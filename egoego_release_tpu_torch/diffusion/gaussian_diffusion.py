"""Head-pose-conditioned Gaussian diffusion, stage 2 (port of
egoego_release_tpu/diffusion/gaussian_diffusion.py): the training loss
(``q_sample``, ``p_losses``) and the samplers.

``p_losses`` runs the denoiser ``nn.Module`` forward with autograd, as JAX
trains through the flax path: no kernel of this package has a backward.

By default every reverse step runs through the three step kernels of
ops/fused_step.py: on the card the hand-written CUDA kernels, on the CPU
their plain versions. With ``fused_transformer`` (the ``--fused`` mode)
each step instead runs the denoiser forward through
``ops.fused_layer.fused_denoiser_apply`` (one ``fused_decoder_layer`` per
layer) and then the posterior or DDIM update and the inpaint in PyTorch,
as the JAX package's non-step loop does. The window chain is a host loop: windows depend on
each other through the inpainted overlap, and each window's 1000 steps are
queued on the device without a host sync.

Randomness comes from outside: a noise source (``ops.fused_step.TorchNoise``
by default) hands out each window's initial x, condition noise and per-step
noise, so a test can replay another framework's draws.

On a mesh (``parallel.mesh``): ``shard(mesh)`` splits the denoiser's layers
over tp, and the window samplers take ``mesh=`` to split their batch over
dp, each rank drawing the noise of the whole padded batch and keeping its
rows, as JAX shards the draws of one key.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from egoego_release_tpu_torch.diffusion.schedule import make_diffusion_constants
from egoego_release_tpu_torch.models.denoiser import TransformerDiffusionModel, init_weights_
from egoego_release_tpu_torch.ops import fk as fk_mod
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import heading
from egoego_release_tpu_torch.ops import rotations as rot
from egoego_release_tpu_torch.ops.fused_layer import fused_denoiser_apply, layer_params
from egoego_release_tpu_torch.ops.fused_step import (
    ddim_scalars,
    ddpm_scalars,
    fused_p_sample_loop,
    prepare_step_params,
)
from egoego_release_tpu_torch.parallel.mesh import shard_module_, sharded_rows
from egoego_release_tpu_torch.utils.device import resolve_device

NUM_JOINTS = fk_mod.NUM_JOINTS
HEAD_IDX = fk_mod.HEAD_IDX
JPOS_DIM = NUM_JOINTS * 3          # 66
ROT_DIM = NUM_JOINTS * 6           # 132
D_FEATS = JPOS_DIM + ROT_DIM       # 198


@dataclass(frozen=True)
class DiffusionConfig:
    """The released stage-2 configuration (d_model 512, 4 heads, 4 layers,
    d_k = d_v = 256, 120-frame windows, cosine DDPM-1000, pred_x0)."""

    d_feats: int = D_FEATS
    d_model: int = 512
    n_head: int = 4
    n_dec_layers: int = 4
    d_k: int = 256
    d_v: int = 256
    window: int = 120
    timesteps: int = 1000
    objective: str = "pred_x0"       # training target; the samplers take pred_x0 only
    beta_schedule: str = "cosine"
    loss_type: str = "l1"
    # recompute each decoder layer in the backward pass (training memory)
    remat: bool = False
    overlap_frames: int = 10
    # the step kernels' compute type: f32 by default, as JAX's config
    # (``egoego_release_tpu/diffusion/gaussian_diffusion.py:65``); "bfloat16"
    # is what the CLIs' --fused_step selects
    compute_dtype: str = "float32"
    sampler: str = "ddpm"            # "ddim" = strided fast sampler
    ddim_steps: int = 50
    # the --fused denoiser (fused_decoder_layer per layer, bf16) instead of
    # the step kernels; the CLIs give --fused_step precedence, as JAX does
    fused_transformer: bool = False
    # the step kernels hand their inter-layer activations over in bf16 (the
    # TPU kernels' act dtype); LayerNorm and softmax statistics, the carry
    # and the update stay f32. The step path only: --fused ignores it, as
    # in JAX, and no CLI flag sets it
    fused_step_act_bf16: bool = False
    # --sample_microbatch N: a reverse chain over more than N rows runs as
    # chunks of N in sequence, each with its own noise source; 0 = off
    sample_microbatch: int = 0


class NormStats(NamedTuple):
    """Min/max normalization stats of the joint positions, (22, 3) each."""

    jpos_min: torch.Tensor
    jpos_max: torch.Tensor


def normalize_jpos(jpos: torch.Tensor, stats: NormStats) -> torch.Tensor:
    """[min, max] -> [-1, 1]; jpos (..., 22, 3)."""
    return (jpos - stats.jpos_min) / (stats.jpos_max - stats.jpos_min) * 2.0 - 1.0


def de_normalize_jpos(n: torch.Tensor, stats: NormStats) -> torch.Tensor:
    return (n + 1.0) * 0.5 * (stats.jpos_max - stats.jpos_min) + stats.jpos_min


def head_condition_mask(bs: int, t: int, joint_idx: int = HEAD_IDX, device="cpu") -> torch.Tensor:
    """1 = to generate, 0 = conditioned: the head's position and rotation dims."""
    mask = torch.ones(bs, t, D_FEATS, device=device)
    p, r = joint_idx * 3, JPOS_DIM + joint_idx * 6
    mask[:, :, p: p + 3] = 0.0
    mask[:, :, r: r + 6] = 0.0
    return mask


def new_denoiser(cfg: DiffusionConfig) -> TransformerDiffusionModel:
    """An uninitialized denoiser of the configured shape, on the CPU."""
    return TransformerDiffusionModel(cfg.d_feats, cfg.d_model, cfg.n_dec_layers, cfg.n_head,
                                     cfg.d_k, cfg.d_v, max_timesteps=cfg.window + 1, remat=cfg.remat)


@torch.no_grad()
def fused_layer_p_sample_loop(diff, x_start, cond_mask, padding_mask=None, inpaint_value=None,
                              inpaint_mask=None, *, noise, ddim_steps: int | None = None,
                              eta: float = 0.0) -> torch.Tensor:
    """The reverse chain of the ``--fused`` mode: per step the denoiser
    through ``fused_denoiser_apply``, x0 clipped to [-1, 1], then
    x_next = a1 x0 + a2 x_t + a3 noise with the step path's host scalars
    (the DDPM posterior update, or the DDIM one written the same way),
    then the inpaint. Noise is drawn as the step path draws it."""
    cfg = diff.cfg
    shape = x_start.shape
    draw = lambda f: f(shape).to(x_start.device, torch.float32)
    x = draw(noise.initial)
    x_cond = x_start * (1.0 - cond_mask) + cond_mask * draw(noise.cond)
    if ddim_steps is None:
        sched = ddpm_scalars(diff.consts, cfg.timesteps)
    else:
        sched = ddim_scalars(diff.consts, cfg.timesteps, ddim_steps, eta)
    layers = diff.fused_layer_params()
    for t, (a1, a2, a3) in sched:
        noise_t = torch.full((shape[0],), t, dtype=torch.int64, device=x.device)
        x0 = fused_denoiser_apply(diff.model, torch.cat([x, x_cond], dim=-1), noise_t,
                                  padding_mask, cfg, layers=layers).clamp(-1.0, 1.0)
        x = a1 * x0 + a2 * x + a3 * draw(noise.step)
        if inpaint_value is not None:
            x = torch.where(inpaint_mask > 0, inpaint_value, x)
    return x


class CondGaussianDiffusion:
    """Holds the denoiser (an ``nn.Module`` on ``device``), the f32 schedule
    and the kernel operands prepared from the weights."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(), device="cuda",
                 model: TransformerDiffusionModel | None = None, seed: int = 0):
        if cfg.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype must be bfloat16 or float32, got {cfg.compute_dtype!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.consts = make_diffusion_constants(cfg.timesteps, cfg.beta_schedule)
        self._loss_consts = {k: torch.as_tensor(getattr(self.consts, k), device=self.device) for k in (
            "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "p2_loss_weight")}
        if model is None:
            model = init_weights_(new_denoiser(cfg), torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()
        self.mesh = None
        self._prep = None
        self._fused_layers = None

    def shard(self, mesh) -> "CondGaussianDiffusion":
        """Put the denoiser on ``mesh`` in place: under tp each rank keeps its
        shards of every layer (``parallel.mesh.shard_module_``), and the step
        kernels run the tensor-parallel layer."""
        shard_module_(self.model, mesh)
        self.mesh = mesh
        self._prep = self._fused_layers = None
        return self

    def _kept(self, attr: str, make):
        """``make()``, computed once from the current weights and kept in
        ``attr``; while ``torch.export`` traces, computed in the traced
        program and not kept."""
        if ck.tracing():
            return make()
        if getattr(self, attr) is None:
            setattr(self, attr, make())
        return getattr(self, attr)

    def step_params(self) -> dict:
        """Kernel operands of the step kernels."""
        return self._kept("_prep", lambda: prepare_step_params(self.model, self.cfg.compute_dtype == "bfloat16"))

    def fused_layer_params(self) -> list[dict]:
        """Per-layer operands of the ``--fused`` denoiser, bf16 as in JAX."""
        return self._kept("_fused_layers", lambda: [layer_params(layer, bf16=True)
                                                    for layer in self.model.motion_transformer.layer_stack])

    # -- forward process / training ---------------------------------------

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        c = self._loss_consts
        shape = (-1,) + (1,) * (x_start.ndim - 1)
        return (c["sqrt_alphas_cumprod"][t].reshape(shape) * x_start
                + c["sqrt_one_minus_alphas_cumprod"][t].reshape(shape) * noise)

    def p_losses(self, model: TransformerDiffusionModel, x_start: torch.Tensor, cond_mask: torch.Tensor,
                 padding_mask: torch.Tensor | None = None, *, noise, train: bool = False) -> torch.Tensor:
        """The training loss of ``model`` (JAX: ``p_losses(params, key, ...)``).
        x_start (B, T, D) in [-1, 1]; cond_mask (B, T, D), 1 = to generate;
        padding_mask (B, 1, T+1), 1 = real, whose frame part ``[:, 0, 1:]``
        zeroes the loss of padded frames before the mean over all T x D.
        ``noise`` gives t (``randint``), the forward noise (``step``), the
        condition noise (``cond``) and, with ``train``, the dropout seed
        (``dropout_seed``; the global RNG is forked around the forward, so
        nothing else sees it). ``train`` puts ``model`` in train mode
        (dropout on), else in eval mode. Returns the scalar loss."""
        bs = x_start.shape[0]
        dev = x_start.device
        t = noise.randint(bs, self.cfg.timesteps).to(dev)
        eps = noise.step(x_start.shape).to(dev, x_start.dtype)
        x = self.q_sample(x_start, t, eps)
        cond_noise = noise.cond(x_start.shape).to(dev, x_start.dtype)
        x_all = torch.cat([x, x_start * (1.0 - cond_mask) + cond_mask * cond_noise], dim=-1)
        model.train(train)
        if train:
            with torch.random.fork_rng(devices=[dev.index] if dev.type == "cuda" else []):
                torch.manual_seed(noise.dropout_seed())
                model_out = model(x_all, t, padding_mask)
        else:
            model_out = model(x_all, t, padding_mask)

        if self.cfg.objective == "pred_x0":
            target = x_start
        elif self.cfg.objective == "pred_noise":
            target = eps
        else:
            raise ValueError(self.cfg.objective)
        if self.cfg.loss_type == "l1":
            loss = (model_out - target).abs()
        elif self.cfg.loss_type == "l2":
            loss = (model_out - target) ** 2
        else:
            raise ValueError(self.cfg.loss_type)
        if padding_mask is not None:
            loss = loss * padding_mask[:, 0, 1:, None]
        loss = loss.reshape(bs, -1).mean(dim=-1) * self._loss_consts["p2_loss_weight"][t]
        return loss.mean()

    # -- reverse process ---------------------------------------------------

    def _loop(self, x_start, cond_mask, padding_mask, inpaint_value, inpaint_mask, *, noise, **kw):
        """The reverse chain of the configured route. With
        ``sample_microbatch`` N below the batch, the batch is padded to a
        multiple of N by repeating its last row (rows are independent
        through the denoiser), run as chunks of N in sequence, each with
        its own source from ``noise.split`` (JAX: ``jax.random.split(key,
        k)``), and sliced back."""
        if self.cfg.objective != "pred_x0":
            raise NotImplementedError(f"the samplers take pred_x0 models only, not {self.cfg.objective!r}")
        if self.cfg.fused_transformer:
            loop = fused_layer_p_sample_loop
        else:
            loop = functools.partial(fused_p_sample_loop, act_bf16=self.cfg.fused_step_act_bf16)
        mb = self.cfg.sample_microbatch
        bs = x_start.shape[0]
        if not mb or bs <= mb:
            return loop(self, x_start, cond_mask, padding_mask, inpaint_value, inpaint_mask, noise=noise, **kw)
        pad = (-bs) % mb
        arrays = [x_start, cond_mask, padding_mask, inpaint_value, inpaint_mask]
        if pad:
            arrays = [None if a is None else torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) for a in arrays]
        chunks = noise.split((bs + pad) // mb)
        out = [loop(self, *(None if a is None else a[i * mb:(i + 1) * mb] for a in arrays), noise=src, **kw)
               for i, src in enumerate(chunks)]
        return torch.cat(out)[:bs]

    def p_sample_loop(self, x_start, cond_mask, padding_mask=None, inpaint_value=None,
                      inpaint_mask=None, *, noise):
        """DDPM over every timestep (inpaint_mask (B, T, 1), 1 = force)."""
        return self._loop(x_start, cond_mask, padding_mask, inpaint_value, inpaint_mask, noise=noise)

    def p_sample_loop_ddim(self, x_start, cond_mask, num_steps: int = 50, eta: float = 0.0,
                           padding_mask=None, inpaint_value=None, inpaint_mask=None, *, noise):
        """DDIM over ``num_steps`` strided timesteps (eta 0: deterministic)."""
        return self._loop(x_start, cond_mask, padding_mask, inpaint_value, inpaint_mask, noise=noise,
                          ddim_steps=num_steps, eta=eta)

    # -- canonical sliding-window sampling ---------------------------------

    def _canonicalize_window(self, head_jpos, head_jquat, stats: NormStats):
        aligned_trans, aligned_quat, recover_rot_quat = heading.rotate_at_frame(
            head_jpos, head_jquat, cano_t_idx=0)
        move0 = aligned_trans[:, 0:1, :] * aligned_trans.new_tensor([1.0, 1.0, 0.0])
        aligned_trans = aligned_trans - move0
        rot6d = rot.matrix_to_rot6d(rot.quat_to_matrix(aligned_quat))

        bs, t = aligned_trans.shape[:2]
        x_start = aligned_trans.new_zeros(bs, t, D_FEATS)
        p, r = HEAD_IDX * 3, JPOS_DIM + HEAD_IDX * 6
        x_start[:, :, p: p + 3] = aligned_trans
        x_start[:, :, r: r + 6] = rot6d
        njpos = normalize_jpos(x_start[:, :, :JPOS_DIM].reshape(bs, t, NUM_JOINTS, 3), stats)
        x_start[:, :, :JPOS_DIM] = njpos.reshape(bs, t, JPOS_DIM)
        return x_start, recover_rot_quat

    def convert_model_res_to_data(self, res, recover_rot_quat, stats: NormStats):
        """Model output -> (local_aa (B,T,22,3), root_pos (B,T,3), head_pos
        (B,T,3)) in the original, un-canonicalized frame."""
        bs, t, _ = res.shape
        global_jpos = de_normalize_jpos(res[:, :, :JPOS_DIM].reshape(bs, t, NUM_JOINTS, 3), stats)
        rot6d = res[:, :, JPOS_DIM:].reshape(bs, t, NUM_JOINTS, 6)
        global_quat = rot.matrix_to_quat(rot.rot6d_to_matrix(rot6d))
        ori_global_quat = rot.quat_multiply(recover_rot_quat, global_quat)
        rq = recover_rot_quat[:, :, 0, :]
        ori_root_jpos = rot.quat_apply(rq, global_jpos[:, :, 0, :])
        ori_head_jpos = rot.quat_apply(rq, global_jpos[:, :, HEAD_IDX, :])
        ori_global_mat = rot.quat_to_matrix(ori_global_quat)
        local_mat = rot.quat_to_matrix(fk_mod.ik_to_local_quat(rot.matrix_to_quat(ori_global_mat)))
        return rot.matrix_to_axis_angle(local_mat), ori_root_jpos, ori_head_jpos

    def _next_window_inpaint(self, root_pos, local_aa, rest_offsets, stats: NormStats):
        """FK re-projection of the last ``overlap`` frames into the next
        window's canonical frame. Returns (B, overlap, D_FEATS)."""
        bs, t = root_pos.shape[:2]
        ov = self.cfg.overlap_frames
        gq, gp = fk_mod.fk_smpl(root_pos.reshape(-1, 3), local_aa.reshape(-1, NUM_JOINTS, 3),
                                rest_offsets)
        gq = gq.reshape(bs, t, NUM_JOINTS, 4)[:, -ov:]
        gp = gp.reshape(bs, t, NUM_JOINTS, 3)[:, -ov:]
        aligned_trans, _, recover = heading.rotate_at_frame(
            gp[:, :, HEAD_IDX, :], gq[:, :, HEAD_IDX, :], cano_t_idx=0)
        move0 = aligned_trans[:, 0:1, :] * aligned_trans.new_tensor([1.0, 1.0, 0.0])
        inv = rot.quat_invert(recover)
        jpos_n = normalize_jpos(rot.quat_apply(inv, gp) - move0[:, :, None, :], stats)
        rot6d = rot.matrix_to_rot6d(rot.quat_to_matrix(rot.quat_multiply(inv, gq)))
        return torch.cat([jpos_n.reshape(bs, ov, JPOS_DIM), rot6d.reshape(bs, ov, ROT_DIM)], dim=-1)

    def _sample_window(self, head_jpos, head_jquat, stats, inpaint_value, noise):
        """One canonical window: canonicalize -> reverse chain (with the
        overlap inpaint when ``inpaint_value`` is given) -> decode."""
        bs, t = head_jpos.shape[:2]
        x_start, recover = self._canonicalize_window(head_jpos, head_jquat, stats)
        cond_mask = head_condition_mask(bs, t, device=x_start.device)
        value = mask = None
        if inpaint_value is not None:
            ov = self.cfg.overlap_frames
            mask = x_start.new_zeros(bs, t, 1)
            mask[:, :ov] = 1.0
            value = x_start.new_zeros(bs, t, D_FEATS)
            value[:, :ov] = inpaint_value
        if self.cfg.sampler == "ddim":
            x = self.p_sample_loop_ddim(x_start, cond_mask, num_steps=self.cfg.ddim_steps,
                                        inpaint_value=value, inpaint_mask=mask, noise=noise)
        else:
            x = self.p_sample_loop(x_start, cond_mask, inpaint_value=value, inpaint_mask=mask,
                                   noise=noise)
        return self.convert_model_res_to_data(x, recover, stats)

    @torch.no_grad()
    def sample_sliding_window_w_canonical(self, head_jpos, head_jquat, stats: NormStats,
                                          rest_offsets, *, noise, mesh=None):
        """Long sequences in overlapping windows with per-window
        canonicalization, overlap inpainting and head-continuity stitching.
        head_jpos (B, T, 3), head_jquat (B, T, 4) wxyz. ``noise.window()`` is
        called once per window. ``mesh``: each dp rank samples its rows of
        the batch padded to dp (``parallel.mesh.sharded_rows``), and every
        rank returns the whole batch. Returns (local_aa (B, T', 22, 3),
        root_pos (B, T', 3))."""
        if mesh is not None and mesh.dp > 1:
            if self.cfg.sample_microbatch:  # its chunks would split each rank's rows again
                raise ValueError("sample_microbatch does not combine with a dp-split batch")
            return sharded_rows(lambda jp, jq, noise: self.sample_sliding_window_w_canonical(
                jp, jq, stats, rest_offsets, noise=noise), mesh, noise, head_jpos, head_jquat)
        cfg = self.cfg
        num_steps = head_jpos.shape[1]
        stride = cfg.window - cfg.overlap_frames
        ov = cfg.overlap_frames
        whole_aa = whole_root = whole_head = inpaint_value = None
        for t_idx in range(0, num_steps, stride):
            tw = min(cfg.window, num_steps - t_idx)
            if tw <= ov:
                break
            aa, root, headp = self._sample_window(
                head_jpos[:, t_idx: t_idx + tw], head_jquat[:, t_idx: t_idx + tw], stats,
                inpaint_value, noise.window())
            if t_idx == 0:
                whole_aa, whole_root, whole_head = aa, root, headp
            else:
                move = whole_head[:, -1:, :] - headp[:, ov - 1: ov, :]
                root = root + move
                headp = headp + move
                whole_aa = torch.cat([whole_aa, aa[:, ov:]], dim=1)
                whole_root = torch.cat([whole_root, root[:, ov:]], dim=1)
                whole_head = torch.cat([whole_head, headp[:, ov:]], dim=1)
            inpaint_value = self._next_window_inpaint(root, aa, rest_offsets, stats)
        return whole_aa, whole_root

    @torch.no_grad()
    def sample_sliding_window_parallel(self, head_jpos, head_jquat, stats: NormStats, rest_offsets, *,
                                       noise, mesh=None):
        """The throughput mode (JAX ``diffusion/gaussian_diffusion.py:564-653``;
        its jitted twin ``sample_sliding_window_parallel_jit`` at ``:551``
        computes the same function, so it has no second copy here): every
        window of every sequence is canonicalized and denoised without the
        overlap inpaint, the full windows of all sequences as one stacked
        batch of ``len(full) * B`` rows in JAX's window-major order, then
        each ragged window alone; the windows are then stitched by
        head-position continuity, the root blended linearly over the
        overlap and the rotations switched at the seam. ``noise.window()``
        is called once before each ``_sample_window``, in JAX's key order.
        ``rest_offsets`` is not read (no window is re-projected through FK);
        it is taken for the chained sampler's signature, as in JAX. ``mesh``
        (JAX ``:604-613``): the stack is padded to dp and each dp rank
        samples its rows, with its share of the noise of the padded stack;
        the ragged windows run whole on every rank. Returns (local_aa
        (B, T', 22, 3), root_pos (B, T', 3))."""
        cfg = self.cfg
        bsz, num_steps = head_jpos.shape[:2]
        w, ov = cfg.window, cfg.overlap_frames
        starts = [t for t in range(0, num_steps, w - ov) if min(w, num_steps - t) > ov]
        full = [t for t in starts if num_steps - t >= w]
        ragged = [t for t in starts if num_steps - t < w]

        results = {}
        if full:
            w_jpos = torch.stack([head_jpos[:, t: t + w] for t in full]).reshape(-1, w, 3)
            w_jquat = torch.stack([head_jquat[:, t: t + w] for t in full]).reshape(-1, w, 4)
            sample = lambda jp, jq, noise: self._sample_window(jp, jq, stats, None, noise)
            if mesh is not None and mesh.dp > 1:
                out = sharded_rows(sample, mesh, noise.window(), w_jpos, w_jquat)
            else:
                out = sample(w_jpos, w_jquat, noise.window())
            aa, root, headp = (o.reshape((len(full), bsz) + o.shape[1:]) for o in out)
            results.update({t: (aa[i], root[i], headp[i]) for i, t in enumerate(full)})
        for t in ragged:
            results[t] = self._sample_window(head_jpos[:, t:], head_jquat[:, t:], stats, None, noise.window())

        whole_aa, whole_root, whole_head = results[starts[0]]
        fade = torch.linspace(0.0, 1.0, ov, device=whole_root.device)[None, :, None]
        for t in starts[1:]:
            aa, root, headp = results[t]
            move = whole_head[:, -1:, :] - headp[:, ov - 1: ov, :]
            root = root + move
            blended = whole_root[:, -ov:] * (1 - fade) + root[:, :ov] * fade
            whole_root = torch.cat([whole_root[:, :-ov], blended, root[:, ov:]], dim=1)
            whole_aa = torch.cat([whole_aa, aa[:, ov:]], dim=1)
            whole_head = torch.cat([whole_head, (headp + move)[:, ov:]], dim=1)
        return whole_aa, whole_root
