"""The DDPM/DDIM reverse step as three hand-written kernels (port of
egoego_release_tpu/ops/fused_step.py).

One reverse step is ``n_dec_layers`` kernel calls, as on the TPU:

  stem_layer      replaces _stem_layer_kernel: the stem as a split-K
                  product x @ Wx + x_cond @ Wc + b, the noise-level token
                  at slot 0, the 1-based position rows, then DecoderLayer 0
  decoder_layer   replaces _layer_kernel (ops/fused_layer.py), layers
                  1 .. L-2
  layer_epilogue  replaces _layer_epilogue_kernel: DecoderLayer L-1, token
                  0 dropped, linear_out, x0 clipped to [-1, 1], then
                      x_next = a1 x0 + a2 x_t + a3 noise
                  and the optional overlap inpaint x + m (v - x)

DDPM  a1 = posterior_mean_coef1[t], a2 = posterior_mean_coef2[t],
      a3 = [t > 0] exp(0.5 posterior_log_variance_clipped[t])
DDIM  a2 = sqrt(max(1 - ac_prev - sigma^2, 0)) / sqrt(1 - ac_t),
      a1 = sqrt(ac_prev) - a2 sqrt(ac_t),  a3 = sigma

On the card each wrapper is a chain of launches (csrc/gemm.cu,
csrc/attention.cu; see ops/fused_layer.py for why a layer is not one
kernel there): the stem and the update ride in GEMM epilogues, so only
the (B, T+1, d_model) activations cross device memory between layers, in
f32 and, for the next layer's bf16 products, as a bf16 copy; with
``act_bf16`` (the TPU kernels' bf16 ``adt``) as one bf16 tensor alone.
The stem's tokens (layer 0's input) stay f32, as they stay in the TPU
kernel's VMEM, and so does the last layer's output, which linear_out reads
in the compute dtype (in bf16 compute as a bf16 tensor alone). In bf16 the
stem's A is ``xa`` (B, T, 400) = [bf16(x) | bf16(x_cond) | 0] (``pack_xa``):
``fused_p_sample_loop`` packs it once a window, and each step's update
writes bf16(x_next) into its x part, so the stem reads one 16-byte aligned
bf16 matrix (the round-to-nearest _stem_layer_kernel does at
``x_ref[:].astype(cdt)``).

The port pads nothing: a window of T frames is T + 1 tokens, every row is
real, and every token is a key. The samplers
take their noise from outside (a ``TorchNoise`` or any object with
``initial``, ``cond`` and ``step``), compute the schedule scalars on the
host from the f32 schedule and embed every noise level of the chain once
up front, so no step waits on the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops.fused_layer import (
    decoder_layer,
    decoder_layer_cuda,
    decoder_layer_plain,
    layer_params,
    linear_plain,
)


def prepare_step_params(model, bf16: bool) -> dict:
    """Kernel operands of a ``TransformerDiffusionModel`` in the compute
    dtype: per-layer dicts (fused_layer.layer_params); the stem weight
    (d_model, 2 d) and the output projection (d, d_model), both (N, K) as
    ``nn.Linear`` keeps them, the stem's K and linear_out's N zero-padded to
    multiples of 8 (16-byte bf16 rows of xa; (512, 400) and (200, 512) at the
    release widths); f32 biases and the position table."""
    wdt = torch.bfloat16 if bf16 else torch.float32
    mt = model.motion_transformer
    f = lambda t: t.detach().float().contiguous()
    wst = mt.start_conv.weight.detach()[..., 0]
    lw = model.linear_out.weight.detach()
    return {
        "layers": [layer_params(layer, bf16) for layer in mt.layer_stack],
        "wst": F.pad(wst, (0, -wst.shape[1] % 8)).contiguous().to(wdt),
        "bst": f(mt.start_conv.bias),
        "lw": F.pad(lw, (0, 0, 0, -lw.shape[0] % 8)).contiguous().to(wdt),
        "lb": f(model.linear_out.bias),
        "pos_table": mt.position_table,
    }


def pack_xa(x: torch.Tensor, xc: torch.Tensor, width: int | None = None) -> torch.Tensor:
    """The stem's bf16 A: (B, T, width) = [bf16(x) | bf16(x_cond) | 0], width
    2 d rounded up to a multiple of 8 by default (``prep["wst"].shape[1]``)."""
    bsz, t, d = x.shape
    xa = x.new_zeros(bsz, t, width or 2 * d + (-2 * d) % 8, dtype=torch.bfloat16)
    xa[..., :d] = x
    xa[..., d: 2 * d] = xc
    return xa


@torch.no_grad()
def noise_level_embeddings(model, ts) -> torch.Tensor:
    """(n, d_model) noise-level tokens for the timesteps ``ts``."""
    dev = model.linear_out.weight.device
    return model.time_mlp(torch.as_tensor(np.asarray(ts), device=dev)).float().contiguous()


# -- stem + layer 0 -------------------------------------------------------


def stem_tokens_plain(x, xc, emb, pos, prep):
    """The input of layer 0, (B, T+1, d_model): token 0 the noise level,
    token t+1 the stem x[t] W_x + xc[t] W_c + b, plus the position rows."""
    bsz, t, d = x.shape
    wst = prep["wst"]
    stem = (linear_plain(x.reshape(bsz * t, d), wst[:, :d]) + linear_plain(xc.reshape(bsz * t, d), wst[:, d: 2 * d])
            + prep["bst"])
    dm = stem.shape[-1]
    return torch.cat([emb.reshape(1, 1, dm).expand(bsz, 1, dm), stem.reshape(bsz, t, dm)], 1) + pos


def stem_layer_plain(x, xc, emb, pos, mask, prep, *, n_head, d_k, d_v, act_bf16=False):
    h = stem_tokens_plain(x, xc, emb, pos, prep)
    return decoder_layer_plain(h, mask, prep["layers"][0], n_head=n_head, d_k=d_k, d_v=d_v, act_bf16=act_bf16)


def stem_layer_cuda(x, xc, emb, pos, mask, prep, *, n_head, d_k, d_v, with_copy=False, xa=None, act_bf16=False):
    """The stem's GEMM, then layer 0; returns ``decoder_layer_cuda``'s pair.
    In bf16 the GEMM reads ``xa`` (packed here when None) and also writes the
    bf16 copy of its output, which layer 0's QKV product reads."""
    bsz, t, _ = x.shape
    dm = prep["bst"].shape[0]
    h = torch.empty(bsz, t + 1, dm, dtype=torch.float32, device=x.device)
    if prep["wst"].dtype == torch.bfloat16:
        xa = pack_xa(x, xc, prep["wst"].shape[1]) if xa is None else xa
        hb = torch.empty_like(h, dtype=torch.bfloat16)
        ck.gemm(ck.STEM, xa.reshape(bsz * t, -1), prep["wst"], prep["bst"], h, M=bsz * (t + 1),
                pos=pos, emb=emb, t_data=t, out_b=hb)
    else:
        hb = None
        ck.gemm(ck.STEM, x, prep["wst"], prep["bst"], h, M=bsz * (t + 1), a2=xc, pos=pos, emb=emb, t_data=t)
    return decoder_layer_cuda(h, mask, prep["layers"][0], n_head=n_head, d_k=d_k, d_v=d_v, hb=hb,
                              with_copy=with_copy, act_bf16=act_bf16)


def stem_layer(x, xc, emb, pos, mask, prep, *, n_head, d_k, d_v, with_copy=False, xa=None, act_bf16=False):
    """x, xc (B, T, d) f32; emb (d_model,) the noise-level token; pos
    (T+1, d_model) the position rows of tokens 0..T; mask (B, T+1); ``xa``
    on the card in bf16: ``pack_xa(x, xc)``, kept by the caller across steps
    (made here when None). Returns the (B, T+1, d_model) output of
    DecoderLayer 0, or with ``with_copy`` (output, its bf16 copy on the card
    in bf16 mode, else None); ``act_bf16``: the output as a bf16 tensor
    (copy None)."""
    if x.is_cuda or ck.tracing():
        out = stem_layer_cuda(x, xc, emb, pos, mask, prep, n_head=n_head, d_k=d_k, d_v=d_v, with_copy=with_copy,
                              xa=xa, act_bf16=act_bf16)
        ck.count("stem_layer")
    else:
        out = stem_layer_plain(x, xc, emb, pos, mask, prep, n_head=n_head, d_k=d_k, d_v=d_v, act_bf16=act_bf16), None
    return out if with_copy else out[0]


# -- last layer + posterior update ---------------------------------------


def step_update_plain(h, x, noise, scal, ipv, ipm, prep):
    """linear_out on tokens 1..T of h (B, T+1, d_model), x0 clipped to
    [-1, 1], x_next = a1 x0 + a2 x + a3 noise, then the inpaint."""
    bsz, t, d = x.shape
    feat = h[:, 1: t + 1].reshape(bsz * t, -1)
    x0 = torch.clamp(linear_plain(feat, prep["lw"][:d]) + prep["lb"], -1.0, 1.0).reshape(bsz, t, d)
    a1, a2, a3 = scal
    xn = a1 * x0 + a2 * x + a3 * noise
    if ipv is not None:
        xn = xn + ipm[..., None] * (ipv - xn)
    return xn


def layer_epilogue_plain(h, mask, x, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v):
    h = decoder_layer_plain(h, mask, prep["layers"][-1], n_head=n_head, d_k=d_k, d_v=d_v)
    return step_update_plain(h, x, noise, scal, ipv, ipm, prep)


def layer_epilogue_cuda(h, mask, x, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v, hb=None, xa=None):
    """The last layer, then the update's GEMM, which in bf16 reads the
    layer's output as bf16 alone (its only reader: the layer writes no f32
    output) and, when ``xa`` is given, writes bf16(x_next) into its x
    part."""
    bf16 = prep["lw"].dtype == torch.bfloat16
    h, _ = decoder_layer_cuda(h, mask, prep["layers"][-1], n_head=n_head, d_k=d_k, d_v=d_v, hb=hb, act_bf16=bf16)
    bsz, t, d = x.shape
    out = torch.empty(bsz, t, d, dtype=torch.float32, device=x.device)
    ck.gemm(ck.STEP, h, prep["lw"], prep["lb"], out, M=bsz * t, x=x, noise=noise,
            ipv=ipv, ipm=ipm, t_data=t, scal=scal, out_b=xa)
    return out


def layer_epilogue(h, mask, x, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v, hb=None, xa=None):
    """h (B, T+1, d_model) f32, or bf16 (the bf16 activations of the
    ``act_bf16`` chain); x, noise (B, T, d) f32; scal = (a1, a2, a3)
    host floats; ipv (B, T, d) and ipm (B, T) or both None; hb the bf16
    copy of an f32 h on the card (made there when None); ``xa`` on the card in
    bf16: the stem's packed A, whose x part receives bf16(x_next). Returns
    x_next (B, T, d) f32."""
    if h.is_cuda or ck.tracing():
        out = layer_epilogue_cuda(h, mask, x, noise, scal, ipv, ipm, prep,
                                  n_head=n_head, d_k=d_k, d_v=d_v, hb=hb, xa=xa)
        ck.count("layer_epilogue")
        return out
    return layer_epilogue_plain(h, mask, x, noise, scal, ipv, ipm, prep,
                                n_head=n_head, d_k=d_k, d_v=d_v)


def fused_denoise_step(x, xc, emb, pos, mask, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v, xa=None,
                       act_bf16=False):
    """One reverse step: ``len(prep["layers"])`` kernel calls. ``xa`` (on
    the card in bf16): ``pack_xa(x, xc)``, updated in place to x_next's.
    ``act_bf16``: the outputs of layers 0 .. L-2 cross between the calls as
    bf16 tensors alone."""
    kw = dict(n_head=n_head, d_k=d_k, d_v=d_v)
    h, hb = stem_layer(x, xc, emb, pos, mask, prep, with_copy=True, xa=xa, act_bf16=act_bf16, **kw)
    for lp in prep["layers"][1:-1]:
        h, hb = decoder_layer(h, mask, lp, hb=hb, with_copy=True, act_bf16=act_bf16, **kw)
    return layer_epilogue(h, mask, x, noise, scal, ipv, ipm, prep, hb=hb, xa=xa, **kw)


# -- schedule scalars (host, f32) ----------------------------------------


def ddpm_scalars(consts, timesteps: int):
    """[(t, (a1, a2, a3))] for t = T-1 .. 0."""
    out = []
    for t in range(timesteps - 1, -1, -1):
        a3 = np.exp(np.float32(0.5) * consts.posterior_log_variance_clipped[t]) if t else np.float32(0.0)
        out.append((t, (float(consts.posterior_mean_coef1[t]),
                        float(consts.posterior_mean_coef2[t]), float(a3))))
    return out


def ddim_timesteps(timesteps: int, n_steps: int) -> np.ndarray:
    return np.linspace(0, timesteps - 1, n_steps).astype(np.int32)[::-1]


def ddim_scalars(consts, timesteps: int, n_steps: int, eta: float = 0.0):
    """[(t, (a1, a2, a3))] over the strided DDIM schedule."""
    f = np.float32
    ts = ddim_timesteps(timesteps, n_steps)
    out = []
    for i, t in enumerate(ts):
        ac_t = consts.alphas_cumprod[t]
        ac_prev = consts.alphas_cumprod[ts[i + 1]] if i + 1 < len(ts) else f(1.0)
        sigma = f(eta) * np.sqrt((f(1) - ac_prev) / (f(1) - ac_t)) * np.sqrt(f(1) - ac_t / ac_prev)
        a2 = np.sqrt(np.maximum(f(1) - ac_prev - sigma * sigma, f(0))) / np.sqrt(f(1) - ac_t)
        a1 = np.sqrt(ac_prev) - a2 * np.sqrt(ac_t)
        out.append((int(t), (float(a1), float(a2), float(sigma))))
    return out


# -- sampling loop ---------------------------------------------------------


class TorchNoise:
    """The samplers' and the trainer's default noise source: every draw
    comes from one ``torch.Generator`` on ``device`` (no host round trip),
    except ``dropout_seed``, which the host needs and draws from a host
    generator of the same seed."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._host = torch.Generator().manual_seed(seed)
        self._splits = 0

    def window(self) -> "TorchNoise":
        return self

    def split(self, k: int) -> list["TorchNoise"]:
        """k independent sources (the counterpart of ``jax.random.split(key,
        k)``), seeded on the host from this source's seed and the number of
        earlier splits, so no draw waits on the device."""
        self._splits += 1
        seeds = np.random.SeedSequence([self.seed, self._splits]).generate_state(k, np.uint64)
        return [TorchNoise(self.device, seed=int(s) >> 1) for s in seeds]

    def _draw(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator, device=self.device)

    initial = cond = step = _draw

    def randint(self, n: int, high: int) -> torch.Tensor:
        """n integers uniform in [0, high) (timesteps, window indices)."""
        return torch.randint(high, (n,), generator=self.generator, device=self.device)

    def dropout_seed(self) -> int:
        return int(torch.randint(2**62, (1,), generator=self._host))


class DefaultNoise:
    """A noise source over the default generator of ``device``
    (``torch.manual_seed`` seeds it): what an exported chain draws
    (``serving.export``), so the live chain on this source and the exported
    program agree for one seed. ``step_at(i, shape)``: the draw of step i
    of a traced reverse loop, in order."""

    def __init__(self, device):
        self.device = torch.device(device)

    def window(self) -> "DefaultNoise":
        return self

    def _draw(self, shape) -> torch.Tensor:
        return torch.randn(shape, device=self.device)

    initial = cond = step = _draw

    def step_at(self, i, shape) -> torch.Tensor:
        return self._draw(shape)


@torch.no_grad()
def fused_p_sample_loop(diff, x_start, cond_mask, padding_mask=None, inpaint_value=None,
                        inpaint_mask=None, *, noise, ddim_steps: int | None = None,
                        eta: float = 0.0, act_bf16: bool = False) -> torch.Tensor:
    """The reverse chain on ``fused_denoise_step``. x_start, cond_mask
    (B, T, d); padding_mask (B, 1, T+1) or None; inpaint_value (B, T, d)
    with inpaint_mask (B, T, 1) (1 = force), or None. ``noise`` supplies
    ``initial(shape)``, ``cond(shape)`` and one ``step(shape)`` per step, in
    that order, on any device (they are moved to x_start's). ddim_steps
    None = DDPM over every timestep. ``act_bf16``: bf16 inter-layer
    activations (JAX: ``act_dtype=jnp.bfloat16``)."""
    cfg = diff.cfg
    if cfg.n_dec_layers < 2:
        raise ValueError("the fused step needs n_dec_layers >= 2")
    prep = diff.step_params()
    bsz, t, d = x_start.shape
    shape = (bsz, t, d)
    draw = lambda f: f(shape).to(x_start.device, torch.float32).contiguous()
    x = draw(noise.initial)
    x_cond = (x_start * (1.0 - cond_mask) + cond_mask * draw(noise.cond)).contiguous()
    if padding_mask is None:
        mask = x_start.new_ones(bsz, t + 1)
    else:
        mask = padding_mask[:, 0, :].float().contiguous()
    pos = prep["pos_table"][1: t + 2].contiguous()
    if inpaint_value is not None:
        ipv = inpaint_value.float().contiguous()
        ipm = inpaint_mask[..., 0].float().contiguous()
    else:
        ipv = ipm = None

    if ddim_steps is None:
        sched = ddpm_scalars(diff.consts, cfg.timesteps)
    else:
        sched = ddim_scalars(diff.consts, cfg.timesteps, ddim_steps, eta)
    embs = noise_level_embeddings(diff.model, [s[0] for s in sched])
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    # the stem's bf16 A on the card, packed once a window; each step's update
    # writes x_next's part
    kernels = x.is_cuda or ck.tracing()
    xa = pack_xa(x, x_cond, prep["wst"].shape[1]) if kernels and prep["wst"].dtype == torch.bfloat16 else None
    if ck.tracing():
        return _traced_loop(x, x_cond, embs, pos, mask, ipv, ipm, prep, sched, xa,
                            lambda i: draw(lambda sh: noise.step_at(i, sh)), act_bf16, kw)
    for i, (_, scal) in enumerate(sched):
        x = fused_denoise_step(x, x_cond, embs[i], pos, mask, draw(noise.step),
                               scal, ipv, ipm, prep, xa=xa, act_bf16=act_bf16, **kw)
    return x


def _traced_loop(x, x_cond, embs, pos, mask, ipv, ipm, prep, sched, xa, draw_step, act_bf16, kw):
    """The reverse loop as ``torch.export`` records it: one
    ``while_loop`` whose body is one ``fused_denoise_step``, so a program of
    any step count holds one step's nodes. Step i reads its noise-level
    token and its update scalars from tables (the scalars stay on the host,
    so no step waits on the device) and draws its noise with ``draw_step(i)``;
    the packed A ``xa`` is carried (copied each step: the loop's body may not
    write its inputs)."""
    from torch._higher_order_ops.while_loop import while_loop

    n = len(sched)
    scal = torch.tensor([s for _, s in sched], dtype=torch.float32)

    def body(i, x, *xa):
        xa = xa[0].clone() if xa else None
        emb = embs.index_select(0, i.reshape(1).to(embs.device))[0]
        x = fused_denoise_step(x, x_cond, emb, pos, mask, draw_step(i), scal.index_select(0, i.reshape(1))[0],
                               ipv, ipm, prep, xa=xa, act_bf16=act_bf16, **kw)
        return (i + 1, x) + (() if xa is None else (xa,))

    carry = (torch.zeros((), dtype=torch.int64), x) + (() if xa is None else (xa,))
    return while_loop(lambda i, *_: i < n, body, carry)[1]
