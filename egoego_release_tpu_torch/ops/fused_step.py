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
      and, for a pred_noise model, whose output is the noise and not x0,
      x0 = clip(r1 x_t - r2 out) with r1 = sqrt_recip_alphas_cumprod[t],
      r2 = sqrt_recipm1_alphas_cumprod[t] (five scalars a step; its own
      instantiation of the update's kernel epilogue)
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
in the compute dtype (in bf16 compute as a bf16 tensor alone). The stem's A
is ``xa`` (B, T, 400) = [x | x_cond | 0] in the compute dtype (``pack_xa``):
``fused_p_sample_loop`` packs it once a window, and each step's update
writes x_next, rounded to that dtype, into its x part, so the stem reads one
16-byte aligned matrix (in bf16 the round-to-nearest _stem_layer_kernel
does at ``x_ref[:].astype(cdt)``; x and x_cond themselves have 792-byte
rows, which TMA cannot map). In f32 compute each weight is also held split
into TF32 hi and lo parts (``<name>_split``), the 3xTF32 GEMM's operand.

The port pads nothing: a window of T frames is T + 1 tokens, every row is
real, and every token is a key. The samplers
take their noise from outside (a ``TorchNoise`` or any object with
``initial``, ``cond`` and ``step``), compute the schedule scalars on the
host from the f32 schedule and embed every noise level of the chain once
up front, into one step table on the device (``step_table``: row i the
noise-level token and the update scalars of step i, which the kernels read
there), so no step waits on the device.

On the card ``fused_p_sample_loop`` replays each reverse step from a CUDA
graph (``StepGraph``): the step's launches, captured once per step shape
into static buffers, replayed after one copy of the step's table row, so
the host issues one graph launch a step instead of its 22 launches. The
capture depends on the shape, the compute dtype, the activations' dtype,
the objective, the inpaint and the operands, never on the schedule or the
noise source; the step draws its noise outside the graph, as an eager step
does, and both launch the same kernels with the same arguments. The steps
launch eagerly on the CPU, while ``torch.export`` traces, and with a
tensor-parallel layer (its collective).
"""

from __future__ import annotations

from collections import Counter, OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops.fused_layer import (
    decoder_layer,
    decoder_layer_cuda,
    decoder_layer_plain,
    kernel_weight,
    layer_params,
    linear_plain,
    with_splits,
)
from egoego_release_tpu_torch.utils import trace


def prepare_step_params(model, bf16: bool) -> dict:
    """Kernel operands of a ``TransformerDiffusionModel`` in the compute
    dtype: per-layer dicts (fused_layer.layer_params); the stem weight
    (d_model, 2 d) and the output projection (d, d_model), both (N, K) as
    ``nn.Linear`` keeps them, the stem's K and linear_out's N zero-padded to
    multiples of 8 (16-byte bf16 rows of xa; (512, 400) and (200, 512) at the
    release widths); f32 biases and the position table. In f32 also
    ``wst_split`` and ``lw_split`` (``fused_layer.with_splits``)."""
    wdt = torch.bfloat16 if bf16 else torch.float32
    mt = model.motion_transformer
    f = lambda t: t.detach().float().contiguous()
    wst = mt.start_conv.weight.detach()[..., 0]
    lw = model.linear_out.weight.detach()
    prep = {
        "layers": [layer_params(layer, bf16) for layer in mt.layer_stack],
        "wst": F.pad(wst, (0, -wst.shape[1] % 8)).contiguous().to(wdt),
        "bst": f(mt.start_conv.bias),
        "lw": F.pad(lw, (0, 0, 0, -lw.shape[0] % 8)).contiguous().to(wdt),
        "lb": f(model.linear_out.bias),
        "pos_table": mt.position_table,
    }
    return prep if bf16 else with_splits(prep, ("wst", "lw"))


def pack_xa(x: torch.Tensor, xc: torch.Tensor, width: int | None = None,
            dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The stem's A: (B, T, width) = [x | x_cond | 0] in ``dtype`` (the
    compute dtype, ``prep["wst"].dtype``), width 2 d rounded up to a
    multiple of 8 by default (``prep["wst"].shape[1]``)."""
    bsz, t, d = x.shape
    xa = x.new_zeros(bsz, t, width or 2 * d + (-2 * d) % 8, dtype=dtype)
    xa[..., :d] = x
    xa[..., d: 2 * d] = xc
    return xa


@torch.no_grad()
def noise_level_embeddings(model, ts) -> torch.Tensor:
    """(n, d_model) noise-level tokens for the timesteps ``ts``."""
    ts = ck.upload(torch.as_tensor(np.asarray(ts)), model.linear_out.weight.device)
    return model.time_mlp(ts).float().contiguous()


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
    The GEMM reads ``xa`` (packed here when None); in bf16 it also writes the
    bf16 copy of its output, which layer 0's QKV product reads."""
    bsz, t, _ = x.shape
    dm = prep["bst"].shape[0]
    wst = prep["wst"]
    h = torch.empty(bsz, t + 1, dm, dtype=torch.float32, device=x.device)
    xa = pack_xa(x, xc, wst.shape[1], wst.dtype) if xa is None else xa
    hb = torch.empty_like(h, dtype=torch.bfloat16) if wst.dtype == torch.bfloat16 else None
    ck.gemm(ck.STEM, xa.reshape(bsz * t, -1), kernel_weight(prep, "wst"), prep["bst"], h, M=bsz * (t + 1),
            pos=pos, emb=emb, t_data=t, out_b=hb)
    return decoder_layer_cuda(h, mask, prep["layers"][0], n_head=n_head, d_k=d_k, d_v=d_v, hb=hb,
                              with_copy=with_copy, act_bf16=act_bf16)


def stem_layer(x, xc, emb, pos, mask, prep, *, n_head, d_k, d_v, with_copy=False, xa=None, act_bf16=False):
    """x, xc (B, T, d) f32; emb (d_model,) the noise-level token; pos
    (T+1, d_model) the position rows of tokens 0..T; mask (B, T+1); ``xa``
    on the card: ``pack_xa(x, xc)`` in the compute dtype, kept by the caller
    across steps (made here when None). Returns the (B, T+1, d_model) output of
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
    [-1, 1], x_next = a1 x0 + a2 x + a3 noise, then the inpaint. ``scal``
    (a1, a2, a3), or (a1, a2, a3, r1, r2) for a pred_noise model, whose
    output converts to x0 = r1 x - r2 out before the clip."""
    bsz, t, d = x.shape
    feat = h[:, 1: t + 1].reshape(bsz * t, -1)
    out = (linear_plain(feat, prep["lw"][:d]) + prep["lb"]).reshape(bsz, t, d)
    if len(scal) == 5:
        out = scal[3] * x - scal[4] * out
    x0 = torch.clamp(out, -1.0, 1.0)
    a1, a2, a3 = scal[:3]
    xn = a1 * x0 + a2 * x + a3 * noise
    if ipv is not None:
        xn = xn + ipm[..., None] * (ipv - xn)
    return xn


def layer_epilogue_plain(h, mask, x, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v):
    h = decoder_layer_plain(h, mask, prep["layers"][-1], n_head=n_head, d_k=d_k, d_v=d_v)
    return step_update_plain(h, x, noise, scal, ipv, ipm, prep)


def layer_epilogue_cuda(h, mask, x, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v, hb=None, xa=None, out=None):
    """The last layer, then the update's GEMM, which in bf16 reads the
    layer's output as bf16 alone (its only reader: the layer writes no f32
    output) and, when ``xa`` is given, writes x_next (rounded to the compute
    dtype) into its x part; x_next itself into ``out`` (made when None)."""
    bf16 = prep["lw"].dtype == torch.bfloat16
    h, _ = decoder_layer_cuda(h, mask, prep["layers"][-1], n_head=n_head, d_k=d_k, d_v=d_v, hb=hb, act_bf16=bf16)
    bsz, t, d = x.shape
    if out is None:
        out = torch.empty(bsz, t, d, dtype=torch.float32, device=x.device)
    ck.gemm(ck.STEP, h, kernel_weight(prep, "lw"), prep["lb"], out, M=bsz * t, x=x, noise=noise,
            ipv=ipv, ipm=ipm, t_data=t, scal=scal, out_b=xa)
    return out


def layer_epilogue(h, mask, x, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v, hb=None, xa=None, out=None):
    """h (B, T+1, d_model) f32, or bf16 (the bf16 activations of the
    ``act_bf16`` chain); x, noise (B, T, d) f32; scal = (a1, a2, a3) or a
    pred_noise model's (a1, a2, a3, r1, r2): host floats or an f32 tensor
    (a row of the step table; on the card the kernel reads it there); ipv
    (B, T, d) and ipm (B, T) or both None; hb the bf16 copy of an f32 h on
    the card (made there when None); ``xa`` on the card: the stem's packed
    A, whose x part receives x_next in its dtype; ``out`` on the card: the
    f32 tensor x_next is written into (made when None). Returns x_next (B,
    T, d) f32."""
    if h.is_cuda or ck.tracing():
        out = layer_epilogue_cuda(h, mask, x, noise, scal, ipv, ipm, prep,
                                  n_head=n_head, d_k=d_k, d_v=d_v, hb=hb, xa=xa, out=out)
        ck.count("layer_epilogue")
        return out
    return layer_epilogue_plain(h, mask, x, noise, scal, ipv, ipm, prep,
                                n_head=n_head, d_k=d_k, d_v=d_v)


def fused_denoise_step(x, xc, emb, pos, mask, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v, xa=None,
                       act_bf16=False, graph=None):
    """One reverse step: ``len(prep["layers"])`` kernel calls. ``xa`` (on
    the card): ``pack_xa(x, xc)``, updated in place to x_next's.
    ``act_bf16``: the outputs of layers 0 .. L-2 cross between the calls as
    bf16 tensors alone. ``graph``: a ``StepGraph`` whose buffers the other
    arguments are (``emb`` and ``scal`` one row of a step table): the step
    is its replay."""
    span = trace.begin("step") if trace.ON else -1
    if graph is not None:
        x = graph.replay(x, emb, scal)
    else:
        x = _launch_step(x, xc, emb, pos, mask, noise, scal, ipv, ipm, prep, n_head=n_head, d_k=d_k, d_v=d_v,
                         xa=xa, act_bf16=act_bf16, out=None)
        if x.is_cuda and not ck.tracing():
            ck.step_graphs["eager"] += 1
    if span >= 0:
        trace.end(span)
    return x


def _launch_step(x, xc, emb, pos, mask, noise, scal, ipv, ipm, prep, *, n_head, d_k, d_v, xa, act_bf16, out):
    """The step's kernel calls, one by one (``fused_denoise_step``'s)."""
    kw = dict(n_head=n_head, d_k=d_k, d_v=d_v)
    h, hb = stem_layer(x, xc, emb, pos, mask, prep, with_copy=True, xa=xa, act_bf16=act_bf16, **kw)
    for lp in prep["layers"][1:-1]:
        h, hb = decoder_layer(h, mask, lp, hb=hb, with_copy=True, act_bf16=act_bf16, **kw)
    return layer_epilogue(h, mask, x, noise, scal, ipv, ipm, prep, hb=hb, xa=xa, out=out, **kw)


# -- schedule scalars (host, f32) ----------------------------------------


def ddpm_scalars(consts, timesteps: int, pred_noise: bool = False):
    """[(t, (a1, a2, a3))] for t = T-1 .. 0; with ``pred_noise``
    [(t, (a1, a2, a3, r1, r2))], r1 and r2 the conversion of a noise
    prediction to x0 (JAX's ``_p_mean_variance``)."""
    out = []
    for t in range(timesteps - 1, -1, -1):
        a3 = np.exp(np.float32(0.5) * consts.posterior_log_variance_clipped[t]) if t else np.float32(0.0)
        scal = (float(consts.posterior_mean_coef1[t]), float(consts.posterior_mean_coef2[t]), float(a3))
        if pred_noise:
            scal += (float(consts.sqrt_recip_alphas_cumprod[t]), float(consts.sqrt_recipm1_alphas_cumprod[t]))
        out.append((t, scal))
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


# -- the step table and the captured step ----------------------------------

# columns of a step-table row past the noise-level token: the step's 3 (or a
# pred_noise model's 5) update scalars, zero-padded
SCAL_COLS = 8


def step_table(embs: torch.Tensor, sched) -> torch.Tensor:
    """(n, d_model + SCAL_COLS) f32 on the device of ``embs`` (n, d_model),
    the noise-level tokens of the ``sched`` (``ddpm_scalars`` /
    ``ddim_scalars``) steps: row i holds step i's token, then its update
    scalars, then zeros. Step i reads ``table[i, :d_model]`` as its token and
    ``table[i, d_model: d_model + len(scal)]`` as its scalars; the scalars
    reach the card without a wait for its queue."""
    scal = torch.zeros(len(sched), SCAL_COLS)
    k = len(sched[0][1])
    scal[:, :k] = torch.tensor([s for _, s in sched], dtype=torch.float32)
    return torch.cat([embs, ck.upload(scal, embs.device)], 1)


class StepGraph:
    """One reverse step at one step shape as CUDA graphs of its launches,
    captured once and replayed for every step of every window of that
    shape. Two graphs carry x from one replay to the next without a copy:
    graph k reads ``x[k]`` and writes x_next into ``x[1 - k]``. Each reads
    the static buffers here (``load`` fills them once a window, on the
    current stream) and its step's noise-level token and update scalars
    from ``row``, into which ``replay`` copies the step's row of the step
    table first. The capture runs one eager step first (every kernel loaded
    and its attributes set), then captures on a side stream into ``pool``;
    the counters and the span recorder see neither. Each replay adds the
    captured step's launches to the kernel counters."""

    def __init__(self, prep, bsz: int, t: int, d: int, *, n_scal: int, inpaint: bool, act_bf16: bool, kw: dict,
                 device, pool):
        f32 = dict(dtype=torch.float32, device=device)
        self.dm = prep["bst"].shape[0]
        self.x = (torch.zeros(bsz, t, d, **f32), torch.zeros(bsz, t, d, **f32))
        self.x_cond, self.noise = torch.zeros(bsz, t, d, **f32), torch.zeros(bsz, t, d, **f32)
        self.mask, self.pos = torch.ones(bsz, t + 1, **f32), torch.zeros(t + 1, self.dm, **f32)
        self.ipv = torch.zeros(bsz, t, d, **f32) if inpaint else None
        self.ipm = torch.zeros(bsz, t, **f32) if inpaint else None
        self.xa = torch.zeros(bsz, t, prep["wst"].shape[1], dtype=prep["wst"].dtype, device=device)
        self.row = torch.zeros(self.dm + SCAL_COLS, **f32)

        def step(k):
            return _launch_step(self.x[k], self.x_cond, self.row[:self.dm], self.pos, self.mask, self.noise,
                                self.row[self.dm: self.dm + n_scal], self.ipv, self.ipm, prep, xa=self.xa,
                                act_bf16=act_bf16, out=self.x[1 - k], **kw)

        self.graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
        with trace.paused(), torch.cuda.device(device):
            with ck.set_aside():
                step(0)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with ck.set_aside() as captured, torch.cuda.stream(side):
                for k, graph in enumerate(self.graphs):
                    graph.capture_begin(pool=pool)  # global capture mode: a synchronizing call would raise
                    try:
                        step(k)
                    finally:
                        graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)
        # one step's launches: half of what the two captures counted
        self.counted = [Counter({n: v // 2 for n, v in c.items()}) for c in captured]
        ck.step_graphs["captured"] += 2

    def load(self, x, x_cond, xa, mask, pos, ipv, ipm):
        """A window's inputs into the static buffers; returns the buffers in
        the same order (x as the first carry)."""
        for dst, src in ((self.x[0], x), (self.x_cond, x_cond), (self.xa, xa), (self.mask, mask), (self.pos, pos),
                         (self.ipv, ipv), (self.ipm, ipm)):
            if dst is not None:
                dst.copy_(src)
        return self.x[0], self.x_cond, self.xa, self.mask, self.pos, self.ipv, self.ipm

    def draw(self, noise) -> torch.Tensor:
        """A step's noise, drawn from ``noise.step`` and copied into the
        static buffer."""
        return self.noise.copy_(noise.step(self.noise.shape))

    def replay(self, x, emb, scal) -> torch.Tensor:
        """x_next of the step on ``x`` (one of the two carries), whose token
        ``emb`` and scalars ``scal`` are one row of a step table."""
        if x is self.x[0] or x is self.x[1]:
            k = int(x is self.x[1])
        else:
            raise ValueError("a replayed step reads one of its graph's two carries (StepGraph.load)")
        if emb.numel() != self.dm or scal.data_ptr() != emb.data_ptr() + 4 * self.dm:
            raise ValueError("a replayed step reads its token and scalars from one row of a step table (step_table)")
        t0 = trace.ON and trace.now()
        self.row.copy_(emb.as_strided(self.row.shape, (1,)))
        t1 = t0 and trace.now()
        self.graphs[k].replay()
        ck.add_counts(self.counted)
        ck.step_graphs["replayed"] += 1
        if t0:
            trace.launch("step_graph", t0, t1)
        return self.x[1 - k]


MAX_STEP_GRAPHS = 16


class StepGraphs:
    """The captured steps of one set of step operands (a diffusion's,
    ``CondGaussianDiffusion.step_graphs``), by ``step_graph_key``, the
    least recently used first (at most ``MAX_STEP_GRAPHS``), and the memory
    pool their graphs share on each stream (they replay there in
    turn). The graphs and their pools go with it."""

    def __init__(self):
        self.graphs: OrderedDict = OrderedDict()
        self.pools: dict = {}

    def get(self, x, prep, *, act_bf16: bool, n_scal: int, inpaint: bool, kw: dict) -> StepGraph:
        """The captured step of a window on ``x`` (B, T, d), captured at the
        first window of its key."""
        bsz, t, d = x.shape
        key = step_graph_key(x.device, bsz, t, act_bf16=act_bf16, n_scal=n_scal, inpaint=inpaint)
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            return graph
        if len(self.graphs) >= MAX_STEP_GRAPHS:
            torch.cuda.synchronize(x.device)  # no replay of the graph dropped is in flight
            dropped, _ = self.graphs.popitem(last=False)
            if all(k[0] != dropped[0] for k in self.graphs):
                del self.pools[dropped[0]]  # a pool that no live graph holds is not shared again
        if key[0] not in self.pools:
            self.pools[key[0]] = torch.cuda.graph_pool_handle()
        graph = self.graphs[key] = StepGraph(prep, bsz, t, d, n_scal=n_scal, inpaint=inpaint, act_bf16=act_bf16,
                                             kw=kw, device=x.device, pool=self.pools[key[0]])
        return graph


def graphs_engage(device, prep) -> bool:
    """Whether a window on ``device`` replays a captured step: on the card,
    outside ``torch.export`` tracing, with no tensor-parallel layer (the
    step would hold its collective); elsewhere the steps launch eagerly."""
    return torch.device(device).type == "cuda" and not ck.tracing() and not any("tp" in lp for lp in prep["layers"])


def step_graph_key(device, bsz: int, t: int, *, act_bf16: bool, n_scal: int, inpaint: bool) -> tuple:
    """What a captured step depends on within one ``StepGraphs`` (whose
    operands, and with them the device and the compute dtype, are fixed):
    the stream it runs on (its buffers are the stream's), the batch, the
    frames, the activations' dtype, the objective (``n_scal`` 5:
    pred_noise) and whether the window inpaints; never the schedule, its
    length or the noise source."""
    device = torch.device(device)
    stream = torch.cuda.current_stream(device).cuda_stream if device.type == "cuda" else None
    return (stream, bsz, t, bool(act_bf16), n_scal == 5, bool(inpaint))


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
    activations (JAX: ``act_dtype=jnp.bfloat16``). Where ``graphs_engage``,
    every step is a replay of the window shape's ``StepGraph``, kept in
    ``diff.step_graphs``, and the result is copied out of its buffers."""
    cfg = diff.cfg
    if cfg.n_dec_layers < 2:
        raise ValueError("the fused step needs n_dec_layers >= 2")
    bsz, t, d = x_start.shape
    shape = (bsz, t, d)
    draw = lambda f: f(shape).to(x_start.device, torch.float32).contiguous()
    with trace.span("loop.setup"):
        prep = diff.step_params()
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
            sched = ddpm_scalars(diff.consts, cfg.timesteps, cfg.objective == "pred_noise")
        else:
            sched = ddim_scalars(diff.consts, cfg.timesteps, ddim_steps, eta)
        table = step_table(noise_level_embeddings(diff.model, [s[0] for s in sched]), sched)
        dm, n_scal = table.shape[1] - SCAL_COLS, len(sched[0][1])
        kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
        # the stem's A on the card, packed once a window; each step's update
        # writes x_next's part
        kernels = x.is_cuda or ck.tracing()
        xa = pack_xa(x, x_cond, prep["wst"].shape[1], prep["wst"].dtype) if kernels else None
        graph = None
        if graphs_engage(x.device, prep):
            graph = diff.step_graphs.get(x, prep, act_bf16=act_bf16, n_scal=n_scal, inpaint=ipv is not None, kw=kw)
            x, x_cond, xa, mask, pos, ipv, ipm = graph.load(x, x_cond, xa, mask, pos, ipv, ipm)
    if ck.tracing():
        return _traced_loop(x, x_cond, table, n_scal, pos, mask, ipv, ipm, prep, xa,
                            lambda i: draw(lambda sh: noise.step_at(i, sh)), act_bf16, kw)
    for i in range(len(sched)):
        t0 = trace.ON and trace.now()
        step_noise = draw(noise.step) if graph is None else graph.draw(noise)
        if t0:
            trace.leaf("step.noise", t0)
        x = fused_denoise_step(x, x_cond, table[i, :dm], pos, mask, step_noise, table[i, dm: dm + n_scal], ipv, ipm,
                               prep, xa=xa, act_bf16=act_bf16, graph=graph, **kw)
    return x if graph is None else x.clone()


def _traced_loop(x, x_cond, table, n_scal, pos, mask, ipv, ipm, prep, xa, draw_step, act_bf16, kw):
    """The reverse loop as ``torch.export`` records it: one
    ``while_loop`` whose body is one ``fused_denoise_step``, so a program of
    any step count holds one step's nodes. Step i reads its noise-level
    token and its update scalars from row i of the step table (on x's
    device, as every step reads them) and draws its noise with
    ``draw_step(i)``; the packed A ``xa`` is carried (copied each step: the
    loop's body may not write its inputs)."""
    from torch._higher_order_ops.while_loop import while_loop

    n, dm = table.shape[0], table.shape[1] - SCAL_COLS

    def body(i, x, *xa):
        xa = xa[0].clone() if xa else None
        row = table.index_select(0, i.reshape(1).to(table.device))[0]
        x = fused_denoise_step(x, x_cond, row[:dm], pos, mask, draw_step(i), row[dm: dm + n_scal],
                               ipv, ipm, prep, xa=xa, act_bf16=act_bf16, **kw)
        return (i + 1, x) + (() if xa is None else (xa,))

    carry = (torch.zeros((), dtype=torch.int64), x) + (() if xa is None else (xa,))
    return while_loop(lambda i, *_: i < n, body, carry)[1]
