"""Build, load and call the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/torch_kernels/`` beside the package (rebuilt when a source is newer
than its library), and loaded with ``ctypes``. Every C entry returns
``cudaGetLastError()`` after its launch; a non-zero code raises here. The
kernels launch on PyTorch's current stream and allocate nothing: the callers
allocate outputs with ``torch.empty``.

Nothing here is imported or built for CPU tensors; the wrappers in
``ops/fused_layer.py``, ``ops/fused_step.py`` and ``ops/attention.py`` take
their plain PyTorch versions for those.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("gemm", "attention", "mha")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches of each ported TPU kernel, counted by its wrapper once its
# kernel chain has been launched on the card.
launch_counts: Counter = Counter()
# Launches of each kernel of the C entries, counted once the entry has
# returned without error: "gemm_wgmma" (every product in bf16) and "gemm"
# (f32) as egoego_gemm reports its choice; the attention kernel that
# ``attention`` picks (ATTENTION_KERNELS); "mha".
kernel_launches: Counter = Counter()

# csrc/attention.cu AttnKernel, by launch name: the CUDA-core kernel (f32
# mode, other head widths), the WMMA kernel (bf16 at head width 256 past
# WGMMA_MAX_TOKENS tokens) and the wgmma kernel (bf16 at head width 256)
ATTENTION_KERNELS = {"attention": 0, "attention_wmma": 1, "attention_wgmma": 2}
WGMMA_MAX_TOKENS = 128  # keys in one m64n128 score accumulator, K and V in shared memory

# GEMM epilogue modes (csrc/gemm.cu GemmMode); the first three are the
# products of a DecoderLayer
BIAS, BIAS_RELU, LAYER_NORM, STEM, STEP = range(5)

_libs: dict[str, ctypes.CDLL] = {}


class GemmArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "a", "a2", "w", "bias", "res", "ln_s", "ln_b", "row_mask", "pos", "emb",
        "x", "noise", "ipv", "ipm", "out", "out_b")] + [(name, ctypes.c_int) for name in (
        "M", "N", "K", "lda", "ldw", "ldo", "ldb", "k_split", "a_bf16", "out_bf16",
        "compute_bf16", "res_bf16", "mode", "t_data", "wgmma")] + [(name, ctypes.c_float) for name in (
        "c1", "c2", "c3")]


class AttnArgs(ctypes.Structure):
    _fields_ = [("qkv", ctypes.c_void_p), ("ctx", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in (
            "B", "T", "t_keys", "n_head", "d_k", "d_v", "ld_qkv", "ld_ctx",
            "is_bf16", "kernel")] + [("scale", ctypes.c_float)]


class MhaArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in ("q", "k", "v", "out")] + [
        (f"{t}_s{d}", ctypes.c_longlong) for t in "qkvo" for d in "bht"] + [
        (name, ctypes.c_int) for name in ("B", "H", "T", "t_keys", "d_k", "d_v")] + [
        ("scale", ctypes.c_float)]


# argument struct and its C size function, per source
_ARGS = {"gemm": (GemmArgs, "egoego_gemm_args_size"), "attention": (AttnArgs, "egoego_attn_args_size"),
         "mha": (MhaArgs, "egoego_mha_args_size")}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"libegoego_{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return max(d.stat().st_mtime for d in deps) > lib.stat().st_mtime


def build(force: bool = False) -> dict:
    """Compile every stale source, one ``nvcc`` per source, all at once.
    Returns {"seconds": wall time, "ptxas": {name: compiler report}}."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if force or _stale(n)]
    reports = {}
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            tmp = BUILD_DIR / f"libegoego_{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            reports[name] = out + err
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}{err}")
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0, "ptxas": reports}


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
        lib = ctypes.CDLL(str(_lib_path(name)))
        entry = getattr(lib, f"egoego_{name}")
        entry.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        entry.restype = ctypes.c_int
        struct, size_fn = _ARGS[name]
        size = getattr(lib, size_fn)
        size.restype = ctypes.c_int
        want = ctypes.sizeof(struct)
        if size() != want:
            raise RuntimeError(f"{name}: argument struct is {size()} bytes in C, {want} in Python")
        _libs[name] = lib
    return _libs[name]


def _check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _layout(t: torch.Tensor, dtype, shape=None, what="tensor") -> None:
    """Raise unless t is contiguous, of ``dtype`` (or one of a tuple) and of
    ``shape`` when given, on any device (gemm checks a layout first and the
    device last, so that the CPU tests reach its refusals)."""
    if not t.is_contiguous() or t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{what}: need a contiguous tensor of {dtype}, "
                         f"got {t.dtype} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _need(t: torch.Tensor, dtype, shape=None, what="tensor") -> None:
    """``_layout``'s checks, on the card."""
    if not t.is_cuda:
        raise ValueError(f"{what}: need a CUDA tensor, got one on {t.device}")
    _layout(t, dtype, shape, what)


def gemm(mode: int, a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
         out: torch.Tensor | None, *, M: int, a2: torch.Tensor | None = None, res=None, ln_s=None, ln_b=None,
         row_mask=None, pos=None, emb=None, x=None, noise=None, ipv=None, ipm=None, out_b=None,
         t_data: int = 0, scal=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """out (M, N) = epilogue(A W^T + b) on the card, N = len(bias), in W's
    dtype: bf16 on the wgmma kernel (tensor cores), f32 on the CUDA cores.

    W is (N_w, K), ``nn.Linear``'s layout, with N_w >= N rows (rows past N
    are never read). A is (rows, K), except in the f32 stem, which reads x
    (B, T, d) as ``a`` and x_cond as ``a2``, with 2 d <= K. In bf16, A is
    bf16, K a multiple of 8, A, W and out 16-byte aligned, and out bf16 in
    BIAS/BIAS_RELU, f32 in the other modes:

    - BIAS, BIAS_RELU, LAYER_NORM: A (M, K); N a multiple of 8.
    - STEM: A = xa (B T, K) (``fused_step.pack_xa``); out (B (T+1), N) and,
      in bf16, its bf16 copy ``out_b`` (required); N a multiple of 8.
    - STEP: A = the last layer's output (B (T+1), K) (its bf16 copy in
      bf16); x, noise, ipv, out (B T, N) f32, 16-byte aligned; N even and
      at most 208 in bf16; ``out_b`` (bf16 only, optional) receives
      bf16(out) in the first N columns of its rows (xa).

    ``out_b`` of LAYER_NORM: bf16 (M, N), the f32 output rounded. With bf16
    inter-layer activations LAYER_NORM's residual ``res`` may be bf16 (read
    as f32; the add stays f32) and ``out`` None, so that the output leaves
    as ``out_b`` alone, in either compute type (in f32 compute that is the
    only ``out_b`` taken). Returns ``out``, or ``out_b`` when ``out`` is
    None. A layout the kernels cannot take raises here or in the C entry;
    nothing falls back to another kernel."""
    f32, bf16 = torch.float32, torch.bfloat16
    _layout(w, (f32, bf16), what="w")
    _layout(bias, f32, what="bias")
    is_bf16 = w.dtype == bf16
    N = bias.numel()
    n_w, K = w.shape
    if n_w < N:
        raise ValueError(f"w: need at least N = {N} rows, got {tuple(w.shape)}")
    _layout(a, (f32, bf16), what="a")
    if out is None:
        if mode != LAYER_NORM or out_b is None:
            raise ValueError("out: only LAYER_NORM may leave out to its bf16 copy out_b")
    else:
        _layout(out, (f32, bf16), what="out")
        if out.numel() != M * N:
            raise ValueError(f"out: need {M}x{N} elements, got {tuple(out.shape)}")
    lda, k_split = a.shape[-1], 0
    if mode == STEM and not is_bf16:
        _layout(a2, a.dtype, a.shape, "a2")
        K, k_split = 2 * lda, lda
        if K > w.shape[1]:
            raise ValueError(f"stem: need 2 d <= K, got d = {lda}, w {tuple(w.shape)}")
    rows = M  # of A: the stem's product skips token 0, the update's includes it
    if mode in (STEM, STEP):
        if t_data <= 0 or M % (t_data + (mode == STEM)):
            raise ValueError(f"stem/step: M = {M} is not a whole number of windows of {t_data} frames")
        rows = M // (t_data + 1) * t_data if mode == STEM else M // t_data * (t_data + 1)
    if a.numel() != rows * lda or (k_split == 0 and lda != K):
        raise ValueError(f"a: need ({rows}, {K}), got {tuple(a.shape)}")
    if mode == STEM:
        _layout(pos, f32, (t_data + 1, N), "pos")
        _layout(emb, f32, (N,), "emb")
    vecs = [("x", x), ("noise", noise)] + ([("ipv", ipv)] if ipv is not None else []) if mode == STEP else []
    for name, t in vecs:
        _layout(t, f32, what=name)
        if t.numel() != M * N:
            raise ValueError(f"{name}: need {M}x{N} elements, got {tuple(t.shape)}")
    if mode == STEP:
        if ipv is not None:
            _layout(ipm, f32, what="ipm")
            if ipm.numel() != M:
                raise ValueError(f"ipm: need {M} elements, got {tuple(ipm.shape)}")
    elif mode == LAYER_NORM:
        _layout(res, (f32, bf16), (M, N), "res")
        _layout(ln_s, f32, (N,), "ln_s")
        _layout(ln_b, f32, (N,), "ln_b")
        _layout(row_mask, f32, (M,), "row_mask")
        if N > 512:
            raise ValueError("layer-norm epilogue: N <= 512")
    ldb = N
    if out_b is not None:
        _layout(out_b, bf16, what="out_b")
        ldb = out_b.shape[-1]
        if (mode not in (LAYER_NORM, STEM, STEP) or (not is_bf16 and out is not None) or out_b.numel() != M * ldb
                or ldb < N or (mode != STEP and ldb != N)):
            raise ValueError("out_b: a bf16 copy (M, N) of the f32 output of LAYER_NORM or STEM in bf16, the "
                             "(M, N) bf16 output of LAYER_NORM alone (out None), or the (M, >= N) x part of xa "
                             "for STEP")
    if is_bf16:
        out_dt = bf16 if mode in (BIAS, BIAS_RELU) else f32
        step_n = N % 2 == 0 and N <= 208 if mode == STEP else N % 8 == 0
        if (a.dtype != bf16 or (out is not None and out.dtype != out_dt) or K % 8 or not step_n
                or (mode == STEM and out_b is None)
                or any(t is not None and t.data_ptr() % 16 for t in (a, w, out, out_b, res, *(t for _, t in vecs)))):
            raise ValueError(f"the wgmma GEMM needs a bf16 A, a bf16 out (f32 for LAYER_NORM, STEM and STEP), K a "
                             f"multiple of 8, N a multiple of 8 (STEP: even, <= 208), the stem's bf16 copy, and "
                             f"16-byte aligned tensors; got A {a.dtype}, out {None if out is None else out.dtype}, "
                             f"K={K}, N={N}")
    elif a.dtype != f32 or (out is not None and out.dtype != f32):
        raise ValueError(f"f32 mode: need f32 A and out, got {a.dtype}, {None if out is None else out.dtype}")
    if not all(t.is_cuda for t in (a, a2, w, bias, res, ln_s, ln_b, row_mask, pos, emb, x, noise, ipv, ipm, out, out_b)
               if t is not None):
        raise ValueError("gemm: need CUDA tensors (the plain versions take CPU tensors)")
    args = GemmArgs(
        a=_ptr(a), a2=_ptr(a2), w=_ptr(w), bias=_ptr(bias), res=_ptr(res),
        ln_s=_ptr(ln_s), ln_b=_ptr(ln_b), row_mask=_ptr(row_mask), pos=_ptr(pos),
        emb=_ptr(emb), x=_ptr(x), noise=_ptr(noise), ipv=_ptr(ipv), ipm=_ptr(ipm),
        out=_ptr(out), out_b=_ptr(out_b), M=M, N=N, K=K, lda=lda, ldw=w.shape[1], ldo=N, ldb=ldb,
        k_split=k_split, a_bf16=int(a.dtype == bf16), out_bf16=int(out is not None and out.dtype == bf16),
        compute_bf16=int(is_bf16), res_bf16=int(res is not None and res.dtype == bf16), mode=mode, t_data=t_data,
        c1=scal[0], c2=scal[1], c3=scal[2],
    )
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        _check(_lib("gemm").egoego_gemm(ctypes.byref(args), stream), "gemm")
    kernel_launches["gemm_wgmma" if args.wgmma else "gemm"] += 1
    return out_b if out is None else out


def attention_route(dtype: torch.dtype, T: int, d_k: int, d_v: int) -> str:
    """The attention kernel for a layout, by launch name: the wgmma kernel
    in bf16 at head width 256 up to WGMMA_MAX_TOKENS tokens (every path at
    the release window), the WMMA kernel there past it, the CUDA-core
    kernel otherwise."""
    if dtype == torch.bfloat16 and d_k == d_v == 256:
        return "attention_wgmma" if T <= WGMMA_MAX_TOKENS else "attention_wmma"
    return "attention"


def attention_args(qkv: torch.Tensor, ctx: torch.Tensor, *, B: int, T: int, t_keys: int, n_head: int, d_k: int,
                   d_v: int, kernel: str) -> AttnArgs:
    """The argument struct of one launch of the named attention kernel."""
    return AttnArgs(qkv=_ptr(qkv), ctx=_ptr(ctx), B=B, T=T, t_keys=t_keys, n_head=n_head, d_k=d_k, d_v=d_v,
                    ld_qkv=qkv.shape[1], ld_ctx=ctx.shape[1], is_bf16=int(qkv.dtype == torch.bfloat16),
                    kernel=ATTENTION_KERNELS[kernel], scale=1.0 / d_k ** 0.5)


def attention(qkv: torch.Tensor, ctx: torch.Tensor, *, B: int, T: int, t_keys: int, n_head: int, d_k: int,
              d_v: int) -> torch.Tensor:
    """ctx (B*T, H*dv) = softmax(q k^T / sqrt(dk), keys < t_keys) v per
    head, from the packed qkv (B*T, H (2 dk + dv)); the function of
    ``fused_layer.attention_plain``, on the kernel ``attention_route``
    picks. The tensor-core kernels need 16-byte aligned qkv and ctx; a
    layout the picked kernel cannot take raises, and nothing falls back to
    another kernel."""
    dt = qkv.dtype
    _need(qkv, (torch.float32, torch.bfloat16), (B * T, n_head * (2 * d_k + d_v)), "qkv")
    _need(ctx, dt, (B * T, n_head * d_v), "ctx")
    if d_v > 256 or not 0 < t_keys <= T:
        raise ValueError(f"attention: need d_v <= 256 and 0 < t_keys <= T, got {d_v}, {t_keys}, {T}")
    kernel = attention_route(dt, T, d_k, d_v)
    if kernel != "attention" and (qkv.data_ptr() % 16 or ctx.data_ptr() % 16):
        raise ValueError(f"{kernel}: need 16-byte aligned qkv and ctx, got them at {qkv.data_ptr() % 16} and "
                         f"{ctx.data_ptr() % 16} bytes past 16")
    args = attention_args(qkv, ctx, B=B, T=T, t_keys=t_keys, n_head=n_head, d_k=d_k, d_v=d_v, kernel=kernel)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        _check(_lib("attention").egoego_attention(ctypes.byref(args), stream), kernel)
    kernel_launches[kernel] += 1
    return ctx


def _mha_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
              t_keys: int) -> MhaArgs:
    """Check the layout of one ``mha`` call and return its argument struct,
    pointers unset."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    for name, x, d in (("q", q, dk), ("k", k, dk), ("v", v, dv), ("out", out, dv)):
        if x.device != q.device or not x.is_cuda or x.dtype != torch.float32 or x.stride(-1) != 1:
            raise ValueError(f"mha {name}: need a CUDA f32 tensor with unit stride over the "
                             f"head width, got {x.dtype} on {x.device}, strides {x.stride()}")
        if tuple(x.shape) != (b, h, t, d):
            raise ValueError(f"mha {name}: need shape {(b, h, t, d)}, got {tuple(x.shape)}")
        if any(s % 4 for s in x.stride()[:3]):
            raise ValueError(f"mha {name}: need 16-byte aligned rows, got strides {x.stride()}")
    if not (0 < t_keys <= t and 0 < dk <= 256 and 0 < dv <= 256 and dk % 4 == 0 and dv % 4 == 0):
        raise ValueError(f"mha: need 0 < t_keys <= T and head widths that are multiples of 4 up to "
                         f"256, got {t_keys}, {t}, {dk}, {dv}")
    strides = {f"{n}_s{d}": s for n, x in zip("qkvo", (q, k, v, out)) for d, s in zip("bht", x.stride()[:3])}
    return MhaArgs(B=b, H=h, T=t, t_keys=t_keys, d_k=dk, d_v=dv, scale=1.0 / dk ** 0.5, **strides)


# checked argument structs of mha, by everything _mha_args reads but the pointers
_mha_layouts: dict[tuple, MhaArgs] = {}


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, *,
        t_keys: int) -> torch.Tensor:
    """out (B, H, T, dv) = softmax(q k^T / sqrt(dk), keys < t_keys) v per
    (batch, head), f32 in and out, the products on the tensor cores at f32
    accuracy (3xTF32). q, k (B, H, T, dk), v and out (B, H, T, dv): any
    strides over (B, H, T) that are multiples of 4 floats, unit stride over
    the head width, 16-byte aligned, head widths multiples of 4 up to 256
    (the kernel copies 16-byte vectors). A layout is checked once and its
    struct kept, so a repeated call only sets the pointers."""
    key = (t_keys, q.shape, k.shape, v.shape, out.shape, q.stride(), k.stride(), v.stride(), out.stride(),
           q.dtype, k.dtype, v.dtype, out.dtype, q.device, k.device, v.device, out.device)
    args = _mha_layouts.get(key)
    if args is None:
        args = _mha_layouts[key] = _mha_args(q, k, v, out, t_keys)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("mha: need 16-byte aligned q, k, v and out")
    args.q, args.k, args.v, args.out = ptrs
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _check(_lib("mha").egoego_mha(ctypes.byref(args), stream), "mha")
    kernel_launches["mha"] += 1
    return out
