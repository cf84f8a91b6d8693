"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These need an NVIDIA GPU with nvcc and skip without one; run them
there with (tests/conftest.py imports JAX, which the GPU machine may lack)

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: 1e-4 absolute in f32 mode (summation order only: no TF32, or
3xTF32, which keeps f32 accuracy, in csrc/mha.cu) and
2e-2 in bf16 mode (a bf16 rounding of q/k/v, p, ctx or h1 may flip where
the two sum in other orders; outputs are O(1) LayerNorm values).
"""

import math
import os

import pytest
import torch

from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_layer as fl
from egoego_release_tpu_torch.ops import fused_step as fs

pytestmark = pytest.mark.cuda
TOL = {False: 1e-4, True: 2e-2}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    ck.build()
    return torch.device("cuda")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("frames,d_head", [(120, 256), (13, 256), (30, 32)])
def test_step_kernels_match_plain(card, bf16, frames, d_head):
    """stem_layer / decoder_layer / layer_epilogue at the release width
    (d_model 512, head width 256: the tensor-core attention in bf16) and at
    head width 32 (the CUDA-core attention), with a padding-mask zero and
    the overlap inpaint."""
    cfg = DiffusionConfig(d_k=d_head, d_v=d_head)
    diff = CondGaussianDiffusion(cfg, device=card, seed=0)
    prep = fs.prepare_step_params(diff.model, bf16)
    g = torch.Generator(device=card).manual_seed(1)
    bsz, d, dm = 6, cfg.d_feats, cfg.d_model
    rn = lambda *s: torch.randn(*s, generator=g, device=card)
    x, xc, noise, ipv = rn(bsz, frames, d), rn(bsz, frames, d), rn(bsz, frames, d), rn(bsz, frames, d)
    h = rn(bsz, frames + 1, dm)
    mask = torch.ones(bsz, frames + 1, device=card)
    mask[:, -2] = 0.0
    ipm = torch.zeros(bsz, frames, device=card)
    ipm[:, :10] = 1.0
    emb = fs.noise_level_embeddings(diff.model, [500])[0]
    pos = prep["pos_table"][1: frames + 2].contiguous()
    kw = dict(n_head=cfg.n_head, d_k=d_head, d_v=d_head)
    cases = [
        (fs.stem_layer, fs.stem_layer_plain, (x, xc, emb, pos, mask, prep)),
        (fl.decoder_layer, fl.decoder_layer_plain, (h, mask, prep["layers"][1])),
        # x0 alone (a1 = 1, no inpaint), then the update with the inpaint
        (fs.layer_epilogue, fs.layer_epilogue_plain, (h, mask, x, noise, (1.0, 0.0, 0.0), None, None, prep)),
        (fs.layer_epilogue, fs.layer_epilogue_plain, (h, mask, x, noise, (0.9, 0.1, 0.05), ipv, ipm, prep)),
    ]
    for wrapper, plain, args in cases:
        ck.launch_counts.clear()
        out_k = wrapper(*args, **kw)
        assert dict(ck.launch_counts) == {wrapper.__name__: 1}
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        assert out_k.shape == out_p.shape
        assert float((out_k - out_p).abs().max()) < TOL[bf16]


def test_wrappers_count_and_route_to_kernels(card):
    """On CUDA tensors the wrappers launch the kernels (and count them); at
    head width 256 in bf16 the attention is the wgmma kernel."""
    cfg = DiffusionConfig(d_model=64, n_head=2, d_k=256, d_v=256, n_dec_layers=3, window=24, timesteps=3,
                          compute_dtype="bfloat16")
    diff = CondGaussianDiffusion(cfg, device=card)
    x = torch.zeros(2, 24, cfg.d_feats, device=card)
    ck.launch_counts.clear()
    ck.kernel_launches.clear()
    out = diff.p_sample_loop(x, torch.ones_like(x), noise=fs.TorchNoise(card, seed=0))
    assert torch.isfinite(out).all()
    assert dict(ck.launch_counts) == {"stem_layer": 3, "decoder_layer": 3, "layer_epilogue": 3}
    # per step: 4 GEMMs per layer, the stem's and the update's, all on the
    # wgmma kernel, and one attention per layer
    assert dict(ck.kernel_launches) == {"gemm_wgmma": 3 * (4 * 3 + 2), "attention_wgmma": 3 * 3}


def _step_inputs(card, cfg, model, bsz, frames, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=card)
    d = cfg.d_feats
    ipm = torch.zeros(bsz, frames, device=card)
    ipm[:, :cfg.overlap_frames] = 1.0
    return dict(x=rn(bsz, frames, d), xc=rn(bsz, frames, d), noise=rn(bsz, frames, d), ipv=rn(bsz, frames, d),
                ipm=ipm, h=rn(bsz, frames + 1, cfg.d_model), mask=torch.ones(bsz, frames + 1, device=card),
                emb=fs.noise_level_embeddings(model, [700])[0])


@pytest.fixture(scope="module")
def release(card):
    """The release-width denoiser and its bf16 step operands."""
    cfg = DiffusionConfig(compute_dtype="bfloat16")
    diff = CondGaussianDiffusion(cfg, device=card, seed=0)
    return cfg, diff.model, fs.prepare_step_params(diff.model, True)


@pytest.mark.parametrize("inpaint", [False, True])
@pytest.mark.parametrize("bsz,frames", [(64, 120), (64, 30), (3, 41)])
def test_stem_and_update_on_wgmma_match_plain(release, card, bsz, frames, inpaint):
    """stem_layer and layer_epilogue in bf16 against their plain versions at
    the main path's windows (64 x 121 and the 64 x 31 tail) and at 3 windows
    of 41 frames (123 stem rows and 126 update rows: ragged tiles that
    straddle windows); each call launches 5 wgmma GEMMs and no other. With
    ``xa`` the update also writes bf16(x_next) into xa's x part, bit for bit
    the rounding of its f32 output, and leaves the x_cond part as it was."""
    cfg, model, prep = release
    inp = _step_inputs(card, cfg, model, bsz, frames, seed=frames + inpaint)
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    pos = prep["pos_table"][1: frames + 2].contiguous()
    ipv, ipm = (inp["ipv"], inp["ipm"]) if inpaint else (None, None)
    xa = fs.pack_xa(inp["x"], inp["xc"], prep["wst"].shape[1])
    xa0 = xa.clone()
    cases = [
        (fs.stem_layer, fs.stem_layer_plain, (inp["x"], inp["xc"], inp["emb"], pos, inp["mask"], prep),
         {"xa": xa}),
        (fs.layer_epilogue, fs.layer_epilogue_plain, (inp["h"], inp["mask"], inp["x"], inp["noise"], (0.9, 0.1, 0.05),
                                                      ipv, ipm, prep), {"xa": xa}),
    ]
    for wrapper, plain, args, extra in cases:
        ck.launch_counts.clear()
        ck.kernel_launches.clear()
        out_k = wrapper(*args, **kw, **extra)
        assert dict(ck.launch_counts) == {wrapper.__name__: 1}
        assert dict(ck.kernel_launches) == {"gemm_wgmma": 5, "attention_wgmma": 1}
        out_p = plain(*args, **kw)
        torch.cuda.synchronize()
        assert out_k.shape == out_p.shape
        assert float((out_k - out_p).abs().max()) < TOL[True]
    d = cfg.d_feats
    assert torch.equal(xa[..., :d], out_k.to(torch.bfloat16))
    assert torch.equal(xa[..., d:], xa0[..., d:])


@pytest.mark.parametrize("bsz,frames", [(64, 120), (64, 30), (3, 41), (2, 13)])
def test_stem_and_step_launches_match_plain(release, card, bsz, frames):
    """The kStem and kStep launches alone: the stem's f32 tokens against
    stem_tokens_plain and its bf16 copy bit for bit their rounding; the
    update's x_next against step_update_plain on the same bf16 copy of h."""
    cfg, model, prep = release
    inp = _step_inputs(card, cfg, model, bsz, frames, seed=3 * frames)
    pos = prep["pos_table"][1: frames + 2].contiguous()
    rows = bsz * (frames + 1)
    h = torch.empty(bsz, frames + 1, cfg.d_model, device=card)
    hb = torch.empty_like(h, dtype=torch.bfloat16)
    xa = fs.pack_xa(inp["x"], inp["xc"], prep["wst"].shape[1])
    ck.kernel_launches.clear()
    ck.gemm(ck.STEM, xa.reshape(bsz * frames, -1), prep["wst"], prep["bst"], h, M=rows, pos=pos, emb=inp["emb"],
            t_data=frames, out_b=hb)
    want = fs.stem_tokens_plain(inp["x"], inp["xc"], inp["emb"], pos, prep)
    torch.cuda.synchronize()
    assert float((h - want).abs().max()) < TOL[True]
    assert torch.equal(hb, h.to(torch.bfloat16))
    hb = inp["h"].to(torch.bfloat16)
    out = torch.empty_like(inp["x"])
    scal = (0.9, 0.1, 0.05)
    ck.gemm(ck.STEP, hb, prep["lw"], prep["lb"], out, M=bsz * frames, x=inp["x"], noise=inp["noise"],
            ipv=inp["ipv"], ipm=inp["ipm"], t_data=frames, scal=scal, out_b=xa)
    want = fs.step_update_plain(hb.float(), inp["x"], inp["noise"], scal, inp["ipv"], inp["ipm"], prep)
    torch.cuda.synchronize()
    assert dict(ck.kernel_launches) == {"gemm_wgmma": 2}
    assert float((out - want).abs().max()) < TOL[True]
    assert torch.equal(xa[..., :cfg.d_feats], out.to(torch.bfloat16))


def _chip_smoke():
    """chip_smoke.py as a module (its phases run only under __main__)."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _bf16_flips_only(got, want, tol, max_share=0.01):
    """A bf16 output within ``tol`` plus the one bf16 ulp its rounding may
    add, at most ``max_share`` of the entries past tol (chip_smoke.bf16_flips)."""
    return _chip_smoke().bf16_flips(got, want, tol, max_share)[0]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bsz,frames", [(64, 120), (64, 30), (3, 41)])
def test_act_bf16_wrappers_match_plain(release, card, bf16, bsz, frames):
    """stem_layer, decoder_layer and layer_epilogue with bf16 inter-layer
    activations against their plain versions: the stem's and the middle
    layer's outputs are bf16 tensors alone (their w2 LayerNorm writes no f32
    output), the middle layer and the epilogue read a bf16 input (fc's
    residual in bf16). f32 outputs within 2e-2 in bf16 compute and 1e-4 in
    f32 compute; bf16 outputs within those plus the one bf16 ulp their
    rounding may add, and in f32 compute at most 1% of the entries past
    1e-4. Each call counts once and launches the chain's C entries."""
    cfg, model, _ = release
    prep = fs.prepare_step_params(model, bf16)
    inp = _step_inputs(card, cfg, model, bsz, frames, seed=7 * frames + bf16)
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    pos = prep["pos_table"][1: frames + 2].contiguous()
    hb = inp["h"].to(torch.bfloat16)
    n_gemm, n_attn = ("gemm_wgmma", "attention_wgmma") if bf16 else ("gemm", "attention")
    cases = [
        (fs.stem_layer, fs.stem_layer_plain, (inp["x"], inp["xc"], inp["emb"], pos, inp["mask"], prep),
         {"act_bf16": True}, 5),
        (fl.decoder_layer, fl.decoder_layer_plain, (hb, inp["mask"], prep["layers"][1]), {"act_bf16": True}, 4),
        (fs.layer_epilogue, fs.layer_epilogue_plain, (hb, inp["mask"], inp["x"], inp["noise"], (0.9, 0.1, 0.05),
                                                      inp["ipv"], inp["ipm"], prep), {}, 5),
    ]
    for wrapper, plain, args, extra, gemms in cases:
        ck.launch_counts.clear()
        ck.kernel_launches.clear()
        out_k = wrapper(*args, **kw, **extra)
        assert dict(ck.launch_counts) == {wrapper.__name__: 1}
        assert dict(ck.kernel_launches) == {n_gemm: gemms, n_attn: 1}
        out_p = plain(*args, **kw, **extra)
        torch.cuda.synchronize()
        assert out_k.shape == out_p.shape and out_k.dtype == out_p.dtype
        assert out_k.dtype == (torch.bfloat16 if extra else torch.float32)
        if out_k.dtype == torch.float32:
            assert float((out_k - out_p).abs().max()) < TOL[bf16], wrapper.__name__
        else:
            assert _bf16_flips_only(out_k, out_p, TOL[bf16], 1.0 if bf16 else 0.01), wrapper.__name__


@pytest.mark.parametrize("bsz,frames", [(64, 120), (64, 30), (3, 41)])
def test_epilogue_without_the_f32_layer_output_is_bit_for_bit(release, card, bsz, frames):
    """layer_epilogue in bf16 no longer has its last LayerNorm write an f32
    output that nothing reads: x_next and xa equal those of the chain that
    wrote it (the layer's f32 output and bf16 copy, the update reading the
    copy), bit for bit."""
    cfg, model, prep = release
    inp = _step_inputs(card, cfg, model, bsz, frames, seed=11 * frames)
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    scal = (0.9, 0.1, 0.05)
    xa_new, xa_old = (fs.pack_xa(inp["x"], inp["xc"], prep["wst"].shape[1]) for _ in range(2))
    new = fs.layer_epilogue(inp["h"], inp["mask"], inp["x"], inp["noise"], scal, inp["ipv"], inp["ipm"], prep,
                            xa=xa_new, **kw)
    _, hb = fl.decoder_layer_cuda(inp["h"], inp["mask"], prep["layers"][-1], with_copy=True, **kw)
    old = torch.empty_like(inp["x"])
    ck.gemm(ck.STEP, hb, prep["lw"], prep["lb"], old, M=bsz * frames, x=inp["x"], noise=inp["noise"],
            ipv=inp["ipv"], ipm=inp["ipm"], t_data=frames, scal=scal, out_b=xa_old)
    torch.cuda.synchronize()
    assert torch.equal(new, old) and torch.equal(xa_new, xa_old)


def test_layer_norm_bf16_residual_and_output_match_plain(card):
    """The LayerNorm epilogue in each of its layouts, one instantiation each
    (an f32 or a bf16 residual; an f32 output, with its bf16 copy in bf16
    compute, or the bf16 output alone), on the wgmma kernel (bf16) and the
    CUDA-core kernel (f32): the residual read as its f32 value, a bf16
    output the f32 result rounded once, a copy bit for bit."""
    g = torch.Generator(device=card).manual_seed(9)
    m, n, k = 726, 512, 1024
    bf = torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=g, device=card)
    res32 = rn(m, n)
    ln_s, ln_b, mask = 1 + 0.1 * rn(n), 0.1 * rn(n), (rn(m) > -1).float()
    for wdt, kernel in ((bf, "gemm_wgmma"), (torch.float32, "gemm")):
        bf16 = wdt == bf
        a, w, bias = rn(m, k).to(wdt), (rn(n, k) * 0.25 / k ** 0.5).to(wdt), 0.25 * rn(n)
        for res in (res32, res32.to(bf)):
            want = fl.layer_norm_plain(fl.linear_plain(a, w) + bias + res.float(), ln_s, ln_b) * mask[:, None]
            for f32_out in (True, False):
                what = (kernel, res.dtype, f32_out)
                out = torch.empty(m, n, device=card) if f32_out else None
                out_b = torch.empty(m, n, dtype=bf, device=card) if bf16 or not f32_out else None
                ck.kernel_launches.clear()
                got = ck.gemm(ck.LAYER_NORM, a, w, bias, out, M=m, res=res, ln_s=ln_s, ln_b=ln_b, row_mask=mask,
                              out_b=out_b)
                torch.cuda.synchronize()
                assert got is (out if f32_out else out_b) and dict(ck.kernel_launches) == {kernel: 1}, what
                if f32_out:
                    assert float((out - want).abs().max()) <= TOL[bf16], what
                    if out_b is not None:
                        assert torch.equal(out_b, out.to(bf)), what
                else:
                    assert _bf16_flips_only(out_b, want.to(bf), TOL[bf16], 1.0 if bf16 else 0.01), what


def test_stem_and_step_refuse_what_they_cannot_take(release, card):
    """A misaligned or oversized operand of kStem or kStep raises in the
    wrapper; nothing falls back to another kernel or to the plain version."""
    cfg, model, prep = release
    b, t, d, dm = 2, 16, cfg.d_feats, cfg.d_model
    inp = _step_inputs(card, cfg, model, b, t, seed=5)
    pos = prep["pos_table"][1: t + 2].contiguous()
    h = torch.empty(b, t + 1, dm, device=card)
    hb = torch.empty_like(h, dtype=torch.bfloat16)
    xa = fs.pack_xa(inp["x"], inp["xc"], prep["wst"].shape[1])
    stem = lambda a, w, out_b=hb: ck.gemm(ck.STEM, a, w, prep["bst"], h, M=b * (t + 1), pos=pos, emb=inp["emb"],
                                         t_data=t, out_b=out_b)
    with pytest.raises(ValueError, match="wgmma"):  # K = 396: rows of 792 bytes
        stem(xa[..., :2 * d].contiguous().reshape(b * t, -1), prep["wst"][:, :2 * d].contiguous())
    with pytest.raises(ValueError, match="wgmma"):  # no bf16 copy for QKV
        stem(xa.reshape(b * t, -1), prep["wst"], None)
    rows = b * (t + 1) - 1
    with pytest.raises(ValueError, match="windows"):
        ck.gemm(ck.STEM, xa.reshape(b * t, -1), prep["wst"], prep["bst"], h.reshape(-1, dm)[:rows], M=rows,
                pos=pos, emb=inp["emb"], t_data=t, out_b=hb.reshape(-1, dm)[:rows])

    def step(n, x=None):
        w = torch.zeros(n + n % 8, dm, dtype=torch.bfloat16, device=card)
        x = torch.zeros(b * t, n, device=card) if x is None else x
        ck.gemm(ck.STEP, hb, w, torch.zeros(n, device=card), torch.empty(b * t, n, device=card), M=b * t, x=x,
                noise=torch.zeros(b * t, n, device=card), t_data=t, scal=(1.0, 0.0, 0.0))

    step(d)  # the release width passes
    with pytest.raises(ValueError, match="wgmma"):  # x 8 bytes off 16-byte alignment
        step(d, torch.zeros(b * t * d + 2, device=card)[2:])
    with pytest.raises(ValueError, match="wgmma"):  # N = 256 > 208
        step(256)


@pytest.mark.parametrize("mode,m,n,k", [
    (mode, m, n, k) for mode in (ck.BIAS, ck.BIAS_RELU, ck.LAYER_NORM) for m in (7744, 726, 93)
    for n in (3072, 512, 384) for k in (512, 1024) if not (mode == ck.LAYER_NORM and n > 512)])
def test_wgmma_gemm_matches_plain(card, mode, m, n, k):
    """The three layer modes through the wgmma kernel against linear_plain
    and the epilogue's plain form: M = 64 x 121 (the path), 6 x 121 and 93
    (not multiples of the 128- or 64-row tiles), N = 3072 (QKV), 512 and 384
    (not a multiple of the 256-column tile); the LayerNorm's bf16 copy is
    its f32 output rounded, bit for bit. Values stay under 2 in magnitude,
    where a bf16 output rounding is under 2e-2."""
    g = torch.Generator(device=card).manual_seed(m + n + k)
    rn = lambda *s: torch.randn(*s, generator=g, device=card)
    bf = torch.bfloat16
    a, w, bias = rn(m, k).to(bf), (rn(n, k) * 0.25 / k ** 0.5).to(bf), 0.25 * rn(n)
    acc = fl.linear_plain(a, w) + bias
    ck.kernel_launches.clear()
    if mode == ck.LAYER_NORM:
        res, ln_s, ln_b = rn(m, n), 1 + 0.1 * rn(n), 0.1 * rn(n)
        mask = (rn(m) > -1).float()
        out, out_b = torch.empty(m, n, device=card), torch.empty(m, n, dtype=bf, device=card)
        ck.gemm(mode, a, w, bias, out, M=m, res=res, ln_s=ln_s, ln_b=ln_b, row_mask=mask, out_b=out_b)
        want = fl.layer_norm_plain(acc + res, ln_s, ln_b) * mask[:, None]
    else:
        out = torch.empty(m, n, dtype=bf, device=card)
        ck.gemm(mode, a, w, bias, out, M=m)
        want = torch.relu(acc) if mode == ck.BIAS_RELU else acc
    assert dict(ck.kernel_launches) == {"gemm_wgmma": 1}
    torch.cuda.synchronize()
    assert float((out.float() - want).abs().max()) < TOL[True]
    if mode == ck.LAYER_NORM:
        assert torch.equal(out_b, out.to(bf))


def test_wgmma_gemm_refuses_what_it_cannot_read(card):
    """The wgmma kernel reads A as bf16 and K in 16-byte rows, and writes
    bf16 outside the LayerNorm modes; the wrapper raises instead of handing
    another layout to any kernel."""
    bf = torch.bfloat16
    w, bias = torch.zeros(256, 64, dtype=bf, device=card), torch.zeros(256, device=card)
    out = torch.empty(8, 256, dtype=bf, device=card)
    with pytest.raises(ValueError, match="bf16 A"):
        ck.gemm(ck.BIAS, torch.zeros(8, 64, device=card), w, bias, out, M=8)
    with pytest.raises(ValueError, match="bf16 A"):
        ck.gemm(ck.BIAS, torch.zeros(8, 60, dtype=bf, device=card), w[:, :60].contiguous(), bias, out, M=8)
    with pytest.raises(ValueError, match="bf16 out"):
        ck.gemm(ck.BIAS, torch.zeros(8, 64, dtype=bf, device=card), w, bias, torch.empty(8, 256, device=card), M=8)


def _packed_qkv(card, b, t, seed, n_head=4, d=256):
    """A bf16 qkv (B T, 3 H d) from a seed; V's columns carry a ramp, so a
    V read transposed or with its 64-column boxes swapped cannot pass."""
    g = torch.Generator(device=card).manual_seed(seed)
    qkv = torch.randn(b * t, 3 * n_head * d, generator=g, device=card)
    qkv[:, 2 * n_head * d:] += torch.linspace(-2, 2, n_head * d, device=card)
    return qkv.to(torch.bfloat16)


@pytest.mark.parametrize("b,t,t_keys,kernel", [
    (64, 121, 121, "attention_wgmma"), (64, 31, 31, "attention_wgmma"), (1, 121, 121, "attention_wgmma"),
    (3, 41, 41, "attention_wgmma"), (5, 100, 37, "attention_wgmma"), (2, 128, 65, "attention_wgmma"),
    (2, 64, 64, "attention_wgmma"), (2, 200, 200, "attention_wmma")])
def test_layer_attention_matches_plain(card, b, t, t_keys, kernel):
    """The layer's attention launch at head width 256 in bf16 against
    attention_plain (bf16 rounding of p and ctx) on the same packed qkv:
    the main path's 64 x 121 and 64 x 31 tokens, batch 1 (eval_egoego's
    per-sequence chain), 3 x 41 (one query block, a 64-key tile), keys cut at
    t_keys < T (37 of 100: a 64-key tile over 100 queries; 65 of 128), and
    past 128 tokens, where the wrapper takes the WMMA kernel. The launch
    counts under its kernel's name."""
    qkv = _packed_qkv(card, b, t, seed=b + t + t_keys)
    ctx = torch.full((b * t, 4 * 256), float("nan"), dtype=torch.bfloat16, device=card)
    ck.kernel_launches.clear()
    ck.attention(qkv, ctx, B=b, T=t, t_keys=t_keys, n_head=4, d_k=256, d_v=256)
    assert dict(ck.kernel_launches) == {kernel: 1}
    want = fl.attention_plain(qkv, B=b, T=t, t_keys=t_keys, n_head=4, d_k=256, d_v=256, bf16=True)
    torch.cuda.synchronize()
    assert float((ctx.float() - want).abs().max()) < TOL[True]


def test_layer_attention_refuses_what_it_cannot_take(card):
    """A qkv or ctx off 16-byte alignment raises in the wrapper; nothing
    falls back to another kernel."""
    b, t, n = 2, 121, 3 * 4 * 256
    flat = torch.zeros(b * t * n + 8, dtype=torch.bfloat16, device=card)
    ctx = torch.empty(b * t, 4 * 256, dtype=torch.bfloat16, device=card)
    kw = dict(B=b, T=t, t_keys=t, n_head=4, d_k=256, d_v=256)
    ck.kernel_launches.clear()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.attention(flat[1: 1 + b * t * n].view(b * t, n), ctx, **kw)
    ctx_off = torch.empty(b * t * 4 * 256 + 8, dtype=torch.bfloat16, device=card)[4: 4 + b * t * 4 * 256]
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.attention(flat[: b * t * n].view(b * t, n), ctx_off.view(b * t, -1), **kw)
    assert not ck.kernel_launches


@pytest.mark.parametrize("b,t,d_head", [(8, 256, 256), (4, 300, 256), (1, 1024, 256), (3, 37, 24),
                                         (2, 256, 256), (3, 300, 20), (9, 130, 20)])
def test_fused_attention_matches_plain(card, b, t, d_head):
    """The mha kernel on the strided (B, H, T, d) views that
    MultiHeadAttention hands over, against its plain version: f32 on both
    sides (3xTF32 on the card), so 1e-4 bounds the summation order only.
    T = 300 and 37 leave ragged key and query tiles; (2, 256, 256) is path
    D's shape; head widths 24 and 20 are not multiples of 16 or 8, and are
    zero-padded in shared memory. On an H100 (132 SMs), (8, 256), (4, 300)
    and (9, 130) take 64-query blocks, the others 16-query blocks."""
    from egoego_release_tpu_torch.ops import attention as attn

    g = torch.Generator(device=card).manual_seed(t)
    q, k, v = (torch.randn(b, t, 4, d_head, generator=g, device=card).transpose(1, 2) for _ in range(3))
    ck.launch_counts.clear()
    ck.kernel_launches.clear()
    out_k = attn.fused_attention(q, k, v)
    assert dict(ck.launch_counts) == {"fused_attention": 1} and dict(ck.kernel_launches) == {"mha": 1}
    out_p = attn.fused_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert out_k.shape == out_p.shape == (b, 4, t, d_head)
    assert float((out_k - out_p).abs().max()) < TOL[False]


@pytest.mark.parametrize("t,t_keys,d_head", [(300, 1, 256), (300, 37, 256), (300, 65, 256),
                                             (300, 299, 20), (40, 17, 24), (600, 1, 256), (600, 300, 20)])
def test_mha_masks_keys_past_t_keys(card, t, t_keys, d_head):
    """cuda_kernels.mha with t_keys < T: keys at or past t_keys get no
    weight. t_keys = 1 and 37 leave some key groups of the first 64-key
    tile with no live key; 65 puts one live key in the second tile. T = 600
    takes 64-query blocks on an H100, T = 300 and 40 16-query blocks."""
    g = torch.Generator(device=card).manual_seed(t_keys)
    q, k, v = (torch.randn(2, t, 4, d_head, generator=g, device=card).transpose(1, 2) for _ in range(3))
    out = torch.full((2, t, 4, d_head), float("nan"), device=card).transpose(1, 2)
    ck.kernel_launches.clear()
    ck.mha(q, k, v, out, t_keys=t_keys)
    assert dict(ck.kernel_launches) == {"mha": 1}
    s = torch.matmul(q, k[:, :, :t_keys].transpose(-1, -2)) / d_head ** 0.5
    want = torch.matmul(torch.softmax(s, -1), v[:, :, :t_keys])
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) < TOL[False]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("frames", [120, 30])
def test_fused_decoder_layer_matches_plain(card, bf16, frames):
    """fused_decoder_layer at the --fused path's shape (release width,
    frames + 1 tokens, a padding-mask zero) against its plain version; it
    counts under its own name, not as decoder_layer."""
    cfg = DiffusionConfig(compute_dtype="bfloat16")
    diff = CondGaussianDiffusion(cfg, device=card, seed=0)
    lp = fl.layer_params(diff.model.motion_transformer.layer_stack[2], bf16=bf16)
    g = torch.Generator(device=card).manual_seed(frames)
    h = torch.randn(6, frames + 1, cfg.d_model, generator=g, device=card)
    mask = torch.ones(6, frames + 1, device=card)
    mask[:, -3] = 0.0
    kw = dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    ck.launch_counts.clear()
    out_k = fl.fused_decoder_layer(h, mask, lp, **kw)
    assert dict(ck.launch_counts) == {"fused_decoder_layer": 1}
    out_p = fl.decoder_layer_plain(h, mask, lp, **kw)
    torch.cuda.synchronize()
    assert float((out_k - out_p).abs().max()) < TOL[bf16]


def test_headformer_routes_long_windows_to_the_kernel(card):
    """A HeadFormer block of 256 frames goes through fused_attention once
    per layer on the card and agrees with the same model on the CPU; at 60
    frames it stays on the einsum path."""
    from egoego_release_tpu_torch.models.headnet import HeadFormer

    for window, launches in ((256, 2), (60, 0)):
        model = HeadFormer(d_model=64, n_head=2, d_k=32, d_v=32, window=window, mlp_hsize=(64,)).eval()
        x = torch.randn(2, window, 512, generator=torch.Generator().manual_seed(window))
        mask = torch.ones(2, window)
        mask[1, window // 2:] = 0.0
        with torch.no_grad():
            want = model(x, mask)
            ck.launch_counts.clear()
            got = model.to(card)(x.to(card), mask.to(card))
        assert ck.launch_counts["fused_attention"] == launches
        for a, b in zip(got, want):
            assert float((a.cpu() - b).abs().max()) < TOL[False]


def _stage1_records(n, frames, seed):
    """n stage-1 eval records of a slowly turning, walking head."""
    import numpy as np

    from egoego_release_tpu_torch.ops import alignment
    from egoego_release_tpu_torch.ops import rotations as rot

    rng = np.random.RandomState(seed)

    def quats():
        aa = np.cumsum(rng.randn(frames + 1, 3) * 0.02, 0)
        ang = np.linalg.norm(aa, axis=-1, keepdims=True)
        return np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * aa / np.maximum(ang, 1e-9)], -1).astype(np.float32)

    out = []
    for _ in range(n):
        walk = np.cumsum(rng.uniform(-0.02, 0.02, (frames + 1, 3)), 0)
        head = np.concatenate([walk + [0, 0, 1.5], quats()], -1).astype(np.float32)
        slam_q = quats()
        slam_t = (0.3 * walk + rng.randn(frames + 1, 3) * 1e-3).astype(np.float32)
        aligned, _, _ = alignment.align_slam_to_first_frame_np(slam_t, slam_q, head[0])
        out.append({"of": rng.randn(frames, 512).astype(np.float32), "head_pose": head,
                    "aligned_slam_trans": aligned, "ori_slam_trans": slam_t,
                    "ori_slam_rot_mat": rot.quat_to_matrix_np(slam_q).astype(np.float32)})
    return out


def _stage1_pipeline(device, window=256):
    """The release-width stage-1 models (random weights from a seed) in a
    pipeline on ``device``."""
    from types import SimpleNamespace

    from egoego_release_tpu_torch.eval.pipeline import EgoEgoPipeline
    from egoego_release_tpu_torch.models.denoiser import init_weights_
    from egoego_release_tpu_torch.models.gravitynet import HeadNormalFormer
    from egoego_release_tpu_torch.models.headnet import HeadFormer

    hn = init_weights_(HeadFormer(window=window), torch.Generator().manual_seed(1))
    gn = init_weights_(HeadNormalFormer(), torch.Generator().manual_seed(2))
    return EgoEgoPipeline(diffusion=SimpleNamespace(device=torch.device(device)), stats=None, rest_offsets=None,
                          headnet=hn.to(device).eval(), gravitynet=gn.to(device).eval())


def test_batched_headformer_launches_mha_once_per_layer(card):
    """headformer_forward_for_eval over 4 sequences of 300 frames at window
    256: all 8 blocks go through fused_attention as one call a layer (2
    calls, 2 mha launches), not one a sequence."""
    from egoego_release_tpu_torch.models.headnet import HeadFormer, headformer_forward_for_eval
    from egoego_release_tpu_torch.models.denoiser import init_weights_

    model = init_weights_(HeadFormer(window=256), torch.Generator().manual_seed(1)).to(card).eval()
    g = torch.Generator(device=card).manual_seed(3)
    of = torch.randn(4, 300, 512, generator=g, device=card)
    init = torch.nn.functional.normalize(torch.randn(4, 4, generator=g, device=card), dim=-1)
    slam = torch.cumsum(torch.randn(4, 301, 3, generator=g, device=card) * 0.02, 1)
    ck.launch_counts.clear()
    ck.kernel_launches.clear()
    with torch.no_grad():
        out = headformer_forward_for_eval(model, of, init, slam)
    torch.cuda.synchronize()
    assert dict(ck.launch_counts) == {"fused_attention": 2} and dict(ck.kernel_launches) == {"mha": 2}
    assert out["head_pose"].shape == (4, 301, 7) and torch.isfinite(out["head_pose"]).all()


def test_stage1_batched_on_card_matches_cpu(card):
    """stage1_head_pose_batched at window 256 on the card (the mha kernel)
    against the same pipeline on the CPU (the plain attention), 4 records
    of 300 frames: translation within 1e-3 m and quaternions within 1e-4,
    the bounds of chip_smoke.py phase 9."""
    records = _stage1_records(4, 300, seed=5)
    got = _stage1_pipeline(card).stage1_head_pose_batched(records)["head_pose"].cpu()
    want = _stage1_pipeline("cpu").stage1_head_pose_batched(records)["head_pose"]
    assert got.shape == want.shape == (4, 301, 7)
    assert float((got[..., :3] - want[..., :3]).abs().max()) < 1e-3
    assert float((got[..., 3:] - want[..., 3:]).abs().max()) < 1e-4


def _train_state(device):
    """A trainer at the release widths (window 24) and its state, weights
    from seed 0, dropout off."""
    from egoego_release_tpu_torch.models.transformer import set_dropout_rate
    from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer

    trainer = DiffusionTrainer(CondGaussianDiffusion(DiffusionConfig(window=24, compute_dtype="float32"),
                                                     device=device), lr=1e-4)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    set_dropout_rate(state.model, 0.0)
    return trainer, state


def test_train_step_on_card_matches_cpu(card):
    """The same step on the card and on the CPU (chip_smoke.py's
    train_step_agreement, its bounds): loss within 1e-5 relative; with the
    card's ReLU and l1 branches replayed on the CPU and in a float64
    reference, each gradient entry as close to float64 as the CPU's f32
    ones (1e-5 of the tensor's max, or twice the CPU's distance) and every
    parameter entry where the step does not hang on the gradient's
    rounding within 1e-5 of max|p| of the CPU's; the branches the CPU took
    otherwise sit on inputs within 1e-5 of their call's max; as each side
    runs, gradients within 1e-4 relative L2 over all tensors and 1e-3 in
    each."""
    cs = _chip_smoke()
    rng = torch.Generator().manual_seed(2)
    batch = {"motion": torch.rand(4, 24, 198, generator=rng) * 2 - 1, "seq_len": torch.tensor([24, 20, 9, 24])}
    m = cs.train_step_agreement(_train_state, batch, 1, card)
    bad = {k: m[k] for k, bound in cs.STEP_BOUNDS.items() if not m[k] <= bound}
    assert not bad, f"{bad} of {m}"


def test_fit_device_bf16_bank_on_card(card):
    """fit_device with the bank in bf16 on the card: on a bank whose values
    are bf16 already, the same steps as the f32 bank, bit for bit (the step
    casts the gathered batch back to f32); finite losses, one checkpoint."""
    import tempfile

    from egoego_release_tpu_torch.training.trainer_diffusion import DiffusionTrainer

    data = (torch.rand(16, 24, 198, generator=torch.Generator().manual_seed(3)) * 2 - 1).bfloat16().float()
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        trainer = DiffusionTrainer(CondGaussianDiffusion(DiffusionConfig(window=24, compute_dtype="float32"),
                                                         device=card), lr=1e-4)
        with tempfile.TemporaryDirectory() as d:
            state, losses = trainer.fit_device(
                trainer.init_state(torch.Generator().manual_seed(0)), data, torch.full((16,), 24), num_steps=4,
                batch_size=8, noise=fs.TorchNoise(card, 5), log_every=2, ckpt_dir=d, save_every=4,
                data_dtype=dtype)
            assert os.listdir(d) == ["model-4.pt"]
        assert state.step == 4 and len(losses) == 2 and all(map(math.isfinite, losses))
        out.append([p.detach().clone() for p in state.model.parameters()])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("tokens", [121, 31])
def test_partial_gemm_and_residual_layernorm_match_plain(card, bf16, tp, tokens):
    """The tensor-parallel layer's own launches at its shapes (64 windows,
    tp 2 and 4): fc's and w2's PARTIAL product (the bare f32 product of this
    rank's K slice) and residual_layernorm (f32 or bf16 residual; f32 out
    with its bf16 copy, or the bf16 out alone) against their plain
    versions, each counted once."""
    g = torch.Generator(device=card).manual_seed(2)
    rn = lambda *s: torch.randn(*s, generator=g, device=card)
    m, dm = 64 * tokens, 512
    wdt = torch.bfloat16 if bf16 else torch.float32
    for k in (4 * 256 // tp, dm // tp):
        a, w, bias = rn(m, k).to(wdt), (rn(dm, k) / k ** 0.5).to(wdt), rn(dm)
        out = torch.empty(m, dm, device=card)
        ck.kernel_launches.clear()
        ck.gemm_modes.clear()
        ck.gemm(ck.PARTIAL, a, w, bias, out, M=m)
        assert dict(ck.gemm_modes) == {ck.PARTIAL: 1} and sum(ck.kernel_launches.values()) == 1
        want = ck.gemm_plain(ck.PARTIAL, a, w, bias, torch.empty_like(out), M=m)
        assert float((out - want).abs().max()) <= TOL[bf16]
    p, res = rn(m, dm), rn(m, dm).to(wdt)
    s, b, mask = 1 + 0.1 * rn(dm), 0.1 * rn(dm), (rn(m) > -1).float()
    want = ck.residual_layernorm_plain(p, bias, res, s, b, mask)
    for f32_out in (True, False):
        out = torch.empty(m, dm, device=card) if f32_out else None
        out_b = torch.empty(m, dm, dtype=torch.bfloat16, device=card)
        ck.kernel_launches.clear()
        ck.residual_layernorm(p, bias, res, s, b, mask, out, out_b)
        assert dict(ck.kernel_launches) == {"residual_layernorm": 1}
        if f32_out:
            assert float((out - want).abs().max()) <= TOL[False] and torch.equal(out_b, out.to(torch.bfloat16))
        # the bf16 output: within the f32 bound plus the one bf16 ulp its own rounding adds
        assert bool(((out_b.float() - want).abs() <= TOL[False] + 2.0 ** -7 * want.abs()).all())


def test_custom_ops_match_ctypes_wrappers(card):
    """Each C entry through torch.ops.egoego (the custom op an exported
    program records) writes what its ctypes wrapper writes, bit for bit,
    and counts the same launch."""
    g = torch.Generator(device=card).manual_seed(3)
    rn = lambda *s: torch.randn(*s, generator=g, device=card)
    bf = torch.bfloat16
    m, t = 64 * 121, 120
    a, w, bias = rn(m, 512).to(bf), (rn(512, 512) / 22.6).to(bf), rn(512)
    res, s, b, mask = rn(m, 512), 1 + 0.1 * rn(512), 0.1 * rn(512), torch.ones(m, device=card)
    x, noise, ipv = rn(64 * t, 198), rn(64 * t, 198), rn(64 * t, 198)
    lw, lb, ipm = (rn(200, 512) / 22.6).to(bf), rn(198), torch.ones(64 * t, device=card)
    qkv, q = rn(m, 4 * 768).to(bf), rn(2, 4, 256, 256)
    none9 = (None,) * 9
    cases = {
        "gemm LAYER_NORM": (
            lambda o: torch.ops.egoego.gemm(a, w, bias, o[0], ck.LAYER_NORM, m, None, res, s, b, mask, None, None,
                                            None, None, None, None, o[1], 0, None),
            lambda o: ck.gemm(ck.LAYER_NORM, a, w, bias, o[0], M=m, res=res, ln_s=s, ln_b=b, row_mask=mask,
                              out_b=o[1]),
            lambda: (torch.zeros(m, 512, device=card), torch.zeros(m, 512, dtype=bf, device=card))),
        "gemm PARTIAL": (
            lambda o: torch.ops.egoego.gemm(a, w, bias, o[0], ck.PARTIAL, m, *none9, None, None, None, 0, None),
            lambda o: ck.gemm(ck.PARTIAL, a, w, bias, o[0], M=m),
            lambda: (torch.zeros(m, 512, device=card),)),
        "gemm STEP": (
            lambda o: torch.ops.egoego.gemm(a, lw, lb, o[0], ck.STEP, 64 * t, None, None, None, None, None, None,
                                            None, x, noise, ipv, ipm, None, t, torch.tensor([0.9, 0.1, 0.05])),
            lambda o: ck.gemm(ck.STEP, a, lw, lb, o[0], M=64 * t, x=x, noise=noise, ipv=ipv, ipm=ipm, t_data=t,
                              scal=(0.9, 0.1, 0.05)),
            lambda: (torch.zeros(64 * t, 198, device=card),)),
        "attention": (
            lambda o: torch.ops.egoego.attention(qkv, o[0], 64, 121, 121, 4, 256, 256),
            lambda o: ck.attention(qkv, o[0], B=64, T=121, t_keys=121, n_head=4, d_k=256, d_v=256),
            lambda: (torch.zeros(m, 1024, dtype=bf, device=card),)),
        "mha": (
            lambda o: torch.ops.egoego.mha(q, q, q, o[0], 256),
            lambda o: ck.mha(q, q, q, o[0], t_keys=256),
            lambda: (torch.zeros(2, 4, 256, 256, device=card),)),
        "residual_layernorm": (
            lambda o: torch.ops.egoego.residual_layernorm(res, bias, res, s, b, mask, o[0], o[1]),
            lambda o: ck.residual_layernorm(res, bias, res, s, b, mask, o[0], o[1]),
            lambda: (torch.zeros(m, 512, device=card), torch.zeros(m, 512, dtype=bf, device=card))),
    }
    for name, (op, wrapper, outputs) in cases.items():
        got = []
        for call in (op, wrapper):
            o = outputs()
            ck.kernel_launches.clear()
            call(o)
            torch.cuda.synchronize()
            got.append((o, dict(ck.kernel_launches)))
        assert got[0][1] == got[1][1], name
        assert all(torch.equal(u, v) for u, v in zip(got[0][0], got[1][0])), name
