"""The reverse step's step table and captured-step key (ops/fused_step.py)
on the CPU: a row of the step table gives the update the results of the
scalars' tuple in the plain versions and in the exported loop's body; the
key of a captured step ignores the schedule and tells shapes, dtypes and
inpaint apart; off the card, while ``torch.export`` traces and with a
tensor-parallel layer the loop launches its steps eagerly. The graphs
themselves run on the card (tests/test_torch_cuda.py)."""

import pytest
import torch

from egoego_release_tpu_torch.diffusion.gaussian_diffusion import CondGaussianDiffusion, DiffusionConfig
from egoego_release_tpu_torch.ops import cuda_kernels as ck
from egoego_release_tpu_torch.ops import fused_step as fs

CFG = dict(d_model=32, n_head=2, n_dec_layers=2, d_k=16, d_v=16, window=12, timesteps=6, overlap_frames=4)
SCAL = {False: (0.9, 0.1, 0.05), True: (0.9, 0.1, 0.05, 1.02, 0.17)}


def small(**kw):
    return CondGaussianDiffusion(DiffusionConfig(**{**CFG, **kw}), device="cpu", seed=0)


def table_row(scal, embs):
    """Row 1 of a step table of three rows, ``scal`` its scalars: (token, scal)."""
    table = fs.step_table(embs, [(0, (0.5,) * len(scal)), (1, scal), (2, (0.25,) * len(scal))])
    dm = embs.shape[1]
    return table[1, :dm], table[1, dm: dm + len(scal)]


@pytest.mark.parametrize("pred_noise", [False, True])
def test_step_table_row_gives_the_tuples_results(pred_noise):
    """step_update_plain and gemm_plain's STEP with the scalars as a row of
    the step table equal their results with the tuple, bit for bit, and the
    row holds the token and the scalars as given."""
    g = torch.Generator().manual_seed(0)
    bsz, t, d, dm = 2, 5, 6, 8
    r = lambda *s: torch.randn(*s, generator=g)
    prep = {"lw": r(d, dm), "lb": r(d)}
    h, x, noise, ipv = r(bsz, t + 1, dm), r(bsz, t, d), r(bsz, t, d), r(bsz, t, d)
    ipm = (torch.arange(t) < 2).float().expand(bsz, t).contiguous()
    scal, embs = SCAL[pred_noise], r(3, dm)
    emb, row = table_row(scal, embs)
    assert torch.equal(row, torch.tensor(scal)) and torch.equal(emb, embs[1])
    for iv, im in ((None, None), (ipv, ipm)):
        assert torch.equal(fs.step_update_plain(h, x, noise, row, iv, im, prep),
                           fs.step_update_plain(h, x, noise, scal, iv, im, prep))
        outs = []
        for s in (scal, row):
            out, xa = torch.empty(bsz * t, d), torch.zeros(bsz * t, 8)
            ck.gemm_plain(ck.STEP, h.reshape(-1, dm), prep["lw"], prep["lb"], out, M=bsz * t, x=x, noise=noise,
                          ipv=iv, ipm=im, t_data=t, scal=s, out_b=xa)
            outs.append((out, xa))
        assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("inpaint", [False, True])
def test_loop_and_exported_body_read_the_table_as_the_tuples(inpaint):
    """The CPU reverse loop (step i reading row i of its step table) and
    the exported loop's body run eagerly (``_traced_loop``) equal a loop of
    fused_denoise_step calls with each step's token and tuple of scalars,
    bit for bit, on the same draws."""
    diff = small()
    cfg = diff.cfg
    bsz, t, d = 2, cfg.window, cfg.d_feats
    g = torch.Generator().manual_seed(3)
    x_start = torch.randn(bsz, t, d, generator=g).clamp(-1, 1)
    cond_mask = torch.ones_like(x_start)
    ipv, ipm = (torch.randn(bsz, t, d, generator=g), (torch.arange(t) < 4).float()[None, :, None].repeat(bsz, 1, 1)
                ) if inpaint else (None, None)
    got = fs.fused_p_sample_loop(diff, x_start, cond_mask, None, ipv, ipm, noise=fs.TorchNoise("cpu", seed=4))

    noise = fs.TorchNoise("cpu", seed=4)
    prep, kw = diff.step_params(), dict(n_head=cfg.n_head, d_k=cfg.d_k, d_v=cfg.d_v)
    x = noise.initial((bsz, t, d))
    x_cond = x_start * (1.0 - cond_mask) + cond_mask * noise.cond((bsz, t, d))
    mask, pos = torch.ones(bsz, t + 1), prep["pos_table"][1: t + 2]
    iv, im = (ipv, ipm[..., 0]) if inpaint else (None, None)
    sched = fs.ddpm_scalars(diff.consts, cfg.timesteps)
    embs = fs.noise_level_embeddings(diff.model, [s[0] for s in sched])
    draws = [noise.step((bsz, t, d)) for _ in sched]
    want = x
    for i, (_, scal) in enumerate(sched):
        want = fs.fused_denoise_step(want, x_cond, embs[i], pos, mask, draws[i], scal, iv, im, prep, **kw)
    assert torch.equal(got, want)
    stacked = torch.stack(draws)
    traced = fs._traced_loop(x, x_cond, fs.step_table(embs, sched), 3, pos, mask, iv, im, prep, None,
                             lambda i: stacked.index_select(0, i.reshape(1))[0], False, kw)
    assert torch.equal(traced, want)


def test_graph_key_ignores_the_schedule_and_tells_shapes_apart():
    """One key for a DDPM-1000 and a DDIM-3 window of one shape; another for
    another batch, frame count, inpaint, activation dtype or objective. The
    operands, and with them the compute dtype, are the cache's own: each
    diffusion keeps its ``StepGraphs``."""
    diff = small(timesteps=1000)
    ddpm, ddim = fs.ddpm_scalars(diff.consts, 1000), fs.ddim_scalars(diff.consts, 1000, 3)
    key = lambda bsz=4, t=120, act_bf16=False, n_scal=3, inpaint=True: fs.step_graph_key(
        "cpu", bsz, t, act_bf16=act_bf16, n_scal=n_scal, inpaint=inpaint)
    assert key(n_scal=len(ddpm[0][1])) == key(n_scal=len(ddim[0][1])) == key()
    other = [key(bsz=5), key(t=30), key(inpaint=False), key(act_bf16=True), key(n_scal=5)]
    assert len({key(), *other}) == len(other) + 1
    assert small().step_graphs is not diff.step_graphs


def test_loop_launches_eagerly_off_the_card(monkeypatch):
    """The captured step engages on the card alone: not on the CPU, not
    while torch.export traces, not with a tensor-parallel layer; a CPU
    window asks for no graph and counts no step on the card."""
    diff = small()
    prep = diff.step_params()
    assert fs.graphs_engage(torch.device("cuda"), prep) and not fs.graphs_engage(torch.device("cpu"), prep)
    tp = {**prep, "layers": [{**lp, "tp": object()} for lp in prep["layers"]]}
    assert not fs.graphs_engage(torch.device("cuda"), tp)
    with monkeypatch.context() as m:
        m.setattr(ck, "tracing", lambda: True)
        assert not fs.graphs_engage(torch.device("cuda"), prep)

    def refuse(*args, **kw):
        raise AssertionError("a CPU window asked for a captured step")

    monkeypatch.setattr(fs.StepGraphs, "get", refuse)
    before = dict(ck.step_graphs)
    x = torch.zeros(2, diff.cfg.window, diff.cfg.d_feats)
    out = fs.fused_p_sample_loop(diff, x, torch.ones_like(x), noise=fs.TorchNoise("cpu", seed=0))
    assert torch.isfinite(out).all() and dict(ck.step_graphs) == before
