"""The operands and row maps of the stem's and the update's GEMM
(csrc/gemm.cu kStem / kStep on the wgmma kernel) against the JAX package,
on the CPU.

- ``pack_xa``: the stem's packed bf16 A, [bf16(x) | bf16(x_cond) | 0], is
  the rounding _stem_layer_kernel does at ``x_ref[:].astype(cdt)``, bit for
  bit (ties included).
- ``prepare_step_params``: wst (512, 400) and lw (200, 512) are JAX's wsx /
  wsc / lw (egoego_release_tpu/ops/fused_step.py:101-104) transposed and
  zero-padded, bit for bit, in f32 and bf16.
- The kernels' row maps, mirrored here: the stem's product row r (frame r %
  T of window r / T) goes to output row r + r / T + 1, and a window's token
  0 is written by the warpgroup (64 product rows) that holds its first data
  row; the update's product row r (token r % (T+1) of window r / (T+1))
  goes to output row (r / (T+1)) T + r % (T+1) - 1 unless it is a token 0,
  and each 64-row tile's output rows are the contiguous span [o_lo, o_hi)
  that the epilogue streams. They rebuild stem_tokens_plain's token layout
  and step_update_plain's h[:, 1:T+1].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egoego_release_tpu.diffusion import CondGaussianDiffusion as JDiffusion
from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu.ops import fused_step as jfs
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import DiffusionConfig, new_denoiser
from egoego_release_tpu_torch.ops import fused_step as tfs
from egoego_release_tpu_torch.ops.fused_layer import linear_plain
from egoego_release_tpu_torch.utils.convert import denoiser_state_dict_from_jax, load_denoiser_weights

D = 198  # features of a frame (joint positions + rot6d)
TILE_ROWS = 64  # product rows of a kStep tile, and of one kStem warpgroup


# -- mirrors of the kernels' row maps (csrc/gemm.cu) ------------------------


def stem_out_row(r, t):
    """store_block_f32: product row r -> output row."""
    return r + r // t + 1


def stem_token0_windows(r_lo, rows, t):
    """The windows whose token 0 the warpgroup of product rows [r_lo, r_lo +
    64) writes: those whose first data row b t lies among them."""
    r_hi = min(r_lo + TILE_ROWS, rows)
    return list(range((r_lo + t - 1) // t, (r_hi - 1) // t + 1)) if r_hi > r_lo else []


def step_out_row(r, t):
    """kStep: product row r -> output row, or -1 for a token 0."""
    k = r % (t + 1)
    return torch.where(k == 0, -1, r // (t + 1) * t + k - 1)


def step_span(m0, rows, t):
    """kStep: the output rows [o_lo, o_hi) of the tile at product row m0."""
    last = min(m0 + TILE_ROWS, rows) - 1
    return m0 // (t + 1) * t + max(m0 % (t + 1) - 1, 0), last // (t + 1) * t + last % (t + 1)


# -- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def release():
    """JAX params at the release widths and the port's model on them."""
    jcfg = JConfig()
    params = JDiffusion(jcfg).init_params(jax.random.PRNGKey(0), bs=1)
    model = load_denoiser_weights(new_denoiser(DiffusionConfig()), denoiser_state_dict_from_jax(params))
    return jcfg, params, model


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


# -- tests ---------------------------------------------------------------------


@pytest.mark.parametrize("t", [120, 30, 13])
def test_pack_xa_is_the_stem_kernels_rounding(t):
    """xa = [bf16(x) | bf16(x_cond) | 0] (B, T, 400), bit for bit JAX's
    astype(bfloat16) of each: random values, values a bf16 ulp apart, and
    exact ties (low 16 bits 0x8000) that round to even."""
    rng = np.random.RandomState(t)
    x, xc = (rng.randn(3, t, D).astype(np.float32) * 3 for _ in range(2))
    ties = x.view(np.uint32)
    ties[0, ::2] = (ties[0, ::2] & 0xFFFF0000) | 0x8000
    xa = tfs.pack_xa(torch.from_numpy(x), torch.from_numpy(xc))
    assert xa.shape == (3, t, 400) and xa.dtype == torch.bfloat16
    want = jnp.concatenate([jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(xc).astype(jnp.bfloat16),
                            jnp.zeros((3, t, 4), jnp.bfloat16)], -1)
    np.testing.assert_array_equal(_bits(xa.view(torch.int16).numpy()), _bits(want))


@pytest.mark.parametrize("bf16", [False, True])
def test_step_weights_are_jax_weights_transposed_and_padded(release, bf16):
    """wst (512, 400): columns 0-197 JAX's wsx, 198-395 its wsc, 396-399
    zero; lw (200, 512): rows 0-197 JAX's lw columns, 198-199 zero; both in
    the compute dtype, bit for bit."""
    jcfg, params, model = release
    cdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jprep = jfs.prepare_step_params(params, jcfg, cdt, 256)
    tprep = tfs.prepare_step_params(model, bf16)
    wst, lw = tprep["wst"], tprep["lw"]
    assert wst.shape == (512, 400) and lw.shape == (200, 512) and wst.dtype == lw.dtype == tdt
    as_np = lambda a: a.float().numpy()
    np.testing.assert_array_equal(as_np(wst[:, :D]), np.asarray(jprep["wsx"][:D].T, np.float32))
    np.testing.assert_array_equal(as_np(wst[:, D: 2 * D]), np.asarray(jprep["wsc"][:D].T, np.float32))
    np.testing.assert_array_equal(as_np(lw[:D]), np.asarray(jprep["lw"][:, :D].T, np.float32))
    assert not wst[:, 2 * D:].any() and not lw[D:].any()
    np.testing.assert_array_equal(tprep["lb"].numpy(), np.asarray(jprep["lb"][0, :D]))


@pytest.mark.parametrize("bsz,t", [(64, 120), (64, 30), (5, 13)])
def test_stem_row_map_rebuilds_the_token_layout(release, bsz, t):
    """The stem kernel's epilogue as a mirror: the product rows plus bias and
    position row r % T + 1 scattered to rows r + r / T + 1, and token 0
    (emb + pos[0]) of each window by the warpgroup holding its first data
    row (each window exactly once), rebuild stem_tokens_plain."""
    _, _, model = release
    prep = tfs.prepare_step_params(model, bf16=False)
    rng = np.random.RandomState(bsz + t)
    x, xc = (torch.from_numpy(rng.randn(bsz, t, D).astype(np.float32)) for _ in range(2))
    emb = torch.from_numpy(rng.randn(512).astype(np.float32))
    pos = prep["pos_table"][1: t + 2].contiguous()
    want = tfs.stem_tokens_plain(x, xc, emb, pos, prep).reshape(bsz * (t + 1), -1)

    rows = bsz * t
    r = torch.arange(rows)
    prod = (linear_plain(x.reshape(rows, D), prep["wst"][:, :D])
            + linear_plain(xc.reshape(rows, D), prep["wst"][:, D: 2 * D]))
    out = torch.full_like(want, float("nan"))
    out[stem_out_row(r, t)] = (prod + prep["bst"]) + pos[r % t + 1]
    token0 = [b for r_lo in range(0, rows, TILE_ROWS) for b in stem_token0_windows(r_lo, rows, t)]
    assert sorted(token0) == list(range(bsz))
    out[torch.tensor(token0) * (t + 1)] = emb + pos[0]
    torch.testing.assert_close(out, want, rtol=0, atol=0)


@pytest.mark.parametrize("bsz,t", [(64, 120), (64, 30), (5, 13)])
def test_step_row_map_rebuilds_the_update_rows(release, bsz, t):
    """The update kernel's map as a mirror: its product rows over all B
    (T+1) tokens, token 0 dropped, land on step_update_plain's h[:, 1:T+1];
    each 64-row tile's output rows are exactly its span [o_lo, o_hi), and
    the spans tile the output rows in order with no gap or overlap."""
    _, _, model = release
    prep = tfs.prepare_step_params(model, bf16=False)
    rng = np.random.RandomState(t)
    h = torch.from_numpy(rng.randn(bsz, t + 1, 512).astype(np.float32))
    rows = bsz * (t + 1)
    o = step_out_row(torch.arange(rows), t)
    keep = o >= 0
    prod = torch.clamp(linear_plain(h.reshape(rows, 512), prep["lw"][:D]) + prep["lb"], -1, 1)
    x0 = torch.full((bsz * t, D), float("nan"))
    x0[o[keep]] = prod[keep]
    zeros = torch.zeros(bsz, t, D)
    want = tfs.step_update_plain(h, zeros, zeros, (1.0, 0.0, 0.0), None, None, prep)
    torch.testing.assert_close(x0.reshape(bsz, t, D), want, rtol=0, atol=0)
    end = 0
    for m0 in range(0, rows, TILE_ROWS):
        lo, hi = step_span(m0, rows, t)
        assert o[m0: m0 + TILE_ROWS][keep[m0: m0 + TILE_ROWS]].tolist() == list(range(lo, hi))
        assert lo == end
        end = hi
    assert end == bsz * t
