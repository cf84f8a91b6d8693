"""The port's stage-2 training data against the JAX package on the CPU:
FK's local-to-global matrices, the AMASS window dataset (windows, items,
stats files, batches) and the prefetch thread. Tolerance 1e-5 absolute
on items (f32 FK and normalization, summed in other orders)."""

import pickle
import time

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from egoego_release_tpu.data import formats as jformats
from egoego_release_tpu.data.amass import AMASSWindowDataset as JDataset
from egoego_release_tpu.ops import fk as jfk
from egoego_release_tpu_torch.data import formats
from egoego_release_tpu_torch.data.amass import AMASSWindowDataset, process_window_data
from egoego_release_tpu_torch.data.prefetch import PrefetchIterator, prefetch_to_device
from egoego_release_tpu_torch.ops import fk

WINDOW = 40
# 100 frames: 4 full windows (the fifth, 20 frames, is skipped); 75
# frames: 2 full windows and one of 35 frames (padded), the last skipped
LENGTHS = (100, 75)


def _motion_pickle(path, lengths=LENGTHS, seed=0):
    rng = np.random.RandomState(seed)
    data = {}
    for i, t in enumerate(lengths):
        data[i] = {"trans": np.cumsum(rng.uniform(-0.02, 0.02, (t, 3)), 0).astype(np.float32),
                   "root_orient": rng.uniform(-0.6, 0.6, (t, 3)).astype(np.float32),
                   "body_pose": rng.uniform(-0.3, 0.3, (t, 63)).astype(np.float32),
                   "seq_name": f"seq{i}"}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    rest = np.concatenate([np.zeros((1, 3)), rng.uniform(-0.2, 0.2, (21, 3))]).astype(np.float32)
    return rest


def test_local_to_global_matrix_matches_jax():
    rng = np.random.RandomState(0)
    aa = rng.uniform(-1, 1, (3, 22, 3)).astype(np.float32)
    from egoego_release_tpu.ops import rotations as jrot

    local = np.asarray(jrot.axis_angle_to_matrix(jnp.asarray(aa)))
    want = np.asarray(jfk.local_to_global_matrix(jnp.asarray(local)))
    got = fk.local_to_global_matrix(torch.from_numpy(local)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("amass")
    rest = _motion_pickle(tmp / "train.p")
    out = {}
    for cano in (True, False):
        out[cano] = (JDataset(str(tmp / "train.p"), rest, window=WINDOW, canonicalize_init_head=cano),
                     AMASSWindowDataset(str(tmp / "train.p"), rest, window=WINDOW, canonicalize_init_head=cano))
    return tmp, rest, out


@pytest.mark.parametrize("cano", [True, False])
def test_windows_and_items_match_jax(datasets, cano):
    _, _, out = datasets
    jds, tds = out[cano]
    assert len(tds) == len(jds) == 7
    for i in range(len(jds)):
        jw, tw = jds.windows[i], tds.windows[i]
        assert (tw["seq_name"], tw["start_t_idx"], tw["end_t_idx"]) == (
            jw["seq_name"], jw["start_t_idx"], jw["end_t_idx"])
        for k in ("global_jpos", "global_jvel", "global_rot_6d"):
            np.testing.assert_allclose(tw[k], jw[k], rtol=0, atol=1e-5, err_msg=f"{i} {k}")
        ji, ti = jds[i], tds[i]
        assert ti["seq_len"] == ji["seq_len"] and ti["motion"].shape == (WINDOW, 198)
        np.testing.assert_allclose(ti["motion"], ji["motion"], rtol=0, atol=1e-5, err_msg=str(i))
    assert sorted({tds[i]["seq_len"] for i in range(len(tds))}) == [35, 40]
    for a, b in zip(tds.materialize_windows(), jds.materialize_windows()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_process_window_data_matches_jax(datasets):
    from egoego_release_tpu.data.amass import process_window_data as jprocess

    _, rest, _ = datasets
    rng = np.random.RandomState(3)
    args = (np.cumsum(rng.uniform(-0.02, 0.02, (33, 3)), 0), rng.uniform(-0.6, 0.6, (33, 3)),
            rng.uniform(-0.3, 0.3, (33, 21, 3)))
    args = [a.astype(np.float32) for a in args]
    want = jprocess(*(jnp.asarray(a) for a in args), jnp.asarray(rest))
    got = process_window_data(*args, rest)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5, err_msg=k)


def test_stats_files_cross_read(datasets):
    """The stats pickle each package writes, the other reads (JAX's
    joblib.dump; the port's plain pickle of numpy arrays)."""
    tmp, rest, _ = datasets
    jds = JDataset(str(tmp / "train.p"), rest, window=WINDOW, stats_path=str(tmp / "j_stats.p"))
    tds = AMASSWindowDataset(str(tmp / "train.p"), rest, window=WINDOW, stats_path=str(tmp / "t_stats.p"))
    t_by_j = formats.load_norm_stats(str(tmp / "j_stats.p"))
    j_by_t = jformats.load_norm_stats(str(tmp / "t_stats.p"))
    for a, b in ((t_by_j.jpos_min, jds.stats.jpos_min), (t_by_j.jpos_max, jds.stats.jpos_max),
                 (j_by_t.jpos_min, tds.stats.jpos_min), (j_by_t.jpos_max, tds.stats.jpos_max)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-5)
    raw_t, raw_j = joblib.load(tmp / "t_stats.p"), formats.load_pickle(str(tmp / "j_stats.p"))
    assert set(raw_t) == set(raw_j)
    for k in raw_t:
        np.testing.assert_allclose(raw_t[k], raw_j[k], rtol=0, atol=1e-5, err_msg=k)
    # a second dataset reads the stats file instead of recomputing it
    again = AMASSWindowDataset(str(tmp / "train.p"), rest, window=WINDOW, stats_path=str(tmp / "j_stats.p"))
    np.testing.assert_array_equal(again.stats.jpos_max.numpy(), t_by_j.jpos_max.numpy())


@pytest.mark.parametrize("batch_size", [3, 16])
def test_batch_iterator_matches_jax(datasets, batch_size):
    """Given the seed JAX draws from its key, the same batches in the same
    order (16 > 7 windows: sampled with replacement)."""
    _, _, out = datasets
    jds, tds = out[True]
    key = jax.random.PRNGKey(4)
    seed = int(jax.random.randint(key, (), 0, 2**31 - 1))
    jit, tit = jds.batch_iterator(batch_size, key), tds.batch_iterator(batch_size, seed)
    for _ in range(5):
        jb, tb = next(jit), next(tit)
        np.testing.assert_array_equal(tb["seq_len"], jb["seq_len"])
        np.testing.assert_allclose(tb["motion"], jb["motion"], rtol=0, atol=1e-5)


# -- prefetch ----------------------------------------------------------------

def test_prefetch_preserves_order_and_values():
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(7)]
    out = list(PrefetchIterator(iter(batches), prefetch=3))
    assert len(out) == 7
    for i, b in enumerate(out):
        np.testing.assert_array_equal(b["x"], batches[i]["x"])


def test_prefetch_to_device_gives_tensors():
    batches = [{"x": np.ones((2, 2), np.float32) * i, "n": np.arange(2, dtype=np.int32)} for i in range(3)]
    out = list(prefetch_to_device(iter(batches), device="cpu"))
    assert all(isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu" for b in out)
    np.testing.assert_array_equal(out[2]["x"].numpy(), batches[2]["x"])
    assert out[0]["n"].dtype == torch.int32


def test_prefetch_overlaps_loading():
    """A slow producer and a slow consumer take about max(producer,
    consumer), not their sum."""
    n, delay = 6, 0.05

    def slow_batches():
        for i in range(n):
            time.sleep(delay)
            yield {"x": np.full((1,), i, np.float32)}

    t0 = time.perf_counter()
    for _ in PrefetchIterator(slow_batches(), prefetch=2):
        time.sleep(delay)
    assert time.perf_counter() - t0 < 1.7 * n * delay


def test_prefetch_propagates_errors():
    def bad():
        yield {"x": np.zeros(1)}
        raise ValueError("boom")

    it = PrefetchIterator(bad(), device="cpu")
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)
