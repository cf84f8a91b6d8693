"""The port's host-side visualization (vis/plots.py, vis/blender_driver.py,
vis/bpy_scripts/*) against the JAX package's, on the CPU.

Both packages run the same host code, so on the same inputs they must
write the same files, byte for byte (matplotlib's Agg PNGs and Pillow's
GIF are deterministic). Blender is not installed here: the driver runs a
stub binary that records its argv, and the three bpy scripts run under the
stub ``bpy`` module of ``tests/test_bpy_scripts.py``; each port script must
leave the same frames and the same scene objects as JAX's.
"""

import importlib
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from egoego_release_tpu.vis import blender_driver as jbd
from egoego_release_tpu.vis import plots as jplots
from egoego_release_tpu_torch.vis import blender_driver as tbd
from egoego_release_tpu_torch.vis import plots as tplots
from test_bpy_scripts import SCRIPTS_DIR as JAX_SCRIPTS_DIR
from test_bpy_scripts import _make_fake_bpy, _write_objs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("render_human", "render_cmp", "render_headpose")


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


def test_plots_write_the_same_files(tmp_path):
    assert tplots._BONES == jplots._BONES
    rng = np.random.RandomState(0)
    t = 30
    trans = np.cumsum(rng.randn(t, 3) * 0.05, 0)
    rot = np.stack([np.eye(3)] * t) @ np.linalg.qr(rng.randn(3, 3))[0]
    jpos = rng.randn(1, 5, 22, 3).astype(np.float32)
    for pkg, plots in (("jax", jplots), ("port", tplots)):
        d = tmp_path / pkg
        d.mkdir()
        plots.vis_head_pose_traj(trans, rot, str(d / "traj3d.png"), gt_head_trans=trans + 0.1)
        plots.vis_head_pose_traj(trans, None, str(d / "traj3d_norot.png"))
        plots.vis_head_traj_2d(trans, str(d / "traj2d.png"), gt_head_trans=trans - 0.1)
        plots.show3dpose_animation(jpos, str(d / "anim.gif"), fps=5)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 4
    for name in names:
        assert os.path.getsize(tmp_path / "jax" / name) > 1000
        _same_file(tmp_path / "jax" / name, tmp_path / "port" / name)


def test_plots_import_matplotlib_lazily():
    """The card machine lists no matplotlib: importing the module must not
    need it."""
    code = ("import sys; import egoego_release_tpu_torch.vis.plots; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


def _stub_blender(tmp_path, monkeypatch):
    log = tmp_path / "argv.txt"
    stub = tmp_path / "blender"
    stub.write_text(f'#!/bin/sh\necho "$@" > {log}\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("BLENDER_PATH", str(stub))
    return log


def test_blender_driver_invokes_the_stub_as_jax_does(tmp_path, monkeypatch):
    log = _stub_blender(tmp_path, monkeypatch)
    argvs = []
    for bd in (jbd, tbd):
        assert bd.find_blender() == str(tmp_path / "blender")
        assert bd.run_blender_rendering(str(tmp_path / "objs"), str(tmp_path / "frames"), "/s/render.py",
                                        scene_blend="/s/scene.blend")
        argvs.append(log.read_text().split())
    assert argvs[1] == argvs[0] == ["-b", "/s/scene.blend", "-P", "/s/render.py", "--", "--folder",
                                    str(tmp_path / "objs"), "--out-folder", str(tmp_path / "frames")]
    assert os.path.isdir(tmp_path / "frames")


def test_blender_driver_points_at_its_own_scripts(tmp_path, monkeypatch):
    log = _stub_blender(tmp_path, monkeypatch)
    assert tbd.BPY_SCRIPTS_DIR == os.path.join(REPO, "egoego_release_tpu_torch", "vis", "bpy_scripts")
    for name in SCRIPTS:
        path = tbd.bpy_script_path(name)
        assert path == tbd.bpy_script_path(name + ".py") and os.path.isfile(path)
    assert tbd.run_blender_rendering(str(tmp_path), str(tmp_path / "o"), tbd.bpy_script_path("render_human"))
    assert log.read_text().split()[2] == tbd.bpy_script_path("render_human")
    with pytest.raises(FileNotFoundError):
        tbd.bpy_script_path("render_missing")


def test_blender_driver_without_a_binary(tmp_path, monkeypatch):
    monkeypatch.setenv("BLENDER_PATH", "")
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tbd.find_blender() is None
    assert not tbd.run_blender_rendering(str(tmp_path), str(tmp_path / "o"), "s.py")


def test_frames_to_video_as_jax(tmp_path):
    imageio = pytest.importorskip("imageio")
    from PIL import Image

    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        Image.fromarray(np.full((8, 8, 3), i * 60, np.uint8)).save(frames / f"{i:04d}.png")
    outs = []
    for pkg, bd in (("jax", jbd), ("port", tbd)):
        out = tmp_path / pkg / "out.mp4"
        out.parent.mkdir()
        assert bd.frames_to_video(str(frames), str(out), fps=5)
        written = out if out.exists() else tmp_path / pkg / "out.gif"
        outs.append(np.asarray([np.asarray(f) for f in imageio.mimread(written)]))
    np.testing.assert_array_equal(outs[1], outs[0])


def _run_script(monkeypatch, scripts_dir, name, argv_of):
    """Import ``name`` from ``scripts_dir`` under a fresh stub bpy, run its
    render_sequence; -> (frames written, the scene's objects)."""
    bpy = _make_fake_bpy()
    monkeypatch.setitem(sys.modules, "bpy", bpy)
    for mod in SCRIPTS:
        sys.modules.pop(mod, None)
    monkeypatch.syspath_prepend(scripts_dir)
    try:
        script = importlib.import_module(name)
        assert os.path.dirname(script.__file__) == scripts_dir
        n = script.render_sequence(script.parse_args(argv_of()))
    finally:
        sys.path.remove(scripts_dir)
        for mod in SCRIPTS:
            sys.modules.pop(mod, None)
    objects = [(o.name, o.kind, tuple(o.location), tuple(o.rotation_quaternion), o.rotation_mode)
               for o in bpy.data.objects]
    return n, objects, sorted(m.name for m in bpy.data.materials)


@pytest.mark.parametrize("name", SCRIPTS)
def test_bpy_scripts_match_jax(tmp_path, monkeypatch, name):
    rng = np.random.RandomState(3)
    _write_objs(tmp_path / "a", 3)
    _write_objs(tmp_path / "b", 4)
    head = np.concatenate([rng.randn(5, 3) * 0.1 + [0, 0, 1.6], np.tile([1.0, 0, 0, 0], (5, 1))], -1)
    np.save(tmp_path / "head.npy", head)
    outs = {}
    for pkg, d in (("jax", JAX_SCRIPTS_DIR), ("port", tbd.BPY_SCRIPTS_DIR)):
        out = tmp_path / f"frames_{pkg}"
        argv = {"render_human": ["--folder", str(tmp_path / "a"), "--out-folder", str(out), "--material-color",
                                 "orange", "--head-path", str(tmp_path / "head.npy")],
                "render_cmp": ["--folder", str(tmp_path / "a"), "--folder2", str(tmp_path / "b"), "--out-folder",
                               str(out), "--offset2", "1.5", "0", "0"],
                "render_headpose": ["--head-path", str(tmp_path / "head.npy"), "--out-folder", str(out)]}[name]
        n, objects, materials = _run_script(monkeypatch, d, name, lambda: list(argv))
        outs[pkg] = (n, objects, materials, sorted(os.listdir(out)))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == len(outs["port"][3]) > 0
