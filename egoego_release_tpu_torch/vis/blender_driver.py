"""Blender rendering driver (host-side, optional; port of
egoego_release_tpu/vis/blender_driver.py, copied).

Port of egoego/vis/blender_vis_mesh_motion.py:34-101
(run_blender_rendering_and_save2video*): writes per-frame OBJ meshes (via
vis/mesh_export.py) and, when a Blender binary is available, shells out to
render them with a user-supplied bpy script, then stitches frames to video
with imageio/ffmpeg.  Unlike the reference, the Blender path is discovered
(PATH or $BLENDER_PATH) instead of hardcoded (:45,:67).
"""

from __future__ import annotations

import os
import shutil
import subprocess


BPY_SCRIPTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpy_scripts")


def bpy_script_path(name: str) -> str:
    """The path of one of the port's own bpy scripts under ``BPY_SCRIPTS_DIR``
    (``render_human``, ``render_cmp``, ``render_headpose``), for
    ``run_blender_rendering``'s ``bpy_script``."""
    path = os.path.join(BPY_SCRIPTS_DIR, name if name.endswith(".py") else name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no bpy script {name!r} in {BPY_SCRIPTS_DIR}")
    return path


def find_blender() -> str | None:
    return os.environ.get("BLENDER_PATH") or shutil.which("blender")


def run_blender_rendering(
    obj_folder: str,
    out_folder: str,
    bpy_script: str,
    scene_blend: str | None = None,
    blender_path: str | None = None,
) -> bool:
    """Render an OBJ sequence with Blender + a bpy script.  Returns False
    (with a message) when Blender is unavailable — rendering is optional."""
    blender = blender_path or find_blender()
    if blender is None:
        print("Blender not found (set $BLENDER_PATH); skipping rendering")
        return False
    os.makedirs(out_folder, exist_ok=True)
    cmd = [blender, "-b"]
    if scene_blend:
        cmd += [scene_blend]
    cmd += ["-P", bpy_script, "--", "--folder", obj_folder, "--out-folder", out_folder]
    subprocess.run(cmd, check=True)
    return True


def frames_to_video(frame_folder: str, out_path: str, fps: int = 30) -> bool:
    """PNG frames -> video via imageio (reference uses imageio/ffmpeg)."""
    try:
        import imageio
    except ImportError:
        print("imageio not available; skipping video stitching")
        return False
    frames = sorted(
        os.path.join(frame_folder, f)
        for f in os.listdir(frame_folder)
        if f.endswith(".png")
    )
    if not frames:
        return False
    try:
        writer = imageio.get_writer(out_path, fps=fps)
    except (ValueError, OSError) as e:
        # no ffmpeg plugin in this environment: fall back to an animated GIF
        # (imageio's built-in pillow plugin) rather than failing the export
        gif_path = os.path.splitext(out_path)[0] + ".gif"
        print(f"video writer unavailable ({e}); writing {gif_path} instead")
        out_path = gif_path
        writer = imageio.get_writer(out_path, duration=1000.0 / fps, loop=0)
    with writer as w:
        for f in frames:
            w.append_data(imageio.imread(f))
    return True
