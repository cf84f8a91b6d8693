"""Render a head-pose trajectory alone (bpy script).

Counterpart of egoego/vis/blender_vis_headpose_utils.py: animates a head
gizmo along a (T, 7) [trans, wxyz-quat] numpy trajectory and renders one
frame per step — no body meshes.  Run as

    blender [scene.blend] -b -P render_headpose.py -- \
        --head-path head_pose.npy --out-folder <frames> [--scene <blend>]

The reference looks up a pre-made "coord.001" object in its private .blend
(:70); here the gizmo is created procedurally (see render_human.head_gizmo).
"""

import argparse
import os
import sys

import bpy  # available inside Blender

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from render_human import build_default_scene, head_gizmo, place_head  # noqa: E402


def parse_args(argv=None):
    if argv is None:
        argv = sys.argv
        argv = argv[argv.index("--") + 1:] if "--" in argv else []
    p = argparse.ArgumentParser(description="Render head-pose trajectory")
    p.add_argument("--head-path", type=str, required=True)
    p.add_argument("--out-folder", type=str, required=True)
    p.add_argument("--scene", type=str, default="")
    p.add_argument("--resolution", type=int, nargs=2, default=(1280, 720))
    return p.parse_args(argv)


def render_sequence(args):
    import numpy as np

    if args.scene:
        bpy.ops.wm.open_mainfile(filepath=args.scene)
        bpy.context.scene.render.use_persistent_data = True
        if bpy.context.scene.camera is None:
            build_default_scene(tuple(args.resolution))
    else:
        build_default_scene(tuple(args.resolution))

    os.makedirs(args.out_folder, exist_ok=True)
    head_pose = np.load(args.head_path)  # (T, 7)
    gizmo = head_gizmo()
    for frame_idx in range(head_pose.shape[0]):
        place_head(gizmo, head_pose[frame_idx])
        bpy.context.scene.render.filepath = os.path.join(
            args.out_folder, "%05d.jpg" % frame_idx
        )
        bpy.ops.render.render(write_still=True)
    return head_pose.shape[0]


if __name__ == "__main__":
    n = render_sequence(parse_args())
    print(f"rendered {n} head-pose frames")
    bpy.ops.wm.quit_blender()
