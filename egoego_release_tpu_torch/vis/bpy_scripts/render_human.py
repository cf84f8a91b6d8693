"""Render an OBJ motion sequence inside Blender (bpy script).

TPU-framework counterpart of egoego/vis/blender_vis_human_utils.py (and the
human+headpose variant when --head-path is given): run as

    blender [scene.blend] -b -P render_human.py -- \
        --folder <objs> --out-folder <frames> [--scene <blend>] \
        [--material-color blue] [--head-path head_pose.npy]

Differences from the reference (deliberate):
  * works without a pre-built .blend — when no scene is given (or the scene
    lacks the named materials) it builds floor + sun + auto-framed camera and
    the material procedurally, instead of requiring the authors' private
    scene files with pre-made "blue"/"orange" materials;
  * modern Blender 3/4 API (bpy.ops.wm.obj_import) with fallback to the 2.x
    operator; CPU rendering by default (no hardcoded CUDA device setup);
  * head pose (T,7 wxyz quaternion + translation, the repo convention) is
    drawn as an animated axes gizmo when --head-path is passed, replacing the
    reference's "coord.001" object lookup in its .blend
    (blender_vis_headpose_utils.py:70-79).

Logic lives in functions so the test suite can exercise it with a stubbed
bpy module (tests/test_torch_vis_plots.py) — no Blender in CI.
"""

import argparse
import math
import os
import sys

import bpy  # available inside Blender

COLORS = {
    "blue": (10 / 255.0, 30 / 255.0, 225 / 255.0, 1.0),
    "orange": (240 / 255.0, 120 / 255.0, 20 / 255.0, 1.0),
    "purple": (150 / 255.0, 60 / 255.0, 220 / 255.0, 1.0),
    "green": (40 / 255.0, 180 / 255.0, 80 / 255.0, 1.0),
    "gray": (220 / 255.0, 220 / 255.0, 220 / 255.0, 1.0),
}


def parse_args(argv=None):
    if argv is None:
        argv = sys.argv
        argv = argv[argv.index("--") + 1:] if "--" in argv else []
    p = argparse.ArgumentParser(description="Render motion OBJ sequence")
    p.add_argument("--folder", type=str, required=True)
    p.add_argument("--out-folder", type=str, required=True)
    p.add_argument("--scene", type=str, default="")
    p.add_argument("--material-color", type=str, default="blue")
    p.add_argument("--head-path", type=str, default="")
    p.add_argument("--resolution", type=int, nargs=2, default=(1280, 720))
    return p.parse_args(argv)


def list_obj_files(folder):
    names = sorted(
        n for n in os.listdir(folder)
        if (n.endswith(".obj") or n.endswith(".ply")) and "object" not in n
    )
    return [os.path.join(folder, n) for n in names]


def import_mesh(path):
    """Import an OBJ/PLY; returns ALL newly created objects (a multi-group
    OBJ yields several — each must be styled and removed per frame)."""
    before = set(bpy.data.objects.keys())
    if path.endswith(".obj"):
        try:
            bpy.ops.wm.obj_import(filepath=path)          # Blender >= 3.2
        except AttributeError:
            bpy.ops.import_scene.obj(filepath=path, split_mode="OFF")
    else:
        try:
            bpy.ops.wm.ply_import(filepath=path)
        except AttributeError:
            bpy.ops.import_mesh.ply(filepath=path)
    return [bpy.data.objects[k] for k in bpy.data.objects.keys() if k not in before]


def get_material(color_name):
    mat = bpy.data.materials.get(color_name)
    if mat is None:
        mat = bpy.data.materials.new(name=color_name)
        mat.use_nodes = True
        bsdf = mat.node_tree.nodes.get("Principled BSDF")
        if bsdf is not None:
            bsdf.inputs[0].default_value = COLORS.get(color_name, COLORS["gray"])
    return mat


def build_default_scene(resolution):
    """Floor + sun + camera for scene-less rendering."""
    scene = bpy.context.scene
    scene.render.resolution_x, scene.render.resolution_y = resolution
    scene.render.use_persistent_data = True

    bpy.ops.mesh.primitive_plane_add(size=40.0, location=(0.0, 0.0, 0.0))
    floor = bpy.context.active_object
    floor.name = "floor"
    floor.active_material = get_material("gray")

    bpy.ops.object.light_add(type="SUN", location=(4.0, -4.0, 8.0))
    sun = bpy.context.active_object
    sun.data.energy = 4.0
    sun.rotation_euler = (math.radians(35.0), 0.0, math.radians(45.0))

    bpy.ops.object.camera_add(
        location=(5.0, -5.0, 3.0),
        rotation=(math.radians(70.0), 0.0, math.radians(45.0)),
    )
    scene.camera = bpy.context.active_object


def head_gizmo():
    """An axes empty standing in for the reference's 'coord.001' object."""
    obj = bpy.data.objects.get("head_gizmo")
    if obj is None:
        bpy.ops.object.empty_add(type="ARROWS", location=(0.0, 0.0, 0.0))
        obj = bpy.context.active_object
        obj.name = "head_gizmo"
        obj.empty_display_size = 0.25
        obj.rotation_mode = "QUATERNION"
    return obj


def place_head(obj, head_pose_row):
    """head_pose_row: (7,) = [x y z, qw qx qy qz] (repo wxyz convention)."""
    obj.location = tuple(float(v) for v in head_pose_row[:3])
    obj.rotation_quaternion = tuple(float(v) for v in head_pose_row[3:7])


def render_sequence(args):
    if args.scene:
        bpy.ops.wm.open_mainfile(filepath=args.scene)
        bpy.context.scene.render.use_persistent_data = True
        if bpy.context.scene.camera is None:
            build_default_scene(tuple(args.resolution))
    else:
        build_default_scene(tuple(args.resolution))

    os.makedirs(args.out_folder, exist_ok=True)
    material = get_material(args.material_color)

    head_pose = None
    if args.head_path:
        import numpy as np

        head_pose = np.load(args.head_path)  # (T, 7)

    obj_files = list_obj_files(args.folder)
    for frame_idx, path in enumerate(obj_files):
        meshes = import_mesh(path)
        for human in meshes:
            for f in human.data.polygons:
                f.use_smooth = True
            human.rotation_euler = (0.0, 0.0, 0.0)
            human.active_material = material

        if head_pose is not None and frame_idx < len(head_pose):
            place_head(head_gizmo(), head_pose[frame_idx])

        bpy.context.scene.render.filepath = os.path.join(
            args.out_folder, "%05d.jpg" % frame_idx
        )
        bpy.ops.render.render(write_still=True)
        for human in meshes:
            bpy.data.objects.remove(human, do_unlink=True)
    return len(obj_files)


if __name__ == "__main__":
    n = render_sequence(parse_args())
    print(f"rendered {n} frames")
    bpy.ops.wm.quit_blender()
