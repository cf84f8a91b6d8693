"""Render two OBJ motion sequences side by side (comparison bpy script).

Counterpart of egoego/vis/blender_vis_cmp_human_utils.py: GT vs prediction in
two material colors, one render per frame.  Run as

    blender [scene.blend] -b -P render_cmp.py -- \
        --folder <pred objs> --folder2 <gt objs> --out-folder <frames> \
        [--material-color blue] [--material-color2 green] [--offset2 X Y Z]

Shares all scene/material/import machinery with render_human.py (same
deviations from the reference: procedural scene fallback, modern bpy API).
--offset2 optionally displaces the second sequence so overlapping motions
stay distinguishable (the reference's scenes rely on camera placement).
"""

import argparse
import os
import sys

import bpy  # available inside Blender

# Allow "blender -P render_cmp.py" to find its sibling module.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from render_human import (  # noqa: E402
    build_default_scene,
    get_material,
    import_mesh,
    list_obj_files,
)


def parse_args(argv=None):
    if argv is None:
        argv = sys.argv
        argv = argv[argv.index("--") + 1:] if "--" in argv else []
    p = argparse.ArgumentParser(description="Render comparison OBJ sequences")
    p.add_argument("--folder", type=str, required=True)
    p.add_argument("--folder2", type=str, required=True)
    p.add_argument("--out-folder", type=str, required=True)
    p.add_argument("--scene", type=str, default="")
    p.add_argument("--material-color", type=str, default="blue")
    p.add_argument("--material-color2", type=str, default="green")
    p.add_argument("--offset2", type=float, nargs=3, default=(0.0, 0.0, 0.0))
    p.add_argument("--resolution", type=int, nargs=2, default=(1280, 720))
    return p.parse_args(argv)


def render_sequence(args):
    if args.scene:
        bpy.ops.wm.open_mainfile(filepath=args.scene)
        bpy.context.scene.render.use_persistent_data = True
        if bpy.context.scene.camera is None:
            build_default_scene(tuple(args.resolution))
    else:
        build_default_scene(tuple(args.resolution))

    os.makedirs(args.out_folder, exist_ok=True)
    mat_a = get_material(args.material_color)
    mat_b = get_material(args.material_color2)

    files_a = list_obj_files(args.folder)
    files_b = list_obj_files(args.folder2)
    n = min(len(files_a), len(files_b))
    for frame_idx in range(n):
        meshes = []
        for path, mat, offset in (
            (files_a[frame_idx], mat_a, (0.0, 0.0, 0.0)),
            (files_b[frame_idx], mat_b, tuple(args.offset2)),
        ):
            for obj in import_mesh(path):
                for f in obj.data.polygons:
                    f.use_smooth = True
                obj.rotation_euler = (0.0, 0.0, 0.0)
                obj.location = offset
                obj.active_material = mat
                meshes.append(obj)

        bpy.context.scene.render.filepath = os.path.join(
            args.out_folder, "%05d.jpg" % frame_idx
        )
        bpy.ops.render.render(write_still=True)
        for obj in meshes:
            bpy.data.objects.remove(obj, do_unlink=True)
    return n


if __name__ == "__main__":
    n = render_sequence(parse_args())
    print(f"rendered {n} comparison frames")
    bpy.ops.wm.quit_blender()
