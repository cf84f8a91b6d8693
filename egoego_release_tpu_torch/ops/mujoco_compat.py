"""Load the kinpoly humanoid MJCF under modern MuJoCo (>= 2.3.4); host
numpy, copied from egoego_release_tpu/ops/mujoco_compat.py.

The bundled models (kinpoly/assets/mujoco_models/humanoid_smpl_neutral_mesh*.xml)
are written in the removed `coordinate="global"` convention: every body pos,
joint pos, and mesh is expressed in world coordinates of the rest pose, with
identity body quaternions.  Modern MuJoCo refuses to load them.  This module
converts such a file to the local-coordinate convention mechanically:

  * body pos   -> global_pos - parent_global_pos
  * joint pos  -> 0 (the file always co-locates each joint with its body)
  * mesh geoms -> pos = -global_body_pos (mesh vertices are authored in
                  world coordinates, so the world origin expressed in the
                  body frame re-anchors them; quats are all identity)
  * compiler   -> drop `coordinate`, set an absolute meshdir

Everything else (defaults, assets, actuators, floor) passes through
unchanged, so the converted model has the same nq=76 / nv=75 layout, joint
names, gears, and contact parameters the reference's mujoco-py environments
used (relive/envs/humanoid_ar_v1.py, copycat/envs/humanoid_im.py).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np


def _fvec(s: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if not s:
        return np.asarray(default, np.float64)
    return np.asarray([float(x) for x in s.split()], np.float64)


def _fmt(v) -> str:
    return " ".join(f"{x:.6f}" for x in np.asarray(v, np.float64))


def convert_global_mjcf(xml_path: str, meshdir: str | None = None) -> str:
    """Global-coordinate kinpoly MJCF -> local-coordinate XML string."""
    tree = ET.parse(xml_path)
    root = tree.getroot()

    compiler = root.find("compiler")
    assert compiler is not None and compiler.get("coordinate") == "global", (
        f"{xml_path} is not a coordinate='global' model"
    )
    del compiler.attrib["coordinate"]
    base_dir = os.path.dirname(os.path.abspath(xml_path))
    if meshdir is None:
        meshdir = os.path.join(base_dir, "geom")
    compiler.set("meshdir", meshdir)
    # the string-loaded model has no base path: absolutize <include> files
    # (the *_all variants include common/materials.xml) and texture paths
    compiler.set("texturedir", base_dir)
    for inc in root.iter("include"):
        f = inc.get("file", "")
        if f and not os.path.isabs(f):
            inc.set("file", os.path.join(base_dir, f))
    # mesh file="./geom/X.stl" entries become plain filenames under meshdir
    asset = root.find("asset")
    if asset is not None:
        for mesh in asset.findall("mesh"):
            f = mesh.get("file", "")
            mesh.set("file", os.path.basename(f))

    def localize(body: ET.Element, parent_global: np.ndarray):
        global_pos = _fvec(body.get("pos"))
        quat = _fvec(body.get("quat"), (1.0, 0.0, 0.0, 0.0))
        assert np.allclose(quat, [1, 0, 0, 0], atol=1e-6), (
            f"body {body.get('name')} has a non-identity quat; converter "
            "only handles the kinpoly identity-quat models"
        )
        body.set("pos", _fmt(global_pos - parent_global))
        body.attrib.pop("quat", None)
        for joint in body.findall("joint"):
            if joint.get("type") == "free":
                # free joint: position is meaningless in local coords
                joint.attrib.pop("pos", None)
            else:
                jpos = _fvec(joint.get("pos"))
                assert np.allclose(jpos, global_pos, atol=1e-5), (
                    f"joint {joint.get('name')} not co-located with its body"
                )
                joint.set("pos", "0 0 0")
        for geom in body.findall("geom"):
            if geom.get("type") == "mesh":
                # mesh vertices are world-frame; re-anchor to the body frame
                geom.set("pos", _fmt(-global_pos))
            elif geom.get("fromto") is not None:
                # primitive capsules (mocap_skeleton-generated models):
                # both endpoints are world-frame
                ft = np.asarray([float(x) for x in geom.get("fromto").split()])
                geom.set(
                    "fromto",
                    " ".join(_fmt(e - global_pos) for e in (ft[:3], ft[3:])),
                )
            elif geom.get("pos") is not None:
                geom.set("pos", _fmt(_fvec(geom.get("pos")) - global_pos))
        for child in body.findall("body"):
            localize(child, global_pos)

    worldbody = root.find("worldbody")
    assert worldbody is not None
    for body in worldbody.findall("body"):
        localize(body, np.zeros(3))

    return ET.tostring(root, encoding="unicode")


def load_humanoid_model(xml_path: str):
    """MjModel for a kinpoly humanoid XML (global-coordinate files are
    converted on the fly; local-coordinate files load directly)."""
    import mujoco

    try:
        return mujoco.MjModel.from_xml_path(xml_path)
    except Exception:
        return mujoco.MjModel.from_xml_string(convert_global_mjcf(xml_path))
