"""Mocap skeleton -> MuJoCo MJCF generation (khrylib mocap tooling); host
numpy and xml.etree, copied from egoego_release_tpu/preprocess/mocap_skeleton.py.

Port of `kinpoly/copycat/khrylib/mocap/skeleton.py:1-310` (Bone/Skeleton,
`load_from_bvh` :128-169, `load_from_offsets` :179-226, `write_xml`
:228-309) plus the BVH motion-channel reader the replay driver needs
(`khrylib/mocap/pose.py`, `mocap_to_mujoco.py:34-120`).  This is the legacy
tooling family that generated humanoid MJCFs from mocap skeletons; ported
so the capability (bring your own BVH skeleton -> a loadable humanoid
model + per-frame joint trajectory) exists without mujoco-py/lxml/the
external `bvh` package.

Deviations (documented):
  * self-contained BVH parser (the reference imports the `bvh` pip package,
    absent here); HIERARCHY and MOTION sections both supported
  * `write_xml` can synthesize the whole MJCF document when no template is
    given (the reference always patches a template file); with a template
    it matches the reference behavior (fill worldbody + one motor per
    non-root joint, gear 1)
  * xml.etree + ET.indent instead of lxml pretty_print
  * the ASF/AMC (CMU) path is not ported: every bundled kinpoly model is
    SMPL-derived, and the reference's own driver (`mocap_to_mujoco.py`)
    depends on the interactive mujoco-py MjViewer
"""

from __future__ import annotations

import io
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

import numpy as np


# ---------------------------------------------------------------------------
# minimal BVH parser (hierarchy + motion)
# ---------------------------------------------------------------------------


@dataclass
class BvhJoint:
    name: str
    offset: np.ndarray                  # (3,)
    channels: list[str]
    parent: "BvhJoint | None" = None
    children: list["BvhJoint"] = field(default_factory=list)
    end_offset: np.ndarray | None = None  # End Site offset, leaves only
    channel_start: int = 0              # index into a motion frame


class BvhData:
    """Parsed BVH file: joint tree + (optional) motion channels."""

    def __init__(self, text: str):
        self.joints: list[BvhJoint] = []
        self.name2joint: dict[str, BvhJoint] = {}
        self.frames: np.ndarray | None = None   # (T, n_channels)
        self.frame_time: float = 1.0 / 30.0
        self._parse(text)

    def _parse(self, text: str) -> None:
        tokens = text.replace("\t", " ").split("\n")
        lines = [ln.strip() for ln in tokens if ln.strip()]
        i = 0
        assert lines[i].upper().startswith("HIERARCHY"), "not a BVH file"
        i += 1
        stack: list[BvhJoint] = []
        channel_count = 0
        while i < len(lines):
            ln = lines[i]
            up = ln.upper()
            if up.startswith("ROOT") or up.startswith("JOINT"):
                name = ln.split(None, 1)[1].strip()
                j = BvhJoint(name=name, offset=np.zeros(3), channels=[],
                             parent=stack[-1] if stack else None)
                if j.parent is not None:
                    j.parent.children.append(j)
                self.joints.append(j)
                self.name2joint[name] = j
                stack.append(j)
            elif up.startswith("END SITE"):
                # consume { OFFSET ... }
                assert lines[i + 1] == "{"
                off = lines[i + 2].split()
                assert off[0].upper() == "OFFSET"
                stack[-1].end_offset = np.asarray([float(x) for x in off[1:4]])
                assert lines[i + 3] == "}"
                i += 4
                continue
            elif up.startswith("OFFSET"):
                vals = ln.split()[1:4]
                stack[-1].offset = np.asarray([float(x) for x in vals])
            elif up.startswith("CHANNELS"):
                parts = ln.split()
                n = int(parts[1])
                stack[-1].channels = parts[2 : 2 + n]
                stack[-1].channel_start = channel_count
                channel_count += n
            elif ln == "}":
                stack.pop()
            elif up.startswith("MOTION"):
                i += 1
                break
            i += 1
        # motion section (optional)
        frames = []
        n_frames = 0
        while i < len(lines):
            ln = lines[i]
            up = ln.upper()
            if up.startswith("FRAMES"):
                n_frames = int(ln.split(":")[1])
            elif up.startswith("FRAME TIME"):
                self.frame_time = float(ln.split(":")[1])
            else:
                frames.append([float(x) for x in ln.split()])
            i += 1
        if frames:
            self.frames = np.asarray(frames, dtype=np.float64)
            assert self.frames.shape == (n_frames, channel_count), (
                f"MOTION block {self.frames.shape} inconsistent with "
                f"{n_frames} frames x {channel_count} channels"
            )

    # -- reference-`bvh`-package-compatible accessors ----------------------

    def get_joints_names(self) -> list[str]:
        return [j.name for j in self.joints]

    def joint_channels(self, name: str) -> list[str]:
        return self.name2joint[name].channels

    def joint_offset(self, name: str):
        return tuple(self.name2joint[name].offset)

    def joint_parent(self, name: str) -> BvhJoint | None:
        return self.name2joint[name].parent

    def joint_rotations(self, name: str) -> np.ndarray:
        """(T, 3) rotation channels in the joint's channel order, degrees."""
        j = self.name2joint[name]
        assert self.frames is not None, "BVH has no MOTION data"
        cols = [
            j.channel_start + k
            for k, c in enumerate(j.channels)
            if c.lower().endswith("rotation")
        ]
        return self.frames[:, cols]


# ---------------------------------------------------------------------------
# Skeleton -> MJCF (skeleton.py port)
# ---------------------------------------------------------------------------


class Bone:
    """skeleton.py:9-31 (asf-only fields dropped)."""

    def __init__(self):
        self.id: int | None = None
        self.name: str | None = None
        self.orient = np.identity(3)
        self.dof_index: list[int] = []
        self.channels: list[str] = []
        self.lb: list[float] = []
        self.ub: list[float] = []
        self.parent: "Bone | None" = None
        self.child: list["Bone"] = []
        self.offset = np.zeros(3)
        self.pos = np.zeros(3)
        self.end = np.zeros(3)


class Skeleton:
    """skeleton.py:33-309 — BVH/offset-table loading + MJCF generation."""

    def __init__(self):
        self.bones: list[Bone] = []
        self.name2bone: dict[str, Bone] = {}
        self.len_scale = 1.0
        self.dof_name = ["x", "y", "z"]
        self.root: Bone | None = None

    def load_from_bvh(self, source, exclude_bones=None, spec_channels=None,
                      len_scale: float = 0.0254):
        """skeleton.py:128-169.  `source` = path, file object, or BVH text.
        len_scale defaults to the reference's hardcoded inch->metre 0.0254."""
        exclude_bones = exclude_bones or set()
        spec_channels = spec_channels or {}
        if hasattr(source, "read"):
            text = source.read()
        elif "\n" in str(source) or str(source).upper().startswith("HIERARCHY"):
            text = str(source)
        else:
            with open(source) as f:
                text = f.read()
        mocap = BvhData(text)

        joint_names = [
            x for x in mocap.get_joints_names()
            if all(t not in x for t in exclude_bones)
        ]
        dof_ind = {"x": 0, "y": 1, "z": 2}
        self.len_scale = len_scale
        self.root = Bone()
        self.root.id = 0
        self.root.name = joint_names[0]
        self.root.channels = mocap.joint_channels(self.root.name)
        self.name2bone[self.root.name] = self.root
        self.bones.append(self.root)
        for i, joint in enumerate(joint_names[1:]):
            bone = Bone()
            bone.id = i + 1
            bone.name = joint
            bone.channels = spec_channels.get(joint, mocap.joint_channels(joint))
            bone.dof_index = [dof_ind[x[0].lower()] for x in bone.channels
                              if x.lower().endswith("rotation")]
            bone.offset = np.asarray(mocap.joint_offset(joint)) * self.len_scale
            bone.lb = [-180.0] * 3
            bone.ub = [180.0] * 3
            self.bones.append(bone)
            self.name2bone[joint] = bone

        for bone in self.bones[1:]:
            parent = mocap.joint_parent(bone.name)
            if parent is not None and parent.name in self.name2bone:
                bone_p = self.name2bone[parent.name]
                bone_p.child.append(bone)
                bone.parent = bone_p

        self.forward_bvh(self.root)
        for bone in self.bones:
            if not bone.child:
                end_off = mocap.name2joint[bone.name].end_offset
                if end_off is None:
                    end_off = np.zeros(3)
                bone.end = bone.pos + end_off * self.len_scale
            else:
                bone.end = sum(c.pos for c in bone.child) / len(bone.child)
        return mocap

    def load_from_offsets(self, offsets, parents, scale, exclude_bones=None,
                          channels=None, spec_channels=None):
        """skeleton.py:179-226 — offset-table variant (the SMPL path)."""
        channels = channels or ["x", "y", "z"]
        exclude_bones = exclude_bones or set()
        spec_channels = spec_channels or {}

        joint_names = [
            x for x in offsets if all(t not in x for t in exclude_bones)
        ]
        dof_ind = {"x": 0, "y": 1, "z": 2}
        self.len_scale = scale
        self.root = Bone()
        self.root.id = 0
        self.root.name = joint_names[0]
        self.root.channels = channels
        self.name2bone[self.root.name] = self.root
        self.bones.append(self.root)
        for i, joint in enumerate(joint_names[1:]):
            bone = Bone()
            bone.id = i + 1
            bone.name = joint
            bone.channels = spec_channels.get(joint, channels)
            bone.dof_index = [dof_ind[x] for x in bone.channels]
            bone.offset = np.asarray(offsets[joint]) * self.len_scale
            bone.lb = [-180.0] * 3
            bone.ub = [180.0] * 3
            self.bones.append(bone)
            self.name2bone[joint] = bone
        for bone in self.bones[1:]:
            if parents[bone.name] in self.name2bone:
                bone_p = self.name2bone[parents[bone.name]]
                bone_p.child.append(bone)
                bone.parent = bone_p

        self.forward_bvh(self.root)
        for bone in self.bones:
            if not bone.child:
                bone.end = bone.pos.copy()
                for c_bone, p_bone in parents.items():
                    if p_bone == bone.name:
                        bone.end = bone.end + np.asarray(offsets[c_bone]) * self.len_scale
                        break
            else:
                bone.end = sum(c.pos for c in bone.child) / len(bone.child)

    def forward_bvh(self, bone: Bone):
        """skeleton.py:171-177."""
        if bone.parent:
            bone.pos = bone.parent.pos + bone.offset
        else:
            bone.pos = bone.offset
        for c in bone.child:
            self.forward_bvh(c)

    # -- MJCF ---------------------------------------------------------------

    def write_xml(self, fname=None, template_fname=None,
                  offset=np.zeros(3), ref_angles=None) -> str:
        """skeleton.py:228-247.  Returns the XML text; writes it if `fname`.
        Without a template, a complete minimal MJCF document is synthesized."""
        ref_angles = ref_angles or {}
        if template_fname is not None:
            tree = ET.parse(template_fname)
            root = tree.getroot()
        else:
            root = ET.Element("mujoco", {"model": "mocap_humanoid"})
            ET.SubElement(root, "compiler", {
                "angle": "degree", "coordinate": "global"  # global like the bundled kinpoly MJCFs
            })
            default = ET.SubElement(root, "default")
            ET.SubElement(default, "joint", {"damping": "1", "limited": "true"})
            ET.SubElement(default, "geom", {
                "condim": "1", "contype": "1", "conaffinity": "1",
            })
            ET.SubElement(root, "worldbody")
            ET.SubElement(root, "actuator")
        worldbody = root.find("worldbody")
        self.write_xml_bodynode(self.root, worldbody, np.asarray(offset), ref_angles)

        actuators = root.find("actuator")
        joints = worldbody.findall(".//joint")
        for joint in joints[1:]:
            name = joint.attrib["name"]
            ET.SubElement(actuators, "motor",
                          {"name": name, "joint": name, "gear": "1"})

        ET.indent(root)
        text = ET.tostring(root, encoding="unicode")
        if fname is not None:
            with open(fname, "w") as f:
                f.write(text)
        return text

    def write_xml_bodynode(self, bone: Bone, parent_node, offset, ref_angles):
        """skeleton.py:249-309 — body/joint/geom emission, identical layout
        (free root joint, per-dof hinge joints on the bone orient axes,
        sphere root geom, 0.02-shrunk capsule bone geoms)."""
        attr = {
            "name": bone.name,
            "pos": "{0:.4f} {1:.4f} {2:.4f}".format(*(bone.pos + offset)),
            "user": "{0:.4f} {1:.4f} {2:.4f}".format(*(bone.end + offset)),
        }
        node = ET.SubElement(parent_node, "body", attr)

        if bone.parent is None:
            ET.SubElement(node, "joint", {
                "name": bone.name,
                "pos": "{0:.4f} {1:.4f} {2:.4f}".format(*(bone.pos + offset)),
                "limited": "false", "type": "free",
                "armature": "0", "damping": "0", "stiffness": "0",
            })
        else:
            for i, ind in enumerate(bone.dof_index):
                axis = bone.orient[:, ind]
                j_attr = {
                    "name": bone.name + "_" + self.dof_name[ind],
                    "type": "hinge",
                    "pos": "{0:.4f} {1:.4f} {2:.4f}".format(*(bone.pos + offset)),
                    "axis": "{0:.4f} {1:.4f} {2:.4f}".format(*axis),
                }
                if i < len(bone.lb):
                    j_attr["range"] = "{0:.4f} {1:.4f}".format(bone.lb[i], bone.ub[i])
                else:
                    j_attr["range"] = "-180.0 180.0"
                if j_attr["name"] in ref_angles:
                    j_attr["ref"] = f"{ref_angles[j_attr['name']]:.1f}"
                ET.SubElement(node, "joint", j_attr)

        if bone.parent is None:
            ET.SubElement(node, "geom", {
                "size": "0.0300", "type": "sphere",
                "pos": "{0:.4f} {1:.4f} {2:.4f}".format(*(bone.pos + offset)),
            })
        else:
            e1 = bone.pos.copy() + offset
            e2 = bone.end.copy() + offset
            v = e2 - e1
            if np.linalg.norm(v) > 1e-6:
                v = v / np.linalg.norm(v)
            else:
                v = np.asarray([0.0, 0.0, 0.2])
            e1 = e1 + v * 0.02
            e2 = e2 - v * 0.02
            ET.SubElement(node, "geom", {
                "size": "0.0300", "type": "capsule",
                "fromto": "{0:.4f} {1:.4f} {2:.4f} {3:.4f} {4:.4f} {5:.4f}".format(
                    *np.concatenate([e1, e2])
                ),
            })

        for c in bone.child:
            self.write_xml_bodynode(c, node, offset, ref_angles)


# ---------------------------------------------------------------------------
# BVH motion -> qpos trajectory (pose.py / mocap_to_mujoco.py capability)
# ---------------------------------------------------------------------------


def bvh_motion_to_qpos(mocap: BvhData, skeleton: Skeleton) -> np.ndarray:
    """Per-frame generalized coordinates for the generated model:
    root [x y z (metres, len-scaled) qw qx qy qz] + per-bone hinge angles in
    RADIANS in the model's joint order (the `interpolated_traj`-feeds-qpos
    role of mocap_to_mujoco.py:60-120, without the mujoco-py viewer loop)."""
    assert mocap.frames is not None, "BVH has no MOTION data"
    t = mocap.frames.shape[0]
    root = skeleton.root
    rj = mocap.name2joint[root.name]

    pos_cols = {c.lower()[0]: rj.channel_start + k
                for k, c in enumerate(rj.channels) if c.lower().endswith("position")}
    root_pos = np.stack(
        [mocap.frames[:, pos_cols[a]] if a in pos_cols else np.zeros(t)
         for a in ("x", "y", "z")], axis=1,
    ) * skeleton.len_scale

    from scipy.spatial.transform import Rotation as sRot

    rot_order = [c[0].lower() for c in rj.channels if c.lower().endswith("rotation")]
    root_euler = mocap.joint_rotations(root.name)
    if root_euler.size:
        r = sRot.from_euler("".join(rot_order).upper(), root_euler, degrees=True)
        q = r.as_quat()[:, [3, 0, 1, 2]]  # wxyz (repo convention)
    else:
        q = np.tile([1.0, 0, 0, 0], (t, 1))

    cols = [root_pos, q]
    for bone in skeleton.bones[1:]:
        angles = np.deg2rad(mocap.joint_rotations(bone.name))  # (T, n_rot)
        order = [c[0].lower() for c in mocap.name2joint[bone.name].channels
                 if c.lower().endswith("rotation")]
        # model joint order is bone.dof_index (x/y/z); map channel order onto it
        by_axis = dict(zip(order, angles.T))
        for ind in bone.dof_index:
            cols.append(by_axis[self_axis(ind)][:, None])
    return np.concatenate(cols, axis=1)


def self_axis(ind: int) -> str:
    return "xyz"[ind]


def bvh_to_mjcf(bvh_path: str, xml_out: str, qpos_out: str | None = None,
                exclude_bones=None, template_fname=None):
    """CLI core: BVH file -> MJCF (+ optional qpos .npy trajectory)."""
    sk = Skeleton()
    mocap = sk.load_from_bvh(bvh_path, exclude_bones=exclude_bones)
    sk.write_xml(xml_out, template_fname=template_fname)
    qpos = None
    if qpos_out is not None and mocap.frames is not None:
        qpos = bvh_motion_to_qpos(mocap, sk)
        np.save(qpos_out, qpos)
    return sk, qpos


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="BVH skeleton -> MuJoCo MJCF")
    p.add_argument("bvh")
    p.add_argument("--xml_out", required=True)
    p.add_argument("--qpos_out", default=None, help=".npy per-frame qpos")
    p.add_argument("--template", default=None)
    p.add_argument("--exclude", nargs="*", default=None,
                   help="substring filters for bones to drop")
    a = p.parse_args(argv)
    sk, qpos = bvh_to_mjcf(a.bvh, a.xml_out, a.qpos_out,
                           exclude_bones=a.exclude, template_fname=a.template)
    print(f"{len(sk.bones)} bones -> {a.xml_out}"
          + (f", qpos {qpos.shape} -> {a.qpos_out}" if qpos is not None else ""))


if __name__ == "__main__":
    main()
