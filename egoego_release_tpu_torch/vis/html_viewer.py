"""Self-contained interactive HTML motion viewer (port of
egoego_release_tpu/vis/html_viewer.py, numpy and text): one call per
sequence writes a standalone .html with play/pause/scrub controls and
mouse-drag orbit, a vanilla-JS canvas renderer with no external
dependency (the reference exports through scenepic,
egoego/vis/mesh_motion.py:287-339 ``sp_animation``). Three layer kinds:

- ``add_skeleton``: (T, J, 3) joint positions drawn as a bone tree;
- ``add_trajectory``: a (T, 3) polyline with a per-frame marker;
- ``add_mesh``: a (T, V, 3) animated triangle mesh, flat-shaded and
  painter-sorted, its vertices quantized to uint16 per sequence and axis
  and embedded as base64 (the error is at most the axis span / 65535).

The page's data is the JSON object ``const DATA = {...}``.
"""

from __future__ import annotations

import base64
import json

import numpy as np

from egoego_release_tpu_torch.ops.fk import SMPL_PARENTS

_DEFAULT_COLORS = ("#d97757", "#5a7d9a", "#7d9a5a", "#9a5a7d", "#c2a45a")


class HTMLAnimation:
    """JAX ``vis/html_viewer.py:34``: construct, add layers, ``save_animation``."""

    def __init__(self, fps: int = 30, width: int = 900, height: int = 640,
                 title: str = "egoego motion"):
        self.fps = fps
        self.width = width
        self.height = height
        self.title = title
        self._skeletons: list[dict] = []
        self._trajectories: list[dict] = []
        self._meshes: list[dict] = []

    def add_skeleton(self, name: str, jpos: np.ndarray,
                     parents: np.ndarray | None = None,
                     color: str | None = None) -> None:
        """jpos: (T, J, 3) global joint positions, z-up.  parents defaults to
        the 22-joint SMPL tree."""
        jpos = np.asarray(jpos, np.float32)
        if parents is None:
            parents = SMPL_PARENTS[: jpos.shape[1]]
        color = color or _DEFAULT_COLORS[len(self._skeletons) % len(_DEFAULT_COLORS)]
        self._skeletons.append(
            {
                "name": name,
                "color": color,
                "parents": np.asarray(parents).tolist(),
                "frames": np.round(jpos, 4).tolist(),
            }
        )

    def add_trajectory(self, name: str, points: np.ndarray,
                       color: str | None = None) -> None:
        """points: (T, 3) — e.g. a head or SLAM trajectory, drawn as a
        polyline with a per-frame marker."""
        points = np.asarray(points, np.float32)
        color = color or _DEFAULT_COLORS[
            (len(self._skeletons) + len(self._trajectories)) % len(_DEFAULT_COLORS)
        ]
        self._trajectories.append(
            {"name": name, "color": color, "points": np.round(points, 4).tolist()}
        )

    def add_mesh(self, name: str, verts: np.ndarray, faces: np.ndarray,
                 color: str | None = None) -> None:
        """verts: (T, V, 3) per-frame vertex positions, z-up;
        faces: (F, 3) int triangle indices (shared across frames — the
        sp_animation contract, mesh_motion.py:317-333).

        Vertices are quantized to uint16 against the sequence's per-axis
        min/max and embedded base64 (little-endian, frame-major)."""
        verts = np.asarray(verts, np.float32)
        faces = np.asarray(faces)
        assert verts.ndim == 3 and verts.shape[-1] == 3, verts.shape
        assert faces.ndim == 2 and faces.shape[-1] == 3, faces.shape
        assert int(faces.max()) < verts.shape[1], "face index out of range"
        lo = verts.reshape(-1, 3).min(axis=0)
        hi = verts.reshape(-1, 3).max(axis=0)
        span = np.maximum(hi - lo, 1e-6)
        q = np.round((verts - lo) / span * 65535.0).astype("<u2")
        color = color or _DEFAULT_COLORS[
            (len(self._skeletons) + len(self._trajectories)
             + len(self._meshes)) % len(_DEFAULT_COLORS)
        ]
        self._meshes.append({
            "name": name,
            "color": color,
            "numFrames": int(verts.shape[0]),
            "numVerts": int(verts.shape[1]),
            "lo": np.round(lo, 6).tolist(),
            "span": np.round(span, 6).tolist(),
            "faces": faces.astype(np.int64).ravel().tolist(),
            "vertsB64": base64.b64encode(q.tobytes()).decode("ascii"),
        })

    def num_frames(self) -> int:
        n = [len(s["frames"]) for s in self._skeletons]
        n += [len(t["points"]) for t in self._trajectories]
        n += [m["numFrames"] for m in self._meshes]
        return max(n) if n else 0

    def save_animation(self, path: str) -> str:
        data = {
            "fps": self.fps,
            "numFrames": self.num_frames(),
            "skeletons": self._skeletons,
            "trajectories": self._trajectories,
            "meshes": self._meshes,
        }
        html = _HTML_TEMPLATE.replace("__TITLE__", self.title)
        html = html.replace("__WIDTH__", str(self.width))
        html = html.replace("__HEIGHT__", str(self.height))
        html = html.replace("__DATA__", json.dumps(data))
        with open(path, "w") as f:
            f.write(html)
        return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{font-family:sans-serif;background:#faf9f5;color:#333;margin:16px}
 canvas{border:1px solid #ccc;background:#fff;cursor:grab}
 .bar{margin:8px 0}
 button{margin-right:8px}
 input[type=range]{width:420px;vertical-align:middle}
</style></head><body>
<h3>__TITLE__</h3>
<canvas id="c" width="__WIDTH__" height="__HEIGHT__"></canvas>
<div class="bar">
 <button id="play">pause</button>
 <input id="scrub" type="range" min="0" value="0" step="1">
 <span id="label"></span>
 <span style="margin-left:16px;color:#888">drag = orbit, wheel = zoom</span>
</div>
<div id="legend"></div>
<script>
const DATA = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = 0.6, pitch = 0.35, scale = 0, cx = 0, cy = 0, center = [0,0,0];
let frame = 0, playing = true, dragging = false, px = 0, py = 0;

// decode quantized mesh vertex streams once
DATA.meshes.forEach(m => {
  const raw = atob(m.vertsB64);
  const u16 = new Uint16Array(raw.length / 2);
  for (let i = 0; i < u16.length; i++)
    u16[i] = raw.charCodeAt(2*i) | (raw.charCodeAt(2*i+1) << 8);
  m.q = u16;  // frame-major (T * V * 3)
  m.vertsB64 = null;
});
function meshVert(m, f, v, out){
  const o = (f * m.numVerts + v) * 3;
  for (let k = 0; k < 3; k++)
    out[k] = m.lo[k] + m.q[o + k] / 65535.0 * m.span[k];
  return out;
}

(function fit(){
  let lo = [1e9,1e9,1e9], hi = [-1e9,-1e9,-1e9];
  const upd = p => { for (let k=0;k<3;k++){ lo[k]=Math.min(lo[k],p[k]); hi[k]=Math.max(hi[k],p[k]); } };
  DATA.skeletons.forEach(s => s.frames.forEach(f => f.forEach(upd)));
  DATA.trajectories.forEach(t => t.points.forEach(upd));
  DATA.meshes.forEach(m => { upd(m.lo);
    upd([0,1,2].map(k => m.lo[k] + m.span[k])); });
  if (lo[0] > hi[0]) { lo = [-1,-1,-1]; hi = [1,1,1]; }
  center = [0,1,2].map(k => (lo[k]+hi[k])/2);
  const span = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2], 0.5);
  scale = 0.42 * Math.min(cv.width, cv.height) / span;
  cx = cv.width/2; cy = cv.height/2;
})();

function project(p){
  const x = p[0]-center[0], y = p[1]-center[1], z = p[2]-center[2];
  const cy_ = Math.cos(yaw), sy = Math.sin(yaw);
  const x1 = cy_*x - sy*y, y1 = sy*x + cy_*y;       // yaw about +z
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;       // pitch about +x
  return [cx + scale*x1, cy - scale*z2, y2];
}

function drawGround(){
  ctx.strokeStyle = '#eee';
  const n = 6, step = 0.5;
  for (let i=-n;i<=n;i++){
    let a = project([i*step + center[0], -n*step + center[1], 0]);
    let b = project([i*step + center[0],  n*step + center[1], 0]);
    ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
    a = project([-n*step + center[0], i*step + center[1], 0]);
    b = project([ n*step + center[0], i*step + center[1], 0]);
    ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
  }
}

function hexRGB(h){
  return [parseInt(h.slice(1,3),16), parseInt(h.slice(3,5),16),
          parseInt(h.slice(5,7),16)];
}
function drawMesh(m){
  const k = Math.min(frame, m.numFrames-1);
  const F = m.faces.length / 3;
  const a=[0,0,0], b=[0,0,0], c=[0,0,0];
  // project all vertices once per frame
  if (!m.proj || m.proj.length !== m.numVerts) m.proj = new Array(m.numVerts);
  const w = [0,0,0];
  for (let v = 0; v < m.numVerts; v++)
    m.proj[v] = project(meshVert(m, k, v, w));
  // painter's algorithm: sort faces back-to-front by mean view depth
  if (!m.order) m.order = Array.from({length: F}, (_, i) => i);
  const depth = new Float32Array(F);
  for (let f = 0; f < F; f++){
    depth[f] = (m.proj[m.faces[3*f]][2] + m.proj[m.faces[3*f+1]][2]
              + m.proj[m.faces[3*f+2]][2]) / 3;
  }
  m.order.sort((i, j) => depth[j] - depth[i]);
  const rgb = hexRGB(m.color), L = [0.35, -0.45, 0.82];
  for (const f of m.order){
    const i0 = m.faces[3*f], i1 = m.faces[3*f+1], i2 = m.faces[3*f+2];
    meshVert(m, k, i0, a); meshVert(m, k, i1, b); meshVert(m, k, i2, c);
    const ux=b[0]-a[0], uy=b[1]-a[1], uz=b[2]-a[2];
    const vx=c[0]-a[0], vy=c[1]-a[1], vz=c[2]-a[2];
    let nx=uy*vz-uz*vy, ny=uz*vx-ux*vz, nz=ux*vy-uy*vx;
    const nn = Math.hypot(nx,ny,nz) || 1;
    const lit = 0.45 + 0.55 * Math.abs((nx*L[0]+ny*L[1]+nz*L[2])/nn);
    ctx.fillStyle = 'rgb(' + rgb.map(x => Math.round(x*lit)).join(',') + ')';
    const p0 = m.proj[i0], p1 = m.proj[i1], p2 = m.proj[i2];
    ctx.beginPath(); ctx.moveTo(p0[0],p0[1]);
    ctx.lineTo(p1[0],p1[1]); ctx.lineTo(p2[0],p2[1]);
    ctx.closePath(); ctx.fill();
  }
}

function draw(){
  ctx.clearRect(0,0,cv.width,cv.height);
  drawGround();
  DATA.meshes.forEach(drawMesh);
  DATA.trajectories.forEach(t => {
    ctx.strokeStyle = t.color; ctx.lineWidth = 1.2; ctx.beginPath();
    t.points.forEach((p,i) => { const q = project(p);
      if (i===0) ctx.moveTo(q[0],q[1]); else ctx.lineTo(q[0],q[1]); });
    ctx.stroke();
    const k = Math.min(frame, t.points.length-1);
    const m = project(t.points[k]);
    ctx.fillStyle = t.color; ctx.beginPath();
    ctx.arc(m[0], m[1], 5, 0, 6.283); ctx.fill();
  });
  DATA.skeletons.forEach(s => {
    const k = Math.min(frame, s.frames.length-1), joints = s.frames[k];
    ctx.strokeStyle = s.color; ctx.fillStyle = s.color; ctx.lineWidth = 2;
    s.parents.forEach((p,j) => {
      if (p < 0) return;
      const a = project(joints[j]), b = project(joints[p]);
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
    });
    joints.forEach(p => { const q = project(p);
      ctx.beginPath(); ctx.arc(q[0],q[1],2.5,0,6.283); ctx.fill(); });
  });
  document.getElementById('label').textContent =
    'frame ' + frame + ' / ' + (DATA.numFrames-1);
  document.getElementById('scrub').value = frame;
}

const scrub = document.getElementById('scrub');
scrub.max = Math.max(DATA.numFrames-1, 0);
scrub.oninput = e => { playing = false;
  document.getElementById('play').textContent = 'play';
  frame = +e.target.value; draw(); };
document.getElementById('play').onclick = e => {
  playing = !playing; e.target.textContent = playing ? 'pause' : 'play'; };
cv.onmousedown = e => { dragging = true; px = e.clientX; py = e.clientY; };
window.onmouseup = () => dragging = false;
window.onmousemove = e => { if (!dragging) return;
  yaw += (e.clientX-px)*0.01; pitch += (e.clientY-py)*0.01;
  pitch = Math.max(-1.5, Math.min(1.5, pitch));
  px = e.clientX; py = e.clientY; draw(); };
cv.onwheel = e => { e.preventDefault();
  scale *= Math.exp(-e.deltaY*0.001); draw(); };

const legend = document.getElementById('legend');
DATA.skeletons.concat(DATA.trajectories).concat(DATA.meshes).forEach(l => {
  const d = document.createElement('span');
  d.innerHTML = '<span style="color:'+l.color+'">&#9632;</span> '+l.name+' &nbsp;';
  legend.appendChild(d);
});

setInterval(() => { if (playing && DATA.numFrames>0){
  frame = (frame+1) % DATA.numFrames; draw(); } }, 1000/DATA.fps);
draw();
</script></body></html>
"""


def vis_mesh_motion_html(verts: np.ndarray, faces: np.ndarray,
                         out_path: str,
                         gt_verts: np.ndarray | None = None,
                         head_traj: np.ndarray | None = None,
                         fps: int = 30,
                         title: str = "egoego mesh motion") -> str:
    """A mesh animation (JAX ``vis/html_viewer.py:304``; the reference's
    ``vis_mesh_motion``, mesh_motion.py:339-368): predicted vertices (T, V,
    3) from ``ops.smpl.lbs``, an optional GT mesh and head trajectory."""
    anim = HTMLAnimation(fps=fps, title=title)
    anim.add_mesh("pred", verts, faces)
    if gt_verts is not None:
        anim.add_mesh("gt", gt_verts, faces)
    if head_traj is not None:
        anim.add_trajectory("head", head_traj)
    return anim.save_animation(out_path)


def vis_skeleton_motion_html(jpos: np.ndarray, out_path: str,
                             gt_jpos: np.ndarray | None = None,
                             head_traj: np.ndarray | None = None,
                             fps: int = 30, title: str = "egoego motion") -> str:
    """A skeleton animation (JAX ``vis/html_viewer.py:325``): the predicted
    skeleton, an optional GT skeleton and head trajectory, one HTML file."""
    anim = HTMLAnimation(fps=fps, title=title)
    anim.add_skeleton("pred", jpos)
    if gt_jpos is not None:
        anim.add_skeleton("gt", gt_jpos)
    if head_traj is not None:
        anim.add_trajectory("head", head_traj)
    return anim.save_animation(out_path)
