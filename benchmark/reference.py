"""Plain PyTorch reference of the timed path: the EgoEgo stage-2 eval of one
batch in GT-head mode (lijiaman/egoego_release ``eval_stage2``), written
from the release model's description and independent of the program.

For each checked sequence of a batch: FK of the GT SMPL parameters, the
GT floor (1-D DBSCAN of the static toe heights) and the snap to it, the
head trajectory; the chained sliding-window sampler (120-frame windows,
overlap 10: each window canonicalized to face +x at its first frame, the
DDPM-1000 reverse chain of the pred_x0 denoiser with the overlap inpainted
from the previous window's FK, decoded, stitched by head continuity); FK of
the result, the prediction's floor and the metric suite.

It imports nothing of the program and reads no tensor the program made.
The benchmark hands it what it handed the program: the SMPL parameters, the
skeleton, the normalization stats, the weights by the checkpoint's keys and
each batch's noise seed (it draws the whole batch's noise, as the program
does, and keeps its rows). Rows are independent through every stage, so it
runs only the rows it checks.

Numerics: the denoiser in f32 with TF32 off; the geometry, FK and metrics
in float64. ``precision`` rounds both operands of every matrix product of
the denoiser before an f32 product: "tf32" (10 mantissa bits, as the tensor
cores' TF32), "bf16", "fp8" (e4m3, one scale a tensor): the controls.
Two witnesses: "f64" runs the denoiser and the chain in float64, and
"tf32x3" sums three TF32 products for each f32 product, as the 3xTF32
GEMMs do.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SMPL_PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19)
NUM_JOINTS, HEAD, LEFT_TOE, RIGHT_TOE = 22, 15, 10, 11
LN_EPS = 1e-5
FLOOR_VEL_THRESH, FLOOR_HEIGHT_OFFSET, DBSCAN_EPS, DBSCAN_MIN = 0.005, 0.01, 0.005, 3
F64 = torch.float64


# -- numerics of the denoiser -----------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round to TF32's 10 mantissa bits, to nearest with ties away, on the bits."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision in ("f32", "f64", "tf32x3"):
        return x
    if precision == "tf32":
        return _tf32(x)
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b with both operands at ``precision``; "tf32x3" splits each into a
    TF32 high part and the rest and sums three TF32 products (hi hi + hi lo
    + lo hi), as a 3xTF32 GEMM does."""
    if precision != "tf32x3":
        return torch.matmul(round_operand(a, precision), round_operand(b, precision))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.matmul(ah, bh) + (torch.matmul(ah, bl) + torch.matmul(al, bh))


class Denoiser:
    """The release denoiser: token 0 the noise level's embedding, tokens
    1..T the Conv1d(k=1) stem over [x | x_cond], sinusoid positions 1..T+1,
    post-LN layers (softmax attention with 1/sqrt(d_k), then fc and a
    residual LayerNorm; a ReLU FFN of width d_model and a residual
    LayerNorm), then linear_out on tokens 1..T. Every token is real, so
    the padding mask is all ones and left out. The weights are rounded
    to ``precision`` once, the activations at each product."""

    def __init__(self, weights: dict, cfg: dict, precision: str = "f32"):
        self.cfg, self.precision = cfg, precision
        self.dtype = F64 if precision == "f64" else torch.float32
        weights = {k: v.to(self.dtype) for k, v in weights.items()}
        dm = cfg["d_model"]

        def lin(*keys):
            w = torch.cat([round_operand(weights[k + ".weight"].reshape(weights[k + ".weight"].shape[0], -1),
                                         precision) for k in keys])
            return w, torch.cat([weights[k + ".bias"] for k in keys])

        def ln(key):
            return weights[key + ".weight"], weights[key + ".bias"]

        self.time1, self.time3 = lin("time_mlp.1"), lin("time_mlp.3")
        self.stem, self.out = lin("motion_transformer.start_conv"), lin("linear_out")
        self.layers = []
        for i in range(cfg["n_dec_layers"]):
            a, f = f"motion_transformer.layer_stack.{i}.self_attn.", f"motion_transformer.layer_stack.{i}.pos_ffn."
            self.layers.append({"qkv": lin(a + "w_q", a + "w_k", a + "w_v"), "fc": lin(a + "fc"),
                                "ln1": ln(a + "layer_norm"), "w1": lin(f + "w_1"), "w2": lin(f + "w_2"),
                                "ln2": ln(f + "layer_norm")})
        pos = np.arange(cfg["window"] + 2)[:, None].astype(np.float64)
        i = np.arange(dm)[None, :]
        angle = pos / np.power(10000.0, 2.0 * (i // 2) / dm)
        table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
        table[0] = 0.0
        self.pos = torch.as_tensor(table, dtype=self.dtype, device=weights["linear_out.weight"].device)

    def linear(self, x, wb):
        if self.precision == "tf32x3":
            return matmul(x, wb[0].t(), self.precision) + wb[1]
        return F.linear(round_operand(x, self.precision), *wb)

    def noise_level_tokens(self, ts) -> torch.Tensor:
        """(n, d_model) for the integer timesteps ts: 32 frequencies
        exp(-i log(10000) / 31), [sin, cos], Linear, exact GELU, Linear."""
        t = torch.as_tensor(np.asarray(ts, np.float32), device=self.pos.device).to(self.dtype)
        freq = torch.exp(torch.arange(32, dtype=self.dtype, device=t.device) * (-math.log(10000.0) / 31))
        ang = t[:, None] * freq[None]
        h = self.linear(torch.cat([torch.sin(ang), torch.cos(ang)], -1), self.time1)
        return self.linear(0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0))), self.time3)

    def __call__(self, x_all: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
        """x_all (B, T, 2 d_feats), token (d_model,) -> x0 (B, T, d_feats)."""
        cfg, p = self.cfg, self.precision
        b, t, _ = x_all.shape
        h_n, dk, dv, dm = cfg["n_head"], cfg["d_k"], cfg["d_v"], cfg["d_model"]
        h = torch.cat([token.expand(b, 1, -1), self.linear(x_all, self.stem)], 1) + self.pos[1: t + 2]
        for lay in self.layers:
            q, k, v = self.linear(h, lay["qkv"]).split([h_n * dk, h_n * dk, h_n * dv], -1)
            q, k, v = (y.reshape(b, t + 1, h_n, -1).transpose(1, 2) for y in (q, k, v))
            att = torch.softmax(matmul(q, k.transpose(-1, -2), p) * (1.0 / math.sqrt(dk)), -1)
            o = matmul(att, v, p).transpose(1, 2).reshape(b, t + 1, h_n * dv)
            h = F.layer_norm(self.linear(o, lay["fc"]) + h, (dm,), *lay["ln1"], LN_EPS)
            h = F.layer_norm(self.linear(torch.relu(self.linear(h, lay["w1"])), lay["w2"]) + h, (dm,), *lay["ln2"],
                             LN_EPS)
        return self.linear(h[:, 1:], self.out)


def ddpm_schedule(timesteps: int) -> list[tuple[int, float, float, float]]:
    """[(t, a1, a2, a3)] for t = T-1 .. 0 of the cosine schedule (s = 0.008,
    betas clipped to 0.999): x_{t-1} = a1 x0 + a2 x_t + a3 noise with the
    posterior mean's coefficients and a3 = exp(log(clipped posterior
    variance) / 2), 0 at t = 0."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + 0.008) / 1.008 * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    ac = np.cumprod(1.0 - betas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    var = betas * (1.0 - ac_prev) / (1.0 - ac)
    c1 = betas * np.sqrt(ac_prev) / (1.0 - ac)
    c2 = (1.0 - ac_prev) * np.sqrt(1.0 - betas) / (1.0 - ac)
    sd = np.exp(0.5 * np.log(np.clip(var, 1e-20, None)))
    return [(t, float(np.float32(c1[t])), float(np.float32(c2[t])), float(np.float32(sd[t])) if t else 0.0)
            for t in range(timesteps - 1, -1, -1)]


# -- rotations and FK (float64) ----------------------------------------------


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.norm(aa, dim=-1, keepdim=True)
    k = aa / theta.clamp_min(1e-30)
    kx, ky, kz = k.unbind(-1)
    z = torch.zeros_like(kx)
    km = torch.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], -1).reshape(aa.shape + (3,))
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    small = (theta < 1e-12)[..., None]
    return torch.where(small, eye + _skew(aa), eye + s * km + (1 - c) * (km @ km))


def _skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], -1).reshape(v.shape + (3,))


def rot6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """The 6d representation is the first two rows; Gram-Schmidt, then the
    third row their cross product."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    a2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = a2 / torch.linalg.norm(a2, dim=-1, keepdim=True)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -2)


class Frame:
    """The canonical frame of the release's window canonicalization (the
    lafan1 ``rotate_at_frame`` it builds on) for head rotations ``rot0``
    (..., 3, 3): the rotation about z that turns +x to the horizontal part
    of rot0's +x axis, as the quaternion (wxyz) of the half-way vector
    between them. Both of its normalizations divide by norm + 1e-8, as
    lafan1's ``normalize`` does, so that near a heading of 180 degrees the
    quaternion falls short of unit length; positions are turned by the
    quaternion itself (``v + 2 w (u x v) + 2 u x (u x v)``, which that
    shortfall scales towards v), rotations by its normalized matrix."""

    def __init__(self, rot0: torch.Tensor):
        f = rot0[..., :, 0] * rot0.new_tensor([1.0, 1.0, 0.0])
        f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-8)
        x = torch.zeros_like(f)
        x[..., 0] = 1.0
        w = torch.sqrt((x * x).sum(-1) * (f * f).sum(-1)) + (x * f).sum(-1)
        q = torch.cat([w[..., None], torch.linalg.cross(x, f, dim=-1)], -1)
        self.q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-8)
        qw, qx, qy, qz = (self.q / torch.linalg.norm(self.q, dim=-1, keepdim=True)).unbind(-1)
        self.m = torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw),
                              2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw),
                              2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
                             -1).reshape(qw.shape + (3, 3))

    @staticmethod
    def _turn(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        u, w = q[..., 1:], q[..., :1]
        uv = torch.linalg.cross(u.expand_as(v), v, dim=-1)
        return v + 2.0 * (w * uv + torch.linalg.cross(u.expand_as(v), uv, dim=-1))

    def _q(self, v: torch.Tensor, inverse: bool) -> torch.Tensor:
        q = self.q * self.q.new_tensor([1.0, -1.0, -1.0, -1.0]) if inverse else self.q
        return q.reshape(q.shape[:1] + (1,) * (v.ndim - 2) + q.shape[1:])

    def into(self, v: torch.Tensor) -> torch.Tensor:
        """Positions (n, ..., 3) of the scene in the frame."""
        return self._turn(self._q(v, True), v)

    def out_of(self, v: torch.Tensor) -> torch.Tensor:
        """Positions (n, ..., 3) of the frame in the scene."""
        return self._turn(self._q(v, False), v)

    def rot_into(self, r: torch.Tensor) -> torch.Tensor:
        """Rotations (n, ..., 3, 3) of the scene in the frame."""
        return self.m.transpose(-1, -2).reshape(r.shape[:1] + (1,) * (r.ndim - 3) + (3, 3)) @ r

    def rot_out_of(self, r: torch.Tensor) -> torch.Tensor:
        return self.m.reshape(r.shape[:1] + (1,) * (r.ndim - 3) + (3, 3)) @ r


def fk(root: torch.Tensor, local: torch.Tensor, offsets: torch.Tensor):
    """root (..., 3), local rotations (..., 22, 3, 3), offsets (22, 3) ->
    global rotations (..., 22, 3, 3) and positions (..., 22, 3)."""
    g, p = [local[..., 0, :, :]], [root + offsets[0]]
    for j in range(1, NUM_JOINTS):
        par = SMPL_PARENTS[j]
        p.append(p[par] + (g[par] @ offsets[j][:, None])[..., 0])
        g.append(g[par] @ local[..., j, :, :])
    return torch.stack(g, -3), torch.stack(p, -2)


# -- floor and metrics (float64, on the host) --------------------------------


def dbscan_1d(x: np.ndarray) -> np.ndarray:
    """DBSCAN labels (-1 noise) of 1-D points, eps 0.005, min_samples 3:
    a core point has 3 points within eps (itself included), cores within
    eps of each other share a cluster, a border point takes its nearest
    core's."""
    d = np.abs(x[:, None] - x[None, :])
    near = d <= DBSCAN_EPS
    core = near.sum(1) >= DBSCAN_MIN
    labels = np.full(len(x), -1)
    n_clusters = 0
    for i in np.argsort(x):
        if not core[i] or labels[i] >= 0:
            continue
        labels[i], todo = n_clusters, [i]
        while todo:
            j = todo.pop()
            for k in np.nonzero(near[j] & core & (labels < 0))[0]:
                labels[k] = n_clusters
                todo.append(k)
        n_clusters += 1
    for i in np.nonzero(~core)[0]:
        cand = np.nonzero(near[i] & core)[0]
        if cand.size:
            labels[i] = labels[cand[np.argmin(d[i, cand])]]
    return labels


def floor_height(jpos: np.ndarray) -> float:
    """(T, 22, 3) -> the floor: the lowest median of the DBSCAN clusters (the
    noise points one more) of the heights of the toes' static frames
    (speed under 5 mm a frame, the last frame repeating the last speed),
    minus 1 cm; 0 when no frame is static."""
    heights = []
    for j in (LEFT_TOE, RIGHT_TOE):
        toe = jpos[:, j]
        v = np.linalg.norm(toe[1:] - toe[:-1], axis=-1)
        v = np.append(v, v[-1])
        heights.append(toe[v < FLOOR_VEL_THRESH, 2])
    h = np.concatenate(heights)
    if h.size == 0:
        return 0.0
    labels = dbscan_1d(h)
    return min(float(np.median(h[labels == lab])) for lab in np.unique(labels)) - FLOOR_HEIGHT_OFFSET


def _pose_dist(rp, pp, rg, pg):
    """mean_t ||I - P G^-1||_F of 4x4 poses, and of the rotations alone."""
    rel = rp @ rg.transpose(0, 2, 1)
    m = np.zeros(rel.shape[:-2] + (4, 4))
    m[:, :3, :3] = np.eye(3) - rel
    m[:, :3, 3] = -(pp - (rel @ pg[..., None])[..., 0])
    return np.sqrt((m * m).sum((1, 2))).mean(), np.sqrt(((np.eye(3) - rel) ** 2).sum((1, 2))).mean()


def _foot_sliding(jpos, floor):
    t = jpos.shape[0]
    total = 0.0
    for j, thresh in ((7, 0.08), (10, 0.04), (8, 0.08), (11, 0.04)):
        disp = np.linalg.norm(jpos[1:, j, :2] - jpos[:-1, j, :2], axis=-1)
        h = jpos[:-1, j, 2] - floor
        total += np.where(h < thresh, np.abs(disp * (2.0 - 2.0 ** (h / thresh))), 0.0).sum() / t * 1000.0
    return total / 4.0


def _accel(j):
    return j[2:] - 2 * j[1:-1] + j[:-2]


def metrics(gt_rot, gt_pos, pred_rot, pred_pos, pred_floor) -> dict:
    """The stage-2 metric suite of one sequence: rotations (T, 22, 3, 3)
    and positions (T, 22, 3); the GT already on its floor (height 0). mm
    where the name says trans, jpe, accel or fs."""
    out = {}
    for name, j in (("root", 0), ("head", HEAD)):
        out[f"{name}_dist"], out[f"{name}_rot_dist"] = _pose_dist(pred_rot[:, j], pred_pos[:, j], gt_rot[:, j],
                                                                 gt_pos[:, j])
        out[f"{name}_trans_dist"] = np.linalg.norm(pred_pos[:, j] - gt_pos[:, j], axis=-1).mean() * 1000.0
    per_joint = np.linalg.norm((pred_pos - pred_pos[:, :1]) - (gt_pos - gt_pos[:, :1]), axis=-1)
    single = per_joint.mean(0) * 1000.0
    out.update({"mpjpe": per_joint.mean() * 1000.0, "mpjpe_wo_hand": single[:18].mean(), "single_jpe": single,
                "accel_pred": np.linalg.norm(_accel(pred_pos), axis=-1).mean() * 1000.0,
                "accel_gt": np.linalg.norm(_accel(gt_pos), axis=-1).mean() * 1000.0,
                "accel_err": np.linalg.norm(_accel(pred_pos) - _accel(gt_pos), axis=-1).mean() * 1000.0,
                "pred_fs": _foot_sliding(pred_pos, pred_floor), "gt_fs": _foot_sliding(gt_pos, 0.0)})
    out.update({f"jpe_{i}": single[i] for i in range(NUM_JOINTS)})
    return out


# -- the chain ----------------------------------------------------------------


class Reference:
    """One configuration's reference: the denoiser at ``precision``, the
    schedule, the skeleton and the stats."""

    def __init__(self, cfg: dict, weights: dict, offsets, stats, precision: str = "f32"):
        self.cfg = cfg
        self.device = weights["linear_out.weight"].device
        self.den = Denoiser(weights, cfg, precision)
        self.sched = ddpm_schedule(cfg["timesteps"])
        self.tokens = self.den.noise_level_tokens([s[0] for s in self.sched])
        self.offsets = torch.as_tensor(offsets, dtype=F64, device=self.device)
        self.lo, self.hi = (torch.as_tensor(s, dtype=F64, device=self.device).reshape(-1) for s in stats)

    def normalize(self, jpos):  # (..., 22 * 3)
        return (jpos - self.lo) / (self.hi - self.lo) * 2.0 - 1.0

    def features(self, pos, rot, frame, move0):
        """Canonical features (..., 198) of (n, T, 22) joints: their positions
        in ``frame`` less the origin ``move0``, normalized, then the first two
        rows of each rotation in ``frame``."""
        jp = frame.into(pos) - move0[..., None, :]
        r6 = frame.rot_into(rot)[..., :2, :]
        lead = pos.shape[:-2]
        return torch.cat([self.normalize(jp.reshape(lead + (-1,))), r6.reshape(lead + (-1,))], -1)

    def reverse_chain(self, x_start, cond_mask, noise, rows, batch, value=None, mask=None):
        """DDPM over every timestep on x_start (b, T, d) of rows ``rows`` of
        a batch of ``batch``; the draws are the whole batch's, in the order
        initial, condition, one a step."""
        shape, dt = (batch,) + tuple(x_start.shape[1:]), self.den.dtype
        x = noise.initial(shape)[rows].to(dt)
        x_start = x_start.to(dt)
        x_cond = x_start * (1 - cond_mask) + cond_mask * noise.cond(shape)[rows].to(dt)
        value = None if value is None else value.to(dt)
        for i, (_, a1, a2, a3) in enumerate(self.sched):
            x0 = self.den(torch.cat([x, x_cond], -1), self.tokens[i]).clamp(-1.0, 1.0)
            x = a1 * x0 + a2 * x + a3 * noise.step(shape)[rows].to(dt)
            if value is not None:
                x = torch.where(mask > 0, value, x)
        return x

    def sample(self, head_pos, head_rot, noise, rows, batch):
        """The chained sampler on head tracks (b, T, 3) and (b, T, 3, 3),
        float64 -> local rotations (b, T', 22, 3, 3), root (b, T', 3)."""
        cfg = self.cfg
        d, w, ov = cfg["d_feats"], cfg["window"], cfg["overlap_frames"]
        n = head_pos.shape[0]
        whole = inpaint = None
        for start in range(0, head_pos.shape[1], w - ov):
            tw = min(w, head_pos.shape[1] - start)
            if tw <= ov:
                break
            hp, hr = head_pos[:, start: start + tw], head_rot[:, start: start + tw]
            frame = Frame(hr[:, 0])
            aligned = frame.into(hp)
            move0 = aligned[:, :1] * aligned.new_tensor([1.0, 1.0, 0.0])
            x_start = torch.zeros(n, tw, d, dtype=F64, device=self.device)
            x_start[..., HEAD * 3: HEAD * 3 + 3] = aligned - move0
            x_start[..., 66 + HEAD * 6: 66 + HEAD * 6 + 6] = frame.rot_into(hr)[..., :2, :].reshape(n, tw, 6)
            x_start[..., :66] = self.normalize(x_start[..., :66])
            cond_mask = torch.ones(n, tw, d, device=self.device)
            cond_mask[..., HEAD * 3: HEAD * 3 + 3] = 0.0
            cond_mask[..., 66 + HEAD * 6: 66 + HEAD * 6 + 6] = 0.0
            value = mask = None
            if inpaint is not None:
                mask = torch.zeros(n, tw, 1, device=self.device)
                mask[:, :ov] = 1.0
                value = torch.zeros(n, tw, d, dtype=F64, device=self.device)
                value[:, :ov] = inpaint
            x = self.reverse_chain(x_start, cond_mask, noise.window(), rows, batch, value, mask).double()
            # decode: positions de-normalized, rotations from 6d, turned back
            jpos = ((x[..., :66] + 1.0) * 0.5 * (self.hi - self.lo) + self.lo).reshape(n, tw, NUM_JOINTS, 3)
            glob = frame.rot_out_of(rot6d_to_matrix(x[..., 66:].reshape(n, tw, NUM_JOINTS, 6)))
            root, head = frame.out_of(jpos[:, :, 0]), frame.out_of(jpos[:, :, HEAD])
            par = list(SMPL_PARENTS[1:])
            local = torch.cat([glob[:, :, :1], glob[:, :, par].transpose(-1, -2) @ glob[:, :, 1:]], 2)
            if whole is None:
                whole = [local, root, head]
            else:
                move = whole[2][:, -1:] - head[:, ov - 1: ov]
                root, head = root + move, head + move
                whole = [torch.cat([a, b[:, ov:]], 1) for a, b in zip(whole, (local, root, head))]
            # the next window's overlap: FK of this window's last frames,
            # canonicalized at the first of them by the head
            g, p = fk(root[:, -ov:], local[:, -ov:], self.offsets)
            frame_n = Frame(g[:, 0, HEAD])
            head_al = frame_n.into(p[:, :, HEAD])
            inpaint = self.features(p, g, frame_n, head_al[:, :1] * head_al.new_tensor([1.0, 1.0, 0.0]))
        return whole[0], whole[1]

    @torch.no_grad()
    def run_batch(self, params: dict, noise, rows) -> dict:
        """Rows ``rows`` of one batch (the SMPL parameters as the program got
        them) through the eval path. Returns the chain's ``local`` rotations
        and ``root``, the FK ``jpos`` of the prediction (before centring) and
        each row's ``metrics``."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._run_batch(params, noise, rows)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def _run_batch(self, params, noise, rows):
        batch = params["gt_trans"].shape[0]
        as_t = lambda a: torch.as_tensor(np.asarray(a)[rows], dtype=F64, device=self.device)
        trans, root_orient, body = as_t(params["gt_trans"]), as_t(params["gt_root_orient"]), as_t(
            params["gt_body_pose"])
        n, t = trans.shape[:2]
        aa = torch.cat([root_orient[:, :, None], body.reshape(n, t, 21, 3)], 2)
        gt_rot, gt_pos = fk(trans, axis_angle_to_matrix(aa), self.offsets)
        gt_pos_np = gt_pos.cpu().numpy()
        floors = torch.as_tensor([floor_height(s) for s in gt_pos_np], dtype=F64, device=self.device)
        gt_pos = gt_pos - floors[:, None, None, None] * gt_pos.new_tensor([0.0, 0.0, 1.0])
        local, root = self.sample(gt_pos[:, :, HEAD], gt_rot[:, :, HEAD], noise,
                                  torch.as_tensor(rows, device=self.device), batch)
        pred_rot, pred_pos = fk(root, local, self.offsets)
        xy = gt_pos.new_tensor([1.0, 1.0, 0.0])
        tt = min(pred_pos.shape[1], t)
        pred_c = (pred_pos[:, :tt] - pred_pos[:, :1, HEAD:HEAD + 1] * xy).cpu().numpy()
        gt_c = (gt_pos[:, :tt] - gt_pos[:, :1, HEAD:HEAD + 1] * xy).cpu().numpy()
        pr, gr = pred_rot[:, :tt].cpu().numpy(), gt_rot[:, :tt].cpu().numpy()
        mds = [metrics(gr[i], gt_c[i], pr[i], pred_c[i], floor_height(pred_c[i])) for i in range(n)]
        return {"local": local, "root": root, "jpos": pred_pos, "metrics": mds}
