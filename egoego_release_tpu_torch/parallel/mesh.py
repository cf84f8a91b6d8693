"""Process meshes and the tensor-parallel rules over ``torch.distributed``
(port of egoego_release_tpu/parallel/mesh.py).

A (dp, tp) mesh of ``dp * tp`` processes, one rank each, laid out as JAX's
``reshape(dp, tp)``: rank r has dp coordinate r // tp and tp coordinate
r % tp.

- dp: each rank computes the rows [dp_rank * B / dp, (dp_rank + 1) * B / dp)
  of a batch padded to a multiple of dp (``pad_to_dp``, ``dp_rows``); the
  results are gathered over the dp group. Randomness is drawn for the whole
  padded batch and sliced (``RowNoise``), so any dp reproduces dp = 1 on the
  padded batch.
- tp: the Megatron split of each DecoderLayer (JAX ``_TP_RULES``): w_q, w_k,
  w_v and pos_ffn.w_1 split on the output dim (column parallel: this rank's
  heads and hidden units), self_attn.fc and pos_ffn.w_2 on the input dim
  (row parallel: a partial product, summed over the tp group before the
  bias, the residual and the LayerNorm). Anything whose dim does not divide
  stays replicated, as JAX's ``_spec_for`` does.

Backend: NCCL when every rank has a GPU of its own, gloo otherwise (CPU
ranks, or several ranks on one card, which NCCL refuses). gloo reduces and
broadcasts CUDA tensors; gathers go through host copies, once a batch.
"""

from __future__ import annotations

import os
import re
import socket
import sys
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

# (regex on a state_dict key) -> the dim split over tp. nn.Linear weights are
# (out, in), Conv1d(k=1) weights (out, in, 1); JAX's flax kernels are (in, out).
TP_RULES: list[tuple[str, int]] = [
    (r"self_attn\.(w_q|w_k|w_v)\.(weight|bias)$", 0),  # this rank's heads (column parallel)
    (r"self_attn\.fc\.weight$", 1),                     # row parallel: partial sums
    (r"pos_ffn\.w_1\.(weight|bias)$", 0),
    (r"pos_ffn\.w_2\.weight$", 1),
]


@dataclass
class Mesh:
    """This rank's place in a (dp, tp) mesh: its coordinates, its device and
    the process groups of its dp column and its tp row."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    dp_group: dist.ProcessGroup = field(repr=False)
    tp_group: dist.ProcessGroup = field(repr=False)

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def backend_for(devices) -> str:
    """NCCL when every rank has a GPU of its own, gloo otherwise."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def make_mesh(dp: int | None = None, tp: int = 1, devices=None) -> Mesh:
    """The (dp, tp) mesh over the initialized default process group, whose
    world size must be dp * tp (dp None: world / tp). ``devices[r]`` is rank
    r's device (default: ``cuda:r``). Every rank must call this, in the same
    order as any other group creation."""
    world = dist.get_world_size()
    dp = world // tp if dp is None else dp
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks, the process group has {world}")
    devices = [f"cuda:{r}" for r in range(world)] if devices is None else devices
    rank = dist.get_rank()
    groups = {}
    for d in range(dp):  # every rank builds every group, in one order
        g = dist.new_group([d * tp + t for t in range(tp)])
        if rank // tp == d:
            groups["tp"] = g
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if rank % tp == t:
            groups["dp"] = g
    return Mesh(dp, tp, rank, torch.device(devices[rank]), groups["dp"], groups["tp"])


# -- launching ranks -------------------------------------------------------


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, dp, tp, devices, port):
    if rank:  # rank 0 alone prints
        sys.stdout = open(os.devnull, "w")
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the CPU ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // (dp * tp)))
    dist.init_process_group(backend_for(devices), init_method=f"tcp://localhost:{port}",
                            world_size=dp * tp, rank=rank)
    try:
        fn(make_mesh(dp, tp, devices), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, args, dp: int, tp: int, devices) -> None:
    """Run ``fn(mesh, *args)`` in dp * tp new processes (``torch.
    multiprocessing.spawn``); ``fn`` must be importable by name. Rank r
    runs on ``devices[r]``; ``devices`` may also name one device type: the
    CPU for every rank, or ``cuda:r`` for rank r. Several ranks may share a
    card (gloo then); ranks other than 0 print nothing. Returns when every
    rank has returned; a rank that raises raises here."""
    n = dp * tp
    if isinstance(devices, str):
        devices = [devices] * n if torch.device(devices).type == "cpu" else [f"cuda:{r}" for r in range(n)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a {dp}x{tp} mesh")
    mp.spawn(_rank_main, args=(fn, args, dp, tp, list(devices), free_port()), nprocs=n, join=True)


# -- tensor parallel: the split rules -------------------------------------


def tp_dim(key: str, shape, tp: int) -> int | None:
    """The dim of ``key`` that tp splits, or None (replicated): the rule's
    dim if it divides by tp."""
    for pattern, dim in TP_RULES:
        if re.search(pattern, key):
            return dim if shape[dim] % tp == 0 else None
    return None


def count_tp_sharded(state_dict: dict, tp: int) -> int:
    """The entries the tp rules actually split (a guard against rule rot:
    non-matching keys and non-dividing dims replicate silently)."""
    return sum(tp_dim(k, v.shape, tp) is not None for k, v in state_dict.items())


def expected_tp_sharded(n_layers: int) -> int:
    """Per DecoderLayer: w_q/w_k/w_v weight + bias (6), fc weight (1),
    w_1 weight + bias (2), w_2 weight (1) = 10."""
    return 10 * n_layers


def shard_state_dict(sd: dict, mesh: Mesh) -> dict:
    """This rank's shards (tp coordinate ``mesh.tp_rank``) of a full
    state_dict; the rest is returned as is."""
    out = {}
    for k, v in sd.items():
        dim = tp_dim(k, v.shape, mesh.tp)
        out[k] = v if dim is None else v.chunk(mesh.tp, dim)[mesh.tp_rank].contiguous()
    return out


def gather_state_dict(sd: dict, mesh: Mesh, full_shapes: dict) -> dict:
    """The inverse of ``shard_state_dict`` on every rank: each split entry
    all-gathered over the tp group (through host copies) and concatenated
    on its dim; ``full_shapes`` are the unsharded shapes, which decide the
    split as ``shard_state_dict`` did. Returns CPU tensors."""
    out = {}
    for k, v in sd.items():
        dim = tp_dim(k, full_shapes[k], mesh.tp)
        v = v.detach()
        out[k] = (v if dim is None else torch.cat(_all_gather(v, mesh.tp_group), dim)).cpu()
    return out


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x (equal shapes) in rank order; through host copies
    under gloo, on the card under NCCL."""
    y = (x.cpu() if dist.get_backend(group) == "gloo" else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return parts


# -- tensor parallel: the layers' collectives ------------------------------


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the tp group
    (each rank's column-parallel products see only its own heads)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the tp group forward; identity backward (every rank's
    downstream is replicated, so its gradient is already whole). torch.
    distributed.nn.functional.all_reduce would sum the tp identical
    gradients in the backward too, tp times too much."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def row_parallel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, group) -> torch.Tensor:
    """x W^T + b with W split on its input dim over ``group`` (None: whole):
    the partial product summed over the group, then the bias once."""
    if group is None:
        return nn.functional.linear(x, weight, bias)
    y = _ReduceFromTP.apply(nn.functional.linear(x, weight), group)
    return y if bias is None else y + bias


# -- data parallel -----------------------------------------------------------


def pad_to_dp(x: torch.Tensor, dp: int):
    """Pad the leading dim up to a multiple of dp by repeating the last row.
    Returns (padded, original batch)."""
    b = x.shape[0]
    pad = (-b) % dp
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x, b


def dp_rows(n: int, mesh: Mesh) -> slice:
    """This rank's rows of a batch of n (a multiple of dp)."""
    if n % mesh.dp:
        raise ValueError(f"a batch of {n} rows is not divisible by dp={mesh.dp}")
    per = n // mesh.dp
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (equal shapes) concatenated on dim 0 in rank order,
    on x's device."""
    return torch.cat(_all_gather(x, group)).to(x.device)


class RowNoise:
    """A noise source that draws what ``src`` draws for a batch of ``n``
    rows and keeps ``rows`` of each draw (the first dim): each dp rank's
    share of the noise of the whole batch, as JAX shards the draws of one
    key. ``window``, ``split`` and ``dropout_seed`` pass through."""

    def __init__(self, src, n: int, rows: slice):
        self.src, self.n, self.rows = src, n, rows

    def window(self) -> "RowNoise":
        return RowNoise(self.src.window(), self.n, self.rows)

    def split(self, k: int) -> list["RowNoise"]:
        return [RowNoise(s, self.n, self.rows) for s in self.src.split(k)]

    def _rows(self, draw, shape):
        return draw((self.n,) + tuple(shape[1:]))[self.rows]

    def initial(self, shape):
        return self._rows(self.src.initial, shape)

    def cond(self, shape):
        return self._rows(self.src.cond, shape)

    def step(self, shape):
        return self._rows(self.src.step, shape)

    def randint(self, n: int, high: int) -> torch.Tensor:
        return self.src.randint(self.n, high)[self.rows]

    def dropout_seed(self) -> int:
        return self.src.dropout_seed()


def sharded_rows(fn, mesh: Mesh, noise, *arrays):
    """``fn(*local arrays, noise=...)`` on this rank's rows of ``arrays``
    (each (B, ...), padded to a multiple of dp by repeating the last row)
    with this rank's share of the noise of the padded batch (None: no
    noise); every output (each (rows, ...)) gathered over the dp group and
    cut back to B rows."""
    padded = [pad_to_dp(a, mesh.dp)[0] for a in arrays]
    b, n = arrays[0].shape[0], padded[0].shape[0]
    rows = dp_rows(n, mesh)
    out = fn(*(a[rows] for a in padded), noise=None if noise is None else RowNoise(noise, n, rows))
    return tuple(all_gather_rows(o, mesh.dp_group)[:b] for o in out)


# -- a module on the mesh ----------------------------------------------------


class RowSpec:
    """The rows [lo, lo + B_local) of a batch of n that this rank's forward
    computes; ``ShardedDropout`` draws its masks for the whole batch."""

    def __init__(self):
        self.lo, self.n = 0, None

    def set(self, rows: slice, n: int) -> None:
        self.lo, self.n = rows.start, n


class ShardedDropout(nn.Dropout):
    """Dropout whose mask is drawn for the whole batch (and, ``heads`` =
    (lo, hi, total), for every head) and sliced to this rank's share, so a
    sharded step draws the masks of the unsharded one: ``F.dropout`` on a
    tensor of ones of the whole shape, which consumes the generator as
    ``nn.Dropout`` on that shape does."""

    def __init__(self, p: float, rows: RowSpec, heads: tuple[int, int, int] | None = None):
        super().__init__(p)
        self.rows, self.heads = rows, heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        shape = list(x.shape)
        shape[0] = self.rows.n or shape[0]
        if self.heads is not None:
            shape[1] = self.heads[2]
        mask = nn.functional.dropout(x.new_ones(shape), self.p, True)
        mask = mask[self.rows.lo: self.rows.lo + x.shape[0]]
        if self.heads is not None:
            mask = mask[:, self.heads[0]: self.heads[1]]
        return x * mask


def shard_module_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Put a model of ``models.transformer`` layers on the mesh, in place:
    each tp-split parameter becomes this rank's shard (``shard_state_dict``),
    each split attention keeps this rank's n_head / tp heads, the split
    attention and FFN modules get the tp group, and every dropout becomes a
    ``ShardedDropout`` over the model's ``row_spec`` (set per forward by the
    caller under dp). The released key names stay; ``model.full_shapes``
    keeps the unsharded shapes for ``gather_state_dict``."""
    from egoego_release_tpu_torch.models.transformer import MultiHeadAttention, PositionwiseFeedForward

    tp = mesh.tp
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    split = lambda key: tp > 1 and tp_dim(key, full[key], tp) is not None
    model.full_shapes, model.row_spec, model.mesh = full, RowSpec(), mesh
    for name, mod in list(model.named_modules()):
        pre = name + "." if name else ""
        if isinstance(mod, MultiHeadAttention):
            h_all, on = mod.n_head, split(pre + "w_q.weight")
            if on and h_all % tp:
                raise ValueError(f"{name}: {h_all} heads do not split over tp={tp}")
            h = h_all // tp if on else h_all
            lo = mesh.tp_rank * h if on else 0
            mod.n_head, mod.tp_group = h, mesh.tp_group if on else None
            mod.attn_dropout = ShardedDropout(mod.attn_dropout.p, model.row_spec, (lo, lo + h, h_all)).train(
                mod.attn_dropout.training)
            mod.dropout = ShardedDropout(mod.dropout.p, model.row_spec).train(mod.dropout.training)
        elif isinstance(mod, PositionwiseFeedForward):
            mod.tp_group = mesh.tp_group if split(pre + "w_1.weight") else None
            mod.dropout = ShardedDropout(mod.dropout.p, model.row_spec).train(mod.dropout.training)
    local = shard_state_dict(dict(model.named_parameters()), mesh)
    for name, p in list(model.named_parameters()):
        if local[name].shape != p.shape:
            mod_name, _, attr = name.rpartition(".")
            model.get_submodule(mod_name).register_parameter(
                attr, nn.Parameter(local[name].detach().clone(), requires_grad=p.requires_grad))
    return model
