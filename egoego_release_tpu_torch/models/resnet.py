"""ResNet-18 optical-flow encoder (port of egoego_release_tpu/models/resnet.py).

torchvision's resnet18 with the classifier replaced by ``Linear(512,
out_dim)``, in NCHW and with torchvision's ``state_dict`` keys
(``conv1.weight``, ``layer1.0.bn1.running_mean``,
``layer2.0.downsample.0.weight``, ``fc.weight``, ...), so a torchvision
checkpoint loads with ``load_state_dict`` as it is once
``convert_torchvision_resnet18`` has replaced its fc, as the JAX package
does. BatchNorm runs in one of two modes:

- ``running_stats=True``: stored statistics in ``eval()`` (the ``of_feats``
  encoder; JAX ``train=False``);
- ``running_stats=False``: ``BatchNorm2d(track_running_stats=False)``, the
  statistics of the whole batch in ``train()`` and ``eval()`` alike, with
  the biased variance (``HeadFormerWithCNN``; the reference's
  ``running_stats=False``, JAX ``bn_batch_stats=True``). The modules then
  hold no running buffers.

cuDNN computes f32 convolutions in TF32 unless told otherwise; the entry
points that run this network wrap it in ``f32_convolutions()``, so the
convolutions are f32, as the JAX package computes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))  # (filters, stride of the first block) of layer1..layer4


def f32_convolutions(cudnn: bool = True):
    """A context in which f32 convolutions run in f32: cuDNN with TF32 off,
    or with ``cudnn=False`` PyTorch's own im2col + cuBLAS sgemm route
    (``torch.backends.cuda.matmul.allow_tf32`` is off by default). cuDNN's
    other settings stay as they are, and all are restored on exit."""
    b = torch.backends.cudnn
    return b.flags(enabled=cudnn and b.enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                   allow_tf32=False)


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, stride: int = 1, running_stats: bool = True):
        super().__init__()
        bn = lambda c: nn.BatchNorm2d(c, track_running_stats=running_stats)
        self.conv1 = nn.Conv2d(in_ch, filters, 3, stride, 1, bias=False)
        self.bn1 = bn(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = bn(filters)
        self.downsample = None
        if in_ch != filters or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, filters, 1, stride, bias=False), bn(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNet18(nn.Module):
    """(B, 3, H, W) -> (B, out_dim); fully convolutional up to the global
    average pool, so any H, W >= 32 works (the reference feeds 224 x 224)."""

    def __init__(self, out_dim: int = 512, running_stats: bool = True):
        super().__init__()
        bn = lambda c: nn.BatchNorm2d(c, track_running_stats=running_stats)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        in_ch = 64
        for s, (filters, stride) in enumerate(STAGES):
            blocks = [BasicBlock(in_ch, filters, stride, running_stats), BasicBlock(filters, filters, 1, running_stats)]
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))
            in_ch = filters
        self.fc = nn.Linear(512, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        return self.fc(x.mean(dim=(2, 3)))


def flow_to_input(flow: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 2) optical flow -> (B, 3, H, W): channels first, the third
    channel zero (the reference's FeatureExtractor)."""
    return F.pad(flow.permute(0, 3, 1, 2), (0, 0, 0, 0, 0, 1))


@torch.no_grad()
def init_resnet_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """torchvision's scheme from an explicit generator: every Conv2d
    kaiming-normal (fan_out, ReLU gain), BatchNorm weight 1 and bias 0, the
    fc uniform(+-1/sqrt(512)). Running statistics, where kept, at 0 / 1."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            std = math.sqrt(2.0 / (mod.weight.shape[0] * mod.weight[0, 0].numel()))
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if mod.track_running_stats:
                mod.reset_running_stats()
        elif isinstance(mod, nn.Linear):
            bound = 1.0 / math.sqrt(mod.weight.shape[1])
            for p in (mod.weight, mod.bias):
                p.copy_(torch.rand(p.shape, generator=generator) * 2 * bound - bound)
    return model


def convert_torchvision_resnet18(sd: dict, out_dim: int = 512) -> dict[str, torch.Tensor]:
    """A torchvision resnet18 ``state_dict`` (tensors or numpy) -> this
    module's: the same keys, as f32 (``num_batches_tracked`` as int64). Its
    fc is kept when it already has ``out_dim`` outputs; otherwise it is
    replaced, as the reference replaces the classifier, by
    ``RandomState(0).randn(512, out_dim) * 0.02`` (transposed) and a zero
    bias, the JAX package's draw."""
    out = {}
    for k, v in sd.items():
        t = torch.as_tensor(np.asarray(v))
        out[k] = t.long() if k.endswith("num_batches_tracked") else t.float()
    if "fc.weight" not in out or out["fc.weight"].shape[0] != out_dim:
        rng = np.random.RandomState(0)
        out["fc.weight"] = torch.from_numpy((rng.randn(512, out_dim).astype(np.float32) * 0.02).T.copy())
        out["fc.bias"] = torch.zeros(out_dim)
    return out
