"""PWC-DC optical-flow network (port of egoego_release_tpu/models/pwcnet.py,
the reference's kinpoly/relive/data_process/PWCNet.py ``PWCDCNet``), in
NCHW, with the reference's module names, so its ``state_dict`` loads as it
is: a convolution + LeakyReLU(0.1) block is ``conv1a.0.weight``, the bare
convolutions are ``predict_flow6.weight``, ``deconv6.weight``,
``upfeat6.weight`` and ``dc_conv7.weight``; level 6's first block is
``conv6aa``, then ``conv6a`` (the reference's names).

- ``correlation``: the cost volume of the reference's CUDA correlation
  package (kernel 1, stride 1, displacement 4): 81 channels, each the mean
  over C of x1 and x2 shifted by (dy, dx), zero outside. Plain torch: the
  81 shifted products and means that JAX stacks.
- ``warp``: the backward warp by the flow, normalised by (W-1, H-1) and
  sampled by ``F.grid_sample(align_corners=False, padding_mode="zeros")``,
  zeroed where the warp of an all-ones image falls below 0.9999.
- ``pwcnet_forward``: flow2 (B, 2, H/4, W/4), or the training pyramid
  (flow2, ..., flow6); H and W divisible by 64. The convolutions run in f32
  on PyTorch's im2col + cuBLAS sgemm route, not cuDNN: with TF32 off,
  cuDNN's heuristics take an FFT algorithm for the widest level-2 layers
  (565 and 373 input channels at 112 x 192), and a forward of 4 pairs of
  448 x 768 took 1257 ms on an H100 against 38 ms on this route (cuDNN's
  TF32 took 34 ms and erred 5.7e-2; chip_smoke.py phase 16 times all three).
- ``init_pwcnet_``: Kaiming-normal (fan_in) weights and zero biases from an
  explicit generator, the reference's init (torch takes a transposed
  convolution's fan_in from its output channels).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from egoego_release_tpu_torch.models.resnet import f32_convolutions

_DD = np.cumsum([128, 128, 96, 64, 32])  # the decoder's dense-connection widths
_ND = 81  # (2 md + 1)^2, md = 4
_OUTS = (128, 128, 96, 64, 32)  # the five convolutions of a decoder level
# (first, second, third block, out channels) of the feature pyramid, strides 2 .. 64
_PYRAMID = (("conv1a", "conv1aa", "conv1b", 16), ("conv2a", "conv2aa", "conv2b", 32),
            ("conv3a", "conv3aa", "conv3b", 64), ("conv4a", "conv4aa", "conv4b", 96),
            ("conv5a", "conv5aa", "conv5b", 128), ("conv6aa", "conv6a", "conv6b", 196))
_WIDTHS = {6: _ND, 5: _ND + 128 + 4, 4: _ND + 96 + 4, 3: _ND + 64 + 4, 2: _ND + 32 + 4}  # a level's input
_FLOW_SCALES = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))  # dc_conv1..6: (out, dilation)


def is_transposed(name: str) -> bool:
    """Whether the reference's module ``name`` is a ConvTranspose2d."""
    return name.startswith(("deconv", "upfeat"))


def state_key(name: str) -> str:
    """The state_dict prefix of module ``name``'s convolution: ``.0`` inside
    a convolution + LeakyReLU block."""
    bare = is_transposed(name) or name.startswith("predict_flow") or name == "dc_conv7"
    return name if bare else name + ".0"


def _block(cin: int, cout: int, stride: int = 1, dilation: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, stride, dilation, dilation), nn.LeakyReLU(0.1))


class PWCDCNet(nn.Module):
    """The network's modules; ``forward`` takes the reference's (B, 6, H, W)
    pair and returns flow2 in ``eval()``, the pyramid in ``train()``."""

    def __init__(self):
        super().__init__()
        cin = 3
        for first, second, third, cout in _PYRAMID:
            setattr(self, first, _block(cin, cout, stride=2))
            setattr(self, second, _block(cout, cout))
            setattr(self, third, _block(cout, cout))
            cin = cout
        for lvl in (6, 5, 4, 3, 2):
            acc = _WIDTHS[lvl]
            for i, out in enumerate(_OUTS):
                setattr(self, f"conv{lvl}_{i}", _block(acc, out))
                acc += out
            setattr(self, f"predict_flow{lvl}", nn.Conv2d(acc, 2, 3, 1, 1))
            if lvl > 2:
                setattr(self, f"deconv{lvl}", nn.ConvTranspose2d(2, 2, 4, 2, 1))
                setattr(self, f"upfeat{lvl}", nn.ConvTranspose2d(acc, 2, 4, 2, 1))
        cin = _WIDTHS[2] + int(_DD[4])
        for i, (out, dil) in enumerate(_CONTEXT):
            setattr(self, f"dc_conv{i + 1}", _block(cin, out, dilation=dil))
            cin = out
        self.dc_conv7 = nn.Conv2d(32, 2, 3, 1, 1)

    def features(self, im: torch.Tensor) -> list[torch.Tensor]:
        """The six pyramid levels of one image, strides 2 .. 64."""
        feats, x = [], im
        for names in _PYRAMID:
            for name in names[:3]:
                x = getattr(self, name)(x)
            feats.append(x)
        return feats

    def decode(self, lvl: int, x: torch.Tensor):
        """A DenseNet decoder level: five convolutions, each output put in
        front of its input, then the flow head. Returns (features, flow)."""
        for i in range(5):
            x = torch.cat([getattr(self, f"conv{lvl}_{i}")(x), x], 1)
        return x, getattr(self, f"predict_flow{lvl}")(x)

    def forward(self, x: torch.Tensor):
        return pwcnet_forward(self, x[:, :3], x[:, 3:], training=self.training)


def correlation(x1: torch.Tensor, x2: torch.Tensor, md: int = 4) -> torch.Tensor:
    """(B, C, H, W) x 2 -> (B, (2 md + 1)^2, H, W): channel (dy + md)(2 md +
    1) + (dx + md) is mean_c x1(c, y, x) x2(c, y + dy, x + dx)."""
    h, w = x1.shape[2:]
    x2p = F.pad(x2, (md, md, md, md))
    n = 2 * md + 1
    return torch.stack([(x1 * x2p[:, :, dy:dy + h, dx:dx + w]).mean(1) for dy in range(n) for dx in range(n)], 1)


def warp(x: torch.Tensor, flo: torch.Tensor) -> torch.Tensor:
    """Backward-warp x (B, C, H, W) by flo (B, 2, H, W), the reference's
    warp: the grid plus the flow, normalised by (W-1, H-1), bilinear
    samples with zero padding (align_corners=False), and zero wherever the
    same warp of an all-ones image falls below 0.9999."""
    h, w = x.shape[2:]
    xx = torch.arange(w, dtype=x.dtype, device=x.device)[None, None, :]
    yy = torch.arange(h, dtype=x.dtype, device=x.device)[None, :, None]
    grid = torch.stack([2.0 * (xx + flo[:, 0]) / max(w - 1, 1) - 1.0,
                        2.0 * (yy + flo[:, 1]) / max(h - 1, 1) - 1.0], -1)
    sample = lambda img: F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    mask = sample(torch.ones_like(x[:, :1]))  # the ones' warp is the same in every channel
    return sample(x) * (mask >= 0.9999).to(x.dtype)


def pwcnet_forward(model: PWCDCNet, im1: torch.Tensor, im2: torch.Tensor, training: bool = False):
    """The PWC-DC forward on (B, 3, H, W) image pairs, H and W divisible by
    64: flow2 (B, 2, H/4, W/4), or with ``training`` the pyramid (flow2,
    flow3, flow4, flow5, flow6). The convolutions run in f32, without
    cuDNN (the module docstring says why)."""
    with f32_convolutions(cudnn=False):
        c1, c2 = model.features(im1), model.features(im2)
        x, flow = model.decode(6, F.leaky_relu(correlation(c1[5], c2[5]), 0.1))
        flows = {6: flow}
        for lvl in (5, 4, 3, 2):
            up_flow, up_feat = getattr(model, f"deconv{lvl + 1}")(flow), getattr(model, f"upfeat{lvl + 1}")(x)
            warped = warp(c2[lvl - 1], up_flow * _FLOW_SCALES[lvl])
            corr = F.leaky_relu(correlation(c1[lvl - 1], warped), 0.1)
            x, flow = model.decode(lvl, torch.cat([corr, c1[lvl - 1], up_flow, up_feat], 1))
            flows[lvl] = flow
        ctx = x
        for i in range(1, 7):
            ctx = getattr(model, f"dc_conv{i}")(ctx)
        flows[2] = flows[2] + model.dc_conv7(ctx)
    return tuple(flows[i] for i in (2, 3, 4, 5, 6)) if training else flows[2]


@torch.no_grad()
def init_pwcnet_(model: PWCDCNet, generator: torch.Generator) -> PWCDCNet:
    """Kaiming-normal (fan_in, gain sqrt 2) weights and zero biases for every
    convolution, from ``generator``."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = mod.weight.shape[1] * mod.weight[0, 0].numel()
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in))
            mod.bias.zero_()
    return model
