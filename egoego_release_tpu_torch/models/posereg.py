"""The pose-regression baseline (kinpoly "posereg"; port of
egoego_release_tpu/models/posereg.py, the reference's
kinpoly/relive/posereg_models/video_reg_net.py): per-frame optical-flow
features -> a temporal net (a bidirectional or causal LSTM, or a dilated
TCN) -> an MLP -> a per-frame regression, trained with a squared error.

The LSTMs are ``nn.LSTM`` (cuDNN on the card; flax's gate order i, f, g, o
is torch's, and flax's biases sit on the hidden products, so ``bias_ih``
is 0, ``utils.convert``; a gradient hook keeps it 0, or AdamW would move
each gate's bias at twice JAX's rate). The TCN's convolutions are ``nn.Conv1d`` on
explicit padding: (p // 2, p - p // 2) non-causal, (p, 0) causal. Dropout
runs only when ``deterministic=False`` is passed, as in flax: the JAX
trainer applies none, and neither does the port's. cuDNN computes RNNs and
convolutions in TF32 unless told otherwise; ``train_posereg`` runs them
under ``models.resnet.f32_convolutions``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egoego_release_tpu_torch.models.mlp import MLP


def _flax_biases(lstm: nn.LSTM) -> nn.LSTM:
    """Zero the gradient of each ``bias_ih``: flax's LSTM cell has one bias a
    gate, on the hidden product (``bias_hh``)."""
    for name, p in lstm.named_parameters():
        if name.startswith("bias_ih"):
            p.register_hook(torch.zeros_like)
    return lstm


class BiLSTM(nn.LSTM):
    """(B, T, D) -> (B, T, hidden): the forward and backward halves
    (hidden // 2 each) concatenated (posereg_models/rnn.py bi_dir mode)."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__(input_dim, hidden // 2, batch_first=True, bidirectional=True)
        _flax_biases(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


class CausalLSTM(nn.LSTM):
    """A unidirectional LSTM (the reference's causal=True mode)."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__(input_dim, hidden, batch_first=True)
        _flax_biases(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]


class TemporalBlock(nn.Module):
    """One dilated-convolution residual block (posereg_models/tcn.py) on
    (B, C, T)."""

    def __init__(self, in_dim: int, filters: int, kernel_size: int, dilation: int, causal: bool,
                 dropout: float = 0.2):
        super().__init__()
        pad = (kernel_size - 1) * dilation
        self.pad = (pad, 0) if causal else (pad // 2, pad - pad // 2)
        self.dropout = dropout
        self.conv0 = nn.Conv1d(in_dim, filters, kernel_size, dilation=dilation)
        self.conv1 = nn.Conv1d(filters, filters, kernel_size, dilation=dilation)
        self.downsample = nn.Conv1d(in_dim, filters, 1) if in_dim != filters else None

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        y = x
        for conv in (self.conv0, self.conv1):
            y = torch.relu(conv(F.pad(y, self.pad)))
            if not deterministic:
                y = F.dropout(y, self.dropout, training=True)
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class TemporalConvNet(nn.Module):
    """Blocks of widths ``sizes`` with dilations 1, 2, 4, ...: (B, T, D) ->
    (B, T, sizes[-1])."""

    def __init__(self, input_dim: int, sizes: tuple[int, ...] = (64, 128), kernel_size: int = 3,
                 causal: bool = False, dropout: float = 0.2):
        super().__init__()
        dims = (input_dim, *sizes)
        for i in range(len(sizes)):
            self.add_module(f"block{i}", TemporalBlock(dims[i], dims[i + 1], kernel_size, 2 ** i, causal, dropout))
        self.n_blocks = len(sizes)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = x.transpose(1, 2)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, deterministic)
        return x.transpose(1, 2)


class VideoRegNet(nn.Module):
    """OF features (B, T, feat_dim) -> per-frame regression (B, T, out_dim)
    (video_reg_net.py:11-65). With ``no_cnn=False`` the input is raw flow
    (B, T, H, W, 2) through a ResNet-18 of ``cnn_fdim`` outputs on its
    stored statistics (``eval()`` whatever the module's mode, as JAX applies
    it). ``feat_dim`` is the features' width when ``no_cnn`` (``cnn_fdim``
    by default). ``settings`` holds the arguments, to rebuild the network
    from a checkpoint (``VideoRegNet(**settings)``)."""

    def __init__(self, out_dim: int, v_hdim: int = 128, cnn_fdim: int = 512, v_net_type: str = "lstm",
                 mlp_dim: tuple[int, ...] = (300, 200), causal: bool = False,
                 tcn_sizes: tuple[int, ...] | None = None, no_cnn: bool = True, feat_dim: int | None = None):
        super().__init__()
        self.settings = dict(out_dim=out_dim, v_hdim=v_hdim, cnn_fdim=cnn_fdim, v_net_type=v_net_type,
                             mlp_dim=tuple(mlp_dim), causal=causal, tcn_sizes=tcn_sizes, no_cnn=no_cnn,
                             feat_dim=feat_dim)
        self.no_cnn, self.v_net_type, self.cnn_fdim = no_cnn, v_net_type, cnn_fdim
        in_dim = cnn_fdim
        if not no_cnn:
            from egoego_release_tpu_torch.models.resnet import ResNet18

            self.cnn = ResNet18(out_dim=cnn_fdim, running_stats=True)
        elif feat_dim is not None:
            in_dim = feat_dim
        if v_net_type == "lstm":
            self.v_net = CausalLSTM(in_dim, v_hdim) if causal else BiLSTM(in_dim, v_hdim)
        elif v_net_type == "tcn":
            sizes = tuple(tcn_sizes or (64, v_hdim))
            assert sizes[-1] == v_hdim
            self.v_net = TemporalConvNet(in_dim, sizes, causal=causal)
        else:
            raise ValueError(v_net_type)
        self.mlp = MLP(v_hdim, tuple(mlp_dim))
        self.linear = nn.Linear(self.mlp.out_dim, out_dim)

    def train(self, mode: bool = True):
        super().train(mode)
        if not self.no_cnn:
            self.cnn.eval()
        return self

    def forward(self, of_feats: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        x = of_feats
        if not self.no_cnn:
            from egoego_release_tpu_torch.models.resnet import flow_to_input

            b, t = x.shape[:2]
            x = self.cnn(flow_to_input(x.reshape((b * t,) + x.shape[2:]))).reshape(b, t, self.cnn_fdim)
        x = self.v_net(x, deterministic) if self.v_net_type == "tcn" else self.v_net(x)
        return self.linear(self.mlp(x))


def posereg_loss(pred_traj: torch.Tensor, gt_traj: torch.Tensor) -> torch.Tensor:
    """Squared-error trajectory loss (video_reg_net.py:67-77)."""
    return ((gt_traj - pred_traj) ** 2).sum(-1).mean()
