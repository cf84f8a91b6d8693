"""Offline optical-flow feature extraction CLI (port of
egoego_release_tpu/preprocess/of_feats.py), on the card unless ``--device
cpu`` is given.

Reads RAFT flow npys (H x W x 2), resizes each to 224 x 224 on the host
(nearest neighbour), encodes them a batch at a time with the ResNet-18
(stored BatchNorm statistics, f32 convolutions) and writes one 512-d
``raft_of_feats`` npy per frame beside the flows: the features that every
stage-1 entry point reads.

    python -m egoego_release_tpu_torch.preprocess.of_feats \\
        --flow_root <dir with */raft_flows/*.npy> [--torch_resnet resnet18.pth] [--batch 64] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from egoego_release_tpu_torch.models.resnet import (
    ResNet18,
    convert_torchvision_resnet18,
    f32_convolutions,
    flow_to_input,
    init_resnet_,
)
from egoego_release_tpu_torch.utils.device import resolve_device


class FlowEncoder:
    """(B, H, W, 2) f32 flows (numpy) -> (B, out_dim) features (numpy): the
    ResNet-18 ``model`` in eval() on ``device``, its convolutions in f32."""

    def __init__(self, model: ResNet18, device: torch.device):
        self.model, self.device = model.to(device).eval(), device

    @torch.no_grad()
    def __call__(self, flow_batch: np.ndarray) -> np.ndarray:
        x = flow_to_input(torch.from_numpy(flow_batch).to(self.device))
        with f32_convolutions():
            return self.model(x).cpu().numpy()


def build_encoder(torch_resnet: str | None = None, out_dim: int = 512, device="cuda") -> FlowEncoder:
    """The encoder on torchvision weights (a state_dict or a pickled model;
    the fc replaced as ``convert_torchvision_resnet18`` does), or on random
    weights from seed 0 when there is no such file."""
    dev = resolve_device(device)
    model = ResNet18(out_dim=out_dim)
    if torch_resnet and os.path.exists(torch_resnet):
        sd = torch.load(torch_resnet, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        model.load_state_dict(convert_torchvision_resnet18(sd, out_dim))
    else:
        print("WARNING: no torchvision weights; random-init encoder")
        init_resnet_(model, torch.Generator().manual_seed(0))
    return FlowEncoder(model, dev)


def resize_flow(flow: np.ndarray, size: int = 224) -> np.ndarray:
    """Nearest-neighbour resize on the host (the reference feeds 224 x 224)."""
    h, w = flow.shape[:2]
    if (h, w) == (size, size):
        return flow
    yi = np.linspace(0, h - 1, size).astype(int)
    xi = np.linspace(0, w - 1, size).astype(int)
    return flow[yi][:, xi]


def extract_folder(flow_dir: str, encode, batch: int = 64) -> int:
    """Encode every flow npy of ``flow_dir`` (a ``raft_flows`` folder) into
    the ``raft_of_feats`` folder beside it, ``batch`` frames at a time, in
    file-name order; returns the number written."""
    out_dir = flow_dir.replace("raft_flows", "raft_of_feats")
    os.makedirs(out_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(flow_dir) if f.endswith(".npy"))
    n = 0
    for s in range(0, len(files), batch):
        chunk = files[s: s + batch]
        flows = np.stack([resize_flow(np.load(os.path.join(flow_dir, f)).astype(np.float32)) for f in chunk])
        for f, feat in zip(chunk, encode(flows)):
            np.save(os.path.join(out_dir, f), feat)
            n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--flow_root", required=True)
    p.add_argument("--torch_resnet", default=None)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    encode = build_encoder(args.torch_resnet, device=args.device)
    total = 0
    for dirpath, _, _ in os.walk(args.flow_root):
        if os.path.basename(dirpath) == "raft_flows":
            total += extract_folder(dirpath, encode, args.batch)
            print(f"{dirpath}: done ({total} total)")
    print(f"extracted {total} feature files")
    return total


if __name__ == "__main__":
    main()
