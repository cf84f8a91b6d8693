"""VPoser v1's latent-pose decoder (port of
egoego_release_tpu/models/vposer.py), with human_body_prior's module names
(``bodyprior_dec_fc1``, ``bodyprior_dec_fc2``, ``bodyprior_dec_out``), so
the decoder's part of a released snapshot loads as it is:

    Linear(32, 512) -> LeakyReLU(0.2) -> [dropout: identity in eval]
    Linear(512, 512) -> LeakyReLU(0.2) -> Linear(512, 21 x 6)
    -> ContinousRotReprDecoder -> rotation matrices

ContinousRotReprDecoder reads the 6 numbers as two matrix COLUMNS, unlike
``ops.rotations.rot6d_to_matrix`` (rows), so it lives here, as in JAX. No
VPoser weights ship with the repository (a licensed download).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egoego_release_tpu_torch.ops.rotations import matrix_to_axis_angle

NUM_JOINTS = 21
LATENT_D = 32
NUM_NEURONS = 512


def cont_rot_repr_decode(d6: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3): the 6 numbers are two 3-d columns [a1 a2];
    b1 = a1 / |a1|, b2 = the normalised part of a2 orthogonal to b1, b3 = b1
    x b2, R = [b1 b2 b3] (norms floored at 1e-8, as JAX)."""
    a = d6.reshape(d6.shape[:-1] + (3, 2))
    a1, a2 = a[..., 0], a[..., 1]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True).clamp_min(1e-8)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True).clamp_min(1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


class VPoserDecoder(nn.Module):
    def __init__(self, latent_d: int = LATENT_D, num_neurons: int = NUM_NEURONS, num_joints: int = NUM_JOINTS):
        super().__init__()
        self.num_joints = num_joints
        self.bodyprior_dec_fc1 = nn.Linear(latent_d, num_neurons)
        self.bodyprior_dec_fc2 = nn.Linear(num_neurons, num_neurons)
        self.bodyprior_dec_out = nn.Linear(num_neurons, num_joints * 6)

    def rot6d(self, latent: torch.Tensor) -> torch.Tensor:
        """(..., 32) latents -> the network's (..., 21, 6) outputs."""
        x = F.leaky_relu(self.bodyprior_dec_fc1(latent), 0.2)
        x = F.leaky_relu(self.bodyprior_dec_fc2(x), 0.2)
        x = self.bodyprior_dec_out(x)
        return x.reshape(x.shape[:-1] + (self.num_joints, 6))

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """(..., 32) latents -> (..., 21, 3, 3) rotation matrices."""
        return cont_rot_repr_decode(self.rot6d(latent))


@torch.no_grad()
def vposer_decode(model: VPoserDecoder, latent: torch.Tensor, output_type: str = "aa") -> torch.Tensor:
    """Decode latents (..., 32): "aa" -> (..., 21, 3) axis-angle (what the
    GIMO extraction writes), "matrot" -> (..., 21, 3, 3)."""
    if output_type not in ("aa", "matrot"):
        raise ValueError(f"unknown output_type {output_type!r}")
    m = model(latent)
    return matrix_to_axis_angle(m) if output_type == "aa" else m


def load_vposer_ckpt(path: str, device="cpu") -> VPoserDecoder:
    """A VPoser v1 snapshot (a state_dict, or {"state_dict": ...}) -> the
    decoder on ``device``, in eval(); the encoder's keys are left out."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    model = VPoserDecoder()
    model.load_state_dict({k: v.float() for k, v in sd.items() if k.startswith("bodyprior_dec_")})
    return model.to(device).eval()
