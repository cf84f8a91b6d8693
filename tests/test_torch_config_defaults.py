"""The port's ``DiffusionConfig()`` defaults against the JAX package's:
every field both configs have holds the same default (``compute_dtype``
"float32" among them, so ``CondGaussianDiffusion(DiffusionConfig())``
samples in f32 in both packages), and the fields only one side has are
the known ones."""

import dataclasses

import pytest

from egoego_release_tpu.diffusion import DiffusionConfig as JConfig
from egoego_release_tpu_torch.diffusion.gaussian_diffusion import DiffusionConfig

PORT = {f.name: getattr(DiffusionConfig(), f.name) for f in dataclasses.fields(DiffusionConfig)}
JAX = {f.name: getattr(JConfig(), f.name) for f in dataclasses.fields(JConfig)}
# JAX only: fused_step (the port's samplers always run the step kernels
# unless fused_transformer is set)
JAX_ONLY = {"fused_step"}
PORT_ONLY = set()


@pytest.mark.parametrize("field", sorted(set(PORT) & set(JAX)))
def test_shared_default_equals_jax(field):
    assert PORT[field] == JAX[field]


def test_default_numerics_are_f32():
    assert PORT["compute_dtype"] == JAX["compute_dtype"] == "float32"


def test_fields_only_one_side_has():
    assert set(JAX) - set(PORT) == JAX_ONLY
    assert set(PORT) - set(JAX) == PORT_ONLY
    assert JAX["fused_step"] is False
    assert (PORT["p2_loss_weight_gamma"], PORT["p2_loss_weight_k"]) == (0.0, 1.0)
