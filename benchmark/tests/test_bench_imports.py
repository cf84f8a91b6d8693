"""What the benchmark loads, each in a fresh interpreter: no top-level module
named jax, jaxlib, flax or egoego_release_tpu (compared whole: the port's
egoego_release_tpu_torch begins with the JAX package's name), and a
reference that loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import spec

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_modules(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    mods = top_level_modules("import benchmark.run, benchmark.calibrate, benchmark.devtime, benchmark.spans\n"
                             "from egoego_release_tpu_torch.eval import pipeline\n"
                             "from egoego_release_tpu_torch.ops import cuda_kernels, fused_step")
    assert "egoego_release_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "egoego_release_tpu"}, mods


def test_the_reference_loads_nothing_of_the_port():
    mods = top_level_modules("import benchmark.reference, benchmark.inputs, benchmark.check, benchmark.flops")
    assert not mods & {"egoego_release_tpu_torch", "jax", "jaxlib", "flax", "egoego_release_tpu"}, mods


def test_the_harness_reports_a_loaded_jax_package(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "egoego_release_tpu", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["egoego_release_tpu", "jax"]
