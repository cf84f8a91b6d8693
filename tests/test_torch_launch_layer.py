"""The launch layer (ops/cuda_kernels.py) on the CPU: the launch counters
that a captured step sets aside and adds back (``set_aside``,
``add_counts``), and the layer's imports, which reach no module above it.

    python -m pytest tests/test_torch_launch_layer.py -q
"""

import ast
from collections import Counter

from egoego_release_tpu_torch.ops import cuda_kernels as ck

# the modules that call into the launch layer
ABOVE = ("egoego_release_tpu_torch.ops.fused_layer", "egoego_release_tpu_torch.ops.fused_step",
         "egoego_release_tpu_torch.diffusion")


def launch(kernel, mode, m, n, sms=132):
    """The struct of one launch as egoego_gemm leaves it."""
    tiles, grid = ck.bias_tiles(m, n, sms)
    return ck.GemmArgs(M=m, N=n, K=512, mode=mode, compute_bf16=int(kernel == "gemm_wgmma"),
                       kernel=ck.GEMM_KERNELS.index(kernel), tiles=tiles, grid=grid)


def counters():
    return [Counter(c) for c in (ck.kernel_launches, ck.gemm_modes, ck.launch_counts, ck.gemm_tiles)]


def test_set_aside_reports_the_launches_inside_and_restores_the_counters():
    """What the launches inside count is reported counter by counter and
    taken back out on exit; add_counts adds the report back as it came."""
    before = counters()
    with ck.set_aside() as added:
        ck.count_gemm(launch("gemm_wgmma", ck.BIAS, 64 * 121, 3072))
        ck.count_gemm(launch("gemm_tf32x3", ck.LAYER_NORM, 64 * 121, 512))
        ck.count("decoder_layer")
        assert added == []  # filled on exit
    assert counters() == before
    assert added == [Counter({"gemm_wgmma": 1, "gemm_tf32x3": 1}), Counter({ck.BIAS: 1, ck.LAYER_NORM: 1}),
                     Counter({"decoder_layer": 1}), Counter({"bias": 732, "bias_hidden": 600})]
    with ck.set_aside() as again:
        ck.add_counts(added)
        ck.add_counts(added)
    assert again == [Counter({n: 2 * v for n, v in c.items()}) for c in added]
    assert counters() == before


def test_launch_layer_imports_nothing_above_it():
    """cuda_kernels imports no module that calls into it, at the top or
    inside a function."""
    tree = ast.parse((ck.PACKAGE_DIR / "ops" / "cuda_kernels.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names += [node.module] + [f"{node.module}.{a.name}" for a in node.names]
    assert "egoego_release_tpu_torch.utils.trace" in names
    assert not [n for n in names if n.startswith(ABOVE)]
