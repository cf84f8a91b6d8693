"""The benchmark of the PyTorch and CUDA port (``egoego_release_tpu_torch``).

See ``benchmark/README.md``. Nothing here imports JAX or the JAX package,
and ``reference.py`` and ``inputs.py`` import nothing of the port.
"""
