"""PyTorch/CUDA port of egoego_release_tpu for NVIDIA Hopper (H100).

The stage-2 inference path: rotations, FK, the denoiser, the DDPM/DDIM
samplers with hand-written CUDA kernels for the denoise step, the canonical
sliding-window chain, metrics and the eval_stage2 CLI. Imports torch
and numpy only.
"""
