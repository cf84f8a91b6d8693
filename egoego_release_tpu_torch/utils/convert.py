"""Weights into the port's denoiser.

* ``denoiser_state_dict_from_jax``: the JAX package's flax parameter tree
  (as numpy) -> this package's ``state_dict`` (Dense kernels transposed,
  the Conv1d(k=1) axis added back).
* ``load_stage2_diffusion_ckpt``: a released ``stage2_diffusion_*.pt``
  read directly, EMA weights by default.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def denoiser_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """{"params": {...}} of ``TransformerDiffusionModel`` -> state_dict."""
    p = params["params"]
    sd = {}

    def dense(key, leaf):
        sd[key + ".weight"] = _t(np.asarray(leaf["kernel"]).T)
        sd[key + ".bias"] = _t(leaf["bias"])

    def conv(key, leaf):
        sd[key + ".weight"] = _t(np.asarray(leaf["kernel"]).T[..., None])
        sd[key + ".bias"] = _t(leaf["bias"])

    def norm(key, leaf):
        sd[key + ".weight"] = _t(leaf["scale"])
        sd[key + ".bias"] = _t(leaf["bias"])

    dense("time_mlp.1", p["time_mlp_1"])
    dense("time_mlp.3", p["time_mlp_2"])
    mt = p["motion_transformer"]
    conv("motion_transformer.start_conv", mt["start_conv"])
    i = 0
    while f"layer_{i}" in mt:
        lp, key = mt[f"layer_{i}"], f"motion_transformer.layer_stack.{i}"
        for name in ("w_q", "w_k", "w_v", "fc"):
            dense(f"{key}.self_attn.{name}", lp["self_attn"][name])
        norm(f"{key}.self_attn.layer_norm", lp["self_attn"]["layer_norm"])
        conv(f"{key}.pos_ffn.w_1", lp["pos_ffn"]["w_1"])
        conv(f"{key}.pos_ffn.w_2", lp["pos_ffn"]["w_2"])
        norm(f"{key}.pos_ffn.layer_norm", lp["pos_ffn"]["layer_norm"])
        i += 1
    dense("linear_out", p["linear_out"])
    return sd


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_stage2_diffusion_ckpt(path: str, use_ema: bool = True):
    """stage2_diffusion_*.pt ({step, model, ema, ...}) -> (denoiser
    state_dict, step). The reference samples with the EMA weights, which
    ema-pytorch keeps under ``ema_model.``; the denoiser's keys carry the
    ``denoise_fn.`` prefix of CondGaussianDiffusion."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {}
    if use_ema and "ema" in ckpt:
        sd = _strip(ckpt["ema"], "ema_model.")
    if not sd:
        sd = ckpt["model"] if "model" in ckpt else ckpt
    sd = _strip(sd, "denoise_fn.")
    if not sd:
        raise ValueError(f"{path}: no denoise_fn.* weights found")
    return sd, int(ckpt.get("step", 0))


def load_denoiser_weights(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """Load a denoiser state_dict; the reference's frozen position table
    (recomputed here) is the only key the module may lack."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    unexpected = [k for k in unexpected if "position" not in k]
    if missing or unexpected:
        raise ValueError(f"denoiser weights: missing {missing}, unexpected {unexpected}")
    return model
