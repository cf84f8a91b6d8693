"""Weights into the port's models.

* ``denoiser_state_dict_from_jax``, ``headformer_state_dict_from_jax``,
  ``gravitynet_state_dict_from_jax``: the JAX package's flax parameter
  trees (as numpy) -> this package's ``state_dict``s (Dense kernels
  transposed, the Conv1d(k=1) axis added back, ``affine_{i}`` ->
  ``affine_layers.{i}``).
* ``load_stage2_diffusion_ckpt``: a released ``stage2_diffusion_*.pt``
  read directly, EMA weights by default.
* ``load_stage1_ckpt``: a released ``stage1_headnet_*.pt`` or
  ``stage1_gravitynet_*.pt``, checked against the target widths and
  layer count before it is used.
* ``trainer_state_from_jax``: the JAX stage-2 trainer's ``TrainState`` ->
  the dict of a ``training.trainer_diffusion`` checkpoint.
* ``stage1_state_from_jax``: the JAX ``Stage1State`` -> the dict that
  ``training.trainer_stage1.Stage1Trainer.state_from_dict`` takes.
* ``resnet18_state_dict_from_jax``, ``headformer_cnn_state_dict_from_jax``,
  ``pwcnet_state_dict_from_jax``: flax trees of the optical-flow models ->
  torchvision's / the reference's ``state_dict`` keys (HWIO kernels ->
  OIHW; a transposed convolution's (kh, kw, in, out) -> (in, out, kh, kw)).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(sd, key, leaf):
    sd[key + ".weight"] = _t(np.asarray(leaf["kernel"]).T)
    sd[key + ".bias"] = _t(leaf["bias"])


def _conv(sd, key, leaf):
    sd[key + ".weight"] = _t(np.asarray(leaf["kernel"]).T[..., None])
    sd[key + ".bias"] = _t(leaf["bias"])


def _norm(sd, key, leaf):
    sd[key + ".weight"] = _t(leaf["scale"])
    sd[key + ".bias"] = _t(leaf["bias"])


def _decoder(sd, prefix, tree):
    """A flax ``Decoder`` subtree -> ``{prefix}.start_conv``,
    ``{prefix}.layer_stack.{i}...``."""
    _conv(sd, f"{prefix}.start_conv", tree["start_conv"])
    i = 0
    while f"layer_{i}" in tree:
        lp, key = tree[f"layer_{i}"], f"{prefix}.layer_stack.{i}"
        for name in ("w_q", "w_k", "w_v", "fc"):
            _dense(sd, f"{key}.self_attn.{name}", lp["self_attn"][name])
        _norm(sd, f"{key}.self_attn.layer_norm", lp["self_attn"]["layer_norm"])
        _conv(sd, f"{key}.pos_ffn.w_1", lp["pos_ffn"]["w_1"])
        _conv(sd, f"{key}.pos_ffn.w_2", lp["pos_ffn"]["w_2"])
        _norm(sd, f"{key}.pos_ffn.layer_norm", lp["pos_ffn"]["layer_norm"])
        i += 1


def _conv2d(sd, key, leaf):
    """An HWIO flax Conv kernel (no bias) -> an OIHW ``Conv2d`` weight."""
    sd[key + ".weight"] = _t(np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))


def _batch_norm(sd, key, leaf, stats):
    """A flax BatchNorm -> ``BatchNorm2d``: scale / bias, and with ``stats``
    the running buffers (stored-statistics mode)."""
    _norm(sd, key, leaf)
    if stats is not None:
        sd[key + ".running_mean"] = _t(stats["mean"])
        sd[key + ".running_var"] = _t(stats["var"])
        sd[key + ".num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _mlp(sd, prefix, tree):
    i = 0
    while f"affine_{i}" in tree:
        _dense(sd, f"{prefix}.affine_layers.{i}", tree[f"affine_{i}"])
        i += 1


def denoiser_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """{"params": {...}} of ``TransformerDiffusionModel`` -> state_dict."""
    p = params["params"]
    sd = {}
    _dense(sd, "time_mlp.1", p["time_mlp_1"])
    _dense(sd, "time_mlp.3", p["time_mlp_2"])
    _decoder(sd, "motion_transformer", p["motion_transformer"])
    _dense(sd, "linear_out", p["linear_out"])
    return sd


def headformer_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """{"params": {...}} of ``HeadFormer`` -> state_dict."""
    p = params["params"]
    sd = {}
    _decoder(sd, "action_transformer", p["action_transformer"])
    for head in ("va", "dist"):
        _mlp(sd, f"action_{head}_mlp", p[f"action_{head}_mlp"])
        _dense(sd, f"action_{head}_fc", p[f"action_{head}_fc"])
    return sd


def gravitynet_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """{"params": {...}} of ``HeadNormalFormer`` -> state_dict."""
    p = params["params"]
    sd = {}
    _decoder(sd, "action_transformer", p["action_transformer"])
    _mlp(sd, "action_normal_mlp", p["action_normal_mlp"])
    _dense(sd, "action_normal_fc", p["action_normal_fc"])
    return sd


def resnet18_state_dict_from_jax(variables, running_stats: bool = True) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of JAX's ``ResNet18`` -> ``models.resnet.
    ResNet18``'s state_dict: ``layer{s}_{b}`` -> ``layer{s}.{b}``,
    ``downsample_conv`` / ``downsample_bn`` -> ``downsample.0`` / ``.1``; the
    batch statistics become the running buffers when ``running_stats``."""
    p = variables["params"]
    stats = variables.get("batch_stats") if running_stats else None
    sd = {}

    def bn(key, *path):
        leaf, st = p, stats
        for k in path:
            leaf, st = leaf[k], None if st is None else st[k]
        _batch_norm(sd, key, leaf, st)

    _conv2d(sd, "conv1", p["conv1"])
    bn("bn1", "bn1")
    for stage in range(1, 5):
        for blk in range(2):
            name, key = f"layer{stage}_{blk}", f"layer{stage}.{blk}"
            for i in (1, 2):
                _conv2d(sd, f"{key}.conv{i}", p[name][f"conv{i}"])
                bn(f"{key}.bn{i}", name, f"bn{i}")
            if "downsample_conv" in p[name]:
                _conv2d(sd, f"{key}.downsample.0", p[name]["downsample_conv"])
                bn(f"{key}.downsample.1", name, "downsample_bn")
    _dense(sd, "fc", p["fc"])
    return sd


def headformer_cnn_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """{"params": {"cnn", "headformer"}} of ``HeadFormerWithCNN`` ->
    state_dict: the transformer's keys as ``HeadFormer``'s, the ResNet's
    (batch-statistics BatchNorm, no running buffers) under ``cnn.``. A CNN
    subtree that holds no arrays (optax's MaskedNode, where a frozen label
    keeps no moments) is left out."""
    p = params["params"]
    sd = headformer_state_dict_from_jax({"params": p["headformer"]})
    if hasattr(p["cnn"]["conv1"]["kernel"], "shape"):
        cnn = resnet18_state_dict_from_jax({"params": p["cnn"]}, running_stats=False)
        sd.update({"cnn." + k: v for k, v in cnn.items()})
    return sd


def pwcnet_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """JAX's PWC-Net params ({name: {"kernel", "bias"}}) -> ``models.pwcnet.
    PWCDCNet``'s state_dict (the reference's keys: ``conv1a.0.weight`` for a
    conv + LeakyReLU block, ``predict_flow6.weight`` for a bare one). HWIO ->
    OIHW; the transposed convolutions (``deconv*``, ``upfeat*``) keep their
    unflipped taps, (kh, kw, in, out) -> (in, out, kh, kw): JAX flips them
    when it applies them, ``ConvTranspose2d`` by definition."""
    from egoego_release_tpu_torch.models.pwcnet import is_transposed, state_key

    sd = {}
    for name, leaf in params.items():
        k = np.asarray(leaf["kernel"])
        sd[state_key(name) + ".weight"] = _t(k.transpose((2, 3, 0, 1) if is_transposed(name) else (3, 2, 0, 1)))
        sd[state_key(name) + ".bias"] = _t(leaf["bias"])
    return sd


def trainer_state_from_jax(state) -> dict:
    """A JAX ``TrainState`` (params, optax.adam state, EMA, step, nan_count)
    -> the checkpoint dict of the port's trainer (``DiffusionTrainer.
    state_from_dict`` takes it): params and EMA through
    ``denoiser_state_dict_from_jax`` under the reference's prefixes, the
    ScaleByAdamState's mu / nu / count as Adam's exp_avg / exp_avg_sq /
    step by parameter name."""
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    return {
        "step": int(np.asarray(state.step)),
        "model": {"denoise_fn." + k: v for k, v in denoiser_state_dict_from_jax(state.params).items()},
        "ema": {"ema_model.denoise_fn." + k: v
                for k, v in denoiser_state_dict_from_jax(state.ema_params).items()},
        "adam": {"step": int(np.asarray(adam.count)),
                 "exp_avg": denoiser_state_dict_from_jax(adam.mu),
                 "exp_avg_sq": denoiser_state_dict_from_jax(adam.nu)},
        "nan_count": int(np.asarray(state.nan_count)),
    }


def stage1_state_from_jax(state, kind: str) -> dict:
    """A JAX ``Stage1State`` (flax params, the optax state of
    ``chain(clip_by_global_norm, adamw)``, possibly under
    ``freeze_subtrees``' ``multi_transform``, epoch) of a ``kind`` model
    ("headnet", "headnet_cnn" or "gravitynet") -> {"model", "adam",
    "epoch"}: the params and the ScaleByAdamState's mu / nu / count as
    AdamW's exp_avg / exp_avg_sq / step by parameter name (a frozen
    subtree has none)."""
    to_sd = {"headnet": headformer_state_dict_from_jax, "headnet_cnn": headformer_cnn_state_dict_from_jax,
             "gravitynet": gravitynet_state_dict_from_jax}[kind]
    adam = _find_adam_state(state.opt_state)
    return {"model": to_sd(state.params),
            "adam": {"step": int(np.asarray(adam.count)), "exp_avg": to_sd(adam.mu), "exp_avg_sq": to_sd(adam.nu)},
            "epoch": int(np.asarray(state.epoch))}


def _find_adam_state(opt_state):
    """The ScaleByAdamState (the one with ``mu``) inside nested optax chain
    (tuple) and multi_transform (dict of labels) states."""
    if hasattr(opt_state, "mu"):
        return opt_state
    if isinstance(opt_state, (tuple, dict)):
        for s in (opt_state.values() if isinstance(opt_state, dict) else opt_state):
            found = _find_adam_state(s)
            if found is not None:
                return found
    return None


def strip_prefix(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def load_stage2_diffusion_ckpt(path: str, use_ema: bool = True):
    """stage2_diffusion_*.pt ({step, model, ema, ...}) -> (denoiser
    state_dict, step). The reference samples with the EMA weights, which
    ema-pytorch keeps under ``ema_model.``; the denoiser's keys carry the
    ``denoise_fn.`` prefix of CondGaussianDiffusion."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = {}
    if use_ema and "ema" in ckpt:
        sd = strip_prefix(ckpt["ema"], "ema_model.")
    if not sd:
        sd = ckpt["model"] if "model" in ckpt else ckpt
    sd = strip_prefix(sd, "denoise_fn.")
    if not sd:
        raise ValueError(f"{path}: no denoise_fn.* weights found")
    return sd, int(ckpt.get("step", 0))


def load_denoiser_weights(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """Load a denoiser (or stage-1 model) state_dict; the reference's frozen
    position table (recomputed here) is the only key the module may lack."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    unexpected = [k for k in unexpected if "position" not in k]
    if missing or unexpected:
        raise ValueError(f"weights: missing {missing}, unexpected {unexpected}")
    return model


def load_stage1_ckpt(path: str, kind: str, n_layers: int = 2, *, d_model: int = 256,
                     n_head: int = 4, d_k: int = 256, d_v: int = 256) -> dict:
    """stage1_headnet_*.pt / stage1_gravitynet_*.pt -> the state_dict of
    ``HeadFormer`` / ``HeadNormalFormer`` (kind "headnet_cnn":
    ``HeadFormerWithCNN``, its ResNet under ``cnn.``), from
    ``transformer_encoder_state_dict`` when the file has it. Refuses a
    checkpoint whose attention widths or decoder layer count differ from
    the target's (the release uses d_k = d_v = 256), and a "headnet_cnn"
    one without the CNN."""
    if kind not in ("headnet", "headnet_cnn", "gravitynet"):
        raise ValueError(f"kind must be headnet, headnet_cnn or gravitynet, got {kind!r}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("transformer_encoder_state_dict", ckpt)
    wq = sd["action_transformer.layer_stack.0.self_attn.w_q.weight"]
    wv = sd["action_transformer.layer_stack.0.self_attn.w_v.weight"]
    want_q, want_v = (n_head * d_k, d_model), (n_head * d_v, d_model)
    if tuple(wq.shape) != want_q or tuple(wv.shape) != want_v:
        raise ValueError(
            f"stage-1 checkpoint dims mismatch: w_q {tuple(wq.shape)} vs expected {want_q}, w_v "
            f"{tuple(wv.shape)} vs expected {want_v} (d_model={d_model}, n_head={n_head}, "
            f"d_k={d_k}, d_v={d_v}); the release config uses d_k=d_v=256")
    found = 0
    while f"action_transformer.layer_stack.{found}.self_attn.w_q.weight" in sd:
        found += 1
    if found != n_layers:
        raise ValueError(f"decoder layer-count mismatch: checkpoint has {found} layers, "
                         f"target module expects {n_layers}")
    if kind == "headnet_cnn" and "cnn.conv1.weight" not in sd:
        raise ValueError(f"{path}: no cnn.* weights (a HeadFormer checkpoint, not HeadFormerWithCNN's)")
    return {k: v.float() for k, v in sd.items() if torch.is_tensor(v)}
