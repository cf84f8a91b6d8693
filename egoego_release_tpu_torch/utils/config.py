"""The typed config tree of the training CLIs (port of
egoego_release_tpu/utils/config.py without ``KinpolyConfig``, which waits
for the kinematic baselines).

Frozen dataclasses built from a YAML file or a dict plus dotted
``a.b=c`` overrides; ``save_yaml`` writes the run's settings as the
reference's opt.yaml. The field names and defaults are the JAX package's,
so one YAML configures either package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass


@dataclass(frozen=True)
class DataConfig:
    data_root_folder: str = "data"
    stats_path: str = ""
    smplh_path: str = ""
    rest_offsets: str = ""
    window: int = 120
    canonicalize_init_head: bool = True
    batch_size: int = 32
    prefetch: int = 2  # background-prefetch queue depth (0 = synchronous)
    # the whole window set lives in device memory and each step gathers its
    # batch there (DiffusionTrainer._train_step_device); false = the host
    # iterator, with `prefetch` batches copied ahead by a thread
    device_resident: bool = True


@dataclass(frozen=True)
class Stage1ModelConfig:
    # release dims: trainer_head_estimation.py:259-260 and
    # eval_egoego.py:644-645,662-663 all use d_k=d_v=256
    d_model: int = 256
    n_dec_layers: int = 2
    n_head: int = 4
    d_k: int = 256
    d_v: int = 256
    window: int = 60
    dist_scale: float = 10.0
    w_rotation: float = 1.0
    w_va: float = 1.0
    w_dist: float = 1.0
    input_of_feats: bool = True


@dataclass(frozen=True)
class Stage2ModelConfig:
    d_model: int = 512
    n_dec_layers: int = 4
    n_head: int = 4
    d_k: int = 256
    d_v: int = 256
    window: int = 120
    timesteps: int = 1000
    objective: str = "pred_x0"
    beta_schedule: str = "cosine"
    loss_type: str = "l1"
    remat: bool = False   # per-layer torch.utils.checkpoint (large micro-batches)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    num_steps: int = 8_000_000
    grad_accum: int = 2
    ema_decay: float = 0.995
    ema_update_every: int = 10
    ema_step_start: int = 2000
    save_every: int = 200_000
    lr_step_size: int = 1000     # stage-1 StepLR step (epochs)
    lr_gamma: float = 0.3
    seed: int = 0
    resume: bool = True          # auto-resume from the newest weights ckpt


@dataclass(frozen=True)
class ParallelConfig:
    dp: int = 0  # above 1 (or tp above 1): train_diffusion on dp x tp ranks; 0 = the cards / tp
    tp: int = 1


@dataclass(frozen=True)
class LoggingConfig:
    save_dir: str = "./results"
    exp_name: str = "exp"
    use_wandb: bool = False
    wandb_project: str = "egoego_tpu"
    log_every: int = 100
    profile_dir: str = ""  # set to write a torch.profiler Chrome trace there


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    headnet: Stage1ModelConfig = field(default_factory=Stage1ModelConfig)
    gravitynet: Stage1ModelConfig = field(
        default_factory=lambda: Stage1ModelConfig(window=120)
    )
    stage2: Stage2ModelConfig = field(default_factory=Stage2ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        if is_dataclass(default.__class__) and isinstance(v, dict):
            kwargs[f.name] = _from_dict(default.__class__, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def _literal(val: str):
    """An override's value: int, then float, then true/false, else the string."""
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            continue
    return {"true": True, "True": True, "false": False, "False": False}.get(val, val)


def load_config(path_or_dict: str | dict | None = None, overrides: list[str] | None = None) -> ExperimentConfig:
    """Build a config from a YAML file or a dict plus 'a.b=c' overrides."""
    d: dict = {}
    if isinstance(path_or_dict, str):
        import yaml

        with open(path_or_dict) as f:
            d = yaml.safe_load(f) or {}
    elif isinstance(path_or_dict, dict):
        d = dict(path_or_dict)

    for ov in overrides or []:
        key, _, val = ov.partition("=")
        node = d
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _literal(val)
    return _from_dict(ExperimentConfig, d)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_yaml(cfg, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
