"""Metric logging and profiling of the training CLIs (port of
egoego_release_tpu/utils/logging.py).

  * MetricLogger: a JSONL file and stdout; wandb only when asked
  * profile_trace: a torch.profiler Chrome trace of the block it wraps,
    and the program's spans (utils/trace.py) in it by name
  * save_run_config: the run's settings as opt.yaml beside its results
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class MetricLogger:
    def __init__(self, save_dir: str, use_wandb: bool = False,
                 wandb_project: str = "egoego_tpu", exp_name: str = "exp",
                 config: dict | None = None):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self.wandb = None
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(project=wandb_project, name=exp_name, config=config or {})
            except Exception as e:  # wandb not installed, or offline
                print(f"wandb unavailable ({e}); logging to JSONL only")

    def log(self, step: int, **metrics) -> None:
        rec = {"step": step, "wall_time": time.time() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self.wandb is not None:
            self.wandb.finish()


@contextlib.contextmanager
def profile_trace(profile_dir: str | None):
    """A torch.profiler trace of the CPU and, where there is one, the card,
    written as ``{profile_dir}/trace.json`` (open it in Perfetto or
    chrome://tracing), in which the eval driver's and the sampler's spans
    are named ranges; and ``{profile_dir}/spans.json``: for each span name
    of the program (``utils/trace.py``, on while the profiler records) the
    count, total ms and self ms (less its child spans) of its spans in the
    block. Nothing when ``profile_dir`` is unset."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from egoego_release_tpu_torch.utils import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(profile_dir, exist_ok=True)
    since = time.time_ns()
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    with open(os.path.join(profile_dir, "spans.json"), "w") as f:
        json.dump(trace.summary(since), f, indent=1)


def save_run_config(cfg, save_dir: str) -> str:
    """Dump the run config next to the results (reference: opt.yaml)."""
    from egoego_release_tpu_torch.utils.config import save_yaml

    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "opt.yaml")
    save_yaml(cfg, path)
    return path
