"""Learner checkpointing: train state + retention + progress (the port of
the JAX package's ``trainer/ckpt.py``): the same per-step directories with
STABLE markers, ``keep_last``/``keep_interval`` retention, resume by step or
latest. The state is one ``torch.save`` file, ``state.pt``, holding the
params, the optimizer state and the step, all moved to the host.
"""

from __future__ import annotations

import json
import shutil
from dataclasses import asdict, dataclass
from pathlib import Path

import torch

from prime_rl_tpu_torch.configs.shared import CheckpointConfig
from prime_rl_tpu_torch.trainer.step import TrainState
from prime_rl_tpu_torch.utils import pathing


@dataclass
class Progress:
    """Scalar training progress saved alongside the state."""

    step: int = 0
    total_tokens: int = 0
    total_samples: int = 0


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


class CheckpointManager:
    """Save/load TrainState + Progress under
    ``{output_dir}/checkpoints/step_{N}/trainer``."""

    def __init__(self, output_dir: str | Path, config: CheckpointConfig):
        self.output_dir = Path(output_dir)
        self.config = config

    def _dir(self, step: int) -> Path:
        return pathing.trainer_ckpt_dir(self.output_dir, step)

    def save(self, state: TrainState, progress: Progress) -> Path:
        step = progress.step
        path = self._dir(step)
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True, exist_ok=True)
        host = _map_tensors({"params": state.params, "opt_state": state.opt_state},
                            lambda t: t.detach().cpu())
        torch.save({**host, "step": int(state.step)}, path / "state.pt")
        (path / "progress.json").write_text(json.dumps(asdict(progress)))
        pathing.mark_stable(pathing.ckpt_dir(self.output_dir, step))
        self._retain()
        return path

    def load(self, like: TrainState, step: int | None = None) -> tuple[TrainState, Progress]:
        """``like``: a live TrainState whose device the restored tensors move
        to. ``step=None``/-1 = latest."""
        if step is None or step == -1:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.output_dir}")
        path = self._dir(step)
        device = next(iter(like.params.values())).device
        saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
        moved = _map_tensors(saved, lambda t: t.to(device))
        state = TrainState(params=moved["params"], opt_state=moved["opt_state"],
                           step=int(moved["step"]))
        progress = Progress(**json.loads((path / "progress.json").read_text()))
        return state, progress

    def latest_step(self) -> int | None:
        return pathing.latest_step(self.output_dir / "checkpoints")

    def _retain(self) -> None:
        keep_last, keep_interval = self.config.keep_last, self.config.keep_interval
        if keep_last is None:
            return
        steps = pathing.list_step_dirs(self.output_dir / "checkpoints", stable_only=False)
        protected = set(steps[-keep_last:]) if keep_last else set()
        if keep_interval:
            protected |= {s for s in steps if s % keep_interval == 0}
        for s in steps:
            if s not in protected:
                shutil.rmtree(pathing.ckpt_dir(self.output_dir, s), ignore_errors=True)
