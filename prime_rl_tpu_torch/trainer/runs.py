"""Multi-tenant LoRA runs: many concurrent adapters trained on one learner
(the port of the JAX package's ``trainer/runs.py``).

Every tenant shares the one train step (the adapter trees have identical
shapes), so switching tenants is passing another adapter state: no per-run
module surgery. Each run owns its adapter ``TrainState``, its progress and its
checkpoint and weight directories under ``{output_dir}/runs/{run_id}/``.
A tenant's state is saved as its tensors in one safetensors file (in the
order a walk of a freshly made state visits them) and its scalars (progress,
the optimizer's step counters) in a JSON file beside it.
"""

from __future__ import annotations

import json
import shutil
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import torch

from prime_rl_tpu_torch.trainer.ckpt import Progress
from prime_rl_tpu_torch.trainer.step import TrainState, init_lora_train_state
from prime_rl_tpu_torch.utils.logger import get_logger

_META = "adapter_state.msgpack.json"
_TENSORS = "adapter_state.safetensors"


@dataclass
class Run:
    run_id: str
    state: TrainState
    progress: Progress = field(default_factory=Progress)

    @property
    def dirty(self) -> bool:
        return self.progress.step > 0


def _walk(obj, tensors: list, scalars: list):
    """Collect the state's tensors and its int/float scalars, depth first,
    dicts in the order of their sorted keys (which a fresh state repeats)."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _walk(obj[k], tensors, scalars)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _walk(v, tensors, scalars)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        scalars.append(obj)


def _rebuild(obj, tensors, scalars):
    """``obj`` with its tensors and scalars replaced from the iterators, in
    ``_walk``'s order; tensors are copied onto the device and dtype of the
    ones they replace."""
    if isinstance(obj, torch.Tensor):
        return next(tensors).to(device=obj.device, dtype=obj.dtype)
    if isinstance(obj, dict):
        return {k: _rebuild(obj[k], tensors, scalars) for k in sorted(obj)}
    if isinstance(obj, TrainState):
        return TrainState(*(_rebuild(v, tensors, scalars) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(v, tensors, scalars) for v in obj)
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return type(obj)(next(scalars))
    return obj


class MultiRunManager:
    """Owns per-tenant adapter states: discovery, creation, LRU eviction and
    per-run checkpoints and weight snapshots."""

    def __init__(self, output_dir: str | Path, spec, lora_cfg, device, optimizer,
                 max_runs: int = 8, seed: int = 0):
        self.output_dir = Path(output_dir)
        self.spec = spec
        self.lora_cfg = lora_cfg
        self.device = torch.device(device)
        self.optimizer = optimizer
        self.max_runs = max_runs
        self.seed = seed
        self.runs: dict[str, Run] = {}
        (self.output_dir / "runs").mkdir(parents=True, exist_ok=True)

    # -- discovery / lifecycle ----------------------------------------------

    def discover(self) -> list[str]:
        """The run ids present on disk."""
        return sorted(d.name for d in (self.output_dir / "runs").iterdir()
                      if d.is_dir() and not d.name.startswith("."))

    def run_dir(self, run_id: str) -> Path:
        return self.output_dir / "runs" / run_id

    def run_seed(self, run_id: str) -> int:
        """The tenant's init seed: ``seed`` plus a hash of its id that is the
        same in every process (the JAX package uses Python's ``hash``, which
        is salted per process)."""
        return self.seed + zlib.crc32(run_id.encode()) % 10_000

    def get_or_create(self, run_id: str) -> Run:
        run = self.runs.get(run_id)
        if run is not None:
            return run
        if len(self.runs) >= self.max_runs:
            self._evict_lru()
        state = init_lora_train_state(self.spec, self.lora_cfg, self.device, self.optimizer,
                                      seed=self.run_seed(run_id))
        run = Run(run_id, state)
        if (self.run_dir(run_id) / _META).exists():
            self._load(run)
        self.run_dir(run_id).mkdir(parents=True, exist_ok=True)
        self.runs[run_id] = run
        get_logger().info(f"multi-run: loaded tenant '{run_id}' "
                          f"(step {run.progress.step}, {len(self.runs)}/{self.max_runs} live)")
        return run

    def evict(self, run_id: str, save: bool = True) -> None:
        run = self.runs.pop(run_id, None)
        if run is not None and save:
            self.save(run)

    def delete(self, run_id: str) -> None:
        """Remove a tenant, its state and its directory."""
        self.runs.pop(run_id, None)
        shutil.rmtree(self.run_dir(run_id), ignore_errors=True)

    def _evict_lru(self) -> None:
        oldest = min(self.runs.values(), key=lambda r: r.progress.step)
        get_logger().info(f"multi-run: evicting '{oldest.run_id}' (slots full)")
        self.evict(oldest.run_id)

    # -- per-run persistence -------------------------------------------------

    def save(self, run: Run) -> None:
        from safetensors.torch import save_file

        d = self.run_dir(run.run_id)
        d.mkdir(parents=True, exist_ok=True)
        tensors, scalars = [], []
        _walk(tuple(run.state), tensors, scalars)
        save_file({f"leaf_{i}": t.detach().cpu().contiguous() for i, t in enumerate(tensors)},
                  str(d / _TENSORS))
        (d / _META).write_text(json.dumps({
            "progress": vars(run.progress), "num_leaves": len(tensors), "scalars": scalars,
        }))

    def _load(self, run: Run) -> None:
        from safetensors.torch import load_file

        d = self.run_dir(run.run_id)
        meta = json.loads((d / _META).read_text())
        run.progress = Progress(**meta["progress"])
        if (d / _TENSORS).exists():
            loaded = load_file(str(d / _TENSORS))
            tensors = iter(loaded[f"leaf_{i}"] for i in range(meta["num_leaves"]))
            run.state = _rebuild(run.state, tensors, iter(meta["scalars"]))

    def save_all(self) -> None:
        for run in self.runs.values():
            if run.dirty:
                self.save(run)

    # -- serving snapshots ---------------------------------------------------

    def publish(self, run: Run, base_params, version: int) -> Path:
        """The tenant's merged weights under ``runs/<id>/weights/step_N``
        (the filesystem surface of that tenant's sampler), plus the
        standalone PEFT adapter under ``.../adapter/``, so that a shared
        engine serves this tenant through ``/load_lora_adapter`` without a
        swap. The adapter is written first: the snapshot's STABLE marker
        gates the tenant watcher's load."""
        from prime_rl_tpu_torch.models.lora import merge_lora, save_adapter
        from prime_rl_tpu_torch.trainer.weights import save_hf_weights

        path = self.run_dir(run.run_id) / "weights" / f"step_{version}"
        save_adapter(run.state.params, self.spec, path / "adapter")
        merged = merge_lora(base_params, run.state.params, self.lora_cfg, spec=self.spec)
        save_hf_weights(merged, self.spec, path)
        return path
