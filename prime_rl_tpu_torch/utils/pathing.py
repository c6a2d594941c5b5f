"""Run-directory conventions shared by all processes
(reference: utils/pathing.py:1-207).

Layout under ``output_dir``:
    checkpoints/step_{N}/trainer/     sharded learner state (orbax)
    checkpoints/step_{N}/orchestrator/ orchestrator progress + source state
    weights/step_{N}/                 HF-format serving snapshots
    broadcasts/step_{N}/              weight-broadcast staging + STABLE marker
    rollouts/step_{N}/                filesystem transport batches
    logs/                             per-process logs
STABLE markers gate cross-process visibility of partially-written dirs.
"""

from __future__ import annotations

import time
from pathlib import Path

STABLE_MARKER = "STABLE"


def ckpt_dir(output_dir: str | Path, step: int) -> Path:
    return Path(output_dir) / "checkpoints" / f"step_{step}"


def trainer_ckpt_dir(output_dir: str | Path, step: int) -> Path:
    return ckpt_dir(output_dir, step) / "trainer"


def orch_ckpt_dir(output_dir: str | Path, step: int) -> Path:
    return ckpt_dir(output_dir, step) / "orchestrator"


def weights_dir(output_dir: str | Path, step: int) -> Path:
    return Path(output_dir) / "weights" / f"step_{step}"


def broadcast_dir(output_dir: str | Path, step: int) -> Path:
    return Path(output_dir) / "broadcasts" / f"step_{step}"


def rollout_dir(output_dir: str | Path, step: int) -> Path:
    return Path(output_dir) / "rollouts" / f"step_{step}"


def logs_dir(output_dir: str | Path) -> Path:
    return Path(output_dir) / "logs"


def mark_stable(path: str | Path) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)
    (Path(path) / STABLE_MARKER).touch()


def is_stable(path: str | Path) -> bool:
    return (Path(path) / STABLE_MARKER).exists()


def wait_for_path(path: str | Path, timeout: float = 600.0, poll: float = 0.2) -> bool:
    """Poll for a path to exist; returns False on timeout."""
    deadline = time.monotonic() + timeout
    p = Path(path)
    while time.monotonic() < deadline:
        if p.exists():
            return True
        time.sleep(poll)
    return p.exists()


def list_step_dirs(parent: str | Path, stable_only: bool = True) -> list[int]:
    """Sorted step numbers with (optionally) STABLE dirs under parent."""
    parent = Path(parent)
    if not parent.exists():
        return []
    steps = []
    for d in parent.iterdir():
        if d.is_dir() and d.name.startswith("step_"):
            try:
                step = int(d.name.removeprefix("step_"))
            except ValueError:
                continue
            if not stable_only or is_stable(d):
                steps.append(step)
    return sorted(steps)


def latest_step(parent: str | Path, stable_only: bool = True) -> int | None:
    steps = list_step_dirs(parent, stable_only)
    return steps[-1] if steps else None
