"""Train/eval example sources (reference: orchestrator/train_source.py:21-130,
eval_source.py:47-86): weighted round-robin across env sources with
epoch-seeded shuffles and checkpointable ``{epoch, cursor}`` state."""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any


@dataclass
class SourceState:
    epoch: int = 0
    cursor: int = 0
    rng_state: Any = None


class TrainSource:
    """Deterministic, resumable example stream over multiple env tasksets."""

    def __init__(self, env_names: list[str], tasksets: dict[str, list[dict]],
                 ratios: dict[str, float], seed: int = 0):
        self.env_names = env_names
        self.tasksets = tasksets
        self.seed = seed
        total = sum(ratios.values()) or 1.0
        self.weights = [ratios.get(n, 1.0) / total for n in env_names]
        self.rng = random.Random(seed)
        self.states = {n: SourceState() for n in env_names}
        self._orders: dict[str, list[int]] = {}
        for n in env_names:
            self._reshuffle(n)

    def _reshuffle(self, env: str) -> None:
        import zlib

        st = self.states[env]
        order = list(range(len(self.tasksets[env])))
        # stable cross-process seed (str hash() is salted per process)
        epoch_seed = zlib.crc32(f"{self.seed}:{env}:{st.epoch}".encode())
        random.Random(epoch_seed).shuffle(order)
        self._orders[env] = order

    def next_example(self) -> tuple[str, dict]:
        env = self.rng.choices(self.env_names, weights=self.weights)[0]
        st = self.states[env]
        order = self._orders[env]
        if st.cursor >= len(order):
            st.epoch += 1
            st.cursor = 0
            self._reshuffle(env)
            order = self._orders[env]
        task = self.tasksets[env][order[st.cursor]]
        st.cursor += 1
        return env, task

    def state_dict(self) -> dict:
        return {
            "rng": self.rng.getstate(),
            "states": {n: {"epoch": s.epoch, "cursor": s.cursor} for n, s in self.states.items()},
        }

    def load_state_dict(self, d: dict) -> None:
        self.rng.setstate(tuple(
            tuple(x) if isinstance(x, list) else x for x in d["rng"]
        ))
        for n, s in d["states"].items():
            if n in self.states:
                self.states[n].epoch = s["epoch"]
                self.states[n].cursor = s["cursor"]
                self._reshuffle(n)
