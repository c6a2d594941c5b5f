"""Trace → TrainingSample conversion (reference: orchestrator/
trajectories.py:1-135). One sample per trace branch; fork dedup: if two
traces share a sampled prefix (branching rollouts), the shared sampled span
trains only once — later branches mask it out (reference: l.69-89)."""

from __future__ import annotations

import numpy as np

from prime_rl_tpu_torch.envs.types import Episode, Trace
from prime_rl_tpu_torch.transport.types import TrainingSample


def trace_to_sample(trace: Trace, env_name: str) -> TrainingSample:
    routed = None
    if trace.routed_experts is not None:
        # [L, NL, K] int32; -1 rows where no routing was recorded (context
        # tokens / the last sampled token) -> trainer uses its own routing
        shape = next((np.asarray(r).shape for r in trace.routed_experts
                      if r is not None), None)
        if shape is not None:
            routed = np.full((len(trace.token_ids), *shape), -1, np.int32)
            for i, r in enumerate(trace.routed_experts):
                if r is not None:
                    routed[i] = np.asarray(r, np.int32)
    mm = None
    if trace.mm_kwargs:
        mm = {k: np.asarray(v) for k, v in trace.mm_kwargs.items()}
    return TrainingSample(
        token_ids=np.asarray(trace.token_ids, np.int32),
        mask=np.asarray(trace.sampled_mask, bool),
        logprobs=np.asarray(trace.logprobs, np.float32),
        temperatures=np.asarray(trace.temperatures, np.float32),
        env_name=env_name,
        routed_experts=routed,
        mm_kwargs=mm,
    )


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = a[:n] != b[:n]
    return int(np.argmax(neq)) if neq.any() else n


def episode_to_samples(episode: Episode, env_name: str) -> list[TrainingSample]:
    """All trainable branches, with fork-node dedup: traces are root-to-leaf
    paths of the branching tree, so any node shared between two branches is
    exactly their flat-stream common prefix — each new branch masks out its
    LONGEST common prefix with every earlier branch, so every sampled node
    trains once no matter where the fork happened
    (reference: trajectories.py:69-89 message-graph node dedup)."""
    samples = []
    seen: list[np.ndarray] = []
    for trace in episode.traces:
        sample = trace_to_sample(trace, env_name)
        ids = np.asarray(trace.token_ids, np.int64)
        shared = 0
        for prev in seen:
            shared = max(shared, _common_prefix_len(prev, ids))
        if shared:
            sample.mask[:shared] = False
        seen.append(ids)
        samples.append(sample)
    return samples
