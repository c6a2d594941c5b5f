"""Weight-broadcast sinks: how a new policy reaches the sampler pool (the
port of the JAX package's ``trainer/rl/broadcast.py``).

- ``FilesystemBroadcast`` writes an HF snapshot per step + STABLE marker,
  which the orchestrator's watcher applies to remote engines through
  ``/update_weights``.
- ``ColocatedBroadcast``: learner and sampler share one process and one
  card; the update hands the trainer's parameter tensors to the live engine
  between its steps (pause, swap, resume). Nothing leaves the card.

The disaggregated device planes (``shm``, ``zmq_stream``, ``dcn_pull``) raise
until the multi-card slice (ROADMAP.md, Queue 1 item 11).
"""

from __future__ import annotations

import time
from typing import Protocol

from prime_rl_tpu_torch.utils.logger import get_logger

Params = dict


class WeightBroadcastSink(Protocol):
    def publish(self, params: Params, version: int) -> None: ...


class FilesystemBroadcast:
    def __init__(self, weight_mgr):
        self.weight_mgr = weight_mgr

    def publish(self, params: Params, version: int) -> None:
        self.weight_mgr.save(params, version)


class ColocatedBroadcast:
    """Swap the live engine's params; version-atomic through pause.

    The engine serves the trainer's tensors themselves where they are already
    on its device in its compute dtype (bf16 masters): the train step is
    functional, so a later step makes new tensors and never writes the ones
    the engine holds. Masters in the host tier (``host_masters``, the
    trainer's ``offload_params``: buffers that the next step writes in
    place) reach the engine as copies made on its device in its compute
    dtype, a leaf at a time; it never holds a host tensor. The orchestrator
    sees the bumped version over ``/liveness`` as soon as the swap is in."""

    def __init__(self, engine, host_masters: bool = False):
        self.engine = engine
        self.host_masters = host_masters

    def publish(self, params: Params, version: int) -> None:
        t0 = time.perf_counter()
        if self.host_masters:
            params = device_copy(params, self.engine.device, self.engine.compute_dtype)
        self.engine.pause()
        try:
            self.engine.update_params(params, version=version)
        finally:
            self.engine.resume()
        wait_s, swap_s = self.engine.last_swap_s
        get_logger().info(f"colocated swap: the engine serves v{self.engine.policy_version} "
                          f"({(time.perf_counter() - t0) * 1e3:.1f} ms: {wait_s * 1e3:.1f} ms "
                          f"waiting for the engine's step in flight, {swap_s * 1e3:.1f} ms "
                          "draining its blocks and swapping)")


def device_copy(params: Params, device, dtype) -> Params:
    """A copy of ``params`` on ``device``, floating tensors in ``dtype``."""
    if isinstance(params, dict):
        return {k: device_copy(v, device, dtype) for k, v in params.items()}
    return params.to(device=device, dtype=dtype if params.is_floating_point() else params.dtype,
                     copy=True)


def make_broadcast(config, weight_mgr, output_dir: str):
    """Build the configured sink (the trainer entry point's path; the
    colocated entry point hands ``train`` a ``ColocatedBroadcast`` itself)."""
    if config.type == "device":
        if config.mode == "colocated":
            raise ValueError("broadcast mode 'colocated' needs the colocated entry point "
                             "(entrypoints.colocated, or entrypoints.rl with colocated = true)")
        raise NotImplementedError(
            f"the {config.mode!r} weight plane is not ported yet (ROADMAP.md, Queue 1 item "
            "11); use broadcast.type = 'filesystem' or the colocated entry point")
    return FilesystemBroadcast(weight_mgr)
