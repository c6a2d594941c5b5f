"""Weight-broadcast sinks: how a new policy reaches the sampler pool (the
port of the JAX package's ``trainer/rl/broadcast.py``).

``FilesystemBroadcast`` writes an HF snapshot per step + STABLE marker, which
the orchestrator's watcher applies to remote engines. The in-process swap
(``ColocatedBroadcast``) and the shm / zmq_stream / dcn_pull planes wait for
the loop slice: ``make_broadcast`` raises for them.
"""

from __future__ import annotations

from typing import Protocol

Params = dict


class WeightBroadcastSink(Protocol):
    def publish(self, params: Params, version: int) -> None: ...


class FilesystemBroadcast:
    def __init__(self, weight_mgr):
        self.weight_mgr = weight_mgr

    def publish(self, params: Params, version: int) -> None:
        self.weight_mgr.save(params, version)


def make_broadcast(config, weight_mgr, output_dir: str):
    """Build the configured sink."""
    if config.type == "device":
        raise NotImplementedError(
            f"the {config.mode!r} weight plane waits for the loop slice (colocated trainer + "
            "sampler); use broadcast.type = 'filesystem'")
    return FilesystemBroadcast(weight_mgr)
