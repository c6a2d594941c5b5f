"""The host tier of the long-context memory levers: tensors parked in pinned
host memory and brought back, the copies on side streams so that they run
under the card's work.

On the card a host-tier tensor is a pinned CPU tensor (``to_host`` raises if
it cannot be pinned: nothing stays on the card behind the caller's back). On
the CPU the host tier is the same device: the same copies run as CPU copies,
unpinned, so that the code paths the card runs are the ones the CPU tests
hold.

- ``to_host``: a host copy made now (the train state's offloaded leaves).
- ``stash`` / ``Stashed.fetch`` / ``Stashed.prefetch``: a device tensor
  copied to the host on a side stream (device-to-host), and back, waited on
  by the stream that uses it (the remat modes' activations).
"""

from __future__ import annotations

import torch

_streams: dict[tuple[torch.device, str], torch.cuda.Stream] = {}


def side_stream(device: torch.device, role: str) -> torch.cuda.Stream:
    """One CUDA stream a device and role (``d2h``, ``h2d``), made on first use."""
    key = (device, role)
    s = _streams.get(key)
    if s is None:
        s = _streams[key] = torch.cuda.Stream(device)
    return s


def pinned_empty(shape, dtype) -> torch.Tensor:
    """An empty pinned CPU tensor; raises where it cannot be pinned."""
    t = torch.empty(shape, dtype=dtype, pin_memory=True)
    if not t.is_pinned():
        raise RuntimeError(f"could not pin a host tensor of {tuple(shape)} {dtype}")
    return t


def to_host(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` in the host tier of ``device``: pinned CPU memory for a
    CUDA ``device`` (synchronous), a CPU copy otherwise."""
    if device.type == "cuda":
        host = pinned_empty(t.shape, t.dtype)
        host.copy_(t)
        return host
    return t.detach().to("cpu", copy=True)


class Stashed:
    """A tensor parked in the host tier by ``stash``: ``host`` and the event
    its device-to-host copy records (None on the CPU)."""

    __slots__ = ("host", "copied", "device", "ahead", "ready")

    def __init__(self, host: torch.Tensor, copied, device: torch.device):
        self.host, self.copied, self.device = host, copied, device
        self.ahead = self.ready = None  # a prefetched device copy and its event

    def prefetch(self) -> None:
        """Start the copy back to the device on the ``h2d`` side stream
        (nothing on the CPU, or when already started)."""
        if self.device.type != "cuda" or self.ahead is not None:
            return
        s = side_stream(self.device, "h2d")
        with torch.cuda.stream(s):
            s.wait_event(self.copied)
            self.ahead = self.host.to(self.device, non_blocking=True)
            self.ready = torch.cuda.Event()
            self.ready.record(s)

    def fetch(self) -> torch.Tensor:
        """The tensor on its device again, safe to use on the current stream:
        the prefetched copy, or one made now after the device-to-host copy has
        landed (on the CPU a copy of the host tensor)."""
        if self.device.type != "cuda":
            return self.host.clone()
        cur = torch.cuda.current_stream(self.device)
        if self.ahead is None:
            cur.wait_event(self.copied)
            return self.host.to(self.device, non_blocking=True)
        out, self.ahead = self.ahead, None
        cur.wait_event(self.ready)
        out.record_stream(cur)  # made on the side stream, used and freed on this one
        return out


def stash(t: torch.Tensor) -> Stashed:
    """``t`` copied into the host tier on the ``d2h`` side stream, which first
    waits for the work that made ``t``; ``t`` is recorded on that stream, so
    that the allocator does not hand its memory out while the copy reads it.
    On the CPU: a copy."""
    t = t.detach()
    if not t.is_cuda:
        return Stashed(t.clone(), None, t.device)
    s = side_stream(t.device, "d2h")
    s.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(s):
        host = pinned_empty(t.shape, t.dtype)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(s)
    t.record_stream(s)
    return Stashed(host, done, t.device)
