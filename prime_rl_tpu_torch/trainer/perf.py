"""Throughput/MFU accounting (the port of the JAX package's
``trainer/perf.py``).

FLOPs/token comes from the model spec; the peak is the card's published dense
bf16 tensor-core rate, looked up from the card's name. An unknown card raises
rather than guess; the CPU keeps a nominal 1e12 so MFU stays finite in tests.
"""

from __future__ import annotations

import time

import torch

# dense bf16 tensor-core FLOP/s per card (NVIDIA's data sheets), most specific
# name first
_PEAK_FLOPS = {
    "h100 pcie": 756e12,
    "h100 nvl": 835e12,
    "h100": 989e12,  # SXM
    "h200": 989e12,
}
_CPU_NOMINAL = 1e12


def device_peak_flops(device: torch.device | str | None = None) -> float:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cpu":
        return _CPU_NOMINAL
    kind = torch.cuda.get_device_name(device).lower()
    for key, flops in _PEAK_FLOPS.items():
        if key in kind:
            return flops
    raise ValueError(f"no published peak for device {kind!r}: add it to _PEAK_FLOPS")


class PerfCounter:
    """Rolling tokens/s + MFU over a window of recorded steps."""

    def __init__(self, flops_per_token: float, n_devices: int = 1, window: int = 32,
                 device: torch.device | str | None = None):
        self.flops_per_token = flops_per_token
        self.n_devices = n_devices
        self.window = window
        self.device = device
        self.samples: list[tuple[float, int]] = []  # (duration_s, tokens)

    def record(self, duration_s: float, tokens: int) -> None:
        self.samples.append((duration_s, tokens))
        if len(self.samples) > self.window:
            self.samples.pop(0)

    @property
    def tokens_per_sec(self) -> float:
        total_t = sum(d for d, _ in self.samples)
        total_tok = sum(n for _, n in self.samples)
        return total_tok / total_t if total_t else 0.0

    def mfu(self, peak_flops: float | None = None) -> float:
        peak = (peak_flops or device_peak_flops(self.device)) * self.n_devices
        return self.tokens_per_sec * self.flops_per_token / peak


class StepTimer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self.start
