#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's engine spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_decode_profile.py [--model qwen3|gpt-oss] [--windows N]

Builds the engine for Qwen3-0.6B (28 layers, full vocabulary, random weights
from seed 0, bf16; ``--model gpt-oss``: openai/gpt-oss-20b, 24 layers, all 32
experts, windows of 128 on every other layer, sinks), fills all 64 decode
slots with prompts of 500 to 1000 random tokens (unfiltered sampling at
temperature 1, the RL rollout setting), lets the engine admit them and run, then measures decode blocks
(8 steps each): host-clock time per step over N unprofiled windows of 48
steps (default 5; their median and spread: one window does not resolve the
host clock), and under ``torch.profiler`` one more window's device time per
kernel name and the device's idle share.
Prints a table, then one JSON line with the numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SLOTS, BLOCKS, SEED = 64, 6, 0
MODELS = {"qwen3": "Qwen/Qwen3-0.6B", "gpt-oss": "openai/gpt-oss-20b"}


def main() -> int:
    import numpy as np
    import torch

    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.sampler.cache import CacheConfig
    from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="qwen3", choices=sorted(MODELS))
    ap.add_argument("--windows", type=int, default=5,
                    help="unprofiled windows of 48 steps on the host clock")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    _build.build()
    spec = get_spec(MODELS[args.model])
    dev = torch.device("cuda")
    params = get_family(spec).init(spec, torch.Generator(device=dev).manual_seed(SEED),
                                   dtype=torch.bfloat16, device=dev)
    engine = Engine(params, spec, CacheConfig(num_pages=SLOTS * 64 + 64, page_size=64,
                                              max_slots=SLOTS, max_seq_len=4096),
                    device="cuda", seed=SEED)
    rng = np.random.default_rng(SEED)
    sp = SamplingParams(max_tokens=2000, temperature=1.0, ignore_eos=True)
    for n in rng.integers(500, 1001, SLOTS):
        engine.submit(rng.integers(0, spec.vocab_size, int(n)).tolist(), sp)
    while engine.pending:  # admit every prompt
        engine.step()
    for _ in range(4):  # steady state: every slot decoding
        engine.step()
    engine._drain(force=True)
    context = float(engine._shadow_lengths[:SLOTS].mean())

    def window():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(BLOCKS):
            engine._dispatch_decode()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        engine._drain(force=True)
        return wall

    steps = BLOCKS * engine.decode_block
    walls = sorted(window() for _ in range(max(args.windows, 1)))
    wall = walls[len(walls) // 2]  # the median window
    _build.reset_launches()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_prof = window()
    # device-side events only (kernels, copies): the aten ops that launched
    # them carry the same device time and would count it twice
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"{'kernel':70s} {'device ms':>10s} {'share':>7s} {'calls':>6s}")
    for name, ms, count in rows[:25]:
        print(f"{name[:70]:70s} {ms:10.3f} {ms / busy_ms:7.1%} {count:6d}")
    launches = dict(_build.launches)
    result = {
        "card": card, "model": MODELS[args.model], "slots": SLOTS,
        "mean_context_tokens": context, "steps": steps,
        "ms_per_step": wall / steps * 1e3, "tokens_per_s": SLOTS * steps / wall,
        "windows": len(walls),
        "ms_per_step_windows": [w / steps * 1e3 for w in walls],
        "ms_per_step_spread": (walls[-1] - walls[0]) / steps * 1e3,
        "tokens_per_s_range": [SLOTS * steps / walls[-1], SLOTS * steps / walls[0]],
        "profiled_ms_per_step": wall_prof / steps * 1e3,
        "device_busy_ms_per_step": busy_ms / steps,
        # the profiler slows the host, not the kernels: the idle share of an
        # unprofiled step is the busy time against the median unprofiled wall
        "device_idle_share": 1.0 - busy_ms / steps / (wall / steps * 1e3),
        "device_idle_share_profiled": 1.0 - busy_ms / (wall_prof * 1e3),
        "top_kernels": [dict(name=n[:120], ms_per_step=ms / steps, calls=c)
                        for n, ms, c in rows[:12]],
        "kernel_launches_per_step": {k: v / steps for k, v in launches.items()},
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
