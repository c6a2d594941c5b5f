#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's engine spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_decode_profile.py
        [--model qwen3|gpt-oss|qwen3-moe|glm|minimax|glm5|qwen3-next|nemotron-h] [--layers N]
        [--windows N] [--quantization int8] [--constrained N]

Builds the engine for Qwen3-0.6B (28 layers, full vocabulary, random weights
from seed 0, bf16; ``--model gpt-oss``: openai/gpt-oss-20b, 24 layers, all 32
experts, windows of 128 on every other layer, sinks; ``qwen3-moe``:
Qwen/Qwen3-30B-A3B, 48 layers, 128 experts top-8, 61 GB of weights; ``glm``:
zai-org/GLM-4.5-Air at full width, its depth cut by ``--layers``, 4 by
default; ``minimax``: MiniMax-M2 from its published config.json
(``chip_smoke.MINIMAX_M2_CONFIG``), 8 layers by default, 61.1 GB of weights;
``glm5``: GLM-5's widths (``chip_smoke.GLM5_CONFIG``) with the cuts of
``chip_smoke.GLM5_CUTS``, 4 layers, 32 routed experts, MLA + DSA over the
latent cache; ``qwen3-next``: Qwen/Qwen3-Next-80B-A3B-Instruct's widths, all
512 experts, 16 of its 48 layers (LLLA x 4: 12 GatedDeltaNet layers and 4
gated attention layers at head dim 256), 53.8 GB; ``nemotron-h``:
nvidia/Nemotron-H-8B-Base-8K, all 52 layers (24 Mamba-2, 24 relu^2 MLP, 4
attention layers of 32/8 heads of 128), 16.2 GB), fills all 64 decode
slots with prompts of 500 to 1000 random tokens (unfiltered sampling at
temperature 1, the RL rollout setting), lets the engine admit them and run, then measures decode blocks
(8 steps each): host-clock time per step over N unprofiled windows of 48
steps (default 5; their median and spread: one window does not resolve the
host clock), and under ``torch.profiler`` one more window's device time per
kernel name and the device's idle share. The JSON line also gives the
weights' bytes and the time the card takes to read them once at 3.35 TB/s:
a decode step of a MoE model at 64 slots reads nearly every expert, so that
time bounds its step from below. ``device_ms_by_part`` splits a step's device
time into K4, K3, the experts' grouped products (``aten::_grouped_mm``) and
the copies (``aten::copy_``); for a hybrid, ``gdn_decode_ms`` (Qwen3-Next)
or ``mamba_decode_ms`` (Nemotron-H) is the device time of a step's recurrent
decode mixers (``sampler.model._gdn_decode_mixer`` or ``_mamba_decode_mixer``
on every recurrent layer, with the copy of the rows back into the pool, as
``decode`` runs them) called alone on the engine's 64 slots, CUDA events
around them.
``--quantization int8`` serves the weights int8 weight-only (the engine's
``quantize``; q/k/v then in plain PyTorch, not K3); ``--constrained N``
gives the first N requests the regex ``CONSTRAINED_REGEX`` with the byte
tokenizer's token bytes, so that every step of those slots runs the
constraint's mask (they ignore eos, so they stay live for the windows).
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
MODELS = {"qwen3": "Qwen/Qwen3-0.6B", "gpt-oss": "openai/gpt-oss-20b",
          "qwen3-moe": "Qwen/Qwen3-30B-A3B", "glm": "zai-org/GLM-4.5-Air",
          "minimax": "MiniMaxAI/MiniMax-M2", "glm5": "zai-org/GLM-5",
          "qwen3-next": "Qwen/Qwen3-Next-80B-A3B-Instruct",
          "nemotron-h": "nvidia/Nemotron-H-8B-Base-8K"}
# the models given by a config.json in chip_smoke.py, and their default depth
CONFIGS = {"minimax": ("MINIMAX_M2_CONFIG", 8), "glm5": ("GLM5_CONFIG", 4)}
# tokens a request may generate: the pool holds each slot's prompt and these,
# and Qwen3-30B-A3B's and MiniMax-M2's 61 GB of weights leave room for about
# 10 GB of pages
MAX_TOKENS = {"qwen3": 2000, "gpt-oss": 2000, "qwen3-moe": 400, "glm": 2000, "minimax": 400,
              "glm5": 2000, "qwen3-next": 2000, "nemotron-h": 2000}
QWEN3_NEXT_LAYERS = 16
# unbounded, so that a constrained slot stays live: the mask's cost does not
# depend on the pattern's size
CONSTRAINED_REGEX = "[a-z ]+"
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def recurrent_decode_ms(engine) -> float:
    """Device ms of one decode step's recurrent mixers (GatedDeltaNet or
    Mamba-2) on the engine's slots (every recurrent layer, the rows copied
    back into the pool as ``decode`` does), CUDA events around 10 runs after
    a warm-up."""
    import torch

    from prime_rl_tpu_torch.sampler import model as smodel

    spec, dtype = engine.spec, engine.compute_dtype
    mixer = smodel._gdn_decode_mixer if spec.gdn_pattern else smodel._mamba_decode_mixer
    layers = [(i, smodel._cast_layer(lp, dtype)) for i, lp in enumerate(engine.params["layers"])
              if engine.r_conv[i] is not None]
    h = torch.randn(engine.config.max_slots, 1, spec.hidden_size, device=engine.device,
                    dtype=dtype)

    def step():
        for i, lp in layers:
            _, conv, state = mixer(h, lp, spec, engine.r_conv[i], engine.r_state[i], dtype)
            engine.r_conv[i].copy_(conv)
            engine.r_state[i].copy_(state)

    step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 10


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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: all layers; 4 for glm)")
    ap.add_argument("--quantization", choices=["int8"], default=None,
                    help="serve the weights int8 weight-only")
    ap.add_argument("--constrained", type=int, default=0,
                    help="requests (of the 64) that carry a regex constraint")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    _build.build()
    if args.model in CONFIGS:
        import dataclasses

        import chip_smoke
        from prime_rl_tpu_torch.models.base import spec_from_hf_config

        name, depth = CONFIGS[args.model]
        cuts = chip_smoke.GLM5_CUTS if args.model == "glm5" else {}
        spec = spec_from_hf_config({**getattr(chip_smoke, name), **cuts})
        spec = dataclasses.replace(spec, num_layers=args.layers or depth)
    elif args.model == "qwen3-next":
        import dataclasses

        full = get_spec(MODELS[args.model])
        n = args.layers or QWEN3_NEXT_LAYERS
        spec = dataclasses.replace(full, num_layers=n, gdn_pattern=full.gdn_pattern[:n])
    elif args.model == "nemotron-h":
        import dataclasses

        full = get_spec(MODELS[args.model])
        n = args.layers or full.num_layers
        spec = dataclasses.replace(full, num_layers=n, layer_pattern=full.layer_pattern[:n])
    else:
        layers = args.layers or (4 if args.model == "glm" else None)
        spec = get_spec(MODELS[args.model], num_layers=layers)
    dev = torch.device("cuda")
    params = get_family(spec).init(spec, torch.Generator(device=dev).manual_seed(SEED),
                                   dtype=torch.bfloat16, device=dev)
    max_tokens = MAX_TOKENS[args.model]
    pages_a_slot = -(-(1000 + max_tokens + 1) // 64)
    from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer
    from prime_rl_tpu_torch.sampler.constrain import token_bytes_from_tokenizer

    engine = Engine(params, spec, CacheConfig(num_pages=SLOTS * pages_a_slot + 64, page_size=64,
                                              max_slots=SLOTS, max_seq_len=4096),
                    device="cuda", seed=SEED, quantize=args.quantization,
                    token_bytes=token_bytes_from_tokenizer(ByteTokenizer()))
    del params
    # the served weights (int8 records count their int8 weights and scales)
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(engine.params))
    rng = np.random.default_rng(SEED)
    sp = SamplingParams(max_tokens=max_tokens, temperature=1.0, ignore_eos=True)
    for i, n in enumerate(rng.integers(500, 1001, SLOTS)):
        constraint = {"regex": CONSTRAINED_REGEX} if i < args.constrained else {}
        engine.submit(rng.integers(0, spec.vocab_size, int(n)).tolist(),
                      SamplingParams(**{**sp.__dict__, **constraint}))
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
    events = prof.key_averages()
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in events
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]

    def device_ms(match) -> float:  # a step's device time of the events that match
        return sum(ev.self_device_time_total for ev in events
                   if ev.device_type == DeviceType.CUDA and match(ev.key)) / 1e3 / steps

    def op_ms(key: str) -> float:  # a step's device time under an op or a range
        return sum(ev.device_time_total for ev in events if ev.key == key) / 1e3 / steps

    parts = {"K4 decode_paged_attention": device_ms(lambda k: "decode_split_kernel" in k),
             "K3 decode_qkv_prep": device_ms(lambda k: "decode_qkv" in k),
             "grouped products (aten::_grouped_mm)": op_ms("aten::_grouped_mm"),
             "copies (aten::copy_)": op_ms("aten::copy_")}
    rec_ms = recurrent_decode_ms(engine) if spec.gdn_pattern or spec.layer_pattern else None
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"{'kernel':70s} {'device ms':>10s} {'share':>7s} {'calls':>6s}")
    for name, ms, count in rows[:25]:
        print(f"{name[:70]:70s} {ms:10.3f} {ms / busy_ms:7.1%} {count:6d}")
    launches = dict(_build.launches)
    result = {
        "card": card, "model": MODELS[args.model], "layers": spec.num_layers, "slots": SLOTS,
        "quantization": args.quantization, "constrained_slots": args.constrained,
        "weight_bytes": weight_bytes,
        "weights_read_once_ms": weight_bytes / PEAK_BYTES * 1e3,
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
        "device_ms_by_part": parts,
        "gdn_decode_ms": rec_ms if spec.gdn_pattern else None,
        "mamba_decode_ms": rec_ms if spec.layer_pattern else None,
        "top_kernels": [dict(name=n[:120], ms_per_step=ms / steps, calls=c)
                        for n, ms, c in rows[:12]],
        "kernel_launches_per_step": {k: v / steps for k, v in launches.items()},
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
