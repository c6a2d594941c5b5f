#!/usr/bin/env python3
"""Where a train step of the PyTorch port's RL trainer spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_train_profile.py [--model qwen3|glm5|gpt-oss]
        [--ac-mode none|full|save_attn|offload_attn|offload_dots|selective[/K]]
        [--seq-len L] [--optimizer adamw_8bit|adamw|muon|adafactor_mom]
        [--quantized-compute int8] [--offload-optimizer] [--offload-params]

Builds the train state (random weights from seed 0, bf16 masters, adamw_8bit,
grad clip 1.0) and takes steps on fake batches, as the trainer does.
``--model qwen3`` (the default): Qwen3-0.6B, 28 layers, full vocabulary, 4
micro-batches of [8, 512] tokens. ``--model glm5``: the glm_moe_dsa family at
GLM-5's widths as ``chip_smoke.py`` cuts it (4 layers, 32 routed experts), 2
micro-batches of [1, 4096] tokens, with the sparse-MLA kernels, the indexer's
sort and the experts' grouped products as groups of their own, and the indexer
(logits and top-k) timed alone at the step's shapes. ``--model gpt-oss``:
gpt-oss at gpt-oss-20b's widths as ``chip_smoke.py`` cuts it (4 layers, two
windowed and two full, all 32 experts), 2 micro-batches of [1, 4096] tokens,
rows of four sequences each. ``--seq-len L`` (qwen3 only): 2 micro-batches
of [1, L] tokens instead, the long-context shape (upstream prime-rl's
figures are a micro-batch of one row of L). ``--optimizer adamw`` takes AdamW
with float32 masters (the example RL config's) in place of adamw_8bit with
bf16 masters, ``--optimizer muon`` Muon with float32 masters (Newton-Schulz on
every projection stack, AdamW on the rest) and ``--optimizer adafactor_mom``
Adafactor with bf16 momentum and bf16 masters; ``--quantized-compute int8``
runs the MLP products in int8 (``ops/int8_linear.py``; its cuBLASLt products
are summed apart, as "int8 matrix products"); ``--offload-optimizer`` and ``--offload-params`` put the
optimizer state and the masters in pinned host memory (the step's update,
a leaf at a time, then streams them, ``trainer/step.py``; under
``--offload-params`` the halves and the micro-batch breakdown below are left
out: its gradient phase runs on a bf16 device copy of the masters, which
they do not make).
Measures, after two warm-up steps:
  - host-clock time per step over three steps (ending in a synchronize);
  - with CUDA events on the stream: gradient accumulation against the
    optimizer update (the step's own two halves), and inside one micro-batch the forward, the LM head with
    the loss, and the backward (which holds the remat recompute and the LM
    head's backward); the LM head alone (forward + backward) on a detached
    hidden state;
  - under ``torch.profiler`` for one step: device time per kernel name (device
    events only), summed into the hand-written attention kernels, the library
    matrix products, and the rest (elementwise, reductions, copies), and the
    device's idle share of the step; the copies to and from pinned host
    memory (the offload modes', on side streams) are summed apart and left
    out of the busy time.
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

SEED = 0
SHAPES = {"qwen3": (4, 8, 512), "glm5": (2, 1, 4096),
          "gpt-oss": (2, 1, 4096)}  # micro-batches, rows, seq_len
OURS = {"flash_fwd_kernel": "flash_attn_fwd", "flash_bwd_dq_kernel": "flash_attn_bwd_dq",
        "flash_bwd_dkv_kernel": "flash_attn_bwd_dkv", "sparse_mla_fwd_kernel": "sparse_mla_fwd",
        "sparse_mla_bwd_kernel": "sparse_mla_bwd",
        "sparse_mla_dkv_reduce_kernel": "sparse_mla_dkv_reduce"}
GROUPED_MARKS = ("grouped", "group_gemm", "GroupProblem")  # the experts' grouped products
SORT_MARKS = ("sort", "radix")  # the indexer's top-k (and the MoE dispatch's argsort)
GEMM_MARKS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
INT8_MARKS = ("s8", "i8", "imma", "int8")  # with a GEMM mark: cuBLASLt's int8 products
OPTIMIZERS = {"adamw_8bit": {"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"},
              "adamw": {"type": "adamw", "lr": 1e-6},
              "muon": {"type": "muon"},
              "adafactor_mom": {"type": "adafactor_mom", "lr": 1e-5,
                                "master_dtype": "bfloat16"}}


def halves(state, step, spec, cfg, next_inputs, events, get_family, chunked_logprob_entropy,
           MicroBatchArrays, tree_map):
    """(state, (gradient accumulation ms, optimizer update ms, and inside one
    micro-batch: forward, LM head with the loss, backward ms, the LM head
    alone)): the two halves of a step, then one micro-batch's parts, on CUDA
    events."""
    import torch

    batch, scales = next_inputs()
    e = events(3)
    e[0].record()
    grads = step.accum_grads(state.params, batch, scales)[0]
    e[1].record()
    state, _ = step.apply_update(state, grads)  # the step's own leaf-at-a-time update
    del grads
    e[2].record()
    torch.cuda.synchronize()
    accum_ms, update_ms = e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])

    # inside one micro-batch
    from prime_rl_tpu_torch.trainer.rl import loss as loss_lib
    from prime_rl_tpu_torch.trainer.step import _shift_left

    family = get_family(spec)
    mb = MicroBatchArrays(*[None if x is None else x[0] for x in batch])
    gp = tree_map(lambda x: x.detach().requires_grad_(True), state.params)
    labels, temps = _shift_left(mb.input_ids, 0), _shift_left(mb.temperatures, 1.0)
    e = events(4)
    e[0].record()
    hidden = family.forward(gp, spec, mb.input_ids, mb.segment_ids, mb.position_ids,
                            remat=cfg.model.ac.mode,
                            quantized_compute=cfg.model.quantized_compute)
    e[1].record()
    # the head in the hidden states' dtype, as the step casts it (float32 masters)
    lp, _ = chunked_logprob_entropy(hidden, family.get_lm_head(gp, spec).to(hidden.dtype),
                                    labels, temps, chunk_size=cfg.model.lm_head_chunk_size)
    loss, _ = loss_lib.compute_loss(
        trainer_logprobs=lp, inference_logprobs=mb.inference_logprobs,
        advantages=mb.advantages, loss_mask=mb.loss_mask, ref_logprobs=None, rl_weights=None,
        ce_weights=None, ref_kl_weights=None, loss_cfg=cfg.loss, rl_scale=scales.rl,
        ce_scale=1.0, ref_kl_scale=1.0)
    e[2].record()
    loss.backward()
    e[3].record()
    torch.cuda.synchronize()
    fwd_ms, head_ms, bwd_ms = (e[i].elapsed_time(e[i + 1]) for i in range(3))
    # the LM head alone, forward and backward, on a detached hidden state
    h2 = hidden.detach().requires_grad_(True)
    w2 = family.get_lm_head(state.params, spec).detach().to(h2.dtype).requires_grad_(True)
    e = events(2)
    e[0].record()
    lp2, _ = chunked_logprob_entropy(h2, w2, labels, temps,
                                     chunk_size=cfg.model.lm_head_chunk_size)
    lp2.sum().backward()
    e[1].record()
    torch.cuda.synchronize()
    head_alone_ms = e[0].elapsed_time(e[1])
    del gp, hidden, lp, loss, h2, w2, lp2
    return state, (accum_ms, update_ms, fwd_ms, head_ms, bwd_ms, head_alone_ms)


def main() -> int:
    # as the trainer's entry point: at gigabytes of parameters the caching
    # allocator otherwise strands tens of GiB in fragments (read at first use)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops.lm_head import chunked_logprob_entropy
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_map
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import (
        MicroBatchArrays,
        Scales,
        init_train_state,
        make_train_step,
        put_batch,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--ac-mode", default="full")
    ap.add_argument("--model", default="qwen3", choices=sorted(SHAPES))
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--optimizer", default="adamw_8bit", choices=sorted(OPTIMIZERS))
    ap.add_argument("--quantized-compute", default=None, choices=("int8",))
    ap.add_argument("--offload-optimizer", action="store_true")
    ap.add_argument("--offload-params", action="store_true")
    args = ap.parse_args()
    N_MB, ROWS, SEQ_LEN = SHAPES[args.model]
    if args.seq_len:
        if args.model != "qwen3":
            ap.error("--seq-len takes the qwen3 model")
        N_MB, ROWS, SEQ_LEN = 2, 1, args.seq_len
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    _build.build()
    model_name, loader_cls = "Qwen/Qwen3-0.6B", FakeDataLoader
    if args.model == "glm5":
        import chip_smoke

        model_name = chip_smoke.glm5_model_dir("glm5_profile", **chip_smoke.GLM5_CUTS)
    elif args.model == "gpt-oss":
        import chip_smoke

        model_name = chip_smoke.gpt_oss_model_dir("gpt_oss_profile", num_hidden_layers=4)
        loader_cls = chip_smoke.packed_fake_loader(4)
    cfg = TrainerConfig(
        device="cuda", seed=SEED, grad_clip=1.0,
        model={"name": model_name, "seq_len": SEQ_LEN, "ac": {"mode": args.ac_mode},
               "debug": {"random_init": True}, "quantized_compute": args.quantized_compute},
        optimizer=OPTIMIZERS[args.optimizer],
        data={"type": "fake", "seq_len": SEQ_LEN, "micro_batch_size": ROWS,
              "num_micro_batches": N_MB},
        offload_optimizer=args.offload_optimizer, offload_params=args.offload_params)
    spec = get_spec(cfg.model.name)
    dev = torch.device("cuda")
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    state = init_train_state(spec, dev, optimizer, seed=SEED,
                             master_dtype=getattr(cfg.optimizer, "master_dtype", "float32"),
                             offload_optimizer=cfg.offload_optimizer,
                             offload_params=cfg.offload_params)
    step = make_train_step(spec, cfg.model, cfg.loss, optimizer, dev,
                           offload_optimizer=cfg.offload_optimizer,
                           offload_params=cfg.offload_params)
    loader = loader_cls(spec.vocab_size, SEQ_LEN, ROWS, N_MB, seed=SEED)

    def next_inputs():
        batch, counts = loader.next_batch()
        return put_batch(batch, dev), Scales(float(max(counts["rl"], 1)), 1.0, 1.0)

    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    for _ in range(2):
        state, _ = step(state, *next_inputs())
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        batch, scales = next_inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, scales)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    tokens = N_MB * ROWS * SEQ_LEN

    accum_ms = update_ms = fwd_ms = head_ms = bwd_ms = head_alone_ms = None
    if not args.offload_params:
        state, (accum_ms, update_ms, fwd_ms, head_ms, bwd_ms, head_alone_ms) = halves(
            state, step, spec, cfg, next_inputs, events, get_family, chunked_logprob_entropy,
            MicroBatchArrays, tree_map)

    # one whole step under the profiler
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch, scales = next_inputs()
    _build.reset_launches()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch, scales)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    launches = dict(_build.launches)
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    # the host tier's copies run on side streams, under the compute stream's
    # kernels: they are counted apart, not as busy time
    host_copies_ms = sum(r[1] for r in rows if "Pinned" in r[0])
    busy_ms = sum(r[1] for r in rows if "Pinned" not in r[0])
    groups = {"expert grouped products": 0.0, "sorts": 0.0, "library matrix products": 0.0,
              "int8 matrix products": 0.0, "elementwise, reductions, copies": 0.0}
    groups.update({v: 0.0 for v in OURS.values()})
    n_kernels = 0
    for name, ms, count in rows:
        if "Pinned" in name:
            continue
        n_kernels += count
        ours = next((v for k, v in OURS.items() if k in name), None)
        if ours is not None:
            groups[ours] += ms
        elif any(m in name for m in GROUPED_MARKS):
            groups["expert grouped products"] += ms
        elif any(m in name.lower() for m in SORT_MARKS):
            groups["sorts"] += ms
        elif any(m in name.lower() for m in GEMM_MARKS):
            int8 = any(m in name.lower() for m in INT8_MARKS)
            groups["int8 matrix products" if int8 else "library matrix products"] += ms
        else:
            groups["elementwise, reductions, copies"] += ms
    print(f"{'kernel':70s} {'device ms':>10s} {'share':>7s} {'calls':>6s}")
    for name, ms, count in rows[:25]:
        print(f"{name[:70]:70s} {ms:10.3f} {ms / busy_ms:7.1%} {count:6d}")
    for name, ms in groups.items():
        print(f"{name:40s} {ms:10.3f} ms {ms / busy_ms:7.1%} of busy")

    indexer = None
    if spec.index_topk:
        # the indexer alone (logits of 32 index heads and the stable sort that
        # picks the top-k) at one row's shapes; it runs once per layer and pass
        from prime_rl_tpu_torch.ops.sparse_mla import mla_topk_indices

        g = torch.Generator(device=dev).manual_seed(SEED)
        hi, di = spec.index_n_heads, spec.index_head_dim
        q_idx = torch.randn(SEQ_LEN, hi, di, device=dev, generator=g).to(torch.bfloat16)
        k_idx = torch.randn(SEQ_LEN, di, device=dev, generator=g).to(torch.bfloat16)
        w_idx = torch.randn(SEQ_LEN, hi, device=dev, generator=g).to(torch.bfloat16)
        ks = torch.zeros(SEQ_LEN, dtype=torch.int32, device=dev)
        ke = torch.arange(1, SEQ_LEN + 1, dtype=torch.int32, device=dev)
        for _ in range(2):
            mla_topk_indices(q_idx, k_idx, w_idx, ks, ke, spec.index_topk)
        e = events(2)
        e[0].record()
        for _ in range(5):
            mla_topk_indices(q_idx, k_idx, w_idx, ks, ke, spec.index_topk)
        e[1].record()
        torch.cuda.synchronize()
        passes = 2 if cfg.model.ac.mode == "full" else 1
        calls = spec.num_layers * N_MB * ROWS * passes
        indexer = {"ms_per_call": e[0].elapsed_time(e[1]) / 5, "calls_per_step": calls}
        indexer["ms_per_step"] = indexer["ms_per_call"] * calls
        print(f"indexer alone: {indexer['ms_per_call']:.3f} ms a call, {calls} calls a step")
    # the spec's flop count covers the dense and GQA families only (and counts
    # full attention on every layer, so not gpt-oss's windowed ones)
    flops = spec.flops_per_token(SEQ_LEN) * tokens if args.model == "qwen3" else None
    result = {
        "card": card, "ac_mode": cfg.model.ac.mode, "tokens_per_step": tokens,
        "seq_len": SEQ_LEN, "micro_batches": N_MB, "rows": ROWS,
        "optimizer": cfg.optimizer.type, "quantized_compute": cfg.model.quantized_compute,
        "offload_optimizer": cfg.offload_optimizer,
        "offload_params": cfg.offload_params,
        "step_s": wall, "step_s_all": walls, "tokens_per_s": tokens / wall,
        "model": args.model, "layers": spec.num_layers, "routed_experts": spec.num_experts,
        "mfu_vs_989_tflops": None if flops is None else flops / wall / 989e12,
        "indexer_alone": indexer,
        "loss": float(metrics["loss"]),
        "accum_grads_ms": accum_ms, "optimizer_update_ms": update_ms,
        "one_micro_batch": {"forward_ms": fwd_ms, "lm_head_and_loss_forward_ms": head_ms,
                            "backward_ms": bwd_ms,
                            "lm_head_alone_forward_backward_ms": head_alone_ms},
        "profiled_step_s": wall_prof, "device_busy_ms": busy_ms,
        "host_copies_ms": host_copies_ms,
        # the profiler slows the host, not the kernels: the idle share of an
        # unprofiled step is the busy time against the unprofiled wall
        "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
        "device_idle_share_profiled": 1.0 - busy_ms / (wall_prof * 1e3),
        "device_kernels_per_step": n_kernels,
        "busy_ms_by_group": groups,
        "kernel_launches_per_step": launches,
        "peak_device_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "top_kernels": [dict(name=n[:120], ms=ms, calls=c) for n, ms, c in rows[:12]],
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
