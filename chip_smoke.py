#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port's serving and training paths on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the last line):
  1. device   — requires CUDA; prints nvidia-smi's name and power limit.
  2. build    — compiles the hand-written kernels from ``prime_rl_tpu_torch/csrc``.
  3. kernels  — K1 flash_attn_fwd, K3 decode_qkv_prep and K4 decode_paged_attention
                at the Qwen3-0.6B shapes of the serving path, K2a flash_attn_bwd_dq
                and K2b flash_attn_bwd_dkv at the trainer's shape and one long
                shape, K5a sparse_mla_fwd, K5b sparse_mla_bwd and the dkv
                reduction at the GLM-5 attention widths (64 heads, 576 = 512 + 64
                channels, top-k 2048) over a packed row of 4096 tokens and over a
                short row full of sentinels, each held against its plain PyTorch
                version (computed in
                float32 on the same bf16 inputs) and timed beside the plain
                version, a one-call PyTorch yardstick where one exists, and the
                bound of the H100 (SXM data sheet: 3.35 TB/s, 989 TFLOP/s dense
                bf16).
  4. train-reference — loss and every gradient of one micro-batch [2, 512] of
                the full-width model cut to 2 layers (full vocabulary), through
                the kernels in bf16 on the card, against the plain float32 path
                on the CPU.
  5. training — the port's RL trainer through its normal entry (Qwen3-0.6B, all
                28 layers, full vocabulary, random weights from a seed, fake
                data, seq_len 512, 4 micro-batches of 8 rows, adamw_8bit with
                bf16 masters) takes 4 steps, twice from the same seed: finite
                losses and grad-norms, changed parameters, bit-equal losses,
                the expected launches of K1, K2a and K2b, and a v4 HF snapshot
                that reads back equal to the state's parameters.
  6. dsa-train-reference — the same for the glm_moe_dsa family at GLM-5's
                widths, cut to 1 dense + 1 MoE layer of 8 experts: one row of
                1024 tokens with top-k 256, K5a/K5b in bf16 on the card against
                float32 on the CPU.
  7. dsa-training — the trainer through the same entry on a directory whose
                config.json names GlmMoeDsaForCausalLM at GLM-5's widths (depth
                78 -> 4 layers, 3 dense + 1 MoE; 256 -> 32 routed experts; the
                cuts are logged), seq_len 4096, 2 micro-batches of 1 row,
                adamw_8bit with bf16 masters, full remat: 3 steps, twice from the
                same seed: finite and changing losses, changed parameters,
                bit-equal losses, the launches of K5a, K5b and the reduction that
                the layers, micro-batches and remat imply, and a snapshot that
                reads back through get_spec and the family's from_hf.
  8. reference — the served model's prefill and decode logits through the
                kernels against a plain float32 forward on the CPU.
  9. serving  — the port's inference server (Qwen3-0.6B, all 28 layers, full
                vocabulary, random weights from a seed, byte tokenizer) answers
                16 concurrent /inference/v1/generate requests, a /v1/completions
                request and a streaming /v1/chat/completions request over HTTP;
                greedy requests are deterministic; every kernel was launched.
Then one JSON line with every kernel's numbers, and the result line. A kernel's
``launches`` is its count on the path that runs it (K1 runs on both: its
``launches`` is the serving path's, ``launches_training`` the Qwen3 trainer's;
the sparse-MLA kernels run on the DSA trainer's path).
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
MODEL = "Qwen/Qwen3-0.6B"
SEED = 0

# zai-org/GLM-5, config.json, GlmMoeDsaForCausalLM: the published widths, all
# kept. Depth and the number of routed experts are cut to fit one card.
GLM5_CONFIG = {
    "architectures": ["GlmMoeDsaForCausalLM"],
    "hidden_size": 6144, "num_attention_heads": 64, "num_key_value_heads": 64,
    "q_lora_rank": 2048, "kv_lora_rank": 512, "qk_nope_head_dim": 192,
    "qk_rope_head_dim": 64, "v_head_dim": 256, "index_n_heads": 32, "index_head_dim": 128,
    "index_topk": 2048, "intermediate_size": 12288, "moe_intermediate_size": 2048,
    "num_experts_per_tok": 8, "n_shared_experts": 1, "first_k_dense_replace": 3,
    "routed_scaling_factor": 2.5, "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
    "scoring_func": "sigmoid", "rope_interleave": True, "vocab_size": 154880,
    "tie_word_embeddings": False, "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 202752, "eos_token_id": 154820, "pad_token_id": 154820,
    "num_hidden_layers": 78, "n_routed_experts": 256,
}
GLM5_CUTS = {"num_hidden_layers": 4, "n_routed_experts": 32}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of one call: CUDA events around each call, queued
    behind a sleep kernel so host overhead stays out of the measurement;
    ``flush`` (a large tensor zeroed before each call) evicts the L2 cache."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def check_close(name: str, got, ref, atol: float, rtol: float) -> float:
    """max |got - ref|; raises unless |got - ref| <= atol + rtol * |ref| everywhere."""
    import torch

    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    if not bool((err <= atol + rtol * ref.abs()).all()):
        raise AssertionError(f"{name}: max abs err {float(err.max()):.4g} exceeds "
                             f"atol {atol} + rtol {rtol} * |ref|")
    return float(err.max())


# bf16 stores 8 significant bits (relative rounding <= 2^-9 per value); the
# kernels round their bf16 output once and K1 also rounds its probabilities
# to bf16 before the PV product, so 1e-2 absolute plus 1e-2 relative bounds
# a correct kernel with room to spare and catches any wrong element.
ATOL, RTOL = 1e-2, 1e-2


def kernel_phase(spec) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from prime_rl_tpu_torch.ops.decode_attention import (
        decode_paged_attention,
        decode_paged_attention_reference,
    )
    from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep, decode_qkv_prep_reference
    from prime_rl_tpu_torch.ops.flash_attention import (
        _delta,
        flash_attention_dkv,
        flash_attention_dkv_reference,
        flash_attention_dq,
        flash_attention_dq_reference,
        flash_attention_reference,
        flash_attention_with_lse,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    nh, nkv, hd, d = spec.num_heads, spec.num_kv_heads, spec.head_dim, spec.hidden_size
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    rows = []

    # ---- K1: prefill flash attention --------------------------------------
    cases = []
    for b, l in ((4, 512), (1, 2048)):
        q, k, v = randn(b, l, nh, hd), randn(b, l, nkv, hd), randn(b, l, nkv, hd)
        seg = torch.zeros(b, l, dtype=torch.int32, device=dev)
        seg_lens = [[200, 250], [512], [37], []] if b == 4 else [[2048]]
        pairs = 0
        for r, lens in enumerate(seg_lens):
            off = 0
            for i, n in enumerate(lens):
                seg[r, off:off + n] = i + 1
                off += n
                pairs += n * (n + 1) // 2
        out, lse = flash_attention_with_lse(q, k, v, seg, seg, causal=True)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg,
                                                     True, hd ** -0.5)
        err = check_close(f"flash_attn_fwd B={b} L={l}", out, ref_out, ATOL, RTOL)
        valid = ref_lse > -1e29
        check_close("flash_attn_fwd lse", lse[valid], ref_lse[valid], 1e-3, 1e-4)
        if not bool((lse[~valid] < -1e29).all()):
            raise AssertionError("flash_attn_fwd: padding rows must give lse -1e30")
        ms = time_ms(lambda: flash_attention_with_lse(q, k, v, seg, seg, causal=True))
        plain = time_ms(lambda: flash_attention_reference(q, k, v, seg, seg, True, hd ** -0.5),
                        iters=5)
        # yardstick: one SDPA call with the same mask on [B, N, L, D] inputs
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pos = torch.arange(l, device=dev)
        mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
                & (pos[:, None] >= pos[None, :]))[:, None]
        lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                             enable_gqa=True), iters=10)
        nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + lse.numel() * 4 + seg.numel() * 4
        flops = pairs * nh * 4 * hd
        bms, by = bound(nbytes, flops)
        cases.append(dict(shape=f"B={b} L={l}", max_abs_err=err, ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bms, bound_by=by))
        log(f"K1 flash_attn_fwd B={b} L={l}: err {err:.3g}  kernel {ms:.4f} ms  plain "
            f"{plain:.4f} ms  sdpa {lib:.4f} ms  bound {bms:.4f} ms ({by})")
        del q, k, v, qt, kt, vt, mask, out, lse, ref_out, ref_lse
    rows.append(dict(name="flash_attn_fwd", route="cuda",
                     source="prime_rl_tpu_torch/csrc/flash_attn_fwd.cu",
                     replaces="prime_rl_tpu/ops/flash_attention.py:59",
                     **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms")},
                     max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases))

    # ---- K2a / K2b: flash attention backward ---------------------------------
    # against the plain backward on the same bf16 inputs (it rounds p and ds to
    # bf16 where the kernels do, and sums in float32): one bf16 step of the
    # result (2^-8 relative) plus the few ds roundings that flip between the
    # kernel's exp and PyTorch's -> 2e-2 absolute + 2e-2 relative
    k2_atol = k2_rtol = 2e-2
    dq_cases, dkv_cases = [], []
    for b, l, seg_lens in ((8, 512, [[120, 130, 100, 110]] * 8), (1, 4096, [[4096]])):
        q, k, v = randn(b, l, nh, hd), randn(b, l, nkv, hd), randn(b, l, nkv, hd)
        do = randn(b, l, nh, hd)
        seg = torch.zeros(b, l, dtype=torch.int32, device=dev)
        pairs = 0
        for r, lens in enumerate(seg_lens):
            off = 0
            for i, n in enumerate(lens):
                seg[r, off:off + n] = i + 1  # the rest of the row is padding
                off += n
                pairs += n * (n + 1) // 2
        scale = hd ** -0.5
        out, lse = flash_attention_with_lse(q, k, v, seg, seg, causal=True)
        delta = _delta(out, do, None)
        args = (q, k, v, seg, seg, lse, delta, do, True, scale)
        dq = flash_attention_dq(*args)
        dk, dv = flash_attention_dkv(*args)
        torch.cuda.synchronize()
        ref_dq = flash_attention_dq_reference(*args)
        ref_dk, ref_dv = flash_attention_dkv_reference(*args)
        err_dq = check_close(f"flash_attn_bwd_dq B={b} L={l}", dq, ref_dq, k2_atol, k2_rtol)
        err_dkv = max(check_close(f"flash_attn_bwd_dkv {n} B={b} L={l}", g, r, k2_atol, k2_rtol)
                      for n, g, r in (("dk", dk, ref_dk), ("dv", dv, ref_dv)))
        if not bool((dq[seg == 0] == 0).all()):
            raise AssertionError("flash_attn_bwd_dq: padding rows must give dq = 0")
        del ref_dq, ref_dk, ref_dv
        ms_dq = time_ms(lambda: flash_attention_dq(*args))
        ms_dkv = time_ms(lambda: flash_attention_dkv(*args))
        plain_dq = time_ms(lambda: flash_attention_dq_reference(*args), iters=5)
        plain_dkv = time_ms(lambda: flash_attention_dkv_reference(*args), iters=5)
        # yardstick: autograd through one SDPA call with the same mask; its
        # backward gives dq, dk and dv together, so both rows show the same time
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        pos = torch.arange(l, device=dev)
        mask = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
                & (pos[:, None] >= pos[None, :]))[:, None]
        o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        do_t = do.transpose(1, 2).contiguous()
        lib = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), do_t, retain_graph=True),
                      iters=10)
        # each input read once, each output written once; 3 (K2a) and 4 (K2b)
        # products of 2*HD flops per (query, key) pair that the segments and the
        # causal mask leave; the kernels visit every tile of the causal half
        # (B * L * (L + 1) / 2 pairs), which the second bound counts
        small = (2 * lse.numel() + seg.numel()) * 4
        qb, kb = q.numel() * 2, k.numel() * 2
        half = b * l * (l + 1) // 2
        for cases, name, ms, plain, err, nbytes, nprod in (
                (dq_cases, "K2a flash_attn_bwd_dq", ms_dq, plain_dq, err_dq,
                 3 * qb + 2 * kb + small, 3),
                (dkv_cases, "K2b flash_attn_bwd_dkv", ms_dkv, plain_dkv, err_dkv,
                 2 * qb + 4 * kb + small, 4)):
            bms, by = bound(nbytes, pairs * nh * nprod * 2 * hd)
            half_ms, _ = bound(nbytes, half * nh * nprod * 2 * hd)
            cases.append(dict(shape=f"B={b} L={l}", max_abs_err=err, ms=ms, plain_ms=plain,
                              library_ms=lib, bound_ms=bms, bound_by=by,
                              bound_causal_half_ms=half_ms))
            log(f"{name} B={b} L={l}: err {err:.3g}  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                f"sdpa backward (dq+dk+dv) {lib:.4f} ms  bound {bms:.4f} ms ({by}), "
                f"{half_ms:.4f} ms over the whole causal half  (tolerance {k2_atol} + "
                f"{k2_rtol} * |ref|)")
        del q, k, v, do, qt, kt, vt, mask, o_lib, do_t, out, lse, delta, dq, dk, dv, args
    for name, cases, line in (("flash_attn_bwd_dq", dq_cases, 227),
                              ("flash_attn_bwd_dkv", dkv_cases, 282)):
        rows.append(dict(name=name, route="cuda",
                         source="prime_rl_tpu_torch/csrc/flash_attn_bwd.cu",
                         replaces=f"prime_rl_tpu/ops/flash_attention.py:{line}",
                         **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")},
                         max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases))

    # ---- K3: decode qkv prep ----------------------------------------------
    s = 64
    x = randn(s, d)
    nw = (1 + 0.1 * torch.randn(d, device=dev, generator=gen)).to(torch.bfloat16)
    wq, wk, wv = randn(d, nh * hd, scale=0.02), randn(d, nkv * hd, scale=0.02), randn(
        d, nkv * hd, scale=0.02)
    qn = (1 + 0.1 * torch.randn(hd, device=dev, generator=gen)).to(torch.bfloat16)
    kn = (1 + 0.1 * torch.randn(hd, device=dev, generator=gen)).to(torch.bfloat16)
    positions = torch.randint(0, 4000, (s,), device=dev, generator=gen, dtype=torch.int32)
    from prime_rl_tpu_torch.models.qwen3 import rope_setup

    inv_freq, scaling = rope_setup(spec, device=dev)
    kw = dict(num_heads=nh, num_kv_heads=nkv, head_dim=hd, qk_norm=True, q_norm_w=qn,
              k_norm_w=kn, scaling=scaling, eps=spec.rms_eps)
    got = decode_qkv_prep(x, nw, wq, wk, wv, positions, inv_freq, **kw)
    torch.cuda.synchronize()
    ref = decode_qkv_prep_reference(x.float(), nw, wq, wk, wv, positions, inv_freq, **kw)
    err = max(check_close(f"decode_qkv_prep {n}", g, r, ATOL, RTOL)
              for n, g, r in zip("qkv", got, ref))
    ms = time_ms(lambda: decode_qkv_prep(x, nw, wq, wk, wv, positions, inv_freq, **kw),
                 flush=flush)
    plain = time_ms(lambda: decode_qkv_prep_reference(x, nw, wq, wk, wv, positions, inv_freq,
                                                      **kw), flush=flush)
    ncols = (nh + 2 * nkv) * hd
    nbytes = (s * d + d * ncols + d + 2 * hd + s * ncols) * 2 + s * 4 + inv_freq.numel() * 4
    bms, by = bound(nbytes, 2 * s * d * ncols)
    log(f"K3 decode_qkv_prep S={s}: err {err:.3g}  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
        f"bound {bms:.4f} ms ({by})  (cold L2)")
    rows.append(dict(name="decode_qkv_prep", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_qkv.cu",
                     replaces="prime_rl_tpu/ops/decode_qkv.py:36", max_abs_err=err, ms=ms,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                     shape=f"S={s} D={d}"))

    # ---- K4: paged decode attention + KV append ---------------------------
    ps = 64
    p = 4096 // ps
    n_inactive = 8
    np_ = s * p + 1
    k_pool, v_pool = randn(nkv, np_, ps, hd), randn(nkv, np_, ps, hd)
    table = (1 + torch.arange(s * p, device=dev, dtype=torch.int32)).reshape(s, p)
    lengths = torch.randint(1, 1501, (s,), device=dev, generator=gen, dtype=torch.int32)
    lengths[-n_inactive:] = torch.randint(0, 64, (n_inactive,), device=dev, generator=gen,
                                          dtype=torch.int32)
    table[-n_inactive:] = 0  # inactive slots: the null page
    qd, k_new, v_new = randn(s, nh, hd), randn(s, nkv, hd), randn(s, nkv, hd)
    k_ref, v_ref = k_pool.float(), v_pool.float()
    o, _, _ = decode_paged_attention(qd, k_new, v_new, k_pool, v_pool, lengths, table)
    torch.cuda.synchronize()
    ref_o, k_ref, v_ref = decode_paged_attention_reference(
        qd.float(), k_new.float(), v_new.float(), k_ref, v_ref, lengths, table)
    act = slice(0, s - n_inactive)
    err = check_close("decode_paged_attention", o[act], ref_o[act], ATOL, RTOL)
    for name, pool, want in (("k", k_pool, k_ref), ("v", v_pool, v_ref)):
        if not torch.equal(pool[:, 1:].float(), want[:, 1:]):
            raise AssertionError(f"decode_paged_attention: {name} pool writes are not exact")
    del k_ref, v_ref, ref_o
    ms = time_ms(lambda: decode_paged_attention(qd, k_new, v_new, k_pool, v_pool, lengths,
                                                table), flush=flush)
    plain = time_ms(lambda: decode_paged_attention_reference(
        qd, k_new, v_new, k_pool, v_pool, lengths, table), iters=5, flush=flush)
    # yardstick: one SDPA call over each slot's gathered pages (gather untimed)
    t_all = p * ps
    kg = k_pool[:, table.long()].permute(1, 0, 2, 3, 4).reshape(s, nkv, t_all, hd)
    vg = v_pool[:, table.long()].permute(1, 0, 2, 3, 4).reshape(s, nkv, t_all, hd)
    amask = (torch.arange(t_all, device=dev)[None, :] < (lengths + 1)[:, None])[:, None, None]
    q4 = qd[:, :, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=amask,
                                                         enable_gqa=True), flush=flush)
    del kg, vg
    rows_read = int(lengths.sum())
    nbytes = (rows_read * nkv * hd * 2 * 2 + 2 * (s * nkv * hd * 2 * 2) + 2 * s * nh * hd * 2
              + s * 4 + s * p * 4)
    flops = (rows_read + s) * nh * hd * 4
    bms, by = bound(nbytes, flops)
    log(f"K4 decode_paged_attention S={s} lengths 1..1500: err {err:.3g}  kernel {ms:.4f} ms  "
        f"plain {plain:.4f} ms  sdpa {lib:.4f} ms  bound {bms:.4f} ms ({by})  (cold L2)")
    rows.append(dict(name="decode_paged_attention", route="cuda",
                     source="prime_rl_tpu_torch/csrc/decode_attention.cu",
                     replaces="prime_rl_tpu/ops/decode_attention.py:50", max_abs_err=err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                     shape=f"S={s} PS={ps} P={p} tokens={rows_read}"))
    del k_pool, v_pool, flush
    torch.cuda.empty_cache()
    return rows


def causal_topk_indices(S: int, T: int, gen, device):
    """[S, T] int32 top-k-looking indices: token i selects min(T, i + 1)
    distinct rows of [0, i] at random; the rest of its row is the sentinel S."""
    import torch

    score = torch.rand(S, S, device=device, generator=gen)
    pos = torch.arange(S, device=device)
    score = torch.where(pos[None, :] <= pos[:, None], score, -1.0)
    val, idx = torch.sort(score, dim=-1, descending=True)
    idx = torch.where(val >= 0, idx, S)[:, :T].to(torch.int32)
    if T > S:
        idx = torch.nn.functional.pad(idx, (0, T - S), value=S)
    return idx.contiguous()


def sparse_mla_kernel_phase() -> list[dict]:
    """K5a, K5b and the dkv reduction against their plain versions on the same
    bf16 inputs: a packed row of 4096 tokens with top-k 2048 (the DSA trainer's
    shape) and a short row of 1024 tokens whose every index row holds
    sentinels, one of them nothing else."""
    import torch

    from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    H, DQ, DV, T = K.HEADS, K.DQ, K.DV, 2048
    scale = DQ ** -0.5
    # one bf16 step of the result plus the p and ds roundings that flip between
    # the kernel's exp and PyTorch's, as for K2a/K2b; dkv sums up to S rows
    tol = 2e-2
    fwd_cases, bwd_cases, red_cases = [], [], []
    for S in (4096, 1024):
        q = torch.randn(S, H, DQ, device=dev, generator=gen).to(torch.bfloat16)
        kv = torch.randn(S, DQ, device=dev, generator=gen).to(torch.bfloat16)
        do = torch.randn(S, H, DV, device=dev, generator=gen).to(torch.bfloat16)
        idx = causal_topk_indices(S, T, gen, dev)
        if S == 1024:
            idx[7] = S  # a token that selected nothing
        pairs = int((idx < S).sum())
        shape = f"S=Sk={S} T={T} pairs={pairs}"

        out, lse = K.sparse_mla_fwd(q, kv, idx, scale, DV)
        dq, dkv = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV)
        torch.cuda.synchronize()
        ref_out, ref_lse = K.sparse_mla_attention_reference(q, kv, idx, scale, DV)
        ref_dq, ref_dkv = K.sparse_mla_backward_reference(q, kv, idx, out, lse, do, scale, DV)
        err_fwd = check_close(f"sparse_mla_fwd {shape}", out, ref_out, tol, tol)
        check_close("sparse_mla_fwd lse", lse, ref_lse, 1e-3, 1e-4)
        err_bwd = max(check_close(f"sparse_mla_bwd dq {shape}", dq, ref_dq, tol, tol),
                      check_close(f"sparse_mla_bwd dkv {shape}", dkv, ref_dkv, tol, tol))
        if S == 1024 and not (bool((out[7] == 0).all()) and bool((dq[7] == 0).all())
                              and bool((lse[7] < -1e29).all())):
            raise AssertionError("sparse_mla: a token that selected nothing must give out 0, "
                                 "lse -5e29 and dq 0")
        dq2, dkv2 = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV)
        if not (torch.equal(dq, dq2) and torch.equal(dkv, dkv2)):
            raise AssertionError("sparse_mla_bwd: two runs on the same inputs differ")
        del ref_out, ref_lse, ref_dq, ref_dkv, dq2, dkv2

        ms_fwd = time_ms(lambda: K.sparse_mla_fwd(q, kv, idx, scale, DV), iters=10)
        ms_bwd = time_ms(lambda: K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV), iters=5)
        plain_fwd = time_ms(lambda: K.sparse_mla_attention_reference(q, kv, idx, scale, DV),
                            iters=3, warmup=1)
        plain_bwd = time_ms(lambda: K.sparse_mla_backward_reference(q, kv, idx, out, lse, do,
                                                                    scale, DV),
                            iters=3, warmup=1)
        # each input read once and each output written once; the operations are
        # those of the (query, selected row) pairs this run's indices hold
        small = idx.numel() * 4 + lse.numel() * 4
        b_fwd = (q.numel() + kv.numel() + out.numel()) * 2 + small
        b_bwd = (2 * q.numel() + 2 * kv.numel() + 2 * out.numel()) * 2 + small
        for cases, name, ms, plain, err, nbytes, flops in (
                (fwd_cases, "K5a sparse_mla_fwd", ms_fwd, plain_fwd, err_fwd, b_fwd,
                 2 * H * pairs * (DQ + DV)),
                (bwd_cases, "K5b sparse_mla_bwd (+ dkv reduction)", ms_bwd, plain_bwd, err_bwd,
                 b_bwd, 2 * H * pairs * (3 * DQ + 2 * DV))):
            bms, by = bound(nbytes, flops)
            cases.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain,
                              library_ms=None, bound_ms=bms, bound_by=by))
            log(f"{name} {shape}: err {err:.3g}  kernel {ms:.4f} ms  plain {plain:.4f} ms  "
                f"library none  bound {bms:.4f} ms ({by})  (tolerance {tol} + {tol} * |ref|)")

        # the reduction alone, on the last chunk of queries: K5b's dkvg rows of
        # that chunk summed per kv row, against index_add_ (one PyTorch call)
        chunk = K.bwd_chunk(S, T)
        ic = idx[S - chunk:]
        dkvg = torch.empty((chunk, T, DQ), dtype=torch.bfloat16, device=dev)
        delta = (out.float() * do.float()).sum(dim=-1)
        sl = slice(S - chunk, S)
        K.sparse_mla_bwd_chunk(q[sl], kv, ic, do[sl], lse[sl], delta[sl], torch.empty_like(q[sl]),
                               dkvg, scale, DV)
        order, seg = K.slot_order(ic, S)
        valid = (ic < S).reshape(-1)
        rows_f32 = dkvg.reshape(-1, DQ)[valid].float()
        where = ic.reshape(-1)[valid].long()
        acc = torch.zeros((S, DQ), dtype=torch.float32, device=dev)
        K.sparse_mla_dkv_reduce(dkvg, order, seg, acc)
        want = torch.zeros_like(acc).index_add_(0, where, rows_f32)
        # f32 sums of the same bf16 rows in another order
        err_red = check_close(f"sparse_mla_dkv_reduce {shape}", acc, want, 1e-3, 1e-4)
        ms_red = time_ms(lambda: K.sparse_mla_dkv_reduce(dkvg, order, seg, acc), iters=10)
        plain_red = time_ms(lambda: torch.zeros_like(acc).index_add_(
            0, ic.reshape(-1)[valid].long(), dkvg.reshape(-1, DQ)[valid].float()), iters=5)
        lib_red = time_ms(lambda: acc.index_add_(0, where, rows_f32), iters=10)
        n_valid = int(valid.sum())
        bms, by = bound(n_valid * (DQ * 2 + 8) + (S + 1) * 4 + 2 * acc.numel() * 4, n_valid * DQ)
        red_cases.append(dict(shape=f"{shape} chunk={chunk} slots={n_valid}", max_abs_err=err_red,
                              ms=ms_red, plain_ms=plain_red, library_ms=lib_red, bound_ms=bms,
                              bound_by=by))
        log(f"sparse_mla_dkv_reduce {shape} (one chunk of {chunk} queries, {n_valid} slots): "
            f"err {err_red:.3g}  kernel {ms_red:.4f} ms  plain {plain_red:.4f} ms  "
            f"index_add_ {lib_red:.4f} ms  bound {bms:.4f} ms ({by})")
        del q, kv, do, idx, out, lse, dq, dkv, dkvg, acc, want, rows_f32, where, order, seg, delta
        torch.cuda.empty_cache()
    rows = []
    for name, cases, line in (("sparse_mla_fwd", fwd_cases, 67), ("sparse_mla_bwd", bwd_cases, 153),
                              ("sparse_mla_dkv_reduce", red_cases, 308)):
        rows.append(dict(name=name, route="cuda", source="prime_rl_tpu_torch/csrc/sparse_mla.cu",
                         replaces=f"prime_rl_tpu/ops/sparse_mla_pallas.py:{line}",
                         **{k: cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "library_ms")},
                         max_abs_err=max(c["max_abs_err"] for c in cases), cases=cases))
    return rows


def train_reference_phase() -> None:
    """Loss and every gradient of one micro-batch [2, 512] of the full-width
    model cut to 2 layers (full vocabulary): bf16 through the kernels on the
    card against the plain float32 path on the CPU, from the same weights."""
    import torch

    from prime_rl_tpu_torch.configs.shared import ModelConfig
    from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import init_params
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_map, tree_paths
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import MicroBatchArrays, Scales, make_loss_fn, put_batch

    spec = get_spec(MODEL, num_layers=2)
    gen = torch.Generator().manual_seed(SEED)
    # bf16-representable weights, so both sides start from the same numbers
    master = tree_map(lambda x: x.to(torch.bfloat16), init_params(spec, gen))
    batch, counts = FakeDataLoader(spec.vocab_size, 512, 2, 1, seed=SEED).next_batch()
    scales = Scales(float(counts["rl"]), 1.0, 1.0)

    def run(device, dtype, compute):
        params = tree_map(lambda x: x.to(device=device, dtype=dtype).requires_grad_(), master)
        mb = MicroBatchArrays(*[None if x is None else x[0] for x in put_batch(batch, device)])
        loss_fn = make_loss_fn(spec, ModelConfig(compute_dtype=compute), DefaultLossConfig())
        loss, _ = loss_fn(params, mb, scales)
        loss.backward()
        return float(loss.detach()), {p: x.grad.float().cpu() for p, x in tree_paths(params)}

    before = dict(_build.launches)
    loss_gpu, grads_gpu = run(torch.device("cuda"), torch.bfloat16, "bfloat16")
    torch.cuda.synchronize()
    for name in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        if _build.launches[name] <= before.get(name, 0):
            raise AssertionError(f"train-reference: {name} was not launched on the card")
    loss_cpu, grads_cpu = run(torch.device("cpu"), torch.float32, "float32")
    # bf16 weights, activations and gradients through 2 layers and a 151936-wide
    # head against float32: a few bf16 steps (2^-8) on the loss, and per tensor
    # a gradient error of a few percent of the gradient's norm
    loss_rtol, grad_rtol = 2e-2, 5e-2
    if not abs(loss_gpu - loss_cpu) <= loss_rtol * abs(loss_cpu):
        raise AssertionError(f"train-reference loss {loss_gpu} vs float32 {loss_cpu}")
    worst = 0.0
    for path, want in grads_cpu.items():
        got = grads_gpu[path]
        rel = float((got - want).norm() / want.norm().clamp_min(1e-30))
        worst = max(worst, rel)
        if not (bool(torch.isfinite(got).all()) and rel <= grad_rtol):
            raise AssertionError(f"train-reference gradient of {path}: relative error {rel:.4g} "
                                 f"exceeds {grad_rtol}")
    log(f"train-reference: loss {loss_gpu:.6g} vs float32 {loss_cpu:.6g} (tolerance {loss_rtol} "
        f"relative); worst gradient error {worst:.4g} of its norm over {len(grads_cpu)} tensors "
        f"(tolerance {grad_rtol})")


def training_phase() -> tuple[dict, dict]:
    """The port's trainer through its normal entry, twice from the same seed.
    Returns (launches of the first run, its last metrics record)."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_leaves, tree_paths
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.trainer.step import init_train_state
    from prime_rl_tpu_torch.utils.pathing import is_stable, weights_dir

    steps, n_mb, rows, seq_len = 4, 4, 8, 512

    def config(out: str) -> TrainerConfig:
        return TrainerConfig(
            device="cuda", seed=SEED, max_steps=steps, grad_clip=1.0, output_dir=out,
            model={"name": MODEL, "seq_len": seq_len, "debug": {"random_init": True}},
            optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"},
            data={"type": "fake", "seq_len": seq_len, "micro_batch_size": rows,
                  "num_micro_batches": n_mb, "seed": SEED},
            batch={"seq_len": seq_len, "micro_batch_size": rows, "num_micro_batches": n_mb},
        )

    spec = get_spec(MODEL)
    if spec.num_layers != 28 or spec.vocab_size != 151936 or spec.hidden_size != 1024:
        raise AssertionError("the trained model must be Qwen3-0.6B at full width and depth")
    outs = [os.path.join(ROOT, "build", "chip_smoke", f"train_{i}") for i in range(2)]
    runs = []
    for i, out in enumerate(outs):
        shutil.rmtree(out, ignore_errors=True)
        cfg = config(out)
        _build.reset_launches()
        t0 = time.perf_counter()
        result = train(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs.append((result, dict(_build.launches)))
        log(f"training run {i}: {steps} steps in {wall:.2f} s, losses "
            f"{[r['loss'] for r in result.records]}")
    (result, launches), (again, _) = runs
    records = result.records
    if len(records) != steps:
        raise AssertionError(f"expected {steps} steps, got {len(records)}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0 and math.isfinite(r["entropy"])):
            raise AssertionError(f"bad step record {r}")
    if [r["loss"] for r in records] != [r["loss"] for r in again.records]:
        raise AssertionError("two runs from the same seed gave different losses")
    per_pass = spec.num_layers * n_mb * steps
    remat = config(outs[0]).model.ac.mode
    want = {"flash_attn_fwd": per_pass * (2 if remat == "full" else 1),
            "flash_attn_bwd_dq": per_pass, "flash_attn_bwd_dkv": per_pass}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches on the training "
                                 f"path, expected {n} (ac.mode {remat})")
    # parameters changed: against the initial state rebuilt from the same seed
    cfg = config(outs[0])
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    init = init_train_state(spec, "cuda", optimizer, seed=SEED, master_dtype="bfloat16")
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(tree_leaves(init.params), tree_leaves(result.state.params)))
    del init
    if changed < len(tree_leaves(result.state.params)) // 2:
        raise AssertionError(f"only {changed} parameter tensors changed in {steps} steps")
    snap = weights_dir(outs[0], steps)
    if not is_stable(snap):
        raise AssertionError(f"no STABLE v{steps} snapshot at {snap}")
    loaded = dict(tree_paths(load_hf_weights(snap, spec, dtype=torch.bfloat16, device="cuda")))
    for path, want_t in tree_paths(result.state.params):
        if not torch.equal(loaded[path], want_t):
            raise AssertionError(f"v{steps} snapshot: {path} differs from the state's parameters")
    last = records[-1]
    log(f"training: {steps} steps of {n_mb} x [{rows}, {seq_len}] tokens; last step "
        f"{last['step_time_s']:.3f} s, {n_mb * rows * seq_len / last['step_time_s']:.0f} tokens/s, "
        f"MFU {spec.flops_per_token(seq_len) * n_mb * rows * seq_len / last['step_time_s'] / PEAK_BF16:.4f} "
        f"of {PEAK_BF16 / 1e12:.0f} TFLOP/s; {changed} parameter tensors changed; the v{steps} "
        f"snapshot reads back equal; launches {launches}")
    for out in outs:
        shutil.rmtree(out, ignore_errors=True)
    del runs, result, again, loaded
    torch.cuda.empty_cache()
    return launches, last


def glm5_model_dir(name: str, **cuts) -> str:
    """A directory whose config.json names GlmMoeDsaForCausalLM at GLM-5's
    widths with ``cuts`` applied: how this family is given to the trainer."""
    path = os.path.join(ROOT, "build", "chip_smoke", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({**GLM5_CONFIG, **cuts}, f, indent=1)
    for key, value in cuts.items():
        log(f"{name}: {key} cut from {GLM5_CONFIG.get(key)} to {value}")
    return path


@contextlib.contextmanager
def indexer_selections(record: list | None = None, replay: list | None = None):
    """Within the block, every ``mla_topk_indices`` call appends its result to
    ``record``, or returns the next of ``replay`` (moved to its inputs' device)
    without computing a selection of its own."""
    from prime_rl_tpu_torch.ops import sparse_mla

    own = sparse_mla.mla_topk_indices
    todo = iter(replay or ())

    def wrapped(q_idx, *args, **kw):
        if replay is not None:
            return next(todo).to(q_idx.device)
        out = own(q_idx, *args, **kw)
        if record is not None:
            record.append(out)
        return out

    sparse_mla.mla_topk_indices = wrapped
    try:
        yield
    finally:
        sparse_mla.mla_topk_indices = own


def dsa_train_reference_phase() -> None:
    """Loss and every gradient of one row of 1024 tokens through the
    glm_moe_dsa model at GLM-5's widths, cut to 1 dense + 1 MoE layer of 8
    experts with top-k 256 (so that the selection restricts): bf16 through
    K5a/K5b on the card, under full remat, against float32 on the CPU through
    the chunked-gather op and PyTorch's autograd, from the same weights.

    The top-k is a discrete choice: scored from bf16 activations on the card
    and from float32 ones on the CPU, a few percent of the selected rows differ,
    and the two runs then differentiate two different functions (gradients up
    to 30% apart, while with equal selections every tensor agrees within 2%).
    So the CPU run is made twice: once with its own selections, to report how
    far the card's agree with them (at least 90% of each layer's selected rows
    must be the same), and once replaying the card's, which is the run the
    loss and the gradients are held against."""
    import torch

    from prime_rl_tpu_torch.configs.shared import ModelConfig
    from prime_rl_tpu_torch.configs.trainer import DefaultLossConfig
    from prime_rl_tpu_torch.models import get_family
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.trainer.optim import tree_map, tree_paths
    from prime_rl_tpu_torch.trainer.rl.data import FakeDataLoader
    from prime_rl_tpu_torch.trainer.step import MicroBatchArrays, Scales, make_loss_fn, put_batch

    seq_len = 1024
    spec = get_spec(glm5_model_dir("glm5_reference", num_hidden_layers=2, first_k_dense_replace=1,
                                   n_routed_experts=8, index_topk=256))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # bf16-representable weights, so both sides start from the same numbers
    master = tree_map(lambda x: x.to(torch.bfloat16),
                      get_family(spec).init(spec, gen, device="cuda"))
    batch, counts = FakeDataLoader(spec.vocab_size, seq_len, 1, 1, seed=SEED).next_batch()
    scales = Scales(float(counts["rl"]), 1.0, 1.0)

    def run(device, dtype, compute, remat, backward=True):
        params = tree_map(lambda x: x.detach().to(device=device, dtype=dtype).requires_grad_(),
                          master)
        mb = MicroBatchArrays(*[None if x is None else x[0] for x in put_batch(batch, device)])
        cfg = ModelConfig(compute_dtype=compute, ac={"mode": remat})
        loss_fn = make_loss_fn(spec, cfg, DefaultLossConfig())
        if not backward:
            with torch.no_grad():
                return float(loss_fn(params, mb, scales)[0]), None
        loss, _ = loss_fn(params, mb, scales)
        loss.backward()
        grads = {p: (None if x.grad is None else x.grad.float().cpu())
                 for p, x in tree_paths(params)}
        return float(loss.detach()), grads

    before = dict(_build.launches)
    t0 = time.perf_counter()
    on_card: list = []
    with indexer_selections(record=on_card):
        loss_gpu, grads_gpu = run(torch.device("cuda"), torch.bfloat16, "bfloat16", "full")
    torch.cuda.synchronize()
    for name in ("sparse_mla_fwd", "sparse_mla_bwd", "sparse_mla_dkv_reduce"):
        if _build.launches[name] <= before.get(name, 0):
            raise AssertionError(f"dsa-train-reference: {name} was not launched on the card")
    # the forward's calls come first, one a layer; the recompute's follow
    on_card = [idx.cpu() for idx in on_card[:spec.num_layers]]
    t1 = time.perf_counter()
    own: list = []
    with indexer_selections(record=own):
        loss_own, _ = run(torch.device("cpu"), torch.float32, "float32", "none", backward=False)
    overlaps = []
    for a, b in zip(on_card, own):
        # every 16th token's selected set (the sentinel counts as one member)
        pairs = [(set(x), set(y)) for x, y in zip(a[::16].tolist(), b[::16].tolist())]
        overlaps.append(sum(len(x & y) for x, y in pairs) / sum(len(x) for x, _ in pairs))
    if min(overlaps) < 0.9:
        raise AssertionError(f"dsa-train-reference: the card's selections share only {overlaps} "
                             "of their rows with the float32 indexer's")
    with indexer_selections(replay=on_card):
        loss_cpu, grads_cpu = run(torch.device("cpu"), torch.float32, "float32", "none")
    t2 = time.perf_counter()
    del master
    torch.cuda.empty_cache()
    # bf16 weights, activations and gradients through 2 layers and a 154880-wide
    # head against float32, on the same selections: a few bf16 steps (2^-8) on
    # the loss, and per tensor a gradient error of a few percent of its norm
    loss_rtol, grad_rtol = 2e-2, 5e-2
    for what, ref in (("the card's selections", loss_cpu), ("its own selections", loss_own)):
        if not abs(loss_gpu - ref) <= loss_rtol * abs(ref):
            raise AssertionError(f"dsa-train-reference loss {loss_gpu} vs float32 {ref} on {what}")
    worst, n = 0.0, 0
    for path, want in grads_cpu.items():
        got = grads_gpu[path]
        if want is None or got is None or float(want.norm()) == 0.0:
            # the indexer and the selection bias: no gradient on either side
            if not ((want is None or float(want.norm()) == 0.0)
                    and (got is None or float(got.norm()) == 0.0)):
                raise AssertionError(f"dsa-train-reference: {path} has a gradient on one side only")
            continue
        rel = float((got - want).norm() / want.norm())
        worst, n = max(worst, rel), n + 1
        if not (bool(torch.isfinite(got).all()) and rel <= grad_rtol):
            raise AssertionError(f"dsa-train-reference gradient of {path}: relative error "
                                 f"{rel:.4g} exceeds {grad_rtol}")
    log(f"dsa-train-reference: loss {loss_gpu:.6g} vs float32 {loss_cpu:.6g} on the card's "
        f"selections and {loss_own:.6g} on its own (tolerance {loss_rtol} relative); the "
        f"selections share {[round(o, 4) for o in overlaps]} of their rows per layer; worst "
        f"gradient error {worst:.4g} of its norm over {n} tensors (tolerance {grad_rtol}); "
        f"card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s")


def dsa_training_phase() -> tuple[dict, dict]:
    """The trainer through its normal entry on a GlmMoeDsaForCausalLM directory
    at GLM-5's widths, twice from the same seed. Returns (launches of the first
    run, numbers of its last step). The run is in bench mode, which publishes
    the initial weights only: at this size a snapshot per step is 9 GB through
    the host (the Qwen3 phase covers publishing every step); one snapshot is
    written and read back here."""
    import torch

    from prime_rl_tpu_torch.configs import TrainerConfig
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import load_hf_weights
    from prime_rl_tpu_torch.ops import _build, moe
    from prime_rl_tpu_torch.ops.sparse_mla_kernel import bwd_launches
    from prime_rl_tpu_torch.trainer.optim import make_optimizer, tree_leaves, tree_paths
    from prime_rl_tpu_torch.trainer.rl.train import train
    from prime_rl_tpu_torch.trainer.step import init_train_state
    from prime_rl_tpu_torch.trainer.weights import save_hf_weights

    steps, n_mb, rows, seq_len = 3, 2, 1, 4096
    model_dir = glm5_model_dir("glm5_model", **GLM5_CUTS)

    def config(out: str) -> TrainerConfig:
        return TrainerConfig(
            device="cuda", seed=SEED, max_steps=steps, grad_clip=1.0, output_dir=out,
            model={"name": model_dir, "seq_len": seq_len, "debug": {"random_init": True}},
            optimizer={"type": "adamw_8bit", "lr": 1e-5, "master_dtype": "bfloat16"},
            data={"type": "fake", "seq_len": seq_len, "micro_batch_size": rows,
                  "num_micro_batches": n_mb, "seed": SEED},
            batch={"seq_len": seq_len, "micro_batch_size": rows, "num_micro_batches": n_mb},
            bench={"warmup_steps": 0, "steps": steps},
        )

    spec = get_spec(model_dir)
    if (spec.family, spec.hidden_size, spec.num_heads, spec.kv_lora_rank, spec.index_topk,
            spec.vocab_size) != ("glm_moe_dsa", 6144, 64, 512, 2048, 154880):
        raise AssertionError("the trained model must be glm_moe_dsa at GLM-5's widths")
    log(f"dsa-training: {spec.num_layers} layers ({spec.first_k_dense_replace} dense), "
        f"{spec.num_experts} routed experts")
    outs = [os.path.join(ROOT, "build", "chip_smoke", f"dsa_train_{i}") for i in range(2)]
    runs = []
    for i, out in enumerate(outs):
        shutil.rmtree(out, ignore_errors=True)
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = train(config(out))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        # only the last run's state is kept: two states do not fit beside a step
        runs.append((result.records, dict(_build.launches), peak))
        state = result.state if i == len(outs) - 1 else None
        del result
        torch.cuda.empty_cache()
        shutil.rmtree(out, ignore_errors=True)
        log(f"dsa-training run {i}: {steps} steps in {wall:.2f} s (initial publish included), "
            f"peak device memory {peak:.2f} GiB, losses {[r['loss'] for r in runs[-1][0]]}, "
            f"step times {[round(r['step_time_s'], 3) for r in runs[-1][0]]}")
    (records, launches, peak), (records_again, _, _) = runs
    losses = [r["loss"] for r in records]
    if len(records) != steps:
        raise AssertionError(f"expected {steps} steps, got {len(records)}")
    for r in records:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0 and math.isfinite(r["entropy"])):
            raise AssertionError(f"bad step record {r}")
    if len(set(losses)) != steps:
        raise AssertionError(f"the losses do not change from step to step: {losses}")
    if losses != [r["loss"] for r in records_again]:
        raise AssertionError(f"two runs from the same seed gave different losses: {losses} and "
                             f"{[r['loss'] for r in records_again]}")
    per_pass = spec.num_layers * n_mb * rows * steps
    remat = config(outs[0]).model.ac.mode
    chunks = bwd_launches(seq_len, spec.index_topk)
    want = {"sparse_mla_fwd": per_pass * (2 if remat == "full" else 1),
            "sparse_mla_bwd": per_pass * chunks, "sparse_mla_dkv_reduce": per_pass * chunks}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            raise AssertionError(f"{name}: {launches.get(name, 0)} launches on the DSA training "
                                 f"path, expected {n} (ac.mode {remat}, {chunks} chunks a call)")
    cfg = config(outs[0])
    optimizer, _ = make_optimizer(cfg.optimizer, cfg.scheduler, cfg.grad_clip)
    init = init_train_state(spec, "cuda", optimizer, seed=SEED, master_dtype="bfloat16")
    changed = sum(not torch.equal(a, b) for a, b in
                  zip(tree_leaves(init.params), tree_leaves(state.params)))
    del init
    torch.cuda.empty_cache()
    if changed < len(tree_leaves(state.params)) // 2:
        raise AssertionError(f"only {changed} parameter tensors changed in {steps} steps")
    snap = os.path.join(ROOT, "build", "chip_smoke", "dsa_snapshot")
    shutil.rmtree(snap, ignore_errors=True)
    t0 = time.perf_counter()
    save_hf_weights(state.params, spec, snap)
    t_save = time.perf_counter() - t0
    if get_spec(snap) != spec:
        raise AssertionError("the snapshot's config.json does not read back as the trained spec")
    loaded = dict(tree_paths(load_hf_weights(snap, spec, dtype=torch.bfloat16, device="cuda")))
    for path, want_t in tree_paths(state.params):
        if not torch.equal(loaded[path].float(), want_t.float()):
            raise AssertionError(f"snapshot: {path} differs from the state's parameters")
    shutil.rmtree(snap, ignore_errors=True)
    last = records[-1]
    tokens = n_mb * rows * seq_len
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    numbers = dict(step_time_s=last["step_time_s"], tokens_per_s=tokens / last["step_time_s"],
                   peak_gib=peak, parameters=n_params, grouped_product=moe.grouped_product_impl(
                       tree_leaves(state.params)[0]))
    log(f"dsa-training: {n_params / 1e9:.3f} G parameters; {steps} steps of {n_mb} x [{rows}, "
        f"{seq_len}] tokens; last step "
        f"{last['step_time_s']:.3f} s, {numbers['tokens_per_s']:.0f} tokens/s, peak device memory "
        f"{peak:.2f} GiB; {changed} parameter tensors changed; the snapshot ({t_save:.1f} s to "
        f"write) reads back equal through get_spec and from_hf; expert products by "
        f"{numbers['grouped_product']}; launches {launches}")
    del state, loaded
    torch.cuda.empty_cache()
    return launches, numbers


def reference_phase(engine) -> None:
    """The served weights' prefill and one decode step through the kernels
    (bf16, CUDA) against the plain float32 path on the CPU."""
    import torch

    from prime_rl_tpu_torch.sampler import model as smodel

    spec = engine.spec
    dev = engine.device
    ps, lpad, n = 64, 64, 37
    rng = torch.Generator().manual_seed(SEED)
    ids = torch.zeros(1, lpad, dtype=torch.int64)
    ids[0, :n] = torch.randint(1, spec.vocab_size, (n,), generator=rng)
    table = torch.zeros(1, 2, dtype=torch.int32)
    table[0] = torch.tensor([1, 2])
    shape = (spec.num_kv_heads, 3, ps, spec.head_dim)

    def run(params, device, dtype):
        kp = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(spec.num_layers)]
        vp = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(spec.num_layers)]
        _, _, h, _ = smodel.prefill(params, spec, kp, vp, ids.to(device), n,
                                    table[0, :1].to(device), compute_dtype=dtype)
        first = smodel.logits_from_hidden(params, spec, h[None], dtype)
        tok = torch.tensor([int(ids[0, n - 1])], device=device)
        _, _, second = smodel.decode(params, spec, kp, vp, tok, torch.tensor(
            [n], dtype=torch.int32, device=device), table.to(device), compute_dtype=dtype)
        return first.float().cpu(), second.float().cpu()

    got = run(engine.params, dev, torch.bfloat16)
    cpu_params = {k: v for k, v in engine.params.items() if k != "layers"}
    cpu_params = {k: v.float().cpu() for k, v in cpu_params.items()}
    cpu_params["layers"] = [{k: v.float().cpu() for k, v in lp.items()}
                            for lp in engine.params["layers"]]
    want = run(cpu_params, torch.device("cpu"), torch.float32)
    for name, g, w in zip(("prefill", "decode"), got, want):
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        # bf16 activations through 28 layers against float32: the logits may
        # drift by a few bf16 ulps of the largest logit
        if not (err <= 0.05 * scale and bool(torch.isfinite(g).all())):
            raise AssertionError(f"served {name} logits differ from the float32 reference: "
                                 f"max err {err:.4g} vs max |logit| {scale:.4g}")
        log(f"reference {name} logits: max err {err:.4g} (max |logit| {scale:.4g})")


async def serving_phase(server, port: int) -> dict:
    import aiohttp
    import numpy as np

    base = f"http://127.0.0.1:{port}"
    spec = server.engine.spec
    rng = np.random.default_rng(SEED)
    prefix = rng.integers(0, spec.vocab_size, 128).tolist()
    lengths = [20, 45, 64, 90, 200, 300, 400, 512, 640, 800, 1000, 1200, 1400, 1500]
    prompts = [rng.integers(0, spec.vocab_size, n).tolist() for n in lengths]
    prompts += [prefix + rng.integers(0, spec.vocab_size, n).tolist() for n in (40, 70)]
    samplings = [dict(temperature=1.0), dict(temperature=0.8, top_p=0.9),
                 dict(temperature=1.0, top_k=20), dict(temperature=0.0)]
    max_tokens = 64
    stop_ids = {spec.eos_token_id}

    def check(result: dict, what: str) -> int:
        c = result["choices"][0]
        toks, lps = c["token_ids"], c["logprobs"]
        if c["finish_reason"] == "length":
            ok = len(toks) == max_tokens
        else:
            ok = c["finish_reason"] == "stop" and toks and toks[-1] in stop_ids
        if not ok or len(lps) != len(toks) or not np.all(np.isfinite(lps)):
            raise AssertionError(f"{what}: bad result {c['finish_reason']} {len(toks)} tokens")
        return len(toks)

    out = {}
    async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as http:
        async def generate(prompt, sampling):
            t0 = time.perf_counter()
            r = await http.post(f"{base}/inference/v1/generate", json={
                "token_ids": prompt, "sampling_params": {"max_tokens": max_tokens, **sampling}})
            if r.status != 200:
                raise AssertionError(f"generate: HTTP {r.status}: {await r.text()}")
            return await r.json(), time.perf_counter() - t0

        t0 = time.perf_counter()
        results = await asyncio.gather(*(generate(p, samplings[i % len(samplings)])
                                         for i, p in enumerate(prompts)))
        wall = time.perf_counter() - t0
        n_tokens = sum(check(r, f"generate #{i}") for i, (r, _) in enumerate(results))
        out["generate_requests"] = len(prompts)
        out["generate_tokens"] = n_tokens
        out["generate_wall_s"] = wall
        out["generate_tokens_per_s"] = n_tokens / wall
        out["request_latency_s_mean"] = sum(t for _, t in results) / len(results)
        log(f"serving: {len(prompts)} concurrent generate requests, {n_tokens} tokens in "
            f"{wall:.3f} s -> {n_tokens / wall:.1f} tokens/s")

        r = await http.post(f"{base}/v1/completions",
                            json={"prompt": "The quick brown fox", "max_tokens": 16})
        body = await r.json()
        if r.status != 200 or body["choices"][0]["finish_reason"] not in ("stop", "length"):
            raise AssertionError(f"completions: HTTP {r.status}: {body}")

        t0 = time.perf_counter()
        ttft = None
        async with http.post(f"{base}/v1/chat/completions", json={
                "model": MODEL, "messages": [{"role": "user", "content": "hi there"}],
                "max_tokens": 32, "temperature": 0.7, "stream": True}) as r:
            if r.status != 200:
                raise AssertionError(f"chat stream: HTTP {r.status}")
            events = []
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                events.append(line[6:])
                if ttft is None and '"content"' in line:
                    ttft = time.perf_counter() - t0
        if events[-1] != "[DONE]" or json.loads(events[-2])["choices"][0]["finish_reason"] not in (
                "stop", "length"):
            raise AssertionError("chat stream: missing [DONE] or finish reason")
        out["chat_stream_ttft_s"] = ttft
        log(f"serving: streaming chat, time to first token {ttft}")

        # greedy determinism: the same prompt twice, concurrently
        greedy = dict(temperature=0.0)
        a, b = await asyncio.gather(generate(prompts[3], greedy), generate(prompts[3], greedy))
        for r in (a[0], b[0]):
            check(r, "greedy")
        if a[0]["choices"][0]["token_ids"] != b[0]["choices"][0]["token_ids"]:
            raise AssertionError("greedy requests for the same prompt differ")
        # a prompt sharing the 128-token prefix with finished requests: the
        # prefix cache serves its first pages, the rest prefills in chunks
        cached0 = server.engine.stats["prefill_tokens_cached"]
        r, _ = await generate(prefix + [5, 6, 7], dict(temperature=0.0))
        check(r, "prefix hit")
        if server.engine.stats["prefill_tokens_cached"] <= cached0:
            raise AssertionError("the shared prefix was not served from the prefix cache")
    return out


def main() -> int:
    # the DSA trainer's state comes within a few GiB of the card's memory: keep
    # the caching allocator from stranding it in fragments (read at its first use)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    from prime_rl_tpu_torch.configs import InferenceConfig
    from prime_rl_tpu_torch.entrypoints.inference import build_server
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")

    spec = get_spec(MODEL)
    rows = kernel_phase(spec) + sparse_mla_kernel_phase()
    train_reference_phase()
    train_launches, _ = training_phase()
    dsa_train_reference_phase()
    dsa_launches, _ = dsa_training_phase()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    config = InferenceConfig(
        device="cuda", seed=SEED, max_model_len=4096,
        output_dir=os.path.join(ROOT, "build", "chip_smoke"),
        model={"name": MODEL, "debug": {"random_init": True}},
        tokenizer={"name": "byte"}, scheduler={"max_batch_size": 64},
    )
    t0 = time.perf_counter()
    server = build_server(config)
    engine = server.engine
    log(f"server built in {time.perf_counter() - t0:.2f} s: {spec.num_layers} layers, vocab "
        f"{spec.vocab_size}, {engine.config.num_pages} KV pages of {engine.config.page_size}")
    if spec.num_layers != 28 or engine.spec.vocab_size != 151936:
        raise AssertionError("the served model must be Qwen3-0.6B at full width and depth")
    reference_phase(engine)
    engine.warmup(4)

    async def drive():
        runner = await server.start_async("127.0.0.1", port)
        try:
            _build.reset_launches()
            stats = await serving_phase(server, port)
            launches = dict(_build.launches)
        finally:
            await server.stop_async(runner)
        return stats, launches

    stats, launches = asyncio.run(drive())
    for row in rows:
        name = row["name"]
        on_serving, on_training = launches.get(name, 0), train_launches.get(name, 0)
        if name == "flash_attn_fwd":  # K1 runs on both paths
            row["launches"], row["launches_training"] = on_serving, on_training
            if min(on_serving, on_training) <= 0:
                raise AssertionError("kernel flash_attn_fwd was not launched on both paths")
        elif name.startswith("sparse_mla"):
            row["launches"] = dsa_launches.get(name, 0)
        else:
            row["launches"] = on_serving + on_training
        if row["launches"] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the path that runs it")
    log(f"launches on the serving path: {launches}")
    log(f"launches on the training path: {train_launches}")
    log(f"launches on the DSA training path: {dsa_launches}")
    log(f"serving stats: {json.dumps(stats)}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
