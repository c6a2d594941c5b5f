#!/usr/bin/env python3
"""Microbenchmark of the sparse-MLA kernels (K5a forward, K5b backward and the
dkv reduction) of the PyTorch/CUDA port on one NVIDIA GPU: the counterpart of
``scripts/bench_sparse_mla.py``.

    python3 scripts/torch_sparse_mla_bench.py [--S 4096] [--topk 2048] [--ptxas] [--quick]

Builds ``prime_rl_tpu_torch/csrc/sparse_mla.cu`` and prints the build report
of K5a and K5b (registers, local memory, shared memory, blocks an SM), holds
both kernels against their plain PyTorch versions on the same bf16 inputs at
short shapes with sentinels and on ``chip_smoke.K5B_EDGE_CASES`` (tolerance
2e-2 absolute + 2e-2 relative, lse within 1e-3, two calls of each bit-equal,
the kernels' tile counts against ``sparse_mla_bwd_tiles_visited``);
``--quick`` stops there. Then it times them at ``S = Sk = --S`` with causal
top-k-looking indices (token i selects min(topk, i + 1) of [0, i]) by CUDA
events: K5a alone with the L2 flushed (256 MB zeroed) before each call, the
whole backward call (K5b and the reductions, chunk by chunk) as
``chip_smoke.py`` times it, then with the L2 flushed, and K5b's own launches
over the call's chunks apart from the reductions, and the reductions alone,
both with the L2 flushed. ``--ptxas`` also prints the registers, shared memory
and spills that ``nvcc -Xptxas -v`` reports for each kernel of the source.
``--variants NAME:FLAG,...`` rebuilds with other ``-D`` flags, holds K5a's
output against the port's build and times K5a and K5b's launches beside the
port's build, in turn: ``K5A_GATHER_ONLY`` (K5a gathers its tiles and runs no
products: a wrong output, timed for the L2 gather floor) and
``K5B_NO_STORES`` (no dkvg row stores: a wrong dkv).
``--timeline`` rebuilds with ``-DSPARSE_MLA_TIMELINE`` (into
``build/k5b_variants/``) and prints, for each warpgroup, the clocks a tile of
each phase of K5a and of K5b, averaged over the blocks, from one call of K5a
and one pass of K5b's launches.
``--grouped-mm`` checks ``torch._grouped_mm`` (forward and backward) against a
loop over experts, which is how ``ops/moe.py`` chooses its expert product.
``--wide`` runs the wide forms (Dq 1152 / v_dim 1024) in place of the above:
the build report, ``chip_smoke.K5_WIDE_CASES`` through both kernels
(``--quick`` stops there), then ``chip_smoke.k5_wide_timing`` at S = Sk =
2048, T = 512 (a causal top-k), 16 heads: K5a, the whole K5b call beside its
plain version and one SDPA backward, and K5b's own launches with the L2
flushed, its tiles and its build figures. With ``--timeline`` it also prints
the wide K5b's phase clocks a tile from a ``-DSPARSE_MLA_TIMELINE`` build;
with ``--variants`` it times the wide K5b's own launches of each variant
build beside the port's, in turns (``nostores:-DK5W_NO_STORES``: no dkvg
stores, a wrong dkv); ``--seeds N`` runs the wide cases (and
``WIDE_SEED_CASES``) over generator seeds 1 .. N and counts the (case, seed)
pairs that miss K5B_TOL (a token that selected one row broke bf16 ties of its
dkv row before both K5b forms and the plain version stored its ds as the
exact 0: the note in ``csrc/sparse_mla.cu``), then the narrow K5b's
``chip_smoke.K5B_EDGE_CASES`` and ``K5_HEAD_CASES`` over the same seeds.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

import chip_smoke
from prime_rl_tpu_torch.ops import _build
from prime_rl_tpu_torch.ops import sparse_mla_kernel as K

H, DQ, DV = K.HEADS, K.DQ, K.DV


def causal_indices(S: int, T: int, gen, device) -> torch.Tensor:
    """[S, T] int32: token i selects min(T, i + 1) distinct rows of [0, i] at
    random, the rest of its row is the sentinel S."""
    score = torch.rand(S, S, device=device, generator=gen)
    pos = torch.arange(S, device=device)
    score = torch.where(pos[None, :] <= pos[:, None], score, -1.0)
    val, idx = torch.sort(score, dim=-1, descending=True)
    return torch.where(val[:, :T] >= 0, idx[:, :T], S).to(torch.int32)


def time_ms(fn, iters=5, warmup=1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2]


def close(name, got, ref, tol=2e-2):
    got, ref = got.detach().float(), ref.detach().float()
    err = (got - ref).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * ref.abs()).all())
    print(f"{name}: max abs err {float(err.max()):.4g} (max |ref| {float(ref.abs().max()):.4g}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    return ok


def check(S: int, T: int, gen, dev) -> bool:
    q = torch.randn(S, H, DQ, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(S, DQ, device=dev, generator=gen).to(torch.bfloat16)
    do = torch.randn(S, H, DV, device=dev, generator=gen).to(torch.bfloat16)
    idx = causal_indices(S, T, gen, dev)
    idx[5] = S  # one token that selected nothing
    scale = DQ ** -0.5
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, DV)
    dq, dkv = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV)
    torch.cuda.synchronize()
    r_out, r_lse = K.sparse_mla_attention_reference(q, kv, idx, scale, DV)
    r_dq, r_dkv = K.sparse_mla_backward_reference(q, kv, idx, r_out, r_lse, do, scale, DV)
    ok = close(f"fwd out S={S} T={T}", out, r_out)
    ok &= close("fwd lse", lse, r_lse, tol=1e-3)
    ok &= close("bwd dq", dq, r_dq)
    ok &= close("bwd dkv", dkv, r_dkv)
    ok &= bool((out[5] == 0).all()) and bool((dq[5] == 0).all())
    dq2, dkv2 = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV)
    same = torch.equal(dq, dq2) and torch.equal(dkv, dkv2)
    print(f"all-sentinel token gives 0: {bool((out[5] == 0).all())}; two backward runs "
          f"bit-equal: {same}", flush=True)
    return ok and same


K5A_PHASES = ("token start: barrier (the last token's end)", "token start: index row scanned",
              "token start: q and the first rows landed", "s product (0)",
              "softmax, p stored; gather issued (1); barrier", "o rescaled, p v product",
              "tile end: next rows landed, barrier", "token end: sums, lse, o stored")

PHASES = ("token start: barrier (the last token's end)", "token start: index row scanned",
          "token start: panels landed", "token start: first tile landed",
          "phase 1: s (0), dkvg rows out (1), dp (2)", "phase 1: hand-offs, p and ds",
          "phase 2: next tile gathered (1), dq product", "phase 2: dkvg products, stmatrix",
          "tile end: next rows landed, barrier", "tile end: next tile found",
          "token end: last dkvg rows, dq")


def build_variant(name: str, flags: tuple = ()) -> ctypes.CDLL:
    """``csrc/sparse_mla.cu`` compiled as the port compiles it, with ``flags``,
    into build/k5b_variants/; prints its registers and spills."""
    out = _build.BUILD_DIR.parent / "k5b_variants"  # also the --variants builds
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o",
                          str(so), str(_build.CSRC / "sparse_mla.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"variant {name} does not build:\n{res.stdout}{res.stderr}")
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", res.stderr)) - {"0"})
    regs = sorted(set(re.findall(r"Used (\d+) registers", res.stderr)), key=int)
    print(f"variant {name}: registers {', '.join(regs)}; spill stores "
          f"{', '.join(spills) or 'none'}", flush=True)
    return ctypes.CDLL(str(so))


def use_library(lib: ctypes.CDLL) -> None:
    """Route the wrapper (``ops.sparse_mla_kernel``) to ``lib``'s entry points."""
    K._fns = None
    own = _build._libs.get(K.KERNEL)
    _build._libs[K.KERNEL] = lib
    K._kernels()
    if own is not None:
        _build._libs[K.KERNEL] = own


def print_clocks(what: str, t: torch.Tensor, phases: tuple, ms: float) -> None:
    """Phase clocks [block][warpgroup][phase + tiles] of the blocks that ran:
    the clocks a tile of each phase, the mean over the blocks' sums."""
    t = t[t[:, 0, -1] > 0]
    tiles = t[:, :, -1]
    print(f"timeline of {what}: {t.shape[0]} blocks, {int(tiles[:, 0].sum())} tiles, the call "
          f"{ms:.3f} ms; clocks a tile, the mean over the blocks' sums, by warpgroup:", flush=True)
    for i, name in enumerate(phases):
        per = t[:, :, i].sum(0) / tiles.sum(0)
        print(f"  {name:>48}: {' / '.join(f'{float(v):8.0f}' for v in per)}", flush=True)
    total = t[:, :, :-1].sum(-1)
    print(f"  {'all':>48}: {' / '.join(f'{float(v):8.0f}' for v in total.sum(0) / tiles.sum(0))}"
          f"; slowest block {float(total.max()):.0f} clocks", flush=True)


def timeline(q, kv, idx, out, lse, do, scale) -> None:
    """The phase clocks of one K5a call and of one pass of K5b's launches over
    the call's chunks."""
    lib = build_variant("timeline", ("-DSPARSE_MLA_TIMELINE",))
    use_library(lib)
    for fn, wgs, phases, call in (
            ("sparse_mla_fwd", 2, K5A_PHASES, lambda: K.sparse_mla_fwd(q, kv, idx, scale, DV)),
            ("sparse_mla_bwd", 3, PHASES,
             lambda: K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV))):
        read = getattr(lib, f"{fn}_timeline")
        read.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        n = 1024 * wgs * (len(phases) + 1)
        buf = (ctypes.c_ulonglong * n)()
        call()
        torch.cuda.synchronize()
        _build.check(f"{fn}_timeline", read(buf, n))  # zeroes it
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        torch.cuda.synchronize()
        _build.check(f"{fn}_timeline", read(buf, n))
        t = torch.tensor(list(buf), dtype=torch.float64).reshape(1024, wgs, len(phases) + 1)
        print_clocks(fn if wgs == 2 else f"{fn} (the reductions included in the call)", t,
                     phases, s.elapsed_time(e))
    use_library(_build.load(K.KERNEL))


WIDE_PHASES = ("token start: panels and the first tile landed", "phase 1: s and dp products",
               "hand-off, p and ds", "phase 2: dq and dkvg products, stores, next gathers",
               "token end: dq stored")


def wide_timeline(gen, dev) -> None:
    """The wide K5b's phase clocks over one backward call at the timed row's
    shape (S = Sk = 2048, T = 512 causal, 16 heads), from a build with
    SPARSE_MLA_TIMELINE (the blocks of its first 1024 tokens a chunk)."""
    S, T, Hw = 2048, 512, 16
    q = torch.randn(S, Hw, K.DQ_WIDE, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(S, K.DQ_WIDE, device=dev, generator=gen).to(torch.bfloat16)
    do = torch.randn(S, Hw, K.DV_WIDE, device=dev, generator=gen).to(torch.bfloat16)
    idx = causal_indices(S, T, gen, dev)
    scale = K.DQ_WIDE ** -0.5
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, K.DV_WIDE)
    lib = build_variant("timeline", ("-DSPARSE_MLA_TIMELINE",))
    use_library(lib)
    read = lib.sparse_mla_bwd_wide_timeline
    read.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    n = 1024 * 2 * (len(WIDE_PHASES) + 1)
    buf = (ctypes.c_ulonglong * n)()

    def call():
        return K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, K.DV_WIDE)

    call()
    torch.cuda.synchronize()
    _build.check("sparse_mla_bwd_wide_timeline", read(buf, n))  # zeroes it
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    call()
    e.record()
    torch.cuda.synchronize()
    _build.check("sparse_mla_bwd_wide_timeline", read(buf, n))
    t = torch.tensor(list(buf), dtype=torch.float64).reshape(1024, 2, len(WIDE_PHASES) + 1)
    print_clocks("the wide sparse_mla_bwd (the reductions included in the call)", t, WIDE_PHASES,
                 s.elapsed_time(e))
    use_library(_build.load(K.KERNEL))


# more wide shapes for --seeds (the fields of chip_smoke.K5_WIDE_CASES): 8
# heads with T below a tile, 40 heads (three groups) dense, Dq 1000 / v_dim 896
WIDE_SEED_CASES = (("H=8 T=40", 1152, 1024, 100, 100, 40, "causal", 3, 8),
                   ("H=40 dense T=200", 1152, 1024, 150, 150, 200, "dense", 9, 40),
                   ("H=16 Dq 1000 v 896", 1000, 896, 128, 128, 64, "scattered", 0, 16))


def wide_seeds(n: int) -> None:
    """chip_smoke.K5_WIDE_CASES and WIDE_SEED_CASES through chip_smoke.k5_wide_case
    with the inputs of generator seeds 1 .. n: how many (case, seed) pairs miss
    K5B_TOL, and by what."""
    log, misses, pairs = chip_smoke.log, {}, 0
    chip_smoke.log = lambda msg: None
    try:
        for seed in range(1, n + 1):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            for case in chip_smoke.K5_WIDE_CASES + WIDE_SEED_CASES:
                pairs += 1
                try:
                    chip_smoke.k5_wide_case(gen, *case)
                except AssertionError as err:
                    misses.setdefault(case[0], []).append(f"seed {seed}: {str(err)[:90]}")
    finally:
        chip_smoke.log = log
    print(f"--seeds {n}: {sum(len(v) for v in misses.values())} of {pairs} (case, seed) pairs miss "
          f"K5B_TOL; by case: {json.dumps(misses)}", flush=True)


def narrow_seeds(n: int) -> None:
    """chip_smoke.K5B_EDGE_CASES (64 heads) and K5_HEAD_CASES through
    chip_smoke.k5b_check with the inputs of generator seeds 1 .. n: how many
    (case, seed) pairs miss K5B_TOL, and by what."""
    log, misses, pairs = chip_smoke.log, {}, 0
    chip_smoke.log = lambda msg: None
    cases = [c + (64,) for c in chip_smoke.K5B_EDGE_CASES] + list(chip_smoke.K5_HEAD_CASES)
    try:
        for seed in range(1, n + 1):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            for name, S, Sk, T, layout, empty, slots, heads in cases:
                pairs += 1
                q, kv, do, idx = chip_smoke.k5b_inputs(gen, S, Sk, T, layout, empty, heads)
                try:
                    chip_smoke.k5b_check(name, q, kv, do, idx, empty, slots)
                except AssertionError as err:
                    misses.setdefault(name, []).append(f"seed {seed}: {str(err)[:90]}")
    finally:
        chip_smoke.log = log
    print(f"--seeds {n}, the narrow K5b: {sum(len(v) for v in misses.values())} of {pairs} "
          f"(case, seed) pairs miss K5B_TOL; by case: {json.dumps(misses)}", flush=True)


def wide(args, gen, dev) -> bool:
    """The wide forms: their edge cases, then (without --quick) the timed row."""
    for case in chip_smoke.K5_WIDE_CASES:
        chip_smoke.k5_wide_case(gen, *case)
    if args.seeds:
        wide_seeds(args.seeds)
        narrow_seeds(args.seeds)
    if args.quick:
        return True
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rows = chip_smoke.k5_wide_timing(gen, flush)
    print(json.dumps({"k5_wide": rows}), flush=True)
    if args.timeline:
        wide_timeline(gen, dev)
    if args.variants:  # the wide K5b's own launches at the timed row's shape, in turns
        S, T, Hw = 2048, 512, 16
        q = torch.randn(S, Hw, K.DQ_WIDE, device=dev, generator=gen).to(torch.bfloat16)
        kv = torch.randn(S, K.DQ_WIDE, device=dev, generator=gen).to(torch.bfloat16)
        do = torch.randn(S, Hw, K.DV_WIDE, device=dev, generator=gen).to(torch.bfloat16)
        idx = causal_indices(S, T, gen, dev)
        scale = K.DQ_WIDE ** -0.5
        out, lse = K.sparse_mla_fwd(q, kv, idx, scale, K.DV_WIDE)
        ref = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, K.DV_WIDE)
        for spec in args.variants:
            name, _, flags = spec.partition(":")
            lib = build_variant(name, tuple(f for f in flags.split(",") if f))
            times = []
            for turn in range(4):  # variant, port, variant, port
                use_library(lib if turn % 2 == 0 else _build.load(K.KERNEL))
                if turn == 0:
                    got = K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, K.DV_WIDE)
                    same = all(torch.equal(a, b) for a, b in zip(got, ref))
                times.append(chip_smoke.k5b_wide_own_ms(q, kv, idx, out, lse, do, scale,
                                                        flush)[0])
            use_library(_build.load(K.KERNEL))
            print(f"variant {name}: the wide K5b's own launches {times[0]:.4f}, {times[2]:.4f} "
                  f"ms against the port's build {times[1]:.4f}, {times[3]:.4f} ms (in turns); "
                  f"dq and dkv {'equal to' if same else 'DIFFER from'} the port's", flush=True)
    del flush
    return True


def grouped_mm_probe(dev) -> None:
    print(f"torch._grouped_mm present: {hasattr(torch, '_grouped_mm')}", flush=True)
    if not hasattr(torch, "_grouped_mm"):
        return
    gen = torch.Generator(device=dev).manual_seed(1)
    sizes = torch.tensor([48, 0, 80, 128], device=dev)
    x = torch.randn(256, 64, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
    w = torch.randn(4, 64, 32, device=dev, generator=gen).to(torch.bfloat16).requires_grad_()
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    y = torch._grouped_mm(x, w, offs=offs)
    gx, gw = torch.autograd.grad(y.float().square().sum(), (x, w))
    ends = offs.tolist()
    parts, a = [], 0
    for e, b in enumerate(ends):
        parts.append(x[a:b] @ w[e])
        a = b
    y2 = torch.cat(parts)
    gx2, gw2 = torch.autograd.grad(y2.float().square().sum(), (x, w))
    for n, u, v in (("y", y, y2), ("dx", gx, gx2), ("dw", gw, gw2)):
        close(f"_grouped_mm {n} vs loop", u, v)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--S", type=int, default=4096)
    ap.add_argument("--topk", type=int, default=2048)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--grouped-mm", action="store_true")
    ap.add_argument("--plain", action="store_true", help="time the plain versions too")
    ap.add_argument("--timeline", action="store_true",
                    help="K5a's and K5b's phase clocks at --S from a build with "
                         "SPARSE_MLA_TIMELINE")
    ap.add_argument("--variants", nargs="*", default=[], metavar="NAME:FLAG,...",
                    help="rebuild with these -D flags (e.g. gather:-DK5A_GATHER_ONLY, "
                         "nostores:-DK5B_NO_STORES) and time K5a and K5b beside the port's "
                         "build")
    ap.add_argument("--quick", action="store_true",
                    help="the build report and the checks only, no timing")
    ap.add_argument("--wide", action="store_true",
                    help="the wide forms (Dq 1152 / v_dim 1024) in place of the 576 ones")
    ap.add_argument("--seeds", type=int, default=0,
                    help="with --wide: the wide cases, then the narrow K5b's edge and head "
                         "cases, over generator seeds 1 .. N, counting the (case, seed) pairs "
                         "that miss K5B_TOL")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("this benchmark needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    dev = torch.device("cuda")
    if args.ptxas:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
               str(_build.CSRC / "sparse_mla.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        print("\n".join(l for l in (res.stdout + res.stderr).splitlines()
                        if "registers" in l or "Compiling" in l or "error" in l or "spill" in l
                        or "bytes stack" in l or "wgmma" in l),
              flush=True)
    print(f"build: {_build.build(('sparse_mla',))}", flush=True)
    ok = True
    try:
        chip_smoke.sparse_mla_build_report()
    except AssertionError as err:  # reported; the checks still run
        print(f"build report: {err}", flush=True)
        ok = False
    if args.grouped_mm:
        grouped_mm_probe(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.wide:
        ok &= wide(args, gen, dev)
        print("OK" if ok else "FAILED", flush=True)
        return 0 if ok else 1
    ok &= check(1024, 512, gen, dev)
    ok &= check(200, 100, gen, dev)  # ragged tiles: T and S no multiple of a tile
    n, err_a, err_b = chip_smoke.k5_edge_cases(gen)
    print(f"K5a/K5b edge cases: {n}, max err {err_a:.4g} / {err_b:.4g}", flush=True)
    if args.quick:
        print("OK" if ok else "FAILED", flush=True)
        return 0 if ok else 1

    S, T = args.S, args.topk
    q = torch.randn(S, H, DQ, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(S, DQ, device=dev, generator=gen).to(torch.bfloat16)
    do = torch.randn(S, H, DV, device=dev, generator=gen).to(torch.bfloat16)
    idx = causal_indices(S, T, gen, dev)
    scale = DQ ** -0.5
    pairs = int((idx < S).sum())
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, DV)
    fwd = time_ms(lambda: K.sparse_mla_fwd(q, kv, idx, scale, DV))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    f_fwd = 2 * H * pairs * (DQ + DV)
    fwd_f = chip_smoke.time_ms(lambda: K.sparse_mla_fwd(q, kv, idx, scale, DV), iters=10,
                               flush=flush)
    gather_gb = pairs * DQ * 2 / 1e9  # each selected pair reads its 1152-byte row once
    print(f"K5a, L2 flushed: {fwd_f:.4f} ms ({f_fwd / fwd_f / 1e9:.1f} TFLOP/s, "
          f"{fwd_f / (f_fwd / chip_smoke.PEAK_BF16 * 1e3):.2f}x the operation bound; its row "
          f"gather {gather_gb:.3f} GB from L2, {gather_gb / fwd_f:.3f} TB/s)", flush=True)
    bwd = time_ms(lambda: K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV))
    f_bwd = 2 * H * pairs * (3 * DQ + 2 * DV)
    print(f"S={S} T={T} pairs={pairs}: fwd {fwd:.3f} ms ({f_fwd / fwd / 1e9:.1f} TFLOP/s), "
          f"bwd {bwd:.3f} ms ({f_bwd / bwd / 1e9:.1f} TFLOP/s; {K.bwd_launches(S, T)} chunks)",
          flush=True)
    bwd_f = chip_smoke.time_ms(lambda: K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV),
                               iters=5, flush=flush)
    # K5b alone over the call's chunks, and the reductions alone
    chunk = K.bwd_chunk(S, T)
    delta = (out.float() * do).sum(dim=-1)  # as the wrapper forms it
    dq = torch.empty_like(q)
    dkvg = torch.empty((chunk, T, DQ), dtype=torch.float32, device=dev)
    dkv = torch.zeros((S, DQ), dtype=torch.float32, device=dev)
    slices = [slice(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    orders = [K.slot_order(idx[sl], S) for sl in slices]

    def k5b_alone():
        for sl in slices:
            K.sparse_mla_bwd_chunk(q[sl], kv, idx[sl], do[sl], lse[sl], delta[sl], dq[sl], dkvg,
                                   scale, DV)

    def reductions_alone():
        for order, seg in orders:
            K.sparse_mla_dkv_reduce(dkvg, order, seg, dkv)

    alone = chip_smoke.time_ms(k5b_alone, iters=5, flush=flush)
    red = chip_smoke.time_ms(reductions_alone, iters=5, flush=flush)
    bms = f_bwd / chip_smoke.PEAK_BF16 * 1e3
    # the rest of the call: the wrapper's delta (and PR 9's form of it, both
    # operands widened first: the same sums) and the chunks' slot orders
    d_ms = chip_smoke.time_ms(lambda: (out.float() * do).sum(dim=-1), iters=5, flush=flush)
    d_old = chip_smoke.time_ms(lambda: (out.float() * do.float()).sum(dim=-1), iters=5,
                               flush=flush)
    o_ms = chip_smoke.time_ms(lambda: [K.slot_order(idx[sl], S) for sl in slices], iters=5,
                              flush=flush)
    print(f"the wrapper's delta: {d_ms:.4f} ms (both operands widened first: {d_old:.4f} ms); "
          f"slot_order over the {len(slices)} chunks: {o_ms:.4f} ms", flush=True)
    if args.timeline:
        timeline(q, kv, idx, out, lse, do, scale)

    def k5a_alone():
        K.sparse_mla_fwd(q, kv, idx, scale, DV)

    for spec in args.variants:
        name, _, flags = spec.partition(":")
        use_library(build_variant(name, tuple(f for f in flags.split(",") if f)))
        o_v, l_v = K.sparse_mla_fwd(q, kv, idx, scale, DV)  # against the port's build's
        same = close(f"variant {name}: K5a out against the port's", o_v, out)
        same &= close(f"variant {name}: K5a lse against the port's", l_v, lse, tol=1e-3)
        print(f"variant {name}: K5a {'agrees' if same else 'DIFFERS (timed only)'}", flush=True)
        a_ms = chip_smoke.time_ms(k5a_alone, iters=10, flush=flush)
        b_ms = chip_smoke.time_ms(k5b_alone, iters=5, flush=flush)
        use_library(_build.load(K.KERNEL))
        a_own = chip_smoke.time_ms(k5a_alone, iters=10, flush=flush)
        b_own = chip_smoke.time_ms(k5b_alone, iters=5, flush=flush)
        print(f"variant {name}: K5a {a_ms:.4f} ms (the port's build {a_own:.4f} ms in turn; the "
              f"gather {gather_gb / a_ms:.3f} TB/s), K5b's own launches {b_ms:.4f} ms (the "
              f"port's build {b_own:.4f} ms)", flush=True)
    print(f"K5b call, L2 flushed: {bwd_f:.4f} ms; K5b's own {len(slices)} launches: {alone:.4f} ms "
          f"({f_bwd / alone / 1e9:.1f} TFLOP/s, {alone / bms:.2f}x the {bms:.4f} ms operation "
          f"bound); the {len(slices)} reductions: {red:.4f} ms", flush=True)
    if args.plain:
        p_fwd = time_ms(lambda: K.sparse_mla_attention_reference(q, kv, idx, scale, DV), iters=2)
        p_bwd = time_ms(lambda: K.sparse_mla_backward_reference(q, kv, idx, out, lse, do, scale,
                                                                DV), iters=2)
        print(f"plain fwd {p_fwd:.3f} ms, plain bwd {p_bwd:.3f} ms", flush=True)
    print("OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
