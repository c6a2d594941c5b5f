#!/usr/bin/env python3
"""K4 (``csrc/decode_attention.cu``) alone on the card: build report, checks
against the plain version, times.

    python3 scripts/torch_decode_attn_bench.py            # everything below
    python3 scripts/torch_decode_attn_bench.py --quick    # build + one slot a form
    python3 scripts/torch_decode_attn_bench.py --variants c512:SPLIT_ROWS=512 ...
    python3 scripts/torch_decode_attn_bench.py --timeline

It prints ptxas's report of K4 (a separate ``nvcc -Xptxas -v``: registers,
spill bytes, shared memory of each instantiation), builds K4 as the port
does and prints ``chip_smoke.py``'s K4 build report (the loaded kernels'
attributes). ``--quick`` then runs one slot of each form that the serving
paths launch (Qwen3's 16/8 heads of 128; gpt-oss's 64/8 heads of 64 with
sinks, at window 128 and without; GLM-4.5's 96/8 heads of 128, two chunks a
kv head) against the plain version, with the rows
the kernel's work items read against the split rule, and stops: the first
call after a change to the kernel. Without it, it runs ``chip_smoke.py``'s K4
edge cases and times K4 with ``chip_smoke.py``'s ``k4_timing`` (the same
time, bound, yardstick and kernel-counted rows as its kernel phase) at every
K4 row of that script: Qwen3-0.6B at 64 slots of 1-1500 cached tokens and 16
slots of 3000-4000, gpt-oss-20b at 64 slots of 5-1000 with window 128 and
without, and Qwen3-30B-A3B (32/4 heads) and GLM-4.5-Air (96/8) at 64 slots
of 500-1100.

``--variants NAME:KEY=V,... ...`` builds copies of the source with its
constants replaced (SPLIT_ROWS, TILE_64, STAGES_64, TILE_128, STAGES_128,
NWARPS, MIN_BLOCKS_64, MIN_BLOCKS_128) beside the source as it is ("base"),
checks each on those four rows, then times them in turns (base, A, B, ..., B,
A, base) on the same inputs, once with ``chip_smoke.py``'s flush (a zeroed
256 MB buffer: the L2 is left full of dirty lines, whose write-back then
shares the card's bandwidth with the kernel) and once with a read of that
buffer (the L2 left full of clean lines), and prints each row's fastest and
slowest time and the device's rate on a plain read of the same size.
``--timeline`` builds the source with a clock at each block's entry and exit
and prints, for the Qwen3 64-slot row and the gpt-oss full row, how many
blocks that read rows were running in each 2 us of the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def quick(gen) -> bool:
    """One slot of each form against the plain version. The slot's cached
    rows span several splits, with a length that is no multiple of the tile;
    a wrong output with the right rows read points at the products or the
    combine."""
    import torch

    ok = True
    for name, nh, nkv, hd, n, window, with_sinks in (
            ("Qwen3 16/8 heads hd 128", 16, 8, 128, 1000, 0, False),
            ("gpt-oss 64/8 heads hd 64, window 128 + sinks", 64, 8, 64, 700, 128, True),
            ("gpt-oss 64/8 heads hd 64, full + sinks", 64, 8, 64, 700, 0, True),
            ("GLM-4.5 96/8 heads hd 128 (two chunks)", 96, 8, 128, 1000, 0, False)):
        args = smoke.k4_inputs(gen, 1, nh, nkv, hd, 64, 16, [n])
        sinks = torch.randn(nh, device="cuda", generator=gen) if with_sinks else None
        try:
            err = smoke.k4_check(name, *args, window=window, sinks=sinks, launches=2)
            rows = smoke.k4_rows(name, *args, window=window, sinks=sinks)
            print(f"one slot {name}: ok, max err {err:.4g}, {rows} cached rows a kv head",
                  flush=True)
        except AssertionError as e:
            ok = False
            print(f"one slot {name}: WRONG: {e}", flush=True)
            from prime_rl_tpu_torch.ops.decode_attention import (
                decode_paged_attention,
                decode_paged_attention_reference,
            )

            q, kn, vn, kp, vp, lengths, table = args
            o = decode_paged_attention(q, kn, vn, kp.clone(), vp.clone(), lengths, table,
                                       window=window, sinks=sinks)[0].float()
            ref = decode_paged_attention_reference(q.float(), kn.float(), vn.float(), kp.float(),
                                                   vp.float(), lengths, table, window=window,
                                                   sinks=sinks)[0]
            print("  max err by head: " + str((o - ref).abs().amax(-1)[0].cpu()), flush=True)
            print(f"  o[0, 0, :8] {o[0, 0, :8].tolist()}\n  ref {ref[0, 0, :8].tolist()}",
                  flush=True)
    return ok


def timings(gen) -> None:
    """K4 at the rows of ``chip_smoke.py``, timed by its own ``k4_timing``."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    smoke.k4_qwen3_cases(get_spec(smoke.MODEL), gen, flush)
    oss = get_spec(smoke.GPT_OSS)
    smoke.k4_gpt_oss_cases(oss, gen, flush, torch.randn(oss.num_heads, device="cuda",
                                                          generator=gen))
    for model in (smoke.QWEN3_MOE, smoke.GLM):
        smoke.k4_moe_case(get_spec(model), gen, flush)


VARIANT_KEYS = ("SPLIT_ROWS", "TILE_64", "STAGES_64", "TILE_128", "STAGES_128", "NWARPS",
                "MIN_BLOCKS_64", "MIN_BLOCKS_128")


def build_variant(name: str, source: str) -> ctypes.CDLL:
    """``source`` compiled as the port compiles K4, into build/k4_variants/."""
    from prime_rl_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "k4_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(source)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                          str(cu.with_suffix(".so")), str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"variant {name} does not build:\n{res.stdout}{res.stderr}")
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", res.stderr)) - {"0"})
    regs = sorted(set(re.findall(r"Used (\d+) registers", res.stderr)), key=int)
    print(f"variant {name}: registers {', '.join(regs)}; spill stores "
          f"{', '.join(spills) or 'none'}", flush=True)
    return ctypes.CDLL(str(cu.with_suffix(".so")))


def use_library(lib: ctypes.CDLL) -> None:
    """Route the wrapper (``ops.decode_attention``) to ``lib``'s entry points
    and split size."""
    from prime_rl_tpu_torch.ops import decode_attention as da

    p, i = ctypes.c_void_p, ctypes.c_int
    da._fns.clear()
    for rows in (False, True):
        fn = lib.decode_paged_attention_rows if rows else lib.decode_paged_attention
        fn.argtypes = [p] * 11 + [i] * 7 + [ctypes.c_float, i, p] + [p] * rows
        fn.restype = i
        da._fns[rows] = fn
    da.SPLIT_ROWS = lib.decode_split_rows()


def bench_rows(gen) -> list:
    """(name, args, window, sinks, inactive slots) of the four K4 rows of
    ``chip_smoke.py`` (fresh inputs from ``gen``)."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    qwen, oss = get_spec(smoke.MODEL), get_spec(smoke.GPT_OSS)

    def lengths(s, lo, hi, n_inactive=0, first=()):
        def draw():
            n = torch.randint(lo, hi + 1, (s,), device="cuda", generator=gen, dtype=torch.int32)
            if n_inactive:
                n[-n_inactive:] = torch.randint(0, 64, (n_inactive,), device="cuda",
                                                generator=gen, dtype=torch.int32)
            n[:len(first)] = torch.tensor(first, dtype=torch.int32)
            return n
        return draw

    q = (qwen.num_heads, qwen.num_kv_heads, qwen.head_dim, 64, 64)
    o = (oss.num_heads, oss.num_kv_heads, oss.head_dim, 64, 64)
    oss_args = smoke.k4_inputs(gen, 64, *o, lengths(64, 500, 1000, first=(5, 64, 126, 127)))
    sinks = torch.randn(oss.num_heads, device="cuda", generator=gen)
    return [("Qwen3 64 slots 1..1500", smoke.k4_inputs(gen, 64, *q, lengths(64, 1, 1500, 8), 8),
             0, None, 8),
            ("Qwen3 16 slots 3000..4000", smoke.k4_inputs(gen, 16, *q, lengths(16, 3000, 4000)),
             0, None, 0),
            ("gpt-oss window 128 + sinks", oss_args, oss.sliding_window, sinks, 0),
            ("gpt-oss full + sinks", oss_args, 0, sinks, 0)]


def variants(gen, specs: list) -> None:
    """The source's constants against the variants ``specs`` (NAME:KEY=V,...)."""
    import torch

    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops import decode_attention as da

    source = (_build.CSRC / "decode_attention.cu").read_text()
    libs = {"base": build_variant("base", source)}
    for spec in specs:
        name, _, assigns = spec.partition(":")
        text = source
        for assign in filter(None, assigns.split(",")):
            key, value = assign.split("=")
            if key not in VARIANT_KEYS:
                raise SystemExit(f"unknown constant {key}: one of {', '.join(VARIANT_KEYS)}")
            text, n = re.subn(rf"\b{key} = \d+", f"{key} = {int(value)}", text)
            assert n == 1, key
        libs[name] = build_variant(name, text)
    rows = bench_rows(gen)
    for name, lib in libs.items():
        use_library(lib)
        for label, args, window, sinks, n_inactive in rows:
            smoke.k4_check(f"{name} {label}", *args, window=window, sinks=sinks,
                           n_inactive=n_inactive, launches=2)
            smoke.k4_rows(f"{name} {label}", *args, window=window, sinks=sinks)
    print(f"variants {', '.join(libs)}: all within tolerance, two launches equal, rows as the "
          "split rule gives", flush=True)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")

    class ReadFlush:  # the same buffer read: L2 full of clean lines
        def zero_(self):
            flush.sum(dtype=torch.int32)

    order = list(libs) + list(libs)[::-1]
    for what, fl in (("flush by zeroing (chip_smoke.py)", flush), ("flush by a read", ReadFlush())):
        times = {name: {row[0]: [] for row in rows} for name in libs}
        for name in order:
            use_library(libs[name])
            for label, args, window, sinks, _ in rows:
                times[name][label].append(smoke.time_ms(
                    lambda: da.decode_paged_attention(*args, window=window, sinks=sinks), flush=fl))
        print(f"-- ms, fastest/slowest of two turns, {what}", flush=True)
        for name in libs:
            print(f"{name:>12}: " + "  ".join(f"{label} {min(v):.4f}/{max(v):.4f}"
                                            for label, v in times[name].items()), flush=True)
        x = torch.empty(45249 * 8 * 128 * 4 // 2, dtype=torch.bfloat16, device="cuda")
        ms = smoke.time_ms(lambda: x.sum(dtype=torch.float32), flush=fl)
        print(f"   a plain read of {x.numel() * 2 / 1e6:.1f} MB (torch.sum): {ms:.4f} ms, "
              f"{x.numel() * 2 / ms / 1e9:.3f} TB/s", flush=True)
        del x
    use_library(libs["base"])


TIMELINE_WRAPPER = """
__device__ unsigned long long prt_clock[1 << 17];
template <int HD, int G>
__global__ void __launch_bounds__(NTHREADS, min_blocks<HD>()) decode_split_kernel(const Args a) {
  unsigned long long t0, t1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  split_body<HD, G>(a);
  if (threadIdx.x == 0) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    const size_t b = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (b < (1 << 16)) { prt_clock[2 * b] = t0; prt_clock[2 * b + 1] = t1; }
  }
}
"""


def timeline(gen) -> None:
    """Blocks that read rows running in each 2 us of the kernel (the clock of
    each block's entry and exit), on the Qwen3 64-slot and gpt-oss full rows."""
    import torch

    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops import decode_attention as da

    source = (_build.CSRC / "decode_attention.cu").read_text()
    head = "__global__ void __launch_bounds__(NTHREADS, min_blocks<HD>())\ndecode_split_kernel("
    assert head in source
    source = source.replace(head, "__device__ __forceinline__ void split_body(")
    source = source.replace("// ---- host side", TIMELINE_WRAPPER + "// ---- host side")
    source += ('\nextern "C" int prt_clock_read(void* dst, size_t n) {\n'
               '  return (int)cudaMemcpyFromSymbol(dst, prt_clock, n * 8);\n}\n')
    lib = build_variant("timeline", source)
    use_library(lib)
    lib.prt_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    rows = bench_rows(gen)
    for label, args, window, sinks, _ in (rows[0], rows[3]):
        s, nkv = args[0].shape[0], args[3].shape[0]
        ms = da.max_splits(args[6].shape[1] * args[3].shape[2], da.SPLIT_ROWS)
        n_blocks = nkv * s * ms
        for _ in range(3):
            flush.zero_()
            da.decode_paged_attention(*args, window=window, sinks=sinks)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (2 * n_blocks))()
        _build.check("prt_clock_read", lib.prt_clock_read(buf, 2 * n_blocks))
        clock = torch.tensor(list(buf), dtype=torch.float64).reshape(ms, s, nkv, 2)
        start, end = (clock[..., 0] - clock[..., 0].min()) / 1e3, (clock[..., 1] -
                                                                   clock[..., 0].min()) / 1e3
        read = da.decode_rows_visited(args[5], window, da.SPLIT_ROWS, ms).T.cpu()[:, :, None] > 0
        read = read.expand(ms, s, nkv)
        bins = torch.arange(0.0, float(end.max()) + 2.0, 2.0)
        running = [int(((start <= t) & (end > t) & read).sum()) for t in bins]
        print(f"{label}: {int(read.sum())} items that read rows of {n_blocks} blocks, kernel "
              f"{float(end.max()):.1f} us; the last item started at "
              f"{float(start[read].max()):.1f} us; items running every 2 us: "
              + " ".join(map(str, running)), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="build and one slot a form only")
    parser.add_argument("--variants", nargs="*", metavar="NAME:KEY=V,...",
                        help="time the source against copies with other constants")
    parser.add_argument("--timeline", action="store_true",
                        help="the blocks running in each 2 us of the kernel")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from prime_rl_tpu_torch.ops import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
           str(_build.CSRC / "decode_attention.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print("\n".join(line for line in (res.stdout + res.stderr).splitlines()
                    if any(w in line for w in ("Compiling", "registers", "spill", "error"))),
          flush=True)
    print(f"build: {_build.build(('decode_attention',))}", flush=True)
    try:
        smoke.decode_build_report()
    except AssertionError as e:  # report and go on: the checks below still say something
        print(f"build report: {e}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    if not quick(gen):
        return 1
    if args.variants is not None or args.timeline:
        if args.variants is not None:
            variants(gen, args.variants)
        if args.timeline:
            timeline(gen)
    elif not args.quick:
        n, err = smoke.k4_edge_cases(gen)
        print(f"edge cases: {n} within tolerance, max err {err:.4g}", flush=True)
        timings(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
