#!/usr/bin/env python3
"""K3 (``csrc/decode_qkv.cu``) alone on the card: build report, checks
against the plain version, times.

    python3 scripts/torch_decode_qkv_bench.py            # everything below
    python3 scripts/torch_decode_qkv_bench.py --quick    # build + one call a model
    python3 scripts/torch_decode_qkv_bench.py --variants s3:MAX_STAGES=3 k4:FORCE_SPLITS=4 ...
    python3 scripts/torch_decode_qkv_bench.py --timeline
    python3 scripts/torch_decode_qkv_bench.py --host [--package-root DIR]

It prints ptxas's report of K3 (a separate ``nvcc -Xptxas -v``: registers,
spill bytes, shared memory of each instantiation), builds K3 as the port
does and prints ``chip_smoke.py``'s build report of the decode kernels (the
loaded kernels' attributes and K3's launch at both serving shapes).
``--quick`` then runs K3 once at Qwen3-0.6B's and gpt-oss-20b's serving
shapes (64 decode slots) against the plain version, twice for equal bits,
with the weight tiles its blocks loaded against the tiling's mirror, and
stops: the first call after a change to the kernel. Without it, it runs
``chip_smoke.py``'s K3 edge cases and times K3 with ``chip_smoke.py``'s
``k3_timing`` (the same time, bound, cuBLAS yardstick and kernel-counted
tiles as its kernel phase) at both rows and at S of 1, 16 and 128, and
again with the L2 flushed by a read instead of a zero fill (the zero fill
leaves dirty lines whose write-back shares the card's bandwidth with the
timed call; a decode step leaves the L2 full of the previous layer's clean
weights).

``--variants NAME:KEY=V,...`` builds copies of the source with its
constants replaced (MAX_STAGES, COL_TILE, SPLIT_COST, and FORCE_SPLITS /
FORCE_STAGES, which fix the split of D and the ring's depth in place of the
occupancy-sized plan) beside the source as it is ("base"), checks each at
both rows, then times them in turns (base, A, B, ..., B, A, base), and
prints each row's fastest and slowest time and the device's rate on a plain
read of the same bytes.

``--host`` prints the host's microseconds a ``decode_qkv_prep`` call (the
wrapper's checks, the plan, the tensor maps and the launch) at both rows;
``--package-root DIR`` takes ``prime_rl_tpu_torch`` from the checkout at
DIR instead of this one (to compare two trees in one call).
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

VARIANT_KEYS = ("MAX_STAGES", "COL_TILE", "SPLIT_COST", "FORCE_SPLITS", "FORCE_STAGES")


class ReadFlush:
    """A flush for ``chip_smoke.time_ms`` that reads its buffer: the L2
    left full of clean lines."""

    def __init__(self, buf):
        self.buf = buf

    def zero_(self):
        import torch

        self.buf.sum(dtype=torch.int32)


def rows(gen) -> list:
    """(name, args, kwargs) of K3 at the two serving shapes, fresh inputs."""
    from prime_rl_tpu_torch.models.base import get_spec
    from prime_rl_tpu_torch.models.qwen3 import rope_setup

    out = []
    for label, model, qk_norm, bias in (("Qwen3", smoke.MODEL, True, False),
                                        ("gpt-oss", smoke.GPT_OSS, False, True)):
        spec = get_spec(model)
        inv_freq, scaling = rope_setup(spec, device=gen.device)
        args, kw = smoke.k3_inputs(gen, 64, spec.hidden_size, spec.num_heads,
                                   spec.num_kv_heads, spec.head_dim, qk_norm=qk_norm, bias=bias,
                                   inv_freq=inv_freq, scaling=scaling, eps=spec.rms_eps)
        out.append((label, args, kw))
    return out


def quick(gen) -> bool:
    """K3 once at each serving shape against the plain version, two launches
    for equal bits, the tiles each block loaded against the mirror. On a
    wrong output, the worst rows and columns of each projection."""
    import torch

    ok = True
    for label, args, kw in rows(gen):
        try:
            err = smoke.k3_check(label, args, kw)
            tiles = smoke.k3_tiles(label, args, kw)
            print(f"K3 {label}: ok, max err {err:.4g}, split {tiles['splits']}, "
                  f"{tiles['tiles_loaded']} of {tiles['weight_tiles']} weight tiles", flush=True)
        except AssertionError as e:
            ok = False
            print(f"K3 {label}: WRONG: {e}", flush=True)
            from prime_rl_tpu_torch.ops.decode_qkv import (
                decode_qkv_prep,
                decode_qkv_prep_reference,
            )

            got = decode_qkv_prep(*args, **kw)
            ref = decode_qkv_prep_reference(args[0].float(), *args[1:], **kw)
            for n, g, r in zip("qkv", got, ref):
                e2 = (g.float() - r).abs().flatten(1)
                print(f"  {n}: max err by row {e2.amax(1)[:8].tolist()}\n"
                      f"     by column {e2.amax(0)[:8].tolist()}\n"
                      f"     got {g.flatten(1)[0, :6].tolist()}\n     ref {r.flatten(1)[0, :6].tolist()}",
                      flush=True)
    return ok


def timings(gen) -> None:
    """K3 at both rows and at other decode batch sizes, by ``k3_timing``
    (the L2 flushed by a zero fill) and with the L2 flushed by a read."""
    import torch

    from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for label, args, kw in rows(gen):
        d = args[0].shape[1]
        for s in (64, 1, 16, 128):
            sub, skw = args, kw
            if s != 64:
                sub, skw = smoke.k3_inputs(gen, s, d, kw["num_heads"], kw["num_kv_heads"],
                                           kw["head_dim"], qk_norm=kw["qk_norm"],
                                           bias=kw.get("q_bias") is not None, inv_freq=args[6],
                                           scaling=kw["scaling"], eps=kw["eps"])
            smoke.k3_timing(f"{label} S={s}", sub, skw, flush)
            xn = sub[0] * sub[1]  # the product's operands: its time does not depend on values
            wcat = torch.cat(sub[2:5], 1)
            read = ReadFlush(flush)
            ms = smoke.time_ms(lambda: decode_qkv_prep(*sub, **skw), flush=read)
            product = smoke.time_ms(lambda: torch.matmul(xn, wcat), flush=read)
            print(f"K3 {label} S={s}, L2 flushed by a read: kernel {ms:.4f} ms  cuBLAS product "
                  f"alone {product:.4f} ms", flush=True)
            del xn, wcat


def time_turns(names, use, gen, label: str) -> None:
    """Each of ``names`` (selected by ``use(name)``) at both rows, in turns
    (names, then reversed); the fastest and slowest of each row's two times."""
    import torch

    from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_prep

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    bench = rows(gen)
    times = {n: {b[0]: [] for b in bench} for n in names}
    for name in list(names) + list(names)[::-1]:
        use(name)
        for row, args, kw in bench:
            times[name][row].append(smoke.time_ms(lambda: decode_qkv_prep(*args, **kw),
                                                  flush=flush))
    print(f"-- {label}: ms at S=64, fastest/slowest of two turns (cold L2)", flush=True)
    for name in names:
        print(f"{name:>12}: " + "  ".join(f"{row} {min(v):.4f}/{max(v):.4f}"
                                        for row, v in times[name].items()), flush=True)
    tiny = torch.zeros(1, device="cuda")
    for how, fl in (("zero fill", flush), ("read", ReadFlush(flush))):
        ms = smoke.time_ms(lambda: tiny.add_(1), flush=fl)
        print(f"   one tiny kernel (an add of one value), L2 flushed by a {how}: {ms:.4f} ms",
              flush=True)
    for row, args, _ in bench:
        w = torch.cat(args[2:5], 1)
        ms = smoke.time_ms(lambda: w.sum(dtype=torch.float32), flush=flush)
        print(f"   a plain read of {row}'s {w.numel() * 2 / 1e6:.1f} MB of weights (torch.sum): "
              f"{ms:.4f} ms, {w.numel() * 2 / ms / 1e9:.3f} TB/s", flush=True)


MARKS = ("producer: x issued", "producer: first tiles issued", "consumers ready", "x arrived",
         "sums of the cluster in", "rstd", "first weight tile", "products done",
         "partials exchanged", "row 0: partials summed", "epilogue done", "exit",
         "pass 1 done (warp 0)", "pass 1 done (warp 3)", "cluster start sync done",
         "producer: ring refilled")
ORDER = (1, 15, 2, 3, 4, 13, 14, 5, 6, 7, 16, 8, 9, 10, 11, 12)  # in time order


def timeline(gen) -> None:
    """The phase clocks of K3's blocks (a build with DECODE_QKV_TIMELINE: the
    clock of consumer thread 0 at each phase, the global timer at entry and
    exit) at both rows, cold L2: when blocks enter after the first, and each
    phase's time from the block's entry, median and slowest over the blocks."""
    import torch

    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops.decode_qkv import decode_qkv_plan, decode_qkv_prep

    lib = build_variant("timeline", (_build.CSRC / "decode_qkv.cu").read_text(),
                        ("-DDECODE_QKV_TIMELINE",))
    use_library(lib)
    lib.decode_qkv_timeline.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    marks = len(MARKS) + 1
    width = marks + 3
    for (label, args, kw), how in [(r, h) for h in ("zero fill", "read") for r in rows(gen)]:
        x = args[0]
        plan = decode_qkv_plan(x.shape[0], x.shape[1], kw["num_heads"], kw["num_kv_heads"],
                               kw["head_dim"])
        n = plan["col_tiles"] * plan["splits"] * plan["groups"]
        label = f"{label}, L2 flushed by a {how}"
        for _ in range(3):
            (flush if how == "zero fill" else ReadFlush(flush)).zero_()
            torch.cuda.synchronize()
            decode_qkv_prep(*args, **kw)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (n * width))()
        _build.check("decode_qkv_timeline", lib.decode_qkv_timeline(buf, n * width))
        t = torch.tensor(list(buf), dtype=torch.float64).reshape(n, width)
        g0, g1, sm = t[:, marks], t[:, marks + 1], t[:, marks + 2].long()
        ghz = (t[:, 12] - t[:, 0]) / (g1 - g0)  # cycles a ns
        entry, exit_ = (g0 - g0.min()) / 1e3, (g1 - g0.min()) / 1e3
        per_sm = torch.bincount(sm, minlength=int(sm.max()) + 1)
        print(f"timeline {label} (split {plan['splits']}, {plan['stages']} stages, {n} blocks "
              f"on {int((per_sm > 0).sum())} SMs, at most {int(per_sm.max())} an SM; SM clock "
              f"{float(ghz.median()):.3f} GHz): blocks enter from 0 to {float(entry.max()):.2f} "
              f"us (median {float(entry.median()):.2f}), leave from {float(exit_.min()):.2f} to "
              f"{float(exit_.max()):.2f} us", flush=True)
        for i in ORDER:
            name = MARKS[i - 1]
            us = (t[:, i] - t[:, 0]) / ghz / 1e3
            print(f"   {name:>20}: median {float(us.median()):6.2f} us, slowest "
                  f"{float(us.max()):6.2f} us after the block's entry", flush=True)
    use_library(_build.load("decode_qkv"))


def build_variant(name: str, source: str, flags: tuple = ()) -> ctypes.CDLL:
    """``source`` compiled as the port compiles K3, into build/k3_variants/."""
    from prime_rl_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "k3_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(source)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC), "-Xptxas",
                          "-v", "-o", str(cu.with_suffix(".so")), str(cu)], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"variant {name} does not build:\n{res.stdout}{res.stderr}")
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", res.stderr)) - {"0"})
    regs = sorted(set(re.findall(r"Used (\d+) registers", res.stderr)), key=int)
    print(f"variant {name}: registers {', '.join(regs)}; spill stores "
          f"{', '.join(spills) or 'none'}", flush=True)
    return ctypes.CDLL(str(cu.with_suffix(".so")))


def use_library(lib: ctypes.CDLL) -> None:
    """Route the wrapper (``ops.decode_qkv``) to ``lib``'s entry points."""
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops import decode_qkv as dq

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dq._fns.clear()
    for tiles in (False, True):
        fn = lib.decode_qkv_prep_tiles if tiles else lib.decode_qkv_prep
        fn.argtypes = [p] * 15 + [i, i, i, i, i, i, f, f, i, p] + [p] * tiles
        fn.restype = i
        dq._fns[tiles] = fn
    _build._libs["decode_qkv"] = lib  # decode_qkv_plan reads the same library


def variants(gen, specs: list) -> None:
    """The source's constants against the variants ``specs`` (NAME:KEY=V,...)."""
    from prime_rl_tpu_torch.ops import _build

    source = (_build.CSRC / "decode_qkv.cu").read_text()
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
    for name, lib in libs.items():
        use_library(lib)
        for label, args, kw in rows(gen):
            smoke.k3_check(f"{name} {label}", args, kw)
            if name == "base" or "COL_TILE" not in spec_of(specs, name):
                smoke.k3_tiles(f"{name} {label}", args, kw)
    print(f"variants {', '.join(libs)}: all within tolerance, two launches equal", flush=True)
    time_turns(list(libs), lambda name: use_library(libs[name]), gen, "variants")
    use_library(libs["base"])


def spec_of(specs: list, name: str) -> str:
    return next((s for s in specs if s.partition(":")[0] == name), "")


def host(gen, calls: int = 200, reps: int = 21) -> None:
    """The host's microseconds a ``decode_qkv_prep`` call at both rows:
    ``calls`` calls issued back to back after a sync (fewer than the launch
    queue holds, so the host never waits for the card), the median and the
    fastest of ``reps`` such runs, the library built and the plan warm; and
    the same for ``decode_qkv_plan`` alone (the launch's plan through the
    wrapper) where the package has it."""
    import statistics
    import time

    import torch

    from prime_rl_tpu_torch.ops import decode_qkv as dq

    def per_call(fn) -> list:
        fn()
        runs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return runs

    for label, args, kw in rows(gen):
        runs = per_call(lambda: dq.decode_qkv_prep(*args, **kw))
        line = (f"K3 {label} S=64 on the host: {statistics.median(runs):.2f} us a call (median "
                f"of {reps} runs of {calls} calls; fastest {min(runs):.2f})")
        if hasattr(dq, "decode_qkv_plan"):
            shape = (args[0].shape[0], args[0].shape[1], kw["num_heads"], kw["num_kv_heads"],
                     kw["head_dim"])
            plan = per_call(lambda: dq.decode_qkv_plan(*shape))
            line += f"; the plan alone {statistics.median(plan):.2f} us"
        print(line, flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="build and one call a model only")
    parser.add_argument("--variants", nargs="*", metavar="NAME:KEY=V,...",
                        help="time the source against copies with other constants")
    parser.add_argument("--timeline", action="store_true",
                        help="the phases of the blocks, from their clocks")
    parser.add_argument("--host", action="store_true",
                        help="only the host's microseconds a call")
    parser.add_argument("--package-root", metavar="DIR",
                        help="a checkout whose prime_rl_tpu_torch to time (with --host)")
    args = parser.parse_args()
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.host:
        host(torch.Generator(device="cuda").manual_seed(smoke.SEED))
        return 0
    from prime_rl_tpu_torch.ops import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
           str(_build.CSRC / "decode_qkv.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print("\n".join(line for line in (res.stdout + res.stderr).splitlines()
                    if any(w in line for w in ("Compiling", "registers", "spill", "error",
                                               "stack"))), flush=True)
    print(f"build: {_build.build(('decode_qkv', 'decode_attention'))}", flush=True)
    try:
        smoke.decode_build_report()
    except AssertionError as e:  # report and go on: the checks below still say something
        print(f"build report: {e}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    if not quick(gen):
        return 1
    if args.variants is not None or args.timeline:
        if args.timeline:
            timeline(gen)
        if args.variants:
            variants(gen, args.variants)
    elif not args.quick:
        n, err = smoke.k3_edge_cases(gen)
        print(f"edge cases: {n} within tolerance, max err {err:.4g}", flush=True)
        timings(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
