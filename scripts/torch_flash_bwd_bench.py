#!/usr/bin/env python3
"""K2a and K2b (``csrc/flash_attn_bwd.cu``) alone on the card: build report,
checks against the plain versions, times.

    python3 scripts/torch_flash_bwd_bench.py            # everything below
    python3 scripts/torch_flash_bwd_bench.py --quick    # build + one tile a form
    python3 scripts/torch_flash_bwd_bench.py --hd 512   # the forms at head dim 384 or 512

It prints ptxas's report of K2a/K2b (a separate ``nvcc -Xptxas -v``:
registers, spill bytes, shared memory of each instantiation), builds the
kernels as the port does and prints ``chip_smoke.py``'s build report (the
loaded kernels' attributes). ``--quick`` then runs one 128 x 128 tile (two q
heads on one kv head) at both head dims, not causal, causal and banded,
against the plain versions and stops: the first call after a change to the
kernels. It checks dv first (it depends on P alone), then dk and dq (which
also depend on dP), so that a wrong layout points at one product. Without
it, it runs ``chip_smoke.py``'s K2 edge cases and times K2a/K2b with
``chip_smoke.py``'s ``k2_timing`` (the same times, bounds, SDPA yardstick and
kernel-counted tiles as its kernel phases) at the shapes that script uses:
Qwen3-0.6B (16/8 heads of 128) at the trainer's B=8 L=512 of four sequences
and B=1 L=4096, and gpt-oss-20b (64/8 heads of 64, sinks) at B=1 L=4096 with
window 128, full, and full over four packed sequences of 1024.

``--hd 384`` or ``--hd 512`` takes the forms of that head dim instead (the
wgmma forms that compute a part of D an item): the same build reports, the
one-tile checks at that width, then (without ``--quick``) the K2 edge cases
of ``chip_smoke.K1_EDGE_CASES`` that run at it (320 is padded to 384) and
``k2_timing`` at the shape of ``chip_smoke.py``'s range-repairs rows: B=1
L=2048, two sequences of 1100 and 948, 16/4 heads. With it,
``--variants NAME:FLAG,...`` rebuilds ``csrc/flash_attn_bwd.cu`` with other
``-D`` flags (into ``build/k2_variants/``, printing the registers) and times
K2a and K2b of each variant beside the port's build in turns (variant, port,
variant, port) at that shape: ``parts:-DK2W_PART_BOXES`` loads only the
item's part of D of each streamed tile (a wrong result), which prices the
streamed loads; ``ksteps:-DK2W_PART_KSTEPS`` runs S and dP over the item's
part of D only (a wrong result), which prices their recomputation in every
part; ``slots2:-DK2W_SLOTS=2`` sets the ring's depth (a right result: 2
holds one tile pair and prefetches nothing).
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


def quick(gen, head_dims=(128, 64)) -> bool:
    """One tile a form against the plain versions, dv before dk and dq."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import (
        _delta,
        _fwd,
        flash_attention_dkv,
        flash_attention_dkv_reference,
        flash_attention_dq,
        flash_attention_dq_reference,
    )

    ok = True
    for hd in head_dims:
        for causal, window in ((False, 0), (True, 0), (True, 48)):
            q, do = (torch.randn(1, 128, 2, hd, device="cuda", generator=gen).to(torch.bfloat16)
                     for _ in range(2))
            k, v = (torch.randn(1, 128, 1, hd, device="cuda", generator=gen).to(torch.bfloat16)
                    for _ in range(2))
            seg = torch.ones(1, 128, dtype=torch.int32, device="cuda")
            out, lse = _fwd(q, k, v, seg, seg, causal, None, window=window)
            args = (q, k, v, seg, seg, lse, _delta(out, do, None), do, causal, hd ** -0.5, window)
            dk, dv = flash_attention_dkv(*args)
            dq = flash_attention_dq(*args)
            torch.cuda.synchronize()
            ref_dk, ref_dv = flash_attention_dkv_reference(*args)
            ref_dq = flash_attention_dq_reference(*args)
            for name, got, ref in (("dv", dv, ref_dv), ("dk", dk, ref_dk), ("dq", dq, ref_dq)):
                got, ref = got.float()[0, :, 0], ref.float()[0, :, 0]  # [128 rows, hd]
                err = (got - ref).abs()
                good = bool((err <= smoke.K2_TOL + smoke.K2_TOL * ref.abs()).all())
                ok = ok and good
                print(f"one tile hd {hd} causal {causal} window {window} {name}: "
                      f"{'ok' if good else 'WRONG'}  max err {err.max().item():.4g} (|ref| max "
                      f"{ref.abs().max().item():.4g})", flush=True)
                if not good:  # where: max error over blocks of 16 rows x 16 columns
                    print("  err by 16x16 block:\n" + str(
                        err.reshape(8, 16, hd // 16, 16).amax(dim=(1, 3)).cpu()), flush=True)
                    print(f"  row 0 [:8] {got[0, :8].tolist()}\n  ref {ref[0, :8].tolist()}",
                          flush=True)
    return ok


def wide_timing(gen, hd: int) -> None:
    """K2a/K2b at head dim ``hd`` at the shape of ``chip_smoke.py``'s
    range-repairs rows, timed by its ``k2_timing``."""
    import torch

    b, l, nh, nkv, lens = 1, 2048, 16, 4, [[1100, 948]]
    q, k, v, do = (torch.randn(b, l, n, hd, device="cuda", generator=gen).to(torch.bfloat16)
                   for n in (nh, nkv, nkv, nh))
    seg, _ = smoke.packed_segments(b, l, lens, "cuda")
    smoke.k2_timing(f"B={b} L={l} {nh}/{nkv} heads hd {hd}, segments {lens[0]}", q, k, v, do,
                    seg)


def build_variant(name: str, flags: tuple) -> ctypes.CDLL:
    """``csrc/flash_attn_bwd.cu`` compiled as the port compiles it, with
    ``flags``, into build/k2_variants/; prints its registers and spills."""
    from prime_rl_tpu_torch.ops import _build

    out = _build.BUILD_DIR.parent / "k2_variants"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"{name}.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o",
                          str(so), str(_build.CSRC / "flash_attn_bwd.cu")], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"variant {name} does not build:\n{res.stdout}{res.stderr}")
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", res.stderr)) - {"0"})
    regs = sorted(set(re.findall(r"Used (\d+) registers", res.stderr)), key=int)
    print(f"variant {name}: registers {', '.join(regs)}; spill stores "
          f"{', '.join(spills) or 'none'}", flush=True)
    return ctypes.CDLL(str(so))


def use_library(lib: ctypes.CDLL) -> None:
    """Route the K2 wrappers (``ops.flash_attention``) to ``lib``'s entry points."""
    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops import flash_attention as F

    F._bwd_fns.clear()
    own = _build._libs.get(F.KERNEL_BWD)
    _build._libs[F.KERNEL_BWD] = lib
    F._bwd_kernels(False)
    if own is not None:
        _build._libs[F.KERNEL_BWD] = own


def variant_times(gen, hd: int, specs: list) -> None:
    """K2a and K2b of each variant beside the port's build, in turns, at the
    shape of ``wide_timing``."""
    import torch

    from prime_rl_tpu_torch.ops import _build
    from prime_rl_tpu_torch.ops.flash_attention import (
        KERNEL_BWD,
        _delta,
        _fwd,
        flash_attention_dkv,
        flash_attention_dq,
    )

    b, l, nh, nkv, lens = 1, 2048, 16, 4, [[1100, 948]]
    q, k, v, do = (torch.randn(b, l, n, hd, device="cuda", generator=gen).to(torch.bfloat16)
                   for n in (nh, nkv, nkv, nh))
    seg, _ = smoke.packed_segments(b, l, lens, "cuda")
    out, lse = _fwd(q, k, v, seg, seg, True, None)
    args = (q, k, v, seg, seg, lse, _delta(out, do, None), do, True, hd ** -0.5)
    for spec in specs:
        name, _, flags = spec.partition(":")
        lib = build_variant(name, tuple(f for f in flags.split(",") if f))
        times = []
        for turn in range(4):  # variant, port, variant, port
            use_library(lib if turn % 2 == 0 else _build.load(KERNEL_BWD))
            times.append((smoke.time_ms(lambda: flash_attention_dq(*args)),
                          smoke.time_ms(lambda: flash_attention_dkv(*args))))
        use_library(_build.load(KERNEL_BWD))
        print(f"variant {name} at hd {hd}: K2a {times[0][0]:.4f}, {times[2][0]:.4f} ms and K2b "
              f"{times[0][1]:.4f}, {times[2][1]:.4f} ms against the port's build K2a "
              f"{times[1][0]:.4f}, {times[3][0]:.4f} and K2b {times[1][1]:.4f}, "
              f"{times[3][1]:.4f} ms (in turns)", flush=True)


def timings(gen) -> None:
    """K2a/K2b at the shapes of ``chip_smoke.py``, timed by its own ``k2_timing``."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    dev = torch.device("cuda")
    qwen, oss = get_spec(smoke.MODEL), get_spec(smoke.GPT_OSS)
    shapes = [(qwen, 8, 512, [[120, 130, 100, 110]] * 8, 0, False),
              (qwen, 1, 4096, [[4096]], 0, False),
              (oss, 1, 4096, [[4096]], oss.sliding_window, True),
              (oss, 1, 4096, [[4096]], 0, True),
              (oss, 1, 4096, [[1024] * 4], 0, True)]
    for spec, b, l, lens, window, with_sinks in shapes:
        nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
        q, k, v, do = (torch.randn(b, l, n, hd, device=dev, generator=gen).to(torch.bfloat16)
                       for n in (nh, nkv, nkv, nh))
        seg, _ = smoke.packed_segments(b, l, lens, dev)
        sinks = torch.randn(nh, device=dev, generator=gen) if with_sinks else None
        smoke.k2_timing(f"{nh}/{nkv} heads hd {hd} B={b} L={l} segments {lens[0]} window "
                        f"{window} sinks {with_sinks}", q, k, v, do, seg, window, sinks)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="build and one tile a form only")
    parser.add_argument("--hd", type=int, choices=(384, 512),
                        help="the forms at this head dim instead of 64 and 128")
    parser.add_argument("--variants", nargs="*", default=[], metavar="NAME:FLAG,...",
                        help="with --hd: rebuild with these -D flags and time beside the port")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from prime_rl_tpu_torch.ops import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
           str(_build.CSRC / "flash_attn_bwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print("\n".join(line for line in (res.stdout + res.stderr).splitlines()
                    if any(w in line for w in ("Compiling", "registers", "spill", "error"))),
          flush=True)
    print(f"build: {_build.build(('flash_attn_fwd', 'flash_attn_bwd'))}", flush=True)
    try:
        smoke.flash_build_report()
    except AssertionError as e:  # report and go on: the checks below still say something
        print(f"build report: {e}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    if not quick(gen, (args.hd,) if args.hd else (128, 64)):
        return 1
    if not args.quick:
        n, err = smoke.k2_edge_cases(gen, (args.hd,) if args.hd else None)
        print(f"edge cases: {n} within tolerance, max err {err:.4g}", flush=True)
        if args.hd:
            wide_timing(gen, args.hd)
            if args.variants:
                variant_times(gen, args.hd, args.variants)
        else:
            timings(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
