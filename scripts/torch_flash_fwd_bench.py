#!/usr/bin/env python3
"""K1 (``csrc/flash_attn_fwd.cu``) alone on the card: build report, checks
against the plain version, times.

    python3 scripts/torch_flash_fwd_bench.py            # everything below
    python3 scripts/torch_flash_fwd_bench.py --quick    # build + one tile a form

It prints ptxas's report of K1 (a separate ``nvcc -Xptxas -v``: registers,
spill bytes, shared memory of each instantiation), builds K1 as the port
does and prints ``chip_smoke.py``'s build report (the loaded kernels'
attributes). ``--quick`` then runs one 128 x 128 tile of one head at both head
dims, causal and not, against the plain version and stops: the first call
after a change to the kernel. Without it, it runs ``chip_smoke.py``'s K1 edge
cases and times K1 with ``chip_smoke.py``'s ``k1_timing`` (the same time,
bound, yardstick and kernel-counted tiles as its kernel phase) at the shapes
that script uses: Qwen3-0.6B (16/8 heads of 128) at B=4 L=512, B=1 L=2048
and the trainer's B=8 L=512 of four sequences, and gpt-oss-20b (64/8 heads
of 64, sinks) at B=1 L=4096 with window 128, full, and full over four packed
sequences of 1024.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402


def quick(gen) -> bool:
    """One tile of one head a form against the plain version. lse depends on
    S = Q K^T alone, out also on P V: a wrong lse points at the first
    product's layout, a wrong out with a right lse at the second's."""
    import torch

    from prime_rl_tpu_torch.ops.flash_attention import _fwd, flash_attention_reference

    ok = True
    for hd in (128, 64):
        for causal in (False, True):
            q, k, v = (torch.randn(1, 128, 1, hd, device="cuda", generator=gen).to(torch.bfloat16)
                       for _ in range(3))
            seg = torch.ones(1, 128, dtype=torch.int32, device="cuda")
            out, lse = _fwd(q, k, v, seg, seg, causal, None)
            torch.cuda.synchronize()
            ref_out, ref_lse = flash_attention_reference(q.float(), k.float(), v.float(), seg, seg,
                                                         causal, hd ** -0.5)
            err = (out.float() - ref_out.float()).abs()[0, :, 0]  # [128 rows, hd]
            lerr = (lse - ref_lse).abs()[0, 0]
            good = bool((err <= smoke.ATOL + smoke.RTOL * ref_out.float().abs()[0, :, 0]).all()
                        and (lerr <= 1e-3 + 1e-4 * ref_lse.abs()[0, 0]).all())
            ok = ok and good
            print(f"one tile hd {hd} causal {causal}: {'ok' if good else 'WRONG'}  max err out "
                  f"{err.max().item():.4g}, lse {lerr.max().item():.4g}", flush=True)
            if not good:  # where: max error over blocks of 16 rows x 16 columns, lse by 16 rows
                print("  out err by 16x16 block:\n" + str(
                    err.reshape(8, 16, hd // 16, 16).amax(dim=(1, 3)).cpu()), flush=True)
                print("  lse err by 16 rows: " + str(lerr.reshape(8, 16).amax(1).cpu()),
                      flush=True)
                print(f"  lse[:8] {lse[0, 0, :8].tolist()}\n  ref  {ref_lse[0, 0, :8].tolist()}",
                      flush=True)
                print(f"  out[0, :8] {out[0, 0, 0, :8].float().tolist()}\n  ref "
                      f"{ref_out[0, 0, 0, :8].tolist()}", flush=True)
    return ok


def timings(gen) -> None:
    """K1 at the shapes of ``chip_smoke.py``, timed by its own ``k1_timing``."""
    import torch

    from prime_rl_tpu_torch.models.base import get_spec

    dev = torch.device("cuda")
    qwen, oss = get_spec(smoke.MODEL), get_spec(smoke.GPT_OSS)
    shapes = [(qwen, 4, 512, [[200, 250], [512], [37], []], 0, False),
              (qwen, 1, 2048, [[2048]], 0, False),
              (qwen, 8, 512, [[120, 130, 100, 110]] * 8, 0, False),
              (oss, 1, 4096, [[4096]], oss.sliding_window, True),
              (oss, 1, 4096, [[4096]], 0, True),
              (oss, 1, 4096, [[1024] * 4], 0, True)]
    for spec, b, l, lens, window, with_sinks in shapes:
        nh, nkv, hd = spec.num_heads, spec.num_kv_heads, spec.head_dim
        q, k, v = (torch.randn(b, l, n, hd, device=dev, generator=gen).to(torch.bfloat16)
                   for n in (nh, nkv, nkv))
        seg, _ = smoke.packed_segments(b, l, lens, dev)
        sinks = torch.randn(nh, device=dev, generator=gen) if with_sinks else None
        smoke.k1_timing(f"K1 {nh}/{nkv} heads hd {hd} B={b} L={l} segments {lens[0]} window "
                        f"{window} sinks {with_sinks}", q, k, v, seg, window, sinks)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true", help="build and one tile a form only")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    from prime_rl_tpu_torch.ops import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", os.devnull,
           str(_build.CSRC / "flash_attn_fwd.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    print("\n".join(line for line in (res.stdout + res.stderr).splitlines()
                    if any(w in line for w in ("Compiling", "registers", "spill", "error"))),
          flush=True)
    print(f"build: {_build.build(('flash_attn_fwd',))}", flush=True)
    try:
        smoke.flash_build_report()
    except AssertionError as e:  # report and go on: the checks below still say something
        print(f"build report: {e}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    if not quick(gen):
        return 1
    if not args.quick:
        n, err = smoke.k1_edge_cases(gen)
        print(f"edge cases: {n} within tolerance, max err {err:.4g}", flush=True)
        timings(gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
