#!/usr/bin/env python3
"""``torch._int_mm`` on one NVIDIA GPU: which weight layout the int8 training
product (``prime_rl_tpu_torch/ops/int8_linear.py``) should hand it, and which
shapes it refuses.

    python3 scripts/torch_int_mm_layouts.py

For Qwen3-0.6B's MLP products at a micro-batch of 8 x 512 tokens (4096 x 1024
x 3072 and 4096 x 3072 x 1024) and a small padded shape, times the product
(CUDA events, 20 calls after 3) with the weight row-major and column-major,
each checked against the exact integer product on the CPU; then tries M = 8,
16 and 17. Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in ((4096, 1024, 3072), (4096, 3072, 1024), (24, 64, 16)):
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev, generator=gen)
        b = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev, generator=gen)
        exact = a.cpu().long() @ b.cpu().long()
        for layout, w in (("row-major", b), ("column-major", b.t().contiguous().t())):
            ok = torch.equal(torch._int_mm(a, w).cpu().long(), exact)
            for _ in range(3):
                torch._int_mm(a, w)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                torch._int_mm(a, w)
            end.record()
            torch.cuda.synchronize()
            print(f"{m} x {k} x {n}, weight {layout}: {start.elapsed_time(end) / 20:.4f} ms, "
                  f"{'exact' if ok else 'WRONG'}")
    for m in (8, 16, 17):
        try:
            torch._int_mm(torch.zeros(m, 64, dtype=torch.int8, device=dev),
                          torch.zeros(64, 16, dtype=torch.int8, device=dev))
            print(f"M = {m}: taken")
        except RuntimeError as e:
            print(f"M = {m}: refused ({str(e).splitlines()[0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
