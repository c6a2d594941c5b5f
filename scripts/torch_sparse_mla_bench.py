#!/usr/bin/env python3
"""Microbenchmark of the sparse-MLA kernels (K5a forward, K5b backward and the
dkv reduction) of the PyTorch/CUDA port on one NVIDIA GPU: the counterpart of
``scripts/bench_sparse_mla.py``.

    python3 scripts/torch_sparse_mla_bench.py [--S 4096] [--topk 2048] [--ptxas]

Builds ``prime_rl_tpu_torch/csrc/sparse_mla.cu``, holds both kernels against
their plain PyTorch versions on the same bf16 inputs at a short shape with
sentinels (tolerance 2e-2 absolute + 2e-2 relative), then times them at
``S = Sk = --S`` with causal top-k-looking indices (token i selects
min(topk, i + 1) of [0, i]) by CUDA events. ``--ptxas`` also prints the
registers, shared memory and spills that ``nvcc -Xptxas -v`` reports.
``--grouped-mm`` checks ``torch._grouped_mm`` (forward and backward) against a
loop over experts, which is how ``ops/moe.py`` chooses its expert product.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

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
                        if "registers" in l or "Compiling" in l or "error" in l or "spill" in l),
              flush=True)
    print(f"build: {_build.build(('sparse_mla',))}", flush=True)
    if args.grouped_mm:
        grouped_mm_probe(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = check(1024, 512, gen, dev)
    ok &= check(200, 100, gen, dev)  # ragged tiles: T and S no multiple of a tile

    S, T = args.S, args.topk
    q = torch.randn(S, H, DQ, device=dev, generator=gen).to(torch.bfloat16)
    kv = torch.randn(S, DQ, device=dev, generator=gen).to(torch.bfloat16)
    do = torch.randn(S, H, DV, device=dev, generator=gen).to(torch.bfloat16)
    idx = causal_indices(S, T, gen, dev)
    scale = DQ ** -0.5
    pairs = int((idx < S).sum())
    out, lse = K.sparse_mla_fwd(q, kv, idx, scale, DV)
    fwd = time_ms(lambda: K.sparse_mla_fwd(q, kv, idx, scale, DV))
    bwd = time_ms(lambda: K.sparse_mla_bwd(q, kv, idx, out, lse, do, scale, DV))
    f_fwd, f_bwd = 2 * H * pairs * (DQ + DV), 2 * H * pairs * (3 * DQ + 2 * DV)
    print(f"S={S} T={T} pairs={pairs}: fwd {fwd:.3f} ms ({f_fwd / fwd / 1e9:.1f} TFLOP/s), "
          f"bwd {bwd:.3f} ms ({f_bwd / bwd / 1e9:.1f} TFLOP/s; {K.bwd_launches(S, T)} chunks)",
          flush=True)
    if args.plain:
        p_fwd = time_ms(lambda: K.sparse_mla_attention_reference(q, kv, idx, scale, DV), iters=2)
        p_bwd = time_ms(lambda: K.sparse_mla_backward_reference(q, kv, idx, out, lse, do, scale,
                                                                DV), iters=2)
        print(f"plain fwd {p_fwd:.3f} ms, plain bwd {p_bwd:.3f} ms", flush=True)
    print("OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
