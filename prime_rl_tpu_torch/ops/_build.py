"""Build and load the hand-written CUDA kernels (``prime_rl_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled on
first use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, then loaded with
``ctypes``. Every C entry point returns ``cudaGetLastError()`` after its
launch; ``check`` turns a non-zero code into an exception.

``launches`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel, so a run can show that its path went through them. A
launch in a window or sink form also counts under ``<kernel>/window`` and
``<kernel>/sinks`` (``count``), K4's launches whose GQA group is cut
into chunks under ``decode_paged_attention/chunked``, and the forms at head
dims 384 and 512 (K1, K2a, K2b, K4) and at the wide MLA widths (K5a, K5b)
under ``<kernel>/wide``.

Nothing here runs at import time: the CPU tests import every module, and
the CPU path (the kernels' plain versions) never needs ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("flash_attn_fwd", "flash_attn_bwd", "decode_qkv", "decode_attention", "sparse_mla")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are built "
                           "from source on the machine with the card")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    # every shared header too: a source that includes a changed one must rebuild
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: tuple[str, ...] = KERNELS) -> dict[str, float]:
    """Compile every kernel of ``names`` whose library is missing, one nvcc
    per source, all started together. Returns seconds per kernel built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The compiled library of kernel ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def count(name: str, window: int = 0, sinks: bool = False) -> None:
    """One launch of kernel ``name``, and of its window and sink forms."""
    launches[name] += 1
    if window:
        launches[f"{name}/window"] += 1
    if sinks:
        launches[f"{name}/sinks"] += 1


def check(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {code}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Checks a kernel argument: CUDA, dtype, contiguity and (where given) shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.data_ptr() % 32:
        raise ValueError(f"{name}: data pointer must be 32-byte aligned")
