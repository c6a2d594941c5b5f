"""Import boundary of the PyTorch port: every module of ``prime_rl_tpu_torch``
imports with ``jax`` and ``prime_rl_tpu`` made unimportable, the modules of
the orchestrator's CPU process import without ``torch`` too, and the port's
inference and trainer configs run on the card unless asked otherwise."""

import subprocess
import sys
import textwrap
from pathlib import Path

import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_CHECK = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.modules["prime_rl_tpu"] = None
    import prime_rl_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(prime_rl_tpu_torch.__path__,
                                                   "prime_rl_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "prime_rl_tpu")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    from prime_rl_tpu_torch.entrypoints.inference import InferenceConfig
    assert InferenceConfig().device == "cuda"
    from prime_rl_tpu_torch.entrypoints.trainer import TrainerConfig
    assert TrainerConfig().device == "cuda"
    for new in ("ops.sparse_mla", "ops.sparse_mla_kernel", "ops.moe", "models.glm4_moe",
                "models.mla_moe", "models.gpt_oss"):
        assert "prime_rl_tpu_torch." + new in names, new
    for new in LOOP_MODULES + SFT_MOE_MODULES:
        assert "prime_rl_tpu_torch." + new in names, new
    from prime_rl_tpu_torch.configs import RLConfig, SFTConfig
    assert RLConfig().trainer.device == RLConfig().inference.device == "cuda"
    assert SFTConfig().device == "cuda"
    print(len(names))
""")

# the loop slice's modules
LOOP_MODULES = (
    "transport", "transport.base", "transport.zmq", "transport.filesystem",
    "configs.algorithm", "configs.orchestrator", "configs.env_server", "configs.rl",
    "envs.types", "envs.client", "envs.base", "envs.envclient", "envs.server",
    "envs.builtin", "envs.builtin.reverse_text", "envs.builtin.fixed_completion",
    "envs.builtin.multi_turn", "envs.builtin.dominant_color",
    "renderers.renderer", "utils.async_utils", "utils.heartbeat",
    "orchestrator.algo.base", "orchestrator.algo.algorithms", "orchestrator.filters",
    "orchestrator.metrics", "orchestrator.source", "orchestrator.trajectories",
    "orchestrator.pool", "orchestrator.orchestrator",
    "entrypoints.orchestrator", "entrypoints.env_server", "entrypoints.rl",
    "entrypoints.colocated")
# the SFT and MoE-families slice's modules, and the two hybrids' (the
# GatedDeltaNet's, then Nemotron-H's)
SFT_MOE_MODULES = ("trainer.sft", "trainer.sft.data", "trainer.sft.train", "entrypoints.sft",
                   "models.qwen3_moe", "models.glm4_moe", "models.gated_moe",
                   "models.qwen3_next", "ops.gated_delta", "ops.mamba", "models.nemotron_h")
_CHECK = _CHECK.replace("LOOP_MODULES", repr(LOOP_MODULES)).replace(
    "SFT_MOE_MODULES", repr(SFT_MOE_MODULES))

# the orchestrator's process (the orchestrator, the envs, the transport and
# their entry points) never uses the card: it imports without torch
_CPU_PROCESS = textwrap.dedent("""
    import importlib, pkgutil, sys
    for blocked in ("jax", "prime_rl_tpu", "torch"):
        sys.modules[blocked] = None
    import prime_rl_tpu_torch
    names = []
    for pkg in ("orchestrator", "envs", "transport"):
        mod = importlib.import_module("prime_rl_tpu_torch." + pkg)
        names += [pkg] + [m.name for m in pkgutil.walk_packages(mod.__path__,
                                                                 f"prime_rl_tpu_torch.{pkg}.")]
    names += ["entrypoints.orchestrator", "entrypoints.env_server"]
    for name in names:
        importlib.import_module(name if name.startswith("prime") else "prime_rl_tpu_torch." + name)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "prime_rl_tpu")
                    and sys.modules[m] is not None)
    assert not leaked, leaked
    print(len(names))
""")


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 88  # every module of the slices so far was imported


def test_orchestrator_process_imports_without_torch():
    out = subprocess.run([sys.executable, "-c", _CPU_PROCESS], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_kernel_libraries_are_keyed_by_their_shared_headers(tmp_path, monkeypatch):
    """A kernel source includes ``csrc/*.cuh``: a changed header must give
    its library another path, or a stale build would load; the build never
    runs here (no ``nvcc``), only the key."""
    from prime_rl_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert _build.library_path("k") != first
    monkeypatch.undo()
    for name in _build.KERNELS:  # every source of the port has its key
        assert _build.library_path(name).name.startswith(f"{name}-")
