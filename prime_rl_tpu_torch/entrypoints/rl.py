"""``python -m prime_rl_tpu_torch.entrypoints.rl @ config.toml`` — the RL
launcher (the port of the JAX package's ``entrypoints/rl.py``, local mode):
splits the merged config, spawns the colocated trainer + sampler (or the
inference server and the trainer), the env servers and the orchestrator as
subprocesses by module path, and fails the whole run fast when any child dies.

The orchestrator is a CPU process: it is spawned with no visible card.
Cluster deployment, more than one trainer process and the disaggregated
device weight planes raise until the multi-card slice (ROADMAP.md, Queue 1
item 11).
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

from prime_rl_tpu_torch.configs import RLConfig, parse_config
from prime_rl_tpu_torch.configs.loader import to_toml
from prime_rl_tpu_torch.utils import pathing

_MULTI_CARD = "not ported yet (ROADMAP.md, Queue 1 item 11: more than one process or card)"


def _write_subconfig(cfg_model, path: Path) -> Path:
    data = cfg_model.model_dump(exclude_none=True, mode="json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(to_toml(data))
    return path


def _spawn(name: str, args: list[str], output_dir: Path, env: dict | None = None) -> subprocess.Popen:
    logs = pathing.logs_dir(output_dir)
    logs.mkdir(parents=True, exist_ok=True)
    # the children import this package from where this process found it
    root = str(Path(__file__).resolve().parents[2])
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    with open(logs / f"{name}.out", "w") as out:  # the child keeps its own descriptor
        return subprocess.Popen(args, stdout=out, stderr=subprocess.STDOUT,
                                env={**os.environ, "PYTHONPATH": path, **(env or {})})


def _resolve_resume(config: RLConfig, output_dir: Path) -> None:
    """Resolve ``--trainer.ckpt.resume-step -1`` to the newest step both the
    trainer and the orchestrator checkpointed, pin it in both subconfigs, and
    clean artifacts from beyond it."""
    step = config.trainer.ckpt.resume_step
    ckpts = pathing.list_step_dirs(output_dir / "checkpoints")
    both = [
        s for s in ckpts
        if (pathing.trainer_ckpt_dir(output_dir, s) / "state.pt").exists()
        and (pathing.orch_ckpt_dir(output_dir, s) / "state.json").exists()
    ]
    if step == -1:
        if not both:
            print("no joint checkpoint found; starting fresh")
            config.trainer.ckpt.resume_step = None
            config.orchestrator.ckpt.resume_step = None
            return
        step = both[-1]
    config.trainer.ckpt.resume_step = step
    config.orchestrator.ckpt.resume_step = step
    # snapshots and rollouts written after the resume point would break the
    # version protocol on restart
    for parent in ("weights", "rollouts"):
        for s in pathing.list_step_dirs(output_dir / parent, stable_only=False):
            if s > step:
                shutil.rmtree(output_dir / parent / f"step_{s}", ignore_errors=True)
    print(f"resuming both processes from step {step}")


def _monitor(children: dict[str, subprocess.Popen]) -> int:
    """Fail-fast child monitor: 0 when the trainer or the orchestrator
    finishes cleanly, the child's code when any other exit comes first."""
    while True:
        for name, proc in list(children.items()):
            code = proc.poll()
            if code is None:
                continue
            if name == "trainer" and code == 0:
                print("trainer finished cleanly; shutting down")
                return 0
            if name == "orchestrator" and code == 0:
                # give the trainer a grace window to finish its final
                # checkpoint save before SIGTERM
                trainer = children.get("trainer")
                if trainer is not None and trainer.poll() is None:
                    try:
                        code = trainer.wait(timeout=120)
                    except subprocess.TimeoutExpired:
                        code = 0
                    if code != 0:
                        print(f"process trainer exited with {code}; failing run")
                        return code
                print("orchestrator finished cleanly; shutting down")
                return 0
            print(f"process {name} exited with {code}; failing run")
            return code or 1
        time.sleep(1.0)


def rl(config: RLConfig) -> int:
    if config.deploy is not None:
        raise NotImplementedError(f"deploy: {_MULTI_CARD}")
    if config.trainer_procs > 1:
        raise NotImplementedError(f"trainer_procs = {config.trainer_procs}: {_MULTI_CARD}")
    if not config.colocated and config.trainer.broadcast.type == "device":
        raise NotImplementedError(f"the {config.trainer.broadcast.mode!r} weight plane: "
                                  f"{_MULTI_CARD}")
    output_dir = Path(config.output_dir)
    if config.trainer.ckpt.resume_step is not None:
        _resolve_resume(config, output_dir)
    # propagate the shared output dir into every process config
    config.trainer.output_dir = str(output_dir)
    config.orchestrator.output_dir = str(output_dir)
    config.inference.output_dir = str(output_dir)
    if config.colocated:
        config.orchestrator.watch = "liveness"
    # shutdown carve-out: the last target_lag+1 policies are never consumed by
    # a shipped batch
    if config.trainer.final_publish_skip == 0 and config.trainer.max_steps is not None:
        config.trainer.final_publish_skip = config.orchestrator.target_lag + 1
    cfg_dir = output_dir / "configs"
    trainer_toml = _write_subconfig(config.trainer, cfg_dir / "trainer.toml")
    orch_toml = _write_subconfig(config.orchestrator, cfg_dir / "orchestrator.toml")
    inf_toml = _write_subconfig(config.inference, cfg_dir / "inference.toml")
    rl_toml = _write_subconfig(config, cfg_dir / "rl_resolved.toml")
    if config.dry_run:
        print(f"resolved configs written to {cfg_dir}")
        return 0

    py = sys.executable
    children: dict[str, subprocess.Popen] = {}
    try:
        if config.colocated:
            # one process owns the card: learner + sampler time-sliced, the
            # weight swap in process
            children["trainer"] = _spawn(
                "colocated", [py, "-m", "prime_rl_tpu_torch.entrypoints.colocated", f"@{rl_toml}"],
                output_dir)
        else:
            children["inference"] = _spawn(
                "inference", [py, "-m", "prime_rl_tpu_torch.entrypoints.inference", f"@{inf_toml}"],
                output_dir)
        for i, es in enumerate(config.env_servers):
            es.output_dir = str(output_dir)
            es_toml = _write_subconfig(es, cfg_dir / f"env_{i}.toml")
            children[f"env_{es.env}_{i}"] = _spawn(
                f"env_{i}", [py, "-m", "prime_rl_tpu_torch.entrypoints.env_server", f"@{es_toml}"],
                output_dir)
        children["orchestrator"] = _spawn(
            "orchestrator",
            [py, "-m", "prime_rl_tpu_torch.entrypoints.orchestrator", f"@{orch_toml}"],
            output_dir, env={"CUDA_VISIBLE_DEVICES": ""})  # the orchestrator never uses the card
        if not config.colocated:
            children["trainer"] = _spawn(
                "trainer", [py, "-m", "prime_rl_tpu_torch.entrypoints.trainer", f"@{trainer_toml}"],
                output_dir)
        print(f"RL run: {len(children)} processes, logs under {output_dir}/logs/", flush=True)
        return _monitor(children)
    finally:
        for proc in children.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = time.time() + 15
        for proc in children.values():
            try:
                proc.wait(timeout=max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def main() -> None:
    sys.exit(rl(parse_config(RLConfig)))


if __name__ == "__main__":
    main()
