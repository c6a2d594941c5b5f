"""The port's transport against the JAX package's: one wire format both ways
(``transport.types``), and each package's filesystem and zmq senders feeding
the other's receivers, steps in order, a filesystem receiver started at step
k skipping the earlier steps."""

import socket
import time
from dataclasses import fields

import numpy as np
import pytest

from prime_rl_tpu import transport as jtransport
from prime_rl_tpu.configs import trainer as jtrainer_cfg
from prime_rl_tpu.transport import types as jtypes
from prime_rl_tpu_torch import transport as ttransport
from prime_rl_tpu_torch.configs import trainer as ttrainer_cfg
from prime_rl_tpu_torch.transport import types as ttypes


def _sample(types, rng, n: int, env: str):
    """A TrainingSample with every optional stream set."""
    return types.TrainingSample(
        token_ids=rng.integers(0, 500, n), mask=rng.random(n) > 0.3,
        logprobs=-rng.random(n), temperatures=np.full(n, 0.7), env_name=env,
        ref_logprobs=-rng.random(n), advantages=rng.standard_normal(n),
        rl_weights=rng.random(n), ce_weights=rng.random(n), ref_kl_weights=rng.random(n),
        routed_experts=rng.integers(0, 8, (n, 2, 4)),
        mm_kwargs={"pixel_values": rng.random((3, 6)).astype(np.float32),
                   "image_grid_thw": np.array([[1, 1, 3]], np.int64)},
        mm_token_type_ids=rng.integers(0, 2, n))


def _batch(types, step: int, seed: int = 0):
    rng = np.random.default_rng(seed + step)
    return types.TrainingBatch(examples=[_sample(types, rng, n, f"env{n}") for n in (5, 17, 9)],
                               step=step, run_idx=3)


def _assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "examples":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _assert_same(x, y)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f.name
        elif isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a == b, f.name


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wire_decodes_both_ways_with_every_stream(direction):
    src, dst = (jtypes, ttypes) if direction == "jax_to_port" else (ttypes, jtypes)
    batch = _batch(src, step=7)
    data = src.encode(batch)
    got = dst.decode(data)
    assert isinstance(got, dst.TrainingBatch)
    _assert_same(got, _batch(dst, step=7))
    assert dst.encode(got) == data  # re-encoded, the bytes are the same


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("kind", ["filesystem", "zmq"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_transport_feeds_the_other_package_in_order(kind, direction, tmp_path):
    (s_pkg, s_cfg, s_types), (r_pkg, r_cfg, r_types) = (
        ((ttransport, ttrainer_cfg, ttypes), (jtransport, jtrainer_cfg, jtypes))
        if direction == "port_to_jax" else
        ((jtransport, jtrainer_cfg, jtypes), (ttransport, ttrainer_cfg, ttypes)))
    raw = {"type": kind} if kind == "filesystem" else {"type": kind, "batch_port": _free_port()}

    def cfg(module):
        cls = (module.FileSystemTransportConfig if kind == "filesystem"
               else module.ZMQTransportConfig)
        return cls(**raw)

    receiver = r_pkg.setup_training_batch_receiver(cfg(r_cfg), str(tmp_path), 0)
    sender = s_pkg.setup_training_batch_sender(cfg(s_cfg), str(tmp_path))
    try:
        assert receiver.receive(timeout=0.2) is None  # nothing sent yet
        for step in range(3):
            sender.send(_batch(s_types, step))
        for step in range(3):
            got = receiver.receive(timeout=10.0)
            assert got is not None and got.step == step
            _assert_same(got, _batch(r_types, step))
    finally:
        sender.close()
        receiver.close()
    if kind == "filesystem":
        # a receiver started at step 2 (a resumed trainer) skips steps 0 and 1
        late = r_pkg.setup_training_batch_receiver(cfg(r_cfg), str(tmp_path), 2)
        assert late.receive(timeout=1.0).step == 2
        t0 = time.monotonic()
        assert late.receive(timeout=0.3) is None and time.monotonic() - t0 < 5
