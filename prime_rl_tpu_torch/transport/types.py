"""Wire types for the orchestrator → packer → trainer data plane.

The port's own copy of the JAX package's ``transport/types.py`` (numpy and
msgpack only), so both packages speak one wire format: TrainingSample /
TrainingBatch / MicroBatch with per-token streams, dataclasses over numpy
arrays with a msgpack codec (heavy streams travel as raw typed bytes).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Any

import msgpack
import numpy as np

_ND_KEY = "__nd__"


def _encode_hook(obj: Any) -> Any:
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        return {_ND_KEY: True, "d": arr.dtype.str, "s": list(arr.shape), "b": arr.tobytes()}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    raise TypeError(f"cannot msgpack-encode {type(obj)}")


def _decode_hook(obj: dict) -> Any:
    if obj.get(_ND_KEY):
        return np.frombuffer(obj["b"], dtype=np.dtype(obj["d"])).reshape(obj["s"]).copy()
    return obj


def pack(payload: Any) -> bytes:
    return msgpack.packb(payload, default=_encode_hook, use_bin_type=True)


def unpack(data: bytes) -> Any:
    return msgpack.unpackb(data, object_hook=_decode_hook, raw=False, strict_map_key=False)


def _as_arr(x: Any, dtype: Any) -> np.ndarray | None:
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        return x.astype(dtype, copy=False)
    return np.asarray(x, dtype=dtype)


@dataclass
class TrainingSample:
    """One training example — one branch of a rollout as a flat token stream.

    No prompt/completion split: multi-turn branches interleave context and
    model-sampled spans; ``mask`` marks trainable (model-sampled) tokens and
    ``logprobs``/``temperatures`` are per-token aligned. The optional
    component weight streams (rl/ce/ref_kl) and ``advantages`` follow the
    reference's three-component loss routing contract
    (reference: transport/types.py:22-69, algo/routing.py).
    """

    token_ids: np.ndarray  # int32 [L]
    mask: np.ndarray  # bool [L]
    logprobs: np.ndarray  # float32 [L]
    temperatures: np.ndarray  # float32 [L]
    env_name: str = ""
    ref_logprobs: np.ndarray | None = None
    advantages: np.ndarray | None = None
    rl_weights: np.ndarray | None = None
    ce_weights: np.ndarray | None = None
    ref_kl_weights: np.ndarray | None = None
    routed_experts: np.ndarray | None = None  # int32 [L, layers, topk]
    mm_kwargs: dict[str, np.ndarray] | None = None
    mm_token_type_ids: np.ndarray | None = None

    def __post_init__(self):
        self.token_ids = _as_arr(self.token_ids, np.int32)
        self.mask = _as_arr(self.mask, np.bool_)
        self.logprobs = _as_arr(self.logprobs, np.float32)
        self.temperatures = _as_arr(self.temperatures, np.float32)
        self.ref_logprobs = _as_arr(self.ref_logprobs, np.float32)
        self.advantages = _as_arr(self.advantages, np.float32)
        self.rl_weights = _as_arr(self.rl_weights, np.float32)
        self.ce_weights = _as_arr(self.ce_weights, np.float32)
        self.ref_kl_weights = _as_arr(self.ref_kl_weights, np.float32)
        self.routed_experts = _as_arr(self.routed_experts, np.int32)
        self.mm_token_type_ids = _as_arr(self.mm_token_type_ids, np.int32)
        n = len(self.token_ids)
        for name in ("mask", "logprobs", "temperatures"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"{name} length {len(getattr(self, name))} != token_ids length {n}")

    def __len__(self) -> int:
        return len(self.token_ids)


@dataclass
class TrainingBatch:
    """Orchestrator → packer."""

    examples: list[TrainingSample]
    step: int
    run_idx: int | None = None


@dataclass
class MicroBatch:
    """Packer → trainer: one packed [1, L] row of concatenated sequences.

    ``seq_lens`` delimits the packed sequences; the trainer derives
    segment/position ids from it (attention masks on segment ids)."""

    input_ids: np.ndarray  # int32 [L]
    loss_mask: np.ndarray  # bool [L]
    advantages: np.ndarray  # float32 [L]
    inference_logprobs: np.ndarray  # float32 [L]
    position_ids: np.ndarray  # int32 [L]
    temperatures: np.ndarray  # float32 [L]
    seq_lens: list[int] = field(default_factory=list)
    env_names: list[str] = field(default_factory=list)
    ref_logprobs: np.ndarray | None = None
    rl_weights: np.ndarray | None = None
    ce_weights: np.ndarray | None = None
    ref_kl_weights: np.ndarray | None = None
    routed_experts: np.ndarray | None = None
    run_id: str | None = None
    run_step: int | None = None
    # VLM: per-packed-sample HF-processor outputs ({"pixel_values": [P_i,
    # patch_dim], "image_grid_thw": [n_i, 3]} or None), aligned with
    # ``seq_lens`` — lets a multi-host packer ship vision data so each rank
    # can assemble its micro-batch patch buffers (reference:
    # trainer/batch.py:576-617 modality-uniform DP distribution)
    mm_kwargs_list: list[dict | None] | None = None

    def __post_init__(self):
        self.input_ids = _as_arr(self.input_ids, np.int32)
        self.loss_mask = _as_arr(self.loss_mask, np.bool_)
        self.advantages = _as_arr(self.advantages, np.float32)
        self.inference_logprobs = _as_arr(self.inference_logprobs, np.float32)
        self.position_ids = _as_arr(self.position_ids, np.int32)
        self.temperatures = _as_arr(self.temperatures, np.float32)
        self.ref_logprobs = _as_arr(self.ref_logprobs, np.float32)
        self.rl_weights = _as_arr(self.rl_weights, np.float32)
        self.ce_weights = _as_arr(self.ce_weights, np.float32)
        self.ref_kl_weights = _as_arr(self.ref_kl_weights, np.float32)
        self.routed_experts = _as_arr(self.routed_experts, np.int32)

    def __len__(self) -> int:
        return len(self.input_ids)


def _to_wire(obj: Any) -> Any:
    if isinstance(obj, (TrainingSample, TrainingBatch, MicroBatch)):
        return {"__t__": type(obj).__name__, **{f.name: _to_wire(getattr(obj, f.name)) for f in fields(obj)}}
    if isinstance(obj, list):
        return [_to_wire(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _to_wire(v) for k, v in obj.items()}
    return obj


_TYPES = {"TrainingSample": TrainingSample, "TrainingBatch": TrainingBatch, "MicroBatch": MicroBatch}


def _from_wire(obj: Any) -> Any:
    if isinstance(obj, dict) and "__t__" in obj:
        cls = _TYPES[obj.pop("__t__")]
        return cls(**{k: _from_wire(v) for k, v in obj.items()})
    if isinstance(obj, dict):
        return {k: _from_wire(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_wire(v) for v in obj]
    return obj


def encode(obj: TrainingBatch | MicroBatch | list[MicroBatch]) -> bytes:
    return pack(_to_wire(obj))


def decode(data: bytes) -> Any:
    return _from_wire(unpack(data))
