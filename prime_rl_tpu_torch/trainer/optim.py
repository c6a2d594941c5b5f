"""Optimizers + LR schedules for the learner (the port of the JAX package's
``trainer/optim.py``, which builds them on optax).

An ``Optimizer`` is a pair of pure functions over the nested params dict,
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, with optax's update rules and state layout: the first update uses
``schedule(0)``, bias correction uses the incremented count, weight decay is
decoupled and added before the learning rate, and the global-norm clip comes
first. The arithmetic is plain PyTorch: the JAX package computes it outside
any kernel too. ``muon`` and ``adafactor_mom`` are not ported yet and raise.

Every rule is elementwise but the clip, so an update also runs one
parameter leaf at a time (the offloaded step, ``trainer/step.py``): the
state's slice of a leaf (``leaf_states``) through ``update`` with the
whole tree's gradient norm given (``norm``), the slices joined again
(``join_leaf_states``), in the same bits as the whole-tree update.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from prime_rl_tpu_torch.configs.shared import (
    AdafactorMomConfig,
    AdamW8bitConfig,
    AdamWConfig,
    ConstantSchedulerConfig,
    CosineSchedulerConfig,
    LinearSchedulerConfig,
    MuonConfig,
    SGDConfig,
    SignSGDConfig,
)

Schedule = Callable[[int], float]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


# ---------------------------------------------------------------------------
# nested-dict trees (params, grads, optimizer moments): leaves in sorted-key
# order, as jax flattens a dict
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest]) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(``a/b/c``, leaf)] in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_paths(tree[k], f"{prefix}/{k}" if prefix else str(k))]
    return [(prefix, tree)]


def tree_unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), f32 scalar on the leaves' device."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree)))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Schedule:
    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return fn


def make_schedule(cfg, base_lr: float) -> Schedule:
    """step -> lr. Warmup is linear from 0; the main schedule counts from the
    end of the warmup."""
    if isinstance(cfg, ConstantSchedulerConfig):
        def main(count: int) -> float:
            return base_lr
    elif isinstance(cfg, LinearSchedulerConfig):
        main = _linear(base_lr, base_lr * cfg.min_lr_ratio, cfg.decay_steps)
    elif isinstance(cfg, CosineSchedulerConfig):
        def main(count: int) -> float:
            c = min(max(count, 0), cfg.decay_steps)
            cosine = 0.5 * (1.0 + math.cos(math.pi * c / cfg.decay_steps))
            return base_lr * ((1.0 - cfg.min_lr_ratio) * cosine + cfg.min_lr_ratio)
    else:
        raise ValueError(f"unknown scheduler {cfg!r}")
    if cfg.warmup_steps > 0:
        warmup = _linear(0.0, base_lr, cfg.warmup_steps)

        def joined(count: int) -> float:
            if count < cfg.warmup_steps:
                return warmup(count)
            return main(count - cfg.warmup_steps)

        return joined
    return main


# ---------------------------------------------------------------------------
# 8-bit moments
# ---------------------------------------------------------------------------

def _blocks(x: torch.Tensor, block: int) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    nb = -(-n // block)
    return torch.nn.functional.pad(flat, (0, nb * block - n)).reshape(nb, block), n


def _quant_q8(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise-absmax int8: flatten, pad to ``block``, return (q [nb, block]
    int8, scale [nb, 1] f32, orig_size)."""
    blocks, n = _blocks(x, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-30)).to(torch.int8)
    return q, scale, n


def _dequant_q8(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


# Nonlinear (log-spaced) 256-entry codebook for the NON-NEGATIVE second
# moment: code 0 = exact zero, codes 1..255 span [1e-6, 1] geometrically
# (~5.6% relative step). With a linear absmax code a coordinate whose
# sqrt(nu) is persistently ~127x below its block's max would re-quantize to
# zero every step and freeze; the log code keeps relative resolution down to
# 1e-6 of the block max. Same idea as bitsandbytes' dynamic quant map.
_NU_CODE = np.concatenate([[0.0], np.geomspace(1e-6, 1.0, 255)]).astype(np.float32)
_nu_code_on: dict[torch.device, torch.Tensor] = {}


def _nu_code(device: torch.device) -> torch.Tensor:
    code = _nu_code_on.get(device)
    if code is None:
        code = _nu_code_on[device] = torch.from_numpy(_NU_CODE).to(device)
    return code


def _quant_nu(x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise dynamic-code uint8 for non-negative x: returns
    (q [nb, block] uint8 codebook indices, absmax scale [nb, 1] f32, size)."""
    blocks, n = _blocks(x, block)
    scale = blocks.amax(dim=1, keepdim=True)  # non-negative input
    y = blocks / torch.clamp(scale, min=1e-30)
    code = _nu_code(x.device)
    idx = torch.searchsorted(code, y)
    lo = torch.clamp(idx - 1, 0, 255)
    hi = torch.clamp(idx, 0, 255)
    q = torch.where(code[hi] - y < y - code[lo], hi, lo)
    return q.to(torch.uint8), scale, n


def _dequant_nu(q: torch.Tensor, scale: torch.Tensor, n: int, shape) -> torch.Tensor:
    return (_nu_code(q.device)[q.long()] * scale).reshape(-1)[:n].reshape(shape)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count, rounded through f32 as the JAX package computes it."""
    d = torch.pow(torch.tensor(decay, dtype=torch.float32),
                  torch.tensor(float(count), dtype=torch.float32))
    return float(torch.tensor(1.0, dtype=torch.float32) - d)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam's direction with f32 moments; state {count, mu, nu}."""

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(updates, state, params=None, norm=None):
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        mu = tree_map(lambda g, m: (1.0 - b1) * g.float() + b1 * m, updates, state["mu"])
        nu = tree_map(lambda g, n: (1.0 - b2) * torch.square(g.float()) + b2 * n,
                      updates, state["nu"])
        new_u = tree_map(lambda m, n: (m / c1) / (torch.sqrt(n / c2) + eps), mu, nu)
        return new_u, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


_LEAF_BLOCKS = 8192  # blocks of one run of the 8-bit update (16.8 M elements at block 2048)


def scale_by_adam_8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                       block: int = 2048) -> Optimizer:
    """Adam whose moments live as blockwise 8-bit codes (+1 f32 scale per
    ``block`` params): ~1.004 bytes/param/moment instead of 4. ``mu`` (signed,
    EMA-self-correcting) uses linear blockwise int8; ``nu`` is stored as
    sqrt(nu) under the nonlinear log codebook (``_NU_CODE``) so small
    coordinates sharing a block with a dominant one keep relative denominator
    resolution instead of freezing at zero. State {count, m: {leaf: {mu_q,
    mu_s, nu_q, nu_s}}}."""

    def init(params):
        def leaf(p):
            z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            mq, ms, _ = _quant_q8(z, block)
            nq, ns, _ = _quant_nu(z, block)
            return {"mu_q": mq, "mu_s": ms, "nu_q": nq, "nu_s": ns}

        return {"count": 0, "m": tree_map(leaf, params)}

    def update(updates, state, params=None, norm=None):
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        code1 = float(_NU_CODE[1])

        def leaf(g, m):
            g = g.float()
            n = g.numel()
            mu = _dequant_q8(m["mu_q"], m["mu_s"], n, g.shape)
            nu_sqrt_q = _dequant_nu(m["nu_q"], m["nu_s"], n, g.shape)
            nu = torch.square(nu_sqrt_q)
            mu = b1 * mu + (1.0 - b1) * g
            nu = b2 * nu + (1.0 - b2) * torch.square(g)
            mu_hat = mu / c1
            nu_hat = nu / c2
            # The log code resolves sqrt(nu) down to 1e-6 of the block max, so
            # the denominator is trustworthy for every representable
            # coordinate; floor it at the smallest nonzero representable value
            # (scale * code[1]) so sub-resolution coordinates can't be exploded
            # by mu noise over eps, and freeze the exact-zero codes.
            nu_floor = (m["nu_s"] * code1).expand(m["nu_q"].shape[0], block).reshape(-1)[:n]
            denom = torch.sqrt(nu_hat) + torch.clamp(nu_floor.reshape(g.shape), min=eps)
            if count <= 1:
                upd = mu_hat / denom
            else:
                upd = torch.where(nu_sqrt_q > 0, mu_hat / denom, 0.0)
            mq, ms, _ = _quant_q8(mu, block)
            nq, ns, _ = _quant_nu(torch.sqrt(nu), block)
            return upd, {"mu_q": mq, "mu_s": ms, "nu_q": nq, "nu_s": ns}

        def chunked(g, m):
            """``leaf`` over runs of whole blocks: blockwise codes and
            elementwise arithmetic give the same bits, with temporaries the
            size of a run instead of the leaf (a stack of experts is hundreds
            of millions of elements)."""
            nb = m["mu_q"].shape[0]
            if nb <= _LEAF_BLOCKS:
                return leaf(g, m)
            flat = g.reshape(-1)
            parts = [leaf(flat[b0 * block:(b0 + _LEAF_BLOCKS) * block],
                          {k: v[b0:b0 + _LEAF_BLOCKS] for k, v in m.items()})
                     for b0 in range(0, nb, _LEAF_BLOCKS)]
            upd = torch.cat([p[0] for p in parts]).reshape(g.shape)
            return upd, {k: torch.cat([p[1][k] for p in parts]) for k in m}

        out = [chunked(g, m) for g, m in zip(tree_leaves(updates), _moment_leaves(state["m"]))]
        new_u = tree_unflatten(updates, [o[0] for o in out])
        new_m = tree_unflatten(updates, [o[1] for o in out])
        return new_u, {"count": count, "m": new_m}

    return Optimizer(init, update)


def _moment_leaves(tree) -> list[dict]:
    if isinstance(tree, dict) and "mu_q" not in tree:
        return [leaf for k in sorted(tree) for leaf in _moment_leaves(tree[k])]
    return [tree]


def _per_param(tree, like) -> list:
    """The entries of an optimizer tree laid out as the params ``like``, one a
    parameter leaf: a tensor (mu, nu, trace) or a dict of them (the 8-bit
    moments' codes and scales)."""
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _per_param(tree[k], like[k])]
    return [tree]


def leaf_states(state: list, params) -> list[list]:
    """Every parameter leaf's slice of the state, in leaf order: stage by
    stage, each tree laid out as ``params`` replaced by ``{"_": its entry
    i}``, the counts as they are. ``update({"_": g_i}, slice_i, {"_": p_i},
    norm)`` is leaf i's part of the whole-tree update."""
    per = [{k: _per_param(v, params) for k, v in st.items() if isinstance(v, dict)}
           for st in state]
    return [[{k: ({"_": per[j][k][i]} if isinstance(v, dict) else v) for k, v in st.items()}
             for j, st in enumerate(state)] for i in range(len(tree_leaves(params)))]


def join_leaf_states(state: list, params, slices: list[list]) -> list:
    """The whole state from the updated slices of every parameter leaf (in
    leaf order): each tree rebuilt in the params' layout, each count taken
    from the slices (every leaf's step gives the same)."""
    out = []
    for j, st in enumerate(state):
        new = {}
        for k, v in st.items():
            if isinstance(v, dict):
                new[k] = tree_unflatten(params, [sl[j][k]["_"] for sl in slices])
            else:
                new[k] = slices[0][j][k] if slices else v
        out.append(new)
    return out


def stochastic_round_to(dtype, x: torch.Tensor, generator: torch.Generator | None = None,
                        bits: torch.Tensor | None = None) -> torch.Tensor:
    """f32 -> bf16 stochastic rounding (bit trick: add 16 random low bits,
    truncate). Unbiased: E[sr(x)] = x, the accumulated-update argument for
    bf16 master weights. Non-finite values pass through unchanged. The random
    bits come from ``generator`` (on x's device) or are given as ``bits``
    (integers, only the low 16 are used)."""
    if dtype != torch.bfloat16:
        return x.to(dtype)
    xf = x.float()
    if bits is None:
        bits = torch.randint(0, 1 << 16, xf.shape, generator=generator, dtype=torch.int32,
                             device=xf.device)
    rnd = bits.to(torch.int32) & 0xFFFF
    # two's-complement int32 arithmetic is the uint32 arithmetic of the bit trick
    rounded = (xf.contiguous().view(torch.int32) + rnd) & -0x10000
    out = rounded.view(torch.float32).to(torch.bfloat16)
    return torch.where(torch.isfinite(xf), out, xf.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# chains
# ---------------------------------------------------------------------------

def _chain(*stages: Optimizer) -> Optimizer:
    def init(params):
        return [s.init(params) for s in stages]

    def update(updates, state, params=None, norm=None):
        new_state = []
        for stage, st in zip(stages, state):
            updates, st = stage.update(updates, st, params, norm)
            new_state.append(st)
        return updates, new_state

    return Optimizer(init, update)


def _stateless(fn) -> Optimizer:
    return Optimizer(lambda params: {}, lambda u, s, p=None, norm=None: (fn(u, p), s))


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def update(updates, state, params=None, norm=None):
        """``norm``: the global norm of the whole gradient tree, where
        ``updates`` is a part of it (a leaf-at-a-time update)."""
        if norm is None:
            norm = global_norm(updates)
        # the select stays on the device: no host round-trip in the step
        keep = norm < max_norm
        return tree_map(lambda g: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm),
                        updates), state

    return Optimizer(lambda params: {}, update)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    if not weight_decay:
        return _stateless(lambda u, p: u)
    return _stateless(lambda u, p: tree_map(lambda g, w: g + weight_decay * w.float(), u, p))


def scale_by_learning_rate(schedule: Schedule) -> Optimizer:
    def update(updates, state, params=None, norm=None):
        lr = schedule(state["count"])
        return tree_map(lambda g: g * -lr, updates), {"count": state["count"] + 1}

    return Optimizer(lambda params: {"count": 0}, update)


def _trace(decay: float, nesterov: bool) -> Optimizer:
    def init(params):
        return {"trace": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                        device=p.device), params)}

    def update(updates, state, params=None, norm=None):
        new_trace = tree_map(lambda g, t: g.float() + decay * t, updates, state["trace"])
        if nesterov:
            updates = tree_map(lambda g, t: g.float() + decay * t, updates, new_trace)
        else:
            updates = new_trace
        return updates, {"trace": new_trace}

    return Optimizer(init, update)


def make_optimizer(cfg, scheduler_cfg, grad_clip: float | None) -> tuple[Optimizer, Schedule]:
    """Build the step transformation: global-norm clip -> optimizer(lr(t)).

    Gradient accumulation is handled by the trainer (grads are already
    normalized by global token counts), so the chain here is purely the
    update rule. State layout: a list with one entry per stage, the clip's
    (empty) first when ``grad_clip`` is set.
    """
    schedule = make_schedule(scheduler_cfg, cfg.lr)
    if isinstance(cfg, AdamWConfig):
        stages = [scale_by_adam(cfg.betas[0], cfg.betas[1], cfg.eps),
                  add_decayed_weights(cfg.weight_decay), scale_by_learning_rate(schedule)]
    elif isinstance(cfg, AdamW8bitConfig):
        stages = [scale_by_adam_8bit(cfg.betas[0], cfg.betas[1], cfg.eps, cfg.block),
                  add_decayed_weights(cfg.weight_decay), scale_by_learning_rate(schedule)]
    elif isinstance(cfg, SGDConfig):
        stages = [add_decayed_weights(cfg.weight_decay)]
        if cfg.momentum:
            stages.append(_trace(cfg.momentum, cfg.nesterov))
        stages.append(scale_by_learning_rate(schedule))
    elif isinstance(cfg, SignSGDConfig):
        stages = [_stateless(lambda u, p: tree_map(torch.sign, u)),
                  add_decayed_weights(cfg.weight_decay), scale_by_learning_rate(schedule)]
    elif isinstance(cfg, (MuonConfig, AdafactorMomConfig)):
        raise NotImplementedError(
            f"optimizer {cfg.type!r} is not ported yet (it waits for the optimizer slice); "
            "use adamw, adamw_8bit, sgd or sign_sgd")
    else:
        raise ValueError(f"unknown optimizer {cfg!r}")
    if grad_clip is not None:
        stages.insert(0, clip_by_global_norm(grad_clip))
    return _chain(*stages), schedule
