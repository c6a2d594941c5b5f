"""Optimizers + LR schedules for the learner (the port of the JAX package's
``trainer/optim.py``, which builds them on optax).

An ``Optimizer`` is a pair of pure functions over the nested params dict,
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, with optax's update rules and state layout: the first update uses
``schedule(0)``, bias correction uses the incremented count, weight decay is
decoupled and added before the learning rate, and the global-norm clip comes
first. The arithmetic is plain PyTorch: the JAX package computes it outside
any kernel too.

``adafactor_mom`` is optax's ``adafactor`` chain as the JAX package builds it
(``scale_by_factored_rms``, ``clip_by_block_rms``, the learning rate, a bf16
``ema`` momentum, the weight decay, the sign flip), stage by stage.
``muon`` runs optax's ``scale_by_muon`` on every hidden matrix and AdamW on
everything else (``scale_by_muon_split``); which leaves are hidden matrices
differs from the JAX package on purpose (ROADMAP.md, Queue 3).

Every rule but the global-norm clip works within one parameter leaf, so an
update also runs one leaf at a time (the offloaded step,
``trainer/step.py``): the state's slice of a leaf (``leaf_states``) through
``update`` with the whole tree's gradient norm given (``norm``), the slices
joined again (``join_leaf_states``), in the same bits as the whole-tree
update.
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
        out = [_adam_leaf(g.float(), m, n, b1, b2, eps, c1, c2) for g, m, n in
               zip(tree_leaves(updates), tree_leaves(state["mu"]), tree_leaves(state["nu"]))]
        new_u, mu, nu = (tree_unflatten(updates, [o[i] for o in out]) for i in range(3))
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
    """The per-leaf dict entries of a moments tree (the 8-bit codes, Muon's
    split), in leaf order."""
    if isinstance(tree, dict) and not ({"mu_q", "mu"} & tree.keys()):
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


def _rounded(rate: float, dtype: torch.dtype) -> float:
    """``rate`` rounded to ``dtype`` on the host: a Python float times a
    tensor of that dtype then gives the product of the two ``dtype`` values,
    rounded once, as JAX multiplies a Python float into a bf16 array, with no
    copy to the device."""
    return float(torch.tensor(rate, dtype=dtype))


def _decayed(g: torch.Tensor, w: torch.Tensor, weight_decay: float) -> torch.Tensor:
    """g + weight_decay * w, the product in w's dtype with the rate rounded
    to it, as optax multiplies a Python float into a bf16 master."""
    return g + w * _rounded(weight_decay, w.dtype)


def add_decayed_weights(weight_decay: float) -> Optimizer:
    if not weight_decay:
        return _stateless(lambda u, p: u)
    return _stateless(lambda u, p: tree_map(lambda g, w: _decayed(g, w, weight_decay), u, p))


def scale_by_learning_rate(schedule: Schedule, flip_sign: bool = True) -> Optimizer:
    def update(updates, state, params=None, norm=None):
        lr = schedule(state["count"])
        lr = -lr if flip_sign else lr
        return tree_map(lambda g: g * lr, updates), {"count": state["count"] + 1}

    return Optimizer(lambda params: {"count": 0}, update)


# ---------------------------------------------------------------------------
# Adafactor (optax's ``adafactor`` as the JAX package configures it)
# ---------------------------------------------------------------------------

def _factored_dims(shape, min_dim_size_to_factor: int) -> tuple[int, int] | None:
    """The two largest axes of ``shape`` (optax's choice, ``np.argsort`` and
    its order among equal sizes included), or None where the second largest
    is under ``min_dim_size_to_factor``."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def scale_by_factored_rms(decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> Optimizer:
    """Adafactor's second-moment scaling: a leaf whose two largest axes both
    reach ``min_dim_size_to_factor`` keeps the means of the squared gradient
    over each of them (``v_row``, ``v_col``; the other axes, a stack's layer
    axis, ride along) and scales by their rank-1 estimate; a smaller leaf
    keeps the full mean (``v``). The decay is 1 - (step + 1)^-decay_rate.
    State {count, v_row, v_col, v}, each tree in the params' dtype with a
    zero [1] where a leaf does not use it."""

    def init(params):
        def stats(p):
            """(v_row, v_col, v) of one leaf: a zero [1] for the unused."""
            def zeros(shape):
                return torch.zeros(shape, dtype=p.dtype, device=p.device)

            dims = _factored_dims(p.shape, min_dim_size_to_factor)
            if dims is None:
                return zeros(1), zeros(1), zeros(p.shape)
            return (zeros(np.delete(p.shape, dims[1]).tolist()),
                    zeros(np.delete(p.shape, dims[0]).tolist()), zeros(1))

        out = [stats(p) for p in tree_leaves(params)]
        return {"count": 0, **{k: tree_unflatten(params, [o[i] for o in out])
                               for i, k in enumerate(("v_row", "v_col", "v"))}}

    def update(updates, state, params=None, norm=None):
        # the decay in f32, as optax's _decay_rate_pow computes it
        t = torch.tensor(float(state["count"] + 1), dtype=torch.float32)
        decay = 1.0 - t ** (-decay_rate)
        d_t, keep = float(decay), float(1.0 - decay)

        def leaf(g, v_row, v_col, v, p):
            dtype = p.dtype
            grad_sqr = g * g + epsilon
            dims = _factored_dims(p.shape, min_dim_size_to_factor)
            if dims is None:
                new_v = (d_t * v.float() + keep * grad_sqr).to(dtype)
                return g * new_v ** -0.5, v_row, v_col, new_v
            d1, d0 = dims
            new_row = (d_t * v_row.float() + keep * grad_sqr.mean(dim=d0)).to(dtype)
            new_col = (d_t * v_col.float() + keep * grad_sqr.mean(dim=d1)).to(dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (new_row / new_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
            col_factor = new_col ** -0.5
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            return u, new_row, new_col, v

        out = [leaf(*a) for a in zip(tree_leaves(updates), tree_leaves(state["v_row"]),
                                     tree_leaves(state["v_col"]), tree_leaves(state["v"]),
                                     tree_leaves(params))]
        parts = [tree_unflatten(updates, [o[i] for o in out]) for i in range(4)]
        return parts[0], {"count": state["count"] + 1, "v_row": parts[1], "v_col": parts[2],
                          "v": parts[3]}

    return Optimizer(init, update)


def clip_by_block_rms(threshold: float) -> Optimizer:
    """Each leaf divided by max(1, its root-mean-square / ``threshold``)."""
    def clip(u):
        return u / torch.clamp(torch.sqrt(torch.mean(u * u)) / threshold, min=1.0)

    return _stateless(lambda u, p: tree_map(clip, u))


def ema(decay: float, accumulator_dtype=torch.bfloat16) -> Optimizer:
    """optax's ``ema`` without debiasing: the update is the new average in the
    updates' dtype, the state keeps it in ``accumulator_dtype``. The decayed
    term is computed in the accumulator's dtype, the rate rounded to it, as
    JAX multiplies a Python float into a bf16 array."""

    def init(params):
        return {"count": 0, "ema": tree_map(lambda p: torch.zeros(
            p.shape, dtype=accumulator_dtype, device=p.device), params)}

    def update(updates, state, params=None, norm=None):
        def leaf(g, t):
            return (1.0 - decay) * g + t * _rounded(decay, t.dtype)

        new = tree_map(leaf, updates, state["ema"])
        return new, {"count": state["count"] + 1,
                     "ema": tree_map(lambda t: t.to(accumulator_dtype), new)}

    return Optimizer(init, update)


def scale(factor: float) -> Optimizer:
    return _stateless(lambda u, p: tree_map(lambda g: g * factor, u))


# ---------------------------------------------------------------------------
# Muon
# ---------------------------------------------------------------------------

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def is_hidden_matrix(path: str, p: torch.Tensor) -> bool:
    """The port's Muon rule: a leaf stacked over layers whose per-layer slice
    is a matrix, i.e. of three or more dims (the projections [NL, in, out],
    the experts' [NL, E, in, out]). Everything else, the embeddings, the LM
    head, every norm or bias stack [NL, d] and every 1-D leaf, goes to AdamW.
    Unlike the JAX package's ``_is_matrix`` (which sends the stacked norms to
    Newton-Schulz and the projections to optax's inner Adam), ROADMAP.md
    Queue 3."""
    return p.dim() >= 3 and path.split("/")[0] not in ("embed", "lm_head")


def newton_schulz(x: torch.Tensor, steps: int = 5, eps: float = 1e-8) -> torch.Tensor:
    """optax's ``orthogonalize_via_newton_schulz`` over the last two axes of
    ``x`` (every leading axis a batch), in float32: a slice with more rows
    than columns runs transposed; each slice is divided by its Frobenius norm
    + eps, then ``steps`` quintic iterations. On the card the products must
    be true float32: TF32 would change the result, so it raises where
    ``torch.backends.cuda.matmul.allow_tf32`` is on."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("Newton-Schulz needs float32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    x = x.float()
    transposed = x.shape[-2] > x.shape[-1]
    if transposed:
        x = x.transpose(-2, -1)
    x = x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + eps)
    c0, c1, c2 = (torch.tensor(c, dtype=torch.float32).item() for c in NS_COEFFS)
    for _ in range(steps):
        a = x @ x.transpose(-2, -1)
        b = c1 * a + (c2 * a) @ a
        x = c0 * x + b @ x
    return x.transpose(-2, -1) if transposed else x


def _adam_leaf(g, mu, nu, b1, b2, eps, c1, c2):
    """optax's ``scale_by_adam`` on one leaf: (direction, mu, nu)."""
    mu = (1.0 - b1) * g + b1 * mu
    nu = (1.0 - b2) * torch.square(g) + b2 * nu
    return (mu / c1) / (torch.sqrt(nu / c2) + eps), mu, nu


def scale_by_muon_split(schedule: Schedule, adamw_schedule: Schedule, beta: float,
                        weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, ns_steps: int = 5) -> Optimizer:
    """Muon on the hidden matrices (``is_hidden_matrix``), AdamW on the rest,
    each with its weight decay and learning rate: the composition of optax's
    ``contrib.muon(schedule, beta, weight_decay, muon_weight_dimension_numbers
    = (-2, -1) per hidden matrix)`` and ``adamw(adamw_schedule, b1, b2, eps,
    weight_decay)`` under ``multi_transform``.

    A hidden matrix: Nesterov momentum with both bias corrections, Newton-
    Schulz per layer (and expert), times sqrt(max(1, out / in)). The rule is
    chosen when the state is made, and each leaf's state says which it took:
    ``{"mu"}`` for Muon, ``{"mu", "nu"}`` for AdamW, so that a leaf's slice
    updates alone. State {count, m: tree of those}, f32."""

    def init(params):
        def entry(path, p):
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if is_hidden_matrix(path, p):
                return {"mu": zeros}
            return {"mu": zeros, "nu": torch.zeros_like(zeros)}

        return {"count": 0, "m": tree_unflatten(params, [entry(path, p) for path, p
                                                         in tree_paths(params)])}

    def update(updates, state, params=None, norm=None):
        count = state["count"] + 1
        lr, adam_lr = schedule(state["count"]), adamw_schedule(state["count"])
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
        nbc, nbc_next = _bias_correction(beta, count), _bias_correction(beta, count + 1)

        def leaf(g, m, p):
            g = g.float()
            if "nu" not in m:
                mu = (1.0 - beta) * g + beta * m["mu"]
                mu_hat = beta * (mu / nbc_next) + (1.0 - beta) * (g / nbc)
                out, inp = p.shape[-1], p.shape[-2]
                u = newton_schulz(mu_hat, ns_steps, eps)
                u = math.sqrt(max(1.0, out / inp)) * u
                step = lr
                new = {"mu": mu}
            else:
                u, mu, nu = _adam_leaf(g, m["mu"], m["nu"], b1, b2, eps, bc1, bc2)
                step = adam_lr
                new = {"mu": mu, "nu": nu}
            if weight_decay:
                u = _decayed(u, p, weight_decay)
            return u * -step, new

        out = [leaf(g, m, p) for g, m, p in zip(tree_leaves(updates), _moment_leaves(state["m"]),
                                               tree_leaves(params))]
        return (tree_unflatten(updates, [o[0] for o in out]),
                {"count": count, "m": tree_unflatten(updates, [o[1] for o in out])})

    return Optimizer(init, update)


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
    elif isinstance(cfg, AdafactorMomConfig):
        stages = [scale_by_factored_rms(cfg.decay_rate)]
        if cfg.clipping_threshold is not None:
            stages.append(clip_by_block_rms(cfg.clipping_threshold))
        stages += [scale_by_learning_rate(schedule, flip_sign=False),
                   ema(cfg.momentum, torch.bfloat16)]
        if cfg.weight_decay:
            stages.append(add_decayed_weights(cfg.weight_decay))
        stages.append(scale(-1.0))
    elif isinstance(cfg, MuonConfig):
        stages = [scale_by_muon_split(schedule, make_schedule(scheduler_cfg, cfg.adamw_lr),
                                      cfg.momentum, cfg.weight_decay)]
    else:
        raise ValueError(f"unknown optimizer {cfg!r}")
    if grad_clip is not None:
        stages.insert(0, clip_by_global_norm(grad_clip))
    return _chain(*stages), schedule
