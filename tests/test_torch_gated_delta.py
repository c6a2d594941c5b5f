"""The GatedDeltaNet ops of the port (``ops/gated_delta.py``,
``ops/mamba.causal_conv1d``) on the CPU against the JAX package's, in
float32 on inputs made from a numpy seed: the chunked rule at (S, chunk) of
(96, 32), (64, 64) and (50, 16), with packed segments and padding, an
initial state and a continued chunk (``prev_seg_tail``), its gradients
against ``jax.grad``; the one-token recurrent rule, and the chunked rule
against a rollout of the recurrent one; the segment-aware causal conv.

The JAX rule runs under ``jax.jit`` (eagerly, each call traces and compiles
its scan again).

Tolerances: atol 1e-5 and rtol 1e-4 on outputs, states and gradients (the
port solves (I - A)^-1 by a triangular solve where JAX multiplies out a
Neumann series: the same matrix, other roundings)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.ops import gated_delta as jgd
from prime_rl_tpu.ops import mamba as jmamba
from prime_rl_tpu_torch.ops import gated_delta as tgd
from prime_rl_tpu_torch.ops import mamba as tmamba

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def j_chunk(q, k, v, g, beta, chunk_size, segment_ids=None, initial_state=None,
            prev_seg_tail=None):
    return jgd.chunk_gated_delta_rule(q, k, v, g, beta, chunk_size=chunk_size,
                                      segment_ids=segment_ids, initial_state=initial_state,
                                      prev_seg_tail=prev_seg_tail)


def _inputs(seed: int, b: int, s: int, h: int, dk: int, dv: int):
    rng = np.random.default_rng(seed)
    f = np.float32
    q = rng.standard_normal((b, s, h, dk)).astype(f)
    k = rng.standard_normal((b, s, h, dk)).astype(f)
    v = rng.standard_normal((b, s, h, dv)).astype(f)
    g = -np.exp(rng.standard_normal((b, s, h)).astype(f) - 2.0)  # log decays <= 0
    beta = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, h))))).astype(f)
    return q, k, v, g, beta


def _segments(b: int, s: int, lens: list[list[int]]) -> np.ndarray:
    seg = np.zeros((b, s), np.int32)
    for r, row in enumerate(lens):
        off = 0
        for i, n in enumerate(row):
            seg[r, off:off + n] = i + 1
            off += n
    return seg


def _t(x):
    return torch.from_numpy(np.asarray(x))


CASES = (
    # (S, chunk, segment lengths of each row or None)
    (96, 32, None),
    (64, 64, [[20, 30, 14], [64]]),
    (50, 16, [[17, 21], [5, 5, 30]]),  # padded tails, a reset mid-chunk
)


@pytest.mark.parametrize("s,chunk,lens", CASES)
def test_chunked_rule_matches_jax(s, chunk, lens):
    b, h, dk, dv = 2, 3, 16, 8
    q, k, v, g, beta = _inputs(s, b, s, h, dk, dv)
    seg = None if lens is None else _segments(b, s, lens)
    state0 = np.random.default_rng(1).standard_normal((b, h, dk, dv)).astype(np.float32)
    for init in (None, state0):
        jout, jst = j_chunk(
            *(jnp.asarray(x) for x in (q, k, v, g, beta)), chunk_size=chunk,
            segment_ids=None if seg is None else jnp.asarray(seg),
            initial_state=None if init is None else jnp.asarray(init))
        tout, tst = tgd.chunk_gated_delta_rule(
            *(_t(x) for x in (q, k, v, g, beta)), chunk_size=chunk,
            segment_ids=None if seg is None else _t(seg),
            initial_state=None if init is None else _t(init))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


def test_continued_chunk_matches_jax():
    """A serving chunk that continues a carried state (``prev_seg_tail``: no
    reset at position 0) over a padded tail."""
    b, s, h, dk, dv = 1, 40, 2, 16, 16
    q, k, v, g, beta = _inputs(7, b, s, h, dk, dv)
    seg = _segments(b, s, [[33]])
    state0 = np.random.default_rng(2).standard_normal((b, h, dk, dv)).astype(np.float32)
    tail = np.ones((b,), np.int32)
    jout, jst = j_chunk(
        *(jnp.asarray(x) for x in (q, k, v, g, beta)), chunk_size=16,
        segment_ids=jnp.asarray(seg), initial_state=jnp.asarray(state0),
        prev_seg_tail=jnp.asarray(tail))
    tout, tst = tgd.chunk_gated_delta_rule(
        *(_t(x) for x in (q, k, v, g, beta)), chunk_size=16, segment_ids=_t(seg),
        initial_state=_t(state0), prev_seg_tail=_t(tail))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("s,chunk,lens", CASES)
def test_chunked_rule_gradients_match_jax(s, chunk, lens):
    b, h, dk, dv = 2, 2, 8, 8
    q, k, v, g, beta = _inputs(100 + s, b, s, h, dk, dv)
    seg = None if lens is None else _segments(b, s, lens)
    w_out = np.random.default_rng(3).standard_normal((b, s, h, dv)).astype(np.float32)
    w_st = np.random.default_rng(4).standard_normal((b, h, dk, dv)).astype(np.float32)

    def jloss(q, k, v, g, beta):
        out, st = jgd.chunk_gated_delta_rule(
            q, k, v, g, beta, chunk_size=chunk,
            segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out * w_out) + jnp.sum(st * w_st)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *(jnp.asarray(x) for x in (q, k, v, g, beta)))
    args = [_t(x).requires_grad_() for x in (q, k, v, g, beta)]
    out, st = tgd.chunk_gated_delta_rule(*args, chunk_size=chunk,
                                         segment_ids=None if seg is None else _t(seg))
    ((out * _t(w_out)).sum() + (st * _t(w_st)).sum()).backward()
    for name, a, jg in zip("q k v g beta".split(), args, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg), err_msg=name, **TOL)


def test_recurrent_rule_matches_jax_and_the_chunked_rule():
    """One decode step against JAX's; a rollout of the recurrent rule over a
    sequence against the chunked rule's outputs and final state."""
    b, s, h, dk, dv = 2, 37, 3, 16, 8
    q, k, v, g, beta = _inputs(11, b, s, h, dk, dv)
    state = np.random.default_rng(5).standard_normal((b, h, dk, dv)).astype(np.float32)
    jo, jst = jgd.recurrent_gated_delta_rule(
        *(jnp.asarray(x[:, 0]) for x in (q, k, v, g, beta)), jnp.asarray(state))
    to, tst = tgd.recurrent_gated_delta_rule(*(_t(x[:, 0]) for x in (q, k, v, g, beta)),
                                             _t(state))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)

    st = torch.zeros((b, h, dk, dv))
    outs = []
    for i in range(s):
        o, st = tgd.recurrent_gated_delta_rule(*(_t(x[:, i]) for x in (q, k, v, g, beta)), st)
        outs.append(o)
    cout, cst = tgd.chunk_gated_delta_rule(*(_t(x) for x in (q, k, v, g, beta)), chunk_size=16)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), cout.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), cst.numpy(), **TOL)


def test_bfloat16_precision_stays_near_highest():
    """``precision="bfloat16"`` (bf16 operands, float32 sums) stays within
    bf16's rounding of the float32 rule; an unknown precision raises."""
    q, k, v, g, beta = _inputs(13, 1, 64, 2, 16, 16)
    args = [_t(x) for x in (q, k, v, g, beta)]
    hi, _ = tgd.chunk_gated_delta_rule(*args)
    lo, _ = tgd.chunk_gated_delta_rule(*args, precision="bfloat16")
    assert float((hi - lo).abs().max()) < 5e-2
    with pytest.raises(ValueError):
        tgd.chunk_gated_delta_rule(*args, precision="high")


def test_causal_conv1d_with_segments_matches_jax():
    rng = np.random.default_rng(17)
    b, l, c, kk = 2, 30, 12, 4
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    w = rng.standard_normal((c, kk)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    seg = _segments(b, l, [[3, 10, 12], [30]])
    for sg, bb in ((seg, None), (None, bias), (seg, bias)):
        want = jmamba.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    None if bb is None else jnp.asarray(bb),
                                    None if sg is None else jnp.asarray(sg))
        got = tmamba.causal_conv1d(_t(x), _t(w), None if bb is None else _t(bb),
                                   None if sg is None else _t(sg))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
