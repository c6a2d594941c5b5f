"""The Mamba-2 ops of the port (``ops/mamba.py``) on the CPU against the JAX
package's, in float32 on inputs made from a numpy seed: the chunked SSD
(``ssd_chunked``) at (L, chunk) of (96, 32), (64, 64) and (50, 16), with and
without an initial state, with packed segments and padded tails, its final
state, a continued chunk (``prev_seg_tail``), and its gradients against
``jax.grad``; ``gated_rms_norm``; ``mamba2_mixer`` with ``in_proj_bias``,
``conv_b`` and ``time_step_limit``, forward and gradients; packed sequences
against the same sequences run one by one; the context-parallel refusal.

Every JAX call runs under ``jax.jit``.

Tolerances: atol 1e-5 and rtol 1e-4 on the SSD's outputs, states and
gradients and the norm without resets (float32 in both packages, other
summation orders). With segment ids every row resets at its first position
(and at each packed start): the -1e4 log-decay of a reset puts the
cumulative sums near -1e4, where a float32 step is 1e-3, so both packages
carry an error of that size in each decay's exponent, summed in other orders
(each is about 1e-3 of max|y| off a float64 run of the same form). There the
values are held within ``RESET_TOL`` = 5e-3 of the reference's largest
magnitude, elementwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.ops import mamba as jmamba
from prime_rl_tpu_torch.ops import mamba as tmamba

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-4)
RESET_TOL = 5e-3
H, P, G, N = 4, 8, 2, 16


def _check(got, want, reset: bool, name: str = "") -> None:
    """got against want: ``TOL`` without resets, else every element within
    ``RESET_TOL`` of max|want|."""
    got, want = np.asarray(got), np.asarray(want)
    if not reset:
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
        return
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= RESET_TOL * scale + 1e-6, f"{name}: {err} > {RESET_TOL} * {scale}"


def _t(x):
    return torch.from_numpy(np.array(x))


def _ssd_inputs(seed: int, b: int, l: int):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, l, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, H)).astype(f) - 1.0))  # softplus > 0
    a_log = np.log(np.linspace(1.0, 4.0, H, dtype=f))
    b_in = rng.standard_normal((b, l, G, N)).astype(f)
    c_in = rng.standard_normal((b, l, G, N)).astype(f)
    d = rng.standard_normal(H).astype(f)
    return x, dt, a_log, b_in, c_in, d


def _segments(b: int, l: int, lens) -> np.ndarray:
    seg = np.zeros((b, l), np.int32)
    for r, row in enumerate(lens):
        off = 0
        for i, n in enumerate(row):
            seg[r, off:off + n] = i + 1
            off += n
    return seg


@functools.partial(jax.jit, static_argnames=("chunk",))
def j_ssd(x, dt, a_log, b_in, c_in, d, chunk, seg=None, init=None, tail=None):
    return jmamba.ssd_chunked(x, dt, a_log, b_in, c_in, d, chunk_size=chunk, segment_ids=seg,
                              initial_state=init, return_final_state=True, prev_seg_tail=tail)


CASES = (
    # (L, chunk, segment lengths of each row or None)
    (96, 32, None),
    (64, 64, [[20, 30, 14], [64]]),
    (50, 16, [[17, 21], [5, 5, 30]]),  # padded tails, a reset mid-chunk
)


@pytest.mark.parametrize("l,chunk,lens", CASES)
def test_ssd_chunked_matches_jax(l, chunk, lens):
    """y and the final state, without and with an initial state."""
    b = 2
    ins = _ssd_inputs(l, b, l)
    seg = None if lens is None else _segments(b, l, lens)
    state0 = np.random.default_rng(1).standard_normal((b, H, P, N)).astype(np.float32)
    for init in (None, state0):
        want_y, want_s = j_ssd(*ins, chunk, seg, init)
        y, s = tmamba.ssd_chunked(*map(_t, ins), chunk_size=chunk,
                                  segment_ids=None if seg is None else _t(seg),
                                  initial_state=None if init is None else _t(init),
                                  return_final_state=True)
        assert y.dtype == torch.float32 and y.shape == (b, l, H, P)
        _check(y.numpy(), want_y, seg is not None, "y")
        _check(s.numpy(), want_s, seg is not None, "state")


def test_ssd_continued_chunk_and_bf16_inputs():
    """A chunk continued from a carried state with the reset at position 0
    suppressed (``prev_seg_tail``) equals JAX's, and the two parts equal the
    sequence run whole (the first part ends on a chunk of the SSD: a part
    that ends inside one is padded, and the pad's reset zeroes the state it
    returns, in both packages); bf16 inputs compute in float32 as JAX
    does."""
    b, l = 1, 48
    ins = _ssd_inputs(7, b, l)
    seg = np.ones((b, l), np.int32)
    tail = np.ones((b,), np.int32)
    whole_y, whole_s = tmamba.ssd_chunked(*map(_t, ins), chunk_size=16, segment_ids=_t(seg),
                                          return_final_state=True)
    first = [a[:, :32] if a.ndim > 1 else a for a in ins]
    rest = [a[:, 32:] if a.ndim > 1 else a for a in ins]
    y1, s1 = tmamba.ssd_chunked(*map(_t, first), chunk_size=16, segment_ids=_t(seg[:, :32]),
                                return_final_state=True)
    y2, s2 = tmamba.ssd_chunked(*map(_t, rest), chunk_size=16, segment_ids=_t(seg[:, 32:]),
                                initial_state=s1, return_final_state=True,
                                prev_seg_tail=_t(tail))
    want_y, want_s = j_ssd(*rest, 16, seg[:, 32:], np.asarray(s1), tail)
    _, s_pad = tmamba.ssd_chunked(*[_t(a[:, :20]) if a.ndim > 1 else _t(a) for a in ins],
                                  chunk_size=16, segment_ids=_t(seg[:, :20]),
                                  return_final_state=True)
    assert float(s_pad.abs().max()) == 0.0 and float(s1.abs().max()) > 0.0
    _check(y2.numpy(), want_y, False, "continued y")  # no reset: the tail suppresses it
    _check(s2.numpy(), want_s, False, "continued state")
    _check(torch.cat([y1, y2], 1).numpy(), whole_y.numpy(), True, "halves")
    _check(s2.numpy(), whole_s.numpy(), True, "halves' state")
    bf = [_t(a).bfloat16() if a.ndim > 1 else _t(a) for a in ins]
    jbf = [jnp.asarray(a, jnp.bfloat16) if a.ndim > 1 else a for a in ins]
    y_bf = tmamba.ssd_chunked(*bf, chunk_size=16)
    want_bf, _ = j_ssd(*jbf, 16)
    assert y_bf.dtype == torch.float32
    np.testing.assert_allclose(y_bf.numpy(), np.asarray(want_bf), **TOL)


def test_ssd_gradients_match_jax():
    """d(sum(y * ct) + sum(state * cs)) against x, dt, a_log, B, C and D, with
    packed segments and an initial state."""
    b, l, chunk = 2, 40, 16
    ins = _ssd_inputs(3, b, l)
    seg = _segments(b, l, [[12, 28], [30]])
    init = np.random.default_rng(4).standard_normal((b, H, P, N)).astype(np.float32)
    rng = np.random.default_rng(5)
    ct = rng.standard_normal((b, l, H, P)).astype(np.float32)
    cs = rng.standard_normal((b, H, P, N)).astype(np.float32)

    @jax.jit
    def j_grads(*a):
        def f(*a_):
            y, s = jmamba.ssd_chunked(*a_[:6], chunk_size=chunk, segment_ids=seg,
                                      initial_state=a_[6], return_final_state=True)
            return jnp.sum(y * ct) + jnp.sum(s * cs)

        return jax.grad(f, argnums=tuple(range(7)))(*a)

    want = j_grads(*ins, init)
    leaves = [_t(a).requires_grad_() for a in (*ins, init)]
    y, s = tmamba.ssd_chunked(*leaves[:6], chunk_size=chunk, segment_ids=_t(seg),
                              initial_state=leaves[6], return_final_state=True)
    got = torch.autograd.grad((y * _t(ct)).sum() + (s * _t(cs)).sum(), leaves)
    for name, g, w in zip(("x", "dt", "a_log", "b", "c", "d", "init"), got, want):
        assert torch.isfinite(g).all(), name
        _check(g.numpy(), w, True, name)


def test_gated_rms_norm_matches_jax():
    rng = np.random.default_rng(8)
    y, gate = rng.standard_normal((2, 5, 24)).astype(np.float32), \
        rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal(24).astype(np.float32)
    want = jax.jit(jmamba.gated_rms_norm)(y, gate, w)
    np.testing.assert_allclose(tmamba.gated_rms_norm(_t(y), _t(gate), _t(w)).numpy(),
                               np.asarray(want), **TOL)


def _mixer_params(seed: int, d: int, conv_k: int = 4):
    rng = np.random.default_rng(seed)
    f = np.float32
    inter, conv = H * P, H * P + 2 * G * N
    return {
        "in_proj": (rng.standard_normal((d, inter + conv + H)) * 0.1).astype(f),
        "in_proj_bias": (rng.standard_normal(inter + conv + H) * 0.1).astype(f),
        "conv_w": (rng.standard_normal((conv, conv_k)) * 0.3).astype(f),
        "conv_b": (rng.standard_normal(conv) * 0.1).astype(f),
        "A_log": np.log(np.linspace(1.0, 8.0, H, dtype=f)),
        "D": rng.standard_normal(H).astype(f),
        "dt_bias": (rng.standard_normal(H) * 0.5).astype(f),
        "ssm_norm": (1.0 + 0.1 * rng.standard_normal(inter)).astype(f),
        "out_proj": (rng.standard_normal((inter, d)) * 0.1).astype(f),
    }


MIXER_KW = dict(num_heads=H, head_dim=P, ssm_state_size=N, n_groups=G, chunk_size=16)


@pytest.mark.parametrize("limit", [(0.0, float("inf")), (0.05, 0.6)])
def test_mamba2_mixer_matches_jax_values_and_grads(limit):
    """The mixer over a packed batch with padding: out and the gradients
    against the input and every parameter; with the default and a clamping
    ``time_step_limit``."""
    b, l, d = 2, 40, 24
    lp = _mixer_params(9, d)
    x = np.random.default_rng(10).standard_normal((b, l, d)).astype(np.float32)
    seg = _segments(b, l, [[15, 25], [22, 10]])
    ct = np.random.default_rng(11).standard_normal((b, l, d)).astype(np.float32)
    names = list(lp)

    @jax.jit
    def j_fwd_grads(x_, lp_):
        def f(x__, lp__):
            out = jmamba.mamba2_mixer(x__, lp__, segment_ids=seg, time_step_limit=limit,
                                      **MIXER_KW)
            return jnp.sum(out * ct), out

        (_, out), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(x_, lp_)
        return out, grads

    want, (want_dx, want_dlp) = j_fwd_grads(x, lp)
    tx = _t(x).requires_grad_()
    tlp = {k: _t(v).requires_grad_() for k, v in lp.items()}
    out = tmamba.mamba2_mixer(tx, tlp, segment_ids=_t(seg), time_step_limit=limit, **MIXER_KW)
    _check(out.detach().numpy(), want, True, "out")
    got = torch.autograd.grad((out * _t(ct)).sum(), [tx] + [tlp[k] for k in names])
    _check(got[0].numpy(), want_dx, True, "x")
    for k, g in zip(names, got[1:]):
        _check(g.numpy(), want_dlp[k], True, k)


def test_packed_mixer_equals_sequences_one_by_one():
    """Two sequences packed in one row with a padded tail give, position for
    position, what each gives alone: the conv and the SSD reset exactly."""
    d = 24
    lp = {k: _t(v) for k, v in _mixer_params(12, d).items()}
    rng = np.random.default_rng(13)
    a, b_ = rng.standard_normal((1, 19, d)).astype(np.float32), \
        rng.standard_normal((1, 23, d)).astype(np.float32)
    packed = np.concatenate([a, b_, np.zeros((1, 6, d), np.float32)], axis=1)
    seg = _segments(1, 48, [[19, 23]])
    out = tmamba.mamba2_mixer(_t(packed), lp, segment_ids=_t(seg), **MIXER_KW)
    alone_a = tmamba.mamba2_mixer(_t(a), lp, segment_ids=torch.ones(1, 19, dtype=torch.int32),
                                  **MIXER_KW)
    alone_b = tmamba.mamba2_mixer(_t(b_), lp, segment_ids=torch.ones(1, 23, dtype=torch.int32),
                                  **MIXER_KW)
    _check(out[:, :19].numpy(), alone_a.numpy(), True, "first")
    _check(out[:, 19:42].numpy(), alone_b.numpy(), True, "second")


def test_context_parallel_branch_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        tmamba.mamba2_mixer(torch.zeros(1, 4, 24), {}, mesh=object(), **MIXER_KW)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        tmamba._ssd_local_summary({})
