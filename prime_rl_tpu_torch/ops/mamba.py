"""Mamba-2 SSD ops in plain PyTorch (the port of the JAX package's
``ops/mamba.py``): the chunked state-space scan, its gated RMSNorm, the
Mamba-2 mixer of Nemotron-H's "M" layers, and the segment-aware causal
depthwise convolution (which Qwen3-Next's linear-attention layers also run).
The JAX package has no Pallas kernel here: it is XLA there and plain PyTorch
here.

``ssd_chunked`` is the SSD's "state-space duality" form, all products over
chunks: the quadratic blocks inside a chunk, then a decay recurrence over the
chunks' states. It runs in float32 whatever its inputs, as JAX's
``_ssd_phase1`` casts. Packed sequences reset exactly, as in JAX: a large
negative log-decay (``RESET_NEG``) at each segment's first position decays
every contribution that crosses it to exactly 0, while a token's own term
never includes its own decay.

The K taps of ``causal_conv1d`` are K shifted multiply-adds, the segment mask
applied to each shifted input, as JAX writes it: no convolution operator,
whose backward (cuDNN's) need not give equal bits from run to run.

Not ported yet, and raising: the context-parallel branch (``mesh`` with a
context axis, JAX ``ops/cp_mamba.py``) and its rank summary
``_ssd_local_summary``, both ROADMAP Queue 1 item 11."""

from __future__ import annotations

import torch
import torch.nn.functional as F

RESET_NEG = -1e4  # exp(-1e4) == 0 in f32, but cumsums stay finite
_CP = "context-parallel Mamba waits for the multi-card slice (ROADMAP.md, Queue 1 item 11)"


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., Q] log-decays -> [..., Q, Q] lower-triangular pairwise sums:
    out[..., j, i] = sum(a[..., i+1 : j+1]) for j >= i, -inf above."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # [..., j, i] = sum (i, j]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def causal_conv1d(
    x: torch.Tensor,  # [B, L, C]
    weight: torch.Tensor,  # [C, K]: tap k multiplies x[t - K + 1 + k]
    bias: torch.Tensor | None,
    segment_ids: torch.Tensor | None = None,  # [B, L]; taps never cross segments
) -> torch.Tensor:
    """Depthwise causal conv [B, L, C] in x's dtype; a tap that would read
    another segment (or padding) reads 0."""
    _, l, _ = x.shape
    k = weight.shape[1]
    out = x * weight[None, None, :, k - 1]
    for s in range(1, k):
        shifted = F.pad(x, (0, 0, s, 0))[:, :l]
        if segment_ids is not None:
            seg_shift = F.pad(segment_ids, (s, 0))[:, :l]
            same = (seg_shift == segment_ids) & (segment_ids != 0)
            shifted = shifted * same[..., None]
        out = out + shifted * weight[None, None, :, k - 1 - s]
    if bias is not None:
        out = out + bias
    return out


def _ssd_phase1(x, dt, a_log, b_in, c_in, d_skip, chunk_size: int, segment_ids,
                prev_seg_tail=None) -> dict:
    """The initial-state-independent part of the SSD (where the products
    are): discretize, chunk, the quadratic blocks inside each chunk, the raw
    per-chunk states. x [B, L, H, P], dt [B, L, H] (post-softplus), a_log [H],
    b_in/c_in [B, L, G, N], d_skip [H]; all in float32 from here."""
    bsz, l, h, p = x.shape
    f32 = torch.float32
    x, dt = x.to(f32), dt.to(f32)
    a = -torch.exp(a_log.to(f32))  # [H], negative
    rep = h // b_in.shape[2]
    b_full = b_in.to(f32).repeat_interleave(rep, dim=2)  # [B, L, H, N]
    c_full = c_in.to(f32).repeat_interleave(rep, dim=2)

    pad = (-l) % chunk_size
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_full = F.pad(b_full, (0, 0, 0, 0, 0, pad))
        c_full = F.pad(c_full, (0, 0, 0, 0, 0, pad))
    lp = l + pad

    d_residual = d_skip.to(f32)[None, None, :, None] * x
    xd = x * dt[..., None]  # [B, Lp, H, P]
    a_pos = a[None, None, :] * dt  # [B, Lp, H] log-decay per position
    if segment_ids is not None:
        seg = F.pad(segment_ids, (0, pad))
        prev = F.pad(seg, (1, 0))[:, :lp].clone()
        if prev_seg_tail is not None:
            prev[:, 0] = prev_seg_tail
        reset = seg != prev  # the first position of every segment (and pad edges)
        a_pos = a_pos + torch.where(reset[..., None], RESET_NEG, 0.0)

    ch, q = lp // chunk_size, chunk_size

    def chunks(t):
        return t.reshape((bsz, ch, q) + tuple(t.shape[2:]))

    xc = chunks(xd)  # [B, C, Q, H, P]
    bc = chunks(b_full)  # [B, C, Q, H, N]
    cc = chunks(c_full)
    ac = chunks(a_pos).permute(0, 3, 1, 2)  # [B, H, C, Q]
    a_cum = torch.cumsum(ac, dim=-1)

    # 1. inside each chunk (the diagonal blocks)
    l_intra = torch.exp(_segsum(ac))  # [B, H, C, Q(j), Q(i)]
    scores = torch.einsum("bcqhn,bcshn->bhcqs", cc, bc)
    y_diag = torch.einsum("bhcqs,bcshp->bcqhp", scores * l_intra, xc)

    # 2. per-chunk states (B terms decayed to the chunk's end)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # [B, H, C, Q]
    states = torch.einsum("bcqhn,bcqhp->bchpn", bc * decay_states.permute(0, 2, 3, 1)[..., None],
                          xc)
    return dict(y_diag=y_diag, states=states, a_cum=a_cum, cc=cc, d_residual=d_residual,
                orig_len=l, shape=(bsz, lp, h, p))


def _ssd_phase2(pieces: dict, initial_state: torch.Tensor | None):
    """The recurrence over the chunks and the states' readout, linear in
    ``initial_state``. Returns (y [B, L, H, P] f32, final state [B, H, P, N])."""
    bsz, lp, h, p = pieces["shape"]
    states, a_cum, cc = pieces["states"], pieces["a_cum"], pieces["cc"]
    n = states.shape[-1]
    if initial_state is None:
        initial_state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=states.device)

    # 3. the recurrence over the chunk states
    states = torch.cat([initial_state.to(torch.float32)[:, None], states], dim=1)
    chunk_decay = F.pad(a_cum[..., -1], (1, 0))  # [B, H, C+1]
    decay_chunk = torch.exp(_segsum(chunk_decay))  # [B, H, C+1(j), C+1(i)]
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output in each chunk (the C terms)
    state_decay_out = torch.exp(a_cum)  # [B, H, C, Q]
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", cc, states)
    y_off = y_off * state_decay_out.permute(0, 2, 3, 1)[..., None]
    y = (pieces["y_diag"] + y_off).reshape(bsz, lp, h, p) + pieces["d_residual"]
    return y[:, :pieces["orig_len"]], final_state


def _ssd_local_summary(pieces: dict):
    """A context-parallel rank's linear summary (JAX ``_ssd_local_summary``)."""
    raise NotImplementedError(_CP)


def ssd_chunked(
    x: torch.Tensor,  # [B, L, H, P]
    dt: torch.Tensor,  # [B, L, H] post-softplus time steps
    a_log: torch.Tensor,  # [H]: A = -exp(a_log)
    b_in: torch.Tensor,  # [B, L, G, N]
    c_in: torch.Tensor,  # [B, L, G, N]
    d_skip: torch.Tensor,  # [H]
    chunk_size: int = 64,
    segment_ids: torch.Tensor | None = None,  # [B, L] packed-sequence resets
    initial_state: torch.Tensor | None = None,  # [B, H, P, N] (a prefill that continues)
    return_final_state: bool = False,
    prev_seg_tail: torch.Tensor | None = None,  # [B] segment id just before position 0
):
    """The Mamba-2 SSD in its chunked product form. Returns y [B, L, H, P]
    float32, and the final state [B, H, P, N] float32 with
    ``return_final_state``."""
    pieces = _ssd_phase1(x, dt, a_log, b_in, c_in, d_skip, chunk_size, segment_ids,
                         prev_seg_tail)
    y, final_state = _ssd_phase2(pieces, initial_state)
    return (y, final_state) if return_final_state else y


def gated_rms_norm(y: torch.Tensor, gate: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2RMSNormGated: normalize y * silu(gate) in float32, scale, back to
    y's dtype."""
    f = (y * F.silu(gate)).to(torch.float32)
    var = (f * f).mean(dim=-1, keepdim=True)
    return (f * torch.rsqrt(var + eps) * weight.to(torch.float32)).to(y.dtype)


def split_in_proj(proj: torch.Tensor, lp: dict, num_heads: int, head_dim: int,
                  ssm_state_size: int, n_groups: int,
                  time_step_limit: tuple[float, float] = (0.0, float("inf"))):
    """in_proj's output [..., inter + conv + H] -> (gate [..., inter], xBC
    [..., conv] before the conv, dt [..., H] float32 after softplus and the
    limit)."""
    inter = num_heads * head_dim
    gn = n_groups * ssm_state_size
    gate = proj[..., :inter]
    xbc = proj[..., inter:2 * inter + 2 * gn]
    dt = F.softplus(proj[..., 2 * inter + 2 * gn:].to(torch.float32)
                    + lp["dt_bias"].to(torch.float32))
    lo, hi = time_step_limit
    if lo > 0.0 or hi != float("inf"):
        dt = dt.clamp(lo, hi)
    return gate, xbc, dt


def mamba2_mixer(
    h_in: torch.Tensor,  # [B, L, D]
    lp: dict,  # in_proj, conv_w, conv_b, A_log, D, dt_bias, ssm_norm, out_proj
    *,
    num_heads: int,
    head_dim: int,
    ssm_state_size: int,
    n_groups: int,
    chunk_size: int = 64,
    segment_ids: torch.Tensor | None = None,
    time_step_limit: tuple[float, float] = (0.0, float("inf")),
    mesh=None,
    cp_axis: str = "context",
) -> torch.Tensor:
    """One Mamba-2 mixer (HF Mamba2Mixer's torch_forward): in_proj -> [gate |
    xBC | dt]; the causal conv and silu over xBC; the SSD; the gated RMSNorm;
    out_proj. A ``mesh`` raises (Queue 1 item 11)."""
    if mesh is not None:
        raise NotImplementedError(_CP)
    inter = num_heads * head_dim
    gn = n_groups * ssm_state_size
    proj = h_in @ lp["in_proj"]
    if lp.get("in_proj_bias") is not None:
        proj = proj + lp["in_proj_bias"]
    gate, xbc, dt = split_in_proj(proj, lp, num_heads, head_dim, ssm_state_size, n_groups,
                                  time_step_limit)
    bsz, l, _ = h_in.shape
    xbc = F.silu(causal_conv1d(xbc, lp["conv_w"], lp.get("conv_b"), segment_ids))
    y = ssd_chunked(
        xbc[..., :inter].reshape(bsz, l, num_heads, head_dim), dt, lp["A_log"],
        xbc[..., inter:inter + gn].reshape(bsz, l, n_groups, ssm_state_size),
        xbc[..., inter + gn:].reshape(bsz, l, n_groups, ssm_state_size), lp["D"],
        chunk_size=chunk_size, segment_ids=segment_ids)
    y = gated_rms_norm(y.reshape(bsz, l, inter).to(h_in.dtype), gate, lp["ssm_norm"])
    return y @ lp["out_proj"]
