"""Chunked gated delta rule (GatedDeltaNet linear attention) in plain
PyTorch (the port of the JAX package's ``ops/gated_delta.py``, Qwen3-Next's
linear-attention layers). The JAX package has no Pallas kernel here: it is
XLA there and plain PyTorch here.

Recurrence, per head, with a [Dk, Dv] fast-weight state S_t and q, k
L2-normalized per head:

    S_t = exp(g_t) S_{t-1} + k_t (beta_t (v_t - (exp(g_t) S_{t-1})^T k_t))^T
    o_t = S_t^T q_t Dk^-0.5

``chunk_gated_delta_rule`` processes the sequence in chunks of 64: inside a
chunk the delta-rule corrections come in closed form through the WY form
T = (I - A)^-1 of the strictly lower A = -(beta k) k^T * decay, here by a
triangular solve (the JAX package multiplies out a Neumann series because an
XLA triangular solve lowers poorly on its matrix unit; both give T). The
chunks are then chained through the carried [B, H, Dk, Dv] state. Packed
sequences reset exactly through explicit masks, as in JAX: pairs across
segments are masked in the chunk's matrices, a token at or after a reset
never reads the carried state, one before a reset never writes the state
that leaves the chunk, and the carried state dies in a chunk that holds a
reset. Padding (segment 0) neither decays nor writes, so the state at a
prompt's length is exact through a padded tail.

``precision`` is ``ModelConfig.gdn_mxu_precision``, passed as an argument
(the JAX package sets a module global): ``"highest"`` runs every product in
float32 (PyTorch's default on the card, TF32 off); ``"bfloat16"`` rounds the
products' operands to bf16 and sums in float32. The state, the decays and
the exponentials stay float32 either way.

``recurrent_gated_delta_rule`` is the one-token decode step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e9
PRECISIONS = ("highest", "bfloat16")


def _l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / sqrt(sum x^2 + eps) over the last dim (fla's l2norm)."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32 (batched over the leading dims, which broadcast).
    ``bfloat16``: operands rounded to bf16, float32 sums."""
    if precision == "highest":
        return a @ b
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if not a.is_cuda:
        return a.float() @ b.float()
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(*lead, a.shape[-2], b.shape[-1])


def chunk_gated_delta_rule(
    q: torch.Tensor,  # [B, S, H, Dk]
    k: torch.Tensor,  # [B, S, H, Dk]
    v: torch.Tensor,  # [B, S, H, Dv]
    g: torch.Tensor,  # [B, S, H] log decay (<= 0)
    beta: torch.Tensor,  # [B, S, H] write strength in (0, 1)
    *,
    chunk_size: int = 64,
    segment_ids: torch.Tensor | None = None,  # [B, S]; 0 = pad
    initial_state: torch.Tensor | None = None,  # [B, H, Dk, Dv]
    l2norm_qk: bool = True,
    precision: str = "highest",
    prev_seg_tail: torch.Tensor | None = None,  # [B] segment id just before position 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B, S, H, Dv] in v's dtype, final state [B, H, Dk, Dv]
    float32). ``prev_seg_tail`` (a chunked serving prefill: the previous
    chunk's last segment id) keeps position 0 from resetting, so the scan
    continues ``initial_state``; without it position 0 starts a sequence."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    out_dtype = v.dtype
    c = chunk_size
    pad = (-s) % c
    n = (s + pad) // c
    dev = q.device

    if l2norm_qk:
        q = _l2norm(q.float())
        k = _l2norm(k.float())
    q = q.float() * (dk ** -0.5)
    k = k.float()
    v = v.float()
    g = g.float()
    beta = beta.float()

    reset = None
    if segment_ids is not None:
        prev = F.pad(segment_ids, (1, 0))[:, :s]
        if prev_seg_tail is not None:
            prev = prev.clone()
            prev[:, 0] = prev_seg_tail.to(prev.dtype)
        reset = segment_ids != prev  # the first position of every segment
        # padding neither decays nor writes: the carried state stays exact
        g = torch.where((segment_ids != 0)[..., None], g, 0.0)

    def chunks(x):  # [B, S, H(, D)] -> [B, H, N, C(, D)]
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        x = x.movedim(2, 1)
        return x.reshape(b, h, n, c, *x.shape[3:])

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    gc = torch.cumsum(chunks(g), dim=-1)  # within-chunk cumulative log decay
    bc = chunks(beta)
    kb = kc * bc[..., None]  # beta-scaled keys and values
    vb = vc * bc[..., None]

    # exp(g_i - g_j) on the lower triangle: gc falls within a chunk, so the
    # kept differences are <= 0 and never overflow
    diff = gc[..., :, None] - gc[..., None, :]
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=dev))
    pair_ok = tril
    read_ok = write_ok = carry_ok = None
    if reset is not None:
        seg_c = F.pad(segment_ids, (0, pad)).reshape(b, 1, n, c)
        pair_ok = tril & (seg_c[..., :, None] == seg_c[..., None, :])
        res_c = F.pad(reset & (segment_ids != 0), (0, pad)).reshape(b, 1, n, c)
        cum = torch.cumsum(res_c.to(torch.int32), dim=-1)
        total = cum[..., -1:]
        read_ok = (cum == 0).float()[..., None]  # no reset at or before i
        write_ok = (((total - cum) == 0) & (seg_c != 0)).float()[..., None]
        carry_ok = (total[..., 0] == 0).float()  # [B, 1, N]
    decay = torch.exp(torch.where(pair_ok, diff, NEG))

    a = -torch.tril(_dot(kb, kc.transpose(-1, -2), precision) * decay, -1)  # strictly lower
    eye = torch.eye(c, dtype=torch.float32, device=dev)
    t = torch.linalg.solve_triangular(eye - a, eye.expand_as(a), upper=False,
                                      unitriangular=True)  # (I - A)^-1

    u = _dot(t, vb, precision)  # corrected values
    read_f = torch.exp(gc)[..., None]  # the state-read decay a token
    if read_ok is not None:
        read_f = read_f * read_ok
    w = _dot(t, kb * read_f, precision)  # state-read weights
    g_last = gc[..., -1]  # [B, H, N]
    attn = torch.where(pair_ok, _dot(qc, kc.transpose(-1, -2), precision) * decay, 0.0)
    write_f = torch.exp(g_last[..., None] - gc)[..., None]  # the state-write decay
    if write_ok is not None:
        write_f = write_f * write_ok
    carry_f = torch.exp(g_last)
    if carry_ok is not None:
        carry_f = carry_f * carry_ok
    carry_f = carry_f.expand(b, h, n)

    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev)
             if initial_state is None else initial_state.float())
    qr, kw = qc * read_f, kc * write_f
    outs = []
    for i in range(n):
        v_new = u[:, :, i] - _dot(w[:, :, i], state, precision)  # [B, H, C, Dv]
        outs.append(_dot(qr[:, :, i], state, precision)
                    + _dot(attn[:, :, i], v_new, precision))
        state = (state * carry_f[:, :, i, None, None]
                 + _dot(kw[:, :, i].transpose(-1, -2), v_new, precision))
    out = torch.stack(outs, dim=2).reshape(b, h, n * c, dv)[:, :, :s]
    return out.movedim(1, 2).to(out_dtype), state


def recurrent_gated_delta_rule(
    q: torch.Tensor,  # [B, H, Dk] one token a batch row
    k: torch.Tensor,  # [B, H, Dk]
    v: torch.Tensor,  # [B, H, Dv]
    g: torch.Tensor,  # [B, H]
    beta: torch.Tensor,  # [B, H]
    state: torch.Tensor,  # [B, H, Dk, Dv] float32
    *,
    l2norm_qk: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step (the serving form of the chunked rule). Returns (out
    [B, H, Dv] in v's dtype, the new state float32)."""
    dk = q.shape[-1]
    if l2norm_qk:
        q = _l2norm(q.float())
        k = _l2norm(k.float())
    q = q.float() * (dk ** -0.5)
    k = k.float()
    state = state * torch.exp(g.float())[..., None, None]
    kv_mem = torch.einsum("bhkv,bhk->bhv", state, k)
    delta = (v.float() - kv_mem) * beta.float()[..., None]
    state = state + k[..., :, None] * delta[..., None, :]
    out = torch.einsum("bhkv,bhk->bhv", state, q)
    return out.to(v.dtype), state
