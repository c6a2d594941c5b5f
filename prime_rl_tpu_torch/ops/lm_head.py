"""Sequence-chunked fused LM head: per-token target logprob + entropy without
materializing the full [N, vocab] logits (the port of the JAX package's
``ops/lm_head.py``).

One ``torch.autograd.Function`` walks the tokens in chunks: the forward keeps
only ``[N]`` results, the backward recomputes each chunk's ``[C, V]`` logits
and turns them into ``d hidden`` and ``d lm_head`` on the spot, so peak memory
is O(chunk x vocab) in both passes. The ``hidden @ w`` product is a plain
``torch.matmul``, as the JAX package leaves it to XLA outside any kernel.

Per-token temperature scales the logits before the softmax so the trainer's
logprobs match the sampling distribution they were drawn from; a softcap
(``cap * tanh(logits / cap)``) applies BEFORE the temperature. Entropy is a
monitoring stat and carries no gradient.
"""

from __future__ import annotations

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an f32 result. On the card a bf16 product keeps its f32
    accumulator as the output (the JAX package asks XLA for the same with
    ``preferred_element_type``) instead of rounding the logits to bf16."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a, b).float()


def _chunk_logits(hidden, w, inv_temp, softcap: float):
    """([C, V] f32 scaled logits, the capped-but-unscaled logits or None)."""
    logits = _mm_f32(hidden, w)
    capped = None
    if softcap > 0:
        capped = softcap * torch.tanh(logits / softcap)
        logits = capped
    return logits * inv_temp[:, None], capped


def _chunk_logprob_entropy(hidden, labels, inv_temp, w, softcap: float = 0.0):
    logits, _ = _chunk_logits(hidden, w, inv_temp, softcap)
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, 1, labels[:, None].long())[:, 0]
    probs = torch.softmax(logits, dim=-1)
    entropy = lse - torch.sum(probs * logits, dim=-1)
    return target - lse, entropy


class _ChunkedLogprobEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, w, labels, inv_temp, chunk_size, softcap):
        n = hidden.shape[0]
        logprob = torch.empty(n, dtype=torch.float32, device=hidden.device)
        entropy = torch.empty(n, dtype=torch.float32, device=hidden.device)
        for lo in range(0, n, chunk_size):
            hi = min(lo + chunk_size, n)
            logprob[lo:hi], entropy[lo:hi] = _chunk_logprob_entropy(
                hidden[lo:hi], labels[lo:hi], inv_temp[lo:hi], w, softcap)
        ctx.save_for_backward(hidden, w, labels, inv_temp)
        ctx.chunk_size, ctx.softcap = chunk_size, softcap
        ctx.mark_non_differentiable(entropy)
        return logprob, entropy

    @staticmethod
    def backward(ctx, d_logprob, _d_entropy):
        hidden, w, labels, inv_temp = ctx.saved_tensors
        n = hidden.shape[0]
        d_hidden = torch.empty_like(hidden)
        # accumulated in f32 across chunks, cast once at the end
        d_w = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for lo in range(0, n, ctx.chunk_size):
            hi = min(lo + ctx.chunk_size, n)
            h, it = hidden[lo:hi], inv_temp[lo:hi]
            logits, capped = _chunk_logits(h, w, it, ctx.softcap)
            # d logprob / d logits = onehot(label) - softmax
            d_logits = -torch.softmax(logits, dim=-1)
            d_logits.scatter_add_(1, labels[lo:hi, None].long(),
                                  torch.ones_like(d_logits[:, :1]))
            d_logits *= (d_logprob[lo:hi].float() * it)[:, None]
            if capped is not None:
                d_logits *= 1.0 - torch.square(capped / ctx.softcap)
            d_logits = d_logits.to(hidden.dtype)
            d_hidden[lo:hi] = torch.matmul(d_logits, w.T)
            d_w += torch.matmul(h.T, d_logits).float()
        return d_hidden, d_w.to(w.dtype), None, None, None, None


def chunked_logprob_entropy(
    hidden: torch.Tensor,  # [B, L, D]
    lm_head: torch.Tensor,  # [D, V]
    labels: torch.Tensor,  # [B, L] int (already next-token aligned)
    temperatures: torch.Tensor | None = None,  # [B, L] float32
    chunk_size: int = 1024,
    softcap: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logprobs [B, L], entropy [B, L]), both f32. The last chunk may
    be ragged: it is simply shorter (no padding rows are computed)."""
    b, l, d = hidden.shape
    n = b * l
    hidden = hidden.reshape(n, d)
    labels = labels.reshape(n)
    if temperatures is None:
        inv_temp = torch.ones(n, dtype=torch.float32, device=hidden.device)
    else:
        temps = temperatures.reshape(n).float()
        inv_temp = torch.where(temps > 0, 1.0 / torch.clamp(temps, min=1e-6), 1.0)
    if chunk_size <= 0 or chunk_size >= n:
        chunk_size = n
    logprob, entropy = _ChunkedLogprobEntropy.apply(hidden, lm_head, labels, inv_temp,
                                                    int(chunk_size), float(softcap))
    return logprob.reshape(b, l), entropy.reshape(b, l)


def lm_head_logits(hidden: torch.Tensor, lm_head: torch.Tensor) -> torch.Tensor:
    """Plain logits path for the sampler (typically last-position only)."""
    return _mm_f32(hidden.reshape(-1, hidden.shape[-1]), lm_head).reshape(
        *hidden.shape[:-1], lm_head.shape[-1])
