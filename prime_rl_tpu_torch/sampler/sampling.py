"""Token sampling: per-slot temperature / top-k / top-p with sampled-token
logprobs (the port of the JAX package's ``sampler/sampling.py``).

The same contract: exact gumbel-max over the full vocabulary when a row does
not filter; top-k/top-p filter within a ``MAX_TOP_K`` candidate window that
carries full-distribution probabilities, with the exact full-sort path for
rows whose nucleus escapes the window; greedy at ``temperature <= 0``; the
logprob is that of the sampled token under the temperature-scaled
UNfiltered distribution. Noise comes from a ``torch.Generator`` on the
logits' device, or from ``noise`` (tests feed both packages the same).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
MAX_TOP_K = 64  # candidate window for filtered sampling


def apply_top_k(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Mask logits outside each row's top-k. top_k <= 0 disables."""
    v = logits.shape[-1]
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where(top_k <= 0, v, top_k.clamp_max(v)).long()
    threshold = sorted_logits.gather(-1, (k - 1)[:, None])
    return torch.where(logits >= threshold, logits, NEG_INF)


def apply_top_p(logits: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus filtering. top_p >= 1 disables. Keeps the smallest prefix of
    the sorted distribution with cumulative prob >= top_p (the first token is
    always kept)."""
    sort_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = logits.gather(-1, sort_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p[:, None]
    keep_sorted[:, 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(-1, sort_idx, keep_sorted)
    return torch.where(keep, logits, NEG_INF)


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [S, V] f32
    temperature: torch.Tensor,  # [S]
    top_k: torch.Tensor,  # [S] int (<=0 disables)
    top_p: torch.Tensor,  # [S] (>=1 disables)
    generator: torch.Generator | None = None,
    *,
    noise: torch.Tensor | None = None,  # [S, V] gumbel noise (tests)
    filtering: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [S] int64, logprobs [S] f32).

    ``filtering=False`` is the caller's promise that no row has
    ``top_p < 1`` or ``top_k > MAX_TOP_K``: the exact full-sort path is then
    skipped. Otherwise that path runs whenever some row may need it (the
    JAX version decides with ``lax.cond`` on the device; a host branch on a
    device value would stall the decode stream, so on the card the host's
    knowledge of the rows' parameters stands in for it)."""
    s, v = logits.shape
    logits = logits.float()
    temp = temperature.float().clamp_min(1e-6)[:, None]
    scaled = logits / temp
    gumbel = noise if noise is not None else gumbel_noise((s, v), generator, logits.device)
    lse = torch.logsumexp(scaled, dim=-1)

    # exact unfiltered categorical sample (gumbel-max) and greedy
    sampled_full = torch.argmax(scaled + gumbel, dim=-1)
    greedy = torch.argmax(logits, dim=-1)

    # filtered path over the top-64 candidate window
    kwin = min(MAX_TOP_K, v)
    cand_vals, cand_idx = torch.topk(scaled, kwin, dim=-1)  # desc [S, K]
    ranks = torch.arange(kwin, device=logits.device)[None, :]
    keep = torch.where(top_k[:, None] > 0, ranks < top_k[:, None], True)
    # full-distribution probabilities (not window-renormalised): the nucleus
    # rule then matches exact top-p whenever the nucleus fits the window
    probs = torch.exp(cand_vals - lse[:, None])
    cum = torch.cumsum(probs, dim=-1)
    nucleus = (cum - probs) < top_p[:, None]
    nucleus[:, 0] = True
    keep = keep & nucleus
    cand_scores = torch.where(keep, cand_vals + gumbel.gather(-1, cand_idx), NEG_INF)
    pick = torch.argmax(cand_scores, dim=-1)
    sampled_filtered = cand_idx.gather(-1, pick[:, None])[:, 0]

    # rows whose nucleus escapes the window need the exact (sorted) path
    needs_exact = ((top_p < 1.0) & (cum[:, -1] < top_p)) | (top_k > MAX_TOP_K)
    if filtering and (logits.is_cuda or bool(needs_exact.any())):
        filtered = apply_top_p(apply_top_k(scaled, top_k), top_p)
        sampled_exact = torch.argmax(filtered + gumbel, dim=-1)
        sampled_filtered = torch.where(needs_exact, sampled_exact, sampled_filtered)

    is_filtering = (top_k > 0) | (top_p < 1.0)
    sampled = torch.where(is_filtering, sampled_filtered, sampled_full)
    tokens = torch.where(temperature <= 0, greedy, sampled)
    # logprob under the unfiltered temperature-scaled distribution
    target = scaled.gather(-1, tokens[:, None])[:, 0]
    return tokens, target - lse
