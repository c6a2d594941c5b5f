"""Rollout filters (reference: orchestrator/filters.py:35-172):
``gibberish`` (mean sampled logprob), ``repetition`` (n-gram), and
``zero_advantage``. ``monitor`` mode only counts; ``enforce`` drops."""

from __future__ import annotations

from collections import Counter

import numpy as np

from prime_rl_tpu_torch.orchestrator.algo.base import Rollout


def gibberish_frac(rollout: Rollout, min_mean_logprob: float) -> bool:
    """True if the rollout looks like gibberish (mean sampled logprob below
    threshold)."""
    lps, n = 0.0, 0
    for s in rollout.samples:
        m = np.asarray(s.mask, bool)
        lps += float(np.sum(np.asarray(s.logprobs)[m]))
        n += int(m.sum())
    return n > 0 and (lps / n) < min_mean_logprob


def repetition_frac(rollout: Rollout, ngram: int) -> float:
    """Fraction of sampled n-grams that are repeats."""
    worst = 0.0
    for s in rollout.samples:
        toks = [int(t) for t, m in zip(s.token_ids, s.mask) if m]
        if len(toks) < ngram + 1:
            continue
        grams = [tuple(toks[i : i + ngram]) for i in range(len(toks) - ngram + 1)]
        counts = Counter(grams)
        repeats = sum(c - 1 for c in counts.values())
        worst = max(worst, repeats / len(grams))
    return worst


def zero_advantage(rollout: Rollout) -> bool:
    """All-zero advantages carry no PG signal — but ONLY for rollouts whose
    tokens route to the RL loss. Distillation algos (opd/opsd/sft) stamp
    advantage 0.0 by design and train through ce/ref_kl weights; dropping
    them would starve the batch forever."""
    for s in rollout.samples:
        ce = getattr(s, "ce_weights", None)
        rk = getattr(s, "ref_kl_weights", None)
        if (ce is not None and np.any(np.asarray(ce) != 0)) or (
                rk is not None and np.any(np.asarray(rk) != 0)):
            return False  # trains through a non-RL component
        if s.advantages is not None and np.any(s.advantages != 0):
            return False
    return True


def advantage_magnitude(rollout: Rollout) -> float:
    """|mean advantage| over sampled tokens — the down-sampling rank key."""
    tot, n = 0.0, 0
    for s in rollout.samples:
        if s.advantages is None:
            continue
        m = np.asarray(s.mask, bool)
        tot += float(np.sum(np.asarray(s.advantages)[m]))
        n += int(m.sum())
    return abs(tot / n) if n else 0.0


def downsample(rollouts: list[Rollout], keep_frac: float,
               min_keep: int) -> list[Rollout]:
    """Keep the most informative rollouts of a group by |mean advantage|
    (group advantages are baseline-centered, so high magnitude = the
    extremes in both directions; PAPERS.md arXiv:2504.13818). Stable: ties
    and kept rollouts preserve arrival order."""
    n = len(rollouts)
    k = max(min(n, min_keep), int(np.ceil(keep_frac * n)))
    if k >= n:
        return list(rollouts)
    order = sorted(range(n), key=lambda i: -advantage_magnitude(rollouts[i]))
    keep = sorted(order[:k])
    return [rollouts[i] for i in keep]


class FilterSet:
    """Applies the configured filter list to a finalized group."""

    def __init__(self, configs: list):
        self.configs = configs
        self.counts: dict[str, int] = {}

    def apply(self, rollouts: list[Rollout]) -> list[Rollout]:
        kept = []
        for r in rollouts:
            drop_by = None
            for cfg in self.configs:
                if cfg.type == "gibberish" and gibberish_frac(r, cfg.min_mean_logprob):
                    drop_by = cfg
                elif cfg.type == "repetition" and repetition_frac(r, cfg.ngram) > cfg.max_repetition_frac:
                    drop_by = cfg
                elif cfg.type == "zero_advantage" and zero_advantage(r):
                    drop_by = cfg
                if drop_by is not None:
                    self.counts[cfg.type] = self.counts.get(cfg.type, 0) + 1
                    break
            if drop_by is not None and drop_by.mode == "enforce":
                continue
            kept.append(r)
        # group-level pass: down-sample to the most informative rollouts
        for cfg in self.configs:
            if cfg.type != "downsample":
                continue
            selected = downsample(kept, cfg.keep_frac, cfg.min_keep)
            self.counts["downsample"] = (
                self.counts.get("downsample", 0) + len(kept) - len(selected))
            if cfg.mode == "enforce":
                kept = selected
        return kept
