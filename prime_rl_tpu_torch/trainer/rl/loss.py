"""Three-component RL loss (rl + ce + ref_kl) over packed token streams.

Behavior parity with the reference's per-sample loss stack
(reference: src/prime_rl/trainer/rl/loss.py:100-403) — DPPO-binary-TV +
squared-log-ratio KL with an advantage-sign-conditioned trust region
("default"), the symmetric-trust-region "ipo" variant, a plain PPO-clip
"ratio" variant, reverse-KL distillation ("ref_kl") and masked NLL ("ce") —
the port of the JAX package's ``trainer/rl/loss.py``, same functions on
torch tensors:

- Every stream is a packed ``[B, L]`` tensor and components are selected
  with masks: no data-dependent control flow, so nothing in a step waits for
  the device. Masked sums of an empty mask are plain zeros.
- Each component is normalized by its own **global** token count
  (``*_scale``), all-reduced across data ranks by the caller — a token only
  enters the denominator of the components it belongs to.

Metrics are returned as ``(sum, count)`` pairs so micro-batch accumulation
and cross-rank reduction are exact (means of means would not be).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from prime_rl_tpu_torch.configs.trainer import (
    DefaultLossConfig,
    IPOLossConfig,
    RatioLossConfig,
)

Array = torch.Tensor


class MaskedStat(NamedTuple):
    """Sum/count pair; ``mean`` finalizes after all accumulation/reduction."""

    total: Array
    count: Array

    @property
    def mean(self) -> Array:
        return self.total / torch.clamp(self.count, min=1.0)


def masked_stat(values: Array, mask: Array) -> MaskedStat:
    mask = mask.to(values.dtype)
    return MaskedStat(torch.sum(values * mask), torch.sum(mask))


def importance_and_mismatch(
    trainer_logprobs: Array, inference_logprobs: Array
) -> tuple[Array, Array, Array]:
    """(log_ratio, ratio, mismatch_kl); mismatch_kl = r - log r - 1 >= 0
    (reference: loss.py:100-106)."""
    log_ratio = trainer_logprobs - inference_logprobs
    ratio = torch.exp(log_ratio)
    return log_ratio, ratio, ratio - log_ratio - 1.0


def _trust_region_pg(
    trainer_logprobs: Array,
    inference_logprobs: Array,
    advantages: Array,
    loss_mask: Array,
    loss_weights: Array | None,
    *,
    adv_tau: float,
    kl_tau: float,
    mask_fn,
    metric_fn=None,
) -> tuple[Array, dict[str, MaskedStat]]:
    """Shared skeleton of the default/ipo loss variants: a per-token PG term
    ``adv * ratio`` gated by a trust-region mask, plus a squared-log-ratio KL
    term over the full loss mask."""
    log_ratio, ratio, mismatch_kl = importance_and_mismatch(trainer_logprobs, inference_logprobs)
    probs_diff = torch.exp(trainer_logprobs) - torch.exp(inference_logprobs)
    is_masked = mask_fn(probs_diff, advantages)
    loss_f = loss_mask.float()
    keep = loss_f * (1.0 - is_masked.float())

    pg = keep * (adv_tau * advantages) * ratio
    kl = loss_f * torch.square(log_ratio)
    per_token = -pg + kl_tau * kl
    if loss_weights is not None:
        per_token = per_token * loss_weights
    loss = torch.sum(per_token)

    metrics = {
        "masked_mismatch_kl": masked_stat(mismatch_kl, loss_mask & is_masked),
        "unmasked_mismatch_kl": masked_stat(mismatch_kl, loss_mask & ~is_masked),
        "is_masked": masked_stat(is_masked.float(), loss_mask),
        "mismatch_kl": masked_stat(mismatch_kl, loss_mask),
        "importance_ratio": masked_stat(ratio, loss_mask),
    }
    if metric_fn is not None:
        metrics.update(metric_fn(probs_diff, advantages, is_masked, loss_mask))
    return loss, metrics


def default_loss(
    trainer_logprobs: Array,
    inference_logprobs: Array,
    advantages: Array,
    loss_mask: Array,
    loss_weights: Array | None,
    cfg: DefaultLossConfig,
) -> tuple[Array, dict[str, MaskedStat]]:
    """DPPO-binary-TV + Kimi-K2.5 squared-log-ratio KL; the trust region is
    conditioned on the advantage sign (reference: loss.py:109-161)."""

    def mask_fn(probs_diff, advantages):
        high = probs_diff > cfg.dppo_mask_high
        low = probs_diff < -cfg.dppo_mask_low
        return torch.where(advantages > 0, high, low)

    def extra(probs_diff, advantages, is_masked, loss_mask):
        drop = loss_mask & is_masked
        pos, neg = advantages > 0, advantages < 0
        return {
            "is_masked_high": masked_stat((pos & (probs_diff > cfg.dppo_mask_high)).float(), loss_mask),
            "is_masked_low": masked_stat((neg & (probs_diff < -cfg.dppo_mask_low)).float(), loss_mask),
            "masked_advantage_positive": masked_stat(pos.float(), drop),
            "masked_advantage_negative": masked_stat(neg.float(), drop),
        }

    return _trust_region_pg(
        trainer_logprobs, inference_logprobs, advantages, loss_mask, loss_weights,
        adv_tau=cfg.adv_tau, kl_tau=cfg.kl_tau, mask_fn=mask_fn, metric_fn=extra,
    )


def ipo_loss(
    trainer_logprobs: Array,
    inference_logprobs: Array,
    advantages: Array,
    loss_mask: Array,
    loss_weights: Array | None,
    cfg: IPOLossConfig,
) -> tuple[Array, dict[str, MaskedStat]]:
    """Symmetric trust region: drop tokens whose probability moved more than
    ``ipo_threshold`` in absolute terms (reference: loss.py:164-196)."""

    def mask_fn(probs_diff, advantages):
        return torch.abs(probs_diff) > cfg.ipo_threshold

    return _trust_region_pg(
        trainer_logprobs, inference_logprobs, advantages, loss_mask, loss_weights,
        adv_tau=cfg.adv_tau, kl_tau=cfg.kl_tau, mask_fn=mask_fn,
    )


def ratio_loss(
    trainer_logprobs: Array,
    inference_logprobs: Array,
    advantages: Array,
    loss_mask: Array,
    loss_weights: Array | None,
    cfg: RatioLossConfig,
) -> tuple[Array, dict[str, MaskedStat]]:
    """Plain PPO-clip token-level importance-ratio loss (GRPO-style)."""
    log_ratio, ratio, mismatch_kl = importance_and_mismatch(trainer_logprobs, inference_logprobs)
    adv = cfg.adv_tau * advantages
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps_low, 1.0 + cfg.clip_eps_high)
    per_token = -torch.minimum(ratio * adv, clipped * adv)
    loss_f = loss_mask.float()
    per_token = per_token * loss_f
    if loss_weights is not None:
        per_token = per_token * loss_weights
    was_clipped = (ratio != clipped) & loss_mask
    metrics = {
        "mismatch_kl": masked_stat(mismatch_kl, loss_mask),
        "is_clipped": masked_stat(was_clipped.float(), loss_mask),
        "importance_ratio": masked_stat(ratio, loss_mask),
    }
    return torch.sum(per_token), metrics


def ref_kl_loss(
    trainer_logprobs: Array,
    inference_logprobs: Array,
    ref_logprobs: Array,
    loss_mask: Array,
    loss_weights: Array | None,
) -> tuple[Array, dict[str, MaskedStat]]:
    """On-policy distillation: reverse KL to the reference model as the PG
    signal, one-sided trust region at probs_diff < -0.2, 1e-3 squared-log-ratio
    regularizer (reference: loss.py:199-243)."""
    log_ratio, ratio, mismatch_kl = importance_and_mismatch(trainer_logprobs, inference_logprobs)
    probs_diff = torch.exp(trainer_logprobs) - torch.exp(inference_logprobs)
    is_masked = probs_diff < -0.2
    loss_f = loss_mask.float()
    keep = loss_f * (1.0 - is_masked.float())

    ref_kl = ref_logprobs - trainer_logprobs
    pg = keep * ref_kl.detach() * ratio
    kl = loss_f * torch.square(log_ratio)
    per_token = -pg + 1e-3 * kl
    if loss_weights is not None:
        per_token = per_token * loss_weights
    metrics = {
        "ref_kl/masked_mismatch_kl": masked_stat(mismatch_kl, loss_mask & is_masked),
        "ref_kl/unmasked_mismatch_kl": masked_stat(mismatch_kl, loss_mask & ~is_masked),
        "ref_kl/is_masked": masked_stat(is_masked.float(), loss_mask),
        "ref_kl": masked_stat(ref_kl, loss_mask),
    }
    return torch.sum(per_token), metrics


def ce_loss(
    trainer_logprobs: Array,
    loss_mask: Array,
    loss_weights: Array | None,
) -> tuple[Array, dict[str, MaskedStat]]:
    """Masked NLL (SFT / ECHO observation prediction; reference: loss.py:246-259)."""
    nll = -trainer_logprobs
    if loss_weights is not None:
        nll = nll * loss_weights
    loss = torch.sum(nll * loss_mask.float())
    return loss, {"nll": masked_stat(-trainer_logprobs, loss_mask)}


_RL_LOSS_FNS = {"default": default_loss, "ipo": ipo_loss, "ratio": ratio_loss}


def make_rl_loss_fn(cfg) -> Any:
    """Resolve trainer.loss to the rl-component fn. ``custom`` imports a
    user fn with the same packed-array signature
    (reference: loss.py:262-282)."""
    if cfg.type == "custom":
        import importlib

        module, _, attr = cfg.import_path.rpartition(".")
        fn = getattr(importlib.import_module(module), attr)

        def custom_fn(t, i, adv, mask, w, _cfg):
            return fn(t, i, adv, mask, w, **cfg.kwargs)

        return custom_fn
    return _RL_LOSS_FNS[cfg.type]


def _at_least_one(scale):
    if isinstance(scale, torch.Tensor):
        return torch.clamp(scale, min=1.0)
    return max(float(scale), 1.0)


def compute_loss(
    *,
    trainer_logprobs: Array,  # [B, L] current-token aligned
    inference_logprobs: Array,  # [B, L]
    advantages: Array,  # [B, L]
    loss_mask: Array,  # [B, L] bool
    ref_logprobs: Array | None,
    rl_weights: Array | None,
    ce_weights: Array | None,
    ref_kl_weights: Array | None,
    loss_cfg,
    rl_scale: Array,
    ce_scale: Array,
    ref_kl_scale: Array,
) -> tuple[Array, dict[str, MaskedStat]]:
    """Packed-batch 3-component loss (reference: loss.py:285-403).

    A weight stream scales its component's per-token loss; weight 0.0 removes
    the token from the component's mask (and, upstream, its denominator).
    ``None`` rl_weights means 1.0 on the full loss mask; ``None`` ce/ref_kl
    weights disable that component.
    """
    metrics: dict[str, MaskedStat] = {}
    rl_fn = make_rl_loss_fn(loss_cfg)

    if rl_weights is None:
        rl_mask, rl_w = loss_mask, None
    else:
        rl_mask, rl_w = loss_mask & (rl_weights != 0), rl_weights
    rl_value, rl_metrics = rl_fn(
        trainer_logprobs, inference_logprobs, advantages, rl_mask, rl_w, loss_cfg
    )
    metrics.update(rl_metrics)
    total = rl_value / _at_least_one(rl_scale)

    if ce_weights is not None:
        ce_value, ce_metrics = ce_loss(trainer_logprobs, ce_weights != 0, ce_weights)
        metrics.update(ce_metrics)
        total = total + ce_value / _at_least_one(ce_scale)

    if ref_kl_weights is not None:
        if ref_logprobs is None:
            raise ValueError("ref_kl weights present but no ref_logprobs in batch")
        rk_value, rk_metrics = ref_kl_loss(
            trainer_logprobs, inference_logprobs, ref_logprobs,
            ref_kl_weights != 0, ref_kl_weights,
        )
        metrics.update(rk_metrics)
        total = total + rk_value / _at_least_one(ref_kl_scale)

    return total, metrics


def component_token_counts(
    loss_mask: Array,
    rl_weights: Array | None,
    ce_weights: Array | None,
    ref_kl_weights: Array | None,
) -> dict[str, Array]:
    """Per-component token counts for one micro-batch; the trainer sums these
    over the step's micro-batches and all-reduces over data ranks to build the
    global ``*_scale`` normalizers (reference: rl/train.py:312-334)."""
    if rl_weights is None:
        rl = torch.sum(loss_mask)
    else:
        rl = torch.sum(loss_mask & (rl_weights != 0))
    zero = torch.zeros((), dtype=torch.int64, device=loss_mask.device)
    ce = torch.sum(ce_weights != 0) if ce_weights is not None else zero
    rk = torch.sum(ref_kl_weights != 0) if ref_kl_weights is not None else zero
    return {"rl": rl, "ce": ce, "ref_kl": rk}
