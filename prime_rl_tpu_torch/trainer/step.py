"""The learner step: forward -> fused logprob head -> 3-component loss ->
backward -> optimizer update, with gradient accumulation over micro-batches
(the port of the JAX package's ``trainer/step.py`` for one process and one
device).

- Micro-batches arrive **stacked on a leading axis** ``[N, B, L]``; a host
  loop runs one forward/backward per micro-batch and autograd accumulates the
  gradients in place. Nothing in the loop reads a value back from the device:
  the metrics stay tensors until the caller asks for them.
- Params are float32 (or bfloat16) masters; the forward casts to the compute
  dtype per layer. Gradients come out in the masters' dtype, or in bfloat16
  under ``grad_accum_dtype = "bfloat16"`` (differentiated against a pre-cast
  copy), and are widened to float32 for the update.
- Normalization: losses are divided by **global** per-component token counts
  (``scales``, whole-step sums), so the number of micro-batches never changes
  the effective loss.
- bfloat16 masters take the float32 update with stochastic rounding, the
  random bits drawn from a generator seeded from the step.

Not carried over from the JAX package, as work-arounds for its runtime and
not contract: ``dispatch_micro_batches`` (the host loop is the only form
here; the config field is accepted and changes nothing) and the sharding
helpers.
Host offload of optimizer state or params, and LoRA, raise until their slices.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple

import numpy as np
import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.ops.lm_head import chunked_logprob_entropy
from prime_rl_tpu_torch.trainer import optim as optim_lib
from prime_rl_tpu_torch.trainer.optim import Optimizer, tree_leaves, tree_map, tree_paths
from prime_rl_tpu_torch.trainer.rl import loss as loss_lib

Params = dict


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: int


class MicroBatchArrays(NamedTuple):
    """Packed micro-batch streams, all [N, B, L] (N = stacked micro-batches;
    absent optional streams are None). The same fields, names and shapes as
    the JAX package's: a batch of numpy arrays feeds either package's step."""

    input_ids: Any  # int32
    loss_mask: Any  # bool
    advantages: Any  # float32
    inference_logprobs: Any  # float32
    position_ids: Any  # int32
    segment_ids: Any  # int32, 0 = padding
    temperatures: Any  # float32
    ref_logprobs: Any = None
    rl_weights: Any = None
    ce_weights: Any = None
    ref_kl_weights: Any = None
    # router replay [N, B, L, NL_moe, K], -1 = the trainer's own routing (MoE families)
    routed_experts: Any = None
    # VLM streams: they wait for the VLM slice and must be None
    mm_patches: Any = None
    mm_vis_seg_ids: Any = None
    mm_vis_pos_idx: Any = None
    mm_vis_pos_w: Any = None
    mm_vis_rope_coords: Any = None
    mm_img_slot: Any = None
    mm_position_ids: Any = None


class Scales(NamedTuple):
    """Global (whole-step) per-component token counts."""

    rl: Any
    ce: Any
    ref_kl: Any


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _compute_dtype(model_cfg) -> torch.dtype:
    return torch.bfloat16 if model_cfg.compute_dtype == "bfloat16" else torch.float32


def put_batch(batch: MicroBatchArrays, device: torch.device | str) -> MicroBatchArrays:
    """The batch's streams (numpy arrays or tensors) as tensors on ``device``."""
    def put(x):
        if x is None:
            return None
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).to(device)

    return MicroBatchArrays(*[put(x) for x in batch])


def model_logprobs(params: Params, spec: ModelSpec, mb, model_cfg, mesh=None,
                   lora: Params | None = None, lora_scale: float = 1.0):
    """(logprobs [B, L], entropy [B, L], moe_aux) in current-token convention:
    out[i] = logp(token_i | tokens_<i). Position 0 of each packed row gets the
    uniform-distribution pad (log 1/V, log V): those positions are always
    loss-masked."""
    from prime_rl_tpu_torch.models import get_family

    if mb.mm_patches is not None:
        raise NotImplementedError("the VLM batch streams wait for the VLM slice")
    family = get_family(spec)
    dtype = _compute_dtype(model_cfg)
    extra = {}
    collect_aux = spec.is_moe and model_cfg.moe_aux_coef > 0
    if collect_aux:
        extra["collect_aux"] = True
    if mb.routed_experts is not None and spec.is_moe:
        extra["routed_experts"] = mb.routed_experts
    if model_cfg.quantized_compute:
        extra["quantized_compute"] = model_cfg.quantized_compute
    if spec.gdn_pattern:
        extra["gdn_precision"] = model_cfg.gdn_mxu_precision
    hidden = family.forward(
        params, spec, mb.input_ids, mb.segment_ids, mb.position_ids,
        compute_dtype=dtype,
        attn_impl=model_cfg.attn.impl,
        block_q=model_cfg.attn.block_q,
        block_kv=model_cfg.attn.block_kv,
        remat=model_cfg.ac.mode,
        mesh=mesh,
        lora=lora,
        lora_scale=lora_scale,
        cp_style=model_cfg.cp_style,
        **extra,
    )
    moe_aux = torch.zeros((), device=mb.input_ids.device)
    if collect_aux:
        hidden, moe_aux = hidden
    labels = _shift_left(mb.input_ids, 0)
    # logits at t are scaled by the temperature the *label* token was sampled at
    label_temps = _shift_left(mb.temperatures, 1.0)
    lm_head = family.get_lm_head(params, spec).to(dtype)
    lp_next, ent_next = chunked_logprob_entropy(
        hidden, lm_head, labels, label_temps, chunk_size=model_cfg.lm_head_chunk_size,
        softcap=spec.final_logit_softcap,
    )
    log_v = float(np.log(spec.vocab_size))
    logprobs = _shift_right(lp_next, -log_v)
    entropy = _shift_right(ent_next, log_v)
    return logprobs, entropy, moe_aux


def make_loss_fn(spec: ModelSpec, model_cfg, loss_cfg, mesh=None,
                 base_params: Params | None = None):
    """Per-micro-batch loss: (params, mb, scales) -> (loss, metrics)."""
    if base_params is not None or model_cfg.lora is not None:
        raise NotImplementedError("LoRA training waits for the LoRA slice")

    def loss_fn(params: Params, mb, scales: Scales):
        logprobs, entropy, moe_aux = model_logprobs(params, spec, mb, model_cfg, mesh)
        total, metrics = loss_lib.compute_loss(
            trainer_logprobs=logprobs,
            inference_logprobs=mb.inference_logprobs,
            advantages=mb.advantages,
            loss_mask=mb.loss_mask,
            ref_logprobs=mb.ref_logprobs,
            rl_weights=mb.rl_weights,
            ce_weights=mb.ce_weights,
            ref_kl_weights=mb.ref_kl_weights,
            loss_cfg=loss_cfg,
            rl_scale=scales.rl,
            ce_scale=scales.ce,
            ref_kl_scale=scales.ref_kl,
        )
        metrics = dict(metrics)
        if spec.is_moe and model_cfg.moe_aux_coef > 0:
            # switch-style load-balance term, trained
            total = total + model_cfg.moe_aux_coef * moe_aux
            metrics["moe_load_balance"] = loss_lib.MaskedStat(
                total=moe_aux, count=torch.ones((), device=moe_aux.device))
        metrics["entropy"] = loss_lib.masked_stat(entropy, mb.loss_mask)
        metrics["trainer_logprob"] = loss_lib.masked_stat(logprobs, mb.loss_mask)
        return total, metrics

    return loss_fn


def _is_float(t: torch.Tensor) -> bool:
    return t.is_floating_point()


def _add_metrics(acc, new):
    if acc is None:
        return new
    return {k: loss_lib.MaskedStat(acc[k].total + v.total, acc[k].count + v.count)
            for k, v in new.items()}


def make_train_step(
    spec: ModelSpec,
    model_cfg,
    loss_cfg,
    optimizer: Optimizer,
    device: torch.device | str,
    base_params: Params | None = None,
):
    """Build the RL train step.

    fn(state, batch: MicroBatchArrays [N,B,L], scales) -> (state', metrics)

    ``batch`` may hold numpy arrays or tensors; it is placed on ``device``.
    ``metrics`` holds tensors: ``loss``, ``grad_norm`` (the norm before
    clipping) and a ``MaskedStat`` per monitored quantity, summed over the
    micro-batches. The global-norm clip is part of ``optimizer`` (see
    ``make_optimizer``)."""
    loss_fn = make_loss_fn(spec, model_cfg, loss_cfg, None, base_params)
    freeze_pats = [re.compile(p) for p in model_cfg.freeze] or None
    accum_bf16 = model_cfg.grad_accum_dtype == "bfloat16"

    def accum_grads(params: Params, batch: MicroBatchArrays, scales: Scales):
        # bf16 accumulation: differentiate against a pre-cast bf16 copy so the
        # gradients and their accumulator are half-size
        def grad_leaf(x):
            if not _is_float(x):
                return x
            x = x.detach()
            if accum_bf16:
                x = x.to(torch.bfloat16)
            return x.requires_grad_(True)

        gp = tree_map(grad_leaf, params)
        loss_acc, metrics_acc = None, None
        for i in range(batch.input_ids.shape[0]):
            mb = MicroBatchArrays(*[None if x is None else x[i] for x in batch])
            loss, metrics = loss_fn(gp, mb, scales)
            loss.backward()  # accumulates into the leaves' .grad in place
            loss = loss.detach()
            loss_acc = loss if loss_acc is None else loss_acc + loss
            metrics_acc = _add_metrics(metrics_acc, {
                k: loss_lib.MaskedStat(v.total.detach(), v.count.detach())
                for k, v in metrics.items()})

        def take_grad(path_leaf):
            path, x = path_leaf
            if not _is_float(x):
                return None
            g = x.grad if x.grad is not None else torch.zeros_like(x)
            x.grad = None
            if freeze_pats is not None and any(p.search(path) for p in freeze_pats):
                g = torch.zeros_like(g)
            return g.float()

        grads = optim_lib.tree_unflatten(gp, [take_grad(pl) for pl in tree_paths(gp)])
        return grads, loss_acc, metrics_acc

    @torch.no_grad()
    def apply_update(state: TrainState, grads):
        """``grads``: the gradient tree, or a one-element list that hands the
        tree over: the optimizer's first stage then holds the only reference
        and the tree is freed as soon as that stage has its output (at
        gigabytes of parameters a second float32 tree is what does not fit)."""
        owned = grads if isinstance(grads, list) else [grads]
        del grads
        grad_norm = optim_lib.global_norm(owned[0])
        updates, opt_state = optimizer.update(owned.pop(), state.opt_state, state.params)
        leaves = tree_leaves(state.params)
        if any(p.dtype == torch.bfloat16 for p in leaves if _is_float(p)):
            # bf16 masters: apply the f32 update with stochastic rounding so
            # sub-bf16-ulp updates survive in expectation
            gen = torch.Generator(device=leaves[0].device)
            gen.manual_seed((17 << 32) + int(state.step))
            new_leaves = []
            upd_leaves = tree_leaves(updates)
            del updates  # each float32 update is freed as soon as it is applied
            for i, p in enumerate(leaves):
                u, upd_leaves[i] = upd_leaves[i], None
                if p.dtype == torch.bfloat16:
                    new_leaves.append(optim_lib.stochastic_round_to(
                        torch.bfloat16, p.float() + u, gen))
                else:
                    new_leaves.append(p + u.to(p.dtype))
            params = optim_lib.tree_unflatten(state.params, new_leaves)
        else:
            params = tree_map(lambda p, u: p + u.to(p.dtype), state.params, updates)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), grad_norm

    def step_fn(state: TrainState, batch: MicroBatchArrays, scales: Scales):
        batch = put_batch(batch, device)
        grads, loss, metrics = accum_grads(state.params, batch, scales)
        owned = [grads]
        del grads
        new_state, grad_norm = apply_update(state, owned)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = grad_norm
        return new_state, metrics

    # the two halves, for scripts that time them apart
    step_fn.accum_grads = accum_grads
    step_fn.apply_update = apply_update
    return step_fn


def init_train_state(
    spec: ModelSpec,
    device: torch.device | str,
    optimizer: Optimizer,
    seed: int = 0,
    params: Params | None = None,
    offload_optimizer: bool = False,
    offload_params: bool = False,
    master_dtype: str = "float32",
) -> TrainState:
    """The train state on ``device``. With ``params=None``, random-init there
    from a generator seeded with ``seed`` (the numbers differ from the JAX
    package's ``jax.random`` init). ``master_dtype='bfloat16'`` halves the
    master weights; the update then applies with stochastic rounding."""
    from prime_rl_tpu_torch.models import get_family

    if offload_optimizer or offload_params:
        raise NotImplementedError("offload_optimizer/offload_params wait for the offload slice")
    device = torch.device(device)
    mdt = torch.bfloat16 if master_dtype == "bfloat16" else torch.float32
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = get_family(spec).init(spec, gen, dtype=torch.float32, device=device)
    params = tree_map(lambda x: x.to(device=device, dtype=mdt) if _is_float(x)
                      else x.to(device), params)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def opt_state_from_jax(optimizer: Optimizer, params: Params, np_state: dict) -> Any:
    """The JAX package's optimizer state, fetched as numpy, as this package's.

    ``np_state``: ``{"count": n, "mu": tree, "nu": tree}`` for ``adamw``
    (optax's ``ScaleByAdamState``), ``{"count": n, "m": tree of {mu_q, mu_s,
    nu_q, nu_s}}`` for ``adamw_8bit``, ``{"count": n, "trace": tree}`` for
    ``sgd`` with momentum, ``{"count": n}`` otherwise; trees in the params'
    layout. Every stage's step counter is set to ``count``, so update
    ``count + 1`` runs in both packages from the same state."""
    device = tree_leaves(params)[0].device
    count = int(np_state["count"])

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x)).to(device)

    state = optimizer.init(params)
    for stage in state:
        if "count" in stage:
            stage["count"] = count
        for key in ("mu", "nu", "m", "trace"):
            if key in stage:
                stage[key] = conv(np_state[key])
    return state
