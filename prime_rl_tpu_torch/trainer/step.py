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
  copy), and are widened to float32 a leaf at a time in the update.
- Normalization: losses are divided by **global** per-component token counts
  (``scales``, whole-step sums), so the number of micro-batches never changes
  the effective loss.
- bfloat16 masters take the float32 update with stochastic rounding, the
  random bits drawn from a generator seeded from the step.

- LoRA mode (``base_params`` given): the state's params are the adapter
  tree (``models/lora.py``) and the base is frozen: its tensors never
  require a gradient and never reach the optimizer. The backward still runs
  K2a and K2b, whose dq, dk and dv carry the gradients of the adapters on
  q, k and v, and the dX products through every frozen projection; the
  weight gradients of the base are never formed.

- The step runs in two phases, as the JAX step's split programs do: the
  gradients first, then the update a parameter leaf at a time
  (``_streamed_update``), in the same bits as a whole-tree update: the rules
  are elementwise and the clip takes the whole tree's norm
  (``optim.leaf_states``). Only one leaf's float32 temporaries exist at once.
- Host offload (``offload_optimizer``, ``offload_params``; the long-context
  levers): the optimizer state's leaves of two or more dims, and with
  ``offload_params`` every master, live in pinned host memory
  (``utils/offload.py``; on the CPU the host tier is the same device and the
  same code runs, unpinned). The gradient phase then has nothing of the
  offloaded state on the card (under ``offload_params`` it runs on a bf16
  copy of the masters made on the card, and accumulates in bf16, as JAX's
  does), and the update holds one leaf's master, gradient and optimizer
  state on the card, the next leaf's copied in on a side stream meanwhile,
  the new values copied back out on another.

Not carried over from the JAX package, as work-arounds for its runtime and
not contract: ``dispatch_micro_batches`` (the host loop is the only form
here; the config field is accepted and changes nothing) and the sharding
helpers.
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, NamedTuple

import numpy as np
import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.ops.lm_head import chunked_logprob_entropy
from prime_rl_tpu_torch.trainer import optim as optim_lib
from prime_rl_tpu_torch.trainer.optim import Optimizer, tree_leaves, tree_map, tree_paths
from prime_rl_tpu_torch.trainer.rl import loss as loss_lib
from prime_rl_tpu_torch.utils import offload as host_tier

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
    # VLM streams (``trainer/batch._assemble_mm``), None on text families
    mm_patches: Any = None  # f32 [N, P, patch_dim]
    mm_vis_seg_ids: Any = None  # int32 [N, P], 0 = pad
    mm_vis_pos_idx: Any = None  # int32 [N, 4, P]
    mm_vis_pos_w: Any = None  # f32 [N, 4, P]
    mm_vis_rope_coords: Any = None  # int32 [N, P, 2]
    mm_img_slot: Any = None  # int32 [N, B, L], -1 = not a vision position
    mm_position_ids: Any = None  # int32 [N, 3, B, L]


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
    if mb.mm_patches is not None:
        if spec.vision is None:
            raise ValueError(f"the batch carries vision streams but {spec.family!r} has no "
                             "vision tower")
        extra["mm"] = {
            "patches": mb.mm_patches,
            "vis_seg_ids": mb.mm_vis_seg_ids,
            "vis_pos_idx": mb.mm_vis_pos_idx,
            "vis_pos_w": mb.mm_vis_pos_w,
            "vis_rope_coords": mb.mm_vis_rope_coords,
            "img_slot": mb.mm_img_slot,
            "mm_position_ids": mb.mm_position_ids,
        }
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
    """Per-micro-batch loss: (params, mb, scales) -> (loss, metrics). With a
    frozen ``base_params`` (LoRA mode) ``params`` is the adapter tree and the
    forward runs the base with it."""
    if base_params is not None and model_cfg.lora is None:
        raise ValueError("base_params (LoRA mode) needs model.lora")
    scale = None
    if base_params is not None:
        from prime_rl_tpu_torch.models.lora import lora_scale

        scale = lora_scale(model_cfg.lora)

    def loss_fn(params: Params, mb, scales: Scales):
        if base_params is not None:
            logprobs, entropy, moe_aux = model_logprobs(base_params, spec, mb, model_cfg, mesh,
                                                        lora=params, lora_scale=scale)
        else:
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
    offload_optimizer: bool = False,
    offload_params: bool = False,
):
    """Build the RL train step.

    fn(state, batch: MicroBatchArrays [N,B,L], scales) -> (state', metrics)

    ``batch`` may hold numpy arrays or tensors; it is placed on ``device``.
    ``metrics`` holds tensors: ``loss``, ``grad_norm`` (the norm before
    clipping) and a ``MaskedStat`` per monitored quantity, summed over the
    micro-batches. The global-norm clip is part of ``optimizer`` (see
    ``make_optimizer``). ``base_params``: the frozen base of LoRA mode (the
    state then holds the adapter tree, ``init_lora_train_state``).
    ``offload_optimizer`` / ``offload_params``: the state was made by
    ``init_train_state`` with the same flags; the step then streams the
    host-tier leaves (the module's notes) and writes the new values of the
    host-tier leaves into their pinned buffers in place (the state it is
    given is used up, as the JAX step donates its state)."""
    if base_params is not None and (offload_optimizer or offload_params):
        raise ValueError("offload_optimizer/offload_params apply to the full train state; "
                         "LoRA mode's state is the adapter tree")
    device = torch.device(device)
    loss_fn = make_loss_fn(spec, model_cfg, loss_cfg, None, base_params)
    freeze_pats = [re.compile(p) for p in model_cfg.freeze] or None
    accum_bf16 = model_cfg.grad_accum_dtype == "bfloat16"

    def accum_grads(params: Params, batch: MicroBatchArrays, scales: Scales):
        """(gradient tree, loss, metrics) summed over the micro-batches, the
        gradients in the dtype they were accumulated in (the update widens a
        leaf at a time)."""
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
            return g

        grads = optim_lib.tree_unflatten(gp, [take_grad(pl) for pl in tree_paths(gp)])
        return grads, loss_acc, metrics_acc

    def apply_update(state: TrainState, grads):
        """(new state, grad_norm): the update half, a leaf at a time."""
        return _streamed_update(state, grads, optimizer, device, offload_optimizer,
                                offload_params)

    def step_fn(state: TrainState, batch: MicroBatchArrays, scales: Scales):
        batch = put_batch(batch, device)
        # phase 1, the gradients: under offload_params on a bf16 copy of the
        # masters made on the card (a leaf's float32 transient at a time)
        gp = state.params
        if offload_params:
            gp = tree_map(lambda x: (x.to(device, non_blocking=True).to(torch.bfloat16)
                                     if _is_float(x) else x.to(device)), state.params)
        grads, loss, metrics = accum_grads(gp, batch, scales)
        del gp
        # phase 2, the update a leaf at a time
        new_state, grad_norm = apply_update(state, grads)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = grad_norm
        return new_state, metrics

    # the two halves, for scripts that time them apart
    step_fn.accum_grads = accum_grads
    step_fn.apply_update = apply_update
    return step_fn


def _slice_flags(sl: list, offload_optimizer: bool) -> list[dict]:
    """Stage by stage, for each tree entry of a leaf's state slice, which of
    its tensors go to the host tier: those of two or more dims under
    ``offload_optimizer`` (the JAX rule, ``state_shardings``)."""
    return [{k: {name: offload_optimizer and t.dim() >= 2
                 for name, t in _entry_tensors(v["_"]).items()}
             for k, v in st.items() if isinstance(v, dict)} for st in sl]


def _entry_tensors(entry) -> dict[str, torch.Tensor]:
    """A state entry's tensors by name ("" for a lone tensor)."""
    return dict(entry) if isinstance(entry, dict) else {"": entry}


def _map_flagged(sl: list, flags: list[dict], fn) -> list:
    """A copy of the state slice ``sl`` with ``fn(t)`` in place of each
    tensor ``flags`` marks (stage by stage, entry by entry, name by name)."""
    out = []
    for st, fl in zip(sl, flags):
        st = dict(st)
        for k, names in fl.items():
            parts = _entry_tensors(st[k]["_"])
            parts = {name: fn(t) if names[name] else t for name, t in parts.items()}
            st[k] = {"_": parts[""] if "" in parts else parts}
        out.append(st)
    return out


def host_leaves(state: TrainState, offload_optimizer: bool, offload_params: bool
                ) -> tuple[list[bool], list[list[dict]]]:
    """Which leaves the flags put in the host tier: (a flag a parameter leaf,
    every master under ``offload_params``; a leaf's ``_slice_flags``). In
    the port's own layouts ``offload_optimizer`` moves AdamW's mu and nu of
    every matrix (a norm weight's stay on the card), the momentum trace
    likewise, and every 8-bit AdamW tensor, codes ``[nb, block]`` and scales
    ``[nb, 1]`` alike, norm weights' too (the port's 8-bit moments run in
    blocks of a flat leaf, ``optim.scale_by_adam_8bit``)."""
    slices = optim_lib.leaf_states(state.opt_state, state.params)
    return ([offload_params] * len(slices),
            [_slice_flags(sl, offload_optimizer) for sl in slices])


def _streamed_update(state: TrainState, grads, optimizer: Optimizer, device: torch.device,
                     offload_optimizer: bool, offload_params: bool):
    """The update a parameter leaf at a time: (new state, grad_norm). Leaf
    i's master, gradient and optimizer-state slice are on the card while its
    update runs. Where the flags put leaves in the host tier, the host-tier
    ones of leaf i + 1 are copied in meanwhile on the ``h2d`` side stream
    (their device copies recorded on the compute stream, so that the
    allocator does not reuse them while it reads them), and leaf i's new
    host-tier values go back on the ``d2h`` side stream, into the same pinned
    buffers. Bit for bit the whole-tree update: the gradient norm of the
    whole tree goes to the clip, the rules run on each leaf as they run on
    the tree, and a bf16 master's stochastic rounding draws from one
    generator in leaf order."""
    side = device.type == "cuda" and (offload_optimizer or offload_params)
    p_leaves = tree_leaves(state.params)
    grad_norm = optim_lib.global_norm(grads)
    g_leaves = tree_leaves(grads)
    del grads
    n = len(p_leaves)
    old = optim_lib.leaf_states(state.opt_state, state.params)
    p_host, o_host = [offload_params] * n, [_slice_flags(sl, offload_optimizer) for sl in old]
    gen = None
    if any(_is_float(p) and p.dtype == torch.bfloat16 for p in p_leaves):
        gen = torch.Generator(device=device)
        gen.manual_seed((17 << 32) + int(state.step))
    compute = torch.cuda.current_stream(device) if side else None
    h2d = host_tier.side_stream(device, "h2d") if side else None
    d2h = host_tier.side_stream(device, "d2h") if side else None

    def on_stream(stream):
        return torch.cuda.stream(stream) if side else contextlib.nullcontext()

    def bring_in(i):
        """Leaf i's (master, state slice) with the host-tier tensors copied to
        the card on the side stream, and the copies' event."""
        def copy_in(t):
            return t.to(device, non_blocking=True)

        with on_stream(h2d):
            p = copy_in(p_leaves[i]) if p_host[i] else p_leaves[i]
            sl = _map_flagged(old[i], o_host[i], copy_in)
            ready = None
            if side:
                ready = torch.cuda.Event()
                ready.record(h2d)
        return p, sl, ready

    def used_here(t):  # a side stream's copy, used (and freed) on the compute stream
        t.record_stream(compute)
        return t

    new_p, slices = [], []
    nxt = bring_in(0) if n else None
    for i in range(n):
        p, sl, ready = nxt
        nxt = bring_in(i + 1) if i + 1 < n else None
        if side:
            compute.wait_event(ready)
            if p_host[i]:
                used_here(p)
            _map_flagged(sl, o_host[i], used_here)
        g, g_leaves[i] = g_leaves[i], None
        with torch.no_grad():
            u, new_sl = optimizer.update({"_": g.float()}, sl, {"_": p}, norm=grad_norm)
            del g, sl
            u = u["_"]
            if p.dtype == torch.bfloat16:
                p2 = optim_lib.stochastic_round_to(torch.bfloat16, p.float() + u, gen)
            else:
                p2 = p + u.to(p.dtype)
            del u, p
        # the new host-tier values go back into their own pinned buffers
        if side:
            d2h.wait_stream(compute)
        with on_stream(d2h):
            if p_host[i]:
                p2 = _write_back(p_leaves[i], p2, d2h)
            olds = []  # the host buffers, in _map_flagged's order
            _map_flagged(old[i], o_host[i], olds.append)
            olds = iter(olds)
            new_sl = _map_flagged(new_sl, o_host[i], lambda t: _write_back(next(olds), t, d2h))
        new_p.append(p2)
        slices.append(new_sl)
    if side:  # the host buffers hold the new values before anyone reads them
        d2h.synchronize()
    params = optim_lib.tree_unflatten(state.params, new_p)
    opt_state = optim_lib.join_leaf_states(state.opt_state, state.params, slices)
    return TrainState(params=params, opt_state=opt_state, step=state.step + 1), grad_norm


def _write_back(host: torch.Tensor, new: torch.Tensor, stream) -> torch.Tensor:
    """``new`` copied into the host-tier buffer ``host`` (on ``stream``, the
    current one, where it is a CUDA stream: ``new`` is recorded on it so that
    its memory is not reused before the copy has read it); returns ``host``."""
    host.copy_(new, non_blocking=True)
    if stream is not None and new.is_cuda:
        new.record_stream(stream)
    return host


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
    master weights; the update then applies with stochastic rounding.
    ``offload_optimizer`` parks the optimizer state's tensors of two or more
    dims in the host tier, ``offload_params`` every master
    (``host_leaves``; ``utils/offload.to_host``: pinned CPU memory on the
    card, which raises where it cannot pin); the step built with the same
    flags streams them (``make_train_step``)."""
    from prime_rl_tpu_torch.models import get_family

    device = torch.device(device)
    mdt = torch.bfloat16 if master_dtype == "bfloat16" else torch.float32
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = get_family(spec).init(spec, gen, dtype=torch.float32, device=device)
    params = tree_map(lambda x: x.to(device=device, dtype=mdt) if _is_float(x)
                      else x.to(device), params)
    if not (offload_optimizer or offload_params):
        return TrainState(params=params, opt_state=optimizer.init(params), step=0)
    # a leaf at a time, so that no whole optimizer state exists on the card
    leaves, slices = tree_leaves(params), []
    for p in leaves:
        sl = optimizer.init({"_": p})
        slices.append(_map_flagged(sl, _slice_flags(sl, offload_optimizer),
                                   lambda t: host_tier.to_host(t, device)))
    if offload_params:
        leaves = [host_tier.to_host(p, device) for p in leaves]
    return TrainState(params=optim_lib.tree_unflatten(params, leaves),
                      opt_state=optim_lib.join_leaf_states(slices[0], params, slices), step=0)


def init_base_params(spec: ModelSpec, device: torch.device | str, seed: int = 0,
                     params: Params | None = None, dtype=torch.bfloat16) -> Params:
    """The frozen base of LoRA mode on ``device`` in ``dtype`` (the compute
    dtype: float32 masters exist only for trained params): ``params`` cast
    and placed, or a random init there from a generator seeded with ``seed``
    (the numbers differ from the JAX package's). No tensor requires a
    gradient."""
    from prime_rl_tpu_torch.models import get_family

    device = torch.device(device)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = get_family(spec).init(spec, gen, dtype=torch.float32, device=device)
    return tree_map(lambda x: (x.detach().to(device=device, dtype=dtype) if _is_float(x)
                               else x.to(device)), params)


def init_lora_train_state(spec: ModelSpec, lora_cfg, device: torch.device | str,
                          optimizer: Optimizer, seed: int = 0) -> TrainState:
    """The adapter-only train state on ``device``: ``init_lora`` from a
    generator seeded with ``seed`` (A ~ N(0, 0.02), B = 0), float32, and the
    optimizer's state over it."""
    from prime_rl_tpu_torch.models.lora import init_lora

    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_lora(spec, lora_cfg, gen, dtype=torch.float32, device=device)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def params_fingerprint(params: Params, chunk: int = 1 << 24) -> str:
    """A digest of every tensor's bits, computed on its device: per tensor,
    the int64 sum of its elements read as integers of their width and that
    sum weighted by position (wrapping, as int64 arithmetic does), hashed
    together. Equal trees give equal digests; a changed element changes it
    but for a chance collision. For checking that a frozen base stays
    frozen, without copying it to the host."""
    import hashlib

    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    sums = []
    for path, t in tree_paths(params):
        flat = t.detach().reshape(-1).view(ints[t.element_size()])
        s1 = s2 = torch.zeros((), dtype=torch.int64, device=t.device)
        for lo in range(0, flat.numel(), chunk):
            v = flat[lo:lo + chunk].long()
            w = torch.arange(lo, lo + v.numel(), device=t.device) % 4093 + 1
            s1 = s1 + v.sum()
            s2 = s2 + (v * w).sum()
        sums.append(f"{path}:{int(s1)}:{int(s2)}")
    return hashlib.sha256("|".join(sums).encode()).hexdigest()[:16]


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
