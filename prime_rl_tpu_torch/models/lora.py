"""LoRA adapters as plain dicts of tensors (the port of the JAX package's
``models/lora.py``).

An adapter is a separate tree ``{"layers": {"q_a": [NL, in, r], "q_b": [NL,
r, out], ...}}`` threaded through the same forward as the base: the base
stays frozen (no gradient, never handed to the optimizer) and the train state
holds only the adapter, so optimizer memory is O(rank). Per-expert targets
(``moe_gate``/``moe_up``/``moe_down``, ``LoRAConfig.experts``) add a leading
expert axis: A ``[NL, E, in, r]``, B ``[NL, E, r, out]``.

Serving: ``merge_lora`` folds scale·A·B into the base for weight snapshots
and the colocated swap, and ``adapter_state_dict`` exports a standalone
PEFT-style adapter (``adapter_from_state_dict`` reads one back, the serving
bank's load format).

Divergence from the JAX package: ``init_lora`` draws A from a
``torch.Generator``, so the numbers differ from ``jax.random``'s; tests bring
JAX adapters over with ``lora_from_jax``. The sharding rule
(``lora_param_pspec``) waits for the multi-card slice.
"""

from __future__ import annotations

import numpy as np
import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.ops.layers import weight_mm

Params = dict

# target -> (in_dim_attr, out_dim_attr) resolved against the spec
_TARGET_DIMS = {
    "q": ("hidden_size", "q_dim"),
    "k": ("hidden_size", "kv_dim"),
    "v": ("hidden_size", "kv_dim"),
    "o": ("q_dim", "hidden_size"),
    "gate": ("hidden_size", "intermediate_size"),
    "up": ("hidden_size", "intermediate_size"),
    "down": ("intermediate_size", "hidden_size"),
}

# per-expert adapter targets (MoE families, LoRAConfig.experts=True): two
# extra grouped products in ops/moe.moe_mlp
_MOE_TARGETS = ("moe_gate", "moe_up", "moe_down")
_MOE_KEYS = {"moe_gate": "expert_gate", "moe_up": "expert_up", "moe_down": "expert_down"}

# the HF-style names (q_proj -> q) are accepted too
_ALIASES = {f"{t}_proj": t for t in _TARGET_DIMS}
_ALIASES.update({"q_b_proj": "q_b", "kv_a_proj_with_mqa": "kv_a",
                 "kv_b_proj": "kv_b", "o_proj": "o",
                 "expert_gate": "moe_gate", "expert_up": "moe_up",
                 "expert_down": "moe_down"})

# PEFT module names: target -> (module, HF projection)
_HF_NAMES = {"q": ("self_attn", "q_proj"), "k": ("self_attn", "k_proj"),
             "v": ("self_attn", "v_proj"), "o": ("self_attn", "o_proj"),
             "gate": ("mlp", "gate_proj"), "up": ("mlp", "up_proj"),
             "down": ("mlp", "down_proj"),
             # MLA latent projections (HF DeepseekV3 module names)
             "q_b": ("self_attn", "q_b_proj"),
             "kv_a": ("self_attn", "kv_a_proj_with_mqa"),
             "kv_b": ("self_attn", "kv_b_proj")}
_HF_EXPERT_NAMES = (("moe_gate", "gate_proj"), ("moe_up", "up_proj"), ("moe_down", "down_proj"))


def target_dims(t: str, spec: ModelSpec) -> tuple[int, int]:
    """(in, out) dims of target ``t`` on this spec. MLA families (``kv_lora_rank
    > 0``) have their own projection shapes; ``moe_*`` targets are per expert,
    and a latent MoE (Nemotron-H) computes its experts at
    ``moe_latent_size``."""
    if t in _MOE_TARGETS:
        d = getattr(spec, "moe_latent_size", 0) or spec.hidden_size
        m = spec.moe_intermediate_size
        return (m, d) if t == "moe_down" else (d, m)
    if spec.kv_lora_rank > 0:
        mla = {
            "q": (spec.hidden_size, spec.num_heads * spec.head_dim),
            "q_b": (spec.q_lora_rank, spec.num_heads * spec.head_dim),
            "kv_a": (spec.hidden_size, spec.kv_lora_rank + spec.qk_rope_head_dim),
            "kv_b": (spec.kv_lora_rank,
                     spec.num_heads * (spec.qk_nope_head_dim + spec.v_head_dim)),
            "o": (spec.num_heads * spec.v_head_dim, spec.hidden_size),
        }
        if t in mla:
            return mla[t]
    a, b = _TARGET_DIMS[t]
    return getattr(spec, a), getattr(spec, b)


def resolve_targets(cfg, spec: ModelSpec) -> list[str]:
    """The config's ``target_modules`` as this spec's targets, in order: HF
    names mapped, MLA's generic attention names onto its latent projections,
    a MoE spec's MLP names onto the per-expert targets when ``experts`` is on
    (skipped otherwise), per-expert targets skipped on a dense spec and
    ``moe_gate`` on a latent MoE (its experts are not gated)."""
    out = []
    experts_on = bool(getattr(cfg, "experts", False))
    for name in cfg.target_modules:
        t = _ALIASES.get(name, name)
        if spec.kv_lora_rank > 0:
            t = {"q": ("q_b" if spec.q_lora_rank else "q"), "k": "kv_b", "v": "kv_b"}.get(t, t)
        if (t not in _TARGET_DIMS and t not in ("q_b", "kv_a", "kv_b")
                and t not in _MOE_TARGETS):
            raise ValueError(f"unknown LoRA target {name!r}")
        if spec.is_moe and t in ("gate", "up", "down"):
            if not experts_on:
                continue
            t = f"moe_{t}"
        if t in _MOE_TARGETS:
            if not spec.is_moe:
                continue
            if t == "moe_gate" and getattr(spec, "moe_latent_size", 0):
                continue
        if t not in out:
            out.append(t)
    return out


def lora_scale(cfg) -> float:
    return cfg.alpha / cfg.rank


def init_lora(spec: ModelSpec, cfg, generator: torch.Generator, dtype=torch.float32,
              device: torch.device | str = "cpu") -> Params:
    """A ~ N(0, 0.02) drawn from ``generator`` (which must live on
    ``device``), B = 0: the identity at init. ``moe_*`` targets add a leading
    per-expert axis."""
    layers: dict[str, torch.Tensor] = {}
    nl, r = spec.num_layers, cfg.rank
    for t in resolve_targets(cfg, spec):
        d_in, d_out = target_dims(t, spec)
        lead = (nl, spec.num_experts) if t in _MOE_TARGETS else (nl,)
        a = torch.randn((*lead, d_in, r), generator=generator, device=device) * 0.02
        layers[f"{t}_a"] = a.to(dtype)
        layers[f"{t}_b"] = torch.zeros((*lead, r, d_out), dtype=dtype, device=device)
    return {"layers": layers}


def apply_lora_proj(x: torch.Tensor, w, lora_layer: dict | None, name: str,
                    scale: float) -> torch.Tensor:
    """y = x·W (+ scale · (x·A)·B), the adapter's products in x's dtype.
    ``w`` may be an int8 weight-only record (serving, ``ops/layers.weight_mm``)."""
    y = weight_mm(x, w)
    if lora_layer is not None and f"{name}_a" in lora_layer:
        a = lora_layer[f"{name}_a"].to(x.dtype)
        b = lora_layer[f"{name}_b"].to(x.dtype)
        y = y + scale * torch.matmul(torch.matmul(x, a), b)
    return y


def layer_slices(lora: Params | None, n: int) -> list[dict | None]:
    """Per-layer views of an adapter's stacks for its ``n`` layers (a list of
    n Nones without an adapter). Unbound once, so that the backward stacks
    each target's per-layer gradients in one copy."""
    if lora is None:
        return [None] * n
    per = {k: v.unbind(0) for k, v in lora["layers"].items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def merge_lora(base: Params, lora: Params, cfg, spec: ModelSpec | None = None) -> Params:
    """base + scale·A·B folded in, for serving snapshots, in float32 and
    rounded to each weight's dtype. New tensors for the merged weights; the
    rest of ``base`` is shared, never written.

    Layout-aware: split stacks (``dense_layers`` + ``layers``) take the
    matching slices of the [NL, ...] adapter stacks; the hybrids'
    ``attn_layers`` / ``lin_layers`` (Qwen3-Next) and ``attn_layers`` /
    ``moe_layers`` (Nemotron-H) take the rows of their pattern (needs
    ``spec``)."""
    scale = lora_scale(cfg)
    targets = sorted({k[:-2] for k in lora["layers"] if k.endswith("_a")})

    def merge_stack(stack: dict, idx) -> dict:
        merged = dict(stack)
        for t in targets:
            key = _MOE_KEYS.get(t, t)
            if key not in stack:
                continue
            a = lora["layers"][f"{t}_a"][idx].float()
            b = lora["layers"][f"{t}_b"][idx].float()
            if a.dim() == 4:  # per-expert [l, E, in, r] x [l, E, r, out]
                delta = torch.einsum("leir,lero->leio", a, b) * scale
            else:
                delta = torch.einsum("lir,lro->lio", a, b) * scale
            w = stack[key]
            merged[key] = (w.float() + delta.to(w.device)).to(w.dtype)
        return merged

    out = dict(base)
    if "attn_layers" in base:  # hybrid layouts: adapters index full depth
        if spec is None or not (spec.gdn_pattern or spec.layer_pattern):
            raise ValueError("merge_lora on a hybrid layout needs the spec")
        pat = spec.gdn_pattern or spec.layer_pattern
        stack_chars = ({"A": "attn_layers", "L": "lin_layers"} if spec.gdn_pattern
                       else {"*": "attn_layers", "E": "moe_layers"})
        for char, name in stack_chars.items():
            if name not in base:
                continue
            idx = [i for i, c in enumerate(pat) if c == char]
            if idx:
                out[name] = merge_stack(base[name], torch.tensor(idx))
        return out
    if "dense_layers" in base:
        k = next(iter(base["dense_layers"].values())).shape[0]
        out["dense_layers"] = merge_stack(base["dense_layers"], slice(0, k))
        out["layers"] = merge_stack(base["layers"], slice(k, None))
        return out
    out["layers"] = merge_stack(base["layers"], slice(None))
    return out


def _key(i: int, mod: str, hf: str, which: str) -> str:
    return f"base_model.model.model.layers.{i}.{mod}.{hf}.{which}.weight"


def adapter_from_state_dict(state: dict, spec: ModelSpec) -> dict[str, np.ndarray]:
    """Inverse of ``adapter_state_dict``: a PEFT-style flat dict (numpy arrays
    or tensors) -> stacked per-target numpy arrays {"q_a": [NL, in, r], "q_b":
    [NL, r, out], ...}, the serving bank's load format."""
    def host(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            return x.detach().float().cpu().numpy()
        return np.asarray(x)

    layers: dict[str, np.ndarray] = {}
    for t, (mod, hf) in _HF_NAMES.items():
        if _key(0, mod, hf, "lora_A") not in state:
            continue
        layers[f"{t}_a"] = np.stack([host(state[_key(i, mod, hf, "lora_A")]).T
                                     for i in range(spec.num_layers)])  # [NL, in, r]
        layers[f"{t}_b"] = np.stack([host(state[_key(i, mod, hf, "lora_B")]).T
                                     for i in range(spec.num_layers)])  # [NL, r, out]
    for t, hf in _HF_EXPERT_NAMES:
        if _key(0, "mlp.experts.0", hf, "lora_A") not in state:
            continue
        for which, suffix in (("lora_A", "a"), ("lora_B", "b")):
            layers[f"{t}_{suffix}"] = np.stack([
                np.stack([host(state[_key(i, f"mlp.experts.{e}", hf, which)]).T
                          for e in range(spec.num_experts)])
                for i in range(spec.num_layers)])  # [NL, E, ., .]
    if not layers:
        raise ValueError("no LoRA tensors found in adapter state dict")
    return layers


def adapter_state_dict(lora: Params, spec: ModelSpec) -> dict[str, np.ndarray]:
    """PEFT-style flat dict (per layer, HF naming, numpy float32) for
    standalone adapter snapshots."""
    def host(x) -> np.ndarray:
        return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    state: dict[str, np.ndarray] = {}
    for t, (mod, hf) in _HF_NAMES.items():
        a = lora["layers"].get(f"{t}_a")
        if a is None:
            continue
        a, b = host(a), host(lora["layers"][f"{t}_b"])
        for i in range(spec.num_layers):
            state[_key(i, mod, hf, "lora_A")] = np.ascontiguousarray(a[i].T)  # [r, in]
            state[_key(i, mod, hf, "lora_B")] = np.ascontiguousarray(b[i].T)  # [out, r]
    for t, hf in _HF_EXPERT_NAMES:
        a = lora["layers"].get(f"{t}_a")
        if a is None:
            continue
        a, b = host(a), host(lora["layers"][f"{t}_b"])  # [NL, E, ., .]
        for i in range(spec.num_layers):
            for e in range(spec.num_experts):
                state[_key(i, f"mlp.experts.{e}", hf, "lora_A")] = np.ascontiguousarray(a[i, e].T)
                state[_key(i, f"mlp.experts.{e}", hf, "lora_B")] = np.ascontiguousarray(b[i, e].T)
    return state


def save_adapter(lora: Params, spec: ModelSpec, directory) -> None:
    """Write ``adapter_model.safetensors`` (``adapter_state_dict``) into
    ``directory``, made if missing."""
    from pathlib import Path

    from safetensors.numpy import save_file

    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    save_file(adapter_state_dict(lora, spec), str(d / "adapter_model.safetensors"))


def load_adapter_file(path, spec: ModelSpec) -> dict[str, np.ndarray]:
    """A PEFT adapter from a ``.safetensors`` file or a directory holding
    ``adapter_model.safetensors`` (or any ``*.safetensors``), as
    ``adapter_from_state_dict`` stacks it."""
    from pathlib import Path

    from safetensors.numpy import load_file

    p = Path(path)
    files = [p] if p.is_file() else (
        [p / "adapter_model.safetensors"] if (p / "adapter_model.safetensors").exists()
        else sorted(p.glob("*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors adapter at {path}")
    state: dict = {}
    for f in files:
        state.update(load_file(str(f)))
    return adapter_from_state_dict(state, spec)


def lora_from_jax(np_lora: dict, device: torch.device | str = "cpu",
                  dtype=torch.float32) -> Params:
    """The JAX package's adapter tree, fetched as numpy arrays, as this
    package's: the same layout and values (the weight bridge the tests use)."""
    return {"layers": {k: torch.as_tensor(np.asarray(v, np.float32)).to(device=device, dtype=dtype)
                       for k, v in np_lora["layers"].items()}}
