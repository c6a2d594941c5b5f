"""Token-exact chat renderers (first-party analogue of the reference's
``renderers`` dependency — SURVEY.md §2.6, docs/algorithms.md:482-550).

A renderer turns a message list into exact token ids for the policy
(``render_ids``), parses a completion back into a message
(``parse_response``), and — critically for multi-turn RL — implements the
**extension property** (``bridge_to_next_turn``): rendering turns
incrementally must produce a prefix-extension of the previous render, so a
rollout's flat token stream with per-token masks is consistent with what the
engine actually sampled (the importance ratios depend on this being exact).

``ChatMLRenderer`` covers the ChatML family (Qwen3 templates are ChatML) for
any tokenizer that exposes the im_start/im_end special ids; with the
ByteTokenizer it is fully offline-testable.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer


@dataclass
class RenderedTurn:
    """Incremental render result: tokens appended since the previous turn and
    which of them the policy must produce (vs be prompted with)."""

    token_ids: list[int]
    sampled_mask: list[bool]


class Renderer:
    def render_ids(self, messages: list[dict], add_generation_prompt: bool = True) -> list[int]:
        raise NotImplementedError

    def parse_response(self, token_ids: list[int]) -> dict:
        raise NotImplementedError

    def bridge_to_next_turn(
        self, prev_ids: list[int], messages: list[dict], add_generation_prompt: bool = True
    ) -> RenderedTurn:
        """Tokens to append so ``prev_ids + appended`` equals the render of
        ``messages``. Raises if the new render is not a prefix-extension."""
        full = self.render_ids(messages, add_generation_prompt)
        if full[: len(prev_ids)] != list(prev_ids):
            raise ValueError(
                "render is not a prefix-extension of the previous turn "
                "(extension property violated)"
            )
        appended = full[len(prev_ids):]
        return RenderedTurn(appended, [False] * len(appended))


class ChatMLRenderer(Renderer):
    """<|im_start|>role\\ncontent<|im_end|>\\n per message (Qwen/ChatML)."""

    def __init__(self, tokenizer=None):
        self.tokenizer = tokenizer or ByteTokenizer()

    def render_ids(self, messages: list[dict], add_generation_prompt: bool = True) -> list[int]:
        return self.tokenizer.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=add_generation_prompt
        )

    def parse_response(self, token_ids: list[int]) -> dict:
        ids = list(token_ids)
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if ids and ids[-1] == eos:
            ids = ids[:-1]
        return {"role": "assistant", "content": self.tokenizer.decode(ids)}

    def continuation_ids(
        self,
        new_messages: list[dict],
        add_generation_prompt: bool = True,
        after_completion: bool = False,
        completion_terminated: bool = True,
    ) -> list[int]:
        """Incremental render of the NEXT turn(s) — the best-effort
        interleaving path for multi-turn rollouts: the sampled span stays
        byte-exact in the stream and the renderer supplies only the template
        glue (reference: renderers ``bridge_to_next_turn`` extension
        property, docs/algorithms.md:516-543)."""
        tok = self.tokenizer
        ids: list[int] = []
        if after_completion:
            if not completion_terminated:
                ids.append(tok.eos_token_id)  # close the truncated turn
            ids.extend(tok.encode("\n"))
        ids.extend(self.render_ids(new_messages, add_generation_prompt=False))
        if add_generation_prompt:
            ids.extend(self.render_ids([], add_generation_prompt=True))
        return ids


class TraceBuilder:
    """Accumulates a multi-turn rollout into one flat token stream with
    per-token sampled masks/logprobs/temperatures — the Trace the orchestrator
    trains on (reference: verifiers Trace contract, trajectories.py)."""

    def __init__(self, renderer: ChatMLRenderer):
        self.renderer = renderer
        self.messages: list[dict] = []
        self.token_ids: list[int] = []
        self.sampled_mask: list[bool] = []
        self.logprobs: list[float] = []
        self.temperatures: list[float] = []
        self.routed: list = []  # per-token [NL, K] expert ids or None
        self._after_completion = False
        self._completion_terminated = True

    def add_context(self, messages: list[dict], add_generation_prompt: bool = True) -> list[int]:
        """Append environment/user turns; returns the full prompt ids to send
        to the engine."""
        self.messages.extend(messages)
        ids = self.renderer.continuation_ids(
            messages, add_generation_prompt,
            after_completion=self._after_completion,
            completion_terminated=self._completion_terminated,
        )
        self.token_ids.extend(ids)
        self.sampled_mask.extend([False] * len(ids))
        self.routed.extend([None] * len(ids))
        self.logprobs.extend([0.0] * len(ids))
        self.temperatures.extend([1.0] * len(ids))
        self._after_completion = False
        return list(self.token_ids)

    def add_completion(self, token_ids: list[int], logprobs: list[float],
                       temperature: float, routed_experts: list | None = None) -> dict:
        """Append the engine's sampled tokens; returns the parsed message
        (also recorded so the next render stays prefix-consistent).
        ``routed_experts``: per-token [NL, K] MoE routing rows (router
        replay) aligned to ``token_ids``."""
        self.token_ids.extend(int(t) for t in token_ids)
        self.sampled_mask.extend([True] * len(token_ids))
        self.logprobs.extend(float(x) for x in logprobs)
        self.temperatures.extend([temperature] * len(token_ids))
        if routed_experts is not None and len(routed_experts) == len(token_ids):
            self.routed.extend(routed_experts)
        else:
            self.routed.extend([None] * len(token_ids))
        message = self.renderer.parse_response(token_ids)
        self.messages.append(message)
        self._after_completion = True
        self._completion_terminated = bool(
            token_ids and token_ids[-1] == self.renderer.tokenizer.eos_token_id
        )
        return message

    def to_trace(self, reward: float | None = None, metrics: dict | None = None):
        from prime_rl_tpu_torch.envs.types import Trace

        return Trace(
            token_ids=list(self.token_ids),
            sampled_mask=list(self.sampled_mask),
            logprobs=list(self.logprobs),
            temperatures=list(self.temperatures),
            reward=reward,
            metrics=metrics or {},
            messages=list(self.messages),
            routed_experts=(list(self.routed)
                            if any(r is not None for r in self.routed) else None),
        )


@dataclass(frozen=True)
class TemplateSpec:
    """One chat-template family as exact glue strings. Hand-coding the glue
    (instead of re-running apply_chat_template over the whole history) gives
    the extension property BY CONSTRUCTION — no thinking-stripping or
    retokenization drift can rewrite earlier turns (reference: hand-coded
    renderers for qwen3/glm/gpt-oss/deepseek/kimi/llama families,
    docs/algorithms.md:482-550)."""

    prefix: dict[str, str]  # role -> turn opening ("*" = default)
    suffix: dict[str, str]  # role -> turn closing
    generation_prompt: str  # opens the next assistant turn
    bos: str = ""
    think_open: str = "<think>"
    think_close: str = "</think>"
    tool_open: str = "<tool_call>"
    tool_close: str = "</tool_call>"

    def turn_prefix(self, role: str) -> str:
        return self.prefix.get(role, self.prefix["*"]).format(role=role)

    def turn_suffix(self, role: str) -> str:
        return self.suffix.get(role, self.suffix["*"]).format(role=role)


TEMPLATE_FAMILIES: dict[str, TemplateSpec] = {
    # ChatML: Qwen3 / debug / minimax-class templates
    "chatml": TemplateSpec(
        prefix={"*": "<|im_start|>{role}\n"},
        suffix={"*": "<|im_end|>\n"},
        generation_prompt="<|im_start|>assistant\n",
    ),
    "llama3": TemplateSpec(
        prefix={"*": "<|start_header_id|>{role}<|end_header_id|>\n\n"},
        suffix={"*": "<|eot_id|>"},
        generation_prompt="<|start_header_id|>assistant<|end_header_id|>\n\n",
        bos="<|begin_of_text|>",
    ),
    "glm4": TemplateSpec(
        prefix={"*": "<|{role}|>\n"},
        suffix={"*": ""},
        generation_prompt="<|assistant|>\n",
        bos="[gMASK]<sop>",
    ),
    # gpt-oss harmony (final channel; analysis channels are parsed as thinking)
    "gpt_oss": TemplateSpec(
        prefix={"*": "<|start|>{role}<|message|>",
                "assistant": "<|start|>assistant<|channel|>final<|message|>"},
        suffix={"*": "<|end|>"},
        generation_prompt="<|start|>assistant<|channel|>final<|message|>",
        think_open="<|channel|>analysis<|message|>",
        think_close="<|end|>",
    ),
    "deepseek3": TemplateSpec(
        prefix={"user": "<｜User｜>", "assistant": "<｜Assistant｜>", "*": ""},
        suffix={"assistant": "<｜end▁of▁sentence｜>", "*": ""},
        generation_prompt="<｜Assistant｜>",
        bos="<｜begin▁of▁sentence｜>",
    ),
    "kimi_k2": TemplateSpec(
        prefix={"*": "<|im_user|>{role}<|im_middle|>",
                "assistant": "<|im_assistant|>assistant<|im_middle|>",
                "system": "<|im_system|>system<|im_middle|>"},
        suffix={"*": "<|im_end|>"},
        generation_prompt="<|im_assistant|>assistant<|im_middle|>",
    ),
}


class TemplateRenderer(Renderer):
    """Template-glue renderer over any tokenizer: earlier turns are NEVER
    re-rendered (the glue is appended around verbatim spans), so the
    extension property holds by construction."""

    def __init__(self, spec: TemplateSpec, tokenizer=None):
        self.spec = spec
        self.tokenizer = tokenizer or ByteTokenizer()

    def _encode(self, text: str) -> list[int]:
        try:
            return list(self.tokenizer.encode(text, add_special_tokens=False))
        except TypeError:
            return list(self.tokenizer.encode(text))

    def _message_text(self, m: dict) -> str:
        parts = []
        if m.get("reasoning_content"):
            parts.append(f"{self.spec.think_open}{m['reasoning_content']}{self.spec.think_close}")
        parts.append(m.get("content") or "")
        for call in m.get("tool_calls") or []:
            import json

            fn = call.get("function", call)
            parts.append(f"{self.spec.tool_open}"
                         f"{json.dumps({'name': fn.get('name'), 'arguments': fn.get('arguments')})}"
                         f"{self.spec.tool_close}")
        return "".join(parts)

    def render_ids(self, messages: list[dict], add_generation_prompt: bool = True) -> list[int]:
        text = self.spec.bos
        for m in messages:
            role = m.get("role", "user")
            text += (self.spec.turn_prefix(role) + self._message_text(m)
                     + self.spec.turn_suffix(role))
        if add_generation_prompt:
            text += self.spec.generation_prompt
        return self._encode(text)

    def parse_response(self, token_ids: list[int]) -> dict:
        ids = list(token_ids)
        eos = getattr(self.tokenizer, "eos_token_id", None)
        if ids and ids[-1] == eos:
            ids = ids[:-1]
        text = self.tokenizer.decode(ids)
        suffix = self.spec.turn_suffix("assistant")
        if suffix and text.endswith(suffix):
            text = text[: -len(suffix)]
        out: dict[str, Any] = {"role": "assistant"}
        if self.spec.think_open in text and self.spec.think_close in text:
            start = text.index(self.spec.think_open) + len(self.spec.think_open)
            end = text.index(self.spec.think_close, start)
            out["reasoning_content"] = text[start:end]
            text = text[:start - len(self.spec.think_open)] + text[end + len(self.spec.think_close):]
        tool_calls = []
        while self.spec.tool_open in text and self.spec.tool_close in text:
            import json

            start = text.index(self.spec.tool_open)
            end = text.index(self.spec.tool_close, start)
            blob = text[start + len(self.spec.tool_open):end]
            try:
                parsed = json.loads(blob)
                tool_calls.append({"type": "function", "function": parsed})
            except json.JSONDecodeError:
                pass
            text = text[:start] + text[end + len(self.spec.tool_close):]
        if tool_calls:
            out["tool_calls"] = tool_calls
        out["content"] = text
        return out

    def continuation_ids(
        self,
        new_messages: list[dict],
        add_generation_prompt: bool = True,
        after_completion: bool = False,
        completion_terminated: bool = True,
    ) -> list[int]:
        """Glue + new turns ONLY — prior turns stay verbatim in the stream."""
        text = ""
        if after_completion and not completion_terminated:
            text += self.spec.turn_suffix("assistant")  # close the truncated turn
        for m in new_messages:
            role = m.get("role", "user")
            text += (self.spec.turn_prefix(role) + self._message_text(m)
                     + self.spec.turn_suffix(role))
        if add_generation_prompt:
            text += self.spec.generation_prompt
        ids = self._encode(text)
        if after_completion and completion_terminated:
            # the eos the engine sampled doubles as the turn close for
            # eos==turn-suffix templates; others prepend their suffix above
            pass
        return ids


def detect_family(tokenizer) -> str:
    """Best-effort template-family detection from the tokenizer
    (reference: renderer name="auto")."""
    name = (getattr(tokenizer, "name_or_path", "") or "").lower()
    for key, fam in (("qwen", "chatml"), ("llama", "llama3"), ("glm", "glm4"),
                     ("gpt-oss", "gpt_oss"), ("gpt_oss", "gpt_oss"),
                     ("deepseek", "deepseek3"), ("kimi", "kimi_k2")):
        if key in name:
            return fam
    return "chatml"


def create_renderer(tokenizer=None, family: str = "chatml") -> Renderer:
    """Registry entry point (reference: create_renderer + hand-coded renderer
    table, docs/algorithms.md:482-550)."""
    if family == "auto":
        family = detect_family(tokenizer)
    if family in ("chatml", "qwen3", "byte", "debug"):
        return ChatMLRenderer(tokenizer)
    spec = TEMPLATE_FAMILIES.get(family)
    if spec is None:
        raise ValueError(
            f"no renderer for family {family!r} (have {sorted(TEMPLATE_FAMILIES)})")
    return TemplateRenderer(spec, tokenizer)
