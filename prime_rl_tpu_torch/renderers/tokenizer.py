"""First-party byte-level tokenizer with a ChatML-style template.

The image has no network egress and no HF tokenizer cache, so hermetic tests
and the sync-GRPO debug loop need a real tokenizer that works offline. This
is byte-exact and reversible: vocab = 256 raw bytes + special tokens, ChatML
markup rendered as special ids (token-exact chat templating is the renderer
contract the orchestrator depends on — reference: deps/renderers,
SURVEY.md §2.6).

API is the subset of ``transformers.PreTrainedTokenizer`` the framework
touches: ``__call__``, ``decode``, ``apply_chat_template``, special-token
ids. ``get_tokenizer()`` prefers a real HF tokenizer when one is available.
"""

from __future__ import annotations

from dataclasses import dataclass

SPECIAL_TOKENS = ["<|pad|>", "<|im_start|>", "<|im_end|>", "<|endoftext|>"]


class ByteTokenizer:
    """256 byte tokens + specials. ids: bytes at [0,255], specials after."""

    is_byte_level = True  # constrain.token_bytes_from_tokenizer fast path

    def __init__(self):
        self.pad_token_id = 256
        self.im_start_id = 257
        self.im_end_id = 258
        self.eos_token_id = 258  # <|im_end|> ends assistant turns (ChatML)
        self.eot_id = 259
        self.vocab_size = 260
        self.pad_token = "<|pad|>"
        self.eos_token = "<|im_end|>"
        self._special_by_id = {256 + i: tok for i, tok in enumerate(SPECIAL_TOKENS)}

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return list(text.encode("utf-8"))

    def __call__(self, text: str, add_special_tokens: bool = True) -> dict:
        return {"input_ids": self.encode(text)}

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out: list[str] = []
        buf = bytearray()
        for i in ids:
            i = int(i)
            if i < 256:
                buf.append(i)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens:
                    out.append(self._special_by_id.get(i, f"<|{i}|>"))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def apply_chat_template(
        self,
        messages: list[dict],
        tokenize: bool = True,
        add_generation_prompt: bool = False,
        **kw,
    ):
        """ChatML: <|im_start|>role\\ncontent<|im_end|>\\n per message."""
        ids: list[int] = []
        for m in messages:
            ids.append(self.im_start_id)
            ids.extend(self.encode(m.get("role", "user") + "\n"))
            ids.extend(self.encode(m.get("content") or ""))
            ids.append(self.im_end_id)
            ids.extend(self.encode("\n"))
        if add_generation_prompt:
            ids.append(self.im_start_id)
            ids.extend(self.encode("assistant\n"))
        if tokenize:
            return ids
        return self.decode(ids, skip_special_tokens=False)


def get_tokenizer(name: str | None):
    """HF tokenizer if loadable (local dir or cache); ByteTokenizer for
    ``byte``/None or when HF loading fails offline."""
    if name in (None, "byte"):
        return ByteTokenizer()
    try:
        import os

        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name)
    except Exception:
        return ByteTokenizer()
