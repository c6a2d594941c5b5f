"""Constrained (guided) decoding: JSON-schema / regex token masking (the
port's copy of the JAX package's ``sampler/constrain.py``, numpy only, the
same behaviour).

The constraint is compiled to a BYTE-level DFA whose transition table the
engine keeps on the device as a plain int32 tensor: the per-step token mask
is computed on the device by walking every vocab token's bytes through the
table in parallel (one gather a byte), so the engine's multi-token decode
block stays on the stream. No per-step host round-trip.

Pipeline:
  JSON schema --json_schema_to_regex--> regex --compile_regex--> CharDFA
  CharDFA.trans [NS, 256] int32 (-1 = dead) + .accept [NS] bool
  token byte tables: chars [V, Lm] uint8 + lens [V] int32 (per tokenizer)

Sampling semantics (outlines/xgrammar-style):
  - a token is allowed iff its full byte string keeps the DFA alive
  - EOS is allowed iff the current state is accepting
  - if nothing is allowed (dead end), EOS is force-allowed so sampling
    never sees an all-masked row
"""

from __future__ import annotations

import json
import re as _re
from dataclasses import dataclass, field

import numpy as np

MAX_STATES = 2048  # DFA size cap — [C=4, 2048, 256] int32 bank = ~8 MB of device memory
# (the mask's cost is independent of NS: its gathers are per [slots, V])
MAX_TOKEN_BYTES = 16  # tokens longer than this are disallowed when constrained


# ---------------------------------------------------------------------------
# regex AST + parser (byte-level subset: literals, escapes, classes, groups,
# alternation, ., quantifiers * + ? {m} {m,n} {m,})
# ---------------------------------------------------------------------------


@dataclass
class _Lit:
    bytes_: frozenset  # allowed byte values


@dataclass
class _Cat:
    parts: list


@dataclass
class _Alt:
    parts: list


@dataclass
class _Rep:
    node: object
    lo: int
    hi: int | None  # None = unbounded


_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = frozenset(
    list(range(0x30, 0x3A)) + list(range(0x41, 0x5B))
    + list(range(0x61, 0x7B)) + [0x5F])
_SPACE = frozenset(b" \t\n\r\f\v")
_ANY = frozenset(range(256)) - {0x0A}
_ALL = frozenset(range(256))


class _Parser:
    def __init__(self, pattern: str):
        self.s = pattern.encode("utf-8")
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.s):
            raise ValueError(f"regex parse error at byte {self.i}: "
                             f"{self.s[self.i:self.i+8]!r}")
        return node

    def _peek(self):
        return self.s[self.i] if self.i < len(self.s) else None

    def _alt(self):
        parts = [self._cat()]
        while self._peek() == 0x7C:  # |
            self.i += 1
            parts.append(self._cat())
        return parts[0] if len(parts) == 1 else _Alt(parts)

    def _cat(self):
        parts = []
        while True:
            c = self._peek()
            if c is None or c in (0x7C, 0x29):  # | )
                break
            parts.append(self._repeat())
        return _Cat(parts)

    def _repeat(self):
        node = self._atom()
        c = self._peek()
        if c == 0x2A:  # *
            self.i += 1
            return _Rep(node, 0, None)
        if c == 0x2B:  # +
            self.i += 1
            return _Rep(node, 1, None)
        if c == 0x3F:  # ?
            self.i += 1
            return _Rep(node, 0, 1)
        if c == 0x7B:  # {
            m = _re.match(rb"\{(\d+)(,(\d*)?)?\}", self.s[self.i:])
            if m:
                self.i += m.end()
                lo = int(m.group(1))
                if m.group(2) is None:
                    return _Rep(node, lo, lo)
                hi = int(m.group(3)) if m.group(3) else None
                return _Rep(node, lo, hi)
        return node

    def _atom(self):
        c = self._peek()
        if c == 0x28:  # (
            self.i += 1
            if self.s[self.i : self.i + 2] == b"?:":
                self.i += 2
            node = self._alt()
            if self._peek() != 0x29:
                raise ValueError("unclosed group")
            self.i += 1
            return node
        if c == 0x5B:  # [
            return self._char_class()
        if c == 0x2E:  # .
            self.i += 1
            return _Lit(_ANY)
        if c == 0x5C:  # backslash
            self.i += 1
            return _Lit(self._escape())
        if c in (0x2A, 0x2B, 0x3F):
            raise ValueError("quantifier with nothing to repeat")
        self.i += 1
        return _Lit(frozenset({c}))

    def _escape(self) -> frozenset:
        c = self.s[self.i]
        self.i += 1
        table = {0x64: _DIGITS, 0x44: _ALL - _DIGITS,       # d D
                 0x77: _WORD, 0x57: _ALL - _WORD,           # w W
                 0x73: _SPACE, 0x53: _ALL - _SPACE,         # s S
                 0x6E: frozenset({0x0A}), 0x74: frozenset({0x09}),  # n t
                 0x72: frozenset({0x0D}), 0x66: frozenset({0x0C}),  # r f
                 0x76: frozenset({0x0B}), 0x30: frozenset({0x00})}  # v 0
        if c in table:
            return table[c]
        if c == 0x78:  # \xNN
            h = self.s[self.i : self.i + 2].decode()
            self.i += 2
            return frozenset({int(h, 16)})
        return frozenset({c})  # escaped literal (\\ \. \" \{ ...)

    def _char_class(self):
        self.i += 1  # [
        negate = self._peek() == 0x5E  # ^
        if negate:
            self.i += 1
        members: set[int] = set()
        prev = None
        while True:
            c = self._peek()
            if c is None:
                raise ValueError("unclosed character class")
            if c == 0x5D and prev is not None or (c == 0x5D and members):  # ]
                break
            if c == 0x5D and prev is None and not members:
                # leading ] is a literal
                members.add(c)
                prev = frozenset({c})
                self.i += 1
                continue
            if c == 0x5C:
                self.i += 1
                s = self._escape()
                members |= s
                prev = s
                continue
            if c == 0x2D and prev is not None and len(prev) == 1 \
                    and self.i + 1 < len(self.s) and self.s[self.i + 1] != 0x5D:
                # range a-b
                self.i += 1
                hi_c = self._peek()
                if hi_c == 0x5C:
                    self.i += 1
                    hs = self._escape()
                    hi_v = min(hs)
                else:
                    hi_v = hi_c
                    self.i += 1
                lo_v = next(iter(prev))
                members |= set(range(lo_v, hi_v + 1))
                prev = None
                continue
            members.add(c)
            prev = frozenset({c})
            self.i += 1
        self.i += 1  # ]
        return _Lit(_ALL - frozenset(members) if negate else frozenset(members))


# ---------------------------------------------------------------------------
# Thompson NFA + subset construction
# ---------------------------------------------------------------------------


@dataclass
class _NfaNode:
    eps: list = field(default_factory=list)          # epsilon targets
    edges: list = field(default_factory=list)        # (byteset, target)


class _Nfa:
    def __init__(self):
        self.nodes: list[_NfaNode] = []

    def new(self) -> int:
        self.nodes.append(_NfaNode())
        return len(self.nodes) - 1

    def build(self, ast, start: int, end: int) -> None:
        """Wire ``ast`` between existing nodes start -> end."""
        if isinstance(ast, _Lit):
            self.nodes[start].edges.append((ast.bytes_, end))
        elif isinstance(ast, _Cat):
            cur = start
            for i, p in enumerate(ast.parts):
                nxt = end if i == len(ast.parts) - 1 else self.new()
                self.build(p, cur, nxt)
                cur = nxt
            if not ast.parts:
                self.nodes[start].eps.append(end)
        elif isinstance(ast, _Alt):
            for p in ast.parts:
                s, e = self.new(), self.new()
                self.nodes[start].eps.append(s)
                self.build(p, s, e)
                self.nodes[e].eps.append(end)
        elif isinstance(ast, _Rep):
            cur = start
            for _ in range(ast.lo):  # required copies
                nxt = self.new()
                self.build(ast.node, cur, nxt)
                cur = nxt
            if ast.hi is None:  # unbounded tail: loop
                loop = self.new()
                self.nodes[cur].eps.append(loop)
                s, e = self.new(), self.new()
                self.nodes[loop].eps.append(s)
                self.build(ast.node, s, e)
                self.nodes[e].eps.append(loop)
                self.nodes[loop].eps.append(end)
            else:
                for _ in range(ast.hi - ast.lo):  # optional copies
                    nxt = self.new()
                    self.nodes[cur].eps.append(end)
                    self.build(ast.node, cur, nxt)
                    cur = nxt
                self.nodes[cur].eps.append(end)
        else:
            raise TypeError(ast)


@dataclass
class CharDFA:
    """Byte-level DFA: ``trans[s, b]`` = next state or -1; state 0 = start."""

    trans: np.ndarray  # [NS, 256] int32
    accept: np.ndarray  # [NS] bool

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    def walk_bytes(self, state: int, bs: bytes) -> int:
        for b in bs:
            if state < 0:
                return -1
            state = int(self.trans[state, b])
        return state


def compile_regex(pattern: str, max_states: int = MAX_STATES) -> CharDFA:
    ast = _Parser(pattern).parse()
    nfa = _Nfa()
    start, end = nfa.new(), nfa.new()
    nfa.build(ast, start, end)

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            for t in nfa.nodes[stack.pop()].eps:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset({start}))
    dfa_states = {start_set: 0}
    order = [start_set]
    trans_rows = []
    i = 0
    while i < len(order):
        cur = order[i]
        row = np.full(256, -1, np.int32)
        # group outgoing edges by byte
        targets_by_byte: dict[int, set] = {}
        for n in cur:
            for byteset, t in nfa.nodes[n].edges:
                for b in byteset:
                    targets_by_byte.setdefault(b, set()).add(t)
        for b, tgts in targets_by_byte.items():
            nxt = closure(frozenset(tgts))
            if nxt not in dfa_states:
                if len(dfa_states) >= max_states:
                    raise ValueError(
                        f"constraint DFA exceeds {max_states} states — "
                        "simplify the schema/regex")
                dfa_states[nxt] = len(dfa_states)
                order.append(nxt)
            row[b] = dfa_states[nxt]
        trans_rows.append(row)
        i += 1
    trans = np.stack(trans_rows)
    accept = np.asarray([end in s for s in order], bool)
    return CharDFA(trans=trans, accept=accept)


# ---------------------------------------------------------------------------
# JSON schema -> regex (outlines-style subset)
# ---------------------------------------------------------------------------

# Bounded optional whitespace: this regex constrains text we GENERATE, and
# an unbounded [ \t\n\r]* loop state lets a greedy sampler spin on spaces
# forever; {0,2} keeps outputs valid JSON while guaranteeing progress.
_WS = r"[ \t\n\r]{0,2}"
_STRING = r'"(?:[^"\\\x00]|\\["\\/bfnrtu])*"'
_INTEGER = r"-?(?:0|[1-9][0-9]*)"
_NUMBER = r"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?"


def _esc_literal(s: str) -> str:
    return "".join(
        "\\" + c if c in r"\^$.|?*+()[]{}" else c for c in s)


def json_schema_to_regex(schema: dict) -> str:
    """Supported subset: object (properties in declaration order; properties
    absent from ``required`` become optional trailing groups — at least the
    first property should be required), string (+enum/const/pattern),
    integer, number, boolean, null, array (items, minItems, maxItems),
    anyOf/oneOf. The emitted JSON allows flexible whitespace."""
    if "enum" in schema:
        return "(?:" + "|".join(
            _esc_literal(json.dumps(v)) for v in schema["enum"]) + ")"
    if "const" in schema:
        return _esc_literal(json.dumps(schema["const"]))
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return "(?:" + "|".join(
                json_schema_to_regex(s) for s in schema[key]) + ")"
    t = schema.get("type")
    if isinstance(t, list):
        return "(?:" + "|".join(
            json_schema_to_regex({**schema, "type": ti}) for ti in t) + ")"
    if t == "string":
        if "pattern" in schema:
            # JSON-schema patterns are conventionally anchored (^...$); the
            # byte parser treats ^/$ as literal bytes, so strip one leading ^
            # and one unescaped trailing $ — the whole-string match is
            # implicit in DFA acceptance anyway
            pat = schema["pattern"]
            if pat.startswith("^"):
                pat = pat[1:]
            if pat.endswith("$") and not pat.endswith("\\$"):
                pat = pat[:-1]
            return '"' + pat + '"'
        return _STRING
    if t == "integer":
        return _INTEGER
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(?:true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = json_schema_to_regex(schema.get("items", {"type": "string"}))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        sep = _WS + "," + _WS
        if hi is not None:
            hi = int(hi)
            if lo > 0:
                body = item + f"(?:{sep}{item}){{{lo - 1},{hi - 1}}}"
            else:
                body = f"(?:{item}(?:{sep}{item}){{0,{hi - 1}}})?"
        elif lo > 0:
            body = item + f"(?:{sep}{item}){{{lo - 1},}}"
        else:
            body = f"(?:{item}(?:{sep}{item})*)?"
        return r"\[" + _WS + body + _WS + r"\]"
    if t == "object" or "properties" in schema:
        props = schema.get("properties", {})
        required = set(schema.get("required", list(props)))
        # emit required properties FIRST (JSON objects are unordered, so
        # reordering keys is spec-legal) — that way every optional property
        # is a trailing "(?:,kv)?" group and no comma can dangle
        ordered = ([k for k in props if k in required]
                   + [k for k in props if k not in required])
        kvs = {k: (_esc_literal(json.dumps(k)) + _WS + ":" + _WS
                   + json_schema_to_regex(props[k])) for k in ordered}
        sep = _WS + "," + _WS
        req = [k for k in ordered if k in required]
        opt = [k for k in ordered if k not in required]
        if req:
            body = sep.join(kvs[k] for k in req)
            body += "".join(f"(?:{sep}{kvs[k]})?" for k in opt)
        elif opt:
            # all-optional: alternation over which property appears FIRST,
            # each followed by optional later ones — commas only ever sit
            # between two present properties
            branches = []
            for i, k in enumerate(opt):
                tail = "".join(f"(?:{sep}{kvs[j]})?" for j in opt[i + 1:])
                branches.append(kvs[k] + tail)
            body = "(?:" + "|".join(branches) + ")?"
        else:
            body = ""
        return r"\{" + _WS + body + _WS + r"\}"
    # permissive default: any scalar JSON value
    return f"(?:{_STRING}|{_NUMBER}|true|false|null)"


# ---------------------------------------------------------------------------
# token tables + host-side masks
# ---------------------------------------------------------------------------


def json_object_regex(max_depth: int = 2) -> str:
    """Generic JSON OBJECT with nesting bounded at ``max_depth`` (regular
    languages can't express unbounded nesting; depth 2 compiles to ~1.7k DFA
    states). The OpenAI ``response_format: json_object`` surface maps here —
    the model can emit any keys/values but cannot open a level deeper than
    the bound."""
    scalar = f"(?:{_STRING}|{_NUMBER}|true|false|null)"
    v = scalar
    for _ in range(max_depth):
        obj = (r"\{" + _WS + f"(?:{_STRING}{_WS}:{_WS}{v}"
               + f"(?:{_WS},{_WS}{_STRING}{_WS}:{_WS}{v})*)?" + _WS + r"\}")
        arr = r"\[" + _WS + f"(?:{v}(?:{_WS},{_WS}{v})*)?" + _WS + r"\]"
        v = f"(?:{scalar}|{obj}|{arr})"
    return (r"\{" + _WS + f"(?:{_STRING}{_WS}:{_WS}{v}"
            + f"(?:{_WS},{_WS}{_STRING}{_WS}:{_WS}{v})*)?" + _WS + r"\}")


def build_token_tables(token_bytes: list[bytes],
                       max_len: int = MAX_TOKEN_BYTES) -> tuple[np.ndarray, np.ndarray]:
    """(chars [V, Lm] uint8, lens [V] int32). Tokens longer than ``max_len``
    get len = max_len + 1 and are disallowed under any constraint."""
    v = len(token_bytes)
    chars = np.zeros((v, max_len), np.uint8)
    lens = np.zeros((v,), np.int32)
    for i, bs in enumerate(token_bytes):
        if bs is None or len(bs) == 0:
            lens[i] = max_len + 1  # special / undecodable: never allowed
            continue
        if len(bs) > max_len:
            lens[i] = max_len + 1
            continue
        chars[i, : len(bs)] = np.frombuffer(bs, np.uint8)
        lens[i] = len(bs)
    return chars, lens


def host_allowed_mask(dfa: CharDFA, state: int, chars: np.ndarray,
                      lens: np.ndarray, eos_id: int) -> np.ndarray:
    """Vectorized [V] bool: which tokens keep the DFA alive from ``state``.
    EOS allowed iff accepting (force-allowed at a dead end)."""
    v, lm = chars.shape
    st = np.full((v,), state, np.int32)
    for i in range(lm):
        live = (i < lens) & (st >= 0)
        nxt = dfa.trans[np.maximum(st, 0), chars[:, i]]
        st = np.where(live, nxt, st)
    allowed = (st >= 0) & (lens <= lm)
    eos_ok = bool(dfa.accept[state]) if state >= 0 else True
    allowed[eos_id] = eos_ok or not allowed.any()
    return allowed


@dataclass
class CompiledConstraint:
    """One compiled constraint, bank-ready."""

    key: str
    dfa: CharDFA

    @classmethod
    def from_params(cls, json_schema: dict | None, regex: str | None,
                    max_states: int = MAX_STATES) -> "CompiledConstraint":
        if json_schema is not None:
            pattern = json_schema_to_regex(json_schema)
            key = "schema:" + json.dumps(json_schema, sort_keys=True)
        elif regex is not None:
            pattern = regex
            key = "regex:" + regex
        else:
            raise ValueError("constraint needs json_schema or regex")
        return cls(key=key, dfa=compile_regex(pattern, max_states))


def token_bytes_from_tokenizer(tokenizer) -> list[bytes]:
    """Best-effort token-id -> raw bytes for the vocab. Handles the GPT-2
    byte-to-unicode convention (Ġ etc.) used by BPE tokenizers and plain
    byte-level tokenizers; falls back to per-token decode."""
    # byte-level tokenizer (ByteTokenizer): id == byte for the base range
    if getattr(tokenizer, "is_byte_level", False):
        v = tokenizer.vocab_size
        out = []
        for i in range(v):
            out.append(bytes([i]) if i < 256 else b"")
        return out
    try:
        # GPT-2 convention: convert_ids_to_tokens gives unicode-mapped bytes
        try:
            vocab_size = len(tokenizer)
        except TypeError:
            vocab_size = int(tokenizer.vocab_size)
        toks = tokenizer.convert_ids_to_tokens(list(range(vocab_size)))
        b2u = _gpt2_bytes_to_unicode()
        u2b = {u: b for b, u in b2u.items()}
        out = []
        for t in toks:
            if t is None:
                out.append(b"")
                continue
            if all(ch in u2b for ch in t):
                out.append(bytes(u2b[ch] for ch in t))
            else:  # sentencepiece-style or special token
                out.append(t.replace("▁", " ").encode("utf-8"))
        return out
    except Exception:
        return [
            tokenizer.decode([i]).encode("utf-8")
            for i in range(len(tokenizer))
        ]


def _gpt2_bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))
