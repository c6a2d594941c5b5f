"""The port's constrained decoding on the CPU against the JAX package's: the
copied DFA compiler, schema translation and token tables give the same
arrays and strings; the engine's device mask equals JAX's
``host_allowed_mask`` on every bank row; greedy constrained generations equal
the JAX engine's token for token (logprobs within 1e-4); a seeded one walks
only tokens the JAX mask allows. Then the port-only engine contracts (slot
reuse, a bad regex, a full bank, a hybrid) and the server's routes.

The JAX engine fixture is the one of ``tests/unit/sampler/test_constrained.py``:
``debug_spec(num_layers=2, vocab_size=128)`` at weights * 3, float32, token
bytes ``bytes([i])`` for 9 <= i < 127, decode blocks of 4.
"""

import asyncio
import json
import re
import socket

import aiohttp
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prime_rl_tpu.models import qwen3 as jqwen3
from prime_rl_tpu.models.base import debug_spec as j_debug_spec
from prime_rl_tpu.sampler import constrain as jc
from prime_rl_tpu.sampler.cache import CacheConfig as JCacheConfig
from prime_rl_tpu.sampler.engine import Engine as JEngine
from prime_rl_tpu.sampler.engine import SamplingParams as JSamplingParams
from prime_rl_tpu_torch.models import qwen3 as tqwen3
from prime_rl_tpu_torch.models.base import debug_spec
from prime_rl_tpu_torch.sampler import constrain as tc
from prime_rl_tpu_torch.sampler.cache import CacheConfig
from prime_rl_tpu_torch.sampler.engine import Engine, SamplingParams

torch.set_num_threads(1)

TOKEN_BYTES = [bytes([i]) if 9 <= i < 127 else b"" for i in range(128)]
CACHE = dict(num_pages=64, page_size=16, max_slots=4, max_seq_len=256)

REGEXES = [
    r"ab+c?", r"(?:foo|ba[rz]){2}", r"[a-c]{1,3}", r"[^0-9]+",
    r"abc", r"a*b+c?", r"(?:ab|cd)+", r"[a-f0-9]{2,4}", r"[^ab]c*",
    r"a.c", r"(?:x[yz]){1,3}w?", r"\d+\.\d{2}", r"\w+@\w+",
    r"-?(?:0|[1-9][0-9]*)", r"[ \t]{0,2}ok[ \t]{0,2}", r"[ab]{3}[0-9]",
]
SCHEMAS = [
    {"type": "integer"},
    {"type": "number"},
    {"type": "boolean"},
    {"type": "object",
     "properties": {"op": {"enum": ["add", "del"]}, "count": {"type": "integer"},
                    "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 2},
                    "note": {"type": "string"}},
     "required": ["op", "count", "tags"]},
    {"type": "string", "pattern": "^[a-z]{1,4}$"},
    {"type": "object", "properties": {"a": {"type": "integer"}, "b": {"type": "integer"}},
     "required": ["b"]},
    {"type": "object", "required": [],
     "properties": {"x": {"type": "integer"}, "y": {"type": "boolean"}}},
    {"type": "object",
     "properties": {"name": {"type": "string", "pattern": "[a-z]{1,6}"},
                    "n": {"type": "integer"}, "ok": {"type": "boolean"},
                    "mode": {"enum": ["fast", "slow", None]}},
     "required": ["name", "n", "ok", "mode"]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 5},
]
ENUM_OBJECT = {"type": "object",
               "properties": {"op": {"enum": ["add", "del"]}, "n": {"type": "integer"}},
               "required": ["op", "n"]}


def _same_dfa(a, b) -> None:
    assert a.num_states == b.num_states
    np.testing.assert_array_equal(a.trans, b.trans)
    np.testing.assert_array_equal(a.accept, b.accept)


@pytest.mark.parametrize("pattern", REGEXES)
def test_compile_regex_matches_jax(pattern):
    _same_dfa(tc.compile_regex(pattern), jc.compile_regex(pattern))


@pytest.mark.parametrize("schema", SCHEMAS, ids=lambda s: json.dumps(s, sort_keys=True)[:40])
def test_schema_regex_and_dfa_match_jax(schema):
    got, want = tc.json_schema_to_regex(schema), jc.json_schema_to_regex(schema)
    assert got == want
    _same_dfa(tc.compile_regex(got), jc.compile_regex(want))
    a = tc.CompiledConstraint.from_params(schema, None)
    b = jc.CompiledConstraint.from_params(schema, None)
    assert a.key == b.key


def test_json_object_regex_and_errors_match_jax():
    assert tc.json_object_regex() == jc.json_object_regex()
    _same_dfa(tc.compile_regex(tc.json_object_regex()), jc.compile_regex(jc.json_object_regex()))
    for bad in ("(unclosed", "[abc", "*a"):
        with pytest.raises(ValueError) as got:
            tc.compile_regex(bad)
        with pytest.raises(ValueError) as want:
            jc.compile_regex(bad)
        assert str(got.value) == str(want.value)


class _StubBPE:
    """A GPT-2-style tokenizer: ids map to byte-to-unicode strings, a
    sentencepiece piece, a special token and an id without a token."""

    def __init__(self):
        b2u = tc._gpt2_bytes_to_unicode()
        self.toks = ([b2u[b] for b in range(256)]
                     + ["".join(b2u[b] for b in w.encode()) for w in (" the", "ing", " {\"")]
                     + ["▁hello", "<|endoftext|>", None, "é" * 20])

    def __len__(self):
        return len(self.toks)

    def convert_ids_to_tokens(self, ids):
        return [self.toks[i] for i in ids]


def test_token_tables_match_jax():
    from prime_rl_tpu.renderers.tokenizer import ByteTokenizer as JByte
    from prime_rl_tpu_torch.renderers.tokenizer import ByteTokenizer as TByte

    stub = _StubBPE()
    got_bpe, want_bpe = tc.token_bytes_from_tokenizer(stub), jc.token_bytes_from_tokenizer(stub)
    assert got_bpe == want_bpe and got_bpe[257] == b"ing" and got_bpe[259] == b" hello"
    assert tc.token_bytes_from_tokenizer(TByte()) == jc.token_bytes_from_tokenizer(JByte())
    for tb in (got_bpe, TOKEN_BYTES, tc.token_bytes_from_tokenizer(TByte())):
        for a, b in zip(tc.build_token_tables(tb), jc.build_token_tables(tb)):
            np.testing.assert_array_equal(a, b)


def _engines(**kw):
    jspec, tspec = j_debug_spec(num_layers=2, vocab_size=128), debug_spec(num_layers=2,
                                                                          vocab_size=128)
    jparams = jax.tree.map(lambda x: x * 3.0, jqwen3.init_params(jspec, jax.random.key(0)))
    tparams = tqwen3.params_from_jax(jax.device_get(jparams), tspec)
    cache = {**CACHE, **kw.pop("cache", {})}
    jeng = JEngine(jparams, jspec, JCacheConfig(**cache), compute_dtype=jnp.float32,
                   token_bytes=TOKEN_BYTES, decode_block=4)
    teng = Engine(tparams, tspec, CacheConfig(**cache), device="cpu",
                  compute_dtype=torch.float32, token_bytes=TOKEN_BYTES, decode_block=4)
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _text(res, eos: int) -> str:
    return bytes(t for t in res.token_ids if t != eos).decode("utf-8", errors="replace")


def test_device_mask_matches_jax_host_mask(engines):
    _, eng = engines
    eng._ensure_token_tables()
    chars, lens = jc.build_token_tables(TOKEN_BYTES)
    eos = eng.spec.eos_token_id
    rng = np.random.default_rng(0)
    constraints = [({"type": "boolean"}, None), (ENUM_OBJECT, None), (None, r"[ab]{3}[0-9]"),
                   (None, tc.json_object_regex())]
    rows, dfas = [], []
    for schema, regex in constraints:
        cc = eng._cons_compile(SamplingParams(json_schema=schema, regex=regex))
        rows.append(eng._cons_assign(cc))
        eng._cons_bank_refs[rows[-1]] += 1  # keep the row while the next ones are assigned
        dfas.append(jc.CompiledConstraint.from_params(schema, regex).dfa)
    assert sorted(rows) == list(range(eng.CONS_BANK))
    ns = eng.CONS_STATES

    def glob(row, st):  # the engine's global state: the row's sink for dead
        return torch.from_numpy(row * ns + np.where(st >= 0, st, ns - 1))

    for row, dfa in zip(rows, dfas):
        states = np.concatenate([[-1, 0], np.flatnonzero(dfa.accept)[:3],
                                 rng.integers(0, dfa.num_states, 12)]).astype(np.int64)
        got = eng._cons_allowed(glob(row, states))
        for st, g in zip(states, got.numpy()):
            np.testing.assert_array_equal(g, jc.host_allowed_mask(dfa, int(st), chars, lens, eos))
        bias = eng._cons_prefill_bias(row).numpy()
        want = np.where(jc.host_allowed_mask(dfa, 0, chars, lens, eos), 0.0, -1e9)
        np.testing.assert_array_equal(bias, want.astype(np.float32))
        # the input-token advance against the DFA's own byte walk (an empty
        # token walks 16 zero bytes, as in the JAX engine)
        toks = rng.integers(0, 128, len(states))
        walked = eng._cons_walk(glob(row, states), eng._tok_tables["chars"][toks]).numpy()
        for st, t, w in zip(states, toks, walked):
            want_st = (dfa.walk_bytes(int(st), TOKEN_BYTES[t]) if lens[t] <= 16
                       else dfa.walk_bytes(int(st), bytes(16)))
            assert w == glob(row, np.asarray([want_st])).item()
    eng._cons_bank_refs = [0] * eng.CONS_BANK


@pytest.mark.parametrize("case", ["boolean", "enum-object", "regex"])
def test_greedy_constrained_generation_matches_jax_engine(engines, case):
    jeng, teng = engines
    kw = {"boolean": dict(json_schema={"type": "boolean"}),
          "enum-object": dict(json_schema=ENUM_OBJECT, max_tokens=64),
          "regex": dict(regex=r"[ab]{3}[0-9]")}[case]
    sp = dict(max_tokens=48, temperature=0.0)
    sp.update(kw)
    prompts = [[5, 9, 23 + i, 47, 3] for i in range(3)]
    want = jeng.generate(prompts, JSamplingParams(**sp))
    got = teng.generate(prompts, SamplingParams(**sp))
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want] == ["stop"] * 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=1e-4)
    eos = teng.spec.eos_token_id
    for r in got:
        text = _text(r, eos)
        if case == "boolean":
            assert text in ("true", "false")
        elif case == "enum-object":
            obj = json.loads(text)
            assert obj["op"] in ("add", "del") and isinstance(obj["n"], int)
        else:
            assert re.fullmatch(r"[ab]{3}[0-9]", text)
    assert teng._cons_active == 0 and teng._cons_bank_refs == [0] * teng.CONS_BANK


def test_mixed_batch_matches_jax_engine(engines):
    """A constrained request beside free ones in one decode batch: greedy
    tokens equal the JAX engine's, the free ones run to max_tokens."""
    jeng, teng = engines
    reqs = [([5, 9, 23], dict(max_tokens=24, temperature=0.0, json_schema={"type": "boolean"})),
            ([7, 11, 13], dict(max_tokens=20, temperature=0.0, ignore_eos=True)),
            ([8, 12, 14, 20], dict(max_tokens=24, temperature=0.0, regex=r"[ab]{3}[0-9]")),
            ([4, 6], dict(max_tokens=20, temperature=0.0, ignore_eos=True))]
    want = jeng.generate([p for p, _ in reqs], [JSamplingParams(**sp) for _, sp in reqs])
    got = teng.generate([p for p, _ in reqs], [SamplingParams(**sp) for _, sp in reqs])
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.logprobs, w.logprobs, atol=1e-4, rtol=1e-4)
    assert len(got[1].token_ids) == len(got[3].token_ids) == 20
    assert _text(got[0], teng.spec.eos_token_id) in ("true", "false")


def test_seeded_constrained_generation_walks_the_jax_mask(engines):
    """Sampled (temperature 1, seeded) constrained outputs: the two packages'
    random streams differ, so each port token is held to the JAX mask at the
    DFA state before it, and the output to the constraint."""
    _, teng = engines
    chars, lens = jc.build_token_tables(TOKEN_BYTES)
    eos = teng.spec.eos_token_id
    for schema, regex in (({"type": "boolean"}, None), (ENUM_OBJECT, None),
                          (None, r"[ab]{3}[0-9]")):
        dfa = jc.CompiledConstraint.from_params(schema, regex).dfa
        res = teng.generate([[5, 9, 23 + i, 47, 3] for i in range(3)], [
            SamplingParams(max_tokens=64, temperature=1.0, seed=10 + i, json_schema=schema,
                           regex=regex) for i in range(3)])
        for r in res:
            st = 0
            for t in r.token_ids:
                assert jc.host_allowed_mask(dfa, st, chars, lens, eos)[t], (r.token_ids, t)
                if t != eos:
                    st = dfa.walk_bytes(st, TOKEN_BYTES[t])
            assert r.finish_reason == "stop" and st >= 0 and dfa.accept[st]


def test_slot_reuse_clears_stale_constraint():
    """A constrained request that finishes must not leave its DFA masking
    the next (unconstrained) request in its slot while another constrained
    slot keeps the masked block running."""
    _, eng = _engines(cache=dict(max_slots=2))
    f_long = eng.submit([5, 9, 23], SamplingParams(
        max_tokens=40, temperature=1.0, seed=1,
        json_schema={"type": "array", "items": {"type": "integer"}, "minItems": 5}))
    f_short = eng.submit([7, 11], SamplingParams(max_tokens=24, temperature=1.0, seed=2,
                                                 json_schema={"type": "boolean"}))
    for _ in range(200):
        if f_short.done():
            break
        eng.step()
    assert f_short.done() and not f_long.done()
    free = [eng.submit([13 + i, 17], SamplingParams(max_tokens=12, temperature=0.0,
                                                    ignore_eos=True)) for i in range(3)]
    eng.run_until_idle()
    f_long.result(timeout=60)
    for f in free:
        assert len(f.result(timeout=60).token_ids) == 12
    assert eng._cons_active == 0


def test_bad_regex_rejects_without_killing_the_engine(engines):
    _, eng = engines
    f_bad = eng.submit([5, 9], SamplingParams(max_tokens=8, regex="(unclosed"))
    f_ok = eng.submit([7, 11], SamplingParams(max_tokens=4, temperature=0.0))
    eng.run_until_idle()
    with pytest.raises(ValueError):
        f_bad.result(timeout=30)
    assert len(f_ok.result(timeout=30).token_ids) >= 1
    assert eng.stats["requests_rejected"] >= 1


def test_full_bank_defers_admission(engines):
    """Five distinct live constraints on a bank of four: the fifth request
    waits in the queue until a row frees, then completes."""
    _, eng = engines
    regexes = [f"{c}{{12}}" for c in "abcde"]
    futs = [eng.submit([5 + i, 9], SamplingParams(max_tokens=16, temperature=0.0, regex=r))
            for i, r in enumerate(regexes)]
    eng.step()
    assert len(eng.pending) == 1 and eng._cons_bank_refs == [1] * eng.CONS_BANK
    eng.run_until_idle()
    for f, c in zip(futs, "abcde"):
        r = f.result(timeout=30)
        assert _text(r, eng.spec.eos_token_id) == c * 12 and r.finish_reason == "stop"
    assert eng._cons_active == 0


def test_hybrid_refuses_constrained_requests():
    from prime_rl_tpu_torch.models import qwen3_next
    from prime_rl_tpu_torch.models.base import get_spec

    spec = get_spec("debug_qwen3_next")
    params = qwen3_next.init_params(spec, torch.Generator().manual_seed(0))
    eng = Engine(params, spec, CacheConfig(num_pages=32, page_size=16, max_slots=2,
                                           max_seq_len=128), device="cpu",
                 token_bytes=TOKEN_BYTES)
    fut = eng.submit([1, 2, 3], SamplingParams(max_tokens=4, regex="a+"))
    with pytest.raises(ValueError, match="hybrid"):
        fut.result(timeout=5)
    assert not eng.pending


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_http_constrained_routes(tmp_path):
    from prime_rl_tpu_torch.configs import InferenceConfig
    from prime_rl_tpu_torch.entrypoints.inference import build_server

    config = InferenceConfig(
        device="cpu", output_dir=str(tmp_path), max_model_len=256,
        model={"name": "debug", "debug": {"random_init": True, "num_layers": 2}},
        tokenizer={"name": "byte"}, kv={"num_pages": 64, "page_size": 16},
        scheduler={"max_batch_size": 4, "decode_block": 2},
    )
    server = build_server(config)
    assert server.engine.token_bytes is not None
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    schema = {"type": "object", "properties": {"mode": {"enum": ["fast", "slow"]},
                                               "ok": {"type": "boolean"}},
              "required": ["mode", "ok"]}

    async def run():
        runner = await server.start_async("127.0.0.1", port)
        try:
            async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=120)) as http:
                async def chat(**extra):
                    r = await http.post(f"{base}/v1/chat/completions", json={
                        "model": "debug", "messages": [{"role": "user", "content": "hi"}],
                        "max_tokens": 96, "temperature": 0.0, **extra})
                    return r.status, await r.json() if r.status == 200 else await r.text()

                status, body = await chat(response_format={
                    "type": "json_schema", "json_schema": {"name": "x", "schema": schema}})
                assert status == 200, body
                choice = body["choices"][0]
                assert choice["finish_reason"] == "stop"
                obj = json.loads(choice["message"]["content"])
                assert obj["mode"] in ("fast", "slow") and isinstance(obj["ok"], bool)

                status, body = await chat(guided_regex=r"[ab]{3}[0-9]")
                assert status == 200, body
                assert re.fullmatch(r"[ab]{3}[0-9]", body["choices"][0]["message"]["content"])

                status, body = await chat(response_format={"type": "json_object"})
                assert status == 200, body
                if body["choices"][0]["finish_reason"] == "stop":
                    assert isinstance(json.loads(body["choices"][0]["message"]["content"]), dict)

                status, _ = await chat(response_format={"type": "json_schema", "json_schema": {}})
                assert status == 400
                status, _ = await chat(guided_regex="(unclosed")
                assert status == 400

                r = await http.post(f"{base}/inference/v1/generate", json={
                    "token_ids": [1, 2, 3],
                    "sampling_params": {"max_tokens": 16, "temperature": 0.0,
                                        "regex": "[0-9]{2}x"}})
                assert r.status == 200, await r.text()
                toks = (await r.json())["choices"][0]["token_ids"]
                eos = server.engine.spec.eos_token_id
                assert re.fullmatch(r"[0-9]{2}x", bytes(t for t in toks if t != eos).decode())

                r = await http.post(f"{base}/inference/v1/generate", json={
                    "token_ids": [1, 2, 3], "json_schema": {"type": "boolean"},
                    "sampling_params": {"max_tokens": 16, "temperature": 0.0}})
                assert r.status == 200, await r.text()
                toks = (await r.json())["choices"][0]["token_ids"]
                assert bytes(t for t in toks if t != eos).decode() in ("true", "false")

                r = await http.post(f"{base}/inference/v1/generate", json={
                    "token_ids": [1, 2, 3], "sampling_params": {"max_tokens": 4}})
                assert r.status == 200  # the server kept serving
        finally:
            await server.stop_async(runner)

    asyncio.run(run())
