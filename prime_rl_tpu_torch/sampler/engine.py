"""Continuous-batching sampling engine (the port of the JAX package's
``sampler/engine.py``: the dense, MoE and MLA paths and the GatedDeltaNet
hybrid's).

Architecture:
- ONE decode pass over all slots per step. Decode state (last tokens,
  lengths, active mask, per-slot sampling params) lives ON THE DEVICE as
  tensors updated in place on the stream (the JAX engine threads immutable
  arrays through jitted programs instead). A dispatched block runs
  ``decode_block`` decode+sample steps back to back with in-block EOS /
  stop-id / length masking, and copies its packed ``[K, S, 2]`` result
  (tokens and logprobs) to pinned host memory once, behind the block on the
  stream. The host never waits per token: it drains blocks with a small
  lookahead, so the next block is already queued while one is read.
- Bucketed prefill (batched for same-bucket bursts) writes K/V pages and
  seeds the slot's device state in the same stream; prompts with a cached
  prefix, or longer than the largest bucket, prefill in page-aligned chunks
  against the paged history.
- Slot release is deferred until every in-flight block that referenced the
  slot has drained, so page reuse can never race a pending write.
- Weight update = swapping the parameter dicts between dispatches (the
  pause/resume protocol); the prefix cache is flushed.
- Router replay (``collect_routed_experts``, MoE families): each decode
  step's expert ids ride the block's packed result to the host, and a
  finished request carries them as ``routed_experts``.
- Hybrid models (``gdn_pattern``, Nemotron-H's ``layer_pattern``): the
  recurrent layers keep a slot's conv window and fast-weight or SSM state in
  a ``RecurrentPool`` (seeded at admit,
  advanced in place by every decode step); their attention layers page as
  usual. Prompts prefill one at a time; with a state tier
  (``state_cache_mb`` > 0, the default) a prompt with a full page before its
  last token prefills in chunks that thread the recurrent rows, and the rows
  at its last full-page boundary are checkpointed to host memory under that
  page chain's hash (LRU, bounded by ``state_cache_mb``). A later prompt
  whose chain reaches a checkpoint restores it and skips the shared pages,
  so hybrids keep prefix reuse; a weight update flushes the tier with the
  prefix cache. P/D transfer of the rows waits for the P/D slice.

Constrained decoding, LoRA adapters, multimodal inputs, P/D KV
extraction/injection and the host KV tier are later slices: requests that
ask for them raise ``NotImplementedError``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from prime_rl_tpu_torch.models.base import ModelSpec
from prime_rl_tpu_torch.sampler import model as smodel
from prime_rl_tpu_torch.sampler.cache import (
    CacheConfig,
    KVPool,
    RecurrentPool,
    SlotTable,
    hash_pages,
)
from prime_rl_tpu_torch.sampler.sampling import MAX_TOP_K, sample_tokens
from prime_rl_tpu_torch.utils.device import resolve_device
from prime_rl_tpu_torch.utils.logger import get_logger


@dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    stop_token_ids: list[int] = field(default_factory=list)
    logprobs: bool = True
    prompt_logprobs: bool = False
    seed: int | None = None
    ignore_eos: bool = False  # benchmarking: always generate max_tokens
    # extra prefix-cache isolation domain (the engine already flushes the
    # cache on every weight update)
    cache_salt: str | None = None
    # the fields below belong to later slices; requests setting them raise
    adapter: str | None = None
    extract_kv: bool = False
    json_schema: dict | None = None
    regex: str | None = None

    @property
    def constrained(self) -> bool:
        return self.json_schema is not None or self.regex is not None


@dataclass
class GenerationResult:
    token_ids: list[int]  # completion tokens
    logprobs: list[float]
    finish_reason: str  # "stop" | "length" | "aborted"
    prompt_len: int
    prompt_logprobs: list[float] | None = None
    policy_version: int = -1
    # router replay (collect_routed_experts): [n_gen, NL_moe, K] int32 expert
    # ids per generated token, the routing of that token as the input of the
    # next decode step; the final token's row is -1 (its forward never ran).
    # None when collection is off or nothing was recorded.
    routed_experts: "np.ndarray | None" = None
    kv: dict | None = None  # P/D extraction payload (not ported: None)


class _Fetch:
    """Device tensors copied to host memory behind the work that produced
    them: a non-blocking copy into pinned memory plus an event on CUDA, the
    tensors themselves on the CPU. ``get`` waits for the copy only."""

    def __init__(self, tensors: list[torch.Tensor]):
        self.event = None
        if tensors[0].is_cuda:
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in tensors]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def get(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


@dataclass
class _Request:
    prompt: list[int]
    params: SamplingParams
    future: Future
    # streaming: called from the engine thread per sampled token
    on_token: "callable | None" = None
    request_id: str | None = None
    aborted: bool = False


@dataclass
class _Active:
    req: _Request
    slot: int
    generated: list[int] = field(default_factory=list)
    logprobs: list[float] = field(default_factory=list)
    # router-replay recording: routed[i] = expert ids [NL_moe, K] of
    # generated[i] (the last token's routing is never computed: padded -1)
    routed: list = field(default_factory=list)
    prompt_logprobs_handle: _Fetch | None = None
    first_token_handle: tuple | None = None  # (_Fetch of (tok, lp), row)
    done: bool = False


@dataclass
class _StepOutput:
    """One dispatched decode block (k on-device steps) awaiting drain."""

    seq: int
    packed: _Fetch  # [K, S, 2] f32: tokens (exact) + logprobs; then, when
    # recording, [K, S, NL_moe, topk] int32: the routing of each step's INPUT tokens
    slots: list[int]  # slots active at dispatch time
    k: int = 1


def _bucket(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


class Engine:
    """Single-device sampling engine over one parameter dict."""

    LOOKAHEAD = 8  # in-flight decode tokens per batched drain
    MAX_STOP = 8  # in-block stop ids per slot (eos + extras; the host enforces
    # the full list at drain)
    ADMIT_WINDOW = 64  # skip-over scan depth over the pending queue (also
    # the batched-prefill grouping window)
    HOL_MAX_STRIKES = 256  # anti-starvation: stop skipping a stuck head
    PREFILL_BATCH_SIZES = (8, 4, 2)  # largest-first

    def __init__(
        self,
        params: dict,
        spec: ModelSpec,
        cache_config: CacheConfig | None = None,
        *,
        device: str = "cuda",
        compute_dtype=torch.bfloat16,
        seed: int = 0,
        lookahead: int | None = None,  # in-flight decode TOKENS per drain
        decode_block: int = 8,  # decode steps per dispatched block
        collect_routed_experts: bool = False,  # record decode-time MoE routing
        gdn_precision: str = "highest",  # ModelConfig.gdn_mxu_precision (hybrids)
    ):
        smodel.check_supported(spec)
        self.spec = spec
        self.gdn_precision = gdn_precision
        self._collect_routed = bool(collect_routed_experts and spec.is_moe)
        self.device = resolve_device(device)
        if lookahead:
            self.LOOKAHEAD = int(lookahead)
        self.decode_block = max(1, int(decode_block))
        self.compute_dtype = compute_dtype
        self.params = self._prepare_params(params)
        self.config = cache_config or CacheConfig()
        if self.config.host_cache_mb > 0:
            raise NotImplementedError("the host-offload KV tier is not ported yet "
                                      "(host_cache_mb must be 0)")
        pool = KVPool(spec, self.config, dtype=compute_dtype, device=self.device)
        self.k_pool, self.v_pool = pool.k, pool.v
        self.is_hybrid = bool(spec.gdn_pattern or spec.layer_pattern)
        rpool = RecurrentPool(spec, self.config, dtype=compute_dtype, device=self.device)
        self.r_conv, self.r_state = rpool.conv, rpool.state
        prefix_ok = self.config.enable_prefix_cache and (
            not self.is_hybrid or self.config.state_cache_mb > 0)
        self.slots = SlotTable(self.config, enable_prefix_cache=prefix_ok)
        # hybrid prefix reuse: page-chain hash -> the recurrent rows at the
        # end of that chain (host tensors a layer), LRU, state_cache_mb
        self._state_tier: OrderedDict | None = (
            OrderedDict() if self.is_hybrid and prefix_ok else None)
        self._state_tier_bytes = 0
        self.pending: deque[_Request] = deque()
        self.active: dict[int, _Active] = {}
        self.paused = False
        self.policy_version = -1
        self._lock = threading.Lock()
        # serializes step() against cross-thread mutators (update_params)
        self._step_lock = threading.Lock()
        self._by_id: dict[str, _Request] = {}
        self._hol_strikes = 0
        self.last_swap_s = (0.0, 0.0)
        self.stats = {
            "prefill_tokens_computed": 0,
            "prefill_tokens_cached": 0,
            "requests_admitted": 0,
            "requests_aborted": 0,
            "requests_rejected": 0,
        }
        ps = self.config.page_size
        self.buckets = [b for b in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
                        if b <= self.config.max_seq_len and b % ps == 0]
        if not self.buckets or self.buckets[-1] < self.config.max_seq_len:
            self.buckets.append(self.config.max_seq_len)

        # device-resident decode state, updated in place on the stream
        s, dev = self.config.max_slots, self.device
        self._d_tokens = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._d_lengths = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._d_active = torch.zeros((s,), dtype=torch.bool, device=dev)
        self._d_temp = torch.ones((s,), dtype=torch.float32, device=dev)
        self._d_topk = torch.full((s,), -1, dtype=torch.int32, device=dev)
        self._d_topp = torch.ones((s,), dtype=torch.float32, device=dev)
        self._d_limit = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._d_stop = torch.full((s, self.MAX_STOP), -1, dtype=torch.int64, device=dev)
        self._d_table = self._to_dev(self.slots.page_table)
        self._table_dirty = False
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(seed)
        # host mirrors of the sampling filters: whether a block may need the
        # exact top-p path is decided here, without reading the device
        self._h_topk = np.full((s,), -1, np.int64)
        self._h_topp = np.ones((s,), np.float64)

        self._inflight: deque[_StepOutput] = deque()
        self._dispatch_seq = 0
        self._deferred_release: list[tuple[int, int]] = []  # (slot, seq at finish)
        self._shadow_lengths = np.zeros((s,), np.int64)  # host mirror (exact)
        self._host_limit = np.zeros((s,), np.int64)  # device limit mirror

    # -- device helpers -----------------------------------------------------

    def _to_dev(self, arr) -> torch.Tensor:
        """Host array -> device tensor without stalling the stream: staged
        through pinned memory and copied behind the queued work on CUDA."""
        t = torch.from_numpy(np.array(arr, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _prepare_params(self, params: dict) -> dict:
        """Cast to the compute dtype on the engine's device, then unstack
        into the serving layout. Tensors already on the device in the
        compute dtype are shared with the caller, who must not modify them
        in place."""

        def prep(x):
            if isinstance(x, dict):
                return {k: prep(v) for k, v in x.items()}
            return x.to(device=self.device, dtype=self.compute_dtype)

        return smodel.unstack_params(prep(params), self.spec)

    def _filtering(self, slots) -> bool:
        return bool(np.any((self._h_topp[slots] < 1.0) | (self._h_topk[slots] > MAX_TOP_K)))

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: list[int], params: SamplingParams | None = None,
               on_token=None, request_id: str | None = None) -> Future:
        sp = params or SamplingParams()
        unsupported = [name for name, on in (
            ("constrained decoding", sp.constrained), ("LoRA adapters", bool(sp.adapter)),
            ("P/D KV extraction", sp.extract_kv)) if on]
        if unsupported:
            raise NotImplementedError(f"not ported yet: {', '.join(unsupported)}")
        req = _Request(list(prompt), sp, Future(), on_token, request_id=request_id)
        with self._lock:
            self.pending.append(req)
            if request_id is not None:
                self._by_id[request_id] = req
        return req.future

    def abort(self, request_id: str) -> bool:
        """Cancel a request. Thread-safe: only flags — the engine loop
        finalizes with reason "aborted" on its next step."""
        with self._lock:
            req = self._by_id.pop(request_id, None)
        if req is None:
            return False
        req.aborted = True
        self.stats["requests_aborted"] += 1
        return True

    def has_work(self) -> bool:
        return bool(self.pending or self.active or self._inflight)

    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    def update_params(self, new_params: dict, version: int | None = None) -> None:
        """Swap weights between dispatches (the caller pauses for a
        version-atomic boundary). Cross-thread safe through the step lock.
        ``last_swap_s`` keeps (seconds waiting for the step in flight to
        release the lock, seconds of the drain and swap)."""
        t0 = time.perf_counter()
        with self._step_lock:
            t1 = time.perf_counter()
            self._drain(force=True)  # complete blocks sampled under the old policy
            self.params = self._prepare_params(new_params)
            # cached prefix KV and recurrent states came from the old weights
            self._flush_prefix()
            if version is not None:
                self.policy_version = version
            self.last_swap_s = (t1 - t0, time.perf_counter() - t1)

    # -- scheduler ----------------------------------------------------------

    def step(self) -> bool:
        """One engine iteration: admit prefills (skip-over, not FIFO-blocked),
        dispatch a decode block, drain completed blocks. Returns True if any
        work was done."""
        if self.paused:
            return False
        with self._step_lock:
            return self._step_locked()

    def _step_locked(self) -> bool:
        did = False
        for a in list(self.active.values()):
            if not a.done and a.req.aborted:
                self._finish(a, "aborted")
                did = True
        t0 = time.perf_counter()
        did |= self._admit_pending()
        t1 = time.perf_counter()
        live = any(not a.done for a in self.active.values())
        if live and not self._pipe_full():
            self._dispatch_decode()
            did = True
        t2 = time.perf_counter()
        self._drain(force=not did)
        t3 = time.perf_counter()
        self.stats["host_admit_s"] = self.stats.get("host_admit_s", 0.0) + (t1 - t0)
        self.stats["host_dispatch_s"] = self.stats.get("host_dispatch_s", 0.0) + (t2 - t1)
        self.stats["host_drain_s"] = self.stats.get("host_drain_s", 0.0) + (t3 - t2)
        self.stats["host_step_max_s"] = max(self.stats.get("host_step_max_s", 0.0), t3 - t0)
        return did or bool(self._inflight)

    def _remove_pending(self, req: _Request) -> None:
        with self._lock:
            try:
                self.pending.remove(req)
            except ValueError:
                pass

    def _reject(self, req: _Request, exc: Exception) -> None:
        self._remove_pending(req)
        with self._lock:
            if req.request_id is not None:
                self._by_id.pop(req.request_id, None)
        self.stats["requests_rejected"] += 1
        if not req.future.done():
            req.future.set_exception(exc)

    def _flush_prefix(self) -> None:
        """Drop the prefix cache's idle pages and the hybrid state tier."""
        self.slots.flush_cache()
        if self._state_tier is not None:
            self._state_tier.clear()
            self._state_tier_bytes = 0

    def _batchable(self, req: _Request) -> bool:
        """Eligible for the batched prefill pass."""
        sp = req.params
        n = max(len(req.prompt), 1)
        return (not req.aborted and not sp.prompt_logprobs and sp.max_tokens >= 1
                # an explicit seed takes the single path: the batched pass
                # folds all rows' seeds into one generator
                and sp.seed is None
                and n <= self.buckets[-1] and n + 1 <= self.config.max_seq_len)

    def _admit_batch_plain(self) -> bool:
        """Batch same-bucket pending prefills into one pass. Cache-hit
        requests fall through to the single path where the prefix is reused.
        The MLA families and hybrids prefill one prompt at a time, as in the
        JAX engine."""
        if self.spec.kv_lora_rank > 0 or self.is_hybrid:
            return False
        with self._lock:
            window = list(self.pending)[: self.ADMIT_WINDOW]
        groups: dict[int, list] = {}
        for req in window:
            if self._batchable(req):
                groups.setdefault(_bucket(max(len(req.prompt), 1), self.buckets), []).append(req)
        any_admitted = False
        ps = self.config.page_size
        for lpad, reqs in groups.items():
            while len(reqs) >= 2:
                bsz = next((b for b in self.PREFILL_BATCH_SIZES if b <= len(reqs)), 2)
                chunk, reqs = reqs[:bsz], reqs[bsz:]
                acquired = []
                for req in chunk:
                    n = max(len(req.prompt), 1)
                    hashes = []
                    if self.slots.cache is not None:
                        n_shareable = ((n - 1) // ps) * ps
                        hashes = hash_pages(req.prompt[:n_shareable], ps,
                                            salt=(req.params.cache_salt, None))
                        if hashes and self.slots.cache.match_len(hashes) > 0:
                            continue  # the single path reuses the cached prefix
                    got = self.slots.acquire(self._acquire_want(req, n), hashes)
                    if got is None:
                        break  # out of slots/pages: stop growing this batch
                    acquired.append((req, got[0], n))
                if len(acquired) < 2:
                    for _req, slot, _n in acquired:
                        self.slots.cancel_donation(slot)  # pages never written
                        self.slots.release(slot)
                    return any_admitted
                self._dispatch_prefill_batch(acquired, lpad)
                any_admitted = True
        return any_admitted

    def _dispatch_prefill_batch(self, acquired: list, lpad: int) -> None:
        ps = self.config.page_size
        real = len(acquired)
        bsz = next((b for b in reversed(self.PREFILL_BATCH_SIZES) if b >= real),
                   self.PREFILL_BATCH_SIZES[0])
        ids = np.zeros((bsz, lpad), np.int64)
        lengths = np.zeros((bsz,), np.int32)
        pages = np.zeros((bsz, lpad // ps), np.int32)  # dummy rows: null page
        temp = np.ones((bsz,), np.float32)
        topk = np.full((bsz,), -1, np.int32)
        topp = np.ones((bsz,), np.float32)
        seed_mix = self._dispatch_seq + 1
        for b, (req, slot, n) in enumerate(acquired):
            sp = req.params
            ids[b, :n] = req.prompt
            lengths[b] = n
            pages[b] = self.slots.page_table[slot][: lpad // ps]
            temp[b] = sp.temperature
            topk[b] = sp.top_k
            topp[b] = sp.top_p
            seed_mix = (seed_mix * 1000003 + slot + 1) % (1 << 31)
        _, _, last_hidden = smodel.prefill_batch(
            self.params, self.spec, self.k_pool, self.v_pool, self._to_dev(ids),
            self._to_dev(lengths), self._to_dev(pages), compute_dtype=self.compute_dtype)
        logits = smodel.logits_from_hidden(self.params, self.spec, last_hidden, self.compute_dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed_mix)
        d_temp, d_topk, d_topp = self._to_dev(temp), self._to_dev(topk), self._to_dev(topp)
        filtering = bool(np.any((topp < 1.0) | (topk > MAX_TOP_K)))
        tok, lp = sample_tokens(logits, d_temp, d_topk, d_topp, gen, filtering=filtering)
        self._table_dirty = True
        first = _Fetch([tok, lp])  # lands the first tokens behind the pass
        slots = np.zeros((real,), np.int64)
        limits = np.zeros((real,), np.int32)
        stop_rows = np.full((real, self.MAX_STOP), -1, np.int64)
        for b, (req, slot, n) in enumerate(acquired):
            sp = req.params
            self.slots.lengths[slot] = n
            self._shadow_lengths[slot] = n
            self.stats["requests_admitted"] += 1
            self.stats["prefill_tokens_computed"] += n
            active = _Active(req, slot)
            active.first_token_handle = (first, b)
            self.active[slot] = active
            limit = self._limit_for(n, sp)
            self._host_limit[slot] = limit
            self._h_topk[slot], self._h_topp[slot] = sp.top_k, sp.top_p
            slots[b], limits[b], stop_rows[b] = slot, limit, self._stop_row(sp)
            self._remove_pending(req)
        # seed every admitted slot's device state in one indexed write each
        idx = self._to_dev(slots)
        self._d_tokens[idx] = tok[:real]
        self._d_lengths[idx] = self._to_dev(lengths[:real])
        self._d_active[idx] = True
        self._d_temp[idx] = d_temp[:real]
        self._d_topk[idx] = d_topk[:real]
        self._d_topp[idx] = d_topp[:real]
        self._d_limit[idx] = self._to_dev(limits)
        self._d_stop[idx] = self._to_dev(stop_rows)

    def _admit_pending(self) -> bool:
        """Admit every pending request that fits right now. The head never
        hard-blocks the queue: smaller requests behind it are admitted
        (skip-over) until the head has been passed over HOL_MAX_STRIKES
        times, after which admission waits for it (no starvation)."""
        any_admitted = self._admit_batch_plain()
        progress = True
        while progress and self.pending:
            progress = False
            with self._lock:
                window = list(self.pending)[: self.ADMIT_WINDOW]
            for i, req in enumerate(window):
                if req.aborted:
                    self._remove_pending(req)
                    if not req.future.done():
                        req.future.set_result(GenerationResult(
                            [], [], "aborted", len(req.prompt),
                            policy_version=self.policy_version))
                    progress = True
                    break
                n = max(len(req.prompt), 1)
                # requests that can NEVER fit fail fast instead of wedging
                total_pool_tokens = (self.config.num_pages - 1) * self.config.page_size
                if n + 1 > self.config.max_seq_len or n + 1 > total_pool_tokens:
                    self._reject(req, MemoryError(
                        f"prompt of {n} tokens cannot fit "
                        f"(max_seq_len={self.config.max_seq_len}, pool={total_pool_tokens})"))
                    progress = True
                    break
                if req.params.prompt_logprobs and n > self.buckets[-1]:
                    self._reject(req, ValueError(
                        f"prompt_logprobs needs a single-shot prefill; prompt of {n} "
                        f"tokens exceeds the largest bucket {self.buckets[-1]}"))
                    progress = True
                    break
                if i > 0 and self._hol_strikes > self.HOL_MAX_STRIKES:
                    break  # head has waited long enough: stop skipping it
                if self._try_admit(req):
                    self._remove_pending(req)
                    if i == 0:
                        self._hol_strikes = 0
                    any_admitted = True
                    progress = True
                    break
                if i == 0:
                    self._hol_strikes += 1
        return any_admitted

    def _try_admit(self, req: _Request) -> bool:
        """Reserve a slot + pages (reusing any cached prefix) and prefill."""
        sp = req.params
        n = max(len(req.prompt), 1)
        ps = self.config.page_size
        if self.is_hybrid and n > self.buckets[-1] and (
                self._state_tier is None or sp.prompt_logprobs):
            self._reject(req, ValueError(
                f"hybrid model: prompt length {n} exceeds the largest prefill bucket "
                f"{self.buckets[-1]} and this request cannot use chunked prefill (needs "
                "state_cache_mb > 0 and no prompt_logprobs)"))
            return True
        hashes: list[int] = []
        if self.slots.cache is not None and not sp.prompt_logprobs:
            # shareable: full pages strictly before the last prompt token (at
            # least one token is always computed -> last_hidden exists)
            n_shareable = ((n - 1) // ps) * ps
            hashes = hash_pages(req.prompt[:n_shareable], ps, salt=(sp.cache_salt, None))
        # hybrid: page reuse is exact only up to a recurrent-state checkpoint:
        # cap the chain at the deepest boundary that has both the pages and a
        # snapshot
        max_shared, snap = None, None
        if self.is_hybrid:
            max_shared = 0
            if hashes and self._state_tier is not None:
                m = self.slots.cache.match_len(hashes)
                for j in range(m - 1, -1, -1):
                    got_snap = self._state_tier.get(hashes[j])
                    if got_snap is not None:
                        self._state_tier.move_to_end(hashes[j])
                        max_shared, snap = j + 1, got_snap
                        break
        # pre-allocate pages for the whole request so the page table never
        # changes during decode
        got = self.slots.acquire(self._acquire_want(req, n), hashes, max_shared=max_shared)
        if got is None:
            return False
        slot, n_shared = got
        if self.is_hybrid and n_shared != (max_shared or 0):
            # the matched chain cannot shrink (lookup increfs before any
            # eviction), but a mismatch would recompute into shared pages:
            # admit unshared instead
            self.slots.cancel_donation(slot)
            self.slots.release(slot)
            got = self.slots.acquire(self._acquire_want(req, n))
            if got is None:
                return False
            slot, n_shared = got
            snap = None
        self.stats["requests_admitted"] += 1
        self.stats["prefill_tokens_cached"] += n_shared * ps
        try:
            self._admit(req, slot, n, n_shared, hashes, snap)
        except Exception as e:  # noqa: BLE001 — reject this request, keep serving
            # the slot's pages may never have been written: never donate them
            self.slots.lengths[slot] = 0
            self.slots.cancel_donation(slot)
            self.slots.release(slot)
            self.active.pop(slot, None)
            self._reject(req, e)
        return True

    def _acquire_want(self, req: _Request, n: int) -> int:
        """Token span to reserve pages for: whole request + single-shot pad."""
        lpad = _bucket(n, self.buckets) if n <= self.buckets[-1] else 0
        return min(max(lpad, n + req.params.max_tokens + 1), self.config.max_seq_len)

    def _stop_row(self, sp: SamplingParams) -> np.ndarray:
        row = np.full((self.MAX_STOP,), -1, np.int64)
        ids = [] if sp.ignore_eos else [self.spec.eos_token_id]
        ids += [t for t in sp.stop_token_ids if t not in ids]
        for i, t in enumerate(ids[: self.MAX_STOP]):
            row[i] = t
        return row

    def _limit_for(self, prompt_len: int, sp: SamplingParams) -> int:
        # device length cap: once lengths reach prompt_len + max_tokens - 1 the
        # slot has max_tokens generated tokens (the first came from prefill);
        # max_seq_len guards the pool
        return min(prompt_len + max(sp.max_tokens, 1) - 1, self.config.max_seq_len - 1)

    def warmup(self, n_requests: int = 8, prompt_len: int = 32) -> None:
        """Run dummy requests through the batched and single prefill and a
        full decode block before live traffic (builds the kernels)."""
        t0 = time.perf_counter()

        def mk(n):
            return [[(i + 7) % 97 + 1 for i in range(prompt_len)] for _ in range(n)]

        sp = SamplingParams(max_tokens=self.decode_block + 1, temperature=1.0, ignore_eos=True)
        self.generate(mk(max(1, n_requests)), sp)
        self._flush_prefix()  # dummy pages and states must never prefix-hit
        get_logger().info(f"engine warmup: {time.perf_counter() - t0:.1f}s")

    def run_until_idle(self) -> None:
        while self.has_work():
            if not self.step():
                with self._step_lock:
                    self._drain(force=True)

    def generate(self, prompts: list[list[int]],
                 params: SamplingParams | list[SamplingParams] | None = None
                 ) -> list[GenerationResult]:
        """Synchronous batch helper (tests / offline eval)."""
        if not isinstance(params, list):
            params = [params] * len(prompts)
        futures = [self.submit(p, sp) for p, sp in zip(prompts, params)]
        self.run_until_idle()
        return [f.result() for f in futures]

    # -- internals ----------------------------------------------------------

    def _admit(self, req: _Request, slot: int, n: int, n_shared: int = 0,
                hashes: list[int] | None = None, snap=None) -> None:
        sp = req.params
        ps = self.config.page_size
        shared_tokens = n_shared * ps
        self.slots.lengths[slot] = n
        self._shadow_lengths[slot] = n
        # the table upload waits for the next decode dispatch: prefill takes
        # its own `pages` argument
        self._table_dirty = True
        self.stats["prefill_tokens_computed"] += n - shared_tokens
        seed = sp.seed if sp.seed is not None else (self._dispatch_seq + slot + 1)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        d_temp = self._to_dev(np.asarray([sp.temperature], np.float32))
        d_topk = self._to_dev(np.asarray([sp.top_k], np.int32))
        d_topp = self._to_dev(np.asarray([sp.top_p], np.float32))
        filtering = sp.top_p < 1.0 or sp.top_k > MAX_TOP_K
        plp = None
        if self.is_hybrid and (shared_tokens > 0 or n > self.buckets[-1]
                               or (self._state_tier is not None and hashes)):
            last_hidden = self._prefill_hybrid_chunked(req, slot, n, n_shared, hashes or [], snap)
        elif shared_tokens == 0 and n <= self.buckets[-1]:
            # single-shot prefill (flash attention over the bucket)
            lpad = _bucket(n, self.buckets)
            ids = np.zeros((1, lpad), np.int64)
            ids[0, :n] = req.prompt
            pages = self.slots.page_table[slot][: lpad // ps]
            out = smodel.prefill(
                self.params, self.spec, self.k_pool, self.v_pool, self._to_dev(ids), n,
                self._to_dev(pages), compute_dtype=self.compute_dtype,
                want_prompt_logprobs=sp.prompt_logprobs, gdn_precision=self.gdn_precision)
            _, _, last_hidden, plp = out[:4]
            if self.is_hybrid:
                self._set_slot_rows(slot, out[4])  # seed the slot's recurrent rows
        else:
            # incremental prefill: skip the cached prefix, process the rest in
            # page-aligned chunks attending to the full paged history
            c = min(self.config.prefill_chunk, self.config.max_seq_len)
            c = max(ps, (c // ps) * ps)
            row = self.slots.page_table[slot]
            row_dev = self._to_dev(row)
            n_chunk_pages = c // ps
            last_hidden = None
            for off in range(shared_tokens, n, c):
                valid = min(c, n - off)
                ids = np.zeros((1, c), np.int64)
                ids[0, :valid] = req.prompt[off: off + valid]
                pchunk = np.zeros((n_chunk_pages,), np.int32)
                seg = row[off // ps: off // ps + n_chunk_pages]
                pchunk[: len(seg)] = seg
                _, _, last_hidden = smodel.prefill_chunk(
                    self.params, self.spec, self.k_pool, self.v_pool, self._to_dev(ids), off,
                    valid, self._to_dev(pchunk), row_dev, compute_dtype=self.compute_dtype)
        logits = smodel.logits_from_hidden(self.params, self.spec, last_hidden[None],
                                           self.compute_dtype)
        tok, lp = sample_tokens(logits, d_temp, d_topk, d_topp, gen, filtering=filtering)
        active = _Active(req, slot)
        active.first_token_handle = (_Fetch([tok, lp]), 0)
        if sp.prompt_logprobs and plp is not None:
            active.prompt_logprobs_handle = _Fetch([plp])
        self.active[slot] = active
        limit = self._limit_for(n, sp)
        self._host_limit[slot] = limit
        self._h_topk[slot], self._h_topp[slot] = sp.top_k, sp.top_p
        # seed the slot's device state (ordered behind the prefill on the stream)
        self._d_tokens[slot] = tok[0]
        self._d_lengths[slot] = n
        self._d_active[slot] = True
        self._d_temp[slot] = sp.temperature
        self._d_topk[slot] = sp.top_k
        self._d_topp[slot] = sp.top_p
        self._d_limit[slot] = limit
        self._d_stop[slot] = self._to_dev(self._stop_row(sp))
        if sp.max_tokens <= 0:
            self._finalize_scoring_only(active)

    def _set_slot_rows(self, slot: int, rows: list | None) -> None:
        """Write per-layer (conv_row, state_row) into the slot's recurrent
        rows (None entries: attention layers, or zeros for all when ``rows``
        is None)."""
        for li, (rc, rs) in enumerate(zip(self.r_conv, self.r_state)):
            if rc is None:
                continue
            row = None if rows is None else rows[li]
            if row is None:
                rc[slot].zero_()
                rs[slot].zero_()
            else:
                rc[slot].copy_(row[0], non_blocking=True)
                rs[slot].copy_(row[1], non_blocking=True)

    def _donate_state(self, h: int, slot: int) -> None:
        """Checkpoint the slot's recurrent rows into the host state tier under
        page-chain hash ``h`` (the boundary is the end of the hashed chain)."""
        if self._state_tier is None or h in self._state_tier:
            return
        # copies (on a CPU engine .cpu() would alias the live rows)
        rows = [None if rc is None else (rc[slot].to("cpu", copy=True),
                                         rs[slot].to("cpu", copy=True))
                for rc, rs in zip(self.r_conv, self.r_state)]
        nbytes = sum(r[0].nbytes + r[1].nbytes for r in rows if r is not None)
        budget = self.config.state_cache_mb * (1 << 20)
        while self._state_tier and self._state_tier_bytes + nbytes > budget:
            _, old = self._state_tier.popitem(last=False)
            self._state_tier_bytes -= sum(r[0].nbytes + r[1].nbytes for r in old
                                          if r is not None)
        if nbytes <= budget:
            self._state_tier[h] = rows
            self._state_tier_bytes += nbytes
            self.stats["state_snapshots"] = self.stats.get("state_snapshots", 0) + 1

    def _prefill_hybrid_chunked(self, req: _Request, slot: int, n: int, n_shared: int,
                                hashes: list[int], snap) -> torch.Tensor:
        """Chunked prefill of a hybrid model: restore the boundary snapshot
        (zeros for a fresh start), run page-aligned chunks threading the
        recurrent rows, and checkpoint the rows at the last full-page boundary
        so that later prompts sharing the prefix skip it. Returns the last
        prompt token's hidden state [D]."""
        ps = self.config.page_size
        shared = n_shared * ps
        n_shareable = len(hashes) * ps
        if snap is not None and n_shared:
            self._set_slot_rows(slot, snap)
            self.stats["state_restores"] = self.stats.get("state_restores", 0) + 1
        else:
            self._set_slot_rows(slot, None)
        c = min(self.config.prefill_chunk, self.config.max_seq_len)
        c = max(ps, (c // ps) * ps)
        row = self.slots.page_table[slot]
        row_dev = self._to_dev(row)
        n_chunk_pages = c // ps
        last_hidden = None

        def run(lo: int, hi: int) -> None:
            nonlocal last_hidden
            for off in range(lo, hi, c):
                valid = min(c, hi - off)
                ids = np.zeros((1, c), np.int64)
                ids[0, :valid] = req.prompt[off: off + valid]
                pchunk = np.zeros((n_chunk_pages,), np.int32)
                seg = row[off // ps: off // ps + n_chunk_pages]
                pchunk[: len(seg)] = seg
                rows_in = [None if rc is None else (rc[slot], rs[slot])
                           for rc, rs in zip(self.r_conv, self.r_state)]
                _, _, last_hidden, rows_out = smodel.prefill_chunk(
                    self.params, self.spec, self.k_pool, self.v_pool, self._to_dev(ids), off,
                    valid, self._to_dev(pchunk), row_dev, compute_dtype=self.compute_dtype,
                    r_rows=rows_in, gdn_precision=self.gdn_precision)
                self._set_slot_rows(slot, rows_out)

        # up to the shareable boundary, checkpointed there; then the tail
        # past it (always at least one token)
        run(shared, n_shareable)
        if hashes and shared < n_shareable:
            self._donate_state(hashes[-1], slot)
        run(max(shared, n_shareable), n)
        return last_hidden

    def _finalize_scoring_only(self, a: _Active) -> None:
        self._fetch_first_token(a)
        a.generated.clear()
        a.logprobs.clear()
        self._finish(a, "length")

    def _fetch_first_token(self, a: _Active) -> None:
        if a.first_token_handle is None:
            return
        fetch, row = a.first_token_handle
        tok, lp = fetch.get()
        t, l = int(tok[row]), float(lp[row])
        a.generated.append(t)
        a.logprobs.append(l)
        a.first_token_handle = None
        if a.req.on_token is not None:
            a.req.on_token(t, l)

    def _pick_block(self) -> int:
        """Adaptive block length, two values: the full decode_block while the
        batch is stable, a quarter of it while admissions wait for a slot (so
        a finishing slot is noticed sooner)."""
        if self.decode_block <= 1:
            return 1
        if self.pending:
            return max(1, self.decode_block // 4)
        return self.decode_block

    def _pipe_full(self) -> bool:
        """In-flight budget: LOOKAHEAD decode tokens, and at least two blocks
        queued so the device never idles while the host drains."""
        return (sum(st.k for st in self._inflight) >= self.LOOKAHEAD
                and len(self._inflight) >= 2)

    def _dispatch_decode(self) -> None:
        if self._table_dirty:
            self._d_table = self._to_dev(self.slots.page_table)
            self._table_dirty = False
        slots = sorted(s for s, a in self.active.items() if not a.done)
        k_steps = self._pick_block()
        filtering = self._filtering(slots)
        tokens, lengths, active = self._d_tokens, self._d_lengths, self._d_active
        toks_rows, lps_rows, routed_rows = [], [], []
        for _ in range(k_steps):
            out = smodel.decode(self.params, self.spec, self.k_pool, self.v_pool,
                                tokens, lengths, self._d_table,
                                compute_dtype=self.compute_dtype,
                                collect_routing=self._collect_routed,
                                r_conv=self.r_conv, r_state=self.r_state)
            logits = out[2]
            if self._collect_routed:
                routed_rows.append(out[3])
            out_tokens, out_logprobs = sample_tokens(logits, self._d_temp, self._d_topk,
                                                     self._d_topp, self._gen,
                                                     filtering=filtering)
            # frozen slots keep their last token so their state is stable
            out_tokens = torch.where(active, out_tokens, tokens)
            new_lengths = lengths + active.to(torch.int32)
            # in-block stopping: a stop-token hit (row of -1-padded ids; eos
            # rides the row unless ignore_eos) or the length budget spent
            hit_stop = (out_tokens[:, None] == self._d_stop).any(dim=1)
            active = active & ~hit_stop & (new_lengths < self._d_limit)
            tokens, lengths = out_tokens, new_lengths
            toks_rows.append(out_tokens)
            lps_rows.append(out_logprobs)
        self._d_tokens.copy_(tokens)
        self._d_lengths.copy_(lengths)
        self._d_active.copy_(active)
        # tokens ride as f32 (exact below 2^24, above any vocabulary size)
        packed = torch.stack([torch.stack(toks_rows).float(),
                              torch.stack(lps_rows).float()], dim=-1)  # [K, S, 2]
        # the routing rides the same copy behind the block: no sync of its own
        fetch = _Fetch([packed, torch.stack(routed_rows)] if routed_rows else [packed])
        self._dispatch_seq += 1
        self._inflight.append(_StepOutput(self._dispatch_seq, fetch, slots, k_steps))

    def _drain(self, force: bool = False) -> None:
        if not self._inflight:
            if force:
                # no decode blocks in flight (e.g. a scoring-only request):
                # release finished slots now
                self._process_deferred(self._dispatch_seq, drained_all=True)
            return
        if not force and not self._pipe_full():
            return
        # drain the OLDEST block only, leaving the rest queued on the device;
        # forced drains (pause/update/shutdown) flush everything
        if force:
            steps = list(self._inflight)
            self._inflight.clear()
        else:
            steps = [self._inflight.popleft()]
        for step in steps:
            packed, *routed = step.packed.get()
            routed = routed[0] if routed else None
            tokens = packed[..., 0].astype(np.int64)
            logprobs = packed[..., 1]
            for i in range(step.k):
                for s in step.slots:
                    a = self.active.get(s)
                    if a is None or a.done:
                        continue  # finished earlier; extra tokens discarded
                    if routed is not None and (len(a.routed) < len(a.generated)
                                               + (a.first_token_handle is not None)):
                        # row i CONSUMED the slot's previous token: its
                        # routing belongs to generated[len(a.routed)]
                        a.routed.append(routed[i, s])
                    if a.first_token_handle is not None:
                        self._fetch_first_token(a)
                        self._post_append_checks(a)
                        if a.done:
                            continue
                    self._shadow_lengths[s] += 1
                    self._append_token(a, int(tokens[i, s]), float(logprobs[i, s]))
            self._process_deferred(step.seq)
        if force:
            self._process_deferred(self._dispatch_seq, drained_all=not self._inflight)

    def _process_deferred(self, drained_seq: int, drained_all: bool = False) -> None:
        still = []
        for slot, seq in self._deferred_release:
            if seq <= drained_seq or drained_all:
                self.slots.release(slot)
                del self.active[slot]
            else:
                still.append((slot, seq))
        self._deferred_release = still

    def _post_append_checks(self, a: _Active) -> None:
        sp = a.req.params
        token = a.generated[-1]
        stop = set(sp.stop_token_ids) | (set() if sp.ignore_eos else {self.spec.eos_token_id})
        if token in stop:
            self._finish(a, "stop")
        elif len(a.generated) >= sp.max_tokens:
            self._finish(a, "length")
        elif self._shadow_lengths[a.slot] + 1 >= self.config.max_seq_len:
            self._finish(a, "length")

    def _append_token(self, a: _Active, token: int, logprob: float) -> None:
        if a.done or len(a.generated) >= a.req.params.max_tokens:
            self._finish(a, "length")
            return
        a.generated.append(token)
        a.logprobs.append(logprob)
        if a.req.on_token is not None:
            a.req.on_token(token, logprob)
        self._post_append_checks(a)

    def _finish(self, a: _Active, reason: str) -> None:
        if a.done:
            return
        a.done = True
        if a.req.request_id is not None:
            with self._lock:
                self._by_id.pop(a.req.request_id, None)
        self._fetch_first_token(a)
        plp = None
        if a.prompt_logprobs_handle is not None:
            (vals,) = a.prompt_logprobs_handle.get()
            plp = [float(x) for x in vals[: len(a.req.prompt)]]
        # stop generating for this slot as of the NEXT dispatch; pages stay
        # reserved until every already-dispatched block has drained
        self._d_active[a.slot] = False
        self._deferred_release.append((a.slot, self._dispatch_seq))
        routed = None
        if self._collect_routed and a.routed and a.generated:
            rows = [np.asarray(r, np.int32) for r in a.routed[: len(a.generated)]]
            rows += [np.full_like(rows[0], -1)] * (len(a.generated) - len(rows))
            routed = np.stack(rows)
        a.req.future.set_result(GenerationResult(
            token_ids=list(a.generated),
            logprobs=list(a.logprobs),
            finish_reason=reason,
            prompt_len=len(a.req.prompt),
            prompt_logprobs=plp,
            policy_version=self.policy_version,
            routed_experts=routed,
        ))


class EngineLoop:
    """Background thread driving ``engine.step()`` (the server's run loop)."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    def _run(self) -> None:
        logger = get_logger()
        if self.engine.device.type == "cuda":
            # the current device is per thread: a colocated trainer may run
            # on another card than this thread's default
            torch.cuda.set_device(self.engine.device)
        while not self._stop.is_set():
            try:
                if not self.engine.step():
                    time.sleep(0.002)
            except Exception:
                logger.exception("engine step failed")
                time.sleep(0.1)
