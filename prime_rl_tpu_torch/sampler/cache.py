"""Paged KV cache: device pool + host page allocator (the port of the JAX
package's ``sampler/cache.py``; dense attention, MLA and the GatedDeltaNet
and Mamba-2 hybrids).

    k/v: one [num_kv_heads, num_pages, page_size, head_dim] tensor per layer
    MLA: k one [1, num_pages, page_size, kv_lora_rank + qk_rope_head_dim]
         latent row a token, shared by every head; v the DSA indexer keys
         [1, num_pages, page_size, index_head_dim], or None for dense MLA
    hybrid: pages only for the attention layers ("A", Nemotron-H's "*");
         ``RecurrentPool`` holds a recurrent layer's ("L", "M") per-slot
         conv window and state instead; "-" and "E" layers hold nothing

The allocator is plain host Python (a free list); the device only ever sees
a page table ``[max_slots, pages_per_slot] int32`` and per-slot lengths.
Page 0 is reserved as the null page so unused table entries stay valid.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from prime_rl_tpu_torch.models.base import ModelSpec


@dataclass(frozen=True)
class CacheConfig:
    num_pages: int = 1024
    page_size: int = 64
    max_slots: int = 32
    max_seq_len: int = 4096
    # prefix caching: reuse full prompt pages across requests
    enable_prefix_cache: bool = True
    # incremental prefill chunk (page multiple): prompts longer than the
    # largest bucket — or with a cached prefix — prefill in chunks of this size
    prefill_chunk: int = 1024
    # host-offload KV tier (not ported yet: must stay 0)
    host_cache_mb: int = 0
    # hybrid (GDN) prefix caching: host budget for recurrent-state
    # checkpoints taken at the last full-page boundary of each prompt; a later
    # prompt whose page chain reaches one restores the state and skips the
    # prefix. 0 = hybrids serve without prefix reuse.
    state_cache_mb: int = 256

    @property
    def pages_per_slot(self) -> int:
        return -(-self.max_seq_len // self.page_size)


PAGED_KINDS = ("A", "*")  # layers with KV pages
RECURRENT_KINDS = ("L", "M")  # layers with RecurrentPool rows


def layer_kinds(spec: ModelSpec) -> list[str]:
    """Per-layer cache kind: "A" = paged-KV attention+MLP pair, "L" =
    recurrent GatedDeltaNet, "M" = recurrent Mamba-2 mixer, "*" = bare
    attention (Nemotron-H: no MLP pairing, no rope), "-" = MLP only, "E" =
    MoE only. Homogeneous transformers are all "A"."""
    if spec.gdn_pattern:
        return list(spec.gdn_pattern)
    if spec.layer_pattern:
        return list(spec.layer_pattern)
    return ["A"] * spec.num_layers


class KVPool:
    """Device-side pool, one k and one v tensor PER LAYER, updated in place
    by prefill page writes and the decode append (where the JAX pool is
    donated and functionally replaced). MLA keeps the latent row of each
    token in k (the compressed cache MLA exists for) and, for DSA, the
    indexer keys in v, so that decode runs the exact top-k selection; dense
    MLA has no v (None)."""

    def __init__(self, spec: ModelSpec, config: CacheConfig, dtype=torch.bfloat16,
                 device: torch.device | str = "cpu"):
        kinds = layer_kinds(spec)
        self.spec = spec
        self.config = config
        if spec.kv_lora_rank > 0:
            lead, (k_row, v_row) = 1, row_widths(spec)
        else:
            lead, k_row, v_row = spec.num_kv_heads, spec.head_dim, spec.head_dim

        def pool(width):
            shape = (lead, config.num_pages, config.page_size, width)
            return [torch.zeros(shape, dtype=dtype, device=device)
                    if width and kd in PAGED_KINDS else None for kd in kinds]

        self.k, self.v = pool(k_row), pool(v_row)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for pool in (self.k, self.v) for t in pool
                   if t is not None)


def recurrent_shapes(spec: ModelSpec, kind: str) -> tuple[tuple, tuple] | None:
    """A recurrent layer's per-slot (conv, state) shapes: the GatedDeltaNet's
    ([conv_dim, K], [Hv, Dk, Dv]) for "L", the Mamba-2 mixer's ([conv_dim, K],
    [H, P, N]) for "M"; None for any other kind."""
    if kind == "L":
        return ((spec.gdn_conv_dim, spec.gdn_conv_kernel),
                (spec.gdn_v_heads, spec.gdn_k_dim, spec.gdn_v_dim))
    if kind == "M":
        return ((spec.mamba_conv_dim, spec.mamba_conv_kernel),
                (spec.mamba_num_heads, spec.mamba_head_dim, spec.mamba_state_size))
    return None


class RecurrentPool:
    """Per-slot recurrent decode state of the GatedDeltaNet ("L") and Mamba-2
    ("M") layers, one entry a layer (None for any other layer):
      conv  [max_slots, conv_dim, K]    the rolling raw conv inputs, in the
                                        compute dtype
      state [max_slots, ...]            the fast-weight state [Hv, Dk, Dv] or
                                        the SSM state [H, P, N], float32
    Updated in place by decode and the chunked prefill; a slot's rows are
    written at admit, so rows left by a finished request are never read."""

    def __init__(self, spec: ModelSpec, config: CacheConfig, dtype=torch.bfloat16,
                 device: torch.device | str = "cpu"):
        s = config.max_slots
        self.conv, self.state = [], []
        for kd in layer_kinds(spec):
            shapes = recurrent_shapes(spec, kd)
            self.conv.append(None if shapes is None else
                             torch.zeros((s, *shapes[0]), dtype=dtype, device=device))
            self.state.append(None if shapes is None else
                              torch.zeros((s, *shapes[1]), dtype=torch.float32, device=device))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.conv + self.state if t is not None)


def recurrent_nbytes(spec: ModelSpec, max_slots: int, itemsize: int = 2) -> int:
    """Bytes of a ``RecurrentPool`` of ``max_slots`` slots (conv windows in
    a dtype of ``itemsize`` bytes, states float32)."""
    total = 0
    for kd in layer_kinds(spec):
        shapes = recurrent_shapes(spec, kd)
        if shapes is not None:
            total += (int(np.prod(shapes[0])) * itemsize + int(np.prod(shapes[1])) * 4)
    return total * max_slots


def row_widths(spec: ModelSpec) -> tuple[int, int]:
    """Values a token adds to the k and the v pool of one layer: the kv heads'
    rows, or MLA's latent row and DSA's indexer key (0: no v pool)."""
    if spec.kv_lora_rank > 0:
        return (spec.kv_lora_rank + spec.qk_rope_head_dim,
                spec.index_head_dim if spec.index_topk > 0 else 0)
    return spec.kv_dim, spec.kv_dim


def page_nbytes(spec: ModelSpec, page_size: int, itemsize: int = 2) -> int:
    """Bytes one page takes over every paged layer's k and v pool."""
    paged = sum(kd in PAGED_KINDS for kd in layer_kinds(spec))
    return paged * sum(row_widths(spec)) * page_size * itemsize


def hash_pages(tokens: list[int], page_size: int, salt: object = None) -> list[int]:
    """Chained 64-bit hashes of each FULL page of ``tokens``: page i's hash
    commits to every token before it and the salt, so a chain-prefix match
    means a token-prefix match."""
    out: list[int] = []
    prev = repr(salt).encode()
    for i in range(len(tokens) // page_size):
        page = tokens[i * page_size: (i + 1) * page_size]
        h = hashlib.blake2b(prev + np.asarray(page, np.int64).tobytes(), digest_size=8)
        prev = h.digest()
        out.append(int.from_bytes(prev, "little"))
    return out


@dataclass
class _CacheEntry:
    page: int
    refs: int = 0
    tick: int = 0


class PrefixCache:
    """Page-hash -> KV page reuse across requests. Pages live here either
    *shared* (refs > 0: some live slot's page table points at them) or
    *idle* (refs == 0: evictable LRU)."""

    def __init__(self):
        self.entries: dict[int, _CacheEntry] = {}
        self._tick = 0
        self.hits_tokens = 0
        self.misses_tokens = 0

    def lookup(self, hashes: list[int]) -> list[int]:
        """Longest chain of cached pages matching the hash chain; increfs."""
        pages = []
        self._tick += 1
        for h in hashes:
            e = self.entries.get(h)
            if e is None:
                break
            e.refs += 1
            e.tick = self._tick
            pages.append(e.page)
        return pages

    def match_len(self, hashes: list[int]) -> int:
        """Length of the longest cached chain WITHOUT taking refs."""
        n = 0
        for h in hashes:
            if h not in self.entries:
                break
            n += 1
        return n

    def decref(self, h: int) -> None:
        e = self.entries.get(h)
        if e is not None:
            e.refs -= 1

    def insert(self, h: int, page: int) -> bool:
        """Donate an idle page under hash ``h``; False if already present
        (the caller frees the duplicate page)."""
        if h in self.entries:
            return False
        self._tick += 1
        self.entries[h] = _CacheEntry(page, refs=0, tick=self._tick)
        return True

    def evict(self, need: int) -> list[int]:
        """Free up to ``need`` idle pages, least-recently-used first."""
        idle = sorted(
            ((h, e) for h, e in self.entries.items() if e.refs <= 0),
            key=lambda kv: kv[1].tick,
        )
        out = []
        for h, e in idle[:need]:
            del self.entries[h]
            out.append(e.page)
        return out

    def flush(self) -> list[int]:
        """Drop every idle entry (weight update: cached KV is stale). Shared
        entries stay mapped until their slots release but are unlinked from
        the hash space so no new request can match them."""
        pages = [e.page for e in self.entries.values() if e.refs <= 0]
        survivors = [e for e in self.entries.values() if e.refs > 0]
        # blake hashes are non-negative; ~i is always negative
        self.entries = {~i: e for i, e in enumerate(survivors)}
        return pages


class PageAllocator:
    """Host free-list; page 0 reserved as the null page."""

    def __init__(self, config: CacheConfig):
        self.config = config
        self.free: list[int] = list(range(config.num_pages - 1, 0, -1))
        self.slot_pages: dict[int, list[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self.free)

    def can_fit(self, num_tokens: int) -> bool:
        return len(self.free) >= -(-num_tokens // self.config.page_size)

    def allocate_n(self, slot: int, n_pages: int) -> list[int]:
        """Append exactly ``n_pages`` owned pages to ``slot``."""
        if n_pages > len(self.free):
            raise MemoryError(f"KV pool exhausted: need {n_pages}, free {len(self.free)}")
        pages = self.slot_pages.setdefault(slot, [])
        for _ in range(n_pages):
            pages.append(self.free.pop())
        return pages

    def allocate(self, slot: int, num_tokens: int) -> list[int]:
        """Ensure ``slot`` has pages covering num_tokens; returns full list."""
        pages = self.slot_pages.setdefault(slot, [])
        need = -(-num_tokens // self.config.page_size) - len(pages)
        self.allocate_n(slot, max(0, need))
        return pages

    def release(self, slot: int) -> None:
        pages = self.slot_pages.pop(slot, [])
        self.free.extend(reversed(pages))


@dataclass
class _SlotMeta:
    shared_hashes: list[int]  # cache hashes this slot holds refs on
    donate_hashes: list[int]  # hashes of own full prompt pages (cacheable)
    epoch: int


class SlotTable:
    """Host mirror of the device page table + lengths for all slots, with
    prefix-cache-aware page accounting: a slot's page-table row is
    ``[shared cache pages..., owned pages...]`` and released prompt pages
    are donated back to the cache instead of freed."""

    def __init__(self, config: CacheConfig, enable_prefix_cache: bool = True):
        self.config = config
        self.page_table = np.zeros((config.max_slots, config.pages_per_slot), np.int32)
        self.lengths = np.zeros((config.max_slots,), np.int32)
        self.free_slots: list[int] = list(range(config.max_slots - 1, -1, -1))
        self.alloc = PageAllocator(config)
        self.cache = PrefixCache() if enable_prefix_cache else None
        self.epoch = 0
        self._meta: dict[int, _SlotMeta] = {}

    def _reclaim(self, need_pages: int) -> None:
        """Evict idle cache pages back into the free list if short."""
        short = need_pages - self.alloc.num_free
        if short > 0 and self.cache is not None:
            self.alloc.free.extend(self.cache.evict(short))

    def acquire(self, num_tokens: int, prompt_hashes: list[int] | None = None,
                max_shared: int | None = None) -> tuple[int, int] | None:
        """Slot + pages for ``num_tokens``, reusing the longest cached chain
        of ``prompt_hashes`` (full prompt pages, salt-chained). Returns
        (slot, shared_page_count) or None if the pool can't fit it now.
        ``max_shared`` caps the reused chain (hybrid models: pages past the
        recurrent-state checkpoint would be recomputed into shared pages)."""
        hashes = list(prompt_hashes or ())
        if not self.free_slots:
            return None
        lookup = hashes if max_shared is None else hashes[:max_shared]
        shared_pages = self.cache.lookup(lookup) if self.cache is not None else []
        n_shared = len(shared_pages)
        total_pages = -(-num_tokens // self.config.page_size)
        need = total_pages - n_shared
        self._reclaim(need)
        if need > self.alloc.num_free:
            if self.cache is not None:
                for h in hashes[:n_shared]:
                    self.cache.decref(h)
            return None
        slot = self.free_slots.pop()
        own = self.alloc.allocate_n(slot, need)
        pages = shared_pages + own
        self.page_table[slot, : len(pages)] = pages
        self.page_table[slot, len(pages):] = 0
        self.lengths[slot] = num_tokens
        self._meta[slot] = _SlotMeta(hashes[:n_shared], hashes[n_shared:], self.epoch)
        return slot, n_shared

    def cancel_donation(self, slot: int) -> None:
        """Mark a slot's own pages as NOT cacheable (prefill failed or never
        ran: donating unwritten pages would poison the prefix cache)."""
        meta = self._meta.get(slot)
        if meta is not None:
            meta.donate_hashes = []

    def release(self, slot: int) -> None:
        meta = self._meta.pop(slot, None)
        own = self.alloc.slot_pages.pop(slot, [])
        free_pages = own
        if meta is not None and self.cache is not None:
            for h in meta.shared_hashes:
                self.cache.decref(h)
            if meta.epoch == self.epoch:
                # donate full prompt pages (their KV matches current weights);
                # duplicates (another slot donated the same prefix) are freed
                free_pages = [
                    p for h, p in zip(meta.donate_hashes, own)
                    if not self.cache.insert(h, p)
                ] + own[len(meta.donate_hashes):]
        self.alloc.free.extend(reversed(free_pages))
        self.page_table[slot] = 0
        self.lengths[slot] = 0
        self.free_slots.append(slot)

    def flush_cache(self) -> None:
        """Weight update: cached KV is stale — drop idle entries, fence
        donations from slots prefilled under the old weights."""
        self.epoch += 1
        if self.cache is not None:
            self.alloc.free.extend(self.cache.flush())
