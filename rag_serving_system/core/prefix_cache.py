"""Exact prefix-KV cache: content-addressed reuse of context KV across requests.

The RAG prompt is "Context:\n{docs}\n\nQuestion: {q}..." (reference:
rag_service/core/batch_processor.py:100-103) and retrieval is deterministic
exact top-k — so the (usually long) context prefix repeats across requests
whenever queries repeat or share retrieved documents. Prefill is the
compute-bound stage, so *not recomputing* the context KV is the lever left
once its matmuls run near the card's rate. This is the static-shape
equivalent of vLLM-style automatic prefix caching:

- entries are whole context prefixes (keyed by retrieved-doc identity,
  VERIFIED against exact token ids — a hit is bit-exact by construction, not
  probabilistic);
- payloads live in ONE preallocated device pool tensor
  (CAP+1, L, 2, POOL_LEN, Hk, D) — slot CAP is a permanent zeros row for
  batch rows without a prefix. A batch's per-row slots become a single
  device GATHER `pool[slots]`, and inserts are a single donated scatter —
  XLA aliases the donated pool buffer, so writes are in-place slot updates,
  not pool copies. (The previous design stacked 32 independent entry arrays
  per batch: ~18 ms of dispatch/copy on the critical path at squad scale —
  the pool gather is <1 ms.)
- `generate(prefix_kv=...)` prefills only the suffix (question + answer cue)
  and attends over [prefix | suffix | generated];
- misses are DEDUPLICATED per batch and computed in one batched
  `compute_prefix_kv` dispatch — so even at 0% hit rate the prefix tokens
  are prefilled once per distinct context instead of once per row.

Memory grows LAZILY in doubling slot chunks up to the byte budget (round 2
reserved the whole 2 GB budget up front even with 2 live entries — poor HBM
hygiene); rows 0/1 are permanent zero/scratch slots so data-slot indices
stay valid across growth. Eviction is LRU slot reuse once at full capacity;
it is safe against in-flight batches because a single device executes
programs in dispatch order — a gather dispatched before the overwriting
scatter reads the old slot contents.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Hashable, Optional, Tuple

import jax
import jax.numpy as jnp


@dataclass
class PrefixEntry:
    tokens: Tuple[int, ...]   # exact token ids this entry caches
    slot: int                 # row index into the device pool(s)


# Pools are stored FLATTENED — values as (N, L*2, PL, Hk*D) and scales as
# (N, L*2, PL*Hk) — because the natural (N, L, 2, PL, Hk, D) layout ends in
# (Hk=2, D): a compiler that tiles the two minor dims pads the tiny
# second-to-minor dim, and the gather then materializes a padded copy of
# the WHOLE pool. The reshape between entry shape and flat shape is
# dim-splitting only (no transpose), folded into the jitted gather/scatter
# so each stays a single dispatch.

_gather = jax.jit(lambda pool, slots, shape:
                  jnp.take(pool, slots, axis=0).reshape(
                      (slots.shape[0],) + shape),
                  static_argnums=2)

# donate the pool so XLA aliases the buffer and the scatter is an in-place
# slot update, never a pool copy
_scatter = jax.jit(lambda pool, slots, rows:
                   pool.at[slots].set(
                       rows.reshape((rows.shape[0],) + pool.shape[1:])
                       .astype(pool.dtype)),
                   donate_argnums=0)

# pool growth: copy live rows into a larger zero/one-filled pool (no
# donation — the shapes differ, so aliasing is impossible anyway; both pools
# coexist only for the duration of the copy)
import functools as _functools


@_functools.lru_cache(maxsize=None)
def _grow_fn(rows: int, fill: int, sharding):
    return jax.jit(lambda pool: jnp.full(
        (rows,) + pool.shape[1:], fill, pool.dtype).at[:pool.shape[0]].set(pool),
        out_shardings=sharding)


def _grow(pool, rows, fill, sharding=None):
    return _grow_fn(rows, fill, sharding)(pool)


class PrefixKVCache:
    """Host-side LRU index over a device-resident slot pool.

    Thread-safe: lookups may run on the prefetch thread while inserts run on
    the dispatch thread. A hit requires the stored token ids to equal the
    request's prefix tokens — the key (retrieved-doc tuple) is only a fast
    index; exactness never depends on it (tokenizers can merge across the
    context/question boundary, which the caller handles by trimming, and the
    verify here backstops).

    `entry_shape` is the per-entry payload shape (L, 2, POOL_LEN, Hk, D).
    With `int8=True` two pools are kept: int8 values + f32 per-(token, head)
    scales (see models.qwen2.quantize_prefix_kv)."""

    # data slots start past the two permanent rows (0 zeros, 1 scratch) so
    # slot indices stay valid as the pool grows
    _RESERVED_ROWS = 2
    ZERO = 0
    SCRATCH = 1

    def __init__(self, pool_len: int, entry_bytes: int, budget_mb: int = 2048,
                 min_tokens: int = 16, entry_shape: tuple | None = None,
                 dtype=None, int8: bool = False, min_slots: int = 0,
                 initial_slots: int = 16, sharding=None,
                 adaptive: bool = True, window: int = 512,
                 low_hit_rate: float = 0.25, probe_every: int = 8):
        import os

        self.pool_len = int(pool_len)
        self.entry_bytes = int(entry_bytes)
        self.capacity = max(1, (budget_mb * (1 << 20)) // max(1, entry_bytes))
        # cap the entry count too — with small per-entry payloads (tiny
        # models) the byte budget alone would admit millions of slots
        self.capacity = min(self.capacity,
                            int(os.environ.get("PREFIX_MAX_ENTRIES", "4096")))
        # slot-reuse safety needs headroom: one batch can protect up to
        # 2 x max_batch slots (its hits + its own fresh inserts), and an
        # allocator that can't find an unprotected victim would have to fail
        # the batch — so the engine passes min_slots = 2*max_batch + 1 and
        # we admit past the byte budget if needed (logged via stats)
        self.capacity = max(self.capacity, min_slots)
        self.min_tokens = min_tokens
        self.int8 = int8
        self._entries: "OrderedDict[Hashable, PrefixEntry]" = OrderedDict()
        # LAZY pool: start with a small slot chunk and double on demand up to
        # capacity — LRU eviction only begins once the full budget is live
        self.n_slots = min(self.capacity, max(1, initial_slots))
        self._free: list[int] = list(range(
            self._RESERVED_ROWS, self._RESERVED_ROWS + self.n_slots))
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.bypassed = 0  # rows that skipped the prefix path entirely
        self.grows = 0
        # ---- adaptive thrash bypass ----
        # A thrashing workload (cyclic access over a working set > capacity)
        # pays the miss path — compute_prefix_kv + scatter/gather + the
        # suffix-split prefill — for near-zero reuse. A rolling hit-rate
        # window detects that regime and the engine then SKIPS the prefix
        # path for most batches, probing every `probe_every`-th batch so the
        # cache re-engages as soon as the workload becomes cacheable again.
        self.adaptive = adaptive
        self._window = int(window)
        self._win_hits: "deque[bool]" = deque(maxlen=self._window)
        self._low_hit_rate = float(low_hit_rate)
        self._probe_every = max(2, int(probe_every))
        self._batch_no = 0
        self.bypass_mode = False
        self.probes = 0
        self.zero_slot = self.ZERO       # permanent all-zeros row
        self.scratch_slot = self.SCRATCH  # scatter target for pad rows
        self._pool = self._pool_scale = None
        # optional NamedSharding for the VALUE pool rows (TP mesh: shard the
        # flattened Hk*D dim over "model", matching the decoder's KV-head
        # sharding, replicated over "data"); scales replicate (tiny).
        # Each allocation goes through out_shardings so no single device ever
        # materializes the full pool.
        self._sharding = sharding
        if entry_shape is not None:
            ll, two, pl, hk, d = entry_shape
            self.entry_shape = tuple(entry_shape)
            self.scale_shape = (ll, two, pl, hk, 1)
            self._flat = (ll * two, pl, hk * d)
            self._flat_scale = (ll * two, pl * hk)
            self._dtype = dtype
            n = self._RESERVED_ROWS + self.n_slots
            if int8:
                self._pool = self._alloc((n,) + self._flat, jnp.int8, 0,
                                         sharding)
                self._pool_scale = self._alloc((n,) + self._flat_scale,
                                               jnp.float32, 1, None)
            else:
                self._pool = self._alloc((n,) + self._flat, dtype, 0, sharding)

    @staticmethod
    def _alloc(shape, dtype, fill, sharding):
        if sharding is None:
            return jnp.full(shape, fill, dtype)
        return jax.jit(lambda: jnp.full(shape, fill, dtype),
                       out_shardings=sharding)()

    def _growth_sizes(self) -> list[int]:
        """Every pool ROW count the doubling schedule can reach (for warmup
        to pre-compile the gather/scatter programs at each size)."""
        sizes, n = [], self.n_slots
        while True:
            sizes.append(self._RESERVED_ROWS + n)
            if n >= self.capacity:
                return sizes
            n = min(self.capacity, n * 2)

    def _grow_locked(self) -> None:
        """Double the slot count (up to capacity): allocate the larger pool,
        copy live rows, extend the free list. One device dispatch per pool;
        the gather/scatter jits recompile per pool size, which warmup
        pre-seeds via `warm_compiles` (growth sizes are geometric, so there
        are only ~log2(capacity) programs ever)."""
        new_n = min(self.capacity, max(self.n_slots * 2, 1))
        if new_n <= self.n_slots:
            raise RuntimeError("_grow_locked called at full capacity")
        rows = self._RESERVED_ROWS + new_n
        self._pool = _grow(self._pool, rows, 0, self._sharding)
        if self._pool_scale is not None:
            self._pool_scale = _grow(self._pool_scale, rows, 1, None)
        self._free.extend(range(self._RESERVED_ROWS + self.n_slots, rows))
        self.n_slots = new_n
        self.grows += 1

    def get(self, key: Hashable, tokens: Tuple[int, ...]) -> Optional[PrefixEntry]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None and e.tokens == tokens:
                self._entries.move_to_end(key)
                self.hits += 1
                self._win_hits.append(True)
                return e
            self.misses += 1
            self._win_hits.append(False)
            return None

    def should_attempt(self) -> bool:
        """Per-BATCH adaptive gate, called by the engine before splitting
        prompts at the prefix boundary. Returns False when the rolling hit
        rate says the workload is thrashing — except on probe batches, which
        keep exercising the cache so recovery is automatic. Never flips to
        bypass until the window has filled once (cold-start misses are
        warming, not thrash)."""
        if not self.adaptive:
            return True
        with self._lock:
            self._batch_no += 1
            if len(self._win_hits) >= self._window:
                rate = sum(self._win_hits) / len(self._win_hits)
                self.bypass_mode = rate < self._low_hit_rate
            if not self.bypass_mode:
                return True
            if self._batch_no % self._probe_every == 0:
                self.probes += 1
                return True
            return False

    def _alloc_slot_locked(self, protected: set) -> int:
        if self._free:
            return self._free.pop()
        if self.n_slots < self.capacity:
            self._grow_locked()
            return self._free.pop()
        # LRU reuse, skipping slots the CURRENT batch references (its hits
        # and its own fresh inserts): the batch's gather is dispatched AFTER
        # this scatter, so clobbering a protected slot would hand a row a
        # different context's KV. Cross-batch reuse is safe (in-order device
        # execution: earlier batches' gathers already ran). Skipped victims
        # are re-marked MRU. min_slots guarantees a victim exists.
        for key in list(self._entries):
            if self._entries[key].slot in protected:
                self._entries.move_to_end(key)
                continue
            return self._entries.pop(key).slot
        raise RuntimeError(
            "prefix cache has no evictable slot (capacity too small for "
            "one batch — should be prevented by min_slots)")

    def put_batch(self, keys: list, tokens_list: list, kv_rows,
                  protected: set | None = None) -> dict:
        """Insert a batch of freshly computed entries with ONE donated
        scatter. `kv_rows` is (M, *entry_shape) (or a (values, scales) pair
        in int8 mode) with the first len(keys) rows valid — the pad rows are
        scattered too (to the scratch slot) so the scatter's shape is the
        bucketed M and warmup can pre-compile it. `protected` holds slots
        the current batch's gather will read (its cache hits). Returns
        {key: PrefixEntry}."""
        protected = set(protected or ())
        with self._lock:
            entries = {}
            slots = []
            for key, toks in zip(keys, tokens_list):
                old = self._entries.get(key)
                if old is not None and old.slot not in protected:
                    # re-insert over a stale entry (token-split variant):
                    # recycle its slot instead of leaking it
                    self._free.append(old.slot)
                slot = self._alloc_slot_locked(protected)
                protected.add(slot)
                e = PrefixEntry(tokens=tuple(toks), slot=slot)
                self._entries[key] = e
                self._entries.move_to_end(key)
                entries[key] = e
                slots.append(slot)
            # the scatter DONATES the pool buffer, so it must stay inside the
            # lock: a concurrent gather (parallel warmup jobs, stage-1
            # workers) reading self._pool between the donation and the
            # rebind would hold a deleted array
            m = (kv_rows[0] if self.int8 else kv_rows).shape[0]
            slots = slots + [self.scratch_slot] * (m - len(slots))
            idx = jnp.asarray(slots, jnp.int32)
            if self.int8:
                vals, scales = kv_rows
                self._pool = _scatter(self._pool, idx, vals)
                self._pool_scale = _scatter(self._pool_scale, idx, scales)
            else:
                self._pool = _scatter(self._pool, idx, kv_rows)
        return entries

    def gather(self, slots: list) -> jax.Array | tuple:
        """(B,) slot list → (B, *entry_shape) device gather (values or a
        (values, scales) pair in int8 mode). Use `zero_slot` for no-prefix
        rows."""
        idx = jnp.asarray(slots, jnp.int32)
        with self._lock:   # vs put_batch's donated-scatter pool swap
            if self.int8:
                return (_gather(self._pool, idx, self.entry_shape),
                        _gather(self._pool_scale, idx, self.scale_shape))
            return _gather(self._pool, idx, self.entry_shape)

    def note_bypass(self) -> None:
        """Count a row that skipped the prefix path (lock-guarded — callers
        include concurrent stage-1 workers)."""
        with self._lock:
            self.bypassed += 1

    def __len__(self) -> int:
        return len(self._entries)

    def warm_compiles(self, gather_counts, scatter_counts) -> None:
        """Pre-seed the persistent XLA compile cache with the gather/scatter
        programs for EVERY pool size the doubling growth can reach, via AOT
        lowering (jax.ShapeDtypeStruct — no pool of that size is allocated).
        A growth event mid-serving then compiles from the disk cache instead
        of from scratch."""
        import numpy as np  # noqa: F401  (ShapeDtypeStruct only)

        pools = ([(self._flat, self._pool.dtype)] if not self.int8 else
                 [(self._flat, jnp.int8), (self._flat_scale, jnp.float32)])
        shapes = ([self.entry_shape] if not self.int8 else
                  [self.entry_shape, self.scale_shape])
        for rows in self._growth_sizes():
            for (flat, dt), eshape in zip(pools, shapes):
                pool_av = jax.ShapeDtypeStruct((rows,) + flat, dt)
                for b in sorted(set(gather_counts)):
                    idx = jax.ShapeDtypeStruct((b,), jnp.int32)
                    _gather.lower(pool_av, idx, eshape).compile()
                for m in sorted(set(scatter_counts)):
                    idx = jax.ShapeDtypeStruct((m,), jnp.int32)
                    rows_av = jax.ShapeDtypeStruct((m,) + eshape, dt)
                    _scatter.lower(pool_av, idx, rows_av).compile()

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            rows = self._RESERVED_ROWS + self.n_slots
            reserved = rows * self.entry_bytes
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "slots": self.n_slots,
                "grows": self.grows,
                "bytes": len(self._entries) * self.entry_bytes,
                "pool_reserved_bytes": reserved,
                "hits": self.hits,
                "misses": self.misses,
                "bypassed": self.bypassed,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "rolling_hit_rate": (sum(self._win_hits) / len(self._win_hits)
                                     if self._win_hits else None),
                "bypass_mode": self.bypass_mode,
                "probes": self.probes,
            }


class PromptSpec(str):
    """A prompt string that carries its cacheable-prefix split.

    Subclassing `str` keeps every existing consumer working unchanged
    (tokenizers encode it, `len()` orders it for length-aware batching, tests
    compare it) while the engine's staging path can read the extra fields."""

    prefix_text: str
    cache_key: Hashable
    sort_len: int
    gen_budget: int | None

    def __new__(cls, text: str, prefix_text: str = "", cache_key=None,
                gen_budget=None):
        s = super().__new__(cls, text)
        s.prefix_text = prefix_text
        s.cache_key = cache_key
        # length-aware batch regrouping should order by what actually sets
        # the prefill bucket: the SUFFIX (the prefix is cached KV)
        s.sort_len = max(len(text) - len(prefix_text), 0)
        # per-request max_new_tokens (None = engine default); rides the
        # prompt through batching/reordering so budgets stay row-aligned
        s.gen_budget = gen_budget
        return s


def split_prefix_tokens(full_tokens: list, prefix_tokens: list,
                        max_len: int) -> int:
    """Longest m <= max_len with full_tokens[:m] == prefix_tokens[:m].

    BPE tokenizers can merge across the prefix/suffix string boundary, so the
    last token (or two) of the separately-tokenized prefix may differ from
    the full prompt's tokenization — trim until they agree. Exactness of the
    cached prefill only needs *some* token-aligned split point."""
    m = min(len(prefix_tokens), len(full_tokens), max_len)
    while m > 0 and full_tokens[m - 1] != prefix_tokens[m - 1]:
        m -= 1
    # the trimmed region must match element-wise, not just at the last index
    while m > 0 and full_tokens[:m] != prefix_tokens[:m]:
        m -= 1
    return m
