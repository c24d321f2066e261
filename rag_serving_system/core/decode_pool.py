"""Continuous (in-flight) batching: a persistent slot pool for decode.

The fixed-scan `generate` (models/qwen2.py) decodes a batch until EVERY row
has finished — completion-length variance is paid by the whole batch. This
module reclaims it (reference has no equivalent; the role is vLLM's
continuous batching, reshaped for XLA's static-shape compilation model, with
JetStream's orchestration shape):

- `DecodePool` owns a static (L, S, W, Hk, D) ring KV pool plus per-slot
  scalars, all device-resident. S slots and window W are fixed at engine
  start, so exactly TWO XLA programs run steady-state: `decode_chunk` (one
  shape, ever) and one insert program per prompt bucket.
- Prompts prefill through the engine's EXISTING bucketed programs
  (`prefill_for_pool` / packed variant) AHEAD of slot availability, then
  scatter into free slots right-aligned at the ring cursor in WAVES sized
  to whatever slots exist (drop-mode scatter: rows outside a wave carry an
  out-of-bounds slot id and write nothing) — a batch never head-of-line
  blocks a half-empty pool, and the pool may be smaller than a batch
  bucket. Each active slot emits one token per pool step; finished slots
  free immediately and new requests take their place WITHOUT waiting for
  the rest of a batch to drain.
- The worker thread dispatches `chunk` steps per XLA call and consumes the
  (chunk, S) token block one dispatch BEHIND (lag pipelining), so the device
  never idles on the host-device round trip.

Ring-overwrite safety: an insert with T prompt columns is legal only while
T + max_new_tokens <= W (checked at init); an active slot advances exactly
one column per step, so its oldest column cannot be lapped before it
finishes. Slots' tokens live at arbitrary ring columns — attention masks by
the per-slot validity bitmap and RoPE positions are baked into K, so key
order is irrelevant (softmax is permutation-invariant).

Decode FLOPs/HBM per step match the fixed path at equal batch; the win is
occupancy — no slot ever decodes a pad token for a finished neighbor.
"""

from __future__ import annotations

import functools
import logging
import os
import queue
import threading
import time
from typing import Callable, List

import jax
import jax.numpy as jnp
import numpy as np

from rag_serving_system.models.qwen2 import (decode_chunk, eos_id_set,
                                             token_is_eos)

logger = logging.getLogger(__name__)


@functools.partial(
    jax.jit,
    static_argnames=("eos_ids",),
    donate_argnums=(0, 1, 2, 3, 4, 5, 6),
)
def _insert_rows(pool_k, pool_v, valid, last_tok, next_pos, active, remaining,
                 rows_k, rows_v, mask, tok0, slot_ids, cursor, row_valid,
                 budgets, eos_ids):
    """Scatter B prefilled rows into the pool at `slot_ids`, right-aligned at
    the ring cursor: padded prompt position j (of T) lands at ring column
    (cursor - T + j) mod W, i.e. the slot's next decode write (at `cursor`)
    continues its sequence. One whole-(W,) row write per slot — a slot is
    rewritten wholesale on reuse, so no stale state can leak.

    `budgets` ((B,) int32) is each row's OWN generation budget (per-request
    max_new_tokens): `remaining` counts down from it, so slots inserted in
    the same batch can free at different steps — continuous batching's
    per-request granularity extends to the budget dimension.

    All scatters use mode="drop": the host inserts a prefilled batch in
    WAVES as slots free (rows not in this wave carry slot_id = S, out of
    bounds, and write nothing) — so a 32-row batch starts decoding on
    whatever slots exist instead of head-of-line blocking for all 32
    (the Poisson A/B's occupancy-0.52 finding)."""
    w = valid.shape[1]
    t = rows_k.shape[2]
    shift = jnp.mod(cursor - t, w)
    rk = jnp.pad(rows_k, ((0, 0), (0, 0), (0, w - t), (0, 0), (0, 0)))
    rv = jnp.pad(rows_v, ((0, 0), (0, 0), (0, w - t), (0, 0), (0, 0)))
    rk = jnp.roll(rk, shift, axis=2)
    rv = jnp.roll(rv, shift, axis=2)
    pool_k = pool_k.at[:, slot_ids].set(rk.astype(pool_k.dtype),
                                        mode="drop")
    pool_v = pool_v.at[:, slot_ids].set(rv.astype(pool_v.dtype),
                                        mode="drop")
    vrow = jnp.roll(jnp.pad(mask.astype(bool), ((0, 0), (0, w - t))),
                    shift, axis=1)
    vrow = vrow & row_valid[:, None]
    valid = valid.at[slot_ids].set(vrow, mode="drop")
    n_real = jnp.sum(mask.astype(jnp.int32), axis=-1)
    live = (row_valid & (budgets > 1)
            & ~token_is_eos(tok0, eos_ids))
    last_tok = last_tok.at[slot_ids].set(tok0, mode="drop")
    next_pos = next_pos.at[slot_ids].set(n_real, mode="drop")
    active = active.at[slot_ids].set(live, mode="drop")
    remaining = remaining.at[slot_ids].set(
        jnp.where(row_valid, budgets - 1, 0), mode="drop")
    return pool_k, pool_v, valid, last_tok, next_pos, active, remaining


class _Slot:
    __slots__ = ("request_id", "tokens", "deliver", "open", "t0", "budget")

    def __init__(self, request_id, deliver, t0, budget):
        self.request_id = request_id
        self.tokens: List[int] = []
        self.deliver = deliver
        self.open = True
        self.t0 = t0
        self.budget = budget   # this request's own max_new_tokens


class _RowSet:
    """A prefilled batch whose rows enter the pool in WAVES as slots free.
    Device tensors (k/v/mask/tok0/budgets) stay batch-shaped; each wave is
    one `_insert_rows` dispatch where rows outside the wave carry slot_id=S
    (out of bounds → mode='drop' writes nothing). `tok0_host` memoizes the
    (B,) transfer so multiple waves pay it once."""
    __slots__ = ("k", "v", "mask", "tok0", "tok0_host", "bud_dev", "metas",
                 "next", "n", "b")

    def __init__(self, k, v, mask, tok0, bud_dev, metas, n):
        self.k, self.v, self.mask, self.tok0 = k, v, mask, tok0
        self.tok0_host = None
        self.bud_dev = bud_dev
        self.metas = metas       # row index -> _Slot, rows [0, n)
        self.next = 0            # first not-yet-inserted row
        self.n = n
        self.b = mask.shape[0]


class DecodePool:
    """Host orchestrator for continuous batching. One worker thread owns ALL
    device dispatch (prefill, insert, decode chunks) — device work serializes
    anyway on one chip, and a single dispatcher keeps slot bookkeeping
    lock-free. `submit` is called from the batch processor's stage-2 and
    returns immediately; results are delivered per-request via the callback
    as each completes (better tail latency than batch-granular delivery)."""

    def __init__(self, engine, slots: int, window: int, chunk: int,
                 mesh=None):
        cfg = engine.dec_cfg
        self.engine = engine
        self.cfg = cfg
        self.slots = slots
        self.window = window
        self.chunk = chunk
        self.eos_ids = eos_id_set(cfg)
        self.max_new_tokens = engine.settings.max_new_tokens
        if self.max_new_tokens > window:
            raise ValueError(
                f"DECODE_WINDOW={window} cannot hold max_new_tokens="
                f"{self.max_new_tokens}")
        kv_dtype = engine.dtype
        shape = (cfg.num_layers, slots, window, cfg.num_kv_heads,
                 cfg.head_dim)

        # under a mesh the pool shards over the "data" axis on SLOTS —
        # decode is slot-local (attention reads only the slot's own ring
        # row), so the chunk program needs no cross-shard collectives for
        # the cache itself; GSPMD handles the tp-sharded weight matmuls
        # exactly as in the fixed path. Host bookkeeping is unchanged: the
        # (chunk, S) token block gathers on consumption.
        def _mk(value_fn, spec_axes):
            arr = value_fn()
            if mesh is None or mesh.devices.size == 1:
                return arr
            from jax.sharding import NamedSharding, PartitionSpec as P

            return jax.device_put(arr, NamedSharding(mesh, P(*spec_axes)))

        dp = 1 if mesh is None else mesh.shape.get("data", 1)
        if dp > 1 and slots % dp != 0:
            raise ValueError(
                f"DECODE_SLOTS={slots} must be a multiple of the mesh data "
                f"axis {dp}")
        slot_ax = "data" if dp > 1 else None
        self.pool_k = _mk(lambda: jnp.zeros(shape, kv_dtype),
                          (None, slot_ax, None, None, None))
        self.pool_v = _mk(lambda: jnp.zeros(shape, kv_dtype),
                          (None, slot_ax, None, None, None))
        self.valid = _mk(lambda: jnp.zeros((slots, window), bool),
                         (slot_ax, None))
        self.last_tok = _mk(
            lambda: jnp.full((slots,), cfg.pad_token_id, jnp.int32),
            (slot_ax,))
        self.next_pos = _mk(lambda: jnp.zeros((slots,), jnp.int32),
                            (slot_ax,))
        self.active = _mk(lambda: jnp.zeros((slots,), bool), (slot_ax,))
        self.remaining = _mk(lambda: jnp.zeros((slots,), jnp.int32),
                             (slot_ax,))
        self.cursor = jnp.int32(0)
        self._rng = jax.random.PRNGKey(
            int(engine.settings.max_new_tokens) * 7919 + slots)

        self._free = list(range(slots))
        self._meta: dict[int, _Slot] = {}
        self._tok0_pending: list[tuple] = []   # (slot_by_row, snapshot, _RowSet)
        self._chunk_pending: list = []          # (tok_dev (chunk, S), snapshot)
        self._pending_inserts: list = []        # staged submissions, pre-prefill
        self._pending_rows: list[_RowSet] = []  # prefilled, awaiting slot waves
        # how many prefilled row-sets may wait for slots (each holds a
        # batch-shaped (L, B, T, Hk, D) k/v pair in HBM — bound it)
        self._prefill_ahead = max(1, int(os.environ.get(
            "DECODE_PREFILL_AHEAD", "1")))
        # bounded: `submit` blocks past this depth — the backpressure that
        # keeps stage-1 from staging unbounded device tensors ahead of the
        # pool (the fixed path gets the same from FINALIZE_DEPTH)
        self._submit_q: "queue.Queue[tuple]" = queue.Queue(
            maxsize=max(2, int(os.environ.get("DECODE_SUBMIT_DEPTH", "4"))))
        self._running = False
        self._thread: threading.Thread | None = None
        self._idle = threading.Event()
        self._idle.set()
        # observability
        self.steps = 0
        self.completed = 0
        self.inserted = 0
        self.tokens_emitted = 0   # real tokens consumed from DECODE blocks
        self.tokens_prefill = 0   # tok0 tokens (sampled by prefill dispatch)
        logger.info(
            "decode pool: %d slots x window %d, chunk %d (%s KV, %.0f MB)",
            slots, window, chunk, np.dtype(kv_dtype).name,
            2 * np.prod(shape) * np.dtype(kv_dtype).itemsize / 2**20)

    # -- public API ------------------------------------------------------

    def submit(self, request_ids: list, prompts: list,
               deliver: Callable[[str, dict], None], staged=None) -> None:
        """Queue a prepared batch for prefill+insert. `deliver(request_id,
        result_dict)` fires once per request as it completes."""
        self._idle.clear()
        self._submit_q.put((request_ids, prompts, staged, deliver,
                            time.time()))

    def start(self) -> None:
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-pool")
        self._thread.start()

    def stop(self, drain_timeout: float = 0.0) -> None:
        if drain_timeout > 0:
            self.wait_idle(drain_timeout)
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def wait_idle(self, timeout: float) -> bool:
        """True once no submissions, inserts, or active slots remain."""
        return self._idle.wait(timeout)

    def stats(self) -> dict:
        return {"slots": self.slots, "free": len(self._free),
                "window": self.window, "chunk": self.chunk,
                "steps": self.steps, "inserted": self.inserted,
                "completed": self.completed,
                "tokens_emitted": self.tokens_emitted,
                "tokens_prefill": self.tokens_prefill,
                # mean fraction of DECODE slot-steps that produced a real
                # token — the quantity continuous batching improves vs the
                # fixed path's pay-max(batch) padding (1.0 = no waste);
                # prefill-sampled tok0 tokens are excluded from both sides
                "occupancy": round(self.tokens_emitted
                                   / max(1, self.steps * self.slots), 4),
                "pending_rows": sum(st.n - st.next
                                    for st in self._pending_rows),
                "pending_submits": self._submit_q.qsize()}

    def warm_insert(self, rows_k, mask) -> None:
        """Compile the insert program for one (B, T) rows shape using
        all-invalid rows: pool semantics unchanged (engine warmup)."""
        b = rows_k.shape[1]
        (self.pool_k, self.pool_v, self.valid, self.last_tok, self.next_pos,
         self.active, self.remaining) = _insert_rows(
            self.pool_k, self.pool_v, self.valid, self.last_tok,
            self.next_pos, self.active, self.remaining,
            rows_k, rows_k, mask,
            jnp.full((b,), self.cfg.pad_token_id, jnp.int32),
            jnp.arange(b, dtype=jnp.int32), self.cursor,
            jnp.zeros((b,), bool),
            jnp.full((b,), self.max_new_tokens, jnp.int32), self.eos_ids)

    def warm_chunk(self) -> None:
        """Compile + run the (single-shape) decode_chunk program on the
        all-inactive pool; only the ring cursor moves (position-free)."""
        self._rng, rng = jax.random.split(self._rng)
        s = self.engine.settings
        (self.pool_k, self.pool_v, self.valid, self.last_tok, self.next_pos,
         self.active, self.remaining, self.cursor, _toks) = decode_chunk(
            self.engine.dec_params, self.cfg, self.pool_k, self.pool_v,
            self.valid, self.last_tok, self.next_pos, self.active,
            self.remaining, self.cursor, rng, chunk=self.chunk,
            do_sample=s.do_sample, dtype=self.engine.dtype,
            eos_bias=s.eos_bias)

    # -- worker ----------------------------------------------------------

    def _loop(self) -> None:
        poll = 0.002
        while self._running:
            try:
                did = self._drain_submissions()
                busy = self._dispatch_chunk()
                # consume one dispatch behind: the pop blocks on tokens the
                # device (usually) already produced while we dispatched the
                # next chunk — device never waits on the host round trip
                lag = 1 if busy else 0
                self._consume(lag)
                if not (did or busy or self._chunk_pending
                        or self._tok0_pending or self._pending_rows
                        or self._pending_inserts):
                    if self._submit_q.empty():
                        self._idle.set()
                    time.sleep(poll)
            except Exception:
                logger.exception("decode-pool loop error")
                self._fail_all("decode pool internal error")
                time.sleep(0.1)
        # deliver whatever is in flight before exiting
        try:
            self._consume(0)
        except Exception:
            logger.exception("decode-pool drain error")

    def _drain_submissions(self) -> bool:
        """Stage, prefill, and wave-insert pending batches. Staging and
        prefill run AHEAD of slot availability (bounded), so by the time
        completions free slots the rows are sitting in HBM ready for a
        cheap scatter; rows then enter in waves sized to whatever slots
        exist — a 32-row batch never head-of-line blocks a half-empty pool
        (the Poisson A/B's occupancy-0.52 finding)."""
        # pull at most a couple of submissions ahead into staged form —
        # pulling eagerly would defeat the bounded submit queue's
        # backpressure (staged tensors live on device until inserted)
        while len(self._pending_inserts) < 2 and not self._submit_q.empty():
            request_ids, prompts, staged, deliver, t0 = \
                self._submit_q.get_nowait()
            if staged is None:
                try:
                    staged = self.engine.stage_prompts(prompts)
                except Exception as e:
                    logger.exception("staging failed; failing batch")
                    for rid in request_ids:
                        deliver(rid, {"error": str(e), "status": "failed"})
                    continue
            self._pending_inserts.append((request_ids, staged, deliver, t0))
        did = False
        while (self._pending_inserts
               and len(self._pending_rows) < self._prefill_ahead):
            request_ids, staged, deliver, t0 = self._pending_inserts.pop(0)
            try:
                self._prefill_batch(request_ids, staged, deliver, t0)
                did = True
            except Exception as e:
                logger.exception("prefill failed; failing batch")
                for rid in request_ids:
                    deliver(rid, {"error": str(e), "status": "failed"})
        while self._insert_wave():
            did = True
        return did

    def _staged_kv_len(self, staged) -> int:
        """Prompt-KV length T the staged batch will occupy in the pool."""
        if staged[0] == "packed":
            return self.engine.packed_p
        ids, metas = staged[1], staged[5]
        t = ids.shape[1]
        if metas is not None and any(m is not None for m in metas):
            t += self.engine.prefix_cache.pool_len
        return t

    def _prefill_batch(self, request_ids, staged, deliver, t0) -> None:
        engine = self.engine
        # gate on the batch's own max budget, not the engine-wide cap: a
        # long-prompt batch whose requests all carry small budgets still
        # fits the per-slot ring invariant (each live slot advances at most
        # its own budget-1 columns). Pad rows carry the cap but are born
        # done (they never advance), so only the n valid rows count.
        n_valid = staged[4]
        batch_budget = int(max(staged[-1][1][:max(1, n_valid)]))
        if self._staged_kv_len(staged) + batch_budget > self.window:
            # long-tail bucket the ring can't hold: run the FIXED path for
            # this batch (same staged tensors, same compiled programs the
            # standard warmup covers) — blocks the pool loop for one batch,
            # which is the honest cost of an undersized DECODE_WINDOW
            logger.warning(
                "staged KV %d + batch max budget %d exceeds window %d; "
                "falling back to fixed decode for this batch",
                self._staged_kv_len(staged), batch_budget, self.window)
            handle = engine.generate_tokens(staged=staged)
            for rid, ans in zip(request_ids, engine.finalize_tokens(handle)):
                deliver(rid, {"result": ans})
            self.completed += len(request_ids)
            return
        self._rng, rng = jax.random.split(self._rng)
        tok0, k, v, mask, n = engine.prefill_rows(staged, rng)
        bud_dev, bud_host = staged[-1]
        metas = [_Slot(request_ids[i], deliver, t0, bud_host[i])
                 for i in range(n)]
        self._pending_rows.append(_RowSet(k, v, mask, tok0, bud_dev,
                                          metas, n))

    def _insert_wave(self) -> bool:
        """Insert up to len(free) rows of the head prefilled row-set — one
        drop-mode `_insert_rows` dispatch; rows outside the wave write
        nothing (slot_id = S). Returns True if any row entered."""
        if not self._pending_rows or not self._free:
            return False
        st = self._pending_rows[0]
        take = min(len(self._free), st.n - st.next)
        if take <= 0:
            return False
        slot_ids = np.full((st.b,), self.slots, np.int32)   # S = dropped
        row_valid = np.zeros((st.b,), bool)
        assigned = []
        for r in range(st.next, st.next + take):
            s = self._free.pop()
            slot_ids[r] = s
            row_valid[r] = True
            assigned.append((r, s))
        (self.pool_k, self.pool_v, self.valid, self.last_tok, self.next_pos,
         self.active, self.remaining) = _insert_rows(
            self.pool_k, self.pool_v, self.valid, self.last_tok,
            self.next_pos, self.active, self.remaining,
            st.k, st.v, st.mask, st.tok0, jnp.asarray(slot_ids), self.cursor,
            jnp.asarray(row_valid), st.bud_dev, self.eos_ids)
        # snapshot binds row index -> _Slot OBJECT: by the time tok0 is
        # consumed, the slot id may already host a successor request
        snapshot = {}
        slot_by_row = [0] * st.b
        for r, s in assigned:
            m = st.metas[r]
            self._meta[s] = m
            snapshot[r] = m
            slot_by_row[r] = s
        self._tok0_pending.append((slot_by_row, snapshot, st))
        st.next += take
        self.inserted += take
        if st.next >= st.n:
            self._pending_rows.pop(0)
        return True

    def _dispatch_chunk(self) -> bool:
        """One decode_chunk dispatch when any slot might be live. The host's
        `_meta` (slots not yet delivered) over-approximates device `active`
        by at most the consumption lag, so a couple of no-op chunks at tail
        are the cost of never syncing eagerly."""
        if not self._meta:
            return False
        self._rng, rng = jax.random.split(self._rng)
        s = self.engine.settings
        (self.pool_k, self.pool_v, self.valid, self.last_tok, self.next_pos,
         self.active, self.remaining, self.cursor, toks) = decode_chunk(
            self.engine.dec_params, self.cfg, self.pool_k, self.pool_v,
            self.valid, self.last_tok, self.next_pos, self.active,
            self.remaining, self.cursor, rng, chunk=self.chunk,
            do_sample=s.do_sample, dtype=self.engine.dtype,
            eos_bias=s.eos_bias)
        # snapshot slot->_Slot at DISPATCH time: tokens in this block belong
        # to these request objects even if a slot is freed and reused before
        # the block is consumed (the successor's tokens ride later blocks)
        snapshot = {sl: m for sl, m in self._meta.items() if m.open}
        self._chunk_pending.append((toks, snapshot))
        self.steps += self.chunk
        return True

    def _consume(self, lag: int) -> None:
        """Materialize pending token blocks down to `lag` outstanding, apply
        EOS/budget bookkeeping, deliver completed requests, free slots.
        tok0 blocks drain fully first (chronologically a request's tok0
        precedes any chunk block dispatched after its insert; blocks
        dispatched BEFORE its insert don't contain it — snapshots bind
        tokens to request objects, not slot ids)."""
        while self._tok0_pending:
            slot_by_row, snapshot, st = self._tok0_pending.pop(0)
            if st.tok0_host is None:           # one (B,) transfer per batch,
                st.tok0_host = np.asarray(st.tok0)   # shared by all waves
            for i, m in snapshot.items():
                self._note_token(slot_by_row[i], m, int(st.tok0_host[i]),
                                 from_prefill=True)
        while len(self._chunk_pending) > lag:
            toks_dev, snapshot = self._chunk_pending.pop(0)
            toks = np.asarray(toks_dev)                     # (chunk, S)
            for step in range(toks.shape[0]):
                row = toks[step]
                for s, m in snapshot.items():
                    if m.open:
                        self._note_token(s, m, int(row[s]))

    def _note_token(self, slot: int, m: _Slot, tok: int,
                    from_prefill: bool = False) -> None:
        if not m.open:
            return
        if tok != self.cfg.pad_token_id and tok not in self.eos_ids:
            m.tokens.append(tok)
            # tok0 comes from the PREFILL dispatch, not a decode slot-step:
            # it must not inflate the decode-occupancy numerator (whose
            # denominator is steps * slots — decode-chunk slot-steps only)
            if from_prefill:
                self.tokens_prefill += 1
            else:
                self.tokens_emitted += 1
        done = (tok in self.eos_ids
                or len(m.tokens) >= m.budget)
        # a pad emission means the device already deactivated this slot
        # (defensive — EOS/budget should always be visible first)
        if tok == self.cfg.pad_token_id:
            done = True
        if done:
            m.open = False
            self._finish(slot, m)

    def _finish(self, slot: int, m: _Slot) -> None:
        if self._meta.get(slot) is m:
            self._meta.pop(slot)
            self._free.append(slot)
        self.completed += 1
        try:
            text = self.engine.dec_tok.decode(m.tokens)
            m.deliver(m.request_id, {"result": text})
        except Exception:
            logger.exception("decode-pool delivery failed for %s",
                             m.request_id)

    def _fail_all(self, msg: str) -> None:
        for slot in list(self._meta):
            m = self._meta.pop(slot)
            self._free.append(slot)
            try:
                m.deliver(m.request_id, {"error": msg, "status": "failed"})
            except Exception:
                pass
        self._tok0_pending.clear()
        self._chunk_pending.clear()
        # prefilled-but-not-inserted rows fail too (rows < next live in
        # _meta and were failed above)
        rowsets, self._pending_rows = self._pending_rows, []
        for st in rowsets:
            for m in st.metas[st.next:]:
                try:
                    m.deliver(m.request_id, {"error": msg,
                                             "status": "failed"})
                except Exception:
                    pass
        # staged-but-not-inserted and still-queued submissions must fail
        # too, or their clients hang until the request-poll TTL
        pending, self._pending_inserts = self._pending_inserts, []
        for request_ids, _staged, deliver, _t0 in pending:
            for rid in request_ids:
                try:
                    deliver(rid, {"error": msg, "status": "failed"})
                except Exception:
                    pass
        while not self._submit_q.empty():
            try:
                request_ids, _p, _s, deliver, _t0 = self._submit_q.get_nowait()
            except queue.Empty:
                break
            for rid in request_ids:
                try:
                    deliver(rid, {"error": msg, "status": "failed"})
                except Exception:
                    pass
