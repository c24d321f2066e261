"""Background batch processor: drains the queue, runs the engine, stores results.

Same role and lifecycle as the reference's `BatchProcessor(threading.Thread)`
(reference: rag_service/core/batch_processor.py:15-69): daemon thread, loop of
`get_batch()` → pipeline → `store_result`, error isolation per request and per
batch so clients never hang (batch_processor.py:108-125).

Differences:
- the pipeline is RagEngine's jit-compiled path (fixed-shape padded buckets);
- per-stage timings are recorded for /metrics and jax.profiler hooks.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time

from rag_serving_system.core.engine import RagEngine

logger = logging.getLogger(__name__)


class BatchProcessor(threading.Thread):
    """Two-stage pipeline: a prefetcher thread forms batches from the queue
    while the device crunches the current one, so the get_batch wait
    (MAX_WAIT_TIME) overlaps device compute instead of stalling it."""

    def __init__(self, request_queue, engine: RagEngine,
                 polling_interval: float = 0.3, prefetch: bool = True,
                 length_aware: bool = True):
        super().__init__(daemon=True)
        self.request_queue = request_queue
        self.engine = engine
        self.polling_interval = polling_interval
        self.prefetch = prefetch
        self.length_aware = length_aware
        # STAGE_PROMPTS=1 tokenizes+device_puts prompt batches on the
        # prefetch thread instead of inside the dispatch call; the extra
        # thread's transfers contend with stage-2 dispatch on the GIL and
        # the dispatch lock, so it is off by default (not measured on the
        # GPU yet).
        import os
        self.stage_on_prefetch = os.environ.get("STAGE_PROMPTS", "0") == "1"
        self.running = False
        self._busy = False            # stage-2 executing
        self._stage1_count = 0        # prefetch threads holding dequeued batches
        self._stage1_lock = threading.Lock()
        # stage-1 (embed+retrieve+prompt build) workers: with long prompts
        # stage 1 can limit the pipeline (each batch pays a host-synced
        # retrieval transfer — one host-device round trip — plus tokenize),
        # so PREFETCH_WORKERS=2 overlaps two batches' stage-1 with device
        # generate. Caveat: concurrent get_batch calls can split
        # the queue into partial batches, whose buckets engine.warmup()
        # compiles — an ad-hoc engine that skipped warmup just pays a
        # one-time compile mid-run.
        self.prefetch_workers = max(1, int(os.environ.get(
            "PREFETCH_WORKERS", "2"))) if prefetch else 0
        # depth of the prepared-batch pipeline between stage 1 and stage 2;
        # 0 keeps queue.Queue's unbounded semantics; otherwise at least one
        # ready slot per stage-1 worker so they don't serialize on handoff
        depth = int(os.environ.get("READY_DEPTH", "1"))
        self._ready: "queue.Queue[tuple]" = queue.Queue(
            maxsize=0 if depth == 0 else max(depth, self.prefetch_workers))
        self._pending = None          # deferred (request_ids, token handle)
        # FINALIZE_ASYNC=1 (default): a dedicated worker blocks on the
        # device→host token transfer + detokenize + store, so the dispatch
        # thread never pays the host-device transfer round trip. The bounded
        # queue is the pipeline's backpressure: at most
        # FINALIZE_DEPTH dispatched-but-unfinalized batches in flight keeps
        # the device busy without unbounded result latency.
        self.finalize_async = os.environ.get("FINALIZE_ASYNC", "1") == "1"
        self._finalize_q: "queue.Queue[tuple]" = queue.Queue(
            maxsize=max(1, int(os.environ.get("FINALIZE_DEPTH", "2"))))
        # rolling stats for observability
        self.batches_processed = 0
        self.requests_processed = 0
        self.last_batch_seconds = 0.0

    @property
    def ready_backlog(self) -> int:
        """Batches staged by stage-1 workers, awaiting dispatch."""
        return self._ready.qsize()

    @property
    def finalize_backlog(self) -> int:
        """Dispatched batches awaiting the finalize worker (async mode)."""
        return self._finalize_q.qsize()

    def _prefetch_loop(self, ready: "queue.Queue") -> None:
        """Form the next batch AND run pipeline stage 1 (embed + retrieve +
        prompt build) while the main thread generates the current batch.
        On a single device the XLA programs still serialize, but all host
        work, dispatch latency, and the get_batch wait hide under decode.

        Length-aware regrouping: prompt length is dominated by the retrieved
        CONTEXTS (unknown until stage 1), and prefill pads every row to the
        batch max — one long prompt drags a whole batch into the next
        sequence bucket. When the queue is deep enough for two batches, both
        are prepared together and their prompts re-partitioned by token
        length, so short-prompt batches prefill in a small bucket instead of
        paying for the longest row of an arbitrary FIFO slice. Reordering is
        bounded to this two-batch window (no starvation)."""
        while self.running:
            try:
                batch = self.request_queue.get_batch()
                if not batch:
                    time.sleep(self.polling_interval)
                    continue
                with self._stage1_lock:
                    self._stage1_count += 1
                try:
                    cap = getattr(self.request_queue, "max_batch_size", len(batch))
                    if (self.length_aware and len(batch) == cap
                            and self.request_queue.queue_size() >= cap):
                        batch += self.request_queue.get_batch()
                    queries = [req["query"] for req in batch]
                    ks = [req.get("k", 2) for req in batch]
                    budgets = [req.get("max_new_tokens") for req in batch]
                    prompts = self.engine.prepare(queries, ks, budgets)
                    stage = (getattr(self.engine, "stage_prompts", None)
                             if self.stage_on_prefetch else None)
                    if len(batch) > cap:
                        # PromptSpec.sort_len orders by SUFFIX length when a
                        # prefix-KV cache handles the context part. Budget
                        # first: the fixed decode pays max(batch budgets)
                        # steps per batch, so grouping short-budget requests
                        # together saves whole decode steps — with uniform
                        # budgets (the default) the key degenerates to the
                        # pure length sort, unchanged behavior
                        cap_mnt = getattr(
                            getattr(self.engine, "settings", None),
                            "max_new_tokens", 1 << 30)

                        def _key(i):
                            b = getattr(prompts[i], "gen_budget", None)
                            return (cap_mnt if b is None else b,
                                    getattr(prompts[i], "sort_len",
                                            len(prompts[i])))

                        order = sorted(range(len(batch)), key=_key)
                        for lo in range(0, len(order), cap):
                            grp = order[lo:lo + cap]
                            gp = [prompts[i] for i in grp]
                            ready.put(([batch[i] for i in grp], gp,
                                       stage(gp) if stage else None))
                    else:
                        # bounded: blocks at 1 in flight
                        ready.put((batch, prompts,
                                   stage(prompts) if stage else None))
                except Exception as e:
                    logger.exception("stage-1 error; failing batch")
                    for req in batch:
                        self.request_queue.store_result(
                            req["id"], {"error": str(e), "status": "failed"})
                finally:
                    with self._stage1_lock:
                        self._stage1_count -= 1
            except Exception:
                logger.exception("prefetch loop error")
                time.sleep(self.polling_interval)

    def _finalize_loop(self) -> None:
        """Drain dispatched batches: wait out the device, transfer tokens,
        detokenize, store. The transfer wait releases the GIL, so on a
        single-core host this thread costs only the (small) detok/store CPU
        while hiding the host-device round trip from the dispatch loop.

        Exits only on the run()-exit sentinel — never on a timing race — so
        a batch dispatched concurrently with shutdown still gets delivered,
        and any exception is swallowed here (not just inside
        _finalize_and_store, whose own error path can throw if the result
        backend is down): a dead finalize worker would wedge the dispatch
        loop on the bounded put."""
        while True:
            item = self._finalize_q.get()
            try:
                if item is None:  # shutdown sentinel from run()
                    return
                ids, handle, t0 = item
                self._finalize_and_store(ids, handle)
                # dispatch→delivered latency of the batch (the /stats gauge)
                self.last_batch_seconds = time.time() - t0
                self.batches_processed += 1
                self.requests_processed += len(ids)
            except Exception:  # keep the pipeline alive no matter what
                logger.exception("finalize worker error; batch dropped")
            finally:
                self._finalize_q.task_done()

    def run(self) -> None:
        self.running = True
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None and not pool._running:
            pool.start()
        logger.info("BatchProcessor started (prefetch=%s, decode=%s).",
                    self.prefetch,
                    "continuous" if pool is not None else "fixed")
        ready = self._ready
        if self.prefetch:
            self._prefetchers = []
            for _ in range(self.prefetch_workers):
                t = threading.Thread(target=self._prefetch_loop, args=(ready,),
                                     daemon=True)
                t.start()
                self._prefetchers.append(t)
            if self.finalize_async:
                self._finalizer = threading.Thread(
                    target=self._finalize_loop, daemon=True)
                self._finalizer.start()
        while self.running:
            try:
                t0 = time.time()
                if self.prefetch:
                    try:
                        batch, prompts, staged = ready.get(
                            timeout=self.polling_interval)
                    except queue.Empty:
                        # idle: deliver any deferred results immediately so
                        # low-traffic latency stays bounded by poll interval
                        self._flush_pending()
                        continue
                    self._busy = True
                    try:
                        self._generate_and_store(batch, prompts, staged)
                    finally:
                        ready.task_done()  # pairs with put(); drives drain accounting
                else:
                    batch = self.request_queue.get_batch()
                    if not batch:
                        time.sleep(self.polling_interval)
                        continue
                    self._busy = True
                    self._process_batch(batch)
                self._busy = False
                if self.prefetch and self.finalize_async:
                    # delivered-batch counters and the latency gauge belong
                    # to the finalize worker in async mode — this loop only
                    # dispatched
                    logger.info("dispatched batch of %d in %.3fs",
                                len(batch), time.time() - t0)
                else:
                    self.last_batch_seconds = time.time() - t0
                    self.batches_processed += 1
                    self.requests_processed += len(batch)
                    logger.info("processed batch of %d in %.3fs",
                                len(batch), self.last_batch_seconds)
            except Exception:  # keep serving no matter what (reference bp.py:68)
                self._busy = False
                logger.exception("batch loop error")
        if self.prefetch and self.finalize_async:
            # sentinel AFTER the last put (both happen on this thread): the
            # worker drains every dispatched batch, then exits — no timing
            # race can strand a batch
            self._finalize_q.put(None)
        self._flush_pending()  # deliver the last deferred batch on shutdown
        logger.info("BatchProcessor stopped.")

    def _generate_and_store(self, batch: list, prompts: list,
                            staged=None) -> None:
        """Pipeline stage 2: dispatch generation for THIS batch (async on
        device), then deliver the PREVIOUS batch's results while the device
        runs — token transfer/detokenize/store never stall the device.
        With `staged` (device-resident prompt tensors prepared by the
        prefetch thread), the dispatch here is latency-free host work."""
        request_ids = [req["id"] for req in batch]
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None:
            # continuous mode: hand the prepared batch to the decode pool —
            # results deliver PER REQUEST as each completes (no batch-drain
            # wait); the pool's worker owns all further device dispatch
            t0 = time.time()
            remaining = {"n": len(request_ids)}

            def deliver(rid, res):
                try:
                    self.request_queue.store_result(rid, res)
                except Exception as e:
                    logger.error("error storing result for %s: %s", rid, e)
                self.requests_processed += 1
                remaining["n"] -= 1
                if remaining["n"] == 0:
                    self.batches_processed += 1
                    self.last_batch_seconds = time.time() - t0

            pool.submit(request_ids, prompts, deliver, staged=staged)
            return
        try:
            handle = self.engine.generate_tokens(prompts, staged=staged)
            if self.finalize_async:
                # blocks only when FINALIZE_DEPTH batches are already in
                # flight — the backpressure that bounds result latency
                self._finalize_q.put((request_ids, handle, time.time()))
                return
            pending, self._pending = self._pending, (request_ids, handle)
            if pending is not None:
                self._finalize_and_store(*pending)
        except Exception as e:
            logger.exception("stage-2 error for batch %s", request_ids)
            for rid in request_ids:
                self.request_queue.store_result(
                    rid, {"error": str(e), "status": "failed"})
            if self.finalize_async:
                # this batch never reaches the finalize worker, but its
                # (error) results WERE delivered — count it so /stats doesn't
                # undercount during incidents (the sync path counts in run())
                self.batches_processed += 1
                self.requests_processed += len(request_ids)

    def _finalize_and_store(self, request_ids: list, handle) -> None:
        try:
            # in the pipelined path this is where generation time is actually
            # PAID (the dispatch above returns immediately): waiting out the
            # device plus the token transfer + detokenize. Recorded as the
            # "generate" stage so /stats reflects steady-state serving — the
            # serial engine.process path records the same stage name.
            timer = getattr(self.engine, "timer", None)
            with (timer.stage("generate") if timer is not None
                  else contextlib.nullcontext()):
                answers = self.engine.finalize_tokens(handle)
            for rid, ans in zip(request_ids, answers):
                try:
                    self.request_queue.store_result(rid, {"result": ans})
                except Exception as e:
                    logger.error("error storing result for %s: %s", rid, e)
        except Exception as e:
            logger.exception("finalize error for batch %s", request_ids)
            for rid in request_ids:
                self.request_queue.store_result(
                    rid, {"error": str(e), "status": "failed"})

    def _flush_pending(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            self._finalize_and_store(*pending)

    def _process_batch(self, batch: list) -> None:
        request_ids = [req["id"] for req in batch]
        try:
            queries = [req["query"] for req in batch]
            ks = [req.get("k", 2) for req in batch]
            budgets = [req.get("max_new_tokens") for req in batch]
            results = self.engine.process(queries, ks, budgets)
            for rid, res in zip(request_ids, results):
                try:
                    self.request_queue.store_result(rid, res)
                except Exception as e:
                    logger.error("error storing result for %s: %s", rid, e)
        except Exception as e:
            logger.exception("error processing batch %s", request_ids)
            for rid in request_ids:
                self.request_queue.store_result(
                    rid, {"error": str(e), "status": "failed"})

    def stop(self, drain_timeout: float = 0.0) -> None:
        """Stop the loops. With drain_timeout > 0, wait up to that long for
        already-dequeued work (the in-flight batch plus one prefetched batch)
        to finish so accepted requests aren't lost. Items still sitting in
        the request queue survive a restart under Redis — losing them in
        in-memory mode is the same at-most-once tradeoff the reference's
        BLPOP path has (SURVEY §5)."""
        deadline = time.time() + drain_timeout
        while time.time() < deadline and (
                self._busy or self._stage1_count > 0
                or self._ready.unfinished_tasks > 0
                or self._finalize_q.unfinished_tasks > 0):
            time.sleep(0.02)
        pool = getattr(self.engine, "decode_pool", None)
        if pool is not None:
            pool.stop(drain_timeout=max(0.0, deadline - time.time())
                      if drain_timeout > 0 else 0.0)
        self.running = False
        # dispatched-but-unfinalized batches always get delivered (the
        # finalize worker only exits on run()'s post-loop sentinel); give
        # them a bounded window here so results exist when stop() returns
        # (device work already paid — only the transfer remains)
        deadline = time.time() + 5.0
        while (time.time() < deadline
               and self._finalize_q.unfinished_tasks > 0):
            time.sleep(0.02)
        # join the stage-1 workers so callers can tear down whatever backs
        # the request queue (e.g. a test's miniredis) without the workers'
        # final BLPOP hitting a dead socket (they poll with a 0.1 s timeout,
        # so this bounds at ~one poll interval per worker)
        for t in getattr(self, "_prefetchers", []):
            t.join(timeout=2.0)
        # run() flushes the deferred batch on exit; if the thread was never
        # started (or already dead), deliver it here so nothing is lost
        if not self.is_alive():
            self._flush_pending()
