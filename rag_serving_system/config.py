"""Service configuration.

Keeps the reference's env-var contract (reference: rag_service/config.py:5-20) —
same variable names and defaults — so existing deployment manifests and the
autoscaler work unchanged, while adding knobs (mesh shape, shape buckets,
dtype) that have no reference equivalent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _parse_int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


@dataclass
class Settings:
    """Env-driven settings (reads a `.env` file if present)."""

    host: str = field(default_factory=lambda: _env("HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: int(_env("PORT", "8000")))

    # Batching (reference: rag_service/config.py:8-10)
    max_batch_size: int = field(default_factory=lambda: int(_env("MAX_BATCH_SIZE", "32")))
    max_wait_time: float = field(default_factory=lambda: float(_env("MAX_WAIT_TIME", "1.00")))
    polling_interval: float = field(default_factory=lambda: float(_env("POLLING_INTERVAL", "0.3")))

    # Data artifacts (reference: rag_service/config.py:11-13)
    document_text_file: str = field(
        default_factory=lambda: _env("DOCUMENT_TEXT_FILE", "data/short_facts_contexts.json"))
    document_embeddings_file: str = field(
        default_factory=lambda: _env("DOCUMENT_EMBEDDINGS_FILE", "data/short_facts_embeddings.npy"))
    document_queries_file: str = field(
        default_factory=lambda: _env("DOCUMENT_QUERIES_FILE", "data/short_facts_queries.json"))

    # Models (reference: rag_service/config.py:14-15)
    embed_model_name: str = field(
        default_factory=lambda: _env("EMBED_MODEL_NAME", "intfloat/multilingual-e5-large-instruct"))
    llm_model_name: str = field(
        default_factory=lambda: _env("LLM_MODEL_NAME", "Qwen/Qwen2.5-1.5B-Instruct"))

    # Queue backend: Redis iff REDIS_URL set (reference: main.py:35-49)
    redis_url: Optional[str] = field(default_factory=lambda: os.environ.get("REDIS_URL"))

    # ---- knobs with no reference equivalent ----
    # 'gpu' | 'cpu' | '' (auto: JAX's default backend). A named platform
    # that JAX cannot use stops start-up (backend.require_platform)
    platform: str = field(default_factory=lambda: _env("JAX_SERVE_PLATFORM", ""))
    # compute dtype for model forward passes
    dtype: str = field(default_factory=lambda: _env("COMPUTE_DTYPE", "bfloat16"))
    # batch-size buckets the engine compiles for (padded fixed shapes for XLA)
    batch_buckets: List[int] = field(
        default_factory=lambda: _parse_int_list(_env("BATCH_BUCKETS", "1,2,4,8,16,32")))
    # encoder sequence-length buckets
    encode_len_buckets: List[int] = field(
        default_factory=lambda: _parse_int_list(_env("ENCODE_LEN_BUCKETS", "32,64,128,256,512")))
    # generator prompt-length buckets
    prompt_len_buckets: List[int] = field(
        default_factory=lambda: _parse_int_list(_env("PROMPT_LEN_BUCKETS", "128,256,512,1024")))
    # PACKED prefill for no-prefix batches (cold path): the batch's real
    # tokens run back-to-back in one (1, T) stream instead of a padded
    # (B, P) grid — matmul FLOPs and elementwise HBM traffic scale with
    # sum(len) (measured ~50% pad waste on squad_real at batch 32).
    # Exact (bit-identical decode); PACKED_PREFILL=0 restores padded prefill.
    packed_prefill: bool = field(
        default_factory=lambda: _env("PACKED_PREFILL", "1").lower() not in ("0", "false"))
    # packed-stream length bucket step (compiled T shapes are multiples of
    # this, rounded up to a multiple of 256)
    packed_t_step: int = field(
        default_factory=lambda: int(_env("PACKED_T_STEP", "1024")))
    max_new_tokens: int = field(default_factory=lambda: int(_env("MAX_NEW_TOKENS", "10")))
    # decode scheduling: 'fixed' (one lax.while_loop per batch — a batch
    # completes when its slowest row does) | 'continuous' (in-flight
    # batching over a persistent slot pool, core/decode_pool.py: rows
    # complete and free their slot individually, new requests join without
    # waiting for a batch to drain — reclaims completion-length variance in
    # decode-heavy regimes; under a mesh the slot axis dp-shards over "data")
    decode_mode: str = field(default_factory=lambda: _env("DECODE_MODE", "fixed"))
    # slot-pool size (0 = auto: 2x the largest batch bucket)
    decode_slots: int = field(default_factory=lambda: int(_env("DECODE_SLOTS", "0")))
    # decode steps per XLA dispatch in continuous mode (amortizes the host
    # round trip; EOS frees slots at chunk granularity)
    decode_chunk: int = field(default_factory=lambda: int(_env("DECODE_CHUNK", "8")))
    # ring window per slot in tokens (0 = auto: largest prompt bucket +
    # max_new_tokens, rounded up to 128); batches staging more KV than the
    # window fall back to fixed decode
    decode_window: int = field(default_factory=lambda: int(_env("DECODE_WINDOW", "0")))
    # sampling on by default (reference: batch_processor.py:105 do_sample=True);
    # greedy mode gives deterministic output for parity tests / debugging
    do_sample: bool = field(
        default_factory=lambda: _env("DO_SAMPLE", "1").lower() not in ("0", "false"))
    # speculative decode draft length (greedy only; 0 = off): per decode
    # iteration, SPEC_DECODE history-lookup drafts are verified in one
    # multi-position forward — 1..gamma+1 tokens per decoder weight stream,
    # greedy-output-preserving in exact arithmetic (models/qwen2.py
    # _spec_decode_loop; f32-pinned — at bf16 a random-init model's near-tie
    # argmaxes can flip). Ignored when DO_SAMPLE is on;
    # only pays off with trained weights (acceptance = context copying).
    spec_gamma: int = field(default_factory=lambda: int(_env("SPEC_DECODE", "0")))
    # EOS logit bias (workload-shaping knob, default 0 = off): positive
    # values under sampling give geometric-ish completion lengths — the
    # controlled completion-length variance the continuous-batching A/B
    # needs, since random-init weights never emit EOS (models/qwen2.py
    # bias_eos). Not a production knob.
    eos_bias: float = field(default_factory=lambda: float(_env("EOS_BIAS", "0")))
    # retrieval: fixed compiled k (per-request k <= max_k sliced on host,
    # mirroring the reference's fixed-max_k trick, reference retriever.py:744-769)
    max_k: int = field(default_factory=lambda: int(_env("MAX_K", "16")))
    # mesh: "dp,tp" sizes; empty = single flat data axis over all devices
    mesh_shape: str = field(default_factory=lambda: _env("MESH_SHAPE", ""))
    # load real HF weights if a local snapshot exists; else deterministic random init
    weights_dir: Optional[str] = field(default_factory=lambda: os.environ.get("WEIGHTS_DIR"))
    # model size preset for offline/random-init mode: 'full' | 'tiny'
    model_preset: str = field(default_factory=lambda: _env("MODEL_PRESET", "full"))
    # corpus dtype for retrieval: 'float32' (oracle-exact, default)
    # | 'bfloat16' (half the bytes streamed per query batch; near-tie order
    # may differ from the f32 oracle) | 'int8' (a quarter of the bytes,
    # mean-centered per-row quantization — f32-parity task recall on real
    # e5 embeddings, fits 10M-doc corpora in one card's memory;
    # single-device only)
    retrieval_corpus_dtype: str = field(
        default_factory=lambda: _env("RETRIEVAL_CORPUS_DTYPE", "float32"))
    # int8 corpora larger than this many rows split into per-chunk top-k
    # programs: chunks bound the (B, rows) score matrix on the device and
    # the float32 quantization transients on the host
    topk_chunk_rows: int = field(
        default_factory=lambda: int(_env("TOPK_CHUNK_ROWS", str(4_194_304))))
    # retrieval engine: "exact" (default — GEMM + top-k over the whole
    # corpus) or "ivf" (approximate inverted-file scan,
    # O(C + nprobe*cap) rows/query — the capacity escape hatch past the
    # exact regime; single-device only, recall-gated at startup)
    retriever: str = field(
        default_factory=lambda: _env("RETRIEVER", "exact"))
    # IVF knobs: clusters (0 = auto ~4*sqrt(N)), probes per query, and the
    # startup recall@k gate vs exact search on sampled corpus queries —
    # an index below the gate refuses to serve (misconfigured nprobe or
    # unclusterable embeddings; see ops/ivf.py "honest regime notes")
    ivf_clusters: int = field(
        default_factory=lambda: int(_env("IVF_CLUSTERS", "0")))
    ivf_nprobe: int = field(
        default_factory=lambda: int(_env("IVF_NPROBE", "8")))
    ivf_recall_gate: float = field(
        default_factory=lambda: float(_env("IVF_RECALL_GATE", "0.9")))
    # exact prefix-KV caching of repeated RAG contexts (core/prefix_cache.py):
    # retrieval is deterministic, so the "Context:\n..." prefix repeats across
    # requests; cache its KV and prefill only the question suffix
    prefix_cache: bool = field(
        default_factory=lambda: _env("PREFIX_CACHE", "1").lower() not in ("0", "false"))
    # fixed token length of each cached prefix entry (static XLA shape);
    # longer contexts cache their first PREFIX_POOL_LEN tokens. Unset =
    # AUTO: the engine sizes the pool from corpus statistics (max of
    # sampled 2-doc context prefixes, rounded up to 128, clamped to 768)
    # so typical suffixes collapse to the question-only bucket instead of
    # prefilling each context's overflow tail per request
    prefix_pool_len: Optional[int] = field(
        default_factory=lambda: (int(os.environ["PREFIX_POOL_LEN"])
                                 if os.environ.get("PREFIX_POOL_LEN")
                                 else None))
    # device-memory budget for the prefix cache (LRU beyond this)
    prefix_cache_mb: int = field(
        default_factory=lambda: int(_env("PREFIX_CACHE_MB", "2048")))
    # adaptive thrash bypass: when the rolling hit rate over the last
    # PREFIX_ADAPTIVE_WINDOW lookups falls below PREFIX_ADAPTIVE_LOW, skip
    # the prefix path for all but every PREFIX_PROBE_EVERY-th batch (probes
    # re-engage the cache automatically when the workload becomes cacheable)
    prefix_adaptive: bool = field(
        default_factory=lambda: _env("PREFIX_ADAPTIVE", "1").lower() not in ("0", "false"))
    prefix_adaptive_window: int = field(
        default_factory=lambda: int(_env("PREFIX_ADAPTIVE_WINDOW", "512")))
    prefix_adaptive_low: float = field(
        default_factory=lambda: float(_env("PREFIX_ADAPTIVE_LOW", "0.25")))
    prefix_probe_every: int = field(
        default_factory=lambda: int(_env("PREFIX_PROBE_EVERY", "8")))
    # entry storage: 'compute' (engine dtype — bit-exact reuse) | 'int8'
    # (half the memory per entry → ~2x capacity; standard KV quantization,
    # not bit-exact)
    prefix_cache_dtype: str = field(
        default_factory=lambda: _env("PREFIX_CACHE_DTYPE", "compute"))
    # exact query-result cache: retrieval is deterministic (fixed corpus +
    # encoder weights), so an identical query string always retrieves the
    # identical top-max_k index list — cache it by exact text and skip the
    # encode+retrieve dispatch (and its host-synced index transfer) on hits.
    # Entries are a few hundred bytes; 0 disables. Miss overhead is two dict
    # operations, so no adaptive bypass is needed (unlike the prefix-KV
    # cache, whose miss path costs device work).
    query_cache_size: int = field(
        default_factory=lambda: int(_env("QUERY_CACHE_SIZE", "8192")))
    # weight-only quantization for the decoder: 'none' | 'int8' | 'int4'
    # (int4 = group-128 matmul weights + int8 embed/head; see ops/quant.py)
    quant_weights: str = field(default_factory=lambda: _env("QUANT_WEIGHTS", "none"))
    # activation quantization for the PREFILL matmuls (W8A8: s8 x s8 -> s32
    # dots): 'none' | 'int8'; requires quant_weights=int8
    quant_act: str = field(default_factory=lambda: _env("QUANT_ACT", "none"))


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader (KEY=VALUE lines; does not override existing env)."""
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip().strip('"').strip("'")
            os.environ.setdefault(key, value)


def get_settings() -> Settings:
    load_dotenv()
    return Settings()
