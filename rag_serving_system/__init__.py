"""rag_serving_system — a RAG serving framework in JAX.

A JAX/XLA re-design of the capabilities of ngray0/RAG-Serving-System
(reference layout: rag_service/), served on an NVIDIA GPU:

- backend.py the one platform -> kernel table, compile cache, platform check
- ops/       top-k retrieval, prefill attention (cuDNN, a Pallas kernel) and jnp oracles
- models/    e5 (XLM-RoBERTa-large) encoder + Qwen2.5 decoder as pure-JAX pytrees
- parallel/  device mesh, corpus sharding, distributed exact top-k merge
- core/      serving engine (jit bucketed pipelines), request queues, batch processor
- api/       asyncio HTTP surface (POST /rag, GET /rag/result/{id}, /health, /metrics)
- utils/     logging / timing / profiling helpers
"""

__version__ = "0.1.0"
