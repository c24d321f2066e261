# RAG service image for NVIDIA GPU nodes (reference: Dockerfile — python +
# CUDA CuPy; here: JAX with its CUDA 12 plugin).
FROM python:3.12-slim

WORKDIR /app

COPY requirements.txt ./
RUN pip install --no-cache-dir -r requirements.txt \
    && pip install --no-cache-dir "jax[cuda12]"

COPY rag_serving_system/ rag_serving_system/
COPY main.py bench.py chip_smoke.py ./
COPY data/ data/
COPY scripts/ scripts/
COPY benchmarks/ benchmarks/
# native host-path components are always built from source in-image
# (the .so is never shipped; see rag_serving_system/native/build.sh);
# the slim base has no toolchain, so install one for the build layer
RUN apt-get update \
    && apt-get install -y --no-install-recommends gcc g++ \
    && rm -f rag_serving_system/native/*.so \
    && bash rag_serving_system/native/build.sh \
    && apt-get purge -y gcc g++ && apt-get autoremove -y \
    && rm -rf /var/lib/apt/lists/*

# Pre-download HF snapshots at build time when network is available
# (reference Dockerfile:15-21); at runtime WEIGHTS_DIR/HF cache is probed and
# the service falls back to architecture-true random init if absent.
ARG PREFETCH_MODELS=0
RUN if [ "$PREFETCH_MODELS" = "1" ]; then \
      pip install --no-cache-dir transformers safetensors && \
      python -c "from transformers import AutoTokenizer, AutoModel; \
AutoTokenizer.from_pretrained('intfloat/multilingual-e5-large-instruct'); \
AutoModel.from_pretrained('intfloat/multilingual-e5-large-instruct'); \
AutoTokenizer.from_pretrained('Qwen/Qwen2.5-1.5B-Instruct')"; \
    fi

ENV HOST=0.0.0.0 \
    PORT=8000 \
    MAX_BATCH_SIZE=32 \
    MAX_WAIT_TIME=1.0 \
    POLLING_INTERVAL=0.3 \
    JAX_COMPILATION_CACHE_DIR=/xla-cache

EXPOSE 8000
CMD ["python", "main.py"]
