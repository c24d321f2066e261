"""The one place that maps the accelerator platform to implementations.

Every kernel choice in the serving path reads `kernels()`; nothing else in
the package branches on `jax.default_backend()`. A platform missing from the
table is an error, never a silent fallback to a slower path.

- ``gpu``: prompt, prefix + suffix and encoder attention through cuDNN's
  fused attention (`jax.nn.dot_product_attention(implementation="cudnn")`),
  packed prefill attention through the Pallas kernel compiled by Triton;
  warmup runs one program at a time.
- ``cpu``: the plain jnp paths (einsum attention, the dense packed
  reference), warmup on 8 threads. This is how the tests run; nothing here
  is interpreted.

Retrieval (GEMM + `lax.top_k`), sampling (`lax.top_k`) and the int8 matmuls
are plain XLA on every platform, so they have no entry.

The module also owns the process-level JAX set-up the entry points share:
XLA flags, the persistent compile cache and the platform requirement.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# the compile cache lives at a fixed path inside the checkout unless the
# environment names one: the path is part of the cache key, so a directory
# that moves between runs never hits
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


@dataclass(frozen=True)
class Kernels:
    # prompt self-attention (left-padded, causal), prefix + suffix attention
    # (additive mask) and the encoder's right-padded self-attention:
    # "cudnn" | "einsum"
    prefill_attention: str
    # block-diagonal causal attention over a packed token stream:
    # "pallas_triton" | "einsum"
    packed_attention: str
    # warmup programs compiled and first run at once. On an H100 the first
    # runs of several cuDNN-calling programs at the same time crashed the
    # process (segfaults; CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED) when their
    # executables came from the compile cache, so the GPU warms up serially
    warmup_workers: int


_TABLE = {
    "gpu": Kernels(prefill_attention="cudnn", packed_attention="pallas_triton",
                   warmup_workers=1),
    "cpu": Kernels(prefill_attention="einsum", packed_attention="einsum",
                   warmup_workers=8),
}


# XLA flags the program runs with (launcher configuration). Command buffers
# (CUDA graphs) are captured on a program's first run; the engine runs
# programs from several threads (parallel warmup compiles, stage-1 workers,
# dispatch), and a capture in one thread made another thread's cuDNN graph
# load fail with CUDA_ERROR_STREAM_CAPTURE_UNSUPPORTED on an H100. So they
# stay off until a measurement shows they are worth serializing first runs.
XLA_FLAGS = ("--xla_gpu_enable_command_buffer=",)


def configure_xla_flags() -> str:
    """Add XLA_FLAGS above to the environment, keeping any flag the
    environment already sets. Call before JAX creates its GPU client (the
    first jax.devices() or computation); later calls change nothing there.
    Returns the resulting XLA_FLAGS."""
    flags = os.environ.get("XLA_FLAGS", "")
    for flag in XLA_FLAGS:
        if flag.split("=")[0] not in flags:
            flags = f"{flags} {flag}".strip()
    os.environ["XLA_FLAGS"] = flags
    return flags


def kernels(platform: str | None = None) -> Kernels:
    """Implementations for `platform` (default: JAX's default backend).
    Raises on a platform this package has no kernels for."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return _TABLE[platform]
    except KeyError:
        raise RuntimeError(
            f"no kernels registered for platform {platform!r} "
            f"(known: {sorted(_TABLE)})") from None


def setup_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at `.jax_cache/` in the checkout,
    unless JAX_COMPILATION_CACHE_DIR is set — JAX reads that variable itself
    and this function then sets nothing. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_CACHE_DIR


def require_platform(platform: str) -> None:
    """Make JAX use `platform` ('gpu' | 'cpu'), failing if it cannot: the
    backend may already be initialized, or no such device may exist."""
    import jax

    kernels(platform)  # unknown platform -> RuntimeError
    jax.config.update("jax_platforms", platform)
    got = jax.default_backend()
    if got != platform:
        raise RuntimeError(
            f"requested platform {platform!r} but JAX runs on {got!r}")
