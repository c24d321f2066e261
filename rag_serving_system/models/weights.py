"""Weight initialization and HF-checkpoint loading.

Two paths:
1. `load_encoder_params` / `load_decoder_params`: map a local HF safetensors
   snapshot (XLM-RoBERTa / Qwen2 naming) onto our pytree layout. HF `nn.Linear`
   stores weights (out, in); we transpose to (in, out) for `x @ W`.
2. `init_encoder_params` / `init_decoder_params`: deterministic random init at
   the exact architecture sizes — used offline (no HF hub access) so tests and
   benchmarks exercise the true compute/memory footprint.

The reference pre-downloads its checkpoints at image build time
(reference: Dockerfile:15-21); here WEIGHTS_DIR points at such a snapshot.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from rag_serving_system.models.configs import DecoderConfig, EncoderConfig


# ---------------------------------------------------------------------------
# Random init (deterministic, architecture-true)
# ---------------------------------------------------------------------------

def _trunc_normal(key, shape, std=0.02, dtype=jnp.float32):
    """Plain normal clipped to ±2σ — same distribution family/scale as HF's
    trunc_normal init. jax.random.truncated_normal's rejection-free inverse-CDF
    lowering compiles to a much bigger program (erfinv chains); for benchmark
    weights only the SHAPES/dtypes matter, and clip is compile-cheap."""
    x = jax.random.normal(key, shape, jnp.float32)
    return (jnp.clip(x, -2.0, 2.0) * std).astype(dtype)


def _stacked(key, n_layers, shape, dtype):
    """One device op for all layers of a given weight kind (~1 dispatch
    instead of n_layers)."""
    return _trunc_normal(key, (n_layers,) + shape, dtype=dtype)


def init_encoder_params(cfg: EncoderConfig, seed: int = 0, dtype=jnp.bfloat16) -> dict:
    key = jax.random.PRNGKey(seed)
    keys = iter(jax.random.split(key, 16))
    h, ff, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    return {
        "embed": {
            "word": _trunc_normal(next(keys), (cfg.vocab_size, h), dtype=dtype),
            "pos": _trunc_normal(next(keys), (cfg.max_position_embeddings, h), dtype=dtype),
            "type": _trunc_normal(next(keys), (cfg.type_vocab_size, h), dtype=dtype),
            "ln_scale": jnp.ones((h,), dtype),
            "ln_bias": jnp.zeros((h,), dtype),
        },
        # layer weights STACKED on a leading L axis — the forward `lax.scan`s
        # over them, so the XLA program contains ONE layer body instead of L
        # unrolled copies (compile time; see models/qwen2.py module docstring)
        "layers": {
            "qkv_w": _stacked(next(keys), L, (h, 3 * h), dtype),
            "qkv_b": jnp.zeros((L, 3 * h), dtype),
            "o_w": _stacked(next(keys), L, (h, h), dtype),
            "o_b": jnp.zeros((L, h), dtype),
            "attn_ln_scale": jnp.ones((L, h), dtype),
            "attn_ln_bias": jnp.zeros((L, h), dtype),
            "ff_w1": _stacked(next(keys), L, (h, ff), dtype),
            "ff_b1": jnp.zeros((L, ff), dtype),
            "ff_w2": _stacked(next(keys), L, (ff, h), dtype),
            "ff_b2": jnp.zeros((L, h), dtype),
            "ff_ln_scale": jnp.ones((L, h), dtype),
            "ff_ln_bias": jnp.zeros((L, h), dtype),
        },
    }


def init_decoder_params(cfg: DecoderConfig, seed: int = 1, dtype=jnp.bfloat16) -> dict:
    key = jax.random.PRNGKey(seed)
    keys = iter(jax.random.split(key, 16))
    h, L = cfg.hidden_size, cfg.num_layers
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    ff = cfg.intermediate_size
    params = {
        "embed": _trunc_normal(next(keys), (cfg.vocab_size, h), dtype=dtype),
        # stacked (L, ...) leaves — scanned over, not unrolled (see encoder)
        "layers": {
            "ln1": jnp.ones((L, h), dtype),
            "qkv_w": _stacked(next(keys), L, (h, qd + 2 * kvd), dtype),
            "o_w": _stacked(next(keys), L, (qd, h), dtype),
            "ln2": jnp.ones((L, h), dtype),
            "gu_w": _stacked(next(keys), L, (h, 2 * ff), dtype),
            "down_w": _stacked(next(keys), L, (ff, h), dtype),
        },
        "ln_f": jnp.ones((h,), dtype),
    }
    if cfg.qkv_bias:
        params["layers"]["qkv_b"] = jnp.zeros((L, qd + 2 * kvd), dtype)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _trunc_normal(next(keys), (h, cfg.vocab_size), dtype=dtype)
    return params


def stack_layer_dicts(layer_list: list[dict], dtype) -> dict:
    """[{k: np (..)}, ...] per-layer dicts → {k: jnp (L, ...)} stacked.
    One host-side np.stack + one host→device transfer per weight kind
    (L transfers per kind would each pay a host-device round trip)."""
    return {k: jnp.asarray(np.stack([l[k] for l in layer_list]), dtype=dtype)
            for k in layer_list[0]}


# ---------------------------------------------------------------------------
# HF safetensors loading
# ---------------------------------------------------------------------------

def _load_safetensors_dir(path: str) -> dict[str, np.ndarray]:
    """Load all *.safetensors files under `path` into one flat name→array dict."""
    from safetensors import safe_open  # available via transformers' deps

    tensors: dict[str, np.ndarray] = {}
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    for fname in files:
        with safe_open(os.path.join(path, fname), framework="np") as f:
            for name in f.keys():
                tensors[name] = f.get_tensor(name)
    return tensors


def _get(tensors: dict, *names: str) -> np.ndarray:
    for n in names:
        if n in tensors:
            return tensors[n]
    raise KeyError(f"none of {names} in checkpoint (have {len(tensors)} tensors)")


def load_encoder_params(cfg: EncoderConfig, snapshot_dir: str, dtype=jnp.bfloat16) -> dict:
    """XLM-RoBERTa HF naming → our pytree. Linear weights transposed to (in, out);
    per-layer tensors stacked to the (L, ...) scan layout."""
    t = _load_safetensors_dir(snapshot_dir)

    def W(name):  # HF (out, in) → (in, out); host-side np until the stack
        return np.ascontiguousarray(
            _get(t, name, "roberta." + name, "bert." + name).T)

    def A(name):
        return _get(t, name, "roberta." + name, "bert." + name)

    def J(name):
        return jnp.asarray(A(name), dtype=dtype)

    layer_list = []
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        layer_list.append({
            "qkv_w": np.concatenate([
                W(p + "attention.self.query.weight"),
                W(p + "attention.self.key.weight"),
                W(p + "attention.self.value.weight")], axis=1),
            "qkv_b": np.concatenate([
                A(p + "attention.self.query.bias"),
                A(p + "attention.self.key.bias"),
                A(p + "attention.self.value.bias")], axis=0),
            "o_w": W(p + "attention.output.dense.weight"),
            "o_b": A(p + "attention.output.dense.bias"),
            "attn_ln_scale": A(p + "attention.output.LayerNorm.weight"),
            "attn_ln_bias": A(p + "attention.output.LayerNorm.bias"),
            "ff_w1": W(p + "intermediate.dense.weight"),
            "ff_b1": A(p + "intermediate.dense.bias"),
            "ff_w2": W(p + "output.dense.weight"),
            "ff_b2": A(p + "output.dense.bias"),
            "ff_ln_scale": A(p + "output.LayerNorm.weight"),
            "ff_ln_bias": A(p + "output.LayerNorm.bias"),
        })
    return {
        "embed": {
            "word": J("embeddings.word_embeddings.weight"),
            "pos": J("embeddings.position_embeddings.weight"),
            "type": J("embeddings.token_type_embeddings.weight"),
            "ln_scale": J("embeddings.LayerNorm.weight"),
            "ln_bias": J("embeddings.LayerNorm.bias"),
        },
        "layers": stack_layer_dicts(layer_list, dtype),
    }


def load_decoder_params(cfg: DecoderConfig, snapshot_dir: str, dtype=jnp.bfloat16) -> dict:
    """Qwen2 HF naming → our pytree (stacked (L, ...) scan layout)."""
    t = _load_safetensors_dir(snapshot_dir)

    def W(name):
        return np.ascontiguousarray(_get(t, name).T)

    def A(name):
        return _get(t, name)

    layer_list = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layer = {
            "ln1": A(p + "input_layernorm.weight"),
            "qkv_w": np.concatenate([
                W(p + "self_attn.q_proj.weight"),
                W(p + "self_attn.k_proj.weight"),
                W(p + "self_attn.v_proj.weight")], axis=1),
            "o_w": W(p + "self_attn.o_proj.weight"),
            "ln2": A(p + "post_attention_layernorm.weight"),
            "gu_w": np.concatenate([
                W(p + "mlp.gate_proj.weight"),
                W(p + "mlp.up_proj.weight")], axis=1),
            "down_w": W(p + "mlp.down_proj.weight"),
        }
        if cfg.qkv_bias:  # Qwen2 has QKV bias; Llama/Mistral do not
            layer["qkv_b"] = np.concatenate([
                A(p + "self_attn.q_proj.bias"),
                A(p + "self_attn.k_proj.bias"),
                A(p + "self_attn.v_proj.bias")], axis=0)
        layer_list.append(layer)
    params = {
        "embed": jnp.asarray(A("model.embed_tokens.weight"), dtype=dtype),
        "layers": stack_layer_dicts(layer_list, dtype),
        "ln_f": jnp.asarray(A("model.norm.weight"), dtype=dtype),
    }
    if "lm_head.weight" in t and not cfg.tie_word_embeddings:
        params["lm_head"] = jnp.asarray(W("lm_head.weight"), dtype=dtype)
    return params


def find_snapshot(weights_dir: str | None, model_name: str) -> str | None:
    """Locate a local HF snapshot for `model_name` under weights_dir or the HF cache."""
    candidates = []
    if weights_dir:
        candidates.append(os.path.join(weights_dir, model_name.replace("/", "--")))
        candidates.append(os.path.join(weights_dir, model_name.split("/")[-1]))
        candidates.append(weights_dir)
    hub = os.path.expanduser("~/.cache/huggingface/hub")
    repo = os.path.join(hub, "models--" + model_name.replace("/", "--"), "snapshots")
    if os.path.isdir(repo):
        for snap in sorted(os.listdir(repo)):
            candidates.append(os.path.join(repo, snap))
    for c in candidates:
        if c and os.path.isdir(c) and any(f.endswith(".safetensors") for f in os.listdir(c)):
            return c
    return None


def snapshot_hf_config(weights_dir: str | None, model_name: str) -> dict | None:
    """The snapshot's config.json, if a local snapshot with one exists —
    lets the engine derive the architecture from the checkpoint itself
    (any Llama-family decoder / BERT-family encoder) instead of a preset."""
    snap = find_snapshot(weights_dir, model_name)
    if not snap:
        return None
    cfg_path = os.path.join(snap, "config.json")
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path, "r", encoding="utf-8") as f:
        return json.load(f)


def get_encoder_params(cfg: EncoderConfig, weights_dir: str | None,
                       model_name: str, dtype=jnp.bfloat16) -> tuple[dict, bool]:
    """Returns (params, loaded_real_weights)."""
    snap = find_snapshot(weights_dir, model_name)
    if snap:
        return load_encoder_params(cfg, snap, dtype=dtype), True
    return init_encoder_params(cfg, dtype=dtype), False


def get_decoder_params(cfg: DecoderConfig, weights_dir: str | None,
                       model_name: str, dtype=jnp.bfloat16) -> tuple[dict, bool]:
    snap = find_snapshot(weights_dir, model_name)
    if snap:
        return load_decoder_params(cfg, snap, dtype=dtype), True
    return init_decoder_params(cfg, dtype=dtype), False
