"""Tensor-parallel parameter shardings (GSPMD style).

The reference has no model parallelism at all (SURVEY §2 parallelism ledger);
this module is the capability that replaces "buy more replicas": shard
attention heads and MLP intermediate over the mesh "model" axis, batch over
"data", and let XLA insert the collectives (NCCL over NVLink on GPUs).

Rules (megatron-style, per transformer convention):
- q/k/v projections: shard OUTPUT dim (heads)   → column parallel
- attention output:  shard INPUT dim            → row parallel (psum after)
- MLP up/gate:       shard OUTPUT dim           → column parallel
- MLP down:          shard INPUT dim            → row parallel (psum after)
- embeddings/norms/biases-of-row-parallel: replicated
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# key name → PartitionSpec for matmul weights (None entries replicate).
# Fused tensors (qkv_w, gu_w) shard their output dim; GSPMD re-shards the
# post-split activations as needed. Layer weights are STACKED on a leading
# L axis (the scan layout, models/qwen2.py) — their specs get a leading None
# (every device scans all layers; only head/ff dims shard).
_COL = {"qkv_w", "ff_w1", "gu_w"}
_ROW = {"o_w", "ff_w2", "down_w"}
_COL_BIAS = {"qkv_b", "ff_b1"}


def _spec_for(key: str, ndim: int, stacked: bool) -> P:
    lead = (None,) if stacked else ()
    if ndim - len(lead) == 2:
        if key in _COL:
            return P(*lead, None, "model")
        if key in _ROW:
            return P(*lead, "model", None)
        return P(*([None] * ndim))
    if ndim - len(lead) == 1 and key in _COL_BIAS:
        return P(*lead, "model")
    return P(*([None] * ndim))


def param_shardings(params, mesh: Mesh):
    """Map our encoder/decoder pytrees to NamedShardings by leaf key name.
    QuantizedWeight leaves shard their int8 matrix like the fp weight would
    and their (…, 1, out) scale along the same output axis."""
    from rag_serving_system.ops.quant import QuantizedWeight, QuantizedWeight4

    def leaf_sharding(key, v, stacked):
        lead = (None,) if stacked else ()
        if isinstance(v, QuantizedWeight4):  # q (…, G, g/2, out) packed int4
            n_model = mesh.shape.get("model", 1)
            g_ax, p_ax = len(lead), len(lead) + 1  # group / packed axes
            if key in _COL:      # shard output dim
                w_spec = s_spec = P(*lead, None, None, "model")
            elif key in _ROW and v.q.shape[g_ax] % n_model == 0:
                # input dim sharded on the group axis; per-group scales follow
                w_spec = s_spec = P(*lead, "model", None, None)
            elif key in _ROW and v.q.shape[p_ax] % n_model == 0:
                # few groups (small models / large group size): shard the
                # packed within-group axis instead — GSPMD still psums the
                # contraction; scales are per-group so they replicate
                w_spec = P(*lead, None, "model", None)
                s_spec = P(*([None] * v.scale.ndim))
            else:
                w_spec = P(*([None] * v.q.ndim))
                s_spec = P(*([None] * v.scale.ndim))
            return QuantizedWeight4(q=NamedSharding(mesh, w_spec),
                                    scale=NamedSharding(mesh, s_spec))
        if isinstance(v, QuantizedWeight):
            w_spec = _spec_for(key, v.q.ndim, stacked)
            s_spec = (P(*lead, None, "model") if key in _COL
                      else P(*([None] * v.scale.ndim)))
            return QuantizedWeight(q=NamedSharding(mesh, w_spec),
                                   scale=NamedSharding(mesh, s_spec))
        return NamedSharding(mesh, _spec_for(key, v.ndim, stacked))

    def walk(tree, stacked=False):
        if isinstance(tree, dict):
            return {k: (walk(v, stacked or k == "layers")
                        if isinstance(v, (dict, list))
                        else leaf_sharding(k, v, stacked))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, stacked) for v in tree]
        return NamedSharding(mesh, P(*([None] * tree.ndim)))

    return walk(params)


def shard_params(params, mesh: Mesh):
    """Device-put a params pytree with TP shardings."""
    shardings = param_shardings(params, mesh)
    return jax.tree.map(lambda p, s: jax.device_put(p, s), params, shardings,
                        is_leaf=lambda x: not isinstance(x, (dict, list)))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the batch dim over "data", replicate the rest."""
    return NamedSharding(mesh, P("data", None))


def replicated(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    return NamedSharding(mesh, P(*([None] * ndim)))
