"""Device-mesh construction.

The reference's only parallelism is whole-replica data parallelism over a
Redis queue (reference: deployment/auto_scaler.py + rag-service.yaml). Inside
one replica we instead scale over the host's devices with a
`jax.sharding.Mesh`: the corpus shards over the combined mesh ("data"-major)
and model weights can shard over the "model" axis (tensor parallelism). The
mesh assumes no topology: the cards of one host reach each other all to all.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(mesh_shape: str = "", devices=None) -> Mesh:
    """Build a ("data", "model") mesh.

    mesh_shape: "dp,tp" e.g. "4,2"; empty → all devices on the data axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_shape:
        dp, tp = (int(x) for x in mesh_shape.split(","))
    else:
        dp, tp = n, 1
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, axis_names=("data", "model"))


def mesh_axis_sizes(mesh: Mesh) -> tuple[int, int]:
    return mesh.shape["data"], mesh.shape["model"]
