from rag_serving_system.parallel.mesh import make_mesh, mesh_axis_sizes
from rag_serving_system.parallel.sharded_topk import (
    shard_corpus,
    sharded_cosine_topk,
)
