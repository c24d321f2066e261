from rag_serving_system.ops.topk import (
    cosine_topk_reference,
    cosine_topk,
)
