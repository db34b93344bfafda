"""Parallelism surface of the port (counterpart of viquae_tpu/parallel.py):
the mesh contract (axes ``data`` / ``pipe`` / ``model`` / ``kb``, over
``torch.distributed``) and the collective-backed primitives of serving:

- data parallelism: the embedders split a batch's rows over ``data`` and
  gather the outputs back in order (ir/embedding.py, image/embedding.py);
- KB sharding: embedding matrices row-split over ``kb``, per-shard top-k
  (kernel B1 for a fused index) and one candidate all-gather + merge
  (ops.mips.topk_sharded); BM25 postings split the same way
  (ops.bm25_device.ShardedDeviceBM25).

The reference's training half (pipeline stages ``pipeline_apply`` /
``stack_stages`` / ``unstack_stages``, tensor, sequence and expert
parallelism, global in-batch negatives over ``data``) is not ported yet
(ROADMAP.md A17b-2).
"""
from viquae_torch.core.mesh import (  # noqa: F401
    DATA_AXIS,
    KB_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    MeshContext,
    current,
    make_kb_mesh,
    make_mesh,
    use,
)
from viquae_torch.ops.mips import topk_sharded  # noqa: F401
