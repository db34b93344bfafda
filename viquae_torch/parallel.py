"""Parallelism surface of the port (counterpart of viquae_tpu/parallel.py):
the mesh contract (axes ``data`` / ``pipe`` / ``model`` / ``kb``, over
``torch.distributed``) and the collective-backed primitives:

- data parallelism: the embedders split a batch's rows over ``data`` and
  gather the outputs back in order (ir/embedding.py, image/embedding.py);
  in training every rank holds the global batch, the trainees run their
  encoders on their rows and gather the per-sequence outputs for global
  in-batch negatives and global normalisers, and the gradients are
  averaged over ``data`` (train/trainer.py, train/data_parallel.py);
- KB sharding: embedding matrices row-split over ``kb``, per-shard top-k
  (kernel B1 for a fused index) and one candidate all-gather + merge
  (ops.mips.topk_sharded); BM25 postings split the same way
  (ops.bm25_device.ShardedDeviceBM25);
- tensor parallelism over ``model``: the ``*_spec`` companions and
  ``shard_module`` / ``gather_module`` (models/sharding.py), Megatron
  column / row-parallel attention and MLP with ``copy_to`` /
  ``reduce_from`` (models/layers.py);
- sequence parallelism: ``bert.encode``'s ``activation_sharding`` seam (L
  over ``model`` between the layers; ``gather_from`` / ``reduce_scatter_to``
  around each block);
- expert parallelism: ``moe_spec``; ``moe_apply`` runs the experts that
  ``shard_module`` split on this rank alone (ops/moe.py);
- pipeline parallelism over ``pipe``: ``stack_stages`` /
  ``unstack_stages`` (the staged layout), ``pipeline_apply`` (the GPipe
  schedule of microbatches through the stage ring, ``ring_shift`` /
  point-to-point calls in core/mesh.py), ``bert.pipeline_params`` /
  ``pipeline_param_spec`` / ``encode_pipelined`` (ops/pipeline.py,
  models/bert.py), composed with ``data`` in the Trainer.
"""
from viquae_torch.core.mesh import (  # noqa: F401
    DATA_AXIS,
    KB_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    MeshContext,
    all_reduce,
    copy_to,
    current,
    gather_from,
    gather_to,
    make_kb_mesh,
    make_mesh,
    reduce_from,
    reduce_scatter,
    reduce_scatter_to,
    ring_shift,
    scatter_to,
    use,
)
from viquae_torch.models.bert import (  # noqa: F401
    encode_pipelined,
    param_spec,
    pipeline_param_spec,
    pipeline_params,
    pipeline_unstack,
)
from viquae_torch.models.layers import (  # noqa: F401
    dense_spec,
    layer_norm_spec,
    mha_spec,
    mlp_spec,
)
from viquae_torch.models.sharding import (  # noqa: F401
    gather_module,
    shard_module,
)
from viquae_torch.ops.mips import topk_sharded  # noqa: F401
from viquae_torch.ops.moe import moe_spec  # noqa: F401
from viquae_torch.ops.pipeline import (  # noqa: F401
    microbatch,
    pipeline_apply,
    stack_stages,
    unmicrobatch,
    unstack_stages,
)
