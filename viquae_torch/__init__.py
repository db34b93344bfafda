"""PyTorch/CUDA port of viquae_tpu for NVIDIA Hopper GPUs.

The exact dense-retrieval path is ported: host packing (ops.packing), the
packed DPR/BERT encoder (models), the fused score+segmax Hopper kernel
(csrc/score_segmax.cu via ops.mips_fused), the fused DenseIndex (ops.mips)
and the serving pipeline (ir). The JAX package is the reference the port is
tested against; the port never imports it. Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""
