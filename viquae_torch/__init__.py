"""PyTorch/CUDA port of viquae_tpu for NVIDIA Hopper GPUs.

Ported: the exact dense-retrieval path — host packing (ops.packing), the
packed DPR/BERT encoder (models), the fused score+segmax Hopper kernel B1
(csrc/score_segmax.cu via ops.mips_fused) and the serving pipeline (ir) —
every single-GPU MIPS engine (ops.mips: DenseIndex in each mode,
StreamingDenseIndex; the kb-major kernel B2, csrc/score_segmax_kbmajor.cu,
behind ops.mips_fused.topk_pallas), late fusion (ops.fusion,
ir.serving.MultiIndexRetrievalPipeline), rankeval, the answer path, BM25
and hybrid serving, the HTTP server, the image and face chain, the
multimodal encoders (models.mm, ir.embedding.MMEmbedder) and the command
line (``python -m viquae_torch``). The JAX package is
the reference the port is tested against; the port never imports it.
Entry points run on the GPU unless the caller passes ``device="cpu"``.
"""
