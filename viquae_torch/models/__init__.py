"""The port's models: BERT/DPR encoders, the reader, the multimodal
encoders, the image and face towers, and the JAX param-tree converter."""
# importing registers the config-registry entries (DPREncoder, ECAEncoder,
# IntermediateLinearFusion, ...)
from viquae_torch.models import bert, clip, dpr, mm, qa  # noqa: F401
