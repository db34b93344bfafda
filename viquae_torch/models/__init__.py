"""BERT/DPR encoders and the JAX param-tree converter."""
