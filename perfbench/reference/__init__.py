"""Plain PyTorch references of what the cells' timed paths produce. They
import neither JAX, nor the JAX package, nor anything of viquae_torch."""
