from viquae_torch.interact import system  # noqa: F401
