from viquae_torch.viz import html, projection, stats, umap, wtl_filter  # noqa: F401
