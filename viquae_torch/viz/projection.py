"""2-D projection maps of embedding columns (role of meerqat/viz/umap.py).

The reference projects embedding columns with UMAP and plots with bokeh;
bokeh is absent from this environment, so plots use matplotlib. Projection
methods: "umap" (the in-repo from-scratch UMAP, viz/umap.py), "pca", or
"tsne" — same artifact: a labeled 2-D scatter of an embedding column,
saved to PNG/HTML.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def project(embeddings: np.ndarray, method: str = "pca", seed: int = 42,
            **kwargs) -> np.ndarray:
    """(N, d) -> (N, 2)."""
    embeddings = np.asarray(embeddings, np.float32)
    if method == "pca":
        from sklearn.decomposition import PCA

        return PCA(n_components=2, random_state=seed, **kwargs).fit_transform(
            embeddings
        )
    if method == "tsne":
        from sklearn.manifold import TSNE

        return TSNE(
            n_components=2, random_state=seed, init="pca", **kwargs
        ).fit_transform(embeddings)
    if method == "umap":
        from viquae_torch.viz import umap as umap_lib

        return umap_lib.umap_embed(embeddings, seed=seed, **kwargs)
    raise ValueError(f"Unknown projection method {method!r}")


def plot_embeddings(
    embeddings: np.ndarray,
    labels: Optional[Sequence] = None,
    output: Optional[str] = None,
    method: str = "pca",
    title: str = "",
    seed: int = 42,
):
    """Scatter an embedding column in 2-D, colored by labels."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xy = project(embeddings, method=method, seed=seed)
    fig, ax = plt.subplots(figsize=(8, 8))
    if labels is not None:
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            mask = labels == lab
            ax.scatter(xy[mask, 0], xy[mask, 1], s=4, label=str(lab), alpha=0.6)
        if len(np.unique(labels)) <= 20:
            ax.legend(markerscale=3, fontsize=8)
    else:
        ax.scatter(xy[:, 0], xy[:, 1], s=4, alpha=0.6)
    ax.set_title(title or f"{method} projection")
    if output:
        fig.savefig(output, dpi=150, bbox_inches="tight")
    plt.close(fig)  # unconditionally: library callers would leak figures
    return xy


def dataset_plot(dataset_path, column: str, label_column: Optional[str] = None,
                 output: Optional[str] = None, **kwargs):
    from datasets import load_from_disk

    dataset = load_from_disk(str(dataset_path))
    embeddings = np.asarray(dataset[column], np.float32)
    labels = dataset[label_column] if label_column else None
    return plot_embeddings(embeddings, labels=labels, output=output, **kwargs)
