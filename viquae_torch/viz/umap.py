"""From-scratch UMAP (parity role of meerqat/viz/umap.py, which wraps
umap-learn — absent from this environment).

Implements the real UMAP algorithm (McInnes et al. 2018) at visualization
scale, vectorized numpy:

1. exact kNN graph (cosine or euclidean),
2. smooth-kNN calibration: per-point rho (nearest distance) and sigma via
   binary search so that sum_j exp(-(d_ij - rho_i)/sigma_i) = log2(k),
3. fuzzy simplicial set symmetrization  w = a + b - a*b,
4. (a, b) curve parameters fit from min_dist,
5. PCA initialization, then SGD over edges with attractive gradients
   -2ab d^(2(b-1)) / (1 + a d^(2b)) and negative-sampled repulsive
   gradients, linearly decaying learning rate, gradient clipping at 4.

`reduce(embeddings, metric)` mirrors the reference's entry
(meerqat/viz/umap.py:24-28); `viz.projection.project(method="umap")`
routes here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _pairwise_dists(x: np.ndarray, metric: str) -> np.ndarray:
    if metric == "cosine":
        xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        return np.clip(1.0 - xn @ xn.T, 0.0, 2.0)
    if metric == "euclidean":
        sq = (x ** 2).sum(1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
        return np.sqrt(np.clip(d2, 0.0, None))
    raise ValueError(f"unknown metric {metric!r}")


def smooth_knn(dists: np.ndarray, n_iter: int = 64,
               bandwidth: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (rho, sigma): rho = nearest non-zero distance; sigma solves
    sum_j exp(-max(d_ij - rho, 0)/sigma) = log2(k) by binary search."""
    k = dists.shape[1]
    target = np.log2(k) * bandwidth
    # nearest NON-ZERO distance (umap-learn's local connectivity): with
    # exact duplicates the first column is 0 and would break the
    # nearest-neighbor-weight == 1 property
    nonzero = dists > 0
    first_nz = nonzero.argmax(axis=1)
    rho = np.where(nonzero.any(axis=1),
                   dists[np.arange(len(dists)), first_nz], 0.0)
    lo = np.full(len(dists), 1e-8)
    hi = np.full(len(dists), 1e4)
    mid = np.ones(len(dists))
    shifted = np.maximum(dists - rho[:, None], 0.0)
    for _ in range(n_iter):
        psum = np.exp(-shifted / mid[:, None]).sum(axis=1)
        too_big = psum > target
        hi = np.where(too_big, mid, hi)
        lo = np.where(too_big, lo, mid)
        mid = np.where(too_big, (lo + hi) / 2.0, np.minimum(mid * 2, hi))
        mid = np.where(hi < 1e4, (lo + hi) / 2.0, mid)
    return rho, mid


def fuzzy_graph(x: np.ndarray, n_neighbors: int, metric: str
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrized fuzzy simplicial set over the exact kNN graph.
    Returns (heads, tails, weights) edge arrays."""
    n = len(x)
    d = _pairwise_dists(x, metric)
    np.fill_diagonal(d, np.inf)
    nn = np.argsort(d, axis=1, kind="stable")[:, :n_neighbors]
    nn_d = np.take_along_axis(d, nn, axis=1)
    rho, sigma = smooth_knn(nn_d)
    w = np.exp(-np.maximum(nn_d - rho[:, None], 0.0) / sigma[:, None])
    # dense symmetrization at viz scale: W = A + A.T - A*A.T
    a = np.zeros((n, n))
    rows = np.repeat(np.arange(n), n_neighbors)
    a[rows, nn.ravel()] = w.ravel()
    sym = a + a.T - a * a.T
    heads, tails = np.nonzero(np.triu(sym, 1) > 1e-8)
    w = sym[heads, tails]
    # emit BOTH directions (umap-learn keeps the full symmetric COO):
    # repulsion in the SGD loop is applied to heads only, so with
    # triu-only edges the higher-index endpoints would never feel a
    # repulsive force and late rows collapse onto their neighbors
    return (np.concatenate([heads, tails]),
            np.concatenate([tails, heads]),
            np.concatenate([w, w]))


def find_ab_params(min_dist: float, spread: float = 1.0
                   ) -> Tuple[float, float]:
    """Fit the (a, b) of 1/(1 + a d^(2b)) to the desired offset-exponential
    (umap-learn's find_ab_params)."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=10000)
    return float(a), float(b)


def umap_embed(
    x: np.ndarray,
    n_components: int = 2,
    n_neighbors: int = 15,
    min_dist: float = 0.1,
    n_epochs: int = 200,
    learning_rate: float = 1.0,
    negative_sample_rate: int = 5,
    metric: str = "cosine",
    seed: int = 42,
) -> np.ndarray:
    """(N, d) -> (N, n_components) UMAP layout."""
    x = np.asarray(x, np.float64)
    n = len(x)
    if n <= n_neighbors:
        n_neighbors = max(2, n - 1)
    heads, tails, weights = fuzzy_graph(x, n_neighbors, metric)
    a, b = find_ab_params(min_dist)

    # PCA init scaled to [-10, 10] (umap-learn convention)
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    y = xc @ vt[:n_components].T
    y *= 10.0 / max(np.abs(y).max(), 1e-12)
    y = y.astype(np.float64)

    rng = np.random.default_rng(seed)
    # edge sampling schedule: edge e fires every 1/w_e epochs (umap's
    # epochs_per_sample), vectorized as a probability mask per epoch
    p_edge = weights / weights.max()
    for epoch in range(n_epochs):
        alpha = learning_rate * (1.0 - epoch / n_epochs)
        fire = rng.random(len(heads)) < p_edge
        h, t = heads[fire], tails[fire]
        if not len(h):
            continue
        # attractive updates
        diff = y[h] - y[t]
        d2 = (diff ** 2).sum(1)
        grad_coeff = np.where(
            d2 > 0.0, -2.0 * a * b * d2 ** (b - 1.0) / (a * d2 ** b + 1.0), 0.0
        )
        g = np.clip(grad_coeff[:, None] * diff, -4.0, 4.0)
        np.add.at(y, h, alpha * g)
        np.add.at(y, t, -alpha * g)
        # repulsive updates (negative sampling)
        for _ in range(negative_sample_rate):
            neg = rng.integers(0, n, len(h))
            diff = y[h] - y[neg]
            d2 = (diff ** 2).sum(1)
            grad_coeff = 2.0 * b / ((0.001 + d2) * (a * d2 ** b + 1.0))
            g = np.clip(grad_coeff[:, None] * diff, -4.0, 4.0)
            np.add.at(y, h, alpha * g)
    return y.astype(np.float32)


def reduce(embeddings: np.ndarray, metric: str = "cosine",
           **kwargs) -> np.ndarray:
    """Reference-entry parity (meerqat/viz/umap.py:24-28): fit + transform
    in one call."""
    return umap_embed(np.asarray(embeddings), metric=metric, **kwargs)
