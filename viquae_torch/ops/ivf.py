"""IVF-Flat MIPS index (counterpart of viquae_tpu/ops/ivf.py; FAISS
``IVF{nlist},Flat`` parity).

The reference passes ``string_factory`` straight through to
``Dataset.add_faiss_index`` (meerqat/ir/search.py:207-249), so IVF
factories are part of its config surface; this module is the inverted-file
index behind them on one device.

- **k-means trains on the device** on a FAISS-style subsample
  (``train_points_per_list`` rows a list, drawn on the host with
  ``np.random.default_rng(seed)``, the reference's stream bit for bit):
  k-means++ seeding, then Lloyd iterations whose assignment is one
  ``(sample, nlist)`` f32 product and an argmax, and whose update is an
  ``index_add_``. The k-means++ draws come from a ``torch.Generator``
  seeded with ``seed``: ``jax.random`` has no counterpart, so a port build
  and a JAX build pick other seeds and end with other lists. Everything
  after the seeding is held to the reference on the same inputs.
- **Storage is cluster-sorted**: one ``(N + list_cap, d)`` matrix whose
  rows are grouped by list (a stable sort: add order within a list), with
  per-list ``starts`` / ``sizes``. Lists larger than ``max_list_factor x
  N / nlist`` are split into capped sublists that share the parent
  centroid; the duplicated centroids tie in the probe selection, and the
  selection is a stable descending sort, so the sublists are probed one
  after another, lowest index first, as ``lax.top_k`` probes them.
- **Search** scores the queries against the centroids in f32, selects
  ``nprobe`` lists a query, and for each probe step gathers the
  ``(qchunk, list_cap, d)`` row windows and scores them with one batched
  product (f32 storage: a full f32 product; bf16 storage: bf16 operands,
  f32 sums). Lanes past a list's size score -inf, and the repo-wide
  ``finalize_topk`` tail orders the candidates (score desc, id asc; the
  INT32_MAX pad id where fewer than k rows were probed).

The products are plain torch ops (cuBLAS on the card): the JAX module has
no Pallas kernel either. Divergences from FAISS, as in the reference:
``add`` after the build raises; an empty k-means list keeps its previous
centroid; ``nlist`` and ``nprobe`` count sublists after a skewed build.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from viquae_torch.core import mesh as meshlib
from viquae_torch.core.device import resolve_device
from viquae_torch.models.layers import _bmm_f32
from viquae_torch.ops.mips import (INT32_MAX, NEG_INF, finalize_topk,
                                   l2_normalize, top_k)

_ASSIGN_CHUNK = 1 << 18


# --------------------------------------------------------------------------
# k-means (Lloyd iterations on a training subsample, on the device)
# --------------------------------------------------------------------------
def _kmeanspp_init(generator: torch.Generator, sample: torch.Tensor,
                   nlist: int) -> torch.Tensor:
    """k-means++ seeding: each next centroid is drawn with probability
    proportional to its squared distance from the chosen set (plus 1e-30,
    the reference's ``log(p + 1e-30)`` logits). ``generator`` lives on
    ``sample``'s device; no draw is read back to the host."""
    s, d = sample.shape
    norms2 = torch.sum(sample * sample, dim=1)
    first = torch.randint(0, s, (1,), generator=generator,
                          device=sample.device)
    c = sample[first[0]]
    mind = norms2 - 2.0 * torch.mv(sample, c) + torch.dot(c, c)
    cs = torch.zeros((nlist, d), dtype=sample.dtype, device=sample.device)
    cs[0] = c
    for i in range(1, nlist):
        p = torch.clamp(mind, min=0.0) + 1e-30
        idx = torch.multinomial(p, 1, generator=generator)[0]
        c = sample[idx]
        dist = norms2 - 2.0 * torch.mv(sample, c) + torch.dot(c, c)
        mind = torch.minimum(mind, dist)
        cs[i] = c
    return cs


def _assign_scores(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmax_c (x . c - ||c||^2 / 2) is the L2-nearest centroid."""
    scores = torch.matmul(x, centroids.T)
    return scores - 0.5 * torch.sum(centroids * centroids, dim=1)[None, :]


def _kmeans_fit(sample: torch.Tensor, init: torch.Tensor, iters: int
                ) -> torch.Tensor:
    """Lloyd's algorithm on an (S, d) f32 sample from (nlist, d) initial
    centroids; an empty cluster keeps its previous centroid. The argmax
    keeps the first maximum, as ``jnp.argmax`` does."""
    nlist = init.shape[0]
    c = init
    for _ in range(iters):
        assign = torch.argmax(_assign_scores(sample, c), dim=1)
        sums = torch.zeros_like(c).index_add_(0, assign, sample)
        counts = torch.bincount(assign, minlength=nlist).to(torch.float32)
        c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts[:, None], min=1.0), c)
    return c


def _assign_chunk(chunk: torch.Tensor, centroids: torch.Tensor
                  ) -> torch.Tensor:
    return torch.argmax(_assign_scores(chunk, centroids),
                        dim=1).to(torch.int32)


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------
def _probe(q: torch.Tensor, centroids: torch.Tensor, nprobe: int
           ) -> torch.Tensor:
    """(Q, nprobe) list ids by inner product with the centroids, ties to
    the lower list id (``lax.top_k`` order: split sublists share a
    centroid and are probed consecutively)."""
    return top_k(torch.matmul(q, centroids.T), nprobe)[1]


def _ivf_search(q: torch.Tensor, matrix: torch.Tensor,
                centroids: torch.Tensor, starts: torch.Tensor,
                sizes: torch.Tensor, ids: torch.Tensor, *, k: int,
                nprobe: int, list_cap: int, qchunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, k) f32 scores and int32 ids of the top-k rows among each
    query's ``nprobe`` probed lists. ``matrix`` / ``ids`` are the
    cluster-sorted rows and their original ids, padded by ``list_cap``
    rows so that every window [start, start + list_cap) stays in bounds."""
    probed = _probe(q, centroids, nprobe)
    offs = torch.arange(list_cap, device=q.device)
    q_c = q.to(matrix.dtype)
    out_s, out_i = [], []
    for lo in range(0, q.shape[0], qchunk):
        qc = q_c[lo: lo + qchunk]
        scores, positions = [], []
        for j in range(nprobe):
            cl = probed[lo: lo + qchunk, j]
            pos = starts[cl].long()[:, None] + offs[None, :]   # (qc, P)
            s = _bmm_f32(matrix[pos], qc[:, :, None])[..., 0]
            scores.append(s.masked_fill(offs[None, :] >= sizes[cl][:, None],
                                        NEG_INF))
            positions.append(pos)
        cand = torch.cat(scores, dim=1)
        cand_ids = ids[torch.cat(positions, dim=1)]
        s, i = finalize_topk(cand, cand_ids, k)
        out_s.append(s)
        out_i.append(i)
    return torch.cat(out_s), torch.cat(out_i)


# --------------------------------------------------------------------------
# the index
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _IVFState:
    matrix: torch.Tensor
    centroids: torch.Tensor
    starts: torch.Tensor
    sizes: torch.Tensor
    ids: torch.Tensor


def split_skewed_lists(starts: np.ndarray, sizes: np.ndarray, cap: int):
    """(starts, sizes, parent) with every list longer than ``cap`` cut
    into sublists of at most ``cap`` rows (an empty list stays one empty
    sublist), in list order; ``parent`` maps a sublist to its list."""
    new_starts, new_sizes, parent = [], [], []
    for li in range(len(sizes)):
        s0, sz = int(starts[li]), int(sizes[li])
        off = 0
        while True:
            new_starts.append(s0 + off)
            new_sizes.append(max(0, min(cap, sz - off)))
            parent.append(li)
            off += cap
            if off >= sz:
                break
    return (np.asarray(new_starts, np.int32),
            np.asarray(new_sizes, np.int32), np.asarray(parent, np.int32))


class IVFFlatIndex:
    """Inverted-file flat index over one embedding column, on one device.

    Mirrors ``add_faiss_index(..., string_factory="IVF{nlist},Flat")`` +
    ``search_batch`` with the inner-product metric; ``do_l2norm``
    normalizes both sides ("L2norm,IVF...,Flat"). Built from host numpy
    or from a tensor already on the device (built there end to end).
    ``search_batch`` returns the exact top-k over the probed lists under
    the repo-wide contract (score desc, id asc, INT32_MAX pad ids).
    ``mesh_ctx`` (default ``core.mesh.current()``) is kept, as the
    reference keeps it: the index stays whole on every rank, on the mesh's
    device unless ``device`` names one."""

    mode = "ivf"

    def __init__(self, vectors, nlist: Optional[int] = None,
                 nprobe: int = 8, do_l2norm: bool = False, device=None,
                 dtype=torch.float32, train_points_per_list: int = 64,
                 train_iters: int = 10, seed: int = 0, qchunk: int = 32,
                 max_list_factor: float = 4.0, mesh_ctx=None,
                 _state: Optional[_IVFState] = None,
                 _meta: Optional[dict] = None):
        self.mesh_ctx = mesh_ctx or meshlib.current()
        self.device = resolve_device(
            device if device is not None else self.mesh_ctx.device)
        self.do_l2norm = do_l2norm
        self.dtype = dtype
        self.qchunk = qchunk
        if _state is not None:  # load()
            meta = dict(_meta or {})
            self.n, self.d = int(meta["n"]), int(meta["d"])
            self.nlist = int(meta["nlist"])
            self.nprobe = int(meta.get("nprobe", nprobe))
            self.list_cap = int(meta["list_cap"])
            self._st = _state
            return

        if isinstance(vectors, torch.Tensor):
            src = vectors.to(self.device)
            if do_l2norm:
                src = l2_normalize(src.float())
        else:
            v = np.asarray(vectors, np.float32)
            if do_l2norm:  # in numpy, as the reference normalizes
                v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True),
                                   1e-12)
            src = torch.as_tensor(v, device=self.device)
        self.n, self.d = src.shape
        if self.n == 0:
            raise ValueError("IVFFlatIndex needs a non-empty matrix")
        if nlist is None:
            # ~sqrt(N), a power of two (the FAISS guideline)
            nlist = max(16, 1 << int(round(np.log2(max(np.sqrt(self.n),
                                                       16)))))
        nlist = min(nlist, self.n)
        self.nlist = int(nlist)
        self.nprobe = int(min(nprobe, nlist))

        # ---- k-means on a subsample -------------------------------------
        rng = np.random.default_rng(seed)
        s = min(self.n, train_points_per_list * self.nlist)
        sample_idx = np.sort(rng.choice(self.n, size=s, replace=False))
        sample = src[torch.as_tensor(sample_idx, device=self.device)].float()
        generator = torch.Generator(device=self.device).manual_seed(seed)
        init = _kmeanspp_init(generator, sample, self.nlist)
        centroids = _kmeans_fit(sample, init, int(train_iters))
        del sample, init

        # ---- assignment of every row, in chunks -------------------------
        assign = torch.cat([
            _assign_chunk(src[i0: i0 + _ASSIGN_CHUNK].float(), centroids)
            for i0 in range(0, self.n, _ASSIGN_CHUNK)])

        # ---- cluster-sorted layout, skewed lists split -------------------
        order = torch.argsort(assign, stable=True)
        sizes = torch.bincount(assign, minlength=self.nlist).to(torch.int32)
        starts = torch.cumsum(sizes, 0, dtype=torch.int32) - sizes
        cap = max(1, int(np.ceil(max_list_factor * self.n / self.nlist)))
        sizes_np = sizes.cpu().numpy()
        if sizes_np.size and int(sizes_np.max()) > cap:
            starts_np, sizes_np, parent = split_skewed_lists(
                starts.cpu().numpy(), sizes_np, cap)
            starts = torch.as_tensor(starts_np, device=self.device)
            sizes = torch.as_tensor(sizes_np, device=self.device)
            centroids = centroids[torch.as_tensor(parent,
                                                  device=self.device).long()]
            self.nlist = len(starts_np)
        self.list_cap = max(1, int(sizes_np.max()) if self.nlist else 0)
        # windows read [start, start + list_cap): pad the tail so the last
        # list's window stays in bounds (its masked lanes score -inf)
        matrix = torch.empty((self.n + self.list_cap, self.d), dtype=dtype,
                             device=self.device)
        matrix[: self.n] = src[order]
        matrix[self.n:] = 0
        ids = torch.cat([order.to(torch.int32),
                         torch.full((self.list_cap,), INT32_MAX,
                                    dtype=torch.int32, device=self.device)])
        self._st = _IVFState(matrix=matrix, centroids=centroids.float(),
                             starts=starts, sizes=sizes, ids=ids)

    # ------------------------------------------------------------------
    def search_batch(self, queries, k: int = 100,
                     nprobe: Optional[int] = None, sync: bool = True):
        """(scores, ids) of the top-k rows among the probed lists; f32
        scores, int32 ids. ``nprobe`` overrides the build-time default for
        this call. With ``sync=False`` the results stay device tensors."""
        q = torch.as_tensor(queries, device=self.device).float()
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(
                f"expected (Q, {self.d}) queries, got {tuple(q.shape)}")
        if self.do_l2norm:
            q = l2_normalize(q)
        nprobe = int(min(nprobe if nprobe is not None else self.nprobe,
                         self.nlist))
        k_eff = min(k, self.n)
        qc = min(self.qchunk, max(1, q.shape[0]))
        st = self._st
        scores, idx = _ivf_search(
            q, st.matrix, st.centroids, st.starts, st.sizes, st.ids,
            k=k_eff, nprobe=nprobe, list_cap=self.list_cap, qchunk=qc)
        if k_eff < k:  # the FAISS pad convention out to the requested k
            nq = q.shape[0]
            scores = torch.cat([scores, scores.new_full((nq, k - k_eff),
                                                        NEG_INF)], 1)
            idx = torch.cat([idx, idx.new_full((nq, k - k_eff), INT32_MAX)],
                            1)
        if not sync:
            return scores, idx
        return scores.cpu().numpy(), idx.cpu().numpy()

    # ------------------------------------------------------------------
    def add(self, vectors) -> None:
        raise NotImplementedError(
            "IVFFlatIndex is built once (the cluster-sorted layout has no "
            "cheap append) — rebuild the index, or use ops.mips.DenseIndex "
            "/ StreamingDenseIndex for live-add KBs")

    def reconstruct_batch(self, row_ids) -> np.ndarray:
        """Rows by original id as f32 (FAISS ``reconstruct_batch``)."""
        row_ids = np.asarray(row_ids, np.int64)
        ids = self._st.ids[: self.n].long()
        inv = torch.empty((self.n,), dtype=torch.long, device=self.device)
        inv[ids] = torch.arange(self.n, device=self.device)
        rows = inv[torch.as_tensor(row_ids, device=self.device)]
        return self._st.matrix[rows].float().cpu().numpy()

    def nbytes(self) -> int:
        """Bytes of device memory the index holds."""
        return sum(t.numel() * t.element_size()
                   for t in dataclasses.astuple(self._st))

    # ------------------------------------------------------------------
    def save(self, path) -> None:
        """The reference's ``.npz`` (same keys, f32 matrix): files load in
        either package. Written uncompressed, where the reference
        compresses: float rows barely compress, and zlib takes ~40 s for
        the 200 MB of a 65,536 x 768 index (chip_smoke.py phase 23)."""
        path = Path(str(path))
        path.parent.mkdir(parents=True, exist_ok=True)
        st = self._st
        np.savez(
            path.with_suffix(".npz") if path.suffix != ".npz" else path,
            matrix=st.matrix.float().cpu().numpy(),
            centroids=st.centroids.float().cpu().numpy(),
            starts=st.starts.cpu().numpy(),
            sizes=st.sizes.cpu().numpy(),
            ids=st.ids.cpu().numpy(),
            meta=np.array([self.n, self.d, self.nlist, self.nprobe,
                           self.list_cap, int(self.do_l2norm)]),
        )

    @classmethod
    def load(cls, path, device=None, dtype=torch.float32, mesh_ctx=None,
             **kwargs):
        path = Path(str(path))
        if path.suffix != ".npz" and Path(str(path) + ".npz").exists():
            path = Path(str(path) + ".npz")
        mesh_ctx = mesh_ctx or meshlib.current()
        dev = resolve_device(device if device is not None
                             else mesh_ctx.device)
        with np.load(path) as z:
            n, d, nlist, nprobe, list_cap, do_l2 = (int(v) for v in z["meta"])

            def put(name, dt=None):
                return torch.as_tensor(z[name], device=dev, dtype=dt)

            state = _IVFState(matrix=put("matrix", dtype),
                              centroids=put("centroids", torch.float32),
                              starts=put("starts"), sizes=put("sizes"),
                              ids=put("ids"))
        return cls(None, do_l2norm=bool(do_l2), device=dev, dtype=dtype,
                   mesh_ctx=mesh_ctx, _state=state,
                   _meta={"n": n, "d": d, "nlist": nlist, "nprobe": nprobe,
                          "list_cap": list_cap},
                   **kwargs)
