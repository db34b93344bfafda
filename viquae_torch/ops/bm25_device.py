"""GPU-resident BM25 scoring, the device leg of hybrid retrieval
(counterpart of viquae_tpu/ops/bm25_device.py; the multi-device
``ShardedDeviceBM25`` is left for the multi-GPU slice, ROADMAP.md A17).

The host index (`ops.bm25.BM25Index` + the C++ MaxScore scorer) is exact
but bound by the host's cores; this module scores on the card.

- **Per-posting weights at build time**: with k1/b fixed, BM25 decomposes
  as s(q, d) = sum_t qtf(t) * w(t, d) with
  w(t, d) = idf(t) * tf / (tf + k1*(1-b+b*dl/avgdl)) — a static sparse
  matrix, computed in f32 and rounded ONCE to bf16.
- **Head terms** (top `n_head` by document frequency, stable, ties by term
  id): densified into an (n_head, D_pad) bf16 matrix once,
  D_pad = round_up(n_docs + 1, 128); a query block scores them with one
  product with f32 accumulation AND an f32 result (`_dot_f32`: a plain
  bf16 `torch.mm` would round the sums to bf16 before the tail is added).
- **Tail terms**: kept as CSR (docs int32 + weights bf16, term-major).
  Each tail term of each query becomes one or more (start, len) ranges in
  a PER-BLOCK slot pool of two widths (`l_small`, `l_mid`; a term wider
  than `l_mid` SPLITS across consecutive slots), gathered contiguously
  (`start + arange(cap)`; the trailing pad of `l_mid` entries keeps every
  range in bounds, an advanced-index gather does not clamp) and added
  into the f32 (q_block, D_pad) score block.
- **Masked lanes** (past a slot's length, and every lane of an unused
  slot) carry value 0. The reference sends them all to column `n_docs`;
  on CUDA the adds are atomics, which serialise on one address, so they
  are spread over the pad columns n_docs .. D_pad-1 (their head score is 0
  and the value added is 0: no score changes; when n_docs + 1 is a
  multiple of 128 there is one pad column only).
- **Selection**: `ops.mips._select_topk` fast mode over the block.

Queries whose ranges do not fit the block's pool go to the host scorer,
exact, behind the same ``search_batch`` contract; ``last_overflow`` counts
them.

Score contract: weights are bf16-quantised, summed in f32; ranks can
differ from the exact host scorer on near-ties. On a CUDA device the tail
is summed by atomic adds, so a score's last f32 bits depend on the order
in which they land: two runs agree within the f32 reordering bound
(~1e-6 relative for a query's handful of terms), and ranks may differ only
between documents whose scores lie that close. On the CPU the sum is
deterministic.

The reference wraps the gathered operands in
``jax.lax.optimization_barrier``; that is a fix for an XLA fusion and has
no counterpart here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from viquae_torch.core.device import HostCopy, resolve_device, upload
from viquae_torch.models.layers import _dot_f32
from viquae_torch.ops import bm25 as bm25_lib
from viquae_torch.ops import mips

LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _to_bf16(a: np.ndarray) -> torch.Tensor:
    """f32 numpy -> bf16 CPU tensor, round to nearest even (the rounding
    the reference's ``astype(bfloat16)`` applies)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16)


def _head_scores(head_w: torch.Tensor, head_dense: torch.Tensor
                 ) -> torch.Tensor:
    """(Q, n_head) bf16 x (n_head, D_pad) bf16 -> (Q, D_pad) f32 sums."""
    if head_dense.shape[0] == 0:
        return torch.zeros((head_w.shape[0], head_dense.shape[1]),
                           dtype=torch.float32, device=head_w.device)
    return _dot_f32(head_w, head_dense.t())


def _pool_lanes(tail_docs, tail_w, starts, lens, rows, qtf, cap: int,
                n_docs: int, d_pad: int):
    """One tier of the slot pool as scatter lanes: the flat (row * D_pad +
    doc) target and the f32 value of each of the P x cap lanes."""
    pos = torch.arange(cap, device=tail_docs.device)
    at = starts.long()[:, None] + pos                       # (P, cap)
    mask = pos < lens[:, None]
    trash = n_docs + pos % (d_pad - n_docs)
    docs = torch.where(mask, tail_docs[at].long(), trash)
    vals = torch.where(mask, tail_w[at].float() * qtf[:, None], 0.0)
    return rows.long()[:, None] * d_pad + docs, vals


def _scatter_add(scores: torch.Tensor, flat: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """scores[row, doc] += val for every lane (atomic adds on CUDA)."""
    scores.view(-1).scatter_add_(0, flat.reshape(-1), vals.reshape(-1))
    return scores


@torch.no_grad()
def _bm25_block(head_dense, tail_docs, tail_w, head_w,
                mid_start, mid_len, mid_row, mid_qtf,
                small_start, small_len, small_row, small_qtf,
                *, k: int, l_mid: int, l_small: int, n_docs: int):
    """Score one padded query block: head product + BLOCK-POOL tail
    gather/scatter + top-k selection. Returns f32 scores and int64 ids of
    shape (q_block, k). Grad mode is off here because serving threads call
    this."""
    d_pad = head_dense.shape[1]
    scores = _head_scores(head_w, head_dense)
    for starts, lens, rows, qtf, cap in (
            (mid_start, mid_len, mid_row, mid_qtf, l_mid),
            (small_start, small_len, small_row, small_qtf, l_small)):
        flat, vals = _pool_lanes(tail_docs, tail_w, starts, lens, rows, qtf,
                                 cap, n_docs, d_pad)
        _scatter_add(scores, flat, vals)
    return mips._select_topk(scores, k, "fast")


@torch.no_grad()
def _finalize_device(score_blocks, id_blocks, fb, *, n_docs: int):
    """Concatenate per-block results and apply the pad convention on the
    device: zero-score docs and padding columns become (-inf, INT32_MAX);
    overflow rows are replaced by their host-fallback results."""
    scores = torch.cat(list(score_blocks), dim=0)
    ids = torch.cat(list(id_blocks), dim=0).to(torch.int32)
    valid = (scores > 0) & (ids < n_docs)
    scores = torch.where(valid, scores, mips.NEG_INF)
    ids = torch.where(valid, ids, mips.INT32_MAX)
    if fb is not None:
        rows, fb_scores, fb_ids = fb
        scores.index_copy_(0, rows, fb_scores)
        ids.index_copy_(0, rows, fb_ids)
    return scores, ids


class DeviceBM25:
    """Device scorer over a host :class:`~viquae_torch.ops.bm25.BM25Index`.

    Same ``search_batch(queries, k) -> (scores, indices)`` contract as the
    host index, so it drops behind the ``IndexKind.BM25`` seam
    (``index_kwargs={"device": True}``). Holds a reference to the host
    index for overflow fallback; call :meth:`rebuild` after
    ``set_hyperparameters`` (weights bake in k1/b). ``device``: the card
    by default; the CPU only when named.
    """

    def __init__(self, index: bm25_lib.BM25Index, n_head: int = 512,
                 l_small: int = 512, l_mid: int = 2048,
                 pool_mid: Optional[int] = None,
                 pool_small: Optional[int] = None, q_block: int = 128,
                 device=None):
        """pool_mid/pool_small: PER-BLOCK slot pools shared by the
        q_block queries (a slot holds one (query, term) posting range;
        one query may use several). Defaults scale with q_block; a block
        whose pool fills sends the unplaceable QUERIES to the host
        fallback.

        l_mid CAPS the mid-slot width: a term whose posting list exceeds
        it is SPLIT across consecutive slots (same row/qtf, consecutive
        starts — the adds are additive, so scores are unchanged up to f32
        summation order). Splitting decouples slot width from the corpus'
        max tail df.

        q_block: queries scored per block. Per-block costs (the head
        matrix read, selection) amortise with larger blocks; the scatter's
        padded lanes and the (q_block, D_pad) f32 score block (3 GB at
        512 x 1.5M) scale WITH the block."""
        self.index = index
        self.device = resolve_device(device)
        self.n_head = n_head
        self.l_small_cfg = l_small
        self.l_mid_cfg = l_mid
        self.pool_mid = (pool_mid if pool_mid is not None
                         else _round_up(3 * q_block + 320, 64))
        self.pool_small = (pool_small if pool_small is not None
                           else _round_up(3 * q_block // 2 + 160, 64))
        self.q_block = q_block
        self.last_overflow = 0  # queries host-fallbacked by the last call
        self.rebuild()

    @property
    def n_docs(self) -> int:
        """Corpus size (duck-type parity with BM25Index so this scorer
        drops into ir/serving.HybridRetrievalPipeline unchanged)."""
        return self.index.n_docs

    # ---- build ---------------------------------------------------------
    def rebuild(self):
        """(Re)build device arrays from the host index (uses its CURRENT
        k1/b). One-time cost: per-posting weights on host (one vectorized
        pass) + a ~6 B/posting upload + a device scatter for the head."""
        index = self.index
        df = np.diff(index.offsets)
        order = np.argsort(-df, kind="stable")  # df desc, ties by term id
        n_head = min(self.n_head, int((df > 0).sum()))
        head_terms = order[:n_head]
        self.head_pos = np.full(len(df), -1, np.int32)
        self.head_pos[head_terms] = np.arange(n_head, dtype=np.int32)
        self.is_head = self.head_pos >= 0

        n_docs = index.n_docs
        self.d_pad = _round_up(n_docs + 1, LANE)
        tail_df = np.where(self.is_head, 0, df)
        # mid slots are capped at l_mid_cfg; wider terms split across
        # consecutive slots (see __init__)
        self.l_mid = max(LANE, min(
            _round_up(int(tail_df.max(initial=0)), LANE),
            _round_up(self.l_mid_cfg, LANE)))
        self.l_small = min(self.l_small_cfg, self.l_mid)

        # per-posting weights w(t, d) = idf * tf / (tf + norm_d)
        tids = np.repeat(np.arange(len(df), dtype=np.int64), df)
        w_all = (index.idf[tids] * index.tfs
                 / (index.tfs + index.norm[index.docs])).astype(np.float32)

        head_mask = self.is_head[tids]
        head_rows = self.head_pos[tids[head_mask]].astype(np.int64)
        head_docs = index.docs[head_mask].astype(np.int64)
        dev = self.device
        dense = torch.zeros((n_head, self.d_pad), dtype=torch.bfloat16,
                            device=dev)
        if len(head_rows):
            # each (term, doc) pair is unique in CSR postings, so these are
            # pure writes
            dense[torch.from_numpy(head_rows).to(dev),
                  torch.from_numpy(head_docs).to(dev)] = _to_bf16(
                      w_all[head_mask]).to(dev)
        self.head_dense = dense

        tail_mask = ~head_mask
        # trailing pad so every range start + cap stays in bounds
        pad = self.l_mid
        tail_docs = np.concatenate([
            index.docs[tail_mask].astype(np.int32),
            np.full(pad, n_docs, np.int32)])
        tail_w = np.concatenate([
            w_all[tail_mask], np.zeros(pad, np.float32)])
        self.tail_docs = torch.from_numpy(tail_docs).to(dev)
        self.tail_w = _to_bf16(tail_w).to(dev)
        # host CSR over TAIL postings only, indexed by original term id
        tail_counts = np.where(self.is_head, 0, df)
        self.tail_offsets = np.zeros(len(df) + 1, np.int64)
        np.cumsum(tail_counts, out=self.tail_offsets[1:])
        self.tail_df = tail_counts
        # slot starts ride as int32
        assert self.tail_offsets[-1] < 2**31, (
            "tail postings exceed int32 range — shard the corpus before "
            "the device path")

    # ---- search ---------------------------------------------------------
    def _plan(self, queries: Sequence[str]):
        """Host query planning: head weights + tiered tail ranges.
        Returns per-block device args + the overflow-query positions."""
        nq = len(queries)
        qb = self.q_block
        n_pad = _round_up(max(nq, 1), qb)
        n_blocks = n_pad // qb
        p_m, p_s = self.pool_mid, self.pool_small
        head_w = np.zeros((n_pad, self.head_dense.shape[0]), np.float32)
        mid_start = np.zeros((n_blocks, p_m), np.int32)
        mid_len = np.zeros((n_blocks, p_m), np.int32)
        mid_row = np.zeros((n_blocks, p_m), np.int32)
        mid_qtf = np.zeros((n_blocks, p_m), np.float32)
        small_start = np.zeros((n_blocks, p_s), np.int32)
        small_len = np.zeros((n_blocks, p_s), np.int32)
        small_row = np.zeros((n_blocks, p_s), np.int32)
        small_qtf = np.zeros((n_blocks, p_s), np.float32)
        mid_used = np.zeros(n_blocks, np.int64)
        small_used = np.zeros(n_blocks, np.int64)
        overflow: List[int] = []
        for i, query in enumerate(queries):
            blk, row = divmod(i, qb)
            counts: dict = {}
            for tok in bm25_lib.analyze(query):
                tid = self.index.vocab.get(tok)
                if tid is not None:
                    counts[tid] = counts.get(tid, 0) + 1
            head_terms, mids, smalls = [], [], []
            for tid, qtf in counts.items():
                pos = self.head_pos[tid]
                if pos >= 0:
                    head_terms.append((pos, qtf))
                    continue
                d = int(self.tail_df[tid])
                if d == 0:
                    continue
                # split wide terms into l_mid-cap chunks (consecutive
                # starts; adds are additive so splitting is score-exact
                # up to f32 summation order); a remainder <= l_small
                # takes a small slot
                off = int(self.tail_offsets[tid])
                while d > self.l_small:
                    take = min(d, self.l_mid)
                    mids.append((off, take, qtf))
                    off += take
                    d -= take
                if d > 0:
                    smalls.append((off, d, qtf))
            # small terms also fit mid slots — spill before giving up
            free_s = p_s - small_used[blk]
            free_m = p_m - mid_used[blk]
            while len(smalls) > free_s and len(mids) < free_m:
                mids.append(smalls.pop())
            if len(mids) > free_m or len(smalls) > free_s:
                overflow.append(i)  # pool exhausted -> host fallback
                continue
            for pos, qtf in head_terms:
                head_w[i, pos] = qtf
            for off, length, qtf in mids:
                s = mid_used[blk]
                mid_start[blk, s] = off
                mid_len[blk, s] = length
                mid_row[blk, s] = row
                mid_qtf[blk, s] = qtf
                mid_used[blk] += 1
            for off, length, qtf in smalls:
                s = small_used[blk]
                small_start[blk, s] = off
                small_len[blk, s] = length
                small_row[blk, s] = row
                small_qtf[blk, s] = qtf
                small_used[blk] += 1
        return (head_w, mid_start, mid_len, mid_row, mid_qtf,
                small_start, small_len, small_row, small_qtf), overflow

    def _score_blocks(self, plan, k_eff: int):
        """Enqueue every block of a plan; yields (lo, hi, scores, ids) on
        the device. Each block's plan arrays go up through pinned staging
        buffers, so the upload of block i+1 does not wait for block i."""
        head_w, *pools = plan
        qb = self.q_block
        head_w16 = _to_bf16(head_w)
        for blk, lo in enumerate(range(0, head_w.shape[0], qb)):
            hi = lo + qb
            s, i = _bm25_block(
                self.head_dense, self.tail_docs, self.tail_w,
                upload(head_w16[lo:hi], self.device),
                *(upload(a[blk], self.device) for a in pools),
                k=k_eff, l_mid=self.l_mid, l_small=self.l_small,
                n_docs=self.index.n_docs)
            yield lo, hi, s, i

    def search_batch(self, queries: Sequence[str], k: int = 100
                     ) -> Tuple[List[List[float]], List[List[int]]]:
        nq = len(queries)
        if nq == 0:
            return [], []
        k_eff = min(k, self.index.n_docs)
        if k_eff == 0:  # empty corpus: nothing retrievable
            return [[] for _ in queries], [[] for _ in queries]
        plan, overflow = self._plan(queries)
        self.last_overflow = len(overflow)
        n_pad = plan[0].shape[0]
        scores_out = np.zeros((n_pad, k_eff), np.float32)
        ids_out = np.zeros((n_pad, k_eff), np.int64)
        # enqueue every block (and its copy to the host) before reading
        # any result: the card runs the blocks back to back while a
        # per-block read would put a host round-trip between them
        pending = [(lo, hi, HostCopy(s, i))
                   for lo, hi, s, i in self._score_blocks(plan, k_eff)]
        for lo, hi, copy in pending:
            s, i = copy.result()
            scores_out[lo:hi] = s.numpy()
            ids_out[lo:hi] = i.numpy()
        scores_batch: List[List[float]] = []
        indices_batch: List[List[int]] = []
        for q in range(nq):
            # zero-score docs (incl. padding columns) are "not retrieved"
            keep = (scores_out[q] > 0) & (ids_out[q] < self.index.n_docs)
            scores_batch.append(scores_out[q][keep].tolist())
            indices_batch.append(ids_out[q][keep].tolist())
        if overflow:
            fb_s, fb_i = self.index.search_batch(
                [queries[i] for i in overflow], k=k)
            for pos, i in enumerate(overflow):
                scores_batch[i] = fb_s[pos]
                indices_batch[i] = fb_i[pos]
        return scores_batch, indices_batch

    def search_batch_device(self, queries: Sequence[str], k: int = 100):
        """Like :meth:`search_batch` but the results STAY on the device in
        the framework pad convention (score -inf, id INT32_MAX for
        not-retrieved) — (n_pad, k) f32 scores + int32 ids, ready for
        `ops.fusion.fuse_topk`, with no pull-pad-reupload round trip.
        Overflow queries' host-fallback rows are written back in with one
        small device update. Nothing here waits for the device."""
        nq = len(queries)
        k_eff = min(k, self.index.n_docs)
        if nq == 0 or k_eff == 0:
            pad_rows = max(_round_up(max(nq, 1), self.q_block), 1)
            shape = (pad_rows, max(k_eff, 1))
            return (torch.full(shape, mips.NEG_INF, device=self.device),
                    torch.full(shape, mips.INT32_MAX, dtype=torch.int32,
                               device=self.device))
        plan, overflow = self._plan(queries)
        self.last_overflow = len(overflow)
        outs = [(s, i) for _, _, s, i in self._score_blocks(plan, k_eff)]
        fb = None
        if overflow:
            fb_s, fb_i = self.index.search_batch(
                [queries[i] for i in overflow], k=k_eff)
            fb_scores = np.full((len(overflow), k_eff), -np.inf,
                                np.float32)
            fb_ids = np.full((len(overflow), k_eff),
                             np.iinfo(np.int32).max, np.int32)
            for pos in range(len(overflow)):
                fb_scores[pos, : len(fb_s[pos])] = fb_s[pos]
                fb_ids[pos, : len(fb_i[pos])] = fb_i[pos]
            fb = (upload(np.asarray(overflow, np.int64), self.device),
                  upload(fb_scores, self.device),
                  upload(fb_ids, self.device))
        return _finalize_device(
            tuple(s for s, _ in outs), tuple(i for _, i in outs), fb,
            n_docs=self.index.n_docs)
