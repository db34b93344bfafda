"""The drivers that a traffic file names by its ``entry``: one class each,
a key of ``ENTRIES`` here or the ``ENTRY`` of ``perfbench/drivers/<entry>.py``
(:func:`entry_class`).

``__init__`` draws the traffic from the seed and builds nothing, so the
control and the tests can use the same questions; ``build`` sets up the
program and warms up the shapes the traffic uses; ``window`` measures;
``release`` frees the program; ``judge`` compares what the window
produced with the plain reference; ``control`` puts the reference, in the
precision below the configuration's, in the program's place and judges it
by the same numbers.

Seeds: every thing drawn from the run's ``--seed`` has a stream of its own
(``STREAM``), so the program and the reference draw the same weights, KB
and text from it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import math
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch

from perfbench import gen, roofline, weights
from perfbench.trace import span

STREAM = {"question_tower": 1, "context_tower": 2, "reader": 3, "kb": 4,
          "questions": 5, "passages": 6, "arrivals": 7, "sample": 8}
BERT_KEYS = ("vocab_size", "hidden_size", "num_hidden_layers",
             "num_attention_heads", "intermediate_size",
             "max_position_embeddings", "type_vocab_size", "hidden_act",
             "layer_norm_eps")
# the control of a bf16 program: fp8 e4m3 products (reference/bert.py)
CONTROL_QUANT = "fp8"


def bert_block(conf: dict) -> dict:
    """The encoder's sizes, and the std of its drawn weights as
    ``initializer_range`` (BERT's 0.02 where the group does not say)."""
    return dict({k: conf[k] for k in BERT_KEYS},
                initializer_range=conf.get("initializer_range", 0.02))


def rng_of(seed: int, stream: str, *more) -> np.random.Generator:
    return np.random.default_rng((seed % 2**63, STREAM[stream], *more))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@dataclasses.dataclass
class Window:
    """What a window hands back: its end-to-end values, its counts and
    what the per-layer readers read (``facts``)."""
    values: Dict[str, float]
    attempted: int
    failed: int
    facts: Dict[str, Any]
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


# ---- the program, built from the benchmark's own draws ----------------------
def port_bert(b: dict, w: Dict[str, torch.Tensor], dropout: bool = False):
    """``models.bert.BertConfig`` and ``Bert`` holding the drawn tensors
    ``w`` (frozen, for serving)."""
    from viquae_torch.models import bert

    extra = ({"hidden_dropout_prob": b["hidden_dropout_prob"],
              "attention_probs_dropout_prob":
                  b["attention_probs_dropout_prob"]} if dropout else {})
    cfg = bert.BertConfig(**{k: b[k] for k in BERT_KEYS}, add_pooler=False,
                          **extra)
    with torch.device("meta"):
        model = bert.Bert(cfg)
    model.load_state_dict(w, strict=True, assign=True)
    return model, cfg


def port_reader(b: dict, w: Dict[str, torch.Tensor]):
    from viquae_torch.models import bert, qa

    cfg = qa.ReaderConfig(bert=bert.BertConfig(
        **{k: b[k] for k in BERT_KEYS}, add_pooler=False))
    with torch.device("meta"):
        model = qa.Reader(cfg)
    model.load_state_dict(w, strict=True, assign=True)
    return model.requires_grad_(False).eval(), cfg


def draw_tower(b: dict, seed: int, stream: str, device, dtype):
    return weights.draw(weights.bert_shapes(b),
                        weights.stream_seed(seed, STREAM[stream]), device,
                        dtype, b["initializer_range"])


def draw_reader(b: dict, seed: int, device):
    return weights.draw(weights.reader_shapes(b),
                        weights.stream_seed(seed, STREAM["reader"]), device,
                        torch.bfloat16, b["initializer_range"])


def draw_kb(rows: int, dim: int, seed: int, device) -> torch.Tensor:
    """N(0, 1/d) bf16 rows drawn on the device (``chip_smoke.main_kb``)."""
    gen_ = torch.Generator(device=device).manual_seed(
        weights.stream_seed(seed, STREAM["kb"]))
    return torch.randn((rows, dim), generator=gen_, device=device,
                       dtype=torch.bfloat16) / math.sqrt(dim)


def fresh_timer(pipe) -> None:
    from viquae_torch.core.profiling import StageTimer

    pipe.timer = StageTimer(pipe.timer.name)


def closed_loop(seconds: float, call, device=None) -> tuple:
    """Calls ``call(i)`` one after another while the window is open: the
    last call starts before the close and is waited for (on ``device``
    too, where a call leaves work queued there), so the rate is all the
    work over all the time. Returns (calls, seconds)."""
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        call(n)
        n += 1
    if device is not None:
        sync(device)
    return n, time.perf_counter() - t0


def longest_first_sample(rng, lengths: List[int], size: int) -> List[int]:
    """``size`` distinct positions drawn by ``rng``, the longest text's
    first."""
    longest = int(np.argmax(lengths))
    rest = [i for i in rng.permutation(len(lengths))[: size] if i != longest]
    return [longest] + rest[: size - 1]


class Entry:
    """The steps every driver takes; see the module's docstring."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.conf, self.traf = cell.config, cell.traffic

    def build(self) -> None:
        raise NotImplementedError

    def window(self, seconds: float) -> Window:
        raise NotImplementedError

    def release(self) -> None:
        raise NotImplementedError

    def judge(self) -> Dict[str, float]:
        raise NotImplementedError

    def control(self) -> Dict[str, float]:
        raise NotImplementedError


# ---- retrieval: the DPR question tower and the exact search ----------------
class Retrieval(Entry):
    """What the retrieval cells share: the tower (``bert_block``), the
    serving options (``port``), the KB and its judging."""

    def __init__(self, cell, seed, device, conf=None):
        super().__init__(cell, seed, device)
        conf = self.conf if conf is None else conf
        self.rb, self.rport = bert_block(conf), conf["port"]
        self.kb_rows = self.conf["kb_rows"]
        # the top-k that is judged
        self.k = self.rport["k"]
        self.tok = gen.tokenizer(self.rb["vocab_size"])

    def pipeline(self, batch, fixed_rows=None):
        """DPR question tower (bf16) + exact fused index (B1) + the fused
        serving pipeline, as ``python -m viquae_torch serve`` builds
        them."""
        from viquae_torch.ir.embedding import PackedTextEmbedder
        from viquae_torch.ir.serving import FusedRetrievalPipeline
        from viquae_torch.models import dpr
        from viquae_torch.ops import mips

        cell, b, port, device = self.cell, self.rb, self.rport, self.device
        cell.mark("program imported")
        model, bcfg = port_bert(b, draw_tower(
            b, self.seed, "question_tower", device, torch.bfloat16))
        model.requires_grad_(False).eval()
        sync(device)
        cell.mark("tower drawn")
        kb = draw_kb(self.kb_rows, port["kb_dim"], self.seed, device)
        index = mips.DenseIndex(kb, mode=port["index_mode"], device=device)
        del kb
        sync(device)
        cell.mark("KB drawn and indexed")
        embedder = PackedTextEmbedder(
            dpr.make_packed_apply(dpr.DPRConfig(bert=bcfg)), model, self.tok,
            row_len=port["row_len"], batch_size=batch,
            compute_dtype=torch.bfloat16, fixed_rows=fixed_rows,
            device=device)
        return FusedRetrievalPipeline(embedder, index, batch_size=batch,
                                      k=port["k"])

    def search_flops(self, queries: int) -> float:
        return roofline.search_flops(queries, self.kb_rows,
                                     self.rport["kb_dim"])

    def judge_retrieval(self, texts, got_scores, got_ids, k) -> dict:
        """The reference's question vectors and exact search for
        ``texts`` against the program's (scores, ids)."""
        from perfbench.reference import retrieval as ref

        b, device = self.rb, self.device
        w = draw_tower(b, self.seed, "question_tower", device,
                       torch.bfloat16)
        q = ref.embed(w, b, self.tok, texts, self.rport["row_len"], device)
        del w
        kb = draw_kb(self.kb_rows, self.rport["kb_dim"], self.seed, device)
        out = ref.judge(np.stack(got_scores), np.stack(got_ids), q, kb, k)
        del kb
        free(device)
        return out

    def control_retrieval(self, texts, k):
        """The reference in ``CONTROL_QUANT`` put in the program's place:
        its top-k (scores, ids) for ``texts``."""
        from perfbench.reference import retrieval as ref

        b, device = self.rb, self.device
        w = draw_tower(b, self.seed, "question_tower", device,
                       torch.bfloat16)
        q = ref.embed(w, b, self.tok, texts, self.rport["row_len"], device,
                      CONTROL_QUANT)
        kb = draw_kb(self.kb_rows, self.rport["kb_dim"], self.seed, device)
        s, i = ref.search(q, kb, k, CONTROL_QUANT)
        del kb, w
        free(device)
        return s.cpu().numpy(), i.cpu().numpy()

    def control(self):
        texts = self.judged_texts(self.pool_size())
        s, i = self.control_retrieval(texts, self.k)
        return self.judge_retrieval(texts, list(s), list(i), self.k)


class CallPool(Retrieval):
    """A closed loop over a pool of calls of ``per_call`` questions; the
    judged questions are drawn from the seed over the calls made, the
    longest question of the first call first."""

    per_call: int
    pool: List[List[str]]

    def pool_size(self) -> int:
        return len(self.pool)

    def picks(self, calls: int):
        """(call, row) of each judged question."""
        flat = [(c, r) for c in range(calls) for r in range(self.per_call)]
        lengths = [gen.token_count(self.pool[0][r]) if c == 0 else 0
                   for c, r in flat]
        return [flat[j] for j in longest_first_sample(
            rng_of(self.seed, "sample"), lengths,
            self.traf["check"]["questions"])]

    def judged_texts(self, calls: int) -> List[str]:
        return [gen.cycle(self.pool, c)[r] for c, r in self.picks(calls)]


# ---- retrieve_batch: closed loop of FusedRetrievalPipeline.run_arrays -------
class RetrieveBatch(CallPool):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        traf = self.traf
        self.per_call = traf["batch"] * traf["batches_per_call"]
        rng = rng_of(seed, "questions")
        self.pool = [gen.questions(rng, self.per_call, traf["questions"])
                     for _ in range(traf["pool_calls"])]
        cell.mark("traffic and tokenizer")

    def build(self):
        self.pipe = self.pipeline(self.traf["batch"])
        for qs in self.pool:    # every canvas this traffic packs
            self.pipe.run_arrays(qs)
        sync(self.device)
        fresh_timer(self.pipe)

    def window(self, seconds):
        results = []

        def call(i):
            qs = gen.cycle(self.pool, i)
            with span("run_arrays"):
                scores, ids = self.pipe.run_arrays(qs)
            results.append((scores, ids))

        calls, wall = closed_loop(seconds, call)
        self.results = results
        lengths = [[gen.token_count(q) for q in qs] for qs in self.pool]
        queries = calls * self.per_call
        encoder = sum(roofline.encoder_flops(self.rb, gen.cycle(lengths, c))
                      for c in range(calls))
        return Window({"queries_per_s": queries / wall}, queries, 0, {
            "report": self.pipe.report(), "wall_s": wall,
            "b1_q": self.traf["batch"], "kb_rows": self.kb_rows,
            "dim": self.rport["kb_dim"],
            "model_flops": encoder + self.search_flops(queries),
            "peak_flops": roofline.PEAKS["bf16"]})

    def release(self):
        del self.pipe

    def judge(self):
        picks = self.picks(len(self.results))
        return self.judge_retrieval(
            self.judged_texts(len(self.results)),
            [self.results[c][0][r] for c, r in picks],
            [self.results[c][1][r] for c, r in picks], self.k)


# ---- answer_batch: closed loop of AnswerPipeline.run ------------------------
class AnswerBatch(CallPool):
    """Retrieval by the configuration's ``retriever`` group, then the
    packed reader of the configuration's own widths."""

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device, conf=cell.config["retriever"])
        traf = self.traf
        self.b, self.port = bert_block(self.conf), self.conf["port"]
        self.k = self.port["m_passages"]
        self.per_call = traf["questions_per_call"]
        rng = rng_of(seed, "questions")
        self.pool = [gen.questions(rng, self.per_call, traf["questions"])
                     for _ in range(traf["pool_calls"])]
        cell.mark("traffic and tokenizer")
        self.passages = gen.LazyPassages(
            self.kb_rows, weights.stream_seed(seed, STREAM["passages"]),
            traf["passages"])
        self.kept: Dict[int, dict] = {}

    def kept_steps(self, call_no: int) -> set:
        """The reader steps of a call whose logits are kept: the step of
        its longest question and one drawn from the seed."""
        per = self.port["questions_per_step"]
        questions = gen.cycle(self.pool, call_no)
        steps = -(-len(questions) // per)
        longest = int(np.argmax([gen.token_count(q) for q in questions]))
        other = int(rng_of(self.seed, "sample", call_no).integers(steps))
        return {longest // per, other}

    def build(self):
        from viquae_torch.ir.qa_serving import AnswerPipeline

        retrieval = self.pipeline(self.traf["retrieval_batch"])
        reader, rcfg = port_reader(self.b, draw_reader(self.b, self.seed,
                                                       self.device))
        sync(self.device)
        self.cell.mark("reader drawn")
        port = self.port
        self.pipe = AnswerPipeline(
            retrieval, self.passages, rcfg, reader, self.tok,
            m_passages=port["m_passages"], reader_seq=port["reader_seq"],
            passage_tokens_key="passage_tokens",
            questions_per_step=port["questions_per_step"],
            compute_dtype=torch.bfloat16,
            packed_reader=port["packed_reader"], device=self.device)
        self._capture()
        # one call: the eager program compiles nothing, so a call's shapes
        # stand for the others' (the canvases differ by a few rows)
        self.run_call(0)
        sync(self.device)
        fresh_timer(self.pipe)
        fresh_timer(self.pipe.retrieval)
        self.kept.clear()

    def _capture(self):
        """Keeps the logits that ``read_packed`` hands to span selection
        (and the spans chosen) for the steps to keep."""
        orig = self.pipe._postprocess
        self.keep_now, self.step, self.call_no = set(), 0, 0

        def capture(start_logits, end_logits, mask):
            spans = orig(start_logits, end_logits, mask)
            if self.step in self.keep_now:
                self.kept.setdefault(self.call_no, {})[self.step] = (
                    start_logits, end_logits, spans)
            self.step += 1
            return spans

        self.pipe._postprocess = capture

    def run_call(self, call_no: int):
        self.call_no, self.step = call_no, 0
        self.keep_now = self.kept_steps(call_no)
        return self.pipe.run(gen.cycle(self.pool, call_no))

    def window(self, seconds):
        results = []

        def call(i):
            with span("answer_run"):
                results.append(self.run_call(i))

        calls, wall = closed_loop(seconds, call)
        self.results = results
        m, seq = self.port["m_passages"], self.port["reader_seq"]
        flops = 0.0
        for c, out in enumerate(results):
            qs = gen.cycle(self.pool, c)
            flops += roofline.encoder_flops(
                self.rb, [gen.token_count(q) for q in qs])
            head = self.tok(qs, add_special_tokens=False, truncation=True,
                            max_length=seq // 2)["input_ids"]
            flops += roofline.encoder_flops(self.b, [
                min(len(h) + 3 + len(self.passages.tokens(d)), seq)
                for h, o in zip(head, out) for d in o["passage_ids"][:m]])
        answers = calls * self.per_call
        return Window({"answers_per_s": answers / wall}, answers, 0, {
            "report": self.pipe.report(), "wall_s": wall,
            "model_flops": flops + self.search_flops(answers),
            "peak_flops": roofline.PEAKS["bf16"]})

    def release(self):
        per = self.port["questions_per_step"]
        self.steps = []
        for call_no, out in enumerate(self.results):
            for step, (s_log, e_log, spans) in sorted(
                    self.kept.get(call_no, {}).items()):
                lo = step * per
                self.steps.append((
                    gen.cycle(self.pool, call_no)[lo: lo + per],
                    [o["passage_ids"] for o in out[lo: lo + per]],
                    s_log.cpu(), e_log.cpu(),
                    tuple(t.cpu().numpy() for t in spans),
                    [o["answer"] for o in out[lo: lo + per]]))
        self.kept.clear()
        del self.pipe

    def judge(self):
        m = self.k
        picks = self.picks(len(self.results))
        got = [self.results[c][r] for c, r in picks]
        out = self.judge_retrieval(
            self.judged_texts(len(self.results)),
            [np.asarray(g["scores"][:m], np.float32) for g in got],
            [np.asarray(g["passage_ids"][:m]) for g in got], m)
        out.update(self.judge_reader(self.steps))
        return out

    def judge_reader(self, steps, quant=None) -> dict:
        """``logit_gap``, ``span_mismatches`` and ``answer_mismatches``
        over the kept steps: [(questions, passage ids, start, end, spans,
        answers)], spans None where there are none to judge."""
        from perfbench.reference import reader as ref

        b, device = self.b, self.device
        w = draw_reader(b, self.seed, device)
        m, seq = self.port["m_passages"], self.port["reader_seq"]
        gap, spans_bad, answers_bad = 0.0, 0, 0
        for qs, pids, g_start, g_end, spans, answers in steps:
            ids, mask, tt = ref.pair_rows(self.tok, qs, pids, self.passages,
                                          m, seq)
            if g_start is None:     # the control: the reference in quant
                g_start, g_end = ref.logits(w, b, ids, mask, tt, device,
                                            quant)
            r_start, r_end = ref.logits(w, b, ids, mask, tt, device)
            rows = len(qs) * m
            gap = max(gap, ref.logit_gap(g_start[:rows], g_end[:rows],
                                         r_start, r_end, mask))
            if spans is not None:
                best, pair = ref.best_spans(g_start[:rows].to(device),
                                            g_end[:rows].to(device), mask, m)
                spans_bad += ref.span_mismatches(pair, best, *spans)
                answers_bad += ref.answer_mismatches(self.tok, ids, answers,
                                                     *spans, m)
        del w
        free(device)
        out = {"logit_gap": gap}
        if any(s[4] is not None for s in steps):
            out.update(span_mismatches=spans_bad,
                       answer_mismatches=answers_bad)
        return out

    def control(self):
        out = super().control()
        per = self.port["questions_per_step"]
        steps = []
        for c in range(self.pool_size()):
            for step in sorted(self.kept_steps(c)):
                sub = self.pool[c][step * per: (step + 1) * per]
                _, ids = self.control_retrieval(sub, self.k)
                steps.append((sub, ids, None, None, None, None))
        out.update(self.judge_reader(steps, CONTROL_QUANT))
        return out


# ---- search_online: open loop into BatchedRetrievalService.search ----------
class RecordedPipeline:
    """The pipeline handed to the service, recording the host wall of each
    dispatch (results end on the host, so the time is synchronous;
    ``chip_smoke.RecordedBatches``)."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.k = pipe.k
        self.dispatch_s: List[float] = []

    def run_arrays(self, queries):
        t0 = time.perf_counter()
        with span("dispatch"):
            out = self.pipe.run_arrays(queries)
        self.dispatch_s.append(time.perf_counter() - t0)
        return out


class SearchOnline(Retrieval):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.pool = gen.questions(rng_of(seed, "questions"),
                                  self.traf["pool"], self.traf["questions"])
        self.arrival_rng = rng_of(seed, "arrivals")
        cell.mark("traffic and tokenizer")

    def pool_size(self) -> int:
        return len(self.pool)

    def picks(self, requests: int) -> List[int]:
        """The requests whose answers are compared: drawn from the seed
        among all the window sends, its longest question first."""
        lengths = [gen.token_count(gen.cycle(self.pool, i))
                   for i in range(requests)]
        return longest_first_sample(rng_of(self.seed, "sample"), lengths,
                                    self.traf["check"]["questions"])

    def judged_texts(self, requests: int) -> List[str]:
        return [gen.cycle(self.pool, i) for i in self.picks(requests)]

    def build(self):
        from viquae_torch.ir.server import BatchedRetrievalService

        traf = self.traf
        pipe = self.pipeline(traf["max_batch"], fixed_rows=traf["fixed_rows"])
        self.recorded = RecordedPipeline(pipe)
        self.service = BatchedRetrievalService(
            self.recorded, max_batch=traf["max_batch"],
            max_wait_ms=traf["max_wait_ms"],
            max_inflight=traf["max_inflight"])
        # the one padded shape, alone and with max_inflight dispatches
        for burst in range(4):
            futures = [self.service.batcher.submit(q) for q in self.pool[
                burst * traf["max_batch"]: (burst + 2) * traf["max_batch"]]]
            for f in futures:
                f.result(timeout=300)
        sync(self.device)
        fresh_timer(pipe)

    def window(self, seconds, rate=None):
        """Requests due at Poisson times at ``rate`` (the mix's own by
        default) for ``seconds``; each timed from when it was due. The
        responses of the judged requests are kept, no others."""
        traf = self.traf
        rate = traf["rate_per_s"] if rate is None else rate
        due = gen.poisson_arrivals(self.arrival_rng, rate, seconds)
        n = len(due)
        keep = set(self.picks(n))
        done = np.full(n, math.nan)
        errors: Dict[int, BaseException] = {}
        kept: Dict[int, dict] = {}
        late = np.zeros(n)
        left = [n]
        lock = threading.Lock()
        all_done = threading.Event()
        batcher = self.service.batcher
        d0, i0 = batcher.n_dispatches, batcher.n_items
        self.recorded.dispatch_s.clear()

        def finish(i):
            def cb(f):
                done[i] = time.perf_counter()
                e = f.exception()
                if e is not None:
                    errors[i] = e
                elif i in keep:
                    kept[i] = f.result()
                with lock:
                    left[0] -= 1
                    if not left[0]:
                        all_done.set()
            return cb

        t0 = time.perf_counter() + 0.005
        for i in range(n):
            target = t0 + due[i]
            wait = target - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[i] = time.perf_counter() - target
            with span("submit"):
                f = batcher.submit(gen.cycle(self.pool, i))
            f.add_done_callback(finish(i))
        # an answer that comes late is late, not missing: wait up to a
        # minute past the close
        all_done.wait(timeout=max(1.0, t0 + seconds + 60
                                  - time.perf_counter()))
        latency = done - (t0 + due)
        latency[np.isnan(latency)] = math.inf
        for i in errors:
            latency[i] = math.inf
        self.kept, self.requests = kept, n
        p50 = float(np.percentile(latency, 50)) * 1e3 \
            if np.isfinite(latency).all() else math.inf
        late_ms = {"late_p95_ms": float(np.percentile(late, 95) * 1e3),
                   "late_max_ms": float(late.max() * 1e3),
                   "latency_ms": {f"p{q}": float(np.percentile(latency, q)
                                                 * 1e3)
                                  for q in (50, 90, 95, 99)},
                   "dispatch_ms_mean": 1e3 * float(np.mean(
                       self.recorded.dispatch_s or [math.nan]))}
        print(f"generator lateness: p95 {late_ms['late_p95_ms']:.3f} ms, "
              f"max {late_ms['late_max_ms']:.3f} ms over {n} requests at "
              f"{rate} a second", file=sys.stderr)
        return Window({"search_p50_ms": p50}, n,
                      int(np.isinf(latency).sum()), {
                          "n_dispatches": batcher.n_dispatches - d0,
                          "n_items": batcher.n_items - i0,
                          "max_batch": traf["max_batch"],
                          "dispatch_s": list(self.recorded.dispatch_s),
                          "latency_s": latency},
                      notes=late_ms)

    def release(self):
        self.service.close()
        del self.service, self.recorded

    def judge(self):
        picks = [i for i in self.picks(self.requests) if i in self.kept]
        if not picks:
            return {"rank_gap": math.inf, "score_gap": math.inf,
                    "bad_ids": 0}
        got = [self.kept[i] for i in picks]
        return self.judge_retrieval(
            [gen.cycle(self.pool, i) for i in picks],
            [np.asarray(g["scores"], np.float32) for g in got],
            [np.asarray(g["indices"]) for g in got], self.k)


# ---- train_dpr: Trainer.fit on the DPR biencoder ---------------------------
class TrainDPR(Entry):
    """One ``Trainer`` built in set-up, driven through its first steps on
    batches that all differ (those the reference follows), then handed to
    the window, which calls ``Trainer.fit`` one step at a time over a
    pool of the same batches, collating each on the host. The items are
    those of ``chip_smoke.dpr_train_items`` (l. 3284): a KB of two
    passages a question, its positive and its BM25 negative."""

    TOWERS = ("question", "context")

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        conf, traf = self.conf, self.traf
        self.b = dict(bert_block(conf),
                      hidden_dropout_prob=conf["hidden_dropout_prob"],
                      attention_probs_dropout_prob=conf[
                          "attention_probs_dropout_prob"])
        self.tok = gen.tokenizer(self.b["vocab_size"])
        n = traf["batch"]
        rng = rng_of(seed, "questions")
        # each step: its questions, their positives and their negatives
        self.steps = [(gen.questions(rng, n, traf["questions"]),
                       gen.questions(rng, n, traf["passages"]),
                       gen.questions(rng, n, traf["passages"]))
                      for _ in range(traf["pool_steps"])]
        self.collate_s: List[float] = []
        cell.mark("traffic and tokenizer")

    def items(self, step: int) -> List[dict]:
        """The collator's items of a pool step: question i's positive is
        passage 2 n s + i of the KB, its BM25 negative n rows on."""
        n, base = self.traf["batch"], 2 * self.traf["batch"] * step
        qs = self.steps[step][0]
        return [{"input": q, "BM25_provenance_indices": [base + i],
                 "BM25_irrelevant_indices": [base + n + i]}
                for i, q in enumerate(qs)]

    def build(self):
        from viquae_torch.models import dpr
        from viquae_torch.train import data as tdata
        from viquae_torch.train import optim
        from viquae_torch.train.trainee import BiEncoderTrainee
        from viquae_torch.train.trainer import Trainer, TrainerConfig

        conf, traf, device = self.conf, self.traf, self.device
        self.cell.mark("program imported")
        torch.backends.cuda.matmul.allow_tf32 = conf["train"]["tf32"]
        torch.backends.cudnn.allow_tf32 = conf["train"]["tf32"]
        towers = []
        for tower in self.TOWERS:
            model, bcfg = port_bert(self.b, draw_tower(
                self.b, self.seed, f"{tower}_tower", device, torch.float32),
                dropout=True)
            towers.append(dpr.DPREncoder(cfg=dpr.DPRConfig(bert=bcfg),
                                         params=model))
        trainee = BiEncoderTrainee(
            *towers, remat_layers=conf["train"]["remat_layers"])
        kb = [{"passage": p} for _, pos, neg in self.steps
              for p in pos + neg]
        self.collator = tdata.BiEncoderCollator(
            self.tok, kb=kb, M=traf["m"], n_relevant_passages=1,
            search_key="BM25", max_length=traf["max_length"],
            packed=traf["packed"], seed=self.seed % 2**32)
        self.losses: List[torch.Tensor] = []
        checked = traf["check"]["steps"]

        def loss_fn(params, batch, generator=None, deterministic=False):
            loss, aux = trainee.loss_fn(params, batch, generator,
                                        deterministic)
            if len(self.losses) < checked:
                self.losses.append(loss.detach())
            return loss, aux

        self.trainer = Trainer(
            loss_fn, trainee.params,
            optim.make_optimizer(trainee.params, **traf["optimizer"]),
            TrainerConfig(max_steps=1, log_every=0, seed=self.seed % 2**32))
        del towers
        sync(device)
        self.cell.mark("towers drawn")
        named = list(self.trainer.state.params.named_parameters())
        start = [p.detach().clone() for _, p in named]
        adam = self.trainer.state.optimizer.adamw
        beta1 = adam.param_groups[0]["betas"][0]
        for step in range(checked):
            self.step(step)
            if step == 0:
                # the first gradient as the optimizer got it, after clipping
                grad = {name: torch.linalg.vector_norm(adam.state[p][
                    "exp_avg"]) / (1 - beta1) if p in adam.state else 0.0
                    for name, p in named}
        self.readings = {
            "losses": [float(x) for x in self.losses],
            "grad_norms": {k: float(v) for k, v in grad.items()},
            "change_norms": {name: float(torch.linalg.vector_norm(
                p.detach() - s)) for (name, p), s in zip(named, start)}}
        del start
        sync(device)
        self.done = checked

    def step(self, i: int) -> None:
        """One optimizer step of ``Trainer.fit`` on pool step ``i``,
        collated on the host."""
        t0 = time.perf_counter()
        with span("collate"):
            batch = self.collator.collate_fn(
                self.items(i % len(self.steps)))
        self.collate_s.append(time.perf_counter() - t0)
        with span("fit_step"):
            self.trainer.fit(lambda _: batch)

    def window(self, seconds):
        self.collate_s = []
        calls, wall = closed_loop(
            seconds, lambda i: self.step(self.done + i), self.device)
        n = self.traf["batch"]
        flops = 0.0
        for c in range(calls):
            qs, pos, neg = gen.cycle(self.steps, self.done + c)
            flops += roofline.encoder_flops(
                self.b, [gen.token_count(q) for q in qs], train=True)
            flops += roofline.encoder_flops(
                self.b, [gen.token_count(p) for p in pos + neg], train=True)
            # the similarities' product and its two gradients
            flops += 3 * 2.0 * n * 2 * n * self.b["hidden_size"]
        items = calls * n
        return Window({"train_items_per_s": items / wall}, items, 0, {
            "wall_s": wall, "model_flops": flops,
            "peak_flops": roofline.PEAKS[self.conf["train"]["dtype"]],
            "collate_s": list(self.collate_s)})

    def release(self):
        del self.trainer, self.collator

    def batches(self) -> List[dict]:
        """The first steps' batches as the reference takes them: its own
        tokenization of the same texts, positives then negatives."""
        from perfbench.reference import train as ref

        out = []
        for qs, pos, neg in self.steps[: self.traf["check"]["steps"]]:
            out.append({
                "question": ref.token_rows(self.tok, qs,
                                           self.traf["max_length"]),
                "context": ref.token_rows(self.tok, pos + neg,
                                          self.traf["max_length"]),
                "labels": list(range(len(qs)))})
        return out

    def reference(self, control: bool = False) -> dict:
        from perfbench.reference import train as ref

        towers = {t: draw_tower(self.b, self.seed, f"{t}_tower", self.device,
                                torch.float32) for t in self.TOWERS}
        out = ref.train(towers, self.b, self.batches(),
                        self.traf["optimizer"], self.device, control)
        del towers
        free(self.device)
        return out

    def judge(self):
        from perfbench.reference import train as ref

        return ref.judge(self.readings, self.reference())

    def control(self):
        from perfbench.reference import train as ref

        return ref.judge(self.reference(control=True), self.reference())


ENTRIES = {"retrieve_batch": RetrieveBatch, "answer_batch": AnswerBatch,
           "search_online": SearchOnline, "train_dpr": TrainDPR}


# a checkout's driver files, loaded once each: a class patched in a test
# stays the class that later runs get
_DRIVERS: Dict[Path, type] = {}


def entry_class(name: str, root=None) -> type:
    """The driver a traffic file's ``entry`` names: ``ENTRIES[name]``, else
    the ``ENTRY`` of ``perfbench/drivers/<name>.py`` under ``root`` (by
    default this checkout)."""
    if name in ENTRIES:
        return ENTRIES[name]
    root = Path(__file__).resolve().parents[1] if root is None else root
    path = (Path(root) / "perfbench" / "drivers" / f"{name}.py").resolve()
    if path not in _DRIVERS:
        if not path.is_file():
            raise LookupError(
                f"no driver {name!r}: it is neither a key of ENTRIES in "
                f"perfbench/entries.py ({', '.join(sorted(ENTRIES))}) nor "
                f"a file perfbench/drivers/{name}.py")
        spec = importlib.util.spec_from_file_location(
            "perfbench_driver_" + name.replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _DRIVERS[path] = module.ENTRY
    return _DRIVERS[path]


def driver_classes(root=None) -> List[type]:
    """Every driver class: those of ``ENTRIES`` and of each file in
    ``perfbench/drivers/`` under ``root``."""
    root = Path(__file__).resolve().parents[1] if root is None else root
    files = sorted((Path(root) / "perfbench" / "drivers").glob("*.py"))
    return list(dict.fromkeys(list(ENTRIES.values()) + [
        entry_class(f.stem, root) for f in files
        if not f.stem.startswith("_")]))
