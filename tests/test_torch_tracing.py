"""The port's in-program tracer (viquae_torch/core/profiling.py) and the
spans and counters at its layer boundaries: the batcher, the embedder, the
prefetch producer, the answer loop, the collator and the Trainer, on the
CPU. Tracing is on while a torch profiler runs anywhere in the process;
each test below opens its own profile, and every recorder read is of that
profile's window."""
import contextlib
import gc
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from viquae_torch.core import profiling

torch.set_num_threads(2)

TINY = dict(vocab_size=300, hidden_size=24, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=48,
            max_position_embeddings=64, add_pooler=False)


def untraced_call():
    """A program call between two traced windows, as every real run has:
    the recorder starts a new recording when it sees tracing turn on."""
    with profiling.span("between"):
        pass


@contextlib.contextmanager
def traced():
    untraced_call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        yield prof


def in_thread(fn):
    box = {}

    def target():
        box["out"] = fn()

    t = threading.Thread(target=target)
    t.start()
    t.join()
    return box["out"]


@pytest.fixture(scope="module")
def tok(tmp_path_factory):
    from transformers import BertTokenizerFast

    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [f"w{i}" for i in range(200)])
    d = tmp_path_factory.mktemp("tok")
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"))


@pytest.fixture(scope="module")
def retrieval(tok):
    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.ir.serving import FusedRetrievalPipeline
    from viquae_torch.models import bert, dpr
    from viquae_torch.ops import mips

    torch.manual_seed(0)
    cfg = bert.BertConfig(**TINY)
    emb = PackedTextEmbedder(
        dpr.make_packed_apply(dpr.DPRConfig(bert=cfg)), bert.Bert(cfg).eval(),
        tok, row_len=24, batch_size=8, compute_dtype=torch.float32,
        device="cpu")
    kb = np.random.default_rng(0).normal(size=(60, 24)).astype(np.float32)
    index = mips.DenseIndex(kb, mode="global", dtype=torch.float32,
                            device="cpu")
    return cfg, emb, index, FusedRetrievalPipeline(emb, index, batch_size=8,
                                                   k=3)


def questions(n, start=0):
    return [" ".join(f"w{j}" for j in range(i, i + 3 + i % 5))
            for i in range(start, start + n)]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------
def test_tracing_is_the_process_wide_profiler_flag():
    assert not profiling.tracing()
    assert not in_thread(profiling.tracing)
    with traced():
        assert profiling.tracing()
        assert in_thread(profiling.tracing)
        # the thread-local flag, which tracing() must not read
        assert torch._C._autograd._profiler_enabled()
        assert not in_thread(torch._C._autograd._profiler_enabled)
    assert not profiling.tracing()
    assert not in_thread(profiling.tracing)


def test_tracing_off_records_nothing_and_creates_no_event(monkeypatch):
    with traced():
        with profiling.span("kept"):
            pass
    before = profiling.recorded()

    def boom(*a, **k):
        raise AssertionError("created or read with tracing off")

    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(time, "time_ns", boom)
    with profiling.span("off", a=1) as s:
        assert s is None
    with profiling.device_span("off.device") as s:
        assert s is None
    profiling.count("off.count", 3)
    profiling.count_canvas("off", np.ones((2, 4), np.int32))
    profiling.interval("off.interval", 1, 2)
    timer = profiling.StageTimer("off")
    with timer.stage("stage"):
        pass
    monkeypatch.undo()
    after = profiling.recorded()
    assert [s.id for s in after.spans] == [s.id for s in before.spans]
    assert [s.name for s in after.spans] == ["kept"]
    assert {k: v for k, v in after.counters.items() if k != "gc.pause_s"} \
        == {}
    assert timer.report()["stage"]["count"] == 1


def test_span_lies_inside_the_profilers_range_around_it():
    """The recorder's clock is the profiler's: a span opened inside a
    ``record_function`` range lies inside that range's event."""
    with traced() as prof:
        with record_function("outer_range"):
            time.sleep(0.002)
            with profiling.span("inner") as s:
                time.sleep(0.002)
            time.sleep(0.002)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "outer_range"]
    assert len(events) == 1
    lo = events[0].start_ns()
    hi = lo + events[0].duration_ns()
    assert lo <= s.start_ns < s.end_ns <= hi
    assert s.seconds >= 0.002
    # the recorder's spans are not profiler events
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "inner" not in names


def test_parents_nest_within_a_thread_and_not_across():
    with traced():
        with profiling.span("a") as a:
            with profiling.span("b", x=1) as b:
                other = in_thread(lambda: profiling.span("c").__enter__())
    rec = profiling.recorded()
    assert b.parent == a.id and a.parent is None and b.attrs == {"x": 1}
    assert other.parent is None and other.thread != a.thread
    assert [s.name for s in rec.spans] == ["b", "a"]   # c never closed


def test_finished_spans_leave_the_collectors_walk():
    """A window records a span per request: once the collector has passed
    over them, the recorder's finished spans are objects it no longer
    tracks (so a full collection does not walk them). A span whose
    attributes are numbers and strings leaves at the first pass, one with
    a tuple among them (a dispatch's request ids) at the second."""
    with traced():
        for i in range(200):
            with profiling.span("dispatch", request=i) as s:
                s.attrs["requests"] = (i, i + 1)
            profiling.interval("wait", 1, 2, request=i, dispatch=s.id)
        gc.collect()
        rows = list(profiling._rows)
        tracked = {row[1] for row in rows if gc.is_tracked(row)}
        gc.collect()
    assert len(rows) == 400 and tracked <= {"dispatch"}
    assert not any(gc.is_tracked(row) for row in rows)
    rec = profiling.recorded()
    seventh = rec.named("dispatch")[7]
    assert seventh.attrs == {"request": 7, "requests": (7, 8)}
    assert rec.named("wait")[7].attrs == {"request": 7,
                                          "dispatch": seventh.id}


def test_second_session_holds_only_its_own_spans():
    with traced():
        with profiling.span("first"):
            pass
        profiling.count("n", 1)
    with traced():
        with profiling.span("second"):
            pass
        profiling.count("n", 2)
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["second"]
    assert rec.counters["n"] == 2


def test_device_span_has_no_device_time_on_the_cpu():
    """A span on the CPU device has no device time; one on the current
    device has it exactly where CUDA is in use (never on a CPU host)."""
    with traced():
        with profiling.device_span("step", "cpu", step=3) as s:
            torch.ones(8).sum()
        with profiling.device_span("step") as t:
            pass
    rec = profiling.recorded()
    assert [x.id for x in rec.named("step")] == [s.id, t.id]
    on_cpu, current = rec.named("step")
    assert on_cpu.device_s is None
    assert (current.device_s is None) == (not torch.cuda.is_initialized())
    assert s.attrs == {"step": 3} and s.end_ns >= s.start_ns


@pytest.mark.cuda
def test_device_span_times_the_work_enqueued_inside_it():
    """On the card: the span's device time is that of the work it enqueued
    (resolved when the recorder is read, with no synchronize inside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    with traced():
        with profiling.device_span("matmuls") as s:
            for _ in range(20):
                x = x @ x / 64.0
        with profiling.device_span("empty") as e:
            pass
    rec = profiling.recorded()
    (m,) = rec.named("matmuls")
    (empty,) = rec.named("empty")
    assert m.id == s.id and empty.id == e.id
    # 20 products of 4096^3 take longer than at the card's 989 TFLOP/s
    assert 20 * 2 * 4096 ** 3 / 989e12 < m.device_s < 5.0
    assert 0 <= empty.device_s < 1e-3


def test_collector_pauses_are_counted_and_full_collections_are_spans():
    with traced():
        with profiling.span("holder") as holder:
            gc.collect()
            gc.collect(0)
    rec = profiling.recorded()
    full = rec.named("python.gc")
    assert len(full) == 1 and full[0].parent == holder.id
    assert rec.counters["gc.pause_s"] >= full[0].seconds > 0
    assert profiling._gc_hook not in gc.callbacks or profiling.tracing()
    untraced_call()
    assert profiling._gc_hook not in gc.callbacks


class YieldingTotals(dict):
    """A dict of totals whose every read hands the interpreter to another
    thread (reading 0 for a missing key), so that an unguarded ``+=`` on
    it loses updates."""

    def __getitem__(self, key):
        value = dict.get(self, key, 0)
        time.sleep(0)
        return value


def test_stage_timer_totals_are_exact_across_threads(monkeypatch):
    """Each thread's clock ticks by exactly 1 a read, so every stage lasts
    1 and the totals must equal the counts, with the timer's reads and
    writes of its totals interleaved between the threads."""
    local = threading.local()

    def perf_counter():
        local.t = getattr(local, "t", -1) + 1
        return float(local.t)

    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=perf_counter, time_ns=time.time_ns))
    timer = profiling.StageTimer("t")
    timer.totals, timer.counts = YieldingTotals(), YieldingTotals()
    n = 2_000

    def work():
        for _ in range(n):
            with timer.stage("s"):
                pass

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report = timer.report()
    assert report["s"]["count"] == 2 * n
    assert report["s"]["total_s"] == 2.0 * n
    assert report["s"]["mean_s"] == 1.0


def test_recorder_keeps_every_span_and_count_from_many_threads():
    """More threads than cores, switching often: no span or count is
    lost."""
    threads_n, n = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with traced():
            def work():
                for _ in range(n):
                    with profiling.span("stress"):
                        profiling.count("stress.n", 1)

            threads = [threading.Thread(target=work)
                       for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rec = profiling.recorded()
    assert len(rec.named("stress")) == threads_n * n
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert rec.counters["stress.n"] == threads_n * n


def test_stage_is_a_span_named_after_the_timer():
    timer = profiling.StageTimer("pipe")
    with traced():
        with timer.stage("work") as held:
            assert held is None
    rec = profiling.recorded()
    assert [s.name for s in rec.spans] == ["pipe.work"]
    assert set(timer.report()["work"]) == {"total_s", "count", "mean_s"}


# ---------------------------------------------------------------------------
# the spans and counters at the layer boundaries
# ---------------------------------------------------------------------------
def test_batcher_loop_workers_and_prefetch_producer_spans(retrieval):
    """A retrieval service with two dispatches in flight: the loop's
    collect and slot-wait spans, each dispatch with its request ids, each
    request's wait naming its dispatch, and the pipeline's stages in the
    workers (under their dispatch) and in the prefetch producer (the
    embedder's spans under its stage)."""
    from viquae_torch.ir.server import BatchedRetrievalService

    pipe = retrieval[3]
    svc = BatchedRetrievalService(pipe, max_batch=4, max_wait_ms=5,
                                  max_inflight=2)
    try:
        svc.search(questions(1)[0], timeout=30)    # warm
        waited_before = svc.batcher.wait_s
        with traced():
            futures = [svc.batcher.submit(q) for q in questions(12)]
            for f in futures:
                f.result(timeout=30)
        waited_ms = svc.batcher.mean_wait_ms()
        waited = svc.batcher.wait_s - waited_before
    finally:
        svc.close()
    rec = profiling.recorded()
    by_id = {s.id: s for s in rec.spans}
    ids = sorted(f.id for f in futures)
    loop = {s.thread for s in rec.named("batcher.collect")} | {
        s.thread for s in rec.named("batcher.slot_wait")}
    assert len(loop) == 1 and rec.named("batcher.slot_wait")
    dispatches = rec.named("batcher.dispatch")
    assert sorted(r for d in dispatches for r in d.attrs["requests"]) == ids
    assert all(d.parent is None and d.thread not in loop for d in dispatches)
    waits = rec.named("batcher.wait")
    assert sorted(w.attrs["request"] for w in waits) == ids
    for w in waits:
        d = by_id[w.attrs["dispatch"]]
        assert w.attrs["request"] in d.attrs["requests"]
        assert w.start_ns <= w.end_ns <= d.start_ns
    # the health counter's wait and the spans share their two instants
    assert waited == pytest.approx(sum(w.seconds for w in waits), rel=1e-9)
    drains = rec.named("retrieval.drain_to_host")
    assert len(drains) == len(dispatches)
    assert {by_id[s.parent].name for s in drains} == {"batcher.dispatch"}
    stages = rec.named("retrieval.tokenize+pack+dispatch")
    assert len(stages) == len(dispatches)
    assert all(s.parent is None for s in stages)
    assert not {s.thread for s in stages} & (
        loop | {d.thread for d in dispatches})
    for name in ("embed.tokenize", "embed.pack"):
        spans = rec.named(name)
        assert len(spans) == len(dispatches)
        assert {by_id[s.parent].name for s in spans} == {
            "retrieval.tokenize+pack+dispatch"}
    assert all(s.attrs["texts"] == 4 for s in rec.named("embed.tokenize"))
    assert waited_ms > 0


def test_mean_wait_counts_the_slot_wait():
    from viquae_torch.ir.server import DynamicBatcher

    def process(items):
        time.sleep(0.05)
        return items

    b = DynamicBatcher(process, max_batch=2, max_wait_ms=1.0)
    try:
        futures = [b.submit(i) for i in range(4)]
        assert [f.result(timeout=10) for f in futures] == [0, 1, 2, 3]
        # the second batch waited for the first's dispatch, ~50 ms
        assert b.mean_wait_ms() >= 20.0
        assert b.wait_s > 0 and b.n_items == 4
    finally:
        b.close()


def test_collate_canvas_counters_equal_the_canvas():
    from viquae_torch.train.data import pack_text_inputs

    rng = np.random.default_rng(0)
    lengths = rng.integers(1, 20, size=30)
    mask = (np.arange(24)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask > 0, rng.integers(5, 200, size=mask.shape), 0)
    inputs = {"input_ids": ids.astype(np.int32), "attention_mask": mask}
    with traced():
        a = pack_text_inputs(inputs, row_len=32)
        b = pack_text_inputs(inputs, row_len=32, row_budget=lambda r: r + 8)
    counters = profiling.recorded().counters
    seg = [a["canvas_segment_ids"], b["canvas_segment_ids"]]
    assert counters["collate.canvas_tokens"] == 2 * int(lengths.sum()) == sum(
        int(np.count_nonzero(s)) for s in seg)
    assert counters["collate.canvas_slots"] == sum(s.size for s in seg)
    assert b["canvas_segment_ids"].shape[0] == a["canvas_segment_ids"].shape[
        0] + 8


def test_answer_loop_spans_and_reader_canvas_counters(retrieval, tok):
    from viquae_torch.ir.qa_serving import AnswerPipeline
    from viquae_torch.ir.serving import FusedRetrievalPipeline
    from viquae_torch.models import qa

    cfg, emb, index, _ = retrieval
    rcfg = qa.ReaderConfig(bert=cfg)
    torch.manual_seed(1)
    kb = [{"passage": " ".join(f"w{j}" for j in range(i % 50, i % 50 + 4
                                                     + i % 9))}
          for i in range(60)]
    pipe = AnswerPipeline(
        FusedRetrievalPipeline(emb, index, batch_size=8, k=3), kb, rcfg,
        qa.Reader(rcfg).eval(), tok, m_passages=3, reader_seq=48,
        questions_per_step=4, compute_dtype=torch.float32,
        packed_reader=True, device="cpu")
    canvases = []
    pack_pairs = pipe.pack_pairs

    def keep(ids, mask, tt):
        out = pack_pairs(ids, mask, tt)
        canvases.append((out[1], mask.sum(axis=1).clip(min=1)))
        return out

    pipe.pack_pairs = keep
    with traced():
        out = pipe.run(questions(10))
    assert len(out) == 10
    rec = profiling.recorded()
    assert len(canvases) == 3
    assert len(rec.named("reader.pairs")) == 3
    assert len(rec.named("reader.questions")) == 1
    steps = rec.named("reader.step")
    assert len(steps) == 3 and all(s.device_s is None for s in steps)
    by_id = {s.id: s for s in rec.spans}
    assert {by_id[s.parent].name for s in steps} == {
        "qa-serving.reader_dispatch"}
    c = rec.counters
    assert c["reader.canvas_tokens"] == sum(
        int(np.count_nonzero(seg)) for seg, _ in canvases) == sum(
        int(lens.sum()) for _, lens in canvases)
    assert c["reader.canvas_slots"] == sum(seg.size for seg, _ in canvases)
    assert all(seg.shape[1] == 48 for seg, _ in canvases)


def test_trainer_step_is_a_device_span():
    from viquae_torch.train import optim
    from viquae_torch.train.trainer import Trainer, TrainerConfig

    torch.manual_seed(0)
    params = torch.nn.Linear(4, 1)

    def loss_fn(p, batch, generator=None, deterministic=False):
        x = torch.as_tensor(batch["x"])
        return (p(x) ** 2).mean(), {}

    trainer = Trainer(loss_fn, params,
                      optim.make_optimizer(params, lr=1e-2),
                      TrainerConfig(max_steps=3, log_every=0))
    batch = {"x": np.ones((2, 4), np.float32)}
    with traced():
        trainer.fit(lambda step: batch)
    steps = profiling.recorded().named("train.step")
    assert [s.attrs["step"] for s in steps] == [0, 1, 2]
    assert all(s.device_s is None and s.seconds > 0 for s in steps)

