"""Dynamic micro-batching + HTTP serving runtime of the port
(viquae_torch/ir/server.py): the cases of tests/test_server.py (:21-161
the batcher, :215 the retrieval service, :244 the answer service, :277 the
HTTP front, :336 index adds under the service) on the port's pipelines on
the CPU, the transient-error rules restated for CUDA, and the VQA service
(its online legs are served in tests/test_torch_image_serving.py).

Tolerances: a service's response equals the direct pipeline call on the
same padded batch: ids exactly, scores within 1e-5 (they are the same
floats through JSON). Every test runs under its own time limit, so a hung
batcher thread fails that test instead of stalling the run.
"""
import functools
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from viquae_torch.ir import server as tserver
from viquae_torch.ir.server import (
    BatchedAnswerService,
    BatchedRetrievalService,
    BatchedVQAService,
    DynamicBatcher,
    is_transient_device_error,
    make_http_server,
)

torch.set_num_threads(2)


def time_limit(seconds):
    """Run the test body in a daemon thread and fail if it outlives the
    limit (a hung dispatcher or worker would otherwise block forever)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def target():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e

            thread = threading.Thread(target=target, daemon=True)
            thread.start()
            thread.join(seconds)
            if thread.is_alive():
                pytest.fail(f"{fn.__name__} still running after {seconds} s")
            if "error" in box:
                raise box["error"]
        return run
    return wrap


# ---------------------------------------------------------------------------
# DynamicBatcher unit behaviour
# ---------------------------------------------------------------------------
@time_limit(30)
def test_batcher_batches_concurrent_requests():
    calls = []

    def process(items):
        calls.append(list(items))
        time.sleep(0.02)  # dispatch latency lets the queue fill
        return [x * 10 for x in items]

    b = DynamicBatcher(process, max_batch=8, max_wait_ms=50.0)
    futures = [b.submit(i) for i in range(16)]
    results = [f.result(timeout=5) for f in futures]
    b.close()
    assert results == [i * 10 for i in range(16)]  # per-item order kept
    assert sum(len(c) for c in calls) == 16
    assert len(calls) < 16          # batching actually happened
    assert all(len(c) <= 8 for c in calls)


@time_limit(30)
def test_batcher_max_wait_dispatches_partial_batch():
    b = DynamicBatcher(lambda items: items, max_batch=1000, max_wait_ms=30.0)
    start = time.monotonic()
    assert b.submit("x").result(timeout=5) == "x"
    elapsed = time.monotonic() - start
    b.close()
    assert elapsed < 2.0  # did not wait for 1000 items


@time_limit(30)
def test_batcher_propagates_process_errors():
    def process(items):
        raise ValueError("boom")

    b = DynamicBatcher(process, max_batch=4, max_wait_ms=5.0)
    futures = [b.submit(i) for i in range(3)]
    for f in futures:
        with pytest.raises(ValueError, match="boom"):
            f.result(timeout=5)
    # the dispatcher survives a failing batch
    b.process = lambda items: items
    assert b.submit(7).result(timeout=5) == 7
    b.close()


class _FakeOutOfMemory(RuntimeError):
    """Stands in for torch.cuda.OutOfMemoryError with its real message."""


OOM_TEXT = ("CUDA out of memory. Tried to allocate 2.86 GiB. GPU 0 has a "
            "total capacity of 79.11 GiB of which 1.02 GiB is free.")


@time_limit(30)
@pytest.mark.parametrize("make_error", [
    lambda: torch.cuda.OutOfMemoryError(OOM_TEXT),
    lambda: RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when "
                         "calling `cublasCreate(handle)`"),
], ids=["out-of-memory", "cublas-alloc-failed"])
def test_batcher_retries_transient_device_error_once(make_error):
    """One bounded re-dispatch on a TRANSIENT device error (memory that
    ran out while another batch was in flight); invisible to callers."""
    attempts = []

    def process(items):
        attempts.append(list(items))
        if len(attempts) == 1:
            raise make_error()
        return [x * 10 for x in items]

    b = DynamicBatcher(process, max_batch=4, max_wait_ms=5.0,
                       retry_backoff_s=0.01)
    assert b.submit(3).result(timeout=5) == 30
    b.close()
    assert len(attempts) == 2           # failed once, retried once
    assert attempts[0] == attempts[1]   # SAME batch re-dispatched
    assert b.n_retries == 1


@time_limit(30)
def test_batcher_transient_retry_is_bounded():
    n_calls = [0]

    def process(items):
        n_calls[0] += 1
        raise torch.cuda.OutOfMemoryError(OOM_TEXT)

    b = DynamicBatcher(process, max_batch=4, max_wait_ms=5.0,
                       retry_transient=1, retry_backoff_s=0.01)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="out of memory"):
        b.submit(1).result(timeout=5)
    b.close()
    assert n_calls[0] == 2  # original + exactly one retry


@time_limit(30)
@pytest.mark.parametrize("error", [
    ValueError("bad collation, deterministic"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    RuntimeError("CUDA error: unspecified launch failure"),
    RuntimeError("CUDA error: device-side assert triggered"),
    # the reference's markers are a tunnelled TPU's: not CUDA's, not retried
    RuntimeError("INTERNAL: backend error"),
    RuntimeError("RESOURCE_EXHAUSTED: backend error"),
], ids=["value-error", "illegal-address", "launch-failure", "device-assert",
        "tpu-internal", "tpu-resource-exhausted"])
def test_batcher_non_transient_error_is_not_retried(error):
    """A sticky CUDA error poisons the context: it reaches the caller at
    once and is never re-dispatched; nor is a plain programming error."""
    n_calls = [0]

    def process(items):
        n_calls[0] += 1
        raise error

    b = DynamicBatcher(process, max_batch=4, max_wait_ms=5.0,
                       retry_backoff_s=0.01)
    with pytest.raises(type(error)):
        b.submit(1).result(timeout=5)
    b.close()
    assert n_calls[0] == 1
    assert b.n_retries == 0


def test_transient_error_rules():
    assert is_transient_device_error(torch.cuda.OutOfMemoryError(OOM_TEXT))
    assert is_transient_device_error(_FakeOutOfMemory(OOM_TEXT))
    assert is_transient_device_error(
        RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED"))
    # a sticky error wins over a transient marker in the same message
    assert not is_transient_device_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered (after CUDA "
        "out of memory)"))
    assert not is_transient_device_error(KeyError("query"))
    for marker in ("INTERNAL", "UNAVAILABLE", "ABORTED"):
        assert marker not in tserver.TRANSIENT_ERROR_MARKERS


@time_limit(30)
def test_batcher_max_inflight_overlaps_batches():
    active = []
    peak = []
    lock = threading.Lock()

    def process(items):
        with lock:
            active.append(1)
            peak.append(len(active))
        time.sleep(0.05)
        with lock:
            active.pop()
        return [x * 10 for x in items]

    b = DynamicBatcher(process, max_batch=4, max_wait_ms=1.0,
                       max_inflight=2)
    futures = [b.submit(i) for i in range(32)]
    results = [f.result(timeout=10) for f in futures]
    b.close()
    assert results == [i * 10 for i in range(32)]
    assert max(peak) == 2  # genuinely overlapped, and bounded


@time_limit(30)
def test_batcher_close_drains_pending():
    done = []

    def process(items):
        time.sleep(0.01)
        done.extend(items)
        return items

    b = DynamicBatcher(process, max_batch=4, max_wait_ms=1.0)
    futures = [b.submit(i) for i in range(10)]
    b.close()
    assert [f.result(timeout=1) for f in futures] == list(range(10))
    assert sorted(done) == list(range(10))
    with pytest.raises(RuntimeError):
        b.submit(99)


@time_limit(30)
def test_batcher_result_count_mismatch_is_an_error():
    b = DynamicBatcher(lambda items: items[:-1] if len(items) > 1 else items,
                       max_batch=4, max_wait_ms=20.0)
    futures = [b.submit(i) for i in range(4)]
    time.sleep(0.05)
    errors = [f for f in futures if f.exception(timeout=5) is not None]
    ok = [f for f in futures if f.exception(timeout=5) is None]
    b.close()
    assert errors, "mismatched process() output must fail the batch"
    for f in errors:
        assert "results for" in str(f.exception())
    for f in ok:
        f.result(timeout=1)


@pytest.mark.parametrize("kwargs", [dict(max_batch=0), dict(max_inflight=0)],
                         ids=["max_batch", "max_inflight"])
def test_batcher_rejects_bad_sizes(kwargs):
    with pytest.raises(ValueError, match="must be >= 1"):
        DynamicBatcher(lambda items: items, **kwargs)


@time_limit(30)
def test_batcher_workers_run_with_their_own_grad_mode():
    """Grad mode is per thread: a worker thread starts with it ON whatever
    the submitting thread set, which is why the pipelines switch it off
    inside their own device entry points."""
    seen = []
    b = DynamicBatcher(lambda items: [seen.append(torch.is_grad_enabled())
                                      or x for x in items],
                       max_batch=2, max_wait_ms=1.0)
    with torch.no_grad():
        assert b.submit(1).result(timeout=5) == 1
    b.close()
    assert seen == [True]


# ---------------------------------------------------------------------------
# services over the port's pipelines (tiny models, on the CPU)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    from transformers import BertTokenizerFast

    from viquae_torch.ir.embedding import PackedTextEmbedder
    from viquae_torch.models import bert, convert, dpr
    from viquae_tpu.models import bert as jbert
    from viquae_tpu.models import dpr as jdpr

    tmp = tmp_path_factory.mktemp("srv")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [
        f"w{i}" for i in range(30)
    ]
    (tmp / "vocab.txt").write_text("\n".join(vocab))
    tokenizer = BertTokenizerFast(vocab_file=str(tmp / "vocab.txt"))
    small = dict(vocab_size=40, hidden_size=16, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=32,
                 max_position_embeddings=32, add_pooler=False)
    tree = jax.tree.map(np.asarray, jdpr.init(
        jax.random.key(0), jdpr.DPRConfig(bert=jbert.BertConfig(**small))))
    cfg = dpr.DPRConfig(bert=bert.BertConfig(**small))
    embedder = PackedTextEmbedder(
        dpr.make_packed_apply(cfg),
        convert.params_from_jax(tree, cfg, device="cpu"), tokenizer,
        row_len=16, batch_size=8, fixed_rows=8, device="cpu")
    rng = np.random.default_rng(0)
    kb = rng.standard_normal((50, 16)).astype(np.float32)
    texts = [" ".join(f"w{j}" for j in rng.integers(0, 30, 12))
             for _ in range(50)]
    return embedder, kb, texts


@pytest.fixture(params=["fused", "hybrid-device"])
def retrieval_pipeline(parts, request):
    from viquae_torch.ir.serving import (FusedRetrievalPipeline,
                                         HybridRetrievalPipeline)
    from viquae_torch.ops import bm25, mips
    from viquae_torch.ops.bm25_device import DeviceBM25

    embedder, kb, texts = parts
    index = mips.DenseIndex(kb, mode="global", device="cpu")
    if request.param == "fused":
        return FusedRetrievalPipeline(embedder, index, batch_size=8, k=5)
    sparse = DeviceBM25(bm25.BM25Index.build(texts, k1=0.5, b=0.3),
                        n_head=4, l_small=16, q_block=8, device="cpu")
    return HybridRetrievalPipeline(embedder, index, sparse, batch_size=8,
                                   k=5)


def _padded_direct(pipeline, queries, width=8):
    """The direct call on the batch as the service pads it."""
    scores, idx = pipeline.run_arrays(
        list(queries) + [""] * (width - len(queries)))
    return scores[: len(queries)], idx[: len(queries)]


@time_limit(120)
def test_retrieval_service_matches_direct_pipeline(retrieval_pipeline):
    queries = [f"w{i} w{i + 1} w{i + 2}" for i in range(8)]
    direct_scores, direct_idx = _padded_direct(retrieval_pipeline, queries)

    service = BatchedRetrievalService(
        retrieval_pipeline, max_batch=8, max_wait_ms=2000.0)
    results = [None] * len(queries)

    def client(i):
        results[i] = service.search(queries[i], timeout=60)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # a full batch dispatches at once, in arrival order: map by query
    assert service.batcher.n_dispatches == 1
    service.close()
    by_query = {q: (direct_idx[i], direct_scores[i])
                for i, q in enumerate(queries)}
    if type(retrieval_pipeline).__name__ == "FusedRetrievalPipeline":
        # rows are independent: each equals its row of the direct call
        for q, got in zip(queries, results):
            assert got["indices"] == by_query[q][0].tolist()
            np.testing.assert_allclose(
                got["scores"], by_query[q][1].astype(np.float64),
                rtol=1e-5, atol=1e-5)
    else:
        # gzmuv statistics are per batch and order-free over its rows, so
        # the same 8 queries in another order give the same rows
        for q, got in zip(queries, results):
            assert got["indices"] == by_query[q][0].tolist()
            np.testing.assert_allclose(
                got["scores"], by_query[q][1].astype(np.float64),
                rtol=2e-2, atol=2e-2)


@time_limit(60)
def test_retrieval_service_search_many(retrieval_pipeline):
    queries = [f"w{i} w{i + 3}" for i in range(5)]
    service = BatchedRetrievalService(retrieval_pipeline, max_batch=8,
                                      max_wait_ms=30.0)
    out = service.search_many(queries, timeout=60)
    service.close()
    direct_scores, direct_idx = _padded_direct(retrieval_pipeline, queries)
    assert [r["indices"] for r in out] == direct_idx.tolist()
    assert service.batcher.n_items == 5


@time_limit(30)
def test_answer_service_pads_and_trims():
    class StubAnswerPipeline:
        def __init__(self):
            self.calls = []

        def run(self, questions):
            self.calls.append(len(questions))
            return [{"answer": q.upper()} for q in questions]

    stub = StubAnswerPipeline()
    service = BatchedAnswerService(stub, max_batch=4, max_wait_ms=20.0)
    futures = [service.batcher.submit(q) for q in ("a", "b", "c")]
    out = [f.result(timeout=5) for f in futures]
    service.close()
    assert out == [{"answer": "A"}, {"answer": "B"}, {"answer": "C"}]
    assert all(n == 4 for n in stub.calls)  # every dispatch padded to shape
    assert service.answer_many([], timeout=1) == []


# ---------------------------------------------------------------------------
# HTTP front
# ---------------------------------------------------------------------------
def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_health(base):
    with urllib.request.urlopen(f"{base}/health", timeout=10) as resp:
        return resp.status, json.loads(resp.read())


@time_limit(180)
def test_http_server_end_to_end(parts):
    from viquae_torch.ir.serving import FusedRetrievalPipeline
    from viquae_torch.ops import mips

    embedder, kb, _ = parts
    pipeline = FusedRetrievalPipeline(
        embedder, mips.DenseIndex(kb, mode="global", device="cpu"),
        batch_size=8, k=5)
    service = BatchedRetrievalService(pipeline, max_batch=8,
                                      max_wait_ms=30.0)
    server = make_http_server(retrieval=service)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        queries = [f"w{i} w{i + 1}" for i in range(6)]
        direct_scores, direct_idx = pipeline.run_arrays(list(queries))
        responses = [None] * len(queries)

        def client(i):
            responses[i] = _post(f"{base}/search", {"query": queries[i]})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, (status, body) in enumerate(responses):
            assert status == 200
            assert body["indices"] == direct_idx[i].tolist()
            np.testing.assert_allclose(body["scores"], direct_scores[i],
                                       rtol=1e-5, atol=1e-5)

        status, health = _get_health(base)
        assert status == 200 and health["ok"]
        assert health["search"]["items"] == len(queries)
        assert health["search"]["dispatches"] < len(queries)
        assert health["search"]["transient_retries"] == 0

        # client-side batch endpoint coalesces into the same dispatches
        status, body = _post(f"{base}/search", {"queries": queries[:3]})
        assert status == 200
        assert [r["indices"] for r in body["results"]] == [
            direct_idx[i].tolist() for i in range(3)
        ]

        # error paths
        assert _post(f"{base}/search", {"query": ""})[0] == 400
        assert _post(f"{base}/search", {})[0] == 400
        assert _post(f"{base}/search", {"queries": []})[0] == 400
        assert _post(f"{base}/search", {"queries": ["ok", ""]})[0] == 400
        assert _post(f"{base}/search", [1, 2, 3])[0] == 400  # non-dict body
        assert _post(f"{base}/search", "queries")[0] == 400
        assert _post(f"{base}/answer", {"question": "x"})[0] == 404
        assert _post(f"{base}/nope", {})[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        service.close()


@time_limit(60)
def test_http_answer_routes_and_server_errors():
    """/answer over a stub pipeline (single and batch form), a pipeline
    error as a 500 that leaves the server up, a timeout as a 504."""
    class Stub:
        def run(self, questions):
            if any(q == "explode" for q in questions):
                raise KeyError("no such passage")
            if any(q == "sleep" for q in questions):
                time.sleep(3.0)
            return [{"answer": q[::-1]} for q in questions]

    service = BatchedAnswerService(Stub(), max_batch=4, max_wait_ms=5.0)
    server = make_http_server(answerer=service, request_timeout_s=1.0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert _post(f"{base}/answer", {"question": "abc"}) == (
            200, {"answer": "cba"})
        status, body = _post(f"{base}/answer", {"questions": ["ab", "cd"]})
        assert status == 200
        assert body["results"] == [{"answer": "ba"}, {"answer": "dc"}]
        assert _post(f"{base}/answer", {"questions": "ab"})[0] == 400
        assert _post(f"{base}/answer", {"question": " "})[0] == 400
        assert _post(f"{base}/search", {"query": "x"})[0] == 404
        status, body = _post(f"{base}/answer", {"question": "explode"})
        assert status == 500 and "no such passage" in body["error"]
        status, body = _post(f"{base}/answer", {"question": "sleep"})
        assert status == 504 and "exceeded" in body["error"]
        time.sleep(2.5)  # let the sleeping batch end
        assert _post(f"{base}/answer", {"question": "up"})[0] == 200
        assert _get_health(base)[1]["answer"]["items"] >= 4
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
        service.close()


@time_limit(120)
def test_service_sees_concurrent_index_adds(parts):
    """A DenseIndex.add() while the service is live becomes searchable:
    the row count is read per batch under the batcher too."""
    from viquae_torch.ir.serving import FusedRetrievalPipeline
    from viquae_torch.ops import mips

    embedder, kb, _ = parts
    index = mips.DenseIndex(kb, mode="global", device="cpu")
    pipeline = FusedRetrievalPipeline(embedder, index, batch_size=8, k=5)
    service = BatchedRetrievalService(pipeline, max_batch=8, max_wait_ms=5.0)
    try:
        n_before = index.n
        service.search("w1 w2", timeout=60)  # warm
        q = embedder(["w7 w8 w9"])[:1].numpy()
        index.add(q * 100.0)  # a row that dominates this query
        out = service.search("w7 w8 w9", timeout=60)
        assert out["indices"][0] == n_before  # the new row wins top-1
    finally:
        service.close()


# ---------------------------------------------------------------------------
# the VQA service
# ---------------------------------------------------------------------------
@time_limit(30)
def test_vqa_service_pads_questions_and_images():
    calls = []

    class Stub:
        def run(self, questions, query_images=None):
            calls.append((list(questions), query_images))
            return [{"answer": q} for q in questions]

    service = BatchedVQAService(Stub(), ["clip", "face"], max_batch=3,
                                max_wait_ms=5.0)
    assert service.answer("who", {"clip": "IMG"}, timeout=5) == {
        "answer": "who"}
    service.close()
    (questions, images), = calls
    assert questions == ["who", "", ""]
    assert images == {"clip": ["IMG", None, None],
                      "face": [None, None, None]}


@time_limit(60)
def test_vqa_online_image_legs_refuse_by_name(parts):
    """The multi-index pipeline takes online image and face legs by index
    name: an unknown name or the text index is refused by name, and a VQA
    request that carries an image for a pipeline built WITHOUT online
    encoders fails with the pipeline's own error, not a wrong answer.
    (tests/test_torch_image_serving.py serves real image and face legs.)"""
    from viquae_torch.ir.serving import MultiIndexRetrievalPipeline
    from viquae_torch.ops import mips

    embedder, kb, _ = parts
    indexes = {"dpr": mips.DenseIndex(kb, mode="global", device="cpu"),
               "clip": mips.DenseIndex(kb[:, :8], mode="global",
                                       device="cpu")}
    weights = {"dpr": 0.5, "clip": 0.5}
    for legs, match in ((dict(image_encoders={"dpr": object()}),
                         "image_encoders"),
                        (dict(face_encoders={"dpr": object()}),
                         "face_encoders"),
                        (dict(image_encoders={"nope": object()}),
                         "image_encoders")):
        with pytest.raises(ValueError, match=match):
            MultiIndexRetrievalPipeline(embedder, indexes, weights, "dpr",
                                        batch_size=8, k=5, **legs)
    for legs in (dict(image_encoders={"clip": object()}),
                 dict(face_encoders={"clip": object()})):
        online = MultiIndexRetrievalPipeline(embedder, indexes, weights,
                                             "dpr", batch_size=8, k=5,
                                             **legs)
        assert set(online.image_encoders) | set(online.face_encoders) == {
            "clip"}
    retrieval = MultiIndexRetrievalPipeline(embedder, indexes, weights,
                                            "dpr", batch_size=8, k=5)

    class Answerer:  # AnswerPipeline.run hands its kwargs to run_arrays
        def run(self, questions, **kwargs):
            retrieval.run_arrays(questions, **kwargs)
            return [{"answer": ""} for _ in questions]

    service = BatchedVQAService(Answerer(), ["clip"], max_batch=8,
                                max_wait_ms=5.0)
    try:
        with pytest.raises(ValueError, match="image_encoders"):
            service.answer("who is this", {"clip": object()}, timeout=30)
    finally:
        service.close()


def test_decode_image_payload():
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (4, 3), (10, 20, 30)).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    out = tserver._decode_image_payload({"image_b64": b64}, ["clip", "face"])
    assert set(out) == {"clip", "face"} and out["clip"].size == (4, 3)
    out = tserver._decode_image_payload({"images_b64": {"face": b64}},
                                        ["clip", "face"])
    assert set(out) == {"face"}
    assert tserver._decode_image_payload({}, ["clip"]) == {}
    with pytest.raises(ValueError, match="unknown image index"):
        tserver._decode_image_payload({"images_b64": {"x": b64}}, ["clip"])
    with pytest.raises(ValueError, match="undecodable"):
        tserver._decode_image_payload({"image_b64": "AAAA"}, ["clip"])
