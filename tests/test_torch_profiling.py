"""core/profiling.py's ``trace`` and ``annotate`` (the counterparts of
the JAX package's XPlane trace and TraceAnnotation): a ``torch.profiler``
trace of the block, written as a Chrome trace file into the directory,
holding the annotated range and the ops run inside it, in every thread,
and the recorder's spans and counters on the same timeline. On the CPU the
trace holds host events only; chip_smoke.py phase 23 checks that a traced
search on the card holds CUDA kernel events."""
import json
import threading
import time

import torch

from viquae_torch.core import profiling

torch.set_num_threads(2)


def _events(log_dir):
    files = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(tmp_path / "trace") as prof:
        with profiling.annotate("ivf_search"):
            y = x @ x
    assert prof is not None and y.shape == (64, 64)
    events = _events(tmp_path / "trace")
    names = {e.get("name") for e in events}
    assert "ivf_search" in names
    assert any(name and name.startswith("aten::mm") for name in names)


def test_annotate_outside_a_trace_is_a_plain_range():
    with profiling.annotate("outside"):
        assert torch.ones(2).sum() == 2


def test_trace_holds_a_worker_threads_span_and_range(tmp_path):
    """Every thread is profiled, and the recorder's spans land in the file
    in the thread that ran them, inside the profiler's range around
    them."""
    def work():
        with profiling.annotate("worker_range"):
            with profiling.span("worker.span", job=7):
                time.sleep(0.001)

    with profiling.trace(tmp_path / "trace"):
        thread = threading.Thread(target=work)
        thread.start()
        thread.join()
        profiling.count("worker.items", 3)
    events = _events(tmp_path / "trace")
    spans = [e for e in events if e.get("name") == "worker.span"]
    assert len(spans) == 1 and spans[0]["cat"] == "viquae"
    assert spans[0]["args"]["job"] == 7
    assert spans[0]["tid"] != threading.get_native_id()
    ranges = [e for e in events if e.get("name") == "worker_range"]
    assert len(ranges) == 1 and ranges[0]["tid"] == spans[0]["tid"]
    assert ranges[0]["ts"] <= spans[0]["ts"]
    assert spans[0]["ts"] + spans[0]["dur"] <= ranges[0]["ts"] + ranges[0][
        "dur"]
    assert any(e.get("name") == "worker.items" and e["ph"] == "C"
               and e["args"]["value"] == 3 for e in events)
