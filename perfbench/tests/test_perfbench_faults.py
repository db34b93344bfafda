"""The harness drives a whole run, past its look for a chip, with the
timed path broken underneath, and ``correct`` comes out false: half of a
batch left out (its rows filled from the other half) and an answer
altered where it is produced, in each cell. The serving cells run on one
chip and hold no training state, so neither the exchange between chips
nor a step that returns its state unchanged applies to them.

Each case runs at the tiny size on the CPU and, on a machine with an
NVIDIA GPU (``-m cuda``), at the cells' own size: there the towers are
drawn at BERT's 0.02 and the KB has its 1.5M rows. The training cell's
faults break the steps that the reference follows, set-up's first ones,
which go through the window's own call."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.tests import tiny


@pytest.fixture(scope="module", params=[
    "tiny", pytest.param("full", marks=pytest.mark.cuda)])
def site(request, tmp_path_factory):
    """(root, device, seconds) of the runs."""
    if request.param == "tiny":
        torch.set_num_threads(2)
        return tiny.make_root(tmp_path_factory.mktemp("bench")), "cpu", 1.0
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from viquae_torch.kernels import build as kbuild

    kbuild.BUILD_DIR = tiny.REPO / "perfbench" / ".cache" / "kernels"
    return tiny.REPO, "cuda", 3.0


def run(site, name: str, seed: int) -> dict:
    import json
    import time

    from perfbench import harness

    root, device, seconds = site
    out = harness.run_cell(root, name, seed, seconds, False,
                           torch.device(device), time.time())
    print(json.dumps({"workload": name, "device": device,
                      "limits": out["limits"]}))
    return out


def broken_in_window(monkeypatch, state):
    """Sets ``state["on"]`` while any entry's window runs, so that set-up
    and warm-up run the sound program."""
    from perfbench import entries

    for cls in set(entries.ENTRIES.values()):
        def window(self, *args, _orig=cls.window, **kwargs):
            state["on"] = True
            try:
                return _orig(self, *args, **kwargs)
            finally:
                state["on"] = False

        monkeypatch.setattr(cls, "window", window)


def half_left_out(scores, ids, n_real):
    """The second half of the real rows is the first half's."""
    scores, ids = scores.copy(), ids.copy()
    half = (n_real + 1) // 2
    scores[half: n_real] = scores[: n_real - half]
    ids[half: n_real] = ids[: n_real - half]
    return scores, ids


def altered(scores, ids, n_real):
    """Every row's 10th passage replaced by its neighbour id (every row:
    the check judges a sample of rows, 24 at this size)."""
    ids = ids.copy()
    ids[:, 9] = np.where(ids[:, 9] > 0, ids[:, 9] - 1, 1)
    return scores, ids


@pytest.mark.parametrize("fault", [half_left_out, altered])
@pytest.mark.parametrize("name", ["retrieve-batch", "search-online"])
def test_broken_search_is_not_correct(site, monkeypatch, name, fault):
    from viquae_torch.ir import serving

    run_arrays = serving.FusedRetrievalPipeline.run_arrays
    state = {"on": False}

    def broken(self, queries):
        scores, ids = run_arrays(self, queries)
        if not state["on"]:
            return scores, ids
        return fault(scores, ids, sum(1 for q in queries if q))

    monkeypatch.setattr(serving.FusedRetrievalPipeline, "run_arrays", broken)
    broken_in_window(monkeypatch, state)
    out = run(site, name, 2**32 + 31337)
    assert out["correct"] is False, out["limits"]


def test_reader_with_half_the_batch_left_out_is_not_correct(site,
                                                             monkeypatch):
    from viquae_torch.models import qa

    apply = qa.reader_apply_packed

    def broken(*args, **kwargs):
        out = apply(*args, **kwargs)
        start, end = out.start_logits.clone(), out.end_logits.clone()
        half = len(start) // 2
        start[half: 2 * half] = start[:half]
        end[half: 2 * half] = end[:half]
        return out._replace(start_logits=start, end_logits=end)

    monkeypatch.setattr(qa, "reader_apply_packed", broken)
    out = run(site, "answer-batch", 2**32 + 31338)
    assert out["correct"] is False, out["limits"]


def test_altered_answer_is_not_correct(site, monkeypatch):
    from viquae_torch.ir import qa_serving

    answer = qa_serving.AnswerPipeline.run

    def broken(self, queries, **kwargs):
        out = answer(self, queries, **kwargs)
        for o in out[::4]:
            o["answer"] = (o["answer"] or "") + " w1000"
        return out

    monkeypatch.setattr(qa_serving.AnswerPipeline, "run", broken)
    out = run(site, "answer-batch", 2**32 + 31339)
    assert out["correct"] is False, out["limits"]
    assert out["limits"]["answer_mismatches"]["value"] > 0


def test_train_step_that_keeps_its_state_is_not_correct(site, monkeypatch):
    from viquae_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step",
                        lambda self, grad_norm=None: None)
    out = run(site, "train-dpr", 2**32 + 31340)
    assert out["correct"] is False, out["limits"]
    assert out["limits"]["change_gap"]["value"] == 1.0


def test_train_with_half_the_batch_left_out_is_not_correct(site,
                                                           monkeypatch):
    from viquae_torch.train import objectives

    loss = objectives.biencoder_loss

    def broken(q, c, labels):
        half = len(labels) // 2
        labels = labels.clone()
        labels[half:] = objectives.IGNORE_INDEX
        return loss(q, c, labels)

    monkeypatch.setattr(objectives, "biencoder_loss", broken)
    out = run(site, "train-dpr", 2**32 + 31341)
    assert out["correct"] is False, out["limits"]


def test_the_sound_program_reads_below_the_faults(site):
    out = run(site, "retrieve-batch", 2**32 + 31337)
    assert out["correct"] is True, out["limits"]
    assert np.isfinite(out["limits"]["rank_gap"]["value"])
