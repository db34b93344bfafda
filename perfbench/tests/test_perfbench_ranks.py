"""Drivers found by name, and cells on several ranks: ``run.py``'s launch
(``run.run_ranks`` and ``perfbench/ranks.py``) driven through
``on_ranks.py`` on four gloo ranks on the CPU at the tiny size, sound and
with a fault planted in every rank; and on a machine with four NVIDIA
GPUs (``-m cuda``) the fault of local negatives at the cell's own size."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from perfbench import entries, ranks
from perfbench.tests import tiny

SCRIPT = Path(__file__).with_name("on_ranks.py")
CELL = ["--workload", "train-dpr-ddp4", "--seconds", "1"]
ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def on_ranks(root, *args, kind="cpu", timeout=600):
    """(the process, its seconds)."""
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, str(SCRIPT), "--kind", kind,
                        "--root", str(root), *args], cwd=root,
                       capture_output=True, text=True, timeout=timeout)
    return p, time.monotonic() - t0


def result_of(p) -> dict:
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1, p.stdout[-2000:]
    return json.loads(lines[0])


def gone(pid: int) -> bool:
    try:
        status = Path(f"/proc/{pid}/status").read_text()
    except OSError:
        return True
    return bool(re.search(r"^State:\s+Z", status, re.M))


def test_the_four_entries_resolve_as_before():
    assert set(entries.ENTRIES) == {"retrieve_batch", "answer_batch",
                                    "search_online", "train_dpr"}
    for name, cls in entries.ENTRIES.items():
        assert entries.entry_class(name) is cls
        assert cls.__module__ == "perfbench.entries"


def test_a_driver_file_is_found_by_name(tmp_path):
    drivers = tmp_path / "perfbench" / "drivers"
    drivers.mkdir(parents=True)
    (drivers / "echo_driver.py").write_text(
        "from perfbench import entries\n\n\n"
        "class Echo(entries.TrainDPR):\n    pass\n\n\nENTRY = Echo\n")
    cls = entries.entry_class("echo_driver", tmp_path)
    assert cls.__name__ == "Echo" and issubclass(cls, entries.TrainDPR)
    # loaded once: a class patched in a test is the one later runs get
    assert entries.entry_class("echo_driver", tmp_path) is cls
    assert cls in entries.driver_classes(tmp_path)
    assert set(entries.ENTRIES.values()) <= set(
        entries.driver_classes(tmp_path))


def test_an_unknown_entry_names_both_places(tmp_path):
    with pytest.raises(LookupError) as e:
        entries.entry_class("nowhere", tmp_path)
    assert "ENTRIES" in str(e.value) and "entries.py" in str(e.value)
    assert "perfbench/drivers/nowhere.py" in str(e.value)


def test_the_repository_drivers_resolve():
    cls = entries.entry_class("train_dpr_ddp")
    assert issubclass(cls, entries.TrainDPR)
    assert cls in entries.driver_classes()


def test_each_rank_gets_the_torchrun_environment(root, tmp_path):
    p, _ = on_ranks(root, "--probe", str(tmp_path), *CELL, "--seed", "1")
    assert p.returncode == 0, p.stderr[-4000:]
    envs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(4)]
    assert [e["RANK"] for e in envs] == ["0", "1", "2", "3"]
    assert [e["LOCAL_RANK"] for e in envs] == ["0", "1", "2", "3"]
    assert {e["WORLD_SIZE"] for e in envs} == {"4"}
    assert {e["MASTER_ADDR"] for e in envs} == {"127.0.0.1"}
    assert len({e["MASTER_PORT"] for e in envs}) == 1
    assert int(envs[0]["MASTER_PORT"]) > 0
    # the workers' standard output goes to rank 0's standard error
    assert p.stdout.strip().splitlines() == ["standard output of rank 0",
                                             '{"failed": []}']
    for r in (1, 2, 3):
        assert f"standard output of rank {r}" in p.stderr
    # every rank started before rank 0 imported torch
    assert not any(e["torch_loaded_at_start"] for e in envs)
    # each rank on its own equal share of the CPUs, as many threads
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 4:
        shares = [e["cpus"] for e in envs]
        assert shares == ranks.cpu_shares(cpus, 4)
        for e in envs:
            assert e["OMP_NUM_THREADS"] == str(len(cpus) // 4)
            assert e["RAYON_NUM_THREADS"] == str(len(cpus) // 4)


def test_the_cpus_are_cut_into_equal_disjoint_shares():
    assert ranks.cpu_shares(range(32), 4) == [
        list(range(r * 8, r * 8 + 8)) for r in range(4)]
    assert ranks.cpu_shares([9, 1, 5, 3, 7, 11, 2], 3) == [
        [1, 2], [3, 5], [7, 9]]
    assert ranks.cpu_shares(range(3), 4) is None
    assert ranks.threads_env([4, 5]) == {"OMP_NUM_THREADS": "2",
                                         "RAYON_NUM_THREADS": "2"}


def test_the_launcher_loads_no_torch():
    code = ("import sys; from perfbench import harness, ranks, run; "
            "print('torch' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "False"


@pytest.mark.parametrize("fault", ["rank1_exits", "rank1_exits_early"])
def test_a_worker_that_fails_ends_the_run(root, fault):
    p, took = on_ranks(root, "--fault", fault, *CELL, "--seed", "2",
                       timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()
    if fault == "rank1_exits_early":
        # rank 0 waits to join; its watch of the workers ends the run
        assert "rank 1 exited with code 1" in p.stderr, p.stderr[-4000:]
    # set-up of the tiny cell, then the end within the minute
    assert took < 120
    pids = [int(x) for x in re.findall(r"rank \d is process (\d+)",
                                       p.stderr)]
    assert len(pids) == 3 and all(gone(pid) for pid in pids)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_on_four_gloo_ranks_is_correct(root, trace):
    p, _ = on_ranks(root, *CELL, "--seed", str(2**33 + 3), "--trace",
                    str(trace))
    out = result_of(p)
    assert out["correct"] is True, out["limits"]
    assert out["device"]["count"] == 4
    assert out["attempted"] > 0 and out["attempted"] % 64 == 0
    assert len(out["notes"]["memory_peak_bytes_by_rank"]) == 4
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        want = {m["name"] for m in bench["per_layer"]
                if "train-dpr-ddp4" in m["workloads"]}
        # on the CPU the readers of device time find nothing to read
        assert {"mfu.train4", "collate_ms.train4"} <= set(out["metrics"])
        assert set(out["metrics"]) <= want
        assert len(out["notes"]["busy_s_by_rank"]) == 4
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    else:
        assert set(out["metrics"]) == {"train_items_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["local_negatives", "no_allreduce",
                                   "half_batch", "state_kept"])
def test_a_broken_step_on_four_ranks_is_not_correct(root, fault):
    p, _ = on_ranks(root, "--fault", fault, *CELL, "--seed",
                    str(2**33 + 11))
    out = result_of(p)
    assert out["correct"] is False, out["limits"]
    if fault == "state_kept":
        assert out["limits"]["change_gap"]["value"] == 1.0


@pytest.mark.cuda
def test_local_negatives_at_full_size_on_four_cards(tmp_path):
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    full = tiny.make_root(tmp_path, shrink=False)
    p, _ = on_ranks(full, "--fault", "local_negatives", *CELL[:2],
                    "--seconds", "3", "--seed", str(2**33 + 17),
                    kind="cuda", timeout=900)
    out = result_of(p)
    print(json.dumps({"fault": "local_negatives", "limits": out["limits"]}))
    assert out["correct"] is False, out["limits"]
    assert out["device"]["count"] == 4
