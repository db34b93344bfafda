"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file of its own under perfbench/."""
from __future__ import annotations

import json
import re

from perfbench import entries
from perfbench.tests import tiny

REPO = tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(m["name"] for m in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]) + len(
        BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert one_line(m["layer"]) and "bound" not in m


def test_every_name_has_its_file_and_every_cell_its_metrics():
    pb = REPO / "perfbench"
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert (pb / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((pb / "limits" / f"{w['name']}.json").read_text())
        assert limits["limits"]
        mine = [m for m in BENCH["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in mine}
    for m in BENCH["per_layer"]:
        kind = m["name"].split(".", 1)[0]
        assert (pb / "metrics" / f"{kind}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_traffic_entry_resolves_to_a_driver():
    for path in sorted((REPO / "perfbench" / "traffic").glob("*.json")):
        name = json.loads(path.read_text())["entry"]
        cls = entries.entry_class(name, REPO)
        for step in ("build", "window", "release", "judge", "control"):
            assert callable(getattr(cls, step)), (path.name, step)


def test_train_items_per_s_is_bound_at_7_percent():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["train_items_per_s"]["workloads"] == ["train-dpr"]
    assert e2e["train_items_per_s"]["bound"] == 0.07


def test_the_held_back_cell_appends_within_the_contract():
    held = tiny.HELD_BACK["workload"]["name"]
    assert held not in {w["name"] for w in BENCH["workloads"]}
    full = tiny.bench()
    cells = {w["name"]: w for w in full["workloads"]}
    four = [n for n, w in cells.items() if w["chips"] == 4]
    assert four == [held] and len(four) <= max(1, len(cells) // 4)
    w = cells[held]
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert one_line(w["why"]) and len(w["why"]) <= 200
    assert w["config"] in {c["name"] for c in full["configs"]}
    pb = REPO / "perfbench"
    traffic = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
    assert entries.entry_class(traffic["entry"], REPO)
    assert json.loads((pb / "limits" / f"{held}.json").read_text())["limits"]
    e2e = {m["name"]: m for m in full["end_to_end"]}
    assert e2e["train_items_per_s"]["workloads"] == ["train-dpr", held]
    assert e2e["train_items_per_s"]["bound"] == 0.07
    mine = [m for m in full["per_layer"] if m["workloads"] == [held]]
    assert {m["name"] for m in mine} == {
        "mfu.train4", "device_idle.train4", "collate_ms.train4",
        "nccl_ms.train4", "nccl_exposed.train4"}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for m in mine:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["source"] in SOURCES and m["moves"] == "train_items_per_s"
        assert (pb / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        assert m["layer"] in layers | {"collectives (NCCL)"}
