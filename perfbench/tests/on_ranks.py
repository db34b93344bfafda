"""A cell on its ranks, through ``run.py``'s launch (``run.run_ranks``), on
gloo ranks on the CPU or on the machine's cards, with a fault planted in
every rank's process; or the judged numbers of many seeds without a
window; or a probe of the ranks' environment.

    python perfbench/tests/on_ranks.py --kind cpu --root <checkout> \
        [--fault <name>] --workload <cell> --seed <n> --seconds <s>
    python perfbench/tests/on_ranks.py --kind cuda \
        --readings "sound:1,2,3;local_negatives:4,5,6" \
        --workload train-dpr-ddp4 --seed 0 --seconds 0
    python perfbench/tests/on_ranks.py --kind cpu --probe <dir> \
        --workload train-dpr-ddp4 --seed 0 --seconds 0

A run prints its result line as ``run.py`` does. ``--readings`` takes
groups of seeds, each under a fault or ``sound``: it builds the cell for
each seed (its judged set-up steps), judges it on rank 0 and prints one
JSON line a seed: the numbers compared and the fullest rank's memory
peak. ``--probe`` writes each rank's ``torchrun`` environment, its host threads,
its CPUs and whether torch was loaded before the ranks started to
``<dir>/rank<r>.json``, prints a line to its standard output, and rank 0
then prints ``{"failed": [...]}``.

Faults (:data:`FAULTS`), planted before the cell is built, so that the
steps the reference follows are broken: ``local_negatives`` (each rank
scores its own questions against its own passages alone, as data
parallelism without the gather would), ``no_allreduce`` (the trainer's
gradient all-reduce left out), ``half_batch`` (half the questions'
labels ignored), ``state_kept`` (an optimizer step that keeps the state),
``rank1_exits`` (rank 1 exits with code 1 as the window opens: rank 0's
collective fails or waits), ``rank1_exits_early`` (rank 1 exits before it
joins: rank 0 waits for it until its watch sees the exit).
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:] = [str(ROOT)] + [p for p in sys.path if os.path.abspath(
    p or ".") != os.path.dirname(os.path.abspath(__file__))]

from perfbench import run  # noqa: E402  (sets the run's environment)

ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
THREADS = ("OMP_NUM_THREADS", "RAYON_NUM_THREADS")
TORCH_AT_START = "torch" in sys.modules
# (object, attribute, original) of every planted fault
_PLANTED: list = []


def plant(obj, name: str, value) -> None:
    _PLANTED.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def unplant() -> None:
    while _PLANTED:
        obj, name, value = _PLANTED.pop()
        setattr(obj, name, value)


def local_negatives():
    import torch

    from viquae_torch.core import mesh as meshlib
    from viquae_torch.train import objectives

    loss = objectives.biencoder_loss

    def broken(q, c, labels):
        ctx = meshlib.current()
        size = ctx.size(meshlib.DATA_AXIS)
        r = ctx.coordinate(meshlib.DATA_AXIS)
        n = len(q)
        per = n // size
        own = torch.arange(r * per, (r + 1) * per, device=q.device)
        # this rank's questions' passages: each block of n (positives,
        # then negatives) at the same rows
        cols = torch.cat([own + j * n for j in range(c.shape[0] // n)])
        return loss(q[own], c[cols], labels[own] - r * per)

    plant(objectives, "biencoder_loss", broken)


def no_allreduce():
    from viquae_torch.core import mesh as meshlib

    reduce = meshlib.all_reduce

    def broken(ctx, x, axis, op="sum", inplace=False):
        # the trainer's gradient mean is the one in-place all-reduce
        return x if inplace else reduce(ctx, x, axis, op, inplace)

    plant(meshlib, "all_reduce", broken)


def half_batch():
    from viquae_torch.train import objectives

    loss = objectives.biencoder_loss

    def broken(q, c, labels):
        half = len(labels) // 2
        labels = labels.clone()
        labels[half:] = objectives.IGNORE_INDEX
        return loss(q, c, labels)

    plant(objectives, "biencoder_loss", broken)


def state_kept():
    from viquae_torch.train import optim

    plant(optim.Optimizer, "step", lambda self, grad_norm=None: None)


def rank1_exits():
    from perfbench import ranks

    if os.environ.get("RANK") == "1":
        plant(ranks, "agree", lambda flag: os._exit(1))


def rank1_exits_early():
    if os.environ.get("RANK") == "1":
        os._exit(1)


FAULTS = {f.__name__: f for f in (local_negatives, no_allreduce, half_batch,
                                  state_kept, rank1_exits,
                                  rank1_exits_early)}


def probe(world, out: Path) -> int:
    from perfbench import ranks

    (out / f"rank{world.rank}.json").write_text(json.dumps(
        {**{k: os.environ.get(k) for k in ENV + THREADS},
         "cpus": sorted(os.sched_getaffinity(0)),
         "torch_loaded_at_start": TORCH_AT_START}))
    print(f"standard output of rank {world.rank}", flush=True)
    ranks.gather(world.rank)
    ranks.leave()
    if world.rank:
        return 0
    failed = world.finish()
    print(json.dumps({"failed": failed}), flush=True)
    return 1 if failed else 0


def readings(root, args, world, groups) -> int:
    """``groups``: [(fault or "sound", seeds)]."""
    from perfbench import entries, harness, ranks

    cell = harness.load_cell(root, args.workload)
    cls = entries.entry_class(cell.traffic["entry"], root)
    for fault, seeds in groups:
        if fault != "sound":
            FAULTS[fault]()
        for seed in seeds:
            entry = cls(cell, seed, world.device)
            entry.build()
            peaks = ranks.gather(harness.peak_memory(world.device))
            entry.release()
            entries.free(world.device)
            if world.rank == 0:
                print(json.dumps({
                    "workload": args.workload, "seed": seed,
                    "fault": fault, **entry.judge(),
                    "memory_peak_bytes": max(peaks)}), flush=True)
        unplant()
    ranks.leave()
    if world.rank:
        return 0
    return 1 if world.finish() else 0


def main(argv=None) -> int:
    import argparse

    from perfbench import harness, ranks

    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--root", default=str(ROOT))
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--probe")
    p.add_argument("--readings")
    own, rest = p.parse_known_args(argv)
    args = run._parse(rest)
    started = harness.process_start_epoch()
    root = Path(own.root)
    chips = int(harness.load_cell(root, args.workload).workload["chips"])
    # as run.py does: the workers start before torch is imported here
    with ranks.World(chips, os.path.abspath(__file__), argv) as world:
        import torch

        if own.kind == "cpu":
            torch.set_num_threads(1)
        if own.fault:
            FAULTS[own.fault]()
        world.join(own.kind)
        if own.probe:
            return probe(world, Path(own.probe))
        if own.readings:
            groups = [(fault, [int(s) for s in seeds.split(",")])
                      for fault, seeds in (g.split(":") for g in
                                           own.readings.split(";"))]
            return readings(root, args, world, groups)
        return run.run_ranks(root, args, world, started)


if __name__ == "__main__":
    sys.exit(main())
