"""The ranks of a cell on several chips: one process a chip, as ``torchrun``
starts them.

``run.py`` is rank 0. For a cell whose ``chips`` is N > 1 it starts N - 1
copies of itself on the same arguments (:class:`World`), each with the
environment ``torchrun`` gives: ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` 127.0.0.1 and a free ``MASTER_PORT``. Every rank joins
through the program's own ``core.mesh.init_from_env`` (NCCL on
``cuda:<rank>``; gloo on the CPU) and runs the driver on its device.
Started under ``torchrun`` (``WORLD_SIZE`` set), rank 0 starts nothing and
joins. A cell on one chip runs in this process alone, starts nothing and
joins no process group.

Rank 0 starts the workers before it imports torch or the program, so that
the ranks import side by side (:class:`World`), and joins them later
(:meth:`World.join`). It splits the CPUs it may run on into N equal,
disjoint shares, one a rank in rank order (:func:`cpu_shares`), and pins
each rank to its share with as many host threads (``OMP_NUM_THREADS``,
``RAYON_NUM_THREADS`` for the tokenizer) as the share has CPUs, so that
the ranks' host work, each collating the whole global batch, does not
contend for the same cores.

A worker's standard output goes to rank 0's standard error, so that the one
result line is rank 0's. A rank that fails ends the run: rank 0 watches
its workers and, on the first that exits with another code than 0, kills
the others, waits for them and exits with code 1 without a result, also
while it waits in a collective; a worker whose rank 0 is gone exits.

What the ranks agree on from the host (whether the window is still open,
each rank's memory peak and busy time) goes over a gloo group of its own
(:func:`agree`, :func:`gather`), so that it never waits for a device.
Without a process group these are the one rank's own values.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

POLL_S = 0.2
# how long rank 0 waits for a worker to end once its own work is done
WORKER_EXIT_S = 60.0
PARENT = "PERFBENCH_PARENT"
_HOST = None  # the gloo group of the host's agreements


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cpu_shares(cpus, chips: int) -> Optional[List[List[int]]]:
    """``cpus`` cut into ``chips`` equal runs of whole CPUs, in order (the
    rest left out); None where there are fewer CPUs than chips."""
    cpus = sorted(cpus)
    per = len(cpus) // chips
    if per == 0:
        return None
    return [cpus[r * per:(r + 1) * per] for r in range(chips)]


def threads_env(share) -> dict:
    """The host threads of a rank pinned to ``share``."""
    n = str(len(share))
    return {"OMP_NUM_THREADS": n, "RAYON_NUM_THREADS": n}


def rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def agree(flag: bool) -> bool:
    """Rank 0's ``flag``, on every rank."""
    if _HOST is None:
        return flag
    import torch
    import torch.distributed as dist

    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.broadcast(t, src=0, group=_HOST)
    return bool(t[0])


def gather(value) -> list:
    """Every rank's ``value``, in rank order, on every rank."""
    if _HOST is None:
        return [value]
    import torch.distributed as dist

    out = [None] * size()
    dist.all_gather_object(out, value, group=_HOST)
    return out


def closed_loop(seconds: float, call: Callable[[int], None],
                device) -> tuple:
    """``entries.closed_loop`` over ranks: rank 0 decides before each call
    whether the window is still open, so every rank makes the same calls;
    the last starts before the close and is waited for on the device.
    Returns (calls, seconds) on this rank's clock."""
    import torch

    t0 = time.perf_counter()
    n = 0
    while agree(time.perf_counter() - t0 < seconds):
        call(n)
        n += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return n, time.perf_counter() - t0


def leave() -> None:
    """Leave the process group (every rank, once its collectives are
    done): what follows runs on each rank alone."""
    global _HOST
    import torch.distributed as dist

    if dist.is_initialized():
        _HOST = None
        dist.destroy_process_group()


class World:
    """This process's rank of a cell on ``chips`` devices. As rank 0 of
    several it starts the workers at once, running ``script`` on ``argv``,
    and pins itself and each worker to its share of the CPUs; :meth:`join`
    then watches the workers until :meth:`finish`, joins the process group
    and sets ``rank``, ``size`` and ``device``. Leaving the ``with`` block
    kills any worker that is left."""

    def __init__(self, chips: int, script: str, argv: List[str]):
        self.chips = chips
        self.workers: List[subprocess.Popen] = []
        self._done = threading.Event()
        self.rank, self.size = 0, 1
        if chips == 1:
            return
        if "WORLD_SIZE" not in os.environ:
            self._start(chips, script, argv)
        self.rank = int(os.environ["RANK"])
        self.size = int(os.environ["WORLD_SIZE"])
        if self.size != chips:
            raise SystemExit(f"perfbench: the cell needs {chips} ranks; "
                             f"this world has {self.size}")
        parent = os.environ.get(PARENT)
        if self.rank and parent is not None:
            threading.Thread(target=self._orphan_guard, args=(int(parent),),
                             daemon=True).start()

    def join(self, kind: str = "cuda") -> "World":
        """Joins the cell's ranks on devices of ``kind`` (``"cuda"``, or
        ``"cpu"`` for gloo ranks) through the program's
        ``core.mesh.init_from_env``; on one chip, takes device 0."""
        import torch

        if self.chips == 1:
            self.device = torch.device(kind, 0) if kind == "cuda" \
                else torch.device("cpu")
            return self
        if self.workers:
            threading.Thread(target=self._watch, daemon=True).start()
        from viquae_torch.core import mesh

        self.device = mesh.init_from_env("cpu" if kind == "cpu" else None)
        global _HOST
        import torch.distributed as dist

        _HOST = dist.new_group(backend="gloo")
        return self

    def _start(self, chips: int, script: str, argv: List[str]) -> None:
        common = {"WORLD_SIZE": str(chips), "MASTER_ADDR": "127.0.0.1",
                  "MASTER_PORT": str(free_port())}
        shares = cpu_shares(os.sched_getaffinity(0), chips)
        for r in range(1, chips):
            env = dict(os.environ, **common, RANK=str(r), LOCAL_RANK=str(r),
                       **{PARENT: str(os.getpid())})
            pin = None
            if shares:
                env.update(threads_env(shares[r]))
                pin = (lambda cpus: lambda: os.sched_setaffinity(0, cpus))(
                    shares[r])
            self.workers.append(subprocess.Popen(
                [sys.executable, script, *argv], env=env,
                stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno(),
                preexec_fn=pin))
            print(f"perfbench: rank {r} is process {self.workers[-1].pid}"
                  + (f" on CPUs {shares[r]}" if shares else ""),
                  file=sys.stderr, flush=True)
        os.environ.update(common, RANK="0", LOCAL_RANK="0")
        if shares:
            os.sched_setaffinity(0, shares[0])
            os.environ.update(threads_env(shares[0]))
            print(f"perfbench: rank 0 is on CPUs {shares[0]}",
                  file=sys.stderr, flush=True)

    def _watch(self) -> None:
        while not self._done.wait(POLL_S):
            for r, p in enumerate(self.workers, 1):
                code = p.poll()
                if code not in (None, 0):
                    print(f"perfbench: rank {r} exited with code {code}; "
                          f"the run ends without a result", file=sys.stderr,
                          flush=True)
                    self._kill()
                    os._exit(1)

    @staticmethod
    def _orphan_guard(parent: int) -> None:
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(1)

    def _kill(self) -> None:
        for p in self.workers:
            if p.poll() is None:
                p.kill()
        for p in self.workers:
            p.wait()

    def finish(self) -> List[int]:
        """Rank 0, its own work done: waits for every worker to end and
        returns the ranks that failed (those that exited with another code
        than 0 or did not end in time)."""
        self._done.set()
        failed = []
        deadline = time.monotonic() + WORKER_EXIT_S
        for r, p in enumerate(self.workers, 1):
            try:
                code = p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                failed.append(r)
        return failed

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self._done.set()
        self._kill()
