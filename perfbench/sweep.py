"""Find the knee of an open-loop cell once, by a sweep on the chip: the
highest rate whose requests complete as fast as they come, with no
backlog growing through the window.

    python3 perfbench/sweep.py --workload search-online \
        --rates 500,1000,2000,4000 --seconds 6 --seed 1

One process builds the cell's service once and offers each rate in turn.
A line a rate: completed a second, latency p50 / p95 / max, the p95 of the
window's first and last thirds (a backlog that grows shows as the last
above the first), the batcher's fill and the generator's lateness. The
knee goes into the mix's ``rate_per_s`` as 0.8 of it.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"


def main(argv=None) -> int:
    import argparse
    from pathlib import Path

    import numpy as np
    import torch

    from perfbench import entries, harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    from viquae_torch.kernels import build as kbuild

    kbuild.BUILD_DIR = Path(ROOT) / "perfbench" / ".cache" / "kernels"
    cell = harness.load_cell(Path(ROOT), args.workload)
    run = entries.SearchOnline(cell, args.seed, torch.device("cuda"))
    run.build()
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            w = run.window(args.seconds, rate=rate)
            lat, f = w.facts["latency_s"], w.facts
            n = len(lat)
            third = max(1, n // 3)
            fin = lat[np.isfinite(lat)]
            print(json.dumps({
                "rate": rate, "requests": n, "failed": w.failed,
                "completed_per_s": len(fin) / (args.seconds
                                               + float(fin.max())),
                "p50_ms": float(np.percentile(fin, 50) * 1e3),
                "p95_ms": float(np.percentile(fin, 95) * 1e3),
                "max_ms": float(fin.max() * 1e3),
                "p95_first_third_ms": float(
                    np.percentile(lat[:third], 95) * 1e3),
                "p95_last_third_ms": float(
                    np.percentile(lat[-third:], 95) * 1e3),
                "fill": f["n_items"] / max(1, f["n_dispatches"])
                / f["max_batch"],
                "dispatch_ms": 1e3 * float(np.mean(f["dispatch_s"])),
                **w.notes}), flush=True)
    finally:
        run.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
