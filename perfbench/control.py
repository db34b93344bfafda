"""The control of ``correct``: the plain reference put in the program's
place, computed in the precision below the configuration's (each entry's
``control``: fp8 e4m3 for the bf16 serving cells), judged by the same
numbers as a run. Its readings set the upper end of each limit
(``perfbench/limits/``), the program's own runs the lower.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3

On the machine's GPU. It drives no window and imports nothing of the
program: the same questions as a run of the seed, the same weights and
KB. Prints one JSON line a seed.
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


def control(cell, seed: int, device) -> dict:
    """The numbers of the control for one seed."""
    from perfbench import entries

    out = entries.entry_class(cell.traffic["entry"], cell.root)(
        cell, seed, device).control()
    return {k: (float(v) if not isinstance(v, int) else v)
            for k, v in out.items()}


def main(argv=None) -> int:
    import argparse
    from pathlib import Path

    import torch

    from perfbench import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(Path(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **control(cell, seed, torch.device("cuda"))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
