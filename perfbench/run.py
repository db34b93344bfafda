"""Run one cell of the benchmark of ``viquae_torch`` and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with an NVIDIA GPU. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; the numbers compared with the reference come last, under
``limits``, and as the last lines of standard error. Exits non-zero and
prints no result without enough CUDA devices, without the program beside
``perfbench/``, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the harness runs as the package ``perfbench`` of the checkout, never as
# loose modules of its own directory
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != os.path.dirname(
                            os.path.abspath(__file__))]
# keep transformers from loading JAX or TensorFlow
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
os.environ["USE_TORCH"] = "1"
# every kernel cache inside the checkout, at a fixed path
CACHE = os.path.join(ROOT, "perfbench", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from pathlib import Path

    from perfbench import harness

    args = _parse(argv)
    started = harness.process_start_epoch()
    import torch

    cell = harness.load_cell(Path(ROOT), args.workload)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"perfbench: the cell needs {need} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import viquae_torch
    except ImportError as e:
        print(f"perfbench: the program is not beside perfbench/: {e}",
              file=sys.stderr)
        return 2
    if not os.path.abspath(viquae_torch.__file__).startswith(ROOT + os.sep):
        print(f"perfbench: viquae_torch loads from {viquae_torch.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 2
    from viquae_torch.kernels import build as kbuild

    kbuild.BUILD_DIR = Path(CACHE) / "kernels"
    built = set(kbuild.BUILD_DIR.glob("lib*.so"))
    result = harness.run_cell(Path(ROOT), args.workload, args.seed,
                              args.seconds, bool(args.trace),
                              torch.device("cuda", 0), started)
    # a checkout's first run of a cell whose program has a kernel builds
    # it, and its set-up is recorded apart
    building = set(kbuild.BUILD_DIR.glob("lib*.so")) != built
    result["notes"]["setup_built_kernels"] = building
    print(f"set-up {result['notes']['setup_s']:.3f} s, "
          f"{'building' if building else 'with the already built'} "
          f"kernel library", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
