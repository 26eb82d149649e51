"""Runs of a cell with the control or a fault in its timed path, several
seeds in one process: the upper readings its limits are set from.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --plant control|<fault>

Each seed is one run as perfbench/run.py makes it (set-up, a window of
BENCHMARK.json's ``run_seconds``, the check, the same ``correct``), with

- ``control``: the plain reference in the precision below the one the
  configuration states (bfloat16 for float32) judged in the program's
  place, over the same units the window produced;
- a fault of the cell's traffic kind (the driver's own ``FAULTS``, else
  the kind's entry in lib/faults.py: ``unchanged``, ``half``,
  ``altered`` for ``invert`` and ``render``) planted in the program.

Prints each run's result line; ``correct`` has to come out false. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--plant", required=True,
                   help="control, or a fault of the cell's traffic kind")
    args = p.parse_args(argv)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [q for q in sys.path if str(Path(q or ".").resolve())
                   != here]
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.lib import faults, harness
    from perfbench.run import configure, run_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    configure(torch)
    layout = harness.Layout(ROOT)
    kind = layout.workload(args.workload)["kind"]
    driver = layout.driver(kind)
    names = getattr(driver, "FAULTS", None) or faults.FAULTS[kind]
    if args.plant != "control" and args.plant not in names:
        print(f"control: {kind} has the faults {sorted(names)}",
              file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.plant == "control":
            out = run_cell(layout, args.workload, seed,
                           layout.bench["run_seconds"], False,
                           torch.device("cuda", 0), t0, control=True)
        else:
            with faults.planted(kind, args.plant, driver) as wrap:
                out = run_cell(layout, args.workload, seed,
                               layout.bench["run_seconds"], False,
                               torch.device("cuda", 0), t0, fault=wrap)
        print(out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
