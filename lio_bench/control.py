"""Readings for the limits of check.py, on the chip at a cell's own size.

    python3 lio_bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--fault <name>]

For each seed, one run of the cell as run.py makes it (a shorter window
where --seconds says so), in one process: the program's compared
numbers, and the control's, the reference put in the program's place
at the precision below the configuration's float32 with TF32 off: TF32,
every stored intermediate result rounded to its 10-bit mantissa and
every product taken in it, judged from the same program states.  With
--fault, the program runs with that fault planted (faults.py) and the
line gives its numbers and the verdict.  Besides the compared numbers,
every number of check.py (the extrinsic's gaps among them) is printed
for the program and, without --fault, for the control.  One JSON line a
seed.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lio_bench import harness as H  # noqa: E402
from lio_bench import run  # noqa: E402
from lio_bench.faults import ESTIMATION_FAULTS, FAULTS  # noqa: E402

ALL_FAULTS = {**FAULTS, **ESTIMATION_FAULTS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(ALL_FAULTS), default=None)
    args = ap.parse_args()
    bench = H.load_benchmark()
    cell = H.cell_of(bench, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        fault = ALL_FAULTS[args.fault] if args.fault else None
        line = run.run_cell(bench, cell, seed, args.seconds, False, t,
                            fault=fault, control=fault is None)
        out = {"workload": cell["name"], "seed": seed, "fault": args.fault,
               "correct": line["correct"],
               "numbers": {k: v["value"] for k, v in
                           line["compared"].items()},
               "metrics": {k: v["value"] for k, v in line["metrics"].items()},
               "device": line["device"]}
        out.update(line["readings"])  # "program", and "control" if run
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
