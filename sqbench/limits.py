"""Readings that set a cell's limits: the program's numbers compared, and the
control's (the reference in bfloat16 in the program's place, on the same
inputs), over many seeds in one process on the card.  Not run by the
benchmark's own runs.

    python3 sqbench/limits.py --workload <cell> --seconds 3 --seeds 1 2 3 ... [--control 4]

One JSON line a seed: the readings, the control's for the first ``--control``
seeds, the check's seconds and the records of the window.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if sys.path and Path(sys.path[0] or ".").resolve() == Path(__file__).resolve().parent:
    sys.path.pop(0)  # run as a script: import this folder only as the package sqbench
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sqbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    for i, seed in enumerate(args.seeds):
        out = run.run_cell(args.workload, seed, args.seconds, control=i < args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": {k: c["value"] for k, c in out["checks"].items()},
                          "control": out.get("control"), "check_s": out["check_s"],
                          "records": out["records"], "failed": out["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
