"""The readings that the comparison's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, one whole run of the cell (run.run_cell) in this process,
whose comparison of the program with the plain reference gives the lower
readings, and then the lower-precision control (the reference with its
resample in bfloat16, put in the program's place) compared with the same
reference: the upper readings. One JSON line a seed on stdout:
{"seed", "program": {number: value}, "control": {number: value}}.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        run.log("FAIL: no CUDA card")
        return run.NO_CARD_RC
    cell = run.find_cell(run.ROOT, args.workload)
    for seed in args.seeds:
        r, _ = run.run_cell(cell, seed, args.seconds, False, t_start=time.perf_counter(),
                         control=True)
        print(json.dumps({"seed": seed,
                          "program": {k: v["value"] for k, v in r["checks"].items()},
                          "control": {k: v["value"] for k, v in r["control"].items()},
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
