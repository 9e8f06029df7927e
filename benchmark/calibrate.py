"""The readings that a cell's check limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --seconds <s> [--control-seconds <s>] \\
        [--first-seed 1000]

Runs the cell's program on ``--seeds`` seeds and then, in the program's
place, the cell's control (the same solver a precision lower: TF32 for
float32 with TF32 off, float32 for float64; the configuration's, or the
cell's own where the cell's file names one) on
``--control-seeds`` further seeds, each a window of ``--seconds`` at the
cell's own size, and prints the check's numbers a run, then for each
number the largest reading of the program (the lower reading) and the
smallest of the control (the upper one).  One JSON line a run and the
summary last.  Needs the cards the cell asks for; the benchmark's own
runs never run the control.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import check, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seconds", type=float, default=None,
                    help="the control's window (default --seconds)")
    ap.add_argument("--first-seed", type=int, default=1000)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    readings = {"program": [], "control": []}
    seed = args.first_seed
    for side, n in (("program", args.seeds), ("control", args.control_seeds)):
        for _ in range(n):
            seed += 1
            try:
                control = side == "control"
                res = harness.run(args.workload, seed,
                                  args.control_seconds or args.seconds
                                  if control else args.seconds, False,
                                  control=control)
                numbers = res["numbers"]
            except RuntimeError as e:
                if side == "program":
                    raise
                # a control that fails to run has failed its check
                numbers = dict.fromkeys(check.NUMBERS, float("inf"))
                print(f"{side} seed {seed} raised {e!r}", file=sys.stderr)
            readings[side].append(numbers)
            print(json.dumps({"side": side, "seed": seed, **numbers}),
                  flush=True)
    summary = {k: {"lower": max(r[k] for r in readings["program"]),
                   "upper": min((r[k] for r in readings["control"]),
                                default=None)}
               for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
