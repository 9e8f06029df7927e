"""Run one cell of the benchmark of ``rtmpc_tpu_torch`` once, on the cards
of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Sets the cell up (builds included), warms
every shape of its traffic, measures for ``--seconds``, then checks what
the measured window produced against the plain reference and prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and
last ``checks``: each number compared beside its limit, which also end
standard error.  Without the cards the cell asks for, or with JAX or the
JAX package loaded once the window has closed, it exits non-zero and
prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_process=T_PROCESS)
    loaded = harness.blocked_modules()
    if loaded:
        print(f"benchmark: modules that no run may load are loaded: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    res.pop("numbers")
    print("setup parts (s): " + json.dumps(res.pop("setup_parts_s")),
          file=sys.stderr)
    for k, v in res["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"check correct: {res['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
