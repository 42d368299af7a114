"""The control of a cell's check, and its faults, on the card: whole runs of
the cell at its own size with the program broken underneath
(`portbench/faults.py`), one line a seed, each of which has to come out not
correct. The benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --fault control \
        --seconds <s> --seeds <n> <n> <n>

The seeds run one after another in one process, each with its own set-up.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", default="control")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("portbench/control.py: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = run.load_cell(args.workload)
    refused = 0
    for seed in args.seeds:
        t = T_START if seed == args.seeds[0] else time.perf_counter()
        res = run.run_cell(cell, seed, args.seconds, False, device, t,
                           fault=args.fault)
        refused += not res.correct
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, **res.line()}), flush=True)
    print(f"control: {refused} of {len(args.seeds)} runs not correct",
          file=sys.stderr)
    return 0 if refused == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
