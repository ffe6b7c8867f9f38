"""Readings of a cell's compared numbers on several seeds in one process, with
the control (the plain reference with one stated guarantee broken,
``reference/system.py``) in the program's place, each run as ``run.py`` runs
the program.

    python3 bench_port/control.py --workload <name> --seconds <s> --seed <n> [--seed <n> ...]

One JSON line a seed: the seed, ``correct`` and the compared numbers with
their limits.  The control has to come out not correct on every seed; the
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

import harness  # noqa: E402
from reference.system import ControlSystem  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py reads its numbers on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    spec = harness.load_spec()
    for seed in args.seed:
        t0 = time.perf_counter()
        result = harness.run_cell(args.workload, seed, args.seconds, False, device,
                                  t_start=t0, spec=spec, system_cls=ControlSystem)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"], "checks": result["checks"],
                          "compared": result["_compared"], "attempted": result["attempted"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
