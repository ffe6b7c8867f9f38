"""The benchmark of ``tpu_bls12_381_torch`` on one card: one run of one cell.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``: a configuration (``configs/<name>.json``) under a traffic
mix (``traffic/<name>.json``).  The run makes its inputs from ``--seed``,
sets up, measures ``--seconds`` of closed-loop rounds, checks what the
rounds produced against the plain reference (``reference/``), prints each
compared number beside its limit on standard error, and prints one JSON line
last on standard output: ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``, read
by ``metrics/<name>.py``), the device, and with ``--trace 1`` the breakdown
of a profiled stretch.  It exits non-zero and prints no result without
enough CUDA cards, and if JAX or the JAX package is loaded once the window
has closed.

The program's kernel cache is its default directory inside the checkout
(``tpu_bls12_381_torch/_build``): the checkout's first run builds, every
later run loads.  ``MIDNIGHT_*`` settings of the environment are dropped, so
every run measures the program as configured here.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]
for key in [k for k in os.environ if k.startswith("MIDNIGHT_")]:
    del os.environ[key]

import torch  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                              t_start=T_START, spec=spec)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"JAX or the JAX package is loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
