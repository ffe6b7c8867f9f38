"""The GLV ladder on one card: ``glv.scalar_mul_glv`` timed for one or more
checkouts of the port in turns, and ``glv_ladder`` against builds not kept.

Run from the repository's root on a machine with a CUDA card and ``nvcc``:

    python3 -m tpu_bls12_381_torch.curves.sweeps [--trees DIR [DIR ...]] [--builds]

Each DIR is the root of a checkout (default: this one); each turn runs in a
process of its own that imports that checkout's ``tpu_bls12_381_torch`` (and
builds its G1 and field kernels), in the order given: for two trees, parent,
change, change, parent.  A turn times whole ``scalar_mul_glv`` calls (the
scalar split, the endomorphism, the ladder, ``proj_to_jac``) on 4096 and
2^20 lanes (``ms``: the median of a call by CUDA events after a warm one;
``launches``: the G1 kernels one call launches).  The points are host
multiples of the generator, tiled; the scalars are random below r, from one
seed.  Every output is hashed, and the script fails where two turns'
outputs differ.

``--builds`` times instead, in this checkout, the kept ``glv_ladder`` against
builds not kept (compiled from a copy of ``csrc/`` with statements changed),
in turns (kept, other, other, kept) on the same inputs, the outputs held
equal, with each build's registers and spill (``ptxas -v``).  The kept build
loads x, y and beta x once and holds them, and each select is the mixed
add's own pass-through mask.  The others: x, y and beta x read at each add
(from L1 and L2); that with the selects apart from the mixed add (three
``fp_cmov`` after each add), as the ladder was first written; the selects
apart with x, y and beta x held; the mixed add's products in another order
(the same values, fewer of them live at once); and x, y and beta x read at
each add by loads the compiler cannot move out of the loop (``ld.global.nc``
in ``asm volatile``).

The last line is the card's name and power limit as ``nvidia-smi`` gives
them.  Exits 1 where no card is visible.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 20
LOG_NS = (12, 20)     # msm_ctx_small's 4096 lanes and the full width
HOST_POINTS = 64      # distinct host multiples of G, tiled over the lanes

_KEPT_LOADS = ("    const fq x = fp_load<Fq>(x2, n, idx), y = fp_load<Fq>(y2, n, idx);\n"
               "    const fq phi_x = fp_load<Fq>(phi_x2, n, idx);\n")


def _adds(xy: str, phiy: str, madd: str = "g1_proj_madd") -> str:
    """The two adds, each select the mixed add's pass-through mask."""
    return (f"        acc = {madd}<CarryMul>(acc, {xy}, inf | !b1);\n"
            f"        acc = {madd}<CarryMul>(acc, {phiy}, inf | !b2);\n")


_KEPT_ADDS = _adds("x, y", "phi_x, y")
_LANE_HEAD = "DEV void g1_glv_ladder_lane("
_READ = ("fp_load<Fq>(x2, n, idx), fp_load<Fq>(y2, n, idx)",
         "fp_load<Fq>(phi_x2, n, idx), fp_load<Fq>(y2, n, idx)")
_FRESH = tuple(r.replace("fp_load<Fq>(", "fq_load_fresh(") for r in _READ)
_FRESH_LOAD = """DEV fq fq_load_fresh(const uint32_t* base, size_t n, size_t idx) {
    fq r;
    UNROLL
    for (int j = 0; j < Fq::W; ++j) {
        uint32_t lo, hi;
        asm volatile("ld.global.nc.u32 %0, [%1];"
                     : "=r"(lo) : "l"(base + (size_t)(2 * j) * n + idx));
        asm volatile("ld.global.nc.u32 %0, [%1];"
                     : "=r"(hi) : "l"(base + (size_t)(2 * j + 1) * n + idx));
        r.v[j] = (lo & 0xffffu) | (hi << 16);
    }
    return r;
}

"""
# The mixed add with its products in another order, each value the
# formula's: t4 and t5 computed where they are used, so fewer values live at
# once.
_MADD_LATE = """template <class M>
DEV G1Proj g1_proj_madd_late(const G1Proj& P, const fq& x2, const fq& y2, bool inf2) {
    fq t0 = M::mul(P.X, x2);
    fq t1 = M::mul(P.Y, y2);
    fq t3 = fq_sub(M::mul(fq_add(P.X, P.Y), fq_add(x2, y2)), fq_add(t0, t1));
    fq t0_3 = fq_add(fq_add(t0, t0), t0);
    fq t2 = fq_mul12(P.Z);
    fq Z3 = fq_add(t1, t2);
    t1 = fq_sub(t1, t2);
    fq Y3 = fq_mul12(fq_add(M::mul(x2, P.Z), P.X));
    G1Proj R;
    R.Y = fp_cmov<Fq>(inf2, P.Y, fq_add(M::mul(t1, Z3), M::mul(Y3, t0_3)));
    fq t5 = fq_add(M::mul(y2, P.Z), P.Y);
    R.X = fp_cmov<Fq>(inf2, P.X, fq_sub(M::mul(t3, t1), M::mul(t5, Y3)));
    R.Z = fp_cmov<Fq>(inf2, P.Z, fq_add(M::mul(Z3, t5), M::mul(t0_3, t3)));
    return R;
}

"""


def _selects_apart(xy: str, phiy: str) -> str:
    """The two adds with the selects after them (three ``fp_cmov`` each), as
    the ladder was first written."""
    out = ""
    for first, (pt, bit) in enumerate(((xy, "b1"), (phiy, "b2"))):
        out += (f"        {'G1Proj ' if first == 0 else ''}s = "
                f"g1_proj_madd<CarryMul>(acc, {pt}, inf);\n")
        out += "".join(f"        acc.{c} = fp_cmov<Fq>({bit}, s.{c}, acc.{c});\n"
                       for c in "XYZ")
    return out


# The builds not kept (``--builds``): (file in csrc/, statement, replacement).
BUILDS = {
    "x, y, beta x read at each add": [
        ("g1.cuh", _KEPT_LOADS, ""), ("g1.cuh", _KEPT_ADDS, _adds(*_READ))],
    "read at each add, the selects apart": [
        ("g1.cuh", _KEPT_LOADS, ""), ("g1.cuh", _KEPT_ADDS, _selects_apart(*_READ))],
    "the selects apart": [("g1.cuh", _KEPT_ADDS, _selects_apart("x, y", "phi_x, y"))],
    "the mixed add's products reordered": [
        ("g1.cuh", _LANE_HEAD, _MADD_LATE + _LANE_HEAD),
        ("g1.cuh", _KEPT_ADDS, _adds("x, y", "phi_x, y", "g1_proj_madd_late"))],
    "read at each add by loads kept in the loop": [
        ("g1.cuh", _LANE_HEAD, _FRESH_LOAD + _LANE_HEAD),
        ("g1.cuh", _KEPT_LOADS, ""), ("g1.cuh", _KEPT_ADDS, _adds(*_FRESH))],
}


def _inputs(dev, log_n: int):
    """Tiled host points, scalars below r, and what ``scalar_mul_glv`` makes
    of them: (scalars, A, k1, k2, beta x)."""
    import numpy as np
    import torch

    from tpu_bls12_381_torch import constants, oracle
    from tpu_bls12_381_torch.curves import g1, glv
    from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER

    rng = np.random.default_rng(SEED + log_n)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(int(k), G, oracle.FQ_OPS), oracle.FQ_OPS)
           for k in rng.integers(1, 1 << 40, size=HOST_POINTS)]
    Ab = g1.affine_from_ints(pts, device=dev)
    n = 1 << log_n
    reps = -(-n // HOST_POINTS)
    A = (Ab[0].repeat(1, reps)[:, :n].contiguous(), Ab[1].repeat(1, reps)[:, :n].contiguous(),
         Ab[2].repeat(reps)[:n].contiguous())
    k = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    k[15] %= constants.FR_MODULUS >> 240        # top limb below r's: k < r
    k = torch.from_numpy(k.astype(np.int32)).to(dev)
    k1, k2 = glv.decompose(k)
    return k, A, k1, k2, glv.endomorphism(FQ_ADAPTER, A)[0].contiguous()


def _ms(fn, reps: int) -> tuple[float, list]:
    """Median milliseconds of one call of ``fn`` by CUDA events, after a warm
    one, and the calls' times."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    return statistics.median(runs), runs


def _digest(out) -> str:
    h = hashlib.sha256()
    for t in out:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _one(tree: str) -> dict:
    """Whole ``scalar_mul_glv`` calls with the port of checkout ``tree`` (run
    as a script, whose own directory, first on the path, gives way to the
    checkout)."""
    sys.path[0] = tree
    import torch

    import tpu_bls12_381_torch as port
    from tpu_bls12_381_torch import _build
    from tpu_bls12_381_torch.curves import cuda_g1, glv

    if Path(port.__file__).resolve().parents[1] != Path(tree).resolve():
        raise RuntimeError(f"imported {port.__file__}, not the checkout at {tree}")
    # build only the sources a GLV call runs (the G1 kernels, the field ones)
    _build.source_names = lambda: ["field_kernels", "g1_kernels"]
    _build.build()
    dev = torch.device("cuda", 0)
    out = {}
    for log_n in LOG_NS:
        k, A, *_ = _inputs(dev, log_n)
        call = lambda: glv.scalar_mul_glv(k, A)
        cuda_g1.reset_launches()
        P = call()
        torch.cuda.synchronize()
        launches = {name: v for name, v in cuda_g1.LAUNCHES.items() if v}
        ms, runs = _ms(call, 5 if log_n < 20 else 3)
        out[f"scalar_mul_glv 2^{log_n}"] = {"ms": ms, "runs": runs, "launches": launches,
                                             "output": _digest(P)}
        del k, A, P
    return out


def _builds() -> dict:
    """The kept ``glv_ladder`` against the builds not kept, in turns."""
    import ctypes

    import torch

    from tpu_bls12_381_torch import _build
    from tpu_bls12_381_torch.curves import cuda_g1
    from tpu_bls12_381_torch.fields.cuda_ops import stream_ptr
    from tpu_bls12_381_torch.ntt.sweeps import _finish, _ptxas, _start_build

    started = {b: _start_build(f"g1 {b}", "g1_kernels", c) for b, c in BUILDS.items()}
    _build.source_names = lambda: ["field_kernels", "g1_kernels"]
    kept = cuda_g1._lib()
    libs = {"kept": kept}
    ptxas = {"kept": _ptxas(_build.build_log("g1_kernels"))}
    for b, (proc, path) in started.items():
        ptxas[b] = _ptxas(_finish(b, proc))
        lib = ctypes.CDLL(str(path))
        lib.g1_glv_ladder.argtypes = kept.g1_glv_ladder.argtypes
        lib.g1_glv_ladder.restype = ctypes.c_int
        libs[b] = lib
    dev = torch.device("cuda", 0)
    rows = {}
    for log_n in LOG_NS:
        _, A, k1, k2, phi_x = _inputs(dev, log_n)
        n = 1 << log_n
        outs = {b: [torch.empty_like(A[0]) for _ in range(3)] for b in libs}

        def call(b):
            code = libs[b].g1_glv_ladder(
                k1.data_ptr(), k2.data_ptr(), k2.shape[0], A[0].data_ptr(), A[1].data_ptr(),
                phi_x.data_ptr(), A[2].data_ptr(), *[o.data_ptr() for o in outs[b]], n,
                128, stream_ptr(dev))
            if code:
                raise RuntimeError(f"{b}: g1_glv_ladder failed with {code}")

        reps = 5 if log_n < 20 else 3
        row = {}
        for b in libs:
            if b == "kept":
                continue
            t = [_ms(lambda: call("kept"), reps)[0], _ms(lambda: call(b), reps)[0],
                 _ms(lambda: call(b), reps)[0], _ms(lambda: call("kept"), reps)[0]]
            torch.cuda.synchronize()
            if not all(torch.equal(o, w) for o, w in zip(outs[b], outs["kept"])):
                raise AssertionError(f"{b}: glv_ladder differs from the kept build")
            row[b] = {"ms_kept_other_other_kept": t}
        rows[f"glv_ladder (24, 2^{log_n})"] = row
        del A, k1, k2, phi_x, outs
    return {"builds": rows,
            "ptxas": {b: {f: v for f, v in p.items() if "glv_ladder" in f}
                      for b, p in ptxas.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=None,
                    help="roots of checkouts to time, in this order")
    ap.add_argument("--builds", action="store_true",
                    help="time the kept glv_ladder against builds not kept")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(_one(args.one)), flush=True)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("sweeps: no CUDA device", file=sys.stderr)
        return 1
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    if args.builds:
        out = _builds()
        print(json.dumps({"builds": out["builds"]}), flush=True)
        print(json.dumps({"ptxas": out["ptxas"]}), flush=True)
        print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip())
        return 0
    here = str(Path(__file__).resolve().parents[2])
    trees = [str(Path(t).resolve()) for t in args.trees or [here]]
    if len(trees) == 2:
        trees = [trees[0], trees[1], trees[1], trees[0]]
    outputs = {}
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for turn, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one", tree],
                              capture_output=True, text=True, env=env, cwd=tree)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise RuntimeError(f"turn {turn} ({tree}) failed")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        for name, r in row.items():
            outputs.setdefault(name, set()).add(r["output"])
        print(json.dumps({"turn": turn, "tree": tree, "cases": row}), flush=True)
    differ = sorted(k for k, v in outputs.items() if len(v) > 1)
    print(json.dumps({"outputs_equal_across_turns": not differ, "differ": differ}))
    print(subprocess.run(smi, capture_output=True, text=True, check=True).stdout.strip(),
          flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
