"""The field kernels at the paths' shapes, timed for one or more checkouts of
the port in turns on one card: the elementwise product on two planes and with
one (K, 1) column (``from_mont``'s 1, GLV's beta), the square on one lane, the
Fq inverse on 1 and 4 lanes, and the affine conversion of G1 and G2 results
(``MsmContext.to_affine``).  Every call is one that both the port before the
inverse kernel and the port since have, so a checkout of each can be timed by
the same script.

Run from the repository's root on a machine with a CUDA card and ``nvcc``:

    python3 -m tpu_bls12_381_torch.fields.sweeps [--trees DIR [DIR ...]] [--builds]

Each DIR is the root of a checkout (default: this one); each turn runs in a
process of its own that imports that checkout's ``tpu_bls12_381_torch`` (and
builds its kernels), in the order given: for two trees, parent, change,
change, parent.  It prints one JSON object a turn (``ms``: the mean of a call
by CUDA events after a warm one, the median of three runs; ``launches``: the
kernels one call launches) and then the card's name and power limit as
``nvidia-smi`` gives them.  The inputs come from one seed; every output is
hashed, and the script fails where two turns' outputs differ.

``--builds`` times instead, in this checkout, the kept product kernel
against builds not kept (compiled from a copy of ``csrc/`` with statements
changed), in turns (kept, other, other, kept), the outputs held equal: one
lane a thread for Fq too, four lanes a thread for Fr too; streaming loads
and stores (``__ldcs`` / ``__stcs``); a grid of the blocks the SMs hold at
once (by the kernel's registers), walking the lanes with a grid stride, in
place of a thread for every four lanes.  Beside them ``torch.add`` on the same int32 planes moves
the same bytes with no product: a yardstick of the rate the card reaches for
such a mix of reads and writes.

Exits 1 where no card is visible.
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
LOG_N = 20            # the MSM's width
VEC_LOG_N = 22        # vecops' and the coset NTT's width

# The builds not kept (``--builds``): (file in csrc/, statement, replacement).
_FOUR_LAUNCH = ("mont_mul_kernel<F, MODE, true><<<blocks_for((size_t)n / 4), THREADS, 0, "
                "st>>>(")
BUILDS = {
    "one lane a thread for Fq too": [
        ("field_carry.cuh", "return F::W == 12 && n % 4 == 0", "return false && n % 4 == 0")],
    "four lanes a thread for Fr too": [
        ("field_carry.cuh", "return F::W == 12 && n % 4 == 0", "return n % 4 == 0")],
    "streaming loads and stores": [
        ("field_carry.cuh", "uint4 v = *reinterpret_cast<const uint4*>(p);",
         "uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));"),
        ("field_carry.cuh",
         "*reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);",
         "__stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));")],
    "a grid of the SMs' resident blocks": [
        ("field_kernels.cu",
         "    const size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x;\n"
         "    if (u >= (FOUR ? n / 4 : n)) return;\n"
         "    const El<F> bc = MODE == MUL_COLUMN ? fp_load<F>(b, 1, 0) : fp_zero<F>();\n",
         "    const El<F> bc = MODE == MUL_COLUMN ? fp_load<F>(b, 1, 0) : fp_zero<F>();\n"
         "    for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x;\n"
         "         u < (FOUR ? n / 4 : n); u += (size_t)gridDim.x * blockDim.x)\n"),
        ("field_kernels.cu", "static inline unsigned blocks_for(size_t n) {",
         "static unsigned resident_blocks(const void* k, size_t units) {\n"
         "    int dev = 0, sms = 0, per_sm = 0;\n"
         "    cudaGetDevice(&dev);\n"
         "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
         "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, 0);\n"
         "    size_t need = (units + THREADS - 1) / THREADS, cap = (size_t)sms * per_sm;\n"
         "    return (unsigned)(need < cap ? need : cap);\n"
         "}\n\n"
         "static inline unsigned blocks_for(size_t n) {"),
        ("field_kernels.cu", _FOUR_LAUNCH,
         _FOUR_LAUNCH.replace("blocks_for((size_t)n / 4)",
                              "resident_blocks((const void*)mont_mul_kernel<F, MODE, true>, "
                              "(size_t)n / 4)"))],
}


def _one(tree: str) -> dict:
    """The timings with the port of checkout ``tree`` (run as a script, whose
    own directory, first on the path, gives way to the checkout)."""
    sys.path[0] = tree
    import numpy as np
    import torch

    import tpu_bls12_381_torch as port
    from tpu_bls12_381_torch.curves import glv
    from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER
    from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, fast
    from tpu_bls12_381_torch.runtime import g1_context, g2_context

    if Path(port.__file__).resolve().parents[1] != Path(tree).resolve():
        raise RuntimeError(f"imported {port.__file__}, not the checkout at {tree}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    def field(spec, *shape):
        a = rng.integers(0, 1 << 16, size=(spec.num_limbs,) + shape, dtype=np.int64)
        a[-1] = rng.integers(1, int(spec.modulus_limbs[-1]), size=shape, dtype=np.int64)
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    def ms_of(fn, reps):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / reps)
        return statistics.median(runs), runs

    def digest(out):
        h = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    n, n22 = 1 << LOG_N, 1 << VEC_LOG_N
    a24, b24 = field(FQ, n), field(FQ, n)
    a16, b16 = field(FR, n), field(FR, n)
    x22, y22 = field(FR, n22), field(FR, n22)
    z1, z4 = field(FQ, 1), field(FQ, 4)
    inf = torch.zeros(n, dtype=torch.bool, device=dev)
    P1 = (field(FQ, 1), field(FQ, 1), field(FQ, 1))
    P4 = (field(FQ, 4), field(FQ, 4), field(FQ, 4))
    P2 = (field(FQ, 2, 1), field(FQ, 2, 1), field(FQ, 2, 1))
    g1c, g2c = g1_context(), g2_context()
    cases = {
        "mont_mul_fq (24, 2^20) planes": (lambda: cuda_ops.mont_mul(FQ, a24, b24), 20),
        "mont_mul_fr (16, 2^20) planes": (lambda: cuda_ops.mont_mul(FR, a16, b16), 20),
        "mont_mul_fr (16, 2^22) planes, vector_mul":
            (lambda: cuda_ops.mont_mul(FR, x22, y22), 10),
        "from_mont fr (16, 2^20)": (lambda: fast.from_mont(FR, a16), 20),
        "glv beta*x fq (24, 2^20)":
            (lambda: glv.endomorphism(FQ_ADAPTER, (a24, b24, inf))[0], 20),
        "mont_sqr_fq (24, 1)": (lambda: cuda_ops.mont_sqr(FQ, z1), 50),
        "inverse fq (24, 1), fast.inv_mont": (lambda: fast.inv_mont(FQ, z1), 3),
        "inverse fq (24, 4), fast.inv_mont": (lambda: fast.inv_mont(FQ, z4), 3),
        "to_affine g1, 1 lane": (lambda: g1c.to_affine(P1), 3),
        "to_affine g1, 4 lanes": (lambda: g1c.to_affine(P4), 3),
        "to_affine g2, 1 lane": (lambda: g2c.to_affine(P2), 3),
    }
    out = {}
    for name, (fn, reps) in cases.items():
        cuda_ops.reset_launches()
        result = fn()
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda_ops.LAUNCHES.items() if v}
        ms, runs = ms_of(fn, reps)
        out[name] = {"ms": ms, "ms_runs": runs, "launches": launches,
                     "output": digest(result)}
    return out


def _builds() -> dict:
    """The kept product kernel against the builds not kept, in turns."""
    import ctypes

    import numpy as np
    import torch

    from tpu_bls12_381_torch import _build
    from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops
    from tpu_bls12_381_torch.ntt.sweeps import _finish, _ptxas, _start_build

    started = {k: _start_build(f"field {k}", "field_kernels", c) for k, c in BUILDS.items()}
    kept = cuda_ops._lib()
    libs, ptxas = {"kept": kept}, {"kept": _ptxas(_build.build_log("field_kernels"))}
    for k, (proc, path) in started.items():
        ptxas[k] = _ptxas(_finish(k, proc))
        lib = ctypes.CDLL(str(path))
        for fn in ("fr_mont_mul", "fq_mont_mul", "fr_mont_mul_col", "fq_mont_mul_col"):
            getattr(lib, fn).argtypes = getattr(kept, fn).argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[k] = lib
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def field(spec, n):
        a = rng.integers(0, 1 << 16, size=(spec.num_limbs, n), dtype=np.int64)
        a[-1] = rng.integers(0, int(spec.modulus_limbs[-1]), size=n, dtype=np.int64)
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    rows = {}
    for spec, sfx, log_n, column in ((FQ, "fq", LOG_N, False), (FQ, "fq", LOG_N, True),
                                     (FR, "fr", LOG_N, False), (FR, "fr", LOG_N, True),
                                     (FR, "fr", VEC_LOG_N, False)):
        n = 1 << log_n
        a = field(spec, n)
        b = field(spec, 1) if column else field(spec, n)
        entry = f"{sfx}_mont_mul" + ("_col" if column else "")
        outs = {k: torch.empty_like(a) for k in libs}

        def call(k):
            code = getattr(libs[k], entry)(a.data_ptr(), b.data_ptr(), outs[k].data_ptr(),
                                           n, stream)
            if code:
                raise RuntimeError(f"{k}: {entry} failed with {code}")

        row = {}
        for k in libs:
            if k != "kept":
                t = [ms(lambda: call("kept")), ms(lambda: call(k)), ms(lambda: call(k)),
                     ms(lambda: call("kept"))]
                torch.cuda.synchronize()
                if not torch.equal(outs[k], outs["kept"]):
                    raise AssertionError(f"{k}: {entry} differs from the kept build")
                row[k] = {"ms_kept_other_other_kept": t}
        o = torch.empty_like(a)
        row["torch.add, the same bytes"] = (
            ms(lambda: torch.add(a, 1, out=o)) if column else ms(lambda: torch.add(a, b, out=o)))
        rows[f"{entry} ({spec.num_limbs}, 2^{log_n})"] = row
    return {"builds": rows,
            "ptxas": {k: {f: v for f, v in p.items() if "mont_" in f} for k, p in ptxas.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=None,
                    help="roots of checkouts to time, in this order")
    ap.add_argument("--builds", action="store_true",
                    help="time the kept product kernel against builds not kept")
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
        print(json.dumps(_builds()), flush=True)
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
