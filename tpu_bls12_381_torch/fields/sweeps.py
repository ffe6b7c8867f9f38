"""The field kernels at the paths' shapes, timed for one or more checkouts of
the port in turns on one card: the elementwise product on two planes and with
one (K, 1) column (``from_mont``'s 1, GLV's beta), the square on one lane, the
Fq inverse on 1 and 4 lanes, the affine conversion of G1 and G2 results
(``MsmContext.to_affine``), vecops' add, sub, sum and scalar add at 2^22,
the add and the sub on Fq planes, the Fq adapter's doubling and negation at
G2 validation's shape, G2's ``is_in_subgroup`` on 1,028 lanes and G1's
generic ``scalar_mul`` on 256 lanes (the routes of the generic formulas,
where the doubling and the negation are field calls), and ``msm_g2`` on
2^20 points (whose window tails negate).  Every call is one that both the port before a
kernel change and the port since have, so a checkout of each can be timed by
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

``--builds`` times instead, in this checkout, the kept field kernels against
builds not kept (compiled from a copy of ``csrc/`` with statements changed),
in turns (kept, other, other, kept), the outputs held equal.  The product:
one lane a thread for Fq too, four lanes a thread for Fr too; streaming loads
and stores (``__ldcs`` / ``__stcs``); a grid of the blocks the SMs hold at
once (by the kernel's registers), walking the lanes with a grid stride, in
place of a thread for every four lanes.  The add and the sub (planes, a
column, the doubling): one lane a thread for Fr too, four lanes a thread
for Fq too (the kept build takes four for Fr, one for Fq).  ``field_sum``:
one lane a step in place of four; one launch whose last block of a row sums
the row's partials (a counter a row) in place of a second launch.  Beside
them ``torch.add`` on the same int32 planes moves the same bytes with no
field arithmetic (``torch.sum`` along the lanes for the sum): a yardstick of
the rate the card reaches for such a mix of reads and writes.

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
_SUM_ONE_LAUNCH = [
    ("field_kernels.cu", "// Block k of a pass over (K, rows, n)",
     "__device__ unsigned sum_done[1 << 16];\n\n// Block k of a pass over (K, rows, n)"),
    ("field_kernels.cu", "                 size_t rows) {\n    __shared__",
     "                 size_t rows, uint32_t* fin = nullptr) {\n    __shared__"),
    ("field_kernels.cu", "    if (lane == 0) fp_store<F>(out, rows * G, blockIdx.x, acc);\n}",
     "    if (lane == 0) fp_store<F>(out, rows * G, blockIdx.x, acc);\n"
     "    if (G == 1) return;\n"
     "    __threadfence();\n"
     "    unsigned prev = 0;\n"
     "    if (lane == 0) prev = atomicAdd(&sum_done[b], 1u);\n"
     "    if (__shfl_sync(0xffffffffu, prev, 0) != G - 1) return;\n"
     "    __threadfence();\n"
     "    acc = sum_warp<F>(sum_run<F, false>(out + b * G, rows * G, G, lane, 32));\n"
     "    if (lane == 0) {\n"
     "        fp_store<F>(fin, rows, b, acc);\n"
     "        sum_done[b] = 0;\n"
     "    }\n}"),
    ("field_kernels.cu",
     "        sum_pass<F>((const uint32_t*)v, first, (size_t)n, (size_t)rows, G, st);\n"
     "        if (G > 1) sum_pass<F>(first, (uint32_t*)out, G, (size_t)rows, 1, st);",
     "        const unsigned blocks = (unsigned)(rows * G);\n"
     "        if (field_sum_takes_four((size_t)n, v))\n"
     "            field_sum_kernel<F, true><<<blocks, SUM_THREADS, 0, st>>>(\n"
     "                (const uint32_t*)v, first, (size_t)n, (size_t)rows, (uint32_t*)out);\n"
     "        else\n"
     "            field_sum_kernel<F, false><<<blocks, SUM_THREADS, 0, st>>>(\n"
     "                (const uint32_t*)v, first, (size_t)n, (size_t)rows, (uint32_t*)out);"),
]
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
    "add and sub one lane a thread for Fr too": [
        ("field_carry.cuh", "return F::W == 8 && n % 4 == 0 && al(a)",
         "return false && n % 4 == 0 && al(a)")],
    "add and sub four lanes a thread for Fq too": [
        ("field_carry.cuh", "return F::W == 8 && n % 4 == 0 && al(a)",
         "return n % 4 == 0 && al(a)")],
    "field_sum one lane a step": [
        ("field_carry.cuh", "return n % 4 == 0 && ((size_t)v & 15u) == 0;",
         "return false && ((size_t)v & 15u) == 0;")],
    "field_sum in one launch": _SUM_ONE_LAUNCH,
}
# The kernels each build not kept changes, and so the cases it is timed on.
BUILD_KERNELS = {"add and sub one lane a thread for Fr too": "addsub",
                 "add and sub four lanes a thread for Fq too": "addsub",
                 "field_sum one lane a step": "sum", "field_sum in one launch": "sum"}


def _one(tree: str) -> dict:
    """The timings with the port of checkout ``tree`` (run as a script, whose
    own directory, first on the path, gives way to the checkout)."""
    sys.path[0] = tree
    import numpy as np
    import torch

    import tpu_bls12_381_torch as port
    from tpu_bls12_381_torch import vecops
    from tpu_bls12_381_torch.curves import glv
    from tpu_bls12_381_torch.curves import points as pt
    from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER, FqAdapter
    from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, fast
    from tpu_bls12_381_torch.msm import msm_g2
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
    s22 = field(FR, 1)[:, 0]
    A2 = (field(FQ, 2, 1028), field(FQ, 2, 1028),
          torch.zeros(1028, dtype=torch.bool, device=dev))
    A256, k256 = (a24[:, :256], b24[:, :256], inf[:256]), field(FR, 256)
    G2n = (torch.stack([a24, b24], dim=1), torch.stack([b24, a24], dim=1), inf)
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
        "vector_add fr (16, 2^22)": (lambda: vecops.vector_add(FR, x22, y22), 10),
        "vector_sub fr (16, 2^22)": (lambda: vecops.vector_sub(FR, x22, y22), 10),
        "add fq (24, 2^20) planes": (lambda: cuda_ops.add(FQ, a24, b24), 20),
        "sub fq (24, 2^20) planes": (lambda: cuda_ops.sub(FQ, a24, b24), 20),
        "FQ_ADAPTER.double (24, 2, 1028)": (lambda: FQ_ADAPTER.double(A2[0]), 20),
        "FQ_ADAPTER.neg (24, 2, 1028)": (lambda: FQ_ADAPTER.neg(A2[1]), 20),
        "vector_sum fr (16, 2^22)": (lambda: vecops.vector_sum(FR, x22), 10),
        "scalar_vec_add fr (16, 2^22)": (lambda: vecops.scalar_vec_add(FR, s22, x22), 10),
        "is_in_subgroup g2, 1028 lanes (generic Fq2)":
            (lambda: pt.is_in_subgroup(FQ2_ADAPTER, A2), 1),
        "scalar_mul g1 generic, 256 lanes": (lambda: pt.scalar_mul(FqAdapter(FQ), k256, A256), 1),
        "msm_g2, 2^20 points (random coordinates)": (lambda: msm_g2(a16, G2n), 1),
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
    """The kept field kernels against the builds not kept, in turns."""
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
        for sfx in ("fr", "fq"):
            for fn in ("mont_mul", "mont_mul_col", "field_add", "field_add_col",
                       "field_double", "field_sub", "field_sum"):
                f_ = getattr(lib, f"{sfx}_{fn}")
                f_.argtypes = getattr(kept, f"{sfx}_{fn}").argtypes
                f_.restype = ctypes.c_int
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

    # (group, entry, spec, lanes, operand form): the product's, the add's and
    # sub's, the sum's cases
    cases = [("product", "mont_mul", FQ, LOG_N, "planes"),
             ("product", "mont_mul_col", FQ, LOG_N, "column"),
             ("product", "mont_mul", FR, LOG_N, "planes"),
             ("product", "mont_mul_col", FR, LOG_N, "column"),
             ("product", "mont_mul", FR, VEC_LOG_N, "planes")]
    for spec, log_n in ((FR, VEC_LOG_N), (FQ, LOG_N)):
        cases += [("addsub", "field_add", spec, log_n, "planes"),
                  ("addsub", "field_sub", spec, log_n, "planes"),
                  ("addsub", "field_add_col", spec, log_n, "column"),
                  ("addsub", "field_double", spec, log_n, "alone"),
                  ("sum", "field_sum", spec, log_n, "sum")]
    rows = {}
    for group, entry, spec, log_n, form in cases:
        n, K = 1 << log_n, spec.num_limbs
        sfx = "fr" if K == 16 else "fq"
        a = field(spec, n)
        b = field(spec, 1) if form == "column" else field(spec, n)
        shape = (K,) if form == "sum" else (K, n)
        outs = {k: torch.empty(shape, dtype=torch.int32, device=dev) for k in libs}
        G = kept.field_sum_blocks_per_row(n, 1)
        scratch = torch.empty((K, G), dtype=torch.int32, device=dev)
        fn_name = f"{sfx}_{entry}"

        def call(k):
            f_ = getattr(libs[k], fn_name)
            if form == "sum":
                code = f_(a.data_ptr(), outs[k].data_ptr(), scratch.data_ptr(), n, 1, stream)
            elif form == "alone":
                code = f_(a.data_ptr(), outs[k].data_ptr(), n, stream)
            else:
                code = f_(a.data_ptr(), b.data_ptr(), outs[k].data_ptr(), n, stream)
            if code:
                raise RuntimeError(f"{k}: {fn_name} failed with {code}")

        row = {}
        for k in libs:
            if k != "kept" and BUILD_KERNELS.get(k, "product") == group:
                t = [ms(lambda: call("kept")), ms(lambda: call(k)), ms(lambda: call(k)),
                     ms(lambda: call("kept"))]
                torch.cuda.synchronize()
                if not torch.equal(outs[k], outs["kept"]):
                    raise AssertionError(f"{k}: {fn_name} differs from the kept build")
                row[k] = {"ms_kept_other_other_kept": t}
        o = torch.empty_like(a)
        if form == "sum":
            row["torch.sum along the lanes, the same bytes"] = ms(
                lambda: torch.sum(a, dim=-1, dtype=torch.int32))
        elif form in ("column", "alone"):
            row["torch.add, the same bytes"] = ms(lambda: torch.add(a, 1, out=o))
        else:
            row["torch.add, the same bytes"] = ms(lambda: torch.add(a, b, out=o))
        rows[f"{fn_name} ({K}, 2^{log_n})"] = row
    marks = {"product": "mont_", "addsub": "addsub", "sum": "field_sum"}
    changed = lambda k: ([marks[BUILD_KERNELS.get(k, "product")]] if k != "kept"
                         else list(marks.values()))
    return {"builds": rows,
            "ptxas": {k: {f: v for f, v in p.items() if any(m in f for m in changed(k))}
                      for k, p in ptxas.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=None,
                    help="roots of checkouts to time, in this order")
    ap.add_argument("--builds", action="store_true",
                    help="time the kept field kernels against builds not kept")
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
