#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpu_bls12_381_torch/csrc``, holds every kernel
against its plain PyTorch version on the card (integer arithmetic, canonical
results: the tolerance is zero, ``torch.equal``), runs the golden n = 4096 G1
MSM vector with GLV off and on, and drives the main path once at full width:
``msm_g1`` on 2^20 points, checked against one host scalar multiplication.

One JSON object per phase goes to standard output.  The last lines are the
``{"kernels": [...]}`` table, the card's name and power limit as ``nvidia-smi``
gives them, and ``{"ok": true, "device": {...}}``.  In the table ``ms`` is
the kernel's own time on the card, read from a ``torch.profiler`` trace of
the timed launches; ``call_ms`` beside it is what one wrapper call costs
back to back (host checks, allocation and launch included), by CUDA events.
``bound_ms`` counts the bytes the function needs (2 for a 16-bit limb);
``bound_ms_as_stored`` counts the 4-byte slot a limb is stored in.  Any failing phase raises,
and the exit code is then not 0.  Without a CUDA device the script exits with
code 2 and prints no result.

It imports only the port (``tpu_bls12_381_torch``), never JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM, for the bounds.  Memory: 3.35 TB/s (data sheet).
# Integer: the data sheet's 67 TFLOP/s of float32 are 128 lanes x 132 SMs x
# 1.98 GHz x 2 (a fused multiply-add counts twice); 64 of the 128 lanes take
# 32-bit integer multiply-adds, which gives 16.75e12 of them a second.  A
# 32x32 -> 64 multiply-add takes two such slots (low and high half).
MEM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 2 / 2
SLOTS_PER_WIDE_MAD = 2
LIMB_BYTES = 2         # a 16-bit limb: what the function must move
LIMB_BYTES_STORED = 4  # the int32 slot it is stored in

SEED = 20
LOG_N = 20             # the main path's point count, 2^20: never cut


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(fn, symbol: str, reps: int) -> dict:
    """Time ``reps`` back-to-back calls of a kernel wrapper.

    ``ms``: the kernel's own mean time on the card, from the trace's events
    whose name holds ``symbol``.  ``call_ms``: mean time of one call by CUDA
    events around the same calls untraced; on few lanes that is the
    wrapper's host time, not the kernel.  ``other_launches``: device kernels
    in the trace that are not the kernel (a wrapper should launch none).
    Where the trace holds no device time, ``ms`` is ``call_ms`` and
    ``ms_from`` says so.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call_ms = time_ms(fn, reps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    own = [e for e in events if symbol in e.key]
    count = sum(e.count for e in own)
    if count:
        ms = sum(e.self_device_time_total for e in own) / 1e3 / count
        return {"ms": ms, "ms_from": "profiler", "call_ms": call_ms,
                "traced_launches": count,
                "other_launches": sum(e.count for e in events) - count}
    return {"ms": call_ms, "ms_from": "events", "call_ms": call_ms,
            "traced_launches": 0, "other_launches": 0}


def mul_mads(words: int) -> int:
    """Wide multiply-adds of one Montgomery product on ``words`` 32-bit words:
    the product, the m*p reduction, and one m = t0 * n0 per word."""
    return 2 * words * words + words


def sqr_mads(words: int) -> int:
    """The same for a square with the symmetric products taken once."""
    return words * (words + 1) // 2 + words * words + words


def bound(bytes_moved: int, wide_mads: int) -> tuple[float, str]:
    """Least milliseconds for the work: the larger of bytes over the memory
    rate and multiply-add slots over the integer rate, and which it is."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S * 1e3
    t_ops = wide_mads * SLOTS_PER_WIDE_MAD / INT32_MAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trees_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def max_abs_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--upto", default="msm_2e20",
                    choices=["build", "kernels", "msm_small", "msm_2e20"],
                    help="stop after this phase (a partial run prints no "
                         "final ok line and exits with code 10)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one main-path call with torch.profiler "
                         "and print the card's busy share and its top kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this script "
              "needs one CUDA device", file=sys.stderr)
        return 2

    import numpy as np

    from tpu_bls12_381_torch import _build, constants, oracle
    from tpu_bls12_381_torch.curves import cuda_g1, g1
    from tpu_bls12_381_torch.curves import projective as pj
    from tpu_bls12_381_torch.curves.field_adapters import FQ_PLAIN
    from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, fast, ops
    from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
    from tpu_bls12_381_torch.msm import msm_g1, msm_geometry
    from tpu_bls12_381_torch.runtime import tracing
    from tpu_bls12_381_torch.tuning import chip_profile

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    # ------------------------------------------------------------------ device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    nvcc_release = next((ln.strip() for ln in nvcc.splitlines()
                         if "release" in ln), nvcc.strip())
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc_release,
          "python": sys.version.split()[0],
          "profile": dataclasses.asdict(chip_profile(dev))})

    # ------------------------------------------------------------------- build
    t0 = time.perf_counter()
    paths = _build.build()
    build_s = time.perf_counter() - t0
    registers = {}
    for name in paths:
        fn = None
        for ln in _build.build_log(name).splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if "'" in ln else ln
            elif "Used" in ln and "registers" in ln and fn:
                registers[fn] = ln.split("ptxas info    :")[-1].strip()
            elif "spill" in ln and fn and "0 bytes spill stores, 0 bytes spill loads" not in ln:
                registers[fn + " spills"] = ln.strip()
    emit({"phase": "build", "seconds": round(build_s, 2),
          "libraries": sorted(p.name for p in paths.values()),
          "ptxas": registers})
    if args.upto == "build":
        return 10

    # ------------------------------------------------------------ shared inputs
    rng = np.random.default_rng(SEED)

    def rand_field(spec, n):
        """(K, n) random canonical elements; lanes 0..2 hold 0, 1, p-1."""
        k = spec.num_limbs
        a = rng.integers(0, 1 << 16, size=(k, n), dtype=np.int64)
        top = int(spec.modulus_limbs[-1])
        a[-1] = rng.integers(0, top, size=n, dtype=np.int64)  # < top limb of p
        a[:, 0] = 0
        a[:, 1] = 0
        a[0, 1] = 1
        a[:, 2] = ints_to_limbs([spec.modulus - 1], k)[:, 0]
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    # 4096 multiples k_j * G on the host (Python integers), as the headline
    # benchmark of the JAX package makes its points; tiled to the size wanted.
    M = 4096
    t0 = time.perf_counter()
    ks = rng.integers(1, 1 << 16, size=M, dtype=np.int64)
    G = oracle.g1_generator()
    base_pts = [oracle.jac_to_affine(oracle.scalar_mul(int(k), G, oracle.FQ_OPS),
                                     oracle.FQ_OPS) for k in ks]
    Ab = g1.affine_from_ints(base_pts, device=dev)
    host_points_s = time.perf_counter() - t0

    def tiled_affine(n):
        reps = -(-n // M)
        return (Ab[0].repeat(1, reps)[:, :n].contiguous(),
                Ab[1].repeat(1, reps)[:, :n].contiguous(),
                Ab[2].repeat(reps)[:n].contiguous())

    # ----------------------------------------------------------------- kernels
    N = 1 << 16
    contig = lambda T: tuple(c.contiguous() for c in T)

    def check(name, symbol, n, got, want, kernel_fn, plain_fn, counter, reps=5):
        torch.cuda.synchronize()
        equal = trees_equal(got, want)
        row = {"phase": "kernels", "name": name, "N": n, "equal": equal,
               **measure(kernel_fn, symbol, reps),
               "plain_ms": round(time_ms(plain_fn, 1, warm=False), 3),
               "launches": counter()}
        emit(row)
        if not equal:
            raise AssertionError(f"{name}: kernel and plain version differ")

    for spec, sfx in ((FR, "fr"), (FQ, "fq")):
        a = rand_field(spec, N)
        b = rand_field(spec, N).flip(1).contiguous()
        check(f"mont_mul_{sfx}", "mont_mul_kernel", N,
              [cuda_ops.mont_mul(spec, a, b)], [cuda_ops.mont_mul_plain(spec, a, b)],
              lambda: cuda_ops.mont_mul(spec, a, b),
              lambda: cuda_ops.mont_mul_plain(spec, a, b),
              lambda: cuda_ops.LAUNCHES[f"mont_mul_{sfx}"])
        check(f"mont_sqr_{sfx}", "mont_sqr_kernel", N,
              [cuda_ops.mont_sqr(spec, a)], [cuda_ops.mont_sqr_plain(spec, a)],
              lambda: cuda_ops.mont_sqr(spec, a),
              lambda: cuda_ops.mont_sqr_plain(spec, a),
              lambda: cuda_ops.LAUNCHES[f"mont_sqr_{sfx}"])
        # from_mont is the product with 1 through the same kernel
        fm = fast.from_mont(spec, a)
        if not torch.equal(fm, ops.from_mont(spec, a)):
            raise AssertionError(f"from_mont {sfx}: kernel and plain differ")

    # Points with Z != 1, and the edge lanes of the group law.
    A = tiled_affine(N)
    roll = lambda T, d: tuple(torch.roll(c, d, dims=-1) for c in T)
    P = list(pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, roll(A, 1))))
    Q = list(pj.proj_add(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, roll(A, 2)),
                         tuple(P)))
    ident = pj.proj_identity(FQ_PLAIN, (N,), dev)
    negP = pj.proj_neg(FQ_PLAIN, tuple(P))
    for c in range(3):
        P[c][:, 0] = ident[c][:, 0]        # identity + Q
        Q[c][:, 1] = ident[c][:, 1]        # P + identity
        Q[c][:, 2] = P[c][:, 2]            # P + P
        Q[c][:, 3] = negP[c][:, 3]         # P + (-P)
        Q[c][:, 4] = ident[c][:, 4]        # identity + identity
        P[c][:, 4] = ident[c][:, 4]
    P, Q = contig(P), contig(Q)
    got = cuda_g1.padd(P, Q)
    want = cuda_g1.padd_plain(P, Q)
    # P + (-P) must be the identity: Z = 0
    if not bool(ops.is_zero(FQ, got[2][:, 3:5]).all()):
        raise AssertionError("padd: P + (-P) is not the identity")
    check("padd", "padd_kernel", N, got, want, lambda: cuda_g1.padd(P, Q),
          lambda: cuda_g1.padd_plain(P, Q), lambda: cuda_g1.LAUNCHES["padd"])
    check("pdbl", "pdbl_kernel", N, cuda_g1.pdbl(P), cuda_g1.pdbl_plain(P),
          lambda: cuda_g1.pdbl(P), lambda: cuda_g1.pdbl_plain(P),
          lambda: cuda_g1.LAUNCHES["pdbl"])

    # Signed mixed add, elementwise (R = 1, accumulator passed in).
    Pm = [c.clone() for c in P]
    Aproj = pj.affine_to_proj(FQ_PLAIN, A)
    sign = torch.from_numpy(rng.integers(0, 2, size=N).astype(bool)).to(dev)
    inf2 = torch.from_numpy(rng.integers(0, 8, size=N) == 0).to(dev)
    for c in range(3):
        Pm[c][:, 5] = Aproj[c][:, 5]       # P + P      (same affine point)
        Pm[c][:, 6] = Aproj[c][:, 6]       # P + (-P)   (sign set)
        Pm[c][:, 8] = ident[c][:, 8]       # identity + A
    sign[5], sign[6], sign[7] = False, True, True
    inf2[5], inf2[6], inf2[7], inf2[8], inf2[9] = False, False, True, False, True
    Pm = contig(Pm)
    got = cuda_g1.pmadd_signed(Pm, A, sign)
    want = cuda_g1.pmadd_signed_plain(Pm, A, sign)
    if not bool(ops.is_zero(FQ, got[2][:, 6])):
        raise AssertionError("pmadd_signed: P + (-P) is not the identity")
    check("pmadd_signed", "pmadd_signed_kernel", N, got, want,
          lambda: cuda_g1.pmadd_signed(Pm, A, sign),
          lambda: cuda_g1.pmadd_signed_plain(Pm, A, sign),
          lambda: cuda_g1.LAUNCHES["pmadd_signed"])

    # Signed mixed add, looped (R > 1, from the identity), on the two halves
    # of one (R, 48, L) tile as the MSM passes them.
    Rr, Lr = 8, N // 8
    tile = torch.cat([A[0], A[1]], dim=0).reshape(48, Rr, Lr).permute(1, 0, 2).contiguous()
    xr, yr = tile[:, :24], tile[:, 24:]
    sr, ir = sign.reshape(Rr, Lr).clone(), inf2.reshape(Rr, Lr).clone()
    ir[0, :4] = True                       # columns that start on skipped rows
    ir[:, 4] = True                        # a column that stays the identity
    got = cuda_g1.pmadd_signed_rows(xr, yr, sr, ir)
    want = cuda_g1.pmadd_signed_rows_plain(xr, yr, sr, ir)
    check("pmadd_signed_rows", "pmadd_signed_kernel", N, got, want,
          lambda: cuda_g1.pmadd_signed_rows(xr, yr, sr, ir),
          lambda: cuda_g1.pmadd_signed_rows_plain(xr, yr, sr, ir),
          lambda: cuda_g1.LAUNCHES["pmadd_signed"], reps=3)
    del P, Q, Pm, A, Aproj, tile, xr, yr, got, want, negP, ident
    if args.upto == "kernels":
        return 10

    # --------------------------------------------------------------- msm_small
    with open(ROOT / "tests" / "vectors" / "msm_g1_vectors.json") as f:
        case = next(c for c in json.load(f)["cases"] if c["n"] == 4096)
    vals = [int(s, 16) for s in case["scalars"]]
    pts = [(int(p["x"], 16), int(p["y"], 16)) for p in case["points"]]
    expected = (int(case["expected"]["x"], 16), int(case["expected"]["y"], 16))
    Av = g1.affine_from_ints(pts, device=dev)
    sv = torch.from_numpy(ints_to_limbs(
        [FR.to_mont(v) for v in vals], FR.num_limbs).astype(np.int32)).to(dev)
    for glv in (False, True):
        t0 = time.perf_counter()
        Pj = msm_g1(sv, Av, glv=glv)
        got = g1.jacobian_to_ints(tuple(c[:, None] for c in Pj))[0]
        ok = got == expected
        emit({"phase": "msm_small", "n": 4096, "glv": glv, "equal": ok,
              "seconds_first_call": round(time.perf_counter() - t0, 3)})
        if not ok:
            raise AssertionError(f"msm_small glv={glv}: wrong result")
    if args.upto == "msm_small":
        return 10

    # ---------------------------------------------------------------- msm_2e20
    n = 1 << LOG_N
    A = tiled_affine(n)
    # scalars below 2^254 < r from the seed, standard form, four 64-bit words
    words = rng.integers(0, np.iinfo(np.uint64).max, size=(4, n),
                         dtype=np.uint64, endpoint=True)
    words[3] &= np.uint64((1 << 62) - 1)
    limbs = np.empty((16, n), dtype=np.int32)
    for wi in range(4):
        for li in range(4):
            limbs[4 * wi + li] = ((words[wi] >> np.uint64(16 * li))
                                  & np.uint64(0xFFFF)).astype(np.int32)
    s_std = torch.from_numpy(limbs).to(dev)
    s_mont = cuda_ops.mont_mul(
        FR, s_std, ops.broadcast_constant(FR, FR.r2_limbs, (n,), dev))
    if not torch.equal(fast.from_mont(FR, s_mont), s_std):
        raise AssertionError("msm_2e20: scalars do not round-trip through Montgomery form")

    # Expected: (sum_i s_i * k_{i mod 4096} mod r) * G, one host scalar mul.
    # Per residue j the scalars are summed in 32-bit halves (no overflow:
    # at most 2^20 / 4096 terms below 2^32 each).
    pad = (-n) % M
    total = 0
    for wi in range(4):
        w_ = np.concatenate([words[wi], np.zeros(pad, np.uint64)]).reshape(-1, M)
        lo = (w_ & np.uint64(0xFFFFFFFF)).sum(axis=0)
        hi = (w_ >> np.uint64(32)).sum(axis=0)
        for j in range(min(M, n)):
            total += ((int(lo[j]) + (int(hi[j]) << 32)) << (64 * wi)) * int(ks[j])
    expected = oracle.jac_to_affine(
        oracle.scalar_mul(total % constants.FR_MODULUS, G, oracle.FQ_OPS),
        oracle.FQ_OPS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    geo = msm_geometry(n, device=dev)            # the plan msm_g1 follows
    cuda_ops.reset_launches()
    cuda_g1.reset_launches()
    t0 = time.perf_counter()
    Pj = msm_g1(s_mont, A)                       # the main path, first call
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {**cuda_ops.LAUNCHES, **cuda_g1.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    got = g1.jacobian_to_ints(tuple(c[:, None] for c in Pj))[0]
    ok = got == expected and all(tuple(c.shape) == (24,) for c in Pj)

    secs = []
    for _ in range(3):
        secs.append(tracing.timed_reps(1, lambda: msm_g1(s_mont, A)))
    med = statistics.median(secs)
    with tracing.collect_stages() as stages:
        msm_g1(s_mont, A)
    on_path = ["mont_mul_fr", "mont_mul_fq", "mont_sqr_fq",
               "pmadd_signed", "padd", "pdbl"]
    emit({"phase": "msm_2e20", "n": n, "equal": bool(ok),
          "g1_msm_2e20_points_per_s": n / med, "seconds_median_of_3": med,
          "seconds_each": secs, "seconds_first_call": first_s,
          **{k: geo[k] for k in ("glv", "w", "T", "L", "R", "nb")},
          "launches": launches, "peak_bytes_allocated": peak,
          "stages_ms": {k: round(v, 3) for k, v in stages.items()},
          "host_points_seconds": round(host_points_s, 2), "card": smi})
    if not ok:
        raise AssertionError("msm_2e20: result differs from the host scalar multiplication")
    missing = [k for k in on_path if launches[k] < 1]
    if missing:
        raise AssertionError(f"msm_2e20: kernels never launched on the main path: {missing}")
    if launches["pmadd_signed"] != geo["T"]:
        # the scan is one launch a window: the call did not follow the plan
        # that the kernels below are timed at
        raise AssertionError(
            f"msm_2e20: {launches['pmadd_signed']} scan launches, the plan has "
            f"{geo['T']} windows")
    if args.profile:
        # Kernel times come from the trace; the wall time does not (tracing
        # slows the host), so the busy share is taken against the untraced
        # median above.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            msm_g1(s_mont, A)
            torch.cuda.synchronize()
        by_kernel = sorted(
            ((e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
            key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in by_kernel)
        measured = bool(by_kernel)
        emit({"phase": "profile",
              "device_busy_ms": round(busy_ms, 2) if measured else "not measured",
              "device_idle_share": round(1 - busy_ms / (med * 1e3), 3)
              if measured else "not measured",
              "kernel_launches_traced": sum(r[2] for r in by_kernel),
              "top_device_ms": [[k[:48], round(ms, 3), c]
                                for k, ms, c in by_kernel[:10]]})
    del A, s_mont, s_std, Pj
    torch.cuda.empty_cache()

    # ------------------------------------- kernels at the main path's shapes
    L, R, nb = geo["L"], geo["R"], geo["nb"]
    W_FR, W_FQ = FR.num_limbs // 2, FQ.num_limbs // 2
    rows = []

    def kernel_row(name, symbol, source, replaces, shape, kernel_fn, plain_fn,
                   limbs_moved, mask_bytes, wide_mads, reps):
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        b_ms, b_by = bound(limbs_moved * LIMB_BYTES + mask_bytes, wide_mads)
        s_ms, s_by = bound(limbs_moved * LIMB_BYTES_STORED + mask_bytes, wide_mads)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err, **measure(kernel_fn, symbol, reps),
               "plain_ms": time_ms(plain_fn, 1, warm=False), "bound_ms": b_ms,
               "bound_by": b_by, "bound_ms_as_stored": s_ms,
               "bound_by_as_stored": s_by, "library_ms": None, "shape": shape}
        if err != 0:
            raise AssertionError(f"{name} at {shape}: kernel and plain differ")
        rows.append(row)

    FIELD_SRC = "tpu_bls12_381_torch/csrc/field_kernels.cu"
    G1_SRC = "tpu_bls12_381_torch/csrc/g1_kernels.cu"
    a16, b16 = rand_field(FR, n), rand_field(FR, n).flip(1).contiguous()
    kernel_row("mont_mul_fr", "mont_mul_kernel", FIELD_SRC,
               "tpu_bls12_381/fields/pallas_ops.py:381",
               [16, n], lambda: cuda_ops.mont_mul(FR, a16, b16),
               lambda: cuda_ops.mont_mul_plain(FR, a16, b16),
               3 * 16 * n, 0, n * mul_mads(W_FR), 10)
    del a16, b16
    a24, b24 = rand_field(FQ, n), rand_field(FQ, n).flip(1).contiguous()
    kernel_row("mont_mul_fq", "mont_mul_kernel", FIELD_SRC,
               "tpu_bls12_381/fields/pallas_ops.py:381",
               [24, n], lambda: cuda_ops.mont_mul(FQ, a24, b24),
               lambda: cuda_ops.mont_mul_plain(FQ, a24, b24),
               3 * 24 * n, 0, n * mul_mads(W_FQ), 10)
    del a24, b24
    z1 = rand_field(FQ, 4)[:, 3:4].contiguous()
    kernel_row("mont_sqr_fq", "mont_sqr_kernel", FIELD_SRC,
               "tpu_bls12_381/fields/pallas_ops.py:391",
               [24, 1], lambda: cuda_ops.mont_sqr(FQ, z1),
               lambda: cuda_ops.mont_sqr_plain(FQ, z1),
               2 * 24, 0, sqr_mads(W_FQ), 50)

    # The scan at its (R, L) tile.  The plain version needs R dependent plain
    # adds; it is timed once.
    At = tiled_affine(R * L)
    tile = torch.cat([At[0], At[1]], dim=0).reshape(48, R, L).permute(1, 0, 2).contiguous()
    xr, yr = tile[:, :24], tile[:, 24:]
    sr = torch.from_numpy(rng.integers(0, 2, size=(R, L)).astype(bool)).to(dev)
    ir = torch.from_numpy(rng.integers(0, 16, size=(R, L)) == 0).to(dev)
    kernel_row("pmadd_signed", "pmadd_signed_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:430",
               [R, 24, L], lambda: cuda_g1.pmadd_signed_rows(xr, yr, sr, ir),
               lambda: cuda_g1.pmadd_signed_rows_plain(xr, yr, sr, ir),
               R * L * 5 * 24, R * L * 2, R * L * 11 * mul_mads(W_FQ), 3)
    del tile, xr, yr, sr, ir, At

    # padd at the boundary stage's 2*nb lanes (its widest call on the path;
    # the stitch, triangle and Horner calls run on L down to 1 lanes).
    nl = 2 * nb
    Al = tiled_affine(nl)
    Pl = contig(pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, Al)))
    Ql = contig(pj.affine_to_proj(FQ_PLAIN, roll(Al, 1)))
    kernel_row("padd", "padd_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:465",
               [24, nl], lambda: cuda_g1.padd(Pl, Ql),
               lambda: cuda_g1.padd_plain(Pl, Ql),
               9 * 24 * nl, 0, nl * 12 * mul_mads(W_FQ), 20)
    # pdbl on one lane, as the triangle combine and the Horner ladder call it.
    P1 = tuple(c[:, 7].contiguous() for c in Pl)
    kernel_row("pdbl", "pdbl_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:478",
               [24, 1], lambda: cuda_g1.pdbl(P1), lambda: cuda_g1.pdbl_plain(P1),
               6 * 24, 0, 6 * mul_mads(W_FQ) + 2 * sqr_mads(W_FQ), 50)

    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
