#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpu_bls12_381_torch/csrc``, holds every kernel
against its plain PyTorch version on the card (integer arithmetic, canonical
results: the tolerance is zero, ``torch.equal``), runs the golden n = 4096 G1
MSM vector with GLV off and on, and drives the two ported paths once each at
full width: ``msm_g1`` on 2^20 points, checked against one host scalar
multiplication, and the Fr NTT on 2^22 elements through ``NttContext`` (the
four-step by default, the radix-2 ladder when asked), checked against host
sums, round trips and each other; then the vector ops at 2^22.

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
import hashlib
import json
import os
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
LOG_N = 20             # the MSM path's point count, 2^20: never cut
NTT_LOG_N = 22         # the NTT path's size, 2^22 Fr elements: never cut
PHASES = ["build", "kernels", "msm_small", "msm_2e20", "ntt_small", "ntt_2e22",
          "vecops"]


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
    ap.add_argument("--upto", default=PHASES[-1], choices=PHASES,
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

    from tpu_bls12_381_torch import _build, constants, oracle, vecops
    from tpu_bls12_381_torch.curves import cuda_g1, g1
    from tpu_bls12_381_torch.curves import projective as pj
    from tpu_bls12_381_torch.curves.field_adapters import FQ_PLAIN
    from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, fast, ops
    from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
    from tpu_bls12_381_torch.msm import msm_g1, msm_geometry
    from tpu_bls12_381_torch.ntt import (Ordering, coset_intt, coset_ntt,
                                         cuda_ntt, get_domain, intt, ntt,
                                         release_domain)
    from tpu_bls12_381_torch.ntt.ntt import _butterflies, release_coset_cache
    from tpu_bls12_381_torch.runtime import NttContext, reset_config_cache, tracing
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
        # add, sub: lanes 0..2 hold 0, 1, p-1 against random values, the
        # last three lanes the same the other way round; lane 3 is
        # (p-1) + (p-1) (a sum >= p), lane 4 is 0 - 1 (a < b).
        a[:, 3] = a[:, 2]
        b[:, 3] = a[:, 2]
        a[:, 4] = a[:, 0]
        b[:, 4] = a[:, 1]
        for op, symbol in (("add", "field_add_kernel"), ("sub", "field_sub_kernel")):
            kern, plain = getattr(cuda_ops, op), getattr(cuda_ops, f"{op}_plain")
            check(f"{op}_{sfx}", symbol, N, [kern(spec, a, b)], [plain(spec, a, b)],
                  lambda: kern(spec, a, b), lambda: plain(spec, a, b),
                  lambda: cuda_ops.LAUNCHES[f"{op}_{sfx}"])
        # butterfly: w = 0 in lane 5, w = 1 (Montgomery) in lane 6, o = 0 in 7
        w = rand_field(spec, N).roll(7, 1).contiguous()
        w[:, 5] = 0
        w[:, 6] = ops.one_mont(spec, (), dev)
        o = b.clone()
        o[:, 7] = 0
        check(f"butterfly_{sfx}", "butterfly_kernel", N,
              cuda_ops.butterfly(spec, a, o, w), cuda_ops.butterfly_plain(spec, a, o, w),
              lambda: cuda_ops.butterfly(spec, a, o, w),
              lambda: cuda_ops.butterfly_plain(spec, a, o, w),
              lambda: cuda_ops.LAUNCHES[f"butterfly_{sfx}"])

    # One stage of the ladder on the array where it lies, (16, 4, 2^14): the
    # first stage, a middle one and the last.
    xs = rand_field(FR, N).reshape(16, 4, N // 4)
    tw14 = get_domain(14, dev).tw
    for half in (1, 1 << 6, 1 << 13):
        check(f"butterfly_stage_fr[half={half}]", "butterfly_stage_kernel", N,
              [cuda_ops.butterfly_stage(FR, xs, tw14, half)],
              [cuda_ops.butterfly_stage_plain(FR, xs, tw14, half)],
              lambda: cuda_ops.butterfly_stage(FR, xs, tw14, half),
              lambda: cuda_ops.butterfly_stage_plain(FR, xs, tw14, half),
              lambda: cuda_ops.LAUNCHES["butterfly_fr"])
    release_domain(14)

    # The NTT tile: a long row to a block; short rows, several to a block,
    # with a table of 4 rows serving 8 (the periodic case) and the scalar; 9
    # short rows (a block part empty) with both folds.
    def tile_case(B, log_m, Bw, scaled, inverse=False):
        m = 1 << log_m
        x = rand_field(FR, B * m).reshape(16, B, m)
        dom = get_domain(log_m, dev)
        tw = dom.itw if inverse else dom.tw
        w = rand_field(FR, Bw * m).reshape(16, Bw, m) if Bw else None
        scale = dom.n_inv if scaled else None
        check(f"ntt_tile[{B}x2^{log_m},Bw={Bw},scale={scaled}]", "ntt_tile_kernel",
              B * m, [cuda_ntt.ntt_tile(x, tw, w, scale)],
              [cuda_ntt.ntt_tile_plain(x, tw, w, scale)],
              lambda: cuda_ntt.ntt_tile(x, tw, w, scale),
              lambda: cuda_ntt.ntt_tile_plain(x, tw, w, scale),
              lambda: dict(cuda_ntt.LAUNCHES))

    tile_case(32, 11, 0, False)
    tile_case(8, 5, 4, False)
    tile_case(8, 5, 0, True)
    tile_case(9, 5, 3, True, inverse=True)
    tile_case(3, chip_profile(dev).ntt_tile_log_cap, 1, False)
    release_domain()

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
                   limbs_moved, mask_bytes, wide_mads, reps, n_launches=None,
                   per_call=1, **extra):
        """One row of the ``kernels`` line.  ``kernel_fn`` launches the kernel
        ``per_call`` times; ``plain_fn`` computes what its last launch does."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        del got, want
        b_ms, b_by = bound(limbs_moved * LIMB_BYTES + mask_bytes, wide_mads)
        s_ms, s_by = bound(limbs_moved * LIMB_BYTES_STORED + mask_bytes, wide_mads)
        timed = measure(kernel_fn, symbol, reps)
        timed["call_ms"] /= per_call
        if timed["ms_from"] == "events":
            timed["ms"] /= per_call
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": launches[name] if n_launches is None else n_launches,
               "max_abs_err": err, **timed,
               "plain_ms": time_ms(plain_fn, 1, warm=False), "bound_ms": b_ms,
               "bound_by": b_by, "bound_ms_as_stored": s_ms,
               "bound_by_as_stored": s_by, "library_ms": None, "shape": shape,
               **extra}
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

    del Al, Pl, Ql, P1, z1
    torch.cuda.empty_cache()
    if args.upto == "msm_2e20":
        return 10

    def set_algorithm(name):
        """What MIDNIGHT_NTT_ALGORITHM would say, for the calls that follow."""
        if name == "auto":
            os.environ.pop("MIDNIGHT_NTT_ALGORITHM", None)
        else:
            os.environ["MIDNIGHT_NTT_ALGORITHM"] = name
        reset_config_cache()

    def fr_mont(std):
        """Standard-form (16, ...) limbs -> Montgomery form, by the kernel."""
        return fast.mont_mul(FR, std, torch.from_numpy(
            FR.r2_limbs.astype(np.int32)).to(dev).reshape((16,) + (1,) * (std.dim() - 1)))

    def fr_ints(t):
        """Montgomery (16, n) limbs on the card -> Python integers."""
        limbs = fast.from_mont(FR, t).cpu().numpy().astype(np.uint16)
        raw = np.ascontiguousarray(limbs.T).tobytes()
        return [int.from_bytes(raw[32 * i:32 * i + 32], "little")
                for i in range(limbs.shape[1])]

    def device_trace(fn):
        """Device kernels of one call of ``fn``: [[name, ms, count], ...]."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sorted(([e.key[:60], round(e.self_device_time_total / 1e3, 4), e.count]
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and e.self_device_time_total > 0), key=lambda r: -r[1])

    r_mod = constants.FR_MODULUS

    # --------------------------------------------------------------- ntt_small
    with open(ROOT / "tests" / "vectors" / "ntt_vectors.json") as f:
        ntt_cases = json.load(f)["cases"]
    for case in ntt_cases:
        n_case = 1 << case["log_n"]
        if case["kind"] == "forward_digest":
            vals = [(i * i + 3) % r_mod for i in range(n_case)]
        else:
            vals = [int(v, 16) for v in case["input"]]
        xv = fr_mont(torch.from_numpy(
            ints_to_limbs(vals, 16).astype(np.int32)).to(dev))
        for algo in ("radix2", "fourstep"):
            set_algorithm(algo)
            cuda_ops.reset_launches()
            cuda_ntt.reset_launches()
            if case["kind"] == "coset":
                yv = coset_ntt(xv, case["shift"])
            else:
                yv = ntt(xv)
            got = fr_ints(yv)
            if case["kind"] == "forward_digest":
                hsh = hashlib.sha256()
                for v in got:
                    hsh.update(v.to_bytes(32, "little"))
                ok = hsh.hexdigest() == case["output_sha256_le32"]
            else:
                ok = got == [int(v, 16) for v in case["output"]]
            tiles = sum(cuda_ntt.LAUNCHES.values())
            stages = cuda_ops.LAUNCHES["butterfly_fr"]
            routed = (tiles, stages) == ((2, 0) if algo == "fourstep"
                                         else (0, case["log_n"]))
            emit({"phase": "ntt_small", "kind": case["kind"], "log_n": case["log_n"],
                  "algorithm": algo, "equal": ok, "tile_launches": tiles,
                  "butterfly_launches": stages})
            if not ok:
                raise AssertionError(f"ntt_small {case['kind']} 2^{case['log_n']} "
                                     f"{algo}: wrong result")
            if not routed:
                raise AssertionError(f"ntt_small {case['kind']} 2^{case['log_n']} "
                                     f"{algo}: took another route")
    set_algorithm("auto")
    release_domain()
    release_coset_cache()
    cuda_ntt.release_fourstep_cache()
    if args.upto == "ntt_small":
        return 10

    # ---------------------------------------------------------------- ntt_2e22
    n22 = 1 << NTT_LOG_N
    x_std = rand_field(FR, n22)
    x22 = fr_mont(x_std)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ctx = NttContext(NTT_LOG_N)                   # builds the 2^22 domain
    torch.cuda.synchronize()
    domain_s = time.perf_counter() - t0
    la22, lb22 = cuda_ntt._split_top(NTT_LOG_N, chip_profile(dev).ntt_tile_log_cap)
    t0 = time.perf_counter()
    cuda_ntt._step_w(NTT_LOG_N, 1 << la22, 1 << lb22, False, dev)
    get_domain(la22, dev)
    get_domain(lb22, dev)
    torch.cuda.synchronize()
    w_table_s = time.perf_counter() - t0

    def counted(fn):
        cuda_ops.reset_launches()
        cuda_ntt.reset_launches()
        out = fn()
        return out, {**cuda_ops.LAUNCHES, **cuda_ntt.LAUNCHES}

    t0 = time.perf_counter()
    y4, launches_4 = counted(lambda: ctx.forward(x22))     # the main path
    first_s = time.perf_counter() - t0
    set_algorithm("radix2")
    y2, launches_2 = counted(lambda: ctx.forward(x22))
    set_algorithm("auto")
    same = torch.equal(y4, y2)
    shape_ok = tuple(y4.shape) == (16, n22) and y4.dtype == torch.int32
    if (launches_4["ntt_tile"] + launches_4["ntt_tile_w"], launches_4["butterfly_fr"]) != (2, 0):
        raise AssertionError(f"ntt_2e22: the default route is not the four-step: {launches_4}")
    if launches_2["butterfly_fr"] != NTT_LOG_N or launches_2["ntt_tile"] + launches_2["ntt_tile_w"]:
        raise AssertionError(f"ntt_2e22: radix2 did not run {NTT_LOG_N} stages: {launches_2}")

    # Host checks with Python integers on standard-form values.  Limb sums
    # stay below 2^38, so numpy sums them exactly.
    xs_np = x_std.cpu().numpy().astype(np.int64)
    limb_sum = lambda cols: sum(int(v) << (16 * k) for k, v in enumerate(cols.sum(axis=1)))
    want0 = limb_sum(xs_np) % r_mod
    want_half = (limb_sum(xs_np[:, 0::2]) - limb_sum(xs_np[:, 1::2])) % r_mod
    k_probe = int(np.random.default_rng(SEED + 1).integers(1, n22))
    wk = pow(oracle.root_of_unity(NTT_LOG_N), k_probe, r_mod)
    raw = np.ascontiguousarray(xs_np.astype(np.uint16).T).tobytes()
    t0 = time.perf_counter()
    acc = 0
    for i in range(n22 - 1, -1, -1):              # Horner in w^k
        acc = (acc * wk + int.from_bytes(raw[32 * i:32 * i + 32], "little")) % r_mod
    horner_s = time.perf_counter() - t0
    probe = torch.tensor([0, n22 // 2, k_probe], device=dev)
    got0, got_half, got_k = fr_ints(y4[:, probe])
    host_ok = (got0, got_half, got_k) == (want0, want_half, acc)
    del xs_np, raw

    set_algorithm("radix2")
    back2 = torch.equal(ctx.inverse(y2), x22)
    set_algorithm("auto")
    back4, launches_inv = counted(lambda: torch.equal(ctx.inverse(y4), x22))
    del y2
    coset_back = torch.equal(coset_intt(coset_ntt(x22, 7), 7), x22)
    release_coset_cache()
    nr = ctx.forward(x22, Ordering.NR)
    nr_rn = (torch.equal(ctx.inverse(nr, Ordering.RN), x22)
             and torch.equal(vecops.bit_reverse(nr), y4))
    del nr
    xb = x22.reshape(16, 4, n22 // 4)
    yb, launches_b = counted(lambda: ctx.forward(xb))
    batched = all(torch.equal(yb[:, i], ctx.forward(xb[:, i].contiguous()))
                  for i in range(4))
    del yb, xb
    peak22 = torch.cuda.max_memory_allocated()

    def median_seconds(fn):
        fn()
        each = [tracing.timed_reps(1, fn) for _ in range(5)]
        return statistics.median(each), each

    med4, each4 = median_seconds(lambda: ctx.forward(x22))
    with tracing.collect_stages() as stages4:
        ctx.forward(x22)
    trace4 = device_trace(lambda: ctx.forward(x22))
    imed4, ieach4 = median_seconds(lambda: ctx.inverse(y4))
    set_algorithm("radix2")
    med2, each2 = median_seconds(lambda: ctx.forward(x22))
    trace2 = device_trace(lambda: ctx.forward(x22))
    set_algorithm("auto")
    ntt_ok = (same and shape_ok and host_ok and back2 and back4 and coset_back
              and nr_rn and batched)
    emit({"phase": "ntt_2e22", "n": n22, "equal": bool(ntt_ok),
          "fourstep_equals_ladder": same, "host_checks": host_ok,
          "probe_k": k_probe, "inverse_roundtrip_ladder": back2,
          "inverse_roundtrip_fourstep": back4, "coset_roundtrip": coset_back,
          "nr_rn_roundtrip": nr_rn, "batched_4x2e20": batched,
          "ntt_fr_2e22_elems_per_s": n22 / med4,
          "ntt_fr_2e22_elems_per_s_ladder": n22 / med2,
          "seconds_median_of_5": med4, "seconds_each": each4,
          "seconds_median_of_5_ladder": med2, "seconds_each_ladder": each2,
          "seconds_median_of_5_inverse": imed4, "seconds_each_inverse": ieach4,
          "seconds_first_call": first_s, "seconds_domain_build": domain_s,
          "seconds_w_table_build": w_table_s, "seconds_host_horner": round(horner_s, 2),
          "split": [la22, lb22], "launches": launches_4, "launches_ladder": launches_2,
          "launches_inverse": launches_inv, "launches_batched": launches_b,
          "peak_bytes_allocated": peak22, "bytes_allocated_before": mem_before,
          "stages_ms": {k: round(v, 3) for k, v in stages4.items()},
          "device_kernels_fourstep": trace4[:8], "device_kernels_ladder": trace2[:8],
          "other_launches_fourstep": sum(r[2] for r in trace4 if "ntt_tile" not in r[0]),
          "other_launches_ladder": sum(r[2] for r in trace2 if "butterfly_stage" not in r[0]),
          "card": smi})
    if not ntt_ok:
        raise AssertionError("ntt_2e22: a check failed (see the line above)")

    # Where the two algorithms cross: both timed at smaller sizes, the
    # four-step forced below the size from which `auto` takes it.
    for log_c in (12, 14, 16, 18, 20):
        xc = x22[:, :1 << log_c].contiguous()
        ctx_c = {}
        for algo in ("fourstep", "radix2"):
            set_algorithm(algo)
            yc = ctx.forward(xc)
            ctx_c[algo] = (yc, median_seconds(lambda: ctx.forward(xc)))
        set_algorithm("auto")
        if not torch.equal(ctx_c["fourstep"][0], ctx_c["radix2"][0]):
            raise AssertionError(f"ntt 2^{log_c}: four-step and ladder differ")
        emit({"phase": "ntt_crossover", "log_n": log_c,
              "fourstep_ms": ctx_c["fourstep"][1][0] * 1e3,
              "ladder_ms": ctx_c["radix2"][1][0] * 1e3,
              "fourstep_ms_each": [t * 1e3 for t in ctx_c["fourstep"][1][1]],
              "ladder_ms_each": [t * 1e3 for t in ctx_c["radix2"][1][1]]})
        del ctx_c, xc, yc
    if args.upto == "ntt_2e22":
        return 10

    # ------------------------------------------- NTT kernels at the path's shapes
    tw22 = get_domain(NTT_LOG_N, dev).tw
    xr22 = vecops.bit_reverse(x22)
    ladder_plain = lambda h: cuda_ops.butterfly_stage_plain(FR, xr22, tw22, h)
    for half in (1, 1 << 10):                     # the last stage is the row's own check
        if not torch.equal(cuda_ops.butterfly_stage(FR, xr22, tw22, half), ladder_plain(half)):
            raise AssertionError(f"butterfly_stage at 2^22, half={half}: kernel and plain differ")
    last = 1 << (NTT_LOG_N - 1)
    kernel_row("butterfly_fr", "butterfly_stage_kernel", FIELD_SRC,
               "tpu_bls12_381/fields/pallas_ops.py:421", [16, n22 // 2],
               lambda: cuda_ops.butterfly_stage(FR, xr22, tw22, last),
               lambda: ladder_plain(last),
               5 * 16 * (n22 // 2), 0, (n22 // 2) * mul_mads(W_FR), 10,
               n_launches=launches_2["butterfly_fr"],
               note="the ladder's last stage; ladder_ms_per_stage is the mean "
                    "over the 22 stages of one ladder",
               ladder_ms_per_stage=sum(r[1] for r in trace2 if "butterfly_stage" in r[0])
               / NTT_LOG_N)
    del xr22
    NTT_SRC = "tpu_bls12_381_torch/csrc/ntt_kernels.cu"
    m_in, m_out = 1 << lb22, 1 << la22
    W22 = cuda_ntt._step_w(NTT_LOG_N, m_out, m_in, False, dev)
    xt = x22.reshape(16, m_out, m_in)
    tw_in, tw_out = get_domain(lb22, dev).tw, get_domain(la22, dev).tw
    tile_mads = lambda rows, m, folds: (
        rows * (m // 2) * (m.bit_length() - 1) + folds * rows * m) * mul_mads(W_FR)
    kernel_row("ntt_tile_w", "ntt_tile_kernel", NTT_SRC,
               "tpu_bls12_381/ntt/pallas_ntt.py:80", [16, m_out, m_in],
               lambda: cuda_ntt.ntt_tile(xt, tw_in, w=W22),
               lambda: cuda_ntt.ntt_tile_plain(xt, tw_in, w=W22),
               3 * 16 * n22 + 16 * (m_in // 2), 0, tile_mads(m_out, m_in, 1), 5,
               n_launches=launches_4["ntt_tile_w"])
    del W22
    xt = x22.reshape(16, m_in, m_out)
    kernel_row("ntt_tile", "ntt_tile_kernel", NTT_SRC,
               "tpu_bls12_381/ntt/pallas_ntt.py:80", [16, m_in, m_out],
               lambda: cuda_ntt.ntt_tile(xt, tw_out),
               lambda: cuda_ntt.ntt_tile_plain(xt, tw_out),
               2 * 16 * n22 + 16 * (m_out // 2), 0, tile_mads(m_in, m_out, 0), 5,
               n_launches=launches_4["ntt_tile"])
    del xt, y4, ctx
    release_domain()
    cuda_ntt.release_fourstep_cache()
    vecops.release_bit_reverse()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ vecops
    b22 = rand_field(FR, n22).flip(1).contiguous()
    zero_lanes = [0, 3, 4097, n22 - 1]            # lane 0 holds 0 already
    xz = x22.clone()
    xz[:, zero_lanes] = 0
    (v_add, v_sub, v_mul, v_sum), launches_v = counted(lambda: (
        vecops.vector_add(FR, x22, b22), vecops.vector_sub(FR, x22, b22),
        vecops.vector_mul(FR, x22, b22), vecops.vector_sum(FR, x22)))
    sum_ok = fr_ints(v_sum[:, None])[0] == want0
    # (a + b) - b = a, and a*b against the plain product on a slice
    algebra_ok = (torch.equal(vecops.vector_sub(FR, v_add, b22), x22)
                  and torch.equal(vecops.vector_add(FR, v_sub, b22), x22)
                  and torch.equal(v_mul[:, :4096],
                                  ops.mont_mul(FR, x22[:, :4096], b22[:, :4096])))
    del v_add, v_sub, v_mul
    t0 = time.perf_counter()
    inv, launches_inv_v = counted(lambda: vecops.batch_inverse(FR, xz))
    torch.cuda.synchronize()
    inverse_s = time.perf_counter() - t0
    prod = vecops.vector_mul(FR, inv, xz)
    want = ops.one_mont(FR, (n22,), dev)
    want[:, zero_lanes] = 0
    inverse_ok = torch.equal(prod, want) and not bool(inv[:, zero_lanes].any())
    vec_ok = sum_ok and algebra_ok and inverse_ok
    emit({"phase": "vecops", "n": n22, "equal": bool(vec_ok), "vector_sum": sum_ok,
          "add_sub_mul": algebra_ok, "batch_inverse": inverse_ok,
          "batch_inverse_seconds": inverse_s, "launches": launches_v,
          "launches_batch_inverse": launches_inv_v})
    if not vec_ok:
        raise AssertionError("vecops: a check failed (see the line above)")
    if launches_v["add_fr"] < 1 or launches_v["sub_fr"] < 1:
        raise AssertionError(f"vecops: add/sub kernels never launched: {launches_v}")
    del inv, prod, want, xz
    for op, symbol, line in (("add", "field_add_kernel", 401),
                             ("sub", "field_sub_kernel", 411)):
        kern, plain = getattr(cuda_ops, op), getattr(cuda_ops, f"{op}_plain")
        kernel_row(f"{op}_fr", symbol, FIELD_SRC,
                   f"tpu_bls12_381/fields/pallas_ops.py:{line}", [16, n22],
                   lambda: kern(FR, x22, b22), lambda: plain(FR, x22, b22),
                   3 * 16 * n22, 0, 0, 10, n_launches=launches_v[f"{op}_fr"])
    del x22, b22, x_std

    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
