#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpu_bls12_381_torch/csrc``, holds every kernel
against its plain PyTorch version on the card (integer arithmetic, canonical
results: the tolerance is zero, ``torch.equal``; the NTT tile in each load
mode at rows of 2^1, 2^5, 2^11 and 2^12 with the table ``w`` and the scalar,
``butterfly_stages`` at 1 to 6 stages and the ladder's split at a shrunken
tile; the doubling chains ``pdbl``
and ``pdbl2`` at every count a path gives them, ``madd`` with P == A planted
in one lane, in a whole warp and in the last lane of a partial last warp,
``jadd`` with P == Q the same way, the batch inversion's three kernels at 2^16
with zeros planted, the elementwise product with a (K, 1) column and on its
one-lane path: n % 4 != 0 and a plane 4 bytes past a 16-byte boundary; the
add and the sub in every operand form, two planes, a (K, 1) column on either
side, the doubling and the negation, on both paths), sweeps the chains
at the paths' widths (``chain_sweep``: one doubling on 2^20 lanes, G1 and G2,
``madd`` on 2^20 lanes against its build with the doubling in every lane,
``jac_ladder`` against its build that reads x and y again at each add,
``jadd`` on 2^19 lanes with and without P == Q lanes, the batch inversion's
columns), runs the golden n = 4096 G1
MSM vector with GLV off and on, and drives the ported paths once each at
full width: ``msm_g1`` on 2^20 points, checked against one host scalar
multiplication, its tail's launches against the plan, its result's affine
conversion (``to_affine`` lines: ``MsmContext.to_affine`` with its one
``field_inv`` launch, and on the launch-a-step route of the Fermat ladder,
equal and the oracle's; likewise the batch of 4's results and ``msm_g2``'s), then the tail's lane
scan (``padd_scan``) at its shapes and the ``tile_sweep`` (the scan kernel
over three tiles of one window's adds, ``padd`` at two widths); then
``msm_traceable`` (G1 on the same 2^20 points with GLV off, G2 on 2^16 tiled
points: the eager call against ``msm_g1`` / ``msm_g2`` limb for limb, the host
and the plan's launches, one call captured in a ``torch.cuda.CUDAGraph`` and
replayed, also on new scalars copied into the captured input, the golden
vectors eager and replayed, eager against replay in turns); the cached-bases path a prover calls (``g1_context()``:
``upload_bases`` with precompute factor 2, ``msm_with_bases``, ``msm_batch``,
an MSM forced into 4 pieces) on the same 2^20 points, and ``msm_g2`` and
``g2_context()`` (factor 2) on 2^20 G2 points, each checked against the host,
their tails' launches against the plan (the G2 lane scan ``padd2_scan``, held
to its plain version in every mode on 2^16 - 3 and 3 x 1,001 lanes, then at
each of the paths' shapes), then the ``tile_sweep_g2`` (the G2 scan kernel
over four tiles of one window's adds, ``padd2`` at two widths), then the GLV
ladder (``scalar_mul_glv`` is one ``glv_ladder`` launch in ``msm_ctx_small``;
its row at (24, 4096) held to the plain ladder on every lane; the
``glv_vs_jac_ladder`` line: ``points.scalar_mul`` and ``scalar_mul_glv`` on the
same 2^20 lanes with per-lane scalars below r, one launch each, equal as
affine points on every lane, timed in turns; the row at (24, 2^20) held limb
for limb to the routed loop of elementwise kernels it replaces); and the Fr NTT
on 2^22 elements
through ``NttContext`` (``auto``'s route, the ladder on the card: one tile
launch reading the bit-reversed rows as columns of x, then two
``butterfly_stages`` launches; and the four-step, forced: two tile launches
on the columns), checked against host sums, round trips and each other, the
launches asserted by tile load mode and by (half, count); then the ladder's
tile at rows of 2^11 and 2^12 in turns (``ntt_ladder_split``), and both
algorithms from 2^10 to 2^24 (``ntt_crossover``); then the vector ops at
2^22 (``vector_sum`` one ``field_sum`` reduction, held to the host's sum and,
on (16, 2, 2^16) with a row of r - 1, to the halving tree; whole calls of
``vector_add``, ``vector_sub``, ``vector_sum`` and ``scalar_vec_add`` by CUDA
events); then the scale-out layer (``parallel``) on one rank over NCCL (a
group of one on a TCP store at 127.0.0.1, destroyed at the phase's end;
``init_distributed()`` with no coordinator returns False first):
``msm_g1_sharded`` over 4 chunks of msm_2e20's points with GLV, the factor-2
form as ``precompute`` lays it out (GLV-extended, expanded, 4 segments a
chunk) and the points as one chunk, each held by value to ``msm_g1`` and to
the host's point, each chunk of ``msm_chunked`` (the 4 chunks as one batch)
with ``torch.equal`` to the one-device call on it, the launches and the
tail to the batched plan (``msm_geometry(..., chunks=4)``), the ``all_gather``
and ``jadd`` counts; ``msm_g2_sharded`` over msm_g2_2e20's 2^20 points in 4
chunks, alike; each also timed against its chunks through the one-device
MSM one after another, rebuilt from public calls; ``ntt_sharded`` at 2^22 natural and
transposed, both inverses, the coset forms and ``ntt_batch_sharded`` on
(16, 4, 2^20), each held with ``torch.equal`` to ``ntt``, ``coset_ntt`` or
the input, with 3 (transposed: 2) ``all_to_all_single`` calls; each timed in
turns with its one-device call by CUDA events; then a row for each kernel
shape of these paths that no row had (the chunks' scans, tail adds and
doubling chains, the combine's ``jadd`` on 2 and 1 lanes, the add and sub
forms), and a line naming the rows that already held the others.  (The NTT's folds and its builds not kept are timed by
``python3 -m tpu_bls12_381_torch.ntt.sweeps``.)  Then SRS point validation
(``points_2e20``): 2^20 G1 points with planted non-members, off-curve points and an identity, written to
wire bytes and read back on the card, checked with ``is_on_curve_affine`` and
``is_in_subgroup`` (one ``jac_ladder`` launch: the whole 255-bit
double-and-add ladder, r read from one column) against the planted masks, the
members summed by ``sum_reduce`` (``jadd``, one a round) against the host
(the ladder's row held to the plain ladder on its first 2^14 lanes),
``scalar_mul`` on 256 lanes with per-lane scalars routed against the generic
formulas, and G2
on 1,028 lanes; and the README's Quick start through ``global_accelerator()``
(``entry``): warmup at 2^20 with factor 4, the validated points uploaded with
factor 4, ``msm_with_bases`` and its async form against the host, the 2^22
NTT round trip, ``dispatch_*`` on Python ints (every route must be ACCEL, and
CPU under ``MIDNIGHT_DEVICE=cpu``), with ``MIDNIGHT_TRACE=msm,ntt`` spans.

The generic ladders (G2's ``is_in_subgroup``, G1's ``scalar_mul`` through a
fresh ``FqAdapter``) and the affine conversions are held to the field
launches their formulas call, the doublings and negations among them.  The
plain-call guard counts the calls of ``fields/ops.py``'s add, sub, mont_mul
and mont_sqr on CUDA tensors inside the driven paths' calls (the
``plain_guard`` line, by phase); the run fails where one is above 0.

One JSON object per phase goes to standard output.  The last lines are the
``{"kernels": [...]}`` table, the card's name and power limit as ``nvidia-smi``
gives them, and ``{"ok": true, "device": {...}}``.  The table has one row for
each kernel at each shape a driven path gives it (``path`` names the path,
``launches`` is that path's count).  In it ``ms`` is
the kernel's own time on the card, read from a ``torch.profiler`` trace of
the timed launches; ``call_ms`` beside it is what one wrapper call costs
back to back (host checks, allocation and launch included), by CUDA events.
A ``pdbl`` or ``pdbl2`` row carries its chain's ``times`` (its bound counts
that many doublings, the bytes once; its plain time is the plain chain's of as
many doublings); a ``batch_inverse`` row its three phases' ms
and the whole call's seconds beside those of the launch-a-step route that
the kernels replace (``vecops.batch_inverse_loop`` on the field kernels).
Every MSM path's ``pdbl`` (G2: ``pdbl2``) launches and doublings are
asserted against its plan (``doubling_chains``, and the launches by chain
length), an upload's against its slices and factor, and a batch inversion's
against its three kernels.
``ms`` is ``call_ms`` where the trace misses launches or the two disagree
by more than one wrapper call's host cost (``launch_overhead_ms``, build
line; ``ms_from`` says which, ``profiler_ms`` keeps the trace's reading).
``bound_ms`` counts the bytes the function needs (2 for a 16-bit limb);
``bound_ms_as_stored`` counts the 4-byte slot a limb is stored in.  ``madd``
and ``jadd`` compute the doubling that only P == A (P == Q) lanes use in a
warp that holds one: ``madd``'s rows hold no such lane past warp 0, so their
``bound_ms`` is the add's alone and ``bound_ms_with_doubling`` that of the
sum and the doubling; ``jadd``'s rows hold them in most warps, so their bound
counts the doubling and ``bound_ms_without_doubling`` is the add's alone.
A ``jac_ladder`` row's bound counts 255 doublings a lane and an add for each
set bit of the lane's scalar (``set_bits``); a ``glv_ladder`` row's, 128
doublings and 256 mixed adds a lane, which the constant-time ladder computes
whatever the bits.  An NTT tile row's bound counts
no product by the twiddle w^0 = 1 (``bound_ms_all_products`` counts them), a
``butterfly_stages`` row's the twiddle entries its launch needs.  A
phase's line ends with ``seconds_since_start``.  Any failing phase raises,
and the exit code is then not 0.  Without a CUDA device the script exits with
code 2 and prints no result.

It imports only the port (``tpu_bls12_381_torch``), never JAX.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import ctypes
import dataclasses
import hashlib
import importlib
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
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
PHASES = ["build", "kernels", "msm_small", "msm_2e20", "msm_traceable", "msm_ctx_small",
          "msm_ctx_2e20", "msm_g2_2e20", "ntt_small", "ntt_2e22", "vecops",
          "parallel", "points_2e20", "entry"]
G2_HOST_POINTS = 1024  # distinct host multiples of the G2 generator, tiled
PLAIN_ONCE_MS = 5_000   # a plain call this long is timed once (kernel_row)
LATE = "g2_padd_scan"   # the source the build phase does not wait for


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended."""
    if "phase" in obj:
        obj = {**obj, "seconds_since_start": round(time.perf_counter() - T_START, 1)}
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


# One wrapper call's cost on the host with next to no device work (a
# one-element add, by CUDA events): set once the kernels are built.
LAUNCH_OVERHEAD_MS = [0.0]


def measure(fn, symbol: str, reps: int) -> dict:
    """Time ``reps`` back-to-back calls of a kernel wrapper.

    ``ms``: the kernel's own mean time on the card, from the trace's events
    whose name holds ``symbol``.  ``call_ms``: mean time of one call by CUDA
    events around the same calls untraced; on few lanes that is the
    wrapper's host time, not the kernel.  ``other_launches``: device kernels
    in the trace that are not the kernel (a wrapper should launch none).
    ``ms`` is ``call_ms`` instead (``ms_from`` says which) where the trace
    holds no device time, where it holds another count of launches than
    ``reps`` calls make, or where the two disagree by
    more than ``LAUNCH_OVERHEAD_MS``: short launches, whose profiler readings
    disagreed with their calls (``profiler_ms`` keeps the trace's reading).
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
    row = {"ms": call_ms, "ms_from": "events", "call_ms": call_ms,
           "traced_launches": count,
           "other_launches": sum(e.count for e in events) - count}
    if count:
        ms = sum(e.self_device_time_total for e in own) / 1e3 / count
        row["profiler_ms"] = ms
        launches_per_call = max(1, round(count / reps))
        whole = count == launches_per_call * reps
        if whole and abs(ms * launches_per_call - call_ms) <= LAUNCH_OVERHEAD_MS[0]:
            row.update(ms=ms, ms_from="profiler")
        elif not whole:
            row["ms_from"] = "events (the trace holds another count of launches)"
        else:
            row["ms_from"] = "events (profiler and call disagree)"
    return row


def ms_by_kernel(fn, symbols, reps: int) -> dict:
    """Mean device milliseconds of one launch of the kernel whose name holds
    each of ``symbols`` (a profiler trace of ``reps`` calls of ``fn``, which
    launches each once, after a warm one); "not measured" where the trace
    holds none of its launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    out = {}
    for s in symbols:
        own = [e for e in events if s in e.key]
        count = sum(e.count for e in own)
        out[s] = (sum(e.self_device_time_total for e in own) / 1e3 / count if count
                  else "not measured")
    return out


def ptxas_lines(log: str) -> dict:
    """Registers and spills of each kernel in ``nvcc -Xptxas -v`` output."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif "Used" in ln and "registers" in ln and fn:
            out[fn] = ln.split("ptxas info    :")[-1].strip()
        elif "spill" in ln and fn and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            out[fn + " spills"] = ln.strip()
    return out


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

    from tpu_bls12_381_torch import _build, constants, native, oracle, vecops
    from tpu_bls12_381_torch.curves import cuda_g1, cuda_g2, g1, g2
    from tpu_bls12_381_torch.curves import glv as glv_mod
    from tpu_bls12_381_torch.curves import points as pt
    from tpu_bls12_381_torch.curves import projective as pj
    from tpu_bls12_381_torch.curves.field_adapters import (FQ2_ADAPTER, FQ2_PLAIN,
                                                           FQ_ADAPTER, FQ_PLAIN,
                                                           FqAdapter)
    from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, fast, ops
    from tpu_bls12_381_torch.fields.limbs import int_to_limbs, ints_to_limbs
    from tpu_bls12_381_torch.msm import msm_g1, msm_g2, msm_geometry
    from tpu_bls12_381_torch.ntt import (Ordering, coset_intt, coset_ntt,
                                         cuda_ntt, get_domain, intt, ntt,
                                         release_domain)
    from tpu_bls12_381_torch.ntt.ntt import _butterflies, release_coset_cache
    ntt_mod = importlib.import_module("tpu_bls12_381_torch.ntt.ntt")
    from tpu_bls12_381_torch.runtime import (NttContext, backend_info, dispatch_msm,
                                             dispatch_ntt, dispatch_vecop, g1_context,
                                             g2_context, global_accelerator,
                                             reset_config_cache, total_live_bytes,
                                             tracing)
    from tpu_bls12_381_torch.runtime import types as wire
    from tpu_bls12_381_torch.tuning import chip_profile

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    rows = []              # the ``kernels`` line, filled phase by phase

    # The plain-call guard: calls of fields/ops.py's add, sub, mont_mul and
    # mont_sqr on CUDA tensors (a plain version running on the card) made
    # inside guarded(phase), around the driven paths' calls; the plain-version
    # checks run outside it.  The plain_guard line prints the counts by
    # phase, and the run fails where one is above 0.
    plain_calls = {}
    guard_phase = [None]

    def plain_counter(name, fn):
        def counted_op(spec, a, *rest):
            if guard_phase[0] is not None and isinstance(a, torch.Tensor) and a.is_cuda:
                plain_calls[guard_phase[0]][name] += 1
            return fn(spec, a, *rest)
        return counted_op

    for name_ in ("add", "sub", "mont_mul", "mont_sqr"):
        setattr(ops, name_, plain_counter(name_, getattr(ops, name_)))

    @contextlib.contextmanager
    def guarded(phase):
        plain_calls.setdefault(phase, dict.fromkeys(("add", "sub", "mont_mul", "mont_sqr"), 0))
        outer, guard_phase[0] = guard_phase[0], phase
        try:
            yield
        finally:
            guard_phase[0] = outer

    def stop_early() -> int:
        """The end of a partial run (``--upto``): the plain-call guard, the
        rows gathered so far, no ok line, exit code 10."""
        check_plain_guard()
        if rows:
            emit({"kernels_so_far": rows})
        return 10

    def check_plain_guard() -> None:
        """The plain_guard line: by phase, the calls of a plain field op on
        CUDA tensors inside the driven paths' calls; fails where one is
        above 0."""
        emit({"phase": "plain_guard", "calls_on_the_card": plain_calls})
        bad = {ph: {k: v for k, v in c.items() if v} for ph, c in plain_calls.items()
               if any(c.values())}
        if bad:
            raise AssertionError(f"plain_guard: plain field ops ran on the card inside the "
                                 f"driven paths: {bad}")

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
    # The host library of the CPU route (g++ of native/), built beside the
    # CUDA sources so that the entry phase's CPU route times the MSM only.
    native_build = {}

    def build_native():
        t_ = time.perf_counter()
        native_build["available"] = native.available()
        native_build["seconds"] = time.perf_counter() - t_

    # The build's longest compile (the G2 lane scan's, LATE) goes on while the
    # G1 phases run; the phase waits for every other source, and the G2 lane
    # scan's checks wait for it before msm_ctx_small.
    t0 = time.perf_counter()
    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    paths = _build.build([name for name in _build.source_names() if name != LATE])
    build_s = time.perf_counter() - t0
    native_thread.join()
    registers = {}
    for name in paths:
        registers.update(ptxas_lines(_build.build_log(name)))
    one = torch.zeros(16, 1, dtype=torch.int32, device=dev)
    LAUNCH_OVERHEAD_MS[0] = time_ms(lambda: cuda_ops.add(FR, one, one), 200)
    emit({"phase": "build", "seconds": round(build_s, 2),
          "launch_overhead_ms": LAUNCH_OVERHEAD_MS[0],
          "seconds_by_source": {k: round(v, 1) for k, v in _build.BUILD_SECONDS.items()},
          "native_host_library": native_build["available"],
          "seconds_native_build_beside": round(native_build["seconds"], 2),
          "libraries": sorted(p.name for p in paths.values()),
          "ptxas": registers})
    if args.upto == "build":
        return stop_early()

    # Builds not kept, timed against the kept ones: a source compiled from a
    # copy of the sources with statements changed, while the kernels phase
    # runs.  chain_sweep: g1_jac_kernels.cu with madd's doubling computed in
    # every lane (no warp branch, the constant-time select), and with the
    # ladder reading x and y again at each add (234 registers where the kept
    # build holds them in 248).
    def alt_build(name, source, changes):
        """``changes``: (file in csrc/, statement, replacement), each statement
        found once."""
        dir_ = _build.BUILD_DIR / name
        dir_.mkdir(parents=True, exist_ok=True)
        texts = {f"{source}.cu": (_build.CSRC_DIR / f"{source}.cu").read_text()}
        for file_, old, new in changes:
            src_ = texts.get(file_) or (_build.CSRC_DIR / file_).read_text()
            if src_.count(old) != 1:
                raise AssertionError(f"build: {name}: the statement to change is not in "
                                     f"{file_} as expected")
            texts[file_] = src_.replace(old, new)
        for file_, text in texts.items():
            (dir_ / file_).write_text(text)
        proc = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
             str(dir_ / f"lib{source}.so"), str(dir_ / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(lambda: proc.poll() is None and proc.kill())
        return proc, dir_ / f"lib{source}.so"

    alt_builds = {
        "madd every lane": alt_build(
            "madd_every_lane", "g1_jac_kernels",
            [("g1_jac.cuh", "if (WARP_ANY(x_eq & y_eq))\n"
              "        R = g1_jac_cmov(x_eq & y_eq, g1_jac_dbl<M>(P), R);",
              "R = g1_jac_cmov(x_eq & y_eq, g1_jac_dbl<M>(P), R);")]),
        "ladder x, y read at each add": alt_build(
            "ladder_reread", "g1_jac_kernels",
            [("g1_jac.cuh", "g1_jac_madd<CarryMul>(acc, x, y, inf)",
              "g1_jac_madd<CarryMul>(acc, fp_load<Fq>(x2, n, idx), "
              "fp_load<Fq>(y2, n, idx), inf)")]),
    }
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

    # The same for G2: 1024 multiples k_j * G2 on the host, as the JAX
    # package's bench makes its G2 points.
    t0 = time.perf_counter()
    ks2 = rng.integers(1, 1 << 16, size=G2_HOST_POINTS, dtype=np.int64)
    G2gen = oracle.g2_generator()
    base_pts2 = [oracle.jac_to_affine(
        oracle.scalar_mul(int(k), G2gen, oracle.FQ2_OPS), oracle.FQ2_OPS)
        for k in ks2]
    Ab2 = g2.affine_from_ints(base_pts2, device=dev)
    host_points2_s = time.perf_counter() - t0

    def tiled_affine_g2(n):
        reps = -(-n // G2_HOST_POINTS)
        return (Ab2[0].repeat(1, 1, reps)[..., :n].contiguous(),
                Ab2[1].repeat(1, 1, reps)[..., :n].contiguous(),
                Ab2[2].repeat(reps)[:n].contiguous())

    modules = (cuda_ops, cuda_g1, cuda_g2, cuda_ntt)

    @contextlib.contextmanager
    def field_shapes():
        """Calls of ``cuda_ops.add`` / ``sub`` / ``double`` / ``neg`` while
        open, by (kernel, the plane's shape): ``add_fq``, ``sub_fq[column]``
        (the second operand a (K, 1) column), ``sub_fq[column left]`` (the
        first), ``double_fq``, ..."""
        seen, keep = {}, {}
        for op_ in ("add", "sub", "double", "neg"):
            keep[op_] = getattr(cuda_ops, op_)

            def rec(spec, *args, op_=op_, fn_=keep[op_]):
                plane = max(args, key=lambda t: t.numel())
                form = ("" if len({tuple(t.shape) for t in args}) == 1 else
                        "[column left]" if args[0] is not plane else "[column]")
                key = (f"{op_}_{'fr' if spec.num_limbs == 16 else 'fq'}{form}",
                       tuple(plane.shape))
                seen[key] = seen.get(key, 0) + 1
                return fn_(spec, *args)
            setattr(cuda_ops, op_, rec)
        try:
            yield seen
        finally:
            for op_, fn_ in keep.items():
                setattr(cuda_ops, op_, fn_)

    def reset_counts():
        for mod in modules:
            mod.reset_launches()

    def counts():
        """Launches by kernel since the counts were set to 0,
        ``mont_mul_col_fr`` / ``mont_mul_col_fq``, those of ``mont_mul`` with
        a (K, 1) column, and ``pdbl_doublings`` / ``pdbl2_doublings``, the
        doublings of those ``pdbl`` / ``pdbl2`` launches."""
        out = {}
        for mod in modules:
            out.update(mod.LAUNCHES)
        for f in ("fr", "fq"):
            out[f"mont_mul_col_{f}"] = sum(v for (k_, _), v in cuda_ops.COLUMN_LAUNCHES.items()
                                           if k_ == f"mont_mul_{f}")
        out["pdbl_doublings"] = sum(t * k for t, k in cuda_g1.CHAIN_LAUNCHES.items())
        out["pdbl2_doublings"] = sum(t * k for t, k in cuda_g2.CHAIN_LAUNCHES.items())
        return out

    def chain_counts(mod=cuda_g1):
        """``pdbl``'s (``mod`` = ``cuda_g2``: ``pdbl2``'s) launches since the
        counts were set to 0, by the doublings each made: times -> launches."""
        return dict(mod.CHAIN_LAUNCHES)

    def set_budget_mb(mb):
        """What MIDNIGHT_MSM_HBM_BUDGET_MB would say, for the calls that follow."""
        if mb is None:
            os.environ.pop("MIDNIGHT_MSM_HBM_BUDGET_MB", None)
        else:
            os.environ["MIDNIGHT_MSM_HBM_BUDGET_MB"] = str(mb)

    def scan_counts(mod=cuda_g1):
        """``padd_scan``'s (``mod`` = ``cuda_g2``: ``padd2_scan``'s) launches
        since the counts were set to 0, by the mode and shape of each call."""
        return dict(mod.SCAN_LAUNCHES)

    def check_tail(what, launches_, plan, chains_, kernel="pdbl"):
        """The tail's lane scans and adds of one call are the plan's: every
        lane scan went through the scan kernel (``padd_scan``, or
        ``padd2_scan`` for G2), no Hillis-Steele step is left (each would be
        one more ``padd`` / ``padd2``): the plan's ``tail_launches``, keyed by
        the curve's kernels; and every chain of doublings (a window's
        triangle combine of lb_bits, a Horner step of w) was one ``kernel``
        launch (``pdbl``, or ``pdbl2`` for G2) with the chain's doublings:
        ``chains_``, the call's ``chain_counts()``, is the plan's split."""
        if plan["tail_launches"] is None:
            raise AssertionError(f"{what}: the plan has no tail launches")
        got = {k: launches_.get(k, 0) for k in plan["tail_launches"]}
        if got != plan["tail_launches"]:
            raise AssertionError(f"{what}: tail launches {got}, the plan has "
                                 f"{plan['tail_launches']}")
        chains = (launches_.get(kernel, 0), launches_.get(f"{kernel}_doublings", 0))
        if chains != (plan["doubling_chains"], plan["doublings"]):
            raise AssertionError(f"{what}: {chains[0]} {kernel} launches for {chains[1]} "
                                 f"doublings, the plan has {plan['doubling_chains']} "
                                 f"chains of {plan['doublings']}")
        want = {}
        for k, d in ((plan["scan_launches"], plan["lb_bits"]), (plan["T"] - 1, plan["w"])):
            if k > 0 and d > 0:
                want[d] = want.get(d, 0) + k
        if chains_ != want or sum(chains_.values()) != launches_.get(kernel, 0):
            raise AssertionError(f"{what}: {kernel} launches by doublings {chains_}, the "
                                 f"plan has {want}")

    def check_upload(what, launches_, slices, factor, span, kernel="pdbl", sqr_each=0):
        """An upload of ``slices`` point slices at ``factor``: one ``kernel``
        launch (``pdbl``; ``pdbl2`` for G2) of ``span`` doublings and one
        batch inversion (3 launches, and ``sqr_each`` ``mont_sqr``: none for
        G1, the Fq2 norm's one for G2) a slice and a block past the first."""
        chains = slices * (factor - 1)
        got = (launches_.get(kernel, 0), launches_.get(f"{kernel}_doublings", 0),
               launches_.get("batch_inverse_fq", 0), launches_.get("mont_sqr_fq", 0))
        want = (chains, chains * span, 3 * chains, sqr_each * chains)
        if got != want:
            raise AssertionError(
                f"{what}: ({kernel}, doublings, batch_inverse_fq, mont_sqr_fq) launches "
                f"{got}, an upload of {slices} slices at factor {factor} makes {want}")

    # ----------------------------------------------------------------- kernels
    N = 1 << 16
    contig = lambda T: tuple(c.contiguous() for c in T)

    def jac_scaled(T, v):
        """(v^2 X, v^3 Y, v Z): the same Jacobian points with another Z."""
        l = ops.broadcast_constant(FQ, int_to_limbs(FQ.to_mont(v), 24),
                                   tuple(T[0].shape[1:]), dev)
        l2 = FQ_PLAIN.sqr(l)
        return (FQ_PLAIN.mul(T[0], l2), FQ_PLAIN.mul(T[1], FQ_PLAIN.mul(l2, l)),
                FQ_PLAIN.mul(T[2], l))

    def jac_edge_cases(n):
        """Jacobian P, Q (Z != 1) and affine A on n tiled lanes, with the edge
        lanes: 0 P identity; 1 Q identity and A's inf; 2 P == Q and 3 P == -Q,
        Q's Z 7 times P's; 4 both identities; 5 P identity with A's inf;
        6 P == A and 7 P == -A, P's Z = 5; A's inf also on a random eighth."""
        A_ = tiled_affine(n)
        P_ = list(pt.jac_double(FQ_PLAIN, pt.affine_to_jac(FQ_PLAIN, roll(A_, 1))))
        Q_ = list(pt.jac_add(FQ_PLAIN, pt.affine_to_jac(FQ_PLAIN, roll(A_, 2)), tuple(P_)))
        id_ = pt.jac_identity(FQ_PLAIN, (n,), dev)
        Pq = jac_scaled(tuple(P_), 7)
        Aq = jac_scaled(pt.affine_to_jac(FQ_PLAIN, A_), 5)
        for c in range(3):
            P_[c][:, 0] = id_[c][:, 0]
            Q_[c][:, 1] = id_[c][:, 1]
            Q_[c][:, 2] = Pq[c][:, 2]
            Q_[c][:, 3] = pt.jac_neg(FQ_PLAIN, Pq)[c][:, 3]
            P_[c][:, 4] = id_[c][:, 4]
            Q_[c][:, 4] = id_[c][:, 4]
            P_[c][:, 5] = id_[c][:, 5]
            P_[c][:, 6] = Aq[c][:, 6]
            P_[c][:, 7] = pt.jac_neg(FQ_PLAIN, Aq)[c][:, 7]
        inf_ = torch.from_numpy(rng.integers(0, 8, size=n) == 0).to(dev)
        inf_[[1, 5]] = True
        inf_[[0, 2, 3, 4, 6, 7]] = False
        return contig(P_), contig(Q_), (A_[0], A_[1], inf_)

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
        check(f"mont_sqr_{sfx}", "mont_mul_kernel", N,
              [cuda_ops.mont_sqr(spec, a)], [cuda_ops.mont_sqr_plain(spec, a)],
              lambda: cuda_ops.mont_sqr(spec, a),
              lambda: cuda_ops.mont_sqr_plain(spec, a),
              lambda: cuda_ops.LAUNCHES[f"mont_sqr_{sfx}"])
        # from_mont is the product with a (K, 1) column of 1 through the same
        # kernel; a column in general; the one-lane path where n % 4 != 0
        # (N - 3 lanes) and where a plane starts 4 bytes past a 16-byte
        # boundary (every operand form on both)
        fm = fast.from_mont(spec, a)
        if not torch.equal(fm, ops.from_mont(spec, a)):
            raise AssertionError(f"from_mont {sfx}: kernel and plain differ")
        col = rand_field(spec, 5)[:, 4:5].contiguous()
        check(f"mont_mul_{sfx}[column]", "mont_mul_kernel", N,
              [cuda_ops.mont_mul(spec, a, col)], [cuda_ops.mont_mul_plain(spec, a, col)],
              lambda: cuda_ops.mont_mul(spec, a, col),
              lambda: cuda_ops.mont_mul_plain(spec, a, col),
              lambda: cuda_ops.COLUMN_LAUNCHES.get((f"mont_mul_{sfx}", N), 0))
        three = lambda x_, y_: (cuda_ops.mont_mul(spec, x_, y_), cuda_ops.mont_mul(spec, x_, col),
                                cuda_ops.mont_sqr(spec, x_))
        three_plain = lambda x_, y_: (cuda_ops.mont_mul_plain(spec, x_, y_),
                                      cuda_ops.mont_mul_plain(spec, x_, col),
                                      cuda_ops.mont_sqr_plain(spec, x_))
        a3, b3 = a[:, :N - 3].contiguous(), b[:, :N - 3].contiguous()
        flat = torch.zeros(spec.num_limbs * N + 4, dtype=torch.int32, device=dev)
        am = flat[1:1 + spec.num_limbs * N].view(spec.num_limbs, N)
        am.copy_(a)
        if am.data_ptr() % 16 != 4:
            raise AssertionError("kernels: the misaligned copy is not 4 bytes off")
        for what, x_, y_ in (("n % 4 != 0", a3, b3), ("misaligned", am, b)):
            check(f"mont_mul_{sfx}[one lane a thread: {what}]", "mont_", x_.shape[1],
                  three(x_, y_), three_plain(x_, y_), lambda: three(x_, y_),
                  lambda: three_plain(x_, y_),
                  lambda: cuda_ops.LAUNCHES[f"mont_mul_{sfx}"])
        del a3, b3, am, flat
        # add, sub: lanes 0..2 hold 0, 1, p-1 against random values, the
        # last three lanes the same the other way round; lane 3 is
        # (p-1) + (p-1) (a sum >= p), lane 4 is 0 - 1 (a < b).
        a[:, 3] = a[:, 2]
        b[:, 3] = a[:, 2]
        a[:, 4] = a[:, 0]
        b[:, 4] = a[:, 1]
        for op in ("add", "sub"):
            kern, plain = getattr(cuda_ops, op), getattr(cuda_ops, f"{op}_plain")
            check(f"{op}_{sfx}", "addsub_kernel", N, [kern(spec, a, b)], [plain(spec, a, b)],
                  lambda: kern(spec, a, b), lambda: plain(spec, a, b),
                  lambda: cuda_ops.LAUNCHES[f"{op}_{sfx}"])
        # every operand form of the add and the sub: a (K, 1) column right of
        # the plane and left of it (p - 1 and the random column), the plane
        # alone (a + a, 0 - a; 0 in lane 0); for Fr on the four-lane path,
        # then on the one-lane path where n % 4 != 0 and where a plane is
        # misaligned (Fq takes one lane a thread on all three)
        pm1 = a[:, 2:3].contiguous()

        def forms(x_, y_):
            return (cuda_ops.add(spec, x_, col), cuda_ops.add(spec, pm1, x_),
                    cuda_ops.sub(spec, x_, col), cuda_ops.sub(spec, pm1, x_),
                    cuda_ops.double(spec, x_), cuda_ops.neg(spec, x_),
                    cuda_ops.add(spec, x_, y_), cuda_ops.sub(spec, x_, y_))

        def forms_plain(x_, y_):
            c_, p_ = col.expand_as(x_), pm1.expand_as(x_)
            return (cuda_ops.add_plain(spec, x_, c_), cuda_ops.add_plain(spec, p_, x_),
                    cuda_ops.sub_plain(spec, x_, c_), cuda_ops.sub_plain(spec, p_, x_),
                    cuda_ops.double_plain(spec, x_), cuda_ops.neg_plain(spec, x_),
                    cuda_ops.add_plain(spec, x_, y_), cuda_ops.sub_plain(spec, x_, y_))

        a3, b3 = a[:, :N - 3].contiguous(), b[:, :N - 3].contiguous()
        flat = torch.zeros(spec.num_limbs * N + 4, dtype=torch.int32, device=dev)
        am = flat[1:1 + spec.num_limbs * N].view(spec.num_limbs, N)
        am.copy_(a)
        for what, x_, y_ in (("n % 4 == 0, aligned", a, b), ("n % 4 != 0", a3, b3),
                             ("misaligned", am, b)):
            check(f"add_sub_{sfx}[every form: {what}]", "addsub_kernel", x_.shape[1],
                  forms(x_, y_), forms_plain(x_, y_), lambda: forms(x_, y_),
                  lambda: forms_plain(x_, y_),
                  lambda: {k: cuda_ops.LAUNCHES[f"{k}_{sfx}"]
                           for k in ("add", "sub", "double", "neg")})
        del a3, b3, am, flat
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
    # first stage, a middle one and the last (butterfly_stages at count 1).
    xs = rand_field(FR, N).reshape(16, 4, N // 4)
    tw14 = get_domain(14, dev).tw
    for half in (1, 1 << 6, 1 << 13):
        check(f"butterfly_stage_fr[half={half}]", "butterfly_stages_kernel", N,
              [cuda_ops.butterfly_stage(FR, xs, tw14, half)],
              [cuda_ops.butterfly_stage_plain(FR, xs, tw14, half)],
              lambda: cuda_ops.butterfly_stage(FR, xs, tw14, half),
              lambda: cuda_ops.butterfly_stage_plain(FR, xs, tw14, half),
              lambda: cuda_ops.LAUNCHES["butterfly_stages"])
    # Several stages a launch, count 1 to 6, on (16, 2, 2^15): up to the
    # row's last stage with the row's own table, with the top stage's table,
    # from a small half (whole runs to a block), the scalar on two.
    x2 = rand_field(FR, N).reshape(16, 2, N // 2)
    for count, half, log_s, scaled in ((1, 1 << 14, 15, False), (2, 1 << 9, 11, True),
                                       (3, 1 << 12, 15, False), (4, 1 << 2, 6, False),
                                       (5, 1 << 10, 15, True), (6, 1 << 7, 13, False),
                                       (6, 1 << 9, 15, False)):
        tw_s = get_domain(log_s, dev).tw
        sc = get_domain(3, dev).n_inv if scaled else None
        check(f"butterfly_stages[half={half},count={count},S=2^{log_s},scale={scaled}]",
              "butterfly_stages_kernel", N,
              [cuda_ops.butterfly_stages(FR, x2, tw_s, half, count, sc)],
              [cuda_ops.butterfly_stages_plain(FR, x2, tw_s, half, count, sc)],
              lambda: cuda_ops.butterfly_stages(FR, x2, tw_s, half, count, sc),
              lambda: cuda_ops.butterfly_stages_plain(FR, x2, tw_s, half, count, sc),
              lambda: {str(k): v for k, v in cuda_ops.STAGE_LAUNCHES.items()})
    # The card's ladder split at a shrunken tile (rows of 2^4): 2^15 makes one
    # tile launch and launches of 6 and 5 stages (the last takes fewer).
    keep = ntt_mod.ladder_tile_log
    ntt_mod.ladder_tile_log = lambda t: 4
    tw15 = get_domain(15, dev).tw
    xl = x2[:, 0].contiguous()
    reset_counts()
    got_l = _butterflies(xl, tw15, 15, get_domain(15, dev).n_inv)
    split_launches = (dict(cuda_ntt.LAUNCHES), dict(cuda_ops.STAGE_LAUNCHES))
    ntt_mod.ladder_tile_log = keep
    want_l = xl
    for h in range(15):
        want_l = cuda_ops.butterfly_stage_plain(FR, want_l, tw15, 1 << h)
    want_l = ops.mont_mul(FR, want_l, get_domain(15, dev).n_inv[:, None])
    split_ok = torch.equal(got_l, want_l)
    emit({"phase": "kernels", "name": "ladder split at a tile of 2^4", "N": 1 << 15,
          "equal": split_ok, "split": ntt_mod.ladder_split(15, 4),
          "launches": [split_launches[0], {str(k): v for k, v in split_launches[1].items()}]})
    if not split_ok or split_launches != ({"ntt_tile": 1, "ntt_tile_w": 0},
                                          {(16, 6): 1, (1024, 5): 1}):
        raise AssertionError(f"the ladder's split at a tile of 2^4: equal {split_ok}, "
                             f"launches {split_launches}")
    del x2, xl, got_l, want_l
    release_domain()

    # The NTT tile in both load modes: rows of 2^1, 2^5, 2^11 and the cap
    # 2^12 (a last block part empty where rows share a block), with a table
    # w of fewer rows than x serving it periodically, and the scalar.
    def tile_case(B, log_m, Bw, scaled, natural_in, inverse=False):
        """Bit-reversed rows, or natural ones (a column a block)."""
        m = 1 << log_m
        x = rand_field(FR, B * m).reshape(16, B, m)
        dom = get_domain(log_m, dev)
        tw = dom.itw if inverse else dom.tw
        w = rand_field(FR, Bw * m).reshape(16, Bw, m) if Bw else None
        scale = dom.n_inv if scaled else None
        if natural_in:
            x4 = x.reshape(16, B, m, 1)
            kern = lambda: cuda_ntt.ntt_tile_columns(x4, tw, w, scale)
            plain = lambda: cuda_ntt.ntt_tile_columns_plain(x4, tw, w, scale)
        else:
            kern = lambda: cuda_ntt.ntt_tile(x, tw, w, scale)
            plain = lambda: cuda_ntt.ntt_tile_plain(x, tw, w, scale)
        check(f"ntt_tile[{B}x2^{log_m},Bw={Bw},scale={scaled},natural_in={natural_in}]",
              "ntt_tile_kernel", B * m, [kern()], [plain()], kern, plain,
              lambda: dict(cuda_ntt.MODE_LAUNCHES))

    cap = cuda_ntt._cap_log(dev)
    for natural_in in (True, False):
        tile_case((N >> 1) - 3, 1, 5, True, natural_in)
        tile_case((N >> 5) - 3, 5, 409, False, natural_in, inverse=True)
        tile_case(N >> 11, 11, 4, natural_in, natural_in)
        tile_case(N >> cap, cap, 1, not natural_in, natural_in)

    # Rows read as columns of (B, m, C) blocks: the four-step's (w of C rows,
    # the scalar) and the ladder's (columns in bit-reversed order).
    def columns_case(B, log_m, log_c, Bw, scaled, brev):
        m, C = 1 << log_m, 1 << log_c
        x = rand_field(FR, B * m * C).reshape(16, B, m, C)
        dom = get_domain(log_m, dev)
        w = rand_field(FR, Bw * m).reshape(16, Bw, m) if Bw else None
        scale = dom.n_inv if scaled else None
        check(f"ntt_tile_columns[{B}x2^{log_m}x2^{log_c},Bw={Bw},scale={scaled},"
              f"brev={brev}]", "ntt_tile_kernel", B * m * C,
              [cuda_ntt.ntt_tile_columns(x, dom.tw, w, scale, brev)],
              [cuda_ntt.ntt_tile_columns_plain(x, dom.tw, w, scale, brev)],
              lambda: cuda_ntt.ntt_tile_columns(x, dom.tw, w, scale, brev),
              lambda: cuda_ntt.ntt_tile_columns_plain(x, dom.tw, w, scale, brev),
              lambda: dict(cuda_ntt.MODE_LAUNCHES))

    columns_case(1, 8, 8, 1 << 8, False, False)
    columns_case(2, 8, 7, 0, True, False)
    columns_case(1, 11, 5, 0, False, True)
    columns_case(4, 5, 9, 0, True, True)
    columns_case(1, cap, 16 - cap, 2, False, True)
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
    # The doubling chain at each count a path gives it (the triangle's 7,
    # Horner's 15, the factor-4 and factor-2 uploads' 48 and 80 on 2^20
    # lanes), on the same lanes: torch.equal to as many plain doublings.
    pdbl_equal = {}
    for times in (7, 15, 48, 80):
        got = cuda_g1.pdbl(P, times)
        torch.cuda.synchronize()
        pdbl_equal[times] = trees_equal(got, cuda_g1.pdbl_plain(P, times))
        if not pdbl_equal[times]:
            raise AssertionError(f"pdbl times={times}: kernel and plain version differ")
        if not bool(ops.is_zero(FQ, got[2][:, [0, 4]]).all()):
            raise AssertionError(f"pdbl times={times}: 2^k * identity is not the identity")
    emit({"phase": "kernels", "name": "pdbl chains", "N": N, "equal": pdbl_equal})

    def chain_equal(times, curve="g1"):
        """``pdbl(P, times)`` (``curve="g2"``: ``pdbl2``) equals its plain
        version on the 2^16 edge lanes (checked once a count)."""
        kern, plain, P_, seen = ((cuda_g2.pdbl2, cuda_g2.pdbl2_plain, P2_edge, pdbl2_equal)
                                 if curve == "g2" else
                                 (cuda_g1.pdbl, cuda_g1.pdbl_plain, P_edge, pdbl_equal))
        if times not in seen:
            seen[times] = trees_equal(kern(P_, times), plain(P_, times))
            if not seen[times]:
                raise AssertionError(f"{kern.__name__} times={times}: kernel and plain "
                                     f"version differ")
        return seen[times]

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

    # The mixed add without the sign on the same lanes (lane 6 is P + P here).
    Ai = (A[0], A[1], inf2)
    check("pmadd", "pmadd_kernel", N, cuda_g1.pmadd(Pm, Ai),
          cuda_g1.pmadd_plain(Pm, Ai), lambda: cuda_g1.pmadd(Pm, Ai),
          lambda: cuda_g1.pmadd_plain(Pm, Ai), lambda: cuda_g1.LAUNCHES["pmadd"])

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

    # The lane scan in every mode, on 2^16 lanes of one row and on 3 rows of
    # 1,001 lanes (an odd width, the last block part empty), with the edge
    # lanes: identities (lanes 0 and 4 of P), P and -P side by side (lanes 8
    # and 9: P's lane 3 and Q's, which is -P there).
    Ps = tuple(torch.cat([p[:, :8], p[:, 3:4], q[:, 3:4], p[:, 10:]], dim=1).contiguous()
               for p, q in zip(P, Q))
    Po = tuple(c[:, :3 * 1001].reshape(24, 3, 1001).contiguous() for c in Ps)
    modes = [dict(reverse=r, exclusive=e) for r in (False, True) for e in (False, True)]
    modes.append(dict(total=True))
    for operand, what in ((Ps, "2^16"), (Po, "3 x 1001")):
        for mode in modes:
            if not trees_equal(cuda_g1.padd_scan(operand, **mode),
                               cuda_g1.padd_scan_plain(operand, **mode)):
                raise AssertionError(f"padd_scan {what} {mode}: kernel and plain differ")
    pair = tuple(c[:, 8:10].contiguous() for c in Ps)
    if not bool(ops.is_zero(FQ, cuda_g1.padd_scan(pair, total=True)[2])):
        raise AssertionError("padd_scan: P + (-P) is not the identity")
    check("padd_scan", "padd_scan_", N, cuda_g1.padd_scan(Ps, exclusive=True),
          cuda_g1.padd_scan_plain(Ps, exclusive=True),
          lambda: cuda_g1.padd_scan(Ps, exclusive=True),
          lambda: cuda_g1.padd_scan_plain(Ps, exclusive=True),
          lambda: cuda_g1.LAUNCHES["padd_scan"], reps=3)
    P_edge = P                             # the chains' edge lanes, for the rows below
    del P, Q, Pm, A, Ai, Aproj, tile, xr, yr, got, want, negP, ident, Ps, Po

    # The same edge lanes over Fq2, coordinates (24, 2, N).  Lanes 10..12 of
    # the first operand hold Fq2 values with c0 = c1, c0 = 0 and c1 = p - 1 in
    # X (not curve points: the kernels are straight-line formulas, and -c0-c1
    # and 12(c0-c1) must come out canonical there too).
    A2 = tiled_affine_g2(N)
    P2 = list(pj.proj_double(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, roll(A2, 1))))
    Q2 = list(pj.proj_add(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, roll(A2, 2)),
                          tuple(P2)))
    ident2 = pj.proj_identity(FQ2_PLAIN, (N,), dev)
    negP2 = pj.proj_neg(FQ2_PLAIN, tuple(P2))
    for c in range(3):
        P2[c][..., 0] = ident2[c][..., 0]     # identity + Q
        Q2[c][..., 1] = ident2[c][..., 1]     # P + identity
        Q2[c][..., 2] = P2[c][..., 2]         # P + P
        Q2[c][..., 3] = negP2[c][..., 3]      # P + (-P)
        Q2[c][..., 4] = ident2[c][..., 4]     # identity + identity
        P2[c][..., 4] = ident2[c][..., 4]
    pm1 = torch.from_numpy(ints_to_limbs([FQ.modulus - 1], 24)[:, 0].astype(np.int32)).to(dev)
    P2[0][:, 1, 10] = P2[0][:, 0, 10]         # c0 = c1
    P2[0][:, 0, 11] = 0                       # c0 = 0
    P2[0][:, 1, 12] = pm1                     # c1 = p - 1
    P2, Q2 = contig(P2), contig(Q2)
    got = cuda_g2.padd2(P2, Q2)
    want = cuda_g2.padd2_plain(P2, Q2)
    if not bool(FQ2_PLAIN.is_zero(got[2][..., 3:5]).all()):
        raise AssertionError("padd2: P + (-P) is not the identity")
    check("padd2", "padd2_kernel", N, got, want, lambda: cuda_g2.padd2(P2, Q2),
          lambda: cuda_g2.padd2_plain(P2, Q2), lambda: cuda_g2.LAUNCHES["padd2"])
    check("pdbl2", "pdbl2_kernel", N, cuda_g2.pdbl2(P2), cuda_g2.pdbl2_plain(P2),
          lambda: cuda_g2.pdbl2(P2), lambda: cuda_g2.pdbl2_plain(P2),
          lambda: cuda_g2.LAUNCHES["pdbl2"])
    # The G2 doubling chain at each count a path gives it (the triangle's 7,
    # Horner's 14, the factor-2 upload's 140 on 2^20 lanes), on the same
    # lanes, identities among them: torch.equal to as many plain doublings.
    pdbl2_equal = {}
    for times in (1, 7, 14, 140):
        got = cuda_g2.pdbl2(P2, times)
        torch.cuda.synchronize()
        pdbl2_equal[times] = trees_equal(got, cuda_g2.pdbl2_plain(P2, times))
        if not pdbl2_equal[times]:
            raise AssertionError(f"pdbl2 times={times}: kernel and plain version differ")
        if not bool(FQ2_PLAIN.is_zero(got[2][..., [0, 4]]).all()):
            raise AssertionError(f"pdbl2 times={times}: 2^k * identity is not the identity")
    emit({"phase": "kernels", "name": "pdbl2 chains", "N": N, "equal": pdbl2_equal})

    Pm2 = [c.clone() for c in P2]
    Aproj2 = pj.affine_to_proj(FQ2_PLAIN, A2)
    for c in range(3):
        Pm2[c][..., 5] = Aproj2[c][..., 5]    # P + P      (same affine point)
        Pm2[c][..., 6] = Aproj2[c][..., 6]    # P + (-P)   (sign set)
        Pm2[c][..., 8] = ident2[c][..., 8]    # identity + A
    Pm2 = contig(Pm2)
    A2 = (A2[0], A2[1], inf2)
    got = cuda_g2.pmadd2(Pm2, A2, sign)
    want = cuda_g2.pmadd2_plain(Pm2, A2, sign)
    if not bool(FQ2_PLAIN.is_zero(got[2][..., 6])):
        raise AssertionError("pmadd2: P + (-P) is not the identity")
    check("pmadd2", "pmadd2_kernel", N, got, want,
          lambda: cuda_g2.pmadd2(Pm2, A2, sign),
          lambda: cuda_g2.pmadd2_plain(Pm2, A2, sign),
          lambda: cuda_g2.LAUNCHES["pmadd2"])
    if not trees_equal(cuda_g2.pmadd2(Pm2, A2), cuda_g2.pmadd2_plain(Pm2, A2)):
        raise AssertionError("pmadd2 without a sign: kernel and plain differ")

    # Looped, on the two halves of one (R, 96, L) tile as the MSM passes them.
    tile = torch.cat([A2[0].reshape(48, N), A2[1].reshape(48, N)], dim=0
                     ).reshape(96, Rr, Lr).permute(1, 0, 2).contiguous()
    xr, yr = tile[:, :48].unflatten(1, (24, 2)), tile[:, 48:].unflatten(1, (24, 2))
    got = cuda_g2.pmadd2_rows(xr, yr, sr, ir)
    want = cuda_g2.pmadd2_rows_plain(xr, yr, sr, ir)
    check("pmadd2_rows", "pmadd2_kernel", N, got, want,
          lambda: cuda_g2.pmadd2_rows(xr, yr, sr, ir),
          lambda: cuda_g2.pmadd2_rows_plain(xr, yr, sr, ir),
          lambda: cuda_g2.LAUNCHES["pmadd2"], reps=3)
    # The same rows on 1,001 lanes (the last block part empty), a column of
    # identities among them.
    tile_o = tile[..., :1001].contiguous()
    xo, yo = tile_o[:, :48].unflatten(1, (24, 2)), tile_o[:, 48:].unflatten(1, (24, 2))
    so, io = sr[:, :1001].contiguous(), ir[:, :1001].contiguous()
    g2_odd_equal = {"pmadd2_rows 8 x 1001": trees_equal(
        cuda_g2.pmadd2_rows(xo, yo, so, io), cuda_g2.pmadd2_rows_plain(xo, yo, so, io))}
    # The elementwise kernels on 2^16 - 3 lanes (a partial last block), the
    # edge lanes above among them: identities, P == A (lane 5), P == -A
    # (lane 6), inf2 lanes (7, 9 and a random eighth), negated lanes.
    n_odd2 = N - 3
    cut = lambda T: tuple(c[..., :n_odd2].contiguous() for c in T)
    Pm2o, A2o, sign_o = cut(Pm2), cut(A2), sign[:n_odd2].contiguous()
    g2_odd_equal[f"pmadd2 {n_odd2}"] = trees_equal(
        cuda_g2.pmadd2(Pm2o, A2o, sign_o), cuda_g2.pmadd2_plain(Pm2o, A2o, sign_o))
    P2o, Q2o = cut(P2), cut(Q2)
    g2_odd_equal[f"padd2 {n_odd2}"] = trees_equal(cuda_g2.padd2(P2o, Q2o),
                                                   cuda_g2.padd2_plain(P2o, Q2o))
    emit({"phase": "kernels", "name": "G2 adds on odd widths", "equal": g2_odd_equal})
    for what_, ok_ in g2_odd_equal.items():
        if not ok_:
            raise AssertionError(f"{what_}: kernel and plain version differ")
    del tile_o, xo, yo, so, io, Pm2o, A2o, sign_o, P2o, Q2o

    # The G2 lane scan in every mode, on 2^16 - 3 lanes of one row (a
    # partial last block) and on 3 rows of 1,001 lanes, with the edge lanes:
    # identities (lanes 0 and 4 of P2), P and -P side by side (lanes 8 and
    # 9: P2's lane 3 and Q2's, which is -P there).
    Ps2 = tuple(torch.cat([p[..., :8], p[..., 3:4], q[..., 3:4], p[..., 10:n_odd2]],
                          dim=-1).contiguous() for p, q in zip(P2, Q2))
    Po2 = tuple(c[..., :3 * 1001].reshape(24, 2, 3, 1001).contiguous() for c in Ps2)
    # (checked before msm_ctx_small, once its source has compiled)
    P2_edge = P2                           # the G2 chains' edge lanes, for the rows below
    del P2, Q2, Pm2, A2, Aproj2, tile, xr, yr, sr, ir, got, want, negP2, ident2

    # The Jacobian kernels on the edge lanes of points.jac_add_affine /
    # jac_add / jac_double (operands from jac_edge_cases, below).
    Pj, Qj, Aj = jac_edge_cases(N)
    got = cuda_g1.jadd(Pj, Qj)
    if not bool(ops.is_zero(FQ, got[2][:, 3:5]).all()):
        raise AssertionError("jadd: P + (-P) is not the identity")
    check("jadd", "jadd_kernel", N, got, cuda_g1.jadd_plain(Pj, Qj),
          lambda: cuda_g1.jadd(Pj, Qj), lambda: cuda_g1.jadd_plain(Pj, Qj),
          lambda: cuda_g1.LAUNCHES["jadd"])
    got = cuda_g1.madd(Pj, Aj)
    if not bool(ops.is_zero(FQ, got[2][:, [5, 7]]).all()):
        raise AssertionError("madd: P + (-A) is not the identity")
    check("madd", "madd_kernel", N, got, cuda_g1.madd_plain(Pj, Aj),
          lambda: cuda_g1.madd(Pj, Aj), lambda: cuda_g1.madd_plain(Pj, Aj),
          lambda: cuda_g1.LAUNCHES["madd"])
    # madd computes the doubling only in a warp with a P == A lane.  Besides
    # warp 0's lane 6 above: a whole warp of P == A lanes (warp 1), and a
    # launch of 2^16 - 3 lanes whose last lane is P == A and the one before
    # P == -A, so the last warp is partial and branches.
    madd_equal = {}
    Pw, inf_w = [c.clone() for c in Pj], Aj[2].clone()
    n_odd = N - 3
    eq_lanes, neg_lanes = list(range(32, 64)) + [n_odd - 1], [n_odd - 2]
    inf_w[eq_lanes + neg_lanes] = False
    Aw = (Aj[0], Aj[1], inf_w)
    Aq = jac_scaled(pt.affine_to_jac(FQ_PLAIN, Aw), 5)
    for c in range(3):
        Pw[c][:, eq_lanes] = Aq[c][:, eq_lanes]
        Pw[c][:, neg_lanes] = pt.jac_neg(FQ_PLAIN, Aq)[c][:, neg_lanes]
    Pw = contig(Pw)
    for what, P_, A_ in (("warp 1 all P == A", Pw, Aw),
                         (f"{n_odd} lanes, the last P == A",
                          tuple(c[:, :n_odd].contiguous() for c in Pw),
                          tuple(c[..., :n_odd].contiguous() for c in Aw))):
        got = cuda_g1.madd(P_, A_)
        torch.cuda.synchronize()
        madd_equal[what] = trees_equal(got, cuda_g1.madd_plain(P_, A_))
        if not madd_equal[what]:
            raise AssertionError(f"madd, {what}: kernel and plain version differ")
        if not bool(ops.is_zero(FQ, got[2][:, neg_lanes]).all()):
            raise AssertionError(f"madd, {what}: P + (-A) is not the identity")
    emit({"phase": "kernels", "name": "madd planted", "N": N, "equal": madd_equal})
    del Pw, Aw, Aq, inf_w
    # jadd likewise computes the doubling only in a warp with a P == Q lane.
    # Besides warp 0's lane 2 above: a whole warp of P == Q lanes (warp 1,
    # Q = P with Z times 3), and 2^16 - 3 lanes whose last lane is P == Q and
    # the one before P == -Q.
    jadd_equal = {}
    Qw = [c.clone() for c in Qj]
    Pq3 = jac_scaled(Pj, 3)
    for c in range(3):
        Qw[c][:, eq_lanes] = Pq3[c][:, eq_lanes]
        Qw[c][:, neg_lanes] = pt.jac_neg(FQ_PLAIN, Pq3)[c][:, neg_lanes]
    Qw = contig(Qw)
    for what, P_, Q_ in (("warp 1 all P == Q", Pj, Qw),
                         (f"{n_odd} lanes, the last P == Q",
                          tuple(c[:, :n_odd].contiguous() for c in Pj),
                          tuple(c[:, :n_odd].contiguous() for c in Qw))):
        got = cuda_g1.jadd(P_, Q_)
        torch.cuda.synchronize()
        jadd_equal[what] = trees_equal(got, cuda_g1.jadd_plain(P_, Q_))
        if not jadd_equal[what]:
            raise AssertionError(f"jadd, {what}: kernel and plain version differ")
        if not bool(ops.is_zero(FQ, got[2][:, neg_lanes]).all()):
            raise AssertionError(f"jadd, {what}: P + (-P) is not the identity")
    emit({"phase": "kernels", "name": "jadd planted", "N": N, "equal": jadd_equal})
    del Qw, Pq3
    check("jdbl", "jdbl_kernel", N, cuda_g1.jdbl(Pj), cuda_g1.jdbl_plain(Pj),
          lambda: cuda_g1.jdbl(Pj), lambda: cuda_g1.jdbl_plain(Pj),
          lambda: cuda_g1.LAUNCHES["jdbl"])
    del Pj, Qj, Aj, got

    # Montgomery's batch inversion (three kernels) against the plain loop, with
    # zeros planted (among them lane 0, and the last lane), at 2^16 (a tile of
    # R x L = 4 x 2^14 on the card's profile) and at 2^16 - 3 (the last row
    # padded with ones).
    binv_equal = {}
    for spec, sfx in ((FR, "fr"), (FQ, "fq")):
        xb = rand_field(spec, N)
        xb[:, [0, 5, 4097, N - 1]] = 0
        for n_ in (N, N - 3):
            xn = xb[:, :n_].contiguous()
            got = vecops.batch_inverse(spec, xn)
            torch.cuda.synchronize()
            binv_equal[f"{sfx} {n_}"] = torch.equal(got, vecops.batch_inverse_plain(spec, xn))
            if not binv_equal[f"{sfx} {n_}"]:
                raise AssertionError(f"batch_inverse {sfx} at {n_}: kernels and plain differ")
        check(f"batch_inverse_{sfx}", "binv_", N, [vecops.batch_inverse(spec, xb)],
              [vecops.batch_inverse_plain(spec, xb)],
              lambda: vecops.batch_inverse(spec, xb),
              lambda: vecops.batch_inverse_plain(spec, xb),
              lambda: cuda_ops.LAUNCHES[f"batch_inverse_{sfx}"])
    emit({"phase": "kernels", "name": "batch_inverse", "equal": binv_equal})
    del xb, xn, got

    # The chains' sweep at the paths' widths: one doubling on the uploads'
    # 2^20 lanes, G1 and G2 (the pdbl[upload] and pdbl2[upload] rows have
    # their 80 and 140), madd's two builds on 2^20 lanes, jadd on 2^19 with
    # and without P == Q lanes, and the batch inversion's columns L on the upload's
    # (24, 2^20) and the vecops phase's (16, 2^22).  Kernel times from the
    # trace; every tile against the first.
    chain_sweep = []
    Pu = contig(pj.affine_to_proj(FQ_PLAIN, tiled_affine(1 << LOG_N)))
    t_ = measure(lambda: cuda_g1.pdbl(Pu, 1), "pdbl_kernel", 5)
    chain_sweep.append({"kernel": "pdbl", "shape": [24, 1 << LOG_N], "times": 1,
                        "ms": t_["ms"], "ms_from": t_["ms_from"]})
    del Pu
    Pu2 = contig(pj.affine_to_proj(FQ2_PLAIN, tiled_affine_g2(1 << LOG_N)))
    t_ = measure(lambda: cuda_g2.pdbl2(Pu2, 1), "pdbl2_kernel", 5)
    chain_sweep.append({"kernel": "pdbl2", "shape": [24, 2, 1 << LOG_N], "times": 1,
                        "ms": t_["ms"], "ms_from": t_["ms_from"]})
    del Pu2
    # madd on is_in_subgroup's (24, 2^20) with no P == A lane (the
    # accumulator 2A), and the ladder on the same points with r: each kept
    # build against its build not kept, in turns kept, other, other, kept;
    # the outputs are held equal.
    Au = tiled_affine(1 << LOG_N)
    Pm = contig(cuda_g1.jdbl_plain(pt.affine_to_jac(FQ_PLAIN, Au)))
    r_col = torch.from_numpy(ints_to_limbs([constants.FR_MODULUS], 16).astype(np.int32)).to(dev)
    kept_jac_lib = cuda_g1._jac_lib
    alt_logs = {}
    for (what, (proc_, lib_path)), kernel, run in zip(
            alt_builds.items(), ("madd", "jac_ladder"),
            (lambda: cuda_g1.madd(Pm, Au), lambda: cuda_g1.jac_ladder(r_col, Au, 255))):
        alt_logs[what], _ = proc_.communicate()
        if proc_.returncode != 0:
            raise AssertionError(f"chain_sweep: the build '{what}' failed:\n{alt_logs[what]}")
        other = ctypes.CDLL(str(lib_path))
        fn = f"g1_{kernel}"
        getattr(other, fn).argtypes = getattr(kept_jac_lib(), fn).argtypes
        ref = run()
        for build_ in ("kept", what, what, "kept"):
            if build_ == what:
                cuda_g1._jac_lib = lambda: other
            try:
                same = trees_equal(run(), ref)
                t_ = measure(run, f"{kernel}_kernel", 10 if kernel == "madd" else 3)
            finally:
                cuda_g1._jac_lib = kept_jac_lib
            chain_sweep.append({"kernel": kernel, "shape": [24, 1 << LOG_N], "build": build_,
                                "ms": t_["ms"], "ms_from": t_["ms_from"], "equal": same})
            if not same:
                raise AssertionError(f"{kernel}'s build '{build_}' differs from the kept one")
    # jadd at sum_reduce's first-round shape, (24, 2^19): with the tiled
    # points lane i + 2^19 holds lane i's point, so P == Q in every lane and
    # every warp computes the doubling; rolled by one lane, no lane has P == Q.
    Jl = tuple(c[:, :1 << (LOG_N - 1)].contiguous() for c in Pm)
    Jr = tuple(c[:, 1 << (LOG_N - 1):].contiguous() for c in Pm)
    for what, Q_ in (("P == Q in every lane", Jr),
                     ("no P == Q lane", contig(roll(Jr, 1)))):
        t_ = measure(lambda: cuda_g1.jadd(Jl, Q_), "jadd_kernel", 10)
        chain_sweep.append({"kernel": "jadd", "shape": [24, 1 << (LOG_N - 1)], "lanes": what,
                            "ms": t_["ms"], "ms_from": t_["ms_from"]})
    del Au, Pm, ref, Jl, Jr, r_col
    phases = ("binv_prefix", "binv_columns", "binv_unwind")
    for spec, log_n in ((FQ, LOG_N), (FR, NTT_LOG_N)):
        xs_ = rand_field(spec, 1 << log_n)
        ref = None
        for log_l in (12, 13, 14, 15, 16):
            out_ = cuda_ops.batch_inverse(spec, xs_, 1 << log_l)
            ref = out_ if ref is None else ref
            same = torch.equal(out_, ref)
            ph = ms_by_kernel(lambda: cuda_ops.batch_inverse(spec, xs_, 1 << log_l), phases, 3)
            chain_sweep.append({"kernel": "batch_inverse", "shape": [spec.num_limbs, 1 << log_n],
                                "L": 1 << log_l, "R": -(-(1 << log_n) >> log_l),
                                "phase_ms": ph, "equal": same})
            if not same:
                raise AssertionError(f"batch_inverse at L = 2^{log_l}: the tiles differ")
        del xs_, ref, out_
    torch.cuda.empty_cache()
    emit({"phase": "chain_sweep", "rows": chain_sweep, "card": smi,
          "ptxas_not_kept": {
              what: {k: v for k, v in ptxas_lines(alt_logs[what]).items() if kernel in k}
              for what, kernel in zip(alt_builds, ("madd", "jac_ladder"))}})
    if args.upto == "kernels":
        return stop_early()
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
        return stop_early()

    # ---------------------------------------------------------------- msm_2e20
    n = 1 << LOG_N
    A = tiled_affine(n)

    def draw_scalars(count):
        """``count`` scalars below 2^254 < r from the seed: their four 64-bit
        words (4, count), and their (16, count) limbs in standard and in
        Montgomery form on the card."""
        words_ = rng.integers(0, np.iinfo(np.uint64).max, size=(4, count),
                              dtype=np.uint64, endpoint=True)
        words_[3] &= np.uint64((1 << 62) - 1)
        limbs_ = np.empty((16, count), dtype=np.int32)
        for wi in range(4):
            for li in range(4):
                limbs_[4 * wi + li] = ((words_[wi] >> np.uint64(16 * li))
                                       & np.uint64(0xFFFF)).astype(np.int32)
        std = torch.from_numpy(limbs_).to(dev)
        mont = cuda_ops.mont_mul(
            FR, std, ops.broadcast_constant(FR, FR.r2_limbs, (count,), dev))
        return words_, std, mont

    words, s_std, s_mont = draw_scalars(n)
    limbs = s_std.cpu().numpy()                  # the parallel phase makes them again
    if not torch.equal(fast.from_mont(FR, s_mont), s_std):
        raise AssertionError("msm_2e20: scalars do not round-trip through Montgomery form")

    def host_scalar_total(mults, words_=None):
        """sum_i s_i * mults[i mod m] mod r for the scalars of ``words_``
        (default: those above).  Per residue j the scalars are summed in
        32-bit halves (no overflow: at most 2^20 / m terms below 2^32 each,
        m >= 1024)."""
        words_ = words if words_ is None else words_
        count = words_.shape[1]
        m = len(mults)
        pad = (-count) % m
        total = 0
        for wi in range(4):
            w_ = np.concatenate([words_[wi], np.zeros(pad, np.uint64)]).reshape(-1, m)
            lo = (w_ & np.uint64(0xFFFFFFFF)).sum(axis=0)
            hi = (w_ >> np.uint64(32)).sum(axis=0)
            for j in range(min(m, count)):
                total += ((int(lo[j]) + (int(hi[j]) << 32)) << (64 * wi)) * int(mults[j])
        return total % constants.FR_MODULUS

    # Expected: (sum_i s_i * k_{i mod 4096} mod r) * G, one host scalar mul.
    expected = oracle.jac_to_affine(
        oracle.scalar_mul(host_scalar_total(ks), G, oracle.FQ_OPS), oracle.FQ_OPS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    geo = msm_geometry(n, device=dev)            # the plan msm_g1 follows
    reset_counts()
    t0 = time.perf_counter()
    with guarded("msm_2e20"):
        Pj = msm_g1(s_mont, A)                   # the main path, first call
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts()
    columns = dict(cuda_ops.COLUMN_LAUNCHES)     # (kernel, lanes) -> launches
    scans = scan_counts()
    chains = chain_counts()
    peak = torch.cuda.max_memory_allocated()
    got = g1.jacobian_to_ints(tuple(c[:, None] for c in Pj))[0]
    ok = got == expected and all(tuple(c.shape) == (24,) for c in Pj)

    secs = []
    with guarded("msm_2e20"):
        for _ in range(3):
            secs.append(tracing.timed_reps(1, lambda: msm_g1(s_mont, A)))
        with tracing.collect_stages() as stages:
            msm_g1(s_mont, A)
    med = statistics.median(secs)
    on_path = ["mont_mul_fr", "mont_mul_fq", "mont_sqr_fq",
               "pmadd_signed", "padd", "pdbl", "padd_scan"]
    emit({"phase": "msm_2e20", "n": n, "equal": bool(ok),
          "g1_msm_2e20_points_per_s": n / med, "seconds_median_of_3": med,
          "seconds_each": secs, "seconds_first_call": first_s,
          **{k: geo[k] for k in ("glv", "w", "T", "L", "R", "nb", "tail_launches")},
          "launches": launches, "pdbl_launches_by_doublings": chains,
          "column_launches_by_lanes": {f"{f} {l}": k for (f, l), k in columns.items()},
          "peak_bytes_allocated": peak,
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
    check_tail("msm_2e20", launches, geo, chains)
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
    del s_std
    torch.cuda.empty_cache()

    # ------------------------------------- kernels at the main path's shapes
    L, R, nb = geo["L"], geo["R"], geo["nb"]
    W_FR, W_FQ = FR.num_limbs // 2, FQ.num_limbs // 2

    def kernel_row(name, symbol, source, replaces, shape, kernel_fn, plain_fn,
                   limbs_moved, mask_bytes, wide_mads, reps, n_launches=None,
                   per_call=1, *, path, kernels_per_call=1, plain_lanes=None, **extra):
        """One row of the ``kernels`` line: a kernel at the shape that the
        driven path ``path`` gives it, with its launches in that path's run
        (a kernel that several paths run at different shapes has a row for
        each, named ``kernel[path]``).  ``kernel_fn`` launches the kernel
        ``per_call`` times; ``plain_fn`` computes what its last launch does,
        and ``max_abs_err`` compares its output with the kernel's.
        ``plain_ms`` is the time of a second plain call, since the first
        call at a shape pays one-off costs (lazy module loading, allocation)
        that can double a call of a few seconds; a first call of
        ``PLAIN_ONCE_MS`` or more (the ladders, the upload chains, the
        larger scans), where they weigh less, is not repeated, and is the
        time (``plain_ms_of_call`` says which).  A
        function of several kernels (``kernels_per_call``, the lane scan's
        passes) is timed whole: ``ms`` is the sum of its kernels' times.
        ``plain_lanes``: ``plain_fn`` computes the first that many lanes
        only (the last axis), and the kernel's output is held to it there;
        ``plain_ms`` is then the slice's."""
        got = kernel_fn()
        if plain_lanes is not None:
            got = tuple(c[..., :plain_lanes] for c in got)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain_fn()
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        del got, want
        plain_call = 1 if plain_ms >= PLAIN_ONCE_MS else 2
        if plain_call == 2:
            plain_ms = time_ms(plain_fn, 1, warm=False)
        b_ms, b_by = bound(limbs_moved * LIMB_BYTES + mask_bytes, wide_mads)
        s_ms, s_by = bound(limbs_moved * LIMB_BYTES_STORED + mask_bytes, wide_mads)
        timed = measure(kernel_fn, symbol, reps)
        if timed["ms_from"] == "profiler":
            timed["ms"] *= kernels_per_call
        timed["call_ms"] /= per_call
        if timed["ms_from"].startswith("events"):
            timed["ms"] /= per_call
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": launches[name] if n_launches is None else n_launches,
               "max_abs_err": err, **timed,
               "plain_ms": plain_ms, "plain_ms_of_call": plain_call, "bound_ms": b_ms,
               "bound_by": b_by, "bound_ms_as_stored": s_ms,
               "bound_by_as_stored": s_by, "library_ms": None, "shape": shape,
               "path": path, **({"plain_lanes": plain_lanes} if plain_lanes else {}),
               **extra}
        if err != 0:
            raise AssertionError(f"{name} at {shape}: kernel and plain differ")
        rows.append(row)

    FIELD_SRC = "tpu_bls12_381_torch/csrc/field_kernels.cu"
    ADD_TPU, SUB_TPU = ("tpu_bls12_381/fields/pallas_ops.py:401",
                        "tpu_bls12_381/fields/pallas_ops.py:411")

    def addsub_row(key, shape, n_launches, path):
        """A row of the add or sub kernel in one operand form (``key`` as
        ``field_shapes`` names it: ``add_fq``, ``sub_fq[column left]``,
        ``double_fq``, ...) at ``shape``, with a path's launches."""
        op, form = key.split("_")[0], key[key.find("["):] if "[" in key else ""
        spec = FR if key.split("[")[0].endswith("fr") else FQ
        K_, lanes = spec.num_limbs, int(np.prod(shape[1:]))
        x_ = rand_field(spec, max(lanes, 3))[:, :lanes].reshape(shape).contiguous()
        y_ = rand_field(spec, max(lanes, 3))[:, -lanes:].flip(1).reshape(shape).contiguous()
        c_ = rand_field(spec, 5)[:, 2:3].contiguous()          # p - 1
        cb = c_.reshape((K_,) + (1,) * (len(shape) - 1))
        kern, plain = getattr(cuda_ops, op), getattr(cuda_ops, f"{op}_plain")
        if op in ("double", "neg"):
            fn, pfn, planes = (lambda: kern(spec, x_)), (lambda: plain(spec, x_)), 2
        elif form == "[column]":
            fn, pfn, planes = (lambda: kern(spec, x_, c_)), (lambda: plain(spec, x_, cb)), 2
        elif form == "[column left]":
            fn, pfn, planes = (lambda: kern(spec, c_, x_)), (lambda: plain(spec, cb, x_)), 2
        else:
            fn, pfn, planes = (lambda: kern(spec, x_, y_)), (lambda: plain(spec, x_, y_)), 3
        kernel_row(f"{key}[{path.split(':')[0]}]", "addsub_kernel", FIELD_SRC,
                   ADD_TPU if op in ("add", "double") else SUB_TPU, list(shape), fn, pfn,
                   planes * K_ * lanes + (K_ if form else 0), 0, 0, 20,
                   n_launches=n_launches, path=path)
    G1_SRC = "tpu_bls12_381_torch/csrc/g1_kernels.cu"
    BINV_SRC = "tpu_bls12_381_torch/csrc/batch_inverse.cu"
    dbl_mads = 6 * mul_mads(W_FQ) + 2 * sqr_mads(W_FQ)     # one doubling, 6M + 2S
    dbl2_mads = 22 * mul_mads(W_FQ)                        # one G2 doubling, 22 Fq products
    # jadd: the sum with its doubling (13M + 10S), the add alone (11M + 5S)
    jadd_mads = 13 * mul_mads(W_FQ) + 10 * sqr_mads(W_FQ)
    jadd_add_mads = 11 * mul_mads(W_FQ) + 5 * sqr_mads(W_FQ)
    JAC_SRC = "tpu_bls12_381_torch/csrc/g1_jac_kernels.cu"

    def seconds_median(fn, reps=3):
        """Median host seconds of ``fn()`` to a synchronised end."""
        fn()
        each = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            each.append(time.perf_counter() - t0_)
        return statistics.median(each)

    def binv_row(name, spec, x_, n_launches, path):
        """The batch inversion on ``x_`` as a path gives it: the three
        kernels' ms, the bound of 3 products an element against 2 K limbs
        moved (x read, the inverses written; ``limbs_moved_by_design`` has
        the kernels' 5 K, the prefixes written and read back and x read
        twice), and the whole call's seconds beside those of the route
        before the kernels (a mont_mul or mont_sqr launch a step, counted)."""
        K_, n_ = spec.num_limbs, x_.shape[-1]
        pr6 = lambda: vecops.batch_inverse_loop(spec, x_, fast.mont_mul, fast.mont_sqr)
        reset_counts()
        by_step = pr6()
        pr6_launches = {k: v for k, v in counts().items() if v}
        if not torch.equal(by_step, vecops.batch_inverse(spec, x_)):
            raise AssertionError(f"{name}: the kernels and the launch-a-step route differ")
        del by_step
        tile = vecops.batch_inverse_tile(n_)
        phase_ms = ms_by_kernel(lambda: vecops.batch_inverse(spec, x_),
                                ("binv_prefix", "binv_columns", "binv_unwind"), 5)
        measured = all(isinstance(v, float) for v in phase_ms.values())
        kernel_row(name, "binv_", BINV_SRC,
                   "tpu_bls12_381/fields/pallas_ops.py:381 and :391 (as vecops.batch_inverse runs them)",
                   [K_, n_], lambda: vecops.batch_inverse(spec, x_),
                   lambda: vecops.batch_inverse_plain(spec, x_),
                   2 * K_ * n_, 0, 3 * n_ * mul_mads(K_ // 2), 5, n_launches=n_launches,
                   path=path, kernels_per_call=3, tile_R_L=list(tile), phase_ms=phase_ms,
                   limbs_moved_by_design=5 * K_ * n_,
                   **({"ms": sum(phase_ms.values()),
                       "ms_from": "profiler: the three phases' means"} if measured else {}),
                   call_s=seconds_median(lambda: vecops.batch_inverse(spec, x_)),
                   call_s_launch_a_step=seconds_median(pr6),
                   launches_launch_a_step=pr6_launches)
    # The elementwise product at the MSM's width: Fr planes (no driven path
    # multiplies two (16, 2^20) planes since msm_g1's from_mont takes a
    # column: the row keeps the kernel's time at that shape); then the
    # product with one (K, 1) column, which msm_g1 launches once each:
    # from_mont's 1 on the Fr scalars, GLV's beta on the Fq x coordinates.
    # Such a call moves two planes and the column.
    MUL_TPU = "tpu_bls12_381/fields/pallas_ops.py:381"
    a16, b16 = rand_field(FR, n), rand_field(FR, n).flip(1).contiguous()
    kernel_row("mont_mul_fr", "mont_mul_kernel", FIELD_SRC, MUL_TPU,
               [16, n], lambda: cuda_ops.mont_mul(FR, a16, b16),
               lambda: cuda_ops.mont_mul_plain(FR, a16, b16),
               3 * 16 * n, 0, n * mul_mads(W_FR), 10, n_launches=0,
               path="kernels: two Fr planes at the MSM's width (msm_g1's from_mont: "
                    "the column row)")
    del b16
    one16 = ops.constant_column(FR, int_to_limbs(1, 16), dev)
    kernel_row("mont_mul_fr[from_mont]", "mont_mul_kernel", FIELD_SRC, MUL_TPU,
               [16, n], lambda: cuda_ops.mont_mul(FR, a16, one16),
               lambda: cuda_ops.mont_mul_plain(FR, a16, one16),
               2 * 16 * n + 16, 0, n * mul_mads(W_FR), 10,
               n_launches=columns.get(("mont_mul_fr", n), 0),
               path="msm_2e20: msm_g1 (fast.from_mont)", column=[16, 1])
    del a16
    x24 = rand_field(FQ, n)
    beta_col = ops.constant_column(
        FQ, int_to_limbs(FQ.to_mont(glv_mod.beta()), 24), dev)
    kernel_row("mont_mul_fq[glv]", "mont_mul_kernel", FIELD_SRC, MUL_TPU,
               [24, n], lambda: cuda_ops.mont_mul(FQ, x24, beta_col),
               lambda: cuda_ops.mont_mul_plain(FQ, x24, beta_col),
               2 * 24 * n + 24, 0, n * mul_mads(W_FQ), 10,
               n_launches=columns.get(("mont_mul_fq", n), 0),
               path="msm_2e20: msm_g1 (glv.endomorphism)", column=[24, 1])
    del x24
    z1 = rand_field(FQ, 4)[:, 3:4].contiguous()
    kernel_row("mont_sqr_fq", "mont_mul_kernel", FIELD_SRC,
               "tpu_bls12_381/fields/pallas_ops.py:391",
               [24, 1], lambda: cuda_ops.mont_sqr(FQ, z1),
               lambda: cuda_ops.mont_sqr_plain(FQ, z1),
               2 * 24, 0, sqr_mads(W_FQ), 50,
               path="msm_2e20: msm_g1")

    # The affine conversion of a result (MsmContext.to_affine): its one
    # inversion is one field_inv launch, where the launch-a-step route (the
    # Fermat ladder, a mont_sqr, and a mont_mul where the bit is set, a
    # launch each for the bits of p - 2) makes 610.
    INV_TPU = ("tpu_bls12_381/fields/pallas_ops.py:381 and :391 (as fields/ops.py "
               "inv_mont chains them)")
    kernel_inv = fast.inv_mont

    def inv_launch_a_step(spec, a):
        return ops.pow_const(spec, a, spec.modulus - 2, mul=fast.mont_mul, sqr=fast.mont_sqr)

    def fermat_mads(spec, lanes):
        """Multiply-adds of csrc's fp_inv_fermat on ``lanes`` lanes: the table's
        14 products, then 4 squares a 4-bit digit of p - 2 below the top one
        and a product for each such digit that is not 0."""
        digits = [((spec.modulus - 2) >> (4 * i)) & 15 for i in range(4 * spec.num_limbs)]
        squares, products = 4 * (len(digits) - 1), 14 + sum(1 for d in digits[:-1] if d)
        w_ = spec.num_limbs // 2
        return lanes * (squares * sqr_mads(w_) + products * mul_mads(w_))

    # The launches of jac_to_affine, from its text: the inverse of Z, its
    # square, two products.  G1: one field_inv_fq, one mont_sqr_fq, three
    # mont_mul_fq.  G2 (Fq2Adapter): the inverse is the norm's square (one Fq
    # mont_sqr on both components), their sum, one Fq inverse, the product
    # by it and the negation of c1; the square is the complex squaring (an
    # add, a sub, a product, a doubling), each of the three products
    # Karatsuba (2 adds, a product, 3 subs).
    TO_AFFINE_LAUNCHES = {
        "g1": {"field_inv_fq": 1, "mont_sqr_fq": 1, "mont_mul_fq": 3},
        "g2": {"field_inv_fq": 1, "mont_sqr_fq": 1, "mont_mul_fq": 1 + 1 + 3,
               "add_fq": 1 + 1 + 3 * 2, "sub_fq": 1 + 3 * 3, "double_fq": 1, "neg_fq": 1}}

    def to_affine_case(what, ctx_, P_, want, curve_mod, curve):
        """``ctx_.to_affine(P_)`` on the kernel route and on the launch-a-step
        route (``fast.inv_mont`` the ladder on the field kernels): median
        seconds, launches, the two equal (``torch.equal``) and the ints the
        oracle's.  Fails unless the kernel route launched what
        ``TO_AFFINE_LAUNCHES[curve]`` has, one ``field_inv_fq`` among them
        (``mont_mul_col_fq`` counts those of its products with a column
        again)."""
        reset_counts()
        with guarded("to_affine"):
            got_k = ctx_.to_affine(P_)
            torch.cuda.synchronize()
            launches_k = {k: v for k, v in counts().items() if v}
            s_k = seconds_median(lambda: ctx_.to_affine(P_))
        fast.inv_mont = inv_launch_a_step
        try:
            reset_counts()
            got_s = ctx_.to_affine(P_)
            torch.cuda.synchronize()
            launches_s = {k: v for k, v in counts().items() if v}
            s_s = seconds_median(lambda: ctx_.to_affine(P_))
        finally:
            fast.inv_mont = kernel_inv
        same = all(torch.equal(x_, y_) for x_, y_ in zip(got_k, got_s))
        oracle_ok = curve_mod.affine_to_ints(got_k) == want
        launch_ok = ({k: v for k, v in launches_k.items() if not k.startswith("mont_mul_col")}
                     == TO_AFFINE_LAUNCHES[curve])
        emit({"phase": "to_affine", "what": what, "lanes": int(P_[0].shape[-1]),
              "equal_routes": same, "equal_oracle": oracle_ok,
              "seconds": s_k, "seconds_launch_a_step": s_s,
              "launches": launches_k, "launches_launch_a_step": launches_s, "card": smi})
        if not (same and oracle_ok and launch_ok):
            raise AssertionError(f"to_affine of {what}: routes equal {same}, the oracle's "
                                 f"{oracle_ok}, launches {launches_k} (the formulas': "
                                 f"{TO_AFFINE_LAUNCHES[curve]})")
        return launches_k

    conv1 = to_affine_case("msm_2e20: the single shot's result", g1_context(),
                           tuple(c[:, None] for c in Pj), [expected], g1, "g1")
    del Pj
    kernel_row("field_inv_fq[to_affine]", "field_inv_kernel", FIELD_SRC, INV_TPU,
               [24, 1], lambda: cuda_ops.field_inv(FQ, z1),
               lambda: cuda_ops.field_inv_plain(FQ, z1),
               2 * 24, 0, fermat_mads(FQ, 1), 20, n_launches=conv1["field_inv_fq"],
               path="msm_2e20: MsmContext.to_affine of msm_g1's result")
    x4096 = rand_field(FR, 4096)
    kernel_row("field_inv_fr", "field_inv_kernel", FIELD_SRC, INV_TPU,
               [16, 4096], lambda: cuda_ops.field_inv(FR, x4096),
               lambda: cuda_ops.field_inv_plain(FR, x4096),
               2 * 16 * 4096, 0, fermat_mads(FR, 4096), 10, n_launches=0,
               path="kernels: Fr on 4096 lanes, 0, 1 and r - 1 among them (no driven "
                    "path inverts Fr on fewer than 4096 lanes)")
    del x4096

    # The scan at its (R, L) tile: one launch walks the R rows of every lane.
    # The plain version needs R dependent plain adds.
    def scan_row_g1(name, path, R_, lanes, n_launches, **extra):
        At_ = tiled_affine(R_ * lanes)
        tile_ = torch.cat([At_[0], At_[1]], dim=0).reshape(48, R_, lanes
                                                           ).permute(1, 0, 2).contiguous()
        del At_
        xr_, yr_ = tile_[:, :24], tile_[:, 24:]
        sr_ = torch.from_numpy(rng.integers(0, 2, size=(R_, lanes)).astype(bool)).to(dev)
        ir_ = torch.from_numpy(rng.integers(0, 16, size=(R_, lanes)) == 0).to(dev)
        kernel_row(name, "pmadd_signed_kernel", G1_SRC,
                   "tpu_bls12_381/curves/pallas_g1.py:430", [R_, 24, lanes],
                   lambda: cuda_g1.pmadd_signed_rows(xr_, yr_, sr_, ir_),
                   lambda: cuda_g1.pmadd_signed_rows_plain(xr_, yr_, sr_, ir_),
                   R_ * lanes * 5 * 24, R_ * lanes * 2,
                   R_ * lanes * 11 * mul_mads(W_FQ), 3, n_launches=n_launches,
                   path=path, **extra)

    scan_row_g1("pmadd_signed", "msm_2e20: msm_g1", R, L, launches["pmadd_signed"])
    G2_SRC = "tpu_bls12_381_torch/csrc/"

    def scan_row_g2(name, path, R_, L_, n_launches):
        At_ = tiled_affine_g2(R_ * L_)
        tile_ = torch.cat([At_[0].reshape(48, -1), At_[1].reshape(48, -1)], dim=0
                          ).reshape(96, R_, L_).permute(1, 0, 2).contiguous()
        del At_
        xr_ = tile_[:, :48].unflatten(1, (24, 2))
        yr_ = tile_[:, 48:].unflatten(1, (24, 2))
        sr_ = torch.from_numpy(rng.integers(0, 2, size=(R_, L_)).astype(bool)).to(dev)
        ir_ = torch.from_numpy(rng.integers(0, 16, size=(R_, L_)) == 0).to(dev)
        kernel_row(name, "pmadd2_kernel", G2_SRC + "g2_pmadd.cu",
                   "tpu_bls12_381/curves/pallas_g2.py:179", [R_, 24, 2, L_],
                   lambda: cuda_g2.pmadd2_rows(xr_, yr_, sr_, ir_),
                   lambda: cuda_g2.pmadd2_rows_plain(xr_, yr_, sr_, ir_),
                   R_ * L_ * 5 * 48, R_ * L_ * 2, R_ * L_ * 33 * mul_mads(W_FQ), 3,
                   n_launches=n_launches, path=path)

    def proj_points(shape, curve="g1"):
        """Projective points with Z != 1 on the lanes of ``shape`` (G1, or G2
        for ``curve="g2"``)."""
        lanes = int(np.prod(shape))
        F_, elem, tiled = ((FQ2_PLAIN, (24, 2), tiled_affine_g2) if curve == "g2"
                           else (FQ_PLAIN, (24,), tiled_affine))
        P_ = pj.proj_double(F_, pj.affine_to_proj(F_, tiled(lanes)))
        return tuple(c.reshape(elem + tuple(shape)).contiguous() for c in P_)

    # The lane scan of each curve: (wrapper, plain, source, the add it
    # replaces, limbs a point, Fq products an add).
    SCANS = {"g1": (cuda_g1.padd_scan, cuda_g1.padd_scan_plain, G1_SRC,
                    "tpu_bls12_381/curves/pallas_g1.py:465", 24, 12),
             "g2": (cuda_g2.padd2_scan, cuda_g2.padd2_scan_plain,
                    "tpu_bls12_381_torch/csrc/g2_padd_scan.cu",
                    "tpu_bls12_381/curves/pallas_g2.py:201", 48, 36)}

    def scan_row(name, path, shape, n_launches, curve="g1", **mode):
        """The lane scan at one of the tail's shapes; its bound counts the
        L - 1 adds a row that any scan needs."""
        scan_, plain_, src_, replaces_, limbs_, prods_ = SCANS[curve]
        P_ = proj_points(shape, curve)
        rows_, L_ = int(np.prod(shape[:-1])), shape[-1]
        total_ = mode.get("total", False)
        add_ = "padd2" if curve == "g2" else "padd"
        kernel_row(name, "padd_scan_", src_, replaces_,
                   [*P_[0].shape[:-len(shape)], *shape], lambda: scan_(P_, **mode),
                   lambda: plain_(P_, **mode),
                   3 * limbs_ * (rows_ * L_ + (rows_ if total_ else rows_ * L_)), 0,
                   rows_ * (L_ - 1) * prods_ * mul_mads(W_FQ), 5, n_launches=n_launches,
                   path=path, kernels_per_call=2 if total_ else 3, mode=mode,
                   note=f"replaces the log2(L) Hillis-Steele {add_} steps of the "
                        "JAX package's lane scans")

    scan_kw = {cuda_g1.scan_mode(**kw): kw
               for kw in [dict(total=True)] + [dict(reverse=r, exclusive=e)
                                               for r in (False, True) for e in (False, True)]}

    def scan_rows(tag, path, by_shape, n_total, curve="g1"):
        """One ``padd_scan[tag: mode shape]`` (G2: ``padd2_scan[...]``) row
        for each mode and shape at which the driven path called the scan,
        with the launches counted at it in that path's run
        (``cuda_g1.SCAN_LAUNCHES``, ``cuda_g2.SCAN_LAUNCHES``); together they
        are all of the path's scan launches.  On the single shot: the stitch
        (prefix exclusive, L lanes), the triangle's column and row totals
        (Lb x Rb, Rb x Lb), its weighted suffix scan and that scan's total
        (2 x Lb)."""
        kernel_ = "padd2_scan" if curve == "g2" else "padd_scan"
        if sum(by_shape.values()) != n_total:
            raise AssertionError(f"{path}: {kernel_} launches by shape {by_shape} "
                                 f"do not sum to the {n_total} counted")
        for (mode_name, shape_), n_ in sorted(by_shape.items()):
            dims = list(shape_[2 if curve == "g2" else 1:])
            scan_row(f"{kernel_}[{tag}: {mode_name} {'x'.join(map(str, dims))}]",
                     path, dims, n_, curve, **scan_kw[mode_name])

    scan_rows("single", "msm_2e20: msm_g1", scans, launches["padd_scan"])

    # The tile sweep: one window's 2^21 signed adds as (R, L) tiles of
    # 128 x 2^14, 64 x 2^15 and 32 x 2^16 (each held to the plain rows on its
    # first 2 rows), with the stitch's lane scan at each L; then padd at 2^15
    # and 2^16 lanes.  Kernel times from the trace.
    sweep = []
    adds = 1 << 21
    At_ = tiled_affine(adds)
    tile_all = torch.cat([At_[0], At_[1]], dim=0)
    del At_
    sign_all = torch.from_numpy(rng.integers(0, 2, size=adds).astype(bool)).to(dev)
    inf_all = torch.from_numpy(rng.integers(0, 16, size=adds) == 0).to(dev)
    for log_l in (14, 15, 16):
        Ls = 1 << log_l
        Rs = adds // Ls
        ts = tile_all.reshape(48, Rs, Ls).permute(1, 0, 2).contiguous()
        xs_, ys_ = ts[:, :24], ts[:, 24:]
        ss_, is_ = sign_all.reshape(Rs, Ls), inf_all.reshape(Rs, Ls)
        rows_ = cuda_g1.pmadd_signed_rows(xs_, ys_, ss_, is_)
        head = cuda_g1.pmadd_signed_rows_plain(xs_[:2], ys_[:2], ss_[:2], is_[:2])
        if not trees_equal(tuple(c[:2] for c in rows_), head):
            raise AssertionError(f"pmadd_signed at {Rs} x {Ls}: kernel and plain differ")
        t_ = measure(lambda: cuda_g1.pmadd_signed_rows(xs_, ys_, ss_, is_),
                     "pmadd_signed_kernel", 3)
        sweep.append({"kernel": "pmadd_signed", "tile": [Rs, Ls], "ms": t_["ms"],
                      "ms_from": t_["ms_from"]})
        col = tuple(c[-1].contiguous() for c in rows_)
        t_ = measure(lambda: cuda_g1.padd_scan(col, exclusive=True), "padd_scan_", 5)
        sweep.append({"kernel": "padd_scan", "shape": [24, Ls], "what": "the stitch",
                      "ms": t_["ms"] * (3 if t_["ms_from"] == "profiler" else 1),
                      "ms_from": t_["ms_from"]})
        del ts, xs_, ys_, rows_, head, col
    del tile_all, sign_all, inf_all
    for lanes_ in (1 << 15, 1 << 16):
        Pw, Qw = proj_points([lanes_]), contig(pj.affine_to_proj(FQ_PLAIN, tiled_affine(lanes_)))
        if not trees_equal(cuda_g1.padd(Pw, Qw), cuda_g1.padd_plain(Pw, Qw)):
            raise AssertionError(f"padd at {lanes_} lanes: kernel and plain differ")
        t_ = measure(lambda: cuda_g1.padd(Pw, Qw), "padd_kernel", 20)
        sweep.append({"kernel": "padd", "shape": [24, lanes_], "ms": t_["ms"],
                      "ms_from": t_["ms_from"]})
    emit({"phase": "tile_sweep", "adds": adds, "rows": sweep, "card": smi})
    torch.cuda.empty_cache()

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
               9 * 24 * nl, 0, nl * 12 * mul_mads(W_FQ), 20,
               path="msm_2e20: msm_g1")
    # pdbl on one lane, as the triangle combine (lb_bits doublings, a chain a
    # window) and the Horner ladder (w doublings, a chain a step) call it;
    # each row's launches are the single shot's launches of that many
    # doublings (check_tail asserted that they are all of its pdbl launches).
    P1 = tuple(c[:, 7].contiguous() for c in Pl)
    if geo["lb_bits"] == geo["w"]:
        raise AssertionError("msm_2e20: the triangle's and Horner's chains are of one "
                             "length, their launches cannot be told apart")
    for tag, times in (("triangle", geo["lb_bits"]), ("horner", geo["w"])):
        kernel_row(f"pdbl[{tag}]", "pdbl_kernel", G1_SRC,
                   "tpu_bls12_381/curves/pallas_g1.py:478",
                   [24, 1], lambda: cuda_g1.pdbl(P1, times),
                   lambda: cuda_g1.pdbl_plain(P1, times),
                   6 * 24, 0, times * dbl_mads, 50, n_launches=chains.get(times, 0),
                   path="msm_2e20: msm_g1", times=times,
                   equal_at_2e16=chain_equal(times))

    del Al, Pl, Ql, P1, z1
    torch.cuda.empty_cache()
    if args.upto == "msm_2e20":
        return stop_early()

    # ------------------------------------------------- the G2 lane scan's checks
    # The kernels phase's operands for the G2 lane scan, held here once its
    # source has compiled (the build's longest; the G1 phases ran meanwhile).
    t0 = time.perf_counter()
    _build.build([LATE])
    late_wait_s = time.perf_counter() - t0
    registers.update(ptxas_lines(_build.build_log(LATE)))
    emit({"phase": "build", "source": LATE,
          "seconds": round(_build.BUILD_SECONDS.get(LATE, 0.0), 1),
          "seconds_waited_after_the_g1_phases": round(late_wait_s, 2),
          "ptxas": ptxas_lines(_build.build_log(LATE))})
    for operand, what in ((Ps2, f"{n_odd2}"), (Po2, "3 x 1001")):
        for mode in modes:
            if not trees_equal(cuda_g2.padd2_scan(operand, **mode),
                               cuda_g2.padd2_scan_plain(operand, **mode)):
                raise AssertionError(f"padd2_scan {what} {mode}: kernel and plain differ")
    pair2 = tuple(c[..., 8:10].contiguous() for c in Ps2)
    if not bool(FQ2_PLAIN.is_zero(cuda_g2.padd2_scan(pair2, total=True)[2]).all()):
        raise AssertionError("padd2_scan: P + (-P) is not the identity")
    check("padd2_scan", "padd_scan_", n_odd2, cuda_g2.padd2_scan(Ps2, exclusive=True),
          cuda_g2.padd2_scan_plain(Ps2, exclusive=True),
          lambda: cuda_g2.padd2_scan(Ps2, exclusive=True),
          lambda: cuda_g2.padd2_scan_plain(Ps2, exclusive=True),
          lambda: cuda_g2.LAUNCHES["padd2_scan"], reps=3)
    del Ps2, Po2, pair2

    def g1_ints(P):
        return g1.jacobian_to_ints(P)[0]

    def g2_ints(P):
        return g2.jacobian_to_ints(tuple(c[..., None] for c in P))[0]

    # The golden G2 vector (n = 1024), for this phase and msm_ctx_small.
    with open(ROOT / "tests" / "vectors" / "msm_g2_vectors.json") as f:
        case2 = json.load(f)["cases"][0]
    hx = lambda v: int(v, 16)
    pts2 = [((hx(p["x"][0]), hx(p["x"][1])), (hx(p["y"][0]), hx(p["y"][1])))
            for p in case2["points"]]
    expected2 = ((hx(case2["expected"]["x"][0]), hx(case2["expected"]["x"][1])),
                 (hx(case2["expected"]["y"][0]), hx(case2["expected"]["y"][1])))
    Av2 = g2.affine_from_ints(pts2, device=dev)
    sv2 = torch.from_numpy(ints_to_limbs(
        [FR.to_mont(hx(v)) for v in case2["scalars"]], FR.num_limbs
    ).astype(np.int32)).to(dev)

    # ----------------------------------------------------------- msm_traceable
    # msm_traceable: the MSM as one call whose shapes all follow from the
    # inputs' (no GLV, no budget, no pieces), captured in a CUDA graph.  G1 on
    # msm_2e20's 2^20 points and scalars, G2 on 2^16 of msm_g2_2e20's tiled
    # points: the eager call against the host's point and, limb for limb,
    # against msm_g1 with GLV off (msm_g2); its launches against the plan;
    # one call captured after a warm call on a side stream, replayed
    # (torch.equal to the eager call), then replayed on a second draw of
    # scalars copied into the captured input (the eager call's limbs and the
    # host's point for them); the golden vectors (G1 n = 4096, G2 n = 1024)
    # eager and replayed.  Then eager against replay in turns, medians of 3
    # by CUDA events each (G1 beside msm_g1 with GLV off and on).  A capture
    # or a launch that fails fails the run: there is no eager fallback.
    from tpu_bls12_381_torch.msm import msm_traceable
    from tpu_bls12_381_torch.msm.pippenger import window_bits_for

    def capture(fn):
        """``fn()`` captured in a CUDA graph after one warm call on a side
        stream: (graph, its output, seconds of the capture, the peak bytes
        its pool held during it, the bytes the pool reserved)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        graph = torch.cuda.CUDAGraph()
        t0_ = time.perf_counter()
        with torch.cuda.graph(graph):
            out_ = fn()
        torch.cuda.synchronize()
        return (graph, out_, time.perf_counter() - t0_,
                torch.cuda.max_memory_allocated() - base,
                torch.cuda.memory_reserved() - reserved)

    def replayed(graph, out_):
        graph.replay()
        torch.cuda.synchronize()
        return tuple(c.clone() for c in out_)

    def in_turns(order, calls):
        """Each name of ``order`` in turn, a median of 3 calls by CUDA events:
        name -> the medians in the order taken."""
        got = {}
        for name_ in order:
            got.setdefault(name_, []).append(
                statistics.median(time_ms(calls[name_], 1, warm=False) for _ in range(3)))
        return got

    def traceable_case(what, F_, s_, A_, want, ints, plan, kernel, on_path_, same_as):
        """The eager call counted, held to the host's point (``want``) and
        limb for limb to ``same_as()`` (the same MSM through msm_g1 / msm_g2
        with GLV off); its launches against ``plan``; then captured and
        replayed, torch.equal to the eager call.  Returns the eager result,
        its launches, the graph, the captured input and output, and the
        capture's figures."""
        reset_counts()
        with guarded("msm_traceable"):
            P_ = msm_traceable(F_, s_, A_)
            torch.cuda.synchronize()
        launches_ = counts()
        chains_ = chain_counts(cuda_g2 if kernel == "pdbl2" else cuda_g1)
        scans_ = scan_counts(cuda_g2 if kernel == "pdbl2" else cuda_g1)
        columns_ = dict(cuda_ops.COLUMN_LAUNCHES)
        with guarded("msm_traceable"):
            same_ = trees_equal(P_, same_as())
        ok_ = ints(P_) == want
        scan_k = "pmadd2" if kernel == "pdbl2" else "pmadd_signed"
        if not (ok_ and same_):
            raise AssertionError(f"msm_traceable {what}: the host's point {ok_}, limbs "
                                 f"equal to the GLV-off MSM {same_}")
        missing_ = [k for k in on_path_ if launches_[k] < 1]
        if missing_:
            raise AssertionError(f"msm_traceable {what}: kernels never launched: {missing_}")
        if launches_[scan_k] != plan["T"] or plan["pieces"] != 1 or plan["glv"]:
            raise AssertionError(f"msm_traceable {what}: {launches_[scan_k]} scan launches, "
                                 f"the plan has {plan['T']} windows in one piece")
        check_tail(f"msm_traceable {what}", launches_, plan, chains_, kernel=kernel)
        s_in = s_.clone()
        with guarded("msm_traceable"):
            graph, out_, cap_s, pool_peak, pool_reserved = capture(
                lambda: msm_traceable(F_, s_in, A_))
        rep_ = replayed(graph, out_)
        if not trees_equal(rep_, P_):
            raise AssertionError(f"msm_traceable {what}: the replay differs from the eager call")
        return dict(P=P_, launches={k: v for k, v in launches_.items() if v},
                    scans=scans_, columns=columns_, graph=graph, s_in=s_in, out=out_,
                    capture_seconds=cap_s, pool_peak_bytes=pool_peak,
                    pool_reserved_bytes=pool_reserved)

    # G1: msm_2e20's points and scalars
    w_t = window_bits_for(n, FQ_ADAPTER, dev)
    plan_t = msm_geometry(n, False, FQ_ADAPTER, dev, w_t)   # the counts to hold it to
    t1 = traceable_case("G1 2^20", FQ_ADAPTER, s_mont, A, expected, g1_ints,
                        plan_t, "pdbl", ["mont_mul_fr", "mont_mul_fq", "mont_sqr_fq",
                                         "pmadd_signed", "padd", "pdbl", "padd_scan",
                                         "neg_fq"],
                        lambda: msm_g1(s_mont, A, glv=False))
    # a second draw of scalars copied into the captured input
    words_b, _, s_mont_b = draw_scalars(n)
    expected_b = oracle.jac_to_affine(
        oracle.scalar_mul(host_scalar_total(ks, words_b), G, oracle.FQ_OPS), oracle.FQ_OPS)
    t1["s_in"].copy_(s_mont_b)
    rep_b = replayed(t1["graph"], t1["out"])
    with guarded("msm_traceable"):
        eager_b = msm_traceable(FQ_ADAPTER, s_mont_b, A)
    new_ok = trees_equal(rep_b, eager_b) and g1_ints(rep_b) == expected_b
    if not new_ok:
        raise AssertionError("msm_traceable G1 2^20: the replay on new scalars differs from "
                             "the eager call or from the host's point")
    del rep_b, eager_b, s_mont_b
    # msm_geometry alone: the host work of msm_g1 that msm_traceable skips
    g1_calls = {"eager": lambda: msm_traceable(FQ_ADAPTER, t1["s_in"], A),
                "replay": t1["graph"].replay,
                "msm_g1 glv=False": lambda: msm_g1(t1["s_in"], A, glv=False),
                "msm_g1 glv=True": lambda: msm_g1(t1["s_in"], A, glv=True),
                "msm_geometry": lambda: msm_geometry(n, False, FQ_ADAPTER, dev, w_t)}
    with guarded("msm_traceable"):
        turns1 = in_turns(["eager", "replay", "msm_geometry", "msm_g1 glv=False",
                           "msm_g1 glv=True", "msm_g1 glv=True", "msm_g1 glv=False",
                           "msm_geometry", "replay", "eager"], g1_calls)
    # the golden G1 vector, n = 4096 (msm_small's), eager and replayed
    expected_v = (int(case["expected"]["x"], 16), int(case["expected"]["y"], 16))
    with guarded("msm_traceable"):
        golden1 = msm_traceable(FQ_ADAPTER, sv, Av)
        gg, gout, _, _, _ = capture(lambda: msm_traceable(FQ_ADAPTER, sv, Av))
    golden1_ok = {"eager": g1_ints(golden1) == expected_v,
                  "replay": g1_ints(replayed(gg, gout)) == expected_v}
    del gg, gout, golden1

    # G2: 2^16 of the tiled G2 points, the first 2^16 scalars
    n_t2 = 1 << 16
    A_t2 = tiled_affine_g2(n_t2)
    s_t2 = s_mont[:, :n_t2].contiguous()
    expected_t2 = oracle.jac_to_affine(
        oracle.scalar_mul(host_scalar_total(ks2, words[:, :n_t2]), G2gen, oracle.FQ2_OPS),
        oracle.FQ2_OPS)
    plan_t2 = msm_geometry(n_t2, False, FQ2_ADAPTER, dev, window_bits_for(n_t2, FQ2_ADAPTER, dev))
    t2 = traceable_case("G2 2^16", FQ2_ADAPTER, s_t2, A_t2, expected_t2, g2_ints, plan_t2,
                        "pdbl2", ["mont_mul_fr", "pmadd2", "padd2", "padd2_scan", "pdbl2"],
                        lambda: msm_g2(s_t2, A_t2))
    with guarded("msm_traceable"):
        turns2 = in_turns(["eager", "replay", "replay", "eager"],
                          {"eager": lambda: msm_traceable(FQ2_ADAPTER, t2["s_in"], A_t2),
                           "replay": t2["graph"].replay})
        golden2 = msm_traceable(FQ2_ADAPTER, sv2, Av2)
        gg, gout, _, _, _ = capture(lambda: msm_traceable(FQ2_ADAPTER, sv2, Av2))
    golden2_ok = {"eager": g2_ints(golden2) == expected2,
                  "replay": g2_ints(replayed(gg, gout)) == expected2}
    del gg, gout, golden2
    med = lambda v: statistics.median(v)
    figures = {}
    for tag, t_, plan_, turns_ in (("g1_2e20", t1, plan_t, turns1),
                                   ("g2_2e16", t2, plan_t2, turns2)):
        figures[tag] = {
            **{k: plan_[k] for k in ("w", "T", "R", "L", "nb", "tail_launches",
                                     "doubling_chains")},
            "ms_in_turns": turns_, "ms_median": {k: med(v) for k, v in turns_.items()},
            "replay_over_eager": med(turns_["replay"]) / med(turns_["eager"]),
            "launches_per_eager_call": t_["launches"],
            "kernel_launches_per_eager_call": sum(
                v for k, v in t_["launches"].items()
                if not k.startswith(("mont_mul_col", "pdbl_doublings", "pdbl2_doublings"))),
            "capture_seconds": t_["capture_seconds"],
            "graph_pool_peak_bytes": t_["pool_peak_bytes"],
            "graph_pool_reserved_bytes": t_["pool_reserved_bytes"]}
    figures["g1_2e20"]["replay_on_new_scalars_equal"] = new_ok
    emit({"phase": "msm_traceable", **figures,
          "golden_g1_4096": golden1_ok, "golden_g2_1024": golden2_ok, "card": smi})
    if not all(golden1_ok.values()) or not all(golden2_ok.values()):
        raise AssertionError(f"msm_traceable: the golden vectors, G1 {golden1_ok}, "
                             f"G2 {golden2_ok}")

    # Rows for the kernel shapes this path gives that no row has: the GLV-off
    # scan tiles and, for G2 at 2^16, the stitch and from_mont's width.  The
    # tails' other shapes follow from L, nb, lb_bits and w, which are those of
    # msm_2e20's and msm_g2_2e20's plans (but G2's L; checked here), so those
    # paths' rows hold them.
    plan_g2_full = msm_geometry(n, F=FQ2_ADAPTER, device=dev)
    for tag, plan_, full, keys_ in (("G1", plan_t, geo, ("L", "nb", "lb_bits", "w")),
                                    ("G2", plan_t2, plan_g2_full, ("nb", "lb_bits", "w"))):
        differ = {k: (plan_[k], full[k]) for k in keys_ if plan_[k] != full[k]}
        if differ:
            raise AssertionError(f"msm_traceable {tag}: the tail's shapes are not the 2^20 "
                                 f"path's ({differ}): they need rows of their own")
    path_t1 = "msm_traceable: msm_traceable(FQ_ADAPTER) on 2^20 points, GLV off"
    path_t2 = "msm_traceable: msm_traceable(FQ2_ADAPTER) on 2^16 points"
    scan_row_g1("pmadd_signed[traceable]", path_t1, plan_t["R"], plan_t["L"],
                t1["launches"]["pmadd_signed"])
    scan_row_g2("pmadd2[traceable]", path_t2, plan_t2["R"], plan_t2["L"],
                t2["launches"]["pmadd2"])
    stitch_t2 = {k: v for k, v in t2["scans"].items() if k[1][-1] == plan_t2["L"]}
    scan_rows("traceable", path_t2, stitch_t2, sum(stitch_t2.values()), "g2")
    a_t2 = rand_field(FR, n_t2)
    one_t2 = ops.constant_column(FR, int_to_limbs(1, 16), dev)
    kernel_row("mont_mul_fr[from_mont traceable g2]", "mont_mul_kernel", FIELD_SRC, MUL_TPU,
               [16, n_t2], lambda: cuda_ops.mont_mul(FR, a_t2, one_t2),
               lambda: cuda_ops.mont_mul_plain(FR, a_t2, one_t2),
               2 * 16 * n_t2 + 16, 0, n_t2 * mul_mads(W_FR), 10,
               n_launches=t2["columns"].get(("mont_mul_fr", n_t2), 0),
               path=path_t2 + " (fast.from_mont)", column=[16, 1])
    emit({"phase": "msm_traceable", "what": "rows", "covered": (
        "the G1 tail's shapes are msm_2e20's rows' (L, nb, lb_bits, w equal), the G2 tail's "
        "but the stitch msm_g2_2e20's (nb, lb_bits, w equal)")})
    del t1, t2, A_t2, s_t2, a_t2
    torch.cuda.empty_cache()
    if args.upto == "msm_traceable":
        return stop_early()

    # ----------------------------------------------------------- msm_ctx_small
    # The cached-bases path at small sizes, every variant against the golden
    # vectors or against its one-shot result.
    def ctx_case(what, ok, **extra):
        emit({"phase": "msm_ctx_small", "what": what, "equal": bool(ok), **extra})
        if not ok:
            raise AssertionError(f"msm_ctx_small: {what}: wrong result")

    ctx1, ctx2 = g1_context(), g2_context()
    reset_counts()
    ctx_case("msm_g2 golden n=1024", g2_ints(msm_g2(sv2, Av2)) == expected2)
    bases2 = ctx2.upload_bases(Av2, precompute_factor=2)
    ctx_case("g2_context factor=2 golden n=1024",
             g2_ints(ctx2.msm_with_bases(sv2, bases2)) == expected2,
             glv=bases2.glv, w=bases2.window_bits, launches=dict(cuda_g2.LAUNCHES))
    del bases2, Av2, sv2

    for factor in (1, 2):
        for use_glv in (False, True):
            bases = ctx1.upload_bases(Av, precompute_factor=factor, glv=use_glv)
            ctx_case(f"g1_context factor={factor} glv={use_glv} golden n=4096",
                     g1_ints(ctx1.msm_with_bases(sv, bases)) == expected_v,
                     w=bases.window_bits, points=int(bases.A[2].shape[-1]))
    # `bases` is now factor 2 with GLV: the batch and the chunk paths run on it
    sets = [sv, sv.roll(1, dims=-1).contiguous(), sv.roll(17, dims=-1).contiguous()]
    singles = [g1_ints(ctx1.msm_with_bases(s_, bases)) for s_ in sets]
    batch3 = [g1_ints(P_) for P_ in ctx1.msm_batch(sets, bases)]
    ctx_case("msm_batch of 3 equals 3 single calls", batch3 == singles
             and singles[0] == expected_v)
    F1 = FQ_ADAPTER
    n_v = 4096

    def chunked(what, mb, fn, want, **plan_kw):
        """Run ``fn`` under a budget of ``mb`` MiB; its scan launches must be
        the plan's, and the plan must split where ``what`` says."""
        set_budget_mb(mb)
        try:
            plan = msm_geometry(n_v, device=dev, **plan_kw)
            reset_counts()
            out = fn()
            scans = cuda_g1.LAUNCHES["pmadd_signed"]
        finally:
            set_budget_mb(None)
        split = plan["groups"] > 1 if "members" in what else plan["pieces"] > 1
        ctx_case(what, out == want and split and scans == plan["scan_launches"],
                 budget_mb=mb, pieces=plan["pieces"], groups=plan["groups"],
                 scan_launches=scans, planned=plan["scan_launches"])

    cached = dict(glv=bases.glv, F=F1, window_bits=bases.window_bits,
                  factor=bases.factor, cached=True)
    chunked("single MSM in pieces", 1, lambda: g1_ints(msm_g1(sv, Av, glv=False)),
            expected_v, glv=False)
    chunked("single MSM with GLV in pieces", 2, lambda: g1_ints(msm_g1(sv, Av, glv=True)),
            expected_v, glv=True)
    chunked("precomputed MSM in pieces", 4,
            lambda: g1_ints(ctx1.msm_with_bases(sv, bases)), expected_v, **cached)
    chunked("batch in groups of members", 16,
            lambda: [g1_ints(P_) for P_ in ctx1.msm_batch(sets, bases)], singles,
            batch=3, **cached)
    chunked("batch in pieces of points", 8,
            lambda: [g1_ints(P_) for P_ in ctx1.msm_batch(sets, bases)], singles,
            batch=3, **cached)
    del bases

    # scalar_mul_glv: 4,096 lanes, a few of them against the host; the whole
    # joint ladder is one glv_ladder launch (no pdbl or pmadd a bit).
    k_std = fast.from_mont(FR, sv)
    reset_counts()
    t0 = time.perf_counter()
    Pk = glv_mod.scalar_mul_glv(k_std, Av)
    torch.cuda.synchronize()
    glv_s = time.perf_counter() - t0
    launches_glv = counts()
    lanes = [0, 1, 2, 3, 2047, 4095]
    got_k = g1.jacobian_to_ints(tuple(c[:, lanes] for c in Pk))
    want_k = [oracle.jac_to_affine(oracle.scalar_mul(vals[i], pts[i], oracle.FQ_OPS),
                                   oracle.FQ_OPS) if vals[i] else None for i in lanes]
    ctx_case("scalar_mul_glv on 4096 lanes", got_k == want_k
             and launches_glv["glv_ladder"] == 1
             and launches_glv["pmadd"] == 0 and launches_glv["pdbl"] == 0,
             seconds=glv_s, glv_ladder_launches=launches_glv["glv_ladder"],
             pmadd_launches=launches_glv["pmadd"], pdbl_launches=launches_glv["pdbl"])
    del Pk
    if args.upto == "msm_ctx_small":
        return stop_early()

    # ------------------------------------------------------------ msm_ctx_2e20
    # The path a prover calls: bases uploaded once, expanded by factor 2 and
    # GLV-extended as `auto` decides, then every MSM against them.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with guarded("msm_ctx_2e20"):
        bases = ctx1.upload_bases(A, precompute_factor=2)
        torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    launches_up = counts()
    geo_c = msm_geometry(n, bases.glv, F1, dev, bases.window_bits,
                         factor=bases.factor, cached=True)
    expand_cap = 1 << int(os.environ.get("MIDNIGHT_EXPAND_CHUNK_LOG", "20"))
    m_up = int(bases.A[2].shape[-1]) // bases.factor   # points of one block
    slices_up = -(-m_up // expand_cap)
    span_up = geo_c["T"] * geo_c["w"]                  # doublings between blocks
    check_upload("msm_ctx_2e20: upload_bases", launches_up, slices_up, bases.factor, span_up)
    t0 = time.perf_counter()
    with guarded("msm_ctx_2e20"):
        ctx1.msm_with_bases(s_mont, bases)          # warm call
        first_c = time.perf_counter() - t0
        reset_counts()
        Pc = ctx1.msm_with_bases(s_mont, bases)     # the main path
        launches_ctx = counts()
        scans_ctx = scan_counts()
        chains_ctx = chain_counts()
        secs_c = [tracing.timed_reps(1, lambda: ctx1.msm_with_bases(s_mont, bases))
                  for _ in range(3)]
        with tracing.collect_stages() as stages_c:
            ctx1.msm_with_bases(s_mont, bases)
    got_c = g1_ints(Pc)
    med_c = statistics.median(secs_c)
    ok_c = got_c == expected and got_c == got
    if launches_ctx["pmadd_signed"] != geo_c["scan_launches"] or geo_c["pieces"] != 1:
        raise AssertionError(f"msm_ctx_2e20: {launches_ctx['pmadd_signed']} scan "
                             f"launches, the plan has {geo_c}")

    # A batch of 4 scalar sets against the same bases, and the 4 single calls.
    sets4 = [s_mont] + [s_mont.roll(sh, dims=-1).contiguous() for sh in (1, 4097, 70001)]
    t0 = time.perf_counter()
    with guarded("msm_ctx_2e20"):
        singles4 = [ctx1.msm_with_bases(s_, bases) for s_ in sets4]
        torch.cuda.synchronize()
    singles4_s = time.perf_counter() - t0
    singles4 = [g1_ints(P_) for P_ in singles4]
    geo_b = msm_geometry(n, bases.glv, F1, dev, bases.window_bits,
                         factor=bases.factor, batch=4, cached=True)
    with guarded("msm_ctx_2e20"):
        ctx1.msm_batch(sets4, bases)                # warm call
        reset_counts()
        t0 = time.perf_counter()
        batch4 = ctx1.msm_batch(sets4, bases)
        torch.cuda.synchronize()
    batch4_s = time.perf_counter() - t0
    launches_b4 = counts()
    scans_b4 = scan_counts()
    chains_b4 = chain_counts()
    ok_b = [g1_ints(P_) for P_ in batch4] == singles4 and singles4[0] == expected
    # the batch's 4 results converted together (4 lanes): set 0 against the
    # oracle's point, the others against their single calls
    conv4 = to_affine_case("msm_ctx_2e20: the batch of 4's results", ctx1,
                           tuple(torch.stack([P_[c] for P_ in batch4], dim=-1)
                                 for c in range(3)), singles4, g1, "g1")
    del batch4, sets4

    # One MSM under a budget that forces 4 pieces.
    need = geo_c["n"] * geo_c["bytes_per_point"]
    mb4 = -(-need // (4 << 20))
    set_budget_mb(mb4)
    try:
        geo_4 = msm_geometry(n, bases.glv, F1, dev, bases.window_bits,
                             factor=bases.factor, cached=True)
        reset_counts()
        t0 = time.perf_counter()
        with guarded("msm_ctx_2e20"):
            P4 = ctx1.msm_with_bases(s_mont, bases)
            torch.cuda.synchronize()
        pieces4_s = time.perf_counter() - t0
        launches_p4 = counts()
        scans_p4 = scan_counts()
        chains_p4 = chain_counts()
    finally:
        set_budget_mb(None)
    ok_4 = (g1_ints(P4) == expected and geo_4["pieces"] == 4
            and launches_p4["pmadd_signed"] == geo_4["scan_launches"])
    peak_c = torch.cuda.max_memory_allocated()
    emit({"phase": "msm_ctx_2e20", "n": n, "equal": bool(ok_c and ok_b and ok_4),
          "with_bases_equals_single_shot_and_host": ok_c,
          "batch4_equals_4_calls": ok_b, "four_pieces_equals_one_shot": ok_4,
          "g1_msm_cached_2e20_points_per_s": n / med_c,
          "seconds_median_of_3": med_c, "seconds_each": secs_c,
          "seconds_first_call": first_c, "seconds_upload": upload_s,
          "seconds_batch4": batch4_s, "batch4_points_per_s": 4 * n / batch4_s,
          "seconds_4_single_calls": singles4_s, "seconds_4_pieces": pieces4_s,
          "budget_mb_4_pieces": mb4,
          "pipeline_points": geo_c["n"],
          **{k: geo_c[k] for k in ("glv", "factor", "w", "T", "L", "R", "nb")},
          "plan_tail_launches": geo_c["tail_launches"],
          "plan_batch4": {k: geo_b[k] for k in ("pieces", "groups", "per_group",
                                                "scan_launches", "tail_launches")},
          "plan_4_pieces": {k: geo_4[k] for k in ("pieces", "per", "L", "R",
                                                  "scan_launches", "tail_launches")},
          "launches": launches_ctx, "launches_batch4": launches_b4,
          "launches_4_pieces": launches_p4, "launches_upload": launches_up,
          "upload_slices": slices_up, "upload_span": span_up,
          "peak_bytes_allocated": peak_c,
          "stages_ms": {k: round(v, 3) for k, v in stages_c.items()}, "card": smi})
    if not (ok_c and ok_b and ok_4):
        raise AssertionError("msm_ctx_2e20: a check failed (see the line above)")
    for k in ("mont_mul_fr", "pmadd_signed", "padd", "pdbl", "padd_scan"):
        if launches_ctx[k] < 1:
            raise AssertionError(f"msm_ctx_2e20: {k} never launched on the path")
    check_tail("msm_ctx_2e20", launches_ctx, geo_c, chains_ctx)
    check_tail("msm_ctx_2e20 batch of 4", launches_b4, geo_b, chains_b4)
    check_tail("msm_ctx_2e20 in 4 pieces", launches_p4, geo_4, chains_p4)
    if geo_b["groups"] != 1 or launches_b4["pmadd_signed"] != geo_b["scan_launches"]:
        raise AssertionError(f"msm_ctx_2e20: the batch of 4 made "
                             f"{launches_b4['pmadd_signed']} scan launches, the "
                             f"plan has {geo_b}")
    del bases, Pc, P4, A, singles4
    torch.cuda.empty_cache()

    # ------------------ the G1 kernels at the shapes the cached path gives them
    # The scan tile of one cached MSM, and of the batch of 4 (the batch axis
    # folded into the lanes: B*L columns to the kernel); padd at the
    # boundary's 2*nb lanes; pdbl on the lanes of one expand_bases slice.
    Rc, Lc = geo_c["R"], geo_c["L"]
    scan_row_g1("pmadd_signed[cached]", "msm_ctx_2e20: msm_with_bases", Rc, Lc,
                launches_ctx["pmadd_signed"])
    scan_row_g1("pmadd_signed[batch4]", "msm_ctx_2e20: msm_batch of 4", geo_b["R"],
                geo_b["per_group"] * geo_b["L"], launches_b4["pmadd_signed"],
                batch=geo_b["per_group"])
    scan_row_g1("pmadd_signed[pieces4]", "msm_ctx_2e20: msm_with_bases in 4 pieces",
                geo_4["R"], geo_4["L"], launches_p4["pmadd_signed"])
    torch.cuda.empty_cache()
    scan_rows("cached", "msm_ctx_2e20: msm_with_bases", scans_ctx,
              launches_ctx["padd_scan"])
    scan_rows("batch4", "msm_ctx_2e20: msm_batch of 4", scans_b4, launches_b4["padd_scan"])
    scan_rows("pieces4", "msm_ctx_2e20: msm_with_bases in 4 pieces", scans_p4,
              launches_p4["padd_scan"])
    torch.cuda.empty_cache()
    nlc = 2 * geo_c["nb"]
    Alc = tiled_affine(nlc)
    Plc = contig(pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, Alc)))
    Qlc = contig(pj.affine_to_proj(FQ_PLAIN, roll(Alc, 1)))
    kernel_row("padd[cached]", "padd_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:465", [24, nlc],
               lambda: cuda_g1.padd(Plc, Qlc), lambda: cuda_g1.padd_plain(Plc, Qlc),
               9 * 24 * nlc, 0, nlc * 12 * mul_mads(W_FQ), 20,
               n_launches=launches_ctx["padd"], path="msm_ctx_2e20: msm_with_bases")
    kernel_row("padd[pieces4]", "padd_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:465", [24, nlc],
               lambda: cuda_g1.padd(Plc, Qlc), lambda: cuda_g1.padd_plain(Plc, Qlc),
               9 * 24 * nlc, 0, nlc * 12 * mul_mads(W_FQ), 20,
               n_launches=launches_p4["padd"],
               path="msm_ctx_2e20: msm_with_bases in 4 pieces")
    del Alc, Plc, Qlc
    nup = min(m_up, expand_cap)
    Pup = contig(pj.affine_to_proj(FQ_PLAIN, tiled_affine(nup)))
    kernel_row("pdbl[upload]", "pdbl_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:478", [24, nup],
               lambda: cuda_g1.pdbl(Pup, span_up), lambda: cuda_g1.pdbl_plain(Pup, span_up),
               6 * 24 * nup, 0, nup * span_up * dbl_mads, 3,
               n_launches=launches_up["pdbl"], path="msm_ctx_2e20: upload_bases",
               times=span_up, equal_at_2e16=chain_equal(span_up))
    del Pup
    # the upload's inversion: the Z coordinates of one slice's block
    xu = rand_field(FQ, nup)
    binv_row("batch_inverse[upload]", FQ, xu, launches_up["batch_inverse_fq"],
             "msm_ctx_2e20: upload_bases")
    # the upload's affine products, on two Fq planes
    yu = rand_field(FQ, nup).flip(1).contiguous()
    kernel_row("mont_mul_fq", "mont_mul_kernel", FIELD_SRC, MUL_TPU,
               [24, nup], lambda: cuda_ops.mont_mul(FQ, xu, yu),
               lambda: cuda_ops.mont_mul_plain(FQ, xu, yu),
               3 * 24 * nup, 0, nup * mul_mads(W_FQ), 10,
               n_launches=launches_up["mont_mul_fq"] - launches_up["mont_mul_col_fq"],
               path="msm_ctx_2e20: upload_bases (the affine products)")
    del xu, yu
    z4 = rand_field(FQ, 4)
    kernel_row("field_inv_fq[to_affine batch4]", "field_inv_kernel", FIELD_SRC, INV_TPU,
               [24, 4], lambda: cuda_ops.field_inv(FQ, z4),
               lambda: cuda_ops.field_inv_plain(FQ, z4),
               2 * 24 * 4, 0, fermat_mads(FQ, 4), 20, n_launches=conv4["field_inv_fq"],
               path="msm_ctx_2e20: MsmContext.to_affine of msm_batch's 4 results "
                    "(0, 1 and p - 1 among the row's lanes)")
    torch.cuda.empty_cache()
    if args.upto == "msm_ctx_2e20":
        return stop_early()

    # ------------------------------------------------------------- msm_g2_2e20
    A2 = tiled_affine_g2(n)
    expected_g2 = oracle.jac_to_affine(
        oracle.scalar_mul(host_scalar_total(ks2), G2gen, oracle.FQ2_OPS),
        oracle.FQ2_OPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    geo2 = msm_geometry(n, F=FQ2_ADAPTER, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    with guarded("msm_g2_2e20"), field_shapes() as shapes_g2:
        Pg2 = msm_g2(s_mont, A2)                    # the main path, first call
        torch.cuda.synchronize()
    first_g2 = time.perf_counter() - t0
    launches_g2 = counts()
    chains_g2 = chain_counts(cuda_g2)
    scans_g2 = scan_counts(cuda_g2)
    peak_g2 = torch.cuda.max_memory_allocated()
    ok_g2 = (g2_ints(Pg2) == expected_g2
             and all(tuple(c.shape) == (24, 2) for c in Pg2))
    with guarded("msm_g2_2e20"):
        secs_g2 = [tracing.timed_reps(1, lambda: msm_g2(s_mont, A2)) for _ in range(3)]
        with tracing.collect_stages() as stages_g2:
            msm_g2(s_mont, A2)
    med_g2 = statistics.median(secs_g2)
    emit({"phase": "msm_g2_2e20", "n": n, "equal": bool(ok_g2),
          "g2_msm_2e20_points_per_s": n / med_g2, "seconds_median_of_3": med_g2,
          "seconds_each": secs_g2, "seconds_first_call": first_g2,
          **{k: geo2[k] for k in ("glv", "w", "T", "L", "R", "nb", "pieces",
                                  "tail_launches")},
          "launches": launches_g2, "pdbl2_launches_by_doublings": chains_g2,
          "doubling_chains": geo2["doubling_chains"], "doublings": geo2["doublings"],
          "peak_bytes_allocated": peak_g2,
          "stages_ms": {k: round(v, 3) for k, v in stages_g2.items()},
          "host_points_seconds": round(host_points2_s, 2), "card": smi})
    if not ok_g2:
        raise AssertionError("msm_g2_2e20: result differs from the host scalar multiplication")
    if launches_g2["pmadd2"] != geo2["T"] or geo2["pieces"] != 1:
        raise AssertionError(f"msm_g2_2e20: {launches_g2['pmadd2']} scan launches, "
                             f"the plan has {geo2['T']} windows")
    for k in ("padd2", "padd2_scan", "pdbl2", "mont_mul_fr"):
        if launches_g2[k] < 1:
            raise AssertionError(f"msm_g2_2e20: {k} never launched on the path")
    check_tail("msm_g2_2e20", launches_g2, geo2, chains_g2, kernel="pdbl2")
    conv2 = to_affine_case("msm_g2_2e20: msm_g2's result", g2_context(),
                           tuple(c[..., None] for c in Pg2), [expected_g2], g2, "g2")
    # the add and sub kernels at the shapes msm_g2 gives them (the Fq and
    # Fq2 formulas of its coordinate conversions), with its launches
    emit({"phase": "msm_g2_2e20", "what": "add and sub calls by form and shape",
          "calls": {f"{k} {list(sh)}": v for (k, sh), v in sorted(shapes_g2.items())}})
    for (key, shape), k_ in sorted(shapes_g2.items()):
        addsub_row(key, shape, k_, f"msm_g2_2e20: msm_g2, {k_} calls at this shape")
    addsub_row("neg_fq", (24, 1), conv2["neg_fq"],
               "to_affine: MsmContext.to_affine of msm_g2's result (c1 of the norm's "
               "inverse times the conjugate)")
    del Pg2

    # The same points as cached bases through g2_context(): factor 2 (no GLV
    # on G2), one warm call and one timed call.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with guarded("msm_g2_2e20"):
        bases2 = ctx2.upload_bases(A2, precompute_factor=2)
        torch.cuda.synchronize()
    upload2_s = time.perf_counter() - t0
    launches_up2 = counts()
    chains_up2 = chain_counts(cuda_g2)
    geo2c = msm_geometry(n, bases2.glv, FQ2_ADAPTER, dev, bases2.window_bits,
                         factor=bases2.factor, cached=True)
    m_up2 = int(bases2.A[2].shape[-1]) // bases2.factor
    slices_up2 = -(-m_up2 // expand_cap)
    span_up2 = geo2c["T"] * geo2c["w"]                # doublings between blocks
    check_upload("msm_g2_2e20: g2_context upload_bases", launches_up2, slices_up2,
                 bases2.factor, span_up2, kernel="pdbl2", sqr_each=1)
    t0 = time.perf_counter()
    with guarded("msm_g2_2e20"):
        ctx2.msm_with_bases(s_mont, bases2)         # warm call
        torch.cuda.synchronize()
        first_g2c = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        Pg2c = ctx2.msm_with_bases(s_mont, bases2)  # the path
        torch.cuda.synchronize()
    call_g2c = time.perf_counter() - t0
    launches_g2c = counts()
    chains_g2c = chain_counts(cuda_g2)
    scans_g2c = scan_counts(cuda_g2)
    peak_g2c = torch.cuda.max_memory_allocated()
    ok_g2c = g2_ints(Pg2c) == expected_g2
    emit({"phase": "msm_g2_2e20", "what": "g2_context factor=2", "n": n,
          "equal": bool(ok_g2c), "seconds_upload": upload2_s,
          "seconds_first_call": first_g2c, "seconds_call": call_g2c,
          "g2_msm_cached_2e20_points_per_s": n / call_g2c,
          "pipeline_points": geo2c["n"],
          **{k: geo2c[k] for k in ("glv", "factor", "w", "T", "L", "R", "nb",
                                   "pieces", "scan_launches", "tail_launches")},
          "launches": launches_g2c, "launches_upload": launches_up2,
          "upload_slices": slices_up2, "upload_span": span_up2,
          "pdbl2_launches_by_doublings": chains_g2c,
          "peak_bytes_allocated": peak_g2c, "card": smi})
    if not ok_g2c:
        raise AssertionError("msm_g2_2e20: the G2 context's result differs from the host's")
    if launches_g2c["pmadd2"] != geo2c["scan_launches"] or geo2c["pieces"] != 1:
        raise AssertionError(f"msm_g2_2e20: the G2 context made {launches_g2c['pmadd2']} "
                             f"scan launches, the plan has {geo2c}")
    check_tail("msm_g2_2e20 g2_context", launches_g2c, geo2c, chains_g2c, kernel="pdbl2")
    del Pg2c, bases2, s_mont

    # ----------------------- the new kernels at the shapes their paths give them
    Ak = tiled_affine(n_v)
    Pk = contig(pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, roll(Ak, 1))))
    # pmadd and pdbl at scalar_mul_glv's shape: no driven path launches them
    # since glv_ladder runs the whole ladder (their rows say 0 launches);
    # glv._glv_steps over FQ_ADAPTER, the routed loop, is their one caller.
    g1_ptxas = lambda kernel: {k: v for k, v in registers.items() if kernel in k}
    no_path_glv = ("msm_ctx_small: scalar_mul_glv's shape (glv_ladder runs the ladder; "
                   "the routed loop glv._glv_steps is its caller, no driven path)")
    kernel_row("pmadd", "pmadd_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:413",
               [24, n_v], lambda: cuda_g1.pmadd(Pk, Ak),
               lambda: cuda_g1.pmadd_plain(Pk, Ak),
               8 * 24 * n_v, n_v, n_v * 11 * mul_mads(W_FQ), 50,
               n_launches=launches_glv["pmadd"], path=no_path_glv,
               ptxas=g1_ptxas("pmadd_kernel"))
    Pk1 = tuple(c.contiguous() for c in pj.affine_to_proj(FQ_PLAIN, Ak))
    kernel_row("pdbl[glv]", "pdbl_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:478", [24, n_v],
               lambda: cuda_g1.pdbl(Pk1), lambda: cuda_g1.pdbl_plain(Pk1),
               6 * 24 * n_v, 0, n_v * dbl_mads, 50,
               n_launches=launches_glv["pdbl"], path=no_path_glv,
               times=1, equal_at_2e16=chain_equal(1))
    del Ak, Pk, Pk1

    # The GLV ladder.  Its bound counts what the constant-time ladder does
    # whatever the bits: num_bits doublings and 2 num_bits mixed adds a lane
    # (128 x (6M + 2S) + 256 x 11M); it moves x, y, beta x, the mask, k1's 16
    # and k2's limbs once and the projective result.
    glv_add_mads = 11 * mul_mads(W_FQ)
    GLV_REPLACES_WITH = ("tpu_bls12_381/curves/pallas_g1.py:413, two launches and a launch "
                         "of _pdbl_kernel (:478) a bit in tpu_bls12_381/curves/glv.py:186")

    def glv_row(name, k1_, k2_, A_, phi_, path, n_launches, plain_fn, reps, **extra):
        lanes, bits = A_[0].shape[-1], glv_mod.GLV_HALF_BITS
        kernel_row(name, "glv_ladder_kernel", G1_SRC,
                   "tpu_bls12_381/curves/pallas_g1.py:413", [24, lanes],
                   lambda: cuda_g1.glv_ladder(k1_, k2_, A_, phi_), plain_fn,
                   (3 * 24 + 3 * 24 + k1_.shape[0] + k2_.shape[0]) * lanes, lanes,
                   lanes * bits * (dbl_mads + 2 * glv_add_mads), reps,
                   n_launches=n_launches, path=path, equal=True,
                   replaces_with=GLV_REPLACES_WITH, num_bits=bits,
                   k2_limbs=int(k2_.shape[0]), ptxas=g1_ptxas("glv_ladder"), **extra)

    # At msm_ctx_small's shape, on its inputs, held to the plain ladder on
    # every lane (some 10 s of plain work, timed once).
    k1_v, k2_v = glv_mod.decompose(k_std)
    phi_v = glv_mod.endomorphism(F1, Av)[0].contiguous()
    Avc = contig(Av)
    glv_row("glv_ladder", k1_v, k2_v, Avc, phi_v, "msm_ctx_small: scalar_mul_glv",
            launches_glv["glv_ladder"],
            lambda: cuda_g1.glv_ladder_plain(k1_v, k2_v, Avc, phi_v), 10)
    del k1_v, k2_v, phi_v, Avc

    # The two ladders on the same 2^20 lanes with per-lane random scalars
    # below r: points.scalar_mul (one jac_ladder launch, 255 bits; with
    # per-lane bits every warp adds at every bit) against scalar_mul_glv (one
    # glv_ladder launch, 128 bits of k1 and k2).  Equal as affine points: the
    # canonical affine limbs of both, every lane, and the host's on a few.
    n20 = 1 << LOG_N
    A20 = tiled_affine(n20)
    limbs20 = rng.integers(0, 1 << 16, size=(16, n20), dtype=np.int64)
    limbs20[15] %= constants.FR_MODULUS >> 240     # top limb below r's: k < r
    k20 = torch.from_numpy(limbs20.astype(np.int32)).to(dev)
    probe20 = [0, 1, n20 // 2 + 1, n20 - 1]
    ks20 = [sum(int(limbs20[j, l]) << (16 * j) for j in range(16)) for l in probe20]
    ladders = {"scalar_mul": lambda: pt.scalar_mul(FQ_ADAPTER, k20, A20),
               "scalar_mul_glv": lambda: glv_mod.scalar_mul_glv(k20, A20)}
    launches_l, results_l, times_l = {}, {}, {k: [] for k in ladders}
    for name_, fn_ in ladders.items():               # first calls, counted
        reset_counts()
        results_l[name_] = fn_()
        torch.cuda.synchronize()
        launches_l[name_] = counts()
    for _ in range(3):                               # then in turns, by events
        for name_, fn_ in ladders.items():
            times_l[name_].append(time_ms(fn_, 1, warm=False))
    aff = {k: pt.jac_to_affine(FQ_ADAPTER, P_) for k, P_ in results_l.items()}
    same20 = trees_equal(aff["scalar_mul"], aff["scalar_mul_glv"])
    host20 = [oracle.jac_to_affine(oracle.scalar_mul(ks20[i], base_pts[l % M], oracle.FQ_OPS),
                                   oracle.FQ_OPS) for i, l in enumerate(probe20)]
    probed20 = all(g1.jacobian_to_ints(tuple(c[:, probe20] for c in P_)) == host20
                   for P_ in results_l.values())
    med_l = {k: statistics.median(v) for k, v in times_l.items()}
    gl, jl = launches_l["scalar_mul_glv"], launches_l["scalar_mul"]
    launches_ok = ((gl["glv_ladder"], gl["pmadd"], gl["pdbl"], jl["jac_ladder"])
                   == (1, 0, 0, 1))
    emit({"phase": "glv_vs_jac_ladder", "n": n20, "equal_affine": bool(same20),
          "probed_lanes_equal_host": bool(probed20),
          "ms_scalar_mul": med_l["scalar_mul"], "ms_scalar_mul_glv": med_l["scalar_mul_glv"],
          "ms_all": times_l,
          "ratio_scalar_mul_over_glv": med_l["scalar_mul"] / med_l["scalar_mul_glv"],
          "launches_scalar_mul": {k: v for k, v in jl.items() if v},
          "launches_scalar_mul_glv": {k: v for k, v in gl.items() if v}, "card": smi})
    if not (same20 and probed20 and launches_ok):
        raise AssertionError("glv_vs_jac_ladder: the two ladders differ, or a ladder was "
                             "not one launch")
    del results_l, aff

    # At 2^20 lanes, held limb for limb on every lane to the routed loop of
    # elementwise kernels it replaces (glv._glv_steps over FQ_ADAPTER: 128
    # pdbl and 256 pmadd launches and the selects), whose time is plain_ms.
    k1_20, k2_20 = glv_mod.decompose(k20)
    phi_20 = glv_mod.endomorphism(F1, A20)[0].contiguous()
    glv_row("glv_ladder[2e20]", k1_20, k2_20, A20, phi_20,
            "glv_vs_jac_ladder: scalar_mul_glv on 2^20 lanes, per-lane scalars",
            gl["glv_ladder"],
            lambda: glv_mod._glv_steps(F1, k1_20, k2_20, A20, (phi_20, A20[1], A20[2]),
                                       glv_mod.GLV_HALF_BITS), 3,
            plain_is="the routed loop of elementwise kernels, glv._glv_steps over "
                     "FQ_ADAPTER (128 pdbl, 256 pmadd, the selects)")
    del k1_20, k2_20, phi_20, A20, k20
    L2, R2, nb2 = geo2["L"], geo2["R"], geo2["nb"]

    scan_row_g2("pmadd2", "msm_g2_2e20: msm_g2", R2, L2, launches_g2["pmadd2"])
    scan_row_g2("pmadd2[cached]", "msm_g2_2e20: g2_context msm_with_bases",
                geo2c["R"], geo2c["L"], launches_g2c["pmadd2"])
    nl2 = 2 * nb2
    Al2 = tiled_affine_g2(nl2)
    Pl2 = contig(pj.proj_double(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, Al2)))
    Ql2 = contig(pj.affine_to_proj(FQ2_PLAIN, roll(Al2, 1)))
    kernel_row("padd2", "padd2_kernel", G2_SRC + "g2_padd.cu",
               "tpu_bls12_381/curves/pallas_g2.py:201",
               [24, 2, nl2], lambda: cuda_g2.padd2(Pl2, Ql2),
               lambda: cuda_g2.padd2_plain(Pl2, Ql2),
               9 * 48 * nl2, 0, nl2 * 36 * mul_mads(W_FQ), 20,
               n_launches=launches_g2["padd2"], path="msm_g2_2e20: msm_g2")
    nl2c = 2 * geo2c["nb"]
    Al2c = tiled_affine_g2(nl2c)
    Pl2c = contig(pj.proj_double(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, Al2c)))
    Ql2c = contig(pj.affine_to_proj(FQ2_PLAIN, roll(Al2c, 1)))
    kernel_row("padd2[cached]", "padd2_kernel", G2_SRC + "g2_padd.cu",
               "tpu_bls12_381/curves/pallas_g2.py:201",
               [24, 2, nl2c], lambda: cuda_g2.padd2(Pl2c, Ql2c),
               lambda: cuda_g2.padd2_plain(Pl2c, Ql2c),
               9 * 48 * nl2c, 0, nl2c * 36 * mul_mads(W_FQ), 20,
               n_launches=launches_g2c["padd2"],
               path="msm_g2_2e20: g2_context msm_with_bases")
    del Al2c, Pl2c, Ql2c
    scan_rows("single", "msm_g2_2e20: msm_g2", scans_g2, launches_g2["padd2_scan"], "g2")
    scan_rows("cached", "msm_g2_2e20: g2_context msm_with_bases", scans_g2c,
              launches_g2c["padd2_scan"], "g2")
    torch.cuda.empty_cache()
    # pdbl2 on one lane, as the triangle combine (lb_bits doublings, a chain
    # a window) and the Horner ladder (w doublings, a chain a step) call it;
    # each row's launches are msm_g2's launches of that many doublings
    # (check_tail asserted that they are all of its pdbl2 launches).
    P12 = tuple(c[..., 7].contiguous() for c in Pl2)
    if geo2["lb_bits"] == geo2["w"]:
        raise AssertionError("msm_g2_2e20: the triangle's and Horner's chains are of one "
                             "length, their launches cannot be told apart")
    for tag, times in (("triangle", geo2["lb_bits"]), ("horner", geo2["w"])):
        kernel_row(f"pdbl2[{tag}]", "pdbl2_kernel", G2_SRC + "g2_pdbl.cu",
                   "tpu_bls12_381/curves/pallas_g2.py:219",
                   [24, 2, 1], lambda: cuda_g2.pdbl2(P12, times),
                   lambda: cuda_g2.pdbl2_plain(P12, times),
                   6 * 48, 0, times * dbl2_mads, 50, n_launches=chains_g2.get(times, 0),
                   path="msm_g2_2e20: msm_g2", times=times,
                   equal_at_2e16=chain_equal(times, "g2"))
    del Al2, Pl2, Ql2, P12, A2
    # The upload's chain of span_up2 doublings on a slice of 2^20 lanes,
    # held to the plain chain of as many doublings (about a minute).
    nup2 = min(m_up2, expand_cap)
    Pup2 = contig(pj.affine_to_proj(FQ2_PLAIN, tiled_affine_g2(nup2)))
    kernel_row("pdbl2[upload]", "pdbl2_kernel", G2_SRC + "g2_pdbl.cu",
               "tpu_bls12_381/curves/pallas_g2.py:219", [24, 2, nup2],
               lambda: cuda_g2.pdbl2(Pup2, span_up2),
               lambda: cuda_g2.pdbl2_plain(Pup2, span_up2),
               6 * 48 * nup2, 0, nup2 * span_up2 * dbl2_mads, 3,
               n_launches=chains_up2.get(span_up2, 0),
               path="msm_g2_2e20: g2_context upload_bases", times=span_up2,
               equal_at_2e16=chain_equal(span_up2, "g2"))
    del Pup2
    torch.cuda.empty_cache()

    # The G2 tile sweep: one window's 2^20 signed G2 adds as (R, L) tiles of
    # 128 x 2^13, 64 x 2^14, 32 x 2^15 and 16 x 2^16 and back (each held to
    # the plain rows on its first 2 rows), with the stitch's lane scan at each
    # L; then padd2 at the boundary's 2*nb lanes and at 2^16.  Kernel times
    # from the trace.
    sweep2 = []
    adds2 = 1 << LOG_N
    At_ = tiled_affine_g2(adds2)
    tile_all = torch.cat([At_[0].reshape(48, -1), At_[1].reshape(48, -1)], dim=0)
    del At_
    sign_all = torch.from_numpy(rng.integers(0, 2, size=adds2).astype(bool)).to(dev)
    inf_all = torch.from_numpy(rng.integers(0, 16, size=adds2) == 0).to(dev)

    def g2_tile(log_l):
        Ls = 1 << log_l
        Rs = adds2 // Ls
        ts = tile_all.reshape(96, Rs, Ls).permute(1, 0, 2).contiguous()
        return (ts[:, :48].unflatten(1, (24, 2)), ts[:, 48:].unflatten(1, (24, 2)),
                sign_all.reshape(Rs, Ls), inf_all.reshape(Rs, Ls))

    for log_l in (13, 14, 15, 16, 16, 15, 14, 13):
        xs_, ys_, ss_, is_ = g2_tile(log_l)
        rows_ = cuda_g2.pmadd2_rows(xs_, ys_, ss_, is_)
        head = cuda_g2.pmadd2_rows_plain(xs_[:2], ys_[:2], ss_[:2], is_[:2])
        if not trees_equal(tuple(c[:2] for c in rows_), head):
            raise AssertionError(f"pmadd2 at {xs_.shape[0]} x 2^{log_l}: kernel and plain "
                                 f"differ")
        t_ = measure(lambda: cuda_g2.pmadd2_rows(xs_, ys_, ss_, is_), "pmadd2_kernel", 3)
        sweep2.append({"kernel": "pmadd2", "tile": [xs_.shape[0], 1 << log_l],
                       "ms": t_["ms"], "ms_from": t_["ms_from"]})
        col = tuple(c[-1].contiguous() for c in rows_)
        t_ = measure(lambda: cuda_g2.padd2_scan(col, exclusive=True), "padd_scan_", 5)
        sweep2.append({"kernel": "padd2_scan", "shape": [24, 2, 1 << log_l],
                       "what": "the stitch",
                       "ms": t_["ms"] * (3 if t_["ms_from"] == "profiler" else 1),
                       "ms_from": t_["ms_from"]})
        del xs_, ys_, ss_, is_, rows_, head, col

    for lanes_ in (nl2, 1 << 16):
        Pw, Qw = proj_points([lanes_], "g2"), contig(pj.affine_to_proj(
            FQ2_PLAIN, tiled_affine_g2(lanes_)))
        if not trees_equal(cuda_g2.padd2(Pw, Qw), cuda_g2.padd2_plain(Pw, Qw)):
            raise AssertionError(f"padd2 at {lanes_} lanes: kernel and plain differ")
        t_ = measure(lambda: cuda_g2.padd2(Pw, Qw), "padd2_kernel", 20)
        sweep2.append({"kernel": "padd2", "shape": [24, 2, lanes_], "ms": t_["ms"],
                       "ms_from": t_["ms_from"]})
    del tile_all, sign_all, inf_all, Pw, Qw
    torch.cuda.empty_cache()
    emit({"phase": "tile_sweep_g2", "adds": adds2, "rows": sweep2, "card": smi})
    if args.upto == "msm_g2_2e20":
        return stop_early()

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
            stages = cuda_ops.LAUNCHES["butterfly_stages"]
            ladder = (1, len(ntt_mod.ladder_split(case["log_n"],
                                                  ntt_mod.ladder_tile_log(xv))[1]))
            routed = (tiles, stages) == ((2, 0) if algo == "fourstep" else ladder)
            emit({"phase": "ntt_small", "kind": case["kind"], "log_n": case["log_n"],
                  "algorithm": algo, "equal": ok, "tile_launches": tiles,
                  "butterfly_stages_launches": stages,
                  "stage_launches": {str(k): v for k, v in cuda_ops.STAGE_LAUNCHES.items()}})
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
        return stop_early()

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

    def counted(fn, phase="ntt_2e22"):
        reset_counts()
        with guarded(phase):
            out = fn()
        return out, counts()

    tiles = lambda l_: l_["ntt_tile"] + l_["ntt_tile_w"]
    t0 = time.perf_counter()
    y4, launches_4 = counted(lambda: ctx.forward(x22))     # the main path: auto's route
    first_s = time.perf_counter() - t0
    modes_4, stages_4 = dict(cuda_ntt.MODE_LAUNCHES), dict(cuda_ops.STAGE_LAUNCHES)
    auto_fourstep = ntt_mod._route_fourstep(x22, Ordering.NN)
    set_algorithm("fourstep")
    yF, launches_F = counted(lambda: ctx.forward(x22))
    modes_F = dict(cuda_ntt.MODE_LAUNCHES)
    set_algorithm("radix2")
    y2, launches_2 = counted(lambda: ctx.forward(x22))
    stages_2, modes_2 = dict(cuda_ops.STAGE_LAUNCHES), dict(cuda_ntt.MODE_LAUNCHES)
    set_algorithm("auto")
    same = torch.equal(yF, y2) and torch.equal(y4, y2)
    del yF
    shape_ok = tuple(y4.shape) == (16, n22) and y4.dtype == torch.int32
    c22, split22 = ntt_mod.ladder_split(NTT_LOG_N, ntt_mod.ladder_tile_log(x22))
    ladder_launches = (1, len(split22))
    if (tiles(launches_F), launches_F["butterfly_stages"], modes_F) != (2, 0, {"columns": 2}):
        raise AssertionError(f"ntt_2e22: the four-step did not run two tiles on the "
                             f"columns: {launches_F}, {modes_F}")
    if ((tiles(launches_2), launches_2["butterfly_stages"]) != ladder_launches
            or len(split22) > 3 or modes_2 != {"columns_brev": 1}
            or stages_2 != {(1 << h, k): 1 for h, k in split22}):
        raise AssertionError(f"ntt_2e22: the ladder did not run one tile and the "
                             f"butterfly_stages launches {split22}: {launches_2}, {stages_2}, "
                             f"{modes_2}")
    if (tiles(launches_4), launches_4["butterfly_stages"]) != (
            (2, 0) if auto_fourstep else ladder_launches):
        raise AssertionError(f"ntt_2e22: the default route is not the one auto takes "
                             f"(four-step: {auto_fourstep}): {launches_4}")

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
    back_rn, launches_rn = counted(lambda: ctx.inverse(nr, Ordering.RN))
    modes_rn = dict(cuda_ntt.MODE_LAUNCHES)
    nr_rn = torch.equal(back_rn, x22) and torch.equal(vecops.bit_reverse(nr), y4)
    if modes_rn != {"rows_bitrev": 1}:
        raise AssertionError(f"ntt_2e22: the RN ladder did not run its tile on bit-reversed "
                             f"rows: {modes_rn}")
    del nr, back_rn
    xb = x22.reshape(16, 4, n22 // 4)
    yb, launches_b = counted(lambda: ctx.forward(xb))
    batched = all(torch.equal(yb[:, i], ctx.forward(xb[:, i].contiguous()))
                  for i in range(4))
    del yb, xb
    peak22 = torch.cuda.max_memory_allocated()

    def median_seconds(fn):
        with guarded("ntt_2e22"):
            fn()
            each = [tracing.timed_reps(1, fn) for _ in range(5)]
        return statistics.median(each), each

    med4, each4 = median_seconds(lambda: ctx.forward(x22))      # auto's route
    imed4, ieach4 = median_seconds(lambda: ctx.inverse(y4))
    set_algorithm("fourstep")
    medF, eachF = median_seconds(lambda: ctx.forward(x22))
    imedF, ieachF = median_seconds(lambda: ctx.inverse(y4))
    with tracing.collect_stages() as stagesF:
        ctx.forward(x22)
    traceF = device_trace(lambda: ctx.forward(x22))
    set_algorithm("radix2")
    med2, each2 = median_seconds(lambda: ctx.forward(x22))
    imed2, ieach2 = median_seconds(lambda: ctx.inverse(y4))
    trace2 = device_trace(lambda: ctx.forward(x22))
    set_algorithm("auto")
    ntt_ok = (same and shape_ok and host_ok and back2 and back4 and coset_back
              and nr_rn and batched)
    emit({"phase": "ntt_2e22", "n": n22, "equal": bool(ntt_ok),
          "route": "fourstep" if auto_fourstep else "ladder",
          "fourstep_equals_ladder": same, "host_checks": host_ok,
          "probe_k": k_probe, "inverse_roundtrip_ladder": back2,
          "inverse_roundtrip_auto": back4, "coset_roundtrip": coset_back,
          "nr_rn_roundtrip": nr_rn, "batched_4x2e20": batched,
          "ntt_fr_2e22_elems_per_s": n22 / med4,
          "ntt_fr_2e22_elems_per_s_fourstep": n22 / medF,
          "ntt_fr_2e22_elems_per_s_ladder": n22 / med2,
          "seconds_median_of_5": med4, "seconds_each": each4,
          "seconds_median_of_5_fourstep": medF, "seconds_each_fourstep": eachF,
          "seconds_median_of_5_ladder": med2, "seconds_each_ladder": each2,
          "seconds_median_of_5_inverse": imed4, "seconds_each_inverse": ieach4,
          "seconds_median_of_5_inverse_fourstep": imedF,
          "seconds_each_inverse_fourstep": ieachF,
          "seconds_median_of_5_inverse_ladder": imed2, "seconds_each_inverse_ladder": ieach2,
          "seconds_first_call": first_s, "seconds_domain_build": domain_s,
          "seconds_w_table_build": w_table_s, "seconds_host_horner": round(horner_s, 2),
          "split": [la22, lb22], "ladder_split": [c22, split22],
          "launches": launches_4, "launches_fourstep": launches_F,
          "launches_ladder": launches_2,
          "stage_launches_ladder": {str(k): v for k, v in stages_2.items()},
          "launches_inverse": launches_inv, "launches_batched": launches_b,
          "launches_rn_inverse": launches_rn,
          "tile_modes": {"auto": modes_4, "fourstep": modes_F, "ladder": modes_2,
                         "ladder_rn": modes_rn},
          "peak_bytes_allocated": peak22, "bytes_allocated_before": mem_before,
          "stages_ms_fourstep": {k: round(v, 3) for k, v in stagesF.items()},
          "device_kernels_fourstep": traceF[:8], "device_kernels_ladder": trace2[:8],
          "other_launches_fourstep": sum(r[2] for r in traceF if "ntt_tile" not in r[0]),
          "other_launches_ladder": sum(r[2] for r in trace2 if "ntt_tile" not in r[0]
                                       and "butterfly_stages" not in r[0]),
          "card": smi})
    if not ntt_ok:
        raise AssertionError("ntt_2e22: a check failed (see the line above)")

    # The ladder's tile rows: 2^11 (four values a thread) against the cap 2^12
    # (eight), in turns, the outputs held equal.
    set_algorithm("radix2")
    keep_tile_log = ntt_mod.LADDER_TILE_LOG
    split_rows = []
    try:
        for c_ in (11, 12, 12, 11):
            ntt_mod.LADDER_TILE_LOG = c_
            reset_counts()
            same_ = torch.equal(ctx.forward(x22), y4)
            launches_ = (tiles(counts()), dict(cuda_ops.STAGE_LAUNCHES))
            med_, each_ = median_seconds(lambda: ctx.forward(x22))
            split_rows.append({"tile_log": c_, "ms": med_ * 1e3,
                               "ms_each": [t * 1e3 for t in each_], "equal": same_,
                               "launches": [launches_[0], {str(k): v for k, v in
                                                           launches_[1].items()}]})
            if not same_:
                raise AssertionError(f"the ladder at a tile of 2^{c_} differs")
    finally:
        ntt_mod.LADDER_TILE_LOG = keep_tile_log
        set_algorithm("auto")
    emit({"phase": "ntt_ladder_split", "n": n22, "rows": split_rows, "card": smi})

    # Where the two algorithms cross: both timed at each size, and the route
    # that `auto` takes there (2^23 and 2^24: x repeated).
    for log_c in (10, 12, 14, 16, 20, 23, 24):
        xc = (x22[:, :1 << log_c].contiguous() if log_c <= NTT_LOG_N
              else x22.repeat(1, 1 << (log_c - NTT_LOG_N)))
        ctx_c = {}
        for algo in ("fourstep", "radix2"):
            set_algorithm(algo)
            yc = ctx.forward(xc)
            ctx_c[algo] = (yc, median_seconds(lambda: ctx.forward(xc)))
        set_algorithm("auto")
        if not torch.equal(ctx_c["fourstep"][0], ctx_c["radix2"][0]):
            raise AssertionError(f"ntt 2^{log_c}: four-step and ladder differ")
        emit({"phase": "ntt_crossover", "log_n": log_c,
              "auto_route": "fourstep" if ntt_mod._route_fourstep(xc, Ordering.NN)
              else "ladder",
              "fourstep_ms": ctx_c["fourstep"][1][0] * 1e3,
              "ladder_ms": ctx_c["radix2"][1][0] * 1e3,
              "fourstep_ms_each": [t * 1e3 for t in ctx_c["fourstep"][1][1]],
              "ladder_ms_each": [t * 1e3 for t in ctx_c["radix2"][1][1]]})
        del ctx_c, xc, yc
    torch.cuda.empty_cache()

    if args.upto == "ntt_2e22":
        return stop_early()

    # ------------------------------------------- NTT kernels at the path's shapes
    NTT_SRC = "tpu_bls12_381_torch/csrc/ntt_kernels.cu"
    STAGES_SRC = "tpu_bls12_381_torch/csrc/ntt_stages.cu"
    TILE_TPU = "tpu_bls12_381/ntt/pallas_ntt.py:80"
    BFLY_TPU = "tpu_bls12_381/fields/pallas_ops.py:421"
    ntt_lib, stages_lib = cuda_ntt._lib(), cuda_ops._stages_lib()
    ntt_lib.fr_ntt_tile_blocks_per_sm.restype = ctypes.c_int
    stages_lib.fr_butterfly_stages_blocks_per_sm.restype = ctypes.c_int
    ntt_ptxas = lambda kernel: {k: v for k, v in registers.items() if kernel in k}
    # products a tile needs: those of twiddle w^0 = 1 (m - 1 a row) take none
    tile_products = lambda rows, m: rows * ((m // 2) * (m.bit_length() - 1) - (m - 1))
    tile_mads = lambda rows, m, folds: (
        tile_products(rows, m) + folds * rows * m) * mul_mads(W_FR)
    tile_mads_all = lambda rows, m, folds: (
        rows * (m // 2) * (m.bit_length() - 1) + folds * rows * m) * mul_mads(W_FR)
    tw22 = get_domain(NTT_LOG_N, dev).tw
    xr22 = vecops.bit_reverse(x22)
    # The ladder: its tile on rows of 2^c22 (NN: the bit-reversed columns of
    # x where it lies; RN: bit-reversed rows), then each butterfly_stages
    # launch on what the one before left.
    m_c = 1 << c22
    xc22 = x22.reshape(16, 1, m_c, n22 // m_c)
    xb22 = xr22.reshape(16, n22 // m_c, m_c)
    tw_c = ntt_mod._stage_table(tw22, NTT_LOG_N, c22)
    tile_bytes = 2 * 16 * n22 + 16 * (m_c // 2)
    ladder_bound_all = bound(tile_bytes * LIMB_BYTES, tile_mads_all(n22 // m_c, m_c, 0))[0]
    kernel_row("ntt_tile[ladder]", "ntt_tile_kernel", NTT_SRC, TILE_TPU,
               [16, n22 // m_c, m_c],
               lambda: cuda_ntt.ntt_tile_columns(xc22, tw_c, brev_cols=True),
               lambda: cuda_ntt.ntt_tile_columns_plain(xc22, tw_c, brev_cols=True),
               tile_bytes, 0, tile_mads(n22 // m_c, m_c, 0), 5,
               n_launches=modes_4.get("columns_brev", 0),
               path="ntt_2e22: auto's route, the NN ladder (rows read as bit-reversed "
                    "columns)",
               mode="columns_brev", bound_ms_all_products=ladder_bound_all,
               blocks_per_sm=ntt_lib.fr_ntt_tile_blocks_per_sm(c22),
               ptxas=ntt_ptxas("ntt_tile_kernel"))
    kernel_row("ntt_tile[ladder RN]", "ntt_tile_kernel", NTT_SRC, TILE_TPU,
               [16, n22 // m_c, m_c], lambda: cuda_ntt.ntt_tile(xb22, tw_c),
               lambda: cuda_ntt.ntt_tile_plain(xb22, tw_c),
               tile_bytes, 0, tile_mads(n22 // m_c, m_c, 0), 5,
               n_launches=modes_rn["rows_bitrev"],
               path="ntt_2e22: the RN ladder (bit-reversed rows in)", mode="rows_bitrev",
               bound_ms_all_products=ladder_bound_all)
    xs_ = cuda_ntt.ntt_tile(xb22, tw_c).reshape(16, n22)
    del xc22, xb22
    for h, k in split22:
        tw_s = ntt_mod._stage_table(tw22, NTT_LOG_N, h + k)
        kernel_row(f"butterfly_stages[half=2^{h},count={k}]", "butterfly_stages_kernel",
                   STAGES_SRC, BFLY_TPU, [16, n22],
                   lambda: cuda_ops.butterfly_stages(FR, xs_, tw_s, 1 << h, k),
                   lambda: cuda_ops.butterfly_stages_plain(FR, xs_, tw_s, 1 << h, k),
                   2 * 16 * n22 + 16 * (1 << (h + k - 1)), 0,
                   k * (n22 // 2) * mul_mads(W_FR), 10,
                   n_launches=stages_4.get((1 << h, k), 0),
                   path="ntt_2e22: auto's route, the ladder", half=1 << h, count=k,
                   twiddle_table=[16, 1 << (h + k - 1)],
                   blocks_per_sm=stages_lib.fr_butterfly_stages_blocks_per_sm(k),
                   ptxas=ntt_ptxas("butterfly_stages_kernel"))
        xs_ = cuda_ops.butterfly_stages(FR, xs_, tw_s, 1 << h, k)
    if not torch.equal(xs_, y4):
        raise AssertionError("ntt_2e22: the ladder's launches, one by one, differ from "
                             "the NTT")
    del xs_, tw_s
    # The elementwise butterfly (the TPU kernel's contract) on the ladder's
    # last stage's operands: no driven path calls it.
    ev, ov = xr22[:, :n22 // 2].contiguous(), xr22[:, n22 // 2:].contiguous()
    kernel_row("butterfly_fr", "butterfly_kernel", "tpu_bls12_381_torch/csrc/field_kernels.cu",
               BFLY_TPU, [16, n22 // 2], lambda: cuda_ops.butterfly(FR, ev, ov, tw22),
               lambda: cuda_ops.butterfly_plain(FR, ev, ov, tw22),
               5 * 16 * (n22 // 2), 0, (n22 // 2) * mul_mads(W_FR), 10, n_launches=0,
               path="kernels: the elementwise form (no driven path calls it)")
    del xr22, ev, ov
    # The four-step's two tiles: natural rows in, bit-reversed as they load.
    m_in, m_out = 1 << lb22, 1 << la22
    W22 = cuda_ntt._step_w(NTT_LOG_N, m_out, m_in, False, dev)
    tw_in = get_domain(lb22, dev).tw
    four_path = "ntt_2e22: the four-step" + ("" if auto_fourstep else " (forced)")
    four_launches = launches_4 if auto_fourstep else launches_F
    xt = x22.reshape(16, 1, m_in, m_out)
    tile_bytes = 3 * 16 * n22 + 16 * (m_in // 2)
    kernel_row("ntt_tile_w", "ntt_tile_kernel", NTT_SRC, TILE_TPU, [16, m_out, m_in],
               lambda: cuda_ntt.ntt_tile_columns(xt, tw_in, w=W22),
               lambda: cuda_ntt.ntt_tile_columns_plain(xt, tw_in, w=W22),
               tile_bytes, 0, tile_mads(m_out, m_in, 1), 5,
               n_launches=four_launches["ntt_tile_w"], path=four_path, mode="columns",
               bound_ms_all_products=bound(tile_bytes * LIMB_BYTES,
                                           tile_mads_all(m_out, m_in, 1))[0],
               blocks_per_sm=ntt_lib.fr_ntt_tile_blocks_per_sm(lb22))
    del W22
    xt = x22.reshape(16, 1, m_out, m_in)
    tw_out = get_domain(la22, dev).tw
    tile_bytes = 2 * 16 * n22 + 16 * (m_out // 2)
    kernel_row("ntt_tile", "ntt_tile_kernel", NTT_SRC, TILE_TPU, [16, m_in, m_out],
               lambda: cuda_ntt.ntt_tile_columns(xt, tw_out),
               lambda: cuda_ntt.ntt_tile_columns_plain(xt, tw_out),
               tile_bytes, 0, tile_mads(m_in, m_out, 0), 5,
               n_launches=four_launches["ntt_tile"], path=four_path, mode="columns",
               bound_ms_all_products=bound(tile_bytes * LIMB_BYTES,
                                           tile_mads_all(m_in, m_out, 0))[0])
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
    s22 = rand_field(FR, 5)[:, 4]                 # one scalar (16,)
    (v_add, v_sub, v_mul), launches_v = counted(lambda: (
        vecops.vector_add(FR, x22, b22), vecops.vector_sub(FR, x22, b22),
        vecops.vector_mul(FR, x22, b22)), "vecops")
    v_sum, launches_sum_v = counted(lambda: vecops.vector_sum(FR, x22), "vecops")
    v_sadd, launches_sadd = counted(lambda: vecops.scalar_vec_add(FR, s22, x22), "vecops")
    sadd_columns = dict(cuda_ops.COLUMN_LAUNCHES)
    sum_ok = fr_ints(v_sum[:, None])[0] == want0
    # (a + b) - b = a, a*b and s + a against the plain versions on a slice
    algebra_ok = (torch.equal(vecops.vector_sub(FR, v_add, b22), x22)
                  and torch.equal(vecops.vector_add(FR, v_sub, b22), x22)
                  and torch.equal(v_mul[:, :4096],
                                  ops.mont_mul(FR, x22[:, :4096], b22[:, :4096]))
                  and torch.equal(v_sadd[:, :4096], ops.add(FR, x22[:, :4096], s22[:, None])))
    del v_add, v_sub, v_mul, v_sadd
    # vector_sum held to its plain version (the halving tree) on (16, 2, 2^16):
    # a row with 0, 1 and r - 1 among random lanes, a row of r - 1 in every lane
    x16 = torch.stack([rand_field(FR, 1 << 16), rand_field(FR, 3)[:, 2:3].expand(16, 1 << 16)],
                      dim=1).contiguous()
    sum16 = vecops.vector_sum(FR, x16)
    sum16_ok = torch.equal(sum16, cuda_ops.field_sum_plain(FR, x16))
    G22 = cuda_ops._lib().field_sum_blocks_per_row(n22, 1)
    # whole calls by CUDA events (the wrappers' host work included)
    with guarded("vecops"):
        vec_ms = {"vector_add": time_ms(lambda: vecops.vector_add(FR, x22, b22), 20),
                  "vector_sub": time_ms(lambda: vecops.vector_sub(FR, x22, b22), 20),
                  "vector_sum": time_ms(lambda: vecops.vector_sum(FR, x22), 20),
                  "scalar_vec_add": time_ms(lambda: vecops.scalar_vec_add(FR, s22, x22), 20)}
    t0 = time.perf_counter()
    inv, launches_inv_v = counted(lambda: vecops.batch_inverse(FR, xz), "vecops")
    torch.cuda.synchronize()
    inverse_s = time.perf_counter() - t0
    prod = vecops.vector_mul(FR, inv, xz)
    want = ops.one_mont(FR, (n22,), dev)
    want[:, zero_lanes] = 0
    inverse_ok = torch.equal(prod, want) and not bool(inv[:, zero_lanes].any())
    vec_ok = sum_ok and sum16_ok and algebra_ok and inverse_ok
    emit({"phase": "vecops", "n": n22, "equal": bool(vec_ok), "vector_sum": sum_ok,
          "vector_sum_equals_plain_2x2e16": sum16_ok,
          "add_sub_mul_scalar_add": algebra_ok, "batch_inverse": inverse_ok,
          "batch_inverse_seconds": inverse_s, "ms_by_cuda_events": vec_ms,
          "launches": launches_v,
          "launches_vector_sum": {k: v for k, v in launches_sum_v.items() if v},
          "field_sum_blocks": G22,
          "launches_scalar_vec_add": {k: v for k, v in launches_sadd.items() if v},
          "launches_batch_inverse": launches_inv_v, "card": smi})
    if not vec_ok:
        raise AssertionError("vecops: a check failed (see the line above)")
    vec_launched = ({k: v for k, v in launches_v.items() if v},
                    {k: v for k, v in launches_sum_v.items() if v},
                    {k: v for k, v in launches_sadd.items() if v}, sadd_columns)
    if vec_launched != ({"add_fr": 1, "sub_fr": 1, "mont_mul_fr": 1},
                        {"sum_fr": 2 if G22 > 1 else 1},
                        {"add_fr": 1}, {("add_fr", n22): 1}):
        raise AssertionError(f"vecops: add, sub, mul, the sum and the scalar add did not "
                             f"launch one kernel each (the sum 1 or 2 field_sum, no add_fr; "
                             f"the scalar add one column add): {vec_launched}")
    binv_launched = {k: v for k, v in launches_inv_v.items() if v}
    if binv_launched != {"batch_inverse_fr": 3}:
        raise AssertionError(f"vecops: batch_inverse launched {binv_launched}, not its "
                             f"three kernels alone")
    del inv, prod, want, x16, sum16
    binv_row("batch_inverse[vecops]", FR, xz, launches_inv_v["batch_inverse_fr"], "vecops")
    del xz
    kernel_row("mont_mul_fr[vecops]", "mont_mul_kernel", FIELD_SRC, MUL_TPU, [16, n22],
               lambda: cuda_ops.mont_mul(FR, x22, b22),
               lambda: cuda_ops.mont_mul_plain(FR, x22, b22),
               3 * 16 * n22, 0, n22 * mul_mads(W_FR), 10,
               n_launches=launches_v["mont_mul_fr"], path="vecops: vector_mul")
    for op, tpu in (("add", ADD_TPU), ("sub", SUB_TPU)):
        kern, plain = getattr(cuda_ops, op), getattr(cuda_ops, f"{op}_plain")
        kernel_row(f"{op}_fr", "addsub_kernel", FIELD_SRC, tpu, [16, n22],
                   lambda: kern(FR, x22, b22), lambda: plain(FR, x22, b22),
                   3 * 16 * n22, 0, 0, 10, n_launches=launches_v[f"{op}_fr"],
                   path=f"vecops: vector_{op}", torch_add_ms=time_ms(
                       lambda: torch.add(x22, b22, out=torch.empty_like(x22)), 10))
    s_col = s22[:, None].contiguous()
    kernel_row("add_fr[column]", "addsub_kernel", FIELD_SRC, ADD_TPU, [16, n22],
               lambda: cuda_ops.add(FR, x22, s_col), lambda: cuda_ops.add_plain(FR, x22, s_col),
               2 * 16 * n22 + 16, 0, 0, 10, n_launches=launches_sadd["add_fr"],
               path="vecops: scalar_vec_add (the scalar a (16, 1) column)",
               torch_add_ms=time_ms(lambda: torch.add(x22, 1, out=torch.empty_like(x22)), 10))
    # field_sum: its plain version is held on (16, 2, 2^16) above; at 2^22 the
    # kernel is held to the host's sum of the same limbs (Python integers:
    # a sum of Montgomery forms is the Montgomery form of the sum)

    def host_sum(x_):
        limbs = x_.cpu().numpy().astype(np.int64).sum(axis=1)
        total = sum(int(v) << (16 * k) for k, v in enumerate(limbs)) % r_mod
        return torch.from_numpy(ints_to_limbs([total], 16)[:, 0].astype(np.int32)).to(dev)

    kernel_row("field_sum_fr[vecops]", "field_sum_kernel", FIELD_SRC, ADD_TPU, [16, n22],
               lambda: cuda_ops.field_sum(FR, x22), lambda: host_sum(x22),
               16 * n22 + 16, 0, 0, 10, n_launches=launches_sum_v["sum_fr"], per_call=1,
               kernels_per_call=launches_sum_v["sum_fr"],
               path="vecops: vector_sum (where the halving tree made 22 add_fr launches)",
               plain_is="the host's sum of the limbs (Python integers); the halving tree "
                        "on (16, 2, 2^16) is held equal with torch.equal",
               blocks_per_row=G22,
               torch_sum_ms=time_ms(lambda: torch.sum(x22, dim=-1, dtype=torch.int32), 10),
               ptxas={k: v for k, v in registers.items() if "field_sum_kernel" in k})
    del x22, b22, x_std
    if args.upto == "vecops":
        return stop_early()

    # ---------------------------------------------------------------- parallel
    # The scale-out layer (parallel/, msm_chunked) on one rank over NCCL: a
    # world of one on the card, whose collectives run through the group.
    # Each sharded result is held to its one-device counterpart: the MSMs by
    # value (the chunks' association changes Z), the NTT forms with
    # torch.equal.  Times in turns with the one-device calls, by CUDA events.
    import socket

    import torch.distributed as dist

    from tpu_bls12_381_torch import parallel
    from tpu_bls12_381_torch.msm import expand_bases, msm_precomputed, pippenger
    from tpu_bls12_381_torch.parallel import mesh as mesh_mod
    from tpu_bls12_381_torch.parallel.msm import chunk_msm_inputs
    from tpu_bls12_381_torch.parallel.ntt import release_sharded_caches, split_sizes

    def events_ms(fn):
        """One call of ``fn`` in milliseconds, by CUDA events."""
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    def in_turns(fns, rounds):
        """{name: median ms} of ``rounds`` rounds, each calling every fn once
        in order (a warm call each first), and each round's readings."""
        for fn in fns.values():
            fn()
        each = {k: [] for k in fns}
        for _ in range(rounds):
            for k, fn in fns.items():
                each[k].append(events_ms(fn))
        return {k: statistics.median(v) for k, v in each.items()}, each

    def counted_par(fn, shapes=None):
        """``fn()`` inside the guard, with the kernel launches and the
        collectives counted from 0; the add and sub calls by form and shape
        are added to ``shapes`` (``field_shapes``)."""
        reset_counts()
        mesh_mod.reset_collectives()
        with guarded("parallel"), field_shapes() as seen_:
            out = fn()
            torch.cuda.synchronize()
        if shapes is not None:
            for k_, v_ in seen_.items():
                shapes[k_] = shapes.get(k_, 0) + v_
        return out, {k: v for k, v in counts().items() if v}, dict(mesh_mod.COLLECTIVES)

    saved_env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                                  "RANK", "LOCAL_RANK") if k in os.environ}
    t_par = time.perf_counter()
    no_coordinator = parallel.init_distributed()
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    joined = parallel.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    shapes_par = {"g1": {}, "g2": {}}
    try:
        mesh = parallel.default_mesh()
        mesh_ok = (mesh.rank, mesh.size, mesh.device, mesh.group is not None,
                   dist.get_backend()) == (0, 1, dev, True, "nccl")
        if no_coordinator or not joined or not mesh_ok:
            raise AssertionError(f"parallel: init_distributed without a coordinator "
                                 f"{no_coordinator}, with one {joined}, mesh {mesh}")
        # G1: msm_2e20's points and scalars
        s_std = torch.from_numpy(limbs).to(dev)
        s_mont = cuda_ops.mont_mul(FR, s_std, ops.broadcast_constant(FR, FR.r2_limbs, (n,), dev))
        del s_std
        A = tiled_affine(n)
        expected = oracle.jac_to_affine(
            oracle.scalar_mul(host_scalar_total(ks), G, oracle.FQ_OPS), oracle.FQ_OPS)
        ints1 = lambda P: g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]
        D = 4
        sc4, A4 = chunk_msm_inputs(s_mont, A, D)
        nloc = n // D
        # the plan of msm_chunked over the D chunks as one batch
        geo_c = msm_geometry(nloc, True, F=FQ_ADAPTER, device=dev, chunks=D)
        w_c = geo_c["w"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        P1 = msm_g1(s_mont, A)
        peak_1 = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        Ps, launches_s, coll_s = counted_par(
            lambda: parallel.msm_g1_sharded(sc4, A4, mesh, glv=True), shapes_par["g1"])
        peak_s = torch.cuda.max_memory_allocated()
        scans_s, chains_s = scan_counts(), chain_counts()
        # factor 2 as precompute lays it out: GLV-extend, expand, 4 segments a chunk
        w_f = pippenger.window_bits_for(2 * nloc, FQ_ADAPTER, dev)
        with guarded("parallel"):
            Ae = expand_bases(FQ_ADAPTER, pippenger.glv_extend_bases(FQ_ADAPTER, A), w_f, 2,
                              pippenger.GLV_HALF_BITS_STATIC)
        scf, Af = chunk_msm_inputs(s_mont, Ae, D, segments=4)
        del Ae
        Pf, launches_f, coll_f = counted_par(
            lambda: parallel.msm_g1_sharded(scf, Af, mesh, window_bits=w_f, glv=True, factor=2),
            shapes_par["g1"])
        scans_f, chains_f = scan_counts(), chain_counts()
        geo_f = msm_geometry(nloc, True, F=FQ_ADAPTER, device=dev, window_bits=w_f,
                             factor=2, chunks=D)
        sc1, A1 = chunk_msm_inputs(s_mont, A, 1)
        Pp, launches_p, coll_p = counted_par(
            lambda: parallel.msm_g1_sharded(sc1, A1, mesh, glv=True), shapes_par["g1"])
        # The parent's form of the same calls, rebuilt from public calls: each
        # chunk through the one-device MSM in turn, then the combine.
        A4d = [tuple(c[d] for c in A4) for d in range(D)]
        Afd = [tuple(c[d] for c in Af) for d in range(D)]
        stack = lambda Ps_: tuple(torch.stack([P[c] for P in Ps_], dim=-1) for c in range(3))
        each_g1 = lambda: [msm_g1(sc4[d], A4d[d], window_bits=w_c, glv=True) for d in range(D)]
        each_f = lambda: [msm_precomputed(FQ_ADAPTER, scf[d], Afd[d], window_bits=w_f, factor=2,
                                          glv=True) for d in range(D)]
        # each chunk of the batch against the one-device call on it: limb for
        # limb (every kernel on the path computes a member as one alone) and
        # by value
        with guarded("parallel"):
            P_chunks = tuple(c.movedim(0, -1).contiguous() for c in pippenger.msm_chunked(
                FQ_ADAPTER, sc4, A4, glv=True))                          # (24, D) leaves
            Pf_chunks = tuple(c.movedim(0, -1).contiguous() for c in pippenger.msm_chunked(
                FQ_ADAPTER, scf, Af, window_bits=w_f, glv=True, factor=2))
            P_each, Pf_each = stack(each_g1()), stack(each_f())
            one_by_one = pt.sum_reduce(FQ_ADAPTER, P_each)
        chunks_equal = {
            "limbs": trees_equal(P_chunks, P_each), "factor2_limbs": trees_equal(Pf_chunks, Pf_each),
            "values": g1.jacobian_to_ints(P_chunks) == g1.jacobian_to_ints(P_each),
            "factor2_values": g1.jacobian_to_ints(Pf_chunks) == g1.jacobian_to_ints(Pf_each)}
        got = {"msm_g1": ints1(P1), "sharded_4": ints1(Ps), "factor2_4": ints1(Pf),
               "one_chunk": ints1(Pp), "one_by_one_4": ints1(one_by_one)}
        g1_ok = all(v == expected for v in got.values()) and all(chunks_equal.values())
        with guarded("parallel"):
            ms_g1, each_ms_g1 = in_turns({
                "msm_g1": lambda: msm_g1(s_mont, A),
                "msm_g1_sharded_4": lambda: parallel.msm_g1_sharded(sc4, A4, mesh, glv=True),
                "msm_g1_one_by_one_4": lambda: pt.sum_reduce(FQ_ADAPTER, stack(each_g1())),
                "msm_g1_sharded_factor2_4": lambda: parallel.msm_g1_sharded(
                    scf, Af, mesh, window_bits=w_f, glv=True, factor=2),
                "msm_precomputed_one_by_one_factor2_4": lambda: pt.sum_reduce(
                    FQ_ADAPTER, stack(each_f())),
                "msm_g1_sharded_1": lambda: parallel.msm_g1_sharded(sc1, A1, mesh,
                                                                    glv=True)}, 3)
        del P1, Ps, Pf, Pp, A, sc1, A1, A4d, Afd, Pf_chunks, P_each, Pf_each, one_by_one
        # the launches against the batched plan: T x groups x pieces scans and
        # the tail of one batched run (not D times a chunk's)
        plan_ok = (launches_s.get("pmadd_signed") == geo_c["scan_launches"]
                   and launches_s.get("padd_scan") == geo_c["tail_launches"]["padd_scan"]
                   and launches_f.get("pmadd_signed") == geo_f["scan_launches"]
                   and launches_f.get("padd_scan") == geo_f["tail_launches"]["padd_scan"]
                   and launches_s.get("jadd") == 2 and launches_f.get("jadd") == 2
                   and coll_s["all_gather"] == 3
                   and launches_p.get("jadd", 0) == 0 and coll_p["all_gather"] == 3)
        plan_keys = ("glv", "w", "T", "L", "R", "nb", "groups", "per_group", "pieces",
                     "scan_launches", "tail_launches")
        emit({"phase": "parallel", "what": "G1 MSM, 2^20 points", "equal": g1_ok,
              "launches_as_planned": plan_ok, "mesh": [mesh.rank, mesh.size, str(mesh.device)],
              "chunks": D, "chunks_as_one_batch_plan": {k: geo_c[k] for k in plan_keys},
              "factor2_window": w_f,
              "factor2_plan": {k: geo_f[k] for k in plan_keys if k != "glv"},
              "chunks_equal_the_one_device_calls": chunks_equal,
              "ms_median_of_3_in_turns": ms_g1, "ms_each": each_ms_g1,
              "peak_bytes_allocated": {"msm_g1": peak_1, "msm_g1_sharded_4": peak_s},
              "launches_sharded_4": launches_s, "launches_factor2_4": launches_f,
              "launches_one_chunk": launches_p,
              "collectives": {"sharded_4": coll_s, "factor2_4": coll_f, "one_chunk": coll_p},
              "jadd": {"sharded_4": launches_s.get("jadd", 0),
                       "factor2_4": launches_f.get("jadd", 0),
                       "one_chunk": launches_p.get("jadd", 0)}, "card": smi})
        if not (g1_ok and plan_ok):
            raise AssertionError(f"parallel: the sharded G1 MSM differs or did not follow "
                                 f"the batched plan: {got} (host {expected}), chunks "
                                 f"{chunks_equal}, {plan_ok}")
        check_tail("parallel: msm_g1_sharded", launches_s, geo_c, chains_s)
        check_tail("parallel: msm_g1_sharded factor 2", launches_f, geo_f, chains_f)
        # G2: msm_g2_2e20's 2^20 points in 4 chunks of 2^18
        A2s = tiled_affine_g2(n)
        sc2, A24 = chunk_msm_inputs(s_mont, A2s, D)
        geo_c2 = msm_geometry(nloc, F=FQ2_ADAPTER, device=dev, chunks=D)
        w_c2 = geo_c2["w"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with guarded("parallel"):
            P2 = msm_g2(s_mont, A2s)
        peak_2 = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        P2s, launches_2s, coll_2s = counted_par(lambda: parallel.msm_g2_sharded(sc2, A24, mesh),
                                                shapes_par["g2"])
        peak_2s = torch.cuda.max_memory_allocated()
        scans_2s, chains_2s = scan_counts(cuda_g2), chain_counts(cuda_g2)
        sc21, A21 = chunk_msm_inputs(s_mont, A2s, 1)
        A24d = [tuple(c[d] for c in A24) for d in range(D)]
        each_g2 = lambda: [msm_g2(sc2[d], A24d[d], window_bits=w_c2) for d in range(D)]
        with guarded("parallel"):
            P2p = parallel.msm_g2_sharded(sc21, A21, mesh)
            P2_chunks = tuple(c.movedim(0, -1).contiguous()
                              for c in pippenger.msm_chunked(FQ2_ADAPTER, sc2, A24))
            P2_each = stack(each_g2())
            one_by_one2 = pt.sum_reduce(FQ2_ADAPTER, P2_each)
        chunks2_equal = {"limbs": trees_equal(P2_chunks, P2_each),
                         "values": g2.jacobian_to_ints(P2_chunks) == g2.jacobian_to_ints(P2_each)}
        got2 = {"msm_g2": g2_ints(P2), "sharded_4": g2_ints(P2s), "one_chunk": g2_ints(P2p),
                "one_by_one_4": g2_ints(one_by_one2)}
        g2_ok = all(v == expected_g2 for v in got2.values()) and all(chunks2_equal.values())
        plan2_ok = (launches_2s.get("pmadd2") == geo_c2["scan_launches"]
                    and launches_2s.get("padd2_scan") == geo_c2["tail_launches"]["padd2_scan"]
                    and coll_2s["all_gather"] == 3)
        with guarded("parallel"):
            ms_g2, each_ms_g2 = in_turns({
                "msm_g2": lambda: msm_g2(s_mont, A2s),
                "msm_g2_sharded_4": lambda: parallel.msm_g2_sharded(sc2, A24, mesh),
                "msm_g2_one_by_one_4": lambda: pt.sum_reduce(FQ2_ADAPTER, stack(each_g2())),
                "msm_g2_sharded_1": lambda: parallel.msm_g2_sharded(sc21, A21, mesh)}, 3)
        emit({"phase": "parallel", "what": "G2 MSM, 2^20 points", "equal": g2_ok,
              "launches_as_planned": plan2_ok, "chunks": D,
              "chunks_as_one_batch_plan": {k: geo_c2[k] for k in plan_keys if k != "glv"},
              "chunks_equal_the_one_device_calls": chunks2_equal,
              "ms_median_of_3_in_turns": ms_g2, "ms_each": each_ms_g2,
              "peak_bytes_allocated": {"msm_g2": peak_2, "msm_g2_sharded_4": peak_2s},
              "launches_sharded_4": launches_2s, "collectives": coll_2s, "card": smi})
        if not (g2_ok and plan2_ok):
            raise AssertionError(f"parallel: the sharded G2 MSM differs from the host's point "
                                 f"or did not follow the batched plan: {got2}, chunks "
                                 f"{chunks2_equal}, {plan2_ok}")
        check_tail("parallel: msm_g2_sharded", launches_2s, geo_c2, chains_2s, kernel="pdbl2")
        del P2, P2s, P2p, A2s, sc2, A24, sc21, A21, A24d, P2_chunks, P2_each, one_by_one2, s_mont
        # NTT at 2^22
        x22 = rand_field(FR, n22)
        nA22, nB22 = split_sizes(NTT_LOG_N, mesh.size)
        shift = constants.FR_MULTIPLICATIVE_GENERATOR
        with guarded("parallel"):
            nat = ntt(x22)
            y_n, launches_n, coll_n = counted_par(lambda: parallel.ntt_sharded(x22, mesh))
            y_t, launches_t, coll_t = counted_par(
                lambda: parallel.ntt_sharded(x22, mesh, transposed_out=True))
            # launches of a call once the step twiddles are cached
            _, launches_n2, _ = counted_par(lambda: parallel.ntt_sharded(x22, mesh))
            checks = {
                "natural": torch.equal(y_n, nat),
                "transposed": torch.equal(y_t.reshape(16, nB22, nA22),
                                          nat.reshape(16, nA22, nB22).transpose(1, 2)),
                "intt natural": torch.equal(parallel.intt_sharded(y_n, mesh), x22),
                "intt transposed": torch.equal(
                    parallel.intt_sharded(y_t, mesh, transposed_in=True), x22)}
            del nat, y_n, y_t
            ev = coset_ntt(x22, shift)
            checks["coset_ntt"] = torch.equal(parallel.coset_ntt_sharded(x22, mesh, shift), ev)
            checks["coset_intt"] = torch.equal(parallel.coset_intt_sharded(ev, mesh, shift),
                                               coset_intt(ev, shift))
            del ev
            xb = x22.reshape(16, 4, n22 // 4)
            checks["ntt_batch_sharded"] = torch.equal(parallel.ntt_batch_sharded(xb, mesh),
                                                      ntt(xb))
            ms_ntt, each_ntt = in_turns({
                "ntt_sharded": lambda: parallel.ntt_sharded(x22, mesh),
                "ntt_sharded_transposed": lambda: parallel.ntt_sharded(
                    x22, mesh, transposed_out=True),
                "ntt": lambda: ntt(x22)}, 5)
        ntt_plan_ok = ((coll_n["all_to_all_single"], coll_t["all_to_all_single"]) == (3, 2)
                       and launches_n2 == {"ntt_tile": 2, "mont_mul_fr": 1})
        emit({"phase": "parallel", "what": "NTT, 2^22", "equal": all(checks.values()),
              "checks": checks, "split": [nA22, nB22], "collectives_as_planned": ntt_plan_ok,
              "ms_median_of_5_in_turns": ms_ntt, "ms_each": each_ntt,
              "launches_first_call": launches_n, "launches_cached": launches_n2,
              "launches_transposed": launches_t,
              "collectives": {"natural": coll_n, "transposed": coll_t}, "card": smi})
        if not (all(checks.values()) and ntt_plan_ok):
            raise AssertionError(f"parallel: the sharded NTT: {checks}, collectives "
                                 f"{coll_n}, {coll_t}, launches {launches_n2}")
        del x22, xb
        release_sharded_caches()
        release_domain()
        release_coset_cache()
    finally:
        dist.destroy_process_group()
        os.environ.update(saved_env)
    emit({"phase": "parallel", "what": "the phase", "seconds": time.perf_counter() - t_par,
          "process_group_destroyed": not dist.is_initialized()})
    torch.cuda.empty_cache()
    # A row for each kernel shape of the phase's paths that no row has yet;
    # the shapes that a row already holds are named in a line.
    def row_at(kernel, shape, **match):
        """The name of a row of ``kernel`` (named ``kernel`` or
        ``kernel[...]``) at ``shape`` and the ``match`` values, or None."""
        for r in rows:
            base = r["name"].rsplit("[", 1)[0] if r["name"].endswith("]") else r["name"]
            if (base == kernel and list(r["shape"]) == list(shape)
                    and all(r.get(k) == v for k, v in match.items())):
                return r["name"]
        return None

    covered = {}

    def new_scan_shapes(kernel, by_shape):
        """The (mode, shape) entries of ``by_shape`` that no row of
        ``kernel`` has (its rows' mode and shape)."""
        have = {(json.dumps(r.get("mode"), sort_keys=True), tuple(r["shape"]))
                for r in rows if r["name"].startswith(kernel + "[")}
        out = {}
        for (mode_name, shape_), k_ in by_shape.items():
            key = (json.dumps(scan_kw[mode_name], sort_keys=True), tuple(shape_))
            if key not in have:
                out[(mode_name, shape_)] = k_
            else:
                covered[f"{kernel} {mode_name} {list(shape_)}"] = "a padd_scan row"
        return out

    def tail_add_row(curve, tag, path, nb_, n_launches, batch=D):
        """``padd`` (G2: ``padd2``) at the batched tail's widest call, 2 nb
        lanes for each of the ``batch`` chunks."""
        kernel_, F_, tiled_, elem_ = (("padd2", FQ2_PLAIN, tiled_affine_g2, 48) if curve == "g2"
                                      else ("padd", FQ_PLAIN, tiled_affine, 24))
        shape_ = ([24, 2] if curve == "g2" else [24]) + [batch, 2 * nb_]
        have_ = row_at(kernel_, shape_)
        if have_:
            covered[f"{kernel_} {shape_} ({tag})"] = have_
            return
        A_ = tiled_(batch * 2 * nb_)
        P_ = tuple(c.reshape(shape_) for c in contig(pj.proj_double(F_, pj.affine_to_proj(F_, A_))))
        Q_ = tuple(c.reshape(shape_) for c in contig(pj.affine_to_proj(F_, roll(A_, 1))))
        kern_, plain_ = ((cuda_g2.padd2, cuda_g2.padd2_plain) if curve == "g2"
                         else (cuda_g1.padd, cuda_g1.padd_plain))
        kernel_row(f"{kernel_}[{tag}]", f"{kernel_}_kernel",
                   G2_SRC + "g2_padd.cu" if curve == "g2" else G1_SRC,
                   "tpu_bls12_381/curves/pallas_g2.py:201" if curve == "g2"
                   else "tpu_bls12_381/curves/pallas_g1.py:465", shape_,
                   lambda: kern_(P_, Q_), lambda: plain_(P_, Q_),
                   9 * elem_ * batch * 2 * nb_, 0,
                   batch * 2 * nb_ * (36 if curve == "g2" else 12) * mul_mads(W_FQ), 20,
                   n_launches=n_launches, path=path)

    def chain_rows(curve, tag, path, by_times, batch=D):
        """``pdbl`` (G2: ``pdbl2``) on the ``batch`` lanes of the chunks'
        points at each chain length the path ran that no row has, with the
        path's launches of that length."""
        kernel_ = "pdbl2" if curve == "g2" else "pdbl"
        shape_ = [24, 2, batch] if curve == "g2" else [24, batch]
        P_ = proj_points((batch,), curve)
        kern_, plain_ = ((cuda_g2.pdbl2, cuda_g2.pdbl2_plain) if curve == "g2"
                         else (cuda_g1.pdbl, cuda_g1.pdbl_plain))
        for times, k_ in sorted(by_times.items()):
            have_ = row_at(kernel_, shape_, times=times)
            if have_:
                covered[f"{kernel_} times={times} ({tag})"] = have_
                continue
            kernel_row(f"{kernel_}[{tag}: times {times}]", f"{kernel_}_kernel",
                       G2_SRC + "g2_pdbl.cu" if curve == "g2" else G1_SRC,
                       "tpu_bls12_381/curves/pallas_g2.py:219" if curve == "g2"
                       else "tpu_bls12_381/curves/pallas_g1.py:478", shape_,
                       lambda: kern_(P_, times), lambda: plain_(P_, times),
                       6 * (48 if curve == "g2" else 24) * batch, 0,
                       batch * times * (dbl2_mads if curve == "g2" else dbl_mads), 50,
                       n_launches=k_, path=path, times=times,
                       equal_at_2e16=chain_equal(times, curve))

    path_s = "parallel: msm_g1_sharded, 4 chunks of 2^18 as one batch"
    path_f = "parallel: msm_g1_sharded factor 2, 4 chunks of 2^18 as one batch"
    path_2 = "parallel: msm_g2_sharded, 4 chunks of 2^18 as one batch"
    # the scan folds the D chunks into its lanes: one launch over D x L columns
    scan_row_g1("pmadd_signed[parallel]", path_s, geo_c["R"], D * geo_c["L"],
                launches_s.get("pmadd_signed", 0))
    fresh = new_scan_shapes("padd_scan", scans_s)
    scan_rows("parallel", path_s, fresh, sum(fresh.values()))
    if row_at("pmadd_signed", [geo_f["R"], 24, D * geo_f["L"]]):
        covered[f"pmadd_signed {[geo_f['R'], 24, D * geo_f['L']]} (factor 2)"] = row_at(
            "pmadd_signed", [geo_f["R"], 24, D * geo_f["L"]])
    else:
        scan_row_g1("pmadd_signed[parallel factor2]", path_f, geo_f["R"], D * geo_f["L"],
                    launches_f.get("pmadd_signed", 0))
    fresh_f = new_scan_shapes("padd_scan", scans_f)
    scan_rows("parallel factor2", path_f, fresh_f, sum(fresh_f.values()))
    tail_add_row("g1", "parallel", path_s, geo_c["nb"], launches_s.get("padd", 0))
    tail_add_row("g1", "parallel factor2", path_f, geo_f["nb"], launches_f.get("padd", 0))
    chain_rows("g1", "parallel", path_s, chains_s)
    chain_rows("g1", "parallel factor2", path_f, chains_f)
    # the combine: sum_reduce of the 4 chunk points, jadd on 2 lanes then 1
    # (no lane with P == Q, so the add alone bounds it)
    for lanes_, Jl_, Jr_ in ((2, contig(c[:, :2] for c in P_chunks),
                              contig(c[:, 2:] for c in P_chunks)),
                             (1, contig(c[:, :1] for c in P_chunks),
                              contig(c[:, 1:2] for c in P_chunks))):
        kernel_row(f"jadd[parallel: {lanes_} lane{'s' if lanes_ > 1 else ''}]", "jadd_kernel",
                   JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:252", [24, lanes_],
                   lambda: cuda_g1.jadd(Jl_, Jr_), lambda: cuda_g1.jadd_plain(Jl_, Jr_),
                   9 * 24 * lanes_, 0, lanes_ * jadd_add_mads, 20, n_launches=1,
                   path=f"{path_s}: the combine of the chunk points (one launch a "
                        f"round; the factor-2 run the same)", equal=True,
                   bound_ms_with_doubling=bound(9 * 24 * lanes_ * LIMB_BYTES,
                                                lanes_ * jadd_mads)[0])
    del P_chunks
    scan_row_g2("pmadd2[parallel]", path_2, geo_c2["R"], D * geo_c2["L"],
                launches_2s.get("pmadd2", 0))
    fresh2 = new_scan_shapes("padd2_scan", scans_2s)
    scan_rows("parallel", path_2, fresh2, sum(fresh2.values()), curve="g2")
    tail_add_row("g2", "parallel", path_2, geo_c2["nb"], launches_2s.get("padd2", 0))
    chain_rows("g2", "parallel", path_2, chains_2s)
    for curve_, path_ in (("g1", "parallel: the G1 runs"), ("g2", path_2)):
        for (key, shape), k_ in sorted(shapes_par[curve_].items()):
            have_ = row_at(key, shape)
            if have_:
                covered[f"{key} {list(shape)}"] = have_
            else:
                addsub_row(key, shape, k_, f"{path_}, {k_} calls at this shape")
    emit({"phase": "parallel", "what": "kernel shapes that a row already held",
          "covered": covered})
    if args.upto == "parallel":
        return stop_early()

    # -------------------------------------------------------------- points_2e20
    # SRS point validation, what a prover runs on an SRS it has read as bytes:
    # 2^20 G1 points (a K=20 circuit's SRS) written to wire bytes and read back
    # on the card, checked on the curve and in the r-torsion, the members
    # summed; scalar_mul routed through the Jacobian kernels against the
    # generic formulas; then G2 on 1,028 lanes through the generic Fq2 path.
    P_MOD, R_MOD = constants.FQ_MODULUS, constants.FR_MODULUS
    F1g = FqAdapter(FQ)            # the same field kernels, not routed to the Jacobian kernels

    def generic_launches(fq2, bits):
        """The field launches of ``bits`` steps of ``points.scalar_mul``'s
        generic loop, from the formulas' text: a step is ``jac_double`` (5 S,
        2 M, 2 adds, 5 subs, 7 doublings) and ``jac_add_affine`` (4 S, 7 M,
        1 add, 9 subs, 5 doublings and a ``jac_double`` of its own).  On Fq
        an S is a ``mont_sqr``; on Fq2 an M is Karatsuba (2 adds, a product,
        3 subs) and an S the complex squaring (an add, a sub, a product, a
        doubling)."""
        S, M, A_, B_, D_ = 2 * 5 + 4, 2 * 2 + 7, 2 * 2 + 1, 2 * 5 + 9, 2 * 7 + 5
        per = ({"add_fq": A_ + S + 2 * M, "sub_fq": B_ + S + 3 * M, "mont_mul_fq": S + M,
                "double_fq": D_ + S} if fq2 else
               {"add_fq": A_, "sub_fq": B_, "mont_mul_fq": M, "mont_sqr_fq": S, "double_fq": D_})
        return {k: v * bits for k, v in per.items()}

    def g1_non_members(count):
        """Curve points outside G1: x = 5, 6, ... with x^3 + 4 a square."""
        out, x = [], 5
        while len(out) < count:
            rhs = (x ** 3 + 4) % P_MOD
            y = pow(rhs, (P_MOD + 1) // 4, P_MOD)       # p = 3 mod 4
            if y * y % P_MOD == rhs:
                out.append((x, y))
            x += 1
        return out

    def fq2_sqrt(a):
        """A square root in Fq2 (p = 3 mod 4), or None."""
        sq = lambda v: pow(v, (P_MOD + 1) // 4, P_MOD)
        norm = (a[0] * a[0] + a[1] * a[1]) % P_MOD
        alpha = sq(norm)
        if alpha * alpha % P_MOD != norm:
            return None
        half = pow(2, P_MOD - 2, P_MOD)
        for d in ((a[0] + alpha) * half % P_MOD, (a[0] - alpha) * half % P_MOD):
            x0 = sq(d)
            if x0 and x0 * x0 % P_MOD == d:
                x1 = a[1] * pow(2 * x0, P_MOD - 2, P_MOD) % P_MOD
                if oracle.fq2_sqr((x0, x1)) == (a[0] % P_MOD, a[1] % P_MOD):
                    return (x0, x1)
        return None

    def g2_non_members(count):
        """Points of E'(Fq2) outside G2: x = c + u with x^3 + 4(1+u) a square."""
        out, c = [], 1
        while len(out) < count:
            x = (c, 1)
            y = fq2_sqrt(oracle.fq2_add(oracle.fq2_mul(oracle.fq2_sqr(x), x), (4, 4)))
            if y is not None:
                out.append((x, y))
            c += 1
        return out

    def timed(fn, phase="points_2e20"):
        """(result, seconds, launches by kernel) of one call, counts from 0."""
        reset_counts()
        torch.cuda.synchronize()
        t0_ = time.perf_counter()
        with guarded(phase):
            out_ = fn()
            torch.cuda.synchronize()
        return out_, time.perf_counter() - t0_, {k: v for k, v in counts().items() if v}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nm_lanes = [5, n // 15, n // 2 + 1, n - 3]          # planted non-members
    off_lanes = [17, n // 8 + 3, 3 * n // 4 + 1, n - 2]  # planted off-curve (y + 1)
    id_lane = n - 1
    Av = [c.clone() for c in tiled_affine(n)]
    planted = g1.affine_from_ints(
        g1_non_members(4) + [(base_pts[l % M][0], (base_pts[l % M][1] + 1) % P_MOD)
                             for l in off_lanes], device=dev)
    lanes_t = torch.tensor(nm_lanes + off_lanes, device=dev)
    for c in range(2):
        Av[c][:, lanes_t] = planted[c]
        Av[c][:, id_lane] = 0
    Av[2][id_lane] = True
    t0 = time.perf_counter()
    wire_g1 = wire.g1_affine_to_bytes(*Av)
    to_bytes_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A = wire.g1_affine_from_bytes(wire_g1, device=dev)
    torch.cuda.synchronize()
    from_bytes_s = time.perf_counter() - t0
    bytes_ok = len(wire_g1) == 96 * n and trees_equal(A, Av)
    del Av, planted
    want_on = torch.ones(n, dtype=torch.bool)
    want_on[off_lanes] = False
    want_sub = want_on.clone()
    want_sub[nm_lanes] = False
    on, on_s, launches_on = timed(
        lambda: pt.is_on_curve_affine(FQ_ADAPTER, A, g1.b_mont((n,), dev)))
    sub, sub_s, launches_sub = timed(lambda: pt.is_in_subgroup(FQ_ADAPTER, A))
    masks_ok = torch.equal(on.cpu(), want_on) and torch.equal(sub.cpu(), want_sub)
    valid = on & sub
    A_valid = (A[0], A[1], A[2] | ~valid)
    S, sum_s, launches_sum = timed(
        lambda: pt.sum_reduce(FQ_ADAPTER, pt.affine_to_jac(FQ_ADAPTER, A_valid)))
    k_members = ((n // M) * sum(int(k) for k in ks)
                 - sum(int(ks[l % M]) for l in nm_lanes + off_lanes + [id_lane]))
    want_sum = oracle.jac_to_affine(
        oracle.scalar_mul(k_members % R_MOD, G, oracle.FQ_OPS), oracle.FQ_OPS)
    sum_ok = g1_ints(tuple(c[:, None] for c in S)) == want_sum
    # scalar_mul on 256 lanes: routed (one jac_ladder launch, per-lane
    # scalars, so a warp adds where any of its lanes has the bit) and generic
    # (field kernels and torch ops), same tensors, same limbs
    k256 = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(256)]
    k256[:2] = [0, R_MOD - 1]
    k256_t = torch.from_numpy(ints_to_limbs(k256, 16).astype(np.int32)).to(dev)
    A256 = tuple(c[..., :256].contiguous() for c in A)
    R_routed, routed_s, launches_sm = timed(lambda: pt.scalar_mul(FQ_ADAPTER, k256_t, A256))
    R_gen, generic_s, launches_gen = timed(lambda: pt.scalar_mul(F1g, k256_t, A256))
    probe = [0, 1, 2, 255]
    routed_ok = (trees_equal(R_routed, R_gen)
                 and g1.jacobian_to_ints(tuple(c[:, probe] for c in R_routed)) == [
                     oracle.jac_to_affine(oracle.scalar_mul(k256[l], base_pts[l % M],
                                                            oracle.FQ_OPS), oracle.FQ_OPS)
                     for l in probe])
    peak_pts = torch.cuda.max_memory_allocated()
    del S, R_routed, R_gen

    # G2: the 1,024 host points, 2 planted non-members, 2 off-curve (y + 1)
    pts2 = (list(base_pts2) + g2_non_members(2)
            + [(p[0], oracle.fq2_add(p[1], (1, 0))) for p in base_pts2[:2]])
    n2 = len(pts2)
    wire_g2 = wire.g2_affine_to_bytes(*g2.affine_from_ints(pts2, device=dev))
    A2 = wire.g2_affine_from_bytes(wire_g2, device=dev)
    want_on2 = torch.tensor([True] * (n2 - 2) + [False] * 2)
    want_sub2 = torch.tensor([True] * (n2 - 4) + [False] * 4)
    on2, on2_s, _ = timed(lambda: pt.is_on_curve_affine(FQ2_ADAPTER, A2, g2.b_mont((n2,), dev)))
    sub2, sub2_s, launches_sub2 = timed(lambda: pt.is_in_subgroup(FQ2_ADAPTER, A2))
    masks2_ok = torch.equal(on2.cpu(), want_on2) and torch.equal(sub2.cpu(), want_sub2)
    A2_valid = (A2[0], A2[1], A2[2] | ~(on2 & sub2))
    S2, sum2_s, _ = timed(lambda: pt.sum_reduce(FQ2_ADAPTER, pt.affine_to_jac(FQ2_ADAPTER, A2_valid)))
    want_sum2 = oracle.jac_to_affine(
        oracle.scalar_mul(sum(int(k) for k in ks2) % R_MOD, G2gen, oracle.FQ2_OPS),
        oracle.FQ2_OPS)
    sum2_ok = g2_ints(S2) == want_sum2
    g2_generic = not any(launches_sub2.get(k) for k in ("madd", "jadd", "jdbl"))
    points_ok = (bytes_ok and masks_ok and sum_ok and routed_ok and masks2_ok
                 and sum2_ok and g2_generic)
    emit({"phase": "points_2e20", "n": n, "equal": bool(points_ok),
          "wire_roundtrip": bytes_ok, "masks_as_planted": masks_ok,
          "sum_of_members": sum_ok, "scalar_mul_routed_equals_generic": routed_ok,
          "g2_masks_as_planted": masks2_ok, "g2_sum_of_members": sum2_ok,
          "wire_bytes": len(wire_g1), "seconds_to_bytes": to_bytes_s,
          "seconds_from_bytes": from_bytes_s, "seconds_is_on_curve": on_s,
          "seconds_is_in_subgroup": sub_s, "seconds_sum_reduce": sum_s,
          "seconds_scalar_mul_256_routed": routed_s,
          "seconds_scalar_mul_256_generic": generic_s,
          "g1_points_validated_per_s": n / (on_s + sub_s),
          "launches_is_on_curve": launches_on, "launches_is_in_subgroup": launches_sub,
          "launches_sum_reduce": launches_sum, "launches_scalar_mul_routed": launches_sm,
          "launches_scalar_mul_generic": launches_gen, "peak_bytes_allocated": peak_pts,
          "g2_lanes": n2, "g2_seconds_is_on_curve": on2_s,
          "g2_seconds_is_in_subgroup": sub2_s, "g2_seconds_sum_reduce": sum2_s,
          "g2_launches_is_in_subgroup": launches_sub2, "card": smi})
    if not points_ok:
        raise AssertionError("points_2e20: a check failed (see the line above)")
    # is_in_subgroup is one jac_ladder launch (no jdbl or madd a bit), the
    # 256-lane scalar_mul too, sum_reduce one jadd a round
    ladder_only = lambda l_: (l_.get("jac_ladder"), l_.get("jdbl", 0), l_.get("madd", 0))
    if (ladder_only(launches_sub), ladder_only(launches_sm), launches_sum.get("jadd")) != (
            (1, 0, 0), (1, 0, 0), 20):
        raise AssertionError(f"points_2e20: the Jacobian kernels were not launched as the "
                             f"ladder and the tree need: {launches_sub}, {launches_sm}, "
                             f"{launches_sum}")
    # the generic ladders (G2's is_in_subgroup, G1's scalar_mul through a
    # fresh FqAdapter) launch the field kernels their formulas call, the
    # doublings among them, and nothing else
    want_gen = (generic_launches(True, 255), generic_launches(False, 255))
    if (launches_sub2, launches_gen) != want_gen:
        raise AssertionError(f"points_2e20: the generic ladders launched {launches_sub2} "
                             f"(G2) and {launches_gen} (G1), the formulas call {want_gen}")
    # the doubling and the negation at the G2 validation shape
    addsub_row("double_fq", (24, 2, n2), launches_sub2["double_fq"],
               "points_2e20: is_in_subgroup of 1,028 G2 points (generic Fq2 formulas)")
    addsub_row("neg_fq", (24, 2, n2), 0,
               "points_2e20: the G2 validation shape (the path negates in to_affine: the "
               "neg_fq[to_affine] row)")
    del A2, A2_valid, S2, on2, sub2

    # ----------------- the Jacobian kernels at N = 2^16 with the edge lanes, and
    # at the shapes points_2e20 gives them.  Since the ladder, no driven path
    # launches madd or jdbl (their routers, jac_add_affine_fast and
    # jac_double_fast, have no caller there): their rows say 0 launches.
    jdbl_mads = 2 * mul_mads(W_FQ) + 5 * sqr_mads(W_FQ)
    madd_mads = 9 * mul_mads(W_FQ) + 9 * sqr_mads(W_FQ)
    # The doubling inside madd and jadd serves only the P == A (P == Q) lanes,
    # and both compute it only in a warp that holds such a lane.  madd's rows
    # have no such lane past warp 0, so their bound is the add alone (7M + 4S),
    # with the bound of the sum and the doubling (9M + 9S) beside it.  jadd's
    # rows have them in most warps (the edge lanes; on sum_reduce's first
    # round every lane, since the tiled points repeat every 4096 lanes): their
    # bound counts the doubling, the add alone (11M + 5S) beside it.
    madd_add_mads = 7 * mul_mads(W_FQ) + 4 * sqr_mads(W_FQ)
    madd_with = lambda lanes: bound(8 * 24 * lanes * LIMB_BYTES + lanes,
                                    lanes * madd_mads)[0]
    jadd_alone = lambda lanes: bound(9 * 24 * lanes * LIMB_BYTES, lanes * jadd_add_mads)[0]
    jac_ptxas = lambda kernel: {k: v for k, v in registers.items() if kernel in k}
    Pj, Qj, Aj = jac_edge_cases(N)
    edge = "kernels: N = 2^16 with the edge lanes (launches: points_2e20's)"
    no_path = ("kernels: N = 2^16 with the edge lanes (no driven path launches it since "
               "the ladder)")
    kernel_row("madd[edge]", "madd_kernel", JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:180",
               [24, N], lambda: cuda_g1.madd(Pj, Aj), lambda: cuda_g1.madd_plain(Pj, Aj),
               8 * 24 * N, N, N * madd_add_mads, 20, n_launches=launches_sub.get("madd", 0),
               path=no_path, equal=True, bound_ms_with_doubling=madd_with(N))
    kernel_row("jadd[edge]", "jadd_kernel", JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:252",
               [24, N], lambda: cuda_g1.jadd(Pj, Qj), lambda: cuda_g1.jadd_plain(Pj, Qj),
               9 * 24 * N, 0, N * jadd_mads, 20, n_launches=launches_sum["jadd"],
               path=edge, equal=True, bound_ms_without_doubling=jadd_alone(N))
    kernel_row("jdbl[edge]", "jdbl_kernel", JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:156",
               [24, N], lambda: cuda_g1.jdbl(Pj), lambda: cuda_g1.jdbl_plain(Pj),
               6 * 24 * N, 0, N * jdbl_mads, 20, n_launches=launches_sub.get("jdbl", 0),
               path=no_path, equal=True)
    del Pj, Qj, Aj

    # The ladder (is_in_subgroup in one launch).  Its bound counts the work
    # these inputs need: num_bits doublings a lane and a mixed add (the add
    # alone) for each set bit of each lane's scalar; it moves A, the mask, the
    # scalar limbs once and the result.  Edge lanes at 2^16, per-lane scalars
    # (k = 0, 1, r - 1, r, r + 2, 2^255 - 1 on members; A's inf; two
    # non-members at r and r + 2; r + 2 also in warp 1 and in the last lanes,
    # where the accumulator meets P == A), held to the plain ladder (some
    # 40 s on the card, timed once).
    def ladder_row(name, k_, A_, ks_, path, plain_lanes=None):
        lanes = A_[0].shape[-1]
        adds = sum(bin(v % (1 << 255)).count("1") for v in ks_) * (lanes // len(ks_))
        cut = lambda t: t if plain_lanes is None else t[..., :plain_lanes].contiguous()
        kernel_row(name, "jac_ladder_kernel", JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:156",
                   [24, lanes], lambda: cuda_g1.jac_ladder(k_, A_, 255),
                   lambda: cuda_g1.jac_ladder_plain(
                       k_ if k_.shape[-1] == 1 else cut(k_), tuple(cut(c) for c in A_), 255),
                   2 * 24 * lanes + 3 * 24 * lanes + k_.numel(), lanes,
                   lanes * 255 * jdbl_mads + adds * madd_add_mads, 3,
                   n_launches=launches_sub["jac_ladder"], path=path, equal=True,
                   replaces_with="tpu_bls12_381/curves/pallas_g1.py:180, a launch of each "
                                 "a bit in tpu_bls12_381/curves/points.py:242",
                   num_bits=255, set_bits=adds, scalars=f"{tuple(k_.shape)}",
                   ptxas=jac_ptxas("jac_ladder"), plain_lanes=plain_lanes)

    A16 = [c.clone() for c in tiled_affine(N)]
    nm16 = g1.affine_from_ints(g1_non_members(2), device=dev)
    for c in range(2):
        A16[c][:, 7:9] = nm16[c]
        A16[c][:, 6] = 0
    A16[2][6] = True
    A16 = contig(A16)
    ks16 = [0, 1, R_MOD - 1, R_MOD, R_MOD + 2, (1 << 255) - 1, 5, R_MOD, R_MOD + 2]
    ks16 += [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(N - len(ks16))]
    for l_ in (40, N - 1):
        ks16[l_] = R_MOD + 2
    k16 = torch.from_numpy(ints_to_limbs(ks16, 16).astype(np.int32)).to(dev)
    ladder_row("jac_ladder[edge]", k16, A16, ks16,
               "kernels: N = 2^16 with the edge lanes, per-lane scalars (launches: "
               "points_2e20's is_in_subgroup)")
    probe = [0, 1, 2, 3, 4, 5, 9, 40, N - 1]
    got16 = g1.jacobian_to_ints(tuple(c[:, probe] for c in cuda_g1.jac_ladder(k16, A16, 255)))
    if got16 != [oracle.jac_to_affine(oracle.scalar_mul(ks16[l_], base_pts[l_ % M],
                                                         oracle.FQ_OPS), oracle.FQ_OPS)
                 for l_ in probe]:
        raise AssertionError("jac_ladder[edge]: the probed lanes differ from the host's")
    del A16, k16
    r_col = torch.from_numpy(ints_to_limbs([R_MOD], 16).astype(np.int32)).to(dev)
    # Held to the plain ladder on its first 2^14 lanes (2^20 of it took 99 s);
    # the masks of every lane are points_2e20's gate.
    ladder_row("jac_ladder", r_col, A, [R_MOD],
               "points_2e20: is_in_subgroup, one launch, r read from one column",
               plain_lanes=1 << 14)
    # the ladder's accumulator is a Jacobian batch with Z != 1: 2A here
    Pbig = contig(cuda_g1.jdbl_plain(pt.affine_to_jac(FQ_PLAIN, A)))
    kernel_row("madd", "madd_kernel", JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:180",
               [24, n], lambda: cuda_g1.madd(Pbig, A), lambda: cuda_g1.madd_plain(Pbig, A),
               8 * 24 * n, n, n * madd_add_mads, 10, n_launches=launches_sub.get("madd", 0),
               path="jac_add_affine_fast at is_in_subgroup's shape (the ladder runs its "
                    "lane body; no driven path launches it)", equal=True,
               bound_ms_with_doubling=madd_with(n))
    kernel_row("jdbl", "jdbl_kernel", JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:156",
               [24, n], lambda: cuda_g1.jdbl(Pbig), lambda: cuda_g1.jdbl_plain(Pbig),
               6 * 24 * n, 0, n * jdbl_mads, 10, n_launches=launches_sub.get("jdbl", 0),
               path="jac_double_fast at is_in_subgroup's shape (the ladder runs its "
                    "lane body; no driven path launches it)", equal=True,
               ptxas=jac_ptxas("jdbl"))
    Jl = tuple(c[:, :n // 2].contiguous() for c in Pbig)
    Jr = tuple(c[:, n // 2:].contiguous() for c in Pbig)
    del Pbig
    kernel_row("jadd", "jadd_kernel", JAC_SRC, "tpu_bls12_381/curves/pallas_g1.py:252",
               [24, n // 2], lambda: cuda_g1.jadd(Jl, Jr), lambda: cuda_g1.jadd_plain(Jl, Jr),
               9 * 24 * (n // 2), 0, (n // 2) * jadd_mads, 10,
               n_launches=launches_sum["jadd"],
               path="points_2e20: sum_reduce, its first round of 20 (P == Q in every lane)",
               equal=True, bound_ms_without_doubling=jadd_alone(n // 2),
               ptxas=jac_ptxas("jadd"))
    del Jl, Jr
    torch.cuda.empty_cache()
    if args.upto == "points_2e20":
        return stop_early()

    # -------------------------------------------------------------------- entry
    # The README's Quick start through the port, on the points validated above,
    # with MIDNIGHT_TRACE=msm,ntt so that the spans are logged; then the
    # host-int surface (dispatch_*) a consumer without tensors calls.
    spans = []
    timed_e = lambda fn: timed(fn, "entry")
    rdv = lambda r: r.route.value if r.error is None else f"{r.route.value}: {r.error!r}"

    class SpanLog(logging.Handler):
        def emit(self, record):
            spans.append(record.getMessage())

    trace_log = logging.getLogger("tpu_bls12_381_torch.trace")
    trace_log.setLevel(logging.INFO)
    span_log = SpanLog()
    trace_log.addHandler(span_log)
    os.environ["MIDNIGHT_TRACE"] = "msm,ntt"
    reset_config_cache()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        acc = global_accelerator()
        info = backend_info()
        t0 = time.perf_counter()
        with guarded("entry"):
            acc.warmup(n=n, factor=4, ntt_log_n=NTT_LOG_N)   # 2^20 points, 2^22
            torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        # scalars as wire bytes, standard form (the msm_2e20 phase's values)
        s_entry = wire.scalars_from_bytes(np.ascontiguousarray(words.T).tobytes(), device=dev)
        bases4, upload4_s, launches_up4 = timed_e(
            lambda: acc.g1.upload_bases(A_valid, precompute_factor=4))
        geo4 = msm_geometry(n, bases4.glv, F1, dev, bases4.window_bits,
                            factor=bases4.factor, cached=True)
        m_up4 = int(bases4.A[2].shape[-1]) // bases4.factor
        span_up4 = geo4["T"] * geo4["w"]
        check_upload("entry: upload_bases, factor 4", launches_up4,
                     -(-m_up4 // expand_cap), bases4.factor, span_up4)
        P_e, call4_s, launches_e4 = timed_e(
            lambda: acc.g1.msm_with_bases(s_entry, bases4, scalars_montgomery=False))
        scans_e4 = scan_counts()
        chains_e4 = chain_counts()
        with guarded("entry"):
            handle = acc.g1.msm_with_bases_async(s_entry, bases4, scalars_montgomery=False)
            P_async = handle.wait()
            secs4 = [tracing.timed_reps(1, lambda: acc.g1.msm_with_bases(
                s_entry, bases4, scalars_montgomery=False)) for _ in range(3)]
        bad = nm_lanes + off_lanes + [id_lane]
        s_words = [sum(int(words[wi, l]) << (64 * wi) for wi in range(4)) for l in bad]
        k_entry = (host_scalar_total(ks)
                   - sum(s * int(ks[l % M]) for s, l in zip(s_words, bad))) % R_MOD
        want_e = oracle.jac_to_affine(oracle.scalar_mul(k_entry, G, oracle.FQ_OPS), oracle.FQ_OPS)
        msm4_ok = g1_ints(P_e) == want_e and g1_ints(P_async) == want_e
        # standard-form scalars: no from_mont, so no mont_mul_fr on this path
        msm4_launched = (launches_e4.get("pmadd_signed") == geo4["scan_launches"]
                         and all(launches_e4.get(k) for k in ("padd", "pdbl")))
        del P_e, P_async, s_entry
        # NTT round trip at 2^22 through acc.ntt
        x_std = rand_field(FR, n22)
        xe = fr_mont(x_std)
        ye, fwd_s, launches_fwd = timed_e(lambda: acc.ntt.forward(xe))
        back, inv_s, _ = timed_e(lambda: acc.ntt.inverse(ye))
        ntt_ok = (torch.equal(back, xe)
                  and fr_ints(ye[:, :1])[0] == limb_sum(x_std.cpu().numpy().astype(np.int64)) % R_MOD)
        del xe, ye, back, x_std
        # dispatch_msm from Python ints: G1 at 2^16, G2 at 2^15 points
        n16, n15 = 1 << 16, 1 << 15
        sc16 = [int.from_bytes(rng.bytes(32), "little") % R_MOD for _ in range(n16)]
        res16, d16_s, launches_d16 = timed_e(
            lambda: dispatch_msm(sc16, [base_pts[i % M] for i in range(n16)]))
        want16 = oracle.jac_to_affine(oracle.scalar_mul(
            sum(s * int(ks[i % M]) for i, s in enumerate(sc16)) % R_MOD, G, oracle.FQ_OPS),
            oracle.FQ_OPS)
        res15, d15_s, launches_d15 = timed_e(
            lambda: dispatch_msm(sc16[:n15], [base_pts2[i % G2_HOST_POINTS]
                                              for i in range(n15)], "g2"))
        want15 = oracle.jac_to_affine(oracle.scalar_mul(
            sum(s * int(ks2[i % G2_HOST_POINTS]) for i, s in enumerate(sc16[:n15])) % R_MOD,
            G2gen, oracle.FQ2_OPS), oracle.FQ2_OPS)
        # dispatch_ntt at 2^14, dispatch_vecop("mul") at 2^13
        v14 = sc16[:1 << 14]
        rn, dn_s, _ = timed_e(lambda: dispatch_ntt(v14))
        rv, dv_s, _ = timed_e(lambda: dispatch_vecop("mul", sc16[:1 << 13], sc16[1 << 13:1 << 14]))
        ntt14_ok = rn.value == oracle.ntt(v14)
        vec13_ok = rv.value == [a * b % R_MOD for a, b in zip(sc16[:1 << 13], sc16[1 << 13:1 << 14])]
        # the host route under MIDNIGHT_DEVICE=cpu
        os.environ["MIDNIGHT_DEVICE"] = "cpu"
        reset_config_cache()
        try:
            rc, dc_s, launches_dc = timed_e(
                lambda: dispatch_msm(sc16[:1024], [base_pts[i] for i in range(1024)]))
        finally:
            os.environ.pop("MIDNIGHT_DEVICE")
            reset_config_cache()
        want_c = oracle.jac_to_affine(oracle.scalar_mul(
            sum(s * int(ks[i]) for i, s in enumerate(sc16[:1024])) % R_MOD, G, oracle.FQ_OPS),
            oracle.FQ_OPS)
        routes = {"msm_g1_2e16": rdv(res16), "msm_g2_2e15": rdv(res15),
                  "ntt_2e14": rdv(rn), "vecop_mul_2e13": rdv(rv), "msm_g1_1024_cpu": rdv(rc)}
        live_b, alloc_b = total_live_bytes(), torch.cuda.memory_allocated()
        peak_e = torch.cuda.max_memory_allocated()
    finally:
        trace_log.removeHandler(span_log)
        os.environ.pop("MIDNIGHT_TRACE", None)
        reset_config_cache()
    want_spans = ["g1.precompute_bases[f=4]", f"ntt.forward[n={n22}]",
                  f"ntt.inverse[n={n22}]", f"g1.msm[n={n16}]", f"g2.msm[n={n15}]"]
    spans_ok = all(any(s.startswith(w + ":") for s in spans) for w in want_spans)
    routes_ok = routes == {"msm_g1_2e16": "accel", "msm_g2_2e15": "accel", "ntt_2e14": "accel",
                           "vecop_mul_2e13": "accel", "msm_g1_1024_cpu": "cpu"}
    dispatch_ok = (res16.value == want16 and res15.value == want15 and ntt14_ok
                   and vec13_ok and rc.value == want_c)
    entry_ok = msm4_ok and msm4_launched and ntt_ok and routes_ok and dispatch_ok and spans_ok
    emit({"phase": "entry", "equal": bool(entry_ok), "backend_info": info.splitlines(),
          "msm_with_bases_factor4": msm4_ok, "msm_factor4_launches_as_planned": msm4_launched,
          "ntt_roundtrip": ntt_ok, "routes": routes,
          "dispatch_values": dispatch_ok, "spans_logged": spans_ok,
          "seconds_warmup": warmup_s, "seconds_upload_factor4": upload4_s,
          "seconds_call_factor4": call4_s, "seconds_each_factor4": secs4,
          "g1_msm_factor4_2e20_points_per_s": n / statistics.median(secs4),
          "seconds_ntt_forward": fwd_s, "seconds_ntt_inverse": inv_s,
          "seconds_dispatch_msm_g1_2e16": d16_s, "seconds_dispatch_msm_g2_2e15": d15_s,
          "seconds_dispatch_ntt_2e14": dn_s, "seconds_dispatch_vecop_2e13": dv_s,
          "seconds_dispatch_msm_cpu_1024": dc_s,
          **{f"plan_{k}": geo4[k] for k in ("glv", "factor", "n", "w", "T", "L", "R", "nb",
                                           "pieces", "scan_launches")},
          "launches_upload": launches_up4, "launches_call": launches_e4,
          "launches_ntt_forward": launches_fwd, "launches_dispatch_g1": launches_d16,
          "launches_dispatch_g2": launches_d15, "launches_dispatch_cpu": launches_dc,
          "total_live_bytes": live_b, "memory_allocated": alloc_b,
          "peak_bytes_allocated": peak_e, "spans": spans[:12], "card": smi})
    if not entry_ok:
        raise AssertionError("entry: a check failed (see the line above)")
    check_tail("entry: msm_with_bases, factor 4", launches_e4, geo4, chains_e4)
    if launches_dc:
        raise AssertionError(f"entry: the host route launched kernels: {launches_dc}")
    if not (launches_d16.get("pmadd_signed") and launches_d15.get("pmadd2")):
        raise AssertionError(f"entry: dispatch_msm ran no scan on the card: "
                             f"{launches_d16}, {launches_d15}")
    if launches_d16.get("field_inv_fq") != 1 or launches_d15.get("field_inv_fq") != 1:
        raise AssertionError(f"entry: dispatch_msm's affine result is not one field_inv "
                             f"launch: {launches_d16}, {launches_d15}")
    del bases4, A, A_valid, on, sub, valid
    torch.cuda.empty_cache()
    # the MSM kernels at the factor-4 plan's shapes
    scan_row_g1("pmadd_signed[factor4]", "entry: msm_with_bases, factor 4", geo4["R"],
                geo4["L"], launches_e4["pmadd_signed"])
    scan_rows("factor4", "entry: msm_with_bases, factor 4", scans_e4,
              launches_e4["padd_scan"])
    nl4 = 2 * geo4["nb"]
    Al4 = tiled_affine(nl4)
    Pl4 = contig(pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, Al4)))
    Ql4 = contig(pj.affine_to_proj(FQ_PLAIN, roll(Al4, 1)))
    kernel_row("padd[factor4]", "padd_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:465", [24, nl4],
               lambda: cuda_g1.padd(Pl4, Ql4), lambda: cuda_g1.padd_plain(Pl4, Ql4),
               9 * 24 * nl4, 0, nl4 * 12 * mul_mads(W_FQ), 20,
               n_launches=launches_e4["padd"], path="entry: msm_with_bases, factor 4")
    del Al4, Pl4, Ql4
    nup4 = min(m_up4, expand_cap)
    Pup4 = contig(pj.affine_to_proj(FQ_PLAIN, tiled_affine(nup4)))
    kernel_row("pdbl[upload factor4]", "pdbl_kernel", G1_SRC,
               "tpu_bls12_381/curves/pallas_g1.py:478", [24, nup4],
               lambda: cuda_g1.pdbl(Pup4, span_up4),
               lambda: cuda_g1.pdbl_plain(Pup4, span_up4),
               6 * 24 * nup4, 0, nup4 * span_up4 * dbl_mads, 3,
               n_launches=launches_up4["pdbl"], path="entry: upload_bases, factor 4",
               times=span_up4, equal_at_2e16=chain_equal(span_up4))
    del Pup4
    torch.cuda.empty_cache()

    check_plain_guard()
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1)})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
