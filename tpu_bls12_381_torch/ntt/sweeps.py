"""Design sweeps of the NTT's two kernels on the card (the tile, ``ntt_tile``,
and the ladder's stages, ``butterfly_stages``), kept apart from
``chip_smoke.py``: they time builds that are not kept, and settle choices that
PERF.md records.

Run from the repository's root on a machine with a CUDA card and ``nvcc``:

    python3 -m tpu_bls12_381_torch.ntt.sweeps

It prints one JSON object a sweep, each at the 2^22 NTT's shapes, and then the
card's name and power limit as ``nvidia-smi`` gives them:

- ``ntt_fold``: the four-step's tile reading its rows as columns where they
  lie (kept) against the transposed copy and the tile on laid-out rows; the
  tile writing its rows transposed (a build not kept) against the tile and
  the copy after it; the ladder's tile reading bit-reversed columns (kept)
  against the bit-reverse gather and the tile on bit-reversed rows.
- ``ntt_builds``: builds not kept, each compiled from a copy of ``csrc/`` with
  statements changed (under ``sweeps/`` in the kernels' cache directory), against the kept build in turns (kept, other, other,
  kept), the outputs held equal: eight values a thread, field.cuh's add and
  subtract, and the stages kernel at one block an SM.
- ``butterfly_sass``: the SASS instructions of one butterfly, of its product
  and of its sum and difference (``cuobjdump -sass`` of a probe: the kernel
  that runs two in a row less the kernel that runs one), the stages kernel's
  own instruction mix, and the rate of a loop of butterflies on registers
  alone.

Times are medians of CUDA events around each call.  Every output is held
equal to the kept build's, or the script raises.  Exits 1 where no card is
visible.
"""

from __future__ import annotations

import atexit
import ctypes
import importlib
import json
import re
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..constants import FR_MODULUS
from ..fields import FR, cuda_ops
from ..vecops import bit_reverse
from . import cuda_ntt
from .domain import get_domain

# The module (the package's ``ntt`` attribute is the function).
ntt_mod = importlib.import_module("tpu_bls12_381_torch.ntt.ntt")

LOG_N = 22
SEED = 20


def _sweep_dir() -> Path:
    """Where the builds not kept go: ``sweeps/`` in the kernels' cache."""
    return _build.cache_dir() / "sweeps"


# Builds not kept: (name, source, [(file in csrc/, statement, replacement)]).
_PLAIN_ADD = [("ntt.cuh", "ntt_bf1<EB == 2>(", "ntt_bf1<false>("),
              ("ntt.cuh", "ntt_bf<EB == 2>(", "ntt_bf<false>(")]
BUILDS = {
    "tile store transposed": ("ntt_kernels", [
        ("ntt.cuh", "(row << a.log_m) + p, v);", "(size_t)p * a.rows + row, v);")]),
    "tile: eight values a thread": ("ntt_kernels", [
        ("ntt.cuh", "return sb == NTT_SLAB_BITS ? 2 : 3;", "return 3;"),
        ("ntt_kernels.cu", "__launch_bounds__(ntt_threads(SB, tile_eb(SB)), 1)",
         "__launch_bounds__(ntt_threads(SB, tile_eb(SB)), SB == NTT_SLAB_BITS ? 2 : 1)")]),
    "tile: field.cuh's add and sub": ("ntt_kernels", _PLAIN_ADD),
    "stages: eight values a thread": ("ntt_stages", [
        ("ntt.cuh", "#define NTT_STAGES_EB 2 ", "#define NTT_STAGES_EB 3 ")]),
    "stages: field.cuh's add and sub": ("ntt_stages", _PLAIN_ADD),
    "stages: one block an SM": ("ntt_stages", [
        ("ntt_stages.cu", "__launch_bounds__(ntt_threads(NTT_SLAB_BITS, NTT_STAGES_EB), 2)",
         "__launch_bounds__(ntt_threads(NTT_SLAB_BITS, NTT_STAGES_EB), 1)")]),
}

# The probe: OPS operations of one kind in a row on one thread's registers
# (KIND 0 the butterfly, 1 the product, 2 the sum and difference), and a loop
# of butterflies on two independent pairs for the rate.
PROBE = r"""
#include <cuda_runtime.h>
#include "ntt.cuh"

template <int KIND, int OPS>
__global__ void probe(const uint32_t* x, uint32_t* out, size_t n) {
    size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fr a = fp_load<Fr>(x, n, i), b = fp_load<Fr>(x, n, (i + 1) % n);
    fr w = fp_load<Fr>(x, n, (i + 2) % n);
    UNROLL
    for (int k = 0; k < OPS; ++k) {
        if (KIND == 0) ntt_bf<true>(a, b, w);
        if (KIND == 1) a = fp_mul_cc<Fr>(a, w);
        if (KIND == 2) ntt_bf1<true>(a, b);
    }
    fp_store<Fr>(out, 2 * n, i, a);
    fp_store<Fr>(out, 2 * n, n + i, b);
}
template __global__ void probe<0, 1>(const uint32_t*, uint32_t*, size_t);
template __global__ void probe<0, 2>(const uint32_t*, uint32_t*, size_t);
template __global__ void probe<1, 1>(const uint32_t*, uint32_t*, size_t);
template __global__ void probe<1, 2>(const uint32_t*, uint32_t*, size_t);
template __global__ void probe<2, 1>(const uint32_t*, uint32_t*, size_t);
template __global__ void probe<2, 2>(const uint32_t*, uint32_t*, size_t);

__global__ void __launch_bounds__(256) bf_loop(const uint32_t* x, uint32_t* out, size_t n,
                                               int iters) {
    size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fr a0 = fp_load<Fr>(x, n, i), b0 = fp_load<Fr>(x, n, (i + 1) % n);
    fr a1 = fp_load<Fr>(x, n, (i + 2) % n), b1 = fp_load<Fr>(x, n, (i + 3) % n);
    fr w = fp_load<Fr>(x, n, (i + 4) % n);
    for (int k = 0; k < iters; ++k) {
        ntt_bf<true>(a0, b0, w);
        ntt_bf<true>(a1, b1, w);
    }
    fp_store<Fr>(out, 2 * n, i, fr_add_cc(a0, a1));
    fp_store<Fr>(out, 2 * n, n + i, fr_add_cc(b0, b1));
}

extern "C" int fr_bf_loop(const void* x, void* out, long long n, int iters, void* stream) {
    bf_loop<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, (size_t)n, iters);
    return (int)cudaGetLastError();
}
"""


def _nvcc(src: Path, out: Path, cubin: bool) -> subprocess.Popen:
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cmd = [_build.find_nvcc(), *(flags + ["-cubin"] if cubin else _build.NVCC_FLAGS),
           "-I", str(_build.CSRC_DIR), "-o", str(out), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def _start_build(name: str, source: str, changes) -> tuple[subprocess.Popen, Path]:
    """Compile ``csrc/<source>.cu`` with each statement replaced once; the
    changed files sit beside the copy of the source, so they are included
    before those of ``csrc/``."""
    dir_ = _sweep_dir() / re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
    dir_.mkdir(parents=True, exist_ok=True)
    texts = {f"{source}.cu": (_build.CSRC_DIR / f"{source}.cu").read_text()}
    for file_, old, new in changes:
        text = texts.get(file_) or (_build.CSRC_DIR / file_).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{name}: the statement to change is not in {file_} "
                                 f"once: {old!r}")
        texts[file_] = text.replace(old, new)
    for file_, text in texts.items():
        (dir_ / file_).write_text(text)
    lib = dir_ / f"lib{source}.so"
    return _nvcc(dir_ / f"{source}.cu", lib, cubin=False), lib


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"the build '{name}' failed:\n{log}")
    return log


def _ptxas(log: str) -> dict:
    """Registers and spills of each kernel in ``-Xptxas -v`` output."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return out


def _sass_counts(text: str) -> dict[str, Counter]:
    """Opcode counts of each function in ``cuobjdump -sass`` output."""
    funcs, cur = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = funcs.setdefault(m.group(1), Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and cur is not None:
            cur[m.group(2)] += 1
    return funcs


def _sass(cubin: Path) -> dict[str, Counter]:
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    return _sass_counts(subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                                       capture_output=True, text=True).stdout)


def _ms(fn, reps: int = 10) -> float:
    """Median milliseconds of one call of ``fn`` by CUDA events."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in evs)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _random_fr(n: int, dev) -> torch.Tensor:
    """(16, n) canonical elements: a top limb below r's keeps each below r."""
    rng = np.random.default_rng(SEED)
    a = rng.integers(0, 1 << 16, size=(FR.num_limbs, n), dtype=np.int64)
    a[-1] = rng.integers(0, FR_MODULUS >> 240, size=n, dtype=np.int64)
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def _bind(path: Path, like, fn: str):
    lib = ctypes.CDLL(str(path))
    getattr(lib, fn).argtypes = getattr(like, fn).argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card is visible: the sweeps run on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    stream = lambda: cuda_ops.stream_ptr(dev)
    _build.build(["field_kernels", "ntt_kernels", "ntt_stages"])
    sweep_dir = _sweep_dir()
    sweep_dir.mkdir(parents=True, exist_ok=True)
    probe_src = sweep_dir / "bf_probe.cu"
    probe_src.write_text(PROBE)
    started = {name: _start_build(name, src, ch) for name, (src, ch) in BUILDS.items()}
    probe_so = _nvcc(probe_src, sweep_dir / "libbf_probe.so", cubin=False)
    probe_cubin = _nvcc(probe_src, sweep_dir / "bf_probe.cubin", cubin=True)
    stages_cubin = _nvcc(_build.CSRC_DIR / "ntt_stages.cu", sweep_dir / "ntt_stages.cubin",
                         cubin=True)

    n = 1 << LOG_N
    x = _random_fr(n, dev)
    la, lb = cuda_ntt._split_top(LOG_N, cuda_ntt._cap_log(dev))
    nA, nB = 1 << la, 1 << lb
    c = ntt_mod.LADDER_TILE_LOG
    tiles, stages = cuda_ntt._lib(), cuda_ops._stages_lib()

    # ntt_fold
    W = cuda_ntt._step_w(LOG_N, nA, nB, False, dev)
    tw_in = get_domain(lb, dev).tw
    x4 = x.reshape(16, 1, nB, nA)
    Mc = x4[:, 0].swapaxes(1, 2).contiguous()
    Mc4 = Mc.reshape(16, nA, nB, 1)
    Yk = cuda_ntt.ntt_tile_columns(Mc4, tw_in, w=W)
    columns_equal = torch.equal(cuda_ntt.ntt_tile_columns(x4, tw_in, w=W), Yk)
    logs = {}
    logs["tile store transposed"] = _finish("tile store transposed",
                                            started["tile store transposed"][0])
    folded = _bind(started["tile store transposed"][1], tiles, "fr_ntt_tile")

    def store_transposed(out):
        cuda_ops.check_launch(folded.fr_ntt_tile(
            Mc.data_ptr(), tw_in.data_ptr(), W.data_ptr(), None, out.data_ptr(),
            nA, nA, lb, 0, 0, stream()), "tile store transposed")
        return out

    Ys = torch.empty_like(Mc)
    store_equal = torch.equal(store_transposed(Ys), Yk.swapaxes(1, 2).contiguous())
    tw_c = ntt_mod._stage_table(get_domain(LOG_N, dev).tw, LOG_N, c)
    xr = bit_reverse(x).reshape(16, -1, 1 << c)
    xc4 = x.reshape(16, 1, 1 << c, 1 << (LOG_N - c))
    brev_equal = torch.equal(cuda_ntt.ntt_tile_columns(xc4, tw_c, brev_cols=True),
                             cuda_ntt.ntt_tile(xr, tw_c))
    fold = {
        "copy_in_ms": _ms(lambda: x4[:, 0].swapaxes(1, 2).contiguous()),
        "tile_rows_ms": _ms(lambda: cuda_ntt.ntt_tile_columns(Mc4, tw_in, w=W)),
        "tile_columns_ms": _ms(lambda: cuda_ntt.ntt_tile_columns(x4, tw_in, w=W)),
        "copy_out_ms": _ms(lambda: Yk.swapaxes(1, 2).contiguous()),
        "tile_store_transposed_ms": _ms(lambda: store_transposed(Ys)),
        "bit_reverse_ms": _ms(lambda: bit_reverse(x)),
        "tile_bitrev_rows_ms": _ms(lambda: cuda_ntt.ntt_tile(xr, tw_c)),
        "tile_columns_brev_ms": _ms(
            lambda: cuda_ntt.ntt_tile_columns(xc4, tw_c, brev_cols=True))}
    _emit({"sweep": "ntt_fold", "shape": [16, nA, nB], "ladder_rows": [16, n >> c, 1 << c],
           **fold, "columns_equal": columns_equal, "store_equal": store_equal,
           "brev_columns_equal": brev_equal,
           "ptxas_not_kept": _ptxas(logs["tile store transposed"])})
    if not (columns_equal and store_equal and brev_equal):
        raise AssertionError("ntt_fold: a folded tile differs from the tile on laid-out rows")
    del Ys, Yk, Mc, Mc4, x4, W

    # ntt_builds: the ladder's launches at 2^22, kept against each build not kept.
    tw_n = get_domain(LOG_N, dev).tw
    xs0 = cuda_ntt.ntt_tile(xr, tw_c).reshape(16, n)
    _, split = ntt_mod.ladder_split(LOG_N, c)
    tile_runs = {
        "columns_brev": lambda lib, out: lib.fr_ntt_tile(
            x.data_ptr(), tw_c.data_ptr(), None, None, out.data_ptr(), n >> c, 0, c,
            LOG_N - c, 1, stream()),
        "rows_bitrev": lambda lib, out: lib.fr_ntt_tile(
            xr.data_ptr(), tw_c.data_ptr(), None, None, out.data_ptr(), n >> c, 0, c, -1, 0,
            stream())}
    stage_runs = {
        f"half=2^{h},count={k}": (lambda lib, out, h=h, k=k, tws=ntt_mod._stage_table(
            tw_n, LOG_N, h + k): lib.fr_butterfly_stages(
                xs0.data_ptr(), tws.data_ptr(), None, out.data_ptr(), n, h, k, h + k, stream()))
        for h, k in split}
    rows = []
    for name, (proc, path) in started.items():
        if name == "tile store transposed":
            continue
        logs[name] = _finish(name, proc)
        tile_build = name.startswith("tile")
        kept = tiles if tile_build else stages
        fn = "fr_ntt_tile" if tile_build else "fr_butterfly_stages"
        other = _bind(path, kept, fn)
        for case, run in (tile_runs if tile_build else stage_runs).items():
            ref, out = torch.empty_like(x), torch.empty_like(x)
            cuda_ops.check_launch(run(kept, ref), f"kept {case}")
            cuda_ops.check_launch(run(other, out), f"{name} {case}")
            same = torch.equal(out, ref)
            turns = [_ms(lambda: run(lib, out)) for lib in (kept, other, other, kept)]
            rows.append({"build": name, "case": case, "equal": same,
                         "kept_ms": [turns[0], turns[3]], "other_ms": [turns[1], turns[2]]})
            if not same:
                raise AssertionError(f"ntt_builds: '{name}' differs from the kept build on "
                                     f"{case}")
        if name == "stages: one block an SM":
            other.fr_butterfly_stages_blocks_per_sm.restype = ctypes.c_int
            stages.fr_butterfly_stages_blocks_per_sm.restype = ctypes.c_int
            rows[-1]["blocks_per_sm"] = {
                "kept": stages.fr_butterfly_stages_blocks_per_sm(6),
                "other": other.fr_butterfly_stages_blocks_per_sm(6)}
    _emit({"sweep": "ntt_builds", "rows": rows,
           "ptxas_kept": {src: _ptxas(_build.build_log(src))
                          for src in ("ntt_kernels", "ntt_stages")},
           "ptxas_not_kept": {name: _ptxas(log) for name, log in logs.items()
                              if name != "tile store transposed"}})
    del xs0, xr, xc4

    # butterfly_sass
    for what, proc in (("probe", probe_so), ("probe cubin", probe_cubin),
                       ("ntt_stages cubin", stages_cubin)):
        _finish(what, proc)
    funcs = _sass(sweep_dir / "bf_probe.cubin")

    def one(kind: int) -> Counter:
        # probe<KIND, 2> less probe<KIND, 1>, by mangled name
        pick = lambda ops: next(v for k, v in funcs.items()
                                if re.search(rf"probeILi{kind}ELi{ops}E", k))
        diff = Counter(pick(2))
        diff.subtract(pick(1))
        return Counter({k: v for k, v in diff.items() if v})

    per = {"butterfly": one(0), "product": one(1), "sum_and_difference": one(2)}
    stages_sass = next(v for k, v in _sass(sweep_dir / "ntt_stages.cubin").items()
                       if "butterfly_stages_kernel" in k)
    probe = ctypes.CDLL(str(sweep_dir / "libbf_probe.so"))
    probe.fr_bf_loop.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                         ctypes.c_void_p]
    probe.fr_bf_loop.restype = ctypes.c_int
    threads, iters = 1 << 18, 64
    xl = _random_fr(threads, dev)
    out = torch.empty((16, 2 * threads), dtype=torch.int32, device=dev)
    loop_ms = _ms(lambda: cuda_ops.check_launch(
        probe.fr_bf_loop(xl.data_ptr(), out.data_ptr(), threads, iters, stream()), "bf_loop"))
    butterflies = threads * iters * 2
    _emit({"sweep": "butterfly_sass",
           "instructions": {k: sum(v.values()) for k, v in per.items()},
           "opcodes": {k: dict(v.most_common()) for k, v in per.items()},
           "stages_kernel_instructions": sum(stages_sass.values()),
           "stages_kernel_opcodes": dict(stages_sass.most_common(24)),
           "register_loop": {"threads": threads, "iterations": iters,
                             "butterflies": butterflies, "ms": loop_ms,
                             "butterflies_per_s": butterflies / (loop_ms * 1e-3),
                             "ms_per_2e21_butterflies": loop_ms * (1 << 21) / butterflies}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
