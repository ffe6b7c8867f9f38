"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Every ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).  All sources are compiled at
once, one ``nvcc`` process each, and ``library(name)`` waits for its own
source only, so the rest of a program need not wait for the slowest compile.
The output goes to ``_build/`` inside the package, keyed by a hash of all
sources and flags, so an edit rebuilds and an unchanged tree reuses what is
there.

Nothing here runs at import: ``library(name)`` builds on its first call.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_PATHS: dict[str, Path] | None = None
_LOCK = threading.Lock()
# Compiles under way: source -> (the thread that waits for nvcc, the process).
_PENDING: dict[str, tuple[threading.Thread, subprocess.Popen]] = {}
_FAILURES: dict[str, str] = {}
# Seconds from the start of this process's build to each source's end (the
# sources compile side by side; empty where everything was built already).
BUILD_SECONDS: dict[str, float] = {}


class BuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise BuildError(
        "nvcc not found (looked on PATH, in CUDA_HOME and in /usr/local/cuda): "
        "the CUDA kernels of tpu_bls12_381_torch cannot be built here")


def source_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def start() -> dict[str, Path]:
    """Start compiling every source not built yet, one ``nvcc`` process each,
    all at once; return the libraries' paths without waiting."""
    global _PATHS
    with _LOCK:
        if _PATHS is not None:
            return _PATHS
        tag = _source_hash()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {name: BUILD_DIR / f"lib{name}_{tag}.so" for name in source_names()}
        todo = [name for name, p in paths.items() if not p.exists()]
        nvcc = find_nvcc() if todo else None
        t0 = time.perf_counter()
        for name in todo:
            tmp = paths[name].with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            _FAILURES.pop(name, None)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            waiter = threading.Thread(target=_finish,
                                      args=(name, tag, tmp, paths[name], cmd, proc, t0),
                                      daemon=True)
            waiter.start()
            _PENDING[name] = (waiter, proc)
        _PATHS = paths
        return paths


def _finish(name, tag, tmp, path, cmd, proc, t0) -> None:
    out, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    (BUILD_DIR / f"{name}_{tag}.log").write_text(out)
    if proc.returncode != 0:
        _FAILURES[name] = f"{' '.join(cmd)}\nexit code {proc.returncode}\n{out}"
        tmp.unlink(missing_ok=True)
    else:
        os.replace(tmp, path)


@atexit.register
def _stop_pending() -> None:
    """A program that exits before a compile ends stops it."""
    for _, proc in _PENDING.values():
        if proc.poll() is None:
            proc.kill()


def build(names=None) -> dict[str, Path]:
    """Compile every source (all at once) unless already built; wait for
    ``names`` (default: every source) and return every library's path."""
    paths = start()
    wanted = list(paths) if names is None else list(names)
    for name in wanted:
        if name not in paths:
            raise BuildError(f"no source csrc/{name}.cu")
        if name in _PENDING:
            _PENDING[name][0].join()
    failures = [_FAILURES[name] for name in wanted if name in _FAILURES]
    if failures:
        raise BuildError("nvcc failed:\n" + "\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for one source (registers, spills)."""
    log = BUILD_DIR / f"{name}_{_source_hash()}.log"
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib
