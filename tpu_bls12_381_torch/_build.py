"""Builds the CUDA sources under ``csrc/`` at first use and loads them: a disk
cache of compiled kernels that every later process reuses (the counterpart of
the JAX package's ``fields/aot.py``).

Every ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes).

* **One key per library.**  ``lib<name>_<key>.so`` (and its log
  ``<name>_<key>.log``), the key ``<sources>-<compiler>``: a hash of
  ``csrc/<name>.cu``, every header it includes through ``#include "..."``
  (transitively, resolved in ``csrc/``) and ``NVCC_FLAGS``, then a hash of
  the ``release`` line of ``nvcc --version``.  An edit rebuilds the libraries
  that include the edited file and no other; another compiler rebuilds them
  all.  The release line is kept in the cache (``nvcc_release.json``) beside
  the compiler's path, size and mtime, so a process whose ``nvcc`` has not
  changed starts none to read it; where no ``nvcc`` is found, the newest
  entry built from the same sources is loaded, and only a compile raises.
* **Build what is asked for.**  ``library(name)`` and ``build(names)`` start
  only those compiles, one ``nvcc`` process each, side by side, and wait for
  them; ``build()`` starts every source at once; ``start(names)`` starts
  without waiting (``runtime.Accelerator.warmup`` starts its paths'
  libraries with it).
* **The directory.**  ``MIDNIGHT_AOT_CACHE_DIR`` moves the cache from
  ``_build/`` inside the package; directories are made with mode 0o700, since
  the entries are executed code.  ``MIDNIGHT_AOT_CACHE=0`` builds into a
  private temporary directory that is removed at exit: nothing is reused and
  nothing is left behind (a cold start on demand).  Read once a process.
* **One compile per key across processes.**  A process holds an exclusive
  ``flock`` on ``<name>_<key>.lock`` while it compiles; another that finds it
  held waits, then loads what the first built.  The OS releases the lock of a
  process that dies.  The library is written to a temporary file and renamed
  into place.
* **An unloadable entry is rebuilt once**; a second failure raises
  ``BuildError`` with the loader's message.

``python3 -m tpu_bls12_381_torch._build`` is the install step: it builds
every library at once and prints one JSON line for each (name, key,
``built`` or ``reused``, seconds).

Nothing here runs at import: ``library(name)`` builds on its first call.
"""

from __future__ import annotations

import atexit
import ctypes
import fcntl
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
DEFAULT_DIR = PKG_DIR / "_build"
# The cache directory, resolved from the environment at first use (cache_dir).
BUILD_DIR: Path | None = None

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_LIBS: dict[str, ctypes.CDLL] = {}
_PATHS: dict[str, Path] | None = None
_LOCK = threading.RLock()
# Compiles started by this process: source -> [the thread that takes the lock
# and waits for nvcc, the nvcc process once it runs].
_PENDING: dict[str, list] = {}
_FAILURES: dict[str, str] = {}
# Seconds from the start(...) call that started a source to its library being
# in the cache (compiled here, or by another process while this one waited).
BUILD_SECONDS: dict[str, float] = {}
# How each library this process asked for came to be: "built" here or
# "reused" from the cache.
STATUS: dict[str, str] = {}
# Seconds of each library's load (ctypes.CDLL) in this process.
LOAD_SECONDS: dict[str, float] = {}
_RELEASE: str | None = None     # "" where no nvcc is found
_PRIVATE: Path | None = None
_STOPPING = False


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


def compiler_release() -> str:
    """The ``release`` line of ``nvcc --version``, "" where no nvcc is found
    (once a process).  Read from the cache's ``nvcc_release.json`` while the
    compiler's path, size and mtime are those kept there; else nvcc runs
    once and the file is rewritten."""
    global _RELEASE
    with _LOCK:
        if _RELEASE is None:
            try:
                nvcc = os.path.realpath(find_nvcc())
            except BuildError:
                _RELEASE = ""
                return _RELEASE
            st = os.stat(nvcc)
            ident = [nvcc, st.st_size, st.st_mtime_ns]
            memo = cache_dir() / "nvcc_release.json"
            try:
                kept = json.loads(memo.read_text())
                if kept["nvcc"] == ident:
                    _RELEASE = kept["release"]
                    return _RELEASE
            except (OSError, ValueError, KeyError, TypeError):
                pass
            try:
                out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                                     check=True).stdout
            except (OSError, subprocess.CalledProcessError) as e:
                raise BuildError(f"{nvcc} --version failed: {e}") from e
            _RELEASE = next((ln.strip() for ln in out.splitlines() if "release" in ln),
                            out.strip())
            tmp = memo.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(json.dumps({"nvcc": ident, "release": _RELEASE}))
            os.replace(tmp, memo)
        return _RELEASE


def source_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def sources_of(name: str) -> dict[str, bytes]:
    """``csrc/<name>.cu`` and every header it includes, transitively: the
    texts by their names in ``csrc/``."""
    texts: dict[str, bytes] = {}
    todo = [f"{name}.cu"]
    while todo:
        file_ = todo.pop()
        if file_ in texts:
            continue
        try:
            texts[file_] = (CSRC_DIR / file_).read_bytes()
        except OSError as e:
            raise BuildError(f"csrc/{file_} cannot be read: {e}") from e
        for inc in _INCLUDE.findall(texts[file_].decode(errors="replace")):
            if not (CSRC_DIR / inc).is_file():
                raise BuildError(f'csrc/{file_} includes "{inc}", which is not in '
                                 f"{CSRC_DIR}")
            todo.append(inc)
    return texts


def source_key(name: str) -> str:
    """The hash of the library's sources and the flags."""
    h = hashlib.sha256()
    for file_, text in sorted(sources_of(name).items()):
        h.update(file_.encode() + b"\0" + text + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_key(name: str) -> str:
    """``<sources>-<compiler>``: the source key, then the hash of the
    compiler's release line (``none`` where no nvcc is found)."""
    release = compiler_release()
    compiler = hashlib.sha256(release.encode()).hexdigest()[:8] if release else "none"
    return f"{source_key(name)}-{compiler}"


def cache_dir() -> Path:
    """The cache directory (made with mode 0o700): ``MIDNIGHT_AOT_CACHE_DIR``,
    else ``_build/`` in the package; under ``MIDNIGHT_AOT_CACHE=0`` a private
    temporary directory, removed at exit."""
    global BUILD_DIR, _PRIVATE
    with _LOCK:
        if BUILD_DIR is None:
            if os.environ.get("MIDNIGHT_AOT_CACHE", "1") == "0":
                BUILD_DIR = _PRIVATE = Path(tempfile.mkdtemp(prefix="tpu_bls12_381_torch_"))
            else:
                BUILD_DIR = Path(os.environ.get("MIDNIGHT_AOT_CACHE_DIR") or DEFAULT_DIR)
        os.makedirs(BUILD_DIR, mode=0o700, exist_ok=True)
        return BUILD_DIR


def library_paths() -> dict[str, Path]:
    """Every library's path in the cache (the keys hashed once a process).
    Where no nvcc is found: the newest entry built from the library's
    sources by any compiler, if the cache holds one."""
    global _PATHS
    with _LOCK:
        if _PATHS is None:
            dir_ = cache_dir()
            _PATHS = {name: dir_ / f"lib{name}_{library_key(name)}.so"
                      for name in source_names()}
            if not compiler_release():
                for name, path in _PATHS.items():
                    held = [p for p in dir_.glob(f"lib{name}_{source_key(name)}-*.so")
                            if "." not in p.stem]
                    if held:
                        _PATHS[name] = max(held, key=lambda p: p.stat().st_mtime_ns)
        return _PATHS


def _key_of(path: Path) -> str:
    return path.stem.rsplit("_", 1)[1]


def start(names=None) -> dict[str, Path]:
    """Start compiling the named sources (default: every source) that the
    cache does not hold, one ``nvcc`` process each, all at once; return every
    library's path without waiting."""
    paths = library_paths()
    wanted = list(paths) if names is None else list(names)
    t0 = time.perf_counter()
    with _LOCK:
        for name in wanted:
            if name not in paths:
                raise BuildError(f"no source csrc/{name}.cu")
            if name in _PENDING:
                continue
            if paths[name].exists():
                STATUS.setdefault(name, "reused")
                continue
            waiter = threading.Thread(target=_compile, args=(name, paths[name], t0),
                                      daemon=True)
            _PENDING[name] = [waiter, None]
            waiter.start()
    return paths


def _compile(name: str, path: Path, t0: float) -> None:
    """Take the library's lock, then compile it unless another process built
    it meanwhile; a failure is kept for ``build`` to raise."""
    try:
        with open(path.with_name(f"{name}_{_key_of(path)}.lock"), "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)       # released when the file closes
            if path.exists():
                STATUS[name] = "reused"
            else:
                _run_nvcc(name, path)
                STATUS[name] = "built"
    except Exception as e:  # noqa: BLE001 - raised again by build()
        _FAILURES[name] = str(e)
    finally:
        BUILD_SECONDS[name] = time.perf_counter() - t0


def _run_nvcc(name: str, path: Path) -> None:
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    with _LOCK:
        if _STOPPING:
            raise BuildError(f"{name}: not compiled, the process is exiting")
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        _PENDING[name][1] = proc
    out, _ = proc.communicate()
    path.with_name(f"{name}_{_key_of(path)}.log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(cmd)}\nexit code {proc.returncode}\n{out}")
    os.replace(tmp, path)


def _stop_pending() -> None:
    """Kill the compiles under way and start no other: a program that exits
    before a compile ends stops it."""
    global _STOPPING
    with _LOCK:
        _STOPPING = True
        procs = [proc for _, proc in _PENDING.values() if proc is not None]
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@atexit.register
def _at_exit() -> None:
    _stop_pending()
    if _PRIVATE is not None:
        shutil.rmtree(_PRIVATE, ignore_errors=True)


def build(names=None) -> dict[str, Path]:
    """Compile the named sources (default: every source, all at once) unless
    the cache holds them; wait for them and return every library's path."""
    paths = start(names)
    wanted = list(paths) if names is None else list(names)
    for name in wanted:
        entry = _PENDING.get(name)
        if entry is not None:
            entry[0].join()
    failures = [_FAILURES[name] for name in wanted if name in _FAILURES]
    if failures:
        raise BuildError("nvcc failed:\n" + "\n".join(failures))
    return paths


def build_log(name: str) -> str:
    """The compiler's output for one source (registers, spills)."""
    path = library_paths()[name]
    log = path.with_name(f"{name}_{_key_of(path)}.log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu`` (built on first use).
    A cached file that cannot be loaded is deleted and built again, once."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        t0 = time.perf_counter()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as first:
            with _LOCK:
                _PENDING.pop(name, None)
                STATUS.pop(name, None)
            path.unlink(missing_ok=True)
            build([name])
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise BuildError(f"{path} cannot be loaded, rebuilt or not: {e} "
                                 f"(before the rebuild: {first})") from e
        LOAD_SECONDS[name] = time.perf_counter() - t0
        _LIBS[name] = lib
    return lib


def main() -> int:
    """The install step: every library built at once, one JSON line each."""
    try:
        paths = build()
        failed = ""
    except BuildError as e:
        paths, failed = library_paths(), str(e)
    for name, path in paths.items():
        print(json.dumps({"library": name, "key": _key_of(path),
                          "status": STATUS.get(name, "failed"),
                          "seconds": round(BUILD_SECONDS.get(name, 0.0), 3),
                          "path": str(path)}), flush=True)
    if failed:
        print(failed, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
