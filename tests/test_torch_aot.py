"""The port's kernel cache (``tpu_bls12_381_torch/_build.py``), the counterpart
of the JAX package's ``fields/aot.py`` (whose tests are ``test_aot.py``): one
key per library, from the library's own sources, the flags and the compiler;
only what is asked for compiles; one compile per key across processes; an
unloadable entry rebuilt once; the cache directory and its two variables; the
install step.  Driven with ``test_torch_build.py``'s stand-in ``nvcc`` on a
copy of the real ``csrc/`` texts; the processes are children that load
``_build.py`` by its path (no torch, no card)."""

import json
import os
import shutil
import stat
import subprocess
import sys
import threading
import time
from unittest import mock

import pytest
import torch
from test_torch_build import compiles, fresh_process, fresh_state, write_nvcc

from tpu_bls12_381_torch import _build, native
from tpu_bls12_381_torch.curves import cuda_g1, cuda_g2
from tpu_bls12_381_torch.fields import cuda_ops
from tpu_bls12_381_torch.ntt import cuda_ntt
from tpu_bls12_381_torch.runtime import accelerator

torch.set_num_threads(1)

CSRC = _build.CSRC_DIR
LIBRARIES = sorted(p.stem for p in CSRC.glob("*.cu"))
G2 = {"g2_padd", "g2_padd_scan", "g2_pdbl", "g2_pmadd"}
CXX = shutil.which("g++") or shutil.which("c++") or "c++"

# The libraries whose key an edit of each file changes (csrc/*.cu lines 21 to
# 77 and *.cuh lines 16 to 51 hold the include graph).
EDITS = {
    "field.cuh": set(LIBRARIES),
    "field_carry.cuh": set(LIBRARIES),
    "g1.cuh": {"g1_kernels", "g1_jac_kernels"} | G2,
    "g1_jac.cuh": {"g1_jac_kernels"},
    "g2.cuh": G2,
    "g2_pair.cuh": {"g2_pmadd"},
    "lane_scan.cuh": {"g1_kernels", "g2_padd_scan"},
    "ntt.cuh": {"ntt_kernels", "ntt_stages"},
    "batch_inverse.cuh": {"batch_inverse"},
    **{f"{name}.cu": {name} for name in LIBRARIES},
    "host_check.cpp": set(),                  # the host tests' file: no library's
}

# A process of its own: loads _build.py by its path, points it at a csrc/,
# builds (every source, or those named) and prints its cache and what it did.
CHILD = """
import importlib.util, json, sys
from pathlib import Path
spec = importlib.util.spec_from_file_location("_build", sys.argv[1])
b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(b)
b.CSRC_DIR = Path(sys.argv[2])
b.build(sys.argv[3:] or None)
print(json.dumps({"dir": str(b.cache_dir()), "status": b.STATUS}))
"""


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the real csrc/ texts, the stand-in nvcc, an empty cache."""
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy, ignore=shutil.ignore_patterns("__pycache__"))
    nvcc = write_nvcc(tmp_path, CXX)
    for name, value in (("CSRC_DIR", copy), ("BUILD_DIR", tmp_path / "cache"),
                        *fresh_state()):
        monkeypatch.setattr(_build, name, value)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    return copy


def keys() -> dict:
    return {name: _build.library_key(name) for name in _build.source_names()}


def edit(path) -> None:
    path.write_text(path.read_text() + "\n// edited\n")


def child_env(csrc, **env) -> dict:
    out = dict(os.environ, PATH=f"{csrc.parent}{os.pathsep}{os.environ.get('PATH', '')}")
    for name in ("MIDNIGHT_AOT_CACHE", "MIDNIGHT_AOT_CACHE_DIR"):
        out.pop(name, None)
    out.update(env)
    return out


def child(csrc, env, *names, wait=True):
    cmd = [sys.executable, "-c", CHILD, str(_build.PKG_DIR / "_build.py"), str(csrc), *names]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return finish(proc) if wait else proc


def finish(proc) -> dict:
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


def test_the_include_graph_is_the_one_the_keys_follow():
    assert LIBRARIES == ["batch_inverse", "field_kernels", "g1_jac_kernels", "g1_kernels",
                         "g2_padd", "g2_padd_scan", "g2_pdbl", "g2_pmadd", "ntt_kernels",
                         "ntt_stages"]
    assert set(EDITS) == {p.name for p in CSRC.iterdir()
                          if p.suffix in (".cu", ".cuh", ".cpp")}


@pytest.mark.parametrize("file_", sorted(EDITS))
def test_an_edit_changes_the_keys_of_the_libraries_that_include_it(csrc, file_):
    before = keys()
    edit(csrc / file_)
    after = keys()
    assert {name for name in LIBRARIES if before[name] != after[name]} == EDITS[file_]


@pytest.mark.parametrize("change", ["flags", "compiler release"])
def test_the_flags_and_the_compiler_are_in_every_key(csrc, monkeypatch, change):
    before = keys()
    if change == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    else:
        write_nvcc(csrc.parent, CXX, release="release 12.8, V12.8.93")   # another nvcc
        _build._RELEASE = None                # read once a process: a new process
        assert _build.compiler_release() == "Cuda compilation tools, release 12.8, V12.8.93"
    after = keys()
    assert all(before[name] != after[name] for name in LIBRARIES)
    assert len(set(after.values())) == len(LIBRARIES)


def test_keys_are_stable_between_calls_and_processes(csrc):
    first = keys()
    assert keys() == first
    fresh_process()
    assert keys() == first
    paths = _build.start([])                  # nothing asked for, nothing started
    assert not _build._PENDING
    assert {name: _build._key_of(p) for name, p in paths.items()} == first
    assert all(p.name == f"lib{n}_{first[n]}.so" for n, p in paths.items())


def test_a_later_process_reads_the_release_from_the_cache(csrc):
    """nvcc --version runs once an nvcc: a later process with the same nvcc
    reads the release line kept in the cache; another nvcc is asked again."""
    versions = csrc.parent / "versions"
    first = keys()
    assert versions.read_text().split() == ["--version"]
    fresh_process()
    assert keys() == first
    assert versions.read_text().split() == ["--version"]
    write_nvcc(csrc.parent, CXX, release="release 12.8, V12.8.93")
    fresh_process()
    assert all(k != first[n] for n, k in keys().items())
    assert versions.read_text().split() == ["--version"] * 2


def test_cached_libraries_load_where_no_nvcc_is_found(csrc, monkeypatch):
    """A host with a filled cache and no nvcc loads what the cache holds for
    the current sources; only a library left to compile raises."""
    if not shutil.which(CXX):
        pytest.skip("no host C++ compiler (g++ / c++) on this machine")
    (csrc / "one.cu").write_text("REAL")
    built = _build.build()
    fresh_process()

    def no_nvcc():
        raise _build.BuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    assert _build.library_paths() == built
    assert _build.library("one").answer() == 42
    assert _build.build() == built
    assert set(_build.STATUS.values()) == {"reused"}
    edit(csrc / "g2_pair.cuh")
    fresh_process()
    assert _build.build(["g2_padd"])["g2_padd"] == built["g2_padd"]
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.build(["g2_pmadd"])
    assert sorted(compiles(csrc.parent / "nvcc")) == sorted([*LIBRARIES, "one"])


def test_an_include_that_is_not_in_csrc_raises(csrc):
    (csrc / "g2_pair.cuh").write_text('#include "g2.cuh"\n#include "missing.cuh"\n')
    assert _build.library_key("g2_padd")      # does not include g2_pair.cuh
    with pytest.raises(_build.BuildError, match='includes "missing.cuh"'):
        _build.library_key("g2_pmadd")


def test_after_an_edit_only_the_changed_keys_compile(csrc):
    nvcc = csrc.parent / "nvcc"
    old = _build.build()
    assert sorted(compiles(nvcc)) == LIBRARIES
    assert set(_build.STATUS.values()) == {"built"}
    assert "Used 1 registers" in _build.build_log("g2_pmadd")
    fresh_process()
    edit(csrc / "lane_scan.cuh")
    new = _build.build()
    assert compiles(nvcc)[len(LIBRARIES):] in (["g1_kernels", "g2_padd_scan"],
                                               ["g2_padd_scan", "g1_kernels"])
    assert {n for n, s in _build.STATUS.items() if s == "built"} == EDITS["lane_scan.cuh"]
    assert {n for n in LIBRARIES if new[n] != old[n]} == EDITS["lane_scan.cuh"]
    assert all(p.exists() for p in (*old.values(), *new.values()))
    fresh_process()
    assert _build.build(["g2_pmadd"])["g2_pmadd"] == new["g2_pmadd"]
    assert _build.STATUS == {"g2_pmadd": "reused"}
    assert len(compiles(nvcc)) == len(LIBRARIES) + 2


def test_a_second_process_on_the_same_cache_compiles_nothing(csrc, tmp_path):
    env = child_env(csrc, MIDNIGHT_AOT_CACHE_DIR=str(tmp_path / "shared"))
    first = child(csrc, env, "g1_kernels", "field_kernels")
    assert first == {"dir": str(tmp_path / "shared"),
                     "status": {"field_kernels": "built", "g1_kernels": "built"}}
    assert sorted(compiles(csrc.parent / "nvcc")) == ["field_kernels", "g1_kernels"]
    second = child(csrc, env)                 # every source
    assert {n for n, s in second["status"].items() if s == "reused"} == {"field_kernels",
                                                                         "g1_kernels"}
    third = child(csrc, env)
    assert third["status"] == dict.fromkeys(LIBRARIES, "reused")
    assert sorted(compiles(csrc.parent / "nvcc")) == LIBRARIES


def test_two_processes_on_an_empty_cache_compile_each_source_once(csrc, tmp_path):
    (csrc / "g1_kernels.cu").write_text((csrc / "g1_kernels.cu").read_text() + "// WAIT\n")
    env = child_env(csrc, MIDNIGHT_AOT_CACHE_DIR=str(tmp_path / "shared"))
    procs = [child(csrc, env, wait=False) for _ in range(2)]
    deadline = time.monotonic() + 30
    while "g1_kernels" not in compiles(csrc.parent / "nvcc"):
        assert time.monotonic() < deadline, "no process reached g1_kernels"
        time.sleep(0.01)
    time.sleep(0.5)                           # the other process waits on the lock
    (csrc / "g1_kernels.go").write_text("")
    a, b = (finish(p) for p in procs)
    assert sorted(compiles(csrc.parent / "nvcc")) == LIBRARIES
    built = [{n for n, s in r["status"].items() if s == "built"} for r in (a, b)]
    assert built[0] | built[1] == set(LIBRARIES) and not built[0] & built[1]
    assert set(a["status"]) == set(b["status"]) == set(LIBRARIES)
    assert not list((tmp_path / "shared").glob("*.tmp*"))


@pytest.mark.parametrize("second", ["loads", "fails again"])
def test_an_unloadable_entry_is_rebuilt_once(csrc, second):
    if second == "loads" and not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no host C++ compiler (g++ / c++) on this machine")
    (csrc / "one.cu").write_text("REAL" if second == "loads" else "text, not a library")
    path = _build.library_paths()["one"]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("a truncated entry")      # what a crash or a bad copy leaves
    nvcc = csrc.parent / "nvcc"
    if second == "loads":
        assert _build.library("one").answer() == 42
        assert compiles(nvcc) == ["one"]
        assert _build.STATUS["one"] == "built"
        assert _build.library("one") is _build.library("one")
    else:
        with pytest.raises(_build.BuildError, match="cannot be loaded, rebuilt or not"):
            _build.library("one")
        assert compiles(nvcc) == ["one"]      # rebuilt once, then raised


def test_the_cache_directory_follows_the_environment(csrc, tmp_path, monkeypatch):
    where = tmp_path / "elsewhere" / "aot"
    monkeypatch.setenv("MIDNIGHT_AOT_CACHE_DIR", str(where))
    monkeypatch.setattr(_build, "BUILD_DIR", None)
    assert _build.cache_dir() == where
    assert stat.S_IMODE(where.stat().st_mode) == 0o700
    assert _build.build(["ntt_stages"])["ntt_stages"].parent == where
    assert native._so_path().parent == where
    monkeypatch.setenv("MIDNIGHT_AOT_CACHE_DIR", str(tmp_path / "later"))
    assert _build.cache_dir() == where        # read once a process
    monkeypatch.setattr(_build, "BUILD_DIR", None)
    monkeypatch.delenv("MIDNIGHT_AOT_CACHE_DIR")
    assert _build.cache_dir() == _build.DEFAULT_DIR == _build.PKG_DIR / "_build"


def test_no_cache_builds_into_a_private_directory_gone_at_exit(csrc, tmp_path):
    env = child_env(csrc, MIDNIGHT_AOT_CACHE="0",
                    MIDNIGHT_AOT_CACHE_DIR=str(tmp_path / "shared"))
    first = child(csrc, env, "batch_inverse")
    second = child(csrc, env, "batch_inverse")
    assert first["status"] == second["status"] == {"batch_inverse": "built"}
    assert first["dir"] != second["dir"]
    assert not any(os.path.exists(r["dir"]) for r in (first, second))
    assert not (tmp_path / "shared").exists()
    assert compiles(csrc.parent / "nvcc") == ["batch_inverse"] * 2


def test_the_install_step_builds_every_library_and_says_how(csrc, tmp_path, monkeypatch,
                                                          capsys):
    env = child_env(csrc, MIDNIGHT_AOT_CACHE_DIR=str(tmp_path / "installed"))
    run = subprocess.run([sys.executable, "-m", "tpu_bls12_381_torch._build"], env=env,
                         capture_output=True, text=True, timeout=120, cwd=_build.PKG_DIR.parent)
    assert run.returncode == 0, run.stderr
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "installed")
    assert _build.main() == 0                 # again, in this process: all reused
    for out, status in ((run.stdout, "built"), (capsys.readouterr().out, "reused")):
        lines = [json.loads(ln) for ln in out.splitlines()]
        assert [ln["library"] for ln in lines] == LIBRARIES
        assert {ln["status"] for ln in lines} == {status}
        for ln in lines:
            assert ln["path"] == str(tmp_path / "installed" / f"lib{ln['library']}_"
                                     f"{ln['key']}.so")
            assert (ln["seconds"] > 0) == (status == "built")
    assert sorted(compiles(csrc.parent / "nvcc")) == LIBRARIES


def test_warmup_starts_the_libraries_of_its_paths(monkeypatch):
    assert accelerator.warmup_libraries() == ["batch_inverse", "field_kernels", "g1_kernels"]
    assert accelerator.warmup_libraries(g2=True, ntt=True) == [
        "batch_inverse", "field_kernels", "g1_kernels", "g2_padd", "g2_padd_scan",
        "g2_pdbl", "g2_pmadd", "ntt_kernels", "ntt_stages"]
    started = []
    monkeypatch.setattr(_build, "start", started.append)
    acc = accelerator.Accelerator(device="cpu")
    for ctx in (acc.g1, acc.g2):
        monkeypatch.setattr(ctx, "warmup", lambda *a, **k: None)
    acc.warmup(g2=True)
    assert started == []                      # the CPU builds nothing
    acc.device = torch.device("cuda", 0)      # what warmup does first on the card
    acc.warmup(g2=True)
    assert started == [accelerator.warmup_libraries(g2=True)]


def test_the_wrappers_load_the_libraries_they_name(monkeypatch):
    """Each wrapper module loads its libraries by the names it declares, the
    names warmup_libraries composes; together they name every library."""
    asked = []
    monkeypatch.setattr(_build, "library", lambda name: asked.append(name) or mock.MagicMock())
    for mod, flags in ((cuda_ops, ("_CONFIGURED", "_BINV_CONFIGURED", "_STAGES_CONFIGURED")),
                       (cuda_g1, ("_CONFIGURED", "_JAC_CONFIGURED")),
                       (cuda_ntt, ("_CONFIGURED",))):
        for flag in flags:
            monkeypatch.setattr(mod, flag, False)
    monkeypatch.setattr(cuda_g2, "_ENTRIES", {})
    for load, name in ((cuda_ops._lib, cuda_ops.FIELD_LIBRARY),
                       (cuda_ops._binv_lib, cuda_ops.INVERSE_LIBRARY),
                       (cuda_ops._stages_lib, cuda_ops.STAGES_LIBRARY),
                       (cuda_g1._lib, cuda_g1.LIBRARY), (cuda_g1._jac_lib, cuda_g1.JAC_LIBRARY),
                       (cuda_ntt._lib, cuda_ntt.LIBRARY),
                       *((lambda n=n: cuda_g2._entry(n), n) for n in cuda_g2.LIBRARIES)):
        load()
        assert asked[-1] == name
    assert sorted(asked) == LIBRARIES


def test_threads_asking_at_once_compile_each_source_once(csrc):
    """Sixteen threads (more than this host's cores) ask for overlapping sets
    of libraries at once, with the interpreter switching threads every
    microsecond: each source compiles once and every thread gets its own."""
    wanted = [LIBRARIES[i % 7:i % 7 + 4] for i in range(16)]
    got, errors = {}, []

    def ask(i):
        try:
            got[i] = {n: _build.build(wanted[i])[n] for n in wanted[i]}
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    asked = sorted({n for names in wanted for n in names})
    assert sorted(compiles(csrc.parent / "nvcc")) == asked
    assert all(p.exists() for paths in got.values() for p in paths.values())
    assert _build.STATUS == dict.fromkeys(asked, "built")
