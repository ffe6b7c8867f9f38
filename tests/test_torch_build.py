"""The build of the port's CUDA sources (``tpu_bls12_381_torch/_build.py``),
driven here with a stand-in for ``nvcc``: the sources asked for compile at
once, and a caller waits only for the sources it asks for."""

import sys

import pytest
import torch

from tpu_bls12_381_torch import _build

torch.set_num_threads(1)

# Answers --version with the release line {release} and appends a line to
# the file ``versions`` beside it; otherwise appends the source's stem to the
# file ``calls`` beside it and copies the source's text to the output (not a
# loadable library).  A source that says FAIL
# fails, one that says WAIT waits until a file <source>.go appears beside it,
# one that says REAL becomes a loadable library through the host compiler
# {cxx} (an ``answer()`` that returns 42).
FAKE_NVCC = """#!{python}
import pathlib, subprocess, sys, time
args = sys.argv[1:]
if args == ["--version"]:
    with open(pathlib.Path(sys.argv[0]).with_name("versions"), "a") as f:
        f.write("--version\\n")
    print("Cuda compilation tools, {release}")
    sys.exit(0)
out, src = pathlib.Path(args[args.index("-o") + 1]), pathlib.Path(args[-1])
with open(pathlib.Path(sys.argv[0]).with_name("calls"), "a") as f:
    f.write(src.stem + "\\n")
text = src.read_text()
if "FAIL" in text:
    print("error: bad source")
    sys.exit(1)
while "WAIT" in text and not src.with_suffix(".go").exists():
    time.sleep(0.01)
if "REAL" in text:
    cpp = out.with_suffix(".cpp")
    cpp.write_text('extern "C" int answer(void) {{ return 42; }}\\n')
    subprocess.run(["{cxx}", "-shared", "-fPIC", "-o", str(out), str(cpp)], check=True)
    cpp.unlink()
else:
    out.write_text("lib " + text)
print("ptxas info    : Used 1 registers")
"""


def fresh_state():
    """The module state a fresh process starts from."""
    return (("_PATHS", None), ("_PENDING", {}), ("_FAILURES", {}), ("BUILD_SECONDS", {}),
            ("STATUS", {}), ("_LIBS", {}), ("_RELEASE", None), ("_STOPPING", False))


def write_nvcc(dir_, cxx="c++", release="release 12.4, V12.4.131"):
    nvcc = dir_ / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, cxx=cxx, release=release))
    nvcc.chmod(0o755)
    return nvcc


def compiles(nvcc) -> list:
    """The sources the stand-in was asked to compile, in order."""
    calls = nvcc.with_name("calls")
    return calls.read_text().split() if calls.exists() else []


def fresh_process() -> None:
    """Forget what this process built or loaded (the cache stays)."""
    for name, value in fresh_state():
        setattr(_build, name, value)


@pytest.fixture
def sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    nvcc = write_nvcc(tmp_path)
    for name, value in (("CSRC_DIR", csrc), ("BUILD_DIR", tmp_path / "out"), *fresh_state()):
        monkeypatch.setattr(_build, name, value)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    return csrc


def test_build_waits_for_the_sources_asked_for(sources):
    (sources / "fast.cu").write_text("fast")
    (sources / "slow.cu").write_text("WAIT")
    (sources / "bad.cu").write_text("FAIL")
    paths = _build.build(["fast"])
    assert paths["fast"].read_text() == "lib fast"
    assert not paths["slow"].exists()                 # not asked for
    assert "Used 1 registers" in _build.build_log("fast")
    with pytest.raises(_build.BuildError, match="bad source"):
        _build.build(["bad"])
    with pytest.raises(_build.BuildError, match="no source"):
        _build.build(["none"])
    (sources / "slow.go").write_text("")
    assert _build.build(["slow"]) is paths
    assert paths["slow"].read_text() == "lib WAIT"
    assert set(_build.BUILD_SECONDS) == {"fast", "slow", "bad"}
    with pytest.raises(_build.BuildError, match="bad source"):
        _build.build()                                # every source, bad among them


def test_build_reuses_what_is_built_and_stops_what_runs(sources):
    (sources / "fast.cu").write_text("fast")
    _build.build()
    fresh_process()
    (sources / "slow.cu").write_text("WAIT")          # a new source: fast's key stays
    paths = _build.start()
    assert set(_build._PENDING) == {"slow"}           # fast is in the cache
    assert _build.STATUS == {"fast": "reused"}
    while _build._PENDING["slow"][1] is None:         # the compile runs once the
        _build._PENDING["slow"][0].join(0.01)         # lock is held
    proc = _build._PENDING["slow"][1]
    _build.build(["fast"])
    assert paths["fast"].read_text() == "lib fast"
    _build._stop_pending()                            # what atexit runs
    assert proc.wait(timeout=30) != 0
    with pytest.raises(_build.BuildError, match="exit code"):
        _build.build(["slow"])
    (sources / "slow.go").write_text("")
    fresh_process()
    assert _build.build() == paths
    assert set(_build._PENDING) == {"slow"}           # fast was built already
    assert _build.STATUS == {"fast": "reused", "slow": "built"}
    calls = compiles(sources.parent / "nvcc")         # the killed compile may have
    assert calls[0] == "fast" and set(calls[1:]) == {"slow"}   # died before it wrote
