"""The build of the port's CUDA sources (``tpu_bls12_381_torch/_build.py``),
driven here with a stand-in for ``nvcc``: every source compiles at once, and a
caller waits only for the sources it asks for."""

import sys

import pytest
import torch

from tpu_bls12_381_torch import _build

torch.set_num_threads(1)

# Copies the source's text to the output; a source that says FAIL fails, one
# that says WAIT waits until a file <source>.go appears beside it.
FAKE_NVCC = """#!{python}
import pathlib, sys, time
args = sys.argv[1:]
out, src = pathlib.Path(args[args.index("-o") + 1]), pathlib.Path(args[-1])
text = src.read_text()
if "FAIL" in text:
    print("error: bad source")
    sys.exit(1)
while "WAIT" in text and not src.with_suffix(".go").exists():
    time.sleep(0.01)
out.write_text("lib " + text)
print("ptxas info    : Used 1 registers")
"""


@pytest.fixture
def sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    for name, value in (("CSRC_DIR", csrc), ("BUILD_DIR", tmp_path / "out"),
                        ("_PATHS", None), ("_PENDING", {}), ("_FAILURES", {}),
                        ("BUILD_SECONDS", {}), ("_LIBS", {})):
        monkeypatch.setattr(_build, name, value)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    return csrc


def test_build_waits_for_the_sources_asked_for(sources):
    (sources / "fast.cu").write_text("fast")
    (sources / "slow.cu").write_text("WAIT")
    (sources / "bad.cu").write_text("FAIL")
    paths = _build.build(["fast"])
    assert paths["fast"].read_text() == "lib fast"
    assert not paths["slow"].exists()                 # still compiling
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
    for name, value in (("_PATHS", None), ("_PENDING", {}), ("BUILD_SECONDS", {})):
        setattr(_build, name, value)
    (sources / "slow.cu").write_text("WAIT")          # a new source: a new hash
    paths = _build.start()
    proc = _build._PENDING["slow"][1]
    assert set(_build._PENDING) == {"fast", "slow"}
    _build.build(["fast"])
    assert paths["fast"].read_text() == "lib fast"
    _build._stop_pending()                            # what atexit runs
    assert proc.wait(timeout=30) != 0
    with pytest.raises(_build.BuildError, match="exit code"):
        _build.build(["slow"])
    (sources / "slow.go").write_text("")
    for name, value in (("_PATHS", None), ("_PENDING", {}), ("BUILD_SECONDS", {})):
        setattr(_build, name, value)
    assert _build.build() == paths
    assert set(_build._PENDING) == {"slow"}           # fast was built already
