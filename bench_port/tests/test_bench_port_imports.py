"""Nothing the benchmark runs loads JAX or the JAX package: top-level module
names compared whole, since ``tpu_bls12_381_torch`` begins with
``tpu_bls12_381``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("tpu_bls12_381_torch.fields", "tpu_bls12_381_torchx", "jax_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_bls12_381.fields", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "tpu_bls12_381.fields"]


def test_no_source_of_the_benchmark_imports_them():
    for path in BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_a_whole_run_loads_none_of_them():
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import generator, harness
spec = harness.load_spec()
cell = harness.find_cell(spec, "plonk-k20.quotient")
config = {{**harness.load_config(spec, cell), "domain_log_n": 6, "extended_log_n": 8}}
traffic = generator.load_traffic("quotient")
traffic["inputs"]["columns"]["sets"] = 1
out = harness.run_cell("plonk-k20.quotient", 3, 0.0, False, "cpu", t_start=time.perf_counter(),
                       spec=spec, config=config, traffic=traffic)
print(json.dumps({{"correct": out["correct"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] is True
    assert "tpu_bls12_381_torch" in out["top"]
    assert not set(out["top"]) & set(harness.FORBIDDEN)


def test_run_without_a_card_fails_and_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: run.py would run")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", "plonk-k20.commit",
                           "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
