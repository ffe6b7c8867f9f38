"""Rules that every test file of the PyTorch/CUDA port keeps, read from the
files' text (nothing is imported or run):

* it sets PyTorch's intra-op threads to one at module level.  The port's CPU
  path is thousands of tiny tensor ops; with the default threads a process
  spins at several cores' worth of CPU between them, and the suite's parallel
  workers then slow each other several times over.  A call at import holds
  for every test of the file, and a worker never returns to the default
  between files;
* it marks no test ``slow``: the tier-1 command deselects ``slow``, so such
  a test would silently stop running.
"""

import ast
import glob
import os

import torch

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
FILES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(TESTS, "test_torch_*.py")))


def _tree(name):
    with open(os.path.join(TESTS, name)) as f:
        return ast.parse(f.read(), filename=name)


def _is_one_thread_call(node):
    """``torch.set_num_threads(1)`` as a statement of its own."""
    if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
        return False
    fn, args = node.value.func, node.value.args
    return (isinstance(fn, ast.Attribute) and fn.attr == "set_num_threads"
            and isinstance(fn.value, ast.Name) and fn.value.id == "torch"
            and len(args) == 1 and isinstance(args[0], ast.Constant) and args[0].value == 1)


def _slow_marks(name):
    return [node.lineno for node in ast.walk(_tree(name))
            if isinstance(node, ast.Attribute) and node.attr == "slow"
            and isinstance(node.value, ast.Attribute) and node.value.attr == "mark"]


def test_one_torch_thread_at_import():
    assert "test_torch_msm.py" in FILES and len(FILES) > 20
    missing = [name for name in FILES
               if not any(_is_one_thread_call(node) for node in _tree(name).body)]
    assert not missing, f"no torch.set_num_threads(1) at module level in: {missing}"


def test_no_slow_marker():
    assert "test_torch_suite_rules.py" in FILES and len(FILES) > 20
    slow = {name: lines for name in FILES if (lines := _slow_marks(name))}
    assert not slow, f"slow markers (file: lines): {slow}"
