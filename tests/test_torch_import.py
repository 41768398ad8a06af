"""metagraph_tpu_torch stands alone: importing it pulls in neither jax nor
metagraph_tpu, and its entry points need CUDA unless asked for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import metagraph_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "metagraph_tpu"))
print(len(names), ",".join(bad))
"""


def test_import_pulls_in_no_jax():
    # a subprocess: tests/conftest.py imports jax into this process
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    n, bad = out.stdout.split()[0], out.stdout.strip().split(" ", 1)[1:]
    assert int(n) >= 15
    assert bad == [], bad


def test_sources_import_no_jax():
    """No import statement of the package or of chip_smoke.py names jax or
    metagraph_tpu (a lazy import inside a function would escape the
    subprocess probe above)."""
    import ast
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO,
                                                  "metagraph_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    assert len(paths) > 15
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "metagraph_tpu"), (path, name)


def test_entry_points_need_cuda(monkeypatch):
    from metagraph_tpu_torch.align.sw import batch_local_align_scores
    from metagraph_tpu_torch.convert import QueryIndex
    from metagraph_tpu_torch.query.pipeline import QueryEngine
    from metagraph_tpu_torch.succinct.ops import DeviceHashIndex
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = np.array([[0x11111111]], dtype=np.uint32)
    index = QueryIndex(4, DeviceHashIndex.build_table(keys, [1]),
                       np.zeros((1, 1), np.uint32), ["a"])
    qs = np.zeros((2, 8), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryEngine(index)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_local_align_scores(qs, qs)
    QueryEngine(index, device="cpu")
    np.testing.assert_array_equal(
        batch_local_align_scores(qs, qs, device="cpu"), [2 * 8] * 2)
