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
assert {"metagraph_tpu_torch.graph.canonical",
        "metagraph_tpu_torch.scripts.exp_gather",
        "metagraph_tpu_torch.kmer.extractor",
        "metagraph_tpu_torch.annotation.matrix",
        "metagraph_tpu_torch.annotation.sparse_device",
        "metagraph_tpu_torch.succinct.bitrank",
        "metagraph_tpu_torch.succinct.bitvector",
        "metagraph_tpu_torch.seq_io.refformat",
        "metagraph_tpu_torch.graph.hash_graph",
        "metagraph_tpu_torch.graph.sshash_graph",
        "metagraph_tpu_torch.server.server",
        "metagraph_tpu_torch.utils.timer",
        "metagraph_tpu_torch.succinct.construct",
        "metagraph_tpu_torch.succinct.device_build",
        "metagraph_tpu_torch.seq_io.kmc",
        "metagraph_tpu_torch.entry"} <= set(names), names
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
    assert int(n) >= 31
    assert bad == [], bad


_LOAD_PROBE = """
import sys
from metagraph_tpu_torch.annotation.matrix import load_annotation
anno = load_annotation(sys.argv[1])
rows = anno.get_rows_mask(list(range(anno.num_rows)))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "metagraph_tpu"))
print(type(anno.matrix).__module__, int(rows.sum()), ",".join(bad))
"""


@pytest.mark.parametrize("rep", ("brwt", "row_diff", "int_brwt",
                                 "brwt_coord"))
def test_loading_a_jax_pickle_pulls_in_no_jax(tmp_path, rep):
    """A StaticAnnotation pickled by the JAX package (its classes' module
    names) loads into the port's classes without importing jax or
    metagraph_tpu."""
    from metagraph_tpu.annotation.column import ColumnMajorAnnotation
    from metagraph_tpu.annotation.matrix import (RowDiff, StaticAnnotation,
                                                 convert_annotation)
    rng = np.random.default_rng(4)
    anno = ColumnMajorAnnotation(50)
    for c in range(5):
        rows = np.unique(rng.integers(0, 50, 12))
        anno.add_label_counts(rows, rng.integers(1, 4, len(rows)), [f"l{c}"])
        anno.add_label_coords(rows, rng.integers(0, 99, len(rows)), [f"l{c}"])
    anno.freeze()
    if rep == "row_diff":
        m = convert_annotation(anno, "flat")
        m = RowDiff(m, np.full(50, -1), np.ones(50, bool), 5)
    else:
        m = convert_annotation(anno, rep)
    path = str(tmp_path / f"x.{rep}.annodbg")
    StaticAnnotation(m, anno.encoder, rep).save(path)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _LOAD_PROBE, path],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    module, ones, *bad = out.stdout.split()
    assert module == "metagraph_tpu_torch.annotation.matrix"
    assert int(ones) == sum(len(anno.column_rows(c)) for c in range(5))
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
