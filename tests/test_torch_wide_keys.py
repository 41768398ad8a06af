"""Keys wider than 8 words on the port (k > 64 at 4 bits a code, k > 32 at
8 bits): the plain versions of kernels A and B against the JAX package on
the CPU, and ``python -m metagraph_tpu_torch query --device --torch-device
cpu`` against ``python -m metagraph_tpu.cli query --device`` on DNA graphs
at k = 70 (basic: the codes route; canonical and primary: the map route)
and a Protein graph at k = 40 (the map route), byte for byte.

tests/test_torch_gpu.py holds the CUDA kernels against these plain
versions on the card at the same widths and wider.  Inputs come from numpy
seeds; every comparison is exact.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metagraph_tpu.succinct import ops as jops
from metagraph_tpu_torch._u32 import np_words
from metagraph_tpu_torch.query import device as tdev
from metagraph_tpu_torch.query.tile_pack import tile_pack2
from metagraph_tpu_torch.succinct import ops as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bits", (4, 8))
@pytest.mark.parametrize("W", (9, 10, 17, 20, 32))
def test_key_lookup_plain_matches_jax(W, bits):
    """The table both packages build from the same keys, and the plain
    kernel A against DeviceHashIndex.lookup: every key (hits), each with
    one code changed (near misses), random keys (misses)."""
    K = W * 32 // bits - 1
    rng = np.random.default_rng(10 * W + bits)
    top = 15 if bits == 4 else 28
    chars = np.unique(rng.integers(1, top, (600, K)).astype(np.uint8),
                      axis=0)
    ids = rng.permutation(len(chars)).astype(np.uint32) + 1
    keys = tops.pack_kmers32(chars, bits)
    jidx = jops.DeviceHashIndex.from_packed(keys, ids)
    table = tops.DeviceHashIndex.build_table(keys, ids)
    assert table.tobytes() == np.asarray(jidx.table).tobytes()
    near = chars.copy()
    rows = np.arange(len(near))
    at = rng.integers(0, K, len(near))
    near[rows, at] = near[rows, at] % (top - 1) + 1
    q = np.concatenate([keys, tops.pack_kmers32(near, bits),
                        tops.pack_kmers32(rng.integers(
                            1, top, (200, K)).astype(np.uint8), bits)])
    want = np.asarray(jidx.lookup(jnp.asarray(q)))
    got = tops.key_lookup(np_words(q), np_words(table))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(want[:len(keys)], ids)
    assert not want[len(keys):].any()
    assert keys.shape[1] == W


@pytest.mark.parametrize("K", (65, 70, 100))
def test_codes_lookup_plain_matches_jax(K):
    """The plain kernel B on 2-bit tiles against the ids the JAX package
    gives the same windows: device_pack_windows on the tiles' codes, then
    DeviceHashIndex.lookup (query_epoch_codes2's steps before it counts);
    reads with N runs, shorter than K, longer than a tile."""
    rng = np.random.default_rng(K)
    refs = rng.integers(0, 4, (4, 600)).astype(np.uint8)
    win = np.lib.stride_tricks.sliding_window_view(refs, K, axis=1)
    chars = np.unique(win.reshape(-1, K) + 1, axis=0)
    ids = np.arange(1, len(chars) + 1, dtype=np.uint32)
    jidx = jops.DeviceHashIndex.from_packed(tops.pack_kmers32(chars), ids)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seqs = []
    for i in range(30):
        r = refs[i % 4]
        a = int(rng.integers(0, 300))
        read = r[a: a + int(rng.integers(K - 5, 300))].copy()
        read[rng.random(len(read)) < 0.01] = 4
        seqs.append(letters[read].tobytes())
    seqs.append(letters[np.tile(refs[1], 2)].tobytes())
    T = tdev.TILE
    t2, vb, _, _ = tile_pack2(seqs, K, T)
    got = tops.codes_lookup(torch.from_numpy(t2), torch.from_numpy(vb),
                            np_words(np.asarray(jidx.table)), K, T)
    codes = tops.tile_codes(torch.from_numpy(t2), torch.from_numpy(vb),
                            T + K - 1).numpy().astype(np.int32)
    packed, valid = jops.device_pack_windows(jnp.asarray(codes), K)
    W = -(-K // 8)
    ids_j = np.asarray(jidx.lookup(jnp.asarray(packed).reshape(-1, W)))
    want = np.where(np.asarray(valid), ids_j.reshape(len(t2), T), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > 1000 and (np.asarray(valid) & (want == 0)).any()


RUNNER = """
import contextlib, io, json, sys
from metagraph_tpu_torch.cli import main
out = []
for args in json.load(open(sys.argv[1])):
    buf, code = io.StringIO(), 0
    try:
        with contextlib.redirect_stdout(buf):
            main(args)
    except SystemExit as e:
        code = e.code or 0
    out.append([buf.getvalue(), code])
json.dump(out, open(sys.argv[2], "w"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "metagraph_tpu")]
assert not bad, bad
"""

GRAPHS = {"dna70": ("DNA", "basic", 70), "dna70c": ("DNA", "canonical", 70),
          "dna70p": ("DNA", "primary", 70), "prot40": ("Protein", "basic", 40)}


@pytest.fixture(scope="module")
def wide_graphs(tmp_path_factory):
    """DNA references (basic, canonical and primary graphs at k = 70) and
    Protein references (k = 40), counts annotations, and reads cut from
    them (reverse complements for DNA, substitutions, invalid runs)."""
    from metagraph_tpu.cli.main import main as jax_main
    tmp = tmp_path_factory.mktemp("wide")
    rng = np.random.default_rng(71)
    comp = str.maketrans("ACGT", "TGCA")
    for name, letters in (("dna", "ACGT"), ("prot", "ACDEFGHIKLMNPQRSTVWY")):
        refs = ["".join(rng.choice(list(letters), size=int(n)))
                for n in rng.integers(200, 400, size=6)]
        refs[2] = refs[2] + refs[2][20:140]              # repeated k-mers
        reads = []
        for i, s in enumerate(refs * 4):
            a = int(rng.integers(0, len(s) - 150))
            r = s[a: a + int(rng.integers(60, 150))]
            if name == "dna" and i % 3 == 1:
                r = r[::-1].translate(comp)
            if i % 4 == 0:
                r = r[:30] + ("N" if name == "dna" else "*") + r[31:]
            reads.append(r)
        with open(tmp / f"{name}.fa", "w") as f:
            f.writelines(f">r{i} x\n{s}\n" for i, s in enumerate(refs))
        with open(tmp / f"q{name}.fa", "w") as f:
            f.writelines(f">q{i}\n{s}\n" for i, s in enumerate(reads))
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        for g, (alphabet, mode, k) in GRAPHS.items():
            fa = str(tmp / ("prot.fa" if alphabet == "Protein"
                            else "dna.fa"))
            jax_main(["build", "--alphabet", alphabet, "--mode", mode, "-k",
                      str(k), "-o", str(tmp / g), fa])
            jax_main(["annotate", "-i", str(tmp / f"{g}.dbg"),
                      "--anno-header", "--count-kmers", "-o",
                      str(tmp / f"{g}a"), fa])
    return tmp


def test_cli_wide_keys_match_jax(wide_graphs):
    """Labels and counts modes (and matches with --fwd-and-reverse on
    DNA) on every wide graph: the JAX CLI's bytes; the routes that the
    port takes, and kernel A's or B's key width."""
    from metagraph_tpu.cli.main import main as jax_main
    from metagraph_tpu_torch.convert import load
    from metagraph_tpu_torch.query.pipeline import route_of
    tmp = wide_graphs
    lines = []
    for g, (alphabet, _, _) in GRAPHS.items():
        q = str(tmp / ("qprot.fa" if alphabet == "Protein" else "qdna.fa"))
        modes = [["--query-mode", "labels"], ["--query-mode", "counts"]]
        if alphabet == "DNA":
            modes.append(["--query-mode", "matches", "--fwd-and-reverse"])
        lines += [["query", "-i", str(tmp / f"{g}.dbg"), "-a",
                   str(tmp / f"{g}a.column.annodbg"), *m, "--device", q]
                  for m in modes]
    spec, res = tmp / "lines.json", tmp / "out.json"
    spec.write_text(json.dumps([a + ["--torch-device", "cpu"]
                                for a in lines]))
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", RUNNER, str(spec), str(res)],
                         capture_output=True, env=env, cwd=str(tmp),
                         timeout=600)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    for args, got in zip(lines, json.loads(res.read_text())):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            jax_main(args)
        assert got == [buf.getvalue(), 0], args
        assert sum(1 for ln in buf.getvalue().splitlines()
                   if ln.count("\t") >= 2) >= 8
    routes = {g: route_of(load(str(tmp / f"{g}.dbg"),
                               str(tmp / f"{g}a.column.annodbg")))
              for g in GRAPHS}
    assert routes == {"dna70": "codes", "dna70c": "map", "dna70p": "map",
                      "prot40": "map"}
    assert tops.key_words(70, 4) == 9 and tops.key_words(40, 8) == 10
