"""Time the ``align`` path of one or more trees of the port on the card, on
the same graph and reads.

    python metagraph_tpu_torch/scripts/align_times.py [--root DIR ...]
        [--reads N] [--profile-reads N] [--rehearse]

``--root`` names a tree whose ``metagraph_tpu_torch`` aligns (by default
the one this file lives in).  Given more than once, the trees run in
turns on one card, a process a turn (the align path imports its modules
lazily, so two trees cannot share a process): in the order given, then in
reverse (parent, change, change, parent for two), so that a commit
unpacked with ``git archive`` and the working tree compare on one card.  The inputs come from fixed
seeds, as ``chip_smoke.py``'s phase 8 draws them: 1,000 random references
of 8,101 bp, each with a repeat of 300 bp of itself, their graph at k = 31
built once by the first tree's ``DBGSuccinct.build`` on the card and saved
in the mmap layout (each tree loads it with its own ``DBGSuccinct.load``),
and reads of 150 bp: 5% random, a quarter of the rest error-free, the
others with 1% substitutions and, a tenth of them, an indel of 1-3 bp,
half reverse-complemented.

Each turn aligns 20 reads (the graph's lazy tables), then ``--reads``
reads through ``DBGAligner.align_batch`` on the card, and prints its wall,
seeding and wave seconds, the engine's host seconds (the wall less both),
its waves and rows, and the bytes its waves copy: as the tree's ``STATS``
count them, or, for a tree whose ``STATS`` has no byte counts (the
engine on ``compute_wave``), four int32 planes and 17 B a row up and three
planes down, computed from its rows and cells.  Every turn's alignments
must equal the first turn's.  Each tree's first turn then aligns
``--profile-reads`` reads once more under ``torch.profiler``: the device
time of the batch's kernels and copies, by name.  The last line is a JSON object of it all
with the card's name and power limit.  ``--rehearse``: tiny sizes on the
CPU with the plain versions; exits 2 without a result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

SEED = 20
K = 31
FULL = dict(n_refs=1000, base_len=8101, repeat=(1000, 1300), read_len=150,
            warm=20)
TINY = dict(n_refs=12, base_len=601, repeat=(100, 160), read_len=150,
            warm=3)


def load_port(root: str) -> SimpleNamespace:
    """Import ``root``'s metagraph_tpu_torch (in a process of its own);
    it builds its kernels into its own ``build/torch_kernels``."""
    sys.path.insert(0, root)
    mods = {n: importlib.import_module(f"metagraph_tpu_torch.{n}")
            for n in ("align.aligner", "align.wave_extender",
                      "graph.dbg_succinct")}
    assert mods["align.aligner"].__file__.startswith(root)
    return SimpleNamespace(root=root, aligner=mods["align.aligner"],
                           wx=mods["align.wave_extender"],
                           dbg=mods["graph.dbg_succinct"].DBGSuccinct)


def references(s, rng):
    a, b = s["repeat"]
    refs = []
    for _ in range(s["n_refs"]):
        base = rng.integers(0, 4, s["base_len"]).astype(np.uint8)
        refs.append(np.concatenate([base, base[a:b]]))
    return refs


def reads(rng, refs, n, m):
    letters = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(n):
        u = rng.random()
        if u < 0.05:
            codes = rng.integers(0, 4, m).astype(np.uint8)
        else:
            r = refs[int(rng.integers(0, len(refs)))]
            a = int(rng.integers(0, len(r) - m - 3))
            codes = r[a: a + m + 3].copy()
            if u >= 0.05 + 0.95 / 4:
                sub = rng.random(len(codes)) < 0.01
                codes[sub] = (codes[sub]
                              + rng.integers(1, 4, int(sub.sum()))) % 4
                if rng.random() < 0.1:
                    at, d = int(rng.integers(20, m - 20)), \
                        int(rng.integers(1, 4))
                    codes = np.concatenate([codes[:at], codes[at + d:]]) \
                        if rng.random() < 0.5 else np.concatenate(
                            [codes[:at], rng.integers(0, 4, d)
                             .astype(np.uint8), codes[at:]])
            codes = codes[:m]
        if rng.random() < 0.5:
            codes = 3 - codes[::-1]
        out.append(letters[codes].tobytes())
    return out


def digest(batch) -> str:
    import hashlib
    keys = [[(a.score, a.cigar.to_string(), list(map(int, a.nodes)),
              a.offset, bool(a.orientation)) for a in r] for r in batch]
    return hashlib.sha256(repr(keys).encode()).hexdigest()


def turn(port, graph, warm, batch, dev, torch):
    """Align ``warm`` then ``batch``: -> (alignments, numbers)."""
    aligner = port.aligner.DBGAligner(graph, device=dev)
    aligner.align_batch(warm)
    stats, seed0 = port.wx.STATS, port.aligner.SEED_SECONDS[0]
    before = dict(stats)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = aligner.align_batch(batch)
    wall = time.perf_counter() - t0
    d = {k: v - before[k] for k, v in stats.items()}
    seeding = port.aligner.SEED_SECONDS[0] - seed0
    W = d["cells"] // max(d["rows"], 1)
    up = d.get("bytes_up", d["rows"] * (16 * W + 17))
    down = d.get("bytes_down", d["cells"] * 12)
    return got, dict(
        reads=len(batch), wall_s=wall, reads_per_s=len(batch) / wall,
        seeding_s=seeding, waves_s=d["seconds"],
        engine_host_s=wall - seeding - d["seconds"], waves=d["waves"],
        rows=d["rows"], bytes_up=up, bytes_down=down,
        bytes_tables=d.get("bytes_tables", 0),
        bytes_counted="STATS" if "bytes_up" in d else "computed")


def profile(port, graph, batch, dev, torch) -> dict:
    """Device ms of one batch's kernels and copies (torch.profiler), by
    name, the largest first."""
    if dev.type != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile as prof
    aligner = port.aligner.DBGAligner(graph, device=dev)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        aligner.align_batch(batch)
        torch.cuda.synchronize()
    ms = {}
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            ms[e.key] = ms.get(e.key, 0.0) + us / 1e3
    return dict(sorted(ms.items(), key=lambda kv: -kv[1]))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def inputs(s, n):
    """The seeded references and the warm and counted reads."""
    rng = np.random.default_rng(SEED)
    refs = references(s, rng)
    warm = reads(rng, refs, s["warm"], s["read_len"])
    return refs, warm, reads(rng, refs, n, s["read_len"])


def child(args, s, torch, dev) -> int:
    """One turn of one tree: -> a JSON line (numbers, digest, profile)."""
    port = load_port(args.child)
    _, warm, batch = inputs(s, args.reads)
    graph = port.dbg.load(args.graph)
    got, numbers = turn(port, graph, warm, batch, dev, torch)
    numbers["digest"] = digest(got)
    if args.profile_reads:
        numbers["device_ms"] = profile(port, graph,
                                       batch[: args.profile_reads], dev,
                                       torch)
    print(json.dumps(numbers))
    return 0


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append",
                    help="a tree to time (repeat to time several in turns)")
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--profile-reads", type=int, default=500)
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU with the plain versions; "
                         "exits 2 without a result")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--graph", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not args.rehearse and not torch.cuda.is_available():
        print("align_times: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cpu" if args.rehearse else "cuda")
    s = TINY if args.rehearse else FULL
    if args.child:
        return child(args, s, torch, dev)
    roots = [os.path.abspath(r) for r in
             args.root or [os.path.dirname(os.path.dirname(here))]]
    if not args.rehearse:
        print(card(), flush=True)
    t0 = time.perf_counter()
    refs, _, _ = inputs(s, 0)
    letters = np.frombuffer(b"ACGT", np.uint8)
    g = load_port(roots[0]).dbg.build(
        [letters[r].tobytes() for r in refs], K, device=dev)
    work = tempfile.mkdtemp(prefix="align_times_")
    path = os.path.join(work, "g")
    g.save(path, mmap_layout=True)
    del g
    print(f"graph built in {time.perf_counter() - t0:.1f} s", flush=True)
    turns = roots + roots[::-1] if len(roots) > 1 else roots
    times = {r: [] for r in roots}
    device = {}
    first = None
    for i, root in enumerate(turns):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root,
               "--graph", path + ".dbg.npz", "--reads", str(args.reads),
               "--profile-reads",
               str(0 if times[root] else args.profile_reads)]
        if args.rehearse:
            cmd.append("--rehearse")
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-8000:])
            raise RuntimeError(f"turn {i + 1} ({root}) failed")
        numbers = json.loads(res.stdout.strip().splitlines()[-1])
        if first is None:
            first = numbers["digest"]
        elif numbers["digest"] != first:
            raise AssertionError(f"{root}: its alignments differ from the "
                                 "first turn's")
        dms = numbers.pop("device_ms", None)
        if dms is not None:
            device[root] = dms
            top = list(dms.items())[:8]
            print(f"device ms, {args.profile_reads} reads, {root}: "
                  f"{sum(dms.values()):.3f} in all; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in top), flush=True)
        print(f"turn {i + 1}: {root}: " + json.dumps(numbers), flush=True)
        times[root].append(numbers)
    if args.rehearse:
        print("rehearsal finished: no result on the CPU", file=sys.stderr)
        return 2
    print(json.dumps({"turns": times, "device_ms": device, "card": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
