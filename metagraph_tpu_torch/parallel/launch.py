"""Start the ranks of a mesh as fresh interpreters and collect their results.

    python -m metagraph_tpu_torch.parallel.launch DIR RANK

is one rank; ``launch`` starts them all.  ``launch(target, shape, inputs)``
writes ``inputs`` to a temporary directory (numpy arrays as ``.npy`` files,
which the ranks map read-only; other values pickled with the spec), starts
one ``python -m metagraph_tpu_torch.parallel.launch`` a rank, and each rank
joins a ``FileStore`` in that directory, builds its ``Mesh``, imports the
``target`` ("module:function", a function of this package) and writes what
``target(mesh, **inputs)`` returns.  A rank fails if ``jax`` or
``metagraph_tpu`` is in its modules when the target returns: the port's
ranks import neither.  The launcher waits for every rank up to ``timeout``
seconds, kills the others when one fails, and returns the results by rank.

Devices: "cuda" (rank r on card r mod the cards it sees, so that several
ranks share one card when there is one; without a card the ranks fail), or
"cpu" when the caller asks for it.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SPEC = "spec.pkl"


def launch(target: str, shape: dict, inputs: dict, backend: str = "gloo",
           device: str = "cuda", timeout: float = 600.0,
           tmp_dir: str | None = None) -> list:
    """Run ``target(mesh, **inputs)`` on every rank of a mesh of ``shape``
    -> the list of its results by rank.  The inputs' files go to a new
    directory under ``tmp_dir`` (the system's temporary directory by
    default), removed at the end.  Raises RuntimeError naming the rank that
    failed, with the end of its output."""
    if not target.startswith("metagraph_tpu_torch."):
        raise ValueError(f"target {target!r} is not in metagraph_tpu_torch")
    world = int(np.prod(list(shape.values())))
    work = tempfile.mkdtemp(prefix="mesh-", dir=tmp_dir)
    procs = []
    try:
        arrays, values = {}, {}
        for name, v in inputs.items():
            if isinstance(v, np.ndarray):
                np.save(os.path.join(work, name + ".npy"), v)
                arrays[name] = name + ".npy"
            else:
                values[name] = v
        with open(os.path.join(work, _SPEC), "wb") as f:
            pickle.dump(dict(target=target, shape=dict(shape),
                             backend=backend, device=device, arrays=arrays,
                             values=values), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        for r in range(world):
            log = open(os.path.join(work, f"log{r}.txt"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "metagraph_tpu_torch.parallel.launch",
                 work, str(r)], stdout=log, stderr=subprocess.STDOUT,
                env=env, cwd=work), log))
        deadline = time.monotonic() + timeout
        pending = set(range(world))
        while pending:
            for r in sorted(pending):
                rc = procs[r][0].poll()
                if rc is None:
                    continue
                pending.discard(r)
                if rc:
                    raise RuntimeError(f"rank {r} of {target} exited with "
                                       f"{rc}:\n{_tail(work, r)}")
            if pending and time.monotonic() > deadline:
                raise RuntimeError(f"{target}: ranks {sorted(pending)} "
                                   f"still running after {timeout} s:\n"
                                   + _tail(work, min(pending)))
            time.sleep(0.05)
        out = []
        for r in range(world):
            with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)


def _tail(work: str, rank: int, n: int = 4000) -> str:
    with open(os.path.join(work, f"log{rank}.txt"), "rb") as f:
        return f.read()[-n:].decode(errors="replace")


def _rank_main(work: str, rank: int) -> int:
    import torch
    import torch.distributed as dist
    from .mesh import Mesh
    with open(os.path.join(work, _SPEC), "rb") as f:
        spec = pickle.load(f)
    shape = spec["shape"]
    world = int(np.prod(list(shape.values())))
    device = torch.device(spec["device"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; launch with "
                               "device='cpu' to run the plain versions")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(work, "store"), world)
    dist.init_process_group(spec["backend"], store=store, rank=rank,
                            world_size=world)
    try:
        mesh = Mesh.create(shape, rank, spec["backend"], device)
        inputs = dict(spec["values"])
        for name, fname in spec["arrays"].items():
            inputs[name] = np.load(os.path.join(work, fname), mmap_mode="r")
        module, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(module), fn)(mesh, **inputs)
        leaked = [m for m in ("jax", "metagraph_tpu") if m in sys.modules]
        if leaked:
            raise RuntimeError(f"rank {rank} imported {leaked}")
        tmp = os.path.join(work, f"out{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(work, f"out{rank}.pkl"))
        dist.barrier(group=mesh.host_group)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
