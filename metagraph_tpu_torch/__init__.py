"""metagraph_tpu_torch: the PyTorch/CUDA port of metagraph_tpu.

The port serves the annotated batch query (``metagraph query --device``,
``server_query --device``) and builds succinct graphs (``build --device``:
``graph/dbg_succinct.py::DBGSuccinct.build``, ``succinct/device_build.py``)
on one NVIDIA Hopper card with hand-written kernels (``csrc/``), and keeps
a plain PyTorch version of every kernel beside it for CPU tensors.  It imports
neither ``jax`` nor ``metagraph_tpu``: the host-side code it needs is copied
into this package.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back.
"""

__version__ = "0.1.0"
