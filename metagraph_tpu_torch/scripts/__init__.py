"""Experiments and micro-benchmarks of the port (``python -m
metagraph_tpu_torch.scripts.<name>``)."""
