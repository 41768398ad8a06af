"""The port's multi-device query (metagraph_tpu/parallel/sharding.py's
query half) on torch.distributed: ``mesh`` (axes, groups, ``pmax``, the
collectives' record), ``launch`` (ranks as fresh interpreters, a
FileStore rendezvous), ``sharding`` (the sharded steps) and ``programs``
(the rank programs that tests and chip_smoke.py launch)."""
