"""Graph representations: ``GRAPH_CLASSES`` maps the ``graph_type`` of a
``.dbg.npz`` to its class (own copy of metagraph_tpu/graph/__init__.py:1-24;
the classes are imported at the first lookup)."""


def _classes():
    from .dbg_succinct import DBGSuccinct
    from .hash_graph import DBGBitmapGraph, DBGHashGraph
    from .sshash_graph import DBGSSHashGraph
    return {"succinct": DBGSuccinct, "bitmap": DBGBitmapGraph,
            "hash": DBGHashGraph, "hashfast": DBGHashGraph,
            "hashstr": DBGHashGraph, "sshash": DBGSSHashGraph}


class _LazyClasses(dict):
    def __missing__(self, key):
        self.update(_classes())
        return dict.__getitem__(self, key)


GRAPH_CLASSES = _LazyClasses()
