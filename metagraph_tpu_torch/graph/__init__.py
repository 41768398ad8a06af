"""Graph representations: ``GRAPH_CLASSES`` maps the ``graph_type`` of a
``.dbg.npz`` to its class, and ``build_graph`` builds any of them (own copy
of metagraph_tpu/graph/__init__.py; the classes are imported at the first
lookup)."""


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


def build_graph(representation: str, sequences, k: int, mode: str = "basic",
                **kwargs):
    """The graph ``representation`` of ``sequences`` (the JAX factory,
    metagraph_tpu/graph/__init__.py:29-44); ``kwargs`` go to its
    ``build`` (``alphabet``, ``device``, ...).  Without an alphabet each
    builds a DNA graph, as the JAX ``build --graph`` does."""
    return GRAPH_CLASSES[representation].build(sequences, k, mode=mode,
                                               **kwargs)
