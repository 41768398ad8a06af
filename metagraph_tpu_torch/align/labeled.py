"""Annotation-consistent alignment; own copy of
metagraph_tpu/align/labeled.py:23-120 (``AnnotationBuffer``,
``LabeledExtender``; ``words_to_columns`` in place of ``mask_to_columns``;
ref aligner_labeled.{hpp,cpp}, annotation_buffer.{hpp,cpp}).

``AnnotationBuffer`` caches each node's label set as ``n_words`` uint64
words (bit c of word c // 64 for label c), fetched from the annotation in
one batch of rows for all the nodes it has not seen yet.  A
``LabeledExtender`` carries the buffer into the flat engine (flat.py),
which runs the label pruning of the JAX class's ``call_outgoing`` (:93-113)
inside its waves: every child of a labeled job keeps its parent's label
words ANDed with its node's (a dummy node passes its parent's) and is
dropped when none is left, so an extension never crosses a label
boundary.  The extender gives the engine the seed's words before the job
is admitted (a seed without labels extends to nothing) and labels each
extension with its path's intersection afterwards.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from .config import AlignerConfig
from .extender import DefaultColumnExtender


class AnnotationBuffer:
    def __init__(self, anno_graph):
        self.anno_graph = anno_graph
        self.annotator = anno_graph.annotator
        self.n_words = max(1, -(-int(self.annotator.num_labels) // 64))
        self._slot = {}                  # node -> its row of _words
        self._words = np.zeros((1024, self.n_words), dtype=np.uint64)
        self._n = 0
        # the fetches' seconds and nodes, which ``align -v`` prints
        self.seconds = 0.0
        self.fetched = 0

    def node_words(self, nodes) -> np.ndarray:
        """(n,) node ids -> (n, n_words) uint64 label words (0 for node 0
        and for unannotated nodes); the nodes not seen yet are fetched in
        one batch."""
        nodes = np.asarray(nodes, dtype=np.int64)
        slot = self._slot
        idx = np.fromiter((slot.get(n, -1) for n in nodes.tolist()),
                          dtype=np.int64, count=len(nodes))
        miss = (idx < 0) & (nodes != 0)
        if miss.any():
            self._fetch(np.unique(nodes[miss]))
            idx[miss] = [slot[n] for n in nodes[miss].tolist()]
        out = self._words[np.maximum(idx, 0)]
        out[idx < 0] = 0
        return out

    def _fetch(self, nodes: np.ndarray):
        t0 = time.perf_counter()
        rows = self.anno_graph.graph_to_anno_index(nodes)
        if hasattr(self.annotator, "row_labels"):
            # a column annotation: its row-major index, not a pass over
            # every label
            owner, lab = self.annotator.row_labels(rows)
            words = np.zeros((len(nodes), self.n_words), dtype=np.uint64)
            np.bitwise_or.at(words, (owner, lab >> 6),
                             np.uint64(1) << (lab & 63).astype(np.uint64))
        else:
            mask = np.asarray(self.annotator.get_rows_mask(rows), dtype=bool)
            packed = np.zeros((len(nodes), self.n_words * 8), dtype=np.uint8)
            packed[:, : -(-mask.shape[1] // 8)] = np.packbits(
                mask, axis=1, bitorder="little")
            words = packed.view("<u8").astype(np.uint64)
        need = self._n + len(nodes)
        if need > len(self._words):
            grown = np.zeros((max(need, 2 * len(self._words)),
                              self.n_words), dtype=np.uint64)
            grown[: self._n] = self._words[: self._n]
            self._words = grown
        self._words[self._n: need] = words
        self._slot.update(zip(nodes.tolist(), range(self._n, need)))
        self._n = need
        self.fetched += len(nodes)
        self.seconds += time.perf_counter() - t0

    def path_words(self, nodes) -> np.ndarray:
        """The intersection of the label sets along a path, node 0 (a
        dummy) skipped; empty where the path has no other node."""
        nodes = np.asarray(nodes, dtype=np.int64)
        real = nodes[nodes != 0]
        if not len(real):
            return np.zeros(self.n_words, dtype=np.uint64)
        return np.bitwise_and.reduce(self.node_words(real), axis=0)

    def columns_of_path(self, nodes) -> List[int]:
        return words_to_columns(self.path_words(list(nodes)))


def words_to_columns(words: np.ndarray) -> List[int]:
    bits = np.unpackbits(np.ascontiguousarray(words, dtype="<u8")
                         .view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).tolist()


class LabeledExtender(DefaultColumnExtender):
    """The column extender of one read and orientation with label
    pruning (ref aligner_labeled.hpp:14): the flat engine reads
    ``buffer`` and ``seed_words`` when it admits the job."""

    def __init__(self, graph, config: AlignerConfig, query: bytes,
                 buffer: AnnotationBuffer):
        super().__init__(graph, config, query)
        self.buffer = buffer
        self.seed_words = None

    def seed_labels(self, seed) -> bool:
        """Take the seed's label set; False when it is empty (the seed
        extends to nothing)."""
        self.seed_words = self.buffer.path_words(seed.nodes)
        return bool(self.seed_words.any())

    def label_extensions(self, exts):
        """Each extension's labels: its path's intersection, else the
        seed's."""
        for a in exts:
            w = self.buffer.path_words(a.nodes)
            a.label_columns = words_to_columns(
                w if w.any() else self.seed_words)
        return exts
