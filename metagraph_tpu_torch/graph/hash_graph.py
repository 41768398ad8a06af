"""Hash- and bitmap-backed de Bruijn graphs: built from sequences, written
to and read from the JAX package's ``.dbg.npz`` artifacts, mapped and
traversed as the aligner walks them.

Own copy of metagraph_tpu/graph/hash_graph.py: ``_KmerGraphBase`` (the
graph API of :45-108, ``node_kmers_and_ids``, ``save``, ``load_generic``,
:110-140), ``DBGHashGraph`` (also ``hashfast`` and ``hashstr``; :142-200)
and ``DBGBitmapGraph`` (:203-270), each with ``build``, ``rebuild``,
``call_kmers``, ``num_nodes`` and ``max_index``.

``build`` runs on ``device`` (the card unless "cpu"): the valid windows
of the sequences, in the JAX package's stream order (each sequence's
forward windows, then in canonical mode the reverse complement's), packed
left to right into 64-bit words (``_stream_windows``), every sort through
kernel D2 (``packing.lexsort_rows``, ``radix_sort``).  A hash graph's node
id is the rank of a k-mer's first occurrence in that stream, as the JAX
graph's insertion-ordered dict gives it; a bitmap graph's is the k-mer's
rank in sorted order (codes compared left to right).

Loading does not read node ids from the file: each type's ``rebuild``
makes them as the JAX one does, a hash graph by inserting the saved
k-mers in the order of their saved ids (first occurrence wins), a bitmap
graph by sorting.  A graph holds its k-mers as (N, k) codes in node-id
order (an sshash graph in its bucket order, with their ids).

Mapping and traversal give the values of the JAX graph's per-k-mer
``_kmer_id`` (a dict, a binary search or a minimizer bucket there), with
batch forms for the aligner: every lookup packs its k-mers as the query
index packs them (``pack_kmers32``, BOSS order) and probes a hash table
of the graph's own ``node_kmers_and_ids`` through kernel A
(``succinct/ops.py::key_lookup``), one launch a batch and none for an
empty one, on the device that ``use_device`` names (the card unless
"cpu", where the plain version runs).  The table is built at the first
lookup on a device, or taken from a ``QueryEngine`` that holds the same
one (``share_index``); a pickled graph leaves it behind.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kmer import packing
from ..kmer.alphabets import ALPHABETS, DNA

# the JAX package's reverse complement of a read for a canonical graph's
# mapping (hash_graph.py:271-273): lower case comes back upper, U as A
_REVCOMP = bytes.maketrans(b"ACGTacgtUu", b"TGCATGCAAA")

BASIC = "basic"
CANONICAL = "canonical"


def _stream_windows(sequences, k: int, alphabet: str, canonical: bool,
                    device):
    """The valid k-windows of ``sequences`` (bytes or str) on ``device``, in
    the order the JAX graphs insert them: each sequence's forward windows
    left to right, then, if ``canonical``, the windows of its reverse
    complement left to right (the reverse complements of its forward
    windows from the last to the first).  -> (n, W) int64 words, the codes
    packed left to right (``packing.pack_rows``; 4 or 8 bits a code)."""
    from ..device import resolve_device
    from ..kmer.extractor import KmerExtractor
    dev = resolve_device(device)
    ex = KmerExtractor(ALPHABETS[alphabet])
    codes = ex._concat_codes(sequences)
    order = np.arange(k)
    n = len(codes) - k + 1
    if n <= 0:
        return torch.zeros((0, ex._words(k)), dtype=torch.int64, device=dev)
    bad = np.concatenate([[0], np.cumsum(codes >= ex.invalid)])
    at = np.flatnonzero((bad[k:] - bad[:-k]) == 0)
    codes_t = torch.from_numpy(codes).to(dev)
    comp = torch.from_numpy(ex.extended_complement_table()).to(dev) \
        if canonical else None
    if canonical and len(at):
        # a sequence's windows are a run of ``at``; its block of the stream
        # is the run, then the run reversed as reverse complements
        ends = np.cumsum([len(s) + 1 for s in sequences])
        seq = np.searchsorted(ends, at, side="right")
        start = np.searchsorted(seq, seq, side="left")
        end = np.searchsorted(seq, seq, side="right")
        pos = np.arange(len(at))
        block = 2 * start + (pos - start)               # forward slot
        rc_slot = 2 * start + (end - start) + (end - 1 - pos)
        src = np.empty(2 * len(at), np.int64)
        strand = np.empty(2 * len(at), bool)
        src[block], strand[block] = at, False
        src[rc_slot], strand[rc_slot] = at, True
        src_t = torch.from_numpy(src).to(dev)
        rc_t = torch.from_numpy(strand).to(dev)

        def col(j):
            fwd = codes_t[src_t + j]
            return torch.where(rc_t, comp[codes_t[src_t + (k - 1 - j)]
                                          .long()], fwd)
        return packing.pack_rows(col, order, ex.bits)
    at_t = torch.from_numpy(at).to(dev)
    return packing.pack_rows(lambda j: codes_t[at_t + j], order, ex.bits)


def _device_key(dev) -> str:
    """A device's name with its index ("cuda" is the current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def key_table(graph) -> torch.Tensor:
    """Kernel A's table of ``graph.node_kmers_and_ids()`` (``pack_kmers32``
    keys, node ids) on ``graph.device``, built at the first call on that
    device and kept in ``graph._tables``."""
    from ..device import resolve_device
    from ..succinct.ops import DeviceHashIndex, pack_kmers32
    dev = resolve_device(graph.device)
    table = graph._tables.get(_device_key(dev))
    if table is None:
        chars, ids = graph.node_kmers_and_ids()
        table = DeviceHashIndex.from_packed(
            pack_kmers32(chars, packing.bits_for_alphabet(graph.alph.sigma)),
            ids.astype(np.uint32), device=dev).table
        graph._tables[_device_key(dev)] = table
    return table


def _rows(kmers: np.ndarray) -> np.ndarray:
    """(N, k) uint8 codes -> (N,) opaque keys that compare as the rows do,
    code by code from the left."""
    kmers = np.ascontiguousarray(kmers, dtype=np.uint8)
    return kmers.view(f"V{kmers.shape[1]}").ravel()


class _KmerGraphBase:
    GRAPH_TYPE = "hash"

    def __init__(self, kmers: np.ndarray, k: int, mode: str = BASIC,
                 alphabet: str = DNA.name, ids: np.ndarray | None = None):
        self.k = k
        self.mode = mode
        self.alphabet = alphabet          # an ALPHABETS name
        self._kmers = kmers               # (N, k) uint8
        # node id of each row; None: row i is id i + 1
        self._ids = ids
        self.device = None                # where lookups run: use_device
        self._tables = {}                 # device -> kernel A's table
        self._row_of = None               # node id -> row, where _ids is set
        self._extractor = None

    def __getstate__(self):
        """Without the lookup tables and caches, which a worker builds on
        its own device at its first lookup."""
        return dict(self.__dict__, _tables={}, _row_of=None, _extractor=None)

    @property
    def alph(self):
        """The ``Alphabet`` that ``alphabet`` names."""
        return ALPHABETS[self.alphabet]

    @property
    def extractor(self):
        from ..kmer.extractor import KmerExtractor
        if self._extractor is None:
            self._extractor = KmerExtractor(self.alph)
        return self._extractor

    def node_kmers_and_ids(self):
        """-> ((N, k) uint8 codes, (N,) int64 node ids), in the order of
        the JAX graph's ``call_kmers``."""
        ids = self._ids if self._ids is not None else np.arange(
            1, len(self._kmers) + 1, dtype=np.int64)
        return self._kmers, ids

    def call_kmers(self):
        chars, ids = self.node_kmers_and_ids()
        for i in range(len(ids)):
            yield int(ids[i]), chars[i]

    def max_index(self) -> int:
        return len(self._kmers)

    def num_nodes(self) -> int:
        return len(self._kmers)

    # ------------------------------------------------------------ lookups
    def use_device(self, device):
        """Run this graph's lookups on ``device`` (the card unless
        "cpu"); -> the graph."""
        from ..device import resolve_device
        self.device = resolve_device(device)
        return self

    def share_index(self, table: torch.Tensor):
        """Take ``table``, kernel A's table of this graph's
        ``node_kmers_and_ids`` packed by ``pack_kmers32`` (a
        ``QueryEngine``'s over the same graph), as the lookup table on its
        device, so that it is not built and uploaded again."""
        self._tables[_device_key(table.device)] = table

    def _table(self) -> torch.Tensor:
        return key_table(self)

    @property
    def _bits(self) -> int:
        return packing.bits_for_alphabet(self.alph.sigma)

    def _valid_rows(self, chars: np.ndarray) -> np.ndarray:
        """The rows the JAX ``_kmer_id`` may find: every code a real
        character (below sigma)."""
        return (chars < self.alph.sigma).all(axis=1)

    def map_kmers_batch(self, chars: np.ndarray) -> np.ndarray:
        """(n, k) code rows -> (n,) int64 node ids (0: not in the graph),
        the JAX ``_kmer_id`` of each: one kernel A launch over the valid
        rows, none when there is none."""
        from .._u32 import np_words
        from ..succinct.ops import key_lookup, pack_kmers32
        chars = np.asarray(chars, dtype=np.uint8).reshape(-1, self.k)
        out = np.zeros(len(chars), dtype=np.int64)
        ok = self._valid_rows(chars)
        if not ok.any() or not len(self._kmers):
            return out
        table = self._table()
        keys = np_words(pack_kmers32(chars[ok], self._bits))
        out[ok] = key_lookup(keys.to(table.device), table).cpu().numpy()
        return out

    def _node_rows(self, nodes) -> np.ndarray:
        """Node ids -> rows of ``_kmers``; as the JAX graph indexes its
        k-mers by ``node - 1``, node 0 reads the last row (and a row past
        the end raises IndexError there too)."""
        nodes = np.asarray(nodes, dtype=np.int64)
        if self._ids is None:
            return nodes - 1
        if self._row_of is None:
            self._row_of = np.full(int(self._ids.max(initial=0)) + 1, -1,
                                   dtype=np.int64)
            self._row_of[self._ids] = np.arange(len(self._ids))
        rows = np.full(len(nodes), -1, dtype=np.int64)
        inside = (nodes >= 0) & (nodes < len(self._row_of))
        rows[inside] = self._row_of[nodes[inside]]
        if (rows < 0).any():
            raise IndexError("node id not in the graph")
        return rows

    def _node_chars(self, node: int) -> np.ndarray:
        return self._kmers[self._node_rows([node])[0]]

    # ------------------------------------------------------------ mapping
    def map_to_nodes_sequentially_batch(self, sequences) -> list:
        """``map_to_nodes_sequentially`` of each sequence, in one lookup:
        the sequences joined by an invalid code, so that no window crosses
        two."""
        ex, k = self.extractor, self.k
        parts = [ex.encode(s) for s in sequences]
        if not parts:
            return []
        sep = np.array([ex.invalid], dtype=np.uint8)
        cat = np.concatenate([x for p in parts for x in (p, sep)])
        nodes = np.zeros(max(len(cat) - k + 1, 0), dtype=np.int64)
        if len(nodes):
            wins = np.lib.stride_tricks.sliding_window_view(cat, k)
            bad = np.concatenate([[0], np.cumsum(cat >= self.alph.sigma)])
            valid = (bad[k:] - bad[:-k]) == 0
            if valid.any():
                nodes[valid] = self.map_kmers_batch(wins[valid])
        out, at = [], 0
        for p in parts:
            out.append(nodes[at: at + max(len(p) - k + 1, 0)])
            at += len(p) + 1
        return out

    def map_to_nodes_sequentially(self, sequence) -> np.ndarray:
        """The node of every k-mer window as it is, 0 where none."""
        return self.map_to_nodes_sequentially_batch([sequence])[0]

    def map_to_nodes_batch(self, sequences, sequentially: bool = False
                           ) -> list:
        """``map_to_nodes`` (or, ``sequentially``,
        ``map_to_nodes_sequentially``) of each sequence, in one lookup."""
        seqs = [s.encode() if isinstance(s, str) else s for s in sequences]
        if self.mode != CANONICAL or sequentially:
            return self.map_to_nodes_sequentially_batch(seqs)
        got = self.map_to_nodes_sequentially_batch(
            seqs + [bytes(s).translate(_REVCOMP)[::-1] for s in seqs])
        n = len(seqs)
        return [np.where(f > 0, f, b[::-1]) for f, b in zip(got[:n],
                                                            got[n:])]

    def map_to_nodes(self, sequence) -> np.ndarray:
        """The node of every window; in canonical mode a forward miss
        takes the reverse complement's hit (hash_graph.py:55-63)."""
        return self.map_to_nodes_batch([sequence])[0]

    # ---------------------------------------------------------- traversal
    def get_node_sequence(self, node: int) -> bytes:
        return self.alph.decode_table[self._node_chars(node)].tobytes()

    def _neighbours(self, nodes, outgoing: bool) -> np.ndarray:
        """(n,) nodes -> (n, sigma - 1) ids of each node's successors (or
        predecessors) by codes 1 .. sigma - 1, 0 where none: one lookup."""
        rows = self._node_rows(nodes)
        sig, k = self.alph.sigma, self.k
        cand = np.empty((len(rows), sig - 1, k), dtype=np.uint8)
        par = self._kmers[rows][:, None, :]
        if outgoing:
            cand[:, :, :-1] = par[:, :, 1:]
            cand[:, :, -1] = np.arange(1, sig)
        else:
            cand[:, :, 1:] = par[:, :, :-1]
            cand[:, :, 0] = np.arange(1, sig)
        return self.map_kmers_batch(cand.reshape(-1, k)).reshape(
            len(rows), sig - 1)

    def _listed(self, ids: np.ndarray):
        table = self.alph.decode_table
        return [(int(n), chr(table[c + 1])) for c, n in enumerate(ids) if n]

    def call_outgoing_kmers(self, node: int):
        """[(next node, char)] by codes 1 .. sigma - 1."""
        return self._listed(self._neighbours([node], True)[0])

    def call_incoming_kmers(self, node: int):
        """[(previous node, char)] by codes 1 .. sigma - 1."""
        return self._listed(self._neighbours([node], False)[0])

    def traverse(self, node: int, ch: str) -> int:
        c = int(self.extractor.encode(ch)[0])
        if c >= self.alph.sigma:
            return 0
        chars = self._node_chars(node)
        return int(self.map_kmers_batch(
            np.concatenate([chars[1:], [c]]).astype(np.uint8))[0])

    def outdegree(self, node: int) -> int:
        return len(self.call_outgoing_kmers(node))

    def indegree(self, node: int) -> int:
        return len(self.call_incoming_kmers(node))

    def has_multiple_outgoing(self, node: int) -> bool:
        return self.outdegree(node) > 1

    def has_single_incoming(self, node: int) -> bool:
        return self.indegree(node) == 1

    # -------------------------------------------------- batch traversal
    def call_outgoing_batch(self, nodes):
        """``call_outgoing_kmers`` of a node array in one lookup: ->
        (owner, child, char code), flat, each node's children by code, the
        code ``ord`` of the upper-cased character, as the JAX flat
        engine's per-node loop gives them (align/flat.py:125-138)."""
        ids = self._neighbours(nodes, True)
        owner, c = np.nonzero(ids)
        upper = np.array([ord(chr(b).upper()) for b in
                          self.alph.decode_table[1: self.alph.sigma]],
                         dtype=np.int64)
        return owner.astype(np.int64), ids[owner, c], upper[c]

    def has_multiple_outgoing_batch(self, nodes) -> np.ndarray:
        return (self._neighbours(nodes, True) > 0).sum(axis=1) > 1

    def has_single_incoming_batch(self, nodes) -> np.ndarray:
        return (self._neighbours(nodes, False) > 0).sum(axis=1) == 1

    # ------------------------------------------------------------ storage
    def save(self, path: str):
        """``<path>.dbg.npz`` (or ``path`` if it ends in .npz) with the JAX
        graph's keys, dtypes and arrays (hash_graph.py:122-128)."""
        from ..utils.npz import savez
        chars, ids = self.node_kmers_and_ids()
        out = path if path.endswith(".npz") else path + ".dbg.npz"
        savez(out, graph_type=self.GRAPH_TYPE, k=self.k, mode=self.mode,
              kmers=chars, ids=ids, alphabet=self.alphabet)

    @classmethod
    def load_generic(cls, z) -> "_KmerGraphBase":
        """An open ``.dbg.npz`` with a ``graph_type`` -> its graph."""
        from . import GRAPH_CLASSES
        gcls = GRAPH_CLASSES[str(z["graph_type"])]
        alpha = str(z["alphabet"]) if "alphabet" in z.files else DNA.name
        return gcls.rebuild(z["kmers"], z["ids"], int(z["k"]),
                            str(z["mode"]), alphabet=alpha)


class DBGHashGraph(_KmerGraphBase):
    """The insertion-ordered k-mer dictionary: node id = insertion rank."""

    @classmethod
    def build(cls, sequences, k: int, mode: str = BASIC, alphabet=DNA,
              device=None, **_) -> "DBGHashGraph":
        """The JAX ``DBGHashGraph.build`` (hash_graph.py:150-171) on
        ``device``: one stable D2 sort of the stream's windows keeps each
        k-mer's first position; the positions, sorted (D2), give the k-mers
        in id order."""
        from ..succinct.device_build import radix_sort
        name = getattr(alphabet, "name", alphabet)
        packed = _stream_windows(sequences, k, name, mode == CANONICAL,
                                 device)
        n = packed.shape[0]
        if n == 0:
            return cls(np.zeros((0, k), np.uint8), k, mode, name)
        perm = packing.lexsort_rows(packed)
        first = perm[packing.new_rows(packed.index_select(0, perm))]
        first, _ = radix_sort(first, max(int(n - 1).bit_length(), 1))
        bits = packing.bits_for_alphabet(ALPHABETS[name].sigma)
        chars = packing.unpack_rows(packed.index_select(0, first), k,
                                    np.arange(k), bits)
        return cls(chars.cpu().numpy(), k, mode, name)

    @classmethod
    def rebuild(cls, kmers, ids, k, mode,
                alphabet: str = DNA.name) -> "DBGHashGraph":
        """The saved k-mers inserted in the (stable) order of their saved
        ids; a k-mer seen before keeps its first id."""
        kmers = np.asarray(kmers, dtype=np.uint8).reshape(-1, k)
        kmers = kmers[np.argsort(np.asarray(ids), kind="stable")]
        _, first = np.unique(_rows(kmers), return_index=True)
        return cls(kmers[np.sort(first)], k, mode, alphabet)


class DBGBitmapGraph(_KmerGraphBase):
    """The sorted k-mer rank dictionary: node id = rank of the k-mer in
    sorted order."""

    GRAPH_TYPE = "bitmap"

    @classmethod
    def build(cls, sequences, k: int, mode: str = BASIC, alphabet=DNA,
              device=None, **_) -> "DBGBitmapGraph":
        """The JAX ``DBGBitmapGraph.build`` (hash_graph.py:211-220) on
        ``device``: the distinct valid k-mers (both strands in canonical
        mode) sorted by their left-to-right keys (D2)."""
        name = getattr(alphabet, "name", alphabet)
        packed = _stream_windows(sequences, k, name, mode == CANONICAL,
                                 device)
        keys, _ = packing.unique_rows(packed)
        bits = packing.bits_for_alphabet(ALPHABETS[name].sigma)
        return cls(packing.unpack_rows(keys, k, np.arange(k), bits)
                   .cpu().numpy(), k, mode, name)

    @classmethod
    def rebuild(cls, kmers, ids, k, mode,
                alphabet: str = DNA.name) -> "DBGBitmapGraph":
        kmers = np.asarray(kmers, dtype=np.uint8).reshape(-1, k)
        return cls(kmers[np.argsort(_rows(kmers), kind="stable")], k, mode,
                   alphabet)
