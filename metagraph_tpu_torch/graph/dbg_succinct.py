"""De Bruijn graphs: ``DBGSuccinct.build``, ``save`` and ``load``.

Own copy of the parts of metagraph_tpu/graph/dbg_succinct.py the port uses:

* ``build`` (:38-89), on one of two routes chosen from its arguments
  alone (``build_route``):

  - the device route, the builds that fit the card's 2-bit construction
    (``succinct/device_build.py``, kernels D1-D4): the DNA alphabet, 3 <=
    k <= 21, no counts, window weights, disk swap or memory cap, in mode
    basic (the JAX device construction, with its dummy-node limit),
    primary (JAX builds it from the basic collector: basic's arrays) or
    canonical (both strands: D1's strand mode); the last two are JAX
    host builds, which have no dummy-node limit;
  - the general route, every other build: the host construction
    (``kmer/extractor.py``, ``kmer/disk_sort.py`` for ``disk_swap`` or
    ``mem_cap_bytes``, ``succinct/construct.py``), every row sort on
    the card through kernel D2;

* ``save`` (:602-609), in the npz or the mmap layout;
* ``load`` (:611-655), for every layout it reads:

* the reference-format ``.dbg`` (not a zip file), through
  ``seq_io/refformat.py::load_reference_boss``;
* the mmap layout (``<base>.meta.npz`` beside raw ``.npy`` arrays), where
  it exists and ``mmap`` is asked for (``DEFAULT_MMAP``, which ``--mmap``
  sets) or no ``<base>.npz`` is there;
* a ``.dbg.npz`` whose ``graph_type`` is not ``succinct``: the hash,
  bitmap or sshash graph that ``GRAPH_CLASSES`` names, rebuilt from its
  k-mers (``hash_graph._KmerGraphBase.load_generic``);
* the npz BOSS, of every alphabet (``_alphabet_of``: the recorded name, or
  the alphabet of the table's sigma) and every k;

and the mapping and traversal the aligner walks (:135-600): mapping
(``map_to_nodes_sequentially(_batch)``, ``map_to_nodes`` with its
canonical form, ``map_kmers_batch`` over a sorted-key index; and
``map_to_nodes_batch``, ``annotate``'s, all windows of a batch in one
launch of kernel A over ``key_table``, the valid edges' hash table on
``use_device``'s device), traversal
(``call_outgoing_kmers``, ``call_outgoing_batch`` over a successor-range
table, ``call_incoming_kmers``, ``traverse``, ``has_multiple_outgoing``,
``has_single_incoming`` and their batch forms) and suffix matching
(``call_nodes_with_suffix_matching_longest_prefix``,
``nodes_in_suffix_range``, ``nodes_in_suffix_ranges_batch``,
``get_node_sequence``).  The JAX package's native lookups are left out;
the numpy paths they short-circuit give the same answers.
"""

from __future__ import annotations

import os

import numpy as np

from ..kmer import packing
from ..kmer.alphabets import ALPHABETS, DNA
from ..kmer.extractor import KmerExtractor, _rows_greater
from ..succinct.boss import BOSS

DEFAULT_MMAP = False
DEVICE_K = (3, 21)          # the k the device construction takes
COLLECTOR = {"basic": "basic", "canonical": "both", "primary": "basic"}


def not_ported(what: str, item: str = "A15") -> NotImplementedError:
    """The refusal of a build the port does not make yet: A15 is the
    mesh."""
    return NotImplementedError(f"build: {what} is not ported yet (ROADMAP "
                               f"{item})")


def build_route(k: int, mode: str = "basic", alphabet=DNA.name,
                with_counts: bool = False, window_weights=None,
                disk_swap: str | None = None,
                mem_cap_bytes: int | None = None) -> str:
    """"device" where the build fits the card's 2-bit construction (DNA,
    3 <= k <= 21, no counts, weights, disk swap or memory cap, any mode),
    else "general"."""
    if mode not in COLLECTOR:
        raise ValueError(f"unknown mode {mode!r}")
    name = getattr(alphabet, "name", alphabet)
    if name == DNA.name and DEVICE_K[0] <= k <= DEVICE_K[1] \
            and not with_counts and window_weights is None \
            and disk_swap is None and mem_cap_bytes is None:
        return "device"
    return "general"


class DBGSuccinct:
    def __init__(self, boss: BOSS, k: int, mode: str = "basic",
                 alphabet: str = DNA.name, masked: bool = True):
        self.boss = boss
        self.k = k                      # dbg k (= boss.k + 1)
        self.mode = mode
        self.alphabet = alphabet        # an ALPHABETS name
        self.masked = masked            # dummy edges hidden
        self._extractor = None
        self._host_index = None
        self._succ_ranges = None
        self.device = None              # where map_to_nodes_batch runs
        self._tables = {}               # device -> kernel A's table

    def __getstate__(self):
        """Without the caches, which a worker rebuilds at its first use."""
        return dict(self.__dict__, _extractor=None, _host_index=None,
                    _succ_ranges=None, _tables={})

    @property
    def alph(self):
        """The ``Alphabet`` that ``alphabet`` names."""
        return ALPHABETS[self.alphabet]

    @property
    def extractor(self) -> KmerExtractor:
        ex = self._extractor
        if ex is None or ex.alphabet.name != self.alphabet:
            ex = self._extractor = KmerExtractor(self.alph)
        return ex

    @classmethod
    def build(cls, sequences, k: int, mode: str = "basic",
              alphabet=DNA.name, with_counts: bool = False,
              bits_per_count: int = 8, mask_dummy: bool = True,
              window_weights=None, disk_swap: str | None = None,
              mem_cap_bytes: int | None = None,
              device=None) -> "DBGSuccinct":
        """The graph of ``sequences`` (bytes or str), built on ``device``
        (the card unless "cpu"): the arrays of the JAX
        ``DBGSuccinct.build`` with the same arguments, ``device=True`` or
        not.  ``window_weights``: per sequence, a count a window, summed
        into the k-mer counts in place of occurrences; ``disk_swap`` and
        ``mem_cap_bytes``: the bounded-RAM build's spill directory and
        buffer size (1 << 28 where only the directory is given)."""
        from ..device import resolve_device
        from ..utils.timer import PhaseTimer, trace
        name = getattr(alphabet, "name", alphabet)
        alph = ALPHABETS[name]
        route = build_route(k, mode, name, with_counts, window_weights,
                            disk_swap, mem_cap_bytes)
        dev = resolve_device(device)
        trace(f"build route: {route} ({mode} mode, {name}, k = {k})")
        if route == "device":
            from ..succinct.construct import empty_boss_arrays
            from ..succinct.device_build import device_build_boss_arrays
            seqs = [s if isinstance(s, bytes) else s.encode()
                    for s in sequences]
            arrays = device_build_boss_arrays(
                seqs, k, device=dev,
                strands=2 if COLLECTOR[mode] == "both" else 1,
                bounded=mode == "basic")
            if arrays is None:
                arrays = empty_boss_arrays(k)
        else:
            from ..succinct.construct import build_boss_arrays
            ex = KmerExtractor(alph)
            with PhaseTimer("extract k-mers"):
                if disk_swap is not None or mem_cap_bytes is not None:
                    kmers, counts = ex.extract_disk(
                        sequences, k, mode=COLLECTOR[mode],
                        with_counts=with_counts,
                        window_weights=window_weights,
                        ram_cap_bytes=mem_cap_bytes or (1 << 28),
                        tmp_dir=disk_swap or None, device=dev)
                else:
                    kmers, counts = ex.extract_tensors(
                        sequences, k, COLLECTOR[mode], with_counts,
                        window_weights, dev)
            arrays = build_boss_arrays(kmers, alph.sigma,
                                       counts if with_counts else None,
                                       bits_per_count, device=dev)
        with PhaseTimer("BOSS indexes"):
            boss = BOSS.from_arrays(arrays)
        boss.count_width = bits_per_count
        return cls(boss, k, mode, name, mask_dummy)

    def save(self, path: str, mmap_layout: bool = False):
        """``<path>.dbg.npz`` (or ``path`` itself if it ends in .npz), or
        the mmap layout beside that name."""
        out = path if path.endswith(".npz") else path + ".dbg.npz"
        save = self.boss.save_mmap if mmap_layout else self.boss.save
        save(out, mode=self.mode, masked=self.masked, alphabet=self.alphabet)

    def num_nodes(self) -> int:
        return self.boss.num_valid if self.masked else self.boss.num_edges

    def max_index(self) -> int:
        return self.boss.num_edges

    # ------------------------------------------------- mapping (:135-245)

    def _mask(self, edges: np.ndarray) -> np.ndarray:
        if self.masked:
            return np.where(self.boss.valid[edges] > 0, edges, 0)
        return edges

    def map_to_nodes_sequentially(self, sequence) -> np.ndarray:
        """The node of every k-mer window, no canonical form."""
        return self._mask(self.boss.map_sequence(
            self.extractor.encode(sequence)))

    def map_to_nodes_sequentially_batch(self, sequences) -> list:
        """``map_to_nodes_sequentially`` of many sequences in one lookup:
        joined by an invalid code, so that no window crosses two."""
        ex = self.extractor
        K = self.boss.k + 1
        parts = [ex.encode(s) for s in sequences]
        if not parts:
            return []
        sep = np.array([self.boss.alph_size], dtype=parts[0].dtype)
        glue, offs, off = [], [], 0
        for i, p in enumerate(parts):
            if i:
                glue.append(sep)
                off += 1
            offs.append(off)
            glue.append(p)
            off += len(p)
        res = self._mask(self.boss.map_sequence(np.concatenate(glue)))
        return [res[o: o + len(p) - K + 1] if len(p) >= K
                else np.zeros(0, dtype=np.int64)
                for p, o in zip(parts, offs)]

    def map_to_nodes(self, sequence) -> np.ndarray:
        """The node of every window; a canonical graph maps each k-mer's
        canonical form (the lesser of it and its reverse complement in
        packed order)."""
        if self.mode != "canonical":
            return self.map_to_nodes_sequentially(sequence)
        codes = self.extractor.encode(sequence)
        if len(codes) < self.k:
            return np.zeros(0, dtype=np.int64)
        return self.map_kmers_batch(self._canonical(codes))

    def _canonical(self, codes: np.ndarray, valid=slice(None)):
        """The ``valid`` windows of ``codes``, each as the strand first in
        BOSS order (of it and its reverse complement)."""
        k = self.k
        wins = np.lib.stride_tricks.sliding_window_view(codes, k)[valid]
        rc = np.lib.stride_tricks.sliding_window_view(
            self.extractor.extended_complement_table()[codes[::-1]],
            k)[::-1][valid]
        order = packing.boss_priority_order(k)
        bits = packing.bits_for_alphabet(self.alph.sigma)
        take_rc = _rows_greater(packing.pack_codes(wins, order, bits=bits),
                                packing.pack_codes(rc, order, bits=bits))
        return np.ascontiguousarray(np.where(take_rc[:, None], rc, wins))

    def _build_host_index(self):
        """(sorted packed keys, their edges, their code rows) of the valid
        edges."""
        if self._host_index is None:
            boss = self.boss
            edges = np.flatnonzero(boss.valid).astype(np.int64)
            kchars = boss.get_edge_seq(edges)
            self._host_index = (packing.pack_codes(
                kchars, packing.boss_priority_order(self.k),
                bits=packing.bits_for_alphabet(self.alph.sigma)),
                edges, kchars)
        return self._host_index

    def map_kmers_batch(self, chars: np.ndarray) -> np.ndarray:
        """(N, k) code rows -> node, or 0, through the sorted-key index."""
        keys, ids, _ = self._build_host_index()
        if not len(keys):
            return np.zeros(len(chars), dtype=np.int64)
        sigma = self.alph.sigma
        invalid = (chars >= sigma).any(axis=1) | (chars == 0).any(axis=1)
        q = packing.pack_codes(np.where(invalid[:, None], 1, chars),
                               packing.boss_priority_order(self.k),
                               bits=packing.bits_for_alphabet(sigma))
        pos = packing.searchsorted_rows(keys, q)
        pos_c = np.minimum(pos, len(keys) - 1)
        hit = (pos < len(keys)) & np.all(keys[pos_c] == q, axis=1) \
            & ~invalid
        return np.where(hit, ids[pos_c], 0)

    # ----------------------------------- mapping on the card (kernel A)

    def use_device(self, device):
        """Run ``map_to_nodes_batch`` on ``device`` (the card unless
        "cpu"); -> the graph."""
        from ..device import resolve_device
        self.device = resolve_device(device)
        return self

    def node_kmers_and_ids(self):
        """The valid edges' k-mers (code rows) and their node ids: what
        kernel A's table holds."""
        ids = np.flatnonzero(self.boss.valid)
        return self.boss.get_edge_seq(ids), ids

    def set_key_table(self, table):
        """Take ``table`` (kernel A's table of ``node_kmers_and_ids``
        packed by ``pack_kmers32``: the table of a ``QueryEngine`` whose
        index ``convert.from_graph`` built from this graph) as
        ``key_table`` on its device."""
        from .hash_graph import _device_key
        self._tables[_device_key(table.device)] = table

    def key_table(self):
        """Kernel A's table of the valid edges on ``device``, built at the
        first call (callers that share the graph between threads call it
        first)."""
        from .hash_graph import key_table
        return key_table(self)

    def batch_keys(self, sequences, sequentially: bool = False):
        """The keys that ``map_to_nodes_batch`` looks up: -> (each
        sequence's length in codes, the valid mask over the windows of the
        sequences joined by an invalid code, (n, W) uint32 keys of the
        valid windows, ``pack_kmers32``), the canonical strand chosen in
        canonical mode unless ``sequentially``."""
        from ..succinct.ops import pack_kmers32
        ex, k, sigma = self.extractor, self.k, self.alph.sigma
        parts = [ex.encode(s) for s in sequences]
        lens = [len(p) for p in parts]
        sep = np.array([ex.invalid], dtype=np.uint8)
        cat = np.concatenate([x for p in parts for x in (p, sep)]) \
            if parts else sep[:0]
        valid = np.zeros(max(len(cat) - k + 1, 0), dtype=bool)
        bits = packing.bits_for_alphabet(sigma)
        if not len(valid):
            return lens, valid, pack_kmers32(
                np.zeros((0, k), np.uint8), bits)
        bad = np.concatenate([[0], np.cumsum((cat >= sigma) | (cat == 0))])
        valid = (bad[k:] - bad[:-k]) == 0
        if self.mode == "canonical" and not sequentially:
            sub = self._canonical(cat, valid)
        else:
            sub = np.lib.stride_tricks.sliding_window_view(cat, k)[valid]
        return lens, valid, pack_kmers32(np.ascontiguousarray(sub), bits)

    def map_to_nodes_batch(self, sequences, sequentially: bool = False
                           ) -> list:
        """``map_to_nodes`` (or, ``sequentially``,
        ``map_to_nodes_sequentially``) of each sequence, all windows in one
        launch of kernel A over ``key_table`` (``batch_keys``: the
        sequences joined by an invalid code, so that no window crosses
        two; in canonical mode each window takes the strand first in BOSS
        order)."""
        from .._u32 import np_words
        from ..succinct.ops import key_lookup
        lens, valid, keys = self.batch_keys(sequences, sequentially)
        nodes = np.zeros(len(valid), dtype=np.int64)
        if len(keys) and self.boss.num_valid:
            table = self.key_table()
            nodes[valid] = key_lookup(np_words(keys).to(table.device),
                                      table).cpu().numpy()
        out, at = [], 0
        for n in lens:
            out.append(nodes[at: at + max(n - self.k + 1, 0)])
            at += n + 1
        return out

    # ----------------------------------------------- traversal (:247-470)

    def _valid_node(self, e: int) -> int:
        if e and (not self.masked or self.boss.valid[e]):
            return e
        return 0

    def call_outgoing_kmers(self, node: int):
        """[(next node, char)], ascending."""
        boss = self.boss
        w = int(boss.W[node])
        if node > 1 and not w:
            return []
        last = boss.fwd_scalar(node, w % boss.alph_size)
        first = boss.pred_last_scalar(last - 1) + 1
        table = self.alph.decode_table
        return [(i, chr(table[int(boss.W[i]) % boss.alph_size]))
                for i in range(max(2, first), last + 1)
                if self._valid_node(i)]

    def _succ_table(self):
        """The successor range [first, last] of every edge (the target
        node's edges), built once."""
        if self._succ_ranges is None:
            boss = self.boss
            e = np.arange(len(boss.W), dtype=np.int64)
            w = boss.W.astype(np.int64)
            has_out = (e <= 1) | (w != 0)
            last = boss.fwd(np.where(has_out, e, 1), w % boss.alph_size)
            first = np.maximum(
                boss.pred_last(np.maximum(last - 1, 0)) + 1, 2)
            ok = has_out & (last >= first)
            self._succ_ranges = (np.where(ok, first, 1),
                                 np.where(ok, last, 0))
        return self._succ_ranges

    def call_outgoing_batch(self, nodes: np.ndarray):
        """``call_outgoing_kmers`` over an edge array: -> (owner, child,
        char code), flat, in each node's ascending order; the char code is
        ASCII, upper case unless the alphabet is DNA_CASE."""
        boss = self.boss
        nodes = np.asarray(nodes, dtype=np.int64)
        sf, sl = self._succ_table()
        first, last = sf[nodes], sl[nodes]
        cnt = np.maximum(last - first + 1, 0)
        owner = np.repeat(np.arange(len(nodes)), cnt)
        offs = np.concatenate([[0], np.cumsum(cnt)])
        child = first[owner] + (np.arange(len(owner)) - offs[owner])
        ch = boss.W[child].astype(np.int64) % boss.alph_size
        keep = ch != 0                      # no $ edges
        if self.masked:
            keep &= boss.valid[child] > 0
        owner, child, ch = owner[keep], child[keep], ch[keep]
        code = self.alph.decode_table[ch].astype(np.int64)
        if self.alphabet != "DNA_CASE":
            lower = (code >= 97) & (code <= 122)
            code = np.where(lower, code - 32, code)
        return owner, child, code

    def _incoming_group(self, x: int, d: int):
        """The edges of the incoming group that starts at x (W == d): x and
        the W == d + alph_size edges before the next W == d edge."""
        boss = self.boss
        M = len(boss.W)
        if not x:
            return []
        out = [x]
        e = x
        while e + 1 < M:
            nxt = boss._next_W(e + 1, d + boss.alph_size)
            stop = boss._next_W(e + 1, d)
            if not nxt or (stop and stop < nxt):
                break
            out.append(nxt)
            e = nxt
        return out

    def call_incoming_kmers(self, node: int):
        """[(previous node, char)]."""
        boss = self.boss
        table = self.alph.decode_table
        out = []
        for e in self._incoming_group(boss.bwd_scalar(node),
                                      boss.node_last_char_scalar(node)):
            if self._valid_node(e):
                # the first char of e's source node
                ee = e
                for _ in range(self.k - 2):
                    ee = boss.bwd_scalar(ee)
                out.append((e, chr(table[boss.node_last_char_scalar(ee)])))
        return out

    def traverse(self, node: int, c: str) -> int:
        boss = self.boss
        code = int(self.extractor.encode(c)[0])
        if code >= boss.alph_size:
            return 0
        w = int(boss.W[node])
        if node > 1 and not w:
            return 0
        last = boss.fwd_scalar(node, w % boss.alph_size)
        return self._valid_node(boss.pick_edge_scalar(last, code))

    def has_multiple_outgoing_batch(self, nodes: np.ndarray) -> np.ndarray:
        boss = self.boss
        nodes = np.asarray(nodes, dtype=np.int64)
        d = boss.W[nodes].astype(np.int64) % boss.alph_size
        last = boss.fwd(nodes, d)
        mult = (last - boss.pred_last(np.maximum(last - 1, 0))) > 1
        mult = np.where(d == 0, False, mult)
        if (nodes == 1).any():
            mult = np.where(nodes == 1, boss.succ_last_scalar(1) > 2, mult)
        return mult

    def has_single_incoming_batch(self, nodes: np.ndarray) -> np.ndarray:
        """Whether each node has one incoming edge: the W == w + alph_size
        edges between bwd(node) and the next W == w edge, counted by
        rank."""
        boss = self.boss
        nodes = np.asarray(nodes, dtype=np.int64)
        M = len(boss.W)
        x = boss.bwd(nodes)
        w = boss.node_last_char(nodes)
        first_valid = (boss.valid[x] > 0) if self.masked \
            else np.ones(len(nodes), dtype=bool)
        rk = boss.rank_W(x, w)
        total_w = boss.rank_W(np.full(len(nodes), M - 1, dtype=np.int64), w)
        n1 = boss.select_W(w, rk + 1)
        hi = np.where(total_w > rk, n1 - 1, M - 1)
        walph = w + boss.alph_size
        cnt = boss.rank_W(hi, walph) - boss.rank_W(x, walph)
        single = np.where(first_valid, cnt == 0, cnt == 1)
        single = np.where(x + 1 >= M, first_valid, single)
        return np.where(nodes == 1, False, single)

    def has_multiple_outgoing(self, node: int) -> bool:
        boss = self.boss
        if node == 1:
            return boss.succ_last_scalar(1) > 2
        d = int(boss.W[node]) % boss.alph_size
        if not d:
            return False
        last = boss.fwd_scalar(node, d)
        return last - boss.pred_last_scalar(last - 1) > 1

    def has_single_incoming(self, node: int) -> bool:
        boss = self.boss
        if node == 1:
            return False
        x = boss.bwd_scalar(node)
        w = boss.node_last_char_scalar(node)
        first_valid = (not self.masked) or bool(boss.valid[x])
        if x + 1 == len(boss.W):
            return first_valid
        if first_valid:
            return _is_single_incoming(boss, x, w)
        return len(self._incoming_group(x, w)) == 2

    # -------------------------------------------- suffix matching (:472-600)

    def call_nodes_with_suffix_matching_longest_prefix(
            self, s: bytes, min_match_length: int,
            max_num_allowed_matches: int = 2 ** 63):
        """Nodes whose k-mer suffix matches the longest prefix of ``s``:
        -> (nodes, match length)."""
        boss = self.boss
        if not max_num_allowed_matches or len(s) < min_match_length:
            return [], 0
        encoded = self.extractor.encode(s)
        if (encoded >= boss.alph_size).any():
            return [], 0
        first, last, match_size = boss.index_range_host(
            encoded[: min(self.k - 1, len(encoded))])
        if len(s) == self.k and match_size + 1 == self.k:
            edge = boss.pick_edge_scalar(last, int(encoded[-1]))
            if edge and self._valid_node(edge):
                return [edge], self.k
        if match_size < min_match_length or not first:
            return [], 0
        nodes = self.nodes_in_suffix_range(first, last,
                                           max_num_allowed_matches)
        return nodes, (match_size if nodes else 0)

    def nodes_in_suffix_range(self, first: int, last: int,
                              max_num_allowed_matches: int = 2 ** 63):
        """The valid edges incoming to each node of the BOSS range [first,
        last]; [] past ``max_num_allowed_matches``."""
        boss = self.boss
        rf = boss.rank_last_scalar(first)
        rl = boss.rank_last_scalar(last)
        if rl < rf:
            return []
        if not self.masked and rl - rf + 1 > max_num_allowed_matches:
            return []       # every group gives at least one node
        big = max(4 * max_num_allowed_matches, 1 << 14)
        if rl - rf + 1 > big:
            # a masked graph: a prefix of the groups past the cap already
            # overflows, unless most of them are dummies
            if len(self._nodes_in_rank_range(rf, rf + big - 1)) \
                    > max_num_allowed_matches:
                return []
        return self._nodes_in_rank_range(rf, rl, max_num_allowed_matches)

    def _incoming_groups(self, rs: np.ndarray):
        """The incoming groups of the nodes of last-ranks ``rs``: -> (the
        edges, group by group, each x then its W == d + alph_size edges
        ascending; each group's size)."""
        boss = self.boss
        e = boss.select_last(rs)
        x = boss.bwd(e)                       # first incoming edge (W == d)
        d = boss.node_last_char(e)
        M = len(boss.W)
        rk_d = boss.rank_W(x, d)
        tot_d = boss.rank_W(np.full(len(x), M - 1, dtype=np.int64), d)
        hi = np.where(tot_d > rk_d, boss.select_W(d, rk_d + 1), M) - 1
        dm = d + boss.alph_size
        base = boss.rank_W(x, dm)
        cnt = boss.rank_W(hi, dm) - base
        gs = cnt + 1
        offs = np.concatenate([[0], np.cumsum(gs)])
        out = np.empty(int(offs[-1]), dtype=np.int64)
        out[offs[:-1]] = x
        if len(out) > len(x):
            owner = np.repeat(np.arange(len(x)), cnt)
            ranks = base[owner] + (np.arange(len(owner))
                                   - np.repeat(np.cumsum(cnt) - cnt, cnt)) + 1
            mask = np.ones(len(out), dtype=bool)
            mask[offs[:-1]] = False
            out[mask] = boss.select_W(dm[owner], ranks)
        return out, gs

    def _nodes_in_rank_range(self, rf: int, rl: int,
                             max_num_allowed_matches: int = 2 ** 63):
        out, _ = self._incoming_groups(np.arange(rf, rl + 1, dtype=np.int64))
        if self.masked:
            out = out[self.boss.valid[out] > 0]
        if len(out) > max_num_allowed_matches:
            return []
        return out.tolist()

    def nodes_in_suffix_ranges_batch(self, firsts, lasts,
                                     max_num_allowed_matches: int = 2 ** 63):
        """``nodes_in_suffix_range`` of many ranges in one sweep: -> a node
        list a range ([] past the cap)."""
        firsts = np.asarray(firsts, dtype=np.int64)
        lasts = np.asarray(lasts, dtype=np.int64)
        results: list = [[] for _ in range(len(firsts))]
        if not len(firsts):
            return results
        boss = self.boss
        rf = boss.rank_last(firsts)
        group_counts = boss.rank_last(lasts) - rf + 1
        if self.masked:
            # the groups may be all dummies: no cap on their count, but a
            # huge range takes the per-range prefix bound
            huge = group_counts > max(4 * max_num_allowed_matches, 1 << 14)
            for i in np.flatnonzero(huge):
                results[int(i)] = self.nodes_in_suffix_range(
                    int(firsts[i]), int(lasts[i]), max_num_allowed_matches)
            en = (group_counts > 0) & ~huge
        else:
            en = (group_counts > 0) \
                & (group_counts <= max_num_allowed_matches)
        idx = np.flatnonzero(en)
        if not len(idx):
            return results
        cnts = group_counts[idx]
        owner_grp = np.repeat(np.arange(len(idx)), cnts)
        rs = np.repeat(rf[idx], cnts) + (
            np.arange(int(cnts.sum()), dtype=np.int64)
            - np.repeat(np.cumsum(cnts) - cnts, cnts))
        out, gs = self._incoming_groups(rs)
        range_sizes = np.zeros(len(idx), dtype=np.int64)
        np.add.at(range_sizes, owner_grp, gs)
        if self.masked:
            rid = np.repeat(np.arange(len(idx)), range_sizes)
            keep = boss.valid[out] > 0
            out = out[keep]
            range_sizes = np.bincount(rid[keep], minlength=len(idx))
        bounds = np.concatenate([[0], np.cumsum(range_sizes)])
        for t, i in enumerate(idx):
            seg = out[bounds[t]: bounds[t + 1]]
            if len(seg) <= max_num_allowed_matches:
                results[int(i)] = seg.tolist()
        return results

    def get_node_sequence(self, node: int) -> bytes:
        table = self.alph.decode_table
        if self._host_index is not None:
            _, ids, kchars = self._host_index
            pos = int(np.searchsorted(ids, node))
            if pos < len(ids) and ids[pos] == node:
                return table[kchars[pos]].tobytes()
        return table[self.boss.get_edge_seq(np.array([node]))[0]].tobytes()

    @classmethod
    def load(cls, path: str, mode: str | None = None,
             mmap: bool | None = None):
        """-> a DBGSuccinct, or the graph of a non-succinct artifact."""
        if mmap is None:
            mmap = DEFAULT_MMAP
        if path.endswith(".dbg") and os.path.exists(path):
            with open(path, "rb") as f:
                if f.read(2) != b"PK":         # not an npz: reference format
                    from ..seq_io.refformat import load_reference_boss
                    return load_reference_boss(path)
        base = path[:-4] if path.endswith(".npz") else path
        if os.path.exists(base + ".meta.npz") and (
                mmap or not os.path.exists(base + ".npz")):
            boss = BOSS.load(path, mmap=mmap)
            with np.load(base + ".meta.npz") as meta:
                m = str(meta["mode"]) if "mode" in meta.files else "basic"
                msk = bool(meta["masked"]) if "masked" in meta.files \
                    else True
                alphabet = _alphabet_of(meta, boss)
            return cls(boss, boss.k + 1, mode or m, alphabet, msk)
        npz = path if path.endswith(".npz") else path + ".npz"
        with np.load(npz) as z:
            if "graph_type" in z.files \
                    and str(z["graph_type"]) != "succinct":
                from .hash_graph import _KmerGraphBase
                return _KmerGraphBase.load_generic(z)
            if mode is None:
                mode = str(z["mode"]) if "mode" in z.files else "basic"
            msk = bool(z["masked"]) if "masked" in z.files else True
            boss = BOSS.load(npz)
            return cls(boss, boss.k + 1, mode, _alphabet_of(z, boss), msk)


def _is_single_incoming(boss: BOSS, i: int, w: int) -> bool:
    """Edge i has W == w (not minus-flagged): its target has one incoming
    edge iff no W == w + alph_size edge comes before the next W == w
    edge (metagraph_tpu/graph/traversal.py:40)."""
    if w > boss.alph_size:
        return False
    i += 1
    if i >= len(boss.W):
        return True
    n1 = boss._next_W(i, w)
    n2 = boss._next_W(i, w + boss.alph_size)
    return not (n2 and (not n1 or n2 < n1))


def _alphabet_of(z, boss: BOSS) -> str:
    """The alphabet recorded in the artifact; an older one's by sigma."""
    if "alphabet" in z.files:
        return str(z["alphabet"])
    return next((a.name for a in ALPHABETS.values()
                 if a.sigma == boss.alph_size), DNA.name)
