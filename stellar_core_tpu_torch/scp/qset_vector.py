"""Vectorized host-side quorum fixpoint with cross-node memo caches.

``local_node.is_quorum`` is the profiled dominator of large-simulation
wall cost: every envelope processed at 50-validator scale re-runs the
greatest-fixpoint contraction with a per-call, per-node scalar slice
walk.  This module evaluates the SAME contraction as boolean-matrix
reductions over the member universe — the ``ops/quorum.py`` QSetTensor
shape (top_mem/top_thr + padded inner_mem/inner_thr), on the NumPy host
path — so one ``matmul`` per contraction step replaces N recursive
slice evaluations.  Every verdict is exact integer math over the same
sets, so results are bitwise-identical to the scalar oracle (asserted
by tests/test_qset_vector.py's differential suite).

The memo caches here are MODULE-level, shared across every sim node in
the process (ROADMAP item 6: each node previously re-memoized the same
org qsets inside its own call).  That sharing is deterministic because
each cache is a pure-function memo — structure key -> packed arrays,
(universe, qsets, local) -> verdict — and no code path ever iterates a
cache; insertion order can never reach a result.

Knobs (env-fallback, same idiom as main/config.py):

- ``SCP_VECTOR_QUORUM=0``        kill switch -> scalar path everywhere
- ``SCP_VECTOR_QUORUM_MIN=<n>``  minimum member-set size to vectorize
  (default 12: the crossover where matrix setup beats the early-exit
  scalar walk; core-4 tests keep the scalar path untouched)
"""
from __future__ import annotations

import os as _os
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

# -- knobs -------------------------------------------------------------------

# kill-switch knobs read ONCE at import: both arms of the switch are
# exact (the vector path is differential-tested bitwise-identical to
# the scalar oracle), so the setting cannot change any verdict
# detlint: allow(det-wallclock)
_ENABLED: bool = _os.environ.get("SCP_VECTOR_QUORUM", "1") != "0"
# detlint: allow(det-wallclock)
_MIN_NODES: int = int(_os.environ.get("SCP_VECTOR_QUORUM_MIN", "12"))


def set_enabled(on: bool) -> bool:
    """Runtime toggle (tests + the fuzz bench's same-session scalar/
    vector A/B).  Returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def is_enabled() -> bool:
    return _ENABLED


def min_nodes() -> int:
    return _MIN_NODES


def set_min_nodes(n: int) -> int:
    """Runtime override of the vectorization size gate (tests force the
    vector path onto small universes for the differential suite)."""
    global _MIN_NODES
    prev = _MIN_NODES
    _MIN_NODES = int(n)
    return prev


# -- cross-node memo caches --------------------------------------------------
#
# All three layers are pure-function memos keyed by VALUE-derived
# structure keys, never iterated, so cross-node (and cross-sim) sharing
# cannot introduce nondeterminism.  Each is capped and cleared
# wholesale — a deterministic policy, unlike LRU eviction whose
# hit-pattern would depend on call interleaving (it still wouldn't
# change verdicts, but wholesale clearing keeps the reasoning trivial).

_CACHE_CAP = 1 << 16

# id(qset) -> (qset strong ref, interned qset int | None for >2-level).
# The strong ref pins the object so its id can never be recycled to a
# different qset; mapping straight to the interned int keeps the hot
# path to ONE dict hop per member (re-hashing the structure key every
# call is what it replaces).
_key_by_id: Dict[int, Tuple[object, Optional[int]]] = {}
# structure key -> small int (interning: downstream keys stay compact)
_intern_qset: Dict[tuple, int] = {}
# frozenset(members) -> (small int, sorted member tuple).  Keying by
# frozenset keeps the hot path sort-free: the deterministic order is
# computed ONCE per distinct member set, at intern time, and every
# later hit reuses it (set hashing is order-free C code; the int and
# the sorted tuple are pure functions of the set VALUE).
_intern_universe: Dict[frozenset, Tuple[int, tuple]] = {}
# (universe int, per-member qset ints) -> packed matrices
_pack_cache: Dict[tuple, tuple] = {}
# (universe int, per-member qset ints, local qset int) -> verdict
_verdict_cache: Dict[tuple, bool] = {}

# observability (tests + FUZZ_BENCH corpus stats)
stats = {"verdict_hits": 0, "verdict_misses": 0, "pack_builds": 0,
         "fallback_deep": 0, "calls": 0}


def clear_caches() -> None:
    _key_by_id.clear()
    _intern_qset.clear()
    _intern_universe.clear()
    _pack_cache.clear()
    _verdict_cache.clear()


def _cap(cache: dict) -> None:
    if len(cache) > _CACHE_CAP:
        cache.clear()


def _structure_key(qset) -> Optional[tuple]:
    """Hashable value key of one XDR SCPQuorumSet (2 levels; None for
    deeper trees, which fall back to the scalar path wholesale)."""
    inners = []
    for s in qset.innerSets:
        if s.innerSets:
            return None
        inners.append((s.threshold,
                       tuple(v.value for v in s.validators)))
    return (qset.threshold, tuple(v.value for v in qset.validators),
            tuple(inners))


def _cap_interned() -> None:
    """Interned ints appear inside pack/verdict cache KEYS and inside
    ``_key_by_id`` entries, so an intern table can only be cleared
    together with every cache that embeds its ints — otherwise a
    recycled int would alias a different qset/universe and corrupt
    verdicts."""
    if (len(_intern_qset) > _CACHE_CAP
            or len(_intern_universe) > _CACHE_CAP):
        _key_by_id.clear()
        _intern_qset.clear()
        _qset_plain_by_int.clear()
        _intern_universe.clear()
        _universe_by_int.clear()
        _pack_cache.clear()
        _verdict_cache.clear()


def _qset_int(qset) -> Optional[int]:
    """Small interned id for a qset VALUE; None for >2-level sets.

    Memoized by object identity first (sim nodes hand out stable qset
    objects), then by structure: two distinct objects with equal
    structure intern to the same int, which is exactly the cross-node
    sharing this module exists for."""
    # id() is only a memo key and the entry pins the object alive (no
    # id recycling); the interned int is a pure function of the qset
    # VALUE via _structure_key, so verdicts never depend on identity
    # detlint: allow(det-interproc-taint)
    ent = _key_by_id.get(id(qset))
    if ent is not None:
        return ent[1]
    key = _structure_key(qset)
    if key is None:
        n = None
    else:
        n = _intern_qset.get(key)
        if n is None:
            _cap_interned()
            n = _intern_qset[key] = len(_intern_qset)
            _qset_plain_by_int[n] = key
    _cap(_key_by_id)
    # detlint: allow(det-interproc-taint)
    _key_by_id[id(qset)] = (qset, n)
    return n


# interned int -> structure key (for pack builds; append-only beside
# _intern_qset and cleared with it)
_qset_plain_by_int: Dict[int, tuple] = {}


def _universe_entry(members: Set[bytes]) -> Tuple[int, tuple]:
    """(interned int, sorted member tuple) for one member set."""
    key = frozenset(members)
    ent = _intern_universe.get(key)
    if ent is None:
        _cap_interned()
        universe = tuple(sorted(members))
        ent = _intern_universe[key] = (len(_intern_universe), universe)
        _universe_by_int[ent[0]] = universe
    return ent


_universe_by_int: Dict[int, tuple] = {}


def _pack(u_int: int, q_key) -> tuple:
    """QSetTensor-shaped packed arrays over the member universe:
    top_mem (N,N) int32, top_thr (N,), inner_mem (N,K,N) int32,
    inner_thr (N,K), inner_real (N,K) bool, known (N,) bool.

    ``q_key`` is either a tuple of per-member qset ints (-1 = unknown)
    or a single int, meaning every member cites that one qset (the
    uniform fast path).  Row i describes member i's qset with columns
    restricted to the universe — ids outside the member set can never
    be in ``cur``, so dropping their columns changes no hit count."""
    key = (u_int, q_key)
    packed = _pack_cache.get(key)
    if packed is not None:
        return packed
    universe = _universe_by_int[u_int]
    q_ints = (q_key,) * len(universe) if isinstance(q_key, int) \
        else q_key
    idx = {nid: i for i, nid in enumerate(universe)}
    n = len(universe)
    k_max = 1
    for q in q_ints:
        if q >= 0:
            k_max = max(k_max, len(_qset_plain_by_int[q][2]))
    top_mem = np.zeros((n, n), dtype=np.int32)
    top_thr = np.zeros(n, dtype=np.int32)
    inner_mem = np.zeros((n, k_max, n), dtype=np.int32)
    inner_thr = np.zeros((n, k_max), dtype=np.int32)
    inner_real = np.zeros((n, k_max), dtype=bool)
    known = np.zeros(n, dtype=bool)
    for i, q in enumerate(q_ints):
        if q < 0:
            continue
        thr, validators, inners = _qset_plain_by_int[q]
        known[i] = True
        top_thr[i] = thr
        for v in validators:
            j = idx.get(v)
            if j is not None:
                top_mem[i, j] = 1
        for ki, (ithr, ivals) in enumerate(inners):
            inner_thr[i, ki] = ithr
            inner_real[i, ki] = True
            for v in ivals:
                j = idx.get(v)
                if j is not None:
                    inner_mem[i, ki, j] = 1
    packed = (top_mem, top_thr, inner_mem, inner_thr, inner_real, known)
    _cap(_pack_cache)
    _pack_cache[key] = packed
    stats["pack_builds"] += 1
    return packed


def _contract(packed: tuple) -> np.ndarray:
    """Greatest-fixpoint contraction as matrix reductions — the exact
    mirror of the scalar loop in ``local_node.is_quorum``: start from
    the FULL member set (unknown-qset members count as columns in step
    one, then drop — same as the scalar path), keep members whose slice
    is satisfied inside the current set, repeat to fixpoint."""
    top_mem, top_thr, inner_mem, inner_thr, inner_real, known = packed
    cur = np.ones(top_thr.shape[0], dtype=bool)
    while True:
        curi = cur.astype(np.int32)
        hits = top_mem @ curi
        inner_hits = inner_mem @ curi                       # (N, K)
        inner_sat = (inner_hits >= inner_thr) & inner_real
        sat = (hits + inner_sat.sum(axis=1)) >= top_thr
        nxt = cur & sat & known
        if bool((nxt == cur).all()):
            return cur
        cur = nxt


def vector_is_quorum(
    members: Set[bytes],
    get_qset: Callable[[bytes], Optional[object]],
    local_qset=None,
) -> Optional[bool]:
    """Vectorized ``local_node.is_quorum``.  Returns the exact verdict,
    or None when the vector path does not apply (disabled, small set,
    or a >2-level qset in play) and the caller must run the scalar
    oracle."""
    if not _ENABLED or len(members) < _MIN_NODES:
        return None
    stats["calls"] += 1
    u_int, universe = _universe_entry(members)
    # the per-member walk is THE hot-path cost at fleet scale: do it as
    # a listcomp + C-level identity scan instead of N dict lookups
    key_by_id = _key_by_id
    qs = [get_qset(nid) for nid in universe]
    # detlint: allow(det-interproc-taint) — id() is a memo key only;
    # every interned int is a pure function of the qset VALUE
    idset = set(map(id, qs))
    if len(idset) == 1 and qs[0] is not None:
        # uniform fast path: every member cites the SAME qset object —
        # the dominant real-sim shape (a node resolves every matching
        # statement hash to its own cached qset), so ONE memo lookup
        # covers the whole walk and the q-key is a single int
        q0 = qs[0]
        # detlint: allow(det-interproc-taint) — memo key only
        ent = key_by_id.get(id(q0))
        qi0 = ent[1] if ent is not None else _qset_int(q0)
        if qi0 is None:
            stats["fallback_deep"] += 1
            return None
        q_key = qi0
    else:
        q_ints: List[int] = []
        append = q_ints.append
        for q in qs:
            if q is None:
                append(-1)
                continue
            # detlint: allow(det-interproc-taint) — memo key only
            ent = key_by_id.get(id(q))
            qi = ent[1] if ent is not None else _qset_int(q)
            if qi is None:
                stats["fallback_deep"] += 1
                return None
            append(qi)
        q_key = tuple(q_ints)
    local_int = -1
    if local_qset is not None:
        local_int = _qset_int(local_qset)  # type: ignore[assignment]
        if local_int is None:
            stats["fallback_deep"] += 1
            return None
    vkey = (u_int, q_key, local_int)
    verdict = _verdict_cache.get(vkey)
    if verdict is not None:
        stats["verdict_hits"] += 1
        return verdict
    stats["verdict_misses"] += 1
    cur = _contract(_pack(u_int, q_key))
    if not bool(cur.any()):
        verdict = False
    elif local_qset is not None:
        from .local_node import is_quorum_slice
        final = {universe[i] for i in np.flatnonzero(cur)}
        verdict = is_quorum_slice(local_qset, final)
    else:
        verdict = True
    _cap(_verdict_cache)
    _verdict_cache[vkey] = verdict
    return verdict
