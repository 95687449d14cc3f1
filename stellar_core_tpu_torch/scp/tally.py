"""TallyEngine: routes the live SCP federated-voting tallies through the
port's quorum ops (``ops/quorum.py``, torch) on one device — BASELINE
config #5's ballot tallies.

Counterpart of the JAX package's ``scp/tally.py``, rewritten for torch.
Per slot, the engine keeps a QSetTensor over the current envelope
universe on its device, rebuilt only when the (node -> qset-hash) map
changes.  Each ``Slot.federated_accept/ratify`` call evaluates its
statement predicates on the host (cheap python over <= N statements),
sends the vote rows to the device in one copy, and runs the
threshold/fixpoint math there; the verdict comes back as one bool.  On a
CUDA device that math is one launch of the hand-written kernel
``csrc/quorum_tally.cu`` (``ops/quorum_cuda.py``) with one synchronisation;
on a CPU device it is the plain torch ops of ``ops/quorum.py``.
Quorum sets deeper than 2 levels have no tensor form (ref
MAXIMUM_QUORUM_NESTING_LEVEL=4, src/scp/QuorumSetUtils.cpp:16) — those
slots fall back to the exact host evaluation in scp/local_node.py, which
is also the differential oracle in "both" mode.

The device is the one ``SCP(..., device=...)`` resolved, or the engine's
own ``device=`` argument: a host-backend engine has none and never needs a
GPU; a tensor backend with no device given runs on ``cuda`` and raises
where there is none (``utils.device``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import quorum_cuda
from ..utils.device import cpu_threads, default_device
from . import local_node as LN
from .statement import companion_qset_hash

HOST = "host"
TENSOR = "tensor"
BOTH = "both"  # tensor path + host oracle, assert equal (sim tests)


class TallyMismatch(AssertionError):
    pass


class TallyEngine:
    def __init__(self, slot, backend: str, device=None):
        self.slot = slot
        self.backend = backend
        self.device = default_device(device) if backend != HOST else None
        self._cache_key: Optional[Tuple] = None
        self._tensors = None  # (local_qs, qsets, node_order)
        self.tensor_tallies = 0
        self.host_fallbacks = 0

    # -- tensor (re)construction -------------------------------------------

    def _build(self, envelopes: Dict[bytes, object]):
        from ..ops.quorum import build_qset_tensor, local_qset

        local = self.slot.local_node
        node_qsets: Dict[bytes, object] = {local.node_id: local.qset}
        # the cache key: each node with the hash of its qset.  A statement
        # names its qset by hash and ``qset_from_statement`` resolves that
        # hash, so the key needs no re-hash of the qset objects (re-hashing
        # every sender's qset on each call dominated a slot on the card).
        node_hashes: Dict[bytes, bytes] = {local.node_id: local.qset_hash}
        # sorted iteration: the envelope map arrives keyed by node id
        # (bytes) — tensor construction must not depend on arrival or
        # hash order
        for n, env in sorted(envelopes.items()):
            q = self.slot.qset_from_statement(env.statement)
            if q is None:
                continue
            node_qsets[n] = q
            node_hashes[n] = companion_qset_hash(env.statement)
        key = tuple(sorted(node_hashes.items()))
        if key == self._cache_key:
            return self._tensors
        for _, q in sorted(node_qsets.items()):
            if LN.qset_to_plain(q) is None:
                self._cache_key = key
                self._tensors = None  # >2-level qset: host only
                return None
        # the universe covers every node any qset references (not just
        # envelope senders) — columns must exist for yet-silent validators
        universe = set(node_qsets)
        for _, q in sorted(node_qsets.items()):
            universe |= LN.qset_nodes(q)
        node_order = sorted(universe)
        # unknown qset: threshold 1 with zero members is never satisfiable,
        # so the node can never stay in a contraction (threshold 0 would
        # be trivially satisfied — the opposite of what we need)
        empty = (1, [], [])
        plains = [LN.qset_to_plain(node_qsets[n])
                  if n in node_qsets else empty for n in node_order]
        qsets = build_qset_tensor(plains, node_order, device=self.device)
        local_qs = local_qset(build_qset_tensor(
            [LN.qset_to_plain(local.qset)], node_order, device=self.device),
            0)
        self._cache_key = key
        self._tensors = (local_qs, qsets, node_order)
        return self._tensors

    def device_accept(self, local_qs, qsets, rows: np.ndarray) -> bool:
        """Host rows (2, N) bool — accepted, voted-or-accepted — to the
        device in one copy; v-blocking or ratified, read back as a bool."""
        if self.device.type == "cuda":
            # the clock read is the kernel build's reported nvcc time,
            # which no verdict reads
            # detlint: allow(det-interproc-taint)
            return quorum_cuda.tally_accept(local_qs, qsets, rows)
        from ..ops import quorum as Q

        with cpu_threads(self.device):
            dev_rows = torch.from_numpy(rows).to(self.device)
            vblock = Q.is_v_blocking(local_qs, dev_rows[0:1])[0]
            ratified = Q.federated_ratify(local_qs, qsets, dev_rows[1:2])[0]
            return bool(vblock | ratified)

    def device_ratify(self, local_qs, qsets, rows: np.ndarray) -> bool:
        """Host row (1, N) bool — voted — to the device in one copy;
        ratified, read back as a bool."""
        if self.device.type == "cuda":
            # the clock read is the kernel build's reported nvcc time,
            # which no verdict reads
            # detlint: allow(det-interproc-taint)
            return quorum_cuda.tally_ratify(local_qs, qsets, rows)
        from ..ops import quorum as Q

        with cpu_threads(self.device):
            dev_rows = torch.from_numpy(rows).to(self.device)
            return bool(Q.federated_ratify(local_qs, qsets, dev_rows)[0])

    # -- tallies ------------------------------------------------------------

    def federated_accept(self, voted_predicate: Callable,
                         accepted_predicate: Callable,
                         envelopes: Dict[bytes, object]) -> Optional[bool]:
        """Tensor-path verdict, or None to use the host path."""
        if self.backend == HOST:
            return None
        t = self._build(envelopes)
        if t is None:
            self.host_fallbacks += 1
            return None
        local_qs, qsets, order = t
        # row 0: accepted; row 1: voted-or-accepted
        rows = np.zeros((2, len(order)), np.bool_)
        for i, n in enumerate(order):
            env = envelopes.get(n)
            if env is None:
                continue
            acc = accepted_predicate(env.statement)
            rows[0, i] = acc
            rows[1, i] = acc or voted_predicate(env.statement)
        verdict = self.device_accept(local_qs, qsets, rows)
        self.tensor_tallies += 1
        if self.backend == BOTH:
            host = self._host_accept(voted_predicate, accepted_predicate,
                                     envelopes)
            if host != verdict:
                raise TallyMismatch(
                    f"federated_accept tensor={verdict} host={host} "
                    f"slot={self.slot.slot_index}")
        return verdict

    def federated_ratify(self, voted_predicate: Callable,
                         envelopes: Dict[bytes, object]) -> Optional[bool]:
        if self.backend == HOST:
            return None
        t = self._build(envelopes)
        if t is None:
            self.host_fallbacks += 1
            return None
        local_qs, qsets, order = t
        voted = np.zeros((1, len(order)), np.bool_)
        for i, n in enumerate(order):
            env = envelopes.get(n)
            if env is not None and voted_predicate(env.statement):
                voted[0, i] = True
        verdict = self.device_ratify(local_qs, qsets, voted)
        self.tensor_tallies += 1
        if self.backend == BOTH:
            host = self._host_ratify(voted_predicate, envelopes)
            if host != verdict:
                raise TallyMismatch(
                    f"federated_ratify tensor={verdict} host={host} "
                    f"slot={self.slot.slot_index}")
        return verdict

    # -- host oracle ---------------------------------------------------------

    def _host_accept(self, voted_predicate, accepted_predicate,
                     envelopes) -> bool:
        accepted_nodes = {
            n for n, env in envelopes.items()
            if accepted_predicate(env.statement)}
        if LN.is_v_blocking(self.slot.local_node.qset, accepted_nodes):
            return True
        vote_or_accept = {
            n for n, env in envelopes.items()
            if accepted_predicate(env.statement)
            or voted_predicate(env.statement)}
        return self.slot._host_is_quorum(vote_or_accept, envelopes)

    def _host_ratify(self, voted_predicate, envelopes) -> bool:
        voted = {n for n, env in envelopes.items()
                 if voted_predicate(env.statement)}
        return self.slot._host_is_quorum(voted, envelopes)
