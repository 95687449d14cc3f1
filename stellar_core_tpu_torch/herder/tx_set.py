"""TxSetFrame: the consensus value — an ordered transaction set + hash
(ref src/herder/TxSetFrame.cpp — SURVEY.md §2.2).

Build from the local queue (``make_from_transactions``: sort-by-hash, surge
pricing, per-tx validity) or from the wire (``make_from_wire``: structural
re-validation).  ``txs_in_apply_order`` is the deterministic shuffle that
keeps per-account sequence order (ref getTxsInApplyOrder :503).

Device batch hook: ``prevalidate_signatures`` collects every signature in
the set and verifies them as ONE batch on the node's device (the CUDA
kernel of ops/ed25519_cuda), feeding per-signature verdicts into the
frames' SignatureCheckers — the admission hot path P5 (SURVEY.md §2.17).
"""
from __future__ import annotations

import hashlib
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from ..crypto import sha256
from ..ledger.ledger_txn import LedgerTxn
from ..transactions import TransactionFrame
from ..transactions.frame import TC
from ..xdr import types as T, xdr_sha256


class TxSetFrame:
    def __init__(self, network_id: bytes, previous_ledger_hash: bytes,
                 frames: Sequence[TransactionFrame]):
        self.network_id = network_id
        self.previous_ledger_hash = previous_ledger_hash
        # canonical order: sorted by full hash (ref sortTxsInHashOrder)
        self.frames = sorted(frames, key=lambda f: f.full_hash())
        self._hash: Optional[bytes] = None
        self._valid_cache: Dict[bytes, bool] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def make_from_transactions(cls, network_id: bytes, lcl_hash: bytes,
                               frames: Sequence[TransactionFrame],
                               ltx_root, max_size: int,
                               base_fee: int,
                               max_dex_ops: Optional[int] = None
                               ) -> "TxSetFrame":
        """Filter invalid txs, trim to max_size by fee rate (surge pricing),
        keep per-account seq continuity (ref makeFromTransactions :234).
        ``max_dex_ops`` adds the DEX lane's per-lane op limit (config
        MAX_DEX_TX_OPERATIONS; ref SurgePricingUtils.h lane config)."""
        # per-source continuity: keep the longest valid prefix per account
        by_source: Dict[bytes, List[TransactionFrame]] = {}
        for f in frames:
            by_source.setdefault(f.source_account_id(), []).append(f)
        valid: List[TransactionFrame] = []
        with LedgerTxn(ltx_root) as ltx:
            lcl_seq = ltx.header().ledgerSeq
            for source, fs in by_source.items():
                fs.sort(key=lambda f: f.seq_num())
                entry = ltx.load_account(source)
                seq = entry.data.value.seqNum if entry else None
                for f in fs:
                    if seq is None or f.seq_num() != seq + 1:
                        break
                    # skip the full re-check for frames the queue already
                    # validated against this very LCL (admission stamps
                    # checked_valid_lcl); state can't have moved since
                    if getattr(f, "checked_valid_lcl", None) != lcl_seq:
                        res = f.check_valid(ltx, current_seq=seq)
                        if not res.ok:
                            break
                    valid.append(f)
                    seq = f.seq_num()
            ltx.rollback()
        valid = surge_pricing_filter(valid, max_size,
                                     max_dex_ops=max_dex_ops)
        return cls(network_id, lcl_hash, valid)

    @classmethod
    def make_from_wire(cls, network_id: bytes, xdr_tx_set) -> "TxSetFrame":
        from ..transactions.frame import tx_frame_from_envelope

        frames = [tx_frame_from_envelope(network_id, env)
                  for env in xdr_tx_set.txs]
        return cls(network_id, xdr_tx_set.previousLedgerHash, frames)

    # -- identity ----------------------------------------------------------

    def to_xdr(self):
        return T.TransactionSet.make(
            previousLedgerHash=self.previous_ledger_hash,
            txs=[f.envelope for f in self.frames])

    def contents_hash(self) -> bytes:
        if self._hash is None:
            self._hash = xdr_sha256(T.TransactionSet, self.to_xdr())
        return self._hash

    def size(self) -> int:
        return len(self.frames)

    def size_op(self) -> int:
        return sum(f.num_operations() for f in self.frames)

    # -- validity (wire sets) ----------------------------------------------

    def check_valid(self, ltx_root, lcl_hash: bytes,
                    verify=None) -> bool:
        """ref TxSetFrame::checkValid :562 — prev-hash linkage, size cap,
        hash order, per-source seq continuity, per-tx checkValid.

        The result is cached per LCL hash: SCP re-validates the same value
        once per envelope (every nomination/ballot message carrying it),
        and ledger state — the only input besides the set itself — cannot
        change without the LCL hash changing.  Without this a 1000-tx
        close re-runs the full per-tx chain ~8x (measured r4 profile)."""
        if self.previous_ledger_hash != lcl_hash:
            return False
        if verify is not None:
            # a custom verifier must actually run: bypass the cache both
            # ways (don't read a verdict it didn't produce, don't publish
            # one keyed only by lcl_hash)
            return self._check_valid_uncached(ltx_root, lcl_hash, verify)
        cached = self._valid_cache.get(lcl_hash)
        if cached is not None:
            return cached
        ok = self._check_valid_uncached(ltx_root, lcl_hash, verify)
        self._valid_cache = {lcl_hash: ok}
        return ok

    def _check_valid_uncached(self, ltx_root, lcl_hash: bytes,
                              verify=None) -> bool:
        with LedgerTxn(ltx_root) as _hltx:
            max_ops = _hltx.header().maxTxSetSize
            _hltx.rollback()
        if self.size_op() > max_ops:
            return False  # oversized set: reject like the reference
        hashes = [f.full_hash() for f in self.frames]
        if hashes != sorted(hashes):
            return False
        by_source: Dict[bytes, List[TransactionFrame]] = {}
        for f in self.frames:
            by_source.setdefault(f.source_account_id(), []).append(f)
        with LedgerTxn(ltx_root) as ltx:
            ok = True
            for source, fs in sorted(by_source.items()):
                fs.sort(key=lambda f: f.seq_num())
                entry = ltx.load_account(source)
                if entry is None:
                    ok = False
                    break
                seq = entry.data.value.seqNum
                for f in fs:
                    if f.seq_num() != seq + 1:
                        ok = False
                        break
                    res = f.check_valid(ltx, current_seq=seq,
                                        verify=verify)
                    if not res.ok:
                        ok = False
                        break
                    seq = f.seq_num()
                if not ok:
                    break
            ltx.rollback()
        return ok

    # -- apply order -------------------------------------------------------

    def txs_in_apply_order(self) -> List[TransactionFrame]:
        """Deterministic shuffle preserving per-account seq order: slot
        positions come from sha256(lcl || txhash) order; each account's txs
        fill its own positions in sequence order (ref ApplyTxSorter)."""
        def shuffle_key(f: TransactionFrame) -> bytes:
            return sha256(self.previous_ledger_hash + f.full_hash())

        shuffled = sorted(self.frames, key=shuffle_key)
        by_source: Dict[bytes, List[TransactionFrame]] = {}
        for f in self.frames:
            by_source.setdefault(f.source_account_id(), []).append(f)
        for _, fs in sorted(by_source.items()):
            fs.sort(key=lambda f: f.seq_num())
        iters = {src: iter(fs) for src, fs in by_source.items()}
        return [next(iters[f.source_account_id()]) for f in shuffled]

    # -- TPU batch pre-verification ----------------------------------------

    def collect_signature_batch(self) -> Tuple:
        """Gather (pubkey, sig, payload-hash) triples for every
        (signature x candidate-signer) pair whose hint matches — the batch
        the device kernel verifies in one shot."""
        import numpy as np

        from ..transactions.signature_checker import signature_hint

        triples = []
        index = []
        for fi, f in enumerate(self.frames):
            # a fee-bump contributes two signed payloads: the outer
            # envelope (fee source sigs over the fee-bump hash) and the
            # inner tx (its own hash + sigs)
            payloads = [(f.full_hash(), f.signatures)]
            inner = getattr(f, "inner_tx", None)
            if inner is not None:
                payloads.append((inner.full_hash(), inner.signatures))
            src = f.source_account_id()
            # candidate signer keys: tx source + fee source + op sources
            # (master keys); additional account signers resolve at check
            # time via cache misses falling back to CPU verify
            keys = {src}
            fee_src = getattr(f, "fee_source_id", None)
            if fee_src is not None:
                keys.add(fee_src())
            for opf in f.op_frames:
                keys.add(opf.source_account_id())
            for h, sigs in payloads:
                for i, ds in enumerate(sigs):
                    for pub in sorted(keys):
                        if ds.hint == signature_hint(pub):
                            triples.append((pub, ds.signature, h))
                            index.append((fi, i, pub))
        return triples, index

    def prevalidate_signatures(self, use_device: bool = True, tracer=None,
                               device=None
                               ) -> Dict[Tuple[bytes, bytes, bytes], bool]:
        """Verify the whole set's signatures as one batch; returns a verdict
        cache keyed by (pubkey, signature, msg) for SignatureChecker.

        ``use_device`` sends the batch, padded to a ``SIG_BATCH_BUCKETS``
        size, to ``device`` (default: the GPU; ``utils.device``): a CUDA
        tensor launches the kernel or raises, a CPU tensor runs the plain
        torch version.  ``tracer`` (utils/tracing) splits the device leg
        into a dispatch span (batch assembly, the copy to the device and
        the launch) and a host-wait span (the readback, which waits for
        the kernel)."""
        if tracer is None:
            from ..utils.tracing import NULL_TRACER as tracer
        triples, _ = self.collect_signature_batch()
        if not triples:
            return {}
        verdicts: Dict[Tuple[bytes, bytes, bytes], bool] = {}
        if use_device:
            import torch

            from ..ops.ed25519_cuda import verify_batch
            from ..utils.device import (default_device,
                                        padded_signature_batch,
                                        signature_columns)

            dev = default_device(device)
            with tracer.span("crypto.sigbatch.dispatch",
                             n_sigs=len(triples)):
                n = len(triples)
                # pad to a fixed batch bucket (repeating real rows) so the
                # device sees a small closed set of shapes
                pending = verify_batch(*(
                    torch.from_numpy(a).to(dev) for a in
                    padded_signature_batch(*signature_columns(triples))))
            with tracer.span("crypto.sigbatch.host_wait"):
                # the readback waits for the kernel: the dispatch/host-wait
                # split is launch overhead vs. kernel time
                ok = pending[:n].cpu().numpy()
            for t, v in zip(triples, ok):
                verdicts[(t[0], t[1], t[2])] = bool(v)
        else:
            from ..crypto import verify_sig

            with tracer.span("crypto.sigbatch.cpu",
                             n_sigs=len(triples)):
                for pub, sig, msg in triples:
                    verdicts[(pub, sig, msg)] = verify_sig(pub, sig, msg)
        return verdicts

    def make_cached_verify(self, verdicts):
        """verify callable for SignatureChecker: batch verdicts first,
        CPU fallback for pairs outside the batch (e.g. extra signers)."""
        from ..crypto import verify_sig

        def verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
            key = (pub, sig, msg)
            if key in verdicts:
                return verdicts[key]
            return verify_sig(pub, sig, msg)

        return verify


#: op types riding the DEX lane (offers + path payments — everything
#: that can cross the order book; ref TxSetUtils hasDexOperations)
_DEX_OP_TYPES = frozenset((
    T.OperationType.MANAGE_SELL_OFFER,
    T.OperationType.MANAGE_BUY_OFFER,
    T.OperationType.CREATE_PASSIVE_SELL_OFFER,
    T.OperationType.PATH_PAYMENT_STRICT_RECEIVE,
    T.OperationType.PATH_PAYMENT_STRICT_SEND,
))


def is_dex_tx(f: TransactionFrame) -> bool:
    return any(opf.op.body.type in _DEX_OP_TYPES for opf in f.op_frames)


def surge_pricing_filter(frames: List[TransactionFrame],
                         max_ops: int,
                         max_dex_ops: Optional[int] = None
                         ) -> List[TransactionFrame]:
    """Trim to the ledger's op capacity by fee-per-op rate, highest first
    (ref applySurgePricing :1150 / SurgePricingUtils.h priority queue).
    Per-account seq chains are kept intact: dropping a tx drops its
    successors.

    Lanes (ref SurgePricingUtils.h DexLimitingLaneConfig): every tx
    counts against the generic ``max_ops`` capacity; txs containing DEX
    ops ALSO count against the ``max_dex_ops`` lane when set, so order-
    book traffic cannot crowd payments out of the whole ledger."""
    total_ops = sum(f.num_operations() for f in frames)
    # DEX classification scans every op of a frame — compute it once,
    # not per prefix sum inside the trim loop (same O(n^2) shape the
    # chain-position map below fixes)
    dex = ({id(f): is_dex_tx(f) for f in frames}
           if max_dex_ops is not None else {})
    dex_total = (sum(f.num_operations() for f in frames if dex[id(f)])
                 if max_dex_ops is not None else 0)
    if total_ops <= max_ops and \
            (max_dex_ops is None or dex_total <= max_dex_ops):
        return list(frames)

    def rate(f: TransactionFrame) -> Tuple:
        # fee-per-op as an EXACT rational (float division could tie or
        # flip near-equal rates after rounding — consensus-visible
        # ordering must be exact int math); tie-break by hash
        return (Fraction(-f.fee_bid(), max(1, f.num_operations())),
                f.full_hash())

    by_source: Dict[bytes, List[TransactionFrame]] = {}
    for f in frames:
        by_source.setdefault(f.source_account_id(), []).append(f)
    # chain position by identity, precomputed once — chain.index(f)
    # inside the trim loop was O(n^2) on long same-source chains
    chain_pos: Dict[int, int] = {}
    for _, fs in sorted(by_source.items()):
        fs.sort(key=lambda f: f.seq_num())
        for pos, c in enumerate(fs):
            chain_pos[id(c)] = pos

    kept: set = set()
    kept_order: List[TransactionFrame] = []
    ops = 0
    dex_ops = 0
    dropped_sources = set()
    for f in sorted(frames, key=rate):
        src = f.source_account_id()
        if src in dropped_sources or id(f) in kept:
            continue
        chain = by_source[src]
        pos = chain_pos[id(f)]
        # a high-fee successor pulls its not-yet-kept (cheaper)
        # predecessors in with it — seq chains stay intact
        prefix = [c for c in chain[:pos + 1] if id(c) not in kept]
        prefix_ops = sum(c.num_operations() for c in prefix)
        prefix_dex = (sum(c.num_operations() for c in prefix
                          if dex[id(c)])
                      if max_dex_ops is not None else 0)
        if ops + prefix_ops > max_ops or \
                (max_dex_ops is not None
                 and dex_ops + prefix_dex > max_dex_ops):
            dropped_sources.add(src)
            continue
        for c in prefix:
            kept.add(id(c))
            kept_order.append(c)
        ops += prefix_ops
        dex_ops += prefix_dex
    return kept_order
