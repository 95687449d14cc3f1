"""Dispatch layer for the native GIL-free apply kernel.

Bridges the cluster executor to ``native/apply_kernel.cpp``: decides
per transaction whether its structure fits the kernel's op strip
(``frame_kernel_shape``, consumed by the footprint pass so the planner
can tag whole clusters), packs a kernel-eligible cluster's snapshot
entries / order-book rows / tx descriptors into canonical XDR bytes,
invokes the kernel (which releases the GIL for its whole run), and
re-wraps the kernel's outputs — packed entry deltas, pre-encoded
TransactionMeta / TransactionResult bytes — into the ``ClusterResult``
shape the merge/hash/commit phases already consume.

The kernel-shaped strip (ISSUE 13 kernel-complete apply): native AND
credit payments, CHANGE_TRUST create/update/delete over classic
assets, MANAGE_SELL_OFFER create/modify/delete (offerID 0 and !=0),
and PATH_PAYMENT strict-send/strict-receive over declared hop pairs
(per-hop pool descriptors ride the shape so the kernel can quote a
LIVE constant-product pool on the hop in-kernel — book-vs-pool
arbitration mirrors ``convert_with_offers_and_pools``; pool
deposit/withdraw stay host-side, and ``NATIVE_POOL_QUOTE=0`` restores
the old decline-if-live behavior via a host screen).

Beyond per-cluster apply, ``run_fee_phase_native`` batches the whole
fee/seqnum phase of a close into ONE GIL-released ``charge_fees``
kernel call: apply-ordered tx descriptors + the packed source-account
snapshot go in, per-tx pre-encoded ``feeProcessing``
LedgerEntryChanges plus packed account deltas come out.  Any
unsupported account shape declines the WHOLE fee batch back to the
per-tx ``frame.process_fee_seq_num`` loop — bytes identical either
way.

Parity contract: the kernel implements success paths only.  Any
structural mismatch, unexpected entry state, failing check or
arithmetic divergence comes back as a ``KernelDecline`` and the caller
runs the unchanged Python reference apply for that cluster — identical
bytes either way, which tests/test_native_apply.py holds across
workloads, worker counts and hash seeds.

Signature checking stays host-side ON PURPOSE: verdicts are already
batch-verified (and cached) before the apply phase, so the dispatcher
replays the master-key check the reference performs for a one-signer
account — hint match + cached verdict — and declines anything richer
(extra signers, non-master weights are state the kernel also guards).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..ledger.ledger_txn import _OFFER_PREFIX, account_key_bytes
from ..ledger.packed import LazyUnion, PackedEntry
from ..xdr import types as T

OT = T.OperationType


def _reason_slug(msg: str) -> str:
    """Stable metric-label slug of a decline reason (the kernel's
    ``need()`` strings are the taxonomy; host-side raises ride along)."""
    import re

    return re.sub(r"[^a-z0-9]+", "_", msg.lower()).strip("_")[:48] or \
        "unknown"


class KernelDecline(Exception):
    """The kernel cannot apply this cluster; Python apply takes it.

    Carries the decline taxonomy: ``op`` is the kernel-shape kind of
    the offending tx (``payment`` / ``offer`` / ``trust`` / ``pathpay``,
    or ``cluster`` for whole-cluster refusals) and ``code`` the reason
    slug — together they feed the ``apply.native.decline.<op>.<code>``
    metric breakout, so a decline storm names the exact coverage gap
    instead of bumping one opaque counter."""

    def __init__(self, msg: str, op: str = "cluster",
                 code: Optional[str] = None):
        super().__init__(msg)
        self.op = op
        self.code = code if code is not None else _reason_slug(msg)


def _screen_account(snapshot, account_id: bytes, idx: int) -> None:
    """Pre-pack host screen for the account entries every kernel tx
    MUST touch (tx source; payment destination).  The kernel's own
    parse raises the same refusals, but only AFTER the cluster's whole
    snapshot/book encode has been paid — and these shapes (extra
    signers, an inflation destination) persist across closes, so
    without the screen a cluster carrying such an account re-pays the
    pack cost on every close just to hear the same "no".  The decoded
    snapshot entry is already in hand: a few attribute reads decline
    the cluster before any encoding.  The kernel's parse stays the
    authority for every other shape."""
    e = snapshot.store.get(account_key_bytes(account_id))
    if e is not None:
        acc = e.data.value
        if acc.signers or acc.inflationDest is not None:
            raise KernelDecline(
                f"tx {idx}: unsupported account shape (host screen)",
                code="unsupported_account_shape")


#: protocol constants the C kernel hardcodes (apply_kernel.cpp) paired
#: with their Python source of truth — asserted before every dispatch
#: so a constant drift disables the kernel instead of risking a fork
#: (the full manifest lives in tools/lint/lockstep.json; detlint's
#: native-lockstep gate diffs both sides statically)
def _constants_in_lockstep() -> bool:
    from ..transactions import utils as U

    return (U.MAX_OFFERS_TO_CROSS == 1000
            and U.ACCOUNT_SUBENTRY_LIMIT == 1000
            and U.MAX_PATH_HOPS == 6
            and U.INT64_MAX == 2**63 - 1
            and int(T.AUTHORIZED_FLAG) == 1
            and int(T.AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG) == 2
            and int(T.TRUSTLINE_CLAWBACK_ENABLED_FLAG) == 4
            and int(T.AUTH_REQUIRED_FLAG) == 1
            and int(T.AUTH_CLAWBACK_ENABLED_FLAG) == 8
            and int(T.PASSIVE_FLAG) == 1
            and int(OT.CHANGE_TRUST) == 6
            and int(OT.PATH_PAYMENT_STRICT_RECEIVE) == 2
            and int(OT.PATH_PAYMENT_STRICT_SEND) == 13
            and int(T.LedgerEntryType.LIQUIDITY_POOL) == 5
            and int(T.ClaimAtomType.CLAIM_ATOM_TYPE_LIQUIDITY_POOL) == 2
            and T.LIQUIDITY_POOL_FEE_V18 == 30)


def kernel_module():
    """The _applykernel extension, or None (build attempted once; the
    native package serializes loading under its own lock)."""
    from ..native import get_apply_kernel

    return get_apply_kernel()


def frame_kernel_shape(frame) -> Optional[tuple]:
    """Structural (state-free) kernel eligibility of one frame; returns
    a shape descriptor consumed by ``run_cluster_native`` or None.

    Pure function of the transaction — safe to compute at plan time
    (including nomination-time preplans) and cache on the footprint.
    Structurally-MALFORMED bodies return None on purpose: malformed is
    a FAILURE result, and the Python reference owns every non-success
    outcome.
    """
    from ..transactions import utils as U
    from ..transactions.frame import TransactionFrame

    if type(frame) is not TransactionFrame:
        return None  # fee bumps carry a second fee source
    tx = frame.tx
    if len(tx.operations) != 1:
        return None
    if tx.cond.type != T.PreconditionType.PRECOND_NONE:
        return None  # time/ledger bounds + v2 preconditions stay host-side
    if len(frame.signatures) != 1:
        return None  # multisig evaluation stays host-side
    op = tx.operations[0]
    if op.sourceAccount is not None:
        return None
    body = op.body
    if body.type == OT.PAYMENT:
        b = body.value
        if not U.is_asset_valid(b.asset) or b.amount <= 0:
            return None
        return ("payment", U.muxed_to_account_id(b.destination), b.amount,
                T.Asset.encode(b.asset))
    if body.type == OT.MANAGE_SELL_OFFER:
        b = body.value
        if b.amount < 0 or b.offerID < 0 or \
                (b.amount == 0 and b.offerID == 0):
            return None  # malformed keeps the reference path
        if b.price.n <= 0 or b.price.d <= 0:
            return None
        return ("offer", T.Asset.encode(b.selling),
                T.Asset.encode(b.buying), b.amount, b.price.n, b.price.d,
                b.offerID)
    if body.type == OT.CHANGE_TRUST:
        b = body.value
        line = b.line
        if line.type in (T.AssetType.ASSET_TYPE_NATIVE,
                         T.AssetType.ASSET_TYPE_POOL_SHARE):
            return None  # native is malformed; pool shares stay host-side
        asset = T.Asset.make(line.type, line.value)
        if not U.is_asset_valid(asset) or b.limit < 0:
            return None
        if U.asset_issuer(asset) == frame.source_account_id():
            return None  # SELF_NOT_ALLOWED is a failure result
        return ("trust", T.Asset.encode(asset), b.limit)
    if body.type in (OT.PATH_PAYMENT_STRICT_SEND,
                     OT.PATH_PAYMENT_STRICT_RECEIVE):
        b = body.value
        strict_send = body.type == OT.PATH_PAYMENT_STRICT_SEND
        chain = [b.sendAsset, *b.path, b.destAsset]
        if len(chain) - 1 > U.MAX_PATH_HOPS:
            return None
        for a in chain:
            if not U.is_asset_valid(a):
                return None
        if strict_send:
            if b.sendAmount <= 0 or b.destMin <= 0:
                return None
            amount, amount2 = b.sendAmount, b.destMin
        else:
            if b.destAmount <= 0 or b.sendMax <= 0:
                return None
            amount, amount2 = b.sendMax, b.destAmount
        hops = _path_hops(chain)
        return ("pathpay", U.muxed_to_account_id(b.destination),
                int(body.type), T.Asset.encode(b.sendAsset), amount,
                T.Asset.encode(b.destAsset), amount2, hops)
    return None


def _path_hops(chain) -> tuple:
    """The effective conversion steps of a path-payment chain: adjacent
    equal assets collapse (exactly the reference's ``assets_equal``
    skip), and each hop carries its pair's liquidity-pool key so the
    kernel can quote a LIVE pool against a DECLARED key (and the
    ``NATIVE_POOL_QUOTE=0`` host screen can probe the same key)."""
    from ..transactions import liquidity_pool as LP
    from ..transactions import utils as U

    hops = []
    for i in range(len(chain) - 1):
        if U.assets_equal(chain[i], chain[i + 1]):
            continue
        hops.append((T.Asset.encode(chain[i]),
                     T.Asset.encode(chain[i + 1]),
                     LP.pair_pool_key_bytes(chain[i], chain[i + 1])))
    return tuple(hops)


def _signature_ok(frame, verify) -> bool:
    """The reference's master-key signature consume for a one-signer
    envelope: hint match + (cached) ed25519 verdict."""
    if verify is None:
        from ..crypto import verify_sig as verify
    ds = frame.signatures[0]
    pub = frame.source_account_id()
    return ds.hint == pub[-4:] and verify(pub, ds.signature,
                                          frame.full_hash())


def _tx_tuple(frame, shape) -> tuple:
    head = (frame.full_hash(), frame.source_account_id(),
            frame.seq_num(), frame.tx.fee, frame.fee_charged)
    kind = shape[0]
    if kind == "payment":
        # (dest, amount, asset)
        return (int(OT.PAYMENT), *head, shape[1], shape[2], shape[3])
    if kind == "offer":
        # (selling, buying, amount, price_n, price_d, offer_id)
        return (int(OT.MANAGE_SELL_OFFER), *head, shape[1], shape[2],
                shape[3], shape[4], shape[5], shape[6])
    if kind == "trust":
        # (line asset, limit)
        return (int(OT.CHANGE_TRUST), *head, shape[1], shape[2])
    # pathpay: (dest, op, send_asset, amount, dest_asset, amount2, hops)
    return (shape[2], *head, shape[1], shape[3], shape[4], shape[5],
            shape[6], shape[7])


def _kernel_ready(snapshot):
    """Shared dispatch gates; returns the kernel module or raises."""
    mod = kernel_module()
    if mod is None:
        raise KernelDecline("kernel unavailable")
    if not _constants_in_lockstep():
        raise KernelDecline("protocol constant drift")
    if snapshot.header.ledgerVersion != 19:
        # the kernel mirrors protocol-19 semantics; older gated
        # behaviors (check order, liability rules) stay host-side
        raise KernelDecline(
            f"protocol version {snapshot.header.ledgerVersion} "
            f"not kernel-backed")
    return mod


def _screen_cluster(cluster, snapshot, apply_order, verify):
    """Host-side per-tx gates (shape, clean master-key signature,
    supported account shapes) — cheap, run BEFORE any encoding is
    paid.  Returns the cluster's frames."""
    frames = [apply_order[i] for i in cluster.indices]
    for idx, frame, shape in zip(cluster.indices, frames,
                                 cluster.shapes):
        if shape is None:
            raise KernelDecline(f"tx {idx} not kernel-shaped",
                                code="not_kernel_shaped")
        if not _signature_ok(frame, verify):
            # a failing signature is a FAILURE result, not a success —
            # the reference path owns every non-success outcome
            raise KernelDecline(f"tx {idx} signature not clean",
                                op=shape[0], code="signature_not_clean")
        _screen_account(snapshot, frame.source_account_id(), idx)
        if shape[0] in ("payment", "pathpay"):
            # destination accounts are touched by every payment-shaped
            # apply; screen their persistent unsupported shapes too
            _screen_account(snapshot, shape[1], idx)
        if shape[0] == "pathpay" and not getattr(snapshot, "pool_quote",
                                                 True):
            # NATIVE_POOL_QUOTE=0 kill switch: restore the pre-r16
            # decline-if-live-pool behavior so the Python reference
            # adjudicates every pool-backed hop
            for _, _, pool_kb in shape[7]:
                if snapshot.store.get(pool_kb) is not None:
                    raise KernelDecline(
                        f"tx {idx}: liquidity pool on hop "
                        f"(pool quoting off)", op="pathpay",
                        code="liquidity_pool_on_hop")
    return frames


def _shape_kinds(clusters) -> "List[str]":
    """Kernel-shape kind of every tx across ``clusters`` in dispatch
    order — the map from a kernel decline's tx_index back to the op
    family for the decline-taxonomy metrics."""
    kinds: List[str] = []
    for cluster in clusters:
        kinds.extend(s[0] if s is not None else "cluster"
                     for s in cluster.shapes)
    return kinds


def _kernel_declined(kinds, reason, tx_index, batched=False):
    what = "batched tx" if batched else "tx"
    op = kinds[tx_index] if 0 <= tx_index < len(kinds) else "cluster"
    return KernelDecline(f"kernel declined {what} {tx_index}: {reason}",
                         op=op, code=_reason_slug(reason))


def _kind_counts(cluster) -> dict:
    """tx count per kernel-shape kind — feeds the per-op-type
    ``apply.native.hit.<op>`` attribution on a kernel hit."""
    counts: dict = {}
    for s in cluster.shapes:
        kind = s[0] if s is not None else "cluster"
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def _pack_inputs(snapshot, keys, pairs):
    """(entries, books) kernel tables over a declared key/pair set."""
    entries = []
    for kb in sorted(keys):
        e = snapshot.store[kb]
        entries.append((kb, None if e is None else T.LedgerEntry.encode(e)))
    books = []
    for pair in sorted(pairs):
        directions = snapshot.books[pair]
        for direction in sorted(directions):
            books.append((direction[0], direction[1],
                          [kb for _, _, kb in directions[direction]]))
    return entries, books


def _fill_records(res, indices, frames, records) -> None:
    """Wrap kernel (meta, result) byte pairs into the ClusterResult
    record shape the merge/hash/commit phases consume."""
    from ..utils import tracing

    inner_union = T.TransactionResult.fields[1][1]
    ext_v0 = T.TransactionResult.fields[2][1].make(0)
    with tracing.stopwatch() as sw:
        for idx, frame, (meta_b, result_b) in zip(indices, frames,
                                                  records):
            pair_b = frame.full_hash() + result_b
            env_b = T.TransactionEnvelope.encode(frame.envelope)
            # TransactionResult is a struct: rebuild its cheap scalar
            # fields eagerly (feeCharged i64 leads the encoding, ext v0
            # trails) and keep only the result union lazy
            result = T.TransactionResult.make(
                feeCharged=frame.fee_charged,
                result=LazyUnion(inner_union, result_b[8:-4]),
                ext=ext_v0)
            res.records[idx] = (
                True,
                result,
                LazyUnion(T.TransactionMeta, meta_b),
                meta_b, pair_b, env_b,
            )
    res.encode_seconds += sw.seconds


def run_cluster_native(cluster, snapshot, apply_order, verify,
                       result_cls):
    """Apply one kernel-eligible cluster natively.

    Returns a populated ``result_cls`` (the executor's ClusterResult)
    or raises ``KernelDecline`` — the caller then runs the Python
    reference apply for the cluster.  Never mutates shared state: the
    kernel works on copies, so a decline discards everything.
    """
    mod = _kernel_ready(snapshot)
    header = snapshot.header
    frames = _screen_cluster(cluster, snapshot, apply_order, verify)

    params = (header.ledgerSeq, header.scpValue.closeTime, header.baseFee,
              header.baseReserve, snapshot.idpool0)
    entries, books = _pack_inputs(snapshot, cluster.keys, cluster.pairs)
    txs = [_tx_tuple(frame, shape)
           for frame, shape in zip(frames, cluster.shapes)]

    out = mod.apply_cluster(params, entries, books, txs)
    if not out[0]:
        _, reason, tx_index = out
        raise _kernel_declined(_shape_kinds([cluster]), reason, tx_index)
    _, deltas, records, idpool_final = out

    from .executor import _is_fresh_offer_key

    res = result_cls(cluster.cluster_id)
    res.native = "hit"
    res.op_kinds = _kind_counts(cluster)
    declared = cluster.writes
    for kb, eb in deltas:
        # write-side guard, mirroring the executor's _post_check: every
        # kernel write must be a declared write or a fresh offer id
        if kb not in declared and not _is_fresh_offer_key(
                kb, snapshot.idpool0):
            # fixed code: the key hex must not leak into the metric
            # name (unbounded counter cardinality in a decline storm)
            raise KernelDecline(f"kernel wrote undeclared key {kb.hex()}",
                                code="undeclared_write")
        res.delta[kb] = None if eb is None else PackedEntry(eb)
        if kb.startswith(_OFFER_PREFIX):
            res.okeys.add(kb)
    if idpool_final != snapshot.idpool0:
        if not cluster.writes_header:
            raise KernelDecline("kernel allocated ids without the token")
        res.header = header._replace(idPool=idpool_final)
    _fill_records(res, cluster.indices, frames, records)
    return res


def run_clusters_native_batched(clusters, snapshot, apply_order, verify,
                                result_cls):
    """Apply MANY kernel-eligible clusters in ONE encode + ONE
    GIL-released ``apply_cluster`` crossing (ROADMAP 2d: a 1000-payment
    close plans hundreds of 2-tx clusters, and per-cluster dispatch
    pays the FFI/encode toll hundreds of times).

    Sound because batchable clusters are disjoint by construction (the
    planner merges any key/book/id-pool conflict into one cluster) and
    none writes the header (id-pool allocators are excluded by the
    caller): applying their transactions back-to-back over the merged
    snapshot table is exactly per-cluster application.  Outputs are
    split back per cluster — deltas by the declared-key ownership map,
    records by tx index.  Any decline rejects the WHOLE batch; the
    caller retries per cluster so one poisoned cluster cannot drag its
    batchmates onto the Python path.
    """
    mod = _kernel_ready(snapshot)
    header = snapshot.header
    clusters = sorted(clusters, key=lambda c: c.cluster_id)
    owner: dict = {}
    all_keys: set = set()
    all_pairs: set = set()
    txs = []
    frames_of = {}
    for cluster in clusters:
        if cluster.writes_header:
            raise KernelDecline(
                f"cluster {cluster.cluster_id} allocates offer ids; "
                f"not batchable")
        frames = _screen_cluster(cluster, snapshot, apply_order, verify)
        frames_of[cluster.cluster_id] = frames
        for kb in cluster.keys:
            owner[kb] = cluster
        all_keys |= cluster.keys
        all_pairs |= cluster.pairs
        for frame, shape in zip(frames, cluster.shapes):
            txs.append(_tx_tuple(frame, shape))

    params = (header.ledgerSeq, header.scpValue.closeTime, header.baseFee,
              header.baseReserve, snapshot.idpool0)
    entries, books = _pack_inputs(snapshot, all_keys, all_pairs)
    out = mod.apply_cluster(params, entries, books, txs)
    if not out[0]:
        _, reason, tx_index = out
        raise _kernel_declined(_shape_kinds(clusters), reason, tx_index,
                               batched=True)
    _, deltas, records, idpool_final = out
    if idpool_final != snapshot.idpool0:
        raise KernelDecline("batched kernel allocated offer ids")

    results = {}
    for c in clusters:
        res = result_cls(c.cluster_id)
        res.native = "hit"
        res.op_kinds = _kind_counts(c)
        results[c.cluster_id] = res
    for kb, eb in deltas:
        cluster = owner.get(kb)
        # no fresh-offer exemption here: id-pool allocators never batch,
        # so every write must belong to exactly one declared key set
        if cluster is None or kb not in cluster.writes:
            raise KernelDecline(
                f"batched kernel wrote undeclared key {kb.hex()}",
                code="undeclared_write")
        res = results[cluster.cluster_id]
        res.delta[kb] = None if eb is None else PackedEntry(eb)
        if kb.startswith(_OFFER_PREFIX):
            res.okeys.add(kb)
    pos = 0
    for cluster in clusters:
        frames = frames_of[cluster.cluster_id]
        n = len(frames)
        _fill_records(results[cluster.cluster_id], cluster.indices,
                      frames, records[pos:pos + n])
        pos += n
    return [results[c.cluster_id] for c in clusters]


def run_fee_phase_native(ltx, apply_order, base_fee):
    """Charge the WHOLE fee/seqnum phase in one GIL-released kernel
    call (apply_kernel.cpp ``charge_fees`` — the batched twin of the
    per-tx ``frame.process_fee_seq_num`` loop).

    On success: sets ``frame.fee_charged`` on every frame, installs the
    packed post-charge account images + the feePool bump into ``ltx``,
    and returns the per-tx ``feeProcessing`` LedgerEntryChanges (each a
    pre-encoded ``[STATE, UPDATED]`` pair riding ``LazyUnion``) in the
    exact shape the Python loop returns.  Raises ``KernelDecline`` with
    ``ltx`` untouched otherwise — any unsupported account shape
    declines the whole batch to the reference loop (bytes identical
    either way; tests/test_native_fee.py holds the parity)."""
    from ..transactions import utils as U
    from ..transactions.frame import TransactionFrame

    mod = kernel_module()
    if mod is None:
        raise KernelDecline("kernel unavailable", op="fee")
    if not _constants_in_lockstep():
        raise KernelDecline("protocol constant drift", op="fee")
    header = ltx.header()
    if header.ledgerVersion != 19:
        raise KernelDecline(
            f"protocol version {header.ledgerVersion} not kernel-backed",
            op="fee")

    acct_idx: dict = {}
    acct_keys: List[bytes] = []
    accounts: List[bytes] = []
    fee_txs: List[tuple] = []
    for idx, frame in enumerate(apply_order):
        if type(frame) is not TransactionFrame:
            # fee bumps charge a second fee source; reference loop owns
            raise KernelDecline(f"tx {idx} not kernel-shaped", op="fee",
                                code="not_kernel_shaped")
        src = frame.source_account_id()
        i = acct_idx.get(src)
        if i is None:
            kb = account_key_bytes(src)
            entry = ltx.get(kb)
            if entry is None:
                # the reference raises "fee source vanished" — a halt,
                # not a success path; keep it on the Python loop
                raise KernelDecline(f"tx {idx} fee source missing",
                                    op="fee", code="fee_source_missing")
            i = acct_idx[src] = len(accounts)
            acct_keys.append(kb)
            accounts.append(T.LedgerEntry.encode(entry))
        fee_txs.append((i, frame.get_full_fee(), frame.num_operations()))

    # base_fee None means "no vote: charge the full fee"; an
    # INT64_MAX stride makes the kernel's min() pick full_fee exactly
    bf = U.INT64_MAX if base_fee is None else base_fee
    out = mod.charge_fees((header.ledgerSeq, bf), accounts, fee_txs)
    if not out[0]:
        raise KernelDecline(f"kernel declined fee batch: {out[1]}",
                            op="fee", code=_reason_slug(out[1]))
    _, rows, finals, fee_pool_delta = out

    fee_changes = []
    for frame, (charged, state_b, upd_b) in zip(apply_order, rows):
        frame.fee_charged = charged
        fee_changes.append([LazyUnion(T.LedgerEntryChange, state_b),
                            LazyUnion(T.LedgerEntryChange, upd_b)])
    # the merge is the executor's delta-install idiom: packed images
    # land in the close ltx, materialized only if someone reads them
    for kb, eb in zip(acct_keys, finals):
        ltx._delta[kb] = PackedEntry(eb)
    ltx.set_header(header._replace(
        feePool=header.feePool + fee_pool_delta))
    return fee_changes
