"""LedgerManager: the replicated-state-machine "apply" side
(ref src/ledger/LedgerManagerImpl.cpp — SURVEY.md §2.4).

``close_ledger`` follows the reference's step order (closeLedger :669-933):
apply-order sort -> fee phase (processFeesSeqNums) -> apply phase
(applyTransactions) -> upgrades -> header seal -> bucket list add ->
history/meta emission -> SQL commit.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from ..crypto import SecretKey, sha256
from ..utils import lockdep
from ..xdr import types as T, xdr_sha256
from .ledger_txn import LedgerTxn, LedgerTxnRoot, open_database

GENESIS_LEDGER_SEQ = 1

# last seq a deferred post-close collection ran for (process-global:
# the interpreter has ONE gc, so one collection per closed seq covers
# every co-hosted simulated node).  The lock serializes the dedup
# check-then-set between one app's sequential close (main thread) and
# another app's pipelined tail worker — unlocked, both could run the
# same collection or one could skip it (detlint conc-unguarded-shared)
_GC_SEQ_LOCK = lockdep.register_lock(threading.Lock(), "ledger.gc_seq")
_LAST_GC_SEQ = -1  # guarded-by: _GC_SEQ_LOCK


def _add_phases(record: dict, ms: dict) -> None:
    """Add each value to the record's (ms round to the record's 3
    decimals; counts stay whole)."""
    for k, v in ms.items():
        total = record.get(k, 0) + v
        record[k] = round(total, 3) if isinstance(total, float) else total


class LedgerCloseData:
    """(ledgerSeq, TxSetFrame, StellarValue) bundle handed from Herder
    (ref src/herder/LedgerCloseData.h:23)."""

    def __init__(self, ledger_seq: int, tx_set, close_value):
        self.ledger_seq = ledger_seq
        self.tx_set = tx_set
        self.close_value = close_value  # XDR StellarValue


class LedgerManager:
    def __init__(self, app):
        self.app = app
        # late-bound bucket source: restore/assume swap the list object
        self.root = LedgerTxnRoot(
            app.database,
            bucket_list=lambda: app.bucket_manager.bucket_list)
        self._lcl_hash: Optional[bytes] = None
        self.metrics = app.metrics
        # pipelined close engine (ledger/close_pipeline.py): after the
        # header seals, the commit/meta/gc tail runs on a worker while
        # the herder triggers the next ledger; PIPELINED_CLOSE=0 keeps
        # the fully synchronous path below
        from .close_pipeline import ClosePipeline
        import threading

        self.pipeline = ClosePipeline(app)
        # serializes last_close_phases finalize (close thread) against
        # the tail's deferred phase publish (worker)
        self._phases_lock = lockdep.register_lock(threading.Lock(),
                                                  "ledger.phases")
        # per-phase breakdown of the most recent close (ms), plus
        # cumulative phase timers in the metrics registry — the
        # observability the async merge pipeline is judged by.  Timing
        # comes from the flight recorder's spans (utils/tracing.py), so
        # the same measurement feeds this dict, the span ring, the
        # watchdog, and the Prometheus exposition.
        #
        # The record is the node's account of the whole ledger: the
        # herder seeds it with what it measured before the close
        # (admission since the previous close, the trigger, SCP, the SCP
        # history's write: seed_close_record) and folds in what follows
        # it (add_close_phases); the close adds its own wall time and its
        # drain (_close_ledger_timed), the tail its phases and flushes.
        self.last_close_phases: dict = {}
        self._record_seed: dict = {}

    # -- genesis / load ----------------------------------------------------

    def start_new_ledger(self) -> None:
        """Create the genesis ledger: root account holds all lumens; root
        secret seed = network id (ref LedgerManagerImpl::startNewLedger,
        GENESIS_* constants)."""
        cfg = self.app.config
        root_sk = SecretKey(cfg.network_id())
        total = 10**11 * 10**7  # 100B lumens in stroops
        sv = T.StellarValue.make(
            txSetHash=b"\x00" * 32,
            closeTime=0,
            upgrades=[],
            ext=T.StellarValue.fields[3][1].make(
                T.StellarValueType.STELLAR_VALUE_BASIC))
        header = T.LedgerHeader.make(
            ledgerVersion=cfg.LEDGER_PROTOCOL_VERSION,
            previousLedgerHash=b"\x00" * 32,
            scpValue=sv,
            txSetResultHash=b"\x00" * 32,
            bucketListHash=b"\x00" * 32,
            ledgerSeq=GENESIS_LEDGER_SEQ,
            totalCoins=total,
            feePool=0,
            inflationSeq=0,
            idPool=0,
            baseFee=cfg.TESTING_UPGRADE_DESIRED_FEE,
            baseReserve=cfg.TESTING_UPGRADE_RESERVE,
            maxTxSetSize=cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE,
            skipList=[b"\x00" * 32] * 4,
            ext=T.LedgerHeader.fields[14][1].make(0),
        )
        from ..transactions import utils as U

        with LedgerTxn(self.root) as ltx:
            ltx.set_header(header)
            ltx.commit()
        with LedgerTxn(self.root) as ltx:
            ltx.put(U.make_account_entry(
                root_sk.public_key().raw, total, seq_num=0))
            ltx.commit()
        self._lcl_hash = xdr_sha256(T.LedgerHeader, header)
        self._store_lcl(header)

    def load_last_known_ledger(self) -> bool:
        try:
            header = self.root.header()
        except Exception:
            return False
        self._lcl_hash = xdr_sha256(T.LedgerHeader, header)
        return True

    # -- accessors ---------------------------------------------------------

    def last_closed_header(self):
        return self.root.header()

    def last_closed_hash(self) -> bytes:
        if self._lcl_hash is None:
            self._lcl_hash = xdr_sha256(
                T.LedgerHeader, self.root.header())
        return self._lcl_hash

    def last_closed_seq(self) -> int:
        return self.root.header().ledgerSeq

    def _store_lcl(self, header, lcl_hash: Optional[bytes] = None,
                   commit: bool = True) -> None:
        """``commit=False``: the pipelined tail batches this into its
        single durable transaction (close_pipeline.run_close_tail)."""
        if lcl_hash is None:
            lcl_hash = self._lcl_hash
        self.app.database.execute(
            "INSERT INTO persistentstate(statename, state) "
            "VALUES('lastclosedledger', ?) ON CONFLICT(statename) "
            "DO UPDATE SET state=excluded.state",
            (lcl_hash.hex(),))
        if commit:
            self.app.database.commit()

    # -- the close path ----------------------------------------------------

    def close_ledger(self, close_data: LedgerCloseData) -> None:
        """ref closeLedger :669-933."""
        prof = self.app.clock.profiler
        if prof is None:
            return self._close_ledger_timed(close_data)
        # crank wall attribution: close work runs inside whatever
        # dispatch externalized the value — carve it into "ledger"
        tok = prof.scope_begin("ledger")
        try:
            return self._close_ledger_timed(close_data)
        finally:
            prof.scope_end(tok)

    def seed_close_record(self, ms: dict) -> None:
        """Phases (ms) that the node measured for the next ledger before
        its close starts; the close's record begins with them."""
        self._record_seed = dict(ms)

    def add_close_phases(self, ms: dict) -> dict:
        """Add phases (ms, or counts) measured after the close to the
        record of the ledger it closed, under the lock that the tail's
        deferred phases take too; a copy of the record after it."""
        with self._phases_lock:
            _add_phases(self.last_close_phases, ms)
            return dict(self.last_close_phases)

    def _close_ledger_timed(self, close_data: LedgerCloseData) -> None:
        from ..utils import tracing
        from ..utils.logging import LogSlowExecution

        tracer = self.app.tracer
        with tracing.stopwatch() as wall, \
                self.metrics.timer("ledger.ledger.close").time_scope(), \
                LogSlowExecution(f"closeLedger {close_data.ledger_seq}",
                                 threshold_seconds=2.0):
            root = None
            try:
                with tracer.span("ledger.close",
                                 ledger=close_data.ledger_seq) as root:
                    self._close_ledger_inner(close_data)
            finally:
                # seal the close's span tree into the ring EVEN when the
                # close raised — a failed close's spans (root included)
                # must not leak into the next close's record; the
                # slow-close watchdog fires here (persists Chrome-trace
                # JSON + one summary line)
                if root is not None:
                    tracer.commit_close(close_data.ledger_seq, root)
        with tracing.stopwatch() as drain:
            if self.pipeline.enabled and self.pipeline.eager_drain:
                # test/standalone rigs: make the deferred tail durable
                # before returning so post-close reads keep sequential
                # semantics (real nodes overlap; see close_pipeline.py)
                self.pipeline.drain()
                self.pipeline.stats["eager_drains"] += 1
        self.add_close_phases({"close_ledger": wall.seconds * 1000.0,
                               "drain": drain.seconds * 1000.0})

    def _phase(self, phases: dict, name: str, seconds: float) -> None:
        phases[name] = phases.get(name, 0.0) + seconds * 1000.0
        self.metrics.timer(f"ledger.close.phase.{name}").update(seconds)

    def _close_ledger_inner(self, close_data: LedgerCloseData) -> None:
        prev_header = self.root.header()
        if close_data.ledger_seq != prev_header.ledgerSeq + 1:
            raise RuntimeError(
                f"out-of-order close: got {close_data.ledger_seq}, "
                f"lcl is {prev_header.ledgerSeq}")
        tx_set = close_data.tx_set
        if tx_set.previous_ledger_hash != self.last_closed_hash():
            raise RuntimeError("tx set prev hash mismatch")
        sv = close_data.close_value

        from ..utils import tracing

        tracer = self.app.tracer
        phases, self._record_seed = self._record_seed, {}
        total_sw = tracing.stopwatch().__enter__()

        with LedgerTxn(self.root) as ltx:
            # open the new ledger: bump seq, set close-time scpValue
            new_header = prev_header._replace(
                ledgerSeq=close_data.ledger_seq,
                previousLedgerHash=self.last_closed_hash(),
                scpValue=sv,
            )
            ltx.set_header(new_header)

            apply_order = tx_set.txs_in_apply_order()

            # bulk-load the entries this set will touch before the apply
            # loops go key-by-key (ref LedgerTxnRoot::prefetch fed by
            # insertKeysForFeeProcessing/insertLedgerKeysToPrefetch)
            # (with the pipeline on, the herder already batch-loaded
            # these keys from the bucket tier at nomination on the
            # prefetch worker — close_pipeline.stage_prefetch — so for
            # self-proposed sets this phase is a warm-cache hit)
            with tracer.span("ledger.close.prefetch") as sp:
                prefetch_keys: set = set()
                for frame in apply_order:
                    prefetch_keys.update(frame.keys_to_prefetch())
                self.root.prefetch(prefetch_keys)
            self._phase(phases, "prefetch", sp.seconds)

            # phase 0: batched signature verification on the node's
            # device (P5); the "cpu" backend verifies on the host
            with tracer.span("ledger.close.verify") as sp:
                verdicts = tx_set.prevalidate_signatures(
                    use_device=self.app.config.CRYPTO_BACKEND == "cuda",
                    tracer=tracer, device=self.app.device)
                verify = tx_set.make_cached_verify(verdicts)
            self._phase(phases, "verify", sp.seconds)

            # phase 1: fees + seqnums for every tx, in apply order
            # (ref processFeesSeqNums :1164) — one batched GIL-released
            # kernel call when every tx fits (NATIVE_FEE), else the
            # per-tx reference loop; bytes identical either way
            base_fee = prev_header.baseFee
            with tracer.span("ledger.close.fee") as sp, \
                    self.metrics.timer(
                        "ledger.transaction.fee").time_scope(), \
                    tracing.collect_op_costs() as fee_costs:
                fee_changes = self._charge_fees(ltx, apply_order,
                                                base_fee)
            self._phase(phases, "fee", sp.seconds)
            # cost attribution mirrors the apply phase's op breakdown:
            # one batched kernel call still lands count=len(apply_order)
            # so per-tx fee cost stays readable off the span tree
            cursor = sp.t0
            for name in sorted(fee_costs.costs):
                total_s, count = fee_costs.costs[name]
                tracer.aggregate_span(
                    f"ledger.fee.op.{name}",
                    sp.span_id or None, cursor, total_s, count=count)
                cursor += total_s
            # lifecycle stage "fee": the batch charges every tx at one
            # instant, which is exactly the stamp contract (stages are
            # close-level events sharing one timestamp)
            self.app.txtracer.stamp_frames(apply_order, "fee")

            # phase 2: apply transactions (ref applyTransactions :1297)
            # with per-operation-type cost attribution: frame.apply's op
            # loop feeds the collector, and the totals become synthetic
            # sub-spans of the apply span (payment vs. DEX crossing —
            # the attribution gap of ROADMAP item 7).
            #
            # Parallel path (apply/): plan conflict clusters over the
            # canonical order, run them concurrently against footprint-
            # guarded snapshots, merge the disjoint deltas back — bit-
            # identical to the sequential loop, which stays as the
            # always-correct fallback (planner declined / escape abort /
            # PARALLEL_APPLY=0).
            par = self.app.parallel_apply
            plan = None
            planned = False
            if par.enabled and len(apply_order) >= 2:
                with tracer.span("ledger.close.plan") as sp:
                    plan = par.plan(tx_set, apply_order, ltx)
                planned = True
                self._phase(phases, "plan", sp.seconds)
            tx_result_metas: List[object] = []
            result_pairs: List[object] = []
            encoded_rows: Optional[List[Tuple[bytes, bytes, bytes]]] = None
            with tracer.span("ledger.close.apply") as sp_apply, \
                    self.metrics.timer(
                        "ledger.transaction.apply").time_scope(), \
                    tracing.collect_op_costs() as op_costs:
                outcome = None
                if plan is not None:
                    outcome = par.execute(
                        plan, ltx, apply_order, verify,
                        self.app.invariants.check_on_tx_apply)
                if outcome is not None:
                    encoded_rows = []
                else:
                    if par.enabled:
                        par.stats["sequential_closes"] += 1
                for i, frame in enumerate(apply_order):
                    if outcome is not None:
                        _ok, result, meta, meta_b, pair_b, env_b = \
                            outcome[i]
                        encoded_rows.append((env_b, pair_b, meta_b))
                    else:
                        _ok, result, meta = frame.apply(
                            ltx, verify=verify,
                            invariant_check=self.app.invariants
                            .check_on_tx_apply)
                    pair = frame.result_pair(result)
                    result_pairs.append(pair)
                    tx_result_metas.append(T.TransactionResultMeta.make(
                        result=pair,
                        feeProcessing=fee_changes[i],
                        txApplyProcessing=meta))
            self._phase(phases, "apply", sp_apply.seconds)
            # lifecycle stage "apply" (observational; the commit stamp
            # lands later — on the tail worker under the pipeline)
            self.app.txtracer.stamp_frames(apply_order, "apply")
            if planned and par.last_plan_stats:
                phases["parallel"] = dict(
                    par.last_plan_stats,
                    mode=("parallel" if encoded_rows is not None
                          else "sequential"))
            op_ms: dict = {}
            cursor = sp_apply.t0
            for name in sorted(op_costs.costs):
                total_s, count = op_costs.costs[name]
                op_ms[name] = round(total_s * 1000.0, 3)
                tracer.aggregate_span(
                    f"ledger.apply.op.{name}",
                    sp_apply.span_id or None, cursor, total_s,
                    count=count)
                cursor += total_s
            phases["apply_ops"] = op_ms

            # phase 3: upgrades — each validated against local policy
            # before applying; invalid remote upgrades are skipped, not
            # fatal (ref LedgerManagerImpl :786-830 + Upgrades::
            # isValidForApply)
            from ..herder.upgrades import VALID, is_valid_for_apply

            upgrade_metas: List[object] = []
            with tracer.span("ledger.close.upgrades") as sp:
                for raw in sv.upgrades:
                    validity, upgrade = is_valid_for_apply(
                        raw, ltx.header(), self.app.config)
                    if validity != VALID:
                        continue
                    with LedgerTxn(ltx) as ultx:
                        hdr = self._apply_upgrade(ultx.header(), upgrade)
                        ultx.set_header(hdr)
                        changes = ultx.changes()
                        ultx.commit()
                    upgrade_metas.append(T.UpgradeEntryMeta.make(
                        upgrade=upgrade, changes=changes))
            self._phase(phases, "upgrades", sp.seconds)

            # phase 4: seal the header
            with tracer.span("ledger.close.hash") as sp:
                if encoded_rows is not None:
                    # assemble the TransactionResultSet encoding from
                    # the workers' pre-encoded TransactionResultPair
                    # bytes (XDR VarArray = >I count + elements) —
                    # byte-identical to encoding the whole set here
                    tx_result_hash = sha256(
                        len(result_pairs).to_bytes(4, "big")
                        + b"".join(pb for _, pb, _ in encoded_rows))
                else:
                    result_set = T.TransactionResultSet.make(
                        results=result_pairs)
                    tx_result_hash = xdr_sha256(T.TransactionResultSet,
                                                result_set)
                sealed = ltx.header()._replace(
                    txSetResultHash=tx_result_hash,
                )
                ltx.set_header(sealed)
            self._phase(phases, "hash", sp.seconds)

            # phase 5: bucket list — state commitment.  spill_wait /
            # bucket-hash sub-phases come from the merge pipeline's own
            # accounting (deltas over BucketList.stats)
            bl = self.app.bucket_manager.bucket_list
            stats0 = dict(bl.stats)
            with tracer.span("ledger.close.bucket") as sp:
                bucket_changes = self._collect_changes(ltx)
                bucket_hash = self.app.bucket_manager.add_batch(
                    close_data.ledger_seq, bucket_changes)
            self._phase(phases, "bucket", sp.seconds)
            phases["spill_wait"] = round(
                (bl.stats["spill_wait_s"] - stats0["spill_wait_s"])
                * 1000.0, 3)
            phases["bucket_hash"] = round(
                (bl.stats["hash_s"] - stats0["hash_s"]) * 1000.0, 3)
            # the worker's merges that finished since the previous close
            # (they share the host with this thread)
            phases["merge_ms"] = round(bl.take_merge_stats() * 1000.0, 3)
            sync_fb = int(bl.stats["sync_fallback_merges"]
                          - stats0["sync_fallback_merges"])
            if sync_fb:
                self.metrics.counter(
                    "bucket.merge.sync-fallback").inc(sync_fb)

            pipelined = self.pipeline.enabled
            staged_delta = None
            with tracer.span("ledger.close.seal") as sp_seal:
                if pipelined:
                    # strict depth-1: ledger N-1's tail must be DURABLE
                    # before N seals — at most one sealed-but-
                    # uncommitted ledger ever exists, so a crash always
                    # recovers to the last durably committed LCL (the
                    # chaos kill-restore contract)
                    with tracer.span("ledger.close.tail_wait") as spw:
                        self.pipeline.barrier()
                    phases["tail_wait"] = round(spw.seconds * 1000.0, 3)
                sealed = ltx.header()._replace(bucketListHash=bucket_hash)
                sealed = self._update_skip_list(sealed)
                ltx.set_header(sealed)
                if pipelined:
                    # the header is final (consensus-visible result):
                    # install the write-ahead overlay so ledger N+1's
                    # reads see this delta while the SQL commit runs on
                    # the tail worker; the LedgerTxn layer is released
                    # WITHOUT a root commit
                    staged_delta = ltx._delta
                    new_header = ltx.header()
                    ltx.rollback()
                    self.root.stage_sealed(staged_delta, new_header)
                    self._lcl_hash = xdr_sha256(T.LedgerHeader,
                                                new_header)
                else:
                    # phase 6: persist tx history rows (SQL, same commit)
                    self._store_tx_history(close_data.ledger_seq,
                                           apply_order, tx_result_metas,
                                           encoded_rows)
                    ltx.commit()

        if pipelined:
            from .close_pipeline import StagedTail

            # the tail's spans hang off the close ROOT (they are
            # siblings of seal/stage, not children of the submit)
            tail_parent = tracer.current_id()
            with tracer.span("ledger.close.stage") as sp:
                bl = self.app.bucket_manager.bucket_list
                st = StagedTail(
                    seq=close_data.ledger_seq,
                    delta=staged_delta,
                    header=new_header,
                    lcl_hash=self._lcl_hash,
                    apply_order=apply_order,
                    tx_result_metas=tx_result_metas,
                    encoded_rows=encoded_rows,
                    tx_set=tx_set,
                    upgrade_metas=upgrade_metas,
                    phases=phases,
                    parent_token=tail_parent,
                    # bucket state snapshots: the tail must never read
                    # the live level list N+1's add_batch mutates
                    level_hashes=bl.level_hashes(),
                    sql_ahead_hex=sorted(
                        kb.hex() for kb in self.root._sql_ahead),
                    buckets=[b for lv in bl.levels
                             for b in (lv.curr, lv.snap)
                             if not b.is_empty()])
                self.pipeline.submit_tail(st)
            self._phase(phases, "stage", sp_seal.seconds + sp.seconds)
        else:
            with tracer.span("ledger.close.commit") as sp:
                # the buckets now cover this close's delta: bucket-mode
                # reads no longer need the commit's sql-ahead overlay
                # copies
                self.root.note_bucket_applied(
                    kb for kb, _, _ in bucket_changes)
                new_header = self.root.header()
                self._lcl_hash = xdr_sha256(T.LedgerHeader, new_header)
                self._store_lcl(new_header)
                self._store_bucket_state()
                # lifecycle stage "commit": the ledger is durable
                self.app.txtracer.stamp_frames(
                    apply_order, "commit", seq=close_data.ledger_seq)
            self._phase(phases, "commit", sp_seal.seconds + sp.seconds)
        self.metrics.counter("ledger.ledger.count").set_count(
            new_header.ledgerSeq)
        if not pipelined:
            # history: queue + publish checkpoints (ref closeLedger
            # :890-899 — queueing is crash-safe because the header row
            # committed above in the same SQL database)
            with tracer.span("ledger.close.meta") as sp:
                hm = self.app.history_manager
                if hm is not None:
                    hm.maybe_queue_history_checkpoint(new_header.ledgerSeq)
                    hm.publish_queued_history()
                # meta stream for downstream consumers
                self.app.emit_ledger_close_meta(
                    new_header, tx_set, tx_result_metas, upgrade_metas)
            self._phase(phases, "meta", sp.seconds)
        # test hook: a deliberately slowed close to exercise the
        # slow-close watchdog end to end.  Placed AFTER the bucket phase
        # so merges staged on the worker pool this close deterministically
        # finish (and record their spans) before the close commits —
        # exactly what the cross-thread parenting test needs; the span
        # makes the persisted trace attribute the delay honestly.
        delay = self.app.config.ARTIFICIALLY_SLEEP_IN_CLOSE_FOR_TESTING
        if delay > 0:
            from time import sleep

            with tracer.span("ledger.close.test_delay", seconds=delay):
                sleep(delay)
        if not pipelined:
            with tracer.span("ledger.close.gc") as sp:
                self._post_close_gc(new_header.ledgerSeq)
            self._phase(phases, "gc", sp.seconds)
        total_sw.__exit__()
        phases["total"] = round(total_sw.seconds * 1000.0, 3)
        phases["sync_fallback_merges"] = sync_fb
        if pipelined:
            phases["_seq"] = close_data.ledger_seq
        with self._phases_lock:
            self.last_close_phases = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in phases.items()}
        from ..utils.logging import get_logger

        get_logger("Ledger").debug(
            "closed ledger %d: %d txs in %.1fms (apply %.1fms, "
            "bucket %.1fms)", close_data.ledger_seq, len(apply_order),
            phases["total"], phases.get("apply", 0.0),
            phases.get("bucket", 0.0))

    def _publish_tail_phases(self, st, tail_s: dict) -> None:
        """Tail worker: record the deferred phases' durations — metrics
        timers always; the close's phase dicts under the publish lock
        (the close thread may be finalizing them concurrently)."""
        for name in sorted(tail_s):
            self.metrics.timer(
                f"ledger.close.phase.{name}").update(tail_s[name])
        tail_ms = {name: round(s * 1000.0, 3)
                   for name, s in tail_s.items()}
        tail_ms["tail_total"] = round(
            sum(s for s in tail_s.values()) * 1000.0, 3)
        tail_ms["tail_deferred"] = True
        # the tail worker's flushes: this worker runs only tails, so
        # they are this ledger's
        n, seconds = self.app.database.take_commit_stats()
        flushes = {"db_commits": n, "db_commit_ms": seconds * 1000.0}
        with self._phases_lock:
            st.phases.update(tail_ms)
            _add_phases(st.phases, flushes)
            lcp = self.last_close_phases
            if lcp is not st.phases and lcp.get("_seq") == st.seq:
                lcp.update(tail_ms)
                _add_phases(lcp, flushes)

    def _post_close_gc(self, seq: int) -> None:
        """DEFERRED_GC: young-gen collection after every close, full
        collection every 64 (the checkpoint cadence) — never during the
        close itself."""
        from ..main import application as app_mod

        # collect whenever the process-global deferral is active, even if
        # THIS app's config says False — once some app disabled automatic
        # GC, any closing app must carry the collection duty or cyclic
        # garbage grows unboundedly
        if not (self.app.config.DEFERRED_GC or app_mod._GC_DEFERRED):
            return
        # GC is process-wide: in a many-validator simulation every node
        # closes the same seq back-to-back, and 50 identical collections
        # per round (50 FULL ones at the seq%64 cadence) dominate wall
        # time.  One collection per closed seq covers the whole process.
        global _LAST_GC_SEQ
        with _GC_SEQ_LOCK:
            if seq == _LAST_GC_SEQ:
                return
            _LAST_GC_SEQ = seq
        import gc

        full = seq % 64 == 0
        gc.collect(2 if full else 1)
        if full and getattr(self.app.config,
                            "GC_FREEZE_LONG_LIVED", True):
            # Everything that survived a FULL collection is long-lived
            # state — adopted buckets, their indexes, XDR caches —
            # exactly the arena whose gen-2 traversal produced
            # SOAK_BENCH_r13's 427ms p99 close.  Freeze it into the
            # permanent generation: the next full collect traverses
            # only the delta since this checkpoint.  Refcounting still
            # frees frozen objects (bucket dicts of bytes are acyclic);
            # only cyclic garbage among frozen survivors would leak,
            # and the collect(2) above just removed the cycles.
            gc.freeze()

    def _store_bucket_state(self, level_hashes=None, sql_ahead_hex=None,
                            commit: bool = True,
                            run_gc: bool = True) -> None:
        """Persist the bucket-list level hashes so a restarted node can
        reassume its state from the on-disk buckets (ref PersistentState
        kHistoryArchiveState).  Only meaningful with an on-disk bucket
        store; GC of unreferenced bucket files runs AFTER this commit so a
        crash can never leave the persisted hashes pointing at deleted
        files.

        The pipelined tail passes ``level_hashes``/``sql_ahead_hex``
        snapshots captured on the close thread at seal (the live list
        may already be mutating under the NEXT close) and batches the
        rows into its own transaction (``commit=False, run_gc=False``)."""
        bm = self.app.bucket_manager
        if bm.bucket_dir is None:
            return
        if level_hashes is None:
            level_hashes = bm.bucket_list.level_hashes()
        from contextlib import nullcontext

        # standalone (commit=True) callers group both rows atomically;
        # the tail passes commit=False and already owns the scope
        scope = (self.app.database.write_txn() if commit
                 else nullcontext())
        with scope:
            self._store_bucket_state_sql(level_hashes, sql_ahead_hex)
            if commit:
                self.app.database.commit()
        if run_gc:
            bm.gc_unreferenced()

    def _store_bucket_state_sql(self, level_hashes, sql_ahead_hex
                                ) -> None:
        import json

        self.app.database.execute(
            "INSERT INTO persistentstate(statename, state) "
            "VALUES('bucketlist', ?) ON CONFLICT(statename) "
            "DO UPDATE SET state=excluded.state",
            (json.dumps(level_hashes),))
        # the sql-ahead overlay keys persist WITH the bucket state: a
        # restarted node re-verifies the buckets against the header but
        # can never re-derive which keys only ever lived in SQL (genesis
        # root before its first fee debit, test-rig bulk seeds) — losing
        # them would make BucketListDB-mode reads miss live entries
        if sql_ahead_hex is None:
            sql_ahead_hex = sorted(kb.hex()
                                   for kb in self.root._sql_ahead)
        self.app.database.execute(
            "INSERT INTO persistentstate(statename, state) "
            "VALUES('sqlahead', ?) ON CONFLICT(statename) "
            "DO UPDATE SET state=excluded.state",
            (json.dumps(sql_ahead_hex),))

    def _collect_changes(self, ltx
                         ) -> List[Tuple[bytes, Optional[object], bool]]:
        """(key-bytes, entry-or-None, existed-before) list for the bucket
        batch.  existed-before distinguishes true creations (INITENTRY,
        whose deletion may annihilate) from updates of entries living in
        deeper bucket levels (LIVEENTRY, whose deletion needs a persistent
        tombstone) — the root still holds pre-close state here."""
        from .ledger_txn import VIRTUAL_PREFIX

        return [
            (kb, entry, self.root.get(kb) is not None)
            for kb, entry in sorted(ltx._delta.items())
            # sponsorship bookkeeping entries never reach the bucket list
            if not kb.startswith(VIRTUAL_PREFIX)
        ]

    def _apply_upgrade(self, header, upgrade):
        UT = T.LedgerUpgradeType
        if upgrade.type == UT.LEDGER_UPGRADE_VERSION:
            return header._replace(ledgerVersion=upgrade.value)
        if upgrade.type == UT.LEDGER_UPGRADE_BASE_FEE:
            return header._replace(baseFee=upgrade.value)
        if upgrade.type == UT.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return header._replace(maxTxSetSize=upgrade.value)
        if upgrade.type == UT.LEDGER_UPGRADE_BASE_RESERVE:
            return header._replace(baseReserve=upgrade.value)
        if upgrade.type == UT.LEDGER_UPGRADE_FLAGS:
            ext = T.LedgerHeader.fields[14][1].make(
                1, T.LedgerHeaderExtensionV1.make(
                    flags=upgrade.value,
                    ext=T.LedgerHeaderExtensionV1.fields[1][1].make(0)))
            return header._replace(ext=ext)
        return header

    SKIP_1, SKIP_2, SKIP_3, SKIP_4 = 50, 5000, 50000, 500000

    def _update_skip_list(self, header):
        """Cascaded skip-list rotation keyed on the NEW header's seq
        (ref BucketManagerImpl::calculateSkipValues)."""
        seq = header.ledgerSeq
        sl = list(header.skipList)
        if seq % self.SKIP_1 == 0:
            v = seq - self.SKIP_1
            if v > 0 and v % self.SKIP_2 == 0:
                v = seq - self.SKIP_2 - self.SKIP_1
                if v > 0 and v % self.SKIP_3 == 0:
                    v = seq - self.SKIP_3 - self.SKIP_2 - self.SKIP_1
                    if v > 0 and v % self.SKIP_4 == 0:
                        sl[3] = sl[2]
                    sl[2] = sl[1]
                sl[1] = sl[0]
            sl[0] = header.bucketListHash
        return header._replace(skipList=sl)

    def _charge_fees(self, ltx, apply_order, base_fee) -> List[object]:
        """Phase 1 (ref processFeesSeqNums): charge every tx's fee
        against its source account, in apply order.

        One batched GIL-released kernel call covers the whole set when
        NATIVE_FEE (and the kernel itself) is on and every source
        account has a kernel-supported shape — the kernel returns the
        per-tx ``feeProcessing`` LedgerEntryChanges pre-encoded, bit-
        identical to the reference loop's.  Any tx the kernel can't
        charge declines the WHOLE batch (fees are strictly sequential:
        a repeat source must see the prior tx's post-image) and the
        per-tx reference loop below takes over.  NATIVE_FEE=0 is the
        kill switch: skip the kernel silently, no decline counters —
        off is not a coverage gap."""
        from ..utils import tracing

        metrics = self.metrics
        cfg = self.app.config
        col = tracing.op_collector()
        if (apply_order and getattr(cfg, "NATIVE_FEE", True)
                and getattr(cfg, "NATIVE_APPLY", True)):
            from ..apply import native_apply as NA

            with tracing.stopwatch() as sw:
                try:
                    fee_changes = NA.run_fee_phase_native(
                        ltx, apply_order, base_fee)
                except NA.KernelDecline as d:
                    fee_changes = None
                    code = getattr(d, "code", None) or "unknown"
            if fee_changes is not None:
                metrics.counter("apply.native.fee.hit").inc()
                if col is not None:
                    # the batch charged every tx at once: apportion the
                    # crossing across the set (count keeps it per-tx)
                    col.add_many("fee.charge", sw.seconds,
                                 len(apply_order))
                return fee_changes
            # whole-batch decline -> reference loop; the taxonomy
            # counter names the exact coverage gap (bounded family:
            # past the cap new codes collapse into ...decline.other)
            metrics.counter("apply.native.fee.decline").inc()
            metrics.counter(metrics.bounded_name(
                "apply.native.fee.decline", code, cap=24)).inc()
        fee_changes = []
        for frame in apply_order:
            with tracing.stopwatch() as sw:
                fee_changes.append(
                    frame.process_fee_seq_num(ltx, base_fee))
            if col is not None:
                col.add("fee.charge", sw.seconds)
        return fee_changes

    def _store_tx_history(self, seq: int, frames, metas,
                          encoded_rows=None) -> None:
        """``encoded_rows`` — (envelope, result-pair, meta) bytes the
        parallel executor pre-encoded on worker threads (overlapping the
        GIL-free native serialization with other clusters' apply); when
        absent, encode here: one batched native crossing that releases
        the GIL for the copy-out (NATIVE_TAIL_ENCODE), else the per-row
        reference loop — bytes identical either way."""
        cur = self.app.database.cursor()
        if encoded_rows is None:
            encoded_rows = self._encode_commit_rows(frames, metas)
        rows = [(frame.full_hash(), seq, i, env_b, pair_b, meta_b)
                for i, (frame, (env_b, pair_b, meta_b))
                in enumerate(zip(frames, encoded_rows))]
        cur.executemany(
            "INSERT INTO txhistory(txid, ledgerseq, txindex, txbody, "
            "txresult, txmeta) VALUES(?,?,?,?,?,?)", rows)

    def _encode_commit_rows(self, frames, metas):
        """The commit tail's remaining Python encode loop, batched:
        every (envelope, result-pair, meta) triple of the close packs
        through ONE native xdrpack call whose copy-out phase runs with
        the GIL released (``pack_many``) — on the pipelined tail worker
        that overlap is concurrent with ledger N+1's close.  Falls back
        to the per-row reference encode when NATIVE_TAIL_ENCODE=0 or
        the native packer is unavailable."""
        if getattr(self.app.config, "NATIVE_TAIL_ENCODE", True):
            from ..xdr import runtime

            pairs = []
            for frame, meta in zip(frames, metas):
                pairs.append((T.TransactionEnvelope, frame.envelope))
                pairs.append((T.TransactionResultPair, meta.result))
                pairs.append((T.TransactionMeta, meta.txApplyProcessing))
            flat = runtime.encode_many(pairs)
            if flat is not None:
                self.metrics.counter("apply.native.tail_encode.hit")\
                    .inc()
                return [tuple(flat[i:i + 3])
                        for i in range(0, len(flat), 3)]
        return [(T.TransactionEnvelope.encode(frame.envelope),
                 T.TransactionResultPair.encode(meta.result),
                 T.TransactionMeta.encode(meta.txApplyProcessing))
                for frame, meta in zip(frames, metas)]
