"""Admin HTTP API: the operator/Horizon-facing command endpoints
(ref src/main/CommandHandler.cpp:89-129 route table; lib/http's tiny
embedded server).

Single-threaded like the reference: a non-blocking listener on the app's
TCPIOService, parsed with a minimal GET handler.  Routes: info, metrics,
peers, quorum (?intersection=true), scp, tx?blob=<base64-xdr>,
manualclose, ll?level=..., bans, trace[/summary], tx/latency, vitals.
"""
from __future__ import annotations

import base64
import json
import socket
import urllib.parse
from typing import Callable, Dict, Optional


def _jsonable(x):
    """Recursively hex raw bytes (node ids, consensus values) so
    protocol-state bodies survive json.dumps — SCP internals hold
    values as bytes, not display strings."""
    if isinstance(x, bytes):
        return x.hex()
    if isinstance(x, dict):
        return {(k.hex() if isinstance(k, bytes) else k): _jsonable(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple, set)):
        return [_jsonable(v) for v in x]
    return x


class RawBody:
    """A non-JSON response body (Prometheus text exposition, trace JSON
    downloads): handlers return one in place of a dict and _respond
    sends it verbatim with its content type."""

    def __init__(self, data: bytes, content_type: str):
        self.data = data
        self.content_type = content_type


class CommandHandler:
    """Route registry + implementations (ref CommandHandler::CommandHandler
    registering handlers :89-129)."""

    def __init__(self, app):
        self.app = app
        self.routes: Dict[str, Callable] = {
            "info": self.info,
            "metrics": self.metrics,
            "peers": self.peers,
            "quorum": self.quorum,
            "quorum-health": self.quorum_health,
            "scp": self.scp,
            "tx": self.tx,
            "manualclose": self.manualclose,
            "ll": self.log_level,
            "surveytopology": self.survey_topology,
            "getsurveyresult": self.get_survey_result,
            "bans": self.bans,
            "unban": self.unban,
            "generateload": self.generateload,
            "trace": self.trace,
            "trace/summary": self.trace_summary,
            "tx/latency": self.tx_latency,
            "vitals": self.vitals,
            "catchup-status": self.catchup_status,
            "flood": self.flood,
            "network-observatory": self.network_observatory,
        }

    def handle(self, path: str, params: Dict[str, str]) -> tuple:
        """-> (status, json-serializable body)."""
        fn = self.routes.get(path.strip("/"))
        if fn is None:
            return 404, {"error": f"unknown command {path!r}"}
        try:
            return fn(params)
        except Exception as e:  # operator endpoint: report, don't crash
            return 500, {"error": f"{type(e).__name__}: {e}"}

    # -- endpoints ----------------------------------------------------------

    def info(self, params):
        return 200, {"info": self.app.get_json_info()}

    def catchup_status(self, params):
        return 200, self.app.catchup_manager.status()

    def metrics(self, params):
        # derived metrics registered IN the registry so the Prometheus
        # exposition carries them too (they were JSON-side-table-only
        # before): the root prefetch hit rate, the PR-9 footprint-
        # prefetch hit rate, and the batched-kernel counter, which is
        # pinned present from boot instead of appearing only after the
        # first batched crossing
        m = self.app.metrics
        root = self.app.ledger_manager.root
        pstats = self.app.ledger_manager.pipeline.stats
        m.gauge("ledger.prefetch.hit-rate").set(root.prefetch_hit_rate())
        m.gauge("ledger.close.prefetch.hit-rate").set(
            pstats["prefetch_adopted"] / pstats["prefetch_keys"]
            if pstats["prefetch_keys"] else 0.0)
        m.counter("apply.native.batched_clusters")
        # aggregate hit/decline counters pinned present from boot; the
        # per-op-type breakout (apply.native.hit.<op> and
        # apply.native.decline.<op>.<reason>) registers on first event
        m.counter("apply.native.hit")
        m.counter("apply.native.decline")
        # fee-phase kernel accounting (r16): pinned from boot so the
        # scrape never misses them; the decline-reason breakout
        # (apply.native.fee.decline.<code>) registers on first decline
        m.counter("apply.native.fee.hit")
        m.counter("apply.native.fee.decline")
        # catchup progress counters pinned from boot (a node that never
        # fell behind should still scrape zeros, not absences)
        m.counter("catchup.chain.verified")
        m.counter("catchup.bucket.downloaded-bytes")
        m.counter("catchup.bucket.applied-bytes")
        m.gauge("catchup.buffered-ledgers")
        m.counter("apply.native.tail_encode.hit")
        # bounded per-peer overlay vitals mirrored into the registry
        # (Prometheus rides the registry; the JSON body also carries
        # the full structured form below)
        om = self.app.overlay_manager
        if om is not None:
            om.export_peer_gauges()
        # ?format=prometheus: text exposition of the registry (plus the
        # flight recorder's span-derived timers, which live in the
        # registry as span.* Timers).  The default JSON body below is
        # untouched — existing consumers see identical bytes.
        if params.get("format") == "prometheus":
            from ..utils.metrics import render_prometheus

            return 200, RawBody(
                render_prometheus(self.app.metrics).encode(),
                "text/plain; version=0.0.4; charset=utf-8")
        snap = self.app.metrics.snapshot()
        snap["ledger.prefetch.hit-rate"] = round(
            root.prefetch_hit_rate(), 4)
        # per-peer overlay vitals (bounded: first N peers + an "other"
        # roll-up; overlay/manager.py peer_vitals)
        if om is not None:
            snap["overlay.peer.vitals"] = om.peer_vitals()
        # the close pipeline's session counters (tails, barrier wait,
        # prefetch staging) at a glance, like bucket.merge.pipeline
        snap["ledger.close.pipeline"] = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in pstats.items()}
        # the async merge pipeline's health at a glance: per-phase ms of
        # the last close + cumulative staging counters (sync_fallback
        # _merges must read 0 in steady state)
        snap["ledger.close.phases"] = \
            self.app.ledger_manager.last_close_phases
        bl = self.app.bucket_manager.bucket_list
        snap["bucket.merge.pipeline"] = {
            k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in bl.stats.items()}
        # BucketListDB read path at a glance: which tier answered point
        # reads, probes per read (the bloom filters' whole point), FP
        # rate, and the indexes' resident cost
        reads = bl.stats["point_reads"]
        probes = bl.stats["bucket_probes"]
        checks = bl.stats["bloom_checks"]
        snap["bucket.read.path"] = {
            "enabled": root.bucket_reads_enabled,
            "served_by": {"bucket": root.reads_from_buckets,
                          "overlay": root.reads_from_overlay,
                          "sql": root.reads_from_sql},
            "point_reads": reads,
            "probes_per_read": round(probes / reads, 4) if reads else 0.0,
            "bloom_false_positive_rate": round(
                bl.stats["bloom_false_positives"] / checks, 6)
            if checks else 0.0,
            "index_memory_bytes": bl.index_memory_bytes(),
            "index_build_s": round(bl.stats["index_build_s"], 4),
        }
        return 200, {"metrics": snap}

    def peers(self, params):
        om = self.app.overlay_manager
        if om is None:
            return 200, {"authenticated_peers": []}
        return 200, {"authenticated_peers": [
            {"id": pid.hex(), **p.get_stats()}
            for pid, p in om.authenticated.items()]}

    def quorum(self, params):
        if params.get("intersection") == "true":
            res = self.app.herder.check_quorum_intersection()
            body = {"intersection": res.ok,  # null = scan budget hit
                    "scanned_subsets": res.scanned,
                    "scc_size": res.scc_size,
                    "tier": res.tier}
            if res.aborted:
                body["aborted"] = True
            if res.split:
                body["split"] = [[n.hex() for n in side]
                                 for side in res.split]
            return 200, body
        qset = self.app.herder.scp.local_node.qset
        qt = self.app.herder.quorum_tracker
        return 200, {"qset": {
            "threshold": qset.threshold,
            "validators": [v.value.hex() for v in qset.validators],
            "inner_sets": len(qset.innerSets)},
            "transitive": {
                "node_count": len(qt.quorum),
                "missing_qsets": [n.hex()[:8]
                                  for n in qt.nodes_missing_qsets()]}}

    def quorum_health(self, params):
        """quorum-health[?intersection=true][&evaluate=true] — the
        quorum-health monitor's report (herder/quorum_health.py):
        heard/available/criticality of the local qset per close, the
        last budget-capped intersection verdict, transitive-quorum
        bookkeeping.  ?intersection=true runs one capped scan now;
        ?evaluate=true forces a fresh evaluation of the current LCL."""
        qh = self.app.herder.quorum_health
        if params.get("evaluate") == "true":
            qh.evaluate(self.app.ledger_manager.last_closed_seq())
        if params.get("intersection") == "true":
            qh.check_intersection()
        return 200, {"quorum_health": qh.report()}

    def scp(self, params):
        """scp[?slot=N][&limit=K] — per-slot consensus state PLUS the
        forensic timeline (scp/timeline.py).  Without ?slot: the last
        two slots' protocol state and a timeline summary.  With
        ?slot=N: that slot's full state and every recorded timeline
        event (nomination rounds, ballot transitions, timers, inbound
        envelopes with verdicts) — render with
        tools/trace_view.py --slots."""
        scp = self.app.herder.scp
        tl = scp.timeline
        if "slot" in params:
            try:
                idx = int(params["slot"])
            except ValueError:
                return 400, {"error": "bad slot param"}
            slot = scp.get_slot(idx, create=False)
            return 200, {
                "slot": idx,
                "state": _jsonable(slot.get_entire_state())
                if slot is not None else None,
                "timeline": tl.export(idx)}
        out = {}
        try:
            limit = int(params.get("limit", "2"))
        except ValueError:
            return 400, {"error": "bad limit param"}
        if limit <= 0:
            # [-0:] would be the WHOLE list, the opposite of the bound
            return 400, {"error": "bad limit param"}
        for idx in sorted(scp.slots)[-limit:]:
            out[str(idx)] = _jsonable(scp.slots[idx].get_entire_state())
        return 200, {"slots": out,
                     "timeline": {"enabled": tl.enabled,
                                  "slots": tl.slots(),
                                  "dropped_slots": tl.dropped_slots}}

    def tx(self, params):
        """Submit a transaction: tx?blob=<base64 TransactionEnvelope XDR>
        (ref CommandHandler::tx :117)."""
        from ..herder.tx_queue import TransactionQueue
        from ..xdr import types as T

        blob = params.get("blob")
        if not blob:
            return 400, {"error": "missing blob"}
        try:
            env = T.TransactionEnvelope.decode(
                base64.b64decode(blob.encode()))
        except Exception:
            return 400, {"status": "ERROR", "error": "malformed envelope"}
        res = self.app.herder.recv_transaction(env)
        names = {TransactionQueue.ADD_STATUS_PENDING: "PENDING",
                 TransactionQueue.ADD_STATUS_DUPLICATE: "DUPLICATE",
                 TransactionQueue.ADD_STATUS_BANNED: "TRY_AGAIN_LATER",
                 TransactionQueue.ADD_STATUS_TRY_AGAIN_LATER:
                 "TRY_AGAIN_LATER",
                 TransactionQueue.ADD_STATUS_ERROR: "ERROR"}
        return 200, {"status": names.get(res, "ERROR")}

    def manualclose(self, params):
        if not self.app.config.MANUAL_CLOSE:
            return 400, {"error": "manual close not enabled"}
        seq = self.app.herder.manual_close()
        return 200, {"ledger": seq}

    def generateload(self, params):
        """generateload?mode=create|pay|pretend|mixed|credit|pathpay|pool
        &accounts=N&txs=N [&dexpct=N&opcount=N&trustpct=N&hops=N] —
        drives the LoadGenerator through the real tx queue (ref
        CommandHandler.cpp:125; the reference registers this only in
        test builds, here it requires the standalone/testing
        accelerators to be on).  ``credit`` and ``pathpay`` seed
        themselves over real transactions in stages — call the mode
        repeatedly with a manualclose between calls until the note
        stops asking for another stage."""
        cfg = self.app.config
        if not (cfg.RUN_STANDALONE
                or cfg.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING):
            return 400, {"error": "generateload requires standalone/"
                                  "testing mode"}
        from ..simulation.load_generator import LoadGenerator

        lg = getattr(self.app, "_load_generator", None)
        if lg is None:
            lg = self.app._load_generator = LoadGenerator(self.app)
        mode = params.get("mode", "pay")
        n_accounts = int(params.get("accounts", "100"))
        n_txs = int(params.get("txs", "100"))

        # rate mode: generateload?mode=pay&rate=N&duration=S starts a
        # timer-driven tx/s run (ref LoadGenerator.h:28-36); mode=status
        # polls it, mode=stop cancels it
        if mode == "status":
            return 200, {"rate_run": lg.rate_status()}
        if mode == "stop":
            lg.stop_rate_run()
            return 200, {"rate_run": lg.rate_status()}
        if "rate" in params:
            if mode not in ("pay", "pretend", "mixed"):
                return 400, {"error": f"rate mode needs pay/pretend/"
                                      f"mixed, got {mode!r}"}
            if not lg.accounts:
                lg.restore_accounts()
            if not lg.accounts:
                return 400, {"error": "run mode=create (and close) first"}
            status = lg.start_rate_run(
                mode, rate=float(params["rate"]),
                duration=float(params.get("duration", "10")),
                dex_percent=int(params.get("dexpct", "50")),
                op_count=int(params.get("opcount", "1")))
            return 200, {"rate_run": status}

        def submit(envs, note=None, on_all_pending=None):
            statuses: dict = {}
            for env in envs:
                r = self.app.herder.recv_transaction(env)
                statuses[r] = statuses.get(r, 0) + 1
            if statuses == {0: len(envs)} and on_all_pending:
                on_all_pending()
            body = {"mode": mode, "submitted": len(envs),
                    "status_counts": statuses}
            if note:
                body["note"] = note
            return 200, body

        # all seeding is TRANSACTION-based so the bucket-list commitment
        # stays consistent with the SQL tier (self-check-clean); each
        # seeding stage needs a ledger close before the next call
        if mode == "create":
            return submit(lg.create_account_envelopes(n_accounts),
                          "accounts exist after the next close")
        if not lg.accounts:
            # restarted node: the pool is a deterministic function of the
            # account ordinal (ref LoadGenerator::findAccount), so probe
            # the ledger for previously-created accounts before giving up
            lg.restore_accounts()
        if not lg.accounts:
            return 400, {"error": "run mode=create (and close) first"}
        if mode == "pay":
            envs = lg.generate_payments(n_txs)
        elif mode == "pretend":
            envs = lg.generate_pretend(
                n_txs, op_count=int(params.get("opcount", "1")))
        elif mode == "mixed":
            # stages advance ONLY when every stage tx was admitted, so a
            # mis-sequenced call (e.g. before the seeding close) can be
            # retried instead of wedging the DEX setup
            stage = getattr(lg, "_dex_stage", 0)
            if stage == 0:
                return submit(lg.create_dex_issuer_envelope(),
                              "dex issuer submitted; close a ledger "
                              "and call mode=mixed again",
                              lambda: setattr(lg, "_dex_stage", 1))
            if stage == 1:
                return submit(lg.setup_dex_envelopes(),
                              "dex trustlines submitted; close a "
                              "ledger and call mode=mixed again",
                              lambda: setattr(lg, "_dex_stage", 2))
            if stage == 2:
                return submit(lg.fund_dex_envelopes(),
                              "dex funding submitted; close a ledger "
                              "and call mode=mixed again",
                              lambda: setattr(lg, "_dex_stage", 3))
            envs = lg.generate_mixed(
                n_txs, dex_percent=int(params.get("dexpct", "50")))
        elif mode == "credit":
            # credit-heavy mix (ISSUE 13): LOAD payments over
            # trustlines + changeTrust salt on CRD2.  Staged like
            # mode=mixed: issuers -> trustlines -> funding, one close
            # between calls
            stage = getattr(lg, "_credit_stage", 0)
            if stage == 0:
                return submit(lg.create_credit_issuer_envelopes(),
                              "credit issuers submitted; close a "
                              "ledger and call mode=credit again",
                              lambda: setattr(lg, "_credit_stage", 1))
            if stage == 1:
                return submit(lg.setup_dex_envelopes(),
                              "trustlines submitted; close a ledger "
                              "and call mode=credit again",
                              lambda: setattr(lg, "_credit_stage", 2))
            if stage == 2:
                return submit(lg.fund_dex_envelopes(),
                              "funding submitted; close a ledger and "
                              "call mode=credit again",
                              lambda: setattr(lg, "_credit_stage", 3))
            envs = lg.generate_credit_mix(
                n_txs, trust_pct=int(params.get("trustpct", "10")))
        elif mode == "pathpay":
            # multi-hop path payments over seeded books (ISSUE 13):
            # four tx-based seeding stages (issuers+makers, trustlines,
            # funding, maker offers), then the workload
            hops = int(params.get("hops", "2"))
            stage = getattr(lg, "_path_stage", 0)
            if stage < 4:
                return submit(
                    lg.path_stage_envelopes(stage, hops=hops),
                    f"path seeding stage {stage} submitted; close a "
                    f"ledger and call mode=pathpay again",
                    lambda: setattr(lg, "_path_stage", stage + 1))
            envs = lg.generate_path_payments(n_txs)
        elif mode == "pool":
            # path payments routed through LIVE constant-product pools
            # (ISSUE 16): pools bulk-seed on first call (perf-rig
            # style, no staged closes needed), then the workload is the
            # same alternating strict-send/receive mix as mode=pathpay
            # with the pools as the only crossing venue
            if getattr(lg, "pool_ids", None) is None:
                lg.setup_pool(hops=int(params.get("hops", "2")))
            envs = lg.generate_pool_payments(n_txs)
        else:
            return 400, {"error": f"unknown mode {mode!r}"}
        return submit(envs)

    def survey_topology(self, params):
        """surveytopology?node=<hex-or-strkey> (ref CommandHandler
        surveytopology)."""
        om = self.app.overlay_manager
        if om is None:
            return 400, {"error": "no overlay"}
        node = params.get("node", "")
        try:
            if node.startswith("G"):
                from ..crypto.strkey import decode_ed25519_public_key

                nid = decode_ed25519_public_key(node)
            else:
                nid = bytes.fromhex(node)
        except Exception:
            return 400, {"error": "bad node id"}
        ok = om.survey_manager.start_survey(nid)
        return 200, {"submitted": ok}

    def get_survey_result(self, params):
        om = self.app.overlay_manager
        if om is None:
            return 400, {"error": "no overlay"}
        return 200, {"results": {
            k.hex()[:8]: v
            for k, v in om.survey_manager.results.items()}}

    def bans(self, params):
        om = self.app.overlay_manager
        if om is None:
            return 200, {"bans": []}
        return 200, {"bans": [b.hex() for b in sorted(om.banned_peers)]}

    def unban(self, params):
        om = self.app.overlay_manager
        node = params.get("node", "")
        if om is None or not node:
            return 400, {"error": "no overlay / missing node"}
        try:
            om.unban_peer(bytes.fromhex(node))
        except ValueError:
            return 400, {"error": "bad node id"}
        return 200, {"unbanned": node}

    def log_level(self, params):
        """ll?level=debug[&partition=SCP] — runtime per-partition log
        control (ref CommandHandler.cpp:113).  Unknown partitions/levels
        are a 400, not a silent fallback to the Default partition."""
        from ..utils import logging as L

        level = params.get("level")
        partition = params.get("partition")
        if partition is not None and partition not in L.PARTITIONS:
            return 400, {"error": f"unknown log partition {partition!r}",
                         "partitions": list(L.PARTITIONS)}
        if level:
            try:
                L.set_log_level(level, partition)
            except ValueError as e:
                return 400, {"error": str(e)}
        return 200, {"levels": L.get_log_levels()}

    # -- flight recorder (utils/tracing) ------------------------------------

    def trace(self, params):
        """trace?ledger=N — Chrome trace_event JSON of one retained
        close (the latest when ledger is omitted); load it in
        chrome://tracing / Perfetto or tools/trace_view.py."""
        from ..utils.tracing import chrome_trace

        tracer = self.app.tracer
        if not tracer.enabled:
            return 400, {"error": "tracing disabled (TRACING_ENABLED)"}
        seq = None
        if "ledger" in params:
            try:
                seq = int(params["ledger"])
            except ValueError:
                return 400, {"error": "bad ledger param"}
        rec = tracer.get_close(seq)
        if rec is None:
            retained = [r.seq for r in tracer.closes()]
            return 404, {"error": f"no trace for ledger {seq}",
                         "retained_closes": retained}
        return 200, RawBody(
            json.dumps(chrome_trace(rec), indent=1).encode(),
            "application/json")

    def tx_latency(self, params):
        """tx/latency?last=N — the transaction-lifecycle tracker's
        report: per-stage + end-to-end latency summaries (ms) over the
        sampled txs, tracker stats, and the last N completed
        lifecycles (utils/txtrace.py)."""
        last = int(params.get("last", "16"))
        return 200, {"tx_latency": self.app.txtracer.report(last=last)}

    def vitals(self, params):
        """vitals — the node-vitals sampler's report: latest gauge
        sample, per-gauge slopes over the ring, SLO watchdog state and
        the GC pause histogram (utils/vitals.py).  ?sample=true takes
        one sample on demand (works even when the periodic timer is
        disabled — suites, sims)."""
        if params.get("sample") == "true":
            self.app.vitals.sample_once()
        return 200, {"vitals": self.app.vitals.report()}

    def flood(self, params):
        """flood?hash=<hex> — this node's hop record for one flood item
        (origin/relayed, first-seen link, duplicate arrivals, forward
        fan-out).  Without ?hash: tracker stats + registry rollups +
        per-link dedup ratios + the most recent hop records
        (?last=N, default 16)."""
        ft = self.app.floodtracer
        if "hash" in params:
            try:
                h = bytes.fromhex(params["hash"])
            except ValueError:
                return 400, {"error": "bad hash param (want hex)"}
            rec = ft.lookup(h)
            if rec is None:
                return 404, {"error": f"no hop record for {params['hash']}"
                             " (untracked, sampled out, or evicted)",
                             "stats": ft.stats()}
            return 200, {"flood": rec}
        return 200, {"flood": ft.report(last=int(params.get("last", "16")))}

    def network_observatory(self, params):
        """network-observatory — fleet-merged propagation/close-cadence
        view.  Only live on sim rigs, where the Simulation attached a
        NetworkObservatory to every node; real nodes aggregate via
        tools/fleet_scrape.py instead."""
        obs = getattr(self.app, "_observatory", None)
        if obs is None:
            return 400, {"error": "no observatory attached "
                         "(sim rigs only; real fleets: tools/fleet_scrape.py)"}
        return 200, {"observatory": obs.snapshot()}

    def trace_summary(self, params):
        """trace/summary?k=N — top-k self-time spans aggregated over the
        whole retained close ring."""
        from ..utils.tracing import summarize_ring

        tracer = self.app.tracer
        recs = tracer.closes()
        k = int(params.get("k", "10"))
        return 200, {
            "closes_retained": [r.seq for r in recs],
            "slow_close_traces": [
                {"ledger": seq, "path": path}
                for seq, path in tracer.slow_close_traces],
            "top_spans_by_self_time": summarize_ring(recs, k=k),
        }


class AdminHttpServer:
    """Non-blocking single-request-per-connection HTTP/1.0 server on the
    app's TCPIOService."""

    def __init__(self, app, port: int = 0):
        self.app = app
        self.handler = CommandHandler(app)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(16)
        self.sock.setblocking(False)
        app.tcp_io.register(self.sock, self._on_acceptable)

    def _on_acceptable(self) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except (BlockingIOError, InterruptedError, OSError):
                return
            conn.setblocking(False)
            buf = bytearray()

            def on_readable(conn=conn, buf=buf):
                try:
                    chunk = conn.recv(65536)
                except (BlockingIOError, InterruptedError):
                    return
                except OSError:
                    self.app.tcp_io.unregister(conn)
                    conn.close()
                    return
                if chunk:
                    buf.extend(chunk)
                if b"\r\n\r\n" in buf or not chunk:
                    self._respond(conn, bytes(buf))

            self.app.tcp_io.register(conn, on_readable)

    def _respond(self, conn, request: bytes) -> None:
        self.app.tcp_io.unregister(conn)
        try:
            line = request.split(b"\r\n", 1)[0].decode("latin-1")
            _method, target, *_ = line.split(" ")
            parsed = urllib.parse.urlparse(target)
            params = {k: v[0] for k, v in
                      urllib.parse.parse_qs(parsed.query).items()}
            status, body = self.handler.handle(parsed.path, params)
        except Exception as e:
            status, body = 400, {"error": str(e)}
        if isinstance(body, RawBody):
            payload = body.data
            content_type = body.content_type
        else:
            payload = json.dumps(body, indent=1).encode()
            content_type = "application/json"
        reasons = {200: "OK", 400: "Bad Request", 404: "Not Found",
                   500: "Internal Server Error"}
        head = (f"HTTP/1.0 {status} {reasons.get(status, 'OK')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(payload)}\r\n\r\n").encode()
        try:
            conn.sendall(head + payload)
        except OSError:
            pass
        conn.close()

    def close(self) -> None:
        self.app.tcp_io.unregister(self.sock)
        self.sock.close()
