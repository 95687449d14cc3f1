"""Config: the node's knob surface (ref src/main/Config.h — a 607-line
header of ~200 TOML-loaded fields; this port keeps the same names for the
load-bearing ones and loads from TOML via tomllib or from kwargs).

Like the reference's Config::load, ``from_toml`` rejects unknown keys and
``validate()`` runs the sanity pass (quorum safety incl. FAILURE_SAFETY /
UNSAFE_QUORUM, port/time ranges, regex compilation) before a node boots.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..crypto import SecretKey, sha256


class ConfigError(Exception):
    """Invalid node configuration (ref std::invalid_argument throws from
    Config::load/validateConfig)."""


class Config:
    CURRENT_LEDGER_PROTOCOL_VERSION = 19

    def __init__(self, **kw):
        # identity / network
        self.NETWORK_PASSPHRASE: str = kw.get(
            "NETWORK_PASSPHRASE", "Test SDF Network ; September 2015")
        self.NODE_SEED: Optional[bytes] = kw.get("NODE_SEED")
        self.NODE_IS_VALIDATOR: bool = kw.get("NODE_IS_VALIDATOR", True)
        self.QUORUM_SET: Optional[dict] = kw.get("QUORUM_SET")

        # mode
        self.RUN_STANDALONE: bool = kw.get("RUN_STANDALONE", False)
        self.MANUAL_CLOSE: bool = kw.get("MANUAL_CLOSE", False)
        self.FORCE_SCP: bool = kw.get("FORCE_SCP", False)

        # protocol / testing knobs
        self.LEDGER_PROTOCOL_VERSION: int = kw.get(
            "LEDGER_PROTOCOL_VERSION",
            self.CURRENT_LEDGER_PROTOCOL_VERSION)
        self.TESTING_UPGRADE_DESIRED_FEE: int = kw.get(
            "TESTING_UPGRADE_DESIRED_FEE", 100)
        self.TESTING_UPGRADE_RESERVE: int = kw.get(
            "TESTING_UPGRADE_RESERVE", 5000000)
        self.TESTING_UPGRADE_MAX_TX_SET_SIZE: int = kw.get(
            "TESTING_UPGRADE_MAX_TX_SET_SIZE", 100)
        self.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING: bool = kw.get(
            "ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING", False)

        # storage
        self.DATABASE: str = kw.get("DATABASE", ":memory:")
        self.BUCKET_DIR_PATH: str = kw.get("BUCKET_DIR_PATH", "buckets")
        # set to a real directory to persist bucket files (restart support)
        self.BUCKET_DIR_PATH_REAL: Optional[str] = kw.get(
            "BUCKET_DIR_PATH_REAL")
        # history archives to publish to / catch up from (ref HISTORY
        # config blocks, src/history/readme.md:8-30).  Two entry forms:
        #   [name, local-directory-path]            — direct file I/O
        #   {name=..., get=..., put=..., mkdir=...} — shell command
        #     templates run as subprocesses ({0}=local file, {1}=remote
        #     path), e.g. get = "curl -sf http://host/{1} -o {0}"
        self.HISTORY_ARCHIVES: List[object] = kw.get("HISTORY_ARCHIVES", [])
        # file path receiving length-framed LedgerCloseMeta XDR per close
        # (ref METADATA_OUTPUT_STREAM, Config.h)
        self.METADATA_OUTPUT_STREAM: Optional[str] = kw.get(
            "METADATA_OUTPUT_STREAM")

        # upgrades this node votes for when nominating (ref Upgrades::
        # UpgradeParameters; None = don't propose)
        self.UPGRADE_DESIRED_PROTOCOL_VERSION: Optional[int] = kw.get(
            "UPGRADE_DESIRED_PROTOCOL_VERSION")
        self.UPGRADE_DESIRED_BASE_FEE: Optional[int] = kw.get(
            "UPGRADE_DESIRED_BASE_FEE")
        self.UPGRADE_DESIRED_MAX_TX_SET_SIZE: Optional[int] = kw.get(
            "UPGRADE_DESIRED_MAX_TX_SET_SIZE")
        self.UPGRADE_DESIRED_BASE_RESERVE: Optional[int] = kw.get(
            "UPGRADE_DESIRED_BASE_RESERVE")

        # SCP federated-tally backend: "host" (exact python), "tensor"
        # (batched torch ops on the node's device, ops/quorum.py), or
        # "both" (tensor with the host oracle asserting equality —
        # differential testing).  "auto" resolves to "tensor" at
        # Application construction; a node with no GPU and no device
        # given then refuses to start (utils/device.default_device)
        self.SCP_TALLY_BACKEND: str = kw.get("SCP_TALLY_BACKEND", "auto")

        # quorum-intersection scan budget for synchronous callers (admin
        # HTTP, self-check): the branch-and-bound is NP-hard over network-
        # supplied qsets, so cap it; the scan reports "unknown" (aborted)
        # past the budget instead of hanging the handler.  ~1M calls/s in
        # the native tier => default caps a scan at roughly 30 s.
        self.QUORUM_INTERSECTION_MAX_CALLS: int = kw.get(
            "QUORUM_INTERSECTION_MAX_CALLS", 30_000_000)
        # wall-clock ceiling for one scan — the call cap alone is
        # calibrated to the native tier and would let the slower Python
        # tiers (deep qsets, no g++) run orders of magnitude longer
        self.QUORUM_INTERSECTION_TIMEOUT_SECONDS: float = kw.get(
            "QUORUM_INTERSECTION_TIMEOUT_SECONDS", 30.0)

        # quorum safety (ref Config.h FAILURE_SAFETY / UNSAFE_QUORUM:
        # -1 = auto-derive f from the top-level quorum set size)
        self.FAILURE_SAFETY: int = kw.get("FAILURE_SAFETY", -1)
        self.UNSAFE_QUORUM: bool = kw.get("UNSAFE_QUORUM", False)

        # consensus cadence (ref Herder.cpp:7-18)
        self.EXP_LEDGER_TIMESPAN_SECONDS: float = kw.get(
            "EXP_LEDGER_TIMESPAN_SECONDS",
            1.0 if kw.get("ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING")
            else 5.0)
        self.MAX_SCP_TIMEOUT_SECONDS: float = kw.get(
            "MAX_SCP_TIMEOUT_SECONDS", 240.0)
        self.CONSENSUS_STUCK_TIMEOUT_SECONDS: float = kw.get(
            "CONSENSUS_STUCK_TIMEOUT_SECONDS", 35.0)
        # closed-slot retention for SCP state (ref MAX_SLOTS_TO_REMEMBER)
        self.MAX_SLOTS_TO_REMEMBER: int = kw.get(
            "MAX_SLOTS_TO_REMEMBER", 12)
        # mempool capacity = multiplier x ledger maxTxSetSize ops (ref
        # TRANSACTION_QUEUE_SIZE_MULTIPLIER feeding TxQueueLimiter)
        self.TRANSACTION_QUEUE_SIZE_MULTIPLIER: int = kw.get(
            "TRANSACTION_QUEUE_SIZE_MULTIPLIER", 4)

        # catchup (ref CATCHUP_COMPLETE: replay every ledger instead of
        # assuming bucket state at the anchor checkpoint)
        self.CATCHUP_COMPLETE: bool = kw.get("CATCHUP_COMPLETE", False)
        # ledgers behind live before archive catchup triggers
        self.CATCHUP_TRIGGER_GAP: int = kw.get("CATCHUP_TRIGGER_GAP", 2)
        # base of the exponential retry backoff (clock-seconds) for
        # archive download works; 0 = immediate retries
        self.CATCHUP_RETRY_BACKOFF: float = kw.get(
            "CATCHUP_RETRY_BACKOFF", 0.1)
        # worker threads behind the WorkScheduler's pool (parallel
        # archive fetch/verify; threads spawn lazily, idle nodes pay
        # nothing); 0 = no pool, every work cranks inline
        self.WORK_POOL_WORKERS: int = kw.get("WORK_POOL_WORKERS", 4)

        # overlay
        self.PEER_PORT: int = kw.get("PEER_PORT", 11625)
        self.HTTP_PORT: int = kw.get("HTTP_PORT", 11626)
        self.TARGET_PEER_CONNECTIONS: int = kw.get(
            "TARGET_PEER_CONNECTIONS", 8)
        self.MAX_ADDITIONAL_PEER_CONNECTIONS: int = kw.get(
            "MAX_ADDITIONAL_PEER_CONNECTIONS", 64)
        self.KNOWN_PEERS: List[str] = kw.get("KNOWN_PEERS", [])
        # always-reconnect peers, tried before KNOWN_PEERS (ref
        # PREFERRED_PEERS)
        self.PREFERRED_PEERS: List[str] = kw.get("PREFERRED_PEERS", [])

        # cross-peer SCP signature-batch admission: flooded envelopes
        # received within one crank verify as a single padded batch
        # (SIG_BATCH_BUCKETS) instead of per-envelope inside SCP —
        # verdicts identical either way, the device just sees one
        # dispatch (ROADMAP 4 companion)
        self.OVERLAY_SIG_BATCH: bool = kw.get("OVERLAY_SIG_BATCH", True)

        # work/process subsystem (ref MAX_CONCURRENT_SUBPROCESSES)
        self.MAX_CONCURRENT_SUBPROCESSES: int = kw.get(
            "MAX_CONCURRENT_SUBPROCESSES", 16)

        # device tier: "cuda" verifies each close's signature batch on
        # the node's device (the hand-written kernel of
        # ops/ed25519_cuda.py), "cpu" on the host (verify_sig, the
        # libsodium-semantics reference backend).  "auto" resolves to
        # "cuda" at Application construction.
        self.CRYPTO_BACKEND: str = kw.get("CRYPTO_BACKEND", "auto")

        # run spill-merges on worker threads between spills (FutureBucket,
        # ref src/bucket/FutureBucket.cpp).  Results are bitwise identical
        # to synchronous merges — this only moves latency off the close
        # path — so the knob exists for debugging, not determinism.
        self.BACKGROUND_BUCKET_MERGES: bool = kw.get(
            "BACKGROUND_BUCKET_MERGES", True)
        # first bucket level stored as sparse-indexed files instead of in
        # memory (ref BucketListDB; levels 0-3 hold <= 4^4 ledgers of
        # deltas and stay hot)
        self.DISK_BUCKET_LEVEL: int = kw.get("DISK_BUCKET_LEVEL", 4)
        # serve point reads / apply-loop prefetch from the bucket tier's
        # bloom-filtered per-bucket indexes instead of SQL (ref
        # BucketListDB / EXPERIMENTAL_BUCKETLIST_DB — default on; SQL
        # keeps only the offer-book range scans).  Activation still
        # requires a fresh start or a hash-verified bucket restore
        # (Application.start) so a node with a missing/stale bucket store
        # never serves wrong reads.
        self.BUCKETLIST_DB: bool = kw.get("BUCKETLIST_DB", True)
        # run GC between closes instead of wherever allocation counters
        # trip (a mid-close gen2 cycle costs >1s at 1000-tx closes)
        self.DEFERRED_GC: bool = kw.get("DEFERRED_GC", True)
        # after each FULL post-close collection (checkpoint cadence),
        # gc.freeze() the survivors — adopted buckets/indexes — so the
        # next gen-2 pass traverses only the delta since the last
        # checkpoint instead of the whole heap (the SOAK_BENCH_r13
        # 427ms-p99 fix).  Kill switch for leak hunts: frozen objects
        # are invisible to the cyclic collector (refcounting still
        # frees them)
        self.GC_FREEZE_LONG_LIVED: bool = kw.get(
            "GC_FREEZE_LONG_LIVED", True)

        # parallel transaction apply (stellar_core_tpu/apply/): footprint
        # planner + conflict-cluster scheduler + bit-identical concurrent
        # executor.  PARALLEL_APPLY is the kill switch (env
        # PARALLEL_APPLY=0 also disables); WORKERS <= 1 disables too.
        # Env reads live HERE on purpose: main/ is outside detlint's
        # consensus det-wallclock scope, and the env only gates WHETHER
        # the parallel path runs — results are bit-identical either way.
        import os as _os

        self.PARALLEL_APPLY: bool = kw.get(
            "PARALLEL_APPLY",
            _os.environ.get("PARALLEL_APPLY", "1") != "0")
        self.PARALLEL_APPLY_WORKERS: int = kw.get(
            "PARALLEL_APPLY_WORKERS",
            int(_os.environ.get("PARALLEL_APPLY_WORKERS", "2") or 0))
        # native GIL-free apply kernel (native/apply_kernel.cpp) for
        # kernel-eligible clusters; NATIVE_APPLY=0 is the kill switch —
        # every cluster then runs the Python reference apply
        # (bit-identical either way, enforced by test_native_apply.py).
        # Note: INVARIANT_CHECKS run per-op on Python-applied clusters
        # only; kernel-applied clusters rely on the kernel's own
        # exact-shape parse + bounds guards (set NATIVE_APPLY=0 to run
        # every configured checker on every tx).
        self.NATIVE_APPLY: bool = kw.get(
            "NATIVE_APPLY",
            _os.environ.get("NATIVE_APPLY", "1") != "0")
        # engage the planner+kernel WITHOUT a worker pool (workers 0/1):
        # the kernel beats Python even applying clusters sequentially on
        # the close thread.  Off by default so workers=0 keeps meaning
        # "plain sequential apply" unless explicitly opted in.
        self.NATIVE_APPLY_INLINE: bool = kw.get(
            "NATIVE_APPLY_INLINE",
            _os.environ.get("NATIVE_APPLY_INLINE", "0") == "1")
        # batched fee/seqnum phase (apply_kernel.cpp charge_fees): one
        # GIL-released call replaces the per-tx process_fee_seq_num
        # loop.  NATIVE_FEE=0 is the kill switch; bytes are identical
        # either way (tests/test_native_fee.py).  Follows NATIVE_APPLY:
        # the fee batch never engages with the apply kernel killed.
        self.NATIVE_FEE: bool = kw.get(
            "NATIVE_FEE",
            _os.environ.get("NATIVE_FEE", "1") != "0")
        # in-kernel constant-product pool quoting on path-payment hops;
        # NATIVE_POOL_QUOTE=0 restores the decline-if-live-pool host
        # screen (pool hops then always run the Python reference).
        self.NATIVE_POOL_QUOTE: bool = kw.get(
            "NATIVE_POOL_QUOTE",
            _os.environ.get("NATIVE_POOL_QUOTE", "1") != "0")
        # native tail encode (xdr_pack.c pack_many): the commit tail's
        # tx-history row encodes collapse into one native crossing.
        # NATIVE_TAIL_ENCODE=0 falls back to per-value encode() — same
        # packer, same bytes.
        self.NATIVE_TAIL_ENCODE: bool = kw.get(
            "NATIVE_TAIL_ENCODE",
            _os.environ.get("NATIVE_TAIL_ENCODE", "1") != "0")
        # one JSON line of session apply stats appended at shutdown —
        # tools/verify_green.py's parallel smoke aggregates these to
        # report aborts observed across the suite
        self.PARALLEL_APPLY_STATS_FILE: Optional[str] = kw.get(
            "PARALLEL_APPLY_STATS_FILE",
            _os.environ.get("PARALLEL_APPLY_STATS_FILE"))

        # pipelined ledger close (ledger/close_pipeline.py): after the
        # header seals, the commit/meta/tx-history/gc tail runs on a
        # worker while the herder triggers the next ledger, with a
        # write-ahead read overlay and a strict depth-1 barrier (the
        # next close's seal waits for the previous tail's durable
        # commit).  PIPELINED_CLOSE=0 (env or config) is the kill
        # switch: the fully synchronous close path, bit-identical
        # results either way (tests/test_pipelined_close.py).
        self.PIPELINED_CLOSE: bool = kw.get(
            "PIPELINED_CLOSE",
            _os.environ.get("PIPELINED_CLOSE", "1") != "0")
        # drain the tail before close_ledger returns.  None resolves to
        # MANUAL_CLOSE: test/standalone rigs keep sequential read
        # semantics, real nodes overlap.  Benches and overlap tests set
        # False explicitly.
        self.PIPELINED_CLOSE_EAGER_DRAIN: Optional[bool] = kw.get(
            "PIPELINED_CLOSE_EAGER_DRAIN")
        # one JSON line of pipeline session stats at shutdown —
        # tools/verify_green.py's pipelined smoke aggregates these
        self.PIPELINED_CLOSE_STATS_FILE: Optional[str] = kw.get(
            "PIPELINED_CLOSE_STATS_FILE",
            _os.environ.get("PIPELINED_CLOSE_STATS_FILE"))

        # surge-pricing DEX lane: ops from DEX transactions (offers +
        # path payments) admitted per ledger, on top of the total
        # maxTxSetSize cap (ref SurgePricingUtils.h lane config /
        # MAX_DEX_TX_OPERATIONS).  None = no DEX lane limit.
        self.MAX_DEX_TX_OPERATIONS: Optional[int] = kw.get(
            "MAX_DEX_TX_OPERATIONS")

        # flight recorder (utils/tracing.py): hierarchical span tracing
        # over the close path.  Disabled tracing still measures the
        # per-phase close breakdown; it just records no spans.
        self.TRACING_ENABLED: bool = kw.get("TRACING_ENABLED", True)
        # how many whole closes the span ring retains (/trace?ledger=N)
        self.TRACE_RING_CLOSES: int = kw.get("TRACE_RING_CLOSES", 8)
        # slow-close watchdog: a close slower than this persists its full
        # span tree as Chrome trace_event JSON into TRACE_DIR and logs a
        # one-line summary (<= 0 disables the watchdog)
        self.SLOW_CLOSE_THRESHOLD_SECONDS: float = kw.get(
            "SLOW_CLOSE_THRESHOLD_SECONDS", 2.0)
        self.TRACE_DIR: str = kw.get("TRACE_DIR", "traces")
        # test hook: sleep this long inside every close (span
        # "ledger.close.test_delay") so the watchdog path is testable
        # without a genuinely pathological workload
        self.ARTIFICIALLY_SLEEP_IN_CLOSE_FOR_TESTING: float = kw.get(
            "ARTIFICIALLY_SLEEP_IN_CLOSE_FOR_TESTING", 0.0)

        # transaction-lifecycle telemetry (utils/txtrace.py): sampled
        # per-tx stage stamps (overlay recv -> admit -> txset ->
        # nominate -> externalize -> apply -> durable commit) rolled up
        # into txtrace.* histograms and the HTTP tx/latency endpoint.
        # Observational only — hashes/meta are bit-identical on or off
        # (tests/test_txtrace.py) and the disabled cost is one attribute
        # check per stamp site.
        self.TX_LIFECYCLE_TRACKING: bool = kw.get(
            "TX_LIFECYCLE_TRACKING", True)
        # completed-lifecycle records retained for tx/latency
        self.TX_LIFECYCLE_RING: int = kw.get("TX_LIFECYCLE_RING", 256)
        # in-flight tracked txs before deterministic decimation halves
        # the live map and doubles the sampling stride
        self.TX_LIFECYCLE_MAX_LIVE: int = kw.get(
            "TX_LIFECYCLE_MAX_LIVE", 512)

        # flood-propagation telemetry (utils/floodtrace.py): sampled
        # per-item hop records across the overlay flood (origin vs
        # relayed, sending peer, duplicate attribution, fan-out),
        # rolled into floodtrace.* metrics and the HTTP flood endpoint;
        # simulation/observatory.py merges them network-wide.
        # Observational only — hashes/meta are bit-identical on or off
        # and the disabled cost is one attribute check per flood site.
        self.FLOOD_TRACE_ENABLED: bool = kw.get(
            "FLOOD_TRACE_ENABLED", True)
        # retired hop records retained for flood / the observatory
        self.FLOOD_TRACE_RING: int = kw.get("FLOOD_TRACE_RING", 256)
        # in-flight tracked items before deterministic decimation
        # halves the live map and doubles the sampling stride
        self.FLOOD_TRACE_MAX_LIVE: int = kw.get(
            "FLOOD_TRACE_MAX_LIVE", 512)

        # continuous node-vitals sampler (utils/vitals.py): periodic
        # RSS/fd/thread/queue/bucket/GC gauges in a bounded ring with
        # per-gauge slope estimation, vitals.* Prometheus gauges, the
        # HTTP vitals endpoint, and the SLO watchdog.  Suites and sims
        # keep it off (one timer per node); real/TOML nodes default on.
        self.VITALS_ENABLED: bool = kw.get("VITALS_ENABLED", True)
        self.VITALS_PERIOD_SECONDS: float = kw.get(
            "VITALS_PERIOD_SECONDS", 1.0)
        self.VITALS_RING_SAMPLES: int = kw.get("VITALS_RING_SAMPLES", 900)
        # append one JSON line per sample (offline soak analysis)
        self.VITALS_JSONL: Optional[str] = kw.get("VITALS_JSONL")
        # SLO ceilings the watchdog enforces (structured WARN per breach
        # episode + slo.breach.* counters); each 0 disables that check
        self.SLO_MAX_MEMORY_SLOPE_MB_S: float = kw.get(
            "SLO_MAX_MEMORY_SLOPE_MB_S", 16.0)
        self.SLO_MAX_CLOSE_P99_SECONDS: float = kw.get(
            "SLO_MAX_CLOSE_P99_SECONDS", 5.0)
        self.SLO_MAX_QUEUE_AGE: int = kw.get("SLO_MAX_QUEUE_AGE", 3)
        # vitals sample taken while the local quorum slice is
        # unsatisfiable from recently-heard nodes = a breach episode
        # (fed by the quorum-health monitor's gauges; False disables)
        self.SLO_QUORUM_AVAILABILITY: bool = kw.get(
            "SLO_QUORUM_AVAILABILITY", True)

        # consensus forensics (scp/timeline.py): per-slot SCP timeline
        # ring — state-machine transitions, envelopes with verdicts,
        # timer arms/fires — behind the scp?slot=N endpoint and the
        # chaos engine's cross-node forensic dumps.  Recording is
        # provably inert (telemetry on/off closes bit-identical,
        # tests + detlint det-telemetry-readback).
        self.SCP_TIMELINE_ENABLED: bool = kw.get(
            "SCP_TIMELINE_ENABLED", True)
        self.SCP_TIMELINE_SLOTS: int = kw.get("SCP_TIMELINE_SLOTS", 32)
        self.SCP_TIMELINE_EVENTS_PER_SLOT: int = kw.get(
            "SCP_TIMELINE_EVENTS_PER_SLOT", 256)

        # quorum-health monitor (herder/quorum_health.py): one cheap
        # qset-graph evaluation per close (heard/available/criticality
        # gauges), plus an optional budget-capped intersection scan
        # every PERIOD closes (0 = on demand only via the
        # quorum-health?intersection=true endpoint)
        self.QUORUM_HEALTH_ENABLED: bool = kw.get(
            "QUORUM_HEALTH_ENABLED", True)
        self.QUORUM_HEALTH_INTERSECTION_PERIOD: int = kw.get(
            "QUORUM_HEALTH_INTERSECTION_PERIOD", 0)
        self.QUORUM_HEALTH_INTERSECTION_MAX_CALLS: int = kw.get(
            "QUORUM_HEALTH_INTERSECTION_MAX_CALLS", 200_000)
        self.QUORUM_HEALTH_INTERSECTION_TIMEOUT_SECONDS: float = kw.get(
            "QUORUM_HEALTH_INTERSECTION_TIMEOUT_SECONDS", 1.0)

        # invariants
        self.INVARIANT_CHECKS: List[str] = kw.get("INVARIANT_CHECKS", [])

        # history
        self.HISTORY: Dict[str, dict] = kw.get("HISTORY", {})
        self.CHECKPOINT_FREQUENCY: int = kw.get(
            "CHECKPOINT_FREQUENCY",
            8 if self.ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING else 64)

        if self.NODE_SEED is None:
            self.NODE_SEED = sha256(b"default-node-seed")

    def validate(self) -> None:
        """Sanity pass run before a node boots (ref Config::load's
        validation + validateConfig's quorum-safety rules).  Raises
        ConfigError with an operator-actionable message."""
        import re

        if not self.NETWORK_PASSPHRASE:
            raise ConfigError("NETWORK_PASSPHRASE must be non-empty")
        if len(self.NODE_SEED) != 32:
            raise ConfigError("NODE_SEED must be a 32-byte seed")
        # 0 / None disable the respective listener (enable_tcp honors
        # both sentinels); ranges only apply when enabled
        for name in ("PEER_PORT", "HTTP_PORT"):
            v = getattr(self, name)
            if v and not (0 < v < 65536):
                raise ConfigError(f"{name} out of range: {v}")
        if self.PEER_PORT and self.HTTP_PORT and \
                self.PEER_PORT == self.HTTP_PORT:
            raise ConfigError("PEER_PORT and HTTP_PORT must differ")
        if self.EXP_LEDGER_TIMESPAN_SECONDS <= 0:
            raise ConfigError("EXP_LEDGER_TIMESPAN_SECONDS must be > 0")
        if self.MAX_SLOTS_TO_REMEMBER < 1:
            raise ConfigError("MAX_SLOTS_TO_REMEMBER must be >= 1")
        if self.MAX_CONCURRENT_SUBPROCESSES < 1:
            raise ConfigError("MAX_CONCURRENT_SUBPROCESSES must be >= 1")
        if self.TRACE_RING_CLOSES < 1:
            raise ConfigError("TRACE_RING_CLOSES must be >= 1")
        if self.ARTIFICIALLY_SLEEP_IN_CLOSE_FOR_TESTING < 0:
            raise ConfigError(
                "ARTIFICIALLY_SLEEP_IN_CLOSE_FOR_TESTING must be >= 0")
        if self.VITALS_PERIOD_SECONDS <= 0:
            raise ConfigError("VITALS_PERIOD_SECONDS must be > 0")
        if self.VITALS_RING_SAMPLES < 2:
            raise ConfigError("VITALS_RING_SAMPLES must be >= 2")
        if self.TX_LIFECYCLE_RING < 1 or self.TX_LIFECYCLE_MAX_LIVE < 2:
            raise ConfigError(
                "TX_LIFECYCLE_RING must be >= 1 and "
                "TX_LIFECYCLE_MAX_LIVE >= 2")
        if self.FLOOD_TRACE_RING < 1 or self.FLOOD_TRACE_MAX_LIVE < 2:
            raise ConfigError(
                "FLOOD_TRACE_RING must be >= 1 and "
                "FLOOD_TRACE_MAX_LIVE >= 2")
        if self.SCP_TIMELINE_SLOTS < 1 or \
                self.SCP_TIMELINE_EVENTS_PER_SLOT < 8:
            raise ConfigError(
                "SCP_TIMELINE_SLOTS must be >= 1 and "
                "SCP_TIMELINE_EVENTS_PER_SLOT >= 8")
        if self.QUORUM_HEALTH_INTERSECTION_PERIOD < 0:
            raise ConfigError(
                "QUORUM_HEALTH_INTERSECTION_PERIOD must be >= 0")
        if self.PARALLEL_APPLY_WORKERS < 0:
            raise ConfigError("PARALLEL_APPLY_WORKERS must be >= 0")
        if self.MAX_DEX_TX_OPERATIONS is not None and \
                self.MAX_DEX_TX_OPERATIONS < 0:
            raise ConfigError("MAX_DEX_TX_OPERATIONS must be >= 0")
        if self.CRYPTO_BACKEND not in ("cpu", "cuda", "auto"):
            raise ConfigError(
                f"unknown CRYPTO_BACKEND {self.CRYPTO_BACKEND!r}: "
                "\"cpu\", \"cuda\" or \"auto\"")
        if self.SCP_TALLY_BACKEND not in ("host", "tensor", "both",
                                         "auto"):
            raise ConfigError(
                f"unknown SCP_TALLY_BACKEND {self.SCP_TALLY_BACKEND!r}")
        for pat in self.INVARIANT_CHECKS:
            try:
                re.compile(pat)
            except re.error as e:
                raise ConfigError(
                    f"INVARIANT_CHECKS pattern {pat!r}: {e}") from e
        for a in self.HISTORY_ARCHIVES:
            if isinstance(a, dict):
                if "name" not in a or not ("get" in a or "put" in a):
                    raise ConfigError(
                        "command-template HISTORY_ARCHIVES entries need "
                        "'name' and at least one of 'get'/'put'")
                unknown = set(a) - {"name", "get", "put", "mkdir"}
                if unknown:
                    raise ConfigError(
                        f"unknown archive keys: {sorted(unknown)}")
            elif len(a) != 2:
                raise ConfigError(
                    "HISTORY_ARCHIVES entries must be [name, path] pairs "
                    "or {name, get, put, mkdir} command tables")
        if self.QUORUM_SET is not None:
            self._validate_qset(self.QUORUM_SET, depth=0)
        elif self.NODE_IS_VALIDATOR and not self.RUN_STANDALONE:
            raise ConfigError("validator nodes need a QUORUM_SET")

    def _validate_qset(self, qs: dict, depth: int) -> None:
        """Structure + byzantine-safety of a quorum-set spec (ref
        validateConfig: threshold >= n - f with f = (n-1)/3 unless
        UNSAFE_QUORUM; FAILURE_SAFETY overrides f at the top level)."""
        if depth > 2:
            raise ConfigError("quorum set nested deeper than 2 levels")
        validators = qs.get("validators", [])
        inner = qs.get("inner_sets", [])
        n = len(validators) + len(inner)
        thr = qs.get("threshold", 0)
        if n == 0:
            raise ConfigError("empty quorum set")
        if not (1 <= thr <= n):
            raise ConfigError(
                f"quorum threshold {thr} out of range 1..{n}")
        if len(set(validators)) != len(validators):
            raise ConfigError("duplicate validator in quorum set")
        if depth == 0 and not self.UNSAFE_QUORUM:
            max_f = (n - 1) // 3
            f = max_f if self.FAILURE_SAFETY < 0 else self.FAILURE_SAFETY
            if f > max_f:
                # tolerating more than (n-1)/3 byzantine failures is
                # impossible; a larger f would also weaken the threshold
                # bound below into a liveness-only check
                raise ConfigError(
                    f"FAILURE_SAFETY {f} exceeds the {max_f} byzantine "
                    f"failures a {n}-member quorum set can tolerate")
            if thr < n - f:
                raise ConfigError(
                    f"quorum threshold {thr} < {n - f} is unsafe for "
                    f"{n} members tolerating {f} failures; raise the "
                    "threshold or set UNSAFE_QUORUM = true")
        for s in inner:
            self._validate_qset(s, depth + 1)

    def network_id(self) -> bytes:
        return sha256(self.NETWORK_PASSPHRASE.encode())

    def node_secret(self) -> SecretKey:
        return SecretKey(self.NODE_SEED)

    def node_id(self) -> bytes:
        return self.node_secret().public_key().raw

    @classmethod
    def from_toml(cls, path: str) -> "Config":
        try:
            import tomllib
        except ImportError:  # Python < 3.11: the bundled subset parser
            from ..utils import minitoml as tomllib

        with open(path, "rb") as f:
            data = tomllib.load(f)
        kw = {}
        known = set(vars(cls()))
        for k, v in data.items():
            if k.upper() not in known:
                raise ConfigError(f"unknown configuration key: {k}")
            kw[k.upper()] = v
        if "NODE_SEED" in kw and isinstance(kw["NODE_SEED"], str):
            from ..crypto.strkey import decode_ed25519_seed

            kw["NODE_SEED"] = decode_ed25519_seed(kw["NODE_SEED"])
        qs = kw.get("QUORUM_SET")
        if qs:
            kw["QUORUM_SET"] = cls._decode_qset_spec(qs)
        if "HISTORY_ARCHIVES" in kw:
            kw["HISTORY_ARCHIVES"] = [
                a if isinstance(a, dict) else tuple(a)
                for a in kw["HISTORY_ARCHIVES"]]
        cfg = cls(**kw)
        # a file-configured node persists buckets next to its database by
        # default (BUCKET_DIR_PATH resolved relative to the config file,
        # like the reference's BUCKET_DIR_PATH); in-memory-DB nodes stay
        # storeless unless an explicit real path is given
        if cfg.BUCKET_DIR_PATH_REAL is None and cfg.DATABASE != ":memory:":
            import os

            base = os.path.dirname(os.path.abspath(path))
            cfg.BUCKET_DIR_PATH_REAL = (
                cfg.BUCKET_DIR_PATH
                if os.path.isabs(cfg.BUCKET_DIR_PATH)
                else os.path.join(base, cfg.BUCKET_DIR_PATH))
        cfg.validate()
        return cfg

    @staticmethod
    def _decode_qset_spec(qs: dict) -> dict:
        """TOML quorum sets name validators by strkey (G...); decode to
        raw keys recursively."""
        from ..crypto.strkey import decode_ed25519_public_key

        def conv(v):
            return (decode_ed25519_public_key(v)
                    if isinstance(v, str) else v)

        out = {"threshold": qs["threshold"],
               "validators": [conv(v) for v in qs.get("validators", [])]}
        if qs.get("inner_sets"):
            out["inner_sets"] = [Config._decode_qset_spec(s)
                                 for s in qs["inner_sets"]]
        return out


def test_config(n: int = 0, **kw) -> Config:
    """getTestConfig equivalent (ref src/test/TestUtils): standalone,
    manual close, in-memory DB, accelerated time."""
    import os

    defaults = dict(
        NODE_SEED=sha256(b"test-node-%d" % n),
        RUN_STANDALONE=True,
        MANUAL_CLOSE=True,
        ARTIFICIALLY_ACCELERATE_TIME_FOR_TESTING=True,
        DATABASE=":memory:",
        INVARIANT_CHECKS=[".*"],
        # test quorums (2-of-3 etc.) are below the byzantine-safety bar
        # on purpose (ref getTestConfig setting UNSAFE_QUORUM)
        UNSAFE_QUORUM=True,
        # suites/simulations keep normal GC: the deferred policy is
        # process-global and one multi-app pytest process must not have
        # collection disabled by the first test app
        DEFERRED_GC=False,
        # the slow-close watchdog stays off in suites (a loaded CI worker
        # crossing the threshold would litter trace files in the cwd);
        # watchdog tests opt in with an explicit threshold + TRACE_DIR
        SLOW_CLOSE_THRESHOLD_SECONDS=0.0,
        # tests pin the host tiers: "auto" would need a GPU, and the
        # suite runs on CPU; device-path tests opt in explicitly
        CRYPTO_BACKEND="cpu",
        SCP_TALLY_BACKEND="host",
        # parallel apply stays opt-in for suites: the default tier-1
        # pass exercises the sequential path; tools/verify_green.py's
        # parallel smoke re-runs the suite with PARALLEL_APPLY_WORKERS=2
        # exported, which flips every test Application to parallel
        PARALLEL_APPLY_WORKERS=int(
            os.environ.get("PARALLEL_APPLY_WORKERS", "0") or 0),
        # same discipline for the pipelined close: off in the default
        # tier-1 pass, flipped on suite-wide by verify_green's
        # PIPELINED_CLOSE=1 smoke (MANUAL_CLOSE rigs then eager-drain
        # per close, so post-close reads keep sequential semantics)
        PIPELINED_CLOSE=os.environ.get("PIPELINED_CLOSE", "0") == "1",
        # the vitals timer stays off in suites (a per-app 1 Hz timer
        # would perturb crank_until-driven rigs and add 50 timers/s at
        # simulation scale); vitals/soak tests opt in explicitly.  The
        # tx-lifecycle tracker stays ON — it owns no timers and every
        # suite close then exercises the stamp sites.
        VITALS_ENABLED=False,
    )
    defaults.update(kw)
    return Config(**defaults)
