"""Parallel transaction-apply subsystem (ref protocol-20 parallel
Soroban apply, SURVEY.md §2.8/§2.17; Block-STM, Gelashvili et al.,
PPoPP 2022 — adapted to *declared* footprints instead of optimistic
re-execution).

Three layers, one module each:

- ``footprint``  — per-transaction declared read/write footprints over
  canonical LedgerKey bytes, with order-book access declared *by
  asset-pair* and plan-time materialization of everything a DEX
  crossing can touch (resting offers, their sellers, trustlines,
  sponsors, the pair's liquidity pool);
- ``planner``    — conflict graph over the canonical apply order +
  union-find clustering: any two txs sharing a write key, a book pair,
  or the offer-id pool land in one cluster, intra-cluster order
  preserved;
- ``executor``   — each cluster runs against its own child
  ``LedgerTxn`` over a shared immutable snapshot on a worker pool; a
  speculation guard turns any undeclared access into a
  ``FootprintEscape`` that aborts the whole parallel attempt and
  replays the set sequentially (the always-correct fallback).  Cluster
  deltas merge in canonical order, so header/bucket hashes AND meta
  bytes are bit-identical to sequential apply; the GIL-releasing
  native work (xdrpack meta/result serialization) overlaps across
  clusters.

Kill switch: config ``PARALLEL_APPLY = false`` (or env
``PARALLEL_APPLY=0``); aborts surface as the ``apply.parallel.abort``
counter and in ``ledger.apply.cluster`` spans.
"""
from .executor import FootprintEscape, ParallelApplyManager  # noqa: F401
from .footprint import TxFootprint, footprint_for  # noqa: F401
from .planner import ApplyPlan, plan_parallel_apply  # noqa: F401
