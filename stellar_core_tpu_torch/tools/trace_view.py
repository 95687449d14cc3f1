#!/usr/bin/env python
"""ASCII flame summary for persisted flight-recorder traces, plus a
slot-timeline renderer for SCP forensics.

The slow-close watchdog (stellar_core_tpu/utils/tracing.py) persists
Chrome ``trace_event`` JSON; chrome://tracing / Perfetto render it, but
the container has no browser.  This renders the same file as an
indented tree with proportional bars plus a top-self-time table.

``--slots`` switches to the consensus-forensics view: the input is
either one node's ``scp?slot=N`` / ``scp`` endpoint body or a
network-wide ``FORENSICS_*.json`` dump (simulation/chaos.py).  Events
from every node merge into one per-slot timeline, ordered by virtual
time, with the first-divergence attribution and equivocation evidence
printed up top — a failing chaos schedule read as a story.

Usage: python tools/trace_view.py <trace.json> [--width N] [--top K]
       python tools/trace_view.py --slots <FORENSICS_*.json|scp.json>
           [--slot N] [--node HEX8]
"""
import argparse
import json
import sys
from typing import Dict, List, Optional


class Node:
    __slots__ = ("name", "ts", "dur", "tid", "args", "children")

    def __init__(self, ev: dict):
        self.name = ev.get("name", "?")
        self.ts = float(ev.get("ts", 0.0))        # µs
        self.dur = float(ev.get("dur", 0.0))      # µs
        self.tid = ev.get("tid", 0)
        self.args = ev.get("args", {})
        self.children: List["Node"] = []


def build_forest(events: List[dict]) -> List[Node]:
    """Parent by explicit span ids (the recorder exports them in args);
    events without a resolvable parent become roots."""
    nodes: Dict[int, Node] = {}
    order: List[Node] = []
    for ev in events:
        n = Node(ev)
        sid = ev.get("args", {}).get("span_id")
        if sid is not None:
            nodes[sid] = n
        order.append(n)
    roots: List[Node] = []
    for n in order:
        pid = n.args.get("parent_id")
        parent = nodes.get(pid) if pid is not None else None
        if parent is None or parent is n:
            roots.append(n)
        else:
            parent.children.append(n)
    for n in order:
        n.children.sort(key=lambda c: c.ts)
    roots.sort(key=lambda c: c.ts)
    return roots


def render_tree(roots: List[Node], width: int) -> List[str]:
    total = max((r.dur for r in roots), default=0.0) or 1.0
    lines: List[str] = []

    def walk(n: Node, depth: int, main_tid) -> None:
        bar = "#" * max(1, int(round(n.dur / total * width))) \
            if n.dur > 0 else ""
        cross = "" if n.tid == main_tid else \
            f"  [thread {n.args.get('thread', n.tid)}]"
        pct = n.dur / total * 100.0
        lines.append(f"{'  ' * depth}{n.name:<{44 - 2 * min(depth, 10)}}"
                     f"{n.dur / 1000.0:10.3f}ms {pct:5.1f}% "
                     f"{bar}{cross}")
        for c in n.children:
            walk(c, depth + 1, main_tid)

    for r in roots:
        walk(r, 0, r.tid)
    return lines


def self_time_table(events: List[dict], top: int) -> List[str]:
    by_sid = {ev["args"]["span_id"]: ev
              for ev in events if ev.get("args", {}).get("span_id")}
    selfs = {sid: float(ev.get("dur", 0.0))
             for sid, ev in by_sid.items()}
    for ev in events:
        pid = ev.get("args", {}).get("parent_id")
        parent = by_sid.get(pid)
        # same-thread children only: cross-thread children (the bucket
        # worker merges) run concurrently with their parent
        if parent is not None and parent.get("tid") == ev.get("tid"):
            selfs[pid] -= float(ev.get("dur", 0.0))
    by_name: Dict[str, List[float]] = {}
    for ev in events:
        sid = ev.get("args", {}).get("span_id")
        if sid is None:
            continue
        slot = by_name.setdefault(ev.get("name", "?"), [0.0, 0])
        slot[0] += selfs.get(sid, 0.0)
        slot[1] += 1
    lines = ["", f"top {top} spans by self time:",
             f"  {'span':<36}{'self':>12}{'count':>8}"]
    ranked = sorted(by_name.items(), key=lambda kv: (-kv[1][0], kv[0]))
    for name, (self_us, count) in ranked[:top]:
        lines.append(f"  {name:<36}{self_us / 1000.0:10.3f}ms"
                     f"{count:8d}")
    return lines


def render(trace: dict, width: int = 40, top: int = 10) -> str:
    events = trace.get("traceEvents", [])
    meta = trace.get("metadata", {})
    head = []
    if meta:
        head.append(f"ledger {meta.get('ledger', '?')}: "
                    f"{meta.get('duration_ms', '?')}ms over "
                    f"{len(events)} spans")
        if meta.get("truncated_spans"):
            head.append(f"  ({meta['truncated_spans']} oldest spans "
                        "truncated from the ring)")
    lines = head + render_tree(build_forest(events), width)
    lines += self_time_table(events, top)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# propagation view (network observatory)
# ---------------------------------------------------------------------------

def _obs_body(doc: dict) -> dict:
    """Accept a raw observatory snapshot, the `network-observatory`
    endpoint body ({"observatory": ...}), or a NET_OBS bench tier doc
    carrying an "observatory" key."""
    if isinstance(doc.get("observatory"), dict):
        return doc["observatory"]
    return doc


def render_propagation(doc: dict, item: Optional[str] = None,
                       top: int = 8) -> str:
    """Per-item hop tree + coverage timeline from a merged observatory
    snapshot (browser-less).  ``item`` filters to hashes with that hex
    prefix; otherwise the ``top`` most recent items render."""
    snap = _obs_body(doc)
    lines: List[str] = []
    nodes = snap.get("nodes", [])
    lines.append(f"{len(nodes)} nodes, {snap.get('n_items', 0)} "
                 "flood items")
    prop = snap.get("propagation", {})
    for key in ("ttfd", "time_to_50pct", "time_to_90pct"):
        s = prop.get(key)
        if s:
            lines.append(
                f"  {key:<14} n={s['n']:<6} "
                f"p50={s['p50'] * 1000.0:9.3f}ms "
                f"p90={s['p90'] * 1000.0:9.3f}ms "
                f"max={s['max'] * 1000.0:9.3f}ms")

    items = snap.get("items", {})
    sel = sorted(items.items(), key=lambda kv: (
        kv[1]["deliveries"][0]["t"] if kv[1].get("deliveries") else 0.0,
        kv[0]))
    if item is not None:
        sel = [(h, it) for h, it in sel if h.startswith(item)]
    else:
        sel = sel[-top:]

    for h, it in sel:
        lines.append("")
        lines.append(
            f"item {h[:16]} [{it.get('kind', '?')}] "
            f"origin={it.get('origin') or '?'} "
            f"coverage={it.get('coverage')} "
            f"dups={it.get('dups_total', 0)}")
        delv = it.get("deliveries", [])
        if not delv:
            continue
        t0 = delv[0]["t"]
        by_parent: Dict[Optional[str], List[dict]] = {}
        node_set = {d["node"] for d in delv}
        for d in delv:
            by_parent.setdefault(d.get("from"), []).append(d)
        emitted = set()

        def walk(d: dict, depth: int) -> None:
            if d["node"] in emitted:
                return
            emitted.add(d["node"])
            mark = "*" if depth == 0 else "+"
            src = f"  (from {d['from']})" \
                if depth == 0 and d.get("from") else ""
            lines.append(f"  {'  ' * depth}{mark} {d['node']} "
                         f"+{(d['t'] - t0) * 1000.0:.3f}ms{src}")
            for c in by_parent.get(d["node"], []):
                walk(c, depth + 1)

        for d in delv:
            # roots: the origin (from=None) or deliveries whose sending
            # peer has no record of its own (sampled out / evicted)
            if d.get("from") is None or d["from"] not in node_set:
                walk(d, 0)
        for d in delv:  # anything the tree missed renders flat
            walk(d, 0)
        n = len(nodes) or len(delv)
        steps = " ".join(
            f"{i + 1}/{n}@{(d['t'] - t0) * 1000.0:.1f}ms"
            for i, d in enumerate(delv))
        lines.append(f"  coverage: {steps}")

    links = snap.get("links", {})
    if links:
        lines.append("")
        lines.append("link redundancy (dup / (uniq + dup)):")
        for k in sorted(links):
            row = links[k]
            lines.append(f"  {k:<22} uniq={row['unique']:<7}"
                         f"dup={row['duplicate']:<7}"
                         f"r={row['redundancy']}")
    cadence = snap.get("close_cadence", {})
    if cadence:
        lines.append("")
        lines.append("close cadence (lcl, lag behind head):")
        for n8 in sorted(cadence):
            row = cadence[n8]
            lines.append(f"  {n8:<10} lcl={row['lcl']:<8}"
                         f"lag={row['lag']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# slot-timeline view (consensus forensics)
# ---------------------------------------------------------------------------

def _short(v, n: int = 12):
    """Truncate long value tags for display (full tags live in the
    JSON)."""
    if isinstance(v, str) and len(v) > n:
        return v[:n] + ".."
    if isinstance(v, list):
        return [_short(x, n) for x in v]
    if isinstance(v, dict):
        return {k: _short(x, n) for k, x in v.items()}
    return v


def _event_detail(ev: dict) -> str:
    parts = []
    for k in sorted(ev):
        if k in ("t", "kind"):
            continue
        parts.append(f"{k}={_short(ev[k])}")
    return " ".join(parts)


def _node_timelines(doc: dict) -> Dict[str, dict]:
    """Normalize the three accepted shapes to {node: timeline export}:
    a FORENSICS dump ('timelines'), a full `scp` body ('timeline' with
    ring summary is NOT enough — needs slots), or one node's
    `scp?slot=N` body ('timeline' carrying slot events)."""
    if "timelines" in doc:
        return doc["timelines"]
    tl = doc.get("timeline", {})
    if "events" in tl:  # scp?slot=N single-slot body
        return {"local": {"slots": {str(tl.get("slot", doc.get("slot", 0))):
                                    {"events": tl.get("events", []),
                                     "dropped": tl.get("dropped", 0)}}}}
    if isinstance(tl.get("slots"), dict):  # a raw SCPTimeline.export()
        return {"local": tl}
    # the full `scp` body's timeline is a ring SUMMARY ("slots" is a
    # list of indices, no events) — nothing renderable
    if "slots" in doc and isinstance(doc.get("slots"), dict) and any(
            "events" in v for v in doc["slots"].values()):
        return {"local": doc}
    return {}


def render_slots(doc: dict, slot: Optional[int] = None,
                 node: Optional[str] = None) -> str:
    lines: List[str] = []
    fd = doc.get("first_divergence")
    if fd:
        lines.append(f"FIRST DIVERGENCE: slot {fd.get('slot')} via "
                     f"{fd.get('via')} -> node {fd.get('node')}")
    for e in doc.get("equivocations", []):
        wit = {w for s in e.get("statements", [])
               for w in s.get("witnesses", [])}
        lines.append(
            f"EQUIVOCATION: node {e['node']} slot {e['slot']} "
            f"[{e['proto']}] {e.get('conflicting_pairs', 0)} conflicting "
            f"pair(s), witnessed by {', '.join(sorted(wit))}")
    if doc.get("reason"):
        lines.append(f"reason: {doc['reason']}")
    if lines:
        lines.append("")

    timelines = _node_timelines(doc)
    if node is not None:
        timelines = {n: t for n, t in timelines.items()
                     if n.startswith(node)}
    # merge: slot -> [(t, node, kind, detail)]
    merged: Dict[int, List[tuple]] = {}
    order = 0
    for n8 in sorted(timelines):
        for slot_str, slot_doc in sorted(
                timelines[n8].get("slots", {}).items(), key=lambda kv:
                int(kv[0])):
            s = int(slot_str)
            if slot is not None and s != slot:
                continue
            for ev in slot_doc.get("events", []):
                order += 1
                merged.setdefault(s, []).append(
                    (float(ev.get("t", 0.0)), order, n8,
                     ev.get("kind", "?"), _event_detail(ev)))
            if slot_doc.get("dropped"):
                merged.setdefault(s, []).append(
                    (float("inf"), order, n8, "(truncated)",
                     f"dropped={slot_doc['dropped']} oldest events"))
    if not merged:
        lines.append("no slot timeline events in this file")
        return "\n".join(lines)
    for s in sorted(merged):
        lines.append(f"== slot {s} ==")
        lines.append(f"  {'t(s)':>10}  {'node':<10}{'event':<24}detail")
        for t, _o, n8, kind, detail in sorted(merged[s]):
            ts = "" if t == float("inf") else f"{t:10.3f}"
            lines.append(f"  {ts:>10}  {n8:<10}{kind:<24}{detail}")
        lines.append("")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="Chrome trace_event JSON file, or a "
                                  "FORENSICS_*.json / scp endpoint body "
                                  "with --slots")
    ap.add_argument("--width", type=int, default=40,
                    help="flame bar width in columns")
    ap.add_argument("--top", type=int, default=10,
                    help="rows in the self-time table")
    ap.add_argument("--slots", action="store_true",
                    help="render a consensus slot timeline instead of "
                         "a flame tree")
    ap.add_argument("--slot", type=int, default=None,
                    help="with --slots: only this slot")
    ap.add_argument("--node", default=None,
                    help="with --slots: only nodes whose hex8 id "
                         "starts with this prefix")
    ap.add_argument("--propagation", action="store_true",
                    help="render per-item flood hop trees + coverage "
                         "timelines from a network-observatory snapshot")
    ap.add_argument("--item", default=None,
                    help="with --propagation: only items whose hash "
                         "starts with this hex prefix")
    args = ap.parse_args()
    try:
        with open(args.trace, encoding="utf-8") as f:
            trace = json.load(f)
    except (OSError, ValueError) as e:
        print(f"trace_view: cannot read {args.trace}: {e}",
              file=sys.stderr)
        return 2
    if args.slots:
        print(render_slots(trace, slot=args.slot, node=args.node))
    elif args.propagation:
        print(render_propagation(trace, item=args.item, top=args.top))
    else:
        print(render(trace, width=args.width, top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
