#!/usr/bin/env python3
"""fleet_scrape: poll N real-TCP nodes' admin endpoints into one JSONL
stream + a fleet summary (the ROADMAP item-4 soak's aggregation path —
sims get the in-process network-observatory endpoint instead).

Each round, every node is polled for `/info`, `/metrics`, `/vitals` and
`/flood` (the r19 hop-record report); one JSONL line is written per node
per round.  After the last round a summary document is computed over the
final round: per-node ledger height / close p50 / flood dedup totals,
fleet-level height spread and per-link redundancy.

    python -m stellar_core_tpu_torch.tools.fleet_scrape \
        --nodes 127.0.0.1:11626,127.0.0.1:11628 --rounds 10 --interval 2 \
        [--out fleet.jsonl]

The JSONL lines go to stdout unless ``--out`` names a file.

A node that fails to answer gets an "error" field in its line and is
excluded from the summary (listed under "unreachable") — a soak must
keep scraping through individual node restarts.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import urllib.request


def fetch_json(base: str, path: str, timeout: float = 5.0) -> dict:
    """GET http://<base>/<path> and decode the JSON body."""
    with urllib.request.urlopen(f"http://{base}/{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def scrape_node(base: str, timeout: float = 5.0,
                fetch=fetch_json) -> dict:
    """One node's round: info + metrics + vitals + flood report.
    ``fetch`` is injectable so tests can drive this without sockets."""
    doc = {"node": base}
    try:
        doc["info"] = fetch(base, "info", timeout)["info"]
        doc["metrics"] = fetch(base, "metrics", timeout)["metrics"]
    except Exception as e:
        doc["error"] = f"{type(e).__name__}: {e}"
        return doc
    # vitals/flood are best-effort: vitals may be disabled on the rig
    for path, key in (("vitals", "vitals"), ("flood?last=4", "flood")):
        try:
            doc[key] = fetch(base, path, timeout)[key]
        except Exception as e:
            doc[f"{key}_error"] = f"{type(e).__name__}: {e}"
    return doc


def _node_summary(doc: dict) -> dict:
    m = doc.get("metrics", {})

    def _count(name):
        return m.get(name, {}).get("count", 0)

    close = m.get("ledger.ledger.close", {})
    out = {
        "ledger": doc.get("info", {}).get("ledger", {}).get("num", 0),
        "close_p50_s": close.get("p50"),
        "close_count": close.get("count", 0),
        "flood_unique": _count("overlay.flood.unique"),
        "flood_duplicate": _count("overlay.flood.duplicate"),
    }
    flood = doc.get("flood")
    if flood:
        out["links"] = flood.get("links", {})
        out["trace_stats"] = {k: flood[k] for k in
                              ("stride", "tracked", "live", "retired")
                              if k in flood}
    return out


def summarize(round_docs: list) -> dict:
    """Fleet summary over one round's node documents."""
    nodes = {}
    unreachable = []
    for doc in round_docs:
        if "error" in doc:
            unreachable.append({"node": doc["node"],
                                "error": doc["error"]})
            continue
        nodes[doc["node"]] = _node_summary(doc)
    heights = [n["ledger"] for n in nodes.values()]
    uniq = sum(n["flood_unique"] for n in nodes.values())
    dup = sum(n["flood_duplicate"] for n in nodes.values())
    links = {}
    for base, n in sorted(nodes.items()):
        for pid8, row in n.get("links", {}).items():
            links[f"{base}<-{pid8}"] = row
    return {
        "nodes": nodes,
        "unreachable": unreachable,
        "fleet": {
            "n_reachable": len(nodes),
            "ledger_min": min(heights) if heights else 0,
            "ledger_max": max(heights) if heights else 0,
            "ledger_spread": (max(heights) - min(heights))
            if heights else 0,
            "flood_unique_total": uniq,
            "flood_duplicate_total": dup,
            "flood_redundancy": round(dup / (uniq + dup), 4)
            if uniq + dup else 0.0,
        },
        "links": links,
    }


def run(bases: list, rounds: int, interval: float, out_path=None,
        timeout: float = 5.0, fetch=fetch_json, sleep=time.sleep,
        now=time.time) -> dict:
    """The scrape loop; returns the final summary (also appended to the
    JSONL as a {"summary": ...} line).  The JSONL goes to ``out_path``,
    or to stdout without one."""
    last_round = []
    with (open(out_path, "w") if out_path
          else contextlib.nullcontext(sys.stdout)) as f:
        for r in range(rounds):
            t = now()
            last_round = []
            for base in bases:
                doc = scrape_node(base, timeout, fetch=fetch)
                doc["t"] = round(t, 3)
                doc["round"] = r
                last_round.append(doc)
                f.write(json.dumps(doc, sort_keys=True) + "\n")
            f.flush()
            if r + 1 < rounds:
                sleep(interval)
        summary = summarize(last_round)
        f.write(json.dumps({"summary": summary}, sort_keys=True) + "\n")
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="poll N nodes' admin endpoints into JSONL + summary")
    ap.add_argument("--nodes", required=True,
                    help="comma-separated host:http_port list")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between rounds")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--out", default=None,
                    help="write the JSONL to this file (default: stdout)")
    args = ap.parse_args(argv)

    bases = [b.strip() for b in args.nodes.split(",") if b.strip()]
    summary = run(bases, args.rounds, args.interval, args.out,
                  timeout=args.timeout)
    print(json.dumps(summary, indent=1, sort_keys=True))
    fleet = summary["fleet"]
    print(f"# {fleet['n_reachable']}/{len(bases)} nodes, "
          f"ledgers {fleet['ledger_min']}..{fleet['ledger_max']}, "
          f"redundancy {fleet['flood_redundancy']}", file=sys.stderr)
    return 0 if fleet["n_reachable"] == len(bases) else 1


if __name__ == "__main__":
    sys.exit(main())
