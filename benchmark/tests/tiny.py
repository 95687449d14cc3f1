"""Running a cell on the CPU at a size a test can hold, in a child
process of its own (so that faults and loaded modules stay there)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# each cell cut to a few accounts and envelopes.  The standalone cells keep
# their device paths, which on the CPU run the port's plain torch verify
# and tallies; the network runs the port's host tiers (a plain verify of
# every overlay batch would take minutes here)
TINY = {
    "standalone.flooded_1k": {
        "accounts": 12, "per_ledger": 12, "forged_per_ledger": 2,
        "window_start_seq": 7, "warmup_ledgers": 1, "pool_ledgers": 400,
        "sample_per_kind": 3},
    "tier1_net.pay_100": {
        "accounts": 8, "per_ledger": 8, "forged_per_ledger": 1,
        "sample_per_kind": 2, "topology": {"orgs": 3, "per_org": 2},
        "node": {"CRYPTO_BACKEND": "cpu", "SCP_TALLY_BACKEND": "host"}},
    "standalone.txset_100k": {
        "signatures": 200, "signers": 20, "forged": 2,
        "sample_per_kind": 2},
}

CHILD = """
import json, sys
from benchmark import harness
args = json.loads(sys.argv[1])
line, _ = harness.run(args["cell"], args["seed"], args["seconds"],
                      args["trace"], device="cpu", fault=args["fault"],
                      overrides=args["overrides"])
line["forbidden"] = harness.forbidden_modules()
print(json.dumps(line))
"""


def run(cell: str, seed: int = 2**31 + 11, seconds: float = 0.3,
        trace: bool = False, fault: str | None = None,
        overrides: dict | None = None, root: Path = REPO) -> dict:
    """The result line of one run, with ``forbidden``: the JAX modules
    loaded in the child by then."""
    args = {"cell": cell, "seed": seed, "seconds": seconds, "trace": trace,
            "fault": fault, "overrides": overrides or TINY[cell]}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        dict.fromkeys([str(root), str(REPO)]))}
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(args)],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
