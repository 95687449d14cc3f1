"""admit.host_verify_ms_per_ledger: the mean over the window's ledgers of
the host ed25519 verifies that missed the verify cache while the node
admitted the ledger's envelopes (``admit_verify`` of
``last_close_phases``): the part of admission that a batch on the device
could take."""


def read(ctx):
    rows = [r["admit_verify"] for r in ctx.counters.get("close_phases", [])
            if "admit_verify" in r]
    return sum(rows) / len(rows) if rows else None
