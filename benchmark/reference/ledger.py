"""Plain reference of what a validator does with the benchmark's
envelopes: which it admits, which it applies, and the balances and
sequence numbers that follow.  Numpy and the rules of the protocol
(version 19) for the two operations the traffic holds; nothing of the
program.

Rules (stellar-core's ``TransactionQueue::tryAdd`` and
``TransactionFrame::apply`` for these shapes):

- an envelope is admitted when its signature verifies and its sequence
  number extends its source account's chain (the account's number, or
  the last one queued this ledger) by one;
- at the close every admitted envelope is applied: the fee (100 stroops
  an operation, the ledger's base fee: no set here exceeds the ledger's
  operation cap, so there is no surge pricing) leaves the source, the
  source's sequence number becomes the envelope's, and each operation
  moves its amount (a payment) or makes its account with that balance
  and the sequence number ``ledger << 32`` (a CreateAccount);
- the result is ``txSUCCESS`` with that fee: every payment is funded,
  every destination exists.
"""
from __future__ import annotations

import numpy as np

TX_SUCCESS = 0


class Ledger:
    def __init__(self, n_accounts: int):
        self.balance = np.zeros(n_accounts, np.int64)
        self.seq = np.zeros(n_accounts, np.int64)
        self.exists = np.zeros(n_accounts, bool)
        self.root_seq = 0
        self.queued: dict[int, int] = {}     # source -> last queued seq
        self.pending: list = []              # admitted, not yet closed
        self.results: dict[bytes, tuple] = {}  # hash -> (ledger, code, fee)

    def _seq_of(self, src: int) -> int:
        if src in self.queued:
            return self.queued[src]
        return self.root_seq if src < 0 else int(self.seq[src])

    def admit(self, env, valid: bool) -> bool:
        """Whether the node admits ``env``; ``valid``: its signature
        verifies."""
        if not valid or (env.src >= 0 and not self.exists[env.src]):
            return False
        if env.seq != self._seq_of(env.src) + 1:
            return False
        self.queued[env.src] = env.seq
        self.pending.append(env)
        return True

    def close(self, ledger_seq: int) -> None:
        for env in self.pending:
            fee = 100 * len(env.ops)
            if env.src < 0:
                self.root_seq = env.seq
            else:
                self.balance[env.src] -= fee
                self.seq[env.src] = env.seq
            for kind, dest, amount in env.ops:
                if kind == "create":
                    self.exists[dest] = True
                    self.balance[dest] = amount
                    self.seq[dest] = ledger_seq << 32
                else:
                    self.balance[env.src] -= amount
                    self.balance[dest] += amount
            self.results[env.hash] = (ledger_seq, TX_SUCCESS, fee)
        self.pending, self.queued = [], {}
