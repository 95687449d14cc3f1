"""Statement/ballot helpers over the XDR SCP types.

Ballots are internally ``(counter:int, value:bytes)`` tuples — Python's
lexicographic tuple order matches the protocol's ballot order (counter,
then value bytes; ref BallotProtocol::compareBallots).  XDR values cross
the boundary only inside SCPStatement structures.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Set, Tuple

from ..xdr import types as T

Ballot = Tuple[int, bytes]
UINT32_MAX = 2**32 - 1

ST_PREPARE = T.SCPStatementType.SCP_ST_PREPARE
ST_CONFIRM = T.SCPStatementType.SCP_ST_CONFIRM
ST_EXTERNALIZE = T.SCPStatementType.SCP_ST_EXTERNALIZE
ST_NOMINATE = T.SCPStatementType.SCP_ST_NOMINATE


def ballot_from_xdr(b) -> Ballot:
    return (b.counter, b.value)


def ballot_to_xdr(b: Ballot):
    return T.SCPBallot.make(counter=b[0], value=b[1])


def compatible(b1: Ballot, b2: Ballot) -> bool:
    return b1[1] == b2[1]


def less_and_compatible(b1: Ballot, b2: Ballot) -> bool:
    return b1 <= b2 and compatible(b1, b2)


def less_and_incompatible(b1: Ballot, b2: Ballot) -> bool:
    return b1 <= b2 and not compatible(b1, b2)


def node_of(st) -> bytes:
    return st.nodeID.value


def pledge_type(st) -> int:
    return st.pledges.type


def working_ballot(st) -> Ballot:
    """The ballot a statement is 'voting commit' on (ref getWorkingBallot)."""
    t = pledge_type(st)
    p = st.pledges.value
    if t == ST_PREPARE:
        return ballot_from_xdr(p.ballot)
    if t == ST_CONFIRM:
        return (p.nCommit, p.ballot.value)
    if t == ST_EXTERNALIZE:
        return ballot_from_xdr(p.commit)
    raise ValueError("not a ballot statement")


def companion_qset_hash(st) -> bytes:
    """Quorum-set hash carried by any statement type."""
    t = pledge_type(st)
    p = st.pledges.value
    if t == ST_PREPARE:
        return p.quorumSetHash
    if t == ST_CONFIRM:
        return p.quorumSetHash
    if t == ST_EXTERNALIZE:
        return p.commitQuorumSetHash
    if t == ST_NOMINATE:
        return p.quorumSetHash
    raise ValueError("unknown statement type")


def statement_ballot_counter(st) -> int:
    """Counter for v-blocking-ahead checks; EXTERNALIZE is infinite
    (ref statementBallotCounter)."""
    t = pledge_type(st)
    p = st.pledges.value
    if t == ST_PREPARE:
        return p.ballot.counter
    if t == ST_CONFIRM:
        return p.ballot.counter
    if t == ST_EXTERNALIZE:
        return UINT32_MAX
    raise ValueError("not a ballot statement")


def ballot_statement_values(st) -> Set[bytes]:
    """Every value referenced by a ballot statement (ref getStatementValues)."""
    t = pledge_type(st)
    p = st.pledges.value
    out: Set[bytes] = set()
    if t == ST_PREPARE:
        if p.ballot.counter != 0:
            out.add(p.ballot.value)
        if p.prepared is not None:
            out.add(p.prepared.value)
        if p.preparedPrime is not None:
            out.add(p.preparedPrime.value)
    elif t == ST_CONFIRM:
        out.add(p.ballot.value)
    elif t == ST_EXTERNALIZE:
        out.add(p.commit.value)
    return out


def is_newer_ballot_statement(old, new) -> bool:
    """Total order on ballot statements (ref isNewerStatement)."""
    t_old, t_new = pledge_type(old), pledge_type(new)
    if t_old != t_new:
        return t_old < t_new
    if t_new == ST_EXTERNALIZE:
        return False
    if t_new == ST_CONFIRM:
        oc, nc = old.pledges.value, new.pledges.value
        ob, nb = ballot_from_xdr(oc.ballot), ballot_from_xdr(nc.ballot)
        if ob != nb:
            return ob < nb
        if oc.nPrepared != nc.nPrepared:
            return oc.nPrepared < nc.nPrepared
        return oc.nH < nc.nH
    # PREPARE: lexicographic on (b, p, p', nH) with None < any ballot
    op, np_ = old.pledges.value, new.pledges.value

    def key(p):
        return (
            ballot_from_xdr(p.ballot),
            _opt(p.prepared),
            _opt(p.preparedPrime),
        )

    ok, nk = key(op), key(np_)
    if ok != nk:
        return ok < nk
    return op.nH < np_.nH


def _opt(b) -> Tuple:
    # None orders below every real ballot
    return (-1, b"") if b is None else ballot_from_xdr(b)


def hasprepared_ballot(ballot: Ballot, st) -> bool:
    """Does this statement *accept* ballot as prepared?
    (ref hasPreparedBallot)."""
    t = pledge_type(st)
    p = st.pledges.value
    if t == ST_PREPARE:
        return (
            (p.prepared is not None
             and less_and_compatible(ballot, ballot_from_xdr(p.prepared)))
            or (p.preparedPrime is not None
                and less_and_compatible(
                    ballot, ballot_from_xdr(p.preparedPrime)))
        )
    if t == ST_CONFIRM:
        prepared = (p.nPrepared, p.ballot.value)
        return less_and_compatible(ballot, prepared)
    if t == ST_EXTERNALIZE:
        return compatible(ballot, ballot_from_xdr(p.commit))
    return False


def votes_prepare(ballot: Ballot, st) -> bool:
    """Does this statement *vote* prepare(ballot)?  (the voted-predicate in
    attemptAcceptPrepared's federatedAccept)."""
    t = pledge_type(st)
    p = st.pledges.value
    if t == ST_PREPARE:
        return less_and_compatible(ballot, ballot_from_xdr(p.ballot))
    if t == ST_CONFIRM:
        return compatible(ballot, ballot_from_xdr(p.ballot))
    if t == ST_EXTERNALIZE:
        return compatible(ballot, ballot_from_xdr(p.commit))
    return False


def commit_predicate(ballot: Ballot, interval: Tuple[int, int], st) -> bool:
    """Does this statement accept commit over [lo, hi] on ballot.value?
    (ref commitPredicate)."""
    t = pledge_type(st)
    p = st.pledges.value
    lo, hi = interval
    if t == ST_PREPARE:
        return False
    if t == ST_CONFIRM:
        if compatible(ballot, ballot_from_xdr(p.ballot)):
            return p.nCommit <= lo and hi <= p.nH
        return False
    if t == ST_EXTERNALIZE:
        if compatible(ballot, ballot_from_xdr(p.commit)):
            return p.commit.counter <= lo
        return False
    return False


def votes_commit(ballot: Ballot, interval: Tuple[int, int], st) -> bool:
    """Vote-or-accept commit over [lo, hi] (the voted-predicate in
    attemptAcceptCommit)."""
    t = pledge_type(st)
    p = st.pledges.value
    lo, hi = interval
    if t == ST_PREPARE:
        if compatible(ballot, ballot_from_xdr(p.ballot)) and p.nC != 0:
            return p.nC <= lo and hi <= p.nH
        return False
    if t == ST_CONFIRM:
        if compatible(ballot, ballot_from_xdr(p.ballot)):
            return p.nCommit <= lo
        return False
    if t == ST_EXTERNALIZE:
        if compatible(ballot, ballot_from_xdr(p.commit)):
            return p.commit.counter <= lo
        return False
    return False


def is_ballot_sane(st, self_: bool) -> bool:
    """Structural sanity of a ballot statement (ref isStatementSane, minus
    the qset checks which the Slot performs)."""
    t = pledge_type(st)
    p = st.pledges.value
    if t == ST_PREPARE:
        ok = self_ or p.ballot.counter > 0
        if p.prepared is not None and p.preparedPrime is not None:
            ok = ok and less_and_incompatible(
                ballot_from_xdr(p.preparedPrime), ballot_from_xdr(p.prepared))
        ok = ok and (
            p.nH == 0 or (p.prepared is not None
                          and p.nH <= p.prepared.counter))
        ok = ok and (
            p.nC == 0 or (p.nH != 0 and p.ballot.counter >= p.nH
                          and p.nH >= p.nC))
        return ok
    if t == ST_CONFIRM:
        return (p.ballot.counter > 0 and p.nH <= p.ballot.counter
                and p.nCommit <= p.nH)
    if t == ST_EXTERNALIZE:
        return p.commit.counter > 0 and p.nH >= p.commit.counter
    return False


def nomination_values(st) -> List[bytes]:
    nom = st.pledges.value
    return list(nom.votes) + list(nom.accepted)


def is_nomination_sane(st) -> bool:
    """votes/accepted strictly sorted (unique), at least one value
    (ref NominationProtocol::isSane)."""
    nom = st.pledges.value

    def sorted_unique(xs):
        return all(xs[i] < xs[i + 1] for i in range(len(xs) - 1))

    return (
        (len(nom.votes) + len(nom.accepted) > 0)
        and sorted_unique(list(nom.votes))
        and sorted_unique(list(nom.accepted))
    )


def is_newer_nomination(old_nom, new_nom) -> bool:
    """new grows votes/accepted as supersets with at least one strictly
    (ref isNewerStatement(SCPNomination); both sorted)."""

    def is_subset(a, b) -> Tuple[bool, bool]:
        # returns (a ⊆ b, a == b); inputs sorted unique
        sa, sb = set(a), set(b)
        return sa <= sb, sa == sb

    votes_sub, votes_eq = is_subset(list(old_nom.votes), list(new_nom.votes))
    acc_sub, acc_eq = is_subset(list(old_nom.accepted),
                                list(new_nom.accepted))
    if votes_sub and acc_sub:
        return not (votes_eq and acc_eq)
    return False
