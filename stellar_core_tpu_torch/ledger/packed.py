"""Lazy packed-XDR ledger values: the delta-merge-from-packed-form tier.

The native apply kernel (native/apply_kernel.cpp) returns entry deltas
and meta/result payloads as CANONICAL XDR BYTES.  Decoding them back
into combinator values on the close thread would hand the GIL right
back the cost the kernel just removed — and the close path mostly does
not need the decoded form: the SQL commit, the bucket batch and the
tx-history rows all re-ENCODE.

These wrappers make the bytes first-class citizens of the existing
object model instead:

- ``PackedEntry`` subclasses the runtime's ``_StructValue`` and seeds
  the ``_xdr_enc`` memo that ``LedgerEntry.memoize`` already consults —
  both the Python packer and the native xdrpack C walker short-circuit
  on it, so ``T.LedgerEntry.encode(packed_entry)`` is a dict hit, zero
  decode.  Field access (``entry.data.value`` in the entry cache, the
  offers SQL index, invariants) decodes once, on demand, and the value
  then behaves exactly like any decoded entry (``_replace`` included).
- ``LazyUnion`` does the same for union values (``TransactionMeta``,
  ``TransactionResult``): the ``_enc`` slot memo serves memoized
  encodes byte-for-byte; the discriminant/arm materialize lazily when
  something actually walks the value (the ledger-close meta stream).

Both resolve to ordinary runtime values on first touch, so equality,
repr and isinstance checks all behave; the laziness is an encoding
fast path, never an observable state.

Since the kernel went credit-complete (ISSUE 13), its deltas carry
trustline entries in every liability shape the kernel models — ext v0,
ext v1 (liabilities) and ext v1+v2 (liquidityPoolUseCount) — plus
created/erased trustlines; all of them ride this tier unchanged
because the wrappers are shape-agnostic: the packed bytes ARE the
value, and the decode (when an invariant or the SQL index touches one)
goes through the ordinary ``T.LedgerEntry`` combinator.
"""
from __future__ import annotations

from ..xdr import types as T
from ..xdr.runtime import _StructValue, _UnionValue


class PackedEntry(_StructValue):
    """A ``LedgerEntry`` carried as its canonical encoding; decodes on
    first field access, encodes by memo hit."""

    def __init__(self, packed: bytes):
        # no _StructValue.__init__: the only eager state is the encode
        # memo the (native and Python) packers already know how to use
        self.__dict__["_xdr_enc"] = (T.LedgerEntry, packed)

    @property
    def packed(self) -> bytes:
        return self.__dict__["_xdr_enc"][1]

    def _materialize(self):
        v = T.LedgerEntry.decode(self.__dict__["_xdr_enc"][1])
        object.__setattr__(self, "_fields", v._fields)
        d = self.__dict__
        for name, val in v.__dict__.items():
            d.setdefault(name, val)
        return self

    def __getattr__(self, name):
        # only reached when normal lookup fails: the un-materialized
        # state.  Dunder probes (copy/pickle/inspect) must not decode.
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        self._materialize()
        try:
            return object.__getattribute__(self, name)
        except AttributeError:
            raise AttributeError(name) from None


class LazyUnion(_UnionValue):
    """A union value (e.g. ``TransactionMeta``) carried as its
    canonical encoding.  The ``_enc`` memo slot is pre-seeded so
    memoized encodes never decode; ``type``/``value``/``arm``
    materialize lazily for consumers that walk the value."""

    __slots__ = ("_lazy",)

    def __init__(self, union_type, packed: bytes):
        # no _UnionValue.__init__: type/value/arm slots stay unset until
        # someone reads them (slot AttributeError routes to __getattr__)
        self._lazy = (union_type, packed)
        self._enc = (union_type, packed)

    @property
    def packed(self) -> bytes:
        return object.__getattribute__(self, "_lazy")[1]

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        union_type, packed = object.__getattribute__(self, "_lazy")
        v = union_type.decode(packed)
        object.__setattr__(self, "type", v.type)
        object.__setattr__(self, "value", v.value)
        object.__setattr__(self, "arm", v.arm)
        try:
            return object.__getattribute__(self, name)
        except AttributeError:
            raise AttributeError(name) from None


def entry_type_from_key(kb: bytes) -> int:
    """LedgerEntryType from an encoded LedgerKey: the union discriminant
    leads the encoding, so the type never needs the entry decoded."""
    return int.from_bytes(kb[:4], "big")
