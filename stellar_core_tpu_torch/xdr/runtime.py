"""XDR (RFC 4506) runtime: declarative type combinators.

The reference generates C++ codecs from the protocol ``.x`` files with
xdrpp's ``xdrc`` (ref src/Makefile.am:42-47); XDR is the wire *and*
canonical-hash format for everything (ref docs/architecture.md:52-54).
This module is the equivalent runtime, redesigned for Python: declarative
combinator objects with ``pack``/``unpack``, over which
``stellar_core_tpu_torch.xdr.types`` declares the protocol schema.

Canonicality matters: every codec here round-trips to the unique canonical
byte form (big-endian, 4-byte alignment, zero padding), so
``sha256(pack(x))`` is usable as an object id exactly like the reference's
``xdrSha256`` (ref src/crypto/SHA.h).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional as Opt, Sequence, Tuple


class XdrError(Exception):
    pass


# Wire-facing decode depth bound.  Legitimate protocol structures nest
# single digits deep (quorum sets are validity-bounded at 4); the guard
# exists to turn adversarial nesting into XdrError.  It must trip well
# before CPython's recursion limit does — each XDR level costs ~6
# interpreter frames, so 100 levels stays comfortably inside the default
# 1000-frame limit even under pytest's extra stack.
MAX_DECODE_DEPTH = 100


class Reader:
    __slots__ = ("data", "pos", "depth")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.depth = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise XdrError("short read")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def enter(self) -> None:
        """Depth guard for recursive types: adversarial deeply-nested
        payloads (e.g. a 400-level SCPQuorumSet) must fail with XdrError,
        not escape as RecursionError."""
        self.depth += 1
        if self.depth > MAX_DECODE_DEPTH:
            raise XdrError("max decode depth exceeded")

    def leave(self) -> None:
        self.depth -= 1

    def done(self) -> bool:
        return self.pos == len(self.data)


class XdrType:
    """Base combinator. pack(value) -> bytes parts appended to out list."""

    def pack(self, v, out: List[bytes]) -> None:
        raise NotImplementedError

    def unpack(self, r: Reader):
        raise NotImplementedError

    def encode(self, v) -> bytes:
        out: List[bytes] = []
        self.pack(v, out)
        return b"".join(out)

    def decode(self, data: bytes, allow_trailing: bool = False):
        r = Reader(data)
        v = self.unpack(r)
        if not allow_trailing and not r.done():
            raise XdrError("trailing bytes")
        return v

    def default(self):
        """The C++ default-constructed value of this type (ints/enums 0,
        arrays empty, unions on arm 0) — what the reference's XDR result
        fields hold before anything assigns them."""
        raise NotImplementedError(type(self).__name__)


def _pad(n: int) -> bytes:
    return b"\x00" * ((4 - n % 4) % 4)


class _IntBase(XdrType):
    fmt = ">i"
    lo, hi = -(2**31), 2**31 - 1

    def pack(self, v, out):
        if not (self.lo <= v <= self.hi):
            raise XdrError(f"{v} out of range for {type(self).__name__}")
        out.append(struct.pack(self.fmt, v))

    def unpack(self, r):
        return struct.unpack(self.fmt, r.take(struct.calcsize(self.fmt)))[0]

    def default(self):
        return 0


class IntType(_IntBase):
    pass


class UintType(_IntBase):
    fmt = ">I"
    lo, hi = 0, 2**32 - 1


class HyperType(_IntBase):
    fmt = ">q"
    lo, hi = -(2**63), 2**63 - 1


class UhyperType(_IntBase):
    fmt = ">Q"
    lo, hi = 0, 2**64 - 1


Int = IntType()
Uint = UintType()
Hyper = HyperType()
Uhyper = UhyperType()


class BoolType(XdrType):
    def pack(self, v, out):
        out.append(struct.pack(">I", 1 if v else 0))

    def unpack(self, r):
        x = struct.unpack(">I", r.take(4))[0]
        if x not in (0, 1):
            raise XdrError("bad bool")
        return bool(x)

    def default(self):
        return False


Bool = BoolType()


class Opaque(XdrType):
    """Fixed-length opaque[n]."""

    def __init__(self, n: int):
        self.n = n
        self._padding = _pad(n)  # precomputed; b"" when n % 4 == 0

    def pack(self, v, out):
        if len(v) != self.n:
            raise XdrError(f"opaque[{self.n}] got {len(v)} bytes")
        out.append(v if type(v) is bytes else bytes(v))
        if self._padding:
            out.append(self._padding)

    def unpack(self, r):
        v = r.take(self.n)
        pad = r.take((4 - self.n % 4) % 4)
        if pad.strip(b"\x00"):
            raise XdrError("nonzero padding")
        return v

    def default(self):
        return b"\x00" * self.n


class VarOpaque(XdrType):
    """opaque<max>."""

    def __init__(self, max_len: int = 2**32 - 1):
        self.max_len = max_len

    def pack(self, v, out):
        if len(v) > self.max_len:
            raise XdrError("opaque too long")
        out.append(struct.pack(">I", len(v)))
        out.append(bytes(v))
        out.append(_pad(len(v)))

    def unpack(self, r):
        n = struct.unpack(">I", r.take(4))[0]
        if n > self.max_len:
            raise XdrError("opaque too long")
        v = r.take(n)
        pad = r.take((4 - n % 4) % 4)
        if pad.strip(b"\x00"):
            raise XdrError("nonzero padding")
        return v

    def default(self):
        return b""


class XdrStr(VarOpaque):
    """string<max> — kept as bytes (stellar strings are byte-exact)."""


class FixedArray(XdrType):
    def __init__(self, elem: XdrType, n: int):
        self.elem, self.n = elem, n

    def pack(self, v, out):
        if len(v) != self.n:
            raise XdrError("bad array length")
        for e in v:
            self.elem.pack(e, out)

    def unpack(self, r):
        return [self.elem.unpack(r) for _ in range(self.n)]

    def default(self):
        return [self.elem.default() for _ in range(self.n)]


class VarArray(XdrType):
    def __init__(self, elem: XdrType, max_len: int = 2**32 - 1):
        self.elem, self.max_len = elem, max_len

    def pack(self, v, out):
        if len(v) > self.max_len:
            raise XdrError("array too long")
        out.append(struct.pack(">I", len(v)))
        for e in v:
            self.elem.pack(e, out)

    def unpack(self, r):
        n = struct.unpack(">I", r.take(4))[0]
        if n > self.max_len:
            raise XdrError("array too long")
        return [self.elem.unpack(r) for _ in range(n)]

    def default(self):
        return []


class Option(XdrType):
    """T* — XDR optional (bool + value)."""

    def __init__(self, elem: XdrType):
        self.elem = elem

    def pack(self, v, out):
        if v is None:
            out.append(struct.pack(">I", 0))
        else:
            out.append(struct.pack(">I", 1))
            self.elem.pack(v, out)

    def unpack(self, r):
        flag = struct.unpack(">I", r.take(4))[0]
        if flag not in (0, 1):
            raise XdrError("bad optional flag")
        return self.elem.unpack(r) if flag else None

    def default(self):
        return None


class Enum(XdrType):
    """Named int32 with a closed value set."""

    def __init__(self, name: str, values: Dict[str, int]):
        self.name = name
        self.by_name = dict(values)
        self.by_value = {v: k for k, v in values.items()}
        # enum wire bytes precomputed per value (hot: every union disc)
        self._enc = {v: struct.pack(">i", v) for v in self.by_value}
        for k, v in values.items():
            setattr(self, k, v)

    def pack(self, v, out):
        b = self._enc.get(v)
        if b is None:
            raise XdrError(f"bad {self.name} value {v}")
        out.append(b)

    def unpack(self, r):
        v = struct.unpack(">i", r.take(4))[0]
        if v not in self.by_value:
            raise XdrError(f"bad {self.name} value {v}")
        return v

    def nameof(self, v) -> str:
        return self.by_value[v]

    def default(self):
        return 0 if 0 in self.by_value else min(self.by_value)


class _StructValue:
    """Generic record: attribute access + equality + repr."""

    __slots__ = ("_fields", "__dict__")

    def __init__(self, _fields: Sequence[str], **kw):
        self._fields = _fields if type(_fields) is tuple else tuple(_fields)
        d = self.__dict__
        d.update(kw)
        # fast path: fully-specified construction (the hot case — every
        # decode and most make() calls) skips the default-fill scan
        if len(d) != len(self._fields):
            for f in self._fields:
                if f not in d:
                    d[f] = None

    def __eq__(self, other):
        return (
            isinstance(other, _StructValue)
            and self._fields == other._fields
            and all(
                getattr(self, f) == getattr(other, f) for f in self._fields
            )
        )

    def __repr__(self):
        body = ", ".join(f"{f}={getattr(self, f)!r}" for f in self._fields)
        return f"({body})"

    def _replace(self, **kw):
        new = _StructValue.__new__(_StructValue)
        new._fields = self._fields
        new.__dict__.update(self.__dict__)
        new.__dict__.pop("_xdr_enc", None)  # drop any memoized encoding
        new.__dict__.update(kw)
        return new


class Struct(XdrType):
    # memoize=True caches the encoding on the value object itself (under
    # "_xdr_enc" in its __dict__; _replace drops it).  Only safe for types
    # whose values are immutable-by-convention AND reused across encodes —
    # a LedgerEntry flows through tx meta, the bucket list, and the SQL
    # commit in one close, which otherwise encodes it three times.
    memoize = False

    def __init__(self, name: str, fields: Sequence[Tuple[str, XdrType]]):
        self.name = name
        self.fields = list(fields)
        # a shared tuple: _StructValue keeps a reference instead of copying
        self.field_names = tuple(f for f, _ in fields)
        # bound pack methods: the encode hot loop skips attribute dispatch
        self._packers = [(f, t.pack) for f, t in fields]
        self._packfn = None  # compiled on first pack (fields may be
        #                      patched during schema construction)

    def _compile_packfn(self):
        """exec-compile a packer: unrolled field sequence with runs of
        primitive leaves FUSED into single struct.pack calls.  Encoding
        is the close path's hottest loop (meta + bucket + SQL all encode
        LedgerEntries); the fused packer cuts interpreter dispatch ~3x.
        Wire layout identical by construction — struct formats map
        int->'>i', uint->'>I', hyper->'>q', uhyper->'>Q', bool->'>I'."""
        fmt_of = {IntType: "i", UintType: "I", HyperType: "q",
                  UhyperType: "Q", BoolType: "I"}
        ns = {"_sp": struct.pack}
        lines = ["def _packfn(d, out):"]
        run_fmt, run_args = "", []

        def flush():
            nonlocal run_fmt, run_args
            if run_fmt:
                lines.append(
                    f"    out.append(_sp('>{run_fmt}', "
                    f"{', '.join(run_args)}))")
                run_fmt, run_args = "", []

        for i, (fname, ftype) in enumerate(self.fields):
            code = fmt_of.get(type(ftype))
            if code is not None:
                run_fmt += code
                run_args.append(f"d[{fname!r}]")
                continue
            flush()
            ns[f"_p{i}"] = ftype.pack
            lines.append(f"    _p{i}(d[{fname!r}], out)")
        flush()
        if len(lines) == 1:
            lines.append("    pass")
        exec("\n".join(lines), ns)
        self._packfn = ns["_packfn"]
        return self._packfn

    def make(self, **kw):
        unknown = set(kw) - set(self.field_names)
        if unknown:
            raise XdrError(f"{self.name}: unknown fields {unknown}")
        return _StructValue(self.field_names, **kw)

    def default(self):
        return _StructValue(self.field_names,
                            **{f: t.default() for f, t in self.fields})

    def _pack_slow(self, v, out):
        """Per-field fallback with precise error attribution (also covers
        namedtuple-like stand-ins without __dict__)."""
        d = getattr(v, "__dict__", None)
        for fname, fpack in self._packers:
            try:
                fpack(d[fname] if d is not None else getattr(v, fname),
                      out)
            except (KeyError, AttributeError, TypeError, XdrError) as e:
                raise XdrError(f"{self.name}.{fname}: {e}") from e

    def pack(self, v, out):
        d = getattr(v, "__dict__", None)
        if d is None:  # e.g. a namedtuple-like stand-in
            return self._pack_slow(v, out)
        packfn = self._packfn or self._compile_packfn()
        if self.memoize:
            hit = d.get("_xdr_enc")
            if hit is not None and hit[0] is self:
                out.append(hit[1])
                return
            sub: List[bytes] = []
            try:
                packfn(d, sub)
            except Exception:
                sub = []
                self._pack_slow(v, sub)  # re-raise with field context
            enc = b"".join(sub)
            d["_xdr_enc"] = (self, enc)
            out.append(enc)
            return
        n = len(out)
        try:
            packfn(d, out)
        except Exception as e:
            if isinstance(e, XdrError):
                raise
            del out[n:]  # drop partial output before the diagnosing retry
            self._pack_slow(v, out)  # re-raises with field context

    def unpack(self, r):
        kw = {fname: ftype.unpack(r) for fname, ftype in self.fields}
        return _StructValue(self.field_names, **kw)


class _UnionValue:
    __slots__ = ("type", "value", "arm", "_enc")

    def __init__(self, type_, value=None, arm: str = ""):
        self.type = type_
        self.value = value
        self.arm = arm
        self._enc = None  # (union_type, bytes) memo for memoize unions

    def __eq__(self, other):
        return (
            isinstance(other, _UnionValue)
            and self.type == other.type
            and self.value == other.value
        )

    def __repr__(self):
        return f"Union(type={self.type}, {self.arm}={self.value!r})"


class Union(XdrType):
    """Discriminated union.  arms: disc-value -> (arm_name, type|None).

    ``default`` (arm_name, type|None) catches unlisted discriminants.
    """

    def __init__(
        self,
        name: str,
        disc: XdrType,
        arms: Dict[int, Tuple[str, Opt[XdrType]]],
        default: Opt[Tuple[str, Opt[XdrType]]] = None,
    ):
        self.name = name
        self.disc = disc
        self.arms = dict(arms)
        self._default_arm = default

    def _arm(self, d):
        if d in self.arms:
            return self.arms[d]
        if self._default_arm is not None:
            return self._default_arm
        raise XdrError(f"{self.name}: no arm for discriminant {d}")

    def make(self, d, value=None):
        arm_name, _ = self._arm(d)
        return _UnionValue(d, value, arm_name)

    def default_for(self, d):
        """Union set to discriminant ``d`` with a default-constructed arm
        (the reference's ``u.type(d)`` on a fresh XDR union)."""
        arm_name, arm_type = self._arm(d)
        return _UnionValue(
            d, arm_type.default() if arm_type is not None else None,
            arm_name)

    def default(self):
        d = 0 if (0 in self.arms or self._default_arm is not None) else \
            min(self.arms)
        return self.default_for(d)

    memoize = False  # see Struct.memoize

    def pack(self, v, out):
        if self.memoize:
            hit = v._enc
            if hit is not None and hit[0] is self:
                out.append(hit[1])
                return
            sub: List[bytes] = []
            self._pack_inner(v, sub)
            enc = b"".join(sub)
            v._enc = (self, enc)
            out.append(enc)
            return
        self._pack_inner(v, out)

    def _pack_inner(self, v, out):
        self.disc.pack(v.type, out)
        arm_name, arm_type = self._arm(v.type)
        if arm_type is not None:
            try:
                arm_type.pack(v.value, out)
            except XdrError as e:
                raise XdrError(f"{self.name}.{arm_name}: {e}") from e
        elif v.value is not None:
            raise XdrError(f"{self.name}: void arm carries a value")

    def unpack(self, r):
        d = self.disc.unpack(r)
        arm_name, arm_type = self._arm(d)
        value = arm_type.unpack(r) if arm_type is not None else None
        return _UnionValue(d, value, arm_name)


class Lazy(XdrType):
    """Forward reference for recursive types (e.g. SCPQuorumSet)."""

    def __init__(self, thunk: Callable[[], XdrType]):
        self._thunk = thunk
        self._resolved: Opt[XdrType] = None

    def _get(self) -> XdrType:
        if self._resolved is None:
            self._resolved = self._thunk()
        return self._resolved

    def pack(self, v, out):
        self._get().pack(v, out)

    def unpack(self, r):
        r.enter()
        try:
            return self._get().unpack(r)
        finally:
            r.leave()


# -- native encoder wiring (see native/xdr_pack.c) ---------------------------

_native_pack = None
_native_pack_many = None


def _compile_native_schema(roots, build: bool = True) -> None:
    """Flatten every reachable XdrType into the C node table and install
    it.  Each compiled type gets ``_nidx`` (its node index); ``encode``
    then routes through the C packer.  Wire bytes are identical by
    construction; the Python pack tree remains the fallback/oracle."""
    global _native_pack, _native_pack_many
    from ..native import get_xdrpack

    mod = get_xdrpack(build=build)
    if mod is None:
        return
    import sys

    nodes: List[tuple] = []
    index: Dict[int, Tuple[int, XdrType]] = {}

    def compile_type(t) -> int:
        key = id(t)
        if key in index:
            return index[key][0]
        if isinstance(t, Lazy):
            # forward reference: compile the resolved target; shares its
            # node (recursion terminates because the target reserves its
            # slot before compiling children)
            idx = compile_type(t._get())
            index[key] = (idx, t)
            return idx
        idx = len(nodes)
        index[key] = (idx, t)
        nodes.append(None)  # reserve (recursive types)
        memo = None
        if isinstance(t, Struct):
            if t.memoize:
                memo = t
            fields = tuple(
                (sys.intern(f), compile_type(ft)) for f, ft in t.fields)
            nodes[idx] = (7, 0, fields, None, None, -1, None, memo)
        elif isinstance(t, Union):
            if t.memoize:
                memo = t
            arm_map = {}
            for d, (an, at) in t.arms.items():
                arm_map[d] = (1, compile_type(at)) if at is not None \
                    else (0, -1)
            default = None
            if t._default_arm is not None:
                an, at = t._default_arm
                default = (1, compile_type(at)) if at is not None \
                    else (0, -1)
            valid = (frozenset(t.disc.by_value)
                     if isinstance(t.disc, Enum) else None)
            nodes[idx] = (8, 0, None, arm_map, default, -1, valid, memo)
        elif isinstance(t, Enum):
            nodes[idx] = (12, 0, None, None, None, -1,
                          frozenset(t.by_value), None)
        elif isinstance(t, Opaque):
            nodes[idx] = (5, t.n, None, None, None, -1, None, None)
        elif isinstance(t, VarOpaque):  # includes XdrStr
            nodes[idx] = (6, t.max_len, None, None, None, -1, None, None)
        elif isinstance(t, FixedArray):
            nodes[idx] = (9, t.n, None, None, None,
                          compile_type(t.elem), None, None)
        elif isinstance(t, VarArray):
            nodes[idx] = (10, t.max_len, None, None, None,
                          compile_type(t.elem), None, None)
        elif isinstance(t, Option):
            nodes[idx] = (11, 0, None, None, None,
                          compile_type(t.elem), None, None)
        elif isinstance(t, BoolType):
            nodes[idx] = (4, 0, None, None, None, -1, None, None)
        elif isinstance(t, UintType):
            nodes[idx] = (1, 0, None, None, None, -1, None, None)
        elif isinstance(t, UhyperType):
            nodes[idx] = (3, 0, None, None, None, -1, None, None)
        elif isinstance(t, HyperType):
            nodes[idx] = (2, 0, None, None, None, -1, None, None)
        elif isinstance(t, IntType):
            nodes[idx] = (0, 0, None, None, None, -1, None, None)
        else:
            raise TypeError(f"uncompilable XdrType {type(t).__name__}")
        return idx

    for t in roots:
        compile_type(t)
    mod.init_schema(nodes, XdrError)
    for idx, t in index.values():
        t._nidx = idx
    _native_pack = mod.pack
    # older prebuilt .so without the batch entry: encode_many degrades
    _native_pack_many = getattr(mod, "pack_many", None)


def encode_many(pairs):
    """Batch encode ``[(XdrType, value), ...]`` -> ``[bytes, ...]`` in
    ONE native call (xdr_pack.c pack_many: shared arena, GIL-released
    copy-out), or None when the native packer is unavailable — callers
    fall back to per-value ``encode``.  Bytes are identical either way
    (same node table, same packer)."""
    if _native_pack_many is None:
        return None
    items = []
    for t, v in pairs:
        idx = getattr(t, "_nidx", -1)
        if idx < 0:
            return None
        items.append((idx, v))
    return _native_pack_many(items)


def _encode_native(self, v):
    idx = getattr(self, "_nidx", -1)
    if idx >= 0 and _native_pack is not None:
        return _native_pack(idx, v)
    out: List[bytes] = []
    self.pack(v, out)
    return b"".join(out)


def enable_native_encode(module, build: bool = True) -> bool:
    """Compile every XdrType bound in ``module`` (the schema module) into
    the native packer and reroute ``encode``.  ``build=False`` only uses
    an already-built extension (imports stay cheap; Application.start
    retries with build=True).  Safe no-op when unavailable."""
    global _native_pack
    if _native_pack is not None:
        return True
    # vars() order is module definition order (same every process);
    # node indices are process-local and wire bytes are canonical by
    # construction
    # detlint: allow(det-unsorted-iter)
    roots = [t for t in vars(module).values() if isinstance(t, XdrType)]
    try:
        _compile_native_schema(roots, build)
    except Exception:
        _native_pack = None
        return False
    if _native_pack is None:
        return False
    XdrType.encode = _encode_native
    return True
