"""The program messages of ``framework.proto`` and their proto2 wire
format, written and read without a protobuf runtime.

``ProgramDesc``, ``BlockDesc``, ``VarDesc``, ``OpDesc`` (with
``OpDesc.Var`` and ``OpDesc.Attr``) behave as far as the framework uses
them like the generated ``framework_pb2`` classes of the JAX package: a
field reads its default until set, ``HasField`` tells a set optional
field from an unset one, repeated fields are lists,
``SerializeToString()`` writes bytes and ``ParseFromString()`` reads
them. The bytes are the ones ``framework_pb2`` writes for the same
message, so a ``__model__`` written by either package loads in the
other:

- fields in field-number order, a set optional field and every required
  one written, an unset optional field not (``EncodeError`` for an unset
  required field, as protobuf raises);
- repeated scalars unpacked (proto2): one tag an element;
- ``int32``, ``int64``, ``bool`` and enums as varints, a negative integer
  as its 64-bit two's complement (ten bytes); ``float`` as fixed32,
  ``double`` as fixed64; strings as UTF-8.

The decoder, as protobuf's does, accepts packed repeated scalars too,
skips fields it does not know (and a known field on another wire type),
lets the last value of a repeated optional scalar win, and leaves a
missing required field at its default. It raises ``DecodeError`` on
truncated or malformed input and never returns part of a message.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

# AttrType
INT, FLOAT, STRING, INTS, FLOATS, STRINGS = 0, 1, 2, 3, 4, 5
BOOLEAN, BOOLEANS, BLOCK, LONG, BLOCKS, LONGS, FLOAT64 = 6, 7, 8, 9, 10, 11, 12


class DecodeError(ValueError):
    """Bytes that are not a well-formed message."""


class EncodeError(ValueError):
    """A message that cannot be written (an unset required field, a value
    outside its field's range)."""


_REQUIRED, _OPTIONAL, _REPEATED = "required", "optional", "repeated"
# wire types
_VARINT, _I64, _LEN, _SGROUP, _EGROUP, _I32 = 0, 1, 2, 3, 4, 5
_WIRE = {"int32": _VARINT, "int64": _VARINT, "bool": _VARINT,
         "enum": _VARINT, "float": _I32, "double": _I64, "string": _LEN}
_RANGE = {"int32": (-(1 << 31), (1 << 31) - 1),
          "enum": (-(1 << 31), (1 << 31) - 1),
          "int64": (-(1 << 63), (1 << 63) - 1)}
_MASK64 = (1 << 64) - 1


class _Field:
    __slots__ = ("number", "name", "kind", "label", "default")

    def __init__(self, number, name, kind, label=_OPTIONAL, default=None):
        self.number, self.name, self.kind = number, name, kind
        self.label = label
        if default is None and label != _REPEATED and isinstance(kind, str):
            default = {"string": "", "bool": False, "float": 0.0,
                       "double": 0.0}.get(kind, 0)
        self.default = default

    @property
    def wire_type(self) -> int:
        return _LEN if not isinstance(self.kind, str) else _WIRE[self.kind]


class _Message:
    """A message: ``_FIELDS`` in field-number order; values in
    ``_values`` (an unset optional field is absent)."""

    __slots__ = ("_values",)
    _FIELDS: Tuple[_Field, ...] = ()
    _BY_NAME: Dict[str, _Field] = {}
    _BY_NUMBER: Dict[int, _Field] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._FIELDS = tuple(sorted(cls._FIELDS, key=lambda f: f.number))
        cls._BY_NAME = {f.name: f for f in cls._FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls._FIELDS}

    def __init__(self, **values):
        object.__setattr__(self, "_values", {})
        for k, v in values.items():
            setattr(self, k, v)

    def __getattr__(self, name):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no field '{name}'")
        if f.label == _REPEATED:
            return self._values.setdefault(name, [])
        return self._values.get(name, f.default)

    def __setattr__(self, name, value):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no field '{name}'")
        self._values[name] = list(value) if f.label == _REPEATED else value

    def HasField(self, name: str) -> bool:
        f = type(self)._BY_NAME[name]
        if f.label == _REPEATED:
            raise ValueError(f"HasField on repeated field '{name}'")
        return name in self._values

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return all(getattr(self, f.name) == getattr(other, f.name)
                   and (f.label == _REPEATED
                        or self.HasField(f.name) == other.HasField(f.name))
                   for f in self._FIELDS)

    def __repr__(self):
        set_ = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"{type(self).__name__}({set_})"

    # --- the wire format ---

    def SerializeToString(self) -> bytes:
        out = bytearray()
        _encode(self, out)
        return bytes(out)

    def ParseFromString(self, data: bytes) -> int:
        """Replace this message's fields with those of ``data``; returns
        the number of bytes read, as protobuf does."""
        view = memoryview(bytes(data))
        parsed = type(self)()
        _decode(parsed, view, 0, len(view))
        object.__setattr__(self, "_values", parsed._values)
        return len(view)

    @classmethod
    def FromString(cls, data: bytes) -> "_Message":
        m = cls()
        m.ParseFromString(data)
        return m


# --- encoding ---


def _varint(v: int, out: bytearray):
    v &= _MASK64
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _scalar_bytes(f: _Field, v, out: bytearray):
    kind = f.kind
    if kind == "string":
        b = v.encode("utf-8")
        _varint(len(b), out)
        out += b
    elif kind == "bool":
        out.append(1 if v else 0)
    elif kind == "float":
        with np.errstate(over="ignore"):
            out += np.float32(v).tobytes()
    elif kind == "double":
        out += struct.pack("<d", float(v))
    else:
        v = int(v)
        lo, hi = _RANGE[kind]
        if not lo <= v <= hi:
            raise EncodeError(f"field '{f.name}': {v} is outside {kind}")
        _varint(v, out)


def _encode(msg: _Message, out: bytearray):
    for f in msg._FIELDS:
        if f.label == _REPEATED:
            values = msg._values.get(f.name, ())
        elif f.name in msg._values:
            values = (msg._values[f.name],)
        elif f.label == _REQUIRED:
            raise EncodeError(f"{type(msg).__name__} is missing required "
                              f"field '{f.name}'")
        else:
            continue
        for v in values:
            _varint((f.number << 3) | f.wire_type, out)
            if isinstance(f.kind, str):
                _scalar_bytes(f, v, out)
            else:
                sub = bytearray()
                _encode(v, sub)
                _varint(len(sub), out)
                out += sub


# --- decoding ---


def _read_varint(buf: memoryview, pos: int, end: int) -> Tuple[int, int]:
    v = shift = 0
    for i in range(10):
        if pos >= end:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v & _MASK64, pos
        shift += 7
    raise DecodeError("varint longer than ten bytes")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _from_varint(kind: str, v: int):
    if kind == "bool":
        return v != 0
    if kind == "int64":
        return _signed(v, 64)
    return _signed(v, 32)  # int32, enum


def _take(buf: memoryview, pos: int, n: int, end: int) -> int:
    if n < 0 or pos + n > end:
        raise DecodeError("truncated field")
    return pos + n


def _skip(buf: memoryview, pos: int, end: int, wt: int, number: int) -> int:
    """Skip one unknown field's value (a group up to its end tag)."""
    if wt == _VARINT:
        return _read_varint(buf, pos, end)[1]
    if wt == _I64:
        return _take(buf, pos, 8, end)
    if wt == _I32:
        return _take(buf, pos, 4, end)
    if wt == _LEN:
        n, pos = _read_varint(buf, pos, end)
        return _take(buf, pos, n, end)
    if wt == _SGROUP:
        while True:
            key, pos = _read_varint(buf, pos, end)
            if key & 7 == _EGROUP:
                if key >> 3 != number:
                    raise DecodeError("mismatched end-group tag")
                return pos
            pos = _skip(buf, pos, end, key & 7, key >> 3)
    raise DecodeError(f"invalid wire type {wt}")


def _read_scalar(kind: str, buf: memoryview, pos: int, end: int):
    if kind in ("int32", "int64", "bool", "enum"):
        v, pos = _read_varint(buf, pos, end)
        return _from_varint(kind, v), pos
    if kind == "float":
        new = _take(buf, pos, 4, end)
        return struct.unpack_from("<f", buf, pos)[0], new
    if kind == "double":
        new = _take(buf, pos, 8, end)
        return struct.unpack_from("<d", buf, pos)[0], new
    n, pos = _read_varint(buf, pos, end)  # string
    new = _take(buf, pos, n, end)
    try:
        return bytes(buf[pos:new]).decode("utf-8"), new
    except UnicodeDecodeError as e:
        raise DecodeError(f"string field is not UTF-8: {e}") from None


def _decode(msg: _Message, buf: memoryview, pos: int, end: int):
    values = msg._values
    while pos < end:
        key, pos = _read_varint(buf, pos, end)
        number, wt = key >> 3, key & 7
        if number == 0:
            raise DecodeError("field number 0")
        f = msg._BY_NUMBER.get(number)
        scalar = f is not None and isinstance(f.kind, str)
        if f is not None and wt == f.wire_type:
            if scalar:
                v, pos = _read_scalar(f.kind, buf, pos, end)
            else:
                n, pos = _read_varint(buf, pos, end)
                stop = _take(buf, pos, n, end)
                v = f.kind()
                _decode(v, buf, pos, stop)
                pos = stop
            if f.label == _REPEATED:
                values.setdefault(f.name, []).append(v)
            else:
                values[f.name] = v
        elif (scalar and f.label == _REPEATED and wt == _LEN
              and f.kind != "string"):
            # a packed run of a repeated scalar
            n, pos = _read_varint(buf, pos, end)
            stop = _take(buf, pos, n, end)
            items = values.setdefault(f.name, [])
            while pos < stop:
                v, pos = _read_scalar(f.kind, buf, pos, stop)
                items.append(v)
        else:
            if wt == _EGROUP:
                raise DecodeError("unexpected end-group tag")
            pos = _skip(buf, pos, end, wt, number)
    if pos != end:
        raise DecodeError("field runs past the end of its message")


# --- the messages of framework.proto ---


class _OpVar(_Message):
    _FIELDS = (_Field(1, "parameter", "string", _REQUIRED),
               _Field(2, "arguments", "string", _REPEATED))


class _OpAttr(_Message):
    _FIELDS = (
        _Field(1, "name", "string", _REQUIRED),
        _Field(2, "type", "enum", _REQUIRED),
        _Field(3, "i", "int32"),
        _Field(4, "f", "float"),
        _Field(5, "s", "string"),
        _Field(6, "ints", "int32", _REPEATED),
        _Field(7, "floats", "float", _REPEATED),
        _Field(8, "strings", "string", _REPEATED),
        _Field(9, "b", "bool"),
        _Field(10, "bools", "bool", _REPEATED),
        _Field(11, "block_idx", "int32"),
        _Field(12, "l", "int64"),
        _Field(13, "blocks_idx", "int32", _REPEATED),
        _Field(14, "longs", "int64", _REPEATED),
        _Field(15, "float64", "double"),
    )


class OpDesc(_Message):
    Var = _OpVar
    Attr = _OpAttr
    _FIELDS = (_Field(1, "type", "string", _REQUIRED),
               _Field(2, "inputs", _OpVar, _REPEATED),
               _Field(3, "outputs", _OpVar, _REPEATED),
               _Field(4, "attrs", _OpAttr, _REPEATED))


_OpVar.__name__ = _OpVar.__qualname__ = "OpDesc.Var"
_OpAttr.__name__ = _OpAttr.__qualname__ = "OpDesc.Attr"


class VarDesc(_Message):
    # VarKind
    DENSE_TENSOR, SELECTED_ROWS, READER, STEP_SCOPES, RAW = 0, 1, 2, 3, 4
    _FIELDS = (
        _Field(1, "name", "string", _REQUIRED),
        _Field(2, "kind", "enum", default=0),
        _Field(3, "dtype", "string"),
        _Field(4, "shape", "int64", _REPEATED),
        _Field(5, "persistable", "bool"),
        _Field(6, "stop_gradient", "bool"),
        _Field(7, "is_parameter", "bool"),
        _Field(8, "trainable", "bool", default=True),
    )


class BlockDesc(_Message):
    _FIELDS = (_Field(1, "idx", "int32", _REQUIRED),
               _Field(2, "parent_idx", "int32", _REQUIRED),
               _Field(3, "vars", VarDesc, _REPEATED),
               _Field(4, "ops", OpDesc, _REPEATED))


class ProgramDesc(_Message):
    _FIELDS = (_Field(1, "blocks", BlockDesc, _REPEATED),
               _Field(2, "version", "int64"),
               _Field(3, "random_seed", "int64"))

