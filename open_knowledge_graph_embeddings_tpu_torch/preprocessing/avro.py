"""Self-contained Avro Object Container File reader/writer.

The OPIEC corpus ships as Avro container files
(reference: preprocessing/process_avro.py:221-288 reads them with the
``avro`` package).  The port needs neither ``avro`` nor ``fastavro``: it
carries its own implementation of the Avro 1.11 specification (a copy of
``open_knowledge_graph_embeddings_tpu/preprocessing/avro.py``, writing the
same bytes) — binary encoding (zigzag varints, length-prefixed
bytes/strings, blocked arrays/maps, unions by branch index) and the object
container framing (magic ``Obj\\x01``, file-metadata map with the embedded
writer schema, 16-byte sync markers, null/deflate codecs).

Scope: everything OPIEC-Clean needs — records, arrays, maps, unions,
enums, fixed, all primitives, named-type references — decoded with the
file's embedded writer schema (no reader-schema resolution, which the
reference doesn't use either).  The writer exists to build test fixtures
and roundtrip checks; it writes codec ``null``.
"""

from __future__ import annotations

import io
import json
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Sequence, Tuple

MAGIC = b"Obj\x01"
SYNC_SIZE = 16

_PRIMITIVES = ("null", "boolean", "int", "long", "float", "double", "bytes", "string")


# ----------------------------------------------------------------- decoding


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return out

    def read_long(self) -> int:
        """Zigzag-encoded variable-length integer (int and long alike)."""
        shift = 0
        accum = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            accum |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (accum >> 1) ^ -(accum & 1)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())


def _decode(r: _Reader, schema: Any, names: Dict[str, Any]) -> Any:
    if isinstance(schema, str):
        if schema in _PRIMITIVES:
            if schema == "null":
                return None
            if schema == "boolean":
                return r.read(1) != b"\x00"
            if schema in ("int", "long"):
                return r.read_long()
            if schema == "float":
                return struct.unpack("<f", r.read(4))[0]
            if schema == "double":
                return struct.unpack("<d", r.read(8))[0]
            if schema == "bytes":
                return r.read_bytes()
            return r.read_bytes().decode("utf-8")  # string
        return _decode(r, names[schema], names)  # named-type reference
    if isinstance(schema, list):  # union: long branch index + value
        return _decode(r, schema[r.read_long()], names)
    t = schema["type"]
    if t in _PRIMITIVES or isinstance(t, (list, dict)):
        # e.g. {"type": "string"} wrapper or nested complex in "type"
        if t in _PRIMITIVES:
            return _decode(r, t, names)
        return _decode(r, t, names)
    if t == "record":
        return {f["name"]: _decode(r, f["type"], names) for f in schema["fields"]}
    if t == "enum":
        return schema["symbols"][r.read_long()]
    if t == "fixed":
        return r.read(schema["size"])
    if t == "array":
        out: List[Any] = []
        while True:
            n = r.read_long()
            if n == 0:
                break
            if n < 0:
                n = -n
                r.read_long()  # block byte size, unused
            for _ in range(n):
                out.append(_decode(r, schema["items"], names))
        return out
    if t == "map":
        m: Dict[str, Any] = {}
        while True:
            n = r.read_long()
            if n == 0:
                break
            if n < 0:
                n = -n
                r.read_long()
            for _ in range(n):
                key = r.read_bytes().decode("utf-8")
                m[key] = _decode(r, schema["values"], names)
        return m
    raise ValueError(f"unsupported avro schema {schema!r}")


def _register_names(schema: Any, names: Dict[str, Any], namespace: str = "") -> None:
    if isinstance(schema, list):
        for s in schema:
            _register_names(s, names, namespace)
        return
    if not isinstance(schema, dict):
        return
    t = schema.get("type")
    ns = schema.get("namespace", namespace)
    if t in ("record", "enum", "fixed"):
        name = schema["name"]
        full = name if "." in name or not ns else f"{ns}.{name}"
        names[full] = schema
        names[name] = schema
    if t == "record":
        for f in schema["fields"]:
            _register_names(f["type"], names, ns)
    elif t == "array":
        _register_names(schema.get("items"), names, ns)
    elif t == "map":
        _register_names(schema.get("values"), names, ns)


def reader(f: BinaryIO) -> Iterator[Any]:
    """Iterate the records of an Avro Object Container File (the fastavro
    ``reader`` surface that preprocessing/corpus.py consumes)."""
    header = f.read()
    r = _Reader(header)
    if r.read(4) != MAGIC:
        raise ValueError("not an avro object container file (bad magic)")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.read_long()
        if n == 0:
            break
        if n < 0:
            n = -n
            r.read_long()
        for _ in range(n):
            key = r.read_bytes().decode("utf-8")
            meta[key] = r.read_bytes()
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    sync = r.read(SYNC_SIZE)
    names: Dict[str, Any] = {}
    _register_names(schema, names)
    while r.pos < len(r.buf):
        count = r.read_long()
        size = r.read_long()
        payload = r.read(size)
        if codec == "deflate":
            payload = zlib.decompress(payload, -15)
        block = _Reader(payload)
        for _ in range(count):
            yield _decode(block, schema, names)
        if r.read(SYNC_SIZE) != sync:
            raise ValueError("avro sync marker mismatch (corrupt block)")


# ----------------------------------------------------------------- encoding


def _zigzag(value: int) -> bytes:
    accum = (value << 1) ^ (value >> 63) if value < 0 else value << 1
    out = bytearray()
    while True:
        b = accum & 0x7F
        accum >>= 7
        if accum:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode(w: io.BytesIO, schema: Any, value: Any, names: Dict[str, Any]) -> None:
    if isinstance(schema, str):
        if schema == "null":
            return
        if schema == "boolean":
            w.write(b"\x01" if value else b"\x00")
        elif schema in ("int", "long"):
            w.write(_zigzag(int(value)))
        elif schema == "float":
            w.write(struct.pack("<f", value))
        elif schema == "double":
            w.write(struct.pack("<d", value))
        elif schema == "bytes":
            w.write(_zigzag(len(value)))
            w.write(value)
        elif schema == "string":
            raw = value.encode("utf-8")
            w.write(_zigzag(len(raw)))
            w.write(raw)
        else:
            _encode(w, names[schema], value, names)
        return
    if isinstance(schema, list):  # union: pick the first matching branch
        for i, branch in enumerate(schema):
            if _matches(branch, value, names):
                w.write(_zigzag(i))
                _encode(w, branch, value, names)
                return
        raise ValueError(f"value {value!r} matches no branch of union {schema!r}")
    t = schema["type"]
    if t == "record":
        for f in schema["fields"]:
            _encode(w, f["type"], value[f["name"]], names)
    elif t == "enum":
        w.write(_zigzag(schema["symbols"].index(value)))
    elif t == "fixed":
        assert len(value) == schema["size"]
        w.write(value)
    elif t == "array":
        if value:
            w.write(_zigzag(len(value)))
            for item in value:
                _encode(w, schema["items"], item, names)
        w.write(_zigzag(0))
    elif t == "map":
        if value:
            w.write(_zigzag(len(value)))
            for k, v in value.items():
                raw = k.encode("utf-8")
                w.write(_zigzag(len(raw)))
                w.write(raw)
                _encode(w, schema["values"], v, names)
        w.write(_zigzag(0))
    else:
        _encode(w, t, value, names)


def _matches(schema: Any, value: Any, names: Dict[str, Any]) -> bool:
    if isinstance(schema, str):
        if schema == "null":
            return value is None
        if schema == "boolean":
            return isinstance(value, bool)
        if schema in ("int", "long"):
            return isinstance(value, int) and not isinstance(value, bool)
        if schema in ("float", "double"):
            return isinstance(value, float)
        if schema == "bytes":
            return isinstance(value, bytes)
        if schema == "string":
            return isinstance(value, str)
        return _matches(names[schema], value, names)
    if isinstance(schema, list):
        return any(_matches(b, value, names) for b in schema)
    t = schema["type"]
    if t in ("record", "map"):
        return isinstance(value, dict)
    if t == "array":
        return isinstance(value, list)
    if t == "enum":
        return isinstance(value, str) and value in schema["symbols"]
    if t == "fixed":
        return isinstance(value, bytes)
    return _matches(t, value, names)


def writer(
    f: BinaryIO,
    schema: Any,
    records: Sequence[Any],
    sync_marker: Optional[bytes] = None,
    records_per_block: int = 1000,
) -> None:
    """Write an Avro Object Container File (codec ``null``).

    ``sync_marker`` can be pinned for byte-reproducible fixture files."""
    sync = sync_marker or b"\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x0a\x0b\x0c\x0d\x0e\x0f"
    assert len(sync) == SYNC_SIZE
    names: Dict[str, Any] = {}
    _register_names(schema, names)
    f.write(MAGIC)
    meta: List[Tuple[str, bytes]] = [
        ("avro.schema", json.dumps(schema).encode("utf-8")),
        ("avro.codec", b"null"),
    ]
    f.write(_zigzag(len(meta)))
    for k, v in meta:
        raw = k.encode("utf-8")
        f.write(_zigzag(len(raw)))
        f.write(raw)
        f.write(_zigzag(len(v)))
        f.write(v)
    f.write(_zigzag(0))
    f.write(sync)
    for start in range(0, len(records), records_per_block):
        chunk = records[start : start + records_per_block]
        buf = io.BytesIO()
        for rec in chunk:
            _encode(buf, schema, rec, names)
        payload = buf.getvalue()
        f.write(_zigzag(len(chunk)))
        f.write(_zigzag(len(payload)))
        f.write(payload)
        f.write(sync)
