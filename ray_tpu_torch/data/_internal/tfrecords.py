"""TFRecord framing + a minimal tf.train.Example codec (no TensorFlow).

Parity: python/ray/data/_internal/datasource/tfrecords_datasource.py —
the reference decodes TFRecord files into one column per Example
feature. The wire format is:

    per record: [8B LE length][4B masked crc32c(length)]
                [data][4B masked crc32c(data)]

and `data` is usually a serialized tf.train.Example protobuf:

    Example    { Features features = 1; }
    Features   { map<string, Feature> feature = 1; }
    Feature    { oneof { BytesList=1; FloatList=2; Int64List=3 } }
    BytesList  { repeated bytes value = 1; }
    FloatList  { repeated float value = 1 [packed]; }
    Int64List  { repeated int64 value = 1 [packed]; }

Both directions are implemented directly against that fixed schema —
a handful of varint/tag cases — because protobuf/tensorflow are not
runtime dependencies of this framework.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

# ---------------------------------------------------------------- crc32c
# Castagnoli polynomial (reversed): the CRC TFRecord uses, NOT zlib's.
_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15 | c << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- framing
def read_records(path: str, *, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads. Length CRCs are always checked (they
    guard the framing); data CRCs only with verify_crc (linear cost)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", head[:8])
            (len_crc,) = struct.unpack("<I", head[8:12])
            if _masked_crc(head[:8]) != len_crc:
                raise ValueError(f"corrupt TFRecord length crc in {path}")
            data = f.read(length)
            foot = f.read(4)
            if len(data) < length or len(foot) < 4:
                raise ValueError(f"truncated TFRecord payload in {path}")
            if verify_crc:
                (data_crc,) = struct.unpack("<I", foot)
                if _masked_crc(data) != data_crc:
                    raise ValueError(f"corrupt TFRecord data crc in {path}")
            yield data


def write_records(path: str, records: Iterator[bytes]) -> None:
    with open(path, "wb") as f:
        for rec in records:
            head = struct.pack("<Q", len(rec))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))


# -------------------------------------------------------- proto helpers
def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message buffer.
    value is bytes for length-delimited, int for varint, raw for
    fixed32/64."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v, pos = _read_varint(buf, pos)
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            v = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:  # fixed64
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _decode_feature(buf: bytes) -> Any:
    """Feature -> python value (singletons unwrap like the reference)."""
    for field, wt, v in _iter_fields(buf):
        if field == 1:  # BytesList
            vals = [bv for f2, _, bv in _iter_fields(v) if f2 == 1]
            return vals[0] if len(vals) == 1 else vals
        if field == 2:  # FloatList (packed or repeated fixed32)
            vals: List[float] = []
            for f2, wt2, fv in _iter_fields(v):
                if f2 != 1:
                    continue
                if wt2 == 2:  # packed
                    vals.extend(
                        struct.unpack(f"<{len(fv) // 4}f", fv)
                    )
                else:
                    vals.append(struct.unpack("<f", fv)[0])
            return vals[0] if len(vals) == 1 else vals
        if field == 3:  # Int64List (packed or repeated varint)
            vals = []
            for f2, wt2, iv in _iter_fields(v):
                if f2 != 1:
                    continue
                if wt2 == 2:  # packed
                    pos = 0
                    while pos < len(iv):
                        x, pos = _read_varint(iv, pos)
                        vals.append(_to_signed64(x))
                else:
                    vals.append(_to_signed64(iv))
            return vals[0] if len(vals) == 1 else vals
    return None


def _to_signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def decode_example(record: bytes) -> Dict[str, Any]:
    """Serialized tf.train.Example -> {feature_name: value}."""
    row: Dict[str, Any] = {}
    for field, _, v in _iter_fields(record):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(v):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            feat = None
            for f3, _, ev in _iter_fields(entry):
                if f3 == 1:
                    key = ev.decode()
                elif f3 == 2:
                    feat = ev
            if key is not None:
                row[key] = _decode_feature(feat) if feat is not None else None
    return row


def _ld(out: bytearray, field: int, payload: bytes) -> None:
    _write_varint(out, field << 3 | 2)
    _write_varint(out, len(payload))
    out += payload


def encode_example(row: Dict[str, Any]) -> bytes:
    """{name: value} -> serialized tf.train.Example. bytes/str ->
    BytesList, float -> FloatList, int/bool -> Int64List; lists of the
    same follow their element type."""
    features = bytearray()
    for key, value in row.items():
        vals = value if isinstance(value, (list, tuple)) else [value]
        try:
            import numpy as np

            if isinstance(value, np.ndarray):
                vals = value.tolist()
            vals = [
                v.item() if isinstance(v, np.generic) else v for v in vals
            ]
        except ImportError:  # pragma: no cover
            pass
        kind = bytearray()
        if all(isinstance(v, (bytes, str)) for v in vals):
            blist = bytearray()
            for v in vals:
                _ld(blist, 1, v.encode() if isinstance(v, str) else v)
            _ld(kind, 1, bytes(blist))  # Feature.bytes_list
        elif all(isinstance(v, bool) or isinstance(v, int) for v in vals):
            packed = bytearray()
            for v in vals:
                _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
            ilist = bytearray()
            _ld(ilist, 1, bytes(packed))
            _ld(kind, 3, bytes(ilist))  # Feature.int64_list
        elif all(isinstance(v, (int, float)) for v in vals):
            packed = b"".join(struct.pack("<f", float(v)) for v in vals)
            flist = bytearray()
            _ld(flist, 1, packed)
            _ld(kind, 2, bytes(flist))  # Feature.float_list
        else:
            raise TypeError(
                f"feature {key!r} has unsupported value type for "
                f"tf.train.Example: {type(vals[0]).__name__}"
            )
        entry = bytearray()
        _ld(entry, 1, key.encode())
        _ld(entry, 2, bytes(kind))
        # map<string, Feature> == repeated field-1 map-entry messages
        _ld(features, 1, bytes(entry))
    example = bytearray()
    _ld(example, 1, bytes(features))
    return bytes(example)
