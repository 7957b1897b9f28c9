"""Dependency-free TFRecord + tf.train.Example codec.

The reference stores every utterance as a single-record TFRecord file holding
one ``tf.train.Example`` (reference: utils/tfrecord.py:46-48), read back with
``tf.data.TFRecordDataset`` + ``tf.parse_single_example``.  This module
implements the same container natively:

* TFRecord framing: u64le length, masked crc32c(length), payload,
  masked crc32c(payload).
* A minimal protobuf wire codec for the ``Example`` message tree
  (Features map of BytesList / FloatList / Int64List).

The checksum is the C++ one of ``native/`` (``native_reader.py``, built
at first use) wherever a C++ compiler is found, else the pure-Python
table (``crc32c_python``, the reference the tests hold the native one
to); the first checksum logs which one serves, and why when it is not the
native one.  The C++ reader of whole files is ``native_reader.
read_examples_native``; this module is the portable reference and the
writer.
"""

from __future__ import annotations

import logging
import struct
from typing import Callable, Dict, Iterator, List, Optional, Union

log = logging.getLogger(__name__)

# ------------------------------------------------------------------- crc32c

_CRC32C_POLY = 0x82F63B78


def _make_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC32C_POLY if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _make_table()


def crc32c_python(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)) & 0xFFFFFFFF
    return crc ^ 0xFFFFFFFF


_crc32c: Optional[Callable[[bytes], int]] = None


def checksum_in_use() -> str:
    """``native`` or ``python``: which crc32c serves this process (logged
    once, with the reason when it is not the native one)."""
    global _crc32c
    if _crc32c is None:
        from . import native_reader
        reason = native_reader.unavailable_reason()
        if reason is None:
            _crc32c = native_reader.crc32c_native
            log.info("TFRecord checksum: native crc32c (%s)",
                     native_reader.library_path().name)
        else:
            _crc32c = crc32c_python
            log.warning("TFRecord checksum: pure-Python crc32c (%s)", reason)
    return "python" if _crc32c is crc32c_python else "native"


def crc32c(data: bytes) -> int:
    if _crc32c is None:
        checksum_in_use()
    return _crc32c(data)


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# -------------------------------------------------------------- record layer

def write_records(records: List[bytes], path: str) -> None:
    with open(path, "wb") as f:
        for payload in records:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(header) != hcrc:
                raise IOError(f"corrupt TFRecord header in {path}")
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(payload) != pcrc:
                raise IOError(f"corrupt TFRecord payload in {path}")
            yield payload


# ------------------------------------------------------------ protobuf wire

def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's complement, 10 bytes
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int):
    shift = 0
    result = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


FeatureValue = Union[List[bytes], List[int], List[float]]


def encode_feature(value: FeatureValue, kind: str) -> bytes:
    """kind: 'bytes' | 'int64' | 'float'."""
    if kind == "bytes":
        inner = b"".join(_len_delimited(1, v) for v in value)
        return _len_delimited(1, inner)  # Feature.bytes_list = 1
    if kind == "float":
        packed = struct.pack(f"<{len(value)}f", *value)
        inner = _len_delimited(1, packed)
        return _len_delimited(2, inner)  # Feature.float_list = 2
    if kind == "int64":
        packed = b"".join(_varint(int(v)) for v in value)
        inner = _len_delimited(1, packed)
        return _len_delimited(3, inner)  # Feature.int64_list = 3
    raise ValueError(kind)


def encode_example(features: Dict[str, tuple]) -> bytes:
    """``features``: name -> (kind, list-of-values).  Returns a serialized
    ``tf.train.Example``."""
    entries = []
    for name, (kind, value) in features.items():
        entry = (_len_delimited(1, name.encode("utf-8"))
                 + _len_delimited(2, encode_feature(value, kind)))
        entries.append(_len_delimited(1, entry))  # Features.feature map entry
    features_msg = b"".join(entries)
    return _len_delimited(1, features_msg)  # Example.features = 1


def _decode_feature(buf: bytes):
    pos = 0
    kind, values = None, []
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire != 2:
            raise ValueError(f"unexpected wire type {wire} in Feature")
        length, pos = _read_varint(buf, pos)
        inner = buf[pos:pos + length]
        pos += length
        if field == 1:  # BytesList
            kind = "bytes"
            ipos = 0
            while ipos < len(inner):
                itag, ipos = _read_varint(inner, ipos)
                ilen, ipos = _read_varint(inner, ipos)
                values.append(inner[ipos:ipos + ilen])
                ipos += ilen
        elif field == 2:  # FloatList
            kind = "float"
            ipos = 0
            while ipos < len(inner):
                itag, ipos = _read_varint(inner, ipos)
                if itag & 7 == 2:  # packed
                    ilen, ipos = _read_varint(inner, ipos)
                    values.extend(struct.unpack(f"<{ilen // 4}f",
                                                inner[ipos:ipos + ilen]))
                    ipos += ilen
                else:  # unpacked fixed32
                    values.append(struct.unpack("<f", inner[ipos:ipos + 4])[0])
                    ipos += 4
        elif field == 3:  # Int64List
            kind = "int64"
            ipos = 0
            while ipos < len(inner):
                itag, ipos = _read_varint(inner, ipos)
                if itag & 7 == 2:  # packed
                    ilen, ipos = _read_varint(inner, ipos)
                    end = ipos + ilen
                    while ipos < end:
                        v, ipos = _read_varint(inner, ipos)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        values.append(v)
                else:
                    v, ipos = _read_varint(inner, ipos)
                    if v >= 1 << 63:
                        v -= 1 << 64
                    values.append(v)
    return kind, values


def decode_example(payload: bytes) -> Dict[str, tuple]:
    """Serialized Example -> {name: (kind, values)}."""
    pos = 0
    features: Dict[str, tuple] = {}
    while pos < len(payload):
        tag, pos = _read_varint(payload, pos)
        field, wire = tag >> 3, tag & 7
        length, pos = _read_varint(payload, pos)
        msg = payload[pos:pos + length]
        pos += length
        if field != 1:
            continue  # skip unknown Example fields
        mpos = 0
        while mpos < len(msg):
            mtag, mpos = _read_varint(msg, mpos)
            mlen, mpos = _read_varint(msg, mpos)
            entry = msg[mpos:mpos + mlen]
            mpos += mlen
            # map entry: key (1, string), value (2, Feature)
            epos = 0
            name, feat = None, None
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                elen, epos = _read_varint(entry, epos)
                data = entry[epos:epos + elen]
                epos += elen
                if etag >> 3 == 1:
                    name = data.decode("utf-8")
                elif etag >> 3 == 2:
                    feat = _decode_feature(data)
            if name is not None and feat is not None:
                features[name] = feat
    return features


def write_example(features: Dict[str, tuple], path: str) -> None:
    """Write a single-Example TFRecord file (reference: utils/tfrecord.py:46)."""
    write_records([encode_example(features)], path)


def read_examples(path: str) -> Iterator[Dict[str, tuple]]:
    for payload in read_records(path):
        yield decode_example(payload)


# --------------------------------------------------------- feature shorthands

def bytes_feature(values: List[bytes]):
    return ("bytes", list(values))


def int64_feature(values: List[int]):
    return ("int64", [int(v) for v in values])


def float_feature(values: List[float]):
    return ("float", [float(v) for v in values])
