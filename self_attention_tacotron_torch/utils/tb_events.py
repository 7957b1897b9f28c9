"""TensorBoard event files without TensorFlow: scalars only.

The port's copy of the JAX package's ``utils/tb_events.py``: TFRecord-framed
``Event`` protos carrying ``Summary.Value.simple_value`` scalars, written
with the hand-rolled protobuf wire codec of ``data/tfrecord.py``, so a
training run is viewable with ``tensorboard --logdir <checkpoint-dir>``
(the reference's workflow of watching ``*_with_teacher``).

Wire formats (stable public protos):
* tensorflow/core/util/event.proto       — Event{wall_time=1 double,
  step=2 int64, file_version=3 string, summary=5 Summary}
* tensorflow/core/framework/summary.proto — Summary{value=1 repeated
  Value{tag=1 string, simple_value=2 float}}
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

from ..data.tfrecord import _len_delimited, _tag, _varint, masked_crc32c


def _encode_scalar_summary(scalars: Dict[str, float]) -> bytes:
    values = b""
    for tag, value in scalars.items():
        v = (_len_delimited(1, tag.encode("utf-8"))
             + _tag(2, 5) + struct.pack("<f", float(value)))
        values += _len_delimited(1, v)          # Summary.value (repeated)
    return values


def encode_event(wall_time: float, step: Optional[int] = None,
                 file_version: Optional[str] = None,
                 scalars: Optional[Dict[str, float]] = None) -> bytes:
    msg = _tag(1, 1) + struct.pack("<d", float(wall_time))   # wall_time
    if step is not None:
        msg += _tag(2, 0) + _varint(int(step))               # step
    if file_version is not None:
        msg += _len_delimited(3, file_version.encode("utf-8"))
    if scalars:
        msg += _len_delimited(5, _encode_scalar_summary(scalars))
    return msg


def _frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


class EventWriter:
    """Append-mode TensorBoard event writer for one logdir.

    Creates ``events.out.tfevents.<time>.<hostname>`` on first use and leads
    with the mandatory ``file_version`` event (``brain.Event:2``).
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        name = f"events.out.tfevents.{now:.6f}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._f.write(_frame(encode_event(now, file_version="brain.Event:2")))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None) -> None:
        wall_time = time.time() if wall_time is None else wall_time
        self._f.write(_frame(encode_event(wall_time, step=step,
                                          scalars=scalars)))
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------------------------- decode

def read_events(path: str):
    """Parse an event file back into dicts: wall time, step, file version
    and scalars, as TensorBoard's loader reads them."""
    from ..data.tfrecord import _read_varint, read_records
    for payload in read_records(path):
        event = {"scalars": {}}
        pos = 0
        while pos < len(payload):
            tag, pos = _read_varint(payload, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 1:
                (val,) = struct.unpack("<d", payload[pos:pos + 8])
                pos += 8
                if field == 1:
                    event["wall_time"] = val
            elif wire == 0:
                val, pos = _read_varint(payload, pos)
                if field == 2:
                    event["step"] = val
            elif wire == 2:
                length, pos = _read_varint(payload, pos)
                msg = payload[pos:pos + length]
                pos += length
                if field == 3:
                    event["file_version"] = msg.decode("utf-8")
                elif field == 5:
                    mpos = 0
                    while mpos < len(msg):
                        mtag, mpos = _read_varint(msg, mpos)
                        mlen, mpos = _read_varint(msg, mpos)
                        value = msg[mpos:mpos + mlen]
                        mpos += mlen
                        if mtag >> 3 != 1:
                            continue
                        vpos, vtag_name, vval = 0, None, None
                        while vpos < len(value):
                            vtag, vpos = _read_varint(value, vpos)
                            if vtag & 7 == 2:
                                vlen, vpos = _read_varint(value, vpos)
                                data = value[vpos:vpos + vlen]
                                vpos += vlen
                                if vtag >> 3 == 1:
                                    vtag_name = data.decode("utf-8")
                            elif vtag & 7 == 5:
                                (vval,) = struct.unpack(
                                    "<f", value[vpos:vpos + 4])
                                vpos += 4
                            else:
                                _, vpos = _read_varint(value, vpos)
                        if vtag_name is not None and vval is not None:
                            event["scalars"][vtag_name] = vval
            else:
                raise ValueError(f"unexpected wire type {wire}")
        yield event
