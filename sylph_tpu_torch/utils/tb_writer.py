"""Minimal TensorBoard scalar event writer, no TF dependency (the port's
own copy of sylph_tpu/utils/tb_writer.py, plus ``write_eval_results_tb``
from sylph_tpu/utils/events.py).

The reference logs training scalars through d2go's TensorBoard writers;
this emits real ``events.out.tfevents.*`` files readable by TensorBoard
using hand-rolled protobuf + TFRecord framing:

  record  = len(8B LE) | masked_crc32c(len) | payload | masked_crc32c(payload)
  payload = Event proto { wall_time=1(double), step=2(int64),
                          summary=5 { value=1 { tag=1(str),
                                                simple_value=2(float) } } }

crc32c is the Castagnoli polynomial (table-driven), masked per the
TFRecord spec: ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff.
"""

from __future__ import annotations

import os
import socket
import struct
import time
import math
from typing import Dict, Optional

_CRC_TABLE = []


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # reversed Castagnoli
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _str_field(field: int, s: str) -> bytes:
    raw = s.encode()
    return _tag(field, 2) + _varint(len(raw)) + raw


def _bytes_field(field: int, raw: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(raw)) + raw


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(step: int, tag: str, value: float,
                  wall_time: Optional[float] = None) -> bytes:
    summary_value = _str_field(1, tag) + _float_field(2, float(value))
    summary = _bytes_field(1, summary_value)
    return (_double_field(1, wall_time or time.time())
            + _int64_field(2, int(step))
            + _bytes_field(5, summary))


def _file_version_event() -> bytes:
    return _double_field(1, time.time()) + _str_field(3, "brain.Event:2")


class TBEventWriter:
    """Append-only scalar event file: ``add_scalars(step, {tag: val})``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write(_file_version_event())

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, step: int, tag: str, value: float) -> None:
        self._write(_scalar_event(step, tag, value))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        for tag, v in scalars.items():
            self.add_scalar(step, tag, v)
        # flush per write batch: TB should see data during the run, and
        # a crashed job must not lose all scalars (metrics.json flushes
        # the same way)
        self._f.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def write_eval_results_tb(results: Dict[str, Dict], output_dir: str,
                          step: int = 0) -> None:
    """Flatten ``do_test`` results into TensorBoard scalars under
    ``{output_dir}/tb``: ``{dataset}/{task}/{metric}``, and for repeated
    seeds also ``{dataset}/bbox/run{i}/{metric}`` (reference
    meta_fcos_runner.py:614-671). Non-finite values are skipped; nothing
    is written when ``output_dir`` is empty."""
    if not output_dir:
        return
    scalars: Dict[str, float] = {}

    def put(tag, v):
        if isinstance(v, (int, float)) and math.isfinite(float(v)):
            scalars[tag] = float(v)

    for ds, res in results.items():
        if not isinstance(res, dict):
            continue
        for task, metrics in res.items():
            if task == "runs" and isinstance(metrics, list):
                for i, run in enumerate(metrics):
                    for k, v in run.items():
                        put(f"{ds}/bbox/run{i}/{k}", v)
            elif isinstance(metrics, dict):
                for k, v in metrics.items():
                    put(f"{ds}/{task}/{k}", v)
    tb = TBEventWriter(os.path.join(output_dir, "tb"))
    tb.add_scalars(step, scalars)
    tb.close()
