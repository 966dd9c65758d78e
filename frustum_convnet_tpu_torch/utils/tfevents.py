"""Dependency-free TensorBoard event-file writer.

Replaces the reference's TF1 ``tf.summary.FileWriter`` wrapper
(reference `utils/logger.py:12-72`) without importing TensorFlow:
scalar ``Event`` protos are hand-encoded (the wire format of
``tensorflow/core/util/event.proto`` — three fields and a nested
``Summary.Value`` is all scalars need) and framed as TFRecords
(length + masked-crc32c framing). Output is readable by stock
TensorBoard; ``tests/test_logger.py`` round-trips files through
``tensorboard``'s own ``EventFileLoader``.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table.append(crc)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def encode_scalar_event(tag: str, value: float, step: int,
                        wall_time: float) -> bytes:
    # Summary.Value { tag = 1 (string); simple_value = 2 (float) }
    val = (_field_bytes(1, tag.encode("utf-8"))
           + _varint((2 << 3) | 5) + struct.pack("<f", value))
    summary = _field_bytes(1, val)  # Summary.value = 1 (repeated message)
    # Event { wall_time = 1 (double); step = 2 (int64); summary = 5 }
    return (_varint((1 << 3) | 1) + struct.pack("<d", wall_time)
            + _varint(2 << 3) + _varint(step)
            + _field_bytes(5, summary))


def _event_shell(wall_time: float, step: int, summary: bytes) -> bytes:
    # Event { wall_time = 1 (double); step = 2 (int64); summary = 5 }
    return (_varint((1 << 3) | 1) + struct.pack("<d", wall_time)
            + _varint(2 << 3) + _varint(step)
            + _field_bytes(5, summary))


def encode_png(img) -> bytes:
    """Minimal PNG encoder (8-bit gray/RGB/RGBA, no filtering).

    Replaces the reference's ``scipy.misc.toimage(img).save(..., 'png')``
    (reference `utils/logger.py:24-43`) without PIL/scipy: float
    inputs are min-max scaled to uint8 like ``toimage``'s default."""
    import zlib

    import numpy as np

    img = np.asarray(img)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        img = ((img - lo) * scale).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(typ: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + typ + data
                + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def encode_image_event(tag: str, img, step: int, wall_time: float) -> bytes:
    """Summary.Value{tag, image=Summary.Image{h, w, colorspace, png bytes}}."""
    import numpy as np

    arr = np.asarray(img)
    h, w = arr.shape[:2]
    c = 1 if arr.ndim == 2 else arr.shape[2]
    # Summary.Image { height=1, width=2, colorspace=3, encoded_image_string=4 }
    image = (_varint(1 << 3) + _varint(h)
             + _varint(2 << 3) + _varint(w)
             + _varint(3 << 3) + _varint(c)
             + _field_bytes(4, encode_png(arr)))
    val = _field_bytes(1, tag.encode("utf-8")) + _field_bytes(4, image)
    return _event_shell(wall_time, step, _field_bytes(1, val))


def encode_histogram_event(tag: str, values, step: int, wall_time: float,
                           bins: int = 1000) -> bytes:
    """Summary.Value{tag, histo=HistogramProto} — same numpy histogram
    construction as the reference (`utils/logger.py:46-72`): ``bins`` equal
    bins, first bin edge dropped."""
    import numpy as np

    values = np.asarray(values, dtype=np.float64).reshape(-1)
    counts, bin_edges = np.histogram(values, bins=bins)

    def dbl(num: int, x: float) -> bytes:
        return _varint((num << 3) | 1) + struct.pack("<d", float(x))

    def packed_dbl(num: int, xs) -> bytes:
        return _field_bytes(num, b"".join(struct.pack("<d", float(x))
                                          for x in xs))

    # HistogramProto { min=1 max=2 num=3 sum=4 sum_squares=5 (doubles);
    #                  bucket_limit=6 bucket=7 (packed repeated double) }
    hist = (dbl(1, values.min()) + dbl(2, values.max())
            + dbl(3, values.size) + dbl(4, values.sum())
            + dbl(5, np.square(values).sum())
            + packed_dbl(6, bin_edges[1:]) + packed_dbl(7, counts))
    val = _field_bytes(1, tag.encode("utf-8")) + _field_bytes(5, hist)
    return _event_shell(wall_time, step, _field_bytes(1, val))


def encode_file_version_event(wall_time: float) -> bytes:
    # Event { wall_time = 1; file_version = 3 (string) }
    return (_varint((1 << 3) | 1) + struct.pack("<d", wall_time)
            + _field_bytes(3, b"brain.Event:2"))


def tfrecord_frame(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class TFEventWriter:
    """Writes ``events.out.tfevents.*`` files TensorBoard can load."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        host = socket.gethostname()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{now:.6f}.{host}")
        self._f = open(self.path, "ab")
        self._f.write(tfrecord_frame(encode_file_version_event(now)))

    def scalar(self, tag: str, value: float, step: int,
               wall_time: float | None = None):
        wt = time.time() if wall_time is None else wall_time
        self._f.write(tfrecord_frame(
            encode_scalar_event(tag, float(value), int(step), wt)))

    def image(self, tag: str, img, step: int,
              wall_time: float | None = None):
        """One image (H, W[, C]) uint8 or float (min-max scaled)."""
        wt = time.time() if wall_time is None else wall_time
        self._f.write(tfrecord_frame(
            encode_image_event(tag, img, int(step), wt)))

    def histogram(self, tag: str, values, step: int, bins: int = 1000,
                  wall_time: float | None = None):
        wt = time.time() if wall_time is None else wall_time
        self._f.write(tfrecord_frame(
            encode_histogram_event(tag, values, int(step), wt, bins=bins)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
