"""Dependency-free PNG writer: 8-bit and 16-bit RGB(A) with metadata chunks
(the port's copy of the writer half of ``fractalrenderer_tpu/utils/png.py``;
the reader and the parallel-deflate writer are not ported yet).

Replaces the reference's stb_image_write 8-bit path (src/vk_engine.cpp:33-34,
src/animation_renderer.cpp:13) and the libpng 16-bit print-export path with
gAMA / sRGB / pHYs(DPI) / tEXt / tIME chunks (src/vk_engine.cpp:2106-2223).
Images arrive as host numpy arrays: callers fetch device tensors first.
"""
from __future__ import annotations

import struct
import time
import zlib
from typing import BinaryIO, Dict, Optional

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _ihdr(width: int, height: int, bit_depth: int, color_type: int) -> bytes:
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, bit_depth,
                                       color_type, 0, 0, 0))


def _text_chunks(metadata: Optional[Dict[str, str]]) -> bytes:
    if not metadata:
        return b""
    out = b""
    for key, value in metadata.items():
        k = key.encode("latin-1", "replace")[:79]
        v = str(value).encode("latin-1", "replace")
        out += _chunk(b"tEXt", k + b"\x00" + v)
    return out


def _time_chunk(t: Optional[float] = None) -> bytes:
    tm = time.gmtime(t)
    return _chunk(b"tIME", struct.pack(">HBBBBB", tm.tm_year, tm.tm_mon,
                                       tm.tm_mday, tm.tm_hour, tm.tm_min,
                                       tm.tm_sec))


def _phys_chunk(dpi: float) -> bytes:
    ppm = int(dpi / 0.0254 + 0.5)  # vk_engine.cpp:2149-2152
    return _chunk(b"pHYs", struct.pack(">IIB", ppm, ppm, 1))


def _prepare_rows(image: np.ndarray, bit_depth: int) -> np.ndarray:
    """Convert an image array to the raw byte matrix (one row per scanline,
    no filter byte yet).  Accepts f32 [0,1], uint8, or uint16."""
    if image.ndim == 2:
        image = image[:, :, None]
    if image.dtype in (np.float32, np.float64):
        image = np.clip(image, 0.0, 1.0)
        if bit_depth == 8:
            image = (image * 255.0 + 0.5).astype(np.uint8)
        else:
            image = (image * 65535.0 + 0.5).astype(np.uint16)
    if bit_depth == 8:
        data = np.ascontiguousarray(image.astype(np.uint8, copy=False))
        return data.reshape(data.shape[0], -1)
    data = np.ascontiguousarray(
        image.astype(np.uint16, copy=False)).byteswap()  # big-endian
    return data.view(np.uint8).reshape(data.shape[0], -1)


class PNGWriter:
    """Streaming PNG writer — rows may be fed in bands."""

    def __init__(self, fp: BinaryIO, width: int, height: int,
                 bit_depth: int = 8, channels: int = 3,
                 metadata: Optional[Dict[str, str]] = None,
                 dpi: Optional[float] = None, srgb: bool = True,
                 compress_level: int = 6):
        if bit_depth not in (8, 16):
            raise ValueError(f"bit_depth must be 8 or 16, got {bit_depth}")
        if channels not in (1, 3, 4):
            raise ValueError(f"channels must be 1, 3 or 4, got {channels}")
        self.fp = fp
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self.channels = channels
        self._rows_written = 0
        color_type = {1: 0, 3: 2, 4: 6}[channels]
        fp.write(_SIG)
        fp.write(_ihdr(width, height, bit_depth, color_type))
        if srgb:
            # gAMA 1/2.2 + sRGB perceptual intent (vk_engine.cpp:2144-2146)
            fp.write(_chunk(b"gAMA", struct.pack(">I", int(100000 / 2.2))))
            fp.write(_chunk(b"sRGB", b"\x00"))
        if dpi is not None:
            fp.write(_phys_chunk(dpi))
        fp.write(_text_chunks(metadata))
        fp.write(_time_chunk())
        self._comp = zlib.compressobj(compress_level)

    def write_rows(self, band: np.ndarray) -> None:
        rows = _prepare_rows(band, self.bit_depth)
        expected = self.width * self.channels * (self.bit_depth // 8)
        if rows.shape[1] != expected:
            raise ValueError(
                f"band row size {rows.shape[1]} != expected {expected}")
        # Filter type 0 (None) per scanline.
        filtered = np.concatenate(
            [np.zeros((rows.shape[0], 1), np.uint8), rows], axis=1)
        payload = self._comp.compress(filtered.tobytes())
        if payload:
            self.fp.write(_chunk(b"IDAT", payload))
        self._rows_written += rows.shape[0]

    def close(self) -> None:
        if self._rows_written != self.height:
            raise ValueError(
                f"wrote {self._rows_written} rows, expected {self.height}")
        tail = self._comp.flush()
        if tail:
            self.fp.write(_chunk(b"IDAT", tail))
        self.fp.write(_chunk(b"IEND", b""))

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()


def write_png(path: str, image: np.ndarray, bit_depth: int = 8,
              metadata: Optional[Dict[str, str]] = None,
              dpi: Optional[float] = None, srgb: bool = True,
              compress_level: int = 6) -> None:
    """One-shot write of an (H, W, C) image (f32 in [0,1], uint8 or uint16)."""
    image = np.asarray(image)
    channels = 1 if image.ndim == 2 else image.shape[2]
    with open(path, "wb") as fp:
        with PNGWriter(fp, image.shape[1], image.shape[0], bit_depth,
                       channels, metadata, dpi, srgb, compress_level) as w:
            w.write_rows(image)


def encode_png(image: np.ndarray, bit_depth: int = 8,
               metadata: Optional[Dict[str, str]] = None,
               srgb: bool = True, compress_level: int = 1) -> bytes:
    """In-memory PNG encode of an (H, W, C) image."""
    import io

    image = np.asarray(image)
    channels = 1 if image.ndim == 2 else image.shape[2]
    buf = io.BytesIO()
    with PNGWriter(buf, image.shape[1], image.shape[0], bit_depth,
                   channels, metadata, None, srgb, compress_level) as w:
        w.write_rows(image)
    return buf.getvalue()
