"""The port's PNG parallel writer and reader (``utils/png.py``) against the
JAX package's on the same seed-made bands and bytes.

The parallel writer's file is the JAX writer's byte for byte, tIME aside
(one zlib header, the full-flushed raw-deflate chunks, the final empty
block and the adler32), in 8 and 16 bits (big-endian); its IDAT stream
inflates to the plain writer's scanlines.  ``_unfilter`` decodes filter
types 0-4 through the native library and through the NumPy loops, equal
to the JAX ``_unfilter``; ``read_png`` decodes what the JAX ``read_png``
decodes; a truncated, foreign or unknown-filter stream raises.
"""
import io
import struct
import zlib

import numpy as np
import pytest

from fractalrenderer_tpu.utils import png as jax_png
from fractalrenderer_tpu_torch.utils import png


def _chunks(data: bytes):
    """[(tag, payload)] of a PNG file, signature checked."""
    assert data[:8] == png._SIG
    out, pos = [], 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        out.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]))
        pos += 12 + length
    return out


def _without_time(data: bytes):
    return [c for c in _chunks(data) if c[0] != b"tIME"]


def _bands(rng, bit_depth, width, splits):
    hi = 255 if bit_depth == 8 else 65535
    dt = np.uint8 if bit_depth == 8 else np.uint16
    return [rng.integers(0, hi + 1, (rows, width, 3)).astype(dt)
            for rows in splits]


def _write(module, bands, bit_depth, width, level):
    buf = io.BytesIO()
    height = sum(b.shape[0] for b in bands)
    with module.ParallelPNGWriter(buf, width, height, bit_depth=bit_depth,
                                  channels=3, metadata={"Software": "t"},
                                  dpi=300.0, compress_level=level) as w:
        for b in bands:
            raw = module.band_raw_bytes(b, bit_depth)
            w.write_deflated(b.shape[0], module.deflate_chunk(raw, level),
                             raw)
    return buf.getvalue()


@pytest.mark.parametrize("bit_depth", [8, 16])
@pytest.mark.parametrize("splits", [(24,), (7, 16, 1)], ids=["one", "three"])
@pytest.mark.parametrize("level", [1, 3])
def test_parallel_writer_bytes_equal_jax(bit_depth, splits, level):
    rng = np.random.default_rng(20261017 + bit_depth + len(splits))
    bands = _bands(rng, bit_depth, 40, splits)
    mine = _write(png, bands, bit_depth, 40, level)
    theirs = _write(jax_png, bands, bit_depth, 40, level)
    assert _without_time(mine) == _without_time(theirs)
    # the IDAT stream is one zlib stream of the filter-0 scanlines, 16-bit
    # samples big-endian
    idat = b"".join(p for t, p in _chunks(mine) if t == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        sum(splits), -1)
    assert (rows[:, 0] == 0).all()
    img = np.concatenate(bands)
    want = (img.astype(">u2").view(np.uint8) if bit_depth == 16
            else img).reshape(sum(splits), -1)
    np.testing.assert_array_equal(rows[:, 1:], want)


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_band_raw_bytes_and_deflate_chunk_equal_jax(bit_depth):
    rng = np.random.default_rng(7 + bit_depth)
    band, = _bands(rng, bit_depth, 33, (5,))
    raw = png.band_raw_bytes(band, bit_depth)
    assert raw == jax_png.band_raw_bytes(band, bit_depth)
    assert len(raw) == 5 * (1 + 33 * 3 * bit_depth // 8)
    for level in (1, 6):
        chunk = png.deflate_chunk(raw, level)
        assert chunk == jax_png.deflate_chunk(raw, level)
        # full flush: the chunk ends in an empty stored block
        assert chunk.endswith(b"\x00\x00\xff\xff")


def test_parallel_write_rows_equals_jax():
    rng = np.random.default_rng(11)
    bands = _bands(rng, 16, 20, (6, 6))
    buf = io.BytesIO()
    with png.ParallelPNGWriter(buf, 20, 12, bit_depth=16) as w:
        for b in bands:
            w.write_rows(b)
    theirs = io.BytesIO()
    with jax_png.ParallelPNGWriter(theirs, 20, 12, bit_depth=16) as w:
        for b in bands:
            w.write_rows(b)
    assert _without_time(buf.getvalue()) == _without_time(theirs.getvalue())


def test_parallel_writer_refuses_a_short_image():
    buf = io.BytesIO()
    w = png.ParallelPNGWriter(buf, 8, 4, bit_depth=8)
    raw = png.band_raw_bytes(np.zeros((3, 8, 3), np.uint8), 8)
    w.write_deflated(3, png.deflate_chunk(raw), raw)
    with pytest.raises(ValueError, match="wrote 3 rows, expected 4"):
        w.close()


def _filtered_stream(rng, height, stride):
    """Seeded filtered scanlines: each row a random filter type 0-4 (every
    type present) and random bytes."""
    ftypes = np.concatenate([np.arange(5), rng.integers(0, 5, height - 5)])
    lines = rng.integers(0, 256, (height, stride + 1)).astype(np.uint8)
    lines[:, 0] = ftypes
    return lines.tobytes()


@pytest.mark.parametrize("bpp", [1, 3, 6, 8])
def test_unfilter_native_and_numpy_equal_jax(bpp, monkeypatch):
    rng = np.random.default_rng(100 + bpp)
    height, stride = 12, 7 * bpp
    raw = _filtered_stream(rng, height, stride)
    want = jax_png._unfilter(raw, height, stride, bpp)
    native = png._load_pngfilter()
    assert native is not None, "native/libpngfilter did not build"
    np.testing.assert_array_equal(png._unfilter(raw, height, stride, bpp),
                                  want)
    monkeypatch.setattr(png, "_load_pngfilter", lambda: None)
    np.testing.assert_array_equal(png._unfilter(raw, height, stride, bpp),
                                  want)


def _png_file(path, raw, width, height, bit_depth, color_type):
    with open(path, "wb") as f:
        f.write(png._SIG)
        f.write(png._ihdr(width, height, bit_depth, color_type))
        z = zlib.compress(raw)
        # two IDAT chunks: the reader joins them
        f.write(png._chunk(b"IDAT", z[:len(z) // 2]))
        f.write(png._chunk(b"IDAT", z[len(z) // 2:]))
        f.write(png._chunk(b"IEND", b""))


@pytest.mark.parametrize("bit_depth,color_type", [
    (8, 0), (8, 2), (8, 6), (16, 2), (16, 6)])
def test_read_png_equals_jax_on_every_filter(tmp_path, bit_depth,
                                             color_type):
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    bpp = channels * bit_depth // 8
    width, height = 9, 10
    rng = np.random.default_rng(bit_depth * 10 + color_type)
    raw = _filtered_stream(rng, height, width * bpp)
    path = str(tmp_path / "f.png")
    _png_file(path, raw, width, height, bit_depth, color_type)
    img = png.read_png(path)
    want = jax_png.read_png(path)
    assert img.dtype == want.dtype == (np.uint8 if bit_depth == 8
                                       else np.uint16)
    assert img.shape == (height, width, channels)
    np.testing.assert_array_equal(img, want)


@pytest.mark.parametrize("bit_depth", [8, 16])
def test_read_png_reads_the_parallel_writer(tmp_path, bit_depth):
    rng = np.random.default_rng(5)
    bands = _bands(rng, bit_depth, 17, (4, 9))
    path = tmp_path / "p.png"
    path.write_bytes(_write(png, bands, bit_depth, 17, 3))
    np.testing.assert_array_equal(png.read_png(str(path)),
                                  np.concatenate(bands))


def test_truncated_or_foreign_files_raise(tmp_path, monkeypatch):
    good = tmp_path / "g.png"
    png.write_png(str(good), np.full((6, 5, 3), 7, np.uint8))
    data = good.read_bytes()
    foreign = tmp_path / "foreign.png"
    foreign.write_bytes(b"GIF89a" + data[6:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(str(foreign))
    cut = tmp_path / "cut.png"
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises((ValueError, zlib.error, TypeError, KeyError)):
        png.read_png(str(cut))
    with pytest.raises(ValueError, match="truncated"):
        png._unfilter(b"\x00" * 10, 4, 5, 1)
    bad = bytearray(_filtered_stream(np.random.default_rng(0), 6, 4))
    bad[0] = 5  # no such filter type
    with pytest.raises(ValueError, match="filter"):
        png._unfilter(bytes(bad), 6, 4, 1)  # native
    monkeypatch.setattr(png, "_load_pngfilter", lambda: None)
    with pytest.raises(ValueError, match="filter"):
        png._unfilter(bytes(bad), 6, 4, 1)  # NumPy
