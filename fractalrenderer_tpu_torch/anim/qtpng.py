"""Dependency-free video container: QuickTime MOV with PNG-coded frames.

The reference can only encode through an external ffmpeg binary and
degrades to nothing without one (video_encoder.cpp:230-238); this muxer
writes a playable, lossless .mov from the rendered PNG sequence in pure
Python — each frame's PNG bytes become one sample of a 'png ' video
track (a standard QuickTime codec; QuickTime/VLC/ffmpeg all read it).

Layout: ftyp + mdat (concatenated PNG frames) + moov (sample tables
pointing into mdat).  Atoms follow the QTFF/ISO-BMFF box grammar:
[u32 size][4cc type][payload].

The PyTorch port's own copy of ``fractalrenderer_tpu/anim/qtpng.py`` (that
package imports jax on import, so the port cannot share it); the two
stay line for line the same below this docstring.
"""
from __future__ import annotations

import os
import struct
from typing import List, Tuple

_TIMESCALE = 60000  # NTSC-friendly: 24/25/30/60 fps all divide evenly


def _atom(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _full(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _atom(tag, struct.pack(">B3s", version,
                                  flags.to_bytes(3, "big")) + payload)


def _png_size(path: str) -> Tuple[int, int]:
    with open(path, "rb") as fh:
        head = fh.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return w, h


def _matrix_identity() -> bytes:
    # 3x3 QT transform: a b u / c d v / x y w (16.16 / 2.30 fixed)
    return struct.pack(">9I", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                       0x40000000)


def _hdlr_data() -> bytes:
    """Data-handler declaration (QT expects one inside minf)."""
    return _full(b"hdlr", 0, 0,
                 b"dhlr" + b"alis" + b"\x00" * 12 + b"\x0bDataHandler")


def write_mov(out_path: str, frame_paths: List[str], fps: float) -> dict:
    """Mux PNG frames into a .mov; returns {frames, width, height,
    duration_s, bytes}."""
    if not frame_paths:
        raise ValueError("no frames to mux")
    width, height = _png_size(frame_paths[0])
    per = max(1, int(round(_TIMESCALE / float(fps))))
    n = len(frame_paths)
    duration = per * n

    ftyp = _atom(b"ftyp", b"qt  " + struct.pack(">I", 0x200) + b"qt  ")

    sizes = []
    offsets = []
    # mdat payload begins after ftyp + mdat header (8 bytes)
    pos = len(ftyp) + 8
    for p in frame_paths:
        sz = os.path.getsize(p)
        sizes.append(sz)
        offsets.append(pos)
        pos += sz
    if pos >= 1 << 32:
        # stco offsets and the mdat size field are 32-bit in this writer
        raise ValueError(
            f"muxed output would be {pos / 2**30:.1f} GiB — past the "
            "32-bit stco/mdat limit; encode fewer frames per file or use "
            "an ffmpeg codec")

    mvhd = _full(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, _TIMESCALE, duration)
        + struct.pack(">I", 0x00010000)      # rate 1.0
        + struct.pack(">H", 0x0100)          # volume 1.0
        + b"\x00" * 10 + _matrix_identity()
        + b"\x00" * 24                        # QT preview/poster/selection
        + struct.pack(">I", 2))               # next track id

    tkhd = _full(b"tkhd", 0, 0x7, struct.pack(
        ">IIIII", 0, 0, 1, 0, duration)      # ctime mtime id rsvd duration
        + b"\x00" * 8                         # reserved
        + struct.pack(">hhhH", 0, 0, 0, 0)   # layer alt-group volume rsvd
        + _matrix_identity()
        + struct.pack(">II", width << 16, height << 16))

    mdhd = _full(b"mdhd", 0, 0, struct.pack(
        ">IIIIHH", 0, 0, _TIMESCALE, duration, 0x55C4, 0))  # lang 'und'
    hdlr = _full(b"hdlr", 0, 0,
                 b"mhlr" + b"vide" + b"\x00" * 12
                 + b"\x0aVideoTrack")          # pascal-string name (10 ch)
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1)
                 + _full(b"alis", 0, 1, b""))  # self-contained
    dinf = _atom(b"dinf", dref)

    # 'png ' video sample description (QTFF ImageDescription)
    desc = (b"\x00" * 6 + struct.pack(">H", 1)          # dataref index
            + struct.pack(">HH", 0, 0)                   # version revision
            + b"\x00" * 4                                # vendor
            + struct.pack(">II", 512, 512)               # temporal/spatial q
            + struct.pack(">HH", width, height)
            + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
            + struct.pack(">I", 0)                       # data size
            + struct.pack(">H", 1)                       # frames/sample
            + b"\x03png" + b"\x00" * 28                  # compressor name
            + struct.pack(">hh", 24, -1))                # depth, clut id
    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + _atom(b"png ", desc))
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, per))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n)
                 + b"".join(struct.pack(">I", s) for s in sizes))
    stco = _full(b"stco", 0, 0, struct.pack(">I", n)
                 + b"".join(struct.pack(">I", o) for o in offsets))
    stbl = _atom(b"stbl", stsd + stts + stsc + stsz + stco)
    minf = _atom(b"minf", vmhd + _hdlr_data() + dinf + stbl)
    mdia = _atom(b"mdia", mdhd + hdlr + minf)
    trak = _atom(b"trak", tkhd + mdia)
    moov = _atom(b"moov", mvhd + trak)

    total = 0
    with open(out_path, "wb") as out:
        out.write(ftyp)
        out.write(struct.pack(">I", 8 + sum(sizes)) + b"mdat")
        for p in frame_paths:
            with open(p, "rb") as fh:
                out.write(fh.read())
        out.write(moov)
        total = out.tell()
    return {"frames": n, "width": width, "height": height,
            "duration_s": duration / _TIMESCALE, "bytes": total}


# ---------------------------------------------------------------------------
# Demuxer — the byte-level round-trip proof for the encoder above
# ---------------------------------------------------------------------------

def _walk(buf: bytes, start: int, end: int):
    """Yield (tag, payload_start, payload_end) for the atoms in
    buf[start:end], validating the box grammar."""
    pos = start
    while pos + 8 <= end:
        size, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        if size < 8 or pos + size > end:
            raise ValueError(f"corrupt atom {tag!r} at {pos} (size {size})")
        yield tag, pos + 8, pos + size
        pos += size
    if pos != end:
        raise ValueError(f"trailing bytes after last atom ({end - pos})")


def _find(buf: bytes, start: int, end: int, *path: bytes):
    """Resolve a nested atom path; returns (payload_start, payload_end)."""
    for tag, a, b in _walk(buf, start, end):
        if tag == path[0]:
            if len(path) == 1:
                return a, b
            return _find(buf, a, b, *path[1:])
    raise ValueError(f"missing atom {path[0]!r}")


def read_mov(path: str) -> dict:
    """Demux a ``write_mov`` .mov back into its PNG frame samples.

    Walks the real sample tables (stsd → codec check, stsz → sizes,
    stco → absolute offsets, stts → timing) exactly as a player would and
    returns {"frames": [png bytes, ...], "width", "height", "fps",
    "duration_s"}.  Each extracted sample is validated as a complete PNG
    (signature + trailing IEND), so a successful read proves the muxer's
    tables point at intact, decodable frames — the dependency-free
    encoder is end-to-end verifiable without any external tool (the
    reference's only check is whether ffmpeg exists,
    video_encoder.cpp:230-238)."""
    with open(path, "rb") as fh:
        buf = fh.read()
    tags = [t for t, _, _ in _walk(buf, 0, len(buf))]
    if tags != [b"ftyp", b"mdat", b"moov"]:
        raise ValueError(f"unexpected top-level atoms {tags}")
    moov_a, moov_b = _find(buf, 0, len(buf), b"moov")
    stbl_a, stbl_b = _find(buf, moov_a, moov_b, b"trak", b"mdia", b"minf",
                           b"stbl")

    # codec: the one stsd entry must be 'png '
    a, b = _find(buf, stbl_a, stbl_b, b"stsd")
    (n_desc,) = struct.unpack(">I", buf[a + 4:a + 8])
    desc_tag = buf[a + 12:a + 16]
    if n_desc != 1 or desc_tag != b"png ":
        raise ValueError(f"not a qtpng track (codec {desc_tag!r})")
    # ImageDescription: 6 reserved + dataref(2) + ver/rev(4) + vendor(4)
    # + temporal/spatial quality(8) = 24 bytes before width/height
    width, height = struct.unpack(">HH", buf[a + 16 + 24:a + 16 + 28])

    a, b = _find(buf, stbl_a, stbl_b, b"stsz")
    fixed, count = struct.unpack(">II", buf[a + 4:a + 12])
    if fixed != 0:
        raise ValueError("fixed-size samples unexpected for PNG frames")
    sizes = struct.unpack(f">{count}I", buf[a + 12:a + 12 + 4 * count])

    a, b = _find(buf, stbl_a, stbl_b, b"stco")
    (n_off,) = struct.unpack(">I", buf[a + 4:a + 8])
    if n_off != count:
        raise ValueError(f"stco/stsz disagree ({n_off} vs {count})")
    offsets = struct.unpack(f">{count}I", buf[a + 8:a + 8 + 4 * count])

    a, b = _find(buf, stbl_a, stbl_b, b"stts")
    (n_ent,) = struct.unpack(">I", buf[a + 4:a + 8])
    (ent_count, per) = struct.unpack(">II", buf[a + 8:a + 16])
    if n_ent != 1 or ent_count != count:
        raise ValueError("unexpected stts layout")

    mdat_a, mdat_b = _find(buf, 0, len(buf), b"mdat")
    frames = []
    for off, sz in zip(offsets, sizes):
        if off < mdat_a or off + sz > mdat_b:
            raise ValueError(f"sample at {off} escapes mdat")
        sample = buf[off:off + sz]
        if sample[:8] != b"\x89PNG\r\n\x1a\n" \
                or sample[-8:] != b"IEND\xaeB`\x82":
            raise ValueError(f"sample at {off} is not a complete PNG")
        frames.append(sample)
    return {"frames": frames, "width": width, "height": height,
            "fps": _TIMESCALE / per,
            "duration_s": per * count / _TIMESCALE}

