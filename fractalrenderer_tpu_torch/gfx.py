"""In-band pixel graphics for the live session (the PyTorch port's copy of
``fractalrenderer_tpu/gfx.py``: the same escapes, byte for byte).

The reference's core experience is a 1700×900 *pixel* window redrawn every
frame (src/vk_engine.cpp:630-733, window size src/vk_engine.h:74).  A
terminal has no swapchain, but modern terminals accept real pixel frames
in-band:

- **kitty graphics protocol** (kitty, ghostty, wezterm, konsole …):
  APC escapes ``ESC _G <k=v,...> ; <base64 payload> ESC \\`` — we transmit
  PNG frames (``f=100``) chunked at 4096 base64 bytes, placed under the
  text layer (``z=-1``) so the status bar / help overlay print on top.
- **iTerm2 inline images** (iTerm2, some others): ``OSC 1337 File=...``
  with a base64 PNG body.
- **SIXEL** (xterm -ti vt340, foot, mlterm, Windows Terminal preview):
  the classic DEC raster format — a 6×7×6 RGB palette quantization
  encoded as per-band color runs; detected via DA1 capability 4.

Detection is a standard in-band handshake (must run with the terminal in
cbreak mode): send a tiny kitty graphics *query* (``a=q``), a window
pixel-size report request (``CSI 14 t``), and a DA1 (``CSI c``).  Every
terminal answers DA1, so its arrival bounds the wait; a ``ESC _G i=31``
response before it means kitty graphics, and a ``CSI 4;H;W t`` reply gives
the window size in pixels (→ render resolution).  ``FRACTAL_TPU_GFX``
forces the outcome (``kitty`` / ``iterm`` / ``off``) for tests, scripts,
and terminals that mis-advertise.

The render itself is the session's usual frame on its device (live.py);
this module is host code only.  The sixel body encoder is the repository's
``native/sixel.cpp`` (shared with the JAX package, built by
utils/native_build.py), with a NumPy fallback that emits the same bytes.
"""
from __future__ import annotations

import base64
import os
import select
import time
from dataclasses import dataclass
from typing import Optional, Tuple

# Render-size bounds for in-band pixel frames: enough to beat the
# reference's 1700x900 window on a big terminal, small enough that the
# base64 stream stays comfortably under interactive latency on ssh.
MAX_W, MAX_H = 1920, 1080
_DEFAULT_CELL = (8.0, 16.0)  # typical monospace cell pixels (fallback)
_CHUNK = 4096                # kitty: max base64 payload bytes per escape


@dataclass
class GfxInfo:
    kind: str                              # "kitty" | "iterm"
    term_px: Optional[Tuple[int, int]]     # (width, height) of the window
    cell_px: Tuple[float, float] = _DEFAULT_CELL


def _read_reports(fin, timeout: float) -> bytes:
    """Drain handshake responses until DA1 arrives or the timeout passes."""
    fd = fin.fileno()
    buf = b""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            ready, _, _ = select.select([fd], [], [],
                                        max(0.0, deadline - time.monotonic()))
        except (OSError, ValueError):
            break
        if not ready:
            break
        try:
            data = os.read(fd, 4096)
        except OSError:
            break
        if not data:
            break
        buf += data
        # DA1 response: ESC [ ? ... c  — the fence that every terminal sends
        if b"\x1b[?" in buf and buf.rsplit(b"\x1b[?", 1)[1].find(b"c") >= 0:
            break
    return buf


def detect(fin, fout, force: Optional[str] = None,
           timeout: float = 0.35, pushback=None) -> Optional[GfxInfo]:
    """Detect an in-band graphics protocol on the attached terminal.

    ``force``: "kitty" / "iterm" skip the handshake; "off" disables; None
    consults $FRACTAL_TPU_GFX first and then handshakes.  Returns None
    when no pixel protocol is available (the caller keeps the half-block
    cell renderer — fallback behavior unchanged).

    ``pushback``: callable receiving any bytes read past the DA1 reply —
    user type-ahead that arrived during the handshake window must reach
    the session's input parser, not vanish."""
    # an explicit "auto" behaves exactly like None — $FRACTAL_TPU_GFX
    # still overrides (run_live documents "auto ... env overrides")
    if force == "auto":
        force = None
    force = force if force is not None else os.environ.get(
        "FRACTAL_TPU_GFX", "").lower() or None
    if force in ("off", "none", "0"):
        return None
    if force in ("kitty", "iterm", "sixel"):
        return GfxInfo(force, None)
    if force is not None and force != "auto":
        return None

    env = os.environ
    # iTerm2 advertises via environment, not an in-band query
    if env.get("TERM_PROGRAM") == "iTerm.app" \
            or env.get("LC_TERMINAL") == "iTerm2":
        return GfxInfo("iterm", None)

    if not hasattr(fin, "fileno"):
        return None
    try:
        if not os.isatty(fin.fileno()):
            return None
    except (OSError, ValueError):
        return None

    # kitty graphics query (a=q never displays anything; i=31 keys the
    # response) + window pixel size + cell pixel size + DA1 fence.  The
    # cell size matters for SIXEL, which paints pixel-for-pixel: a wrong
    # cell estimate would misplace the status bar and skew the
    # mouse-to-pixel mapping (kitty/iTerm2 rescale to the cell rectangle
    # and are immune).
    try:
        fout.write("\x1b_Gi=31,s=1,v=1,a=q,t=d,f=24;AAAA\x1b\\"
                   "\x1b[14t\x1b[16t\x1b[c")
        fout.flush()
    except (OSError, ValueError):
        return None
    buf = _read_reports(fin, timeout)
    # bytes past the DA1 reply terminator are user type-ahead — hand them
    # back to the caller's input buffer (bytes interleaved BEFORE the
    # replies within the ~0.35 s window are indistinguishable from reply
    # payloads and are dropped; DA1 ends the window, so the common case —
    # typing right after the prompt appears — lands after it)
    da1_at = buf.rfind(b"\x1b[?")
    da1_end = buf.find(b"c", da1_at) if da1_at >= 0 else -1
    if pushback is not None and da1_end >= 0 and buf[da1_end + 1:]:
        pushback(buf[da1_end + 1:])
    if b"\x1b_Gi=31" not in buf:
        # no kitty — DA1 capability 4 advertises SIXEL (xterm -ti vt340,
        # foot, mlterm, Windows Terminal preview, ...)
        if da1_at >= 0 and da1_end > da1_at:
            attrs = buf[da1_at + 3:da1_end].split(b";")
            if b"4" in attrs:
                return GfxInfo("sixel", _parse_14t(buf),
                               _parse_16t(buf) or _DEFAULT_CELL)
        return None
    return GfxInfo("kitty", _parse_14t(buf),
                   _parse_16t(buf) or _DEFAULT_CELL)


def _parse_report_t(buf: bytes, code: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from a ``CSI <code> ; height ; width t`` report."""
    marker = b"\x1b[" + code + b";"
    at = buf.find(marker)
    if at < 0:
        return None
    endt = buf.find(b"t", at)
    try:
        h_s, w_s = buf[at + len(marker):endt].split(b";")
        return (int(w_s), int(h_s))
    except ValueError:
        return None


def _parse_14t(buf: bytes) -> Optional[Tuple[int, int]]:
    """Window pixel size (CSI 14 t → CSI 4 ; height ; width t)."""
    return _parse_report_t(buf, b"4")


def _parse_16t(buf: bytes) -> Optional[Tuple[float, float]]:
    """Cell pixel size (CSI 16 t → CSI 6 ; height ; width t)."""
    r = _parse_report_t(buf, b"6")
    return (float(r[0]), float(r[1])) if r else None


def requery(fin, fout, info: GfxInfo, timeout: float = 0.35,
            pushback=None) -> GfxInfo:
    """Refresh ``info``'s window/cell pixel geometry after a terminal
    resize or fullscreen toggle (the startup handshake's term_px goes
    stale, skewing pick_render_size and the mouse px_per_cell mapping).
    Sends only the size queries + DA1 fence — never the kitty probe, so
    the protocol ``kind`` is preserved.  On any failure the original
    info is returned unchanged."""
    if not hasattr(fin, "fileno"):
        return info
    try:
        if not os.isatty(fin.fileno()):
            return info
    except (OSError, ValueError):
        return info
    try:
        fout.write("\x1b[14t\x1b[16t\x1b[c")
        fout.flush()
    except (OSError, ValueError):
        return info
    buf = _read_reports(fin, timeout)
    da1_at = buf.rfind(b"\x1b[?")
    da1_end = buf.find(b"c", da1_at) if da1_at >= 0 else -1
    if pushback is not None and da1_end >= 0 and buf[da1_end + 1:]:
        pushback(buf[da1_end + 1:])
    return GfxInfo(info.kind, _parse_14t(buf) or info.term_px,
                   _parse_16t(buf) or info.cell_px)


def pick_render_size(info: GfxInfo, cols: int, rows: int,
                     img_rows: int) -> Tuple[int, int]:
    """Pixel render size for an ``img_rows``-cell-tall image in a
    cols×rows terminal, from the handshake's window pixel report (or a
    typical 8×16 cell when unreported), capped at 1080p."""
    if info.term_px and cols > 0 and rows > 0:
        cw = info.term_px[0] / cols
        ch = info.term_px[1] / rows
    else:
        cw, ch = info.cell_px
    w = int(cols * cw)
    h = int(img_rows * ch)
    w, h = min(w, MAX_W), min(h, MAX_H)
    return max(2, w - w % 2), max(2, h - h % 2)


def kitty_clear() -> str:
    """Delete every image placement (entering the minimap / on exit)."""
    return "\x1b_Ga=d,d=A,q=2\x1b\\"


# ---------------------------------------------------------------------------
# SIXEL encoder (DEC raster graphics)
# ---------------------------------------------------------------------------
# Fixed 6x7x6 RGB palette (252 colors): idx = r6*42 + g7*6 + b6.  Sixel
# has no alpha/truecolor; a fixed cube keeps the encode one vectorized
# quantization instead of a per-frame median cut.

def _sixel_palette_defs() -> str:
    out = []
    for r in range(6):
        for g in range(7):
            for b in range(6):
                idx = r * 42 + g * 6 + b
                out.append(f"#{idx};2;{round(r * 100 / 5)};"
                           f"{round(g * 100 / 6)};{round(b * 100 / 5)}")
    return "".join(out)


_SIXEL_PALETTE = None  # built once (it is ~2.5 KB of text)


def _load_sixel_native():
    """native/sixel.cpp via the shared loader; None without a toolchain."""
    import ctypes

    from .utils.native_build import load_native_lib

    def configure(lib):
        lib.sixel_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong]
        lib.sixel_encode.restype = ctypes.c_longlong
        lib.sixel_encode_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_longlong]
        lib.sixel_encode_rgb.restype = ctypes.c_longlong

    return load_native_lib("libsixel", configure)


def _sixel_body_numpy(idx, h: int, w: int) -> str:
    """Fallback sixel body encoder — byte-identical emission rules to
    native/sixel.cpp (runs n >= 4 as '!<n><ch>', trailing-'?' trim, '$'
    between colors, '-' after each band), vectorized where numpy can:
    the per-(color, column) bitmasks come from ONE bincount per band
    (each pixel's key color*w + x is unique within a row, so summing
    1<<row is exactly the OR), and dense low-coherence rows emit raw
    bytes in one conversion instead of walking 100k Python runs."""
    import numpy as np

    out = []
    cols_ar = np.arange(w)
    for y0 in range(0, h, 6):
        band = idx[y0:y0 + 6]
        rows = band.shape[0]
        colors, inv = np.unique(band, return_inverse=True)
        inv = inv.reshape(band.shape)
        nc = len(colors)
        keys = (inv * w + cols_ar[None, :]).ravel()
        weights = np.repeat(
            (1 << np.arange(rows)).astype(np.float64), w)
        bits = np.bincount(keys, weights=weights,
                           minlength=nc * w).astype(np.uint8)
        chars = (bits + 63).reshape(nc, w)
        for ci in range(nc):
            row = chars[ci]
            nz = np.flatnonzero(row != 63)
            last = int(nz[-1]) + 1 if nz.size else 0
            row = row[:last]
            parts = ["$"] if ci else []  # '$' = return to band start
            parts.append(f"#{colors[ci]}")
            cuts = np.flatnonzero(np.diff(row)) + 1
            starts = np.concatenate(([0], cuts))
            ends = np.concatenate((cuts, [last])) if last else starts[:0]
            for s_, e_ in zip(starts, ends):
                n, ch = int(e_ - s_), chr(int(row[s_]))
                parts.append(f"!{n}{ch}" if n >= 4 else ch * n)
            out.append("".join(parts))
        out.append("-")  # next band
    return "".join(out)


def sixel_frame(img8) -> str:
    """Encode an (H, W, 3) uint8 image as a SIXEL sequence.

    The palette quantization (252 fixed colors: 6x7x6 RGB levels) runs in
    numpy; the band/RLE emission runs in native/sixel.cpp when the C++
    helper builds (single-digit ms per frame — the interactive sixel
    session re-encodes every frame, and the former pure-Python RLE walk
    cost seconds on low-coherence frames), with a numpy fallback emitting
    byte-identical sequences."""
    import numpy as np

    global _SIXEL_PALETTE
    if _SIXEL_PALETTE is None:
        _SIXEL_PALETTE = _sixel_palette_defs()
    h, w = img8.shape[:2]
    head = "".join(["\x1bP0;1;0q", f'"1;1;{w};{h}', _SIXEL_PALETTE])
    lib = _load_sixel_native()
    if lib is not None:
        import ctypes

        rgb = np.ascontiguousarray(img8[..., :3], dtype=np.uint8)
        cap = 4 * h * w + (1 << 20)
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = lib.sixel_encode_rgb(
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                h, w, buf, cap)
            if n >= 0:
                body = ctypes.string_at(buf, n).decode("latin1")
                return head + body + "\x1b\\"
            if cap > (1 << 31):  # give up on the native path
                break
            cap *= 2
    r = img8[..., 0].astype(np.int32) * 6 // 256
    g = img8[..., 1].astype(np.int32) * 7 // 256
    b = img8[..., 2].astype(np.int32) * 6 // 256
    idx = r * 42 + g * 6 + b  # (H, W) palette indices
    return head + _sixel_body_numpy(idx, h, w) + "\x1b\\"


def encode_frame(info: GfxInfo, img8, cols: int, rows: int,
                 image_id: int = 1) -> str:
    """img8 (H, W, 3) uint8 → the complete escape string for this
    backend (kitty/iTerm2: in-band PNG; sixel: direct raster)."""
    if info.kind == "sixel":
        return sixel_frame(img8)
    from .utils.png import encode_png

    return emit_frame(info, encode_png(img8, compress_level=1), cols,
                      rows, image_id)


def emit_frame(info: GfxInfo, png_bytes: bytes, cols: int, rows: int,
               image_id: int = 1) -> str:
    """The escape string that displays ``png_bytes`` over a cols×rows cell
    rectangle at the current cursor position."""
    payload = base64.standard_b64encode(png_bytes).decode("ascii")
    if info.kind == "iterm":
        return (f"\x1b]1337;File=inline=1;size={len(png_bytes)}"
                f";width={cols};height={rows};preserveAspectRatio=0"
                f":{payload}\x07")
    # kitty: transmit+display PNG under the text layer; q=2 suppresses
    # responses (we never read them mid-frame); C=1 keeps the cursor put;
    # re-using one image id replaces the previous frame without flicker
    # or placement accumulation.
    ctrl = (f"a=T,f=100,i={image_id},q=2,C=1,z=-1,c={cols},r={rows}")
    if len(payload) <= _CHUNK:
        return f"\x1b_G{ctrl};{payload}\x1b\\"
    out = []
    first, rest = payload[:_CHUNK], payload[_CHUNK:]
    out.append(f"\x1b_G{ctrl},m=1;{first}\x1b\\")
    while rest:
        chunk, rest = rest[:_CHUNK], rest[_CHUNK:]
        out.append(f"\x1b_Gm={1 if rest else 0};{chunk}\x1b\\")
    return "".join(out)
