"""Plain reference of the deep-zoom export frame: the per-lane perturbation
against one reference orbit with Zhuoran rebasing, in double-double deltas
(or f32 deltas, the lower-precision control), the HP fallback of lanes
still wanting a rebase, the deep colouring and the uint8 quantize.

Frozen copies, at commit f3d0ace5ea09, of ``fractalrenderer_tpu_torch/
ops/dd.py`` (two_prod through f64, dd_add, dd_mul, dd_mul_float),
``ops/perturbation.py`` (``pack_pert_operands``' streams and parameters
and the Mandelbrot rebasing branch of ``perturbation_fields_plain``, f32
and dd tiers, no series: A = 1 and n0 = 1), ``models/deep_zoom.py`` (the
orbit's length max_iter + 1, the exact pixel mapping of the HP fallback,
its count convention) and ``ops/coloring.py`` / ``ops/palettes.py``
(``color_deep_zoom``, ``deepzoom_color``, ``hsv2rgb``).  Plain PyTorch,
each operation as in its source and in its order.

On a card the step loop runs as CUDA graphs of 16 steps: the same
operations launched from a recorded graph instead of one call each (a
step with no live lane changes nothing, so the steps a graph runs past
the last live one are no-ops).
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import hp_orbit

_LOG2 = math.log(2.0)
_CHUNK = 16  # steps between two looks for a live lane


# ---- dd arithmetic (ops/dd.py) ---------------------------------------------

def two_prod(a, b):
    p = a * b
    err = (a.double() * b.double() - p.double()).float()
    return p, err


def dd_add(a, b):
    ah, al = a
    bh, bl = b
    s = ah + bh
    v = s - ah
    t = ((bh - v) + (ah - (s - v))) + (al + bl)
    hi = s + t
    lo = t - (hi - s)
    return hi, lo


def dd_mul_float(a, b):
    ah, al = a
    p, e = two_prod(ah, b)
    lo = al * b + e
    hi = p + lo
    lo = lo - (hi - p)
    return hi, lo


def dd_mul(a, b):
    ah, al = a
    bh, bl = b
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    hi = p + e
    lo = e - (hi - p)
    return hi, lo


def dd_sub(a, b):
    return dd_add(a, (-b[0], -b[1]))


def _cmul_dd(ar, ai, br, bi):
    return (dd_sub(dd_mul(ar, br), dd_mul(ai, bi)),
            dd_add(dd_mul(ar, bi), dd_mul(ai, br)))


def _select(cond, a, b):
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def _scl(v, f):
    return v[0] * f, v[1] * f


# ---- the launch's operands (pack_pert_operands) ----------------------------

def orbit_streams(orbit: np.ndarray, max_iter: int, device):
    """(re, im, re_lo, im_lo) f32 streams of the orbit, zero past its end,
    each as long as the power-of-two bucket over max_iter + 1 (<= 32768),
    and the orbit's stored length."""
    if max_iter + 1 > 32768:
        cap = max(max_iter + 1, 2)
    else:
        cap = 256
        while cap < max_iter + 1:
            cap *= 2
    n = min(len(orbit), cap)
    re, im = np.zeros(cap, np.float32), np.zeros(cap, np.float32)
    re_lo, im_lo = np.zeros(cap, np.float32), np.zeros(cap, np.float32)
    re[:n] = orbit[:n, 0].astype(np.float32)
    im[:n] = orbit[:n, 1].astype(np.float32)
    re_lo[:n] = (orbit[:n, 0] - re[:n].astype(np.float64)).astype(np.float32)
    im_lo[:n] = (orbit[:n, 1] - im[:n].astype(np.float64)).astype(np.float32)
    return [torch.from_numpy(s).to(device) for s in (re, im, re_lo, im_lo)], n


def lane_dc(zoom: Fraction, shift: Tuple[Fraction, Fraction], width: int,
            height: int, rows: Sequence[int], device):
    """The dd pixel deltas dc = step * (pixel - size/2) + shift of the
    lanes of ``rows`` (global rows of a ``height``-tall frame), step =
    zoom * 4 / height^2 exactly, as the launch maps them."""
    f32 = torch.float32
    step_hi, step_lo = hp_orbit.dd_from_fraction(Fraction(zoom) * 4
                                                 / (height * height))
    sh = [hp_orbit.dd_from_fraction(s) for s in shift]
    t = lambda v: torch.tensor(v, dtype=f32, device=device)  # noqa: E731
    rows_f = torch.as_tensor(list(rows), dtype=torch.int32,
                             device=device).to(f32)
    cols = torch.arange(width, dtype=torch.int32, device=device).to(f32)
    half_w, half_h = t(width * 0.5), t(height * 0.5)
    shape = (len(rows), width)
    off = t(0.0).expand(len(rows))
    nx = ((cols - half_w)[None, :] + off[:, None]).contiguous()
    ny = ((rows_f - half_h) + off)[:, None].expand(shape).contiguous()
    step = (t(step_hi), t(step_lo))
    dcx = dd_add(dd_mul_float(step, nx), (t(sh[0][0]), t(sh[0][1])))
    dcy = dd_add(dd_mul_float(step, ny), (t(sh[1][0]), t(sh[1][1])))
    return dcx, dcy


# ---- the per-lane loop (perturbation_fields_plain, Mandelbrot rebase) -------

class _Lanes:
    """The loop's per-lane state and its step, written so that one step
    only reads and then overwrites these tensors in place (a CUDA graph can
    record it)."""

    def __init__(self, dcx, dcy, streams, ref_len: int, limit: int,
                 bailout: float, tier: str, max_passes: int):
        self.tier = tier
        dev = dcx[0].device
        f32 = torch.float32
        self.ore, self.oim, self.orl, self.oil = streams
        self.last = self.ore.shape[0] - 1
        self.pert_end = ref_len - 1
        self.limit_f = torch.tensor(float(limit), dtype=f32, device=dev)
        b = max(2.0, float(bailout))
        self.bail2 = torch.tensor(b * b, dtype=f32, device=dev)
        self.max_passes = max_passes
        self.dcx, self.dcy = dcx, dcy
        self.delta_r, self.delta_i = dcx[0] + dcx[1], dcy[0] + dcy[1]
        zero = torch.zeros((), dtype=f32, device=dev)
        one = torch.ones((), dtype=f32, device=dev)
        n0 = 1
        if tier == "f32":
            # Horner ((C dc + B) dc + A) dc with C = B = 0, A = 1
            hr, hi = zero, zero
            dr, di = self.delta_r, self.delta_i
            hr, hi = (hr * dr - hi * di + zero, hr * di + hi * dr + zero)
            hr, hi = (hr * dr - hi * di + one, hr * di + hi * dr + zero)
            d0r, d0i = hr * dr - hi * di, hr * di + hi * dr
            z1r, z1i = d0r, d0i
            self.d = [d0r.clone(), d0i.clone()]
        else:
            tr, tj = _cmul_dd((zero, zero), (zero, zero), dcx, dcy)
            tr = dd_add(tr, (zero, zero))
            tj = dd_add(tj, (zero, zero))
            tr, tj = _cmul_dd(tr, tj, dcx, dcy)
            tr = dd_add(tr, (one, zero))
            tj = dd_add(tj, (zero, zero))
            dzr, dzi = _cmul_dd(tr, tj, dcx, dcy)
            z1r, z1i = dzr[0] + dzr[1], dzi[0] + dzi[1]
            self.d = [t.clone() for t in (*dzr, *dzi)]
        shape = dcx[0].shape
        self.zfr = (self.ore[n0] + z1r).expand(shape).contiguous()
        self.zfi = (self.oim[n0] + z1i).expand(shape).contiguous()
        self.nf = torch.full(shape, float(n0 - 1), dtype=f32, device=dev)
        self.i = torch.full(shape, n0, dtype=torch.int64, device=dev)
        self.want = torch.zeros(shape, dtype=torch.bool, device=dev)
        self.rounds = torch.ones(shape, dtype=torch.int32, device=dev)
        self.live = torch.ones((), dtype=torch.bool, device=dev)

    def step(self):
        restart = self.want & (self.rounds < self.max_passes)
        i = torch.where(restart, 0, self.i)
        rounds = self.rounds + restart.to(torch.int32)
        want = self.want & ~restart
        zfr, zfi, nf = self.zfr, self.zfi, self.nf
        mag2 = zfr * zfr + zfi * zfi
        alive = ((mag2 <= self.bail2) & (i < self.pert_end) & ~want
                 & (nf < self.limit_f))
        nf = nf + alive.to(torch.float32)
        ic, ip = i.clamp(max=self.last), (i + 1).clamp(max=self.last)
        zr, zi = self.ore[ic], self.oim[ic]
        zr1, zi1 = self.ore[ip], self.oim[ip]
        ends = (i + 1) >= self.pert_end
        if self.tier == "f32":
            dr, di = self.d
            t1r = 2.0 * (zr * dr - zi * di)
            t1i = 2.0 * (zr * di + zi * dr)
            t2r = dr * dr - di * di
            t2i = (2.0 * dr) * di
            ndr = t1r + t2r + self.delta_r
            ndi = t1i + t2i + self.delta_i
            relr, reli = zr1 + ndr, zi1 + ndi
            zm2 = relr * relr + reli * reli
            dm2 = ndr * ndr + ndi * ndi
            want_now = alive & ((zm2 < dm2) | ends) & (nf < self.limit_f)
            ndr = torch.where(want_now, relr, ndr)
            ndi = torch.where(want_now, reli, ndi)
            new_d = [torch.where(alive, ndr, dr), torch.where(alive, ndi, di)]
            nzfr, nzfi = relr, reli
        else:
            dzr, dzi = (self.d[0], self.d[1]), (self.d[2], self.d[3])
            zrl, zil = self.orl[ic], self.oil[ic]
            zrl1, zil1 = self.orl[ip], self.oil[ip]
            X, Y = (zr, zrl), (zi, zil)
            z2r, z2i = _scl(X, 2.0), _scl(Y, 2.0)
            t1r = dd_sub(dd_mul(dzr, z2r), dd_mul(dzi, z2i))
            t1i = dd_add(dd_mul(dzi, z2r), dd_mul(dzr, z2i))
            sq_r = dd_sub(dd_mul(dzr, dzr), dd_mul(dzi, dzi))
            sq_i = _scl(dd_mul(dzr, dzi), 2.0)
            ndr, ndi = dd_add(t1r, sq_r), dd_add(t1i, sq_i)
            ndr, ndi = dd_add(ndr, self.dcx), dd_add(ndi, self.dcy)
            rel_r = (zr1 + ndr[0]) + (zrl1 + ndr[1])
            rel_i = (zi1 + ndi[0]) + (zil1 + ndi[1])
            zm2 = rel_r * rel_r + rel_i * rel_i
            dm2 = ndr[0] * ndr[0] + ndi[0] * ndi[0]
            want_now = alive & ((zm2 < dm2) | ends) & (nf < self.limit_f)
            ndr = _select(want_now, dd_add((zr1, zrl1), ndr), ndr)
            ndi = _select(want_now, dd_add((zi1, zil1), ndi), ndi)
            new_d = [*_select(alive, ndr, dzr), *_select(alive, ndi, dzi)]
            nzfr, nzfi = rel_r, rel_i
        new_zfr = torch.where(alive, nzfr, zfr)
        new_zfi = torch.where(alive, nzfi, zfi)
        new_want = want | want_now
        new_i = i + alive.to(torch.int64)
        for dst, src in zip(self.d, new_d):
            dst.copy_(src)
        self.zfr.copy_(new_zfr)
        self.zfi.copy_(new_zfi)
        self.nf.copy_(nf)
        self.i.copy_(new_i)
        self.want.copy_(new_want)
        self.rounds.copy_(rounds)
        self.live.copy_(alive.any())

    def run(self, graphs: bool):
        """Step until a look finds no live lane."""
        if not graphs:
            while True:
                for _ in range(_CHUNK):
                    self.step()
                if not bool(self.live):
                    return
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the capture's warm-up: real steps
            for _ in range(_CHUNK):
                self.step()
        torch.cuda.current_stream().wait_stream(side)
        if not bool(self.live):
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(_CHUNK):
                self.step()
        while True:
            graph.replay()
            if not bool(self.live):
                return


def _hp_fallback(n, zx, zy, want, lanes, cx: Fraction, cy: Fraction,
                 zoom: Fraction, width: int, height: int, max_iter: int,
                 bailout: float, bits: int):
    """Each lane still wanting a rebase iterates its own exact orbit (the
    pixel is the reference), at the launch's c, as the model does."""
    hp_bits = max(bits, 128)
    bail = max(2.0, float(bailout))
    step = zoom * 4 / (height * height)
    idx = torch.nonzero(want.reshape(-1)).reshape(-1).cpu().tolist()
    for k in idx:
        row, px = lanes[k]
        dcx = step * (Fraction(px) - Fraction(width, 2))
        dcy = step * (Fraction(row) - Fraction(height, 2))
        o = hp_orbit.orbit(hp_orbit.to_man(cx, hp_bits)
                           + hp_orbit.to_man(dcx, hp_bits),
                           hp_orbit.to_man(cy, hp_bits)
                           + hp_orbit.to_man(dcy, hp_bits),
                           hp_bits, max_iter + 1, escape_mag_sq=bail * bail)
        zfx, zfy = float(o[-1, 0]), float(o[-1, 1])
        escaped = zfx * zfx + zfy * zfy > bail * bail
        n.view(-1)[k] = (len(o) - 2) if escaped else max_iter
        zx.view(-1)[k] = zfx
        zy.view(-1)[k] = zfy
    return len(idx)


def fields(blocks: List[Tuple[Fraction, Sequence[int]]], orbit: np.ndarray,
           center: Tuple[Fraction, Fraction], ref: Tuple[Fraction, Fraction],
           width: int, height: int, max_iter: int, bailout: float,
           bits: int, tier: str, device, max_passes: int):
    """(n, zx, zy) of the rows of each block (zoom, rows), every block's
    lanes in one loop against ``orbit`` (computed at ``ref``; the scene is
    at ``center``), and the count of HP-fallback lanes.  Each plane is
    (sum of rows, width)."""
    dev = torch.device(device)
    streams, ref_len = orbit_streams(orbit, max_iter, dev)
    shift = (center[0] - ref[0], center[1] - ref[1])
    parts = [lane_dc(z, shift, width, height, rows, dev)
             for z, rows in blocks]
    dcx = tuple(torch.cat([p[0][k] for p in parts]) for k in (0, 1))
    dcy = tuple(torch.cat([p[1][k] for p in parts]) for k in (0, 1))
    lanes = _Lanes(dcx, dcy, streams, ref_len, max_iter, bailout, tier,
                   max_passes)
    lanes.run(graphs=dev.type == "cuda")
    lim = torch.tensor(max_iter, dtype=torch.int32, device=dev)
    n = torch.where(lanes.nf >= lanes.limit_f, lim,
                    torch.clamp_min(lanes.nf, 0.0).to(torch.int32))
    zx, zy = lanes.zfr.clone(), lanes.zfi.clone()
    fallback = 0
    if bool(lanes.want.any()):
        n, zx, zy = n.cpu(), zx.cpu(), zy.cpu()
        start = 0
        for z, rows in blocks:
            sl = slice(start, start + len(rows))
            lane_ix = [(r, c) for r in rows for c in range(width)]
            fallback += _hp_fallback(n[sl], zx[sl], zy[sl],
                                     lanes.want[sl].cpu(), lane_ix,
                                     center[0], center[1], z, width, height,
                                     max_iter, bailout, bits)
            start += len(rows)
        n, zx, zy = n.to(dev), zx.to(dev), zy.to(dev)
    return n, zx, zy, fallback


# ---- colour (ops/coloring.py color_deep_zoom) ------------------------------

def _fract(t):
    return t - torch.floor(t)


def _hsv2rgb(h, s, v):
    kx, ky, kz, kw = 1.0, 2.0 / 3.0, 1.0 / 3.0, 3.0
    px = torch.abs(_fract(h + kx) * 6.0 - kw)
    py = torch.abs(_fract(h + ky) * 6.0 - kw)
    pz = torch.abs(_fract(h + kz) * 6.0 - kw)
    p = torch.stack([px, py, pz], dim=-1)
    lo = torch.tensor(0.0, dtype=torch.float32, device=p.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=p.device)
    rgb = torch.ones_like(p) * (1.0 - s[..., None]) \
        + torch.minimum(torch.maximum(p - 1.0, lo), hi) * s[..., None]
    return v[..., None] * rgb


def palette(t, mode: int):
    """Deep palette 0, the one the configurations use (hue cycling)."""
    if mode != 0:
        raise ValueError(f"deep palette {mode} is not in the reference")
    hue = _fract(t * 0.05)
    return _hsv2rgb(hue, torch.full_like(hue, 0.8), torch.full_like(hue, 0.9))


def color(n, zx, zy, max_iter: int, color_offset: float, color_scale: float,
          palette_mode: int):
    """(rows, width, 3) f32 deep colour, no post chain."""
    dev = zx.device
    vals = torch.tensor([float(max_iter), float(color_offset),
                         float(color_scale)], dtype=torch.float32, device=dev)
    mi, off, scale = vals[0], vals[1], vals[2]
    log2 = torch.tensor(_LOG2, dtype=torch.float32, device=dev)
    nf = n.to(torch.float32)
    lenz = torch.clamp_min(torch.sqrt(zx * zx + zy * zy), 1e-12)
    log_zn = torch.log(lenz)
    nu = torch.log(torch.clamp_min(log_zn, 1e-38) / log2) / log2
    smooth = nf + 1.0 - nu
    t = smooth * scale + off
    c = palette(t, int(palette_mode))
    inside = (nf >= mi - 0.5)[..., None]
    return torch.where(inside, torch.zeros_like(c), c)


def quantize8(img: torch.Tensor) -> torch.Tensor:
    img = torch.clamp(img, 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8)
