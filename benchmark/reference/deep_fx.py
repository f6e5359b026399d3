"""Plain reference of the deep-zoom export frame past the f64 floor: the
per-lane Mandelbrot perturbation against one reference orbit with Zhuoran
rebasing, in floatexp deltas (a double-double mantissa and an integer
exponent), the HP fallback of lanes still wanting a rebase, the deep
colouring and the uint8 quantize.

Frozen copies, at commit 654f233125f1, of ``fractalrenderer_tpu_torch/
ops/perturbation.py`` (``pack_pert_operands``' floatexp pre-scale: the
pixel step and the shift times 2^s, s = -14 - (bit length of the step's
numerator - its denominator's), each correctly rounded to an f32 pair;
the floatexp start of ``perturbation_fields_plain`` with no series, A = 1
at exponent -s; its Mandelbrot floatexp rebasing branch and
``_fx_aligned_step``, ``_cfe_norm``, ``_pow2``, ``_expo``) and
``deepzoom/hp.py`` (``precision_mode_for_zoom_frac``'s ARBITRARY bits,
bucketed up to a multiple of 64 as ``models/deep_zoom.py`` does).  The
double-double arithmetic, the orbit streams, the pixel mapping, the HP
fallback, the colour and the quantize are ``reference/deep.py``'s, the
orbit ``reference/hp_orbit.py``'s.  Plain PyTorch and Python integers,
each operation as in its source and in its order.

Departures from the program's arithmetic, none of which changes a bit:

- the frames of one comparison share one loop, so the launch's scalar
  s (and the start exponent -s) is a per-lane int32 tensor here:
  ``clamp_min(x, -s)`` becomes ``maximum(x, -s)``, exact on integers;
- the step loop runs as CUDA graphs of 16 steps on a card
  (``reference/deep.py``): a step with no live lane changes nothing;
- the frame's pixel mapping is ``reference/deep.py``'s ``lane_dc`` at
  zoom·2^s and shift·2^s, the same exact rationals the program rounds.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import deep, hp_orbit

E_ZERO = -(1 << 24)  # the exponent of an exact floatexp zero


# ---- the orbit's bits (deepzoom/hp.py) --------------------------------------

def orbit_bits(zoom: Fraction) -> int:
    """The orbit's fraction bits at ``zoom``: below 1e-30 the ARBITRARY
    tier's rule (the reference formula while the zoom is a nonzero double,
    subnormal included; the decimal digits from the exact rational's bit
    lengths past it), bucketed up to a multiple of 64; above 1e-30
    ``hp_orbit.orbit_bits``."""
    fr = Fraction(zoom)
    if fr == 0:
        raise ValueError("a zero zoom has no view")
    z = abs(float(fr))
    if z > 1e-30:
        return hp_orbit.orbit_bits(fr)
    if z > 0.0:
        bits = max(128, min(64 + int(-math.log10(z) * 3.32) + 64, 4096))
    else:
        digits = (abs(fr.denominator).bit_length()
                  - abs(fr.numerator).bit_length()) * 0.30103
        bits = max(128, min(int(64 + digits * 3.32 + 64), 1 << 20))
    return -(-bits // 64) * 64


def scale_exp(zoom: Fraction, height: int) -> int:
    """s of the pre-scale: the pixel step zoom·4/height² times 2^s sits
    near 2^-14."""
    step = Fraction(zoom) * 4 / (height * height)
    if step == 0:
        raise ValueError("the floatexp tier needs a nonzero zoom")
    return -14 - (step.numerator.bit_length()
                  - step.denominator.bit_length())


# ---- floatexp arithmetic (ops/perturbation.py) ------------------------------

def _pow2(k: torch.Tensor) -> torch.Tensor:
    kc = torch.clamp(k, -126, 127)
    f = ((kc + 127) << 23).view(torch.float32)
    return torch.where(k < -126, torch.zeros_like(f), f)


def _expo(x: torch.Tensor) -> torch.Tensor:
    return ((x.view(torch.int32) >> 23) & 0xFF) - 127


def _cfe_norm(mr, mi, ex):
    mag = torch.maximum(torch.abs(mr[0]), torch.abs(mi[0]))
    zero = mag == 0.0
    k = torch.where(zero, 0, _expo(mag))
    f = _pow2(-k)
    nex = torch.where(zero, E_ZERO, torch.clamp(ex + k, E_ZERO, 1 << 24))
    return deep._scl(mr, f), deep._scl(mi, f), nex


def _fx_aligned_step(mr, mi, ex, X, Y, dcx, dcy, neg_s):
    """d <- 2Zd + d^2 + dc: the terms at exponents ex, 2ex and -s aligned
    to their max by exact powers of two, then renormalised."""
    z2r, z2i = deep._scl(X, 2.0), deep._scl(Y, 2.0)
    t1r = deep.dd_sub(deep.dd_mul(mr, z2r), deep.dd_mul(mi, z2i))
    t1i = deep.dd_add(deep.dd_mul(mi, z2r), deep.dd_mul(mr, z2i))
    sq_r = deep.dd_sub(deep.dd_mul(mr, mr), deep.dd_mul(mi, mi))
    sq_i = deep._scl(deep.dd_mul(mr, mi), 2.0)
    e2 = ex + ex
    emax = torch.maximum(torch.maximum(ex, e2), neg_s)
    fa, fb = _pow2(ex - emax), _pow2(e2 - emax)
    nmr = deep.dd_add(deep._scl(t1r, fa), deep._scl(sq_r, fb))
    nmi = deep.dd_add(deep._scl(t1i, fa), deep._scl(sq_i, fb))
    fc = _pow2(neg_s - emax)
    nmr = deep.dd_add(nmr, deep._scl(dcx, fc))
    nmi = deep.dd_add(nmi, deep._scl(dcy, fc))
    return _cfe_norm(nmr, nmi, emax)


# ---- the per-lane loop (perturbation_fields_plain, Mandelbrot fx rebase) ----

class _Lanes(deep._Lanes):
    """The floatexp loop's per-lane state and its step; ``run`` (the
    16-step chunks, graphs on a card) is the dd reference's."""

    def __init__(self, dcx, dcy, neg_s, streams, ref_len: int, limit: int,
                 bailout: float, max_passes: int):
        dev = dcx[0].device
        f32, i32 = torch.float32, torch.int32
        self.ore, self.oim, self.orl, self.oil = streams
        self.last = self.ore.shape[0] - 1
        self.pert_end = ref_len - 1
        self.limit_f = torch.tensor(float(limit), dtype=f32, device=dev)
        b = max(2.0, float(bailout))
        self.bail2 = torch.tensor(b * b, dtype=f32, device=dev)
        self.max_passes = max_passes
        self.dcx, self.dcy, self.neg_s = dcx, dcy, neg_s
        zero = torch.zeros((), dtype=f32, device=dev)
        one = torch.ones((), dtype=f32, device=dev)
        n0 = 1
        # Horner ((C dc + B) dc + A) dc with C = B = 0, A = 1 at exponent -s
        tr, tj = deep._cmul_dd((zero, zero), (zero, zero), dcx, dcy)
        tr = deep.dd_add(tr, (zero, zero))
        tj = deep.dd_add(tj, (zero, zero))
        tr, tj = deep._cmul_dd(tr, tj, dcx, dcy)
        tr = deep.dd_add(tr, (one, zero))
        tj = deep.dd_add(tj, (zero, zero))
        dzr, dzi = deep._cmul_dd(tr, tj, dcx, dcy)
        mag0 = torch.maximum(torch.abs(dzr[0]), torch.abs(dzi[0]))
        zero0 = mag0 == 0.0
        k0 = torch.where(zero0, 0, _expo(mag0))
        f0 = _pow2(-k0)
        dzr, dzi = deep._scl(dzr, f0), deep._scl(dzi, f0)
        ex = torch.where(zero0, E_ZERO, torch.clamp(
            k0 + neg_s, E_ZERO, 1 << 24)).to(i32)
        dfac0 = _pow2(ex)
        z1r = (dzr[0] + dzr[1]) * dfac0
        z1i = (dzi[0] + dzi[1]) * dfac0
        self.d = [t.clone() for t in (*dzr, *dzi)]
        self.ex = ex.clone()
        shape = dcx[0].shape
        self.zfr = (self.ore[n0] + z1r).expand(shape).contiguous()
        self.zfi = (self.oim[n0] + z1i).expand(shape).contiguous()
        self.nf = torch.full(shape, float(n0 - 1), dtype=f32, device=dev)
        self.i = torch.full(shape, n0, dtype=torch.int64, device=dev)
        self.want = torch.zeros(shape, dtype=torch.bool, device=dev)
        self.rounds = torch.ones(shape, dtype=i32, device=dev)
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
        zrl, zil = self.orl[ic], self.oil[ic]
        zrl1, zil1 = self.orl[ip], self.oil[ip]
        dzr, dzi = (self.d[0], self.d[1]), (self.d[2], self.d[3])
        ex = self.ex
        nmr, nmi, nex = _fx_aligned_step(dzr, dzi, ex, (zr, zrl), (zi, zil),
                                         self.dcx, self.dcy, self.neg_s)
        # z_full = Z + m 2^ex; Zhuoran test; rebase to exponent 0
        dfac = _pow2(nex)
        nzfr = (zr1 + nmr[0] * dfac) + (zrl1 + nmr[1] * dfac)
        nzfi = (zi1 + nmi[0] * dfac) + (zil1 + nmi[1] * dfac)
        zm2 = nzfr * nzfr + nzfi * nzfi
        dm2 = (nmr[0] * nmr[0] + nmi[0] * nmi[0]) * _pow2(nex + nex)
        want_now = alive & ((zm2 < dm2) | ends) & (nf < self.limit_f)
        ndr = deep._select(want_now, deep.dd_add((zr1, zrl1),
                                                 deep._scl(nmr, dfac)), nmr)
        ndi = deep._select(want_now, deep.dd_add((zi1, zil1),
                                                 deep._scl(nmi, dfac)), nmi)
        new_ex = torch.where(want_now, 0, nex)
        new_d = [*deep._select(alive, ndr, dzr), *deep._select(alive, ndi,
                                                               dzi)]
        new_ex = torch.where(alive, new_ex, ex)
        new_zfr = torch.where(alive, nzfr, zfr)
        new_zfi = torch.where(alive, nzfi, zfi)
        new_want = want | want_now
        new_i = i + alive.to(torch.int64)
        for dst, src in zip(self.d, new_d):
            dst.copy_(src)
        self.ex.copy_(new_ex)
        self.zfr.copy_(new_zfr)
        self.zfi.copy_(new_zfi)
        self.nf.copy_(nf)
        self.i.copy_(new_i)
        self.want.copy_(new_want)
        self.rounds.copy_(rounds)
        self.live.copy_(alive.any())


def lane_dc(zoom: Fraction, shift: Tuple[Fraction, Fraction], width: int,
            height: int, rows: Sequence[int], device):
    """The scaled dd pixel deltas (dc·2^s) of the lanes of ``rows`` and
    the launch's s."""
    s = scale_exp(zoom, height)
    two_s = Fraction(2) ** s
    dcx, dcy = deep.lane_dc(Fraction(zoom) * two_s,
                            (shift[0] * two_s, shift[1] * two_s), width,
                            height, rows, device)
    return dcx, dcy, s


def fields(blocks: List[Tuple[Fraction, Sequence[int]]], orbit: np.ndarray,
           center: Tuple[Fraction, Fraction], ref: Tuple[Fraction, Fraction],
           width: int, height: int, max_iter: int, bailout: float,
           bits: int, device, max_passes: int):
    """(n, zx, zy) of the rows of each block (zoom, rows), every block's
    lanes in one floatexp loop against ``orbit`` (computed at ``ref`` with
    ``bits``; the scene is at ``center``), and the count of HP-fallback
    lanes.  Each plane is (sum of rows, width)."""
    dev = torch.device(device)
    streams, ref_len = deep.orbit_streams(orbit, max_iter, dev)
    shift = (center[0] - ref[0], center[1] - ref[1])
    parts = [lane_dc(z, shift, width, height, rows, dev)
             for z, rows in blocks]
    dcx = tuple(torch.cat([p[0][k] for p in parts]) for k in (0, 1))
    dcy = tuple(torch.cat([p[1][k] for p in parts]) for k in (0, 1))
    neg_s = torch.cat([torch.full(tuple(p[0][0].shape), -p[2],
                                  dtype=torch.int32, device=dev)
                       for p in parts])
    lanes = _Lanes(dcx, dcy, neg_s, streams, ref_len, max_iter, bailout,
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
            fallback += deep._hp_fallback(
                n[sl], zx[sl], zy[sl], lanes.want[sl].cpu(), lane_ix,
                center[0], center[1], z, width, height, max_iter, bailout,
                bits)
            start += len(rows)
        n, zx, zy = n.to(dev), zx.to(dev), zy.to(dev)
    return n, zx, zy, fallback


def frames(blocks: List[Tuple[Fraction, Sequence[int]]],
           center: Tuple[Fraction, Fraction], ref: Tuple[Fraction, Fraction],
           width: int, height: int, max_iter: int, bailout: float,
           color_offset: float, color_scale: float, palette_mode: int,
           device, max_passes: int, tier: str = "fx"):
    """The uint8 (len(rows), width, 3) rows of each block (zoom, rows) and
    its count plane, ``[(img, n), ...]`` in the order of ``blocks``: the
    blocks grouped by their orbit's bits, one exact orbit at ``ref`` and
    one loop a group.  ``tier`` "dd" runs the dd reference's deltas in
    place of floatexp ones (the lower-precision control)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    by_bits = {}
    for j, (z, rows) in enumerate(blocks):
        by_bits.setdefault(orbit_bits(z), []).append(j)
    out = [None] * len(blocks)
    for bits, idx in by_bits.items():
        o = hp_orbit.orbit(hp_orbit.to_man(ref[0], bits),
                           hp_orbit.to_man(ref[1], bits), bits,
                           max_iter + 1)
        group = [blocks[j] for j in idx]
        if tier == "fx":
            n, zx, zy, _ = fields(group, o, center, ref, width, height,
                                  max_iter, bailout, bits, device,
                                  max_passes)
        else:
            n, zx, zy, _ = deep.fields(group, o, center, ref, width, height,
                                       max_iter, bailout, bits, tier, device,
                                       max_passes)
        start = 0
        for j, (_, rows) in zip(idx, group):
            sl = slice(start, start + len(rows))
            img = deep.color(n[sl], zx[sl], zy[sl], max_iter, color_offset,
                             color_scale, palette_mode)
            out[j] = (deep.quantize8(img), n[sl])
            start += len(rows)
    return out
