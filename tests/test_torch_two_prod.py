"""The port's exact product error (ops/dd.py two_prod) against the JAX
package's Dekker two_prod and against exact rationals.

The CUDA kernels (csrc/dd.cuh) take err = fmaf(a, b, -p); the plain
version computes the same number as f32(f64(a) * f64(b) - f64(p)), both f64
operations exact.  Contract:
- wherever neither the product nor its exact error a * b - p is
  subnormal, (p, err) is bit for bit the JAX package's Dekker pair
  (fractalrenderer_tpu/ops/dd.py two_prod, ``xp=numpy``), and p + err ==
  a * b exactly;
- where the exact error is subnormal, err is its correctly rounded f32
  (Dekker's is not, on some pairs);
- the dd-tier view the card test holds K3 on at 1e-20
  (tests/test_torch_cuda.py) runs through that zone.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from fractalrenderer_tpu.ops import dd as jax_dd
from fractalrenderer_tpu_torch.ops import dd, perturbation

TINY = np.float32(2.0 ** -126)  # the smallest normal f32


def _pairs(seed, n, lo, hi):
    """n f32 pairs, signed, with mantissas uniform in [1, 2) and exponents
    uniform in [lo, hi]."""
    rng = np.random.default_rng(seed)

    def draw():
        m = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
        return np.ldexp(m, rng.integers(lo, hi + 1, n)).astype(np.float32)

    return draw(), draw()


def _port(a, b):
    p, e = dd.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    assert p.dtype == e.dtype == torch.float32
    return p.numpy(), e.numpy()


def _normal(x):
    return (x == 0) | (np.abs(x) >= TINY)


def _exact_error(a, b, p):
    """a * b - p, exact in f64 (24 + 24 bits, then a subtraction of two
    values on the product's grid)."""
    return a.astype(np.float64) * b.astype(np.float64) - p.astype(np.float64)


@pytest.mark.parametrize("seed,lo,hi", [(0, -60, 30), (1, -30, 30),
                                        (2, -60, -40), (3, 0, 60)])
def test_two_prod_equals_jax_dekker_in_the_normal_range(seed, lo, hi):
    a, b = _pairs(seed, 200_000, lo, hi)
    p, e = _port(a, b)
    jp, je = jax_dd.two_prod(np, a, b)
    keep = _normal(p) & _normal(_exact_error(a, b, p)) & (p != 0)
    assert keep.mean() > 0.5
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(e[keep], je[keep])
    for i in np.flatnonzero(keep)[:500]:
        assert Fraction(float(p[i])) + Fraction(float(e[i])) \
            == Fraction(float(a[i])) * Fraction(float(b[i]))


def test_two_prod_error_is_correctly_rounded_in_the_subnormal_zone():
    # products near 2^-100 ... 2^-126: their errors fall below 2^-126
    a, b = _pairs(4, 200_000, -63, -50)
    p, e = _port(a, b)
    zone = ~_normal(_exact_error(a, b, p)) & _normal(p)
    assert zone.sum() > 1000
    for i in np.flatnonzero(zone)[:2000]:
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            - Fraction(float(p[i]))
        assert float(e[i]) == jax_dd._f32_round_fraction(exact)
    _, je = jax_dd.two_prod(np, a, b)
    assert (e[zone] != je[zone]).any()  # where Dekker's split rounds twice


# the card test's view (tests/test_torch_cuda.py
# test_dd_tier_subnormal_product_errors_kernel_equals_plain)
SUBNORMAL_VIEW = ("-1.74975914513036646165693", "0", "1e-20", 600)


def test_dd_tier_view_at_1e20_reaches_subnormal_product_errors(monkeypatch):
    from fractalrenderer_tpu_torch.deepzoom.orbit import compute_orbit

    real, seen = dd.two_prod, []

    def counted(a, b):
        p, e = real(a, b)
        seen.append(int(((e != 0) & (e.abs() < float(TINY))).sum()))
        return p, e

    monkeypatch.setattr(dd, "two_prod", counted)
    cx, cy, zoom, iters = SUBNORMAL_VIEW
    orb = compute_orbit(cx, cy, 256, iters + 1)
    params, streams, launch = perturbation.pack_pert_operands(
        orb, 12, 8, center_x_dd=dd.dd_from_string(cx),
        center_y_dd=dd.dd_from_string(cy), zoom_dd=dd.dd_from_string(zoom),
        max_iter=iters, dd_delta=True)
    assert launch["tier"] == "dd"
    n = perturbation.perturbation_fields_plain(
        params, streams, max_passes=256, device="cpu", **launch)[0]
    assert sum(seen) > 1000
    assert int(n.min()) < iters  # pixels escape: the view is not interior
