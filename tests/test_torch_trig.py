"""The port's polynomial atan/atan2 (ops/trig.py) against the JAX
package's, which the Phoenix flow stripes use on every render path.

Against the jax.numpy version (f32 throughout) the two are bit-equal;
against the numpy version (which folds its quadrant constants into f64)
within 1e-6; against the true numpy.arctan2 within the polynomial's own
error, which reaches ~1.8e-6 (atol 5e-6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fractalrenderer_tpu.ops import trig as jax_trig
from fractalrenderer_tpu_torch.ops import trig

ATOL_TRUE = 5e-6


def _points(seed, n=4096):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-6, 3, n)
    ang = rng.uniform(-np.pi, np.pi, n)
    y = (mag * np.sin(ang)).astype(np.float32)
    x = (mag * np.cos(ang)).astype(np.float32)
    # the edges: axes, origin, tiny and negative-tiny x
    edge_x = np.array([0.0, 0.0, 0.0, -0.0, 1e-39, -1e-39, 1.0, -1.0, -2.0],
                      np.float32)
    edge_y = np.array([1.0, -1.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, -0.0],
                      np.float32)
    return np.concatenate([y, edge_y]), np.concatenate([x, edge_x])


@pytest.mark.parametrize("seed", [0, 1])
def test_atan2_matches_jax_trig(seed):
    y, x = _points(seed)
    got = trig.atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    want_jnp = np.asarray(jax_trig.atan2(jnp, jnp.asarray(y),
                                         jnp.asarray(x)))
    np.testing.assert_array_equal(got, want_jnp)
    want_np = jax_trig.atan2(np, y, x)
    np.testing.assert_allclose(got, want_np, rtol=0, atol=1e-6)
    # numpy.arctan2 tells -0.0 from 0.0 (the branch cut at x < 0, and
    # (0, -0)); the polynomial, as in the JAX package, does not
    signed_zero = (y == 0) & (np.signbit(y) | np.signbit(x))
    np.testing.assert_allclose(got[~signed_zero],
                               np.arctan2(y, x)[~signed_zero], rtol=0,
                               atol=ATOL_TRUE)


def test_atan_matches_jax_trig():
    x = np.random.default_rng(3).standard_cauchy(4096).astype(np.float32)
    got = trig.atan(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_trig.atan(np, x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.arctan(x), rtol=0, atol=ATOL_TRUE)


def test_quadrant_constants_are_f32():
    assert trig.PI == float(np.float32(np.pi))
    assert trig.PI_2 == float(np.float32(np.pi / 2))
