"""The port's spherical harmonics (grail_torch/core/sh.py) against the
reference's grail/core/sh.py.

sh_evaluate on 4,096 seeded directions with the poles and the equator's
axes among them, for each lmax up to 5, within rtol 1e-5, atol 1e-6 (the
port's tolerance for float stages: the recurrence's multiply-adds may
round differently from XLA's); the per-band helpers exactly (Python
floats in the reference's order); the cosine and Phong convolutions,
sh_reduce_ringing and sh_rotate_z on seeded coefficients at the same
tolerance; and the reference's own checks repeated on the port:
orthonormality by Monte Carlo integration, E = pi under constant unit
radiance, E(z) = 2 pi / 3 for L = max(0, w.z) and the z rotation of
f(w) = x into f(w) = y.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grail.core import sh as jsh
from grail_torch.core import sh as tsh
from tests.test_torch_goldens import _close

torch.set_num_threads(2)


def _directions(n=4096, seed=11):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    poles = np.array([[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [-1, 0, 0],
                      [0, -1, 0], [0, 1e-7, 1], [1e-4, -1e-4, -1]], np.float64)
    return np.concatenate([poles, w[len(poles):]]).astype(np.float32)


def test_constants_match_reference():
    for lmax in range(7):
        assert tsh.sh_terms(lmax) == jsh.sh_terms(lmax)
        assert tsh._cos_theta_zh(lmax) == jsh._cos_theta_zh(lmax)
        for l in range(lmax + 1):
            for m in range(-l, l + 1):
                assert tsh.sh_index(l, m) == jsh.sh_index(l, m)
                assert tsh._k(l, m) == jsh._k(l, m)


@pytest.mark.parametrize("lmax", (0, 1, 2, 3, 4, 5))
def test_sh_evaluate_matches_reference(lmax):
    w = _directions()
    got = tsh.sh_evaluate(torch.tensor(w), lmax)
    assert got.shape == (4096, tsh.sh_terms(lmax))
    _close(got, jsh.sh_evaluate(jnp.asarray(w), lmax), f"Y lmax={lmax}")


@pytest.mark.parametrize("op", ("cos_theta", "phong", "ringing", "rotate_z"))
def test_band_operators_match_reference(op):
    rng = np.random.default_rng(12)
    lmax = 4
    c = rng.normal(size=(7, tsh.sh_terms(lmax), 3)).astype(np.float32)
    tc, jc = torch.tensor(c), jnp.asarray(c)
    if op == "cos_theta":
        got, ref = tsh.sh_convolve_cos_theta(lmax, tc), jsh.sh_convolve_cos_theta(lmax, jc)
    elif op == "phong":
        got, ref = tsh.sh_convolve_phong(lmax, 12.5, tc), jsh.sh_convolve_phong(lmax, 12.5, jc)
    elif op == "ringing":
        got, ref = tsh.sh_reduce_ringing(tc, lmax), jsh.sh_reduce_ringing(jc, lmax)
    else:
        got, ref = tsh.sh_rotate_z(tc, lmax, 0.7), jsh.sh_rotate_z(jc, lmax, 0.7)
    _close(got, ref, op)


def test_sh_orthonormality():
    rng = np.random.default_rng(7)
    n = 200000
    w = rng.normal(size=(n, 3)).astype(np.float32)
    Y = tsh.sh_evaluate(torch.tensor(w), 4).double().numpy()
    gram = (Y.T @ Y) * (4 * math.pi / n)
    assert np.abs(gram - np.eye(tsh.sh_terms(4))).max() < 0.05


def test_sh_convolution_and_rotation_identities():
    # constant unit radiance: E(n) = pi for any n
    c = torch.zeros((tsh.sh_terms(4), 1))
    c[0, 0] = math.sqrt(4 * math.pi)
    ce = tsh.sh_convolve_cos_theta(4, c)
    for nvec in ([0, 0, 1], [0.3, 0.4, math.sqrt(1 - 0.25)], [1, 0, 0]):
        Y = tsh.sh_evaluate(torch.tensor([nvec], dtype=torch.float32), 4)[0]
        assert abs(float(Y @ ce[:, 0]) - math.pi) < 1e-3
    rng = np.random.default_rng(3)
    w = rng.normal(size=(200000, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    Y = tsh.sh_evaluate(torch.tensor(w, dtype=torch.float32), 4).double().numpy()
    # L(w) = max(0, w.z): E(z) = 2 pi / 3
    cz = (Y * np.maximum(w[:, 2:3], 0.0)).mean(0) * 4 * math.pi
    ce = tsh.sh_convolve_cos_theta(4, torch.tensor(cz[:, None], dtype=torch.float32))
    Ez = tsh.sh_evaluate(torch.tensor([[0.0, 0.0, 1.0]]), 4)[0] @ ce[:, 0]
    assert abs(float(Ez) - 2 * math.pi / 3) < 0.03
    # f(w) = x rotated by pi/2 about z is f(w) = y
    Y3 = Y[:, :tsh.sh_terms(3)]
    cx = (Y3 * w[:, 0:1]).mean(0) * 4 * math.pi
    rot = tsh.sh_rotate_z(torch.tensor(cx[:, None], dtype=torch.float32), 3, math.pi / 2)
    fy = tsh.sh_evaluate(torch.tensor([[0.0, 1.0, 0.0]]), 3)[0] @ rot[:, 0]
    assert abs(float(fy) - 1.0) < 0.02
