"""grail_torch.core.rng against grail.core.rng: every draw bitwise equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grail.core import rng as jrng
from grail_torch.core import rng as trng

torch.set_num_threads(2)

_KINDS = {"random": trng.RANDOM, "stratified": trng.STRATIFIED,
          "zero_two": trng.ZERO_TWO, "halton": trng.HALTON}


def _ids(n=3000, seed=0):
    """(pixel, sample, dim) triples as uint32, with ids near 2^31 and 2^32-1."""
    rs = np.random.RandomState(seed)
    pix = rs.randint(0, 2**32, size=n, dtype=np.uint64)
    samp = rs.randint(0, 64, size=n, dtype=np.uint64)
    dim = rs.randint(0, 200, size=n, dtype=np.uint64)
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
                    np.uint64)
    k = len(edge)
    pix[:k] = edge
    samp[k:2 * k] = edge
    dim[2 * k:3 * k] = edge
    pix[3 * k:4 * k] = edge
    samp[3 * k:4 * k] = edge[::-1]
    return [a.astype(np.uint32) for a in (pix, samp, dim)]


def _t(a):
    return torch.as_tensor(a.astype(np.int64))


def _same(j, t):
    j = np.asarray(j)
    t = t.numpy()
    assert j.shape == t.shape
    assert j.dtype == t.dtype == np.float32
    np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))


def test_hash_primitives_bitwise():
    pix, samp, dim = _ids()
    for jf, tf in ((jrng.pcg_hash, trng.pcg_hash),
                   (jrng.reverse_bits32, trng.reverse_bits32)):
        np.testing.assert_array_equal(np.asarray(jf(pix)).astype(np.int64),
                                      tf(_t(pix)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.hash_combine(pix, dim)).astype(np.int64),
        trng.hash_combine(_t(pix), _t(dim)).numpy())
    _same(jrng.sobol2(samp, pix), trng.sobol2(_t(samp), _t(pix)))
    _same(jrng.van_der_corput(samp, pix), trng.van_der_corput(_t(samp), _t(pix)))
    _same(jrng.u32_to_float(pix), trng.u32_to_float(_t(pix)))


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_sample_bitwise(kind):
    """sample_1d / sample_2d for one sampler kind, with per-lane (array) dims
    and with static Python-int dims (which pick HALTON's prime base)."""
    pix, samp, dim = _ids()
    jcfg = jrng.SamplerConfig(kind=_KINDS[kind], spp=16, seed=12345)
    tcfg = trng.SamplerConfig(kind=_KINDS[kind], spp=16, seed=12345)
    _same(jrng.sample_1d(jcfg, pix, samp, dim),
          trng.sample_1d(tcfg, _t(pix), _t(samp), _t(dim)))
    for jv, tv in zip(jrng.sample_2d(jcfg, pix, samp, dim),
                      trng.sample_2d(tcfg, _t(pix), _t(samp), _t(dim))):
        _same(jv, tv)
    for static_dim in (0, 1, 2, 7, 37, 45):
        _same(jrng.sample_1d(jcfg, pix, samp, static_dim),
              trng.sample_1d(tcfg, _t(pix), _t(samp), static_dim))
        for jv, tv in zip(jrng.sample_2d(jcfg, pix, samp, static_dim),
                          trng.sample_2d(tcfg, _t(pix), _t(samp), static_dim)):
            _same(jv, tv)


def test_sample_ints_stay_uint32():
    """A JAX uint32 array and a Python int give the same draws as int64
    tensors holding the same values."""
    cfg_j = jrng.SamplerConfig()
    cfg_t = trng.SamplerConfig()
    pix = np.arange(2**32 - 64, 2**32, dtype=np.uint64).astype(np.uint32)
    _same(jrng.sample_1d(cfg_j, jnp.asarray(pix), 3, 9),
          trng.sample_1d(cfg_t, _t(pix), 3, 9))
