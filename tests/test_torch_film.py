"""The port's scattered film paths (grail_torch/engine/film.py: add_samples,
splat, merge, develop(splat_scale=)) against the reference's.

4,096 samples made from a seed with numpy, about a tenth of them off the
24x16 image, over a film that already holds samples: add_samples under the
box, gaussian and mitchell filters, with and without per-sample weights
(adaptive sampling's padding mask), splat, merge of three films and
develop with a splat scale, each allclose to the reference's at rtol 1e-6
(both packages add the samples of a pixel in lane order on the CPU).
Then the scatter against the port's own dense path (add_samples_grid) on a
full-grid wave: the same sums in another order, rtol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from grail.engine import film as jfilm
from grail.engine import filters as jflt
from grail_torch.engine import film as tfilm
from grail_torch.engine import filters as tflt

torch.set_num_threads(2)

W, H, N = 24, 16, 4096


def _samples(seed):
    rng = np.random.default_rng(seed)
    sx = rng.uniform(-1.5, W + 1.5, N).astype(np.float32)
    sy = rng.uniform(-1.5, H + 1.5, N).astype(np.float32)
    L = (rng.random((N, 3)) * 2.0).astype(np.float32)
    weight = (rng.random(N) < 0.8).astype(np.float32)
    film = {"rgb": rng.random((H, W, 3)).astype(np.float32),
            "weight": rng.random((H, W)).astype(np.float32) + 0.5,
            "splat": rng.random((H, W, 3)).astype(np.float32)}
    return sx, sy, L, weight, film


def _jax(film):
    return {k: jnp.asarray(v) for k, v in film.items()}


def _torch(film):
    return {k: torch.tensor(v) for k, v in film.items()}


def _assert_films(got, ref, rtol):
    for k in ("rgb", "weight", "splat"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=rtol, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", ["box", "gaussian", "mitchell"])
def test_add_samples_matches_reference(name, weighted):
    sx, sy, L, weight, film = _samples(1)
    off = (sx < 0) | (sx >= W) | (sy < 0) | (sy >= H)
    assert 0.05 < off.mean() < 0.3
    w = weight if weighted else None
    ref = jfilm.add_samples(_jax(film), jflt.FilterConfig.from_name(name), jnp.asarray(sx),
                            jnp.asarray(sy), jnp.asarray(L),
                            None if w is None else jnp.asarray(w))
    got = tfilm.add_samples(_torch(film), tflt.FilterConfig.from_name(name), torch.tensor(sx),
                            torch.tensor(sy), torch.tensor(L),
                            None if w is None else torch.tensor(w))
    _assert_films(got, ref, rtol=1e-6)
    assert not np.array_equal(got["rgb"].numpy(), film["rgb"])


def test_splat_merge_develop_match_reference():
    sx, sy, L, _, film = _samples(2)
    ref = jfilm.splat(_jax(film), jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(L))
    got = tfilm.splat(_torch(film), torch.tensor(sx), torch.tensor(sy), torch.tensor(L))
    _assert_films(got, ref, rtol=1e-6)
    films = [_samples(s)[4] for s in (3, 4, 5)]
    merged = tfilm.merge([_torch(f) for f in films])
    _assert_films(merged, jfilm.merge([_jax(f) for f in films]), rtol=1e-6)
    np.testing.assert_allclose(tfilm.develop(got, splat_scale=0.37).numpy(),
                               np.asarray(jfilm.develop(ref, splat_scale=0.37)), rtol=1e-6)


@pytest.mark.parametrize("name", ["box", "gaussian"])
def test_scatter_matches_dense_path_on_a_full_grid(name):
    rng = np.random.default_rng(6)
    fcfg = tflt.FilterConfig.from_name(name)
    lane = torch.arange(W * H)
    sx = (lane % W).float() + torch.tensor(rng.random(W * H), dtype=torch.float32)
    sy = (lane // W).float() + torch.tensor(rng.random(W * H), dtype=torch.float32)
    L = torch.tensor(rng.random((W * H, 3)), dtype=torch.float32)
    empty = tfilm.new_film(W, H, "cpu")
    dense = tfilm.add_samples_grid(empty, fcfg, sx, sy, L, 1)
    scattered = tfilm.add_samples(empty, fcfg, sx, sy, L)
    for k in ("rgb", "weight"):
        np.testing.assert_allclose(scattered[k].numpy(), dense[k].numpy(), rtol=1e-5,
                                   err_msg=k)
    assert not empty["rgb"].any()          # out of place
