"""The brute-force intersector's plain PyTorch version against the Pallas
kernel run in interpret mode and against the reference's all-pairs oracle,
on the Cornell box triangles.

Tolerance: the hit primitive must agree on >= 99.9% of rays (an exact-edge or
exact-tie ray may resolve differently under another operation order), and
where it agrees t, b1, b2 match to rtol 1e-5, atol 1e-6 (float32 rounding of
the same Möller-Trumbore arithmetic).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.scene.presets import cornell_box
from grail.kernels import intersect as jisect
from grail.kernels.pallas_intersect import _run, pack_tris
from grail_torch.kernels import brute_intersect as tbi
from grail_torch.kernels import intersect as tisect
from grail_torch.scene.bridge import scene_from_numpy

torch.set_num_threads(2)

N_RAYS = 2000


@pytest.fixture(scope="module")
def setup():
    scene, meta, _ = cornell_box(xres=16, yres=16, spp=4)
    scene_np = jax.tree_util.tree_map(np.asarray, scene)
    rs = np.random.RandomState(7)
    o = (rs.rand(N_RAYS, 3) * [1.9, 1.9, 1.9] + [-0.95, 0.05, -0.95]).astype(np.float32)
    o[:100] = [0.0, 1.0, 3.9]                     # camera position, outside the box
    d = rs.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(N_RAYS, np.float32)
    tmax = np.full(N_RAYS, 1.0e7, np.float32)
    tmax[100:400] = rs.rand(300).astype(np.float32) * 2.0   # shadow-ray lengths
    tmax[400:450] = 0.0                                     # dead lanes
    tmin[450:500] = 0.5                                     # offset origins
    return {"scene": scene, "scene_np": scene_np, "meta": meta,
            "tris9": np.asarray(pack_tris(scene)),
            "o": o, "d": d, "tmin": tmin, "tmax": tmax}


def _torch(*arrays):
    return [torch.tensor(a) for a in arrays]


def _agree(prim_ref, prim, t_ref, t, b1_ref, b1, b2_ref, b2):
    same = prim_ref == prim
    assert same.mean() >= 0.999, f"prim agrees on {same.mean():.4%} of rays"
    np.testing.assert_allclose(t[same], t_ref[same], rtol=1e-5, atol=1e-6)
    # barycentrics of a miss are unspecified in the reference's oracle
    hit = same & (prim >= 0)
    for ref, got in ((b1_ref, b1), (b2_ref, b2)):
        np.testing.assert_allclose(got[hit], ref[hit], rtol=1e-5, atol=1e-6)


def test_plain_closest_hit_matches_pallas_interpret(setup):
    s = setup
    before = dict(tbi.LAUNCHES)
    t_j, prim_j, b1_j, b2_j = (np.asarray(a) for a in _run(
        jnp.asarray(s["tris9"]), jnp.asarray(s["o"]), jnp.asarray(s["d"]),
        jnp.asarray(s["tmin"]), jnp.asarray(s["tmax"]), interpret=True))
    t, prim, b1, b2 = (a.numpy() for a in tbi.brute_intersect(
        *_torch(s["tris9"], s["o"], s["d"], s["tmin"], s["tmax"])))
    _agree(prim_j, prim, t_j, t, b1_j, b1, b2_j, b2)
    assert (prim >= 0).mean() > 0.5 and (prim < 0).any()
    # miss convention: t = tmax, prim = -1, b1 = b2 = 0
    miss = prim < 0
    np.testing.assert_array_equal(t[miss], s["tmax"][miss])
    assert not b1[miss].any() and not b2[miss].any()
    # dead lanes (tmax = 0) never hit
    assert (prim[400:450] == -1).all()
    # on the CPU the wrapper runs the plain version, never the kernel
    assert tbi.LAUNCHES == before


def test_plain_matches_reference_oracle(setup):
    """Closest hit and any-hit against grail.kernels.intersect's all-pairs
    oracle, through the port's dispatch and the port's own oracle."""
    s = setup
    args_j = [jnp.asarray(s[k]) for k in ("o", "d", "tmax", "tmin")]
    ref = {k: np.asarray(v) for k, v in
           jisect.intersect_brute(s["scene"], *args_j).items()}
    occ_ref = np.asarray(jisect.intersect_p_brute(s["scene"], *args_j))

    scene_t, _ = scene_from_numpy(s["scene_np"], s["meta"], device="cpu")
    o, d, tmax, tmin = _torch(s["o"], s["d"], s["tmax"], s["tmin"])
    hit = {k: v.numpy() for k, v in
           tisect.intersect(scene_t, o, d, tmax, tmin, device="cpu").items()}
    _agree(ref["prim"], hit["prim"], ref["t"], hit["t"],
           ref["b1"], hit["b1"], ref["b2"], hit["b2"])
    assert (hit["t"][hit["prim"] < 0] == np.float32(tisect.BIG_T)).all()
    occ = tisect.intersect_p(scene_t, o, d, tmax, tmin, device="cpu").numpy()
    assert (occ == occ_ref).mean() >= 0.999

    oracle = {k: v.numpy() for k, v in
              tisect.intersect_brute(scene_t, o, d, tmax, tmin).items()}
    _agree(ref["prim"], oracle["prim"], ref["t"], oracle["t"],
           ref["b1"], oracle["b1"], ref["b2"], oracle["b2"])
    np.testing.assert_array_equal(
        tisect.intersect_p_brute(scene_t, o, d, tmax, tmin).numpy(), occ_ref)


def test_any_hit_is_first_hit_in_index_order(setup):
    """Any-hit reports the lowest-index triangle the ray hits within
    (tmin, tmax), which is where the kernel stops."""
    s = setup
    tris9, o, d, tmin, tmax = _torch(s["tris9"], s["o"], s["d"], s["tmin"], s["tmax"])
    t, prim, b1, b2 = tbi.brute_intersect_plain(tris9, o, d, tmin, tmax, any_hit=True)
    _, prim_c, _, _ = tbi.brute_intersect_plain(tris9, o, d, tmin, tmax)
    np.testing.assert_array_equal((prim >= 0).numpy(), (prim_c >= 0).numpy())
    hit_rows = np.nonzero(prim.numpy() >= 0)[0][:200]
    for r in hit_rows:
        k = int(prim[r])
        one = [a[r:r + 1] for a in (o, d, tmin, tmax)]
        for earlier in range(k):          # no lower-index triangle is hit
            _, p_e, _, _ = tbi.brute_intersect_plain(tris9[earlier:earlier + 1], *one)
            assert int(p_e[0]) == -1
        t_k, p_k, b1_k, b2_k = tbi.brute_intersect_plain(tris9[k:k + 1], *one)
        assert int(p_k[0]) == 0 and float(t_k[0]) == float(t[r])
        assert float(b1_k[0]) == float(b1[r]) and float(b2_k[0]) == float(b2[r])


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_stage_counts(setup, any_hit):
    """counts=True leaves the result alone and counts, per ray, the pairs the
    function needs (a live ray's every triangle; any hit, up to its first
    hit) that reach each stage of the hit test, against the same stages
    evaluated pair by pair in numpy."""
    s = setup
    args = _torch(s["tris9"], s["o"], s["d"], s["tmin"], s["tmax"])
    out = tbi.brute_intersect_plain(*args, any_hit=any_hit, counts=True)
    for a, b in zip(out[:4], tbi.brute_intersect_plain(*args, any_hit=any_hit)):
        assert torch.equal(a, b)
    n_b1, n_b2, n_t = (c.numpy() for c in out[4:])
    prim = out[1].numpy()
    tris, o, d = s["tris9"], s["o"][:, None], s["d"][:, None]
    v0, e1, e2 = tris[None, :, 0:3], tris[None, :, 3:6], tris[None, :, 6:9]
    s1 = np.stack([d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1],
                   d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2],
                   d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]], -1)
    div = s1[..., 0] * e1[..., 0] + s1[..., 1] * e1[..., 1] + s1[..., 2] * e1[..., 2]
    inv = np.float32(1.0) / np.where(div == 0.0, np.float32(1.0), div)
    sv = o - v0
    b1 = (sv[..., 0] * s1[..., 0] + sv[..., 1] * s1[..., 1] + sv[..., 2] * s1[..., 2]) * inv
    s2 = np.stack([sv[..., 1] * e1[..., 2] - sv[..., 2] * e1[..., 1],
                   sv[..., 2] * e1[..., 0] - sv[..., 0] * e1[..., 2],
                   sv[..., 0] * e1[..., 1] - sv[..., 1] * e1[..., 0]], -1)
    b2 = (d[..., 0] * s2[..., 0] + d[..., 1] * s2[..., 1] + d[..., 2] * s2[..., 2]) * inv
    on_b1 = (div != 0.0) & (b1 >= 0.0) & (b1 <= 1.0)
    on_b2 = on_b1 & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    n_tris = tris.shape[0]
    need = np.broadcast_to((s["tmax"] > s["tmin"])[:, None], on_b1.shape)
    if any_hit:
        last = np.where(prim >= 0, prim, n_tris - 1)
        need = need & (np.arange(n_tris)[None] <= last[:, None])
    np.testing.assert_array_equal(n_b1, need.sum(1))
    np.testing.assert_array_equal(n_b2, (need & on_b1).sum(1))
    np.testing.assert_array_equal(n_t, (need & on_b2).sum(1))
    # dead lanes need no pair; a live closest-hit ray needs every triangle
    assert not n_b1[400:450].any()
    if not any_hit:
        assert (n_b1[:400] == n_tris).all()
    assert (n_b1 >= n_b2).all() and (n_b2 >= n_t).all() and (n_t >= (prim >= 0)).all()
    assert n_b2.sum() < n_b1.sum()


def test_dispatch_refuses_unported_routes(setup, monkeypatch):
    s = setup
    scene_t, _ = scene_from_numpy(s["scene_np"], s["meta"], device="cpu")
    o, d, tmax = _torch(s["o"][:8], s["d"][:8], s["tmax"][:8])
    with pytest.raises(NotImplementedError):
        tisect.intersect(dict(scene_t, bvh={}), o, d, tmax, device="cpu")
    # without a card, the default device is refused rather than replaced
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tisect.intersect(scene_t, o, d, tmax)
    with pytest.raises(ValueError, match="triangles exceed"):
        tbi._check(torch.zeros(tbi.MAX_TRIS + 1, 9), *_torch(
            s["o"][:8], s["d"][:8], s["tmin"][:8], s["tmax"][:8]))


def test_pack_tris_matches_reference(setup):
    """The (T,9) [v0|e1|e2] table the kernel stages (as 48-byte rows) is the
    reference packer's, word for word, and the wrapper takes nothing else."""
    s = setup
    scene_t, _ = scene_from_numpy(s["scene_np"], s["meta"], device="cpu")
    tris9 = tisect.pack_tris(scene_t)
    assert tris9.shape == (36, 9) and tris9.is_contiguous()
    np.testing.assert_array_equal(tris9.numpy().view(np.uint32),
                                  s["tris9"].view(np.uint32))
    rays = _torch(s["o"][:8], s["d"][:8], s["tmin"][:8], s["tmax"][:8])
    with pytest.raises(ValueError, match="shape"):
        tbi._check(torch.nn.functional.pad(tris9, (0, 3)), *rays)
    with pytest.raises(ValueError, match="contiguous"):
        tbi._check(tris9.t().contiguous().t(), *rays)

