"""The port's training step (dist/sharding.make_train_step) at world size 1
against the reference's make_train_step over a one-device mesh, on two
parsed scenes: scenes/glossy.pbrt (the conductor, glass and mirror lobes,
path) and scenes/proctex.pbrt (the procedural textures, directlighting),
each at 16x16, 1 spp, depth 2, the scene's own integrator. The loss agrees
to rtol 1e-5 and the gradients for tex_data (const and w2t) lie within
PERF.md's gradient gate (rtol 1e-3, atol 2e-3 of the largest entry)
wherever the reference's are finite (ROADMAP C.4, C.5)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import grail.kernels.bvh_stream as jbs
import grail.kernels.intersect as jisect
from grail.dist.sharding import make_mesh as jax_mesh, make_train_step as jax_train_step
from grail.scene import parser as jparser
from grail_torch.dist.sharding import make_mesh, make_train_step
from grail_torch.scene import parser as tparser

RES, DEPTH = 16, 2


def _text(name):
    with open(f"scenes/{name}.pbrt") as f:
        text = f.read()
    text = text.replace('"integer xresolution" [64] "integer yresolution" [64]',
                        f'"integer xresolution" [{RES}] "integer yresolution" [{RES}]')
    for spp in (4, 8):
        text = text.replace(f'"integer pixelsamples" [{spp}]', '"integer pixelsamples" [1]')
    assert f"[{RES}]" in text and '"integer pixelsamples" [1]' in text
    return text


@pytest.mark.parametrize("name", ("glossy", "proctex"))
def test_train_step_matches_reference(name, monkeypatch):
    # glossy's spheres take a BVH. The reference's differentiable BVH
    # route on the CPU is its stream kernels in Pallas interpret mode (its
    # XLA traversal's while loop has no reverse mode), with the any hit's
    # rays given no gradient (the Pallas call has no JVP), as
    # tests/test_torch_grad.py runs it
    text = _text(name)
    js, jm, japi = jparser.parse_string(text, search_path="scenes")
    if js.get("bvh") is not None:
        occluded = jbs.bvh_stream_intersect_p
        monkeypatch.setattr(jisect, "_pallas_ok", lambda: True)
        monkeypatch.setenv("GRAIL_PALLAS_INTERPRET", "1")
        monkeypatch.setattr(jbs, "bvh_stream_intersect_p", lambda table, *rays, **kw: occluded(
            table, *map(jax.lax.stop_gradient, rays), **kw))
    torch.set_num_threads(2)
    ts, tm, tapi = tparser.parse_string(text, device="cpu", search_path="scenes")
    jcfg = dataclasses.replace(japi.integrator_config, max_depth=DEPTH)
    tcfg = dataclasses.replace(tapi.integrator_config, max_depth=DEPTH)
    assert tcfg.kind == jcfg.kind == ("path" if name == "glossy" else "direct")
    jloss, jgrads = jax_train_step(jm, jcfg, jax_mesh(1))(
        js, jnp.zeros((RES, RES, 3), jnp.float32), jnp.uint32(0))
    loss, grads = make_train_step(tm, tcfg, make_mesh(1, "cpu"))(
        ts, torch.zeros((RES, RES, 3)), 0)
    assert float(loss) > 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("const", "w2t"):
        g, ref = grads["tex_data"][k].numpy(), np.asarray(jgrads["tex_data"][k])
        assert g.shape == ref.shape and np.isfinite(g).all()
        ok = np.isfinite(ref)
        assert ok.mean() > 0.5
        np.testing.assert_allclose(g[ok], ref[ok], rtol=1e-3,
                                   atol=2e-3 * np.abs(ref[ok]).max(), err_msg=k)
    assert np.abs(grads["tex_data"]["const"].numpy()).sum() > 0
