"""The port's Cornell box against the reference's, carried across by
scene_from_numpy: integer leaves exactly equal, float leaves to rtol 1e-6
(both packages build on the host in numpy, so they should hold the same
bits), and the same SceneMeta. A reference scene with clustered record
tables carries across with one 4-wide table; unported routes raise."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import grail.kernels.bvh_stream as jbs
from grail.dist.scene_shard import partition_scene as jax_partition
from grail.scene.presets import cornell_box as jax_cornell
from grail.scene.presets import mesh_scene as jax_mesh_scene
from grail.scene.presets import mesh_scene_1m as jax_mesh_scene_1m
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.buffers import SceneBuilder
from grail_torch.scene.presets import cornell_box, mesh_scene, mesh_scene_1m

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def both():
    js, jm, _ = jax_cornell(16, 16, 4)
    scene_np = jax.tree_util.tree_map(np.asarray, js)
    ts, tm, _ = cornell_box(16, 16, 4, device="cpu")
    return scene_np, jm, ts, tm


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_scene_leaves_match(both):
    scene_np, jm, ts, _ = both
    bridged, _ = scene_from_numpy(scene_np, jm, device="cpu")
    ported = dict(_leaves(ts))
    carried = dict(_leaves(bridged))
    assert ported.keys() == carried.keys()
    assert "lights/acdf" in ported and "camera/c2w/m0" in ported
    for name, got in ported.items():
        ref = carried[name].numpy()
        got = got.numpy()
        assert got.shape == ref.shape, name
        if np.issubdtype(ref.dtype, np.floating):
            assert got.dtype == np.float32, name
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)


def test_scene_meta_matches(both):
    _, jm, _, tm = both
    for field in dataclasses.fields(tm):
        got = getattr(tm, field.name)
        ref = getattr(jm, field.name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(ref), field.name
        elif field.name == "tex_specs":
            assert [dataclasses.asdict(s) for s in got] == \
                [dataclasses.asdict(s) for s in ref]
        else:
            assert got == ref, field.name


@pytest.mark.parametrize("preset", ["cornell", "mesh"])
def test_mat_specs_match_reference(preset):
    """Each material's lobe slots (SceneMeta.mat_specs), from the port's
    preset and through the bridge, as the reference's, tuple for tuple."""
    if preset == "cornell":
        (js, jm, _), (_, tm, _) = jax_cornell(8, 8, 1), cornell_box(8, 8, 1, device="cpu")
    else:
        (js, jm, _), (_, tm, _) = (jax_mesh_scene(8, 8, 1, grid=8),
                                   mesh_scene(8, 8, 1, grid=8, device="cpu"))
    _, bm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), jm, device="cpu")
    assert tm.mat_specs == bm.mat_specs == jm.mat_specs
    assert len(jm.mat_specs) == len(js["materials"]["lobe_type"])
    assert all(isinstance(v, int) for spec in tm.mat_specs for slot in spec for v in slot)


def test_clustered_scene_carries(monkeypatch):
    """A reference scene above its (here cut) VMEM budget holds clustered
    record tables; it carries across with the one 4-wide table of its binary
    tree, equal to the port's own build of the same scene, and neither
    record table."""
    monkeypatch.setattr(jbs, "VMEM_TABLE_BUDGET", 4096)
    monkeypatch.setattr(jbs, "CLUSTER_TARGET_TRIS", 1000)
    js, jm, _ = jax_mesh_scene_1m(8, 8, 1, grid=12)
    assert js["bvh"]["cstream"].shape[0] >= 3 and "stream" not in js["bvh"]
    bridged, _ = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), jm,
                                  device="cpu")
    own, _, _ = mesh_scene_1m(8, 8, 1, grid=12, device="cpu")
    assert set(bridged["bvh"]) == {"bvh4_nodes", "bvh4_tris", "bvh4_stack"}
    for k in ("bvh4_nodes", "bvh4_tris"):
        assert torch.equal(bridged["bvh"][k].view(torch.int32),
                           own["bvh"][k].view(torch.int32)), k
    assert int(bridged["bvh"]["bvh4_stack"]) == int(own["bvh"]["bvh4_stack"])


def test_unported_scenes_raise(both):
    scene_np, jm, _, _ = both
    # the scene-sharded partition is ported: a reference ring leaf carries
    # across (tests/test_torch_scene_shard.py holds it leaf for leaf)
    ring = jax.tree_util.tree_map(np.asarray, jax_partition(scene_np, 2))
    got = scene_from_numpy(dict(scene_np, ring=ring), jm, device="cpu")[0]["ring"]
    np.testing.assert_array_equal(got["gid"].numpy(), ring["gid"])
    # a crop window is carried across (engine/render.py renders it)
    _, tm_crop = scene_from_numpy(scene_np, dataclasses.replace(jm, crop=(0.0, 0.5, 0.0, 1.0)),
                                  device="cpu")
    assert tm_crop.crop == (0.0, 0.5, 0.0, 1.0)
    # above 64 triangles a scene gets a BVH, as the reference: its 4-wide
    # tables and nothing else
    b = SceneBuilder()
    verts = np.random.RandomState(0).rand(65 * 3, 3)
    b.add_mesh(verts, np.arange(65 * 3).reshape(65, 3), b.matte())
    b.camera = cornell_box(16, 16, 1, device="cpu")[2].camera
    scene, _ = b.finalize(device="cpu")
    assert set(scene["bvh"]) == {"bvh4_nodes", "bvh4_tris", "bvh4_stack"}
