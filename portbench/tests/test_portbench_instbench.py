"""The instanced cell (`instbench.path`): whole runs on the CPU with the
sphere cut to nu=24, nv=12 (576 triangles), a 3x3 grid of instances near
the look point and the camera moved in, at 16x16 and 2 spp with every
pixel compared and a hit ray through every pixel's centre; the
reference's flattened triangles against the system's instances carried to
world space; the roots-aware roofline count against the walk's own counts;
and the faults that the check has to catch: one instance's transform
dropped, the rotations ignored, the sweep cut to its first round, the point
light 1% brighter, the image 1% brighter. The same faults and the control at
the cell's own size are marked `card`."""
import collections
import importlib.util
import types

import numpy as np
import pytest
import torch

from portbench import manifest, roofline_roots, run, scenes
from portbench.generators import render_inst
from portbench.reference.instances import flatten

CPU = "cpu"
SEED = 2 ** 31 + 2323
CELL = "instbench.path"
SMALL = {"res": 16, "spp": 2, "check_pixels": 256, "hit_rays": 256}    # every pixel
FAULTS = ["instance_dropped", "rotation_ignored", "sweep_first_round", "light_brighter",
          "altered"]


@pytest.fixture(autouse=True)
def empty_log():
    """The program's span log left empty: the readers' tests in other files
    read whatever a traced run leaves in it."""
    yield
    telemetry = pytest.importorskip("grail_torch.telemetry")
    telemetry.reset()


@pytest.fixture
def small_grid(monkeypatch):
    """instbench with its sphere cut to nu=24, nv=12, a 3x3 grid of
    instances 1.2 apart around the look point (their rotated boxes
    overlap, so rays take several sweep rounds) and the camera moved in
    to (0, 3.5, 4.5), so that the spheres fill the 16x16 film; everything
    else as configured."""
    real = scenes.load_config

    def cut(name):
        params, mod = real(name)
        if name == "instbench":
            params = dict(params, grid=3, instances=9, spacing=1.2, corner=[-1.2, 0.55, -1.2],
                          sphere=dict(params["sphere"], nu=24, nv=12),
                          camera=dict(params["camera"], pos=[0.0, 3.5, 4.5]))
        return params, mod
    monkeypatch.setattr(scenes, "load_config", cut)


def dropped_instance(grid):
    """The instance whose transform the fault drops: the middle of the row
    nearest the camera (the largest on the film)."""
    return grid * (grid - 1) + grid // 2


def _plant(fault, monkeypatch, grid):
    """The system broken as `fault` says, where the system makes what the
    fault breaks."""
    import grail_torch.engine.render as rnd
    from grail_torch.kernels import instanced
    from grail_torch.scene.buffers import SceneBuilder
    if fault == "altered":
        real_render = rnd.render

        def altered(*a, **kw):
            img, film = real_render(*a, **kw)
            return img * 1.01, film
        monkeypatch.setattr(rnd, "render", altered)
    elif fault == "light_brighter":
        real_light = SceneBuilder.add_point_light
        monkeypatch.setattr(SceneBuilder, "add_point_light",
                            lambda self, p, i: real_light(self, p, tuple(1.01 * x for x in i)))
    elif fault == "sweep_first_round":
        real_next = instanced.next_candidates

        def first_round_only(inst, o, d, tmin, t, last_near, last_id, occ=None):
            sel, near, act = real_next(inst, o, d, tmin, t, last_near, last_id, occ)
            if bool((last_id >= 0).any()):          # a later round
                act = torch.zeros_like(act)
            return sel, near, act
        monkeypatch.setattr(instanced, "next_candidates", first_round_only)
    else:
        real_add = SceneBuilder.add_instance
        calls = collections.Counter()

        def add(self, obj_id, m0, m1=None):
            m0 = np.array(m0, np.float32)
            k = calls[id(self)]
            calls[id(self)] += 1
            if fault == "rotation_ignored":
                m0[:3, :3] = np.eye(3)
            elif k == dropped_instance(grid):
                m0 = np.eye(4, dtype=np.float32)
            return real_add(self, obj_id, m0, m1)
        monkeypatch.setattr(SceneBuilder, "add_instance", add)


def test_a_sound_run_is_correct(small_grid, monkeypatch):
    """Correct, with the instanced walk from per-ray roots on every wave."""
    from grail_torch.kernels import instanced
    walks, real = [], instanced.bvh4_traverse

    def walk(*a, **kw):
        walks.append(kw["roots"] is not None)
        return real(*a, **kw)
    monkeypatch.setattr(instanced, "bvh4_traverse", walk)
    result, numbers = run.execute(CELL, SEED, 0.2, 0, CPU, traffic=SMALL)
    assert result["correct"], numbers
    assert numbers[0][1] < 1e-5, numbers
    assert result["attempted"] >= 1 and walks and all(walks)


def test_a_traced_run_reports_the_instancing_layer(small_grid):
    from grail_torch import telemetry
    telemetry.reset()
    result, numbers = run.execute(CELL, SEED + 1, 0.2, 1, CPU, traffic=SMALL)
    assert result["correct"], numbers
    m = result["metrics"]
    assert m["tlas_ms_per_mray.render"]["value"] > 0.0
    assert 0.0 < m["inst_lane_use.render"]["value"] <= 1.0
    names = {s.name for s in telemetry.SPANS}
    assert {"instanced", "sweep/closest", "sweep/any", "instance_to_world"} <= names


def test_a_flattened_scene_fails_at_set_up(small_grid, monkeypatch):
    """A builder that bakes the instances into the world soup leaves no
    instance table: set-up raises."""
    from grail_torch.scene.buffers import SceneBuilder

    def baked(self, obj_id, m0, m1=None):
        ob = self.inst_objects[obj_id]
        for v, i in zip(ob["verts"], ob["tri_idx"]):
            self.add_mesh(v @ np.asarray(m0)[:3, :3].T + np.asarray(m0)[:3, 3], i,
                          int(ob["tri_mat"][0][0]))
    monkeypatch.setattr(SceneBuilder, "add_instance", baked)
    with pytest.raises(ValueError, match="no instance table"):
        run.execute(CELL, SEED, 0.1, 0, CPU, traffic=SMALL)


def test_flattened_triangles_are_the_instances_in_world_space(small_grid):
    from grail_torch.kernels.instanced import gather_pack, o2w_point
    desc = scenes.describe("instbench", SEED, 16, 16)
    built = render_inst.build_program(desc, 2, torch.device(CPU))
    inst, scene = built.scene["inst"], built.scene
    flat = flatten(desc)[0]
    ob = desc["objects"]["sphere"]
    nv = len(ob["verts"])
    assert inst["root"].shape[0] == 9 and len(flat["verts"]) == 9 * nv
    # the object's rows follow the base soup's in the system's vertex table
    obj_v = scene["verts"][-nv:]
    assert torch.equal(obj_v, torch.as_tensor(ob["verts"]))
    for k in range(9):
        pk = gather_pack(inst, torch.full((nv,), k, dtype=torch.int64))
        world = o2w_point(pk, torch.zeros(nv), obj_v).double().numpy()
        np.testing.assert_allclose(world, flat["verts"][k * nv:(k + 1) * nv], rtol=0,
                                   atol=2e-6)
    np.testing.assert_array_equal(flat["idx"][:len(ob["idx"])], ob["idx"])
    # the rotations are real: no instance keeps the identity's 3x3
    m0 = np.stack([i["m0"] for i in desc["instances"]])
    assert np.abs(m0[:, :3, :3] - np.eye(3)).max(axis=(1, 2)).min() > 1e-2


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_roots_count_matches_the_walks_counts(small_grid, any_hit):
    """bvh4_counts from each ray's root against bvh4_traverse_plain's node
    visits (n_box_test = 4 a node) and triangle tests, on a sweep's first
    round of object-space rays (roots at node or leaf refs), and on the base
    route's tables from node 0."""
    from grail_torch.kernels import bvh4, instanced
    desc = scenes.describe("instbench", SEED, 16, 16)
    scene = render_inst.build_program(desc, 2, torch.device(CPU)).scene
    inst = scene["inst"]
    g = torch.Generator().manual_seed(7)
    n = 2048
    o = torch.rand((n, 3), generator=g) * torch.tensor([6.0, 3.0, 6.0]) - torch.tensor([3.0, 0.0, 3.0])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    tmax = torch.full((n,), 1e7)
    tmax[:300] = torch.rand(300, generator=g) * 2.0
    tmin = torch.zeros(n)
    sel, _, act = instanced.next_candidates(inst, o, d, tmin, tmax, torch.full((n,), -3e37),
                                            torch.full((n,), -1, dtype=torch.int32))
    assert bool(act.any()) and not bool(act.all())
    o_obj, d_obj, sub_tmax, roots = instanced.object_rays(inst, sel, act, o, d,
                                                          torch.zeros(n), tmax)
    cases = [(inst["bvh4_nodes"], inst["bvh4_tris"], o_obj, d_obj, sub_tmax, roots,
              inst["bvh4_stack"]),
             (scene["bvh"]["bvh4_nodes"], scene["bvh"]["bvh4_tris"], o, d, tmax, None,
              scene["bvh"]["bvh4_stack"])]
    for nodes, tris, ro, rd, rt, rr, stack in cases:
        ops, n_node, n_tri = roofline_roots.bvh4_counts(nodes, tris, ro, rd, tmin, rt,
                                                        any_hit, rr, stack)
        plain = bvh4.bvh4_traverse_plain(nodes, tris, ro, rd, tmin, rt, any_hit, stack=stack,
                                         roots=rr)
        assert torch.equal(4 * n_node, plain[5]) and torch.equal(n_tri, plain[6])
        stages = ops - 4 * 26 * n_node
        assert bool((stages >= 29 * n_tri).all()) and bool((stages <= 55 * n_tri).all())
    assert bool((roots < 0).any()) or inst["bvh4_nodes"].shape[0] > 1


def test_a_launch_bound_counts_the_roots_bytes():
    nodes, tris = torch.zeros((3, 32)), torch.zeros((5, 12))
    rays = (torch.zeros((1, 3)), torch.ones((1, 3)), torch.zeros(1), -torch.ones(1))
    la = {"any_hit": False, "n": 1000, "stack": 4, "tables": (nodes, tris)}
    plain = roofline_roots.launch_bound_s(dict(la, rays=rays + (None,)))
    rooted = roofline_roots.launch_bound_s(
        dict(la, rays=rays + (torch.zeros(1, dtype=torch.int32),)))
    assert plain == pytest.approx((1000 * 48 + 3 * 128 + 5 * 48) / 3.35e12)
    assert rooted - plain == pytest.approx(1000 * 4 / 3.35e12)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_route_is_not_correct(fault, small_grid, monkeypatch):
    _plant(fault, monkeypatch, 3)
    result, numbers = run.execute(CELL, SEED + 2, 0.1, 0, CPU, traffic=SMALL)
    assert not result["correct"], numbers


def test_the_control_is_not_correct(small_grid):
    _, numbers = run.execute(CELL, SEED + 3, 0.1, 0, CPU, control=True, traffic=SMALL)
    assert any(v > lim for _, v, lim in numbers), numbers


@pytest.mark.card
@pytest.mark.parametrize("seed", [SEED + 10, SEED + 11, SEED + 12])
def test_the_control_fails_at_the_cells_size(seed, card):
    _, numbers = run.execute(CELL, seed, 1.0, 0, str(card), control=True)
    print("control", CELL, seed, numbers)
    assert any(v > lim for _, v, lim in numbers), numbers


@pytest.mark.card
@pytest.mark.parametrize("seed", [SEED + 20, SEED + 21, SEED + 22])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_route_fails_at_the_cells_size(fault, seed, card, monkeypatch):
    _plant(fault, monkeypatch, 10)
    result, numbers = run.execute(CELL, seed, 1.0, 0, str(card))
    print("fault", fault, seed, numbers)
    assert not result["correct"], numbers


MS = 1_000_000      # ns


def _reader(name):
    spec = importlib.util.spec_from_file_location("portbench_layer_" + name,
                                                  manifest.layer_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(sid, name, parent, start, end, lanes=None):
    return types.SimpleNamespace(name=name, id=sid, parent=parent, root=1, thread=7,
                                 start=start, end=end, lanes=lanes)


@pytest.fixture
def log(monkeypatch):
    telemetry = pytest.importorskip("grail_torch.telemetry")
    spans = collections.deque(maxlen=telemetry.SPANS.maxlen)
    monkeypatch.setattr(telemetry, "SPANS", spans)
    return spans


def _two_sweeps():
    # a closest-hit sweep of 100 lanes, two rounds (60 and 10 lanes), and an
    # any-hit sweep of 50 lanes, one round (5 lanes); 1 + 2 + 1 ms of walk
    return [_span(4, "launch/bvh4", 3, 3 * MS, 4 * MS), _span(3, "sweep/closest", 2, 2 * MS, 5 * MS, 60),
            _span(6, "launch/bvh4", 5, 6 * MS, 8 * MS), _span(5, "sweep/closest", 2, 6 * MS, 9 * MS, 10),
            _span(2, "instanced", 1, 1 * MS, 10 * MS, 100),
            _span(9, "launch/bvh4", 8, 13 * MS, 14 * MS), _span(8, "sweep/any", 7, 12 * MS, 15 * MS, 5),
            _span(7, "instanced", 1, 11 * MS, 16 * MS, 50),
            _span(10, "launch/bvh4", 1, 20 * MS, 21 * MS), _span(1, "render", None, 0, 30 * MS)]


def test_tlas_ms_takes_the_walk_off_the_sweep(log):
    log.extend(_two_sweeps())
    ctx = types.SimpleNamespace(mrays=0.5)
    # 9 + 5 ms of sweep less 4 ms of walk inside it (the base walk outside
    # any sweep is not taken off)
    assert _reader("tlas_ms_per_mray.render")(ctx) == pytest.approx(10.0 / 0.5)


def test_inst_lane_use_is_the_used_over_the_handed_lanes(log):
    log.extend(_two_sweeps())
    ctx = types.SimpleNamespace(mrays=0.5)
    assert _reader("inst_lane_use.render")(ctx) == pytest.approx((60 + 10 + 5) / (100 * 2 + 50))


def test_the_instancing_readers_read_nothing_without_their_spans(log):
    ctx = types.SimpleNamespace(mrays=1.0)
    for name in ("tlas_ms_per_mray.render", "inst_lane_use.render"):
        assert _reader(name)(ctx) is None
    log.append(_span(1, "render", None, 0, MS))
    # an `instanced` span without rounds (a program without the round spans)
    log.append(_span(2, "instanced", 1, 0, MS))
    assert _reader("inst_lane_use.render")(ctx) is None
    assert _reader("tlas_ms_per_mray.render")(ctx) == pytest.approx(1.0)
