"""The lens cell (`mesh1m.path`): the reference's thin-lens, moving camera
against the system's camera rays, whole runs on the CPU with the terrain cut
to grid=24 (3,266 triangles), and the faults that the check has to catch: the
lens taken off, the shutter's time frozen at its open, the close pose
dropped. The same control and faults at the cell's own size are marked
`card`."""
import collections
import importlib.util
import math
import sys
import types

import numpy as np
import pytest
import torch

from portbench import manifest, run, scenes
from portbench.reference.lens import LensCamera

CPU = "cpu"
SEED = 2 ** 31 + 1931
CELL = "mesh1m.path"
SMALL = {"res": 16, "spp": 2, "check_pixels": 256}    # every pixel
FAULTS = ["lens_off", "time_frozen", "end_pose_dropped"]


def _camera(rng, turn_deg, lens):
    """A seeded camera description whose close pose has moved round the look
    point by `turn_deg` about a random axis (the camera turns by about as
    much), with a lens radius, a focal distance and a shutter."""
    look = rng.uniform(-2.0, 2.0, 3)
    d0 = rng.normal(size=3)
    d0 /= np.linalg.norm(d0)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    a = math.radians(turn_deg)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + math.sin(a) * k + (1 - math.cos(a)) * k @ k
    return {"pos0": look + rng.uniform(3.0, 9.0) * d0,
            "pos1": look + rng.uniform(3.0, 9.0) * (rot @ d0),
            "look": look, "up": rng.normal(size=3), "fov": float(rng.uniform(20.0, 80.0)),
            "lens_radius": lens, "focal_distance": float(rng.uniform(1.0, 20.0)),
            "shutter": sorted(rng.uniform(-1.0, 2.0, 2))}


# seeded cameras whose turn lies past the slerp's linear threshold (a
# quaternion cosine of 0.9995: about 3.6 degrees) or inside it, with and
# without a lens
CASES = [(0, 40.0, 0.0, "arc"), (1, 40.0, 0.05, "arc"), (2, 120.0, 0.3, "arc"),
         (3, 170.0, 0.02, "arc"), (4, 1.5, 0.04, "linear"), (5, 0.5, 0.1, "linear")]


@pytest.mark.parametrize("seed,turn,lens,branch", CASES)
def test_camera_rays_match_the_system(seed, turn, lens, branch):
    from grail_torch.core import transform as tr
    from grail_torch.engine import camera as cam
    from grail_torch.scene.buffers import to_torch
    from portbench.reference.lens import SLERP_LINEAR_COS, decompose
    from portbench.reference.geometry import look_at
    c, res, n = _camera(np.random.default_rng(seed), turn, lens), 32, 4096
    q0, q1 = (decompose(look_at(c[k], c["look"], c["up"]))[1] for k in ("pos0", "pos1"))
    assert (abs(float(q0 @ q1)) > SLERP_LINEAR_COS) == (branch == "linear")
    pack = cam.build_camera(cam.PERSPECTIVE, tr.look_at(c["pos0"], c["look"], c["up"]),
                            tr.look_at(c["pos1"], c["look"], c["up"]), res, res, fov=c["fov"],
                            lens_radius=lens, focal_distance=c["focal_distance"],
                            shutter_open=c["shutter"][0], shutter_close=c["shutter"][1])
    g = torch.Generator().manual_seed(seed)
    px = torch.randint(0, res, (n,), generator=g, dtype=torch.int32)
    py = torch.randint(0, res, (n,), generator=g, dtype=torch.int32)
    u = torch.rand((5, n), generator=g)
    got = cam.generate_rays(to_torch(pack, CPU), px, py, u[0], u[1], u[2], u[3], u[4],
                            cam.PERSPECTIVE)
    ref = LensCamera(c, res, res, torch.device(CPU), torch.float32)
    ref.draws = (u[2], u[3], u[4])
    o, d = ref.rays(px.float() + u[0], py.float() + u[1])
    # float32 through ~30 dependent operations (raster to camera, the lens,
    # slerp, the TRS product), each side rounding in its own order, the poses
    # decomposed by another method (SVD here, pbrt's iteration there): the
    # gaps read up to 6e-7 on the directions and 1.1e-7 |pos| on the
    # origins; the bounds are about eight and twenty times that (freezing
    # the time moves the directions by 2e-3 at the smallest turn)
    scale = 1.0 + float(max(np.abs(c["pos0"]).max(), np.abs(c["pos1"]).max()))
    assert torch.allclose(got["o"], o, rtol=0, atol=2e-6 * scale), (got["o"] - o).abs().max()
    assert torch.allclose(got["d"], d, rtol=0, atol=5e-6), (got["d"] - d).abs().max()


@pytest.fixture
def small_grid(monkeypatch):
    """mesh1m with its terrain cut to grid=24, everything else as configured."""
    real = scenes.load_config

    def cut(name):
        params, mod = real(name)
        return (dict(params, grid=24) if name == "mesh1m" else params), mod
    monkeypatch.setattr(scenes, "load_config", cut)


def _plant(fault, monkeypatch):
    """The system's camera rays (or image) broken as `fault` says, after the
    set-up's check of the camera."""
    from grail_torch.engine import camera as cam
    import grail_torch.engine.render as rnd
    if fault == "altered":              # the answer altered where it is made
        real_render = rnd.render

        def altered(*a, **kw):
            img, film = real_render(*a, **kw)
            return img * 1.01, film
        monkeypatch.setattr(rnd, "render", altered)
        return
    real = cam.generate_rays

    def broken(camera, px, py, ufx, ufy, ul1, ul2, ut, kind):
        if fault == "lens_off":
            camera = dict(camera, lens_radius=torch.zeros_like(camera["lens_radius"]))
        elif fault == "time_frozen":
            ut = torch.zeros_like(ut)
        else:                           # end_pose_dropped: the close pose is the open one
            c2w = camera["c2w"]
            camera = dict(camera, c2w=dict(c2w, **{k: c2w[k][[0, 0]] for k in ("t", "q", "s")}))
        return real(camera, px, py, ufx, ufy, ul1, ul2, ut, kind)
    monkeypatch.setattr(cam, "generate_rays", broken)


def test_a_sound_run_is_correct(small_grid, monkeypatch):
    """Correct, and every intersect launch on the 4-wide route."""
    from grail_torch.kernels import intersect as isect
    walks, real = [], isect.bvh4_traverse

    def walk(*a, **kw):
        walks.append(a[2].shape[0])
        return real(*a, **kw)

    def brute(*a, **kw):
        raise AssertionError("a brute-force launch on the lens cell")
    monkeypatch.setattr(isect, "bvh4_traverse", walk)
    monkeypatch.setattr(isect, "brute_intersect", brute)
    result, numbers = run.execute(CELL, SEED, 0.2, 0, CPU, traffic=SMALL)
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and walks


def test_a_traced_run_reports_the_camera(small_grid):
    from grail_torch import telemetry
    telemetry.reset()
    result, numbers = run.execute(CELL, SEED + 1, 0.2, 1, CPU, traffic=SMALL)
    assert result["correct"], numbers
    assert result["metrics"]["camera_ms_per_mray.render"]["value"] > 0.0
    names = {s.name for s in telemetry.SPANS}
    assert {"camera", "camera/lens", "camera/motion"} <= names


def test_a_still_pinhole_fails_at_set_up(small_grid, monkeypatch):
    from grail_torch.engine import camera as cam
    real = cam.build_camera
    monkeypatch.setattr(cam, "build_camera", lambda *a, **kw: real(*a, **dict(kw, lens_radius=0.0)))
    with pytest.raises(ValueError, match="no lens"):
        run.execute(CELL, SEED, 0.1, 0, CPU, traffic=SMALL)


@pytest.mark.parametrize("fault", FAULTS + ["altered"])
def test_a_broken_camera_is_not_correct(fault, small_grid, monkeypatch):
    _plant(fault, monkeypatch)
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
@pytest.mark.parametrize("fault", FAULTS + ["altered"])
def test_a_broken_camera_fails_at_the_cells_size(fault, seed, card, monkeypatch):
    _plant(fault, monkeypatch)
    result, numbers = run.execute(CELL, seed, 1.0, 0, str(card))
    print("fault", fault, seed, numbers)
    assert not result["correct"], numbers


MS = 1_000_000      # ns


def _camera_reader():
    name = "camera_ms_per_mray.render"
    spec = importlib.util.spec_from_file_location("portbench_layer_" + name,
                                                  manifest.layer_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(sid, name, parent, start, end):
    return types.SimpleNamespace(name=name, id=sid, parent=parent, root=1, thread=7,
                                 start=start, end=end, lanes=None)


@pytest.fixture
def log(monkeypatch):
    telemetry = pytest.importorskip("grail_torch.telemetry")
    spans = collections.deque(maxlen=telemetry.SPANS.maxlen)
    monkeypatch.setattr(telemetry, "SPANS", spans)
    return spans


def test_camera_ms_per_mray_sums_the_camera_spans(log):
    # two camera spans, 10 and 4 ms, with their lens, motion and reads inside
    log.extend([_span(3, "sync/lens", 2, 1 * MS, 2 * MS), _span(4, "camera/lens", 2, 2 * MS, 5 * MS),
                _span(5, "camera/motion", 2, 6 * MS, 10 * MS), _span(2, "camera", 1, 0, 10 * MS),
                _span(6, "camera", 1, 20 * MS, 24 * MS), _span(1, "render", None, 0, 30 * MS)])
    ctx = types.SimpleNamespace(mrays=2048 / 1e6)
    assert _camera_reader()(ctx) == pytest.approx(14.0 / (2048 / 1e6))


def test_camera_ms_per_mray_none_without_camera_spans(log, monkeypatch):
    ctx = types.SimpleNamespace(mrays=1.0)
    assert _camera_reader()(ctx) is None
    log.append(_span(1, "render", None, 0, MS))
    assert _camera_reader()(ctx) is None
    monkeypatch.setitem(sys.modules, "grail_torch.telemetry", None)
    assert _camera_reader()(ctx) is None
