"""The readers of the program's span log (portbench/spans.py and the five
layers that read it) on a hand-made log: self time, sums, lanes per camera
ray, and None where the log holds none of a reader's spans or the program
keeps no log."""
import collections
import importlib.util
import sys
import types

import pytest

from portbench import manifest

MS = 1_000_000      # ns


def _span(sid, name, parent, start, end, lanes=None):
    return types.SimpleNamespace(name=name, id=sid, parent=parent, root=1, thread=7,
                                 start=start, end=end, lanes=lanes)


# one render of one megawave: render 0-100 ms > megawave 5-95 > bounce/0 10-60
# (wave/camera 12-20, 4,096 lanes; shading_geometry 20-30), compaction 60-70
# (sync/compaction 61-64), bounce/1 70-80 (wave/continuation 71-73, 1,024
# lanes), film 80-90 (rng 81-82, not film); film 96-99 (develop)
LOG = [
    _span(2, "megawave", 1, 5 * MS, 95 * MS),
    _span(3, "bounce/0", 2, 10 * MS, 60 * MS),
    _span(4, "wave/camera", 3, 12 * MS, 20 * MS, lanes=4096),
    _span(5, "shading_geometry", 3, 20 * MS, 30 * MS),
    _span(6, "compaction", 2, 60 * MS, 70 * MS),
    _span(7, "sync/compaction", 6, 61 * MS, 64 * MS),
    _span(8, "bounce/1", 2, 70 * MS, 80 * MS),
    _span(9, "wave/continuation", 8, 71 * MS, 73 * MS, lanes=1024),
    _span(10, "film", 2, 80 * MS, 90 * MS),
    _span(11, "rng", 10, 81 * MS, 82 * MS),
    _span(12, "film", 1, 96 * MS, 99 * MS),
    _span(1, "render", None, 0, 100 * MS),
]
RAYS = 2048             # camera rays of the window: 2,048e-6 Mray


def _ctx():
    win = types.SimpleNamespace(rays=RAYS, requests=1)
    return types.SimpleNamespace(window=win, mrays=RAYS / 1e6)


def _reader(name):
    spec = importlib.util.spec_from_file_location("portbench_layer_" + name,
                                                  manifest.layer_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def log(monkeypatch):
    telemetry = pytest.importorskip("grail_torch.telemetry")
    spans = collections.deque(maxlen=telemetry.SPANS.maxlen)
    monkeypatch.setattr(telemetry, "SPANS", spans)
    return spans


def test_self_time(log):
    from portbench import spans
    log.extend(LOG)
    # megawave 90 - (50 + 10 + 10 + 10); bounce/0 50 - (8 + 10); compaction
    # 10 - 3; bounce/1 10 - 2
    assert spans.self_s(LOG, spans.integrator) == pytest.approx((10 + 32 + 7 + 8) * 1e-3)
    assert spans.self_s(LOG, lambda n: n == "film") == pytest.approx((9 + 3) * 1e-3)


@pytest.mark.parametrize("name,want", [
    ("sync_wait_ms_per_mray.render", 3.0),
    ("integrator_self_ms_per_mray.render", 57.0),
    ("integrator_self_ms_per_mray.train", 57.0),
    ("film_ms_per_mray.render", 12.0),
])
def test_ms_per_mray(log, name, want):
    log.extend(LOG)
    assert _reader(name)(_ctx()) == pytest.approx(want / (RAYS / 1e6))


def test_lanes_per_camera_ray(log):
    log.extend(LOG)
    assert _reader("lanes_per_camera_ray.render")(_ctx()) == pytest.approx(5120 / RAYS)


def test_no_sync_reads_zero(log):
    log.extend(s for s in LOG if not s.name.startswith("sync/"))
    assert _reader("sync_wait_ms_per_mray.render")(_ctx()) == 0.0


NAMES = ["sync_wait_ms_per_mray.render", "integrator_self_ms_per_mray.render",
         "integrator_self_ms_per_mray.train", "film_ms_per_mray.render",
         "lanes_per_camera_ray.render"]


@pytest.mark.parametrize("name", NAMES)
def test_none_without_spans(log, name):
    assert _reader(name)(_ctx()) is None
    # a log without the reader's spans (a program that records other ones)
    log.append(_span(1, "rng", None, 0, MS))
    assert _reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_when_the_log_ran_full(log, name):
    log.extend(LOG[i % len(LOG)] for i in range(log.maxlen))
    assert _reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_log(monkeypatch, name):
    """A program without grail_torch.telemetry gives None and raises
    nothing."""
    monkeypatch.setitem(sys.modules, "grail_torch.telemetry", None)
    assert _reader(name)(_ctx()) is None
