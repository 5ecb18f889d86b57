"""The port's spans (grail_torch/telemetry.py) on one 64x64, 1-spp Cornell
render with compaction from 4,096 lanes, so that the post-Russian-roulette
split is taken.

With no profiler recording, `span` hands out one shared null context, no
`record_function` is made and the log stays empty. Under torch.profiler the
log nests render > megawave > bounce/0 > wave/camera, every span of the
render carries its root's id, each wave span's lanes are the width the
intersect dispatch got, each split reads its survivor count once inside
`sync/compaction`, the Chrome trace holds the same `grail:` ranges, each
inside its parent's, and the image is bitwise the unprofiled one.
tools/profile_render.py's reduction of the log and the trace counts each
span's calls, and its self times add up to the render's.
"""
import collections
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grail_torch import telemetry
from grail_torch.engine import integrator
from grail_torch.engine.integrator import IntegratorConfig
from grail_torch.engine.render import render
from grail_torch.kernels import intersect as isect
from grail_torch.scene.presets import cornell_box
from grail_torch.tools import profile_render

torch.set_num_threads(2)

RES = 64
CFG = IntegratorConfig(kind="path", max_depth=5, compact_min=4096)


def _no_range(name):
    raise AssertionError(f"record_function({name!r}) made with no profiler recording")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(unprofiled image, profiled image, spans, the trace's complete
    events, widths handed to the dispatch, splits tried)."""
    scene, meta, _ = cornell_box(RES, RES, 1, device="cpu")
    telemetry.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(telemetry, "record_function", _no_range)
        plain, _ = render(scene, meta, CFG, spp=1, device="cpu")
    assert not telemetry.SPANS
    widths, splits = [], []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("intersect", "intersect_p"):
            fn = getattr(isect, name)
            mp.setattr(isect, name, lambda s, o, *a, _fn=fn, **k:
                       widths.append(o.shape[0]) or _fn(s, o, *a, **k))
        take = integrator._compaction_take
        mp.setattr(integrator, "_compaction_take",
                   lambda active, cap: splits.append(cap) or take(active, cap))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            img, _ = render(scene, meta, CFG, spp=1, device="cpu")
    spans = list(telemetry.SPANS)
    telemetry.reset()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    return plain, img, spans, events, widths, splits


def test_no_profiler_no_span():
    telemetry.reset()
    assert telemetry.span("render") is telemetry.span("wave/camera", lanes=8)
    with telemetry.span("render"):
        assert telemetry.sync("compaction", int, torch.tensor(7)) == 7
    assert not telemetry.SPANS


def test_image_bitwise_unprofiled(traced):
    plain, img = traced[:2]
    assert torch.equal(plain, img)


def test_spans_nest(traced):
    spans = traced[2]
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.parent is None]
    assert root.name == "render"
    assert all(s.root == root.id and s.thread == root.thread for s in spans)
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end, (p.name, s.name)
    (cam,) = [s for s in spans if s.name == "wave/camera"]
    chain = []
    while cam.parent is not None:
        cam = by_id[cam.parent]
        chain.append(cam.name)
    assert chain == ["bounce/0", "megawave", "render"]


def test_wave_lanes_are_the_dispatch_widths(traced):
    spans, widths = traced[2], traced[4]
    waves = sorted((s for s in spans if s.name.startswith("wave/")), key=lambda s: s.start)
    assert [s.lanes for s in waves] == widths
    assert widths[0] == RES * RES
    # the taken split hands the dispatch a quarter-width wave
    assert min(widths) == CFG.compact_frac * RES * RES


def test_one_sync_a_split(traced):
    spans, splits = traced[2], traced[5]
    syncs = [s for s in spans if s.name == "sync/compaction"]
    assert len(splits) == 1 and len(syncs) == len(splits)


def test_chrome_trace_holds_the_spans(traced):
    spans = traced[2]
    ranges = [e for e in traced[3] if e["name"].startswith(telemetry.PREFIX)]
    names = collections.Counter(telemetry.PREFIX + s.name for s in spans)
    assert collections.Counter(e["name"] for e in ranges) == names
    # both in start order (a parent before a child that starts with it)
    spans = sorted(spans, key=lambda s: (s.start, s.start - s.end))
    ranges = sorted(ranges, key=lambda e: (e["ts"], -e["dur"]))
    assert [telemetry.PREFIX + s.name for s in spans] == [e["name"] for e in ranges]
    of = {s.id: e for s, e in zip(spans, ranges)}
    for s in spans:
        if s.parent is not None:
            p, e = of[s.parent], of[s.id]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3


def test_profile_render_reads_the_spans(traced):
    spans, events = traced[2], traced[3]
    table = profile_render.span_table(spans, profile_render.Timeline(events))
    calls = collections.Counter(s.name for s in spans)
    assert {k: v["calls"] for k, v in table.items() if "calls" in v} == calls
    (root,) = [s for s in spans if s.parent is None]
    total = sum(v.get("host_self_ms", 0.0) for v in table.values())
    assert total == pytest.approx((root.end - root.start) * 1e-6, rel=1e-9)
