"""The plain reference against the system on the CPU at 16x16, and the
check's control and faults: each has to come out as not correct. The tests
drive whole runs (set-up, window, check) with the harness's look for a card
skipped; the reference itself imports nothing of the system."""
import ast
import os

import numpy as np
import pytest
import torch

from portbench import run, scenes
from portbench.reference.render import Scene, pixel_means

CPU = "cpu"
SEED = 2 ** 31 + 977
SMALL = {"res": 16, "spp": 2, "check_pixels": 64}
TRAIN_SMALL = {"res": 16, "target_spp": 2}
RENDER_CELLS = ["cornell.path", "mesh100k.path", "mesh100k.direct"]


def small(cell):
    return TRAIN_SMALL if cell.endswith("train") else SMALL


def test_reference_imports_nothing_of_the_system():
    ref = os.path.join(os.path.dirname(os.path.dirname(__file__)), "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] not in ("grail_torch", "grail", "jax", "portbench"), (name, m)


@pytest.mark.parametrize("config,kind,strategy", [("cornell", "path", "one"),
                                                  ("cornell", "direct", "all"),
                                                  ("mesh100k", "path", "one"),
                                                  ("mesh100k", "direct", "all")])
def test_reference_matches_the_system(config, kind, strategy):
    from grail_torch.engine.integrator import IntegratorConfig
    from grail_torch.engine.render import render
    desc = scenes.describe(config, SEED, 16, 16)
    built = scenes.build_program(desc, 1, torch.device(CPU))
    img, _ = render(built.scene, built.meta, IntegratorConfig(kind=kind, light_strategy=strategy),
                    spp=1, device=CPU)
    ref = pixel_means(Scene(desc, torch.device(CPU)), np.arange(256), np.arange(1), kind, 5)
    got = img.reshape(-1, 3).double().numpy()
    assert np.abs(got - ref).sum() / np.abs(ref).sum() < 1e-5
    assert np.abs(ref).sum() > 0


@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell.train"])
def test_a_sound_run_is_correct(cell):
    result, numbers = run.execute(cell, SEED, 0.2, 0, CPU, traffic=small(cell))
    assert result["correct"], numbers
    assert result["attempted"] >= 1 and list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell.train"])
def test_the_control_is_not_correct(cell):
    _, numbers = run.execute(cell, SEED + 1, 0.1, 0, CPU, control=True, traffic=small(cell))
    assert any(v > lim for _, v, lim in numbers), numbers


def _render_fault(kind):
    import grail_torch.engine.render as rnd
    real = rnd.render

    def broken(scene, meta, cfg, spp=None, start_wave=0, **kw):
        if kind == "unchanged":          # the film comes back as it was handed in
            img, film = real(scene, meta, cfg, spp=start_wave + 1, start_wave=start_wave, **kw)
            return torch.zeros_like(img), film
        if kind == "half":               # half the samples, the mean of the rest
            return real(scene, meta, cfg, spp=start_wave + (spp - start_wave) // 2,
                        start_wave=start_wave, **kw)
        img, film = real(scene, meta, cfg, spp=spp, start_wave=start_wave, **kw)
        return img * 1.01, film          # the answer altered where it is made
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", ["cornell.path", "mesh100k.direct"])
def test_a_broken_render_is_not_correct(cell, fault, monkeypatch):
    import grail_torch.engine.render as rnd
    monkeypatch.setattr(rnd, "render", _render_fault(fault))
    result, numbers = run.execute(cell, SEED + 2, 0.1, 0, CPU,
                                  traffic=dict(SMALL, spp=4))
    assert not result["correct"], numbers


def _plant_training_fault(fault, monkeypatch):
    import grail_torch.engine.render as rnd
    real = rnd.render_wave
    if fault == "unchanged":             # the step leaves the albedos as they were
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half":                # half the pixels, the mean over the rest
        from portbench.generators import train
        monkeypatch.setattr(train, "mse", lambda img, target: torch.mean(
            (img[: img.shape[0] // 2] - target[: img.shape[0] // 2]) ** 2))
    else:                                # the rendered image altered where it is made

        def altered(scene, meta, cfg, film, samp, **kw):
            out = real(scene, meta, cfg, film, samp, **kw)
            return dict(out, rgb=out["rgb"] * 1.01) if torch.is_grad_enabled() else out
        monkeypatch.setattr(rnd, "render_wave", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    _plant_training_fault(fault, monkeypatch)
    result, numbers = run.execute("cornell.train", SEED + 3, 0.1, 0, CPU, traffic=TRAIN_SMALL)
    assert not result["correct"], numbers


@pytest.mark.card
@pytest.mark.parametrize("seed", [SEED + 10, SEED + 11, SEED + 12])
@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell.train"])
def test_the_control_fails_at_the_cells_size(cell, seed, card):
    _, numbers = run.execute(cell, seed, 2.0, 0, str(card), control=True)
    print("control", cell, seed, numbers)
    assert any(v > lim for _, v, lim in numbers), numbers


@pytest.mark.card
@pytest.mark.parametrize("seed", [SEED + 20, SEED + 21, SEED + 22])
@pytest.mark.parametrize("fault", ["half", "altered"])
def test_a_broken_training_step_fails_at_the_cells_size(fault, seed, card, monkeypatch):
    _plant_training_fault(fault, monkeypatch)
    result, numbers = run.execute("cornell.train", seed, 1.0, 0, str(card))
    print("fault", fault, seed, numbers)
    assert not result["correct"], numbers
