"""Checkpoint and resume (port of grail/engine/checkpoint.py).

The render state is the film {rgb, weight, splat} and the first sample
index not yet accumulated; the sampler is counter-based, so a render resumed
from a checkpoint continues bitwise as the uninterrupted one
(engine/render.py). The file is a single .npz in the reference's layout
(the film's three arrays, "next_wave", "format_version", a "fingerprint" of
the render configuration as uint8 bytes, and "extra_*" leaves), published
with an atomic rename, so a checkpoint written by either package loads in
the other. A fingerprint mismatch raises: resuming another scene or
configuration would corrupt the image without a sign.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

FORMAT_VERSION = 1


def scene_fingerprint(meta, cfg) -> str:
    """A stable hash of the render configuration (not of the scene's
    buffers, which the same .pbrt input makes again), as the reference's."""
    payload = {
        "xres": meta.xres, "yres": meta.yres,
        "spp": meta.sampler.spp, "kind": meta.sampler.kind,
        "integrator": getattr(cfg, "kind", "?"),
        "max_depth": getattr(cfg, "max_depth", 0),
        "n_tris": int(meta.n_tris), "n_lights": int(meta.n_lights),
    }
    return hashlib.sha256(json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def save(path, film, next_wave: int, meta=None, cfg=None, extra=None):
    """Write the render state: film (engine.film's dict), next_wave (the
    first sample index not yet accumulated), extra (numpy-able leaves)."""
    arrays = {k: film[k].detach().cpu().numpy() for k in ("rgb", "weight", "splat")}
    arrays["next_wave"] = np.int64(next_wave)
    arrays["format_version"] = np.int64(FORMAT_VERSION)
    if meta is not None and cfg is not None:
        arrays["fingerprint"] = np.frombuffer(scene_fingerprint(meta, cfg).encode(),
                                              dtype=np.uint8)
    for k, v in (extra or {}).items():
        arrays["extra_" + k] = np.asarray(v)
    tmp = str(path) + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)     # atomic: a kill leaves no torn checkpoint


def load(path, meta=None, cfg=None, device="cpu"):
    """Returns (film on `device`, next_wave, extra). Raises ValueError on
    another format version or a fingerprint that is not this render's."""
    with np.load(path) as z:
        ver = int(z["format_version"])
        if ver != FORMAT_VERSION:
            raise ValueError(f"checkpoint format {ver} != {FORMAT_VERSION}")
        if meta is not None and cfg is not None and "fingerprint" in z:
            want = scene_fingerprint(meta, cfg)
            got = bytes(z["fingerprint"]).decode()
            if got != want:
                raise ValueError(f"checkpoint fingerprint {got} does not match scene {want}")
        film = {k: torch.as_tensor(z[k], device=device) for k in ("rgb", "weight", "splat")}
        extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
        return film, int(z["next_wave"]), extra
