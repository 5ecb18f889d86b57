""".pbrt scene-description parser (port of grail/scene/parser.py; pbrt
src/core/pbrtlex.ll and pbrtparse.yy): a tokenizer and a statement
dispatcher over directives, quoted strings, numbers, [ ] arrays, # comments
and the Include stack, driving scene.api.PbrtAPI. WorldEnd builds the scene
on the requested device (the CUDA card unless the caller names another).
"""
from __future__ import annotations

import logging
import os

from ..device import resolve_device
from .api import PbrtAPI
from .paramset import ParamSet

log = logging.getLogger("grail_torch")


def tokenize(text):
    """Yield tokens: strings keep their quotes stripped but are tagged."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n":
            i += 1
        elif c == "#":
            while i < n and text[i] != "\n":
                i += 1
        elif c == '"':
            j = text.index('"', i + 1)
            yield ("str", text[i + 1:j])
            i = j + 1
        elif c in "[]":
            yield ("bracket", c)
            i += 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n"[]#':
                j += 1
            tok = text[i:j]
            try:
                yield ("num", float(tok))
            except ValueError:
                yield ("id", tok)
            i = j


class _TokenStream:
    """Stack of (token-list, cursor) frames; Include pushes a frame."""

    def __init__(self):
        self.frames = []

    def push_file(self, path):
        with open(path) as f:
            self.frames.append([list(tokenize(f.read())), 0])

    def push_text(self, text):
        self.frames.append([list(tokenize(text)), 0])

    def next(self):
        while self.frames:
            toks, i = self.frames[-1]
            if i < len(toks):
                self.frames[-1][1] = i + 1
                return toks[i]
            self.frames.pop()
        return None

    def peek(self):
        while self.frames:
            toks, i = self.frames[-1]
            if i < len(toks):
                return toks[i]
            self.frames.pop()
        return None


def _read_params(ts, search_path):
    """Read ("type name", values) pairs until a non-string token; spectrum
    files resolve against search_path."""
    decls = []
    while True:
        tok = ts.peek()
        if tok is None or tok[0] != "str":
            break
        typed_name = tok[1]
        if " " not in typed_name.strip():
            break  # a lone string argument of the NEXT statement, not a param
        ts.next()
        nxt = ts.peek()
        values = []
        if nxt is not None and nxt[0] == "bracket" and nxt[1] == "[":
            ts.next()
            while True:
                t = ts.next()
                if t is None or (t[0] == "bracket" and t[1] == "]"):
                    break
                values.append(t[1])
        else:
            t = ts.next()
            if t is not None:
                values.append(t[1])
        decls.append((typed_name, values))
    return ParamSet(decls, search_path)


def _read_floats(ts, count):
    vals = []
    while len(vals) < count:
        t = ts.next()
        if t is None:
            raise ValueError("unexpected EOF reading numbers")
        if t[0] == "bracket":
            continue
        vals.append(float(t[1]))
    return vals


def _read_string(ts):
    t = ts.next()
    if t is None or t[0] != "str":
        raise ValueError(f"expected quoted string, got {t}")
    return t[1]


def parse(ts: _TokenStream, api: PbrtAPI):
    while True:
        tok = ts.next()
        if tok is None:
            break
        if tok[0] != "id":
            log.warning("Unexpected token %r at top level", tok[1])
            continue
        d = tok[1]
        if d == "Include":
            fname = _read_string(ts)
            path = api._resolve(fname)
            ts.push_file(path)
        elif d == "WorldBegin":
            api.world_begin()
        elif d == "WorldEnd":
            return api.world_end()
        elif d == "AttributeBegin":
            api.attribute_begin()
        elif d == "AttributeEnd":
            api.attribute_end()
        elif d == "TransformBegin":
            api.transform_begin()
        elif d == "TransformEnd":
            api.transform_end()
        elif d == "ObjectBegin":
            api.object_begin(_read_string(ts))
        elif d == "ObjectEnd":
            api.object_end()
        elif d == "ObjectInstance":
            api.object_instance(_read_string(ts))
        elif d == "ReverseOrientation":
            api.reverse_orientation()
        elif d == "Identity":
            api.identity()
        elif d == "Translate":
            api.translate(*_read_floats(ts, 3))
        elif d == "Rotate":
            api.rotate(*_read_floats(ts, 4))
        elif d == "Scale":
            api.scale(*_read_floats(ts, 3))
        elif d == "LookAt":
            api.look_at(*_read_floats(ts, 9))
        elif d == "ConcatTransform":
            api.concat_transform(_read_floats(ts, 16))
        elif d == "Transform":
            api.transform(_read_floats(ts, 16))
        elif d == "CoordinateSystem":
            api.coordinate_system(_read_string(ts))
        elif d == "CoordSysTransform":
            api.coord_sys_transform(_read_string(ts))
        elif d == "ActiveTransform":
            which = ts.next()
            api.active_transform(which[1] if which else "All")
        elif d == "TransformTimes":
            api.transform_times(*_read_floats(ts, 2))
        elif d == "Camera":
            api.camera(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "Sampler":
            api.sampler(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "Film":
            api.film(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "PixelFilter":
            api.pixel_filter(_read_string(ts), _read_params(ts, api.search_path))
        elif d in ("SurfaceIntegrator", "Integrator"):
            api.surface_integrator(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "VolumeIntegrator":
            api.volume_integrator(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "Accelerator":
            api.accelerator(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "Renderer":
            api.renderer(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "Texture":
            name = _read_string(ts)
            ttype = _read_string(ts)
            tclass = _read_string(ts)
            api.texture(name, ttype, tclass, _read_params(ts, api.search_path))
        elif d == "Material":
            api.material(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "MakeNamedMaterial":
            api.make_named_material(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "NamedMaterial":
            api.named_material(_read_string(ts))
        elif d == "LightSource":
            api.light_source(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "AreaLightSource":
            api.area_light_source(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "Shape":
            api.shape(_read_string(ts), _read_params(ts, api.search_path))
        elif d == "Volume":
            api.volume(_read_string(ts), _read_params(ts, api.search_path))
        else:
            log.warning("Unknown directive %r ignored", d)
    return None


def parse_file(path, device=None):
    """Parse a .pbrt file -> (scene, meta, api); the scene's tensors go to
    `device` (CUDA unless the caller passes another), api.integrator_config
    holds the integrator's settings."""
    api = PbrtAPI(resolve_device(device))
    api.search_path = os.path.dirname(os.path.abspath(path))
    ts = _TokenStream()
    ts.push_file(path)
    result = parse(ts, api)
    if result is None:
        raise ValueError(f"{path}: no WorldEnd — nothing to render")
    scene, meta = result
    return scene, meta, api


def parse_string(text, device=None, search_path="."):
    """parse_file for scene text; Include and file names resolve against
    search_path."""
    api = PbrtAPI(resolve_device(device))
    api.search_path = search_path
    ts = _TokenStream()
    ts.push_text(text)
    result = parse(ts, api)
    if result is None:
        raise ValueError("no WorldEnd in scene text")
    scene, meta = result
    return scene, meta, api
