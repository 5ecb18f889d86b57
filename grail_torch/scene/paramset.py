"""ParamSet and TextureParams (port of grail/scene/paramset.py; pbrt
src/core/paramset.{h,cpp}): typed arrays keyed by name, FindOne* scalar
lookups with defaults, Find* array lookups, and ReportUnused warnings for
parameters no factory consumed. Spectrum inputs (rgb/color, xyz, spectrum
values or files, blackbody) normalize to RGB here, on the host in numpy.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from ..core.spectrum import blackbody_rgb, spd_to_rgb, xyz_to_rgb
from .floatfile import read_float_file

log = logging.getLogger("grail_torch")

_TYPES = ("float", "integer", "bool", "point", "vector", "normal", "string",
          "texture", "rgb", "color", "xyz", "spectrum", "blackbody")


class ParamSet:
    def __init__(self, decls=None, search_path="."):
        """decls: list of (typed_name, values) where typed_name = 'float fov';
        a relative spectrum file name resolves against search_path (the
        scene file's directory, as pbrt does)."""
        self.items = {}       # name -> (ptype, np.array or list)
        self.used = set()
        self.search_path = search_path
        for typed_name, values in (decls or []):
            self.add(typed_name, values)

    def add(self, typed_name, values):
        parts = typed_name.strip().split()
        if len(parts) != 2:
            raise ValueError(f"bad parameter declaration {typed_name!r}")
        ptype, name = parts
        if ptype not in _TYPES:
            raise ValueError(f"unknown parameter type {ptype!r} in {typed_name!r}")
        if ptype in ("rgb", "color"):
            vals = np.asarray(values, np.float32).reshape(-1, 3)
            ptype = "rgb"
        elif ptype == "xyz":
            vals = xyz_to_rgb(np.asarray(values, np.float32).reshape(-1, 3))
            ptype = "rgb"
        elif ptype == "blackbody":
            v = np.asarray(values, np.float32).reshape(-1)
            temp = float(v[0])
            scale = float(v[1]) if v.size > 1 else 1.0
            vals = blackbody_rgb(temp, scale).reshape(1, 3)
            ptype = "rgb"
        elif ptype == "spectrum":
            vals = self._spectrum_to_rgb(values)
            ptype = "rgb"
        elif ptype in ("point", "vector", "normal"):
            vals = np.asarray(values, np.float32).reshape(-1, 3)
        elif ptype == "float":
            vals = np.asarray(values, np.float32).reshape(-1)
        elif ptype == "integer":
            vals = np.asarray(values, np.int64).reshape(-1)
        elif ptype == "bool":
            vals = np.asarray(
                [v in (True, "true", 1, "1") for v in np.ravel(values)], np.bool_)
        else:  # string, texture
            vals = [str(v) for v in np.ravel(values)]
        self.items[name] = (ptype, vals)

    def _spectrum_to_rgb(self, values):
        vals = list(np.ravel(values))
        if vals and isinstance(vals[0], str):
            lam, v = [], []
            for fname in vals:
                data = read_float_file(os.path.join(self.search_path, fname))
                lam.extend(data[0::2])
                v.extend(data[1::2])
            return spd_to_rgb(lam, v).reshape(1, 3)
        arr = np.asarray(vals, np.float32).reshape(-1, 2)
        return spd_to_rgb(arr[:, 0], arr[:, 1]).reshape(1, 3)

    # ------------------------------------------------------------------ lookups
    def _get(self, name, ptypes):
        if name in self.items and self.items[name][0] in ptypes:
            self.used.add(name)
            return self.items[name][1]
        return None

    def find_one_float(self, name, default):
        v = self._get(name, ("float", "integer"))
        return float(v[0]) if v is not None and len(v) else float(default)

    def find_one_int(self, name, default):
        v = self._get(name, ("integer", "float"))
        return int(v[0]) if v is not None and len(v) else int(default)

    def find_one_bool(self, name, default):
        v = self._get(name, ("bool",))
        return bool(v[0]) if v is not None and len(v) else bool(default)

    def find_one_string(self, name, default):
        v = self._get(name, ("string", "texture"))
        return str(v[0]) if v else str(default)

    def find_one_point(self, name, default):
        v = self._get(name, ("point", "vector", "normal"))
        return np.asarray(v[0] if v is not None and len(v) else default, np.float32)

    def find_one_rgb(self, name, default):
        v = self._get(name, ("rgb",))
        return np.asarray(v[0] if v is not None and len(v) else default, np.float32)

    def find_texture(self, name):
        """Named-texture reference, or None."""
        if name in self.items and self.items[name][0] == "texture":
            self.used.add(name)
            return self.items[name][1][0]
        return None

    def find_floats(self, name):
        return self._get(name, ("float",))

    def find_ints(self, name):
        return self._get(name, ("integer",))

    def find_points(self, name):
        return self._get(name, ("point",))

    def find_normals(self, name):
        return self._get(name, ("normal",))

    def find_vectors(self, name):
        return self._get(name, ("vector",))

    def find_strings(self, name):
        return self._get(name, ("string",))

    def report_unused(self, context=""):
        """pbrt ParamSet::ReportUnused — warn about unconsumed parameters."""
        for name in self.items:
            if name not in self.used:
                log.warning("Parameter %r unused %s", name,
                            f"in {context}" if context else "")


class TextureParams:
    """pbrt core/paramset.h TextureParams: geom+material ParamSets + the graphics
    state's named texture maps; resolves constant-or-texture parameters."""

    def __init__(self, geom_params: ParamSet, mat_params: ParamSet,
                 float_textures: dict, spectrum_textures: dict):
        self.geom = geom_params
        self.mat = mat_params
        self.float_textures = float_textures
        self.spectrum_textures = spectrum_textures

    def get_spectrum_texture(self, builder, name, default_rgb):
        """Returns a texture id in `builder` for parameter `name`."""
        tex_name = self.geom.find_texture(name) or self.mat.find_texture(name)
        if tex_name is not None:
            if tex_name not in self.spectrum_textures:
                log.warning("Spectrum texture %r not declared; using default",
                            tex_name)
            else:
                return self.spectrum_textures[tex_name]
        v = self.geom.find_one_rgb(
            name, self.mat.find_one_rgb(name, default_rgb))
        return builder.const_tex(v)

    def get_float_texture(self, builder, name, default):
        tex_name = self.geom.find_texture(name) or self.mat.find_texture(name)
        if tex_name is not None:
            if tex_name not in self.float_textures:
                log.warning("Float texture %r not declared; using default",
                            tex_name)
            else:
                return self.float_textures[tex_name]
        v = self.geom.find_one_float(name, self.mat.find_one_float(name, default))
        return builder.const_tex((v, v, v))

    def get_float_texture_or_none(self, builder, name):
        tex_name = self.geom.find_texture(name) or self.mat.find_texture(name)
        if tex_name is not None and tex_name in self.float_textures:
            return self.float_textures[tex_name]
        v = self.geom.find_floats(name)
        if v is None:
            v = self.mat.find_floats(name)
        if v is None or not len(v):
            return None
        return builder.const_tex((float(v[0]),) * 3)

    def find_one_float(self, name, default):
        return self.geom.find_one_float(name, self.mat.find_one_float(name, default))

    def find_one_int(self, name, default):
        return self.geom.find_one_int(name, self.mat.find_one_int(name, default))

    def find_one_string(self, name, default):
        return self.geom.find_one_string(name, self.mat.find_one_string(name, default))

    def find_one_bool(self, name, default):
        return self.geom.find_one_bool(name, self.mat.find_one_bool(name, default))

    def find_one_rgb(self, name, default):
        return self.geom.find_one_rgb(name, self.mat.find_one_rgb(name, default))

    def report_unused(self, context=""):
        self.geom.report_unused(context)
