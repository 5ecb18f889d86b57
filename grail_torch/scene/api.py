"""Scene API (port of grail/scene/api.py; pbrt src/core/api): the state
machine that the .pbrt parser drives, with graphics and transform state
stacks and string-keyed factories, building the port's SceneBuilder.

Statements flow as in the reference (options block -> WorldBegin ->
attributes, materials, lights and shapes -> WorldEnd) and build the same
rows in the same order, so that a parsed scene holds the reference's leaves.
Ported: the transform directives, Camera "perspective", "orthographic" and
"environment", Film (with its "cropwindow"), Sampler (with "adaptive":
self.adaptive), PixelFilter, Renderer "sampler" and "metropolis"
(self.mlt_config and self.mlt_spp), SurfaceIntegrator "path",
"directlighting", "whitted", "ambientocclusion" and "dipolesubsurface",
VolumeIntegrator "emission" and "single", attributes and
ReverseOrientation, Texture "constant", "scale", "mix", "bilerp", "uv",
"checkerboard", "dots", "fbm", "wrinkled", "windy", "marble" and
"imagemap" (uv, spherical, cylindrical and planar mappings), the materials
matte, plastic, metal, shinymetal, mirror, glass, uber, substrate,
translucent, measured, subsurface, kdsubsurface and mix (named or not) with
a "bumpmap", LightSource "point", "spot", "distant", "infinite",
"projection" and "goniometric", AreaLightSource "diffuse", Volume
"homogeneous", "volumegrid" and "exponential", every shape of
scene/shapes.py with its "alpha" cutout, and object instancing
(ObjectBegin/ObjectEnd/ObjectInstance, animated transforms as
single-instance objects). Everything else raises NotImplementedError where
it is used, naming the directive or parameter; a missing image or BRDF file
raises (the reference substitutes a constant, drops the map or shades
matte). The reference's own name mappings stay: an unknown camera is the
perspective camera, an unknown filter is a box filter, an unknown sampler
and "bestcandidate" are the (0,2)-sequence, an unknown integrator is
"path", an unknown volume integrator "emission", an unknown accelerator or
renderer is the BVH and the sampler renderer, each with a warning; an
unknown Volume is ignored with a warning, and a subsurface medium whose
name is not in the (case-sensitive) measured table keeps the skin1
coefficients with a warning, as in the reference.
"""
from __future__ import annotations

import copy
import logging
import os

import numpy as np

from ..core import transform as tr
from ..core.rng import HALTON, RANDOM, STRATIFIED, ZERO_TWO, SamplerConfig
from ..engine import camera as cam
from ..engine.filters import FilterConfig
from ..engine.imageio import read_image
from ..engine.integrator import IntegratorConfig
from ..engine.metropolis import MLTConfig
from ..engine.subsurface import subsurface_from_diffuse
from ..shade import bsdf as bx
from ..shade import measured as msr
from ..shade import media as med
from ..shade.materials import CONV_INV, CONV_RADIANS
from ..shade.textures import TexSpec
from . import shapes as shp
from .buffers import SceneBuilder
from .paramset import ParamSet, TextureParams

log = logging.getLogger("grail_torch")

# default conductor spectra (approx copper, pbrt metal.cpp defaults)
COPPER_ETA = (0.2004, 0.9240, 1.1022)
COPPER_K = (3.9129, 2.4528, 2.1421)

# the SurfaceIntegrator names the port renders, with their integrator kind,
# and the others the reference knows (an unknown name renders with "path",
# as in the reference)
INTEGRATORS = {"path": "path", "directlighting": "direct", "whitted": "whitted",
               "ambientocclusion": "ao", "dipolesubsurface": "dipole"}
UNPORTED_INTEGRATORS = ("igi", "photonmap", "exphotonmap", "diffuseprt", "glossyprt",
                        "useprobes", "irradiancecache")
VOLUME_INTEGRATORS = ("emission", "single")
SAMPLER_KINDS = {"lowdiscrepancy": ZERO_TWO, "02sequence": ZERO_TWO,
                 "stratified": STRATIFIED, "halton": HALTON, "random": RANDOM,
                 "bestcandidate": ZERO_TWO, "adaptive": ZERO_TWO}
FILTERS = ("box", "triangle", "gaussian", "mitchell", "sinc")
CAMERAS = {"perspective": cam.PERSPECTIVE, "orthographic": cam.ORTHOGRAPHIC,
           "environment": cam.ENVIRONMENT}
UNPORTED_RENDERERS = ("createprobes", "surfacepoints")


def _unported(what):
    return NotImplementedError(f"{what} is not ported yet")


class GraphicsState:
    """pbrt api.cpp GraphicsState."""

    def __init__(self):
        self.material = "matte"
        self.material_params = ParamSet()
        self.named_materials = {}            # name -> material id (built)
        self.current_named_material = None
        self.float_textures = {}             # name -> tex id
        self.spectrum_textures = {}
        self.area_light = None               # (name, ParamSet)
        self.reverse_orientation = False

    def clone(self):
        g = copy.copy(self)
        g.float_textures = dict(self.float_textures)
        g.spectrum_textures = dict(self.spectrum_textures)
        g.named_materials = dict(self.named_materials)
        return g


class TransformSet:
    """Two transform slots for motion start/end (api.cpp TransformSet)."""

    def __init__(self):
        self.t = [tr.identity(), tr.identity()]

    def clone(self):
        ts = TransformSet()
        ts.t = [self.t[0].copy(), self.t[1].copy()]
        return ts

    def is_animated(self):
        return not np.allclose(self.t[0], self.t[1])


ALL_TRANSFORM_BITS = 0b11
START_BIT, END_BIT = 0b01, 0b10


class PbrtAPI:
    """One render context: use it through scene.parser.parse_file. WorldEnd
    finalizes the scene on `device` (a torch device, resolved by the
    caller)."""

    # objects at or below this triangle count are flattened into the base
    # soup; larger ones share one BLAS across their instances
    INSTANCE_BAKE_MAX = 16

    def __init__(self, device):
        self.device = device
        self.ctm = TransformSet()
        self.active_bits = ALL_TRANSFORM_BITS
        self.coord_systems = {}
        self.gs = GraphicsState()
        self.pushed_gs = []
        self.pushed_ctm = []
        self.pushed_bits = []
        self.builder = SceneBuilder()
        # pre-world configuration (RenderOptions)
        self.camera_name = "perspective"
        self.camera_params = ParamSet()
        self.camera_to_world = TransformSet()
        self.sampler_name = "lowdiscrepancy"
        self.sampler_params = ParamSet()
        self.film_name = "image"
        self.film_params = ParamSet()
        self.filter_name = "box"
        self.filter_params = ParamSet()
        self.integrator_name = "directlighting"
        self.integrator_params = ParamSet()
        self.vol_integrator_name = "emission"
        self.vol_integrator_params = ParamSet()
        # the BSSRDF medium the last subsurface material recorded (the skin1
        # defaults of pbrt volume.cpp's measured table)
        self.sss_sigma_a = (0.0011, 0.0024, 0.014)
        self.sss_sigma_s = (2.55, 3.21, 3.77)
        self.sss_eta = 1.3
        self.accelerator_name = "bvh"
        self.renderer_name = "sampler"
        self.renderer_params = ParamSet()
        self.objects = {}                 # ObjectBegin name -> recorded shapes
        self._tlas_objects = {}           # name -> builder object id (BLAS)
        self.current_object = None
        self.search_path = "."
        self.out_filename = "out.exr"
        self.integrator_config = None
        self.adaptive = None        # Sampler "adaptive": {"min": ..., "max": ...}
        self.mlt_config = None      # Renderer "metropolis": its MLTConfig ...
        self.mlt_spp = None         # ... and mutations a pixel

    # --------------------------------------------------------------- CTM helpers
    def _for_active(self, fn):
        for i in range(2):
            if self.active_bits & (1 << i):
                self.ctm.t[i] = fn(self.ctm.t[i])

    def identity(self):
        self._for_active(lambda m: tr.identity())

    def translate(self, dx, dy, dz):
        self._for_active(lambda m: m @ tr.translate([dx, dy, dz]))

    def rotate(self, angle, x, y, z):
        self._for_active(lambda m: m @ tr.rotate(angle, [x, y, z]))

    def scale(self, sx, sy, sz):
        self._for_active(lambda m: m @ tr.scale(sx, sy, sz))

    def look_at(self, ex, ey, ez, lx, ly, lz, ux, uy, uz):
        # pbrt: CTM = CTM * Inverse(LookAt), world -> camera
        w2c = tr.inverse(tr.look_at([ex, ey, ez], [lx, ly, lz], [ux, uy, uz]))
        self._for_active(lambda m: m @ w2c)

    def concat_transform(self, m16):
        m = np.asarray(m16, np.float32).reshape(4, 4).T  # column-major input
        self._for_active(lambda cur: cur @ m)

    def transform(self, m16):
        m = np.asarray(m16, np.float32).reshape(4, 4).T
        self._for_active(lambda cur: m.copy())

    def coordinate_system(self, name):
        self.coord_systems[name] = self.ctm.clone()

    def coord_sys_transform(self, name):
        if name in self.coord_systems:
            self.ctm = self.coord_systems[name].clone()
        else:
            log.warning("CoordSysTransform: unknown coordinate system %r", name)

    def active_transform(self, which):
        self.active_bits = {"StartTime": START_BIT,
                            "EndTime": END_BIT}.get(which, ALL_TRANSFORM_BITS)

    # ----------------------------------------------------------- options block
    def camera(self, name, params):
        if name not in CAMERAS:
            log.warning("Camera %r mapped to perspective", name)
        self.camera_name = name
        self.camera_params = params
        # camera-to-world = inverse(CTM); also the "camera" coordinate system
        c2w = TransformSet()
        c2w.t = [tr.inverse(self.ctm.t[0]), tr.inverse(self.ctm.t[1])]
        self.camera_to_world = c2w
        self.coord_systems["camera"] = c2w

    def sampler(self, name, params):
        self.sampler_name, self.sampler_params = name, params

    def film(self, name, params):
        self.film_name, self.film_params = name, params

    def pixel_filter(self, name, params):
        self.filter_name, self.filter_params = name, params

    def surface_integrator(self, name, params):
        if name in UNPORTED_INTEGRATORS:
            raise _unported(f'SurfaceIntegrator "{name}"')
        self.integrator_name, self.integrator_params = name, params

    def volume_integrator(self, name, params):
        if name not in VOLUME_INTEGRATORS:
            log.warning("Volume integrator %r mapped to emission", name)
        self.vol_integrator_name, self.vol_integrator_params = name, params

    def accelerator(self, name, params):
        self.accelerator_name = name

    def renderer(self, name, params):
        if name in UNPORTED_RENDERERS:
            raise _unported(f'Renderer "{name}"')
        self.renderer_name, self.renderer_params = name, params

    # -------------------------------------------------------------- world block
    def world_begin(self):
        self.ctm = TransformSet()
        self.active_bits = ALL_TRANSFORM_BITS
        self.coord_systems["world"] = self.ctm.clone()

    def attribute_begin(self):
        self.pushed_gs.append(self.gs.clone())
        self.pushed_ctm.append(self.ctm.clone())
        self.pushed_bits.append(self.active_bits)

    def attribute_end(self):
        if not self.pushed_gs:
            log.warning("Unmatched AttributeEnd")
            return
        self.gs = self.pushed_gs.pop()
        self.ctm = self.pushed_ctm.pop()
        self.active_bits = self.pushed_bits.pop()

    def transform_begin(self):
        self.pushed_ctm.append(self.ctm.clone())
        self.pushed_bits.append(self.active_bits)

    def transform_end(self):
        if not self.pushed_ctm:
            log.warning("Unmatched TransformEnd")
            return
        self.ctm = self.pushed_ctm.pop()
        self.active_bits = self.pushed_bits.pop()

    def reverse_orientation(self):
        self.gs.reverse_orientation = not self.gs.reverse_orientation

    # ---------------------------------------------------------------- textures
    def texture(self, name, ttype, texclass, params):
        tp = TextureParams(params, ParamSet(), self.gs.float_textures,
                           self.gs.spectrum_textures)
        tex_id = self._make_texture(texclass, tp)
        tp.report_unused(f'Texture "{texclass}"')
        if ttype == "float":
            self.gs.float_textures[name] = tex_id
        else:
            self.gs.spectrum_textures[name] = tex_id

    def _make_texture(self, texclass, tp):
        b = self.builder
        w2t = tr.inverse(self.ctm.t[0])
        if texclass == "constant":
            return b.const_tex(tp.geom.find_one_rgb(
                "value", (tp.find_one_float("value", 1.0),) * 3))
        if texclass == "scale":
            t1 = tp.get_spectrum_texture(b, "tex1", (1, 1, 1))
            t2 = tp.get_spectrum_texture(b, "tex2", (1, 1, 1))
            return b.add_texture(TexSpec(kind="scale", inputs=(t1, t2)), w2t=w2t)
        if texclass == "mix":
            t1 = tp.get_spectrum_texture(b, "tex1", (0, 0, 0))
            t2 = tp.get_spectrum_texture(b, "tex2", (1, 1, 1))
            amt = tp.get_float_texture(b, "amount", 0.5)
            return b.add_texture(TexSpec(kind="mix", inputs=(t1, t2, amt)), w2t=w2t)
        if texclass == "bilerp":
            vs = [tp.get_spectrum_texture(b, k, (0, 0, 0))
                  for k in ("v00", "v01", "v10", "v11")]
            return b.add_texture(
                TexSpec(kind="bilerp", inputs=tuple(vs), **self._mapping_kwargs(tp)),
                w2t=w2t)
        if texclass == "uv":
            return b.add_texture(TexSpec(kind="uv", **self._mapping_kwargs(tp)), w2t=w2t)
        if texclass == "checkerboard":
            dim = tp.find_one_float("dimension", 2)
            t1 = tp.get_spectrum_texture(b, "tex1", (1, 1, 1))
            t2 = tp.get_spectrum_texture(b, "tex2", (0, 0, 0))
            aa = tp.find_one_string("aamode", "closedform")
            kw = self._mapping_kwargs(tp) if dim == 2 else {}
            return b.add_texture(TexSpec(kind="checkerboard", inputs=(t1, t2),
                                         dim=int(dim), aa=aa, **kw), w2t=w2t)
        if texclass == "dots":
            t1 = tp.get_spectrum_texture(b, "inside", (1, 1, 1))
            t2 = tp.get_spectrum_texture(b, "outside", (0, 0, 0))
            return b.add_texture(
                TexSpec(kind="dots", inputs=(t1, t2), **self._mapping_kwargs(tp)),
                w2t=w2t)
        if texclass in ("fbm", "wrinkled"):
            return b.add_texture(TexSpec(kind=texclass,
                                         octaves=tp.find_one_int("octaves", 8),
                                         omega=tp.find_one_float("roughness", 0.5)),
                                 w2t=w2t)
        if texclass == "windy":
            return b.add_texture(TexSpec(kind="windy"), w2t=w2t)
        if texclass == "marble":
            return b.add_texture(
                TexSpec(kind="marble", octaves=tp.find_one_int("octaves", 8),
                        omega=tp.find_one_float("roughness", 0.5),
                        scale=tp.find_one_float("scale", 1.0),
                        variation=tp.find_one_float("variation", 0.2)), w2t=w2t)
        if texclass == "imagemap":
            fname = self._resolve(tp.find_one_string("filename", ""))
            scale = tp.find_one_float("scale", 1.0)
            g = tp.geom.find_floats("gamma")
            gamma = (float(g[0]) if g is not None and len(g)
                     else (None if fname.lower().endswith((".tga", ".png", ".jpg"))
                           else 1.0))
            img_id = b.add_image(read_image(fname, gamma=gamma) * scale)
            # imagemap.cpp: "trilinear" bool (false => EWA), "maxanisotropy"
            filt = "trilinear" if tp.find_one_bool("trilinear", False) else "ewa"
            return b.add_texture(
                TexSpec(kind="image", image_id=img_id, filt=filt,
                        maxaniso=tp.find_one_float("maxanisotropy", 8.0),
                        **self._mapping_kwargs(tp)),
                w2t=w2t)
        raise _unported(f'Texture "{texclass}"')

    @staticmethod
    def _mapping_kwargs(tp):
        """A 2D texture's mapping parameters (TextureMapping2D): uv,
        spherical, cylindrical or planar, with its scales and offsets, and
        the planar mapping's axes."""
        mapping = tp.find_one_string("mapping", "uv")
        kw = dict(mapping=mapping, su=tp.find_one_float("uscale", 1.0),
                  sv=tp.find_one_float("vscale", 1.0),
                  du=tp.find_one_float("udelta", 0.0),
                  dv=tp.find_one_float("vdelta", 0.0))
        if mapping == "planar":
            kw["v1"] = tuple(tp.geom.find_one_point("v1", (1, 0, 0)))
            kw["v2"] = tuple(tp.geom.find_one_point("v2", (0, 1, 0)))
        return kw

    def _resolve(self, fname):
        if fname and not os.path.isabs(fname):
            return os.path.join(self.search_path, fname)
        return fname

    # ---------------------------------------------------------------- materials
    def material(self, name, params):
        self.gs.material = name
        self.gs.material_params = params
        self.gs.current_named_material = None

    def make_named_material(self, name, params):
        mtype = params.find_one_string("type", "matte")
        mid = self._build_material(mtype, TextureParams(
            ParamSet(), params, self.gs.float_textures, self.gs.spectrum_textures))
        self.gs.named_materials[name] = mid

    def named_material(self, name):
        self.gs.current_named_material = name

    def _current_material_id(self, shape_params):
        if self.gs.current_named_material is not None:
            mid = self.gs.named_materials.get(self.gs.current_named_material)
            if mid is None:
                log.warning("NamedMaterial %r unknown; using matte",
                            self.gs.current_named_material)
                return self.builder.matte()
            return mid
        tp = TextureParams(shape_params, self.gs.material_params,
                           self.gs.float_textures, self.gs.spectrum_textures)
        return self._build_material(self.gs.material, tp)

    def _build_material(self, mtype, tp):
        """One material row with its bump map, its textures built in the
        reference's order (the bump map's first)."""
        bump = tp.get_float_texture_or_none(self.builder, "bumpmap")
        return self.builder.add_material(self._material_lobes(mtype, tp), bump=bump)

    def _material_lobes(self, mtype, tp):
        """The lobe stack of a material."""
        b = self.builder
        if mtype in ("", "none"):
            return []
        if mtype == "matte":
            kd = tp.get_spectrum_texture(b, "Kd", (0.5, 0.5, 0.5))
            sigma = tp.get_float_texture(b, "sigma", 0.0)
            return [dict(type=bx.OREN_NAYAR, s0=kd, f0=sigma, f0_conv=CONV_RADIANS)]
        if mtype == "plastic":
            kd = tp.get_spectrum_texture(b, "Kd", (0.25,) * 3)
            ks = tp.get_spectrum_texture(b, "Ks", (0.25,) * 3)
            rough = tp.get_float_texture(b, "roughness", 0.1)
            ior = b.const_tex((1.5,) * 3)
            return [
                dict(type=bx.LAMBERT, s0=kd),
                dict(type=bx.BLINN, s0=ks, fr=bx.FR_DIELECTRIC, f0=rough,
                     f0_conv=CONV_INV, f2=ior)]
        if mtype == "glass":
            kr = tp.get_spectrum_texture(b, "Kr", (1.0,) * 3)
            kt = tp.get_spectrum_texture(b, "Kt", (1.0,) * 3)
            index = tp.get_float_texture(b, "index", 1.5)
            return [
                dict(type=bx.SPEC_REFL, s0=kr, fr=bx.FR_DIELECTRIC, f2=index),
                dict(type=bx.SPEC_TRANS, s0=kt, f2=index)]
        if mtype == "mirror":
            kr = tp.get_spectrum_texture(b, "Kr", (0.9,) * 3)
            return [dict(type=bx.SPEC_REFL, s0=kr, fr=bx.FR_NOOP)]
        if mtype == "metal":
            eta = tp.get_spectrum_texture(b, "eta", COPPER_ETA)
            k = tp.get_spectrum_texture(b, "k", COPPER_K)
            rough = tp.get_float_texture(b, "roughness", 0.01)
            one = b.const_tex((1.0,) * 3)
            return [dict(type=bx.BLINN, s0=one, s1=eta, s2=k, fr=bx.FR_CONDUCTOR,
                         f0=rough, f0_conv=CONV_INV)]
        if mtype == "shinymetal":
            ks = tp.get_spectrum_texture(b, "Ks", (1.0,) * 3)
            kr = tp.get_spectrum_texture(b, "Kr", (1.0,) * 3)
            rough = tp.get_float_texture(b, "roughness", 0.1)
            # the conductor's eta and k from the constant Kr (shinymetal.cpp
            # FresnelApproxEta/K), as the reference computes them: a textured
            # Kr reads its constant row
            kr_rgb = np.clip(b.tex_const[kr], 0.0, 0.999)
            eta = b.const_tex((1.0 + np.sqrt(kr_rgb)) / (1.0 - np.sqrt(kr_rgb)))
            k = b.const_tex(2.0 * np.sqrt(kr_rgb) / np.sqrt(np.maximum(1.0 - kr_rgb, 1e-5)))
            return [
                dict(type=bx.BLINN, s0=ks, s1=eta, s2=k, fr=bx.FR_CONDUCTOR, f0=rough,
                     f0_conv=CONV_INV),
                dict(type=bx.SPEC_REFL, s0=kr, s1=eta, s2=k, fr=bx.FR_CONDUCTOR)]
        if mtype == "uber":
            kd = tp.get_spectrum_texture(b, "Kd", (0.25,) * 3)
            ks = tp.get_spectrum_texture(b, "Ks", (0.25,) * 3)
            kr = tp.get_spectrum_texture(b, "Kr", (0.0,) * 3)
            rough = tp.get_float_texture(b, "roughness", 0.1)
            index = tp.get_float_texture(b, "index", 1.5)
            opacity = tp.get_spectrum_texture(b, "opacity", (1.0,) * 3)
            one = b.const_tex((1.0,) * 3)
            inv_op = b.add_texture(TexSpec(kind="mix", inputs=(one, b.const_tex(
                (0.0,) * 3), opacity)))  # lerp(op, 1, 0) = 1-op
            okd = b.add_texture(TexSpec(kind="scale", inputs=(opacity, kd)))
            oks = b.add_texture(TexSpec(kind="scale", inputs=(opacity, ks)))
            okr = b.add_texture(TexSpec(kind="scale", inputs=(opacity, kr)))
            unity_ior = b.const_tex((1.0,) * 3)
            return [
                dict(type=bx.LAMBERT, s0=okd),
                dict(type=bx.BLINN, s0=oks, fr=bx.FR_DIELECTRIC, f0=rough,
                     f0_conv=CONV_INV, f2=index),
                dict(type=bx.SPEC_REFL, s0=okr, fr=bx.FR_DIELECTRIC, f2=index),
                # opacity pass-through: (1-op)·SpecularTransmission with ior 1
                dict(type=bx.SPEC_TRANS, s0=inv_op, f2=unity_ior)]
        if mtype == "mix":
            m1 = tp.find_one_string("namedmaterial1", "")
            m2 = tp.find_one_string("namedmaterial2", "")
            amount = tp.get_spectrum_texture(b, "amount", (0.5,) * 3)
            named = self.gs.named_materials
            rows1 = b.mat_rows[named[m1]] if m1 in named else []
            rows2 = b.mat_rows[named[m2]] if m2 in named else []
            one = b.const_tex((1.0,) * 3)
            zero = b.const_tex((0.0,) * 3)
            inv_amount = b.add_texture(TexSpec(kind="mix", inputs=(one, zero, amount)))
            lobes = []
            for weight, rows in ((amount, rows1), (inv_amount, rows2)):
                for lobe in rows:
                    lobes.append(dict(lobe, s0=b.add_texture(
                        TexSpec(kind="scale", inputs=(weight, lobe["s0"])))))
            return lobes
        if mtype == "substrate":
            kd = tp.get_spectrum_texture(b, "Kd", (0.5,) * 3)
            ks = tp.get_spectrum_texture(b, "Ks", (0.5,) * 3)
            ur = tp.get_float_texture(b, "uroughness", 0.1)
            vr = tp.get_float_texture(b, "vroughness", 0.1)
            return [dict(type=bx.FRESNEL_BLEND, s0=kd, s1=ks, f0=ur, f1=vr,
                         f0_conv=CONV_INV, f1_conv=CONV_INV)]
        if mtype == "translucent":
            kd = tp.get_spectrum_texture(b, "Kd", (0.25,) * 3)
            ks = tp.get_spectrum_texture(b, "Ks", (0.25,) * 3)
            refl = tp.get_spectrum_texture(b, "reflect", (0.5,) * 3)
            trans = tp.get_spectrum_texture(b, "transmit", (0.5,) * 3)
            rough = tp.get_float_texture(b, "roughness", 0.1)
            ior = b.const_tex((1.5,) * 3)
            rkd, rks, tkd, tks = (b.add_texture(TexSpec(kind="scale", inputs=pair))
                                  for pair in ((refl, kd), (refl, ks), (trans, kd),
                                               (trans, ks)))
            return [
                dict(type=bx.LAMBERT, s0=rkd),
                dict(type=bx.BLINN, s0=rks, fr=bx.FR_DIELECTRIC, f0=rough,
                     f0_conv=CONV_INV, f2=ior),
                dict(type=bx.LAMBERT_T, s0=tkd),
                dict(type=bx.BLINN_T, s0=tks, fr=bx.FR_DIELECTRIC, f0=rough,
                     f0_conv=CONV_INV, f2=ior)]
        if mtype in ("subsurface", "kdsubsurface"):
            self._record_sss_medium(mtype, tp)
            # the shell the dipole integrator shades direct light with: a
            # diffuse base; Kr gets a texture row, as in the reference, which
            # no lobe reads
            tp.get_spectrum_texture(b, "Kr", (1.0, 1.0, 1.0))
            kd = tp.get_spectrum_texture(b, "Kd", (0.5, 0.5, 0.5))
            return [dict(type=bx.LAMBERT, s0=kd)]
        if mtype == "measured":
            fname = tp.find_one_string("filename", "")
            if not fname:
                raise ValueError('Material "measured" without a "filename"')
            path = self._resolve(fname)
            if path.endswith(".binary"):
                table = msr.read_merl(path)
            else:
                table = msr.bake_irregular(*msr.read_brdf(path))
            return b.measured_lobes(table)
        raise _unported(f'Material "{mtype}"')

    def _record_sss_medium(self, mtype, tp):
        """The BSSRDF medium of a subsurface material, for the dipole
        integrator: kdsubsurface's Kd and mean free path inverted
        (SubsurfaceFromDiffuse), a named medium of the measured table, or
        explicit sigma_a and sigma_prime_s times "scale"; and its index."""
        eta = tp.find_one_float("index", 1.3)
        name = tp.find_one_string("name", "")
        if mtype == "kdsubsurface":
            self.sss_sigma_a, self.sss_sigma_s = subsurface_from_diffuse(
                tp.find_one_rgb("Kd", (0.5, 0.5, 0.5)),
                tp.find_one_float("meanfreepath", 1.0), eta)
        elif name and name in med.MEASURED_MEDIA:
            sa, sps = med.MEASURED_MEDIA[name]
            self.sss_sigma_a, self.sss_sigma_s = tuple(sa), tuple(sps)
        elif name:
            log.warning('Unknown scattering medium "%s"; using skin1', name)
        else:
            scale = tp.find_one_float("scale", 1.0)
            sa = tp.find_one_rgb("sigma_a", (0.0011, 0.0024, 0.014))
            sps = tp.find_one_rgb("sigma_prime_s", (2.55, 3.21, 3.77))
            self.sss_sigma_a = tuple(float(x) * scale for x in sa)
            self.sss_sigma_s = tuple(float(x) * scale for x in sps)
        self.sss_eta = eta

    # ------------------------------------------------------------------- lights
    def light_source(self, name, params):
        b = self.builder
        l2w = self.ctm.t[0]
        scale = params.find_one_rgb("scale", (1, 1, 1))
        if name == "point":
            i = params.find_one_rgb("I", (1, 1, 1)) * scale
            from_p = params.find_one_point("from", (0, 0, 0))
            b.add_point_light(tr.xform_p_np(l2w, from_p), i)
        elif name == "spot":
            i = params.find_one_rgb("I", (1, 1, 1)) * scale
            from_p = params.find_one_point("from", (0, 0, 0))
            to_p = params.find_one_point("to", (0, 0, 1))
            cone = params.find_one_float("coneangle", 30.0)
            delta = params.find_one_float("conedeltaangle", 5.0)
            b.add_spot_light(l2w @ _spot_frame(from_p, to_p), i, cone, delta)
        elif name == "distant":
            L = params.find_one_rgb("L", (1, 1, 1)) * scale
            from_p = params.find_one_point("from", (0, 0, 0))
            to_p = params.find_one_point("to", (0, 0, 1))
            b.add_distant_light(tr.xform_p_np(l2w, from_p), tr.xform_p_np(l2w, to_p), L)
        elif name == "infinite":
            L = params.find_one_rgb("L", (1, 1, 1)) * scale
            mapname = params.find_one_string("mapname", "")
            env = read_image(self._resolve(mapname)) if mapname else None
            b.add_infinite_light(l2w, L, env)
        elif name == "projection":
            i = params.find_one_rgb("I", (1, 1, 1)) * scale
            fov = params.find_one_float("fov", 45.0)
            b.add_projection_light(l2w, i, fov=fov, image_id=self._light_image(params))
        elif name == "goniometric":
            i = params.find_one_rgb("I", (1, 1, 1)) * scale
            b.add_goniometric_light(l2w, i, image_id=self._light_image(params))
        else:
            raise _unported(f'LightSource "{name}"')
        params.report_unused(f'LightSource "{name}"')

    def _light_image(self, params):
        """A light's "mapname" image added to the builder, or -1 without
        one."""
        mapname = params.find_one_string("mapname", "")
        if not mapname:
            return -1
        return self.builder.add_image(read_image(self._resolve(mapname)))

    def area_light_source(self, name, params):
        if name != "diffuse":
            raise _unported(f'AreaLightSource "{name}"')
        self.gs.area_light = (name, params)

    # ------------------------------------------------------------------- shapes
    def shape(self, name, params):
        mesh = self._make_shape_mesh(name, params)
        if mesh is None:
            return
        verts, idx, normals, uvs = mesh
        if self.current_object is not None:
            self.objects[self.current_object].append(
                (verts, idx, normals, uvs, self.gs.clone(), self.ctm.clone(), params))
            return
        self._emit_shape(verts, idx, normals, uvs, self.gs, self.ctm, params)
        params.report_unused(f'Shape "{name}"')

    def _emit_shape(self, verts, idx, normals, uvs, gs, ctm, shape_params):
        b = self.builder
        m = ctm.t[0]
        if ctm.is_animated() and gs.area_light is None:
            # object motion blur (TransformedPrimitive with an animated
            # PrimitiveToWorld): a single-instance object with object-space
            # geometry and the transform pair on the instance (without an
            # alpha cutout, as in the reference)
            nrm = normals
            if nrm is not None:
                nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
            mat_id = self._material_id_for_state(gs, shape_params)
            obj_id = b.add_object()
            b.add_object_mesh(obj_id, verts, idx, mat_id, normals=nrm, uvs=uvs,
                              reverse_orientation=gs.reverse_orientation)
            b.add_instance(obj_id, ctm.t[0].copy(), ctm.t[1].copy())
            return
        if ctm.is_animated():
            log.warning("Animated transform on an area-light shape: using the "
                        "shutter-open key")
        verts = tr.xform_p_np(m, verts)
        if normals is not None:
            normals = tr.xform_n_np(tr.inverse(m), normals)
            normals = normals / np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                                           1e-12)
        emit = None
        nsamp = 1
        if gs.area_light is not None:
            _, ap = gs.area_light
            emit = ap.find_one_rgb("L", (1, 1, 1)) * ap.find_one_rgb("scale", (1, 1, 1))
            nsamp = ap.find_one_int("nsamples", 1)
        mat_id = self._material_id_for_state(gs, shape_params)
        b.add_mesh(verts, idx, mat_id, normals=normals, uvs=uvs,
                   reverse_orientation=gs.reverse_orientation,
                   swaps_handedness=bool(tr.swaps_handedness(m)),
                   area_light_emit=emit, n_samples=nsamp,
                   alpha_tex=self._alpha_tex_for(shape_params, gs))

    def _alpha_tex_for(self, shape_params, gs):
        """A shape's alpha-cutout float texture row ("texture alpha" or
        "float alpha", Triangle::Intersect's alpha test); -1: opaque."""
        ref = shape_params.find_texture("alpha")
        if ref is not None:
            if ref not in gs.float_textures:
                log.warning('alpha texture "%s" not found', ref)
                return -1
            return gs.float_textures[ref]
        a = shape_params.find_one_float("alpha", 1.0)
        if a != 1.0:
            return self.builder.const_tex((a, a, a))
        return -1

    def _material_id_for_state(self, gs, shape_params):
        saved = self.gs
        self.gs = gs
        try:
            return self._current_material_id(shape_params)
        finally:
            self.gs = saved

    def _make_shape_mesh(self, name, params):
        """(verts, idx, normals, uvs) in object space, or None."""
        if name == "trianglemesh":
            idx = params.find_ints("indices")
            P = params.find_points("P")
            if idx is None or P is None:
                log.warning("trianglemesh missing indices/P; ignored")
                return None
            N = params.find_normals("N")
            uv = params.find_floats("uv")
            if uv is None:
                uv = params.find_floats("st")
            return (np.asarray(P, np.float32),
                    np.asarray(idx, np.int64).reshape(-1, 3),
                    np.asarray(N, np.float32) if N is not None else None,
                    np.asarray(uv, np.float32).reshape(-1, 2) if uv is not None else None)
        if name == "sphere":
            r = params.find_one_float("radius", 1.0)
            return shp.sphere(r, params.find_one_float("zmin", -r),
                              params.find_one_float("zmax", r),
                              params.find_one_float("phimax", 360.0))
        if name == "cylinder":
            return shp.cylinder(params.find_one_float("radius", 1.0),
                                params.find_one_float("zmin", -1.0),
                                params.find_one_float("zmax", 1.0),
                                params.find_one_float("phimax", 360.0))
        if name == "disk":
            return shp.disk(params.find_one_float("height", 0.0),
                            params.find_one_float("radius", 1.0),
                            params.find_one_float("innerradius", 0.0),
                            params.find_one_float("phimax", 360.0))
        if name == "cone":
            return shp.cone(params.find_one_float("height", 1.0),
                            params.find_one_float("radius", 1.0),
                            params.find_one_float("phimax", 360.0))
        if name == "paraboloid":
            return shp.paraboloid(params.find_one_float("radius", 1.0),
                                  params.find_one_float("zmin", 0.0),
                                  params.find_one_float("zmax", 1.0),
                                  params.find_one_float("phimax", 360.0))
        if name == "hyperboloid":
            return shp.hyperboloid(params.find_one_point("p1", (0, 0, 0)),
                                   params.find_one_point("p2", (1, 1, 1)),
                                   params.find_one_float("phimax", 360.0))
        if name == "loopsubdiv":
            P = params.find_points("P")
            idx = params.find_ints("indices")
            if P is None or idx is None:
                return None
            return shp.loop_subdivide(np.asarray(P, np.float32),
                                      np.asarray(idx, np.int64).reshape(-1, 3),
                                      params.find_one_int("nlevels", 3))
        if name == "heightfield":
            nu = params.find_one_int("nu", 0)
            nv = params.find_one_int("nv", 0)
            z = params.find_floats("Pz")
            if not nu or not nv or z is None:
                return None
            return shp.heightfield(nu, nv, z)
        if name == "nurbs":
            P = params.find_points("P")
            return shp.nurbs(
                params.find_one_int("nu", 0), params.find_one_int("uorder", 0),
                params.find_floats("uknots"),
                params.find_one_float("u0", 0.0), params.find_one_float("u1", 1.0),
                params.find_one_int("nv", 0), params.find_one_int("vorder", 0),
                params.find_floats("vknots"),
                params.find_one_float("v0", 0.0), params.find_one_float("v1", 1.0),
                P if P is not None else params.find_floats("Pw"), P is None)
        raise _unported(f'Shape "{name}"')

    # ---------------------------------------------------------------- instances
    def object_begin(self, name):
        self.attribute_begin()
        self.objects[name] = []
        self.current_object = name

    def object_end(self):
        self.current_object = None
        self.attribute_end()

    def object_instance(self, name):
        if name not in self.objects:
            log.warning("ObjectInstance: unknown object %r", name)
            return
        shapes = self.objects[name]
        inst_ctm = self.ctm
        if sum(len(s[1]) for s in shapes) <= self.INSTANCE_BAKE_MAX:
            for verts, idx, normals, uvs, gs, obj_ctm, shape_params in shapes:
                combined = TransformSet()
                combined.t = [inst_ctm.t[i] @ obj_ctm.t[i] for i in range(2)]
                self._emit_shape(verts, idx, normals, uvs, gs, combined, shape_params)
            return
        b = self.builder
        obj_id = self._tlas_objects.get(name)
        if obj_id is None:
            obj_id = b.add_object()
            for verts, idx, normals, uvs, gs, obj_ctm, shape_params in shapes:
                m = obj_ctm.t[0]
                if obj_ctm.is_animated():
                    log.warning("Animated CTM inside ObjectBegin %r: using the "
                                "start key", name)
                ov = tr.xform_p_np(m, verts)
                on = normals
                if normals is not None:
                    on = tr.xform_n_np(tr.inverse(m), normals)
                    on = on / np.maximum(np.linalg.norm(on, axis=1, keepdims=True), 1e-12)
                if gs.area_light is not None:
                    log.warning("Area light inside ObjectInstance %r ignored "
                                "(pbrt TransformedPrimitive carries no area light)",
                                name)
                mat_id = self._material_id_for_state(gs, shape_params)
                b.add_object_mesh(obj_id, ov, idx, mat_id, normals=on, uvs=uvs,
                                  reverse_orientation=gs.reverse_orientation,
                                  swaps_handedness=bool(tr.swaps_handedness(m)),
                                  alpha_tex=self._alpha_tex_for(shape_params, gs))
            self._tlas_objects[name] = obj_id
        b.add_instance(obj_id, inst_ctm.t[0].copy(), inst_ctm.t[1].copy())

    # ------------------------------------------------------------------ volumes
    def volume(self, name, params):
        """Volume -> a media region (src/volumes/*), in the CTM's frame."""
        common = dict(
            v2w=self.ctm.t[0],
            p0=params.find_one_point("p0", (0, 0, 0)),
            p1=params.find_one_point("p1", (1, 1, 1)),
            sigma_a=params.find_one_rgb("sigma_a", (0.45,) * 3),
            sigma_s=params.find_one_rgb("sigma_s", (0.25,) * 3),
            g=params.find_one_float("g", 0.0),
            le=params.find_one_rgb("Le", (0, 0, 0)))
        b = self.builder
        if name == "homogeneous":
            b.add_volume(med.HOMOGENEOUS, **common)
        elif name == "volumegrid":
            dens = params.find_floats("density")
            if dens is None:
                log.warning("volumegrid without density ignored")
                return
            shape = tuple(params.find_one_int(k, 1) for k in ("nz", "ny", "nx"))
            b.add_volume(med.GRID, density=np.asarray(dens, np.float32).reshape(shape),
                         **common)
        elif name == "exponential":
            b.add_volume(med.EXPONENTIAL, exp_a=params.find_one_float("a", 1.0),
                         exp_b=params.find_one_float("b", 1.0),
                         updir=params.find_one_point("updir", (0, 1, 0)), **common)
        else:
            log.warning("Unknown volume %r ignored", name)
        params.report_unused(f'Volume "{name}"')

    # ------------------------------------------------------------------- finish
    def world_end(self):
        """MakeRenderer + MakeScene -> (scene, meta); the integrator's
        configuration is left in self.integrator_config."""
        b = self.builder
        b.xres = self.film_params.find_one_int("xresolution", 640)
        b.yres = self.film_params.find_one_int("yresolution", 480)
        cw = self.film_params.find_floats("cropwindow")
        if cw is not None and len(cw) == 4:
            # image.cpp's constructor clamps and orders the crop window
            x0, x1 = sorted((max(0.0, min(1.0, cw[0])), max(0.0, min(1.0, cw[1]))))
            y0, y1 = sorted((max(0.0, min(1.0, cw[2])), max(0.0, min(1.0, cw[3]))))
            b.crop = (x0, x1, y0, y1)
        self.out_filename = self.film_params.find_one_string("filename", "out.exr")
        fkind = self.filter_name if self.filter_name in FILTERS else "box"
        kw = {}
        xw = self.filter_params.find_floats("xwidth")
        yw = self.filter_params.find_floats("ywidth")
        if xw is not None and len(xw):
            kw["xwidth"] = float(xw[0])
        if yw is not None and len(yw):
            kw["ywidth"] = float(yw[0])
        if fkind == "gaussian":
            kw["alpha"] = self.filter_params.find_one_float("alpha", 2.0)
        if fkind == "mitchell":
            kw["b"] = self.filter_params.find_one_float("B", 1.0 / 3.0)
            kw["c"] = self.filter_params.find_one_float("C", 1.0 / 3.0)
        if fkind == "sinc":
            kw["tau"] = self.filter_params.find_one_float("tau", 3.0)
        b.filter = FilterConfig.from_name(fkind, **kw)

        spp = self.sampler_params.find_one_int(
            "pixelsamples", self.sampler_params.find_one_int("nsamples", 4))
        if self.sampler_name == "stratified":
            spp = (self.sampler_params.find_one_int("xsamples", 2)
                   * self.sampler_params.find_one_int("ysamples", 2))
        if self.sampler_name == "bestcandidate":
            log.warning("Sampler %r mapped to scrambled (0,2)-sequence",
                        self.sampler_name)
        if self.sampler_name == "adaptive":
            # adaptive.cpp's "minsamples"/"maxsamples": the re-queue between
            # waves of engine.render.render_adaptive over the (0,2)-sequence
            self.adaptive = {"min": self.sampler_params.find_one_int("minsamples", 4),
                             "max": self.sampler_params.find_one_int("maxsamples", 32)}
            spp = self.adaptive["max"]
        b.sampler = SamplerConfig(kind=SAMPLER_KINDS.get(self.sampler_name, ZERO_TWO),
                                  spp=spp)

        sw = self.camera_params.find_floats("screenwindow")
        b.camera = cam.build_camera(
            CAMERAS.get(self.camera_name, cam.PERSPECTIVE), self.camera_to_world.t[0], self.camera_to_world.t[1],
            b.xres, b.yres,
            fov=self.camera_params.find_one_float("fov", 90.0),
            screen_window=list(sw) if sw is not None and len(sw) == 4 else None,
            lens_radius=self.camera_params.find_one_float("lensradius", 0.0),
            focal_distance=self.camera_params.find_one_float("focaldistance", 1e6),
            shutter_open=self.camera_params.find_one_float("shutteropen", 0.0),
            shutter_close=self.camera_params.find_one_float("shutterclose", 1.0))

        kind = INTEGRATORS.get(self.integrator_name)
        if kind is None:
            log.warning("Surface integrator %r not yet implemented; using path",
                        self.integrator_name)
            kind = "path"
        ip = self.integrator_params
        strategy = ip.find_one_string("strategy", "all")
        self.integrator_config = IntegratorConfig(
            kind=kind, max_depth=ip.find_one_int("maxdepth", 5),
            # directlighting's "strategy": "one", or else "all"
            light_strategy=("one" if strategy == "one" else "all")
            if kind == "direct" else "one",
            ao_samples=ip.find_one_int("nsamples", 2048) if kind == "ao" else 1,
            ao_maxdist=ip.find_one_float("maxdist", 1e7),
            vol=(self.vol_integrator_name if self.vol_integrator_name in VOLUME_INTEGRATORS
                 else "emission"),
            vol_stepsize=self.vol_integrator_params.find_one_float("stepsize", 0.1),
            sss_maxerror=ip.find_one_float("maxerror", 0.05) if kind == "dipole" else 0.05,
            sss_sigma_a=tuple(self.sss_sigma_a), sss_sigma_s=tuple(self.sss_sigma_s),
            sss_eta=self.sss_eta)
        if self.renderer_name == "metropolis":
            rp = self.renderer_params
            self.mlt_config = MLTConfig(
                max_depth=rp.find_one_int("maxdepth", 7),
                n_bootstrap=rp.find_one_int("bootstrapsamples", 4096),
                large_step_prob=rp.find_one_float("largestepprobability", 0.25),
                mutations_per_wave=16,
                bidirectional=rp.find_one_bool("bidirectional", True),
                direct_separate=rp.find_one_bool("dodirectseparately", False))
            self.mlt_spp = rp.find_one_int("samplesperpixel", 32)
        elif self.renderer_name not in ("sampler", "aggregatetest", ""):
            log.warning("Renderer %r falls back to the sampler renderer",
                        self.renderer_name)
        if self.accelerator_name not in ("bvh", ""):
            log.warning("Accelerator %r mapped to BVH", self.accelerator_name)

        for ps, ctx in ((self.camera_params, f'Camera "{self.camera_name}"'),
                        (self.film_params, f'Film "{self.film_name}"'),
                        (self.sampler_params, f'Sampler "{self.sampler_name}"'),
                        (self.filter_params, f'PixelFilter "{self.filter_name}"'),
                        (self.integrator_params,
                         f'SurfaceIntegrator "{self.integrator_name}"')):
            ps.report_unused(ctx)
        return b.finalize(self.device)


def _spot_frame(from_p, to_p):
    """The spot light's frame: +z from `from` toward `to`, at `from` (the
    reference's construction of spot.cpp's light-to-world)."""
    d = to_p - from_p
    d = d / max(np.linalg.norm(d), 1e-12)
    up = np.array([0, 1, 0.0]) if abs(d[1]) < 0.9 else np.array([1, 0, 0.0])
    x = np.cross(up, d)
    x /= np.linalg.norm(x)
    m = tr.identity()
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, np.cross(d, x), d, from_p
    return m

