"""Material-sorted shading (port of grail/shade/megabatch.py).

The masked path evaluates every texture row and every lobe type of the scene
on every lane. This pass sorts the shade queue by material instead and
evaluates each material only on its own lanes, with only its own texture
rows (their input closure) and only its own lobe types, the lobe fields and
conversions read from SceneMeta.mat_specs rather than gathered a lane:

  1. the live lanes are counting-sorted by material (kernels/binning.py's
     stable bucket rank; dead lanes take key M, after every material);
  2. each material's contiguous range is evaluated in chunks of at most
     `block` lanes; the dead range is the reference's zeros, unevaluated;
  3. the results are gathered back to the original lane order.

The reference runs fixed-size blocks through lax.switch, with a generic
branch for blocks that straddle two materials and a benign padding frame for
its last block. Here the ranges are exact (one host read of the counts a
pass), so no block is mixed, none is padded, and no dead or padding lane
reaches normalize: no NaN can reach the backward from them.

One visit computes the bounce's three BSDF uses: the light branch's f and
pdf (EstimateDirect), the continuation's Sample_f, and the partner pdf of
path-vertex reuse. Every formula is the masked path's on the lane's own
lobes, so the results equal the unsorted pass's. STATS counts the visits.
"""
from __future__ import annotations

import torch

from .. import telemetry
from ..kernels.binning import bucket_rank, sort_by_rank
from . import bsdf as bx
from . import geometry as geom
from .materials import CONV_INV, CONV_RADIANS, MAT_FIELDS
from .textures import eval_texture_rows

# sorted visits (one a bounce that takes this pass), the material chunks
# they evaluated, and the live lanes they sorted
STATS = {"visits": 0, "chunks": 0, "lanes": 0}

OUTPUTS = ("f_l", "pdf_l", "wi_w", "f", "pdf", "spec", "valid", "pdf_prev_nospec")
_FIELD = {f: i for i, f in enumerate(MAT_FIELDS)}
# the slot of an empty material: the material table's padding (type NONE, row 0)
_EMPTY = ((0,) * len(MAT_FIELDS),)


def _convert_static(x, conv):
    """gather_lobes' f0/f1 conversion for a tag known on the host: the same
    formulas, so the values are the masked select's."""
    if conv == CONV_INV:
        return 1.0 / torch.clamp_min(x, 1e-5)
    if conv == CONV_RADIANS:
        return x * (3.14159265 / 180.0)
    return x


def _lobes_from_spec(spec_m, vals, n, width):
    """The (n, K_m) lobe stack of one material from its slot tuples and the
    evaluated texture rows {row: (n, 3)}. Each field is the first K_m slots
    of an (n, width) stack, width the material table's: a slot's column then
    has the masked gather's stride, and the CPU's elementwise kernels (whose
    vectorised and strided loops round pow and exp differently) take the
    masked path's loop, so the values are its bits there too."""
    k = len(spec_m)

    def stacked(cols):
        pad = [torch.zeros_like(cols[0])] * (width - k)
        return torch.stack(cols + pad, dim=1)[:, :k]

    def colour(field):
        return stacked([vals[s[_FIELD[field]]] for s in spec_m])

    def scalar(field, conv=None):
        return stacked([_convert_static(vals[s[_FIELD[field]]][:, 0],
                                        s[_FIELD[conv]] if conv else None)
                        for s in spec_m])

    def const(field):
        device = vals[spec_m[0][_FIELD["s0"]]].device
        row = torch.tensor([s[_FIELD[field]] for s in spec_m], dtype=torch.int32,
                           device=device)
        return row.expand(n, k)

    return {"type": const("lobe_type"), "fr": const("fr"), "R": colour("s0"),
            "S1": colour("s1"), "S2": colour("s2"), "f0": scalar("f0", "f0_conv"),
            "f1": scalar("f1", "f1_conv"), "f2": scalar("f2")}


def _shade_one(lobes, blk, present, tables):
    """The bounce's BSDF work on one chunk, given its lobe stack."""
    wo = blk["wo"]
    f_l = bx.bsdf_f(lobes, wo, blk["wil"], present, include_specular=False, tables=tables)
    pdf_l = bx.bsdf_pdf(lobes, wo, blk["wil"], present, include_specular=False)
    bs = bx.bsdf_sample(lobes, wo, blk["u1"], blk["u2"], blk["uc"], present,
                        include_specular=True, tables=tables)
    wi_w = geom.local_to_world(blk, bs["wi"])
    # the partner pdf through the same local/world round trip as the
    # unsorted body, so the MIS weights are the same
    pdf_prev = bx.bsdf_pdf(lobes, wo, geom.world_to_local(blk, wi_w), present,
                           include_specular=False)
    return {"f_l": f_l, "pdf_l": pdf_l, "wi_w": wi_w, "f": bs["f"], "pdf": bs["pdf"],
            "spec": bs["specular"], "valid": bs["valid"], "pdf_prev_nospec": pdf_prev}


def _material_pass(scene, meta, m):
    """The evaluation specialised to material m: its texture rows' closure,
    its lobe types, its slots."""
    spec_m = meta.mat_specs[m] or _EMPTY
    rows = {s[_FIELD[f]] for s in spec_m for f in ("s0", "s1", "s2", "f0", "f1", "f2")}
    present = tuple(sorted({s[_FIELD["lobe_type"]] for s in spec_m} - {bx.NONE}))
    tables = scene.get("brdf_tables", ())
    width = scene["materials"]["lobe_type"].shape[1]

    def run(blk):
        vals = eval_texture_rows(meta.tex_specs, scene["tex_data"], blk, rows,
                                 scene.get("images", ()), scene.get("mipmaps", ()))
        lobes = _lobes_from_spec(spec_m, vals, blk["wo"].shape[0], width)
        return _shade_one(lobes, blk, present, tables)
    return run


def _dead(n, like):
    z3 = like.new_zeros((n, 3))
    z1 = like.new_zeros((n,))
    zb = torch.zeros((n,), dtype=torch.bool, device=like.device)
    return {"f_l": z3, "pdf_l": z1, "wi_w": z3, "f": z3, "pdf": z1, "spec": zb,
            "valid": zb, "pdf_prev_nospec": z1}


@telemetry.spanned("megabatch")
def megabatch_shade(scene, meta, sg, wo_local, wi_l_local, u1, u2, u_comp, active,
                    block=8192):
    """Sorted, per-material shading pass.

    sg: the shading record (p, uv, ns, ss, ts, mat, and duvdx/duvdy on the
    camera wave); wo_local, wi_l_local: the outgoing and light-sample
    directions in the local frame; u1, u2, u_comp: the continuation's
    Sample_f draws. Lanes with ~active or mat < 0 are dead. Returns, in the
    original lane order: f_l, pdf_l (the light branch), wi_w, f, pdf, spec,
    valid (the continuation) and pdf_prev_nospec (the reuse-MIS partner
    pdf); dead lanes get zeros."""
    n = wo_local.shape[0]
    M = len(meta.mat_specs)
    mat = sg["mat"]
    key = torch.where(active & (mat >= 0), torch.clamp_min(mat, 0), M).to(torch.int64)
    counts = telemetry.sync("megabatch", torch.bincount(key, minlength=M + 1).tolist)
    STATS["visits"] += 1
    STATS["lanes"] += n - counts[M]
    inputs = {"wo": wo_local, "wil": wi_l_local, "u1": u1, "u2": u2, "uc": u_comp}
    inputs.update({k: sg[k] for k in ("p", "uv", "ns", "ss", "ts", "duvdx", "duvdy")
                   if k in sg})
    rank = bucket_rank(key, M + 1)
    srt = dict(zip(inputs, sort_by_rank(rank, *inputs.values())))
    parts, start = [], 0
    for m, count in enumerate(counts[:M]):
        if count:
            run = _material_pass(scene, meta, m)
            for a in range(start, start + count, block):
                b = min(a + block, start + count)
                parts.append(run({k: v[a:b] for k, v in srt.items()}))
                STATS["chunks"] += 1
        start += count
    parts.append(_dead(counts[M], wo_local))
    return {k: torch.cat([p[k] for p in parts])[rank] for k in OUTPUTS}
