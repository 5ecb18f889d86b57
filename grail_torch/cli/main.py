"""Command line renderer (port of grail/cli/main.py; pbrt src/main/pbrt.cpp):
parse .pbrt scene files, render each with the integrator its
SurfaceIntegrator line names, with the Metropolis renderer where its
Renderer line says "metropolis" and with adaptive sampling where its
Sampler line says "adaptive", and write the image (EXR or PFM; 8-bit
formats need PIL). Renderer "createprobes" bakes a grid of SH radiance
probes instead (its resolution a cell of "samplespacing" along the scene's
extent, 1 to 16 cells an axis) and writes it to its "filename", which
SurfaceIntegrator "useprobes" reads back by its own "filename"; Renderer
"surfacepoints" writes the sampled surface point cloud (x y z nx ny nz
area a line) to its "filename".

    python -m grail_torch.cli.main [options] scene.pbrt [scene2.pbrt ...]
    python -m grail_torch.cli.main --outfile out.exr --quick scene.pbrt
    python -m grail_torch.cli.main --checkpoint ck.npz --metrics m.jsonl scene.pbrt

--checkpoint PATH resumes the render from PATH where the file exists and
writes it every --checkpoint-every samples (8), removing it when the render
completes; --metrics PATH appends the occupancy line and one JSONL record a
megawave (engine/render.py). Both apply to the sampler renderer's uniform
render, as in the reference. Metropolis runs the reference's number of
waves: pixels x "samplesperpixel" mutations over n_chains x 16 a wave.

It renders on the CUDA card; --cpu is the only way to render on the CPU.
A scene that needs a part not ported yet exits with status 1 and names it.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="grail_torch",
                                 description="pbrt-compatible path tracer (PyTorch/CUDA)")
    ap.add_argument("scenes", nargs="+", help=".pbrt scene files ('-' = stdin)")
    ap.add_argument("--outfile", default=None, help="override the output image path")
    ap.add_argument("--quick", action="store_true",
                    help="1/4 of the samples, for fast previews (pbrt --quick)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--spp", type=int, default=None, help="override samples per pixel")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint file: resumed if present, written every "
                         "--checkpoint-every samples")
    ap.add_argument("--checkpoint-every", type=int, default=8, metavar="N")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="append per-wave JSONL metrics (rays/s, wall time)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else
        (logging.ERROR if args.quiet else logging.INFO),
        format="grail_torch: %(levelname)s: %(message)s")
    log = logging.getLogger("grail_torch")

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..engine.imageio import write_image
    from ..engine.metropolis import render_mlt
    from ..engine.prt import bake_probes, write_probes
    from ..engine.render import render, render_adaptive
    from ..engine.subsurface import sample_surface_points
    from ..scene.parser import parse_file, parse_string

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        log.error("%s", e)
        return 1
    for scene_path in args.scenes:
        t0 = time.time()
        try:
            if scene_path == "-":
                scene, meta, api = parse_string(sys.stdin.read(), device=device)
            else:
                scene, meta, api = parse_file(scene_path, device=device)
        except (OSError, ValueError, NotImplementedError) as e:
            log.error("%s: %s", scene_path, e)
            return 1
        log.info("parsed %s: %d tris, %d lights, %d materials (%.1fs)",
                 scene_path, meta.n_tris, meta.n_lights,
                 scene["materials"]["lobe_type"].shape[0], time.time() - t0)

        spp = args.spp if args.spp else meta.sampler.spp
        if args.quick:
            spp = max(1, spp // 4)
        cfg = api.integrator_config
        t0 = time.time()

        def progress(s, total):
            if not args.quiet and (s % max(1, total // 20) == 0 or s == total):
                log.info("  wave %d/%d (%.1fs)", s, total, time.time() - t0)

        if api.probe_bake is not None:
            pb = api.probe_bake
            v = scene["verts"].cpu().numpy()
            extent = np.maximum(v.max(0) - v.min(0), 1e-6)
            res = tuple(int(np.clip(np.ceil(e / pb["spacing"]), 1, 16)) for e in extent)
            write_probes(pb["filename"], bake_probes(scene, meta, cfg, *res,
                                                     n_samples=pb["nsamples"],
                                                     lmax=pb["lmax"]))
            log.info("wrote %s (%dx%dx%d probes, lmax=%d) in %.1fs", pb["filename"], *res,
                     pb["lmax"], time.time() - t0)
            continue
        if api.surfacepoints_out is not None:
            sp = api.surfacepoints_out
            p, n, area = sample_surface_points(scene, sp["npoints"])
            rows = torch.cat([p, n, area[:, None]], dim=1).cpu().numpy()
            with open(sp["filename"], "w") as f:
                f.write("# grail surface points: x y z nx ny nz area\n")
                for row in rows:
                    f.write(" ".join(f"{x:.9g}" for x in row) + "\n")
            log.info("wrote %s (%d points)", sp["filename"], sp["npoints"])
            continue
        if api.mlt_config is not None:
            mcfg = api.mlt_config
            n_waves = max(1, (meta.xres * meta.yres * api.mlt_spp)
                          // (mcfg.n_chains * mcfg.mutations_per_wave))
            img, _ = render_mlt(scene, meta, mcfg, n_waves=n_waves, device=device)
            what = f"MLT, {n_waves} waves"
        elif api.adaptive:
            img, _ = render_adaptive(scene, meta, cfg, min_spp=min(api.adaptive["min"], spp),
                                     max_spp=spp, progress=progress, device=device)
            what = f"adaptive, <= {spp}spp"
        else:
            img, _ = render(scene, meta, cfg, spp=spp, progress=progress,
                            checkpoint_path=args.checkpoint,
                            checkpoint_every=args.checkpoint_every,
                            metrics_path=args.metrics, device=device)
            what = f"{spp}spp"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log.info("rendered %dx%d (%s) on %s in %.1fs", meta.xres, meta.yres, what, device,
                 time.time() - t0)
        out = args.outfile or api.out_filename
        write_image(out, np.asarray(img.cpu()))
        log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
