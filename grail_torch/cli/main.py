"""Command line renderer (port of grail/cli/main.py; pbrt src/main/pbrt.cpp):
parse .pbrt scene files, render each with the integrator its
SurfaceIntegrator line names (path, directlighting, whitted or
ambientocclusion), write the image (EXR or PFM; 8-bit formats need PIL).

    python -m grail_torch.cli.main [options] scene.pbrt [scene2.pbrt ...]
    python -m grail_torch.cli.main --outfile out.exr --quick scene.pbrt

It renders on the CUDA card; --cpu is the only way to render on the CPU.
A scene that needs a part not ported yet exits with status 1 and names it.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time

# options of the reference's CLI that the port does not have yet
_UNPORTED_OPTIONS = {"checkpoint": "--checkpoint", "metrics": "--metrics"}


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
    ap.add_argument("--checkpoint", default=None, metavar="PATH", help="not ported yet")
    ap.add_argument("--metrics", default=None, metavar="PATH", help="not ported yet")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else
        (logging.ERROR if args.quiet else logging.INFO),
        format="grail_torch: %(levelname)s: %(message)s")
    log = logging.getLogger("grail_torch")
    for dest, flag in _UNPORTED_OPTIONS.items():
        if getattr(args, dest) is not None:
            log.error("%s is not ported yet", flag)
            return 2

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..engine.imageio import write_image
    from ..engine.render import render
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
        t0 = time.time()
        img, _ = render(scene, meta, api.integrator_config, spp=spp, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        log.info("rendered %dx%d @ %dspp on %s in %.1fs", meta.xres, meta.yres, spp,
                 device, time.time() - t0)
        out = args.outfile or api.out_filename
        write_image(out, np.asarray(img.cpu()))
        log.info("wrote %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
