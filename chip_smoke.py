#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (grail_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line with its seconds; any
failure ends the run with a non-zero exit code:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: every CUDA kernel of the port, compiled from the sources here
     (one nvcc per source, all started together), with ptxas's registers
     and spills per kernel instance, and the brute-force kernel's static
     instructions a ray-triangle pair (its triangle loop in cuobjdump -sass);
  Cornell box (36 triangles, brute-force intersector):
  3. parity: both instances (closest and any hit) against their plain
     PyTorch version on the card at the main path's shapes (1,048,576 rays)
     and at a ragged count (1,048,613), bitwise;
  4. main path: a render on the card against the same render on the CPU;
  5. bench: the bench render (256x256, 16 spp, path integrator, max depth 5)
     through the kernel, with its launch counts, and each instance's time
     beside its plain version, its bound (the operations of the stages of
     the hit test that each pair needs) and its issue time were every pair
     to take every path of its loop;
  mesh100k (the 100k-triangle terrain at grid=224, BVH traversal):
  6. parity: each of the four record-stream kernels against its plain
     version at 1,048,576 rays: the bench camera wave (skip, closest hit), a
     binned incoherent secondary wave (ordered, closest and any hit) and
     shadow rays with random lengths and 1/8 dead lanes (skip, any hit); the
     two 4-wide kernels on the rays of the kernels they replace on the main
     path (closest hit on the secondary wave and on the camera wave, any hit
     on the shadow rays), against their plain versions and against those
     kernels;
  7. main path: a 64x64, 4 spp, depth 3 render on the card against the CPU,
     through the 4-wide route;
  8. bench: the bench render (256x256, 16 spp, depth 5) through the kernels,
     with launches per render of each kernel, the closest hit's split by
     wave (camera, binned);
  9. kernel_time: each traversal kernel's ms per launch beside its plain
     version and its bound; each 4-wide kernel timed in turns with the
     kernel it replaces, on each wave it takes, and the 4-wide any hit in
     turns with the ordered any hit (row 3, reached only by a kind
     override) on the sorted secondary wave;
  (the record table, which only the record-stream kernels read, is built
  on request for phases 6 and 9 and dropped before phases 7 and 8)
  mesh1m (mesh_scene_1m: 1,001,906 triangles, a thin lens and a moving
  camera, the 4-wide tables above the card's L2):
  10. set-up: the host build, the table sizes, and what the record table
      would cost;
  11. parity: the 4-wide closest hit on the camera wave (depth of field
      and motion blur, unbinned) and on a binned secondary wave, the any hit
      on shadow rays, each against its plain version at 1,048,576 rays,
      bitwise;
  12. kernel_time: each of those beside its plain version and its bound;
  13. main path: the full geometry at 32x32, 2 spp, depth 3, card against
      CPU;
  14. bench: bench.py's mesh1m render (256x256, 4 spp: one megawave of
      262,144 camera rays; depth 5), launches per render by wave;
  instanced (tools/instbench.py: 100 instances of a 50,176-triangle sphere
  over a floor under a point light, and the same field flattened into
  5,017,600 world-space triangles):
  15. set-up: both scenes' host build, table sizes, instance count, stack
      bound;
  16. parity: the 4-wide walk with per-ray roots (the instanced BLAS walk),
      closest and any hit, against its plain version at 1,048,576
      object-space rays of a sweep's first round (the camera wave at
      16 samples a pixel; shadow rays from its hits toward the light) and at
      a ragged count, bitwise;
  17. main path: the instanced scene at 32x32, 2 spp, depth 3, card against
      CPU; a small scene with a moving and a mirrored instance, card against
      CPU, the moving one smeared across the shutter on both;
  18. bench: instbench's render of both scenes (256x256, 4 spp, depth 3):
      rates, launches per render (base walk and roots walk apart), the sweep
      rounds of each wave, peak memory, the ratio of the two rates;
  19. kernel_time: the walk with roots beside its plain version and its
      bound;
  training path:
  20. grad: the gradient of the mean image (256x256, 1 spp, depth 5) for
      the Cornell box's albedos, emission and vertices (brute-force kernel)
      and for mesh100k's texels, MIP pyramid and vertices (4-wide kernels),
      against the same through the plain versions on the card (bitwise) and
      against the CPU at 32x32; then optimize_albedo on the Cornell box;
  pbrt scene files (scenes/cornell.pbrt, glossy.pbrt, envlight.pbrt, through
  the port's own parser, 4-wide kernels):
  21. pbrt: each scene rendered at its authored settings by the command line
      (python -m grail_torch.cli.main SCENE --outfile OUT.exr, one process a
      scene, run together), the EXR read back against the scene's golden
      (tests/goldens, relative MAE < 0.02); in this process, the parse's
      host seconds; parity: the rays of the busiest wave of each kind that
      the authored render hands the 4-wide walk (the camera wave, binned
      secondary and shadow waves, and envlight's unbinned compacted tail),
      each kernel against its plain version on them, bitwise; the render
      at authored settings (a warm-up, then three timed: camera rays/s,
      launches per render of each kernel, the image against the golden);
      and the scene at 32x32, 2 spp on the card against the CPU.
  the direct group (the integrator kinds direct, whitted and ao):
  22. direct: the seven goldens of those kinds (nurbs, instances, dof,
      heightfield, whittedigi, subdiv, ao) through the command line, seven
      processes at once, each EXR against its golden; each at 32x32, 2 spp
      on the card against the CPU, and the Cornell box under direct with
      the power strategy (the area light's BSDF branch on brute force);
      full-size renders (256x256, 16 spp, one megawave of 1,048,576 camera
      rays): mesh100k under direct with the "all" strategy (its environment
      light's BSDF branch) and under ao with 4 samples, the Cornell box
      under whitted, each with camera rays/s (median of 3 after a warm-up),
      launches per render of each kernel, the waves by role (camera,
      continuation and BSDF-branch closest hits, shadow and occlusion any
      hits), the card's busy share under torch.profiler and peak memory,
      and direct and whitted again at depth 0 (the same image: their later
      bounces are dead waves); every kernel of the group's path launched;
      then each kernel against its plain version on the card, bitwise, on
      the busiest wave of each (kernel, role) those renders handed it.
  the maps group (the orthographic and environment cameras, the procedural
  textures and mappings, bump maps, alpha cutouts, the projection and
  goniometric lights; every scene read from a copy of scenes/ that
  grail_torch/tools/gen_assets.py writes the image assets into):
  23. maps: the four goldens of these features (orthodisk, proctex, bump,
      projgonio) through the command line, four processes at once, each EXR
      against its golden; each of them and alphacut (a checkerboard alpha
      cutout over a floor) at 32x32, 2 spp on the card against the CPU, and
      envlight.pbrt's world under the environment camera at 64x32; the
      five at 256x256, 16 spp (one megawave of 1,048,576 camera rays)
      under their own integrator (directlighting), each with camera rays/s
      (median of 3 after a warm-up), launches per render of each kernel,
      the waves by role (the cutout's re-traces as "alpha"), the card's
      busy share under torch.profiler and peak memory; then each kernel
      against its plain version on the card, bitwise, on the busiest wave of
      each (kernel, role), the re-traces with their per-ray tmin and
      IntersectP run as closest hit among them.
  the media group (participating media, measured BRDFs, the dipole
  subsurface integrator):
  24. media: the three goldens of these features (spotfog, measured,
      dipole) through the command line, three processes at once, each EXR
      against its golden; each at 32x32, 2 spp on the card against the CPU,
      and spotfog's world with its fog made a seeded density grid and an
      exponential region (the GRID and EXPONENTIAL marches); the three at
      256x256, 16 spp (one megawave of 1,048,576 camera rays) under their
      own integrator (directlighting with VolumeIntegrator "single",
      directlighting, dipolesubsurface), each with camera rays/s (median
      of 3 after a warm-up), launches per render of each kernel, the waves
      by role (the march's "medium" waves, the dipole preprocess's
      "irradiance" waves), the card's busy share under torch.profiler and
      peak memory, and the dipole's preprocess seconds apart; the dipole's
      Mo contraction alone at 1,048,576 lanes (ms, peak memory); then each
      kernel against its plain version on the card, bitwise, on the
      busiest wave of each (kernel, role).
  the Metropolis group (engine/metropolis.py and the render loop's other
  paths):
  25. mlt: scenes/mlt.pbrt at its authored settings (64x64, 64 mutations a
      pixel, 4,096 chains, 4 waves, bidirectional) through the command line
      in its own process, the EXR against its golden (relative MAE < 0.05)
      and against the long path-traced reference (8x8 block errors:
      median < 0.05, q90 < 0.10); meanwhile eval_path and eval_path_bidir
      on 4,096 u-vectors and _mutate, the card against the CPU (>= 99% of
      lanes within rtol 1e-4, atol 1e-6; the mutation bitwise), and a
      warm-up render; three timed renders (mutations/s, launches per
      render, which must be exactly 759 closest hits, mlt_camera 414 and
      mlt_light 345, all unbinned, and 2,484 any hits, mlt_connect; peak
      memory), the busy share under torch.profiler of one step of every
      chain; the same scene at 256x256 with 65,536 chains and bootstrap
      samples (binned closest hits; rate and peak); each kernel against its
      plain version on the busiest wave of each MLT role, bitwise; a
      checkpointed mesh100k render (64x64, 8 spp) resumed, bitwise the
      uninterrupted one; a cropped and an adaptive Cornell box at 32x32,
      card against CPU; mesh100k's occupancy line at 256x256.
Then a {"kernels": [...]} line (each kernel's "launches_direct",
"launches_maps", "launches_media" and "launches_mlt": its launches in the
direct, maps, media and Metropolis groups' renders) and, last, {"ok": true,
"device": {...}}.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""
import contextlib
import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from grail_torch.core import rng as rngmod
from grail_torch.core import transform as tr
from grail_torch.engine.imageio import read_image
from grail_torch.engine import camera
from grail_torch.engine.film import develop, new_film
from grail_torch.engine import checkpoint as ckpt
from grail_torch.engine import integrator as integ
from grail_torch.engine import metropolis as mlt
from grail_torch.engine.integrator import WAVES, IntegratorConfig
from grail_torch.engine import subsurface
from grail_torch.engine.render import (camera_rays, megawave_lanes, occupancy_probe,
                                       preprocess, render, render_adaptive, render_wave)
from grail_torch.kernels import brute_intersect as bi
from grail_torch.kernels import bvh4 as b4
from grail_torch.kernels import bvh_stream as bs
from grail_torch.kernels import build
from grail_torch.kernels import instanced
from grail_torch.kernels import intersect as isect
from grail_torch.kernels.binning import (N_RAY_BUCKETS, bin_rays_key, bucket_rank,
                                         sort_by_rank)
from grail_torch.kernels.intersect import (BIG_T, CLOSEST_WAVES, SORT_MIN,
                                           moller_trumbore, pack_tris)
from grail_torch.scene.buffers import SceneBuilder, attach_record_table
from grail_torch.scene.parser import parse_file, parse_string
from grail_torch.scene.presets import cornell_box, mesh_scene, mesh_scene_1m
from grail_torch.scene.shapes import sphere
from grail_torch.shade import media
from grail_torch.shade.lights import AREA, INFINITE
from grail_torch.tools import gen_assets, instbench
from grail_torch.tools.instbench import (N_INST, SPHERE_NU, SPHERE_NV, build_flattened,
                                         build_instanced)
from grail_torch.tools.optimize import optimize_albedo

N_RAYS = 1 << 20
MESH_GRID = 224
# H100 SXM published peaks (dense, at the 700 W limit): FP32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Möller-Trumbore and its hit test per ray-triangle pair, by stage of the
# predicate (a conjunction, so a pair that fails a stage needs no later one):
# s1, the divisor, its guard and reciprocal, s, b1 and the divisor and b1
# tests (29); s2, b2, b1 + b2 and their tests (18); t and its two tests (8)
OPS_STAGES = (29, 18, 8)
OPS_PER_PAIR = sum(OPS_STAGES)   # every stage: 55
LANES_PER_SM = 128         # FP32 lanes of a Hopper SM: one instruction a lane a clock
# slab test per box record (bvh_stream.cu): 6 subtracts, 6 multiplies, one
# min and one max per axis (6), 4 min/max across axes, 1 multiply and
# 3 compares
OPS_PER_BOX = 26
RAY_BYTES = 12 + 12 + 4 + 4 + 16   # o, d, tmin, tmax in; t, prim, b1, b2 out
PRIM_AGREE_MIN = 0.999
OCC_AGREE_MIN = 0.9999
RTOL, ATOL = 1e-5, 1e-6
RELMAE_MAX = 1e-3
SLEEP_CYCLES = 100_000_000    # ~50 ms of the card's clock ahead of a timed run
STREAM_SOURCE = "grail_torch/kernels/csrc/bvh_stream.cu"
STREAM_REPLACES = {"ordered": "grail/kernels/bvh_stream.py:269",
                   "skip": "grail/kernels/bvh_stream.py:414"}
BVH4_SOURCE = "grail_torch/kernels/csrc/bvh4.cu"
# the wave each record-stream kernel is held and timed on (mesh_ray_cases)
STREAM_CASES = {"skip_closest": "camera_wave", "ordered_closest": "sorted_secondary",
                "ordered_any_hit": "sorted_secondary", "skip_any_hit": "shadow"}
# each 4-wide kernel, the record-stream kernel it replaces on the main path
# and the dispatch's closest-hit route (intersect.CLOSEST_WAVES), one entry a
# wave: closest hit on binned secondary waves, any hit on shadow waves,
# closest hit on the camera wave
BVH4_REPLACES = (("bvh4_closest", "ordered_closest", "binned"),
                 ("bvh4_any_hit", "skip_any_hit", None),
                 ("bvh4_closest", "skip_closest", "unbinned"))
# row 3: the ordered any hit, which no main-path wave runs (a kind override
# reaches it), against the 4-wide any hit that is its redesign; timed in
# turns, not in the kernels line
BVH4_ROW3 = ("bvh4_any_hit", "ordered_any_hit", None)
# a mesh render of one megawave at depth 5: the camera wave's closest hit
# (unbinned), the binned closest hits of bounces 1-5, one shadow wave a
# bounce, all on the 4-wide kernels
MESH_EXPECTED = {"skip_closest": 0, "skip_any_hit": 0, "ordered_closest": 0,
                 "ordered_any_hit": 0, "bvh4_closest": 6, "bvh4_any_hit": 6,
                 "bvh4_closest_roots": 0, "bvh4_any_hit_roots": 0,
                 "brute_intersect": 0, "brute_intersect_any_hit": 0}
MESH_EXPECTED_WAVES = {"binned": 5, "unbinned": 1}
MESH1M_SPP = 4                  # bench.py's mesh1m render: 256x256, 4 spp
MESH1M_WAVES = (("bvh4_closest", "camera_wave"), ("bvh4_closest", "sorted_secondary"),
                ("bvh4_any_hit", "shadow"))
# instbench's render (benchmarks/instbench.py: 256x256, 4 spp, depth 3), and
# the walk with roots on each wave of a sweep's first round it takes; row 6
# of PERF.md, the per-stream start records of the two stream kernels that
# the reference's instanced route runs (ordered closest hit, skip any hit)
INST_SPP, INST_DEPTH = 4, 3
INST_WAVES = (("bvh4_closest_roots", "camera_wave"), ("bvh4_any_hit_roots", "shadow"))
ROOTS_REPLACES = {"bvh4_closest_roots": "grail/kernels/bvh_stream.py:270",
                  "bvh4_any_hit_roots": "grail/kernels/bvh_stream.py:424"}
# the training path: scene, preset, the kernels its render launches, and
# the leaves differentiated ({name: path in the scene})
GRAD_SCENES = (("cornell", cornell_box, bi.KERNELS),
               ("mesh100k", functools.partial(mesh_scene, grid=MESH_GRID), b4.KERNELS))
GRAD_LEAVES = {"cornell": {"const": ("tex_data", "const"), "emit": ("lights", "emit"),
                           "verts": ("verts",)},
               "mesh100k": {"img": ("images", 0), "flat": ("mipmaps", 0, "flat"),
                            "verts": ("verts",)}}
# card against CPU gradients: the renders agree to ~1e-6 (relative MAE), but
# the shading's float32 transcendental functions round differently on the
# two devices, a vertex sums many lanes' terms in another order, and a
# texel's bilinear weight is the fraction of a coordinate up to 6 x 256,
# which a last-bit change of uv moves by up to 1.2e-4 (as in
# tests/test_torch_grad.py against the reference)
GRAD_RTOL, GRAD_ATOL = 1e-3, 2e-3     # atol: of the largest CPU entry
# the pbrt scenes with golden images that the port renders (the path
# integrator), tests/test_golden.py's threshold for them, and the reduced
# size of the card-against-CPU check
ROOT = os.path.dirname(os.path.abspath(__file__))
PBRT_SCENES = ("cornell", "glossy", "envlight")
GOLDEN_RELMAE = 0.02
PBRT_SMALL_RES, PBRT_SMALL_SPP = 32, 2
# the kinds of wave each parsed scene's authored render must hand the 4-wide
# walk (captured_waves): envlight's compacted tail falls below SORT_MIN
PBRT_WAVES = {"cornell": ("camera_wave", "binned_secondary", "binned_shadow"),
              "glossy": ("camera_wave", "binned_secondary", "binned_shadow"),
              "envlight": ("camera_wave", "binned_secondary", "binned_shadow",
                           "unbinned_secondary", "unbinned_shadow")}
# the direct-lighting, Whitted and ambient-occlusion goldens, and the
# group's full-size renders (mesh100k's and the Cornell box's bench size:
# one megawave of 1,048,576 camera rays): (name, preset, configuration)
DIRECT_GOLDENS = ("nurbs", "instances", "dof", "heightfield", "whittedigi", "subdiv",
                  "ao")
DIRECT_RENDERS = (
    ("mesh100k_direct_all", "mesh", IntegratorConfig(kind="direct", light_strategy="all")),
    ("mesh100k_ao", "mesh", IntegratorConfig(kind="ao", ao_samples=4)),
    ("cornell_whitted", "cornell", IntegratorConfig(kind="whitted")))
# the Cornell box under the power strategy: the area light's BSDF branch on
# brute force, card against CPU
DIRECT_POWER = IntegratorConfig(kind="direct", light_strategy="power")
# the kernels of the group's path; each must launch in its renders
DIRECT_KERNELS = bi.KERNELS + b4.KERNELS + b4.ROOT_KERNELS
# the maps group: the goldens of the orthographic camera, the procedural
# textures, bump mapping and the projection and goniometric lights, and the
# alpha-cutout scene, read from a copy of scenes/ with the generated assets
# (tools/gen_assets.py); their full-size renders (one megawave of 1,048,576
# camera rays under the scene's own integrator); the environment camera on
# envlight.pbrt's world; every scene takes the 4-wide kernels (rows 2, 4, 5)
MAPS_GOLDENS = ("orthodisk", "proctex", "bump", "projgonio")
MAPS_RENDERS = MAPS_GOLDENS + ("alphacut",)
MAPS_RES, MAPS_SPP = 256, 16
ENV_RES = (64, 32)
MAPS_KERNELS = b4.KERNELS
MAPS_WAVES = (("bvh4_closest", "camera"), ("bvh4_closest", "continuation"),
              ("bvh4_any_hit", "shadow"), ("bvh4_closest", "shadow"),
              ("bvh4_closest", "alpha"))
# the media group: the goldens of participating media (spotfog), a measured
# BRDF (measured) and the dipole integrator (dipole); spotfog's world under a
# seeded density grid and under an exponential region; their full-size
# renders (one megawave of 1,048,576 camera rays under the scene's own
# integrator); every scene takes the 4-wide kernels (rows 2, 4, 5)
MEDIA_GOLDENS = ("spotfog", "measured", "dipole")
MEDIA_RES, MEDIA_SPP = 256, 16
MEDIA_KERNELS = b4.KERNELS
# the waves with live rays the renders must make (their continuations are
# dead: no specular surface)
MEDIA_WAVES = (("bvh4_closest", "camera"), ("bvh4_closest", "bsdf"),
               ("bvh4_any_hit", "shadow"), ("bvh4_any_hit", "medium"),
               ("bvh4_any_hit", "irradiance"))
# the Metropolis group (phase 25): scenes/mlt.pbrt at its authored
# settings (64x64, 64 mutations a pixel, 4,096 chains, 16 mutations a wave:
# 4 waves, 1 + 4 * 17 = 69 bidirectional evaluations, each 6 camera and 5
# light closest-hit waves and 36 connection any-hit waves of 4,096 rays)
MLT_GOLDEN_RELMAE = 0.05      # tests/test_golden.py's for mlt
MLT_BLOCK_MEDIAN, MLT_BLOCK_Q90 = 0.05, 0.10   # tests/test_render.py:269-300
MLT_WAVES_BY_ROLE = {"mlt_camera": 414, "mlt_light": 345, "mlt_connect": 2484}
MLT_LAUNCHES = {"bvh4_closest": 759, "bvh4_any_hit": 2484}
MLT_LANES = 4096              # u-vectors held card against CPU
MLT_WIDE_RES, MLT_WIDE_CHAINS = 256, 65536   # the width run: 16x the lanes, binned
MLT_KERNELS = b4.KERNELS + bi.KERNELS        # row 1: the crop and adaptive Cornell box
MLT_PARITY = (("bvh4_closest", "mlt_camera"), ("bvh4_closest", "mlt_light"),
              ("bvh4_any_hit", "mlt_connect"))
MLT_CROP = (0.25, 0.75, 0.125, 0.625)
GRID_SEED = 10
BRUTE_SOURCE = "grail_torch/kernels/csrc/brute_intersect.cu"
RAGGED = 37                # rays past 1M in the ragged parity case
NODE_BYTES, TRI_BYTES = 128, 48


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip()


def sass_loop_instructions(name):
    """{function: instructions of its largest loop} of kernel library
    `name`, from cuobjdump -sass (a loop: the span from a backward branch's
    target to the branch, every path and out-of-line block inside it); None
    where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", build.lib_path(name)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loops = {}
    for chunk in out.split("Function : ")[1:]:
        fn = chunk.split(None, 1)[0]
        best = 0
        for addr, target in re.findall(r"/\*([0-9a-f]+)\*/[^;]*?\bBRA\b[^;]*?0x([0-9a-f]+)",
                                       chunk):
            a, t = int(addr, 16), int(target, 16)
            if t <= a:
                best = max(best, (a - t) // 16 + 1)
        loops[fn] = best
    return loops


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() over reps launches (CUDA events, warmed up).
    A sleep kernel queued first keeps the card busy while the host queues
    the launches, so a wrapper's host time per call, which can exceed a
    short kernel's, does not count."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ray_cases(scene, meta, dev):
    """{name: (o, d, tmin, tmax)} at N_RAYS rays: the bench camera wave,
    rays from inside the box (secondary waves), and shadow rays with random
    lengths, some of them dead lanes (tmax = 0)."""
    pix, samp, _ = megawave_lanes(meta, 0, meta.sampler.spp, dev)
    rays = camera_rays(scene, meta, pix, samp)[0]
    check(rays["o"].shape[0] == N_RAYS, "bench megawave is 1M rays")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inside(n):
        lo = torch.tensor([-0.99, 0.01, -0.99], device=dev)
        return lo + torch.rand(n, 3, device=dev, generator=gen) * 1.98

    def dirs(n):
        v = torch.randn(n, 3, device=dev, generator=gen)
        return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)

    zeros = torch.zeros(N_RAYS, device=dev)
    big = torch.full((N_RAYS,), 1.0e7, device=dev)
    shadow_t = torch.rand(N_RAYS, device=dev, generator=gen) * 2.5
    shadow_t[: N_RAYS // 8] = 0.0
    return {
        "camera_wave": (rays["o"].contiguous(), rays["d"].contiguous(), zeros, big),
        "secondary": (inside(N_RAYS), dirs(N_RAYS), zeros, big),
        "shadow": (inside(N_RAYS), dirs(N_RAYS), zeros, shadow_t),
    }


def compare(kern, plain, any_hit=False):
    """Mismatch count of prim, and the max |difference| of t, b1, b2 where
    prim agrees; raises beyond the stated tolerance (and, for any hit, if
    the occlusion masks agree on fewer than OCC_AGREE_MIN of the rays)."""
    t_k, p_k, b1_k, b2_k = kern
    t_p, p_p, b1_p, b2_p = plain[:4]
    same = p_k == p_p
    n_bad = int((~same).sum())
    errs = {}
    for name, a, b in (("t", t_k, t_p), ("b1", b1_k, b1_p), ("b2", b2_k, b2_p)):
        a, b = a[same], b[same]
        errs[name] = float((a - b).abs().max()) if a.numel() else 0.0
        check(bool(torch.all((a - b).abs() <= ATOL + RTOL * b.abs())),
              f"{name} outside rtol {RTOL}, atol {ATOL}")
    bitwise = (n_bad == 0 and all(torch.equal(x, y) for x, y in zip(kern, plain)))
    check(1.0 - n_bad / p_k.numel() >= PRIM_AGREE_MIN,
          f"prim disagrees on {n_bad} of {p_k.numel()} rays")
    if any_hit:
        occ_agree = float(((p_k >= 0) == (p_p >= 0)).float().mean())
        check(occ_agree >= OCC_AGREE_MIN, f"occlusion agrees on {occ_agree:.6f}")
    return n_bad, errs, bitwise


def against_replaced(new, old, args, any_hit, scene):
    """Mismatch counts of a 4-wide kernel against the record-stream kernel it
    replaces, on the same rays; raises beyond the stated thresholds. t, b1
    and b2 must be bitwise equal where prim agrees. Closest hit: prim agrees
    on >= PRIM_AGREE_MIN of the rays. Any hit: occlusion agrees on
    >= OCC_AGREE_MIN, and since the two walks visit in other orders (near
    first here, preorder there) the first occluder found may differ, so
    instead of prim, >= PRIM_AGREE_MIN of the reported triangles must be
    real hits of their rays in (tmin, tmax) by moller_trumbore."""
    same = new[1] == old[1]
    n = new[1].numel()
    n_prim = int((~same).sum())
    n_occ = int(((new[1] >= 0) != (old[1] >= 0)).sum())
    check(all(torch.equal(a[same], b[same]) for a, b in zip(new, old)),
          "t, b1, b2 differ from the replaced kernel where prim agrees")
    out = {"prim_mismatch": n_prim, "occlusion_mismatch": n_occ}
    if not any_hit:
        check(1.0 - n_prim / n >= PRIM_AGREE_MIN,
              f"prim disagrees with the replaced kernel on {n_prim} of {n} rays")
        return out
    check(1.0 - n_occ / n >= OCC_AGREE_MIN,
          f"occlusion disagrees with the replaced kernel on {n_occ} of {n} rays")
    hit = new[1] >= 0
    o, d, tmin, tmax = (a[hit] for a in args)
    idx = scene["tri_idx"][new[1][hit].long()].long()
    v = scene["verts"]
    v0 = v[idx[:, 0]]
    real = moller_trumbore(o, d, v0, v[idx[:, 1]] - v0, v[idx[:, 2]] - v0, tmin, tmax)[0]
    out["reported_not_real_hit"] = int((~real).sum())
    check(float(real.float().mean()) >= PRIM_AGREE_MIN,
          f"{out['reported_not_real_hit']} reported occluders are not hits")
    return out


def cornell_phases(dev, gpu, issue_rate, sass):
    """Phases 3-5; returns the entries of the kernels line of the brute-force
    kernel's two instances (closest hit, any hit)."""
    t0 = time.perf_counter()
    scene, meta, _ = cornell_box(256, 256, 16, device=dev)
    tris9 = pack_tris(scene)
    cases = ray_cases(scene, meta, dev)
    max_err = dict.fromkeys(bi.KERNELS, 0.0)
    with torch.no_grad():
        for case, args in cases.items():
            ragged = tuple(torch.cat([a, a[:RAGGED]]).contiguous() for a in args)
            for rays in (args, ragged):
                for any_hit in (False, True):
                    name = bi.KERNELS[int(any_hit)]
                    kern = bi.brute_intersect(tris9, *rays, any_hit=any_hit)
                    plain = bi.brute_intersect_plain(tris9, *rays, any_hit=any_hit)
                    torch.cuda.synchronize()
                    n_bad, errs, bitwise = compare(kern, plain)
                    max_err[name] = max([max_err[name]] + list(errs.values()))
                    emit({"phase": "parity", "scene": "cornell", "kernel": name,
                          "case": case, "rays": rays[0].shape[0],
                          "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
                          "max_abs_diff": errs, "bitwise_equal": bitwise})
                    check(bitwise, f"{name} is not bitwise equal to its plain version "
                                   f"({case}, {rays[0].shape[0]} rays)")
    del kern, plain
    emit({"phase": "parity", "scene": "cornell", "seconds": time.perf_counter() - t0})

    # the main path on the card against the same render on the CPU
    # (the entry() configuration: 64x64, 4 spp, max depth 3)
    t0 = time.perf_counter()
    cfg_e = IntegratorConfig(kind="path", max_depth=3)
    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sc, mt, _ = cornell_box(64, 64, 4, device=where)
        imgs[side] = render(sc, mt, cfg_e, spp=4, device=where)[0].cpu().numpy()
    err = relative_mae(imgs["card"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "scene": "cornell", "res": 64, "spp": 4,
          "max_depth": 3, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(np.isfinite(imgs["card"]).all() and err < RELMAE_MAX,
          f"GPU render differs from the CPU render (relative MAE {err})")

    # the bench render through the kernel: one warm-up, three timed
    t0 = time.perf_counter()
    cfg = IntegratorConfig(kind="path", max_depth=5)
    spp = meta.sampler.spp
    times, launches, _, img, peak, _ = bench_render(scene, meta, cfg, spp, dev)
    # one closest hit and one shadow ray a bounce, no other kernel
    expected = dict(dict.fromkeys(launches[0], 0),
                    **dict.fromkeys(bi.KERNELS, cfg.max_depth + 1))
    emit({"phase": "bench", "scene": "cornell", "res": 256, "spp": spp,
          "max_depth": cfg.max_depth, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
          "launches_per_render": launches,
          "expected_launches": expected, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()), "peak_memory_bytes": peak,
          "seconds": time.perf_counter() - t0})
    check(all(n == expected for n in launches),
          f"brute_intersect launched {launches} per render, want {expected}")
    check(np.isfinite(img).all() and img.shape == (256, 256, 3) and img.mean() > 0.0,
          "bench image is not finite and positive")

    # each instance's time, its plain version's and its bound at the main
    # path's shapes: closest hit on the camera wave, any hit on the shadow
    # rays. Pairs counted as this run's rays need them: a live ray tests
    # every triangle, an any-hit ray up to its first hit; each pair's
    # operations by the stages of the hit test it reaches (OPS_STAGES).
    # Beside it, the bound with every stage counted for every pair (55),
    # and those pairs times the kernel's static instructions a pair (its
    # triangle loop over the rays a thread, every path) over the card's FP32
    # issue rate: its issue time were every pair to take every path; a warp
    # issues only the paths one of its lanes takes.
    n_tris = tris9.shape[0]
    per_thread = int(re.search(r"kRays = (\d+);",
                               open(BRUTE_SOURCE).read()).group(1))
    entries = []
    for any_hit, case in ((False, "camera_wave"), (True, "shadow")):
        name = bi.KERNELS[int(any_hit)]
        o, d, tmin, tmax = cases[case]
        n = o.shape[0]
        with torch.no_grad():
            ms = cuda_ms(lambda: bi.brute_intersect(tris9, o, d, tmin, tmax, any_hit), 50)
            plain_ms = cuda_ms(lambda: bi.brute_intersect_plain(tris9, o, d, tmin, tmax,
                                                                any_hit), 5)
            stages = [int(c.sum()) for c in bi.brute_intersect_plain(
                tris9, o, d, tmin, tmax, any_hit, counts=True)[4:]]
        pairs = stages[0]
        bytes_moved = n * RAY_BYTES + n_tris * 36
        ops = sum(k * c for k, c in zip(OPS_STAGES, stages))
        t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
        bound_every_pair = max(t_bytes, OPS_PER_PAIR * pairs / PEAK_FP32_OPS * 1e3)
        loop = None if sass is None else next(
            (v for k, v in sass.items() if f"ILb{int(any_hit)}E" in k), None)
        per_pair = None if loop is None else loop / per_thread
        every_path = None if per_pair is None else pairs * per_pair / issue_rate * 1e3
        emit({"phase": "kernel_time", "kernel": name, "case": case, "rays": n,
              "live_rays": int((tmax > tmin).sum()), "triangles": n_tris,
              "pairs": pairs, "pairs_past_b1": stages[1], "pairs_past_b2": stages[2],
              "ms": ms, "plain_ms": plain_ms, "bytes": bytes_moved, "operations": ops,
              "bytes_ms": t_bytes, "operations_ms": t_ops,
              "bound_ms": max(t_bytes, t_ops), "bound_ms_every_pair": bound_every_pair,
              "sass_loop_instructions": loop, "rays_per_thread": per_thread,
              "static_instructions_per_pair": per_pair,
              "issue_rate_lane_instructions_per_s": issue_rate,
              "issue_ms_every_path": every_path, "gpu": gpu})
        entries.append({"name": name, "case": case, "route": "cuda",
                        "source": BRUTE_SOURCE,
                        "replaces": "grail/kernels/pallas_intersect.py:31",
                        "launches": launches[0][name], "max_abs_err": max_err[name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes > t_ops else "operations",
                        "bound_ms_every_pair": bound_every_pair, "library_ms": None})
    return entries



def mesh_ray_cases(scene, meta, dev):
    """{wave: (o, d, tmin, tmax)} at N_RAYS rays, each made as the intersect
    dispatch hands rays to the traversal: "camera_wave", the camera rays of
    N_RAYS // pixels samples a pixel in tile order (unbinned);
    "sorted_secondary", rays from the camera wave's hit points (found by the
    4-wide walk) in random directions toward the camera's side, binned and
    sorted with their dead lanes (the misses) inert and last; "shadow", rays
    from the hit points with random lengths and 1/8 dead lanes."""
    pix, samp, _ = megawave_lanes(meta, 0, N_RAYS // (meta.xres * meta.yres), dev)
    rays = camera_rays(scene, meta, pix, samp)[0]
    o, d = rays["o"].contiguous(), rays["d"].contiguous()
    check(o.shape[0] == N_RAYS, "the camera wave is 1M rays")
    zeros = torch.zeros(N_RAYS, device=dev)
    big = torch.full((N_RAYS,), 1.0e7, device=dev)
    bvh = scene["bvh"]
    t, prim, _, _ = b4.bvh4_traverse(bvh["bvh4_nodes"], bvh["bvh4_tris"], o, d, zeros,
                                     big, stack=bvh["bvh4_stack"])
    hit = prim >= 0
    p = o + (t * (1.0 - 1e-4))[:, None] * d
    p = torch.where(hit[:, None], p, o)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(N_RAYS, 3, device=dev, generator=gen)
    w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
    w = torch.where(((w * d).sum(1) > 0)[:, None], -w, w)
    dead = ~hit
    tmin2 = torch.where(dead, BIG_T, 0.0)
    tmax2 = torch.where(dead, -BIG_T, 1.0e7)
    vmin, vmax = scene["verts"].amin(0), scene["verts"].amax(0)
    key = torch.where(dead, N_RAY_BUCKETS, bin_rays_key(p, w, vmin, vmax))
    secondary = sort_by_rank(bucket_rank(key, N_RAY_BUCKETS + 1), p, w, tmin2, tmax2)
    shadow_t = torch.rand(N_RAYS, device=dev, generator=gen) * 3.0
    dead = torch.zeros(N_RAYS, dtype=torch.bool, device=dev)
    dead[: N_RAYS // 8] = True
    shadow = (p.contiguous(), w.flip(0).contiguous(), torch.where(dead, BIG_T, 0.0),
              torch.where(dead, -BIG_T, shadow_t))
    return {"camera_wave": (o, d, zeros, big), "sorted_secondary": secondary,
            "shadow": shadow}


def _kind(name):
    return name.split("_", 1)[0], name.endswith("any_hit")


def bvh4_parity(scene_name, name, wave, args, bvh):
    """One 4-wide kernel against its plain version on the card, bitwise; emits
    the parity line and returns the plain walk's outputs and counts."""
    any_hit = name == "bvh4_any_hit"
    nodes, tris4, stack = (bvh[k] for k in ("bvh4_nodes", "bvh4_tris", "bvh4_stack"))
    with torch.no_grad():
        kern = b4.bvh4_traverse(nodes, tris4, *args, any_hit=any_hit, stack=stack)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain = b4.bvh4_traverse_plain(nodes, tris4, *args, any_hit=any_hit, stack=stack)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
    n_bad, errs, bitwise = compare(kern, plain, any_hit)
    counts = tuple(int(x.sum()) for x in plain[4:])
    # items (node fetches + triangle tests) per ray, over warps of 32
    # consecutive rays: the share of lanes busy while the warp walks
    items = (plain[4] + plain[6]).view(-1, 32).double()
    line = {"phase": "parity", "scene": scene_name, "kernel": name, "case": wave,
            "rays": args[0].shape[0], "live_rays": int((args[3] > args[2]).sum()),
            "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
            "occlusion_mismatch": int(((kern[1] >= 0) != (plain[1] >= 0)).sum()),
            "max_abs_diff": errs, "bitwise_equal": bitwise, "node_fetches": counts[0],
            "box_tests": counts[1], "tri_tests": counts[2],
            "max_node_fetches_per_ray": int(plain[4].max()),
            "warp_lane_use": float(items.mean(1).sum() / items.amax(1).sum()),
            "plain_seconds": plain_s}
    check(bitwise, f"{name} is not bitwise equal to its plain version "
                   f"({scene_name}, {wave})")
    return kern, line, {"errs": errs, "counts": counts, "live": line["live_rays"]}


def bvh4_bound(counts, table4_bytes):
    """(bound ms, by) of a 4-wide walk: the ray bytes and the tables once, 26
    operations a slab test and 55 a triangle test."""
    _, n_test, n_tri = counts
    t_bytes = (N_RAYS * RAY_BYTES + table4_bytes) / PEAK_BYTES * 1e3
    t_ops = (OPS_PER_BOX * n_test + OPS_PER_PAIR * n_tri) / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def bench_render(scene, meta, cfg, spp, dev):
    """One warm-up and three timed bench renders; returns (seconds, launches
    and closest-hit waves per render, image, peak and held bytes)."""
    render(scene, meta, cfg, spp=spp, device=dev)
    torch.cuda.synchronize()
    times, launches, waves = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    for _ in range(3):
        for counts in (bs.LAUNCHES, b4.LAUNCHES, bi.LAUNCHES, CLOSEST_WAVES):
            counts.update(dict.fromkeys(counts, 0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches.append(dict(bs.LAUNCHES, **b4.LAUNCHES, **bi.LAUNCHES))
        waves.append(dict(CLOSEST_WAVES))
    return (times, launches, waves, img.cpu().numpy(),
            torch.cuda.max_memory_allocated(dev), held)


def mesh_phases(dev, gpu):
    """Phases 6-9; returns the entries of the kernels line: the four
    bvh_stream kernels, and the two bvh4 kernels on each main-path wave."""
    t0 = time.perf_counter()
    scene, meta, _ = mesh_scene(256, 256, 16, grid=MESH_GRID, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bvh = scene["bvh"]
    nodes, tris4, stack = (bvh[k] for k in ("bvh4_nodes", "bvh4_tris", "bvh4_stack"))
    # the record table, which only the record-stream kernels (the baselines)
    # read, built on request (the binary tree again, the records packed and
    # uploaded) and dropped before the main path runs
    t1 = time.perf_counter()
    attach_record_table(scene)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t1
    table, depth = bvh.pop("stream"), bvh.pop("depth")
    table4_bytes = (nodes.numel() + tris4.numel()) * 4
    emit({"phase": "mesh_scene", "scene": "mesh100k", "grid": MESH_GRID,
          "triangles": meta.n_tris, "records": table.shape[0] * bs.RECS_PER_ROW,
          "record_table_bytes": table.numel() * 4,
          "record_table_host_seconds": record_s, "tree_depth": depth,
          "bvh4_nodes": nodes.shape[0], "bvh4_table_bytes": table4_bytes,
          "bvh4_stack_bound": stack, "host_build_seconds": build_s})

    t0 = time.perf_counter()
    with torch.no_grad():
        cases = mesh_ray_cases(scene, meta, dev)
    results = {}
    for name in bs.KERNELS:
        kind, any_hit = _kind(name)
        case = STREAM_CASES[name]
        args = cases[case]
        with torch.no_grad():
            kern = bs.stream_traverse(table, *args, any_hit=any_hit, kind=kind,
                                      depth=depth)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plain = bs.stream_traverse_plain(table, *args, any_hit=any_hit, kind=kind)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        n_bad, errs, bitwise = compare(kern, plain, any_hit)
        live = int((args[3] > args[2]).sum())
        visits = (int(plain[4].sum()), int(plain[5].sum()))
        results[name] = {"case": case, "args": args, "errs": errs, "live": live,
                         "visits": visits, "plain_s": plain_s, "kern": kern}
        emit({"phase": "parity", "scene": "mesh100k", "kernel": f"bvh_stream_{name}",
              "case": case, "rays": N_RAYS, "live_rays": live,
              "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
              "occlusion_mismatch": int(((kern[1] >= 0) != (plain[1] >= 0)).sum()),
              "max_abs_diff": errs, "bitwise_equal": bitwise,
              "box_visits": visits[0], "tri_visits": visits[1],
              "max_visits_per_ray": int((plain[4] + plain[5]).max()),
              "plain_seconds": plain_s})
    # the 4-wide kernels on the rays of the kernels they replace
    results4 = {}
    for name, old, _ in BVH4_REPLACES + (BVH4_ROW3,):
        r = results[old]
        kern, line, results4[old] = bvh4_parity("mesh100k", name, r["case"], r["args"],
                                                bvh)
        with torch.no_grad():
            line[f"vs_bvh_stream_{old}"] = against_replaced(
                kern, r["kern"], r["args"], name == "bvh4_any_hit", scene)
        emit(line)
    # keep only the rays and counts: the outputs would count in the bench
    # render's peak memory
    del kern, plain
    for r in results.values():
        del r["kern"]
    emit({"phase": "parity", "scene": "mesh100k", "seconds": time.perf_counter() - t0})

    # each kernel's time, its plain version's and its bound at 1M rays
    t0 = time.perf_counter()
    timed = {}
    for name in bs.KERNELS:
        kind, any_hit = _kind(name)
        r = results[name]
        args = r["args"]
        with torch.no_grad():
            ms = cuda_ms(lambda: bs.stream_traverse(table, *args, any_hit=any_hit,
                                                    kind=kind, depth=depth), 20)
            plain_ms = cuda_ms(lambda: bs.stream_traverse_plain(
                table, *args, any_hit=any_hit, kind=kind), 1, warmup=0)
        n_box, n_tri = r["visits"]
        ops = OPS_PER_BOX * n_box + OPS_PER_PAIR * n_tri
        bytes_moved = N_RAYS * RAY_BYTES + table.numel() * 4
        t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
        emit({"phase": "kernel_time", "kernel": f"bvh_stream_{name}", "case": r["case"],
              "rays": N_RAYS, "live_rays": r["live"], "ms": ms, "plain_ms": plain_ms,
              "box_visits": n_box, "tri_visits": n_tri,
              "record_bytes_read": (n_box + n_tri) * bs.FIELDS * 4,
              "bytes": bytes_moved, "operations": ops, "bytes_ms": t_bytes,
              "operations_ms": t_ops, "gpu": gpu})
        timed[name] = {
            "name": f"bvh_stream_{name}", "case": r["case"], "route": "cuda",
            "source": STREAM_SOURCE, "replaces": STREAM_REPLACES[kind],
            "max_abs_err": max(r["errs"].values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}
    # each 4-wide kernel in turns with the kernel it replaces (old, new,
    # new, old) on each wave, row 3's ordered any hit too; its bound counts
    # its own walk on these rays (bvh4_bound). The bound of the replaced
    # kernel's walk on these rays (the record table, the records it visits)
    # is printed beside it as bound_ms_record_walk.
    for name, old, wave in BVH4_REPLACES + (BVH4_ROW3,):
        any_hit = name == "bvh4_any_hit"
        r = results[old]
        args = r["args"]
        old_kind = _kind(old)[0]
        runs = {"old": lambda: bs.stream_traverse(table, *args, any_hit=any_hit,
                                                  kind=old_kind, depth=depth),
                "new": lambda: b4.bvh4_traverse(nodes, tris4, *args, any_hit=any_hit,
                                                stack=stack)}
        turns = {k: [] for k in runs}
        with torch.no_grad():
            for who in ("old", "new", "new", "old"):
                turns[who].append(cuda_ms(runs[who], 20))
            plain_ms = cuda_ms(lambda: b4.bvh4_traverse_plain(
                nodes, tris4, *args, any_hit=any_hit, stack=stack), 1, warmup=0)
        ms = statistics.mean(turns["new"])
        counts = results4[old]["counts"]
        bound, by = bvh4_bound(counts, table4_bytes)
        n_box, n_tri = r["visits"]
        rec_bound = max((N_RAYS * RAY_BYTES + table.numel() * 4) / PEAK_BYTES,
                        (OPS_PER_BOX * n_box + OPS_PER_PAIR * n_tri) / PEAK_FP32_OPS) * 1e3
        emit({"phase": "kernel_time", "scene": "mesh100k", "kernel": name,
              "case": r["case"], "rays": N_RAYS, "live_rays": r["live"], "ms": ms,
              "ms_turns": turns, "plain_ms": plain_ms,
              "fill_blocks": b4.fill_blocks(dev.index, any_hit, stack),
              "node_fetches": counts[0], "box_tests": counts[1], "tri_tests": counts[2],
              "bytes_read": counts[0] * NODE_BYTES + counts[2] * TRI_BYTES,
              "bound_ms": bound, "bound_by": by, "replaced": f"bvh_stream_{old}",
              "replaced_ms": statistics.mean(turns["old"]),
              "replaced_box_visits": n_box, "replaced_tri_visits": n_tri,
              "bound_ms_record_walk": rec_bound, "gpu": gpu})
        timed[(name, old)] = {
            "name": name, "case": r["case"], "route": "cuda", "source": BVH4_SOURCE,
            "replaces": STREAM_REPLACES[old_kind],
            "max_abs_err": max(results4[old]["errs"].values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "bound_ms_record_walk": rec_bound, "library_ms": None}
    emit({"phase": "kernel_time", "scene": "mesh100k", "seconds": time.perf_counter() - t0})
    del cases, results, table

    # the main path on the card against the same render on the CPU, at
    # 16,384 lanes: above the dispatch's binning threshold (SORT_MIN) at
    # every bounce, also after the pre-RR split halves the wave, so the
    # comparison bins every wave after the camera wave as the bench render
    # does
    t0 = time.perf_counter()
    cfg_e = IntegratorConfig(kind="path", max_depth=3)
    res_e, spp_e = 64, 4
    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sc, mt, _ = mesh_scene(res_e, res_e, spp_e, grid=MESH_GRID, device=where)
        for counts in (bs.LAUNCHES, b4.LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))
        imgs[side] = render(sc, mt, cfg_e, spp=spp_e,
                                  device=where)[0].cpu().numpy()
        if side == "card":
            gpu_launches = dict(bs.LAUNCHES, **b4.LAUNCHES)
    err = relative_mae(imgs["card"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "scene": "mesh100k", "res": res_e,
          "spp": spp_e, "max_depth": 3, "lanes": res_e * res_e * spp_e,
          "sort_min": SORT_MIN, "gpu_launches": gpu_launches, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(res_e * res_e * spp_e // 2 >= SORT_MIN, "comparison wave below SORT_MIN")
    check(gpu_launches == {"skip_closest": 0, "skip_any_hit": 0, "ordered_closest": 0,
                           "ordered_any_hit": 0, "bvh4_closest": cfg_e.max_depth + 1,
                           "bvh4_any_hit": cfg_e.max_depth + 1,
                           "bvh4_closest_roots": 0, "bvh4_any_hit_roots": 0},
          f"GPU mesh render took {gpu_launches}, not the 4-wide route")
    check(np.isfinite(imgs["card"]).all() and err < RELMAE_MAX,
          f"GPU mesh render differs from the CPU render (relative MAE {err})")

    # the bench render through the kernels: one warm-up, three timed
    t0 = time.perf_counter()
    cfg = IntegratorConfig(kind="path", max_depth=5)
    spp = meta.sampler.spp
    times, launches, waves, img, peak, held = bench_render(scene, meta, cfg, spp, dev)
    emit({"phase": "bench", "scene": "mesh100k", "res": 256, "spp": spp,
          "max_depth": cfg.max_depth, "grid": MESH_GRID, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
          "launches_per_render": launches, "expected_launches": MESH_EXPECTED,
          "bvh4_closest_by_wave": waves, "expected_by_wave": MESH_EXPECTED_WAVES,
          "host_build_seconds": build_s, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()), "peak_memory_bytes": peak,
          "held_before_render_bytes": held, "seconds": time.perf_counter() - t0})
    check(all(n == MESH_EXPECTED for n in launches),
          f"traversal kernels launched {launches} per render, want {MESH_EXPECTED}")
    check(all(w == MESH_EXPECTED_WAVES for w in waves),
          f"bvh4_closest took waves {waves} per render, want {MESH_EXPECTED_WAVES}")
    check(np.isfinite(img).all() and img.shape == (256, 256, 3) and img.mean() > 0.0,
          "bench image is not finite and positive")

    entries = [dict(timed[name], launches=launches[0][name]) for name in bs.KERNELS]
    for name, old, wave in BVH4_REPLACES:
        entries.append(dict(timed[(name, old)],
                            launches=waves[0][wave] if wave else launches[0][name]))
    return entries


def mesh1m_phases(dev, gpu):
    """Phases 10-14 (mesh1m: the 1M-triangle terrain seen through a thin lens
    by a moving camera, bench.py's third scene). Its kernels are the 4-wide
    ones of mesh100k: their entries in the kernels line stay mesh100k's."""
    t0 = time.perf_counter()
    scene, meta, _ = mesh_scene_1m(256, 256, MESH1M_SPP, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bvh = scene["bvh"]
    nodes, tris4, stack = (bvh[k] for k in ("bvh4_nodes", "bvh4_tris", "bvh4_stack"))
    table4_bytes = (nodes.numel() + tris4.numel()) * 4
    # what the record table would cost here, on request, then dropped
    t1 = time.perf_counter()
    attach_record_table(scene)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t1
    record_bytes = bvh.pop("stream").numel() * 4
    del bvh["depth"]
    cam = scene["camera"]
    emit({"phase": "mesh_scene", "scene": "mesh1m", "grid": 708,
          "triangles": meta.n_tris, "bvh4_nodes": nodes.shape[0],
          "bvh4_node_bytes": nodes.numel() * 4, "bvh4_tri_bytes": tris4.numel() * 4,
          "bvh4_table_bytes": table4_bytes, "bvh4_stack_bound": stack,
          "host_build_seconds": build_s, "record_table_bytes": record_bytes,
          "record_table_host_seconds": record_s,
          "lens_radius": float(cam["lens_radius"]),
          "focal_distance": float(cam["focal_distance"]),
          "camera_moves": bool(cam["c2w"]["animated"])})
    check(meta.n_tris == 1_001_906 and stack <= b4.STACK_MAX
          and float(cam["lens_radius"]) > 0 and bool(cam["c2w"]["animated"]),
          "mesh1m is not the 1M-triangle DOF and motion-blur scene")

    # parity: each 4-wide kernel on each mesh1m wave it takes
    t0 = time.perf_counter()
    with torch.no_grad():
        cases = mesh_ray_cases(scene, meta, dev)
    results = {}
    for name, wave in MESH1M_WAVES:
        _, line, results[(name, wave)] = bvh4_parity("mesh1m", name, wave, cases[wave], bvh)
        emit(line)
    emit({"phase": "parity", "scene": "mesh1m", "seconds": time.perf_counter() - t0})

    # each 4-wide kernel's time on each wave, its plain version's, its bound
    t0 = time.perf_counter()
    for name, wave in MESH1M_WAVES:
        any_hit = name == "bvh4_any_hit"
        args = cases[wave]
        with torch.no_grad():
            ms = cuda_ms(lambda: b4.bvh4_traverse(nodes, tris4, *args, any_hit=any_hit,
                                                  stack=stack), 20)
            plain_ms = cuda_ms(lambda: b4.bvh4_traverse_plain(
                nodes, tris4, *args, any_hit=any_hit, stack=stack), 1, warmup=0)
        counts = results[(name, wave)]["counts"]
        bound, by = bvh4_bound(counts, table4_bytes)
        emit({"phase": "kernel_time", "scene": "mesh1m", "kernel": name, "case": wave,
              "rays": N_RAYS, "live_rays": results[(name, wave)]["live"], "ms": ms,
              "plain_ms": plain_ms, "node_fetches": counts[0], "box_tests": counts[1],
              "tri_tests": counts[2],
              "bytes_read": counts[0] * NODE_BYTES + counts[2] * TRI_BYTES,
              "table_bytes": table4_bytes, "bound_ms": bound, "bound_by": by,
              "percent_of_bound": 100.0 * bound / ms, "gpu": gpu})
    emit({"phase": "kernel_time", "scene": "mesh1m", "seconds": time.perf_counter() - t0})
    del cases

    # the main path on the card against the CPU, the full geometry at 32x32
    t0 = time.perf_counter()
    cfg_e = IntegratorConfig(kind="path", max_depth=3)
    res_e, spp_e = 32, 2
    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sc, mt, _ = mesh_scene_1m(res_e, res_e, spp_e, device=where)
        b4.LAUNCHES.update(dict.fromkeys(b4.LAUNCHES, 0))
        imgs[side] = render(sc, mt, cfg_e, spp=spp_e,
                                  device=where)[0].cpu().numpy()
        if side == "card":
            gpu_launches = dict(b4.LAUNCHES)
        del sc
    err = relative_mae(imgs["card"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "scene": "mesh1m", "res": res_e, "spp": spp_e,
          "max_depth": 3, "gpu_launches": gpu_launches, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(gpu_launches == dict(dict.fromkeys(b4.ROOT_KERNELS, 0),
                               **dict.fromkeys(b4.KERNELS, cfg_e.max_depth + 1)),
          f"GPU mesh1m render took {gpu_launches}, not the 4-wide route")
    check(np.isfinite(imgs["card"]).all() and err < RELMAE_MAX,
          f"GPU mesh1m render differs from the CPU render (relative MAE {err})")

    # bench.py's mesh1m render: 256x256, 4 spp (one megawave), depth 5
    t0 = time.perf_counter()
    cfg = IntegratorConfig(kind="path", max_depth=5)
    times, launches, waves, img, peak, held = bench_render(scene, meta, cfg,
                                                           MESH1M_SPP, dev)
    emit({"phase": "bench", "scene": "mesh1m", "res": 256, "spp": MESH1M_SPP,
          "max_depth": cfg.max_depth, "grid": 708, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * MESH1M_SPP
          / statistics.median(times),
          "launches_per_render": launches, "expected_launches": MESH_EXPECTED,
          "bvh4_closest_by_wave": waves, "expected_by_wave": MESH_EXPECTED_WAVES,
          "host_build_seconds": build_s, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()), "peak_memory_bytes": peak,
          "held_before_render_bytes": held, "seconds": time.perf_counter() - t0})
    check(all(n == MESH_EXPECTED for n in launches),
          f"traversal kernels launched {launches} per mesh1m render, want {MESH_EXPECTED}")
    check(all(w == MESH_EXPECTED_WAVES for w in waves),
          f"bvh4_closest took waves {waves} per mesh1m render")
    check(np.isfinite(img).all() and img.shape == (256, 256, 3) and img.mean() > 0.0,
          "mesh1m bench image is not finite and positive")


def small_instanced(animated, device):
    """A floor under a point light with one instance of a sphere moving
    from x = -0.8 to 0.8 across the shutter (or standing at -0.8), and a
    mirrored instance (negative scale: its handedness swaps), at 48x48 (the
    shape of tests/test_instances.py's motion-blur scene)."""
    b = SceneBuilder()
    b.xres = b.yres = 48
    b.matte(kd=(0.6, 0.6, 0.6))
    b.add_mesh(np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]], np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int64), 0)
    b.add_point_light((0.0, 4.0, 0.0), (30.0, 30.0, 30.0))
    c2w = tr.look_at((0, 1.5, 4.0), (0, 0.5, 0), (0, 1, 0))
    b.camera = camera.build_camera(camera.PERSPECTIVE, c2w, c2w, 48, 48, fov=50.0)
    v, i, n, uv = sphere(radius=0.4, nu=24, nv=12)
    oid = b.add_object()
    b.add_object_mesh(oid, v, i, 0, normals=n, uvs=uv)
    b.add_instance(oid, tr.translate((-0.8, 0.5, 0.0)),
                   tr.translate((0.8 if animated else -0.8, 0.5, 0.0)))
    b.add_instance(oid, tr.translate((0.4, 1.2, -0.8)) @ tr.scale(-1.0, 1.0, 1.0))
    return b.finalize(device)


def first_round(inst, o, d, tmin, tmax, time, any_hit):
    """The BLAS walk's rays of a sweep's first round (instanced.py): each
    ray's nearest candidate instance, its ray in object space and its root.
    Returns ((o, d, tmin, tmax), roots, rays with a candidate)."""
    n = o.shape[0]
    last_near = torch.full((n,), -BIG_T, device=o.device)
    last_id = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device) if any_hit else None
    sel, _, act = instanced.next_candidates(inst, o, d, tmin, tmax, last_near, last_id,
                                            occ)
    o_obj, d_obj, sub_tmax, roots = instanced.object_rays(inst, sel, act, o, d, time,
                                                          tmax)
    return (o_obj, d_obj, tmin, sub_tmax), roots, int(act.sum())


def inst_ray_cases(scene, meta, dev):
    """{wave: (rays, roots, live)} at N_RAYS object-space rays: the first
    sweep round of instbench's camera wave (16 samples a pixel, tile order,
    each ray at its shutter time, t cut at the floor's hit as the dispatch
    does) and of shadow rays from its hits toward the point light."""
    pix, samp, _ = megawave_lanes(meta, 0, N_RAYS // (meta.xres * meta.yres), dev)
    rays = camera_rays(scene, meta, pix, samp)[0]
    o, d, time = rays["o"].contiguous(), rays["d"].contiguous(), rays["time"]
    check(o.shape[0] == N_RAYS, "the camera wave is 1M rays")
    zeros = torch.zeros(N_RAYS, device=dev)
    bvh, inst = scene["bvh"], scene["inst"]
    t_base = b4.bvh4_traverse(bvh["bvh4_nodes"], bvh["bvh4_tris"], o, d, zeros,
                              torch.full((N_RAYS,), 1.0e7, device=dev),
                              stack=bvh["bvh4_stack"])[0]
    camera_case = first_round(inst, o, d, zeros, t_base, time, False)
    hit = isect.intersect(scene, o, d, torch.full((N_RAYS,), 1.0e7, device=dev),
                          device=dev, sort=False, time=time)
    p = o + (torch.clamp_max(hit["t"], 1.0e7) * (1.0 - 1e-4))[:, None] * d
    to_light = scene["lights"]["l2w"][0, :3, 3] - p
    dist = torch.linalg.vector_norm(to_light, dim=1)
    w = (to_light / dist[:, None]).contiguous()
    tmax = torch.where(hit["prim"] >= 0, dist * (1.0 - 1e-3), 0.0)
    shadow_case = first_round(inst, p.contiguous(), w, zeros, tmax, time, True)
    return {"camera_wave": camera_case, "shadow": shadow_case}


def inst_phases(dev, gpu):
    """Phases 15-19 (instbench's instanced scene); returns the entries of the
    kernels line of the 4-wide walk with per-ray roots (row 6)."""
    # 15. set-up: both scenes built by the port's builder
    built = {}
    for name, make in (("instanced", build_instanced), ("flattened", build_flattened)):
        t0 = time.perf_counter()
        scene, meta = make(256, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        tables = scene["inst"] if name == "instanced" else scene["bvh"]
        line = {"phase": "inst_scene", "scene": name, "host_build_seconds": build_s,
                "triangles": (int(scene["tri_idx"].shape[0]) - meta.n_tris
                              if name == "instanced" else meta.n_tris),
                "bvh4_nodes": tables["bvh4_nodes"].shape[0],
                "bvh4_node_bytes": tables["bvh4_nodes"].numel() * 4,
                "bvh4_tri_bytes": tables["bvh4_tris"].numel() * 4,
                "bvh4_stack_bound": tables["bvh4_stack"]}
        if name == "instanced":
            line.update(instances=int(scene["inst"]["root"].shape[0]),
                        objects=len(set(scene["inst"]["obj"].tolist())),
                        base_triangles=meta.n_tris)
        emit(line)
        built[name] = (scene, meta)
    scene, meta = built["instanced"]
    inst = scene["inst"]
    nodes, tris4, stack = (inst[k] for k in ("bvh4_nodes", "bvh4_tris", "bvh4_stack"))
    table4_bytes = (nodes.numel() + tris4.numel()) * 4
    check(inst["root"].shape[0] == N_INST and stack <= b4.STACK_MAX
          and tris4.shape[0] == 2 * SPHERE_NU * SPHERE_NV,
          "instbench's scene is not 100 instances of the 50,176-triangle sphere")

    # 16. parity: the walk with roots against its plain version, bitwise
    t0 = time.perf_counter()
    with torch.no_grad():
        cases = inst_ray_cases(scene, meta, dev)
    results = {}
    for name, wave in INST_WAVES:
        any_hit = name == "bvh4_any_hit_roots"
        args, roots, live = cases[wave]
        for n in (N_RAYS, N_RAYS + RAGGED):
            a = tuple(torch.cat([x, x[:n - N_RAYS]]).contiguous() for x in args)
            r = torch.cat([roots, roots[:n - N_RAYS]]).contiguous()
            with torch.no_grad():
                kern = b4.bvh4_traverse(nodes, tris4, *a, any_hit=any_hit, stack=stack,
                                        roots=r)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                plain = b4.bvh4_traverse_plain(nodes, tris4, *a, any_hit=any_hit,
                                               stack=stack, roots=r)
                torch.cuda.synchronize()
                plain_s = time.perf_counter() - t1
            n_bad, errs, bitwise = compare(kern, plain, any_hit)
            counts = tuple(int(x.sum()) for x in plain[4:])
            emit({"phase": "parity", "scene": "instbench", "kernel": name, "case": wave,
                  "rays": n, "live_rays": live, "hits": int((kern[1] >= 0).sum()),
                  "prim_mismatch": n_bad, "max_abs_diff": errs, "bitwise_equal": bitwise,
                  "node_fetches": counts[0], "box_tests": counts[1],
                  "tri_tests": counts[2], "plain_seconds": plain_s})
            check(bitwise, f"{name} is not bitwise equal to its plain version "
                           f"({wave}, {n} rays)")
            if n == N_RAYS:
                results[name] = {"errs": errs, "counts": counts, "live": live}
    del kern, plain
    emit({"phase": "parity", "scene": "instbench", "seconds": time.perf_counter() - t0})

    # 17. the main path on the card against the CPU: instbench's scene at
    # 32x32, then the small scene with a moving and a mirrored instance,
    # which must smear the moving sphere across the shutter on both devices
    t0 = time.perf_counter()
    cfg_e = IntegratorConfig(kind="path", max_depth=3)
    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sc, mt = build_instanced(32, where)
        b4.LAUNCHES.update(dict.fromkeys(b4.LAUNCHES, 0))
        imgs[side] = render(sc, mt, cfg_e, spp=2, device=where)[0].cpu().numpy()
        if side == "card":
            gpu_launches = dict(b4.LAUNCHES)
        del sc
    err = relative_mae(imgs["card"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "scene": "instbench", "res": 32, "spp": 2,
          "max_depth": 3, "gpu_launches": gpu_launches, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(all(gpu_launches[k] > 0 for k in b4.ROOT_KERNELS)
          and all(gpu_launches[k] == cfg_e.max_depth + 1 for k in b4.KERNELS),
          f"GPU instanced render took {gpu_launches}")
    check(np.isfinite(imgs["card"]).all() and err < RELMAE_MAX,
          f"GPU instanced render differs from the CPU render (relative MAE {err})")
    t0 = time.perf_counter()
    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        for animated in (False, True):
            sc, mt = small_instanced(animated, where)
            imgs[side, animated] = render(sc, mt, cfg_e, spp=16,
                                          device=where)[0].cpu().numpy()
    errs = {a: relative_mae(imgs["card", a], imgs["cpu", a]) for a in (False, True)}
    smear = {side: int((np.abs(imgs[side, True] - imgs[side, False]).sum(-1) > 1e-3).sum())
             for side in ("card", "cpu")}
    emit({"phase": "main_path_vs_cpu", "scene": "moving_and_mirrored", "res": 48,
          "spp": 16, "max_depth": 3, "relative_mae": {"still": errs[False],
                                                       "moving": errs[True]},
          "pixels_moved": smear, "seconds": time.perf_counter() - t0})
    check(all(e < RELMAE_MAX for e in errs.values())
          and all(np.isfinite(im).all() for im in imgs.values()),
          f"GPU moving/mirrored renders differ from the CPU's (relative MAE {errs})")
    check(all(v > 50 for v in smear.values()), f"the moving instance does not smear: {smear}")

    # 18. bench: instbench's two renders (256x256, 4 spp, depth 3)
    t0 = time.perf_counter()
    rates = {}
    for name in ("instanced", "flattened"):
        for counts in (bs.LAUNCHES, bi.LAUNCHES, CLOSEST_WAVES):
            counts.update(dict.fromkeys(counts, 0))
        r = instbench.bench(lambda res, device, s=built[name]: s, 256, INST_SPP,
                            INST_DEPTH, dev)
        del r["build_seconds"]                  # built in phase 15
        other = dict(bs.LAUNCHES, **bi.LAUNCHES)
        rounds = [[s[2] for s in sw] for sw in r["sweeps_per_render"]]
        rates[name] = r["camera_rays_per_sec"]
        emit(dict({"phase": "bench", "scene": f"instbench_{name}", "res": 256,
                   "spp": INST_SPP, "max_depth": INST_DEPTH,
                   "sweep_rounds_per_wave": rounds, "other_launches": other,
                   "seconds": time.perf_counter() - t0, "gpu": gpu}, **r))
        expected_base = dict.fromkeys(b4.KERNELS, INST_DEPTH + 1)
        check(all(v == 0 for v in other.values()),
              f"{name}: a record-stream or brute-force kernel launched: {other}")
        check(all({k: n[k] for k in b4.KERNELS} == expected_base
                  for n in r["launches_per_render"]),
              f"{name}: base walk launches {r['launches_per_render']}")
        roots_ok = [all(n[k] > 0 for k in b4.ROOT_KERNELS) if name == "instanced"
                    else all(n[k] == 0 for k in b4.ROOT_KERNELS)
                    for n in r["launches_per_render"]]
        check(all(roots_ok), f"{name}: roots walk launches {r['launches_per_render']}")
        check(np.isfinite(r["image_mean"]) and r["image_mean"] > 0.0,
              f"{name}: bench image mean {r['image_mean']}")
        if name == "instanced":
            launches = r["launches_per_render"][0]
    emit({"phase": "bench", "scene": "instbench", "instanced_over_flattened":
          rates["instanced"] / rates["flattened"], "gpu": gpu})
    del built

    # 19. kernel_time: row 6 beside its plain version and its bound; the
    # bound counts the 4-byte root a ray besides the ray bytes
    t0 = time.perf_counter()
    entries = []
    for name, wave in INST_WAVES:
        any_hit = name == "bvh4_any_hit_roots"
        args, roots, live = cases[wave]
        with torch.no_grad():
            ms = cuda_ms(lambda: b4.bvh4_traverse(nodes, tris4, *args, any_hit=any_hit,
                                                  stack=stack, roots=roots), 20)
            plain_ms = cuda_ms(lambda: b4.bvh4_traverse_plain(
                nodes, tris4, *args, any_hit=any_hit, stack=stack, roots=roots), 1,
                warmup=0)
        counts = results[name]["counts"]
        bound, by = bvh4_bound(counts, table4_bytes + 4 * N_RAYS)
        emit({"phase": "kernel_time", "scene": "instbench", "kernel": name, "case": wave,
              "rays": N_RAYS, "live_rays": live, "ms": ms, "plain_ms": plain_ms,
              "node_fetches": counts[0], "box_tests": counts[1], "tri_tests": counts[2],
              "bytes_read": counts[0] * NODE_BYTES + counts[2] * TRI_BYTES,
              "table_bytes": table4_bytes, "bound_ms": bound, "bound_by": by,
              "percent_of_bound": 100.0 * bound / ms,
              "fill_blocks": b4.fill_blocks(dev.index, any_hit, stack), "gpu": gpu})
        entries.append({"name": name, "case": wave, "route": "cuda", "source": BVH4_SOURCE,
                        "replaces": ROOTS_REPLACES[name], "launches": launches[name],
                        "max_abs_err": max(results[name]["errs"].values()), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                        "library_ms": None})
    emit({"phase": "kernel_time", "scene": "instbench", "seconds": time.perf_counter() - t0})
    return entries


def _get(tree, path):
    return functools.reduce(lambda t, k: t[k], path, tree)


def _with_leaf(tree, path, value):
    """A copy of the scene's containers along `path` with that leaf replaced."""
    if not path:
        return value
    k, rest = path[0], path[1:]
    if isinstance(tree, tuple):
        return tree[:k] + (_with_leaf(tree[k], rest, value),) + tree[k + 1:]
    return dict(tree, **{k: _with_leaf(tree[k], rest, value)})


def scene_grads(scene, meta, leaves, cfg, dev):
    """Gradients of the mean image of one wave (1 spp) for the scene leaves
    at `leaves` ({name: path}): (loss, {name: grad}, forward s, backward s)."""
    params = {k: _get(scene, p).detach().clone().requires_grad_(True)
              for k, p in leaves.items()}
    for k, p in leaves.items():
        scene = _with_leaf(scene, p, params[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film = render_wave(scene, meta, cfg, new_film(meta.xres, meta.yres, dev), 0,
                       device=dev)
    loss = develop(film).mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    return (loss.item(), {k: v.grad for k, v in params.items()}, t1 - t0,
            time.perf_counter() - t1)


@contextlib.contextmanager
def plain_traversal():
    """The intersect dispatch calls the plain versions on the card: a
    comparison only (the wrappers take them only for CPU tensors)."""
    saved = isect.brute_intersect, isect.bvh4_traverse
    isect.brute_intersect = bi.brute_intersect_plain
    isect.bvh4_traverse = lambda *args, **kw: b4.bvh4_traverse_plain(*args, **kw)[:4]
    try:
        yield
    finally:
        isect.brute_intersect, isect.bvh4_traverse = saved


def grad_phases(dev, gpu):
    """Phase 20: gradients through the render (the training path) on both
    routes, then inverse rendering of the Cornell albedo."""
    cfg = IntegratorConfig(kind="path", max_depth=5)
    torch.use_deterministic_algorithms(True, warn_only=True)
    for name, make, kernels in GRAD_SCENES:
        t0 = time.perf_counter()
        scene, meta, _ = make(256, 256, 1, device=dev)
        leaves = GRAD_LEAVES[name]
        for counts in (bi.LAUNCHES, b4.LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))
        torch.cuda.reset_peak_memory_stats(dev)
        loss, grads, fwd_s, bwd_s = scene_grads(scene, meta, leaves, cfg, dev)
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: n for c in (bi.LAUNCHES, b4.LAUNCHES) for k, n in c.items()
                    if k in kernels}
        with plain_traversal():
            loss_p, grads_p, _, _ = scene_grads(scene, meta, leaves, cfg, dev)
        bitwise = {k: torch.equal(grads[k], grads_p[k]) for k in leaves}
        emit({"phase": "grad", "scene": name, "res": 256, "spp": 1,
              "max_depth": cfg.max_depth, "loss": loss, "loss_plain": loss_p,
              "launches": launches, "forward_seconds": fwd_s, "backward_seconds": bwd_s,
              "peak_memory_bytes": peak,
              "grad_abs_sum": {k: float(g.abs().sum()) for k, g in grads.items()},
              "nonzero": {k: int((g != 0).sum()) for k, g in grads.items()},
              "max_abs_diff_vs_plain": {k: float((grads[k] - grads_p[k]).abs().max())
                                        for k in leaves},
              "bitwise_equal_vs_plain": bitwise, "gpu": gpu})
        check(all(n > 0 for n in launches.values()) and set(launches) == set(kernels),
              f"the {name} gradient took the kernels {launches}")
        check(all(bool(torch.isfinite(g).all()) and bool((g != 0).any())
                  for g in grads.values()), f"{name} gradients not finite and nonzero")
        check(all(bitwise.values()),
              f"{name} gradients through the kernel differ from the plain version's")
        del scene, grads, grads_p

        # the card against the CPU at 32x32
        got = {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            sc, mt, _ = make(32, 32, 1, device=where)
            got[side] = {k: g.cpu() for k, g in
                               scene_grads(sc, mt, leaves, cfg, where)[1].items()}
        diffs = {}
        for k in leaves:
            a, b = got["card"][k], got["cpu"][k]
            tol = GRAD_ATOL * float(b.abs().max())
            diffs[k] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, rtol=GRAD_RTOL, atol=tol)),
                  f"{name} {k} gradient on the card differs from the CPU's "
                  f"(max |diff| {diffs[k]}, atol {tol})")
        emit({"phase": "grad_vs_cpu", "scene": name, "res": 32, "spp": 1,
              "max_depth": cfg.max_depth, "max_abs_diff": diffs, "rtol": GRAD_RTOL,
              "atol_of_max": GRAD_ATOL, "seconds": time.perf_counter() - t0})
    torch.use_deterministic_algorithms(False)

    # inverse rendering: the white walls' albedo from a target image
    t0 = time.perf_counter()
    scene, meta, _ = cornell_box(128, 128, 1, device=dev)
    cfg1 = IntegratorConfig(kind="path", max_depth=1)
    target, _ = render(scene, meta, cfg1, spp=1, device=dev)
    rec, losses = optimize_albedo(scene, meta, cfg1, target, steps=25, lr=0.1, spp=1,
                                  param_rows=(0,), device=dev)
    true = scene["tex_data"]["const"][0]
    err0 = float((true - 0.5).abs().mean())
    err1 = float((true - rec[0]).abs().mean())
    emit({"phase": "optimize_albedo", "scene": "cornell", "res": 128, "spp": 1,
          "max_depth": 1, "steps": 25, "losses": losses, "albedo_error_start": err0,
          "albedo_error_end": err1, "seconds": time.perf_counter() - t0})
    check(losses[-1] < 0.3 * losses[0] and err1 < 0.5 * err0,
          "inverse rendering did not recover the albedo")


def _scene_file(name, scenes=None):
    return os.path.join(scenes or os.path.join(ROOT, "scenes"), name + ".pbrt")


def _golden(name):
    return read_image(os.path.join(ROOT, "tests", "goldens", name + ".exr"))


def pbrt_cli(tmp, names=PBRT_SCENES, phase="pbrt_cli", scenes=None):
    """The command line on each scene of `names` (read from directory
    `scenes`, scenes/ by default), one process a scene, run together; each
    must exit 0 and write an image near the golden."""
    t0 = time.perf_counter()
    outs = {name: os.path.join(tmp, name + ".exr") for name in names}
    procs = {}
    try:
        for name in names:
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "grail_torch.cli.main", _scene_file(name, scenes),
                 "--outfile", outs[name]], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            _, log = proc.communicate(timeout=600)
            check(proc.returncode == 0,
                  f"the command line exited {proc.returncode} on {name}: {log[-2000:]}")
            img = read_image(outs[name])
            err = relative_mae(img, _golden(name))
            emit({"phase": phase, "scene": name, "shape": list(img.shape),
                  "relative_mae_vs_golden": err, "log": log.strip().splitlines()[-3:],
                  "seconds": time.perf_counter() - t0})
            check(np.isfinite(img).all() and err < GOLDEN_RELMAE,
                  f"the command line's {name} image is {err} from its golden")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _scene_text(name, res, scenes=None, spp=None):
    """The scene file's text at res = (xres, yres) (and spp samples a
    pixel, where given)."""
    with open(_scene_file(name, scenes)) as f:
        text = re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                      f'"integer xresolution" [{res[0]}] "integer yresolution" [{res[1]}]',
                      f.read())
    if spp is not None:
        text = re.sub(r'"integer pixelsamples" \[\d+\]', f'"integer pixelsamples" [{spp}]',
                      text)
    return text


def small_vs_cpu(name, dev, phase, scenes=None, text=None,
                 res=(PBRT_SMALL_RES, PBRT_SMALL_RES)):
    """The scene file (or `text`, read against directory `scenes`) at res,
    PBRT_SMALL_SPP on the card against the CPU (relative MAE < RELMAE_MAX)."""
    t0 = time.perf_counter()
    scenes = scenes or os.path.join(ROOT, "scenes")
    text = text or _scene_text(name, res, scenes)
    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sc, mt, ap = parse_string(text, device=where, search_path=scenes)
        imgs[side] = render(sc, mt, ap.integrator_config, spp=PBRT_SMALL_SPP,
                            device=where)[0].cpu().numpy()
    err = relative_mae(imgs["card"], imgs["cpu"])
    emit({"phase": phase, "scene": name, "res": list(res), "spp": PBRT_SMALL_SPP,
          "kind": ap.integrator_config.kind, "camera": mt.cam_kind, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(imgs["card"].shape == (res[1], res[0], 3)
          and np.isfinite(imgs["card"]).all() and err < RELMAE_MAX,
          f"{name} on the card differs from the CPU (relative MAE {err})")


@contextlib.contextmanager
def captured_waves(waves):
    """Records in `waves` the launch of the 4-wide walk with the most live
    rays on each kind of wave that the intersect dispatch makes, as {case:
    (any_hit, (o, d, tmin, tmax))}: the rays as the kernel receives them
    (binned or not, dead lanes inert). case: "camera_wave", or a secondary
    or shadow wave, binned or unbinned (below SORT_MIN rays, as a compacted
    tail may be)."""
    stream, traverse = isect._stream_bvh, isect.bvh4_traverse
    case, live_of = [None], {}

    def stream_named(scene, o, d, tmax, tmin, any_hit=False, sort=None):
        if sort is False:
            case[0] = "camera_wave"
        else:
            case[0] = (("binned_" if o.shape[0] >= isect.SORT_MIN else "unbinned_")
                       + ("shadow" if any_hit else "secondary"))
        return stream(scene, o, d, tmax, tmin, any_hit=any_hit, sort=sort)

    def traverse_recorded(nodes, tris, o, d, tmin, tmax, any_hit=False, **kw):
        live = int((tmax > tmin).sum())
        if live and live > live_of.get(case[0], 0):
            live_of[case[0]] = live
            waves[case[0]] = (any_hit, tuple(x.detach().clone() for x in (o, d, tmin, tmax)))
        return traverse(nodes, tris, o, d, tmin, tmax, any_hit, **kw)

    isect._stream_bvh, isect.bvh4_traverse = stream_named, traverse_recorded
    try:
        yield waves
    finally:
        isect._stream_bvh, isect.bvh4_traverse = stream, traverse


def pbrt_phases(dev, gpu):
    """Phase 21: the pbrt scenes through the port's parser and command line."""
    with tempfile.TemporaryDirectory() as tmp:
        pbrt_cli(tmp)
    for name in PBRT_SCENES:
        t0 = time.perf_counter()
        scene, meta, api = parse_file(_scene_file(name), device=dev)
        torch.cuda.synchronize()
        parse_s = time.perf_counter() - t0
        cfg = api.integrator_config
        spp = meta.sampler.spp

        # parity: each 4-wide kernel on the busiest wave of each kind that
        # the authored render hands it, against its plain version, bitwise
        t0 = time.perf_counter()
        with captured_waves({}) as waves:
            render(scene, meta, cfg, spp=spp, device=dev)
        for case in PBRT_WAVES[name]:
            check(case in waves, f"{name}'s render made no {case} wave")
        for case, (any_hit, args) in waves.items():
            kernel = "bvh4_any_hit" if any_hit else "bvh4_closest"
            emit(bvh4_parity(name, kernel, case, args, scene["bvh"])[1])
        emit({"phase": "parity", "scene": name, "cases": sorted(waves),
              "seconds": time.perf_counter() - t0})
        del waves
        times, launches, waves, img, peak, held = bench_render(scene, meta, cfg, spp, dev)
        err = relative_mae(img, _golden(name))
        expected = dict.fromkeys(launches[0], 0)
        expected.update(dict.fromkeys(b4.KERNELS, cfg.max_depth + 1))
        emit({"phase": "pbrt_bench", "scene": name, "res": [meta.xres, meta.yres],
              "spp": spp, "sampler_kind": meta.sampler.kind, "filter": meta.filter.kind,
              "max_depth": cfg.max_depth, "triangles": meta.n_tris,
              "lobe_types": list(meta.lobe_types), "host_parse_seconds": parse_s,
              "render_seconds": times,
              "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
              "launches_per_render": launches, "expected_launches": expected,
              "bvh4_closest_by_wave": waves, "relative_mae_vs_golden": err,
              "image_mean": float(img.mean()), "peak_memory_bytes": peak,
              "held_before_render_bytes": held, "gpu": gpu,
              "seconds": time.perf_counter() - t0})
        check(all(n == expected for n in launches),
              f"{name} renders launched {launches}, want {expected}")
        check(np.isfinite(img).all() and err < GOLDEN_RELMAE,
              f"{name} at its authored settings is {err} from its golden")
        del scene

        # the card against the CPU at a reduced size
        small_vs_cpu(name, dev, "pbrt_vs_cpu")


@contextlib.contextmanager
def role_waves(waves):
    """Records in `waves`, for each (kernel, role), the launch with the most
    live rays that the integrator's waves hand a kernel, as {(kernel, role):
    (live, tables, (o, d, tmin, tmax), keywords)}: role is the integrator's
    (integrator.WAVES: camera, continuation, bsdf, shadow, occlusion,
    alpha), the rays as the kernel receives them (binned or not, dead lanes
    inert), the walk with roots among them (the instanced sweep's rounds)."""
    role = [None]
    trace = integ._trace
    kernels = (isect.bvh4_traverse, instanced.bvh4_traverse, isect.brute_intersect)

    def named(*args, **kw):
        role[0] = kw["role"]
        return trace(*args, **kw)

    def record(kernel, tables, rays, kw):
        if rays[0].device.type != "cuda":          # the CPU's plain version
            return
        live = int((rays[3] > rays[2]).sum())
        key = (kernel, role[0])
        if live and live > waves.get(key, (0,))[0]:
            keep = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            waves[key] = (live, tables, tuple(a.detach().clone() for a in rays), keep)

    def walk(fn):
        def run(nodes, tris, o, d, tmin, tmax, any_hit=False, **kw):
            name = (b4.KERNELS if kw.get("roots") is None else b4.ROOT_KERNELS)[int(any_hit)]
            record(name, (nodes, tris), (o, d, tmin, tmax), dict(kw, any_hit=any_hit))
            return fn(nodes, tris, o, d, tmin, tmax, any_hit, **kw)
        return run

    def brute(tris9, o, d, tmin, tmax, any_hit=False):
        record(bi.KERNELS[int(any_hit)], (tris9,), (o, d, tmin, tmax), {"any_hit": any_hit})
        return kernels[2](tris9, o, d, tmin, tmax, any_hit)

    integ._trace = named
    isect.bvh4_traverse, instanced.bvh4_traverse = walk(kernels[0]), walk(kernels[1])
    isect.brute_intersect = brute
    try:
        yield waves
    finally:
        integ._trace = trace
        isect.bvh4_traverse, instanced.bvh4_traverse, isect.brute_intersect = kernels


def wave_parity(source, kernel, role, tables, rays, kw, phase="direct_parity"):
    """A captured wave through its kernel and its plain version on the card,
    bitwise; emits the parity line and returns the max |difference|."""
    with torch.no_grad():
        if kernel in bi.KERNELS:
            kern = bi.brute_intersect(tables[0], *rays, kw["any_hit"])
            plain = bi.brute_intersect_plain(tables[0], *rays, kw["any_hit"])
        else:
            kern = b4.bvh4_traverse(*tables, *rays, **kw)
            plain = b4.bvh4_traverse_plain(*tables, *rays, **kw)[:4]
        torch.cuda.synchronize()
    n_bad, errs, bitwise = compare(kern, plain, kw["any_hit"])
    emit({"phase": phase, "source": source, "kernel": kernel, "wave": role,
          "rays": rays[0].shape[0], "live_rays": int((rays[3] > rays[2]).sum()),
          "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
          "max_abs_diff": errs, "bitwise_equal": bitwise})
    check(bitwise, f"{kernel} is not bitwise equal to its plain version on "
                   f"{source}'s {role} wave")
    return max(errs.values())


def expected_waves(cfg, meta):
    """The waves of one megawave's li by role (integrator.WAVES): every
    bounce at full width for direct and whitted, one shadow wave a light
    sampled (all of them under "all" and whitted), one BSDF-branch wave each
    where the scene has an area or infinite light; on a scene with alpha
    cutouts, ALPHA_MAX_REJECT re-traces after every other wave. The
    single-scattering march traces MAX_MARCH_STEPS "medium" waves a region
    on the camera segment. kind="dipole" makes one camera wave, one light's
    shadow wave and BSDF branch, and, once a render (one megawave in the
    renders here), n_samples (4) "irradiance" waves a light in its
    preprocess."""
    if cfg.kind == "ao":
        want = dict(camera=1, continuation=0, bsdf=0, shadow=0, occlusion=cfg.ao_samples)
    elif cfg.kind == "dipole":
        mis = bool({AREA, INFINITE} & set(meta.light_types))
        want = dict(camera=1, continuation=0, bsdf=int(mis), shadow=int(meta.n_lights > 0),
                    occlusion=0)
    else:
        bounces = cfg.max_depth + 1
        lights = (meta.n_lights if cfg.kind == "whitted" or cfg.light_strategy == "all"
                  else 1)
        mis = cfg.kind == "direct" and bool({AREA, INFINITE} & set(meta.light_types))
        want = dict(camera=1, continuation=bounces - 1,
                    bsdf=bounces * lights if mis else 0, shadow=bounces * lights,
                    occlusion=0)
    want["alpha"] = integ.ALPHA_MAX_REJECT * sum(want.values()) if meta.alpha_rows else 0
    marches = (cfg.kind != "ao" and cfg.vol == "single" and meta.n_lights > 0)
    want["medium"] = media.MAX_MARCH_STEPS * len(meta.media_kinds) if marches else 0
    want["irradiance"] = 4 * meta.n_lights if cfg.kind == "dipole" else 0
    return dict(dict.fromkeys(WAVES, 0), **want)    # no Metropolis wave


def expected_launches(want, meta, kernels):
    """Launches a render of each kernel of `kernels` (closest hit, any hit)
    for the waves `want`: any hit on shadow and occlusion waves, closest hit
    on the others, and on all of them where the scene has alpha cutouts
    (IntersectP is then a closest-hit loop); the march's and the dipole
    preprocess's waves are any hit in every scene (they skip cutouts)."""
    closest, any_hit = kernels
    n_any = (0 if meta.alpha_rows else want["shadow"] + want["occlusion"]) \
        + want["medium"] + want["irradiance"]
    return {closest: sum(want.values()) - n_any, any_hit: n_any}


def busy_share(scene, meta, cfg, spp, dev, wall):
    """(kernel ms, launches, busy share) of one render under torch.profiler:
    the card's kernel time over the unprofiled wall time `wall`."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return kernel_ms, sum(e.count for e in kernels), kernel_ms / (wall * 1e3)


def _launch_counts():
    return dict(b4.LAUNCHES, **bi.LAUNCHES, **bs.LAUNCHES)


def _reset_counts():
    for counts in (bs.LAUNCHES, b4.LAUNCHES, bi.LAUNCHES, CLOSEST_WAVES, WAVES):
        counts.update(dict.fromkeys(counts, 0))


def direct_phases(dev, gpu):
    """The direct group: the seven goldens of kind direct, whitted and ao
    through the command line and against the CPU; the full-size renders of
    the new kinds; every kernel on the busiest wave of each (kernel, role)
    these renders hand it, against its plain version. Returns {kernel:
    launches} over the group's renders (parity launches apart)."""
    t_group = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pbrt_cli(tmp, DIRECT_GOLDENS, "direct_cli")
    total = dict.fromkeys(DIRECT_KERNELS, 0)
    waves = {}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    with role_waves(waves):
        for name in DIRECT_GOLDENS:
            _reset_counts()
            small_vs_cpu(name, dev, "direct_vs_cpu")
            add(_launch_counts())
        # the area light's BSDF branch on brute force, card against CPU
        t0 = time.perf_counter()
        imgs = {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            sc, mt, _ = cornell_box(PBRT_SMALL_RES, PBRT_SMALL_RES, PBRT_SMALL_SPP,
                                    device=where)
            _reset_counts()
            imgs[side] = render(sc, mt, DIRECT_POWER, device=where)[0].cpu().numpy()
            if side == "card":
                add(_launch_counts())
                got_waves = dict(WAVES)
        err = relative_mae(imgs["card"], imgs["cpu"])
        emit({"phase": "direct_vs_cpu", "scene": "cornell", "kind": "direct",
              "light_strategy": "power", "res": PBRT_SMALL_RES, "spp": PBRT_SMALL_SPP,
              "relative_mae": err, "waves": got_waves,
              "expected_waves": expected_waves(DIRECT_POWER, mt),
              "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
              "seconds": time.perf_counter() - t0})
        check(np.isfinite(imgs["card"]).all() and err < RELMAE_MAX
              and got_waves == expected_waves(DIRECT_POWER, mt),
              f"Cornell direct/power on the card: relative MAE {err}, waves {got_waves}")

        scenes = {}
        for label, preset, cfg in DIRECT_RENDERS:
            t0 = time.perf_counter()
            if preset not in scenes:
                scenes.clear()
                make = (functools.partial(mesh_scene, grid=MESH_GRID) if preset == "mesh"
                        else cornell_box)
                scenes[preset] = make(256, 256, 16, device=dev)[:2]
            scene, meta = scenes[preset]
            spp = meta.sampler.spp
            _reset_counts()
            render(scene, meta, cfg, spp=spp, device=dev)     # captures its waves
            got_waves = dict(WAVES)
            times, launches, _, img, peak, held = bench_render(scene, meta, cfg, spp, dev)
            add(launches[0])
            wall = statistics.median(times)
            kernel_ms, n_launch, busy = busy_share(scene, meta, cfg, spp, dev, wall)
            closest = "brute_intersect" if preset == "cornell" else "bvh4_closest"
            any_hit = bi.KERNELS[1] if preset == "cornell" else "bvh4_any_hit"
            want = expected_waves(cfg, meta)
            by_wave = {"camera": want["camera"], "continuation": want["continuation"],
                       "bsdf": want["bsdf"]}
            expected = dict.fromkeys(launches[0], 0)
            expected.update(expected_launches(want, meta, (closest, any_hit)))
            emit({"phase": "direct_bench", "render": label, "kind": cfg.kind,
                  "light_strategy": cfg.light_strategy, "ao_samples": cfg.ao_samples,
                  "res": 256, "spp": spp, "max_depth": cfg.max_depth,
                  "triangles": meta.n_tris, "render_seconds": times,
                  "camera_rays_per_sec": meta.xres * meta.yres * spp / wall,
                  "launches_per_render": launches, "expected_launches": expected,
                  "closest_hit_by_wave": by_wave, "waves": got_waves,
                  "device_kernel_ms": kernel_ms, "device_launches": n_launch,
                  "device_busy_share": busy, "image_mean": float(img.mean()),
                  "peak_memory_bytes": peak, "held_before_render_bytes": held, "gpu": gpu,
                  "seconds": time.perf_counter() - t0})
            if cfg.kind != "ao":
                # the scene has no delta lobe, so bounces 1-5 are dead waves:
                # depth 0 renders the same image, and the rate beside it is
                # what they cost
                shallow = dataclasses.replace(cfg, max_depth=0)
                times0, _, _, img0, _, _ = bench_render(scene, meta, shallow, spp, dev)
                emit({"phase": "direct_bench_depth0", "render": label,
                      "render_seconds": times0,
                      "camera_rays_per_sec": meta.xres * meta.yres * spp
                      / statistics.median(times0),
                      "image_bitwise_equal_depth5": bool(np.array_equal(img0, img))})
                check(np.array_equal(img0, img),
                      f"{label} at depth 0 differs from depth 5 (dead bounces add light)")
            check(got_waves == want, f"{label} made waves {got_waves}, want {want}")
            check(all(n == expected for n in launches),
                  f"{label} renders launched {launches}, want {expected}")
            check(np.isfinite(img).all() and img.shape == (256, 256, 3) and img.mean() > 0.0,
                  f"{label}'s image is not finite and positive")
        scenes.clear()

    # the group's renders went through every kernel of its path
    emit({"phase": "direct_launches", "launches": total})
    check(all(total[k] > 0 for k in DIRECT_KERNELS),
          f"a kernel of the direct path was not launched: {total}")
    # parity on the busiest wave of each (kernel, role)
    t0 = time.perf_counter()
    max_err = dict.fromkeys(DIRECT_KERNELS, 0.0)
    for (kernel, role), (_, tables, rays, kw) in sorted(waves.items(), key=lambda w: w[0]):
        max_err[kernel] = max(max_err[kernel],
                              wave_parity("direct", kernel, role, tables, rays, kw))
    for need in (("bvh4_closest", "bsdf"), ("bvh4_any_hit", "shadow"),
                 ("bvh4_any_hit", "occlusion"), ("brute_intersect_any_hit", "shadow"),
                 ("brute_intersect", "bsdf"), ("bvh4_closest_roots", "camera")):
        check(need in waves, f"the direct group's renders made no {need} wave")
    emit({"phase": "direct_parity", "cases": [list(k) for k in sorted(waves)],
          "seconds": time.perf_counter() - t0})
    del waves
    emit({"phase": "direct", "seconds": time.perf_counter() - t_group})
    return total


def maps_phases(dev, gpu):
    """The maps group: the four goldens through the command line and
    against the CPU, the environment camera against the CPU, the five
    full-size renders, and each kernel on the busiest wave of each (kernel,
    role) they hand it, against its plain version. Returns {kernel:
    launches} over the group's renders (parity launches apart)."""
    t_group = time.perf_counter()
    total = dict.fromkeys(MAPS_KERNELS, 0)
    waves = {}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    with tempfile.TemporaryDirectory() as tmp:
        scenes = gen_assets.scene_copy(os.path.join(tmp, "scenes"))
        pbrt_cli(tmp, MAPS_GOLDENS, "maps_cli", scenes)
        with role_waves(waves):
            for name in MAPS_RENDERS:
                _reset_counts()
                small_vs_cpu(name, dev, "maps_vs_cpu", scenes)
                add(_launch_counts())
            _reset_counts()
            env = re.sub(r'^Camera "perspective".*$', 'Camera "environment"',
                         _scene_text("envlight", ENV_RES), flags=re.M)
            small_vs_cpu("envlight_environment", dev, "maps_vs_cpu", scenes, env, ENV_RES)
            add(_launch_counts())

            for name in MAPS_RENDERS:
                t0 = time.perf_counter()
                scene, meta, api = parse_string(
                    _scene_text(name, (MAPS_RES, MAPS_RES), scenes, MAPS_SPP),
                    device=dev, search_path=scenes)
                cfg = api.integrator_config
                _reset_counts()
                render(scene, meta, cfg, spp=MAPS_SPP, device=dev)   # captures its waves
                got_waves = dict(WAVES)
                times, launches, routes, img, peak, held = bench_render(
                    scene, meta, cfg, MAPS_SPP, dev)
                add(launches[0])
                wall = statistics.median(times)
                kernel_ms, n_launch, busy = busy_share(scene, meta, cfg, MAPS_SPP, dev, wall)
                want = expected_waves(cfg, meta)
                expected = dict.fromkeys(launches[0], 0)
                expected.update(expected_launches(want, meta, MAPS_KERNELS))
                emit({"phase": "maps_bench", "render": name, "kind": cfg.kind,
                      "light_strategy": cfg.light_strategy, "camera": meta.cam_kind,
                      "res": MAPS_RES, "spp": MAPS_SPP, "max_depth": cfg.max_depth,
                      "triangles": meta.n_tris, "light_types": list(meta.light_types),
                      "texture_kinds": sorted({t.kind for t in meta.tex_specs}),
                      "bump_rows": list(meta.bump_rows), "alpha_rows": list(meta.alpha_rows),
                      "render_seconds": times,
                      "camera_rays_per_sec": MAPS_RES * MAPS_RES * MAPS_SPP / wall,
                      "launches_per_render": launches, "expected_launches": expected,
                      "bvh4_closest_by_route": routes[0],
                      "waves": got_waves, "expected_waves": want,
                      "device_kernel_ms": kernel_ms, "device_launches": n_launch,
                      "device_busy_share": busy, "image_mean": float(img.mean()),
                      "peak_memory_bytes": peak, "held_before_render_bytes": held,
                      "gpu": gpu, "seconds": time.perf_counter() - t0})
                check(got_waves == want, f"{name} made waves {got_waves}, want {want}")
                check(all(n == expected for n in launches),
                      f"{name} renders launched {launches}, want {expected}")
                check(np.isfinite(img).all() and img.shape == (MAPS_RES, MAPS_RES, 3)
                      and img.mean() > 0.0, f"{name}'s image is not finite and positive")
                del scene

    emit({"phase": "maps_launches", "launches": total})
    check(all(total[k] > 0 for k in MAPS_KERNELS),
          f"a kernel of the maps path was not launched: {total}")
    t0 = time.perf_counter()
    for (kernel, role), (_, tables, rays, kw) in sorted(waves.items(), key=lambda w: w[0]):
        wave_parity("maps", kernel, role, tables, rays, kw, "maps_parity")
    for need in MAPS_WAVES:
        check(need in waves, f"the maps group's renders made no {need} wave")
    emit({"phase": "maps_parity", "cases": [list(k) for k in sorted(waves)],
          "seconds": time.perf_counter() - t0})
    del waves
    emit({"phase": "maps", "seconds": time.perf_counter() - t_group})
    return total


def spotfog_variants():
    """spotfog's world at 32x32 with its homogeneous region made a
    volumegrid (an 8x4x8 density drawn from GRID_SEED) and an exponential
    region, the other parameters kept: the GRID and EXPONENTIAL marches of
    tau and single_scatter_li."""
    text = _scene_text("spotfog", (PBRT_SMALL_RES, PBRT_SMALL_RES))
    dens = np.random.default_rng(GRID_SEED).uniform(0.0, 2.0, 8 * 4 * 8)
    grid = ('Volume "volumegrid" "integer nx" [8] "integer ny" [4] "integer nz" [8] '
            '"float density" [%s]' % " ".join(f"{v:.4f}" for v in dens))
    expo = 'Volume "exponential" "float a" [1.5] "float b" [0.8] "vector updir" [0 1 0]'
    return {"spotfog_grid": text.replace('Volume "homogeneous"', grid),
            "spotfog_exponential": text.replace('Volume "homogeneous"', expo)}


def dipole_contraction(dev, gpu, aux, cfg):
    """The dipole's Mo contraction alone at a full megawave (1,048,576 lanes
    against the render's point cloud): ms a call on the card's clock and
    the peak memory above what it is given."""
    p = torch.rand((N_RAYS, 3), device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    args = (p, aux, p.new_tensor(cfg.sss_sigma_a), p.new_tensor(cfg.sss_sigma_s),
            float(cfg.sss_eta))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: subsurface._mo(*args), 3)
    emit({"phase": "media_dipole_contraction", "lanes": N_RAYS,
          "points": int(aux["p"].shape[0]), "lane_chunk": subsurface.LANE_CHUNK,
          "point_chunk": subsurface.POINT_CHUNK, "ms": ms,
          "peak_above_held_bytes": torch.cuda.max_memory_allocated(dev) - held, "gpu": gpu})


def media_phases(dev, gpu):
    """The media group: the three goldens through the command line and
    against the CPU, spotfog's grid and exponential variants against the
    CPU, the three full-size renders, the dipole's contraction alone, and
    each kernel on the busiest wave of each (kernel, role) the renders hand
    it, against its plain version. Returns {kernel: launches} over the
    group's renders (parity launches apart)."""
    t_group = time.perf_counter()
    total = dict.fromkeys(MEDIA_KERNELS, 0)
    waves = {}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    with tempfile.TemporaryDirectory() as tmp:
        pbrt_cli(tmp, MEDIA_GOLDENS, "media_cli")
    with role_waves(waves):
        for name in MEDIA_GOLDENS:
            _reset_counts()
            small_vs_cpu(name, dev, "media_vs_cpu")
            add(_launch_counts())
        for name, text in spotfog_variants().items():
            _reset_counts()
            small_vs_cpu(name, dev, "media_vs_cpu", text=text)
            add(_launch_counts())

        scenes = os.path.join(ROOT, "scenes")
        for name in MEDIA_GOLDENS:
            t0 = time.perf_counter()
            scene, meta, api = parse_string(
                _scene_text(name, (MEDIA_RES, MEDIA_RES), spp=MEDIA_SPP), device=dev,
                search_path=scenes)
            cfg = api.integrator_config
            _reset_counts()
            render(scene, meta, cfg, spp=MEDIA_SPP, device=dev)   # captures its waves
            got_waves = dict(WAVES)
            extra = {}
            if cfg.kind == "dipole":
                # the preprocess apart (each render below runs it once)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                aux = preprocess(scene, meta, cfg)
                torch.cuda.synchronize()
                extra["preprocess_seconds"] = time.perf_counter() - t1
                dipole_contraction(dev, gpu, aux, cfg)
                del aux
            times, launches, routes, img, peak, held = bench_render(
                scene, meta, cfg, MEDIA_SPP, dev)
            add(launches[0])
            wall = statistics.median(times)
            kernel_ms, n_launch, busy = busy_share(scene, meta, cfg, MEDIA_SPP, dev, wall)
            want = expected_waves(cfg, meta)
            expected = dict.fromkeys(launches[0], 0)
            expected.update(expected_launches(want, meta, MEDIA_KERNELS))
            emit(dict({"phase": "media_bench", "render": name, "kind": cfg.kind,
                       "vol": cfg.vol, "media_kinds": list(meta.media_kinds),
                       "lobe_types": list(meta.lobe_types),
                       "light_strategy": cfg.light_strategy, "res": MEDIA_RES,
                       "spp": MEDIA_SPP, "max_depth": cfg.max_depth,
                       "triangles": meta.n_tris, "light_types": list(meta.light_types),
                       "render_seconds": times,
                       "camera_rays_per_sec": MEDIA_RES * MEDIA_RES * MEDIA_SPP / wall,
                       "launches_per_render": launches, "expected_launches": expected,
                       "bvh4_closest_by_route": routes[0],
                       "waves": got_waves, "expected_waves": want,
                       "device_kernel_ms": kernel_ms, "device_launches": n_launch,
                       "device_busy_share": busy, "image_mean": float(img.mean()),
                       "peak_memory_bytes": peak, "held_before_render_bytes": held,
                       "gpu": gpu, "seconds": time.perf_counter() - t0}, **extra))
            check(got_waves == want, f"{name} made waves {got_waves}, want {want}")
            check(all(n == expected for n in launches),
                  f"{name} renders launched {launches}, want {expected}")
            check(np.isfinite(img).all() and img.shape == (MEDIA_RES, MEDIA_RES, 3)
                  and img.mean() > 0.0, f"{name}'s image is not finite and positive")
            del scene

    emit({"phase": "media_launches", "launches": total})
    check(all(total[k] > 0 for k in MEDIA_KERNELS),
          f"a kernel of the media path was not launched: {total}")
    t0 = time.perf_counter()
    for (kernel, role), (_, tables, rays, kw) in sorted(waves.items(), key=lambda w: w[0]):
        wave_parity("media", kernel, role, tables, rays, kw, "media_parity")
    for need in MEDIA_WAVES:
        check(need in waves, f"the media group's renders made no {need} wave")
    emit({"phase": "media_parity", "cases": [list(k) for k in sorted(waves)],
          "seconds": time.perf_counter() - t0})
    del waves
    emit({"phase": "media", "seconds": time.perf_counter() - t_group})
    return total


def mlt_blocks(img, ref, k=8):
    """tests/test_render.py's block check: the relative error of each 8x8
    block mean against the path-traced reference's (floored at 0.02)."""
    def blocks(a):
        h, w, _ = a.shape
        return a[:h // k * k, :w // k * k].reshape(h // k, k, w // k, k, 3).mean((1, 3))
    rel = np.abs(blocks(img) - blocks(ref)) / np.maximum(blocks(ref), 0.02)
    return float(np.median(rel)), float(np.quantile(rel, 0.9))


def mlt_u(n, dim, device, seed=12345):
    """n primary-sample vectors drawn as the bootstrap draws them."""
    pix = torch.arange(n, dtype=torch.int64, device=device) ^ seed
    return rngmod.sample_1d(rngmod.SamplerConfig(kind=rngmod.RANDOM), pix[:, None],
                            torch.zeros((n, 1), dtype=torch.int64, device=device),
                            torch.arange(dim, dtype=torch.int64, device=device)[None, :])


def mlt_n_waves(meta, cfg, mlt_spp):
    """The command line's wave count: pixels x mutations a pixel over the
    mutations of a wave."""
    return max(1, meta.xres * meta.yres * mlt_spp // (cfg.n_chains * cfg.mutations_per_wave))


def mlt_vs_cpu(dev):
    """eval_path and eval_path_bidir on MLT_LANES u-vectors and _mutate, the
    card against the CPU: >= 99% of lanes within rtol 1e-4, atol 1e-6; the
    mutation bitwise."""
    t0 = time.perf_counter()
    sides = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        scene, meta, api = parse_file(_scene_file("mlt"), device=where)
        cfg = api.mlt_config
        u = mlt_u(MLT_LANES, cfg.dim, where)
        out = {"u": u}
        for fn in (mlt.eval_path, mlt.eval_path_bidir):
            out[fn.__name__] = [a.cpu().numpy() for a in fn(scene, meta, cfg, u)]
        key = (torch.arange(MLT_LANES, dtype=torch.int64, device=where) ^ (3 * 7919)) ^ (5 * 104729)
        out["mutate"] = [a.cpu().numpy() for a in mlt._mutate(u, key, 5, cfg)]
        sides[side] = out
        del scene
    card, cpu = sides["card"], sides["cpu"]
    line = {"phase": "mlt_vs_cpu", "lanes": MLT_LANES,
            "u_bitwise": bool(np.array_equal(card["u"].cpu().numpy(), cpu["u"].numpy()))}
    for fn in ("eval_path", "eval_path_bidir"):
        (L, px, py), (L_c, px_c, py_c) = card[fn], cpu[fn]
        close = np.all(np.abs(L - L_c) <= 1e-6 + 1e-4 * np.abs(L_c), axis=-1)
        line[fn] = {"lanes_close": float(close.mean()), "bitwise_lanes":
                    float(np.all(L == L_c, axis=-1).mean()), "max_abs_diff":
                    float(np.abs(L - L_c).max()), "mean": float(L.mean()),
                    "raster_equal": bool(np.array_equal(px, px_c) and np.array_equal(py, py_c))}
        check(np.isfinite(L).all() and close.mean() >= 0.99 and line[fn]["raster_equal"],
              f"{fn} on the card differs from the CPU: {line[fn]}")
    line["mutate_bitwise"] = bool(all(np.array_equal(a, b) for a, b in
                                      zip(card["mutate"], cpu["mutate"])))
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    check(line["u_bitwise"] and line["mutate_bitwise"],
          "the bootstrap draw or a mutation differs between the card and the CPU")


def mlt_render_loop(dev, gpu):
    """The render loop's other paths on the card: a checkpointed mesh100k
    render resumed, bitwise the uninterrupted one (the dense grid film);
    a cropped and an adaptive Cornell box against the CPU; the occupancy
    line of mesh100k's bench wave."""
    t0 = time.perf_counter()
    cfg = IntegratorConfig(kind="path", max_depth=5)
    scene, meta, _ = mesh_scene(64, 64, 8, grid=MESH_GRID, device=dev)
    img_full = render(scene, meta, cfg, spp=8, device=dev)[0].cpu().numpy()
    _, film = render(scene, meta, cfg, spp=4, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ck.npz")
        ckpt.save(path, film, 4, meta, cfg)
        img_res = render(scene, meta, cfg, spp=8, checkpoint_path=path,
                         device=dev)[0].cpu().numpy()
        removed = not os.path.exists(path)
    emit({"phase": "mlt_render_loop", "case": "checkpoint_resume", "scene": "mesh100k",
          "res": 64, "spp": 8, "resumed_at": 4, "bitwise_equal":
          bool(np.array_equal(img_res, img_full)), "checkpoint_removed": removed,
          "image_mean": float(img_full.mean())})
    check(np.array_equal(img_res, img_full) and removed,
          "the resumed mesh100k render is not bitwise the uninterrupted one")
    del scene

    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sc, mt, _ = cornell_box(32, 32, 4, device=where)
        crop = render(sc, dataclasses.replace(mt, crop=MLT_CROP),
                      IntegratorConfig(kind="path", max_depth=5), spp=4, device=where)[0]
        adaptive, (_, _, spp_map) = render_adaptive(
            sc, mt, IntegratorConfig(kind="path", max_depth=5), min_spp=2, max_spp=6,
            threshold=0.25, device=where)
        imgs[side] = (crop.cpu().numpy(), adaptive.cpu().numpy(), spp_map)
    for i, case in enumerate(("crop", "adaptive")):
        a, b = imgs["card"][i], imgs["cpu"][i]
        err = relative_mae(a, b)
        line = {"phase": "mlt_render_loop", "case": case, "scene": "cornell", "res": 32,
                "relative_mae": err, "bitwise_equal": bool(np.array_equal(a, b)),
                "image_mean": float(a.mean())}
        if case == "adaptive":
            line.update(spp_map_equal=float((imgs["card"][2] == imgs["cpu"][2]).mean()),
                        spp_min=int(imgs["card"][2].min()), spp_max=int(imgs["card"][2].max()))
        else:
            line["crop"] = list(MLT_CROP)
        emit(line)
        check(np.isfinite(a).all() and a.mean() > 0 and err < RELMAE_MAX,
              f"the {case} Cornell render on the card differs from the CPU ({err})")

    scene, meta, _ = mesh_scene(256, 256, 16, grid=MESH_GRID, device=dev)
    t1 = time.perf_counter()
    occ = occupancy_probe(scene, meta, cfg, device=dev)
    emit({"phase": "mlt_render_loop", "case": "occupancy_probe", "scene": "mesh100k",
          "res": 256, "occupancy_per_bounce": occ, "probe_seconds": time.perf_counter() - t1,
          "gpu": gpu, "seconds": time.perf_counter() - t0})
    check(occ is not None and occ[0] == 1.0 and all(b <= a for a, b in zip(occ, occ[1:])),
          f"mesh100k's occupancy line is not a falling fraction: {occ}")


def mlt_phases(dev, gpu):
    """Phase 25, the Metropolis group: scenes/mlt.pbrt through the command
    line against its golden and the long path reference; the MLT estimators
    and the mutation card against CPU; the authored render's rate, launches
    and waves by role (exactly 759 closest hits and 2,484 any hits), busy
    share and peak; the same scene at 256x256 with 65,536 chains (binned
    waves); each kernel on the busiest wave of each MLT role against its
    plain version; the render loop's checkpoint, crop, adaptive and
    occupancy paths. Returns {kernel: launches} over the group's renders
    (parity launches apart)."""
    t_group = time.perf_counter()
    total = dict.fromkeys(MLT_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    # the command line in its own process, while this one holds the
    # estimators against the CPU and warms up (capturing the waves)
    waves = {}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mlt.exr")
        proc = subprocess.Popen([sys.executable, "-m", "grail_torch.cli.main",
                                 _scene_file("mlt"), "--outfile", out], cwd=ROOT,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            mlt_vs_cpu(dev)
            t0 = time.perf_counter()
            scene, meta, api = parse_file(_scene_file("mlt"), device=dev)
            cfg = api.mlt_config
            n_waves = mlt_n_waves(meta, cfg, api.mlt_spp)
            with role_waves(waves):
                mlt.render_mlt(scene, meta, cfg, n_waves=n_waves, device=dev)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            _, log = proc.communicate(timeout=900)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"the command line exited {proc.returncode} on mlt: "
                                    f"{log[-2000:]}")
        img = read_image(out)
    err = relative_mae(img, _golden("mlt"))
    med, q90 = mlt_blocks(img, _golden("mlt_path_reference"))
    emit({"phase": "mlt_cli", "scene": "mlt", "shape": list(img.shape),
          "relative_mae_vs_golden": err, "block_median_vs_path_reference": med,
          "block_q90_vs_path_reference": q90, "log": log.strip().splitlines()[-3:],
          "seconds": time.perf_counter() - t_group})
    check(np.isfinite(img).all() and img.shape == (64, 64, 3) and err < MLT_GOLDEN_RELMAE,
          f"the command line's mlt image is {err} from its golden")
    check(med < MLT_BLOCK_MEDIAN and q90 < MLT_BLOCK_Q90,
          f"the mlt image's blocks are {med} (median) and {q90} (q90) from the path reference")

    # the authored render: 3 timed after the warm-up
    t0 = time.perf_counter()
    mutations = n_waves * cfg.mutations_per_wave * cfg.n_chains
    times, launches, roles, routes = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    for _ in range(3):
        _reset_counts()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = mlt.render_mlt(scene, meta, cfg, n_waves=n_waves, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches.append(_launch_counts())
        roles.append({k: v for k, v in WAVES.items() if v})
        routes.append(dict(CLOSEST_WAVES))
        add(launches[-1])
    peak = torch.cuda.max_memory_allocated(dev)
    wall = statistics.median(times)
    # the busy share of one step of every chain (the state's evaluation, a
    # mutation, its evaluation, both splats): 1/34 of the render's
    # evaluations; the profiler's cost grows with the ~2.3M launches of a
    # whole render
    u = mlt_u(cfg.n_chains, cfg.dim, dev)
    step = dataclasses.replace(cfg, mutations_per_wave=1)

    def one_step():
        mlt._mlt_wave(scene, meta, step, mlt.eval_path_bidir, new_film(meta.xres, meta.yres, dev),
                      u, 0)
        torch.cuda.synchronize()
    one_step()
    t1 = time.perf_counter()
    one_step()
    step_wall = time.perf_counter() - t1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        one_step()
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_ms = sum(e.self_device_time_total for e in kern) / 1e3
    img = img.cpu().numpy()
    expected = dict.fromkeys(launches[0], 0)
    expected.update(MLT_LAUNCHES)
    emit({"phase": "mlt_bench", "scene": "mlt", "res": [meta.xres, meta.yres],
          "mutations_per_pixel": api.mlt_spp, "chains": cfg.n_chains, "waves": n_waves,
          "mutations_per_wave": cfg.mutations_per_wave, "max_depth": cfg.max_depth,
          "bidirectional": cfg.bidirectional, "triangles": meta.n_tris,
          "render_seconds": times, "mutations_per_sec": mutations / wall,
          "launches_per_render": launches, "expected_launches": expected,
          "waves_by_role": roles, "expected_waves_by_role": MLT_WAVES_BY_ROLE,
          "bvh4_closest_by_route": routes, "warm_up_seconds": warm_s,
          "step_seconds": step_wall, "step_device_kernel_ms": kernel_ms,
          "step_device_launches": sum(e.count for e in kern),
          "step_device_busy_share": kernel_ms / (step_wall * 1e3),
          "relative_mae_vs_golden": relative_mae(img, _golden("mlt")),
          "image_mean": float(img.mean()), "peak_memory_bytes": peak,
          "held_before_render_bytes": held, "gpu": gpu, "seconds": time.perf_counter() - t0})
    check(all(n == expected for n in launches),
          f"the mlt renders launched {launches}, want {expected}")
    check(all(r == MLT_WAVES_BY_ROLE for r in roles),
          f"the mlt renders made waves {roles}, want {MLT_WAVES_BY_ROLE}")
    check(all(r == {"binned": 0, "unbinned": 759} for r in routes),
          f"the mlt renders' closest hits took routes {routes}, want all unbinned")
    check(np.isfinite(img).all() and relative_mae(img, _golden("mlt")) < MLT_GOLDEN_RELMAE,
          "the in-process mlt render is off its golden")
    del scene

    # the width run: 16x the chains (and bootstrap samples) at 256x256, the
    # same 4 waves and 69 evaluations, every closest-hit wave binned
    t0 = time.perf_counter()
    text = _scene_text("mlt", (MLT_WIDE_RES, MLT_WIDE_RES)).replace(
        'Renderer "metropolis"',
        f'Renderer "metropolis" "integer bootstrapsamples" [{MLT_WIDE_CHAINS}]')
    scene, meta, api = parse_string(text, device=dev, search_path=os.path.join(ROOT, "scenes"))
    cfg = dataclasses.replace(api.mlt_config, n_chains=MLT_WIDE_CHAINS)
    n_waves = mlt_n_waves(meta, cfg, api.mlt_spp)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img, _ = mlt.render_mlt(scene, meta, cfg, n_waves=n_waves, device=dev)
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t1
    wide = _launch_counts()
    add(wide)
    img = img.cpu().numpy()
    emit({"phase": "mlt_wide", "scene": "mlt", "res": MLT_WIDE_RES, "chains": cfg.n_chains,
          "bootstrap": cfg.n_bootstrap, "waves": n_waves, "render_seconds": wide_s,
          "mutations_per_sec": n_waves * cfg.mutations_per_wave * cfg.n_chains / wide_s,
          "launches_per_render": wide, "bvh4_closest_by_route": dict(CLOSEST_WAVES),
          "waves_by_role": {k: v for k, v in WAVES.items() if v},
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "image_mean": float(img.mean()), "gpu": gpu, "seconds": time.perf_counter() - t0})
    check(np.isfinite(img).all() and img.mean() > 0 and n_waves == 4
          and {k: v for k, v in WAVES.items() if v} == MLT_WAVES_BY_ROLE
          and CLOSEST_WAVES == {"binned": 759, "unbinned": 0},
          "the 65,536-chain render's image, waves or routes are not as expected")
    del scene

    # each kernel on the busiest wave of each MLT role, bitwise
    t0 = time.perf_counter()
    for (kernel, role), (_, tables, rays, kw) in sorted(waves.items(), key=lambda w: w[0]):
        wave_parity("mlt", kernel, role, tables, rays, kw, "mlt_parity")
    for need in MLT_PARITY:
        check(need in waves, f"the mlt render made no {need} wave")
    emit({"phase": "mlt_parity", "cases": [list(k) for k in sorted(waves)],
          "seconds": time.perf_counter() - t0})
    del waves

    _reset_counts()
    mlt_render_loop(dev, gpu)
    add(_launch_counts())
    emit({"phase": "mlt_launches", "launches": total})
    check(all(total[k] > 0 for k in MLT_KERNELS),
          f"a kernel of the Metropolis group's path was not launched: {total}")
    emit({"phase": "mlt", "seconds": time.perf_counter() - t_group})
    return total


def main():
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. environment
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit({"phase": "environment", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": run([build.nvcc_path(), "--version"])
          .splitlines()[-1], "python": sys.version.split()[0]})

    # 2. build every kernel from the sources in this checkout
    t0 = time.perf_counter()
    built = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": sec,
                             "ptxas": [ln.strip() for ln in log.splitlines()
                                       if "entry function" in ln or "Used" in ln
                                       or "spill" in ln]}
                      for name, (sec, log) in built.items()}})

    sass = sass_loop_instructions("brute_intersect")
    emit({"phase": "sass", "kernel": "brute_intersect",
          "loop_instructions": sass if sass is not None else "cuobjdump not available"})
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    issue_rate = sms * LANES_PER_SM * clock_mhz * 1e6

    kernels = cornell_phases(dev, gpu, issue_rate, sass) + mesh_phases(dev, gpu)
    mesh1m_phases(dev, gpu)
    kernels += inst_phases(dev, gpu)
    grad_phases(dev, gpu)
    pbrt_phases(dev, gpu)
    direct = direct_phases(dev, gpu)
    maps = maps_phases(dev, gpu)
    media_launches = media_phases(dev, gpu)
    mlt_launches = mlt_phases(dev, gpu)
    for entry in kernels:
        entry["launches_direct"] = direct.get(entry["name"], 0)
        entry["launches_maps"] = maps.get(entry["name"], 0)
        entry["launches_media"] = media_launches.get(entry["name"], 0)
        entry["launches_mlt"] = mlt_launches.get(entry["name"], 0)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
