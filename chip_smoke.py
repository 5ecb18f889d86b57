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
  6. parity: the two 4-wide kernels against their plain versions at
     1,048,576 rays, bitwise, on each wave they take on the main path:
     closest hit on the bench camera wave (unbinned) and on a binned
     incoherent secondary wave, any hit on shadow rays with random lengths
     and 1/8 dead lanes; and the any hit on the secondary wave (row 3, the
     redesign of the ordered any hit, which a kind override reaches);
  7. main path: a 64x64, 4 spp, depth 3 render on the card against the CPU,
     through the 4-wide route;
  8. bench: the bench render (256x256, 16 spp, depth 5) through the kernels,
     with launches per render of each kernel, the closest hit's split by
     wave (camera, binned);
  9. kernel_time: each of those beside its plain version and its bound
     (its own walk on those rays);
  mesh1m (mesh_scene_1m: 1,001,906 triangles, a thin lens and a moving
  camera, the 4-wide tables above the card's L2):
  10. set-up: the host build and the table sizes;
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
  the film kernel (kernels/csrc/film.cu, engine/film.py::add_samples_grid):
  21. film: tests/test_torch_film_card.py in this process, without the
      tests' conftest (which loads JAX): the kernel bitwise its plain
      version at the render cells' call, at one chunk, on a raster film,
      under the five filter kinds, with and without weights; the backward
      against autograd of the plain version; then the launches of each
      kernel in one render at cornell.path's traffic (256x256, 64 spp,
      path depth 5: one forward a megawave, no backward) and in one
      gradient of the mean image (256x256, 1 spp: one of each); the
      forward's time beside the plain version's and its byte bound at the
      cells' call (256x256, 16 chunks; bitwise the plain version's film;
      the host's time a call of each) and at one chunk, the backward's at
      16 chunks and at one, the training step's call, beside the plain
      version's autograd backward there.
  the sampler kernel (kernels/csrc/sampler.cu, core/rng.py::sample_1d and
  sample_2d):
  22. sampler: tests/test_torch_rng_card.py in this process, without the
      tests' conftest: the kernel bitwise the plain version for each
      sampler kind in 1D and 2D, static, traced and per-lane dims,
      Python-int, int32, expanded and strided operands, STRATIFIED at 12
      and 48 samples, Metropolis's 2-D broadcast and zero lanes; then one
      render at cornell.path's traffic (256x256, 64 spp, path depth 5)
      under torch.profiler: the kernel's launches, which must equal the
      `rng` spans (156, one a call), their lanes, no plain-version call on
      the card and no `sync/sobol_table` span; sample_1d and sample_2d
      (ZERO_TWO, the cells' kind) at a megawave's 1,048,576 lanes of int64
      pixel ids and sample indices, the kernel beside the plain version
      (CUDA events; the host's time a call), bitwise, with the byte bound
      and its share, and each kernel instance's registers.
  the BSDF kernel (kernels/csrc/bsdf.cu, shade/bsdf.py::bsdf_f, bsdf_pdf
  and bsdf_sample):
  22b. bsdf: tests/test_torch_bsdf_card.py in this process, without the
      tests' conftest: the kernel bitwise the plain version for every lobe
      type, MEASURED's tables included, alone and mixed, K = 1 to 4, every
      Fresnel kind, include_specular both ways, strided, expanded and empty
      operands, the sampled slot, and its backward's gradients against the
      plain version's autograd; then one render at mesh100k.path's traffic
      (256x256, 64 spp, path depth 5) under torch.profiler: the kernel's
      launches by route, which must equal the bsdf_eval and bsdf_sample
      spans; a gradient step at cornell.train's shape (256x256, 1 spp, the
      albedos), every BSDF call of it one launch forward and each of its
      backwards one more, timed beside the same step on the plain version,
      with the gradients' largest difference; each route at 1,048,576
      lanes of mesh100k's stack (its material table's LAMBERT and BLINN
      slots), the kernel beside the plain version (CUDA events; the host's
      time a call), bitwise, with the byte bound and its share, and each
      route's registers; and the backward of bsdf_f and bsdf_sample in the
      slots' colours there, kernel beside plain.
  pbrt scene files (scenes/cornell.pbrt, glossy.pbrt, envlight.pbrt, through
  the port's own parser, 4-wide kernels):
  23. pbrt: each scene rendered at its authored settings by the command line
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
  24. direct: the seven goldens of those kinds (nurbs, instances, dof,
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
  25. maps: the four goldens of these features (orthodisk, proctex, bump,
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
  26. media: the three goldens of these features (spotfog, measured,
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
  27. mlt: scenes/mlt.pbrt at its authored settings (64x64, 64 mutations a
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
  the preprocessed group (photon mapping, the irradiance cache, PRT with
  spherical harmonics and radiance probes, instant GI):
  28. preprocessed: the four goldens (photon, irradcache, prtteapot,
      useprobes) through the command line, four processes at once, each EXR
      against its golden, and the photon image against the long path-traced
      reference (energy ratio within 0.18, median 8x8-block error under
      0.3); Renderer "createprobes" through the command line, then
      useprobes.pbrt reading that file through the command line, bitwise
      the render given bake_probes in process at the file's resolution,
      samples and lmax; Renderer "surfacepoints" through the command line
      (4,096 points); each kind (photon, irradiancecache, diffuseprt,
      glossyprt: prtteapot with its integrator line swapped, useprobes,
      and igi on cornell.pbrt) at 32x32, 2 spp on the card against the CPU,
      and igi and photon on the Cornell box preset (brute force, row 1) as
      tests/test_render.py runs them; the six at 256x256, 16 spp (one
      megawave of 1,048,576 camera rays): camera rays/s (median of 3 after
      a warm-up), the preprocess's seconds apart, launches per render of
      each kernel and waves by role against the counts PERF.md predicted,
      the card's busy share under torch.profiler and peak memory; then each
      kernel against its plain version on the card, bitwise, on the busiest
      wave of each (kernel, role), the new roles (photon_shoot,
      final_gather, ic_preprocess, prt_transfer, probe_bake, vpl_path,
      vpl_shadow) among them. TF32 matmuls must stay off.
  the spectral and material-sorted group (core/sampled_spectrum.py,
  shade/megabatch.py, tools/bsdftest.py):
  29. spectral_megabatch: render_spectral (ten 3-band passes, path, depth
      5, 256x256, 16 spp) on the Cornell preset (row 1) and on mesh100k
      (rows 2, 4, 5; its image texture and environment map promoted): the
      host seconds of the promotion and of the band tables apart; the
      colour rows' bands differ from pass to pass and the float rows' do
      not (ROADMAP C.3); exactly ten passes, with ten times an RGB
      render's launches by kernel and waves by role; camera rays/s
      counting xres*yres*spp once (median of 3 after a warm-up); the
      spectral/RGB mean ratio (Cornell within tests/test_spectrum.py's
      0.85-1.1); each at 32x32, 2 spp, card against CPU. Then mat_sort on
      and off at 256x256, 16 spp on the Cornell preset, glossy.pbrt,
      envlight.pbrt and mesh100k, in turns: the sorted visits as
      predicted (one a bounce), the two images bitwise equal (else the
      largest difference, held to tests/test_megabatch.py's atol 1e-5,
      rtol 2e-4), both rates, both renders' launches (equal), the unsorted
      render's busy share, and on the Cornell preset and mesh100k the
      sorted render's with the megabatch stage's device ms a render
      (the program's `megabatch` span); bsdftest on the card (every case
      OK, exit code 0); each kernel against its plain version on the
      busiest wave of each (kernel, role) of the group's renders, bitwise.
  the multi-rank group (grail_torch/dist: sharding.py, scene_shard.py,
  launch.py; photonmap.shoot_photons_sharded, metropolis.render_mlt_sharded,
  entry.py), at world size torch.cuda.device_count() through NCCL: in this
  process on one card, one process a card (dist/launch.py) otherwise; each
  line gives the world size:
  30. sharded: render_sharded on mesh100k (path, depth 5, 256x256, 16 spp),
      fused and not, in turns with render (camera rays/s, median of 3 after
      a warm-up; the image against render's, relative MAE < 1e-3; launches
      per render; the all-reduce's ms on the band film's bytes);
      render_scene_sharded with compact off, on the Cornell box by brute
      force (bitwise the replicated render) and on mesh100k with a 4-wide
      table a shard (within atol 1e-5, rtol 1e-4), in turns with the
      replicated render and the replicated band render, whose launches the
      ring's equal at one rank, with the partition's seconds and the ring's
      transfers; the sharded photon shoot of photon.pbrt bitwise the
      replicated one, and its render against render's; render_mlt_sharded
      on mlt.pbrt (4,096 chains, one wave) against render_mlt; each kernel
      against its plain version, bitwise, on the busiest wave of each
      (kernel, role) of these renders, the ring's local steps among them;
      make_train_step on the Cornell box and mesh100k (256x256, 1 spp,
      depth 5: forward and backward seconds, peak memory, the gradient
      within the grad gate of one card's through render_wave); the entry's
      dry run; each path at 32x32 on the card against the CPU.
Then a {"kernels": [...]} line (each kernel's "launches_direct",
"launches_maps", "launches_media", "launches_mlt",
"launches_preprocessed", "launches_spectral_megabatch" and
"launches_sharded": its launches in the direct, maps, media, Metropolis,
preprocessed, spectral/sorted and multi-rank groups' renders; null for the
film's two kernels, which those groups do not count) and, last,
{"ok": true, "device": {...}}.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""
import collections
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import pytest
import torch

from grail_torch import telemetry
from grail_torch.core import rng as rngmod
from grail_torch.dist import launch, scene_shard
from grail_torch.dist import sharding
from grail_torch.core import sampled_spectrum as ssp
from grail_torch.core import transform as tr
from grail_torch.engine.imageio import read_image
from grail_torch.engine import camera
from grail_torch.engine import film as flm
from grail_torch.engine import filters as flt
from grail_torch.engine.film import develop, new_film
from grail_torch.engine import checkpoint as ckpt
from grail_torch.engine import integrator as integ
from grail_torch.engine import metropolis as mlt
from grail_torch.engine.integrator import WAVES, IntegratorConfig
from grail_torch.engine import subsurface
from grail_torch.engine import photonmap, prt
from grail_torch.engine import render as render_mod
from grail_torch.engine.render import (auto_spp_chunk, camera_rays, megawave_lanes,
                                       occupancy_probe, photon_config, preprocess, render,
                                       render_adaptive, render_wave)
from grail_torch.kernels import brute_intersect as bi
from grail_torch.kernels import bsdf as kbsdf
from grail_torch.kernels import bvh4 as b4
from grail_torch.kernels import build
from grail_torch.kernels import film as kfilm
from grail_torch.kernels import sampler as ksampler
from grail_torch.kernels import instanced
from grail_torch.kernels import intersect as isect
from grail_torch.kernels.binning import (N_RAY_BUCKETS, bin_rays_key, bucket_rank,
                                         sort_by_rank)
from grail_torch.kernels.intersect import BIG_T, CLOSEST_WAVES, SORT_MIN, pack_tris
from grail_torch.scene.buffers import SceneBuilder
from grail_torch.scene.parser import parse_file, parse_string
from grail_torch.scene.presets import cornell_box, mesh_scene, mesh_scene_1m
from grail_torch.scene.shapes import sphere
from grail_torch.shade import bsdf as bx
from grail_torch.shade import media
from grail_torch.shade import megabatch
from grail_torch.shade.lights import AREA, INFINITE
from grail_torch.tools import bsdftest, gen_assets, instbench
from grail_torch.tools.instbench import (N_INST, SPHERE_NU, SPHERE_NV, build_flattened,
                                         build_instanced)
from grail_torch.tools.optimize import optimize_albedo
from grail_torch.entry import dryrun_rank

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
# slab test per box (bvh4.cu): 6 subtracts, 6 multiplies, one
# min and one max per axis (6), 4 min/max across axes, 1 multiply and
# 3 compares
OPS_PER_BOX = 26
RAY_BYTES = 12 + 12 + 4 + 4 + 16   # o, d, tmin, tmax in; t, prim, b1, b2 out
PRIM_AGREE_MIN = 0.999
OCC_AGREE_MIN = 0.9999
RTOL, ATOL = 1e-5, 1e-6
RELMAE_MAX = 1e-3
SLEEP_CYCLES = 100_000_000    # ~50 ms of the card's clock ahead of a timed run
BVH4_SOURCE = "grail_torch/kernels/csrc/bvh4.cu"
# each 4-wide kernel on each main-path wave it takes (mesh_ray_cases) and the
# TPU kernel it replaces there: closest hit on binned secondary waves (the
# ordered kernel), any hit on shadow waves and closest hit on the camera
# wave (the skip-link kernels)
BVH4_WAVES = (("bvh4_closest", "sorted_secondary", "grail/kernels/bvh_stream.py:269"),
              ("bvh4_any_hit", "shadow", "grail/kernels/bvh_stream.py:414"),
              ("bvh4_closest", "camera_wave", "grail/kernels/bvh_stream.py:414"))
# the dispatch's closest-hit route of each wave (intersect.CLOSEST_WAVES)
CLOSEST_ROUTE = {"sorted_secondary": "binned", "camera_wave": "unbinned"}
# row 3: the 4-wide any hit on the secondary wave, the redesign of the
# ordered any hit, which no main-path wave runs (a kind override reaches
# it); not in the kernels line
BVH4_ROW3 = ("bvh4_any_hit", "sorted_secondary", "grail/kernels/bvh_stream.py:269")
# a mesh render of one megawave at depth 5: the camera wave's closest hit
# (unbinned), the binned closest hits of bounces 1-5, one shadow wave a
# bounce, all on the 4-wide kernels
MESH_EXPECTED = {"bvh4_closest": 6, "bvh4_any_hit": 6,
                 "bvh4_closest_roots": 0, "bvh4_any_hit_roots": 0,
                 "brute_intersect": 0, "brute_intersect_any_hit": 0}
MESH_EXPECTED_WAVES = {"binned": 5, "unbinned": 1}
MESH1M_SPP = 4                  # bench.py's mesh1m render: 256x256, 4 spp
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
# the Metropolis group (phase 27): scenes/mlt.pbrt at its authored
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
# the preprocessed group (phase 28): the goldens of photon mapping, the
# irradiance cache, diffuse PRT and radiance probes; the group's renders at
# full width (256x256, 16 spp: one megawave of 1,048,576 camera rays), each
# (name, scene file, the file's integrator line and its replacement or None)
PRE_GOLDENS = ("photon", "irradcache", "prtteapot", "useprobes")
PRE_RES, PRE_SPP = 256, 16
PRE_RENDERS = (
    ("photon", "photon", None), ("irradiancecache", "irradcache", None),
    ("diffuseprt", "prtteapot", None),
    ("glossyprt", "prtteapot", ('SurfaceIntegrator "diffuseprt"',
                                'SurfaceIntegrator "glossyprt"')),
    ("useprobes", "useprobes", None),
    ("igi", "cornell", ('SurfaceIntegrator "path"', 'SurfaceIntegrator "igi"')))
# tests/test_render.py's checks on the Cornell box preset (brute force)
PRE_PRESET = (("preset_igi", IntegratorConfig(kind="igi", max_depth=2, igi_n_paths=32,
                                              igi_n_sets=2, igi_max_depth=3)),
              ("preset_photon", IntegratorConfig(kind="photon", photon_paths=4096,
                                                 photon_radius=0.3)))
PRE_KERNELS = b4.KERNELS + bi.KERNELS
PHOTON_ENERGY, PHOTON_BLOCK_MEDIAN = 0.18, 0.3     # tests/test_render.py:303-330
# the waves of the group's new roles that the renders must hand a kernel
PRE_WAVES = (("bvh4_closest", "photon_shoot"), ("bvh4_closest", "final_gather"),
             ("bvh4_closest", "ic_preprocess"), ("bvh4_any_hit", "ic_preprocess"),
             ("bvh4_any_hit", "prt_transfer"), ("bvh4_any_hit", "probe_bake"),
             ("bvh4_closest", "vpl_path"), ("bvh4_any_hit", "vpl_shadow"))
# the roles traced as any hit (the others are closest hits), and the
# irradiance cache preprocess's shadow rays among its waves
PRE_ANY_ROLES = ("shadow", "occlusion", "prt_transfer", "probe_bake", "vpl_shadow")
PROBE_SPACING = 0.25       # createprobes' "samplespacing": 8 cells an axis of useprobes.pbrt
GRID_SEED = 10
BRUTE_SOURCE = "grail_torch/kernels/csrc/brute_intersect.cu"
SM_RES, SM_SPP = 256, 16          # the spectral and sorted group's renders
SM_CFG = IntegratorConfig(kind="path", max_depth=5)
SM_FILES = ("glossy", "envlight")
SM_KERNELS = bi.KERNELS + b4.KERNELS
SPECTRAL_RATIO = (0.85, 1.1)      # tests/test_spectrum.py: spectral/RGB mean, Cornell
MB_ATOL, MB_RTOL = 1e-5, 2e-4     # tests/test_megabatch.py's tolerance
RAGGED = 37                # rays past 1M in the ragged parity case
NODE_BYTES, TRI_BYTES = 128, 48
# the film kernel (phase 21): its card tests, and the render cells' film call
# (256x256, 16 chunks of the 8x16 tiled pixel order, box filter, no weight)
FILM_CARD_TESTS = "tests/test_torch_film_card.py"
FILM_SOURCE = "grail_torch/kernels/csrc/film.cu"
FILM_RES, FILM_CHUNK = 256, 16
FILM_LANE_BYTES, FILM_PIXEL_BYTES = 20, 32     # sx, sy, L; rgb and weight in and out
# the sampler kernel (phase 22): its card tests, one render at cornell.path's
# traffic (39 sampler calls a megawave, four megawaves), and a draw at a
# megawave's lanes (int64 pixel ids and sample indices, a static dim)
RNG_CARD_TESTS = "tests/test_torch_rng_card.py"
RNG_SOURCE = "grail_torch/kernels/csrc/sampler.cu"
RNG_LANES, RNG_RENDER_CALLS = 1 << 20, 156
RNG_LANE_BYTES = {"sample_1d": 20, "sample_2d": 24}   # pix, samp in; one or two floats out
# the BSDF kernel (phase 22b): its card tests, one render at mesh100k.path's
# traffic, and each route at a megawave's lanes of mesh100k's stack
BSDF_CARD_TESTS = "tests/test_torch_bsdf_card.py"
BSDF_SOURCE = "grail_torch/kernels/csrc/bsdf.cu"
BSDF_LANES = 1 << 20
BSDF_OUT_BYTES = {"f": 12, "pdf": 4, "sample": 30}   # f; pdf; wi, f, pdf, two flags


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
        for counts in (b4.LAUNCHES, bi.LAUNCHES, CLOSEST_WAVES):
            counts.update(dict.fromkeys(counts, 0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches.append(dict(b4.LAUNCHES, **bi.LAUNCHES))
        waves.append(dict(CLOSEST_WAVES))
    return (times, launches, waves, img.cpu().numpy(),
            torch.cuda.max_memory_allocated(dev), held)


def bvh4_phases(scene_name, scene, meta, dev, gpu, waves):
    """Parity and kernel_time of each 4-wide kernel on each wave of `waves`
    ((kernel, wave of mesh_ray_cases, the TPU kernel it replaces) triples):
    bitwise its plain version; its ms beside the plain version's and its
    bound by its own walk on these rays (bvh4_bound). Returns {(kernel,
    wave): its entry of the kernels line}."""
    bvh = scene["bvh"]
    nodes, tris4, stack = (bvh[k] for k in ("bvh4_nodes", "bvh4_tris", "bvh4_stack"))
    table4_bytes = (nodes.numel() + tris4.numel()) * 4
    t0 = time.perf_counter()
    with torch.no_grad():
        cases = mesh_ray_cases(scene, meta, dev)
    results = {}
    for name, wave, _ in waves:
        _, line, results[(name, wave)] = bvh4_parity(scene_name, name, wave, cases[wave],
                                                     bvh)
        emit(line)
    emit({"phase": "parity", "scene": scene_name, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    timed = {}
    for name, wave, replaces in waves:
        any_hit = name == "bvh4_any_hit"
        args = cases[wave]
        with torch.no_grad():
            ms = cuda_ms(lambda: b4.bvh4_traverse(nodes, tris4, *args, any_hit=any_hit,
                                                  stack=stack), 20)
            plain_ms = cuda_ms(lambda: b4.bvh4_traverse_plain(
                nodes, tris4, *args, any_hit=any_hit, stack=stack), 1, warmup=0)
        r = results[(name, wave)]
        counts = r["counts"]
        bound, by = bvh4_bound(counts, table4_bytes)
        emit({"phase": "kernel_time", "scene": scene_name, "kernel": name, "case": wave,
              "rays": N_RAYS, "live_rays": r["live"], "ms": ms, "plain_ms": plain_ms,
              "fill_blocks": b4.fill_blocks(dev.index, any_hit, stack),
              "node_fetches": counts[0], "box_tests": counts[1], "tri_tests": counts[2],
              "bytes_read": counts[0] * NODE_BYTES + counts[2] * TRI_BYTES,
              "table_bytes": table4_bytes, "bound_ms": bound, "bound_by": by,
              "percent_of_bound": 100.0 * bound / ms, "replaces": replaces, "gpu": gpu})
        timed[(name, wave)] = {
            "name": name, "case": wave, "route": "cuda", "source": BVH4_SOURCE,
            "replaces": replaces, "max_abs_err": max(r["errs"].values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None}
    emit({"phase": "kernel_time", "scene": scene_name, "seconds": time.perf_counter() - t0})
    return timed


def mesh_phases(dev, gpu):
    """Phases 6-9; returns the entries of the kernels line: the two bvh4
    kernels on each main-path wave."""
    t0 = time.perf_counter()
    scene, meta, _ = mesh_scene(256, 256, 16, grid=MESH_GRID, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bvh = scene["bvh"]
    nodes, tris4, stack = (bvh[k] for k in ("bvh4_nodes", "bvh4_tris", "bvh4_stack"))
    emit({"phase": "mesh_scene", "scene": "mesh100k", "grid": MESH_GRID,
          "triangles": meta.n_tris, "bvh4_nodes": nodes.shape[0],
          "bvh4_table_bytes": (nodes.numel() + tris4.numel()) * 4,
          "bvh4_stack_bound": stack, "host_build_seconds": build_s})
    timed = bvh4_phases("mesh100k", scene, meta, dev, gpu, BVH4_WAVES + (BVH4_ROW3,))

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
        b4.LAUNCHES.update(dict.fromkeys(b4.LAUNCHES, 0))
        imgs[side] = render(sc, mt, cfg_e, spp=spp_e,
                                  device=where)[0].cpu().numpy()
        if side == "card":
            gpu_launches = dict(b4.LAUNCHES)
    err = relative_mae(imgs["card"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "scene": "mesh100k", "res": res_e,
          "spp": spp_e, "max_depth": 3, "lanes": res_e * res_e * spp_e,
          "sort_min": SORT_MIN, "gpu_launches": gpu_launches, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(res_e * res_e * spp_e // 2 >= SORT_MIN, "comparison wave below SORT_MIN")
    check(gpu_launches == dict(dict.fromkeys(b4.ROOT_KERNELS, 0),
                               **dict.fromkeys(b4.KERNELS, cfg_e.max_depth + 1)),
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

    return [dict(timed[(name, wave)], launches=waves[0][CLOSEST_ROUTE[wave]]
                 if name == "bvh4_closest" else launches[0][name])
            for name, wave, _ in BVH4_WAVES]


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
    cam = scene["camera"]
    emit({"phase": "mesh_scene", "scene": "mesh1m", "grid": 708,
          "triangles": meta.n_tris, "bvh4_nodes": nodes.shape[0],
          "bvh4_node_bytes": nodes.numel() * 4, "bvh4_tri_bytes": tris4.numel() * 4,
          "bvh4_table_bytes": table4_bytes, "bvh4_stack_bound": stack,
          "host_build_seconds": build_s,
          "lens_radius": float(cam["lens_radius"]),
          "focal_distance": float(cam["focal_distance"]),
          "camera_moves": bool(cam["c2w"]["animated"])})
    check(meta.n_tris == 1_001_906 and stack <= b4.STACK_MAX
          and float(cam["lens_radius"]) > 0 and bool(cam["c2w"]["animated"]),
          "mesh1m is not the 1M-triangle DOF and motion-blur scene")
    bvh4_phases("mesh1m", scene, meta, dev, gpu, BVH4_WAVES)

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
        for counts in (bi.LAUNCHES, CLOSEST_WAVES):
            counts.update(dict.fromkeys(counts, 0))
        r = instbench.bench(lambda res, device, s=built[name]: s, 256, INST_SPP,
                            INST_DEPTH, dev)
        del r["build_seconds"]                  # built in phase 15
        other = dict(bi.LAUNCHES)
        rounds = [[s[2] for s in sw] for sw in r["sweeps_per_render"]]
        rates[name] = r["camera_rays_per_sec"]
        emit(dict({"phase": "bench", "scene": f"instbench_{name}", "res": 256,
                   "spp": INST_SPP, "max_depth": INST_DEPTH,
                   "sweep_rounds_per_wave": rounds, "other_launches": other,
                   "seconds": time.perf_counter() - t0, "gpu": gpu}, **r))
        expected_base = dict.fromkeys(b4.KERNELS, INST_DEPTH + 1)
        check(all(v == 0 for v in other.values()),
              f"{name}: a brute-force kernel launched: {other}")
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


class _Outcomes:
    """A pytest plugin: the count of each outcome over the tests' phases
    (a pass counted at the call, anything else where it happened)."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def _reset(counts):
    counts.update(dict.fromkeys(counts, 0))


def film_phases(dev, gpu):
    """Phase 21: the film kernel's card tests in this process (their
    conftest, which loads JAX, skipped); each kernel's launches in a render
    at cornell.path's traffic and in a gradient step; their time beside the
    plain version's at the render cells' film call (16 chunks) and at the
    training step's (one chunk). Returns the kernels line's entries of the
    two kernels."""
    t0 = time.perf_counter()
    outcomes, log = _Outcomes(), io.StringIO()
    with contextlib.redirect_stdout(log):
        code = pytest.main([os.path.join(ROOT, FILM_CARD_TESTS), "--noconftest", "-q",
                            "-p", "no:cacheprovider"], plugins=[outcomes])
    emit({"phase": "film_card_tests", "outcomes": outcomes.counts, "exit_code": int(code),
          "seconds": time.perf_counter() - t0})
    check(code == 0 and set(outcomes.counts) == {"passed"},
          f"the film kernel's card tests: {outcomes.counts}\n{log.getvalue()[-4000:]}")

    # each kernel's launches in one render at cornell.path's traffic, and in
    # one gradient of the mean image (the training step's film call)
    t1 = time.perf_counter()
    scene, meta, _ = cornell_box(FILM_RES, FILM_RES, 64, device=dev)
    cfg = IntegratorConfig(kind="path", max_depth=5)
    _reset(kfilm.LAUNCHES)
    render(scene, meta, cfg, spp=64, device=dev)
    torch.cuda.synchronize()
    launches = {"render": dict(kfilm.LAUNCHES)}
    scene, meta, _ = cornell_box(FILM_RES, FILM_RES, 1, device=dev)
    _reset(kfilm.LAUNCHES)
    scene_grads(scene, meta, {"const": GRAD_LEAVES["cornell"]["const"]}, cfg, dev)
    launches["grad_step"] = dict(kfilm.LAUNCHES)
    del scene
    emit({"phase": "film_launches", "scene": "cornell", "res": FILM_RES,
          "spp": {"render": 64, "grad_step": 1}, "max_depth": cfg.max_depth,
          "launches": launches, "seconds": time.perf_counter() - t1})
    check(launches == {"render": {"film_grid": 4, "film_grid_backward": 0},
                       "grad_step": {"film_grid": 1, "film_grid_backward": 1}},
          f"the film kernels' launches: {launches}, want 4 and 0 a 64-spp render, "
          f"1 and 1 a gradient step")

    # time: the forward at the cells' call (beside the plain version, whose
    # film it must equal bit for bit) and at one chunk; the backward at both,
    # beside autograd of the plain version at one chunk (the training step's)
    fcfg = flt.FilterConfig()
    tile = (flm.TILE_H, flm.TILE_W)
    npix = FILM_RES * FILM_RES
    gen = torch.Generator(device=dev).manual_seed(18)
    px, py = flm.lane_pixel(torch.arange(npix, device=dev), FILM_RES)
    entries = []
    for chunk in (FILM_CHUNK, 1):
        n = chunk * npix
        sx = px.float().repeat(chunk) + torch.rand(n, generator=gen, device=dev)
        sy = py.float().repeat(chunk) + torch.rand(n, generator=gen, device=dev)
        L = torch.rand((n, 3), generator=gen, device=dev)
        film = new_film(FILM_RES, FILM_RES, dev)
        args = (film, fcfg, sx, sy, L, chunk)
        g_rgb = torch.rand((FILM_RES, FILM_RES, 3), generator=gen, device=dev)
        line = {"phase": "film_time", "res": FILM_RES, "chunks": chunk, "lanes": n,
                "bound_ms": (n * FILM_LANE_BYTES + npix * FILM_PIXEL_BYTES) / PEAK_BYTES * 1e3,
                # sx, sy and grad_L a lane; grad_rgb
                "backward_bound_ms": (n * 20 + npix * 12) / PEAK_BYTES * 1e3, "gpu": gpu}
        with torch.no_grad():
            line["kernel_ms"] = cuda_ms(lambda: flm.add_samples_grid(*args, tiled=True), reps=50)
        line["backward_ms"] = cuda_ms(lambda: kfilm.launch_backward(
            fcfg, (FILM_RES, FILM_RES), sx, sy, None, g_rgb, chunk, tile), reps=50)
        if chunk == FILM_CHUNK:
            with torch.no_grad():
                got = flm.add_samples_grid(*args, tiled=True)
                ref = flm.add_samples_grid_plain(*args, tiled=True)
                line["plain_ms"] = cuda_ms(
                    lambda: flm.add_samples_grid_plain(*args, tiled=True), reps=5)
                host = {}
                for name, fn in (("kernel", flm.add_samples_grid),
                                 ("plain", flm.add_samples_grid_plain)):
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    for _ in range(5):
                        fn(*args, tiled=True)
                    torch.cuda.synchronize()
                    host[name] = (time.perf_counter() - t2) / 5 * 1e3
            line["host_ms_per_call"] = host
            line["differing_bits"] = {k: int((got[k].view(torch.int32)
                                              != ref[k].view(torch.int32)).sum())
                                      for k in ("rgb", "weight")}
            check(not any(line["differing_bits"].values()),
                  f"the film kernel's film differs from the plain version's: {line}")
            entries.append({
                "name": "film_grid", "case": "cells_call", "route": "cuda",
                "source": FILM_SOURCE, "replaces": None,
                "launches": launches["render"]["film_grid"],
                "max_abs_err": max(float((got[k] - ref[k]).abs().max()) for k in got),
                "ms": line["kernel_ms"], "plain_ms": line["plain_ms"],
                "bound_ms": line["bound_ms"], "bound_by": "bytes",
                "bound_ms_every_pair": None, "library_ms": None})
            del got, ref
        else:
            Lg = L.clone().requires_grad_()
            out = flm.add_samples_grid_plain(film, fcfg, sx, sy, Lg, chunk, tiled=True)["rgb"]
            line["plain_backward_ms"] = cuda_ms(
                lambda: torch.autograd.grad(out, Lg, g_rgb, retain_graph=True), reps=5)
            ref = torch.autograd.grad(out, Lg, g_rgb)[0]
            got = kfilm.launch_backward(fcfg, (FILM_RES, FILM_RES), sx, sy, None, g_rgb,
                                        chunk, tile)
            entries.append({
                "name": "film_grid_backward", "case": "train_call", "route": "cuda",
                "source": FILM_SOURCE, "replaces": None,
                "launches": launches["grad_step"]["film_grid_backward"],
                "max_abs_err": float((got - ref).abs().max()),
                "ms": line["backward_ms"], "plain_ms": line["plain_backward_ms"],
                "bound_ms": line["backward_bound_ms"], "bound_by": "bytes",
                "bound_ms_every_pair": None, "library_ms": None})
            del Lg, out, got, ref
        line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["kernel_ms"]
        line["backward_pct_of_bound"] = 100.0 * line["backward_bound_ms"] / line["backward_ms"]
        emit(line)
    emit({"phase": "film", "seconds": time.perf_counter() - t0})
    return entries


def ptxas_registers(log):
    """{entry function: registers} from ptxas's -v output (a sampler
    instance's mangled name shortened to sampler_kernel<kind,two>, a BSDF
    one's to bsdf_kernel<route> or bsdf_backward<route>)."""
    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = m.group(1)
            inst = re.search(r"sampler_kernelILi(\d+)ELb(\d)E", fn)
            if inst:
                fn = f"sampler_kernel<{inst.group(1)},{inst.group(2)}>"
            inst = re.search(r"bsdf_(kernel|backward)ILi(\d)E", fn)
            if inst:
                fn = f"bsdf_{inst.group(1)}<{inst.group(2)}>"
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn] = int(m.group(1))
    return out


def sampler_phases(dev, gpu, built):
    """Phase 22: the sampler kernel's card tests in this process (their
    conftest, which loads JAX, skipped); its launches in a render at
    cornell.path's traffic against the `rng` spans there; sample_1d and
    sample_2d at a megawave's lanes beside the plain version, bitwise, with
    their byte bound; the kernel's registers from the build's log (`built`,
    build.build's result). Returns the kernels line's entries."""
    t0 = time.perf_counter()
    outcomes, log = _Outcomes(), io.StringIO()
    with contextlib.redirect_stdout(log):
        code = pytest.main([os.path.join(ROOT, RNG_CARD_TESTS), "--noconftest", "-q",
                            "-p", "no:cacheprovider"], plugins=[outcomes])
    emit({"phase": "sampler_card_tests", "outcomes": outcomes.counts, "exit_code": int(code),
          "seconds": time.perf_counter() - t0})
    check(code == 0 and set(outcomes.counts) == {"passed"},
          f"the sampler kernel's card tests: {outcomes.counts}\n{log.getvalue()[-4000:]}")

    # one launch a sampler call in a render at cornell.path's traffic, no
    # copy of the Sobol table
    t1 = time.perf_counter()
    scene, meta, _ = cornell_box(FILM_RES, FILM_RES, 64, device=dev)
    cfg = IntegratorConfig(kind="path", max_depth=5)
    render(scene, meta, cfg, spp=64, device=dev)
    _reset(ksampler.LAUNCHES)
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        render(scene, meta, cfg, spp=64, device=dev)
        torch.cuda.synchronize()
    rng_spans = [s for s in telemetry.SPANS if s.name == "rng"]
    syncs = collections.Counter(s.name for s in telemetry.SPANS if s.name.startswith("sync/"))
    telemetry.reset()
    del scene
    render_counts = dict(ksampler.LAUNCHES)
    render_launches = sum(render_counts.values())
    line = {"phase": "sampler_launches", "scene": "cornell", "res": FILM_RES, "spp": 64,
            "max_depth": cfg.max_depth, "launches": render_counts,
            "rng_calls": len(rng_spans),
            "rng_lanes": sum(s.lanes for s in rng_spans), "syncs": dict(syncs),
            "seconds": time.perf_counter() - t1}
    emit(line)
    check(render_launches == len(rng_spans) == RNG_RENDER_CALLS
          and "sync/sobol_table" not in syncs,
          f"the sampler's launches in a render: {line}, want {RNG_RENDER_CALLS}, one a "
          f"call, no Sobol-table copy")

    # sample_1d and sample_2d at a megawave's lanes: the kernel beside the
    # plain version, whose draws it must equal bit for bit
    gen = torch.Generator(device=dev).manual_seed(20)
    pix = torch.randint(0, 2**32, (RNG_LANES,), generator=gen, device=dev)
    samp = torch.randint(0, 2**31, (RNG_LANES,), generator=gen, device=dev)
    scfg = rngmod.SamplerConfig(kind=rngmod.ZERO_TWO, spp=64, seed=0x2545F491)
    args = (scfg, pix, samp, 7)
    registers = ptxas_registers(built.get("sampler", (0.0, ""))[1])
    entries = []
    for name, lane_bytes in RNG_LANE_BYTES.items():
        kern, plain = getattr(rngmod, name), getattr(rngmod, name + "_plain")
        got, ref = kern(*args), plain(*args)
        if name == "sample_2d":
            got, ref = torch.stack(got), torch.stack(ref)
        line = {"phase": "sampler_time", "function": name, "kind": "zero_two",
                "lanes": RNG_LANES, "bound_ms": RNG_LANES * lane_bytes / PEAK_BYTES * 1e3,
                "differing_bits": int((got.view(torch.int32) != ref.view(torch.int32)).sum()),
                "kernel_ms": cuda_ms(lambda: kern(*args), reps=50),
                "plain_ms": cuda_ms(lambda: plain(*args), reps=5),
                "registers": {k: v for k, v in registers.items()
                              if k.endswith(f",{int(name == 'sample_2d')}>")}, "gpu": gpu}
        host = {}
        for label, fn in (("kernel", kern), ("plain", plain)):
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for _ in range(10):
                fn(*args)
            torch.cuda.synchronize()
            host[label] = (time.perf_counter() - t2) / 10 * 1e3
        line["host_ms_per_call"] = host
        line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["kernel_ms"]
        emit(line)
        check(line["differing_bits"] == 0,
              f"the sampler kernel's draws differ from the plain version's: {line}")
        entries.append({
            "name": name, "case": "megawave", "route": "cuda", "source": RNG_SOURCE,
            "replaces": None, "launches": render_counts[name],
            "max_abs_err": float((got - ref).abs().max()), "ms": line["kernel_ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"], "bound_by": "bytes",
            "bound_ms_every_pair": None, "library_ms": None})
        del got, ref
    emit({"phase": "sampler", "render_launches": render_launches, "registers": registers,
          "seconds": time.perf_counter() - t0})
    return entries


def _raw_bits(x):
    """A float32 or bool tensor's bits, to compare bit for bit."""
    return x.view(torch.uint8 if x.dtype == torch.bool else torch.int32)


def bsdf_bytes(route, tags, kinds):
    """The bytes one launch of `route` must move on a stack of (N, K) tags
    and Fresnel kinds: every slot's tag; bsdf_pdf a BLINN slot's exponent;
    bsdf_f and bsdf_sample each LAMBERT and BLINN slot's colour, a BLINN
    slot's exponent and Fresnel tag, and a dielectric's ior; wo, and wi or
    the three uniforms; the outputs."""
    lam = int((tags == bx.LAMBERT).sum())
    blinn = tags == bx.BLINN
    fields = 4 * int(blinn.sum())
    if route != "pdf":
        fields = 12 * (lam + int(blinn.sum())) + 8 * int(blinn.sum()) + 4 * int(
            (blinn & (kinds == bx.FR_DIELECTRIC)).sum())
    return 4 * tags.numel() + fields + tags.shape[0] * (24 + BSDF_OUT_BYTES[route])


def bsdf_phases(dev, gpu, built):
    """Phase 22b: the BSDF kernel's card tests in this process (their
    conftest, which loads JAX, skipped); its launches by route in a render
    at mesh100k.path's traffic against the bsdf spans there; each route at a
    megawave's lanes of mesh100k's stack beside the plain version, bitwise,
    with its byte bound and registers (`built`, build.build's result).
    Returns the kernels line's entries."""
    t0 = time.perf_counter()
    outcomes, log = _Outcomes(), io.StringIO()
    with contextlib.redirect_stdout(log):
        code = pytest.main([os.path.join(ROOT, BSDF_CARD_TESTS), "--noconftest", "-q",
                            "-p", "no:cacheprovider"], plugins=[outcomes])
    emit({"phase": "bsdf_card_tests", "outcomes": outcomes.counts, "exit_code": int(code),
          "seconds": time.perf_counter() - t0})
    check(code == 0 and set(outcomes.counts) == {"passed"},
          f"the BSDF kernel's card tests: {outcomes.counts}\n{log.getvalue()[-4000:]}")

    # one launch a BSDF call in a render at mesh100k.path's traffic, none on
    # the plain version
    t1 = time.perf_counter()
    scene, meta, _ = mesh_scene(FILM_RES, FILM_RES, 64, device=dev)
    cfg = IntegratorConfig(kind="path", max_depth=5)
    render(scene, meta, cfg, spp=64, device=dev)
    _reset(kbsdf.LAUNCHES)
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        render(scene, meta, cfg, spp=64, device=dev)
        torch.cuda.synchronize()
    spans = collections.Counter(s.name for s in telemetry.SPANS)
    telemetry.reset()
    render_counts = dict(kbsdf.LAUNCHES)
    line = {"phase": "bsdf_launches", "scene": "mesh100k", "res": FILM_RES, "spp": 64,
            "max_depth": cfg.max_depth, "launches": render_counts,
            "bsdf_eval_spans": spans["bsdf_eval"],
            "bsdf_sample_spans": spans["bsdf_sample"], "seconds": time.perf_counter() - t1}
    emit(line)
    check(render_counts["f"] + render_counts["pdf"] == spans["bsdf_eval"] > 0
          and render_counts["sample"] == spans["bsdf_sample"] > 0,
          f"the BSDF kernel's launches in a render: {line}, want one a call")

    # a gradient step at cornell.train's shape (256x256, 1 spp, the albedos
    # requiring a gradient): every BSDF call one launch forward and one in
    # backward, beside the same step with the plain version on the card
    cscene, cmeta, _ = cornell_box(FILM_RES, FILM_RES, 1, device=dev)
    leaves = {"const": GRAD_LEAVES["cornell"]["const"]}
    step = {}
    for version in ("kernel", "plain", "kernel", "plain"):
        saved = kbsdf.plan
        if version == "plain":
            kbsdf.plan = lambda *a, **k: "cpu"
        _reset(kbsdf.LAUNCHES)
        _reset(kbsdf.BACKWARD)
        try:
            _, grads, fwd_s, bwd_s = scene_grads(cscene, cmeta, leaves, cfg, dev)
        finally:
            kbsdf.plan = saved
        step[version] = {"forward_ms": fwd_s * 1e3, "backward_ms": bwd_s * 1e3,
                         "grad": grads["const"], "launches": dict(kbsdf.LAUNCHES),
                         "backward_launches": dict(kbsdf.BACKWARD)}
    scale = float(step["plain"]["grad"].abs().max())
    line = {"phase": "bsdf_grad_step", "scene": "cornell", "res": FILM_RES, "spp": 1,
            "max_depth": cfg.max_depth,
            "grad_max_rel_diff": float((step["kernel"]["grad"] - step["plain"]["grad"]).abs()
                                       .max()) / max(scale, 1e-30),
            **{f"{version}_{key}": value for version, row in step.items()
               for key, value in row.items() if key != "grad"}, "gpu": gpu}
    emit(line)
    check(step["kernel"]["launches"]["sample"] > 0
          and step["kernel"]["backward_launches"]["sample"] > 0
          and not any(step["plain"]["launches"].values())
          and line["grad_max_rel_diff"] < 1e-4,
          f"a gradient step's BSDF calls: {line}, want every one on the kernel, both ways, "
          "and the plain version's gradient")
    del cscene

    # each route at a megawave's lanes of mesh100k's stack: the material
    # table's rows at random, the kernel beside the plain version, whose
    # values it must equal bit for bit
    gen = torch.Generator(device=dev).manual_seed(22)
    mats = scene["materials"]
    mid = torch.randint(0, mats["lobe_type"].shape[0], (BSDF_LANES,), generator=gen, device=dev)
    tags, kinds = mats["lobe_type"][mid], mats["fr"][mid]
    k = tags.shape[1]

    def rand(*shape):
        return torch.rand((BSDF_LANES,) + shape, generator=gen, device=dev)

    lobes = {"type": tags, "fr": kinds, "R": rand(k, 3), "S1": rand(k, 3), "S2": rand(k, 3),
             "f0": torch.where(tags == bx.BLINN, 12.5, 1.0), "f1": torch.ones_like(rand(k)),
             "f2": torch.full((BSDF_LANES, k), 1.5, device=dev)}
    wo, wi = (torch.nn.functional.normalize(torch.randn((BSDF_LANES, 3), generator=gen,
                                                        device=dev), dim=1) for _ in range(2))
    u = [rand() for _ in range(3)]
    present = meta.lobe_types
    calls = {"f": (lambda f: f(lobes, wo, wi, present, False), bx.bsdf_f, bx.bsdf_f_plain),
             "pdf": (lambda f: f(lobes, wo, wi, present, False), bx.bsdf_pdf,
                     bx.bsdf_pdf_plain),
             "sample": (lambda f: f(lobes, wo, *u, present, True), bx.bsdf_sample,
                        bx.bsdf_sample_plain)}
    registers = ptxas_registers(built.get("bsdf", (0.0, ""))[1])
    entries = []
    del scene
    with torch.no_grad():
        for route, (call, kern, plain) in calls.items():
            got, ref = call(kern), call(plain)
            got, ref = (got, ref) if route == "sample" else ({route: got}, {route: ref})
            differing = {key: int((_raw_bits(got[key]) != _raw_bits(ref[key])).sum())
                         for key in ref}
            line = {"phase": "bsdf_time", "route": route, "lanes": BSDF_LANES,
                    "present": list(present), "slots": k,
                    "bound_ms": bsdf_bytes(route, tags, kinds) / PEAK_BYTES * 1e3,
                    "differing_bits": differing,
                    "kernel_ms": cuda_ms(lambda: call(kern), reps=50),
                    "plain_ms": cuda_ms(lambda: call(plain), reps=5),
                    "registers": registers.get(f"bsdf_kernel<{kbsdf.ROUTES.index(route)}>"),
                    "gpu": gpu}
            host = {}
            for label, fn in (("kernel", kern), ("plain", plain)):
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                for _ in range(10):
                    call(fn)
                torch.cuda.synchronize()
                host[label] = (time.perf_counter() - t2) / 10 * 1e3
            line["host_ms_per_call"] = host
            line["pct_of_bound"] = 100.0 * line["bound_ms"] / line["kernel_ms"]
            emit(line)
            check(not any(differing.values()),
                  f"the BSDF kernel's values differ from the plain version's: {line}")
            entries.append({
                "name": "bsdf_" + route, "case": "megawave", "route": "cuda",
                "source": BSDF_SOURCE, "replaces": None, "launches": render_counts[route],
                "max_abs_err": max(float((got[key].float() - ref[key].float()).abs().max())
                                   for key in ref),
                "ms": line["kernel_ms"], "plain_ms": line["plain_ms"],
                "bound_ms": line["bound_ms"], "bound_by": "bytes",
                "bound_ms_every_pair": None, "library_ms": None})
            del got, ref

    # the backward in the slots' colours (where cornell.train's albedos
    # enter): bsdf_f's and bsdf_sample's forward and vector-Jacobian
    # product, kernel beside plain, the cotangent of f all ones
    colours = lobes["R"]
    for route in ("f", "sample"):
        call, kern, plain = calls[route]

        def vjp(fn):
            lobes["R"] = colours.detach().requires_grad_()
            out = call(fn)
            out = out["f"] if route == "sample" else out
            return torch.autograd.grad(out, lobes["R"], torch.ones_like(out))[0]
        got, ref = vjp(kern), vjp(plain)
        line = {"phase": "bsdf_backward_time", "route": route, "lanes": BSDF_LANES,
                "wrt": "R", "max_rel_diff": float((got - ref).abs().max())
                / max(float(ref.abs().max()), 1e-30),
                "kernel_fwd_bwd_ms": cuda_ms(lambda: vjp(kern), reps=20),
                "plain_fwd_bwd_ms": cuda_ms(lambda: vjp(plain), reps=3),
                "registers": registers.get(f"bsdf_backward<{kbsdf.ROUTES.index(route)}>"),
                "gpu": gpu}
        emit(line)
        check(line["max_rel_diff"] < 1e-5,
              f"the BSDF kernel's gradient differs from the plain version's: {line}")
        del got, ref
    lobes["R"] = colours
    emit({"phase": "bsdf", "render_launches": render_counts, "registers": registers,
          "seconds": time.perf_counter() - t0})
    return entries


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
    """Phase 22: the pbrt scenes through the port's parser and command line."""
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
    inert), the walk with roots among them (the instanced sweep's rounds),
    and the scene-sharded ring's local steps as "ring_<role>"."""
    role = [None]
    trace = integ._trace
    kernels = (isect.bvh4_traverse, instanced.bvh4_traverse, isect.brute_intersect,
               scene_shard.bvh4_traverse, scene_shard.brute_intersect)

    def named(*args, **kw):
        role[0] = kw["role"]
        return trace(*args, **kw)

    def record(kernel, tables, rays, kw, prefix):
        if rays[0].device.type != "cuda":          # the CPU's plain version
            return
        live = int((rays[3] > rays[2]).sum())
        key = (kernel, prefix + role[0])
        if live and live > waves.get(key, (0,))[0]:
            keep = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            waves[key] = (live, tables, tuple(a.detach().clone() for a in rays), keep)

    def walk(fn, prefix=""):
        def run(nodes, tris, o, d, tmin, tmax, any_hit=False, **kw):
            name = (b4.KERNELS if kw.get("roots") is None else b4.ROOT_KERNELS)[int(any_hit)]
            record(name, (nodes, tris), (o, d, tmin, tmax), dict(kw, any_hit=any_hit),
                   prefix)
            return fn(nodes, tris, o, d, tmin, tmax, any_hit, **kw)
        return run

    def brute(fn, prefix=""):
        def run(tris9, o, d, tmin, tmax, any_hit=False):
            record(bi.KERNELS[int(any_hit)], (tris9,), (o, d, tmin, tmax),
                   {"any_hit": any_hit}, prefix)
            return fn(tris9, o, d, tmin, tmax, any_hit)
        return run

    integ._trace = named
    isect.bvh4_traverse, instanced.bvh4_traverse = walk(kernels[0]), walk(kernels[1])
    isect.brute_intersect = brute(kernels[2])
    scene_shard.bvh4_traverse = walk(kernels[3], "ring_")
    scene_shard.brute_intersect = brute(kernels[4], "ring_")
    try:
        yield waves
    finally:
        integ._trace = trace
        (isect.bvh4_traverse, instanced.bvh4_traverse, isect.brute_intersect,
         scene_shard.bvh4_traverse, scene_shard.brute_intersect) = kernels


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
    return dict(b4.LAUNCHES, **bi.LAUNCHES)


def _reset_counts():
    for counts in (b4.LAUNCHES, bi.LAUNCHES, CLOSEST_WAVES, WAVES):
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
    """Phase 26, the Metropolis group: scenes/mlt.pbrt through the command
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


def pre_text(name, file, swap, res=None, spp=None):
    """The group's scene text: the file at res (its own when None) with its
    integrator line swapped where `swap` says."""
    if res is None:
        with open(_scene_file(file)) as f:
            text = f.read()
        if spp is not None:
            text = re.sub(r'"integer pixelsamples" \[\d+\]',
                          f'"integer pixelsamples" [{spp}]', text)
    else:
        text = _scene_text(file, (res, res), spp=spp)
    if swap is not None:
        check(swap[0] in text, f"{file}.pbrt has no {swap[0]}")
        text = text.replace(swap[0], swap[1])
    return text


def pre_expected(cfg, meta):
    """(waves by role, launches of each kernel, closest hits binned and
    unbinned) of one render of one megawave at or above SORT_MIN lanes, as
    PERF.md predicts them: every camera wave a closest hit, binned but
    kind igi's (bounce 0 keeps tile order); direct lighting one shadow wave
    and, with an area or infinite light, one BSDF-branch closest hit."""
    mis = int(bool({AREA, INFINITE} & set(meta.light_types)))
    want = dict.fromkeys(WAVES, 0)
    any_hit, unbinned = 0, 0
    if cfg.kind == "photon":
        pcfg = photon_config(cfg)
        want.update(camera=1, shadow=1, bsdf=mis, photon_shoot=pcfg.max_depth,
                    final_gather=2 if pcfg.final_gather else 0)
        unbinned = pcfg.max_depth                       # 2,048-ray shoots
    elif cfg.kind == "irradiancecache":
        ns = cfg.ic_nsamples
        want.update(camera=1, shadow=1, bsdf=mis, ic_preprocess=1 + ns * (2 + mis))
        any_hit, unbinned = ns, 1 + ns * (1 + mis)      # 256-ray waves
    elif cfg.kind in ("diffuseprt", "glossyprt"):
        want.update(camera=1, prt_transfer=cfg.prt_nsamples)
    elif cfg.kind == "useprobes":
        want.update(camera=1, probe_bake=meta.n_lights * cfg.prt_nsamples)
    elif cfg.kind == "igi":
        bounces = cfg.max_depth + 1
        want.update(camera=1, continuation=bounces - 1, shadow=bounces, bsdf=bounces * mis,
                    vpl_path=cfg.igi_max_depth,
                    vpl_shadow=bounces * cfg.igi_n_paths * cfg.igi_max_depth)
        unbinned = 1 + cfg.igi_max_depth               # the camera wave, 64-ray paths
    any_hit += sum(want[r] for r in PRE_ANY_ROLES)
    closest = sum(want.values()) - any_hit
    launches = {"bvh4_closest": closest, "bvh4_any_hit": any_hit}
    return want, launches, {"binned": closest - unbinned, "unbinned": unbinned}


def _cli(*args):
    return subprocess.Popen([sys.executable, "-m", "grail_torch.cli.main", *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait(procs):
    """Wait for the command-line processes; each must exit 0."""
    try:
        for proc in procs:
            _, log = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"the command line exited {proc.returncode}: "
                                        f"{log[-2000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def pre_cli(dev, gpu):
    """The four goldens through the command line (the photon image also
    against the path reference); meanwhile createprobes and surfacepoints
    through the command line, then useprobes reading the probe file,
    against the in-process bake."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        probes = os.path.join(tmp, "grid.probes")
        base = pre_text("useprobes", "useprobes", None)
        bake, use, out = (os.path.join(tmp, n) for n in ("bake.pbrt", "use.pbrt", "use.pfm"))
        with open(bake, "w") as f:
            f.write(f'Renderer "createprobes" "integer lmax" [3] "integer directsamples" [32] '
                    f'"float samplespacing" [{PROBE_SPACING}] "string filename" "{probes}"\n'
                    + base)
        with open(use, "w") as f:
            f.write(base.replace('SurfaceIntegrator "useprobes"',
                                 f'SurfaceIntegrator "useprobes" "string filename" "{probes}"'))
        points = os.path.join(tmp, "points.txt")
        sp = os.path.join(tmp, "sp.pbrt")
        with open(sp, "w") as f:
            f.write(f'Renderer "surfacepoints" "string filename" "{points}"\n'
                    + pre_text("dipole", "dipole", None))
        side = [_cli(bake), _cli(sp)]
        try:
            pbrt_cli(tmp, PRE_GOLDENS, "preprocessed_cli")
        finally:
            _wait(side)
        img = read_image(os.path.join(tmp, "photon.exr"))
        ref = _golden("photon_path_reference")
        energy = abs(float(img.mean() / ref.mean()) - 1.0)
        med, _ = mlt_blocks(img, ref)
        emit({"phase": "preprocessed_photon_reference", "energy_ratio_off": energy,
              "block_median": med})
        check(energy < PHOTON_ENERGY and med < PHOTON_BLOCK_MEDIAN,
              f"the photon image is off the path reference: {energy}, {med}")

        _wait([_cli(use, "--outfile", out)])
        grid = prt.read_probes(probes, dev)
        res = tuple(grid["coeffs"].shape[:3])
        scene, meta, api = parse_file(use, device=dev)
        baked = prt.bake_probes(scene, meta, api.integrator_config, *res, n_samples=32,
                                lmax=3)
        file_equal = all(torch.equal(grid[k], baked[k]) for k in ("coeffs", "bmin", "bmax"))
        cli_img = read_image(out)
        with mock.patch("grail_torch.engine.render.preprocess",
                        lambda *a: {"probes": baked}):
            own = render(scene, meta, api.integrator_config, device=dev)[0].cpu().numpy()
        with open(points) as f:
            rows = [ln.split() for ln in f if not ln.startswith("#")]
        pts = np.asarray(rows, np.float64)
        emit({"phase": "preprocessed_probes", "grid": list(res), "lmax": grid["lmax"],
              "file_bitwise_bake": file_equal,
              "image_bitwise": bool(np.array_equal(cli_img, own)),
              "image_mean": float(own.mean()), "surface_points": int(pts.shape[0]),
              "gpu": gpu, "seconds": time.perf_counter() - t0})
        check(res == (8, 8, 8) and file_equal and np.array_equal(cli_img, own)
              and own.mean() > 0.0, "createprobes then useprobes is not the in-process bake")
        check(pts.shape == (4096, 7) and np.isfinite(pts).all(),
              f"surfacepoints wrote {pts.shape}")


def pre_vs_cpu(dev):
    """Each kind at 32x32, 2 spp, card against CPU; igi and photon on the
    Cornell box preset (brute force) as tests/test_render.py runs them."""
    for name, file, swap in PRE_RENDERS:
        small_vs_cpu(name, dev, "preprocessed_vs_cpu",
                     text=pre_text(name, file, swap, PBRT_SMALL_RES))
    for name, cfg in PRE_PRESET:
        t0 = time.perf_counter()
        imgs = {}
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            sc, mt, _ = cornell_box(PBRT_SMALL_RES, PBRT_SMALL_RES, 4, device=where)
            imgs[side] = render(sc, mt, cfg, spp=4, device=where)[0].cpu().numpy()
        err = relative_mae(imgs["card"], imgs["cpu"])
        emit({"phase": "preprocessed_vs_cpu", "scene": name, "kind": cfg.kind,
              "res": PBRT_SMALL_RES, "spp": 4, "relative_mae": err,
              "image_mean": float(imgs["card"].mean()), "seconds": time.perf_counter() - t0})
        check(np.isfinite(imgs["card"]).all() and err < RELMAE_MAX,
              f"{name} on the card differs from the CPU ({err})")


def preprocessed_phases(dev, gpu):
    """Phase 27, the preprocessed group: the goldens and the probe files
    through the command line, each kind card against CPU, the six renders
    at full width (rate, preprocess seconds, launches and waves by role
    against PERF.md's prediction, busy share, peak), and each kernel on the
    busiest wave of each (kernel, role) against its plain version. Returns
    {kernel: launches} over the group's renders (parity launches apart)."""
    t_group = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the cache's and PRT's contractions would lose 13 bits")
    total = dict.fromkeys(PRE_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    pre_cli(dev, gpu)
    waves = {}
    with role_waves(waves):
        _reset_counts()
        pre_vs_cpu(dev)
        add(_launch_counts())
        for name, file, swap in PRE_RENDERS:
            t0 = time.perf_counter()
            scene, meta, api = parse_string(pre_text(name, file, swap, PRE_RES, PRE_SPP),
                                            device=dev, search_path=os.path.join(ROOT, "scenes"))
            cfg = api.integrator_config
            check(cfg.kind == name, f"{file} parsed as {cfg.kind}, want {name}")
            want, want_launches, want_routes = pre_expected(cfg, meta)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            preprocess(scene, meta, cfg)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t1
            times, launches, roles, routes = [], [], [], []
            render(scene, meta, cfg, spp=PRE_SPP, device=dev)    # the warm-up captures waves
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            for _ in range(3):
                _reset_counts()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                img, _ = render(scene, meta, cfg, spp=PRE_SPP, device=dev)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                launches.append(_launch_counts())
                roles.append(dict(WAVES))
                routes.append(dict(CLOSEST_WAVES))
                add(launches[-1])
            peak = torch.cuda.max_memory_allocated(dev)
            wall = statistics.median(times)
            kernel_ms, n_launch, busy = busy_share(scene, meta, cfg, PRE_SPP, dev, wall)
            img = img.cpu().numpy()
            expected = dict.fromkeys(launches[0], 0)
            expected.update(want_launches)
            emit({"phase": "preprocessed_bench", "render": name, "scene": file,
                  "kind": cfg.kind, "res": PRE_RES, "spp": PRE_SPP,
                  "max_depth": cfg.max_depth, "triangles": meta.n_tris,
                  "light_types": list(meta.light_types), "render_seconds": times,
                  "preprocess_seconds": pre_s,
                  "camera_rays_per_sec": PRE_RES * PRE_RES * PRE_SPP / wall,
                  "launches_per_render": launches, "expected_launches": expected,
                  "waves": {k: v for k, v in roles[0].items() if v},
                  "expected_waves": {k: v for k, v in want.items() if v},
                  "bvh4_closest_by_route": routes[0], "expected_routes": want_routes,
                  "device_kernel_ms": kernel_ms, "device_launches": n_launch,
                  "device_busy_share": busy, "image_mean": float(img.mean()),
                  "peak_memory_bytes": peak, "held_before_render_bytes": held, "gpu": gpu,
                  "seconds": time.perf_counter() - t0})
            check(all(r == want for r in roles), f"{name} made waves {roles[0]}, want {want}")
            check(all(n == expected for n in launches),
                  f"{name} renders launched {launches}, want {expected}")
            check(all(r == want_routes for r in routes),
                  f"{name}'s closest hits took routes {routes[0]}, want {want_routes}")
            check(np.isfinite(img).all() and img.shape == (PRE_RES, PRE_RES, 3)
                  and img.mean() > 0.0, f"{name}'s image is not finite and positive")
            del scene

    emit({"phase": "preprocessed_launches", "launches": total})
    check(all(total[k] > 0 for k in PRE_KERNELS),
          f"a kernel of the preprocessed path was not launched: {total}")
    t0 = time.perf_counter()
    for (kernel, role), (_, tables, rays, kw) in sorted(waves.items(), key=lambda w: w[0]):
        wave_parity("preprocessed", kernel, role, tables, rays, kw, "preprocessed_parity")
    for need in PRE_WAVES:
        check(need in waves, f"the preprocessed group's renders made no {need} wave")
    emit({"phase": "preprocessed_parity", "cases": [list(k) for k in sorted(waves)],
          "seconds": time.perf_counter() - t0})
    del waves
    emit({"phase": "preprocessed", "seconds": time.perf_counter() - t_group})
    return total


def _sm_scenes(dev):
    """The group's scenes at SM_RES, SM_SPP: (name, scene, meta, cfg)."""
    scene, meta, _ = cornell_box(SM_RES, SM_RES, SM_SPP, device=dev)
    yield "cornell", scene, meta, SM_CFG
    for name in SM_FILES:
        scene, meta, api = parse_string(_scene_text(name, (SM_RES, SM_RES), spp=SM_SPP),
                                        device=dev, search_path=os.path.join(ROOT, "scenes"))
        cfg = api.integrator_config
        check(cfg.kind == "path", f"{name}.pbrt parsed as {cfg.kind}")
        yield name, scene, meta, cfg


def sorted_profile(scene, meta, cfg, spp, dev, wall):
    """(kernel ms, launches, busy share, the megabatch stage's kernel ms) of
    one render under torch.profiler: the sorted pass is the program's
    `megabatch` span (grail_torch/telemetry.py), whose range is
    "grail:megabatch"."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
    telemetry.reset()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith(telemetry.PREFIX)]
    kernel_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    stage = sum(e.device_time_total for e in events
                if e.key == telemetry.PREFIX + "megabatch"
                and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    return kernel_ms, sum(e.count for e in kernels), kernel_ms / (wall * 1e3), stage


def _sm_reset():
    _reset_counts()
    megabatch.STATS.update(dict.fromkeys(megabatch.STATS, 0))


def spectral_bench(name, scene, meta, dev, gpu, add):
    """One scene's spectral render at full size: promotion and band tables
    apart, the C.3 check, passes, launches and waves against an RGB
    render's, camera rays/s, the mean ratio."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    src = ssp._promoted_sources(scene, meta)
    torch.cuda.synchronize()
    promote_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    bands = [ssp._band_scene(scene, src, g) for g in range(ssp.N_PASSES)]
    torch.cuda.synchronize()
    band_s = time.perf_counter() - t1
    const = scene["tex_data"]["const"]
    rows = ssp.colour_rows(meta)
    float_rows = sorted(set(range(const.shape[0])) - rows)
    passes = torch.stack([b["tex_data"]["const"] for b in bands])        # (10, R, 3)
    float_same = bool(torch.equal(passes[:, float_rows], const[float_rows].expand(
        ssp.N_PASSES, len(float_rows), 3)))
    lit = [r for r in sorted(rows) if bool(const[r].abs().sum() > 0)]
    colour_vary = sum(int(bool((passes[:, r] != passes[0, r]).any())) for r in lit)
    del bands, passes

    _sm_reset()
    rgb, _ = render(scene, meta, SM_CFG, spp=SM_SPP, device=dev)
    want_launches = {k: ssp.N_PASSES * v for k, v in _launch_counts().items()}
    want_waves = {k: ssp.N_PASSES * v for k, v in WAVES.items()}
    ssp.render_spectral(scene, meta, SM_CFG, spp=SM_SPP)       # warm-up
    torch.cuda.synchronize()
    times, launches, waves, n_pass = [], [], [], []
    counted = render_mod.render

    def counting(*a, **kw):
        n_pass[-1] += 1
        return counted(*a, **kw)

    with mock.patch.object(render_mod, "render", counting):
        for _ in range(3):
            _sm_reset()
            n_pass.append(0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            img, films = ssp.render_spectral(scene, meta, SM_CFG, spp=SM_SPP)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            launches.append(_launch_counts())
            waves.append(dict(WAVES))
            add(launches[-1])
    wall = statistics.median(times)
    img, rgb = img.cpu().numpy(), rgb.cpu().numpy()
    ratio = float(img.mean() / rgb.mean())
    emit({"phase": "spectral_bench", "scene": name, "res": SM_RES, "spp": SM_SPP,
          "max_depth": SM_CFG.max_depth, "triangles": meta.n_tris,
          "images": meta.n_images, "env_map": meta.has_env_map,
          "colour_rows": len(rows), "float_rows": float_rows,
          "colour_rows_varying": colour_vary, "colour_rows_nonzero": len(lit),
          "float_rows_same_every_pass": float_same,
          "host_promotion_seconds": promote_s, "host_band_tables_seconds": band_s,
          "render_seconds": times, "passes": n_pass, "films": len(films),
          "camera_rays_per_sec": SM_RES * SM_RES * SM_SPP / wall,
          "launches_per_render": launches, "expected_launches": want_launches,
          "waves": {k: v for k, v in waves[0].items() if v},
          "expected_waves": {k: v for k, v in want_waves.items() if v},
          "spectral_over_rgb_mean": ratio, "image_mean": float(img.mean()),
          "rgb_mean": float(rgb.mean()), "gpu": gpu, "seconds": time.perf_counter() - t0})
    check(float_same and colour_vary == len(lit) and lit,
          f"{name}: the band tables break C.3 ({colour_vary}/{len(lit)} colour rows vary, "
          f"float rows the same: {float_same})")
    check(all(n == ssp.N_PASSES for n in n_pass) and len(films) == ssp.N_PASSES,
          f"{name}: {n_pass} passes a spectral render")
    check(all(n == want_launches for n in launches) and all(w == want_waves for w in waves),
          f"{name}: a spectral render launched {launches[0]} ({waves[0]}), want ten times "
          f"an RGB render's")
    check(np.isfinite(img).all() and img.shape == (SM_RES, SM_RES, 3) and img.mean() > 0.0,
          f"{name}: the spectral image is not finite and positive")
    if name == "cornell":
        check(SPECTRAL_RATIO[0] < ratio < SPECTRAL_RATIO[1],
              f"the Cornell box's spectral/RGB mean ratio {ratio}")


def spectral_vs_cpu(name, make, dev):
    """render_spectral at 32x32, 2 spp, card against CPU."""
    t0 = time.perf_counter()
    imgs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        scene, meta = make(where)
        imgs[side] = ssp.render_spectral(scene, meta, SM_CFG,
                                         spp=PBRT_SMALL_SPP)[0].cpu().numpy()
    err = relative_mae(imgs["card"], imgs["cpu"])
    emit({"phase": "spectral_vs_cpu", "scene": name, "res": PBRT_SMALL_RES,
          "spp": PBRT_SMALL_SPP, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["card"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(np.isfinite(imgs["card"]).all() and err < RELMAE_MAX,
          f"{name}'s spectral image on the card differs from the CPU ({err})")


def megabatch_bench(name, scene, meta, cfg, dev, gpu, add, profile_sorted=False):
    """mat_sort off and on in turns at full size: visits, images, rates,
    launches, the unsorted render's busy share, and (profile_sorted) the
    sorted render's with its pass's device ms, from a profile that records
    the host's operators too (60-90 s a scene: the profiler's cost grows
    with the sorted render's 70-170k launches)."""
    t0 = time.perf_counter()
    cfgs = {"off": dataclasses.replace(cfg, mat_sort=False),
            "on": dataclasses.replace(cfg, mat_sort=True)}
    waves_a_render = -(-SM_SPP // auto_spp_chunk(meta, SM_SPP))
    want_visits = {"off": 0, "on": (cfg.max_depth + 1) * waves_a_render}
    for c in cfgs.values():
        render(scene, meta, c, spp=SM_SPP, device=dev)             # warm-ups
    torch.cuda.synchronize()
    times = {k: [] for k in cfgs}
    launches = {k: [] for k in cfgs}
    stats = {k: [] for k in cfgs}
    imgs = {}
    for _ in range(3):
        for k, c in cfgs.items():
            _sm_reset()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            img, _ = render(scene, meta, c, spp=SM_SPP, device=dev)
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t1)
            launches[k].append(_launch_counts())
            stats[k].append(dict(megabatch.STATS))
            imgs[k] = img.cpu().numpy()
            add(launches[k][-1])
    t_timed = time.perf_counter() - t0
    t1 = time.perf_counter()
    busy = {"off": busy_share(scene, meta, cfgs["off"], SM_SPP, dev,
                              statistics.median(times["off"])),
            "on": ("not measured (profiled on cornell and mesh100k)",) * 3}
    mb_ms = busy["on"][0]
    if profile_sorted:
        *busy["on"], mb_ms = sorted_profile(scene, meta, cfgs["on"], SM_SPP, dev,
                                            statistics.median(times["on"]))
    equal = bool(np.array_equal(imgs["on"], imgs["off"]))
    diff = float(np.abs(imgs["on"] - imgs["off"]).max())
    emit({"phase": "megabatch_bench", "scene": name, "res": SM_RES, "spp": SM_SPP,
          "max_depth": cfg.max_depth, "materials": len(meta.mat_specs),
          "lobe_types": list(meta.lobe_types), "mat_block": cfg.mat_block,
          "visits": [st["visits"] for st in stats["on"]],
          "expected_visits": want_visits["on"], "chunks": stats["on"][0]["chunks"],
          "sorted_lanes": stats["on"][0]["lanes"],
          "render_seconds": times,
          "camera_rays_per_sec": {k: SM_RES * SM_RES * SM_SPP / statistics.median(v)
                                  for k, v in times.items()},
          "launches_per_render": {k: v[0] for k, v in launches.items()},
          "device_kernel_ms": {k: v[0] for k, v in busy.items()},
          "device_launches": {k: v[1] for k, v in busy.items()},
          "device_busy_share": {k: v[2] for k, v in busy.items()},
          "megabatch_device_ms": mb_ms, "bitwise_equal": equal, "max_abs_diff": diff,
          "image_mean": float(imgs["off"].mean()), "gpu": gpu,
          "renders_seconds": t_timed, "profiles_seconds": time.perf_counter() - t1,
          "seconds": time.perf_counter() - t0})
    for k in cfgs:
        check(all(st["visits"] == want_visits[k] for st in stats[k]),
              f"{name} mat_sort {k}: sorted visits {stats[k]}, want {want_visits[k]}")
    check(all(n == launches["off"][0] for n in launches["on"] + launches["off"]),
          f"{name}: the sorted render launched {launches['on']}, the unsorted "
          f"{launches['off']}")
    check(np.isfinite(imgs["on"]).all() and imgs["off"].mean() > 0.0
          and (equal or np.allclose(imgs["on"], imgs["off"], atol=MB_ATOL, rtol=MB_RTOL)),
          f"{name}: the sorted image differs from the unsorted by {diff}")


def spectral_megabatch_phases(dev, gpu):
    """Phase 28: spectral renders, material-sorted shading, bsdftest on the
    card, and each kernel on the busiest wave of each (kernel, role) of the
    group's renders against its plain version. Returns {kernel: launches}
    over the group's renders (parity launches apart)."""
    t_group = time.perf_counter()
    total = dict.fromkeys(SM_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    waves = {}
    with role_waves(waves):
        cornell = cornell_box(SM_RES, SM_RES, SM_SPP, device=dev)
        spectral_bench("cornell", cornell[0], cornell[1], dev, gpu, add)
        t0 = time.perf_counter()
        mesh, mesh_meta, _ = mesh_scene(SM_RES, SM_RES, SM_SPP, grid=MESH_GRID, device=dev)
        emit({"phase": "spectral_mesh_scene", "seconds": time.perf_counter() - t0})
        spectral_bench("mesh100k", mesh, mesh_meta, dev, gpu, add)
        _reset_counts()
        spectral_vs_cpu("cornell", lambda where: cornell_box(
            PBRT_SMALL_RES, PBRT_SMALL_RES, PBRT_SMALL_SPP, device=where)[:2], dev)
        spectral_vs_cpu("mesh100k", lambda where: mesh_scene(
            PBRT_SMALL_RES, PBRT_SMALL_RES, PBRT_SMALL_SPP, grid=MESH_GRID,
            device=where)[:2], dev)
        add(_launch_counts())
        for name, scene, meta, cfg in _sm_scenes(dev):
            megabatch_bench(name, scene, meta, cfg, dev, gpu, add,
                            profile_sorted=name == "cornell")
            del scene
        megabatch_bench("mesh100k", mesh, mesh_meta, SM_CFG, dev, gpu, add,
                        profile_sorted=True)
        del mesh, cornell

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bsdftest.run(device=dev)
    lines = out.getvalue().splitlines()
    emit({"phase": "bsdftest", "exit_code": rc, "lines": lines,
          "seconds": time.perf_counter() - t0})
    check(rc == 0 and len(lines) == len(bsdftest.CASES)
          and all(ln.startswith("OK") for ln in lines), f"bsdftest on the card: {lines}")

    emit({"phase": "spectral_megabatch_launches", "launches": total})
    check(all(total[k] > 0 for k in SM_KERNELS),
          f"a kernel of the spectral and sorted path was not launched: {total}")
    t0 = time.perf_counter()
    for (kernel, role), (_, tables, rays, kw) in sorted(waves.items(), key=lambda w: w[0]):
        wave_parity("spectral_megabatch", kernel, role, tables, rays, kw,
                    "spectral_megabatch_parity")
    emit({"phase": "spectral_megabatch_parity", "cases": [list(k) for k in sorted(waves)],
          "seconds": time.perf_counter() - t0})
    del waves
    emit({"phase": "spectral_megabatch", "seconds": time.perf_counter() - t_group})
    return total


SHARD_RES, SHARD_SPP = 256, 16     # the sharded group's full-width renders
SHARD_CFG = IntegratorConfig(kind="path", max_depth=5)
SHARD_KERNELS = bi.KERNELS + b4.KERNELS
STREAM_ATOL, STREAM_RTOL = 1e-5, 1e-4   # the 4-wide ring: tests/test_scene_shard.py's
MLT_ATOL, MLT_RTOL = 1e-4, 1e-3         # chains over ranks: tests/test_sharding.py's
SHARD_TIMEOUT_S = 900


def in_turns(fns, reps=3, warmup=True):
    """A warm-up of each fn, then reps rounds calling each in turn, timed to
    a synchronize: {name: (seconds, launches of the first timed call, last
    result)}."""
    for fn in fns.values() if warmup else ():
        fn()
    torch.cuda.synchronize()
    out = {name: ([], None, None) for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times, launches, _ = out[name]
            out[name] = (times + [time.perf_counter() - t0],
                         launches or _launch_counts(), res)
    return out


def _rays_per_sec(meta, spp, times):
    return meta.xres * meta.yres * spp / statistics.median(times)


def _l2_grads(scene, meta, cfg, dev, target):
    """The training loss's tex_data gradient through one full-grid wave on
    this card alone (the grad phase's path: render_wave, dense film)."""
    params = sharding._requiring_grad(scene["tex_data"])
    film = render_wave(dict(scene, tex_data=params), meta, cfg,
                       new_film(meta.xres, meta.yres, dev), 0, device=dev)
    loss = torch.mean((develop(film) - target) ** 2)
    leaves = [params["const"], params["w2t"]]
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(x) if g is None else g
                         for k, x, g in zip(("const", "w2t"), leaves, got)}


def _within_gate(got, ref):
    tol = GRAD_ATOL * float(ref.abs().max())
    return bool(torch.isfinite(got).all()) and bool(
        torch.allclose(got, ref, rtol=GRAD_RTOL, atol=tol)), float((got - ref).abs().max())


def shard_train(mesh, say, name, make):
    """make_train_step at 256x256, 1 spp, depth 5: forward and backward
    seconds (the backward: the step's autograd.grad call), peak memory, and
    the gradient against the single-card gradient of the same loss."""
    dev = mesh.device
    scene, meta, _ = make(SHARD_RES, SHARD_RES, 1, device=dev)
    target = torch.zeros((meta.yres, meta.xres, 3), device=dev)
    step = sharding.make_train_step(meta, SHARD_CFG, mesh)
    step(scene, target, 0)
    grad_fn, marks = torch.autograd.grad, []

    def timed_grad(*args, **kw):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        out = grad_fn(*args, **kw)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        return out

    _reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(sharding.torch.autograd, "grad", timed_grad):
        loss, grads = step(scene, target, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = _launch_counts()
    loss_1, ref = _l2_grads(scene, meta, SHARD_CFG, dev, target)
    gate = {k: _within_gate(grads["tex_data"][k], ref[k]) for k in ref}
    say({"phase": "sharded_train", "scene": name, "world_size": mesh.world_size,
         "res": SHARD_RES, "spp": 1, "max_depth": SHARD_CFG.max_depth,
         "loss": float(loss), "loss_single_card": loss_1,
         "forward_seconds": marks[0] - t0, "backward_seconds": marks[1] - marks[0],
         "step_seconds": t1 - t0, "peak_memory_bytes": peak, "launches": launches,
         "max_abs_diff_vs_single_card": {k: g[1] for k, g in gate.items()},
         "within_gate": {k: g[0] for k, g in gate.items()}})
    check(all(g[0] for g in gate.values()) and bool((grads["tex_data"]["const"] != 0).any()),
          f"the sharded {name} training step's gradient is outside the gate: {gate}")
    check(abs(float(loss) - loss_1) <= 1e-4 * abs(loss_1),
          f"the sharded {name} loss {float(loss)} differs from one card's {loss_1}")


def shard_ring(mesh, say, gpu, name, scene, meta, stream, add):
    """render_scene_sharded at SHARD_RES, SHARD_SPP, depth 5, compact=False:
    rate (each render partitions the scene; the partition's seconds alone
    too), the image against the replicated render's, launches against the
    replicated band render's (render_sharded, the same waves)."""
    dev = mesh.device
    cfg = dataclasses.replace(SHARD_CFG, compact=False)
    t0 = time.perf_counter()
    scene_shard.partition_scene(scene, mesh.world_size, stream=stream)
    torch.cuda.synchronize()
    part_s = time.perf_counter() - t0
    scene_shard.STATS.update(passes=0, bytes=0)
    runs = in_turns({
        "replicated": lambda: render(scene, meta, cfg, spp=SHARD_SPP, device=dev)[0],
        "band": lambda: sharding.render_sharded(scene, meta, cfg, SHARD_SPP, mesh)[0],
        "ring": lambda: sharding.render_scene_sharded(scene, meta, cfg, SHARD_SPP, mesh,
                                                      stream=stream)[0]})
    passes = dict(scene_shard.STATS)
    rep, ring_img = runs["replicated"][2].cpu().numpy(), runs["ring"][2].cpu().numpy()
    bitwise = bool(np.array_equal(ring_img, rep))
    close = bool(np.allclose(ring_img, rep, atol=STREAM_ATOL, rtol=STREAM_RTOL))
    launches = runs["ring"][1]
    say({"phase": "sharded_ring", "scene": name, "world_size": mesh.world_size,
         "local_step": "bvh4" if stream else "brute_force", "res": SHARD_RES,
         "spp": SHARD_SPP, "max_depth": cfg.max_depth, "compact": False,
         "partition_seconds": part_s,
         "render_seconds": {k: v[0] for k, v in runs.items()},
         "camera_rays_per_sec": {k: _rays_per_sec(meta, SHARD_SPP, v[0])
                                 for k, v in runs.items()},
         "launches_per_render": {k: v[1] for k, v in runs.items()},
         "ring_passes_and_bytes_sent": passes, "bitwise_equal_vs_replicated": bitwise,
         "max_abs_diff_vs_replicated": float(np.abs(ring_img - rep).max()),
         "image_mean": float(ring_img.mean()), "gpu": gpu})
    check(bitwise if not stream else close,
          f"the {name} ring render differs from the replicated render")
    check(mesh.world_size > 1 or launches == runs["band"][1],
          f"the {name} ring launched {launches}, the band render {runs['band'][1]}")
    add(launches)


def shard_vs_cpu(mesh, say):
    """Each sharded path at 32x32 on the card against the CPU (a lone CPU
    rank): relative MAE < RELMAE_MAX; the training step's gradients within
    the gate."""
    cpu = sharding.Mesh(1, 0, torch.device("cpu"))
    cfg3 = IntegratorConfig(kind="path", max_depth=3)
    ring_cfg = dataclasses.replace(cfg3, compact=False)
    photon_cfg = IntegratorConfig(kind="photon", max_depth=3, photon_paths=1024,
                                  photon_radius=0.3)
    mlt_cfg = mlt.MLTConfig(max_depth=3, n_chains=256, n_bootstrap=256,
                            mutations_per_wave=4)
    res, spp = PBRT_SMALL_RES, PBRT_SMALL_SPP

    def mesh100k(where):
        return mesh_scene(res, res, spp, grid=MESH_GRID, device=where)[:2]

    def cornell(where, **kw):
        return cornell_box(res, res, spp, device=where, **kw)[:2]

    paths = {
        "render_sharded": lambda m: sharding.render_sharded(
            *mesh100k(m.device), cfg3, spp, m)[0],
        "ring_brute": lambda m: sharding.render_scene_sharded(
            *cornell(m.device), ring_cfg, spp, m)[0],
        "ring_stream": lambda m: sharding.render_scene_sharded(
            *cornell(m.device), ring_cfg, spp, m, stream=True)[0],
        "photon_sharded": lambda m: sharding.render_sharded(
            *cornell(m.device), photon_cfg, spp, m)[0],
        "mlt_sharded": lambda m: mlt.render_mlt_sharded(
            *cornell(m.device, with_boxes=False), mlt_cfg, 1, m)[0],
    }
    for name, run_path in paths.items():
        t0 = time.perf_counter()
        card, host = run_path(mesh).cpu().numpy(), run_path(cpu).numpy()
        err = relative_mae(card, host)
        say({"phase": "sharded_vs_cpu", "path": name, "world_size": mesh.world_size,
             "res": res, "relative_mae": err, "seconds": time.perf_counter() - t0})
        check(np.isfinite(card).all() and card.mean() > 0 and err < RELMAE_MAX,
              f"sharded path {name} on the card differs from the CPU ({err})")
    t0 = time.perf_counter()
    got = {}
    for side, m in (("card", mesh), ("cpu", cpu)):
        scene, meta = cornell(m.device)
        target = torch.zeros((meta.yres, meta.xres, 3), device=m.device)
        got[side] = sharding.make_train_step(meta, cfg3, m)(scene, target, 0)[1]["tex_data"]
    gate = {k: _within_gate(got["card"][k].cpu(), got["cpu"][k]) for k in got["cpu"]}
    say({"phase": "sharded_vs_cpu", "path": "train_step", "world_size": mesh.world_size,
         "res": res, "max_abs_diff": {k: g[1] for k, g in gate.items()},
         "seconds": time.perf_counter() - t0})
    check(all(g[0] for g in gate.values()),
          f"the training step's gradient on the card differs from the CPU's: {gate}")


def sharded_rank(mesh, gpu):
    """Phase 29 on one rank (every rank runs it; rank 0 prints). Returns
    {kernel: launches} over the phase's renders (parity launches apart)."""
    say = emit if mesh.rank == 0 else (lambda obj: None)
    dev = mesh.device
    total = dict.fromkeys(SHARD_KERNELS, 0)

    def add(launches):
        for k in total:
            total[k] += launches[k]

    waves = {}
    with role_waves(waves):
        # the band render on mesh100k, fused and not, in turns with render
        t0 = time.perf_counter()
        scene, meta, _ = mesh_scene(SHARD_RES, SHARD_RES, SHARD_SPP, grid=MESH_GRID,
                                    device=dev)
        runs = in_turns({
            "render": lambda: render(scene, meta, SHARD_CFG, spp=SHARD_SPP, device=dev)[0],
            "fused": lambda: sharding.render_sharded(scene, meta, SHARD_CFG, SHARD_SPP,
                                                     mesh)[0],
            "unfused": lambda: sharding.render_sharded(scene, meta, SHARD_CFG, SHARD_SPP,
                                                       mesh, fused=False)[0]})
        ref = runs["render"][2].cpu().numpy()
        errs = {k: relative_mae(runs[k][2].cpu().numpy(), ref) for k in ("fused", "unfused")}
        rows, margin, _ = sharding._band_layout(meta, mesh.world_size)
        buf = torch.zeros((mesh.world_size * rows + 2 * margin) * meta.xres * 7, device=dev)
        reduce_ms = cuda_ms(lambda: mesh.all_reduce(buf), 20)
        say({"phase": "sharded_render", "scene": "mesh100k", "world_size": mesh.world_size,
             "res": SHARD_RES, "spp": SHARD_SPP, "max_depth": SHARD_CFG.max_depth,
             "band_rows": rows, "band_margin": margin,
             "render_seconds": {k: v[0] for k, v in runs.items()},
             "camera_rays_per_sec": {k: _rays_per_sec(meta, SHARD_SPP, v[0])
                                     for k, v in runs.items()},
             "launches_per_render": {k: v[1] for k, v in runs.items()},
             "relative_mae_vs_render": errs, "all_reduce_bytes": buf.numel() * 4,
             "all_reduce_ms": reduce_ms, "all_reduces_per_render": {
                 "fused": 1, "unfused": SHARD_SPP},
             "gpu": gpu, "seconds": time.perf_counter() - t0})
        check(all(e < RELMAE_MAX for e in errs.values()),
              f"the sharded render differs from render: {errs}")
        add(runs["fused"][1])
        add(runs["unfused"][1])

        # the scene-sharded ring: Cornell by brute force, mesh100k by 4-wide tables
        cornell = cornell_box(SHARD_RES, SHARD_RES, SHARD_SPP, device=dev)
        shard_ring(mesh, say, gpu, "cornell", cornell[0], cornell[1], False, add)
        shard_ring(mesh, say, gpu, "mesh100k", scene, meta, True, add)
        del scene, cornell

        # the sharded photon shoot and render at photon.pbrt's settings
        t0 = time.perf_counter()
        scene, meta, api = parse_file(_scene_file("photon"), device=dev)
        cfg = api.integrator_config
        spp = meta.sampler.spp
        pcfg = photon_config(cfg)
        grids = {"sharded": photonmap.shoot_photons_sharded(scene, meta, pcfg, mesh),
                 "replicated": photonmap.shoot_photons(scene, meta, pcfg)}
        same = {k: torch.equal(grids["sharded"][k], grids["replicated"][k])
                for k in grids["replicated"]}
        runs = in_turns({
            "render": lambda: render(scene, meta, cfg, spp=spp, device=dev)[0],
            "sharded": lambda: sharding.render_sharded(scene, meta, cfg, spp, mesh)[0]},
            reps=1, warmup=False)
        err = relative_mae(runs["sharded"][2].cpu().numpy(), runs["render"][2].cpu().numpy())
        say({"phase": "sharded_photon", "world_size": mesh.world_size, "paths": pcfg.n_paths,
             "res": [meta.xres, meta.yres], "spp": spp,
             "grid_bitwise_vs_replicated": same,
             "render_seconds": {k: v[0] for k, v in runs.items()},
             "launches_per_render": {k: v[1] for k, v in runs.items()},
             "relative_mae_vs_render": err, "gpu": gpu,
             "seconds": time.perf_counter() - t0})
        check(all(same.values()) and err < RELMAE_MAX,
              f"the sharded photon shoot or render differs: {same}, {err}")
        add(runs["sharded"][1])
        del scene, grids

        # Metropolis with the chains over the ranks, one wave of mlt.pbrt
        t0 = time.perf_counter()
        scene, meta, api = parse_file(_scene_file("mlt"), device=dev)
        mcfg = api.mlt_config
        runs = in_turns({
            "render_mlt": lambda: mlt.render_mlt(scene, meta, mcfg, n_waves=1,
                                                 device=dev)[0],
            "sharded": lambda: mlt.render_mlt_sharded(scene, meta, mcfg, 1, mesh)[0]},
            reps=1, warmup=False)
        a, b = (runs[k][2].cpu().numpy() for k in ("render_mlt", "sharded"))
        close = bool(np.allclose(b, a, atol=MLT_ATOL, rtol=MLT_RTOL))
        say({"phase": "sharded_mlt", "world_size": mesh.world_size,
             "chains": mcfg.n_chains, "waves": 1,
             "render_seconds": {k: v[0] for k, v in runs.items()},
             "launches_per_render": {k: v[1] for k, v in runs.items()},
             "max_abs_diff": float(np.abs(a - b).max()), "allclose": close,
             "gpu": gpu, "seconds": time.perf_counter() - t0})
        check(close and np.isfinite(b).all(), "render_mlt_sharded differs from render_mlt")
        add(runs["sharded"][1])
        del scene

    # each kernel on the busiest wave of each (kernel, role), the ring's too
    t0 = time.perf_counter()
    for (kernel, role), (_, tables, rays, kw) in sorted(waves.items(), key=lambda w: w[0]):
        wave_parity("sharded", kernel, role, tables, rays, kw, "sharded_parity")
    say({"phase": "sharded_parity", "cases": [list(k) for k in sorted(waves)],
         "seconds": time.perf_counter() - t0})
    check(any(role.startswith("ring_") for _, role in waves),
          "no ring local step was captured")
    del waves

    # the training step at the grad phase's width, the entry's dry run
    shard_train(mesh, say, "cornell", cornell_box)
    shard_train(mesh, say, "mesh100k", functools.partial(mesh_scene, grid=MESH_GRID))
    loss, gnorm = dryrun_rank(mesh)
    say({"phase": "sharded_dryrun", "world_size": mesh.world_size, "loss": loss,
         "grad_norm": gnorm})

    shard_vs_cpu(mesh, say)
    say({"phase": "sharded_launches", "launches": total})
    check(all(total[k] > 0 for k in SHARD_KERNELS),
          f"a kernel of the sharded paths was not launched: {total}")
    return total


def sharded_phases(dev, gpu):
    """Phase 29: the multi-rank paths at world size device_count() through
    NCCL: in this process on one card, one process a card otherwise.
    Returns {kernel: launches} over rank 0's renders."""
    t0 = time.perf_counter()
    world = torch.cuda.device_count()
    if world == 1:
        store = tempfile.mkdtemp(prefix="grail_smoke_")
        mesh = launch.init_rank(0, 1, dev, "file://" + os.path.join(store, "store"),
                                SHARD_TIMEOUT_S)
        try:
            check(torch.distributed.get_backend() == "nccl", "the group is not NCCL")
            total = sharded_rank(mesh, gpu)
        finally:
            torch.distributed.destroy_process_group()
            shutil.rmtree(store, ignore_errors=True)
    else:
        total = launch.run_ranks(sharded_rank, world, "cuda", SHARD_TIMEOUT_S, (gpu,))[0]
    emit({"phase": "sharded", "world_size": world, "backend": "nccl",
          "seconds": time.perf_counter() - t0})
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
    film = (film_phases(dev, gpu) + sampler_phases(dev, gpu, built)
            + bsdf_phases(dev, gpu, built))
    pbrt_phases(dev, gpu)
    direct = direct_phases(dev, gpu)
    maps = maps_phases(dev, gpu)
    media_launches = media_phases(dev, gpu)
    mlt_launches = mlt_phases(dev, gpu)
    pre_launches = preprocessed_phases(dev, gpu)
    sm_launches = spectral_megabatch_phases(dev, gpu)
    sharded_launches = sharded_phases(dev, gpu)
    groups = {"direct": direct, "maps": maps, "media": media_launches, "mlt": mlt_launches,
              "preprocessed": pre_launches, "spectral_megabatch": sm_launches,
              "sharded": sharded_launches}
    for entry in kernels:
        for group, counts in groups.items():
            entry["launches_" + group] = counts.get(entry["name"], 0)
    for entry in film:    # the groups do not count the film's, sampler's or BSDF's launches
        entry.update({"launches_" + group: None for group in groups})
    kernels += film
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
