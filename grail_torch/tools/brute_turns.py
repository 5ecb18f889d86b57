"""Time the brute-force kernel of this tree against other sources of the
same C interface (`grail_brute_intersect`), in turns, with chip_smoke.py's
clock and Cornell rays.

    python3 -m grail_torch.tools.brute_turns OTHER.cu [OTHER.cu ...]

Run from the repository root on a machine with a CUDA device and nvcc. Each
other source is compiled with the port's nvcc flags into grail_torch/_build/.
On each ray case of chip_smoke.py (the bench camera wave, secondary rays
from inside the box, shadow rays of random length with 1/8 dead lanes; 1M
rays each) and on the secondary rays with a random half of them dead (dead
lanes among live ones, as Russian roulette leaves them), for each instance
(closest hit, any hit), every kernel is first held bitwise against
brute_intersect_plain, then timed by chip_smoke.py's cuda_ms in the order:
this tree, the others, the others reversed, this tree. Prints one JSON line
per case and instance with each kernel's two times, and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

from chip_smoke import cuda_ms, ray_cases
from grail_torch.kernels import brute_intersect as bi
from grail_torch.kernels import build
from grail_torch.kernels.intersect import pack_tris
from grail_torch.scene.presets import cornell_box

REPS = 50


def build_other(path):
    """Compile `path` with the port's flags; returns its ctypes library."""
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(build.NVCC_FLAGS).encode())
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR, f"libbrute_other-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, path],
                       capture_output=True, text=True, timeout=600, check=True)
    return ctypes.CDLL(out)


def main(others):
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    fns = {"tree": bi._launcher()}
    for path in others:
        fns[path] = bi._launcher(build_other(path))
    scene, meta, _ = cornell_box(256, 256, 16, device=dev)
    tris9 = pack_tris(scene)
    order = list(fns) + list(fns)[::-1]
    with torch.no_grad():
        cases = ray_cases(scene, meta, dev)
        o, d, tmin, tmax = cases["secondary"]
        gen = torch.Generator(device=dev).manual_seed(1)
        dead = torch.rand(tmax.shape[0], device=dev, generator=gen) < 0.5
        cases["secondary_half_dead"] = (o, d, tmin, torch.where(dead, 0.0, tmax))
        for case, args in cases.items():
            for any_hit in (False, True):
                plain = bi.brute_intersect_plain(tris9, *args, any_hit=any_hit)
                for who, fn in fns.items():
                    got = bi._launch(fn, tris9, *args, any_hit)
                    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                        raise SystemExit(f"brute_turns: {who} differs from the plain "
                                         f"version ({case}, any_hit={any_hit})")
                times = {who: [] for who in fns}
                for who in order:
                    times[who].append(cuda_ms(
                        lambda: bi._launch(fns[who], tris9, *args, any_hit), REPS))
                print(json.dumps({"case": case, "kernel": bi.KERNELS[int(any_hit)],
                                  "rays": args[0].shape[0], "order": order,
                                  "ms": times, "gpu": gpu}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
