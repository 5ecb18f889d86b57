"""Build and bind the port's CUDA kernels: `nvcc` compiles each source in csrc/ into a
shared library with a plain C interface, loaded with ctypes.

Libraries go to grail_torch/_build/, named by a hash of the source and the
flags, so a changed source never loads a stale build. Nothing is built at
import: the first call that needs a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("brute_intersect", "bvh4", "film", "sampler", "bsdf")
NVCC_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "--fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc_path():
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _source(name):
    return os.path.join(CSRC, name + ".cu")


def lib_path(name):
    with open(_source(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES):
    """Compile every named source without an up-to-date library, starting one
    nvcc per source at once. Returns {name: (seconds, compiler output)} for
    the sources it compiled; raises if any compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    try:
        for name in names:
            out = lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, _source(name)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            jobs[name] = (proc, tmp, out, time.perf_counter())
        done = {}
        for name, (proc, tmp, out, t0) in jobs.items():
            log = proc.communicate()[0].decode(errors="replace")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
            os.replace(tmp, out)
            done[name] = (time.perf_counter() - t0, log)
        return done
    finally:
        for proc, tmp, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def check_operands(want, device):
    """Raise unless each tensor of want {name: (tensor, shape)} lies on
    `device`, is float32 and contiguous, and has its shape: what a kernel
    with a plain C interface takes on trust."""
    for name, (x, shape) in want.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, rays on {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def load(name):
    """The ctypes handle of kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(lib_path(name))
        _LIBS[name] = lib
    return lib
