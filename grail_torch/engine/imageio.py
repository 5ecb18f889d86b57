"""Image I/O (port of grail/engine/imageio.py; pbrt src/core/imageio):
dispatch by extension.

.pfm  — portable float map;
.exr  — a minimal OpenEXR 2.0 codec (scanline, NONE/ZIP/ZIPS compression,
        HALF/FLOAT/UINT channels): magic 20000630, typed header attributes,
        the scanline offset table, per-block (y, size, zlib data) with the
        delta predictor and byte deinterleave, in numpy and zlib;
.png/.tga/.jpg — 8-bit through PIL (imported only for these) with gamma 2.2.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------- PFM
def write_pfm(path, img):
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")                       # little-endian
        f.write(img[::-1].tobytes())             # bottom-up rows


def read_pfm(path):
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    return np.ascontiguousarray(img[::-1]).astype(np.float32)


# ---------------------------------------------------------------------------- EXR
_EXR_MAGIC = 20000630
_PT_HALF, _PT_FLOAT, _PT_UINT = 1, 2, 0
_NO_COMPRESSION, _ZIPS, _ZIP = 0, 2, 3


def _exr_predictor_decode(buf):
    """Undo the delta predictor (a running sum less 128 a byte, mod 256),
    then the byte deinterleave (first half even bytes, second half odd)."""
    b = np.frombuffer(buf, np.uint8).astype(np.int64)
    b = (np.cumsum(b) - 128 * np.arange(len(b))) & 0xFF
    half = (len(b) + 1) // 2
    out = np.empty(len(b), np.uint8)
    out[0::2] = b[:half]
    out[1::2] = b[half:]
    return out.tobytes()


def _exr_predictor_encode(buf):
    """Interleave (even bytes, then odd) and delta-encode with a +128 bias;
    the first byte passes through (ImfZip.cpp)."""
    a = np.frombuffer(buf, np.uint8)
    inter = np.concatenate([a[0::2], a[1::2]]).astype(np.int64)
    out = inter.copy()
    out[1:] = (inter[1:] - inter[:-1] + 128) & 0xFF
    return out.astype(np.uint8).tobytes()


def _read_exr_attrs(f):
    attrs = {}
    while True:
        name = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            name += c
        if name == b"":
            break
        atype = b""
        while True:
            c = f.read(1)
            if c == b"\x00":
                break
            atype += c
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (atype.decode(), f.read(size))
    return attrs


def read_exr(path):
    """Returns (H,W,3) float32 RGB (missing channels zero-filled)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<ii", f.read(8))
        if magic != _EXR_MAGIC:
            raise ValueError(f"{path}: not an EXR file")
        if version & 0x200:
            raise ValueError(f"{path}: tiled EXR not supported")
        attrs = _read_exr_attrs(f)

        # channels
        chans = []
        data = attrs["channels"][1]
        off = 0
        while data[off] != 0:
            end = data.index(0, off)
            cname = data[off:end].decode()
            ptype, _, xs, ys = struct.unpack("<iiii", data[end + 1:end + 17])
            chans.append((cname, ptype))
            off = end + 17
        chans_sorted = sorted(chans)  # EXR stores channels alphabetically

        comp = attrs["compression"][1][0]
        dw = struct.unpack("<iiii", attrs["dataWindow"][1])
        xmin, ymin, xmax, ymax = dw
        w = xmax - xmin + 1
        h = ymax - ymin + 1
        lines_per_block = {_NO_COMPRESSION: 1, _ZIPS: 1, _ZIP: 16}.get(comp)
        if lines_per_block is None:
            raise ValueError(f"{path}: unsupported EXR compression {comp}")
        nblocks = -(-h // lines_per_block)
        f.read(8 * nblocks)  # scanline offset table (we read sequentially)

        out = {c: np.zeros((h, w), np.float32) for c, _ in chans_sorted}
        for _ in range(nblocks):
            y, size = struct.unpack("<ii", f.read(8))
            raw = f.read(size)
            nlines = min(lines_per_block, ymax - y + 1)
            expected = sum(w * (2 if pt == _PT_HALF else 4)
                           for _, pt in chans_sorted) * nlines
            if comp in (_ZIP, _ZIPS) and size != expected:
                raw = _exr_predictor_decode(zlib.decompress(raw))
            pos = 0
            for line in range(nlines):
                for cname, ptype in chans_sorted:
                    nbytes = w * (2 if ptype == _PT_HALF else 4)
                    chunk = raw[pos:pos + nbytes]
                    pos += nbytes
                    if ptype == _PT_HALF:
                        vals = np.frombuffer(chunk, "<f2").astype(np.float32)
                    elif ptype == _PT_FLOAT:
                        vals = np.frombuffer(chunk, "<f4").astype(np.float32)
                    else:
                        vals = np.frombuffer(chunk, "<u4").astype(np.float32)
                    out[cname][y - ymin + line] = vals

    img = np.zeros((h, w, 3), np.float32)
    names = {c for c, _ in chans_sorted}
    if {"R", "G", "B"} <= names:
        img[..., 0], img[..., 1], img[..., 2] = out["R"], out["G"], out["B"]
    elif "Y" in names:
        img[...] = out["Y"][..., None]
    else:
        for i, (c, _) in enumerate(chans_sorted[:3]):
            img[..., i] = out[c]
    return img


def write_exr(path, img, half=True):
    """Scanline EXR, ZIP compression, HALF (default) or FLOAT channels."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    ptype = _PT_HALF if half else _PT_FLOAT
    bpp = 2 if half else 4

    def attr(name, atype, payload):
        return (name.encode() + b"\x00" + atype.encode() + b"\x00"
                + struct.pack("<i", len(payload)) + payload)

    chan_entry = lambda n: (n.encode() + b"\x00"
                            + struct.pack("<iiii", ptype, 0, 1, 1))
    channels = chan_entry("B") + chan_entry("G") + chan_entry("R") + b"\x00"
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        attr("channels", "chlist", channels)
        + attr("compression", "compression", bytes([_ZIP]))
        + attr("dataWindow", "box2i", dw)
        + attr("displayWindow", "box2i", dw)
        + attr("lineOrder", "lineOrder", b"\x00")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00")

    lines_per_block = 16
    nblocks = -(-h // lines_per_block)
    blocks = []
    for bi in range(nblocks):
        y0 = bi * lines_per_block
        nlines = min(lines_per_block, h - y0)
        raw = bytearray()
        for line in range(nlines):
            row = img[y0 + line]
            for ci in (2, 1, 0):  # B, G, R (alphabetical)
                vals = row[:, ci].astype("<f2" if half else "<f4")
                raw += vals.tobytes()
        comp = zlib.compress(_exr_predictor_encode(bytes(raw)))
        if len(comp) >= len(raw):
            comp = bytes(raw)
        blocks.append((y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        offset_pos = f.tell()
        data_start = offset_pos + 8 * nblocks
        offsets = []
        pos = data_start
        for y0, comp in blocks:
            offsets.append(pos)
            pos += 8 + len(comp)
        for o in offsets:
            f.write(struct.pack("<q", o))
        for y0, comp in blocks:
            f.write(struct.pack("<ii", y0, len(comp)))
            f.write(comp)


# ------------------------------------------------------------------------- dispatch
def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("8-bit image formats need PIL, which is not installed; "
                          "use .exr or .pfm") from e
    return Image


def read_image(path, gamma=None):
    """ReadImage: float RGB in linear space. 8-bit formats are de-gamma'd (2.2)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".pfm":
        img = read_pfm(path)
        return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
    if ext == ".exr":
        return read_exr(path)
    im = np.asarray(_pil_image().open(path).convert("RGB"), np.float32) / 255.0
    g = 2.2 if gamma is None else gamma
    return im ** g


def write_image(path, img):
    """WriteImage dispatch; 8-bit formats get gamma 2.2 + clamp (imageio.cpp)."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".pfm":
        write_pfm(path, img)
    elif ext == ".exr":
        write_exr(path, img)
    else:
        tone = np.clip(img, 0.0, 1.0) ** (1.0 / 2.2)
        _pil_image().fromarray((tone * 255.0 + 0.5).astype(np.uint8)).save(path)
