"""Radiance RGBE (.hdr) reader and writer in NumPy (counterpart of
pathtracing_tpu/io/hdr.py, bit-equal to it both ways).

Pillow has no Radiance support, so the format is implemented here: the
ASCII header, the `-Y H +X W` resolution line, then per-scanline adaptive
RLE of RGBE quadruples (or flat RGBE for old files and tiny widths).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """[H,W,4] uint8 RGBE -> [H,W,3] float32 (shared-exponent decode)."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 128 - 8)).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def read_hdr(path) -> np.ndarray:
    """Read a .hdr file. Returns [H, W, 3] float32, row 0 = top."""
    data = Path(path).read_bytes()
    # ---- header
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    width = height = None
    flip_y = False
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"-Y") or line.startswith(b"+Y"):
            parts = line.split()
            flip_y = line.startswith(b"+Y")
            height = int(parts[1])
            if parts[2] != b"+X":
                raise ValueError(f"{path}: unsupported orientation {line!r}")
            width = int(parts[3])
            break
    if not (width and height):
        raise ValueError(f"{path}: no image size in the header")

    out = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bi = 0
    for y in range(height):
        # new-style RLE scanline starts with 0x02 0x02 hi lo
        if (width >= 8 and width < 32768 and buf[bi] == 2 and buf[bi + 1] == 2
                and ((int(buf[bi + 2]) << 8) | int(buf[bi + 3])) == width):
            bi += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[bi]); bi += 1
                    if count > 128:       # run
                        out[y, x:x + count - 128, c] = buf[bi]
                        bi += 1
                        x += count - 128
                    else:                 # literal
                        out[y, x:x + count, c] = buf[bi:bi + count]
                        bi += count
                        x += count
        else:
            # flat RGBE (also covers old-style; old RLE 255,255,255 runs
            # are rare and unsupported)
            row = buf[bi:bi + width * 4].reshape(width, 4)
            out[y] = row
            bi += width * 4
    img = _rgbe_to_float(out)
    if flip_y:
        img = img[::-1]
    return img


def write_hdr(path, img: np.ndarray):
    """Write [H,W,3] float32 as flat (uncompressed) RGBE."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    m = img.max(-1)
    exp = np.zeros((h, w), np.int32)
    mant = np.frexp(np.maximum(m, 1e-32))[1]      # exponent of max channel
    exp = np.where(m > 0, mant, 0)
    scale = np.where(m > 0, np.ldexp(1.0, -exp + 8), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(m > 0, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if w < 8 or w >= 32768:
            f.write(rgbe.tobytes())
            return
        # new-style scanlines with literal-only runs: unambiguous (a flat
        # row whose first pixel happened to be (2,2,...) would fake the
        # RLE marker for decoders)
        for y in range(h):
            f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
            for c in range(4):
                col = rgbe[y, :, c].tobytes()
                for x in range(0, w, 128):
                    chunk = col[x:x + 128]
                    f.write(bytes([len(chunk)]) + chunk)
