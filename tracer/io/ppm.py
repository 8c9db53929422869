"""PPM image I/O (host-side, numpy).

Replacement for the reference's `ppmLoader`
(its `src/imageLoader.cpp:21-103`): P3/P6 parsing with comment
eating, producing `uint8 [H, W, 3]` arrays that the scene compiler uploads as
float32 texture atlases. Missing files return `None` and the caller falls
back exactly like the reference (`imageLoader.cpp:24-28` logs and leaves the
image empty — procedural sky / magenta checker take over).
"""

from __future__ import annotations

import os
import numpy as np


def _tokens(data: bytes):
    """Yield whitespace-separated tokens, skipping '#' comments."""
    i, n = 0, len(data)
    while i < n:
        c = data[i : i + 1]
        if c.isspace():
            i += 1
        elif c == b"#":
            while i < n and data[i : i + 1] != b"\n":
                i += 1
        else:
            j = i
            while j < n and not data[j : j + 1].isspace():
                j += 1
            yield data[i:j], j
            i = j


def load_ppm(path: str):
    """Load a P3/P6 PPM; returns uint8 [H, W, 3] or None if missing/bad."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    it = _tokens(data)
    try:
        magic, _ = next(it)
        if magic not in (b"P3", b"P6"):
            return None
        w, _ = next(it)
        h, _ = next(it)
        maxv, end = next(it)
        w, h, maxv = int(w), int(h), int(maxv)
        if magic == b"P6":
            # Binary: pixel data starts after exactly one whitespace byte.
            start = end + 1
            raw = np.frombuffer(data, np.uint8, count=w * h * 3, offset=start)
            return raw.reshape(h, w, 3).copy()
        vals = np.empty(w * h * 3, np.uint8)
        for k in range(w * h * 3):
            tok, _ = next(it)
            vals[k] = int(tok)
        return vals.reshape(h, w, 3)
    except (StopIteration, ValueError):
        return None


def write_ppm(path: str, image: np.ndarray, binary: bool = True):
    """Write float [H, W, 3] (clamped *255, like main.cpp:258-261) as PPM."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        if binary:
            f.write(b"P6\n%d %d\n255\n" % (w, h))
            f.write(img.tobytes())
        else:
            f.write(b"P3\n%d %d\n255\n" % (w, h))
            flat = img.reshape(-1)
            f.write(b" ".join(b"%d" % v for v in flat))
            f.write(b"\n")


def write_png(path: str, image: np.ndarray):
    """Minimal PNG writer (no external deps): float/uint8 [H, W, 3]."""
    import struct
    import zlib

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        c = struct.pack(">I", len(payload)) + tag + payload
        return c + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
