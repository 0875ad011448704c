"""Image IO for the example gallery (the reference examples load PNGs
through their C++ harness, e.g. examples/image_warping/src/main.cpp
reads the input image + mask).  PIL-backed with a dependency-free
PPM/PGM fallback so the loaders work in minimal environments."""
from __future__ import annotations

import numpy as np


def load_image(path, dtype=np.float32, normalize=True):
    """Load an image as [H, W] (grayscale) or [H, W, C] float array in
    [0, 1] (normalize=True) or raw integer range."""
    path = str(path)
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is not None:
        arr = np.asarray(Image.open(path))
    else:
        arr = _load_pnm(path)
    arr = arr.astype(dtype)
    if normalize and np.issubdtype(np.asarray(arr).dtype, np.floating):
        arr = arr / 255.0
    return arr


def save_image(path, arr, normalized=True):
    """Save [H, W] or [H, W, C] array; float inputs are assumed in
    [0, 1] when normalized=True."""
    path = str(path)
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.floating):
        a = np.clip(a * 255.0 if normalized else a, 0, 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        _save_pnm(path, a)
        return
    Image.fromarray(a).save(path)


def _load_pnm(path):
    with open(path, "rb") as f:
        data = f.read()
    tokens = []
    i = 0
    # header: magic, width, height, maxval (P5/P6 binary)
    while len(tokens) < 4:
        if data[i:i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        if j > i:
            tokens.append(data[i:j])
        i = j + 1
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    body = np.frombuffer(data, np.uint8 if maxval < 256 else ">u2", offset=i)
    if magic == b"P5":
        return body[: w * h].reshape(h, w)
    if magic == b"P6":
        return body[: w * h * 3].reshape(h, w, 3)
    raise ValueError(f"unsupported PNM magic {magic!r} in {path}")


def _save_pnm(path, a):
    with open(path, "wb") as f:
        if a.ndim == 2:
            f.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        elif a.ndim == 3 and a.shape[2] == 3:
            f.write(b"P6\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        else:
            raise ValueError(f"unsupported shape for PNM: {a.shape}")
        f.write(np.ascontiguousarray(a, np.uint8).tobytes())
