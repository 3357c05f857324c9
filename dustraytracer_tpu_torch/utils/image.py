"""Image export (port of utils/image.py): 8-bit PNG, flipped vertically
because pixel row 0 is the bottom scanline. Written with zlib + struct,
so it needs no imaging library."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def to_uint8(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path, image, flip: bool = True) -> None:
    """Write an (H, W, 3) RGB or (H, W, 4) RGBA image in [0, 1]."""
    arr = to_uint8(image)
    if flip:
        arr = arr[::-1]
    h, w, c = arr.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    color_type = 2 if c == 3 else 6
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, w * c)],
                          axis=1)  # filter byte 0 (None) per scanline
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(png)
