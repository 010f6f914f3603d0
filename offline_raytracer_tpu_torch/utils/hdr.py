"""Radiance .hdr and PNG output (counterpart of ``utils/hdr.py``, numpy).

Flat RGBE scanlines with the ``+Y h +X w`` header, bit-compatible with the
JAX package's writer; a Reinhard + gamma tonemap and a dependency-free PNG
writer for eyeballing renders.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 shared-exponent RGBE."""
    img = np.asarray(img, np.float32)
    maxc = img.max(axis=-1)
    valid = maxc >= 1e-32
    mant, exp = np.frexp(maxc)
    with np.errstate(divide="ignore", invalid="ignore"):
        denom = np.where(valid, mant * 255.0 / np.where(valid, maxc, 1.0), 0.0)
    rgb = np.rint(img * denom[..., None]).astype(np.uint8)
    e = np.where(valid, exp + 128, 0).astype(np.uint8)
    out = np.concatenate([rgb, e[..., None]], axis=-1)
    out[~valid] = 0
    return out


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) float32 image (row 0 = top) as flat RGBE .hdr."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    rgbe = float_to_rgbe(img)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"+Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def tonemap(img: np.ndarray, exposure: float = 1.0,
            gamma: float = 2.2) -> np.ndarray:
    """Reinhard + gamma tonemap to uint8."""
    img = np.asarray(img, np.float32) * exposure
    img = img / (1.0 + img)
    img = np.clip(img, 0.0, 1.0) ** (1.0 / gamma)
    return (img * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Minimal PNG writer. img_u8: (H, W, 3) uint8."""
    h, w, _ = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
