"""Radiance .hdr I/O and PNG output (counterpart of ``utils/hdr.py``, numpy).

Flat RGBE scanlines with the ``+Y h +X w`` header, bit-compatible with the
JAX package's writer; a reader of that layout and of new-style RLE, so
files written by either package, or by other Radiance tools, load; a
Reinhard + gamma tonemap and a dependency-free PNG writer for eyeballing
renders.
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


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = np.asarray(rgbe, np.uint8)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0).astype(
        np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


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


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32, row 0 = top: the
    flat layout ``write_hdr`` writes, or new-style RLE scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    # the header ends at its first blank line; the resolution line follows
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line.strip() == b"" and lines:
            break
        lines.append(line)
    res_nl = data.index(b"\n", pos)
    res = data[pos:res_nl].decode().split()
    pos = res_nl + 1
    if res[0] not in ("+Y", "-Y") or res[2] not in ("+X", "-X"):
        raise ValueError(f"unsupported .hdr resolution line {res}")
    h, w = int(res[1]), int(res[3])

    body = np.frombuffer(data[pos:], np.uint8)
    if body.size == h * w * 4:
        rgbe = body.reshape(h, w, 4)
    else:
        rgbe = _decode_rle(body, h, w)
    img = rgbe_to_float(rgbe)
    if res[0] == "-Y":
        img = img[::-1]
    if res[2] == "-X":
        img = img[:, ::-1]
    return img


def _decode_rle(body: np.ndarray, h: int, w: int) -> np.ndarray:
    """New-style RLE scanlines -> (h, w, 4) uint8 RGBE."""
    out = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if not (body[pos] == 2 and body[pos + 1] == 2):
            raise ValueError("unsupported scanline encoding")
        if (int(body[pos + 2]) << 8) + int(body[pos + 3]) != w:
            raise ValueError(f"scanline {y}: width differs from {w}")
        pos += 4
        for c in range(4):
            x = 0
            while x < w:
                count = int(body[pos])
                pos += 1
                if count > 128:   # a run
                    out[y, x:x + count - 128, c] = body[pos]
                    pos += 1
                    x += count - 128
                else:             # literal values
                    out[y, x:x + count, c] = body[pos:pos + count]
                    pos += count
                    x += count
    return out


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
