"""PNG / BMP image output.

Port of ``pathtracer_tpu/utils/imageio.py:20-147``: extension-sniffed
save of the 8-bit image (PNG, or BMP for reference parity), with the
trailing-``\\r`` filename tolerance, and a minimal PNG reader.  The
encoders are pure numpy + zlib; there is no native fast path.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgb: np.ndarray) -> bytes:
    """``rgb``: [H, W, 3] uint8 -> PNG bytes (8-bit truecolor)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    return b"".join(
        [
            b"\x89PNG\r\n\x1a\n",
            _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
            _png_chunk(b"IDAT", zlib.compress(raw, 6)),
            _png_chunk(b"IEND", b""),
        ]
    )


def encode_bmp(rgb: np.ndarray) -> bytes:
    """``rgb``: [H, W, 3] uint8 -> 24-bit BI_RGB BMP bytes (row order
    bottom-up, BGR — the format stb_image_write emits for the reference's
    ``.bmp`` renders)."""
    h, w, _ = rgb.shape
    row_pad = (-(w * 3)) % 4
    bgr = rgb[::-1, :, ::-1]  # bottom-up, BGR
    body = b"".join(bgr[y].tobytes() + b"\x00" * row_pad for y in range(h))
    pixel_offset = 14 + 40
    file_size = pixel_offset + len(body)
    header = struct.pack("<2sIHHI", b"BM", file_size, 0, 0, pixel_offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 2835, 2835, 0, 0)
    return header + info + body


def save_image(path: str, img01: np.ndarray) -> str:
    """Save a [H, W, 3] float [0,1] image; format sniffed from extension
    (``.png`` default, ``.bmp`` supported for reference parity).  Returns
    the cleaned path actually written."""
    path = path.rstrip("\r")  # OSX line-ending quirk tolerated by image.cpp:67-71
    rgb = np.clip(np.asarray(img01) * 255.0, 0, 255).astype(np.uint8)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".png", ".bmp", ""):
        path = os.path.splitext(path)[0] + ".png"
        ext = ".png"

    data = encode_bmp(rgb) if ext == ".bmp" else encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
    return path


def load_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (8-bit truecolor / RGBA,
    no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit, color = struct.unpack(">IIBB", chunk[:10])
            if bit != 8 or color not in (2, 6):
                raise ValueError(f"{path}: unsupported PNG (bit depth {bit}, color type {color})")
            channels = 3 if color == 2 else 4
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).copy()
        if ftype == 0:
            pass
        elif ftype == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 1:  # sub
            for x in range(channels, stride):
                line[x] = (int(line[x]) + int(line[x - channels])) & 0xFF
        elif ftype == 3:  # average
            for x in range(stride):
                left = int(line[x - channels]) if x >= channels else 0
                line[x] = (int(line[x]) + ((left + int(prev[x])) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            for x in range(stride):
                a = int(line[x - channels]) if x >= channels else 0
                b = int(prev[x])
                c = int(prev[x - channels]) if x >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[x] = (int(line[x]) + pred) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = line
        prev = line
    return out.reshape(h, w, channels)[:, :, :3]
