"""Animated-GIF assembly for rendered frames — a copy of
``wgpu_n_body_tpu/runners/gif.py`` (numpy only).

The reference's OnlineRenderer presents frames to a winit surface
(src/runners/online_renderer.rs:336-378); the offline analog dumps frames
and assembles them into an animated GIF so the disc-galaxy scene from
``visualize`` (src/bin/visualize.rs:26-37) is viewable without a window
system or ffmpeg. GIF89a with a 256-entry grayscale palette and a real
LZW encoder (12-bit codes, dictionary reset at 4096 entries). A float
frame is quantised with ``+ 0.5`` rounding, where ``png_bytes`` truncates.
"""

from __future__ import annotations

import struct

import numpy as np


def _lzw_encode(data: bytes, min_code_size: int = 8) -> bytes:
    """LZW-compress index data (GIF variant: CLEAR/EOI codes, MSB-first
    code growth, LSB-first bit packing)."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    bitbuf = 0
    nbits = 0

    def emit(code: int, size: int):
        nonlocal bitbuf, nbits
        bitbuf |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            nbits -= 8

    table = {bytes([i]): i for i in range(clear)}
    next_code = eoi + 1
    code_size = min_code_size + 1
    emit(clear, code_size)
    prefix = b""
    for b in data:
        cur = prefix + bytes([b])
        if cur in table:
            prefix = cur
            continue
        emit(table[prefix], code_size)
        table[cur] = next_code
        next_code += 1
        if next_code > (1 << code_size) and code_size < 12:
            code_size += 1
        elif next_code >= (1 << 12):
            emit(clear, code_size)
            table = {bytes([i]): i for i in range(clear)}
            next_code = eoi + 1
            code_size = min_code_size + 1
        prefix = bytes([b])
    if prefix:
        emit(table[prefix], code_size)
    emit(eoi, code_size)
    if nbits:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def _to_u8(frame: np.ndarray) -> np.ndarray:
    f = np.asarray(frame)
    if f.dtype == np.uint8:
        return f
    return (np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_gif(
    path: str,
    frames,
    fps: float = 30.0,
    loop: int = 0,
) -> str:
    """Write grayscale frames ((H, W) float [0,1] or uint8) as an animated
    GIF. ``loop=0`` repeats forever (NETSCAPE2.0 extension). Returns path."""
    frames = [_to_u8(f) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape
    for f in frames:
        if f.shape != (h, w):
            raise ValueError(f"frame shape {f.shape} != {(h, w)}")
    delay_cs = max(1, round(100.0 / fps))  # GIF delays are centiseconds

    buf = bytearray()
    buf += b"GIF89a"
    # logical screen: global 256-gray color table (2^8, sorted flag off)
    buf += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
    buf += bytes(v for g in range(256) for v in (g, g, g))
    if len(frames) > 1:
        # NETSCAPE2.0 looping application extension
        buf += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"
    for f in frames:
        # graphic control: no disposal, no transparency, frame delay
        buf += b"\x21\xf9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
        buf += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0)  # image descriptor
        buf += b"\x08"  # LZW min code size
        lzw = _lzw_encode(f.tobytes())
        for i in range(0, len(lzw), 255):
            chunk = lzw[i : i + 255]
            buf += bytes([len(chunk)]) + chunk
        buf += b"\x00"
    buf += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(bytes(buf))
    return path
