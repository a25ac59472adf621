"""Radiance RGBE (.hdr) reader/writer in pure numpy.

The counterpart of ``spt_tpu.io.hdr`` (copied, numpy only): it fills the
role stb_image's `stbi_loadf` plays for the reference's Cubemap
(Cubemap.cpp:18-46), loading HDR environment maps as linear float RGB.
Supports the common "32-bit_rle_rgbe" format, both adaptive-RLE and flat
scanlines, plus a writer (flat scanlines) so tests and ``chip_smoke.py`` can
round-trip without any external asset.  The pixels are decoded by the
native host library (``io/native``, ``native/spt_native.cpp``) when ``g++``
can build it, else by the numpy decode below, whose flat-scanline rows are
one slice each; both give the same floats.

Layout detection mirrors Cubemap::loadFromFile (Cubemap.cpp:18-46): a 2:1
aspect is an equirectangular panorama, 4:3 a horizontal-cross cubemap (see
:func:`spt_tpu_torch.io.cubemap_cross.cross_to_equirect` for the cross path).
"""

from __future__ import annotations

import numpy as np


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32 linear RGB."""
    rgbe = rgbe.astype(np.int32)
    e = rgbe[..., 3]
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 RGBE."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mantissa, exponent = np.frexp(np.where(nz, maxc, 1.0))
    scale = mantissa * 256.0 / np.where(nz, maxc, 1.0)
    vals = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., :3] = np.where(nz[..., None], vals, 0)
    out[..., 3] = np.where(nz, exponent + 128, 0).astype(np.uint8)
    return out


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32 linear RGB."""
    with open(path, "rb") as f:
        data = f.read()

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")

    # Header: lines until blank, then the resolution line.
    pos = 0
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res!r}")
    h, w = int(res[1]), int(res[3])

    # the native decode (io/native, spt_native.cpp) when g++ can build it
    from spt_tpu_torch.io import native

    decoded = native.rgbe_decode(data[pos:], w, h)
    if decoded is not None:
        return decoded

    buf = np.frombuffer(data, np.uint8, offset=pos)
    img = np.zeros((h, w, 4), np.uint8)
    bp = 0
    for row in range(h):
        if w < 8 or w > 0x7FFF or buf[bp] != 2 or buf[bp + 1] != 2:
            # flat (possibly old-style RLE, which we don't generate) scanline
            img[row] = buf[bp : bp + 4 * w].reshape(w, 4)
            bp += 4 * w
            continue
        assert (int(buf[bp + 2]) << 8 | int(buf[bp + 3])) == w, "scanline width mismatch"
        bp += 4
        for ch in range(4):
            x = 0
            while x < w:
                count = int(buf[bp]); bp += 1
                if count > 128:  # run
                    img[row, x : x + count - 128, ch] = buf[bp]
                    bp += 1
                    x += count - 128
                else:            # literal
                    img[row, x : x + count, ch] = buf[bp : bp + count]
                    bp += count
                    x += count
    return _rgbe_to_float(img)


def write_hdr(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3) float32 linear RGB as flat-scanline Radiance HDR."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape
    rgbe = _float_to_rgbe(img)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def detect_layout(width: int, height: int) -> str:
    """'equirect' for 2:1, 'cross' for 4:3, else 'unknown'
    (Cubemap.cpp:18-46 aspect autodetect)."""
    if width == 2 * height:
        return "equirect"
    if width * 3 == height * 4:
        return "cross"
    return "unknown"
