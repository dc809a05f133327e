"""PNG read and write on zlib and numpy.

No JAX counterpart: the JAX package decodes with OpenCV
(orb_slam3_modified_tpu/io/datasets.py:35-38), and the card host of the
port has no cv2. io/datasets.py decodes with cv2 where it can be imported
and with this module otherwise (io.datasets.PNG_DECODER says which).

Covers non-interlaced PNGs of bit depth 8 or 16 and colour type gray (0),
RGB (2) or RGBA (6), every row filter (None, Sub, Up, Average, Paeth).
Rows filtered with Average or Paeth depend on the pixel to their left, so
they are undone along anti-diagonals: pixel (r, c) needs only (r, c - 1),
(r - 1, c) and (r - 1, c - 1), so one numpy step takes a whole diagonal
(H + W - 1 steps, tens of ms for a 752x480 frame); files whose rows are all
unfiltered, as write_png writes them, skip that loop.

read_png_gray equals cv2.imread(path, cv2.IMREAD_GRAYSCALE) bit for bit:
OpenCV has libpng convert colour (png_set_rgb_to_gray with 0.299, 0.587),
which weighs R, G, B by 9797, 19234, 13737 / 2^15 and truncates at 8 bits,
rounds at 16 bits and then keeps the high byte (pngrtran.c,
png_do_rgb_to_gray; no gamma tables when the file has no gAMA chunk);
16-bit gray keeps its high byte.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
_GRAY_WEIGHTS = (9797, 19234, 32768 - 9797 - 19234)  # libpng's R, G, B at 0.299, 0.587


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(rows: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """(H, 1 + W * bpp) filtered scanlines -> (H, W * bpp) uint8 samples."""
    h = rows.shape[0]
    ft = rows[:, 0]
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ft.max())} unknown")
    if not ft.any():
        return rows[:, 1:]
    x = rows[:, 1:].reshape(h, w, bpp).astype(np.int32)
    # decoded pixels, padded with a zero row above and a zero column on the
    # left: the neighbours outside the image that the filters read as 0
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    rr = np.arange(h)
    for d in range(h + w - 1):
        r = rr[max(0, d - w + 1):min(h, d + 1)]
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        f = ft[r][:, None]
        pred = np.select([f == 0, f == 1, f == 2, f == 3], [0, a, b, (a + b) >> 1],
                         _paeth(a, b, ul))
        out[r + 1, c + 1] = (x[r, c] + pred) & 255
    return out[1:, 1:].reshape(h, w * bpp).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """The samples as stored: (H, W) for gray, (H, W, 3) RGB or (H, W, 4)
    RGBA (cv2.IMREAD_UNCHANGED gives B, G, R order instead), uint8 or
    uint16."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth not in (8, 16) or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace})")
    ch = _CHANNELS[colour]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = _unfilter(raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp), w, bpp)
    if depth == 16:
        samples = samples.view(">u2").astype(np.uint16)
    return samples.reshape((h, w) if ch == 1 else (h, w, ch))


def to_gray(img: np.ndarray) -> np.ndarray:
    """read_png's samples -> (H, W) uint8 as cv2.IMREAD_GRAYSCALE decodes them."""
    wide = img.dtype == np.uint16
    if img.ndim == 3:
        rgb = img[..., :3].astype(np.int64)
        wr, wg, wb = _GRAY_WEIGHTS
        s = wr * rgb[..., 0] + wg * rgb[..., 1] + wb * rgb[..., 2]
        img = (s + 16384) >> 15 if wide else s >> 15
    return (img >> 8 if wide else img).astype(np.uint8)


def read_png_gray(path: str) -> np.ndarray:
    """(H, W) uint8, equal to cv2.imread(path, cv2.IMREAD_GRAYSCALE)."""
    return to_gray(read_png(path))


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA samples, uint8 or
    uint16, non-interlaced, every row unfiltered (filter 0)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, not {img.dtype}")
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    colour = {1: 0, 3: 2, 4: 6}[ch]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rows.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + chunk(b"IEND", b""))
