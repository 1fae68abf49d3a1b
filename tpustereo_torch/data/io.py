"""Image and disparity-map I/O: PNG and PGM, PFM (Middlebury ground truth)
and KITTI uint16 disparity PNGs; a numpy copy of the JAX package's
`data/io.py`, which reads and writes through cv2.

The port carries its own codec (numpy and the standard library's `zlib`),
so it reads on machines without cv2 or PIL and gives what cv2 gives:

* PNG decode: every colour type (gray, RGB, palette, gray + alpha,
  RGBA) at every bit depth the specification allows (1, 2, 4, 8, 16),
  all five row filters, and Adam7 interlacing. The row filters are undone
  in C (`tpustereo_torch.native`, built at first use; the inflate is
  `zlib`'s), outside the interpreter lock; the numpy decodes below
  (`_unfilter`, `_unfilter_wavefront`) are the plain versions the tests
  hold it to.
* PNG encode: gray, 8 and 16 bit.
* PGM: P5 (8 and 16 bit) and P2 read, P5 written.

`read_image_gray` gives cv2's `IMREAD_GRAYSCALE` bit for bit. cv2 decodes
PNGs through libpng with `png_set_rgb_to_gray(0.299, 0.587)`, whose
coefficients become the 15-bit fixed-point 9797, 19234 and 32768 - 9797 -
19234 = 3737: an 8-bit colour pixel is (9797 R + 19234 G + 3737 B) >> 15
(truncated), a 16-bit one is rounded at 16 bits, (... + 16384) >> 15, and
then cut to its high byte, as a 16-bit gray pixel is. Alpha is dropped.
A palette image is its palette's RGB (the tRNS alphas dropped), gray
at 1, 2 or 4 bits is scaled to 8 (v * 255 / (2^depth - 1)), as libpng's
`png_set_palette_to_rgb` and `png_set_expand_gray_1_2_4_to_8` give cv2.
PGM values are taken as stored, 16-bit ones cut to their high byte. (Found
by holding cv2 5.0 with libpng 1.6.58 to every RGB triple of 8 bits, every
16-bit gray value and random 16-bit colours and alphas; not the float
0.299 / 0.587 / 0.114 product of `api._as_u8`.) JPEG, TIFF, BMP and PPM
files, which cv2 reads through libraries the port does not carry, raise
`NotImplementedError` naming the format.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from tpustereo_torch import native

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libpng's fixed-point rgb_to_gray coefficients for (0.299, 0.587), over 2^15
_GRAY_RC, _GRAY_GC = 9797, 19234
_GRAY_BC = 32768 - _GRAY_RC - _GRAY_GC
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type -> samples
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}                        # the bit depths each allows
# Adam7: each pass's (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
# the first bytes of the formats cv2 reads and the port refuses
_REFUSED = ((b"\xff\xd8\xff", "JPEG"), (b"II*\x00", "TIFF"),
            (b"MM\x00*", "TIFF"), (b"BM", "BMP"), (b"P6", "PPM"),
            (b"P3", "PPM"))
# a PGM header field: whitespace and comments, then digits
_PGM_FIELD = re.compile(rb"(?:\s|#[^\n]*\n?)*(\d+)")


# --- PNG ---------------------------------------------------------------------

def _chunks(data: bytes, path: str):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"truncated PNG chunk {kind!r}: {path}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"PNG without IEND: {path}")


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters in numpy: raw (h * (1 + stride),) uint8 ->
    (h, stride) uint8, bpp the filter's byte distance (bytes a pixel).
    The plain version of `native.png_unfilter`, which `read_png` runs; the
    tests hold the C code to it. None, Sub and Up go a row at a time. A
    file with Average or Paeth rows (libpng's adaptive choice, as dataset
    files are written), whose bytes depend on the decoded byte bpp to the
    left, goes by anti-diagonals of pixels, every row at once
    (`_unfilter_wavefront`), at a Python step a diagonal."""
    rows = raw.reshape(h, 1 + stride)
    ftypes, lines = rows[:, 0], rows[:, 1:]
    if ftypes.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {ftypes.max()}")
    if np.isin(ftypes, (3, 4)).any():
        return _unfilter_wavefront(ftypes, lines, bpp)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line = lines[y]
        if ftypes[y] == 1:       # Sub: a running sum mod 256 a channel
            line = np.cumsum(line.reshape(-1, bpp), 0, dtype=np.uint8
                             ).reshape(-1)
        elif ftypes[y] == 2:     # Up
            line = line + prev
        out[y] = line
        prev = out[y]
    return out


def _unfilter_wavefront(ftypes: np.ndarray, lines: np.ndarray,
                        bpp: int) -> np.ndarray:
    """All five filters over pixels (y, x) with y + x = k, k = 0, 1, ...:
    such a pixel needs only (y, x - 1), (y - 1, x) and (y - 1, x - 1),
    decoded at k - 1 and k - 2. P holds the image with a zero row above
    and a zero column to the left."""
    h, stride = lines.shape
    w = stride // bpp
    src = lines.reshape(h, w, bpp).astype(np.int32)
    P = np.zeros((h + 1, w + 1, bpp), np.int32)
    ft = ftypes.astype(np.int32)[:, None]
    for k in range(h + w - 1):
        y = np.arange(max(0, k - w + 1), min(h, k + 1))
        x = k - y
        a, b, c = P[y + 1, x], P[y, x + 1], P[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        f = ft[y]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
        P[y + 1, x + 1] = (src[y, x] + pred) & 0xFF
    return P[1:, 1:].astype(np.uint8).reshape(h, stride)


def _samples(rows: np.ndarray, w: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered rows (h, stride) uint8 -> (h, w, ch) samples: uint8 for
    depths up to 8 (sub-byte samples unpacked, first in the high bits),
    uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, ch)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        rows = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)
    return rows[:, :w * ch].reshape(h, w, ch)


def _decode(raw: np.ndarray, h: int, w: int, depth: int, ch: int):
    """One non-interlaced image (or Adam7 pass) of raw rows -> (h, w, ch)
    samples and the bytes it took."""
    stride = -(-w * ch * depth // 8)
    n = h * (1 + stride)
    bpp = max(1, ch * depth // 8)
    return _samples(native.png_unfilter(raw[:n], h, stride, bpp), w, depth,
                    ch), n


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H, W) for gray, (H, W, C) with the file's channel
    order (RGB, RGBA, gray + alpha) otherwise; uint8 or uint16. Gray of 1,
    2 or 4 bits is scaled to 8 bits and a palette image expanded to RGB,
    or to RGBA when it has a tRNS chunk, as cv2's IMREAD_UNCHANGED
    gives them."""
    with open(path, "rb") as f:
        data = f.read()
    ihdr, idat, plte, trns = None, [], None, None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"tRNS":
            trns = body
    if ihdr is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG colour type {ctype}: {path}")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"bad PNG bit depth {depth} for colour type "
                         f"{ctype}: {path}")
    if interlace > 1:
        raise ValueError(f"bad PNG interlace method {interlace}: {path}")
    if ctype == 3 and plte is None:
        raise ValueError(f"palette PNG without PLTE: {path}")
    ch = _CHANNELS[ctype]
    # each pass's (first row, first column, row step, column step, rows,
    # columns); an empty pass has no bytes at all
    passes = [(y0, x0, dy, dx, -(-(h - y0) // dy), -(-(w - x0) // dx))
              for y0, x0, dy, dx in (_ADAM7 if interlace else
                                     ((0, 0, 1, 1),))]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    # the inflated size, so zlib fills one buffer in one call without the
    # interpreter lock (a growing buffer takes the lock back at each step)
    size = sum(ph * (1 + -(-pw * ch * depth // 8))
               for *_, ph, pw in passes)
    raw = np.frombuffer(zlib.decompress(b"".join(idat),
                                        bufsize=max(size, 1)), np.uint8)
    if raw.size != size:
        raise ValueError(f"PNG image data of {raw.size} bytes, expected "
                         f"{size}: {path}")
    img = np.empty((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for y0, x0, dy, dx, ph, pw in passes:
        img[y0::dy, x0::dx], n = _decode(raw[pos:], ph, pw, depth, ch)
        pos += n
    if ctype == 3:
        return _palette(img[..., 0], plte, trns)
    if depth < 8:
        img = img * np.uint8(255 // ((1 << depth) - 1))
    return img[..., 0] if ch == 1 else img


def _palette(idx: np.ndarray, plte: bytes, trns) -> np.ndarray:
    """Palette indices (H, W) -> RGB, or RGBA with a tRNS chunk (entries
    past it opaque); indices past the palette read as black, as libpng's
    zero-filled 256-entry palette gives them."""
    lut = np.zeros((256, 4), np.uint8)
    lut[:, 3] = 255
    n = min(len(plte) // 3, 256)
    lut[:n, :3] = np.frombuffer(plte, np.uint8, 3 * n).reshape(n, 3)
    if trns is None:
        return lut[idx, :3]
    a = np.frombuffer(trns, np.uint8)[:256]
    lut[:a.size, 3] = a
    return lut[idx]


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Encode a (H, W) uint8 or uint16 gray image (filter None a row)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise NotImplementedError(f"PNG encode takes (H, W) uint8 or uint16 "
                                  f"gray, got {img.dtype} {img.shape}")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2" if depth == 16 else np.uint8)
                                ).view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0,
                                                  0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def _png_gray8(img: np.ndarray) -> np.ndarray:
    """cv2's IMREAD_GRAYSCALE of a decoded PNG (see the module docstring)."""
    wide = img.dtype == np.uint16
    if img.ndim == 3:
        if img.shape[2] in (3, 4):
            r, g, b = (img[..., i].astype(np.int64) for i in range(3))
            s = _GRAY_RC * r + _GRAY_GC * g + _GRAY_BC * b
            img = (s + 16384) >> 15 if wide else s >> 15
        else:                                     # gray + alpha
            img = img[..., 0]
    if wide:
        img = img.astype(np.int64) >> 8
    return img.astype(np.uint8)


# --- PGM ---------------------------------------------------------------------

def read_pgm(path: str) -> np.ndarray:
    """P5 (binary, 8 or 16 bit big-endian) or P2 (ASCII) -> (H, W) uint8 or
    uint16 as stored."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P5", b"P2"):
        raise NotImplementedError(f"not a P5/P2 PGM ({magic!r}): {path}")
    fields, pos = [], 2
    while len(fields) < 3:                  # width, height, maxval
        m = _PGM_FIELD.match(data, pos)
        if not m:
            raise ValueError(f"malformed PGM header: {path}")
        fields.append(int(m.group(1)))
        pos = m.end()
    w, h, maxval = fields
    if not 0 < maxval < 65536:
        raise ValueError(f"PGM maxval {maxval}: {path}")
    dtype = np.uint16 if maxval > 255 else np.uint8
    if magic == b"P2":
        vals = np.array(data[pos:].split()[:w * h], np.int64)
    else:
        pos += 1                            # one whitespace byte
        vals = np.frombuffer(data, ">u2" if maxval > 255 else np.uint8,
                             w * h, pos)
    if vals.size != w * h:
        raise ValueError(f"PGM with {vals.size} of {w * h} values: {path}")
    return vals.astype(dtype).reshape(h, w)


def write_pgm(path: str, img: np.ndarray) -> None:
    """(H, W) uint8 or uint16 -> P5, maxval 255 or 65535, as cv2 writes."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise NotImplementedError(f"PGM encode takes (H, W) uint8 or uint16, "
                                  f"got {img.dtype} {img.shape}")
    wide = img.dtype == np.uint16
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n"
                f"{65535 if wide else 255}\n".encode())
        f.write(np.ascontiguousarray(img.astype(">u2" if wide else np.uint8))
                .tobytes())


def _read_any(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _PNG_SIGNATURE:
        return read_png(path)
    if head[:2] in (b"P5", b"P2"):
        return read_pgm(path)
    for magic, name in _REFUSED:
        if head.startswith(magic):
            raise NotImplementedError(
                f"{name} image {path}: the port reads PNG and P5/P2 PGM "
                f"(cv2's {name} decoder is not carried)")
    raise NotImplementedError(f"image format of {path} (PNG and P5/P2 PGM "
                              f"are read)")


# --- the JAX package's interface ---------------------------------------------

def read_image_gray(path: str) -> np.ndarray:
    """Load an image as grayscale uint8 (H, W), as cv2's IMREAD_GRAYSCALE."""
    img = _read_any(str(path))
    return _png_gray8(img) if img.ndim == 3 else (
        (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img)


def write_image(path: str, img: np.ndarray) -> None:
    """Write a (H, W) uint8 or uint16 gray image; `.png` or `.pgm`."""
    path = str(path)
    if path.lower().endswith(".png"):
        write_png(path, img)
    elif path.lower().endswith(".pgm"):
        write_pgm(path, img)
    else:
        raise NotImplementedError(f"image format of {path} (.png and .pgm "
                                  f"are written)")


# --- PFM (Middlebury float maps) ---------------------------------------------

def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> float32 (H, W) or (H, W, 3). Rows are stored
    bottom-up in PFM; returned top-down."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        color = header == b"PF"
        dims = f.readline().strip()
        while dims.startswith(b"#"):
            dims = f.readline().strip()
        m = re.match(rb"^(\d+)\s+(\d+)$", dims)
        if not m:
            raise ValueError("malformed PFM dims")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(count * 4), dtype=endian + "f4",
                             count=count)
    shape = (h, w, 3) if color else (h, w)
    return np.ascontiguousarray(data.reshape(shape)[::-1]).astype(np.float32)


def write_pfm(path: str, data: np.ndarray) -> None:
    data = np.asarray(data, dtype=np.float32)
    color = data.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.ascontiguousarray(data[::-1]).astype("<f4").tobytes())


# --- KITTI disparity PNGs ----------------------------------------------------

def kitti_disparity_raw(disp: np.ndarray) -> np.ndarray:
    """float disparity (invalid < 0) -> the KITTI uint16 map: d * 256
    clipped to [1, 65535] and truncated, 0 = invalid."""
    return np.where(disp >= 0, np.clip(disp * 256.0, 1, 65535),
                    0).astype(np.uint16)


def read_kitti_disparity(path: str) -> np.ndarray:
    """KITTI disparity GT: uint16 PNG, value = disparity*256, 0 = invalid.
    Returns float32 with invalid = -1."""
    raw = read_png(str(path))
    if raw.ndim != 2:
        raise ValueError(f"a KITTI disparity map is single-channel: {path}")
    disp = raw.astype(np.float32) / 256.0
    disp[raw == 0] = -1.0
    return disp


def write_kitti_disparity(path: str, disp: np.ndarray) -> None:
    write_png(str(path), kitti_disparity_raw(disp))
