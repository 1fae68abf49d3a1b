"""The port's image I/O, dataset loaders and prefetch (`tpustereo_torch.
data.io`, `data.datasets`, `data.prefetch`) against the JAX package's,
which read and write through cv2, on the CPU.

Every comparison is exact: decoded images and KITTI maps bit for bit,
PFM float32 bit for bit, loaders' arrays equal.
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from tpustereo.data import datasets as jdatasets
from tpustereo.data import io as jio
from tpustereo_torch.data import datasets, io, prefetch_pairs

SHAPES = [(37, 53), (96, 160), (1, 1), (5, 1), (2, 257)]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(path, arr, ctype, depth, filters=(0, 1, 2, 3, 4),
                interlace=0, plte=None):
    """A PNG of `arr` (H, W) or (H, W, C) in colour type ctype and bit
    depth 8 or 16, row y filtered with filters[y % len(filters)] by the
    PNG specification's rules (a loop, independent of the codec under
    test); `interlace` and `plte` only set the header and add the chunk."""
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(arr.astype(">u2" if depth == 16 else np.uint8)
                                ).view(np.uint8).reshape(h, -1).astype(int)
    bpp = max(1, rows.shape[1] // w)
    out, prev = bytearray(), [0] * rows.shape[1]
    for y in range(h):
        f = filters[y % len(filters)]
        line = rows[y].tolist()
        out.append(f)
        for x, v in enumerate(line):
            a = line[x - bpp] if x >= bpp else 0
            b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
            out.append((v - [0, a, b, (a + b) >> 1, _paeth(a, b, c)][f]) & 255)
        prev = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      interlace))
    if plte is not None:
        body += chunk(b"PLTE", plte)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body
                + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND",
                                                                    b""))


def _textured(rng, shape, hi):
    """Smooth rows plus noise, so cv2's adaptive filters pick several."""
    base = np.cumsum(rng.integers(-3, 4, shape), 1) * max(1, hi // 255)
    return np.clip(base + hi // 2 + rng.integers(0, 3, shape), 0, hi)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_cv2_png_reads_equal(tmp_path, shape, dtype, channels):
    rng = np.random.default_rng(sum(shape) + channels)
    hi = np.iinfo(dtype).max
    a = _textured(rng, shape + (channels,), hi).astype(dtype)
    a = a[..., 0] if channels == 1 else a
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, a)
    got = io.read_image_gray(path)
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, jio.read_image_gray(path))
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if channels > 1:   # cv2 hands back BGR(A); the file holds RGB(A)
        raw = raw[..., [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(io.read_png(path), raw)


def test_colour_to_gray_every_rgb_triple(tmp_path):
    """All 2^24 RGB triples of 8 bits in one 4096 x 4096 PNG: the port's
    gray is cv2's, bit for bit (libpng's 15-bit fixed point, truncated)."""
    v = np.arange(256, dtype=np.uint8)
    r, g, b = np.meshgrid(v, v, v, indexing="ij")
    rgb = np.stack([r, g, b], -1).reshape(4096, 4096, 3)
    path = str(tmp_path / "cube.png")
    assert cv2.imwrite(path, rgb[..., ::-1])
    np.testing.assert_array_equal(io.read_image_gray(path),
                                  jio.read_image_gray(path))


@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
@pytest.mark.parametrize("depth", [8, 16])
def test_every_filter_and_colour_type(tmp_path, ctype, channels, depth):
    """Rows under all five filters, in each colour type and depth
    (gray + alpha only this way: cv2 writes no two-channel PNG); 16-bit
    colour rounds at 16 bits before its high byte is taken."""
    rng = np.random.default_rng(ctype * 10 + depth)
    a = rng.integers(0, 1 << depth, (23, 41, channels))
    a[:5, :, 1:3 if channels > 2 else 1] = a[:5, :, :1]   # gray pixels
    a = a[..., 0] if channels == 1 else a
    path = str(tmp_path / "f.png")
    _encode_png(path, a, ctype, depth)
    np.testing.assert_array_equal(io.read_png(path), a)
    np.testing.assert_array_equal(io.read_image_gray(path),
                                  jio.read_image_gray(path))


def _filter_types(path):
    """The filter byte of each row of an 8-bit gray PNG."""
    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    idat, pos = b"", 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + n] if kind == b"IDAT" else b""
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1
                                                                  )[:, 0]


@pytest.mark.parametrize("side", [0, 1])
def test_libpng_adaptive_fixture(side):
    """`tests/data/adaptive_image_{0,1}.png`: frame 0 of the sequence below
    at KITTI odometry's 376 x 1241, written by cv2 5.0 with
    IMWRITE_PNG_ALL_FILTERS (libpng's adaptive choice, as real dataset
    files are written: Paeth rows). It decodes to the frame, as cv2 reads
    it; `chip_smoke.py` step 21 times the decode and the CLI on it."""
    from tpustereo_torch.data import synthetic_sequence
    path = os.path.join(os.path.dirname(__file__), "data",
                        f"adaptive_image_{side}.png")
    _, frames, _ = synthetic_sequence(
        n_frames=1, shape=(376, 1241), step_x=0.08, seed=0, depth=8.0,
        fx=718.856, baseline=0.537, slant=0.35)
    assert (_filter_types(path) == 4).sum() > 300
    got = io.read_image_gray(path)
    np.testing.assert_array_equal(got, frames[0][side])
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (0, 1, 2)])
def test_row_decode_equals_the_wavefront(tmp_path, filters):
    """Files of None, Sub and Up rows (what the port and cv2's defaults
    write) decode a row at a time; the wavefront that Average and Paeth
    rows need gives the same bytes on them."""
    a = np.random.default_rng(len(filters)).integers(0, 256, (19, 33, 3))
    path = str(tmp_path / "r.png")
    _encode_png(path, a, 2, 8, filters)
    with open(path, "rb") as f:
        data = f.read()
    raw = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:]),
                        np.uint8)
    rows = raw.reshape(19, 1 + 33 * 3)
    np.testing.assert_array_equal(
        io._unfilter(raw, 19, 33 * 3, 3),
        io._unfilter_wavefront(rows[:, 0], rows[:, 1:], 3))
    np.testing.assert_array_equal(io.read_png(path), a)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ext", [".png", ".pgm"])
def test_port_writes_read_by_jax(tmp_path, shape, dtype, ext):
    rng = np.random.default_rng(7)
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / f"p{ext}")
    io.write_image(path, a)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), a)
    np.testing.assert_array_equal(io.read_image_gray(path),
                                  jio.read_image_gray(path))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pgm_reads_equal(tmp_path, dtype):
    rng = np.random.default_rng(3)
    hi = np.iinfo(dtype).max
    a = rng.integers(0, hi + 1, (19, 31)).astype(dtype)
    p5 = str(tmp_path / "a.pgm")
    jio.write_image(p5, a)          # cv2's P5
    np.testing.assert_array_equal(io.read_pgm(p5), a)
    np.testing.assert_array_equal(io.read_image_gray(p5),
                                  jio.read_image_gray(p5))
    p2 = str(tmp_path / "b.pgm")    # ASCII, with a comment in the header
    with open(p2, "w") as f:
        f.write(f"P2\n# made by a test\n31 19\n{hi}\n")
        f.write("\n".join(" ".join(map(str, row)) for row in a) + "\n")
    np.testing.assert_array_equal(io.read_image_gray(p2),
                                  jio.read_image_gray(p2))


@pytest.mark.parametrize("color", [False, True])
def test_pfm_round_trips_both_ways(tmp_path, color):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(13, 29, 3) if color else (13, 29)).astype(np.float32)
    a.flat[::7] = np.inf
    ours, theirs = str(tmp_path / "o.pfm"), str(tmp_path / "t.pfm")
    io.write_pfm(ours, a)
    jio.write_pfm(theirs, a)
    with open(ours, "rb") as f1, open(theirs, "rb") as f2:
        assert f1.read() == f2.read()
    for p in (ours, theirs):
        np.testing.assert_array_equal(io.read_pfm(p), a)
        np.testing.assert_array_equal(jio.read_pfm(p), a)


def test_kitti_disparity_round_trips_both_ways(tmp_path):
    rng = np.random.default_rng(9)
    d = rng.uniform(-2, 300, (17, 33)).astype(np.float32)
    d[0, :4] = [0.0, 1e-4, 255.999, 1e4]    # clip to 1, trunc, 65535
    ours, theirs = str(tmp_path / "o.png"), str(tmp_path / "t.png")
    io.write_kitti_disparity(ours, d)
    jio.write_kitti_disparity(theirs, d)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED),
                                  cv2.imread(theirs, cv2.IMREAD_UNCHANGED))
    np.testing.assert_array_equal(io.read_png(ours), io.kitti_disparity_raw(d))
    for p in (ours, theirs):
        np.testing.assert_array_equal(io.read_kitti_disparity(p),
                                      jio.read_kitti_disparity(p))
    back = io.read_kitti_disparity(ours)
    assert (back[d < 0] == -1).all() and back[0, 1] == 1 / 256


def test_unsupported_formats_raise(tmp_path):
    """JPEG, TIFF, BMP and PPM, which cv2 reads through libraries the
    port does not carry, raise naming the format; PNG encode takes gray
    only; a missing file raises as open() does."""
    a = np.random.default_rng(0).integers(0, 4, (6, 8)).astype(np.uint8)
    for ext, name in ((".jpg", "JPEG"), (".tif", "TIFF"), (".bmp", "BMP"),
                      (".ppm", "PPM")):
        path = str(tmp_path / f"a{ext}")
        assert cv2.imwrite(path, a if ext != ".ppm" else np.stack([a] * 3,
                                                                  -1))
        with pytest.raises(NotImplementedError, match=name):
            io.read_image_gray(path)
    webp = str(tmp_path / "a.webp")
    assert cv2.imwrite(webp, a)
    with pytest.raises(NotImplementedError, match="image format"):
        io.read_image_gray(webp)
    with pytest.raises(NotImplementedError):
        io.write_image(str(tmp_path / "c.png"), np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(FileNotFoundError):
        io.read_image_gray(str(tmp_path / "missing.png"))


# --- palette, bit depths 1, 2 and 4, Adam7: files built by hand ------------

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
PACKED_SHAPES = [(13, 17), (1, 1), (9, 1), (2, 23), (8, 8)]


def _pack(samples, depth):
    """(h, w, ch) samples -> (h, stride) bytes of a PNG row: big-endian
    16-bit, bytes, or sub-byte samples first in the high bits."""
    h = samples.shape[0]
    if depth == 16:
        return np.ascontiguousarray(samples.astype(">u2")).view(
            np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    if depth == 8:
        return flat
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.astype(np.uint8).reshape(h, -1), axis=1)


def _filtered(rows, bpp, filters):
    """The PNG filters applied by the specification's rules, a loop."""
    out, prev = bytearray(), [0] * rows.shape[1]
    for y in range(rows.shape[0]):
        f = filters[y % len(filters)]
        line = rows[y].astype(int).tolist()
        out.append(f)
        for x, v in enumerate(line):
            a = line[x - bpp] if x >= bpp else 0
            b, c = prev[x], (prev[x - bpp] if x >= bpp else 0)
            out.append((v - [0, a, b, (a + b) >> 1, _paeth(a, b, c)][f])
                       & 255)
        prev = line
    return bytes(out)


def _encode_packed(path, samples, ctype, depth, interlace=0, plte=None,
                   trns=None, filters=(0, 1, 2, 3, 4)):
    """A PNG of samples (h, w, ch) at any bit depth, colour type and
    interlace method, with PLTE and tRNS chunks as given (zlib and struct
    only; Adam7 passes filtered each on its own, empty passes absent)."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        data = b"".join(
            _filtered(_pack(samples[y0::dy, x0::dx], depth), bpp, filters)
            for y0, x0, dy, dx in ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        data = _filtered(_pack(samples, depth), bpp, filters)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                      interlace))
    body += chunk(b"PLTE", plte) if plte is not None else b""
    body += chunk(b"tRNS", trns) if trns is not None else b""
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body
                + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def _cv2_gray_equal(path):
    got = io.read_image_gray(path)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True])
@pytest.mark.parametrize("interlace", [0, 1])
def test_palette_reads_equal_cv2(tmp_path, depth, trns, interlace):
    """Colour type 3 with PLTE, with and without tRNS (alphas for half the
    entries): the palette's RGB to gray by libpng's rule, as cv2 reads."""
    rng = np.random.default_rng([depth, trns, interlace])
    n = 1 << depth
    plte = rng.integers(0, 256, (n, 3), dtype=np.uint8).tobytes()
    alpha = (rng.integers(0, 256, max(1, n // 2), dtype=np.uint8).tobytes()
             if trns else None)
    for k, shape in enumerate(PACKED_SHAPES):
        path = str(tmp_path / f"p{k}.png")
        _encode_packed(path, rng.integers(0, n, shape + (1,)), 3, depth,
                       interlace, plte, alpha)
        _cv2_gray_equal(path)
        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(io.read_png(path),
                                      raw[..., [2, 1, 0, 3][:raw.shape[2]]])


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("interlace", [0, 1])
def test_low_bit_gray_reads_equal_cv2(tmp_path, depth, interlace):
    """Gray at 1, 2 and 4 bits, rows that end mid-byte: scaled to 8 bits
    as cv2 reads them (IMREAD_GRAYSCALE and IMREAD_UNCHANGED)."""
    rng = np.random.default_rng([depth, interlace])
    for k, shape in enumerate(PACKED_SHAPES):
        path = str(tmp_path / f"g{k}.png")
        _encode_packed(path, rng.integers(0, 1 << depth, shape + (1,)), 0,
                       depth, interlace)
        _cv2_gray_equal(path)
        np.testing.assert_array_equal(io.read_png(path),
                                      cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_adam7_reads_equal_cv2(tmp_path, depth, ctype, channels):
    """Adam7 in gray, RGB, gray + alpha and RGBA at 8 and 16 bits, every
    filter in every pass, on shapes with empty passes (1 x 1, 9 x 1)."""
    rng = np.random.default_rng([depth, ctype])
    for k, shape in enumerate(PACKED_SHAPES):
        a = rng.integers(0, 1 << depth, shape + (channels,))
        path = str(tmp_path / f"i{k}.png")
        _encode_packed(path, a, ctype, depth, interlace=1)
        _cv2_gray_equal(path)
        np.testing.assert_array_equal(io.read_png(path),
                                      a[..., 0] if channels == 1 else a)


# --- the C unfilter against both numpy decodes ------------------------------

@pytest.mark.parametrize("bpp", range(1, 9))
def test_native_unfilter_equals_numpy(bpp):
    """Random rows under every filter type (each row's type cycling through
    0-4, and runs of one type) at 1-8 bytes a pixel: the C unfilter equals
    the numpy row decode and the wavefront, byte for byte."""
    from tpustereo_torch import native
    rng = np.random.default_rng(bpp)
    for h, w, types in ((11, 13, np.arange(11) % 5), (5, 1, np.full(5, 4)),
                        (7, 9, np.full(7, 3)), (4, 6, np.array([1, 2, 1, 2]))):
        stride = w * bpp
        rows = rng.integers(0, 256, (h, 1 + stride), dtype=np.uint8)
        rows[:, 0] = types
        raw = rows.ravel()
        got = native.png_unfilter(raw, h, stride, bpp)
        np.testing.assert_array_equal(got, io._unfilter(raw, h, stride, bpp))
        np.testing.assert_array_equal(
            got, io._unfilter_wavefront(rows[:, 0], rows[:, 1:], bpp))
    rows[2, 0] = 5
    with pytest.raises(ValueError, match="bad PNG filter type 5"):
        native.png_unfilter(rows.ravel(), h, stride, bpp)


@pytest.mark.parametrize("side", [0, 1])
def test_native_unfilter_on_adaptive_fixture(side):
    """The committed libpng adaptive files (Paeth rows): C equals the
    wavefront decode on their inflated rows."""
    from tpustereo_torch import native
    path = os.path.join(os.path.dirname(__file__), "data",
                        f"adaptive_image_{side}.png")
    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    idat = b"".join(body for kind, body in io._chunks(data, path)
                    if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = raw.reshape(h, 1 + w)
    np.testing.assert_array_equal(
        native.png_unfilter(raw, h, w, 1),
        io._unfilter_wavefront(rows[:, 0], rows[:, 1:], 1))


def test_native_build_without_compiler_raises(tmp_path, monkeypatch):
    """No fallback: a compiler that is missing, or that fails, raises."""
    from tpustereo_torch import native
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="not found"):
        native.build(str(tmp_path / "build"))
    monkeypatch.setenv("CC", "false")
    with pytest.raises(RuntimeError, match="failed"):
        native.build(str(tmp_path / "build"))
    assert not os.path.exists(native.lib_path(str(tmp_path / "build")))


# --- loaders, on trees in the datasets' own layouts --------------------------

def _pairs(n, shape=(96, 160), d0=10.0):
    from tpustereo_torch.data import synthetic_pair
    out = []
    for i in range(n):
        L, R, gt, valid = synthetic_pair(shape, disparity=d0 + i,
                                         slope=0.04, seed=40 + i)
        out.append((L, R, np.where(valid & (gt > 0), gt, -1.0)))
    return out


def _colour(img, seed):
    """A colour image whose gray is near img, as a dataset's would be."""
    rng = np.random.default_rng(seed)
    c = img[..., None].astype(int) + rng.integers(-9, 10, img.shape + (3,))
    return np.clip(c, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("half_res", [False, True])
def test_middlebury_loader_matches_jax(tmp_path, half_res):
    scene = tmp_path / "Adirondack"
    os.makedirs(scene)
    (L, R, gt), = _pairs(1)
    cv2.imwrite(str(scene / "im0.png"), _colour(L, 1))
    cv2.imwrite(str(scene / "im1.png"), _colour(R, 2))
    jio.write_pfm(str(scene / "disp0GT.pfm"), np.where(gt > 0, gt, np.inf))
    ours = datasets.load_middlebury_pair(str(scene), half_res=half_res)
    theirs = jdatasets.load_middlebury_pair(str(scene), half_res=half_res)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert ours[0].shape == ((48, 80) if half_res else (96, 160))


def test_middlebury_loader_without_gt(tmp_path):
    (L, R, _), = _pairs(1)
    io.write_image(str(tmp_path / "im0.png"), L)
    io.write_image(str(tmp_path / "im1.png"), R)
    left, right, gt = datasets.load_middlebury_pair(str(tmp_path))
    assert gt is None and np.array_equal(left, L) and np.array_equal(right, R)


def _kitti2015_tree(root, pairs):
    for split in ("training", "testing"):
        for sub in ("image_2", "image_3", "disp_occ_0"):
            os.makedirs(root / split / sub)
        for i, (L, R, gt) in enumerate(pairs):
            name = f"{i:06d}_10.png"
            cv2.imwrite(str(root / split / "image_2" / name), _colour(L, i))
            cv2.imwrite(str(root / split / "image_3" / name), _colour(R, i))
            if split == "training":
                jio.write_kitti_disparity(
                    str(root / split / "disp_occ_0" / name), gt)


@pytest.mark.parametrize("training", [True, False])
def test_kitti2015_loader_matches_jax(tmp_path, training):
    root = tmp_path / "kitti2015"
    _kitti2015_tree(root, _pairs(2))
    for i in range(2):
        ours = datasets.load_kitti2015_pair(str(root), i, training=training)
        theirs = jdatasets.load_kitti2015_pair(str(root), i,
                                               training=training)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
        if training:
            np.testing.assert_array_equal(ours[2], theirs[2])
        else:
            assert ours[2] is None and theirs[2] is None


CALIB = ("P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
         "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n"
         "P2: 718.856 0 607.1928 45.38225 0 718.856 185.2157 -0.1130887 "
         "0 0 1 0.003779761\n")


def _odometry_tree(root, frames, ext=".png"):
    seq = root / "sequences" / "00"
    for sub in ("image_0", "image_1"):
        os.makedirs(seq / sub)
    (seq / "calib.txt").write_text(CALIB)
    for i, (L, R, _) in enumerate(frames):
        jio.write_image(str(seq / "image_0" / f"{i:06d}{ext}"), L)
        jio.write_image(str(seq / "image_1" / f"{i:06d}{ext}"), R)
    return seq


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("ext", [".png", ".pgm"])
def test_kitti_odometry_loader_matches_jax(tmp_path, prefetch, ext):
    frames = _pairs(4, d0=6.0)
    _odometry_tree(tmp_path, frames, ext)
    calib, it = datasets.kitti_odometry_sequence(
        str(tmp_path), "00", max_frames=3, prefetch=prefetch)
    jcalib, jit = jdatasets.kitti_odometry_sequence(
        str(tmp_path), "00", max_frames=3, prefetch=prefetch)
    assert calib == datasets.KittiCalib(**vars(jcalib))
    ours, theirs = list(it), list(jit)
    assert len(ours) == len(theirs) == 3
    for (a, b), (c, d), (L, R, _) in zip(ours, theirs, frames):
        for x, y, z in ((a, c, L), (b, d, R)):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


def test_prefetch_raises_at_the_failing_position(tmp_path):
    frames = _pairs(4, d0=6.0)
    seq = _odometry_tree(tmp_path, frames)
    with open(seq / "image_1" / "000002.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\ntruncated")
    _, it = datasets.kitti_odometry_sequence(str(tmp_path), prefetch=2)
    got = [next(it), next(it)]
    assert all(np.array_equal(g[0], f[0]) for g, f in zip(got, frames))
    with pytest.raises(ValueError, match="PNG"):
        next(it)


def test_prefetch_of_decoded_arrays_keeps_order():
    items = [(np.full((2, 2), i, np.uint8), np.full((2, 2), -i, np.int8))
             for i in range(7)]
    out = list(prefetch_pairs(iter(items), depth=3))
    assert len(out) == 7
    assert all(a[0][0, 0] == i for i, a in enumerate(out))
