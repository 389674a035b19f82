"""The port's image module (``data/image_io.py``) against OpenCV.

PNG: every bit depth and colour type the databases meet (8 and 16 bits;
gray, gray + alpha, RGB, RGBA; palette, with and without ``tRNS``; gray and
palette below 8 bits), every row filter, decoded bit-equal to
``cv2.imread(IMREAD_UNCHANGED)`` (in RGB(A) order), and the port's writes
read back bit-equal by ``cv2``.  Resampling: ``resize`` (linear, nearest,
area at integer and fractional ratios), ``warp_perspective`` and
``gaussian_blur`` against ``cv2``: float images to 1e-5, uint8 to one level
(cv2 rounds fixed-point coefficients; the port rounds float64 results).
"""

import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from nunerf_tpu_torch.data import image_io as io


def _rgb(img):
    """cv2's BGR(A) -> RGB(A)."""
    if img.ndim == 3:
        return img[..., [2, 1, 0, 3]] if img.shape[-1] == 4 else img[..., ::-1]
    return img


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _raw_png(w, h, depth, ctype, rows, extra=b"", interlace=0):
    """A PNG of already-filtered rows (each with its filter byte)."""
    return (io.PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
            + extra + _chunk(b"IDAT", zlib.compress(rows)) + _chunk(b"IEND", b""))


IMAGES = {
    "gray": (17, 23),
    "gray_alpha": (17, 23, 2),
    "rgb": (17, 23, 3),
    "rgba": (17, 23, 4),
}


@pytest.mark.parametrize("png_filter", range(5))
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_png_written_and_read_match_cv2(tmp_path, kind, depth, png_filter):
    dtype = np.uint8 if depth == 8 else np.uint16
    rs = np.random.RandomState(depth + png_filter)
    img = (rs.rand(*IMAGES[kind]) * np.iinfo(dtype).max).astype(dtype)
    img[:3] = img[:1]  # flat rows, where the filters' predictions are exact
    path = str(tmp_path / "x.png")
    io.imwrite(path, img, png_filter=png_filter)
    ours = io.imread(path)
    theirs = _rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert ours.dtype == theirs.dtype == dtype
    assert np.array_equal(ours, theirs)
    want = np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]], -1) \
        if kind == "gray_alpha" else img
    assert np.array_equal(ours, want)


@pytest.mark.parametrize("kind", ["gray", "rgb", "rgba"])
def test_png_written_by_cv2_decodes_bit_equal(tmp_path, kind):
    """cv2's own writer (its choice of filters and compression)."""
    rs = np.random.RandomState(3)
    img = (rs.rand(*IMAGES[kind]) * 255).astype(np.uint8)
    img[5:9] = 7
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, img)
    assert np.array_equal(io.imread(path), _rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("trns", [False, True])
def test_palette_png_matches_cv2(tmp_path, depth, trns):
    rs = np.random.RandomState(depth)
    w, h, n = 13, 7, 1 << min(depth, 4)
    plte = rs.randint(0, 256, (n, 3)).astype(np.uint8)
    idx = rs.randint(0, n, (h, w)).astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = idx
    packed = np.zeros((h, padded.shape[1] // per), np.uint8)
    for k in range(per):
        packed |= padded[:, k::per] << np.uint8(8 - depth * (k + 1))
    rows = b"".join(b"\x00" + r.tobytes() for r in packed)
    extra = _chunk(b"PLTE", plte.tobytes())
    if trns:
        extra += _chunk(b"tRNS", rs.randint(0, 256, max(1, n - 1)).astype(np.uint8).tobytes())
    path = str(tmp_path / "p.png")
    with open(path, "wb") as f:
        f.write(_raw_png(w, h, depth, 3, rows, extra))
    ours = io.imread(path)
    assert ours.shape == (h, w, 4 if trns else 3)
    assert np.array_equal(ours, _rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_gray_matches_cv2(tmp_path, depth):
    rs = np.random.RandomState(depth)
    w, h = 21, 5
    raw = rs.randint(0, 256, (h, -(-w * depth // 8))).astype(np.uint8)
    rows = b"".join(b"\x00" + r.tobytes() for r in raw)
    path = str(tmp_path / "g.png")
    with open(path, "wb") as f:
        f.write(_raw_png(w, h, depth, 0, rows))
    assert np.array_equal(io.imread(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_rgb_with_transparent_key_matches_cv2(tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    img[1, 2] = (1, 2, 3)
    rows = b"".join(b"\x00" + r.tobytes() for r in img.reshape(4, -1))
    path = str(tmp_path / "k.png")
    with open(path, "wb") as f:
        f.write(_raw_png(5, 4, 8, 2, rows, _chunk(b"tRNS", struct.pack(">HHH", 1, 2, 3))))
    assert np.array_equal(io.imread(path), _rgb(cv2.imread(path, cv2.IMREAD_UNCHANGED)))


def test_unsupported_files_raise_naming_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "interlaced.png")
    with open(path, "wb") as f:
        f.write(_raw_png(2, 2, 8, 0, b"\x00\x01\x02" * 2, interlace=1))
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        io.imread(path)
    with pytest.raises(FileNotFoundError):
        io.imread(str(tmp_path / "missing.png"))
    jpg = str(tmp_path / "photo.jpg")
    cv2.imwrite(jpg, np.full((8, 8, 3), 100, np.uint8))
    assert io.imread(jpg).shape == (8, 8, 3)
    # without OpenCV, JPEG has no decoder: the error names cv2 and the file
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="photo.jpg needs cv2"):
        io.imread(jpg)
    with pytest.raises(ImportError, match="cv2"):
        io.imwrite(str(tmp_path / "out.jpg"), np.zeros((4, 4, 3), np.uint8))
    io.imwrite(str(tmp_path / "still.png"), np.zeros((4, 4, 3), np.uint8))
    assert os.path.exists(tmp_path / "still.png")


SIZES = [(13, 9), (26, 18), (100, 80), (53, 37), (20, 37)]


@pytest.mark.parametrize("dsize", SIZES)
def test_resize_linear_and_nearest_match_cv2(dsize):
    rs = np.random.RandomState(0)
    f = rs.rand(37, 53, 3).astype(np.float32)
    u = (rs.rand(37, 53, 3) * 255).astype(np.uint8)
    m = (rs.rand(37, 53) > 0.5).astype(np.float32)
    np.testing.assert_allclose(io.resize(f, dsize, "linear"),
                               cv2.resize(f, dsize, interpolation=cv2.INTER_LINEAR), atol=1e-5)
    diff = io.resize(u, dsize, "linear").astype(int) - cv2.resize(
        u, dsize, interpolation=cv2.INTER_LINEAR).astype(int)
    assert np.abs(diff).max() <= 1
    assert np.array_equal(io.resize(m, dsize, "nearest"),
                          cv2.resize(m, dsize, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("dsize", [(13, 9), (26, 18), (51, 35), (17, 12), (20, 10)])
def test_resize_area_matches_cv2(dsize):
    """Integer ratios (52x36 -> 26x18, 60x40 -> 20x10) and fractional ones."""
    rs = np.random.RandomState(1)
    f = rs.rand(37, 53, 3).astype(np.float32)
    u = (rs.rand(40, 60, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(io.resize(f, dsize, "area"),
                               cv2.resize(f, dsize, interpolation=cv2.INTER_AREA), atol=1e-5)
    for src in (u, u[:36, :52]):
        diff = io.resize(src, dsize, "area").astype(int) - cv2.resize(
            src, dsize, interpolation=cv2.INTER_AREA).astype(int)
        assert np.abs(diff).max() <= 1
    with pytest.raises(ValueError, match="shrinks"):
        io.resize(f, (100, 100), "area")


@pytest.mark.parametrize("H", [
    [[1.1, 0.05, -3], [0.02, 0.95, 2], [1e-3, -5e-4, 1]],
    [[0.8, 0.1, 5], [-0.1, 1.2, -4], [2e-3, 1e-3, 1.1]],
    [[1.0, 0.0, 0.3], [0.0, 1.0, 0.2], [0.0, 0.0, 1.0]],
])
def test_warp_perspective_matches_cv2(H):
    H = np.asarray(H)
    rs = np.random.RandomState(2)
    f = rs.rand(40, 40, 3).astype(np.float32)
    u = (rs.rand(40, 40, 3) * 255).astype(np.uint8)
    for img, tol in ((f, 1e-5), (f[..., 0], 1e-5), (u, 1)):
        ours = io.warp_perspective(img, H, (35, 45))
        theirs = cv2.warpPerspective(img, H, (35, 45), flags=cv2.INTER_LINEAR)
        assert ours.dtype == theirs.dtype
        assert np.abs(ours.astype(np.float64) - theirs).max() <= tol


def test_gaussian_blur_matches_cv2():
    rs = np.random.RandomState(4)
    np.testing.assert_allclose(io.gaussian_kernel(11, 1.5),
                               cv2.getGaussianKernel(11, 1.5)[:, 0], atol=1e-15)
    for img in (rs.rand(30, 40), rs.rand(30, 40, 3).astype(np.float32), rs.rand(7, 9)):
        np.testing.assert_allclose(io.gaussian_blur(img, 11, 1.5),
                                   cv2.GaussianBlur(img, (11, 11), 1.5), atol=1e-5)
    u = (rs.rand(30, 40, 3) * 255).astype(np.uint8)
    diff = io.gaussian_blur(u, 11, 1.5).astype(int) - cv2.GaussianBlur(u, (11, 11), 1.5)
    assert np.abs(diff).max() <= 1
