"""Image files and image resampling without OpenCV: the port's own copy of
what the JAX data layer asks of ``cv2`` (``nunerf_tpu/data/database.py:51-76``,
``:278``, ``:312``; ``nunerf_tpu/train/metrics.py:35-39``;
``nunerf_tpu/train/trainer.py:335-342``).  Numpy, ``zlib`` and ``struct``
only: the machine that trains may have no ``cv2``.

* ``imread`` / ``imwrite``: PNG of 1 to 16 bits, gray, gray + alpha, RGB,
  RGBA and palette (with ``tRNS``), every row filter when reading, in RGB(A)
  channel order and with ``cv2.imread(IMREAD_UNCHANGED)``'s expansions
  (gray + alpha and palette with ``tRNS`` become RGBA, gray below 8 bits is
  scaled to 0-255).  The writer uses filter 0 unless asked for another.
  Rows with the Average or
  Paeth filter depend on their left neighbour, so they are decoded along
  anti-diagonals of the image (``_unfilter_wavefront``).  JPEG goes through
  ``cv2``, imported when a JPEG is met, and raises naming ``cv2`` and the file
  where it is missing: there is no substitute decoder.
* ``resize``: ``cv2.resize``'s ``INTER_LINEAR`` (half-pixel centres, no
  antialias), ``INTER_NEAREST`` (``floor(dst * scale)``) and ``INTER_AREA``
  (shrinking, at integer and fractional ratios).
* ``warp_perspective``: ``cv2.warpPerspective``, bilinear, constant border
  0.
* ``gaussian_blur``: ``cv2.GaussianBlur``, ``getGaussianKernel``'s weights,
  ``BORDER_REFLECT_101``.

Floating images come back in their own dtype; 8- and 16-bit images are
resampled in float64 and rounded, which is within one level of ``cv2``'s
fixed-point arithmetic.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_JPEG = (".jpg", ".jpeg")


def _cv2(path: str, what: str):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} {path} needs cv2 (OpenCV), which is not "
                          "installed: the port decodes and encodes only PNG "
                          "itself") from e
    return cv2


# ---------------------------------------------------------------------------
# PNG


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG without IEND")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_rows(ftype, filt, bpp):
    """Rows of the filters None, Sub and Up only: row by row, each row at
    once.  filt [h, stride] uint8 -> the image bytes [h, stride]."""
    h, stride = filt.shape
    out = np.empty_like(filt)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row = filt[y]
        if ftype[y] == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype[y] == 2:
            row = row + prev
        out[y] = row
        prev = out[y]
    return out


def _unfilter_wavefront(ftype, filt, bpp):
    """Any mix of the five filters.  A byte depends on its left neighbour
    (a), the one above (b) and the one above-left (c), so all pixels of one
    anti-diagonal x + y = s are decoded together from the two before it:
    h + w steps, each over at most min(h, w) pixels."""
    h, stride = filt.shape
    n = stride // bpp
    f = filt.reshape(h, n, bpp).astype(np.int32)
    rec = np.zeros((h + 1, n + 1, bpp), np.int32)  # row 0 and column 0 are zero
    kind = ftype.astype(np.int32)
    for s in range(h + n - 1):
        ys = np.arange(max(0, s - n + 1), min(h, s + 1))
        xs = s - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        k = kind[ys][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        rec[ys + 1, xs + 1] = (f[ys, xs] + pred) & 255
    return rec[1:, 1:].reshape(h, stride).astype(np.uint8)


def _decode_png(data: bytes, path: str) -> np.ndarray:
    ihdr, plte, trns, idat = None, None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt_method, interlace = ihdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or comp or filt_method:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type "
                         f"{ctype}, compression {comp}, filter method {filt_method})")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG (Adam7) is not supported")
    ch = _CHANNELS[ctype]
    bits = depth * ch
    stride = (w * bits + 7) // 8
    bpp = max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: image data too short")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(ftype.max())}")
    if (ftype >= 3).any():
        img = _unfilter_wavefront(ftype, filt, bpp)
    else:
        img = _unfilter_rows(ftype, filt, bpp)

    if depth == 16:
        px = img.view(">u2").astype(np.uint16).reshape(h, w, ch)
    elif depth == 8:
        px = img.reshape(h, w, ch)
    else:  # 1, 2 or 4 bits: one sample a pixel, packed from the high bits
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((img[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if ctype == 0:  # gray scaled to 0-255
            px = px * np.uint8(255 // ((1 << depth) - 1))
        px = px.reshape(h, w, 1)

    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = px[..., 0]
        if idx.max(initial=0) >= len(plte):
            raise ValueError(f"{path}: palette index out of range")
        if trns is None:
            return plte[idx]
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(plte)]
        return np.concatenate([plte[idx], alpha[idx][..., None]], -1)
    if ctype == 0:
        return px[..., 0]
    if ctype == 4:
        return np.concatenate([px[..., :1].repeat(3, -1), px[..., 1:]], -1)
    if ctype == 2 and trns is not None:
        key = np.asarray(struct.unpack(">HHH", trns[:6]), px.dtype)
        opaque = np.iinfo(px.dtype).max
        alpha = np.where((px == key).all(-1), 0, opaque).astype(px.dtype)
        return np.concatenate([px, alpha[..., None]], -1)
    return px


def _filter_rows(raw, png_filter: int, bpp: int):
    """The image bytes [h, stride] under one row filter (0-4) -> the filtered
    rows with their filter byte, [h, 1 + stride] uint8."""
    r = raw.astype(np.int32)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[png_filter]
    out = np.empty((r.shape[0], 1 + r.shape[1]), np.uint8)
    out[:, 0] = png_filter
    out[:, 1:] = (r - pred) & 255
    return out


def _encode_png(img: np.ndarray, png_filter: int = 0) -> bytes:
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, ch = 0, 1
    elif img.ndim == 3 and img.shape[-1] in (2, 3, 4):
        ch = img.shape[-1]
        ctype = {2: 4, 3: 2, 4: 6}[ch]
    else:
        raise ValueError(f"PNG takes [h, w] or [h, w, 1-4] images, got {img.shape}")
    h, w = img.shape[:2]
    depth = 8 if img.dtype == np.uint8 else 16
    if png_filter not in range(5):
        raise ValueError(f"PNG row filter {png_filter}: 0 to 4")
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = _filter_rows(px.reshape(h, -1).view(np.uint8), png_filter, ch * depth // 8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def imread(path: str) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread(path, IMREAD_UNCHANGED)`` reads
    it, in RGB(A) order: [h, w] gray or [h, w, 3 | 4], uint8 or uint16."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        return _decode_png(data, path)
    if data[:2] == b"\xff\xd8" or path.lower().endswith(_JPEG):
        cv2 = _cv2(path, "reading")
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"{path}: cv2 could not decode it")
        if img.ndim == 3:
            img = img[..., [2, 1, 0, 3]] if img.shape[-1] == 4 else img[..., ::-1]
        return np.ascontiguousarray(img)
    raise ValueError(f"{path}: neither PNG nor JPEG")


def imwrite(path: str, img: np.ndarray, png_filter: int = 0):
    """Write ``img`` (RGB(A) order, or gray) to ``path``: PNG by this module
    (every row with the filter ``png_filter``, 0 None to 4 Paeth), JPEG
    through ``cv2``."""
    img = np.asarray(img)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = _encode_png(img, png_filter)
        with open(path, "wb") as f:
            f.write(data)
        return
    if ext in _JPEG:
        cv2 = _cv2(path, "writing")
        if img.ndim == 3:
            img = img[..., [2, 1, 0, 3]] if img.shape[-1] == 4 else img[..., ::-1]
        if not cv2.imwrite(path, np.ascontiguousarray(img)):
            raise ValueError(f"{path}: cv2 could not write it")
        return
    raise ValueError(f"{path}: imwrite writes .png (and .jpg through cv2)")


# ---------------------------------------------------------------------------
# resampling


def _as_float(img):
    return img.astype(np.float64) if img.dtype.kind in "ui" else img


def _back(out, dtype):
    """float -> the input's dtype: integers rounded and saturated."""
    if np.dtype(dtype).kind in "ui":
        info = np.iinfo(dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(dtype)
    return out.astype(dtype)


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR taps along one axis: the source position of each
    destination centre, ``(d + 0.5) * src / dst - 0.5``, clamped at both
    borders -> (i0, i1, weight of i1)."""
    scale = src / dst
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0
    frac = np.where(i0 < 0, 0.0, frac)
    i0 = np.clip(i0, 0, src - 1)
    frac = np.where(i0 >= src - 1, 0.0, frac)
    i1 = np.minimum(i0 + 1, src - 1)
    return i0, i1, frac


def _area_weights(src: int, dst: int) -> np.ndarray:
    """cv2's INTER_AREA weights along one axis when shrinking
    (``computeResizeAreaTab``): [dst, src], each row the share of every
    source pixel in the destination cell."""
    scale = src / dst
    wts = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            wts[d, s1 - 1] += (s1 - f1) / cell
        wts[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            wts[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return wts


def resize(img: np.ndarray, dsize, interpolation: str = "linear") -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=INTER_<LINEAR|NEAREST|AREA>)``:
    ``dsize`` is (width, height); ``interpolation`` is "linear", "nearest" or
    "area" (shrinking only, as the databases use it)."""
    img = np.asarray(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    if dw < 1 or dh < 1:
        raise ValueError(f"resize to {dsize}: sizes must be positive")
    if interpolation == "nearest":
        # cv2's resizeNN: floor(d / (dst / src)) in double, clamped
        ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
        xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
        return img[ys][:, xs]
    x = _as_float(img)
    if interpolation == "linear":
        y0, y1, fy = _linear_taps(h, dh)
        x0, x1, fx = _linear_taps(w, dw)
        fy = fy.reshape((-1,) + (1,) * (img.ndim - 1))
        fx = fx.reshape((-1,) + (1,) * (img.ndim - 2))
        rows = x[y0] * (1 - fy) + x[y1] * fy
        out = rows[:, x0] * (1 - fx[None]) + rows[:, x1] * fx[None]
    elif interpolation == "area":
        if dw > w or dh > h:
            raise ValueError("area resize shrinks only (the databases shrink with it)")
        out = np.tensordot(_area_weights(h, dh), x, axes=(1, 0))
        out = np.moveaxis(np.tensordot(_area_weights(w, dw), out, axes=(1, 1)), 0, 1)
    else:
        raise ValueError(f"interpolation {interpolation!r}: linear, nearest or area")
    return _back(out, img.dtype)


def warp_perspective(img: np.ndarray, H: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpPerspective(img, H, dsize, flags=INTER_LINEAR)`` with a
    constant border of 0: each destination pixel (x, y) samples the source at
    ``H^-1 (x, y, 1)`` from its four neighbours, taking 0 for a neighbour
    outside the image.  The position is not rounded, as OpenCV from 4.11 on
    samples it (earlier releases round it to 1/32 of a pixel)."""
    img = np.asarray(img)
    dw, dh = int(dsize[0]), int(dsize[1])
    h, w = img.shape[:2]
    M = np.linalg.inv(np.asarray(H, np.float64))
    xs, ys = np.meshgrid(np.arange(dw, dtype=np.float64), np.arange(dh, dtype=np.float64))
    W = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    W = np.where(W != 0, 1.0 / np.where(W != 0, W, 1.0), 0.0)
    # far outside, every tap is border: clip before the integer part
    X = np.clip((M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) * W, -2.0, w + 1.0)
    Y = np.clip((M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) * W, -2.0, h + 1.0)
    sx, sy = np.floor(X).astype(np.int64), np.floor(Y).astype(np.int64)
    ax, ay = X - sx, Y - sy
    if img.ndim == 3:
        ax, ay = ax[..., None], ay[..., None]
    x = _as_float(img)

    def tap(px, py):
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        v = x[np.clip(py, 0, h - 1), np.clip(px, 0, w - 1)]
        return np.where(inside[..., None] if img.ndim == 3 else inside, v, 0.0)

    out = ((tap(sx, sy) * (1 - ax) + tap(sx + 1, sy) * ax) * (1 - ay)
           + (tap(sx, sy + 1) * (1 - ax) + tap(sx + 1, sy + 1) * ax) * ay)
    return _back(out, img.dtype)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(ksize, sigma)`` for sigma > 0, in float64."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: np.ndarray, ksize: int = 11, sigma: float = 1.5) -> np.ndarray:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)``: the separable
    Gaussian with ``BORDER_REFLECT_101`` (numpy's "reflect")."""
    img = np.asarray(img)
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    x = _as_float(img)
    for axis in (0, 1):
        pad = [(0, 0)] * x.ndim
        pad[axis] = (r, r)
        p = np.pad(x, pad, mode="reflect")
        n = x.shape[axis]
        x = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis) for i in range(ksize))
    return _back(x, img.dtype)
