"""OpenCV's `cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA)` on
uint8 images [h, w, C], in numpy: how the JAX package's dataset
brings an image to its split's size (provider.py:162-163). The port does
not depend on cv2; this module follows OpenCV's resize.cpp rule by rule,
so the pixels are the same.

Scales are OpenCV's doubles: scale = 1 / (dst / src) per axis.

* Shrinking on both axes (scale_x >= 1 and scale_y >= 1):
  - integer scales (`is_area_fast`): each output is the mean of its
    iscale_y x iscale_x block; at 2 x 2 the integer (sum + 2) >> 2 (the
    vector path's rounding), at other factors round(sum * (1 / area)) in
    float32; a block cut by the image's edge averages what it holds;
  - otherwise `resizeArea`: each source pixel weighs by the share of it
    that the output cell covers (`_area_tab`), summed in float32 in
    OpenCV's order, rounded to nearest (ties to even).
* Otherwise (enlarging on an axis): OpenCV's bilinear variant of INTER_AREA
  in fixed point: per axis the source index floor(d * scale) and the
  fraction (d + 1) - (s + 1) / scale, kept only where it is positive and
  then taken modulo 1 (so integer enlargements replicate pixels); 11-bit
  weights, the horizontal pass in int32 and the vertical pass with
  OpenCV's uint8 shift rule.
"""

import numpy as np

_DBL_EPSILON = np.finfo(np.float64).eps
_COEF_SCALE = 2048          # INTER_RESIZE_COEF_SCALE (11 bits)


def _round_even(x):
    """cvRound: to nearest, ties to even."""
    return np.rint(x)


def _area_tab(ssize: int, dsize: int, scale: float):
    """computeResizeAreaTab: (dst index, src index, float32 weight) per
    term, in OpenCV's order."""
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            di.append(dx)
            si.append(sx1 - 1)
            alpha.append((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            di.append(dx)
            si.append(sx)
            alpha.append(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            di.append(dx)
            si.append(sx2)
            alpha.append(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return (np.asarray(di), np.asarray(si),
            np.asarray(alpha, dtype=np.float64).astype(np.float32))


def _terms(di, si, alpha):
    """The table as a list of term slots: slot t holds, for every dst index
    that has a t-th term, (dst, src, weight), so that adding slot after slot
    keeps OpenCV's per-output order."""
    slots = []
    pos = np.zeros(di.max() + 1 if len(di) else 0, dtype=np.int64)
    rank = np.empty(len(di), dtype=np.int64)
    for k, d in enumerate(di):
        rank[k] = pos[d]
        pos[d] += 1
    for t in range(int(pos.max()) if len(pos) else 0):
        sel = rank == t
        slots.append((di[sel], si[sel], alpha[sel]))
    return slots


def _resize_area(img, W: int, H: int, scale_x: float, scale_y: float):
    """resizeArea_<uchar, float> (ResizeArea_Invoker): float32 sums."""
    h, w, C = img.shape
    src = img.astype(np.float32)
    xslots = _terms(*_area_tab(w, W, scale_x))
    ydi, ysi, ya = _area_tab(h, H, scale_y)
    out = np.zeros((H, W, C), dtype=np.uint8)
    total = np.zeros((W, C), dtype=np.float32)
    prev = ydi[0]
    for dy, sy, beta in zip(ydi, ysi, ya):
        buf = np.zeros((W, C), dtype=np.float32)
        for d, s, a in xslots:
            buf[d] = buf[d] + src[sy, s] * a[:, None]
        if dy != prev:
            out[prev] = np.clip(_round_even(total), 0, 255)
            total = beta * buf
            prev = dy
        else:
            total = total + beta * buf
    out[prev] = np.clip(_round_even(total), 0, 255)
    return out


def _resize_area_fast(img, W: int, H: int, sx: int, sy: int):
    """resizeAreaFast_ (ResizeAreaFast_Invoker and, at 2 x 2, its vector
    path): integer block means."""
    h, w, C = img.shape
    out = np.zeros((H, W, C), dtype=np.uint8)
    full_w, full_h = w // sx, h // sy
    src = img.astype(np.int64)
    if full_w and full_h:
        blocks = src[:full_h * sy, :full_w * sx].reshape(
            full_h, sy, full_w, sx, C).sum(axis=(1, 3))
        if sx == 2 and sy == 2:
            vals = (blocks + 2) >> 2
        else:
            scale = np.float32(1.0) / np.float32(sx * sy)
            vals = _round_even(blocks.astype(np.float32) * scale)
        out[:min(full_h, H), :min(full_w, W)] = np.clip(
            vals[:H, :W], 0, 255)
    # outputs whose block the image's edge cuts: the mean of what is left
    for dy in range(H):
        for dx in range(W) if dy >= full_h else range(full_w, W):
            y0, x0 = dy * sy, dx * sx
            if y0 >= h or x0 >= w:
                continue
            blk = src[y0:min(y0 + sy, h), x0:min(x0 + sx, w)]
            count = blk.shape[0] * blk.shape[1]
            out[dy, dx] = np.clip(_round_even(
                blk.sum(axis=(0, 1)).astype(np.float32)
                / np.float32(count)), 0, 255)
    return out


def _linear_axis(ssize: int, dsize: int, scale: float, inv_scale: float):
    """Per output index: the source index and the two 11-bit weights of
    INTER_AREA's bilinear variant (resizeGeneric_'s `area_mode`)."""
    idx = np.empty(dsize, dtype=np.int64)
    wts = np.empty((dsize, 2), dtype=np.int64)
    for d in range(dsize):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv_scale)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.floor(f))
        if s >= ssize - 1:
            s, f = ssize - 1, np.float32(0.0)
        idx[d] = s
        c0 = np.float32(np.float32(1.0) - f)
        wts[d] = [_round_even(c0 * np.float32(_COEF_SCALE)),
                  _round_even(f * np.float32(_COEF_SCALE))]
    return idx, wts


def _resize_linear_area(img, W: int, H: int, sx: float, sy: float,
                        inv_x: float, inv_y: float):
    h, w, C = img.shape
    xi, xw = _linear_axis(w, W, sx, inv_x)
    yi, yw = _linear_axis(h, H, sy, inv_y)
    src = img.astype(np.int64)
    x1 = np.minimum(xi + 1, w - 1)
    rows = (src[:, xi] * xw[None, :, 0, None]
            + src[:, x1] * xw[None, :, 1, None])       # [h, W, C] int32
    r0 = rows[np.clip(yi, 0, h - 1)]
    r1 = rows[np.clip(yi + 1, 0, h - 1)]
    b0 = yw[:, 0, None, None]
    b1 = yw[:, 1, None, None]
    val = (((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2) >> 2
    return (val & 0xFF).astype(np.uint8)


def resize_area(image, W: int, H: int):
    """`cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA)` of a uint8
    image [h, w, C]."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise TypeError("resize_area takes uint8 images [h, w, C]")
    h, w = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()
    inv_x, inv_y = W / w, H / h
    sx, sy = 1.0 / inv_x, 1.0 / inv_y
    if sx < 1 or sy < 1:
        return _resize_linear_area(img, W, H, sx, sy, inv_x, inv_y)
    isx, isy = int(_round_even(sx)), int(_round_even(sy))
    if abs(sx - isx) < _DBL_EPSILON and abs(sy - isy) < _DBL_EPSILON:
        return _resize_area_fast(img, W, H, isx, isy)
    return _resize_area(img, W, H, sx, sy)
