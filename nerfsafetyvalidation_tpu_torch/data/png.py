"""PNG files with zlib and numpy alone, for the dataset's images and the
trainer's frames (the JAX package reads and writes them with cv2, which
the card's machine does not have).

`read_png` decodes 8-bit, non-interlaced greyscale, RGB and RGBA files
with any of the five row filters, and raises on anything else (palettes,
16-bit samples, interlacing). It returns the channels in RGB(A) order, as
`cv2.cvtColor(cv2.imread(path, cv2.IMREAD_UNCHANGED), BGR(A)2RGB(A))`
gives them. Rows filtered with None, Sub or Up decode one row at a time,
each row in whole-array operations; Average and Paeth make each pixel
depend on the one to its left, so an image with such rows decodes in
anti-diagonals of pixels, each diagonal in whole-array operations.
`write_png` encodes 8-bit greyscale, RGB or RGBA with filter None or Sub
on every row."""

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}           # colour type -> channels
COLOR_TYPE = {c: t for t, c in CHANNELS.items()}
NONE, SUB, UP, AVERAGE, PAETH = range(5)


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(tag + body) != crc:
            raise ValueError(f"PNG chunk {tag!r}: bad CRC")
        yield tag, body
        pos += 12 + n


def _unfilter_rows(types, filt):
    """Rows filtered None, Sub or Up: one row at a time. filt [H, W, C]
    uint8; uint8 sums wrap modulo 256, as the filters' sums do."""
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for r, t in enumerate(types):
        if t == NONE:
            out[r] = filt[r]
        elif t == SUB:
            out[r] = np.cumsum(filt[r], axis=0, dtype=np.uint8)
        else:
            out[r] = filt[r] + prev
        prev = out[r]
    return out


def _unfilter_diagonals(types, filt):
    """Any filters: the pixels of each anti-diagonal r + c = k together
    (pixel (r, c) needs (r, c - 1), (r - 1, c) and (r - 1, c - 1))."""
    H, W, _ = filt.shape
    out = np.zeros((H + 1, W + 1, filt.shape[2]), np.int16)   # a zero
    f = filt.astype(np.int16)                                  # border
    t = types.astype(np.int16)
    rows = np.arange(H)
    for k in range(H + W - 1):
        r = rows[max(0, k - W + 1):min(H, k + 1)]
        c = k - r
        a, b, cc = out[r + 1, c], out[r, c + 1], out[r, c]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        ft = t[r][:, None]
        pred = np.select([ft == SUB, ft == UP, ft == AVERAGE, ft == PAETH],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, c + 1] = (f[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """A PNG file's bytes -> uint8 [H, W] (greyscale) or [H, W, 3 | 4]."""
    header, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        elif tag[:1].isupper():
            raise ValueError(f"PNG chunk {tag!r} is not supported")
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, color, compression, filter_method, interlace = header
    if depth != 8 or color not in CHANNELS or compression or \
            filter_method or interlace:
        raise ValueError(f"only 8-bit non-interlaced greyscale, RGB and "
                         f"RGBA PNGs are read, not bit depth {depth}, "
                         f"colour type {color}, interlace {interlace}")
    C = CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(H, 1 + W * C)
    types, filt = raw[:, 0], raw[:, 1:].reshape(H, W, C)
    if types.max(initial=0) > PAETH:
        raise ValueError(f"PNG row filter {int(types.max())} is unknown")
    if np.isin(types, (AVERAGE, PAETH)).any():
        img = _unfilter_diagonals(types, filt)
    else:
        img = _unfilter_rows(types, filt)
    return img[..., 0] if C == 1 else img


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(img, filter_type: int = SUB) -> bytes:
    """uint8 [H, W] / [H, W, 1 | 3 | 4] -> PNG bytes, every row filtered
    with None (0) or Sub (1)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG images are uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {img.shape}")
    if filter_type not in (NONE, SUB):
        raise ValueError("rows are written with filter None or Sub")
    H, W, C = img.shape
    filt = img.copy()
    if filter_type == SUB:
        filt[:, 1:] = img[:, 1:] - img[:, :-1]       # wraps modulo 256
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8),
                          filt.reshape(H, W * C)], axis=1)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, COLOR_TYPE[C], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path, img, filter_type: int = SUB):
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
