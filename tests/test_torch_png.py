"""The port's PNG codec (data/png.py) against cv2, which the JAX package
reads and writes its datasets with: the decode of JAX `generate_dataset`'s
files, of files whose rows use each of the five filters (written here by
a row-by-row filter of the PNG specification), and the port's own files
read back by cv2, all bit for bit; and the files it refuses."""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from nerfsafetyvalidation_tpu.data.synthetic import generate_dataset
from nerfsafetyvalidation_tpu_torch.data import png


def _cv2_read(path):
    """cv2's image in RGB(A) order, as the JAX provider converts it."""
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                           else cv2.COLOR_BGR2RGB)
    return img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered_png(img, types):
    """A PNG of img [H, W, C] uint8 whose row r is filtered with
    types[r], byte by byte as the PNG specification defines the filters."""
    H, W, C = img.shape
    rows = img.reshape(H, W * C).astype(int)
    raw = bytearray()
    for r in range(H):
        t = types[r]
        raw.append(t)
        for i in range(W * C):
            a = rows[r, i - C] if i >= C else 0
            b = rows[r - 1, i] if r else 0
            c = rows[r - 1, i - C] if r and i >= C else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[t]
            raw.append((rows[r, i] - pred) % 256)

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, {3: 2, 4: 6}[C], 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def test_decode_matches_cv2_on_the_jax_dataset(tmp_path):
    """JAX `generate_dataset`'s RGBA views (cv2's writer): every file
    decodes to cv2's pixels."""
    generate_dataset(str(tmp_path), n_train=2, n_val=1, n_test=1, H=40,
                     W=48)
    files = sorted(p for p in os.listdir(tmp_path) if p.endswith(".png"))
    assert len(files) == 4
    for name in files:
        got = png.read_png(tmp_path / name)
        assert got.dtype == np.uint8 and got.shape == (40, 48, 4)
        assert np.array_equal(got, _cv2_read(tmp_path / name))


@pytest.mark.parametrize("channels", [3, 4])
def test_every_filter_decodes_as_cv2_does(tmp_path, channels):
    """Rows filtered None, Sub, Up, Average and Paeth in turn, and an
    image of Sub and Up rows only (the row-by-row decode): cv2 and the
    port read the same pixels, which are the image written."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    img[4:9, 3:12] = 200                      # runs, for the predictors
    for types in ([r % 5 for r in range(23)], [1 + r % 2 for r in range(23)]):
        path = tmp_path / "f.png"
        path.write_bytes(_filtered_png(img, types))
        assert np.array_equal(_cv2_read(path), img)
        assert np.array_equal(png.read_png(path), img)


@pytest.mark.parametrize("shape", [(31, 29, 4), (16, 40, 3), (12, 7)])
@pytest.mark.parametrize("filter_type", [png.NONE, png.SUB])
def test_written_png_reads_back_in_cv2(tmp_path, shape, filter_type):
    """RGBA, RGB and greyscale, filter None or Sub: cv2 reads the pixels
    written, and so does the port."""
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "w.png"
    png.write_png(path, img, filter_type)
    assert np.array_equal(_cv2_read(path), img)
    assert np.array_equal(png.read_png(path), img)


def test_unsupported_files_raise(tmp_path):
    """16-bit samples, a palette, interlacing, a corrupt chunk and
    another filter on writing all raise; nothing is guessed."""
    img = np.zeros((4, 4, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "16.png"), np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        png.read_png(tmp_path / "16.png")
    data = bytearray(png.encode_png(img))
    ihdr = data.index(b"IHDR")
    # IHDR's body starts 4 bytes after its tag: colour type 3 (a palette)
    # at byte 9 of it, interlace 1 at byte 12
    for offset, value in ((13, 3), (16, 1)):
        bad = bytearray(data)
        bad[ihdr + offset] = value
        body = bytes(bad[ihdr:ihdr + 17])
        bad[ihdr + 17:ihdr + 21] = struct.pack(">I", zlib.crc32(body))
        with pytest.raises(ValueError):
            png.decode_png(bytes(bad))
    bad = bytearray(data)
    bad[-20] ^= 0xFF                          # inside IDAT: its CRC fails
    with pytest.raises(ValueError):
        png.decode_png(bytes(bad))
    with pytest.raises(ValueError):
        png.encode_png(img, png.PAETH)
    with pytest.raises(ValueError):
        png.encode_png(img.astype(np.float32))
