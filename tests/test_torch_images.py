"""The port's image reader (`mvsmplfitting_tpu_torch.data.images`) against
`cv2.imread`, which the JAX pipeline reads camera images with.

The committed fixtures (`tests/fixtures/images`, written by
`tools/make_image_fixtures.py`) are decoded by both and compared
bitwise, and against the sha256 of OpenCV's array recorded beside them
(what `chip_smoke.py` holds the reader to where OpenCV is absent).  A
few more PNG layouts are made here on the fly.
"""

import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mvsmplfitting_tpu_torch.data import images as I  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "images")
with open(os.path.join(FIXTURES, "decoded.json")) as _f:
    DECODED = json.load(_f)
DECODABLE = sorted(k for k, v in DECODED.items() if v is not None)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_image_fixtures import pack_bits, png_bytes  # noqa: E402


@pytest.mark.parametrize("name", DECODABLE)
def test_fixture_matches_cv2(name):
    path = os.path.join(FIXTURES, name)
    got = I.read_image(path)
    want = cv2.imread(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    rec = DECODED[name]
    assert list(got.shape) == rec["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"]


def test_progressive_refused_naming_the_file():
    path = os.path.join(FIXTURES, "jpeg_progressive.jpg")
    with pytest.raises(I.ImageError, match="jpeg_progressive.jpg.*"
                       "progressive"):
        I.read_image(path)


def test_views_are_baseline_420_full_hd():
    """The six camera views are 1920x1080 4:2:0 baseline (SOF0) JPEGs."""
    for v in range(6):
        with open(os.path.join(FIXTURES, "views", f"Camera0{v}.jpg"),
                  "rb") as f:
            data = f.read()
        p = data.index(b"\xff\xc0")
        h, w, nc = struct.unpack(">HHB", data[p + 5:p + 10])
        assert (h, w, nc) == (1080, 1920, 3)
        assert data[p + 11] == 0x22 and data[p + 14] == 0x11


@pytest.mark.parametrize("depth,color", [(4, 0), (2, 0), (8, 4), (16, 4),
                                         (16, 6), (1, 3), (4, 3), (16, 0)])
def test_png_layouts_match_cv2(tmp_path, depth, color):
    rng = np.random.default_rng(depth * 10 + color)
    h, w = 19, 23
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    palette = None
    if depth < 8:
        idx = rng.integers(0, 1 << depth, (h, w))
        rows = [pack_bits(r, depth) for r in idx]
        if color == 3:
            palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
    else:
        dt = np.dtype(">u2") if depth == 16 else np.uint8
        arr = rng.integers(0, 1 << depth, (h, w * ch)).astype(dt)
        rows = [r.tobytes() for r in arr]
    path = tmp_path / f"d{depth}c{color}.png"
    path.write_bytes(png_bytes(rows, w, h, depth, color, palette))
    np.testing.assert_array_equal(I.read_image(str(path)),
                                  cv2.imread(str(path)))


def test_interlaced_png_refused(tmp_path):
    data = bytearray(png_bytes([bytes(3 * 4)] * 4, 4, 4, 8, 2))
    data[28] = 1                                      # IHDR interlace flag
    crc = zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF
    data[29:33] = struct.pack(">I", crc)
    path = tmp_path / "interlaced.png"
    path.write_bytes(bytes(data))
    with pytest.raises(I.ImageError, match="interlaced.png.*interlaced"):
        I.read_image(str(path))


def test_other_files_refused(tmp_path):
    path = tmp_path / "notes.txt"
    path.write_bytes(b"GIF89a....")
    with pytest.raises(I.ImageError, match="notes.txt"):
        I.read_image(str(path))
    truncated = tmp_path / "cut.jpg"
    with open(os.path.join(FIXTURES, "jpeg_420_121x163_q75.jpg"), "rb") as f:
        truncated.write_bytes(f.read()[:200])
    with pytest.raises(I.ImageError, match="cut.jpg"):
        I.read_image(str(truncated))


def test_library_built_under_build_dir():
    lib = I.load_library()
    assert lib is I.load_library()
    assert I.library_path().exists()
    assert I.library_path().parent.name == "host"


def test_dataset_load_image_is_rgb01():
    """`data.dataset.load_image` reads through the port's reader: RGB in
    [0, 1], as the reference's loader returns it."""
    from mvsmplfitting_tpu_torch.data.dataset import load_image
    path = os.path.join(FIXTURES, "jpeg_444_121x163_q95.jpg")
    got = load_image(path)
    want = cv2.imread(path)[:, :, ::-1].astype(np.float32) / 255.0
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cut", [2, 30, 100, 300, -2])
def test_damaged_jpeg_refused_or_decoded_in_bounds(tmp_path, cut):
    """A JPEG cut short (or with its last bytes dropped) raises
    `ImageError` naming the file, or decodes to the full frame (libjpeg
    pads a short scan with zeros); the decoder's bounds checks keep the
    process alive either way."""
    with open(os.path.join(FIXTURES, "jpeg_420_rst3_83x61_q90.jpg"),
              "rb") as f:
        data = f.read()
    path = tmp_path / "damaged.jpg"
    path.write_bytes(data[:cut])
    try:
        img = I.read_image(str(path))
    except I.ImageError as e:
        assert "damaged.jpg" in str(e)
    else:
        assert img.shape == (83, 61, 3)
