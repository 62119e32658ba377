"""The port's image reader (`mvsmplfitting_tpu_torch.data.images`) against
`cv2.imread`, which the JAX pipeline reads camera images with.

The committed fixtures (`tests/fixtures/images`, written by
`tools/make_image_fixtures.py`) are decoded by both and compared
bitwise, and against the sha256 of OpenCV's array recorded beside them
(what `chip_smoke.py` holds the reader to where OpenCV is absent).  More
layouts are made here on the fly: progressive JPEGs at every sampling,
PNGs plain, Adam7-interlaced and with an eXIf orientation, BMPs of
every accepted header, depth and bit-field layout.  The files OpenCV
reads and the port refuses (an incomplete progressive JPEG, RLE BMPs,
bit fields other than whole bytes) raise naming the file.
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
from make_image_fixtures import (adam7_png_bytes, bmp_bytes,  # noqa: E402
                                 exif_tiff, pack_bits, pack_row, png_bytes,
                                 png_chunk, rle8, texture)


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


def test_progressive_refused_naming_the_file(tmp_path):
    """A complete progressive file decodes to OpenCV's bytes; one whose
    last scans are missing (OpenCV smooths its unrefined blocks) and one
    with a second frame raise naming the file."""
    path = os.path.join(FIXTURES, "jpeg_progressive.jpg")
    np.testing.assert_array_equal(I.read_image(path), cv2.imread(path))
    path = os.path.join(FIXTURES, "jpeg_prog_incomplete.jpg")
    assert cv2.imread(path) is not None
    with pytest.raises(I.ImageError, match="jpeg_prog_incomplete.jpg.*"
                       "incomplete progressive"):
        I.read_image(path)
    with open(os.path.join(FIXTURES, "jpeg_prog_420_9x3_q90.jpg"),
              "rb") as f:
        data = f.read()
    sof = data.index(b"\xff\xc2")
    length = struct.unpack(">H", data[sof + 2:sof + 4])[0]
    two = tmp_path / "two_frames.jpg"
    two.write_bytes(data[:sof + 2 + length] + data[sof:])
    with pytest.raises(I.ImageError, match="two_frames.jpg.*more than one"):
        I.read_image(str(two))


SAMPLINGS = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS) + ["gray"])
def test_progressive_layouts_match_cv2(sampling):
    """Progressive files (libjpeg's simple progression: DC and AC first
    and refinement scans, EOB runs) at odd sizes, qualities and restart
    intervals decode to `cv2.imdecode`'s bytes."""
    for i, (h, w, q, rst) in enumerate([(1, 1, 90, 0), (9, 3, 50, 1),
                                        (17, 33, 100, 0), (41, 29, 75, 3),
                                        (8, 64, 95, 2)]):
        img = texture(h, w, i)
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_PROGRESSIVE,
                  1, cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if sampling == "gray":
            img = img[..., 0]
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
        buf = cv2.imencode(".jpg", img, params)[1]
        np.testing.assert_array_equal(
            I.decode_jpeg(buf.tobytes()), cv2.imdecode(buf, cv2.IMREAD_COLOR),
            str((h, w, q, rst)))


@pytest.mark.parametrize("name", DECODABLE)
def test_image_hw_matches_read_image(name):
    """The header-only size is the decoded size (EXIF turns included)."""
    path = os.path.join(FIXTURES, name)
    assert I.image_hw(path) == I.read_image(path).shape[:2]


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
    """Adam7 PNGs decode to OpenCV's bytes (see also
    `test_adam7_layouts_match_cv2`); an interlace method PNG does not
    define raises naming the file, where OpenCV reads nothing too."""
    rng = np.random.default_rng(3)
    path = tmp_path / "adam7.png"
    path.write_bytes(adam7_png_bytes(rng.integers(0, 256, (4, 4, 3)), 8, 2))
    np.testing.assert_array_equal(I.read_image(str(path)),
                                  cv2.imread(str(path)))
    data = bytearray(path.read_bytes())
    data[28] = 2                                      # IHDR interlace method
    crc = zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF
    data[29:33] = struct.pack(">I", crc)
    path = tmp_path / "interlaced.png"
    path.write_bytes(bytes(data))
    assert cv2.imread(str(path)) is None
    with pytest.raises(I.ImageError, match="interlaced.png.*interlace"):
        I.read_image(str(path))


@pytest.mark.parametrize("depth,color,h,w", [
    (1, 0, 1, 1), (2, 0, 3, 2), (4, 3, 9, 7), (8, 0, 2, 9), (8, 4, 11, 5),
    (8, 6, 16, 16), (16, 0, 5, 13), (16, 2, 8, 3), (1, 3, 13, 17)])
def test_adam7_layouts_match_cv2(tmp_path, depth, color, h, w):
    """Seven passes, each filtered on its own (types 0-4 in turn), empty
    passes without bytes, sub-byte samples packed per pass row."""
    rng = np.random.default_rng(depth * 100 + color * 10 + h)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rng.integers(0, 1 << depth, (h, w, ch))
    palette = None
    if color == 3:
        palette = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
    path = tmp_path / "a7.png"
    path.write_bytes(adam7_png_bytes(samples, depth, color, palette))
    np.testing.assert_array_equal(I.read_image(str(path)),
                                  cv2.imread(str(path)))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_png_exif_orientation_matches_cv2(tmp_path, orientation):
    """`imread` turns a PNG by its eXIf chunk, before the image data or
    after it, as it turns a JPEG."""
    rng = np.random.default_rng(orientation)
    rgb = rng.integers(0, 256, (4, 6, 3))
    rows = [pack_row(r.reshape(-1), 8) for r in rgb]
    before = png_bytes(rows, 6, 4, 8, 2, exif=orientation)
    plain = png_bytes(rows, 6, 4, 8, 2)
    after = plain[:-12] + png_chunk(b"eXIf", exif_tiff(orientation)) \
        + plain[-12:]
    for tag, data in (("before", before), ("after", after)):
        path = tmp_path / f"{tag}.png"
        path.write_bytes(data)
        want = cv2.imread(str(path))
        np.testing.assert_array_equal(I.read_image(str(path)), want, tag)
        assert I.image_hw(str(path)) == want.shape[:2]


def _bmp_case(case: str):
    """(BMP bytes, the image a bit-exact reader gives) for the layouts
    `test_bmp_layouts_match_cv2` covers."""
    rng = np.random.default_rng(len(case))
    h, w = 3, 5
    if case.startswith("pal"):
        bpp, entries = (int(v) for v in case[3:].split("_"))
        idx = rng.integers(0, 1 << bpp, (h, w))
        pal = rng.integers(0, 256, (entries, 3))
        return bmp_bytes([pack_bits(r, bpp) for r in idx], w, h, bpp, pal)
    if case.startswith("bgr24"):
        header = int(case.split("_")[1].rstrip("td"))
        rows = [r.tobytes() for r in rng.integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8)]
        return bmp_bytes(rows, w, h, 24, header=header,
                         top_down=case.endswith("td"))
    if case.startswith("w16"):
        masks = {"555": (0x7C00, 0x3E0, 0x1F), "565": (0xF800, 0x7E0, 0x1F),
                 "rgb": None}[case[4:]]
        rows = [r.astype("<u2").tobytes()
                for r in rng.integers(0, 1 << 16, (h, w))]
        return bmp_bytes(rows, w, h, 16, compression=0 if masks is None
                         else 3, masks=masks)
    header, masks = {
        "x32_40": (40, (0xFF, 0xFF00, 0xFF0000)),     # masks ignored
        "x32_52": (52, (0xFF, 0xFF00, 0xFF0000)),     # masks ignored
        "x32_56": (56, (0xFF, 0xFF00, 0xFF0000)),
        "x32_108": (108, (0xFF000000, 0xFF0000, 0xFF00)),
        "x32_124": (124, (0xFF00, 0xFF0000, 0xFF)),
        "x32_zero": (124, (0, 0, 0)),
        "x32_rgb": (124, None)}[case]
    rows = [r.tobytes() for r in rng.integers(0, 256, (h, w, 4),
                                              dtype=np.uint8)]
    return bmp_bytes(rows, w, h, 32, compression=0 if masks is None else 3,
                     masks=masks, header=header)


BMP_CASES = ["pal1_2", "pal4_16", "pal4_5", "pal8_256", "pal8_3",
             "bgr24_40", "bgr24_56td", "bgr24_124td", "w16_rgb", "w16_555",
             "w16_565", "x32_40", "x32_52", "x32_56", "x32_108", "x32_124",
             "x32_zero", "x32_rgb"]


@pytest.mark.parametrize("case", BMP_CASES)
def test_bmp_layouts_match_cv2(tmp_path, case):
    """BMP headers of 40, 52, 56, 108 and 124 bytes, palettes short of
    their depth (the rest black), 5-pixel rows padded to 4 bytes,
    bottom-up and top-down, 16-bit 5-5-5/5-6-5 and 32-bit bit fields,
    each as `cv2.imread` decodes it."""
    path = tmp_path / f"{case}.bmp"
    path.write_bytes(_bmp_case(case))
    want = cv2.imread(str(path))
    assert want is not None
    np.testing.assert_array_equal(I.read_image(str(path)), want)
    assert I.image_hw(str(path)) == want.shape[:2]


def test_bmp_refused_naming_the_file(tmp_path):
    """RLE8 and RLE4, 32-bit bit fields other than whole bytes (OpenCV
    reads these) and 16-bit bit fields behind a V4 header (OpenCV does
    not) raise naming the file."""
    path = os.path.join(FIXTURES, "bmp_rle8_13x7.bmp")
    assert cv2.imread(path) is not None
    with pytest.raises(I.ImageError, match="bmp_rle8_13x7.bmp.*RLE"):
        I.read_image(path)
    with pytest.raises(I.ImageError, match="bmp_rle8_13x7.bmp.*RLE"):
        I.image_hw(path)
    idx = np.random.default_rng(0).integers(0, 16, (3, 4))
    rle4 = tmp_path / "rle4.bmp"
    rle4.write_bytes(bmp_bytes(None, 4, 3, 4, np.zeros((16, 3), np.uint8),
                               compression=2, pixels=rle8(idx)))
    with pytest.raises(I.ImageError, match="rle4.bmp.*RLE"):
        I.read_image(str(rle4))
    rows = [bytes(8)] * 2
    tenbit = tmp_path / "tenbit.bmp"
    tenbit.write_bytes(bmp_bytes(rows, 2, 2, 32, compression=3, header=124,
                                 masks=(0x3FF00000, 0xFFC00, 0x3FF)))
    assert cv2.imread(str(tenbit)) is not None
    with pytest.raises(I.ImageError, match="tenbit.bmp.*whole bytes"):
        I.read_image(str(tenbit))
    v4 = tmp_path / "v4_565.bmp"
    v4.write_bytes(bmp_bytes([bytes(4)] * 2, 2, 2, 16, compression=3,
                             header=108, masks=(0xF800, 0x7E0, 0x1F)))
    assert cv2.imread(str(v4)) is None
    with pytest.raises(I.ImageError, match="v4_565.bmp.*16-bit"):
        I.read_image(str(v4))


def test_frame_source_reads_mixed_folder(tmp_path):
    """A folder of frames (`detect/stream.py:frame_source`) of progressive
    JPEG, PNG and BMP files gives `cv2.imread`'s bytes in name order."""
    from mvsmplfitting_tpu_torch.detect.stream import frame_source
    names = {"000.jpg": "jpeg_prog_420_121x163_q75.jpg",
             "001.png": "png_adam7_bgr8_37x23.png",
             "002.bmp": "bmp_24bpp_13x7.bmp",
             "003.BMP": "bmp_8bpp_13x7.bmp",
             "004.jpeg": "jpeg_444_121x163_q95.jpg"}
    for dst, src in names.items():
        with open(os.path.join(FIXTURES, src), "rb") as f:
            (tmp_path / dst).write_bytes(f.read())
    (tmp_path / "notes.txt").write_bytes(b"not a frame")
    got = list(frame_source(str(tmp_path)))
    assert [i for i, _ in got] == list(range(len(names)))
    for (_, img), dst in zip(got, sorted(names)):
        np.testing.assert_array_equal(img, cv2.imread(str(tmp_path / dst)),
                                      dst)


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
