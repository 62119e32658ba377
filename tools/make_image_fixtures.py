"""Write the image fixtures of the port's reader and keypoint tests.

    python tools/make_image_fixtures.py [--out tests/fixtures/images]

Needs OpenCV (it encodes with `cv2.imwrite` and records what
`cv2.imread` decodes), so it runs where OpenCV is installed; the files
it writes are committed.  It writes

* `views/Camera0{0..5}.jpg`: the synthetic SMPL body of
  `mvsmplfitting_tpu_torch.synthetic` (frame 0 of `true_params(1, 0)`)
  seen by the six orbit cameras at 1920x1080, drawn as shaded vertex
  splats over a gradient floor and wall, baseline JPEG 4:2:0 at quality
  90;
* the small files the reader tests decode: JPEG 4:4:4, 4:2:2, 4:2:0,
  4:4:0, 4:1:1, gray and a restart interval at odd sizes and qualities
  75/95, EXIF-rotated JPEGs, PNG gray, RGB, RGBA, 16-bit and palette
  images;
* progressive JPEGs (`IMWRITE_JPEG_PROGRESSIVE`, libjpeg's simple
  progression with successive approximation): 4:2:0, 4:4:4 and gray at
  odd sizes, one with a restart interval, a 1920x1080 view (the render
  of view 1) and a 1280x720 crop of view 2 (the GUI's halving); and one
  cut after its third-last scan, which the port must refuse (libjpeg
  would smooth its blocks);
* BMPs written here (`bmp_bytes`): 1, 4 and 8 bits a pixel with a
  palette (an 8-bit gray one among them), 24 bits bottom-up and
  top-down, 32 bits, 16 bits as 5-5-5 and as 5-6-5 bit fields, 32-bit
  bit fields behind a V5 header, a V4 header; and an RLE8 one, which
  the port must refuse;
* Adam7-interlaced PNGs at depths 1, 8 and 16, and PNGs whose eXIf
  chunk says orientation 3, 6 or 8;
* `decoded.json`: per file its shape and the sha256 of `cv2.imread`'s
  array (None where cv2 refuses or the port must refuse), so the reader
  can be held to OpenCV where OpenCV is not installed;
* `gui_halving.json`: for the 1280x720 crop, the camera and the sha256
  of `cv2.imencode(".jpg", cv2.resize(render, None, fx=0.5, fy=0.5),
  [IMWRITE_JPEG_QUALITY, 80])`, `render` being the port's
  `render_mesh_overlay` of `tests/fixtures/overlay/verts.npy` on it:
  the JPEG the adjustment GUI serves for such a view.

Files already written with other bytes are overwritten; the run prints
which changed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def render_views(width: int = 1920, height: int = 1080) -> list:
    import torch

    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.smpl import SMPLParams, smpl_forward
    from mvsmplfitting_tpu_torch.synthetic import (VPOSER_NPZ,
                                                   orbit_cameras,
                                                   true_params)

    assets = synthetic_smpl("smpl", device="cpu")
    vw = V.load_npz(VPOSER_NPZ, device="cpu")
    z, cols = true_params(1, 0)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    params = SMPLParams(betas=t(cols["betas"]),
                        global_orient=t(cols["global_orient"]),
                        body_pose=torch.zeros((1, 69)),
                        transl=t(cols["transl"]), scale=t(cols["scale"]))
    verts, _ = smpl_forward(assets, params, V.decode(vw, t(z)))
    verts = verts[0].numpy().astype(np.float64)
    part = assets.lbs_weights.numpy().argmax(1)
    cam = orbit_cameras(6, torch.device("cpu"))
    R = cam.rotation.numpy().astype(np.float64)
    T = cam.translation.numpy().astype(np.float64)
    rng = np.random.default_rng(0)
    palette = rng.uniform(60, 230, (24, 3))
    yy, xx = np.mgrid[0:height, 0:width]
    views = []
    for v in range(6):
        img = np.empty((height, width, 3))
        horizon = height * 0.55
        wall = yy < horizon
        img[..., 0] = np.where(wall, 170 + 30 * yy / height,
                               90 + 40 * (yy - horizon) / height)
        img[..., 1] = np.where(wall, 160 + 20 * xx / width, 110)
        img[..., 2] = np.where(wall, 140, 80 + 30 * xx / width)
        pc = verts @ R[v].T + T[v]
        uv = pc[:, :2] / pc[:, 2:3] * 1200.0 + np.array([width / 2,
                                                         height / 2])
        shade = 0.6 + 0.4 * np.clip(-pc[:, 2] + pc[:, 2].mean() + 0.5,
                                    0, 1)
        order = np.argsort(-pc[:, 2])          # far first
        r = 5
        for i in order:
            x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
            if -r <= x < width + r and -r <= y < height + r:
                img[max(y - r, 0):y + r, max(x - r, 0):x + r] = \
                    palette[part[i]] * shade[i]
        views.append(np.clip(img + rng.normal(0, 0.7, img.shape), 0,
                             255).astype(np.uint8))
    return views


def texture(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0,
                   255).astype(np.uint8)


def filter_rows(rows, bpp: int) -> bytes:
    """PNG image data of `rows` (byte strings), using filter types 0-4 in
    turn."""
    raw = bytearray()
    prev = bytes(len(rows[0]))
    for y, row in enumerate(rows):
        ft = y % 5
        out = bytearray()
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 0:
                p = 0
            elif ft == 1:
                p = a
            elif ft == 2:
                p = b
            elif ft == 3:
                p = (a + b) // 2
            else:
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((x - p) & 255)
        raw += bytes([ft]) + bytes(out)
        prev = row
    return bytes(raw)


def png_chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _png(raw: bytes, width: int, height: int, depth: int, color: int,
         palette, interlace: int, exif) -> bytes:
    data = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, color, 0, 0, interlace))
    if exif is not None:
        data += png_chunk(b"eXIf", exif_tiff(exif))
    if palette is not None:
        data += png_chunk(b"PLTE", palette.tobytes())
    return data + png_chunk(b"IDAT", zlib.compress(raw)) \
        + png_chunk(b"IEND", b"")


def _bpp(depth: int, color: int) -> int:
    return max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8)


def png_bytes(rows, width: int, height: int, depth: int, color: int,
              palette=None, exif=None) -> bytes:
    """A PNG whose rows use filter types 0-4 in turn; `exif`, an EXIF
    orientation, adds an eXIf chunk."""
    return _png(filter_rows(rows, _bpp(depth, color)), width, height, depth,
                color, palette, 0, exif)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))   # x0, y0, dx, dy


def pack_row(samples, depth: int) -> bytes:
    """One row of samples (integers, channels interleaved) at `depth`."""
    if depth < 8:
        return pack_bits(samples, depth)
    return np.asarray(samples).astype(">u2" if depth == 16 else np.uint8
                                      ).tobytes()


def adam7_png_bytes(samples: np.ndarray, depth: int, color: int,
                    palette=None) -> bytes:
    """An Adam7-interlaced PNG of `samples` (H, W, channels): each pass
    filtered on its own, empty passes left out."""
    h, w = samples.shape[:2]
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += filter_rows([pack_row(r.reshape(-1), depth) for r in sub],
                               _bpp(depth, color))
    return _png(raw, w, h, depth, color, palette, 1, None)


def bmp_bytes(rows, width: int, height: int, bpp: int, palette=None,
              compression: int = 0, masks=None, header: int = 40,
              top_down: bool = False, pixels: bytes = None) -> bytes:
    """A BMP of `rows` (packed row bytes, top row first), each row padded
    to 4 bytes and stored bottom-up unless `top_down`; `palette` (N, 3)
    BGR entries; `header` 40 (BITMAPINFOHEADER, bit-field `masks` after
    it), 52 or 56 (V2, V3), 108 (V4) or 124 (V5; masks inside from 52
    on); `pixels` replaces the
    stored rows (an RLE stream)."""
    if pixels is None:
        stride = (width * bpp + 31) // 32 * 4
        pixels = b"".join(r + bytes(stride - len(r))
                          for r in (rows if top_down else rows[::-1]))
    pal = b"" if palette is None else b"".join(
        bytes([int(b), int(g), int(r), 0]) for b, g, r in palette)
    info = struct.pack("<IiiHHIIiiII", header, width,
                       -height if top_down else height, 1, bpp, compression,
                       len(pixels), 2835, 2835,
                       0 if palette is None else len(palette), 0)
    m = tuple(masks or (0, 0, 0)) + (0,) * 4
    if header == 40:
        extra = struct.pack("<III", *m[:3]) if compression == 3 else b""
    elif header in (52, 56):
        extra = struct.pack("<IIII", *m[:4])[:header - 40]
    else:
        extra = struct.pack("<IIII", *m[:4]) + b"BGRs"
        extra += bytes(header - 40 - len(extra))
    off = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
            + info + extra + pal + pixels)


def rle8(idx: np.ndarray) -> bytes:
    """An RLE8 stream of the palette indices `idx` (top row first): runs
    of equal pixels, an end-of-line after each row, end of bitmap."""
    out = bytearray()
    for row in idx[::-1]:
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < 255 and row[x + n] == row[x]:
                n += 1
            out += bytes([n, int(row[x])])
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def pack_bits(values, depth: int) -> bytes:
    bits = "".join(format(int(v), f"0{depth}b") for v in values)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def exif_tiff(orientation: int) -> bytes:
    """A little-endian TIFF block holding one Orientation tag."""
    return (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))


def with_exif(jpeg: bytes, orientation: int) -> bytes:
    app1 = b"Exif\0\0" + exif_tiff(orientation)
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
            + app1 + jpeg[2:])


# Files OpenCV decodes and the port refuses (recorded as None).
PORT_REFUSES = ("jpeg_prog_incomplete.jpg", "bmp_rle8_13x7.bmp")
GUI_IMAGE = "jpeg_prog_420_1280x720_q90.jpg"


def progressive_jpegs(cv2, files: dict) -> dict:
    """Progressive JPEGs; the views are decoded from `files`."""
    Q = cv2.IMWRITE_JPEG_QUALITY
    S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    P = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]

    def enc(img, q, *extra):
        return cv2.imencode(".jpg", img, [Q, q, *P, *extra])[1].tobytes()

    def view(v):
        return cv2.imdecode(np.frombuffer(files[f"views/Camera0{v}.jpg"],
                                          np.uint8), cv2.IMREAD_COLOR)

    out = {
        "jpeg_prog_420_121x163_q75.jpg": enc(
            texture(121, 163, 31), 75, S,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "jpeg_prog_444_121x163_q95.jpg": enc(
            texture(121, 163, 32), 95, S,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "jpeg_prog_gray_37x45_q90.jpg": enc(texture(37, 45, 33)[..., 0], 90),
        "jpeg_prog_420_9x3_q90.jpg": enc(texture(9, 3, 34), 90),
        "jpeg_prog_420_rst2_83x61_q90.jpg": enc(
            texture(83, 61, 35), 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
        "jpeg_prog_420_1920x1080_q90.jpg": enc(view(1), 90),
        GUI_IMAGE: enc(view(2)[180:900, 320:1600], 90),
    }
    # The scans after the third-last are dropped: some coefficients stay
    # unrefined, and libjpeg would smooth the blocks.
    full = enc(texture(40, 56, 36), 90)
    sos = [i for i in range(len(full) - 1) if full[i:i + 2] == b"\xff\xda"]
    out["jpeg_prog_incomplete.jpg"] = full[:sos[-2]] + b"\xff\xd9"
    return out


def bmps() -> dict:
    """13x7 BMPs (rows padded to 4 bytes) in every accepted layout, and an
    RLE8 one."""
    rng = np.random.default_rng(11)
    h, w = 7, 13
    out = {}
    for bpp in (1, 4, 8):
        idx = rng.integers(0, 1 << bpp, (h, w))
        pal = rng.integers(0, 256, (1 << bpp, 3))
        out[f"bmp_{bpp}bpp_13x7.bmp"] = bmp_bytes(
            [pack_bits(r, bpp) for r in idx], w, h, bpp, pal)
    gray = np.repeat(np.arange(256)[:, None], 3, 1)
    out["bmp_8bpp_gray_13x7.bmp"] = bmp_bytes(
        [pack_bits(r, 8) for r in idx], w, h, 8, gray)
    out["bmp_rle8_13x7.bmp"] = bmp_bytes(None, w, h, 8, pal, compression=1,
                                         pixels=rle8(idx))
    bgr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rows = [r.tobytes() for r in bgr]
    out["bmp_24bpp_13x7.bmp"] = bmp_bytes(rows, w, h, 24)
    out["bmp_24bpp_topdown_13x7.bmp"] = bmp_bytes(rows, w, h, 24,
                                                  top_down=True)
    out["bmp_24bpp_v4_13x7.bmp"] = bmp_bytes(rows, w, h, 24, header=108)
    bgra = [r.tobytes() for r in rng.integers(0, 256, (h, w, 4),
                                              dtype=np.uint8)]
    out["bmp_32bpp_13x7.bmp"] = bmp_bytes(bgra, w, h, 32)
    out["bmp_32bpp_v5_rgba_13x7.bmp"] = bmp_bytes(
        bgra, w, h, 32, compression=3, header=124,
        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    words = [r.astype("<u2").tobytes()
             for r in rng.integers(0, 1 << 16, (h, w))]
    out["bmp_16bpp_555_13x7.bmp"] = bmp_bytes(words, w, h, 16)
    out["bmp_16bpp_565_13x7.bmp"] = bmp_bytes(
        words, w, h, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    return out


def more_pngs() -> dict:
    """Adam7-interlaced PNGs at depths 1, 8 and 16, and PNGs with an
    eXIf orientation."""
    rng = np.random.default_rng(12)
    out = {
        "png_adam7_gray1_5x3.png": adam7_png_bytes(
            rng.integers(0, 2, (3, 5, 1)), 1, 0),
        "png_adam7_bgr8_37x23.png": adam7_png_bytes(
            rng.integers(0, 256, (23, 37, 3)), 8, 2),
        "png_adam7_rgba16_19x13.png": adam7_png_bytes(
            rng.integers(0, 1 << 16, (13, 19, 4)), 16, 6),
    }
    rgb = rng.integers(0, 256, (4, 6, 3))
    for o in (3, 6, 8):
        out[f"png_exif_orientation{o}.png"] = png_bytes(
            [pack_row(r.reshape(-1), 8) for r in rgb], 6, 4, 8, 2, exif=o)
    return out


def gui_halving(cv2, image_path: str) -> dict:
    """The JPEG the adjustment GUI serves for the 1280x720 view: the
    committed body rendered with view 0's rotation and translation and
    the focal length and centre scaled to 1280x720, halved by cv2 and
    encoded at quality 80.  Faces of equal depth come in pairs whose
    order does not change the render, so any sort gives its bytes."""
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.viz.overlay import (_project, face_order,
                                                     render_mesh_overlay)

    fixtures = os.path.dirname(os.path.dirname(image_path))
    with open(os.path.join(fixtures, "overlay", "golden.json")) as f:
        cam = json.load(f)["render"]["camera"]
    verts = np.load(os.path.join(fixtures, "overlay", "verts.npy"))
    faces = synthetic_smpl("smpl", device="cpu").faces.numpy()
    R, t = (np.asarray(cam[k], np.float32) for k in ("rotation",
                                                     "translation"))
    focal = np.asarray([800.0, 800.0], np.float32)
    center = np.asarray([640.0, 360.0], np.float32)
    img = cv2.imread(image_path)
    # The sort may put faces of equal depth either way: each tie is a
    # pair, and the render is the same with every pair turned round.
    tri = _project(R, t, focal, center, verts)[1][faces].mean(1)
    assert np.unique(tri, return_counts=True)[1].max() <= 2
    turned = np.arange(len(tri))[::-1]
    turned = turned[np.argsort(-tri[turned], kind="stable")]
    _, _, order = face_order(img.shape[:2], verts, faces, R, t, focal,
                             center)
    render = render_mesh_overlay(img, verts, faces, R, t, focal, center)
    assert np.array_equal(render, render_mesh_overlay(
        img, verts, faces, R, t, focal, center, order=turned))
    half = cv2.resize(render, None, fx=0.5, fy=0.5)
    jpg = cv2.imencode(".jpg", half, [cv2.IMWRITE_JPEG_QUALITY, 80])[1]
    return {"image": os.path.basename(image_path),
            "camera": {"rotation": R.tolist(), "translation": t.tolist(),
                       "focal": focal.tolist(), "center": center.tolist()},
            "faces_drawn": int(len(order)),
            "painted": int((render != img).any(-1).sum()),
            "sha256": hashlib.sha256(jpg.tobytes()).hexdigest()}


def main() -> int:
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures",
                                                  "images"))
    out = ap.parse_args().out
    os.makedirs(os.path.join(out, "views"), exist_ok=True)
    files = {}
    S = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
    Q = cv2.IMWRITE_JPEG_QUALITY
    for v, img in enumerate(render_views()):
        name = f"views/Camera0{v}.jpg"
        ok, buf = cv2.imencode(".jpg", img, [
            Q, 90, S, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
        files[name] = buf.tobytes()
    samplings = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
                 "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                 "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
                 "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
                 "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
    for i, (tag, samp) in enumerate(samplings.items()):
        for q in (75, 95):
            img = texture(121, 163, 10 * i + q)
            ok, buf = cv2.imencode(".jpg", img, [Q, q, S, samp])
            files[f"jpeg_{tag}_121x163_q{q}.jpg"] = buf.tobytes()
    ok, buf = cv2.imencode(".jpg", texture(37, 45, 1)[..., 0], [Q, 90])
    files["jpeg_gray_37x45_q90.jpg"] = buf.tobytes()
    ok, buf = cv2.imencode(".jpg", texture(83, 61, 2), [
        Q, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    files["jpeg_420_rst3_83x61_q90.jpg"] = buf.tobytes()
    ok, buf = cv2.imencode(".jpg", texture(9, 3, 3), [Q, 90])
    files["jpeg_420_9x3_q90.jpg"] = buf.tobytes()
    ok, buf = cv2.imencode(".jpg", texture(40, 56, 4), [
        Q, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    files["jpeg_progressive.jpg"] = buf.tobytes()
    ok, buf = cv2.imencode(".jpg", texture(24, 40, 5), [Q, 90])
    for o in (3, 6, 8):
        files[f"jpeg_exif_orientation{o}.jpg"] = with_exif(buf.tobytes(), o)

    rng = np.random.default_rng(7)
    h, w = 37, 53
    for name, arr in (("png_gray8.png", rng.integers(0, 256, (h, w))),
                      ("png_bgr8.png", rng.integers(0, 256, (h, w, 3))),
                      ("png_bgra8.png", rng.integers(0, 256, (h, w, 4)))):
        ok, buf = cv2.imencode(".png", arr.astype(np.uint8))
        files[name] = buf.tobytes()
    ok, buf = cv2.imencode(".png", rng.integers(0, 65536, (h, w, 3)
                                                ).astype(np.uint16))
    files["png_bgr16.png"] = buf.tobytes()
    for depth in (2, 8):
        idx = rng.integers(0, 1 << depth, (h, w))
        pal = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
        files[f"png_palette{depth}.png"] = png_bytes(
            [pack_bits(r, depth) for r in idx], w, h, depth, 3, pal)
    idx = rng.integers(0, 2, (h, w))
    files["png_gray1.png"] = png_bytes([pack_bits(r, 1) for r in idx], w, h,
                                       1, 0)

    files.update(progressive_jpegs(cv2, files))
    files.update(bmps())
    files.update(more_pngs())

    decoded = {}
    changed = []
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        if os.path.exists(path):
            with open(path, "rb") as f:
                if f.read() != data:
                    changed.append(name)
        with open(path, "wb") as f:
            f.write(data)
        arr = None if name in PORT_REFUSES else cv2.imread(path)
        decoded[name] = (None if arr is None else {
            "shape": list(arr.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()
                                     ).hexdigest()})
    with open(os.path.join(out, "decoded.json"), "w") as f:
        json.dump(decoded, f, indent=1, sort_keys=True)
    with open(os.path.join(out, "gui_halving.json"), "w") as f:
        json.dump(gui_halving(cv2, os.path.join(out, GUI_IMAGE)), f,
                  indent=1, sort_keys=True)
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} files, {total} bytes, to {out}; changed: "
          f"{changed or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
