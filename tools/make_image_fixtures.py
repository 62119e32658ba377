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
  75/95, a progressive JPEG (refused), EXIF-rotated JPEGs, and PNG
  gray, RGB, RGBA, 16-bit and palette images;
* `decoded.json`: per file its shape and the sha256 of `cv2.imread`'s
  array (None where cv2 refuses or the port must refuse), so the reader
  can be held to OpenCV where OpenCV is not installed.
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


def png_bytes(rows, width: int, height: int, depth: int, color: int,
              palette=None) -> bytes:
    """A PNG whose rows use filter types 0-4 in turn."""
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8)
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

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, color, 0, 0, 0))
    if palette is not None:
        data += chunk(b"PLTE", palette.tobytes())
    return data + chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + chunk(b"IEND", b"")


def pack_bits(values, depth: int) -> bytes:
    bits = "".join(format(int(v), f"0{depth}b") for v in values)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def with_exif(jpeg: bytes, orientation: int) -> bytes:
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    app1 = b"Exif\0\0" + tiff
    return (jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2)
            + app1 + jpeg[2:])


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

    decoded = {}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        arr = cv2.imread(path)
        if name == "jpeg_progressive.jpg":
            arr = None          # cv2 decodes it; the port refuses it
        decoded[name] = (None if arr is None else {
            "shape": list(arr.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(arr).tobytes()
                                     ).hexdigest()})
    with open(os.path.join(out, "decoded.json"), "w") as f:
        json.dump(decoded, f, indent=1, sort_keys=True)
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} files, {total} bytes, to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
