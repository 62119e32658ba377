"""The port's overlay surface against OpenCV and the JAX package, on the
CPU: the drawing primitives (`viz/draw.py`, `csrc/draw.cpp`), the JPEG
writer (`data/images.py:encode_jpeg`, `csrc/jpeg_encode.cpp`), the
`fx`/`fy` resize and its exact halving (the GUI's 1280-px views), the
mesh overlays, `vis_frame`, the video writer and
`models/vposer.py:encode_mean`.

Tolerances and why: everything drawn or encoded is compared bitwise (the
port repeats OpenCV's integer arithmetic and JAX's numpy calls); the
video's frames are held to `cv2.imdecode` of the port's own JPEGs
(OpenCV's MJPEG reader decodes each frame with `imdecode`);
`encode_mean` at rtol/atol 1e-5 (two float32 MLPs).  The committed
fixtures (`tests/fixtures/overlay`, `tools/make_overlay_fixtures.py`)
are regenerated here and must still match, and the port is replayed
against them as `chip_smoke.py` does on the card.
"""

import hashlib
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mvsmplfitting_tpu.viz import overlay as JO  # noqa: E402
from mvsmplfitting_tpu.viz import skeletons as JS  # noqa: E402
from mvsmplfitting_tpu_torch.data import images as I  # noqa: E402
from mvsmplfitting_tpu_torch.data import video as V  # noqa: E402
from mvsmplfitting_tpu_torch.detect.preprocess import (  # noqa: E402
    resize_area_half_u8, resize_linear_u8_by)
from mvsmplfitting_tpu_torch.viz import draw as D  # noqa: E402
from mvsmplfitting_tpu_torch.viz import overlay as TO  # noqa: E402
from mvsmplfitting_tpu_torch.viz import skeletons as TS  # noqa: E402
from mvsmplfitting_tpu_torch.viz import video as TV  # noqa: E402

HERE = os.path.dirname(__file__)
IMAGES = os.path.join(HERE, "fixtures", "images")
VIEWS = os.path.join(IMAGES, "views")
OVERLAY = os.path.join(HERE, "fixtures", "overlay")
sys.path.insert(0, os.path.join(HERE, "..", "tools"))
import make_overlay_fixtures as MF  # noqa: E402


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# ---------------------------------------------------------- primitives

def _pt(r, lo=-40, hi=170):
    return tuple(int(v) for v in r.integers(lo, hi, 2))


def _col(r):
    return tuple(int(v) for v in r.integers(0, 256, 3))


def _poly(r):
    n = int(r.integers(1, 9))
    c = r.integers(-20, 150, 2)
    ang = np.sort(r.uniform(0, 2 * np.pi, n))
    rad = r.uniform(0, 70)
    pts = np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1)
    if r.uniform() < 0.1:                      # collinear
        pts[:, 1] = pts[0, 1]
    if r.uniform() < 0.05:                     # far off the image
        pts *= 200
    return pts.round().astype(np.int32)


# name -> (cv2 call, port call), each drawing one random shape from r, at
# the line types the port draws with (LINE_8, LINE_AA) and integer points.
PRIMITIVES = {
    **{f"line_thin_lt{lt}": (
        lambda i, r, lt=lt: cv2.line(i, _pt(r), _pt(r), _col(r), 1, lt),
        lambda i, r, lt=lt: D.line(i, _pt(r), _pt(r), _col(r), 1, lt))
       for lt in (8, 16)},
    **{f"line_thick_lt{lt}": (
        lambda i, r, lt=lt: cv2.line(i, _pt(r), _pt(r), _col(r),
                                     int(r.integers(2, 12)), lt),
        lambda i, r, lt=lt: D.line(i, _pt(r), _pt(r), _col(r),
                                   int(r.integers(2, 12)), lt))
       for lt in (8, 16)},
    **{f"circle_th{th}_lt{lt}": (
        lambda i, r, th=th, lt=lt: cv2.circle(
            i, _pt(r), int(r.integers(0, 60)), _col(r), th, lt),
        lambda i, r, th=th, lt=lt: D.circle(
            i, _pt(r), int(r.integers(0, 60)), _col(r), th, lt))
       for th in (-1, 1, 2, 3) for lt in (8, 16)},
    **{f"fill_convex_poly_lt{lt}": (
        lambda i, r, lt=lt: cv2.fillConvexPoly(i, _poly(r), _col(r), lt),
        lambda i, r, lt=lt: D.fill_convex_poly(i, _poly(r), _col(r), lt))
       for lt in (8, 16)},
    "rectangle": (
        lambda i, r: cv2.rectangle(i, _pt(r), _pt(r), _col(r),
                                   int(r.choice([-1, 1, 2, 5]))),
        lambda i, r: D.rectangle(i, _pt(r), _pt(r), _col(r),
                                 int(r.choice([-1, 1, 2, 5])))),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_cv2(name):
    """Random shapes, off-image points, degenerate and thick ones, each
    drawn by cv2 and by the port on one image: the same bytes after
    every call."""
    ours, theirs = PRIMITIVES[name][1], PRIMITIVES[name][0]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    img = rng.integers(0, 256, (90, 130, 3), dtype=np.uint8)
    a, b = img.copy(), img.copy()
    for k in range(150):
        seed = int(rng.integers(2**31))
        theirs(a, np.random.default_rng(seed))
        ours(b, np.random.default_rng(seed))
        assert np.array_equal(a, b), (name, k, seed)
    assert (a != img).any()


def test_ellipse2poly_matches_cv2():
    rng = np.random.default_rng(5)
    for _ in range(1500):
        args = (_pt(rng, -100, 300), tuple(int(v) for v in
                                            rng.integers(0, 200, 2)),
                int(rng.integers(-800, 800)), int(rng.integers(-800, 800)),
                int(rng.integers(-800, 800)), int(rng.integers(1, 181)))
        np.testing.assert_array_equal(D.ellipse2poly(*args),
                                      cv2.ellipse2Poly(*args), str(args))
    with pytest.raises(ValueError):
        D.ellipse2poly((0, 0), (5, 5), 0, 0, 360, 0)


@pytest.mark.parametrize("shape", [(256, 256), (7, 13, 3), (1, 1, 3)])
def test_add_weighted_matches_cv2(shape):
    """Every pair of byte values (and odd sizes, where OpenCV's vector
    loop leaves a tail) at random weights."""
    rng = np.random.default_rng(1)
    if shape == (256, 256):
        a = np.repeat(np.arange(256, dtype=np.uint8), 256).reshape(shape)
        b = np.tile(np.arange(256, dtype=np.uint8), 256).reshape(shape)
    else:
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        b = rng.integers(0, 256, shape, dtype=np.uint8)
    for alpha in list(rng.uniform(0, 1, 12)) + [0.0, 0.5, 1.0, 1 / 3]:
        np.testing.assert_array_equal(
            D.add_weighted(a, alpha, b, 1 - alpha, 0),
            cv2.addWeighted(a, alpha, b, 1 - alpha, 0), str(alpha))


def test_fill_faces_is_the_painters_loop():
    rng = np.random.default_rng(2)
    pts, colors, order = MF.triangles(rng)
    want = MF.cv2_fill_faces(MF.pattern(200, 240), pts, colors, order)
    got = D.fill_faces(MF.pattern(200, 240), pts, colors, order)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        D.fill_faces(MF.pattern(20, 20), pts, colors, np.asarray([400]))


def test_blend_changed_is_numpys():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
    layer = img.copy()
    layer[5:20, 3:30] = rng.integers(0, 256, (15, 27, 3), dtype=np.uint8)
    for alpha in (0.9, 0.5, 1.0, 0.1234):
        mask = np.any(layer != img, axis=2, keepdims=True)
        want = np.where(mask, alpha * layer + (1 - alpha) * img,
                        img).astype(np.uint8)
        np.testing.assert_array_equal(D.blend_changed(img, layer, alpha),
                                      want)


@pytest.mark.parametrize("call,match", [
    (lambda z: D.line(z[:, ::2], (0, 0), (1, 1), (1,)), "C-contiguous"),
    (lambda z: D.line(z, (0, 0), (1, 1), (1,), 0), "thickness"),
    (lambda z: D.circle(z, (2, 2), 1, (1,), 1, 4), "line type 4"),
    (lambda z: D.fill_convex_poly(z, [(0, 0), (3, 1), (1, 3)], (1,), 0),
     "line type 0"),
], ids=["strided", "thickness", "line_type_4", "line_type_0"])
def test_bad_inputs_raise(call, match):
    with pytest.raises(ValueError, match=match):
        call(np.zeros((5, 5, 3), np.uint8))


# ---------------------------------------------------------- JPEG writer

def _jpeg_inputs():
    rng = np.random.default_rng(4)
    imgs = {f"view{v}": cv2.imread(os.path.join(VIEWS, f"Camera0{v}.jpg"))
            for v in (0, 3)}
    imgs["noise_9x3"] = rng.integers(0, 256, (3, 9, 3), dtype=np.uint8)
    imgs["noise_121x163"] = rng.integers(0, 256, (163, 121, 3),
                                         dtype=np.uint8)
    imgs["smooth_121x163"] = cv2.GaussianBlur(imgs["noise_121x163"],
                                              (9, 9), 3)
    imgs["flat_17x1"] = np.full((1, 17, 3), 200, np.uint8)
    return imgs


@pytest.mark.parametrize("quality", [50, 80, 95, 100])
def test_encode_jpeg_matches_cv2(quality):
    for name, img in _jpeg_inputs().items():
        want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY,
                                          quality])[1].tobytes()
        assert I.encode_jpeg(img, quality) == want, name


def test_write_image_as_imwrite(tmp_path):
    img = cv2.imread(os.path.join(VIEWS, "Camera01.jpg"))
    I.write_image(str(tmp_path / "a.jpg"), img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    assert (tmp_path / "a.jpg").read_bytes() == \
        (tmp_path / "b.jpg").read_bytes()
    I.write_image(str(tmp_path / "c.JPEG"), img, 80)
    np.testing.assert_array_equal(I.read_image(str(tmp_path / "c.JPEG")),
                                  cv2.imread(str(tmp_path / "c.JPEG")))
    with pytest.raises(I.ImageError, match="d.png"):
        I.write_image(str(tmp_path / "d.png"), img)
    with pytest.raises(ValueError):
        I.encode_jpeg(img[..., 0])


def test_resize_by_scale_matches_cv2():
    """`cv2.resize(img, None, fx=s, fy=s)` (the GUI's 640-wide views):
    the taps step by 1/s, which the size-given path can miss."""
    img = cv2.imread(os.path.join(VIEWS, "Camera02.jpg"))
    rng = np.random.default_rng(6)
    odd = rng.integers(0, 256, (1081, 1921, 3), dtype=np.uint8)
    for src, s in ((img, 640 / 1920), (img, 0.3), (img, 1.3),
                   (odd, 640 / 1921), (odd, 640 / 1081)):
        want = cv2.resize(src, None, fx=s, fy=s)
        got = resize_linear_u8_by(torch.from_numpy(src), s, s).numpy()
        np.testing.assert_array_equal(got, want, str((src.shape, s)))
    # An exact halving, which OpenCV sends to INTER_AREA, is cv2's too.
    for src in (img, odd):
        np.testing.assert_array_equal(
            resize_linear_u8_by(torch.from_numpy(src), 0.5, 0.5).numpy(),
            cv2.resize(src, None, fx=0.5, fy=0.5), str(src.shape))


@pytest.mark.parametrize("shape", [(8 + a, 12 + b) for a in range(4)
                                   for b in range(4)]
                         + [(720, 1280), (1280, 720)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_exact_halving_matches_cv2(shape):
    """`cv2.resize(img, None, fx=0.5, fy=0.5)`: both sides at every
    residue mod 4 (3 mod 4 gives a last row or column of one source row
    or column, 1 mod 4 drops one), and the GUI's 720p views."""
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    src = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    want = cv2.resize(src, None, fx=0.5, fy=0.5)
    got = resize_area_half_u8(torch.from_numpy(src)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        resize_linear_u8_by(torch.from_numpy(src), 0.5, 0.5).numpy(), want)


def _gui_app(image: str, hw, monkeypatch):
    """The port's GUI app for one view of size `hw` showing `image`, built
    without a session (as `tests/test_torch_adjust_gui.py` builds it),
    whose body forward gives the committed overlay body, with the camera
    `tools/make_image_fixtures.py` records for the 1280x720 view."""
    import threading
    import types

    from mvsmplfitting_tpu_torch.cli import adjust_gui as G
    from mvsmplfitting_tpu_torch.fitting.stages import FitResult
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.smpl import SMPLParams
    with open(os.path.join(IMAGES, "gui_halving.json")) as f:
        rec = json.load(f)
    verts = np.load(os.path.join(OVERLAY, "verts.npy"))
    monkeypatch.setattr(G, "smpl_forward", lambda *a: (
        torch.from_numpy(verts)[None], None))
    cam = {k: torch.tensor([rec["camera"][k]]) for k in rec["camera"]}
    if hw[0] > hw[1]:                   # portrait: the centre turned
        cam["center"] = cam["center"].flip(-1)
    app = G.AdjustApp.__new__(G.AdjustApp)
    app.sess = types.SimpleNamespace(assets=synthetic_smpl("smpl",
                                                           device="cpu"),
                                     cameras=types.SimpleNamespace(**cam))
    app.frame = types.SimpleNamespace(img_hw=hw, img_paths=[image])
    app.max_size, app.override = 640, None
    app.lock = threading.Lock()
    app.keypoints = np.zeros((1, 17, 3), np.float32)
    z = torch.zeros((1, 3))
    app.result = FitResult(
        params=SMPLParams(betas=torch.zeros((1, 10)), global_orient=z,
                          body_pose=torch.zeros((1, 69)), transl=z,
                          scale=torch.ones(1)),
        body_pose=torch.zeros((1, 69)), z=torch.zeros((1, 32)),
        loss=torch.tensor([1.0]), stage_losses=torch.tensor([[1.0]]),
        lm_iters=torch.tensor([[1]]))
    return app, rec, verts, {k: v[0].numpy() for k, v in cam.items()}


@pytest.mark.parametrize("orient", ["1280x720", "720x1280"])
def test_gui_state_halves_1280_views(tmp_path, monkeypatch, orient):
    """`AdjustApp.state()` on a 1280-px view (scale exactly 0.5) serves
    `cv2.imencode(cv2.resize(render, None, fx=0.5, fy=0.5), q80)`; the
    landscape view's JPEG is the sha256 `chip_smoke.py` checks."""
    import base64
    image = os.path.join(IMAGES, "jpeg_prog_420_1280x720_q90.jpg")
    hw = (720, 1280)
    if orient == "720x1280":
        image = str(tmp_path / "portrait.jpg")
        cv2.imwrite(image, cv2.imread(os.path.join(
            IMAGES, "jpeg_prog_420_1280x720_q90.jpg")).transpose(1, 0, 2))
        hw = (1280, 720)
    app, rec, verts, cam = _gui_app(image, hw, monkeypatch)
    view = app.state()["views"][0]
    got = base64.b64decode(view["img"])
    faces = app.sess.assets.faces.numpy()
    render = JO.render_mesh_overlay(cv2.imread(image), verts, faces,
                                    cam["rotation"], cam["translation"],
                                    cam["focal"], cam["center"])
    half = cv2.resize(render, None, fx=0.5, fy=0.5)
    assert (view["height"], view["width"]) == half.shape[:2] == (
        hw[0] // 2, hw[1] // 2)
    assert got == cv2.imencode(".jpg", half, [cv2.IMWRITE_JPEG_QUALITY,
                                              80])[1].tobytes()
    if orient == "1280x720":
        assert hashlib.sha256(got).hexdigest() == rec["sha256"]


# ---------------------------------------------------------- overlays

@pytest.fixture(scope="module")
def scene():
    verts = np.load(os.path.join(OVERLAY, "verts.npy"))
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    faces = synthetic_smpl("smpl", device="cpu").faces.numpy()
    cams = [MF.view_camera(v) for v in range(6)]
    cams = [tuple(np.asarray(c[k], np.float32) for k in (
        "rotation", "translation", "focal", "center")) for c in cams]
    return verts, faces, cams


@pytest.mark.parametrize("size", ["240x320", "1080p"])
def test_render_matches_jax(scene, size):
    verts, faces, cams = scene
    R, t, f, c = cams[0]
    if size == "1080p":
        img = cv2.imread(os.path.join(VIEWS, "Camera00.jpg"))
    else:
        img = np.full((240, 320, 3), 40, np.uint8)
        f, c = f * np.float32(1 / 6), c * np.float32(1 / 6)
    want = JO.render_mesh_overlay(img, verts, faces, R, t, f, c)
    got = TO.render_mesh_overlay(img, verts, faces, R, t, f, c)
    assert (want != img).any(-1).sum() > 1000
    np.testing.assert_array_equal(got, want)
    # Other tints and alpha, and culled faces (NaN and behind the camera).
    bad = verts.copy()
    bad[:200] = np.nan
    bad[200:400, 2] = -50.0
    want = JO.render_mesh_overlay(img, bad, faces, R, t, f, c,
                                  color=(0.2, 0.9, 0.1), alpha=0.6)
    got = TO.render_mesh_overlay(img, bad, faces, R, t, f, c,
                                 color=(0.2, 0.9, 0.1), alpha=0.6)
    np.testing.assert_array_equal(got, want)


def test_face_order_is_numpys_argsort(scene):
    """The depth sort is numpy's own default `argsort` (as JAX's), whose
    order of tied depths a stable sort does not keep."""
    verts, faces, cams = scene
    R, t, f, c = cams[0]
    _, depth = JO._project(R, t, f, c, verts)
    tri_depth = depth[faces].mean(axis=1)
    ties = len(tri_depth) - len(np.unique(tri_depth))
    assert ties > 10, ties
    _, _, order = TO.face_order((1080, 1920), verts, faces, R, t, f, c)
    np.testing.assert_array_equal(order, np.argsort(-tri_depth))
    assert not np.array_equal(order, np.argsort(-tri_depth, kind="stable"))


def test_multiperson_and_keypoints_match_jax(scene):
    verts, faces, cams = scene
    R, t, f, c = cams[1]
    f, c = f * np.float32(1 / 6), c * np.float32(1 / 6)
    img = np.full((180, 320, 3), 90, np.uint8)
    people = [verts, verts + np.float32([0.35, 0.0, 0.2]),
              verts - np.float32([0.3, 0.0, 0.1])]
    for p in (people, people[:1], []):
        np.testing.assert_array_equal(
            TO.render_multiperson_overlay(img, p, faces, R, t, f, c),
            JO.render_multiperson_overlay(img, p, faces, R, t, f, c))
    rng = np.random.default_rng(7)
    for K in (17, 26, 21, 68, 133, 5):
        kp = np.concatenate([rng.uniform(-30, 350, (K, 2)),
                             rng.uniform(0, 1, (K, 1))], 1)
        kp[0, 0] = np.inf
        np.testing.assert_array_equal(TO.draw_keypoints(img.copy(), kp),
                                      JO.draw_keypoints(img.copy(), kp),
                                      str(K))


def test_save_overlays_match_jax(scene, tmp_path):
    """`save_overlays` (views on threads) writes JAX's files, bytes for
    bytes: its cv2.imwrite and the port's writer of the same image."""
    import types
    verts, faces, cams = scene
    paths = [os.path.join(VIEWS, f"Camera0{v}.jpg") for v in range(3)]
    paths.append(str(tmp_path / "missing.jpg"))
    cam = types.SimpleNamespace(**{k: np.stack([c[i] for c in cams[:4]])
                                   for i, k in enumerate((
                                       "rotation", "translation", "focal",
                                       "center"))})
    rng = np.random.default_rng(8)
    kp = np.concatenate([rng.uniform(0, 1900, (4, 2, 17, 1)),
                         rng.uniform(0, 1000, (4, 2, 17, 1)),
                         rng.uniform(0, 1, (4, 2, 17, 1))], -1)
    frame = types.SimpleNamespace(img_paths=paths, keypoints=kp,
                                  view_mask=np.asarray([1, 0, 1, 1]),
                                  person_mask=np.asarray(
                                      [[1, 1], [1, 0], [0, 1], [1, 1]]))
    TO.save_overlays(str(tmp_path / "port"), frame, cam, verts, faces)
    JO.save_overlays(str(tmp_path / "jax"), frame, cam, verts, faces)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["00.jpg", "01.jpg", "02.jpg"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n
    people = np.stack([verts, verts + np.float32([0.4, 0, 0])])
    for live in (None, np.asarray([0, 1])):
        TO.save_overlays_multi(str(tmp_path / "pm"), frame, cam, people,
                               faces, live=live)
        JO.save_overlays_multi(str(tmp_path / "jm"), frame, cam, people,
                               faces, live=live)
        for n in names:
            assert (tmp_path / "pm" / n).read_bytes() == \
                (tmp_path / "jm" / n).read_bytes(), (n, live)


# ---------------------------------------------------------- vis_frame

@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("fmt", sorted(JS.SKELETONS))
def test_vis_frame_matches_jax(fmt, fast):
    rng = np.random.default_rng(len(fmt) + 10 * fast)
    K = JS.SKELETONS[fmt].num_joints
    for tid, box in ((None, None), (3, (10.7, 20.2, 200.9, 180.1)),
                     (-2, (-5, -5, 400, 300))):
        kp = np.concatenate([rng.uniform(-30, 350, (K, 2)),
                             rng.uniform(0, 1.2, (K, 1))], 1)
        kp[rng.integers(0, K)] = np.nan
        img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            TS.vis_frame(img.copy(), kp, fmt=fmt, fast=fast, track_id=tid,
                         box=box),
            JS.vis_frame(img.copy(), kp, fmt=fmt, fast=fast, track_id=tid,
                         box=box), f"{fmt} fast={fast} track={tid}")


@pytest.mark.parametrize("fast", [False, True])
def test_vis_frame_1080p_matches_jax(fast):
    rng = np.random.default_rng(11)
    img = cv2.imread(os.path.join(VIEWS, "Camera04.jpg"))
    kp = np.concatenate([rng.uniform(200, 1700, (26, 1)),
                         rng.uniform(100, 1000, (26, 1)),
                         rng.uniform(0, 1, (26, 1))], 1)
    scores = rng.uniform(0, 1, 26)
    np.testing.assert_array_equal(
        TS.vis_frame(img.copy(), kp, scores, fast=fast, box=(300, 90, 1500,
                                                              1010)),
        JS.vis_frame(img.copy(), kp, scores, fast=fast, box=(300, 90, 1500,
                                                             1010)))


# ---------------------------------------------------------- video

def test_export_video_reads_back(tmp_path):
    paths = [os.path.join(VIEWS, f"Camera0{v}.jpg") for v in range(3)]
    small = str(tmp_path / "small.jpg")
    cv2.imwrite(small, cv2.resize(cv2.imread(paths[0]), (333, 211)))
    paths.append(small)
    # MPEG-4 at the .mp4 name, as JAX's cv2 writer writes it: cv2 and
    # the port read it alike, close to the resized sources
    out = TV.export_video(paths, str(tmp_path / "v" / "clip.mp4"), fps=25)
    assert out == str(tmp_path / "v" / "clip.mp4")
    cap = cv2.VideoCapture(out)
    assert cap.get(cv2.CAP_PROP_FPS) == 25
    mine = [f for _, f in V.read_video(out)]
    assert len(mine) == 4
    for p, got in zip(paths, mine):
        ok, frame = cap.read()
        assert ok
        np.testing.assert_array_equal(got, frame)
        src = cv2.imread(p)
        if src.shape != (1080, 1920, 3):
            src = cv2.resize(src, (1920, 1080))
        mse = np.mean((frame.astype(float) - src) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 30, p
    assert not cap.read()[0]
    cap.release()
    # Motion-JPEG at the .avi name where cv2's mp4v writer cannot open
    out = TV.export_video(paths, str(tmp_path / "v" / "clip.webm"), fps=25)
    assert out == str(tmp_path / "v" / "clip.avi")
    cap = cv2.VideoCapture(out, cv2.CAP_OPENCV_MJPEG)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FPS) == 25
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4
    for p in paths:
        ok, frame = cap.read()
        assert ok
        src = cv2.imread(p)
        if src.shape != (1080, 1920, 3):
            src = cv2.resize(src, (1920, 1080))
        want = cv2.imdecode(np.frombuffer(I.encode_jpeg(src, 95), np.uint8),
                            cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(frame, want, p)
    assert not cap.read()[0]
    cap.release()
    # FFmpeg's reader takes the file as well.
    cap = cv2.VideoCapture(out, cv2.CAP_FFMPEG)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 4
    with pytest.raises(ValueError):
        TV.export_video([], str(tmp_path / "x.avi"))


def test_export_video_skips_missing_frame(tmp_path):
    """A missing later frame is skipped, as JAX skips the None of
    `cv2.imread` (the clip is one frame shorter); a missing first frame
    and a file the reader refuses raise."""
    paths = []
    for v in range(3):
        p = str(tmp_path / f"{v}.jpg")
        cv2.imwrite(p, cv2.resize(cv2.imread(os.path.join(
            VIEWS, f"Camera0{v}.jpg")), (96, 54)))
        paths.append(p)
    os.remove(paths[1])
    out = TV.export_video(paths, str(tmp_path / "clip.avi"))
    assert len(list(V.read_video(out))) == 2       # MPEG-4 AVI
    out = TV.export_video(paths, str(tmp_path / "clip.webm"))
    assert out == str(tmp_path / "clip.avi")      # JAX's MJPG fallback
    cap = cv2.VideoCapture(out, cv2.CAP_OPENCV_MJPEG)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 2
    for p in (paths[0], paths[2]):
        ok, frame = cap.read()
        assert ok
        want = cv2.imdecode(np.frombuffer(I.encode_jpeg(cv2.imread(p), 95),
                                          np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(frame, want, p)
    cap.release()
    with pytest.raises(FileNotFoundError):
        TV.export_video(paths[1:], str(tmp_path / "none.avi"))
    bad = str(tmp_path / "bad.jpg")
    with open(bad, "wb") as f:
        f.write(b"GIF89a")
    with pytest.raises(I.ImageError, match="bad.jpg"):
        TV.export_video([paths[0], bad], str(tmp_path / "bad.avi"))


# ---------------------------------------------------------- fixtures

def test_fixtures_are_current():
    """Regenerated from the committed vertices with cv2 and JAX, the
    fixtures equal the committed files."""
    verts = np.load(os.path.join(OVERLAY, "verts.npy"))
    _, order, golden = MF.build(verts)
    with open(os.path.join(OVERLAY, "golden.json")) as f:
        assert json.load(f) == json.loads(json.dumps(golden))
    np.testing.assert_array_equal(
        np.load(os.path.join(OVERLAY, "order.npy")), order)


def test_port_replays_fixtures(scene):
    """`chip_smoke.py` [overlay] (a)-(c) without a card."""
    with open(os.path.join(OVERLAY, "golden.json")) as f:
        golden = json.load(f)
    api = {k: getattr(D, k) for k in ("line", "circle", "fill_convex_poly",
                                      "rectangle", "ellipse2poly",
                                      "add_weighted")}
    got = MF.replay([(g["name"], g["calls"]) for g in golden["primitives"]],
                    api)
    assert got == {g["name"]: g["sha256"] for g in golden["primitives"]}
    for name, qs in golden["jpeg"].items():
        img = I.read_image(os.path.join(VIEWS, name))
        for q, digest in qs.items():
            assert hashlib.sha256(I.encode_jpeg(img, int(q))).hexdigest() \
                == digest, (name, q)
    verts, faces, _ = scene
    ren = golden["render"]
    R, t, f, c = (np.asarray(ren["camera"][k], np.float32) for k in (
        "rotation", "translation", "focal", "center"))
    img = I.read_image(os.path.join(VIEWS, ren["image"]))
    order = np.load(os.path.join(OVERLAY, "order.npy"))
    out = TO.render_mesh_overlay(img, verts, faces, R, t, f, c, order=order)
    assert _sha(out) == ren["sha256"]


# ---------------------------------------------------------- VPoser encoder

def test_encode_mean_matches_jax():
    import jax.numpy as jnp

    from mvsmplfitting_tpu.models import vposer as JV
    from mvsmplfitting_tpu_torch.models import vposer as TVP
    from mvsmplfitting_tpu_torch.synthetic import VPOSER_NPZ
    rng = np.random.default_rng(9)
    pose = rng.normal(0, 0.3, (5, 69)).astype(np.float32)
    want = np.asarray(JV.encode_mean(JV.load_npz(VPOSER_NPZ),
                                     jnp.asarray(pose)))
    got = TVP.encode_mean(TVP.load_npz(VPOSER_NPZ, device="cpu"),
                          torch.from_numpy(pose)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
