"""The port's adjustment GUI (`cli/adjust_gui.py`) against JAX's
`AdjustApp`, on the CPU, and driven over HTTP.

Tolerances and why:
- nudges, clamps, resets and keypoint edits: both apps built without a
  session (as `tests/test_adjust_gui.py` builds JAX's) and given the same
  fitted state; the effective state at JAX's test tolerance (atol 1e-6);
- `state()`: one view's overlay, resize to 640 and JPEG at quality 80 on
  the same vertices, bitwise; the whole state with each package's own
  body forward (round-off apart, ~1e-6 m) with the images decoded and
  >= 99.5% of the pixels within 4 levels, the keypoints, loss,
  translation and scale exact;
- `refit()`: the observations, the warm start (the VPoser encoder of
  the edited pose) and the parameter override handed to
  `refit_with_observations`, at rtol/atol 1e-5 (float32 encoders);
- over HTTP, a real session on a small workspace: every route answers,
  the refit's loss is finite and `save` writes the result.
"""

import dataclasses
import json
import os
import threading
import types
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mvsmplfitting_tpu.cli import adjust_gui as JG  # noqa: E402
from mvsmplfitting_tpu.models.camera import \
    load_cameras_txt as jload_cameras  # noqa: E402
from mvsmplfitting_tpu.models.smpl import SMPLParams as JParams  # noqa: E402
from mvsmplfitting_tpu.models.vposer import load_npz as jload_npz  # noqa
from mvsmplfitting_tpu_torch.cli import adjust_gui as TG  # noqa: E402
from mvsmplfitting_tpu_torch.data.results import load_result_pkl  # noqa
from mvsmplfitting_tpu_torch.fitting.stages import FitResult  # noqa: E402
from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl  # noqa
from mvsmplfitting_tpu_torch.models.camera import (  # noqa: E402
    load_cameras_txt, save_cameras_txt)
from mvsmplfitting_tpu_torch.models.smpl import SMPLParams  # noqa: E402
from mvsmplfitting_tpu_torch.models.vposer import (encode_mean,  # noqa
                                                   load_npz)
from mvsmplfitting_tpu_torch.synthetic import (VPOSER_NPZ,  # noqa: E402
                                               orbit_cameras)

from torch_port_helpers import cli_workspace, write_config  # noqa: E402

VIEWS = os.path.join(os.path.dirname(__file__), "fixtures", "images",
                     "views")
RNG = np.random.default_rng(0)
BETAS = RNG.normal(0, 0.5, 10).astype(np.float32)
ORIENT = np.asarray([0.1, -2.9, 0.05], np.float32)
TRANSL = np.asarray([0.02, 0.1, 0.05], np.float32)
POSE = RNG.normal(0, 0.15, 69).astype(np.float32)
Z = RNG.normal(0, 0.5, 32).astype(np.float32)
KEYPOINTS = np.concatenate([RNG.uniform(200, 1700, (6, 1, 17, 2)),
                            RNG.uniform(0.3, 1.0, (6, 1, 17, 1))], -1)


class _JaxResult(types.SimpleNamespace):
    def replace(self, **kw):
        return _JaxResult(**{**vars(self), **kw})


def _apps():
    """JAX's and the port's app, each built without a session and holding
    the same fitted state."""
    jres = _JaxResult(
        params=JParams(betas=jnp.asarray(BETAS),
                       global_orient=jnp.asarray(ORIENT),
                       body_pose=jnp.zeros(69), transl=jnp.asarray(TRANSL),
                       scale=jnp.asarray(1.1)),
        body_pose=jnp.asarray(POSE), z=jnp.asarray(Z),
        loss=jnp.asarray(42.5))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))[None]

    tres = FitResult(
        params=SMPLParams(betas=t(BETAS), global_orient=t(ORIENT),
                          body_pose=torch.zeros((1, 69)), transl=t(TRANSL),
                          scale=torch.tensor([1.1])),
        body_pose=t(POSE), z=t(Z), loss=torch.tensor([42.5]),
        stage_losses=torch.tensor([[42.5]]), lm_iters=torch.tensor([[1]]))
    frame = types.SimpleNamespace(
        keypoints=KEYPOINTS.astype(np.float32), img_hw=(1080, 1920),
        img_paths=[os.path.join(VIEWS, f"Camera0{v}.jpg") for v in range(6)],
        serial="0000", frame_name="00000")
    apps = []
    for cls, res in ((JG.AdjustApp, jres), (TG.AdjustApp, tres)):
        app = cls.__new__(cls)
        app.result = app.init_result = res
        app.override = None
        app.lock = threading.Lock()
        app.frame = frame
        app.max_size = 640
        app.keypoints = np.asarray(frame.keypoints[:, 0]).copy()
        apps.append(app)
    return apps


def _effective(app):
    params, bp = app._effective()
    out = {k: np.asarray(getattr(params, k)).reshape(-1)
           for k in ("betas", "global_orient", "transl", "scale")}
    out["body_pose"] = np.asarray(bp).reshape(-1)
    return out


EDITS = {
    "betas_keeps_pose": [("betas", 2, 1.0)],
    "pose_then_betas": [("body_pose", 5, 0.02), ("betas", 0, -1.0)],
    "clamps": [("body_pose", 3, 0.02)] * 40 + [("transl", 0, 0.05)] * 30
    + [("betas", 1, -1.0)] * 15 + [("global_orient", 2, -0.05)] * 25,
    "none": [],
    "reset": [("transl", 1, 0.05), ("reset",)],
}


@pytest.mark.parametrize("case", sorted(EDITS))
def test_nudges_as_jax(case):
    japp, tapp = _apps()
    for edit in EDITS[case]:
        for app in (japp, tapp):
            if edit[0] == "reset":
                app.reset()
            else:
                app.nudge(*edit)
    want, got = _effective(japp), _effective(tapp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    if case == "clamps":                      # the reference's bounds
        assert abs(got["body_pose"][3] - (POSE[3] + 0.5)) < 1e-6
        assert abs(got["transl"][0] - (TRANSL[0] + 1.0)) < 1e-6
        assert got["betas"][1] == -10.0
    if case == "none":
        assert tapp._effective()[0] is tapp.result.params


def test_set_keypoint_as_jax():
    japp, tapp = _apps()
    for app in (japp, tapp):
        app.set_keypoint(2, 7, 100.5, 200.25)
        app.set_keypoint(0, 0, 3.0, 4.0)
    np.testing.assert_array_equal(tapp.keypoints, japp.keypoints)
    assert tapp.keypoints[2, 7, 0] == np.float32(100.5 * 3)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Both packages' body, cameras (one camera file) and VPoser."""
    path = str(tmp_path_factory.mktemp("cams") / "cams.txt")
    save_cameras_txt(path, orbit_cameras(6, torch.device("cpu")))
    from mvsmplfitting_tpu.models.assets import synthetic_smpl as jsmpl
    jsess = types.SimpleNamespace(
        assets=jsmpl(), cameras=jload_cameras(path),
        vposer=jload_npz(VPOSER_NPZ),
        fit_config=types.SimpleNamespace(
            spec=types.SimpleNamespace(use_vposer=True)))
    tsess = types.SimpleNamespace(
        assets=synthetic_smpl("smpl", device="cpu"),
        cameras=load_cameras_txt(path, device="cpu"),
        vposer=load_npz(VPOSER_NPZ, device="cpu"),
        fit_config=jsess.fit_config, gmm=None)
    jsess.gmm = None
    return jsess, tsess


def test_state_as_jax(sessions):
    import base64

    from mvsmplfitting_tpu.models.smpl import smpl_forward as jforward
    from mvsmplfitting_tpu.viz.overlay import render_mesh_overlay
    japp, tapp = _apps()
    japp.sess, tapp.sess = sessions
    for app in (japp, tapp):
        app.nudge("betas", 0, 1.0)
        app.set_keypoint(1, 3, 50.0, 60.0)
    # One view on JAX's vertices: the port's overlay, resize and JPEG are
    # cv2's bytes.
    params, bp = japp._effective()
    verts = np.asarray(jforward(japp.sess.assets, params,
                                jnp.asarray(bp))[0])
    faces = np.asarray(japp.sess.assets.faces)
    cams = tuple(np.asarray(getattr(japp.sess.cameras, k)) for k in (
        "rotation", "translation", "focal", "center"))
    img = render_mesh_overlay(cv2.imread(japp.frame.img_paths[2]), verts,
                              faces, *(c[2] for c in cams))
    img = cv2.resize(img, None, fx=1 / 3, fy=1 / 3)
    want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 80])[1]
    got = tapp._view(2, verts, faces, cams, tapp.keypoints)
    assert base64.b64decode(got["img"]) == want.tobytes()
    # The whole state, each package with its own body forward.
    js, ts = japp.state(), tapp.state()
    assert ts["loss"] == js["loss"]
    np.testing.assert_allclose(ts["transl"], js["transl"], rtol=1e-6)
    np.testing.assert_allclose(ts["scale"], js["scale"], rtol=1e-6)
    assert len(ts["views"]) == len(js["views"]) == 6
    for a, b in zip(ts["views"], js["views"]):
        assert (a["width"], a["height"]) == (b["width"], b["height"]) == \
            (640, 360)
        assert a["keypoints"] == b["keypoints"]
        x = cv2.imdecode(np.frombuffer(base64.b64decode(a["img"]),
                                       np.uint8), cv2.IMREAD_COLOR)
        y = cv2.imdecode(np.frombuffer(base64.b64decode(b["img"]),
                                       np.uint8), cv2.IMREAD_COLOR)
        close = (np.abs(x.astype(int) - y).max(-1) <= 4).mean()
        assert close >= 0.995, close


def test_refit_as_jax(sessions, monkeypatch):
    """What each app hands `refit_with_observations` after a pose nudge
    and a keypoint edit: the edited observations, the encoder's warm
    start of the edited pose and the nudged parameters."""
    japp, tapp = _apps()
    japp.sess, tapp.sess = sessions
    calls = {}

    def capture(name, wrap):
        def fake(cfg, assets, cam, new_obs, prev, vposer_w=None, gmm=None,
                 img_height=1080.0, params_override=None):
            calls[name] = (new_obs, prev, params_override, img_height)
            return wrap(prev)
        return fake

    monkeypatch.setattr("mvsmplfitting_tpu.fitting.adjust."
                        "refit_with_observations",
                        capture("jax", lambda prev: prev))
    monkeypatch.setattr(TG, "refit_with_observations",
                        capture("port", lambda prev: prev))
    japp.obs = types.SimpleNamespace(
        replace=lambda **kw: types.SimpleNamespace(**kw))
    tapp.obs = dataclasses.make_dataclass(
        "Obs", ["gt2d", "conf"])(torch.zeros((1, 6, 17, 2)),
                                 torch.zeros((1, 6, 17)))
    japp.img_h = tapp.img_h = 1080.0
    for app in (japp, tapp):
        app.nudge("body_pose", 10, 0.02)
        app.nudge("transl", 2, -0.05)
        app.set_keypoint(4, 9, 120.0, 80.0)
        app.refit()
    (jobs, jprev, jover, jh), (tobs, tprev, tover, th) = \
        calls["jax"], calls["port"]
    assert jh == th == 1080.0
    np.testing.assert_array_equal(tobs.gt2d[0].numpy(),
                                  np.asarray(jobs.gt2d))
    np.testing.assert_array_equal(tobs.conf[0].numpy(),
                                  np.asarray(jobs.conf))
    np.testing.assert_allclose(tprev.z[0].numpy(), np.asarray(jprev.z),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(np.asarray(jprev.z), Z)       # re-encoded
    for k in ("betas", "global_orient", "transl"):
        np.testing.assert_allclose(getattr(tover, k)[0].numpy(),
                                   np.asarray(getattr(jover, k)), atol=1e-7)
    assert tapp.override is None and japp.override is None


def test_encoder_warm_start_decodes_near_the_pose():
    """The VPoser encoder's mean decodes back near a plausible pose (the
    GUI's pose edits reach the latent through it)."""
    from mvsmplfitting_tpu_torch.models.vposer import decode
    w = load_npz(VPOSER_NPZ, device="cpu")
    z0 = torch.as_tensor(RNG.normal(0, 0.3, (4, 32)), dtype=torch.float32)
    pose = decode(w, z0)
    back = decode(w, encode_mean(w, pose))
    assert (back - pose).abs().max().item() < 0.5


# ---------------------------------------------------------- over HTTP

def _ask(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=120) as r:
        data = r.read()
    return data if path == "/" else json.loads(data)


def test_gui_over_http(tmp_path):
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ws = cli_workspace(tmp_path / "ws", num_frames=1,
                           model_type="smpllsp", image_hw=(240, 320))
        absent = str(tmp_path / "absent")
        cfg = write_config(
            tmp_path / "g.yaml", model_type="smpllsp", use_vposer=True,
            maxiters=3, ftol=1e-4, data_folder=ws["data_folder"],
            cam_param=ws["cam_param"], output_folder=str(tmp_path / "out"),
            model_folder=absent, prior_folder=absent)
        args = TG.parse_args(["--config", cfg, "--device", "cpu", "--port",
                              "0"])
        assert TG.parse_args([]).device == "cuda"
        app = TG.build_app(args)
        server = ThreadingHTTPServer(("127.0.0.1", 0), TG.make_handler(app))
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            assert b"/api/refit" in _ask(port, "/")
            st = _ask(port, "/api/state")
            assert len(st["views"]) == 6 and st["loss"] == app.loss()
            assert (st["views"][0]["width"], st["views"][0]["height"]) == \
                (320, 240)
            x, y, _ = st["views"][0]["keypoints"][5]
            assert _ask(port, "/api/keypoint", {"view": 0, "joint": 5,
                                                "x": x + 4, "y": y})["ok"]
            assert _ask(port, "/api/nudge", {"field": "betas", "index": 0,
                                             "delta": 1.0})["ok"]
            assert float(app.override["params"].betas[0, 0]) == \
                float(app.init_result.params.betas[0, 0]) + 1.0
            loss = _ask(port, "/api/refit", {})["loss"]
            assert np.isfinite(loss) and loss == app.loss()
            assert _ask(port, "/api/state")["loss"] == loss
            path = _ask(port, "/api/save", {})["path"]
            assert path == str(tmp_path / "out" / "adjusted" / "0000" /
                               "00000" / "000.pkl")
            saved = load_result_pkl(path)
            np.testing.assert_allclose(saved["loss"], loss, rtol=1e-6)
            np.testing.assert_allclose(saved["transl"],
                                       app.result.params.transl.numpy())
            assert _ask(port, "/api/nudge", {"reset": True})["ok"]
            assert app.result is app.init_result and app.override is None
            with pytest.raises(urllib.error.HTTPError):
                _ask(port, "/api/nothing")
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
    finally:
        torch.set_num_threads(before)
