"""The port's config, data I/O and helper modules against the JAX
package, on the CPU.

Tolerances and why:
- config: the `Config` field by field, exact; the YAML subset reader's
  raw mappings equal PyYAML's `safe_load` (which JAX's reader uses);
- keypoint, dataset, result and camera files: bitwise (the same numpy
  code, or the same bytes on disk);
- `ops/geometry.py`: rtol 1e-5 (fp32 small solves and SVDs in another
  library); `ops/match.py`, `utils/filters.py`: bitwise (numpy copies).
"""

import dataclasses
import glob
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mvsmplfitting_tpu import config as JC
from mvsmplfitting_tpu.data import dataset as JD
from mvsmplfitting_tpu.data import keypoints as JK
from mvsmplfitting_tpu.data import native as JN
from mvsmplfitting_tpu.data import results as JR
from mvsmplfitting_tpu.models import camera as JCam
from mvsmplfitting_tpu.models import vposer as JV
from mvsmplfitting_tpu.ops import geometry as JG
from mvsmplfitting_tpu.ops import match as JM
from mvsmplfitting_tpu.utils import filters as JF
from mvsmplfitting_tpu.utils import profiling as JP
from mvsmplfitting_tpu_torch import config as TC
from mvsmplfitting_tpu_torch.data import dataset as TD
from mvsmplfitting_tpu_torch.data import keypoints as TK
from mvsmplfitting_tpu_torch.data import native as TN
from mvsmplfitting_tpu_torch.data import results as TR
from mvsmplfitting_tpu_torch.models import camera as TCam
from mvsmplfitting_tpu_torch.models import vposer as TV
from mvsmplfitting_tpu_torch.ops import geometry as TG
from mvsmplfitting_tpu_torch.ops import match as TM
from mvsmplfitting_tpu_torch.utils import filters as TF
from mvsmplfitting_tpu_torch.utils import profiling as TP

from torch_port_helpers import VPOSER_NPZ, black_png, jpeg_header

REPO = os.path.join(os.path.dirname(__file__), "..")
CFG_FILES = sorted(glob.glob(os.path.join(REPO, "cfg_files", "*.yaml")))


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("path", CFG_FILES, ids=os.path.basename)
def test_cfg_files_load_as_jax(path):
    with open(path) as f:
        text = f.read()
    assert TC.parse_yaml_subset(text, path) == yaml.safe_load(text)
    assert (dataclasses.asdict(TC.load_config(path))
            == dataclasses.asdict(JC.load_config(path)))


EVERY_FIELD = """\
# every field of Config, none at its default
data_folder: "/d"   # a comment after a value
img_folder: 'imgs'
keyp_folder: kp
cam_param: "/d/cams.txt"
dataset: offline2
output_folder: /o
result_folder: res
mesh_folder: 'it''s'
save_meshes: false
save_images: False
interactive: FALSE
visualize: true
model_folder: "/m"
model_type: smpl
gender: female
float_dtype: float64
allow_synthetic_model: false
lsp_regressor: /r.npz
use_vposer: false
prior_folder: "p#1"
body_prior_type: gmm
gmm_path: g.pkl
use_joints_conf: false
use_3d: true
use_hip: false
data_weights: [2, 2.5, 1e-1, 3.]
body_pose_prior_weights: [4.04e2, 3.0e2, 57.4, 4.78]
shape_weights: [1.0e2, 5.0e1, 1.0e1, 0.4e1]
coll_loss_weights: [0.0, 0.0, 1000, 4000.0]
rho: 50
optim_type: lbfgs
ftol: 1e-8
gtol: 1.0e-07
lr: .5
maxiters: 7
fix_scale: true
scale: 1.1
fix_shape: true
shape: [0.1, -0.2, 0, 0, 0, 0, 0, 0, 0, 1e-3]
is_seq: true
adjustment: true
interpenetration: true
coll_grid_size: 64
use_pallas_sdf: false
sdf_engine: grid
num_people: 3
batch_frames: 16
mesh_shape: [2, 4]
use_cuda: true
unknown_key: [a, 'b c', "d"]
"""


def test_every_field_and_overrides(tmp_path):
    path = str(tmp_path / "all.yaml")
    with open(path, "w") as f:
        f.write(EVERY_FIELD)
    assert TC.parse_yaml_subset(EVERY_FIELD, path) == yaml.safe_load(
        EVERY_FIELD)
    port, ref = TC.load_config(path), JC.load_config(path)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    defaults = dataclasses.asdict(TC.Config())
    assert all(v != defaults[k] for k, v in dataclasses.asdict(port).items())
    for kw in ({"model_type": "smpllsp", "rho": 20, "maxiters": None},
               {"optim_type": "lbfgsls", "save_images": False},
               {"optim_type": "lbfgs"}):
        assert (dataclasses.asdict(TC.load_config(path, **kw))
                == dataclasses.asdict(JC.load_config(path, **kw)))
        assert (dataclasses.asdict(TC.load_config(None, **kw))
                == dataclasses.asdict(JC.load_config(None, **kw)))
    assert TC.load_config(None, optim_type="lbfgs").optim_type == "lbfgsls"


def test_unequal_stage_lists_raise(tmp_path):
    path = str(tmp_path / "bad.yaml")
    with open(path, "w") as f:
        f.write("shape_weights: [1.0, 2.0]\n")
    with pytest.raises(AssertionError):
        JC.load_config(path)
    with pytest.raises(ValueError, match="equal length"):
        TC.load_config(path)


def test_dump_reads_back_as_jax(tmp_path):
    with open(str(tmp_path / "all.yaml"), "w") as f:
        f.write(EVERY_FIELD)
    for kw in ({}, {"ftol": 1e-20, "scale": 1e22, "data_folder": 'q"\\x'}):
        cfg = TC.load_config(str(tmp_path / "all.yaml"), **kw)
        jcfg = JC.load_config(str(tmp_path / "all.yaml"), **kw)
        TC.dump_config(cfg, str(tmp_path / "port" / "conf.yaml"))
        JC.dump_config(jcfg, str(tmp_path / "jax" / "conf.yaml"))
        with open(tmp_path / "port" / "conf.yaml") as f:
            ours = yaml.safe_load(f)
        with open(tmp_path / "jax" / "conf.yaml") as f:
            theirs = yaml.safe_load(f)
        assert ours == theirs
        assert (dataclasses.asdict(TC.load_config(str(
            tmp_path / "port" / "conf.yaml"))) == dataclasses.asdict(cfg))
    # The same text is not written again (a resumed run writes nothing).
    p = str(tmp_path / "port" / "conf.yaml")
    os.utime(p, (1, 1))
    TC.dump_config(cfg, p)
    assert os.stat(p).st_mtime == 1


@pytest.mark.parametrize("text", [
    "a: 1.\nb: .5\nc: -0\nd: +5\ne: 1e-9\nf: 4.04e2\ng: 1.5e+3\nh: ~\n"
    "i:\nj: null # c\nk: a#b\nl: [1, 'x', null, 2.0, true]\nm: []\n"
    "n: \"x\\\"y\\\\z\"\no: 'a''b'\np: some text, with comma\n",
])
def test_reader_matches_pyyaml(text):
    assert TC.parse_yaml_subset(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: yes", "a: off", "a: 017", "a: 0x1f", "a: 1_000", "a: 1:30",
    "a: 2001-01-01", "a: .inf", "a:\n  b: 1", "a:\n- 1", "a: [1, [2]]",
    "a: {b: 1}", "a: 'x", "a: [1, 2", "a: &x 1", "a: !!str 1", "a: |",
    "a: b: c", "a: [1, 2,]", "- a", "---", "a: \"\\u0041\"",
])
def test_reader_refuses_outside_subset(tmp_path, text):
    path = str(tmp_path / "x.yaml")
    with open(path, "w") as f:
        f.write("ok: 1\n" + text + "\n")
    with pytest.raises(TC.YAMLSubsetError, match=r"x\.yaml:[23]: "):
        TC.load_config(path)


# ---------------------------------------------------------------- keypoints

def _person(rng, body=25, hands=True, face=True):
    p = {"pose_keypoints_2d": rng.uniform(0, 1000, body * 3).tolist()}
    if hands:
        p["hand_left_keypoints_2d"] = rng.uniform(0, 9, 63).tolist()
        p["hand_right_keypoints_2d"] = rng.uniform(0, 9, 63).tolist()
    if face:
        p["face_keypoints_2d"] = rng.uniform(0, 9, 70 * 3).tolist()
    return p


def test_keypoint_files(tmp_path):
    rng = np.random.default_rng(0)
    files = {
        "many": {"people": [_person(rng), _person(rng, 17, False, False),
                            _person(rng, 14)]},
        "empty": {"version": 1.1, "people": []},
        "none": {"version": 1.1},
        "j3d": {"people": [dict(_person(rng), pose_keypoints_3d=rng.normal(
            size=17 * 4).tolist())]},
    }
    for name, data in files.items():
        path = str(tmp_path / f"{name}.json")
        with open(path, "w") as f:
            json.dump(data, f)
        for kw in ({}, {"num_body_joints": 25}, {"use_hands": True},
                   {"use_face": True}, {"use_hands": True, "use_face": True,
                                        "use_face_contour": True}):
            if name == "many" and kw.get("use_hands"):
                continue  # the second person has no hands (both raise)
            ours = TK.read_keypoints_json(path, **kw)
            theirs = JK.read_keypoints_json(path, **kw)
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        ours, theirs = TK.read_joints3d_json(path), JK.read_joints3d_json(path)
        assert (ours is None) == (theirs is None)
        for a, b in zip(ours or [], theirs or []):
            np.testing.assert_array_equal(a, b)
    poses = rng.normal(size=(2, 17, 3)).astype(np.float32)
    TK.save_keypoints_json(str(tmp_path / "p" / "a.json"), poses)
    JK.save_keypoints_json(str(tmp_path / "j" / "a.json"), poses)
    with open(tmp_path / "p" / "a.json", "rb") as f, \
            open(tmp_path / "j" / "a.json", "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------- dataset

def _write_tree(root, rng):
    """Two serials: a missing keypoint file, a view with no people, three
    people where two fit, JPEG and PNG views, 25-row bodies, 3D joints."""
    def img(path, png=True, hw=(1080, 1920)):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(black_png(*hw) if png else jpeg_header(*hw))

    def kps(path, people):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": 1.1, "people": people}, f)

    base = os.path.join(root, "data")
    for fr in ("00000", "00001"):
        img(f"{base}/images/0000/Camera00/{fr}.png")
        img(f"{base}/images/0000/Camera01/{fr}.jpg", png=False,
            hw=(720, 1280))
        img(f"{base}/images/0000/Camera02/{fr}.png", hw=(480, 640))
    kps(f"{base}/keypoints/0000/Camera00/00001_keypoints.json",
        [_person(rng), _person(rng)])
    for fr in ("00000", "00001"):
        kps(f"{base}/keypoints/0000/Camera01/{fr}_keypoints.json",
            [dict(_person(rng, 17), pose_keypoints_3d=rng.normal(
                size=17 * 4).tolist())])
    kps(f"{base}/keypoints/0000/Camera02/00000_keypoints.json", [])
    kps(f"{base}/keypoints/0000/Camera02/00001_keypoints.json",
        [_person(rng) for _ in range(3)])
    img(f"{base}/images/0001/Camera00/00007.jpg", png=False, hw=(600, 800))
    img(f"{base}/images/0001/Camera00/.hidden.png")
    kps(f"{base}/keypoints/0001/Camera00/00007_keypoints.json",
        [_person(rng, 25)])
    return base


def _assert_frames_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("route", ["native", "python"])
def test_dataset_walks_as_jax(tmp_path, monkeypatch, route):
    base = _write_tree(str(tmp_path), np.random.default_rng(1))
    if route == "python":
        monkeypatch.setattr(TN, "available", lambda: False)
        monkeypatch.setattr(JN, "available", lambda: False)
    elif not TN.available():
        pytest.skip("native loader not loadable (make -C native)")
    for kw in ({}, {"max_people": 2}, {"use_3d": True},
               {"num_body_joints": 25, "max_people": 2}):
        ours, theirs = TD.FittingDataset(base, **kw), JD.FittingDataset(
            base, **kw)
        assert len(ours) == len(theirs) == 3
        assert ours.num_views("0001") == theirs.num_views("0001") == 1
        for i in range(len(ours)):
            _assert_frames_equal(ours[i], theirs[i])
        _assert_frames_equal(ours.batch(list(ours)[:2]),
                             theirs.batch(list(theirs)[:2]))
    frames = list(TD.FittingDataset(base, use_3d=True))
    assert [f.img_hw for f in frames] == [(720, 1280), (1080, 1920),
                                          (600, 800)]
    assert frames[0].joints3d is not None


def test_native_and_python_routes_agree(tmp_path, monkeypatch):
    if not TN.available():
        pytest.skip("native loader not loadable (make -C native)")
    base = _write_tree(str(tmp_path), np.random.default_rng(2))
    native = list(TD.FittingDataset(base, max_people=2))
    monkeypatch.setattr(TN, "available", lambda: False)
    python = list(TD.FittingDataset(base, max_people=2))
    for a, b in zip(native, python):
        _assert_frames_equal(a, b)


def test_frame_to_observations(tmp_path):
    base = _write_tree(str(tmp_path), np.random.default_rng(3))
    for kw, K in (({"max_people": 2}, 17), ({"use_3d": True}, 17),
                  ({"max_people": 2}, 25)):
        w = np.linspace(0, 1, K).astype(np.float32)
        for frame in TD.FittingDataset(base, **kw):
            for p in range(frame.keypoints.shape[1]):
                ours = TD.frame_to_observations(frame, w, person=p,
                                                device="cpu")
                theirs = JD.frame_to_observations(frame, w, person=p)
                for f in dataclasses.fields(theirs):
                    y = getattr(theirs, f.name)
                    x = getattr(ours, f.name)
                    assert (x is None) == (y is None), f.name
                    if y is not None:
                        assert x.shape == (1,) + y.shape, f.name
                        np.testing.assert_array_equal(x[0].numpy(),
                                                      np.asarray(y))
    both = TD.cat_observations([ours, ours])
    assert both.gt2d.shape[0] == 2 and both.gt3d is None


# ---------------------------------------------------------------- results

def test_result_files(tmp_path):
    rng = np.random.default_rng(4)
    out = dict(betas=rng.normal(size=10), global_orient=rng.normal(size=3),
               transl=rng.normal(size=3),
               scale=np.float32(1.1), body_pose=rng.normal(size=69),
               pose_embedding=rng.normal(size=32).astype(np.float32),
               loss=float(np.float32(53.25)))
    ours = TR.result_dict(TR.FitOutputs(**out))
    theirs = JR.result_dict(JR.FitOutputs(**out))
    assert list(ours) == list(theirs)
    for k in theirs:
        if k == "loss":
            assert ours[k] == theirs[k]
        else:
            assert ours[k].dtype == theirs[k].dtype and ours[k].shape == \
                theirs[k].shape
            np.testing.assert_array_equal(ours[k], theirs[k])
    np.testing.assert_array_equal(
        TR.zero_extremities(out["body_pose"]),
        JR.zero_extremities(out["body_pose"]))
    TR.save_result_pkl(str(tmp_path / "p" / "000.pkl"), TR.FitOutputs(**out))
    JR.save_result_pkl(str(tmp_path / "j" / "000.pkl"), JR.FitOutputs(**out))
    with open(tmp_path / "p" / "000.pkl", "rb") as f, \
            open(tmp_path / "j" / "000.pkl", "rb") as g:
        ours_bytes = f.read()
        assert ours_bytes == g.read()
    assert ours_bytes[:2] == b"\x80\x02"               # protocol 2
    back = TR.load_result_pkl(str(tmp_path / "p" / "000.pkl"))
    np.testing.assert_array_equal(back["pose"], theirs["pose"])

    verts = rng.normal(size=(300, 3)).astype(np.float32)
    verts[0] = [-0.0, 1e-9, -1e-7]
    faces = rng.integers(0, 300, (500, 3)).astype(np.int64)
    TR.save_obj(str(tmp_path / "p" / "m.obj"), verts, faces)
    JR.save_obj(str(tmp_path / "j" / "m.obj"), verts, faces)
    with open(tmp_path / "p" / "m.obj", "rb") as f, \
            open(tmp_path / "j" / "m.obj", "rb") as g:
        assert f.read() == g.read()


# ---------------------------------------------------------------- cameras

def test_camera_files(tmp_path):
    from mvsmplfitting_tpu_torch.synthetic import orbit_cameras
    tc = orbit_cameras(5, torch.device("cpu"))
    jc = JCam.Camera(**{f: jnp.asarray(getattr(tc, f).numpy())
                        for f in ("rotation", "translation", "focal",
                                  "center")})
    TCam.save_cameras_txt(str(tmp_path / "p.txt"), tc)
    JCam.save_cameras_txt(str(tmp_path / "j.txt"), jc)
    with open(tmp_path / "p.txt", "rb") as f, open(tmp_path / "j.txt",
                                                   "rb") as g:
        assert f.read() == g.read()
    back = TCam.load_cameras_txt(str(tmp_path / "p.txt"), device="cpu")
    for f in ("rotation", "translation", "focal", "center"):
        torch.testing.assert_close(getattr(back, f), getattr(tc, f),
                                   rtol=0, atol=0)
    rng = np.random.default_rng(5)
    poses = []
    for _ in range(3):
        p = np.eye(4)
        p[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        p[:3, 3] = rng.normal(size=3)
        poses.append(p)
    for photoscan in (False, True):
        for a, b in zip(TCam.get_rot_trans(poses, photoscan),
                        JCam.get_rot_trans(poses, photoscan)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------- VPoser

def test_vposer_snapshot(tmp_path, monkeypatch):
    """A torch snapshot of the bundled weights (a whole module pickled by
    the class path `model.VPoser`), read by both packages."""
    nn = torch.nn
    mod, vp_mod = types.ModuleType("model"), types.ModuleType("model.VPoser")

    class VPoser(nn.Module):
        pass

    VPoser.__module__, VPoser.__qualname__ = "model.VPoser", "VPoser"
    vp_mod.VPoser = VPoser
    mod.VPoser = vp_mod
    monkeypatch.setitem(sys.modules, "model", mod)
    monkeypatch.setitem(sys.modules, "model.VPoser", vp_mod)
    w = np.load(VPOSER_NPZ)
    m = VPoser()
    for name in ("dec_fc1", "dec_fc2", "dec_out", "enc_fc1", "enc_fc2",
                 "enc_mu"):
        wt = w[f"{name}_w"]
        lin = nn.Linear(wt.shape[0], wt.shape[1])
        lin.weight.data = torch.from_numpy(wt.T.copy())
        lin.bias.data = torch.from_numpy(w[f"{name}_b"].copy())
        setattr(m, f"bodyprior_{name}", lin)
    for name in ("enc_bn1", "enc_bn2"):
        bn = nn.BatchNorm1d(w[f"{name}_w"].shape[0])
        bn.weight.data = torch.from_numpy(w[f"{name}_w"].copy())
        bn.bias.data = torch.from_numpy(w[f"{name}_b"].copy())
        bn.running_mean.data = torch.from_numpy(w[f"{name}_mean"].copy())
        bn.running_var.data = torch.from_numpy(w[f"{name}_var"].copy())
        setattr(m, f"bodyprior_{name}", bn)
    os.makedirs(tmp_path / "priors" / "snapshots")
    torch.save(m, str(tmp_path / "priors" / "snapshots" / "TR00_E096.pkl"))
    ours = TV.load_vposer(str(tmp_path / "priors"), device="cpu")
    theirs = JV.convert_torch_snapshot(
        str(tmp_path / "priors" / "snapshots" / "TR00_E096.pkl"))
    for f in dataclasses.fields(ours):
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      np.asarray(getattr(theirs, f.name)))
        np.testing.assert_array_equal(getattr(ours, f.name).numpy(),
                                      w[f.name])
    # An npz in the folder comes first.
    TV.save_npz(str(tmp_path / "priors" / "vposer_weights.npz"), ours)
    again = TV.load_vposer(str(tmp_path / "priors"), device="cpu")
    torch.testing.assert_close(again.dec_out_w, ours.dec_out_w, rtol=0,
                               atol=0)
    with pytest.raises(FileNotFoundError):
        TV.load_vposer(str(tmp_path / "none"), device="cpu")


# ---------------------------------------------------------------- helpers

def test_geometry_as_jax():
    rng = np.random.default_rng(42)
    for a, b in ((10.0, 9.0), (0.5, 0.4), (-3.0, 2.0)):
        np.testing.assert_allclose(TG.rel_change(a, b).item(),
                                   float(JG.rel_change(a, b)), rtol=1e-6)
    assert TG.rel_change(10.0, 9.0).item() == pytest.approx(0.1)

    A = rng.standard_normal((10, 3))
    th = 0.7
    R_true = np.array([[np.cos(th), -np.sin(th), 0],
                       [np.sin(th), np.cos(th), 0], [0, 0, 1.0]])
    B = A @ R_true.T + np.array([1.0, -2.0, 0.5])
    R, t = TG.rigid_transform_3d(_t(A), _t(B))
    jR, jt = JG.rigid_transform_3d(jnp.asarray(A, jnp.float32),
                                   jnp.asarray(B, jnp.float32))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(R.numpy(), R_true, atol=1e-5)
    # A reflection in the data is corrected, as in JAX.
    R, _ = TG.rigid_transform_3d(_t(A), _t(B * [1, 1, -1]))
    jR, _ = JG.rigid_transform_3d(jnp.asarray(A, jnp.float32),
                                  jnp.asarray(B * [1, 1, -1], jnp.float32))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)

    S = rng.standard_normal((17, 3)) * 0.5
    P = S + np.array([0.2, -0.1, 4.0])
    j2d = P[:, :2] / P[:, 2:] * [1000.0, 1000.0] + [500.0, 400.0]
    conf = rng.uniform(0.2, 1.0, 17)
    t = TG.estimate_translation_weak(_t(S), _t(j2d), _t(conf), 1000.0,
                                     1000.0, 500.0, 400.0)
    jt = JG.estimate_translation_weak(
        jnp.asarray(S, jnp.float32), jnp.asarray(j2d, jnp.float32),
        jnp.asarray(conf, jnp.float32), 1000.0, 1000.0, 500.0, 400.0)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-5)
    np.testing.assert_allclose(t.numpy(), [0.2, -0.1, 4.0], atol=1e-2)

    verts = np.asarray([[0.1, -0.2, 4.0], [0.5, 0.5, 5.0],
                        [-0.3, 0.2, 3.0]])
    K = np.asarray([[1000.0, 0, 320], [0, 1000.0, 240], [0, 0, 1.0]])
    E = np.eye(4)
    E[:3, 3] = [0.1, 0.0, 0.5]
    m3d, m2d = TG.surface_project(_t(verts), _t(E), _t(K))
    j3d, j2d = JG.surface_project(jnp.asarray(verts, jnp.float32),
                                  jnp.asarray(E, jnp.float32),
                                  jnp.asarray(K, jnp.float32))
    np.testing.assert_allclose(m3d.numpy(), np.asarray(j3d), rtol=1e-6)
    assert m2d.dtype == torch.int32
    np.testing.assert_array_equal(m2d.numpy(), np.asarray(j2d))

    pose = 0.3 * rng.standard_normal((2, 72))
    trans = rng.standard_normal((2, 3))
    c, s = np.cos(0.8), np.sin(0.8)
    extri = np.eye(4)
    extri[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]) @ \
        np.array([[1.0, 0, 0], [0, c, s], [0, -s, c]])
    extri[:3, 3] = [0.3, -1.0, 2.0]
    for e in (np.eye(4), extri):
        p1, t1 = TG.convert_world_coord(_t(pose), _t(trans), _t(e))
        jp, jtr = JG.convert_world_coord(jnp.asarray(pose, jnp.float32),
                                         jnp.asarray(trans, jnp.float32),
                                         jnp.asarray(e, jnp.float32))
        np.testing.assert_allclose(p1.numpy(), np.asarray(jp), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(t1.numpy(), np.asarray(jtr), rtol=1e-5,
                                   atol=1e-5)


def test_match_and_filters_as_jax():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 500, (3, 17, 3))
    gt[..., 2] = 1.0
    perm = [2, 0, 1]
    pred = gt[perm] + rng.normal(0, 2.0, (3, 17, 3))
    pred[..., 2] = 0.9
    outlier = rng.uniform(5000, 6000, (1, 17, 3))
    outlier[..., 2] = 0.9
    pred = np.concatenate([pred, outlier])
    idx = np.arange(17)
    np.testing.assert_array_equal(TM.pair_by_l2_distance(pred, gt, idx, idx),
                                  JM.pair_by_l2_distance(pred, gt, idx, idx))
    far_gt = np.zeros((2, 17, 3))
    far_gt[..., 2] = 1.0
    far = np.full((1, 17, 3), 1e5)
    far[..., 2] = 1.0
    for g, p in ((gt, pred), (far_gt, far)):
        (m1, b1), (m2, b2) = (TM.match_people(g, p, idx, idx),
                              JM.match_people(g, p, idx, idx))
        assert b1 == b2
        for x, y in zip(m1, m2):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)

    t = np.arange(256)
    clean = np.stack([np.sin(2 * np.pi * t / 128), 0.5 + 0 * t], axis=1)
    noisy = clean + 0.2 * rng.standard_normal(clean.shape)
    for kw in ({}, {"N": 3, "Wn": 0.2, "btype": "high"}):
        np.testing.assert_array_equal(TF.filter_butter(noisy, **kw),
                                      JF.filter_butter(noisy, **kw))


def test_stage_timer_and_metrics(tmp_path, capsys):
    ours, theirs = TP.StageTimer(), JP.StageTimer()
    for timer, arr in ((ours, torch.ones(3)), (theirs, jnp.ones(3))):
        for _ in range(2):
            with timer.time("a", sync_value=arr):
                pass
        with timer.time("b") as box:
            box["sync"] = arr
    assert {k: len(v) for k, v in ours.timings.items()} == \
        {k: len(v) for k, v in theirs.timings.items()} == {"a": 2, "b": 1}
    assert set(ours.summary()) == set(theirs.summary()) == {"a", "b"}
    assert ours.totals()["a"] == pytest.approx(sum(ours.timings["a"]))
    TP.Metrics(str(tmp_path / "m" / "x.jsonl")).log(step=1, loss=2.5)
    TP.Metrics().log(step=2)
    with open(tmp_path / "m" / "x.jsonl") as f:
        assert json.loads(f.read())["loss"] == 2.5
    assert json.loads(capsys.readouterr().out)["step"] == 2
    g = TP.set_seed(3)
    assert torch.rand(2, generator=g).tolist() == torch.rand(
        2, generator=torch.Generator().manual_seed(3)).tolist()
    with TP.trace_profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    with TP.trace_profile(None):
        pass
