"""HybrIK's SMPL regression in the port (`detect/hybrik.py`,
`models/hybrik.py`, `predictor.SmplPoseEstimator`, `stream.
run_stream_smpl`) against the JAX package on the same inputs.

The decode and the IK take seeded numpy inputs; the net takes a random
state_dict in the reference's names through JAX's `convert_hybrik_sd`
(outputs at `tests/test_hybrik.py`'s atol 2e-4 / rtol 1e-3); the stream
runs both packages' `run_stream_smpl` on the same frames with YOLOX's
head fixed (`fixed_yolox_head`), so both crop the same boxes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import fixed_yolox_head, numpy_state, to_tensors

from mvsmplfitting_tpu.detect import hybrik as JD
from mvsmplfitting_tpu.models import hybrik as JM
from mvsmplfitting_tpu_torch.detect import hybrik as TD
from mvsmplfitting_tpu_torch.models import hybrik as TM

ATOL, RTOL = 2e-4, 1e-3
DET_HW = (64, 96)
SMPL_HW = (64, 64)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets():
    from mvsmplfitting_tpu.models.assets import synthetic_smpl as jsyn
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    return jsyn(), synthetic_smpl(device="cpu")


def test_decode_matches_jax():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((2, 4, 8, 6, 5)).astype(np.float32) * 3
    want = jax.jit(JD.integral_uvd, static_argnums=(1, 2, 3))(vol, 5, 6, 8)
    got = TD.integral_uvd(torch.from_numpy(vol), 5, 6, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    uvd = rng.uniform(-0.5, 0.5, (2, 29, 3)).astype(np.float32)
    cam = np.stack([rng.uniform(0.5, 1.5, 2), rng.uniform(-0.2, 0.2, 2),
                    rng.uniform(-0.2, 0.2, 2)], -1).astype(np.float32)
    want = jax.jit(JD.uvd_to_xyz)(uvd, cam, 1000.0, 256.0, 2.0)
    got = TD.uvd_to_xyz(torch.from_numpy(uvd), torch.from_numpy(cam),
                        1000.0, 256.0, 2.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-6)


def test_ik_and_forward_match_jax(assets):
    ja, ta = assets
    from mvsmplfitting_tpu.models.smpl import rodrigues
    rng = np.random.default_rng(1)
    B = 4
    betas = (0.4 * rng.standard_normal((B, 10))).astype(np.float32)
    pose = (0.35 * rng.standard_normal((B, 24, 3))).astype(np.float32)
    pose[3, 4] = [0.0, 0.0, 3.1]        # a knee bent nearly back on itself
    R = np.array(jax.vmap(rodrigues)(jnp.asarray(pose)))
    t = torch.from_numpy

    @jax.jit
    def jax_side(betas, R, skel, phis):
        fk = jax.vmap(lambda b, r: JM.forward_rotmats(ja, b, r))(betas, R)
        tw = jax.vmap(lambda b, r: JM.twist_angles(ja, b, r))(betas, R)
        ik = jax.vmap(lambda s, b, p: JM.hybrik_ik(ja, s, b, p))(
            skel, betas, phis)
        return fk, tw, ik

    # targets: the posed joints (29 rows: 5 leaves appended) and twists
    # moved off the exact pose
    tv, tj = TM.forward_rotmats(ta, t(betas), t(R))
    skel = np.concatenate([tj.numpy(), rng.standard_normal((B, 5, 3))],
                          1).astype(np.float32)
    skel[:, :24] += 0.01 * rng.standard_normal((B, 24, 3)).astype(np.float32)
    phis = rng.standard_normal((B, 23, 2)).astype(np.float32)
    (jv, jj), jtw, jik = jax_side(betas, R, skel, phis)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5)
    np.testing.assert_allclose(TM.twist_angles(ta, t(betas), t(R)).numpy(),
                               np.asarray(jtw), atol=2e-5)
    rik = TM.hybrik_ik(ta, t(skel), t(betas), t(phis))
    np.testing.assert_allclose(rik.numpy(), np.asarray(jik), atol=1e-4)
    # the round trip IK(FK(pose), twists(pose)) == pose off the leaves
    leaves = [i for i in range(24) if TM._SMPL_CHILD[i] < 0]
    p0 = pose[:3].copy()
    p0[:, leaves] = 0.0
    R0 = t(np.array(jax.vmap(rodrigues)(jnp.asarray(p0))))
    _, j0 = TM.forward_rotmats(ta, t(betas[:3]), R0)
    back = TM.hybrik_ik(ta, j0, t(betas[:3]),
                        TM.twist_angles(ta, t(betas[:3]), R0))
    torch.testing.assert_close(back, R0, atol=2e-5, rtol=0)


def test_net_matches_jax():
    J, D, F = 29, 8, 64
    port = TD.Simple3DPoseSMPLCam(num_joints=J, depth_dim=D, height_dim=16,
                                  width_dim=16, deconv_filters=(F, F, F),
                                  input_size=64.0)
    sd = numpy_state(port, 3)
    from mvsmplfitting_tpu.detect.convert import convert_hybrik_sd
    variables = convert_hybrik_sd(sd)
    port.load_state_dict(to_tensors(sd))
    port.eval()
    x = np.random.default_rng(4).standard_normal((2, 3, 64, 64)).astype(
        np.float32)
    jm = JD.Simple3DPoseSMPLCam(num_joints=J, depth_dim=D, height_dim=16,
                                width_dim=16, deconv_filters=(F, F, F),
                                input_size=64.0)
    want = jax.jit(jm.apply)(variables,
                             jnp.asarray(x.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_run_stream_smpl_matches_jax(tmp_path, assets):
    import cv2

    from mvsmplfitting_tpu.detect import convert as JC
    from mvsmplfitting_tpu.detect import predictor as JPr
    from mvsmplfitting_tpu.detect import stream as JS
    from mvsmplfitting_tpu_torch.data.video import read_video
    from mvsmplfitting_tpu_torch.detect import predictor as TP
    from mvsmplfitting_tpu_torch.detect import stream as TS
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX
    ja, ta = assets
    det_sd = fixed_yolox_head(numpy_state(YOLOX(depth_mul=0.33,
                                                width_mul=0.25), 0))
    smpl = TP.SmplPoseEstimator(input_hw=SMPL_HW, assets=ta, device="cpu")
    sd = numpy_state(smpl.model, 8)
    smpl.model.load_state_dict(to_tensors(sd))
    src = tmp_path / "frames"
    src.mkdir()
    rng = np.random.default_rng(9)
    for i in range(2):
        cv2.imwrite(str(src / f"{i}.png"),
                    rng.integers(0, 255, (48, 64, 3), np.uint8))
    det = TP.PersonDetector(to_tensors(det_sd), input_hw=DET_HW,
                            depth_mul=0.33, width_mul=0.25, device="cpu")
    n = TS.run_stream_smpl(str(src), det, smpl,
                           out_json=str(tmp_path / "p" / "smpl.json"),
                           out_video=str(tmp_path / "p" / "v.mp4"), chunk=1,
                           draw_skeleton=True)
    jdet = JPr.PersonDetector(JC.convert_yolox_sd(det_sd, 0.33),
                              input_hw=DET_HW, depth_mul=0.33,
                              width_mul=0.25)
    jsmpl = JPr.SmplPoseEstimator(JC.convert_hybrik_sd(sd), assets=ja,
                                  input_hw=SMPL_HW)
    n_jax = JS.run_stream_smpl(str(src), jdet, jsmpl,
                               out_json=str(tmp_path / "j" / "smpl.json"),
                               chunk=1)
    assert n == n_jax == 2
    with open(tmp_path / "p" / "smpl.json") as f:
        got = json.load(f)
    with open(tmp_path / "j" / "smpl.json") as f:
        want = json.load(f)
    assert [r["imgname"] for r in got] == [r["imgname"] for r in want]
    people = 0
    for g, w in zip(got, want):
        assert len(g["result"]) == len(w["result"])
        for pg, pw in zip(g["result"], w["result"]):
            assert set(pg) == set(pw)
            people += 1
            for k in ("box", "crop_box", "bbox_score"):
                np.testing.assert_allclose(pg[k], pw[k], rtol=1e-6,
                                           atol=1e-4, err_msg=k)
            # uv is uvd * the crop's width: uvd's tolerance in pixels
            scale = pw["crop_box"][2]
            np.testing.assert_allclose(pg["keypoints"], pw["keypoints"],
                                       atol=ATOL * scale, rtol=RTOL)
            for k in ("pred_xyz_jts", "kp_score", "proposal_score"):
                np.testing.assert_allclose(pg[k], pw[k], atol=ATOL,
                                           rtol=RTOL, err_msg=k)
    assert people >= 2
    # MPEG-4 at the name given, as JAX's cv2 `mp4v` writer writes it
    frames = [f for _, f in read_video(str(tmp_path / "p" / "v.mp4"))]
    assert len(frames) == 2 and frames[0].shape == (48, 64, 3)
    # The meshes: camera-frame vertices within 1e-3 m of JAX's.
    img = cv2.imread(str(src / "0.png"))
    boxes = det.detect_batch([torch.from_numpy(img)])[0]
    out = smpl.estimate(TP.rgb01(torch.from_numpy(img)), boxes)
    jout = jsmpl.estimate(img[:, :, ::-1].astype(np.float32) / 255.0, boxes)
    assert out["verts"].shape == (len(boxes), 6890, 3)
    np.testing.assert_allclose(out["verts"], jout["verts"], atol=1e-3,
                               rtol=0)
    empty = smpl.estimate(TP.rgb01(torch.from_numpy(img)),
                          np.zeros((0, 5), np.float32))
    assert empty["verts"].shape == (0, 6890, 3)
