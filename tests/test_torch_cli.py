"""The port's session and fitting CLI against the JAX package, on the CPU,
end to end on a workspace in the reference's layout
(`synthetic.write_workspace`, read by both CLIs).

Tolerances and why:
- `build_session`: every `FitConfig` field, the cameras, joint weights,
  assets and VPoser weights exact (the same host numpy, the same
  files);
- the batched CLI against JAX's: the pkls' keys, shapes and dtypes
  exact; losses at rtol 1e-2, global orientation and translation at
  atol 1e-3 (rad, m).  Both CLIs run the library defaults (Newton-
  Schulz, speculative LM), which may take another path on round-off;
  JAX's own batch-vs-single spread is rtol 1e-2 (`tests/test_parallel.
  py`).  Measured here: ~3e-6 on the orientation, 3e-7 on the losses;
- the per-frame sequence CLI against the port's own `init_guess`,
  `warm_start` and `fit_frame` on the same session: rtol 1e-6 (the same
  calls; the CLI adds no arithmetic).

JAX's session builds its joint model op by op in float32 (~12 s here);
both JAX sessions of this module take the port-built one instead (as
`torch_port_helpers.jax_assets` does), a difference of ~5e-7.  The test
configs set ftol 1e-4, which cuts the LM loops short in both packages
alike.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
import yaml

import mvsmplfitting_tpu.models.joint_model as JJM
from mvsmplfitting_tpu.cli import main as jcli
from mvsmplfitting_tpu.config import load_config as jload_config
from mvsmplfitting_tpu.session import build_session as jbuild_session
from mvsmplfitting_tpu_torch.cli import main as tcli
from mvsmplfitting_tpu_torch.config import load_config
from mvsmplfitting_tpu_torch.data.dataset import frame_to_observations
from mvsmplfitting_tpu_torch.data.results import load_result_pkl
from mvsmplfitting_tpu_torch.fitting.initialize import init_guess, warm_start
from mvsmplfitting_tpu_torch.fitting.stages import fit_frame
from mvsmplfitting_tpu_torch.models.smpl import SMPLParams, smpl_forward
from mvsmplfitting_tpu_torch.session import build_session

from torch_port_helpers import (arrays, cli_workspace, jax_joint_model,
                                port_assets, write_config)

BASE = dict(model_type="smpl", use_vposer=True, optim_type="lm",
            save_images=False, ftol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _setup():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JJM, "with_joint_model", lambda a: a.replace(
            joint_model=jax_joint_model(port_assets(a.model_type)
                                        .joint_model)))
        yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    return cli_workspace(tmp_path_factory.mktemp("ws"), num_frames=2)


def _argv(ws, config, out, *extra):
    absent = os.path.join(ws["root"], "absent")
    return ["--config", config, "--data_folder", ws["data_folder"],
            "--cam_param", ws["cam_param"], "--output_folder", out,
            "--model_folder", absent, "--prior_folder", absent, *extra]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = os.stat(p).st_mtime_ns
    return out


# ---------------------------------------------------------------- session

@pytest.mark.parametrize("case", ["lm", "lbfgsls", "adam", "lm_ad", "gmm"])
def test_session_as_jax(ws, tmp_path, monkeypatch, case):
    values = dict(BASE, optim_type=case.split("_")[0], maxiters=12, lr=0.05,
                  data_folder=ws["data_folder"], cam_param=ws["cam_param"],
                  model_folder=str(tmp_path / "absent"),
                  prior_folder=str(tmp_path / "absent"))
    if case == "lm_ad":
        monkeypatch.setenv("MVSF_LM_JAC", "ad")
    if case == "gmm":
        values.update(use_vposer=False, body_prior_type="gmm",
                      model_type="smpllsp")
    path = write_config(tmp_path / "c.yaml", **values)
    ours = build_session(load_config(path), device="cpu")
    theirs = jbuild_session(jload_config(path))
    a, b = ours.fit_config, theirs.fit_config
    for f in dataclasses.fields(a.spec):
        assert getattr(a.spec, f.name) == getattr(b.spec, f.name), f.name
    for name in ("lm", "lbfgs", "grad"):
        assert dataclasses.asdict(getattr(a, name)) == \
            dataclasses.asdict(getattr(b, name)), name
    for name in ("solver", "pose_weights", "shape_weights", "coll_weights",
                 "fused", "is_seq"):
        assert getattr(a, name) == getattr(b, name), name
    if case == "lm_ad":
        assert a.lm.jac == "ad"
    assert ours.pose_format == theirs.pose_format
    assert ours.synthetic_model and theirs.synthetic_model
    np.testing.assert_array_equal(ours.joint_weights, theirs.joint_weights)
    for f in ("rotation", "translation", "focal", "center"):
        np.testing.assert_array_equal(getattr(ours.cameras, f).numpy(),
                                      np.asarray(getattr(theirs.cameras, f)))
    for name, v in arrays(theirs.assets).items():
        w = getattr(ours.assets, name)
        assert (v is None) == (w is None), name
        if v is not None:
            np.testing.assert_array_equal(w.numpy(), v, err_msg=name)
    for name in ("vposer", "gmm"):
        x, y = getattr(ours, name), getattr(theirs, name)
        assert (x is None) == (y is None), name
        if y is not None:
            for k, v in arrays(y).items():
                if v is not None and hasattr(x, k):
                    np.testing.assert_array_equal(getattr(x, k).numpy(), v,
                                                  err_msg=f"{name}.{k}")
    assert len(ours.dataset) == len(theirs.dataset) == 2


# ---------------------------------------------------------------- the CLI

def test_batched_cli_as_jax(ws, tmp_path, capsys):
    """Both CLIs in batched mode on the same files: the same outputs."""
    cfg = write_config(tmp_path / "b.yaml", **BASE, batch_frames=2)
    assert jcli.main(_argv(ws, cfg, str(tmp_path / "jax"))) == 0
    jax_out = capsys.readouterr().out
    assert tcli.main(_argv(ws, cfg, str(tmp_path / "port"),
                           "--device", "cpu")) == 0
    out = capsys.readouterr().out
    # The same printed lines, numbers aside.
    def shape(text):
        return [re.sub(r"[0-9.]+", "#", line) for line in text.splitlines()
                if "[warn]" not in line]
    assert shape(out) == shape(jax_out)
    for fr in ws["frames"]:
        rel = os.path.join("results", ws["serial"], fr, "000.pkl")
        ours = load_result_pkl(str(tmp_path / "port" / rel))
        theirs = load_result_pkl(str(tmp_path / "jax" / rel))
        assert list(ours) == list(theirs)
        for k, v in theirs.items():
            if k != "loss":
                assert ours[k].shape == v.shape and ours[k].dtype == v.dtype
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-2)
        for k in ("global_orient", "transl"):
            np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-3)
        mesh = os.path.join("meshes", ws["serial"], fr, "000.obj")
        with open(tmp_path / "port" / mesh) as f:
            lines = f.read().splitlines()
        assert sum(ln.startswith("v ") for ln in lines) == 6890
        assert sum(ln.startswith("f ") for ln in lines) == 13776
    with open(tmp_path / "port" / "conf.yaml") as f:
        ours = yaml.safe_load(f)
    with open(tmp_path / "jax" / "conf.yaml") as f:
        theirs = yaml.safe_load(f)
    assert ours.pop("output_folder") != theirs.pop("output_folder")
    assert ours == theirs


def test_sequence_cli_matches_library_and_resumes(ws, tmp_path, capsys):
    cfg_path = write_config(tmp_path / "s.yaml", **BASE, is_seq=True)
    out = str(tmp_path / "out")
    argv = _argv(ws, cfg_path, out, "--device", "cpu")
    assert tcli.main(argv) == 0
    printed = capsys.readouterr().out
    stages = re.findall(r"stages \[([^\]]*)\] final ([0-9.]+)", printed)
    assert [len(s.split()) for s, _ in stages] == [4, 2]
    assert float(stages[0][1]) <= 5000.0      # frame 1 takes the warm start

    # The same calls through the library.
    cfg = load_config(cfg_path, data_folder=ws["data_folder"],
                      cam_param=ws["cam_param"],
                      model_folder=os.path.join(ws["root"], "absent"),
                      prior_folder=os.path.join(ws["root"], "absent"))
    sess = build_session(cfg, device="cpu")
    prev = None
    for frame in sess.dataset:
        obs = frame_to_observations(frame, sess.joint_weights, device="cpu")
        guess = init_guess(sess.assets, sess.cameras, obs.gt2d, obs.conf,
                           obs.view_mask)
        if prev is not None:
            guess = warm_start(prev.params, prev.z, prev.loss, guess)
        prev = fit_frame(sess.fit_config, sess.assets, sess.cameras, obs,
                         guess.params, guess.z, vposer_w=sess.vposer,
                         img_height=float(frame.img_hw[0]),
                         seq_start=frame.frame_name == ws["frames"][0])
        got = load_result_pkl(os.path.join(out, "results", frame.serial,
                                           frame.frame_name, "000.pkl"))
        np.testing.assert_allclose(got["loss"], prev.loss.item(), rtol=1e-6)
        for k, v in (("betas", prev.params.betas),
                     ("global_orient", prev.params.global_orient),
                     ("transl", prev.params.transl),
                     ("pose_embedding", prev.z)):
            np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=k)

    # --resume skips every frame and writes nothing.
    before = _files(out)
    assert tcli.main(argv + ["--resume"]) == 0
    printed = capsys.readouterr().out
    assert printed.count("Skipping (resume)") == 2
    assert "Processing" not in printed
    assert _files(out) == before


def test_save_images_refused_before_loading(ws, tmp_path):
    """`save_images` is no longer refused (the overlays are ported); the
    one refusal left before anything is loaded or written is a missing
    card when `--device cpu` is not given."""
    cfg = write_config(tmp_path / "i.yaml", model_type="smpl")
    assert tcli.parse_args(["--config", cfg]).save_images is None
    out = tmp_path / "out"
    if not torch.cuda.is_available():
        # No GPU and no --device cpu: the default device raises.
        for extra in ((), ("--no_save_images",)):
            with pytest.raises(RuntimeError, match="CUDA"):
                tcli.main(_argv(ws, cfg, str(out), *extra))
            assert not out.exists()


def test_two_person_solo_cli(tmp_path, capsys):
    """Two people in every view's file, fitted without the collision
    term: one pkl per person, in the files' (the truth's) order."""
    ws = cli_workspace(tmp_path / "ws", kind="people", dx0=0.2)
    cfg = write_config(tmp_path / "p.yaml", **BASE, num_people=2,
                       interpenetration=False)
    out = tmp_path / "out"
    assert tcli.main(_argv(ws, cfg, str(out), "--device", "cpu")) == 0
    printed = capsys.readouterr().out
    assert "2 people" in printed and "coll [0.0, 0.0]" in printed
    d = out / "results" / ws["serial"] / ws["frames"][0]
    people = [load_result_pkl(str(d / f"{p:03d}.pkl")) for p in range(2)]
    x = [p["transl"][0, 0] for p in people]
    assert x[0] < x[1], x                      # truth: -0.2, +0.2
    np.testing.assert_allclose(x, [-0.2, 0.2], atol=0.1)
    assert (out / "meshes" / ws["serial"] / ws["frames"][0]
            / "001.obj").exists()


# ---------------------------------------------------------------- overlays

def _cli_verts(sess, result_dir, stems):
    """The bodies `cli/main.py:_save_outputs` draws: the saved
    (extremity-zeroed) pose of each pkl, in one forward."""
    pkls = [load_result_pkl(os.path.join(result_dir, f"{s}.pkl"))
            for s in stems]

    def cat(k):
        return torch.as_tensor(np.concatenate([d[k] for d in pkls]))

    params = SMPLParams(betas=cat("betas"), global_orient=cat("pose")[:, :3],
                        body_pose=cat("body_pose"), transl=cat("transl"),
                        scale=cat("scale")[:, 0])
    return smpl_forward(sess.assets, params)[0].numpy()


OVERLAY_CASES = {
    # config, workspace kind, frames, people; only the demo case runs
    # JAX's CLI (its first run in a process costs ~20-50 s here); the seq
    # case runs the port's CLI in a subprocess.
    "demo": ("fit_smpl_demo.yaml", "frames", 1, 1),
    "seq": ("fit_seq.yaml", "sequence", 2, 1),
    "multi": ("fit_multi_person_sdf.yaml", "people", 1, 2),
}


@pytest.mark.parametrize("case", sorted(OVERLAY_CASES))
def test_overlays_as_jax(case, tmp_path, capsys):
    """The three shipped configs with `save_images` on (their own or the
    default), on a workspace of black 1920x1080 PNGs (the synthetic
    cameras' size): the port's CLI writes JAX's overlay layout,
    `images/<serial>/<frame>/<v:02d>.jpg` for every frame and view, and
    each overlay is, byte for byte, both the port's and JAX's
    `save_overlays` (`save_overlays_multi` with JAX's live mask) of the
    bodies its pkls hold.  The demo case also runs JAX's CLI: the same
    files, and decoded, >= 99.5% of the pixels within 4 levels of JAX's
    (the fits differ at round-off, which can move a projected corner
    across a pixel).

    Cut for time: both CLIs fit with `--optim_type adam --maxiters 1`
    (30 steps a stage; the LM's budget has a floor of 60 iterations),
    and the two-person config without its collision term (a minute of
    CPU here; `chip_smoke.py` [cli] runs it with the overlays on the
    card), which leaves the overlays' path as it is."""
    import subprocess
    import sys

    import cv2

    from mvsmplfitting_tpu.viz import overlay as JO
    from mvsmplfitting_tpu_torch.viz import overlay as TO
    name, kind, n_frames, people = OVERLAY_CASES[case]
    config = os.path.join(os.path.dirname(__file__), "..", "cfg_files", name)
    if case == "multi":
        with open(config) as f:
            text = f.read().replace("interpenetration: true",
                                    "interpenetration: false")
        assert "interpenetration: false" in text
        config = str(tmp_path / name)
        with open(config, "w") as f:
            f.write(text)
    cfg = load_config(config)
    assert cfg.save_images
    ws = cli_workspace(tmp_path / "ws", kind=kind,
                       **({} if kind == "people" else
                          dict(num_frames=n_frames, model_type="smpllsp")))
    outs = {k: str(tmp_path / k) for k in ("port", "jax")}
    args = {k: _argv(ws, config, v, "--optim_type", "adam", "--maxiters",
                     "1") for k, v in outs.items()}
    if case == "seq":
        # The subprocess's torch takes this module's thread count: the
        # bodies' last bits depend on it, and they are drawn again below.
        root = os.path.join(os.path.dirname(__file__), "..")
        env = dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()))
        proc = subprocess.run(
            [sys.executable, "-m", "mvsmplfitting_tpu_torch.cli.main",
             *args["port"], "--device", "cpu"], capture_output=True,
            text=True, cwd=root, timeout=600, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    else:
        assert tcli.main(args["port"] + ["--device", "cpu"]) == 0
    if case == "demo":
        assert jcli.main(args["jax"]) == 0
    capsys.readouterr()

    sess = build_session(load_config(
        config, data_folder=ws["data_folder"], cam_param=ws["cam_param"],
        model_folder=os.path.join(ws["root"], "absent"),
        prior_folder=os.path.join(ws["root"], "absent")), device="cpu")
    faces = sess.assets.faces.numpy()
    want = []
    for frame in sess.dataset:
        d = os.path.join(ws["serial"], frame.frame_name)
        result_dir = os.path.join(outs["port"], "results", d)
        again = {k: str(tmp_path / k / d) for k in ("port_again",
                                                    "jax_again")}
        if people == 1:
            verts = _cli_verts(sess, result_dir, ["000"])[0]
            TO.save_overlays(again["port_again"], frame, sess.cameras,
                             verts, faces)
            JO.save_overlays(again["jax_again"], frame, sess.cameras,
                             verts, faces)
        else:
            live = frame.person_mask.max(axis=0)
            verts = _cli_verts(sess, result_dir,
                               [f"{p:03d}" for p in range(people) if live[p]])
            everyone = np.zeros((people,) + verts.shape[1:], np.float32)
            everyone[live > 0] = verts
            for k, mod in (("port_again", TO), ("jax_again", JO)):
                mod.save_overlays_multi(again[k], frame, sess.cameras,
                                        everyone, faces, live=live)
        for v in range(6):
            n = os.path.join("images", d, f"{v:02d}.jpg")
            want.append(n)
            with open(os.path.join(outs["port"], n), "rb") as f:
                ours = f.read()
            for k in again:
                with open(os.path.join(again[k], f"{v:02d}.jpg"), "rb") as f:
                    assert ours == f.read(), (k, n)
            a = cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_COLOR)
            painted = (a.max(-1) > 32).sum()
            assert painted > 1000, (n, painted)
            if case == "demo":
                b = cv2.imread(os.path.join(outs["jax"], n))
                close = (np.abs(a.astype(int) - b).max(-1) <= 4).mean()
                assert close >= 0.995, (n, close)

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, ns in os.walk(os.path.join(root, "images"))
                      for n in ns)
    assert files(outs["port"]) == sorted(want)
    assert len(want) == 6 * n_frames
    if case == "demo":
        assert files(outs["jax"]) == sorted(want)


def test_frame_without_people_saves_no_body(tmp_path):
    """A multi-person frame where no one is seen writes no pkl or mesh
    and hands its overlays no body (JAX draws none either), where the
    stacking of no results used to raise."""
    import types

    from mvsmplfitting_tpu_torch.fitting.stages import FitResult
    cfg = types.SimpleNamespace(save_meshes=True, save_images=True)
    sess = types.SimpleNamespace(assets=types.SimpleNamespace(
        v_template=torch.zeros((6890, 3))))
    zeros = torch.zeros((2, 10))
    result = FitResult(
        params=SMPLParams(betas=zeros, global_orient=zeros[:, :3],
                          body_pose=torch.zeros((2, 69)),
                          transl=zeros[:, :3], scale=torch.ones(2)),
        z=torch.zeros((2, 32)), body_pose=torch.zeros((2, 69)),
        loss=torch.zeros(2), stage_losses=torch.zeros((2, 4)),
        lm_iters=torch.zeros((2, 4)))
    verts = tcli._save_outputs(cfg, sess, result, [], str(tmp_path / "r"),
                               str(tmp_path / "m"))
    assert verts.shape == (0, 6890, 3)
    assert not (tmp_path / "r").exists() and not (tmp_path / "m").exists()
