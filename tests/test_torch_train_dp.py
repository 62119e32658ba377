"""The port's data-parallel training (`mvsmplfitting_tpu_torch.parallel.
data_parallel`, `detect/train.py` with a process group, the datasets'
rank blocks and the training CLIs under ``env://``) on gloo worlds of CPU
processes, against the one-process step on the global batch and JAX.

A world of 2 ranks and a world of 4 are started once for the module
(`tests/torch_train_dp_worker.py`); while they run, this process makes
the references: JAX's toy step on one device and sharded over the
8-device CPU mesh (`tests/test_train.py:533-563`'s recipe), JAX's YOLOX
and HybrIK losses, and the port's one-process runs of the same pieces.

Tolerances (PR 13's, everything in float64): losses rtol 1e-5;
parameters, BatchNorm statistics and EMA after a step rtol 1e-5 (atol
1e-12); gradients rtol 1e-4 / atol 1e-6 max|g|; BatchNorm outputs rtol
1e-10 (one layer, no accumulation); the CLIs' first float32 loss rtol
1e-5.  Ranks that hold the same result hold it bitwise, and the
datasets' rows are bitwise the one-process rows.
"""

import json
import os
import socket
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_dp_worker as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_ports(n: int):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _exif_app1(orientation: int) -> bytes:
    """A JPEG APP1 segment whose EXIF block holds one Orientation tag."""
    tiff = (b"II*\x00" + struct.pack("<IH", 8, 1)
            + struct.pack("<HHIHH", 0x112, 3, 1, orientation, 0)
            + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def _workspace(root) -> dict:
    """Images of several sizes (JPEGs, a PNG, a JPEG turned by its EXIF
    orientation, an annotated image with no file), COCO person-keypoint
    GT (12 persons) and instances GT (10 images, 1-3 boxes)."""
    import cv2
    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    names = []
    for i, (h, w) in enumerate([(120, 90), (70, 150), (96, 96), (140, 60),
                                (64, 110), (100, 130)]):
        ext = "png" if i == 3 else "jpg"
        names.append(f"im{i}.{ext}")
        cv2.imwrite(os.path.join(img_dir, names[-1]),
                    rng.integers(0, 255, (h, w, 3), np.uint8))
    data = open(os.path.join(img_dir, "im5.jpg"), "rb").read()
    with open(os.path.join(img_dir, "im5.jpg"), "wb") as f:
        f.write(data[:2] + _exif_app1(6) + data[2:])   # decodes as 130x100
    names.append("missing.jpg")
    images = [{"id": i, "file_name": n} for i, n in enumerate(names)]
    cats = [{"id": 1, "name": "person"}]
    anns = []
    for k in range(12):
        x, y = rng.uniform(2, 20, 2)
        kp = np.zeros((17, 3))
        kp[:, 0] = rng.uniform(x, x + 40, 17)
        kp[:, 1] = rng.uniform(y, y + 50, 17)
        kp[:, 2] = (rng.uniform(0, 1, 17) > 0.2) * 2
        anns.append({"id": k, "image_id": k % len(names), "category_id": 1,
                     "bbox": [float(x), float(y), 40.0, 50.0],
                     "keypoints": kp.ravel().tolist()})
    ws = {"img_root": img_dir, "pose": os.path.join(root, "pose.json"),
          "det": os.path.join(root, "det.json")}
    with open(ws["pose"], "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": cats}, f)
    det_images = [{"id": i, "file_name": names[i % len(names)]}
                  for i in range(10)]
    anns = []
    for i in range(10):
        for _ in range(int(rng.integers(1, 4))):
            w, h = rng.uniform(12, 40, 2)
            anns.append({"id": len(anns), "image_id": i, "category_id": 1,
                         "bbox": [float(v) for v in (*rng.uniform(0, 20, 2),
                                                     w, h)]})
    with open(ws["det"], "w") as f:
        json.dump({"images": det_images, "annotations": anns,
                   "categories": cats}, f)
    return ws


def _jax_toy():
    from flax import linen as nn

    from mvsmplfitting_tpu.detect.blocks import ConvBnAct, batch_norm

    class _ToyPose(nn.Module):
        """`tests/test_train.py:478-489`."""
        num_joints: int = 3

        @nn.compact
        def __call__(self, x):
            x = ConvBnAct(8, 3, 2, act="relu", name="c1")(x)
            x = nn.ConvTranspose(8, (4, 4), strides=(2, 2), padding="SAME",
                                 name="up")(x)
            x = batch_norm(self, name="bn_up")(x)
            x = nn.relu(x)
            return nn.Conv(self.num_joints, (1, 1), name="final")(x)
    return _ToyPose()


def _jax_refs(variables):
    """JAX's toy step (one device, and sharded over the 8-device mesh),
    YOLOX losses and HybrIK loss on the global batch, in float64."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from mvsmplfitting_tpu.detect import train as JT
    from mvsmplfitting_tpu.detect.yolox_loss import yolox_losses
    from mvsmplfitting_tpu.models.assets import synthetic_smpl
    from mvsmplfitting_tpu.parallel.mesh import MeshLayout, make_mesh

    model = _jax_toy()
    out = {}
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        tx = JT.make_optimizer("sgd", W.LR, momentum=W.MOMENTUM,
                               weight_decay=W.WD)
        step = JT.make_train_step(
            lambda v, b, m: model.apply(v, b["image"], mutable=m),
            lambda o, b: JT.pose_heatmap_loss(o, b["target"],
                                              b["target_weight"]), tx)
        batch = cast(W.toy_batch())
        shard = NamedSharding(make_mesh(MeshLayout(frames=8, cameras=1)),
                              P("frames"))
        for name, b in (("single", batch), ("sharded", jax.tree_util.tree_map(
                lambda x: jax.device_put(x, shard), batch))):
            st, loss, _ = step(JT.init_train_state(cast(variables), tx), b)
            out[name] = (jax.tree_util.tree_map(np.asarray, st), float(loss))

        inp = W.yolox_inputs()
        js = jax.jit(lambda d, l, r: yolox_losses(
            d, l, W.YOLOX_HW, origin_reg=r, use_l1=True))(
            jnp.asarray(inp["decoded"]), jnp.asarray(inp["labels"]),
            jnp.asarray(inp["origin_reg"]))
        out["yolox"] = {k: float(v) for k, v in js.items()}

        ho, hb = W.hybrik_inputs()
        assets = synthetic_smpl("smpl")
        loss, aux = jax.jit(lambda o, b: JT.hybrik_smpl_loss(
            o, b, assets=assets))(
            {k: jnp.asarray(v) for k, v in ho.items()},
            {k: jnp.asarray(v) for k, v in hb.items()})
        out["hybrik"] = (float(loss), {k: float(v) for k, v in aux.items()})
    return out


def _one_process(ws, toy_sd, tmp):
    """The port's one-process runs of every piece, and of both CLIs."""
    from mvsmplfitting_tpu_torch.cli import train_pose, train_yolox
    everything = slice(None)
    out = {"bn": W.run_bn(None, everything),
           "toy": W.run_toy(toy_sd, None, everything),
           "yolox": W.run_yolox(None, everything),
           "hybrik": W.run_hybrik(None, everything),
           "data": W.run_data(ws, 0, 1)}
    out["cli"] = {
        "pose": train_pose.main(["--ann", ws["pose"]] + W.POSE_CLI + [
            "--img_root", ws["img_root"], "--out", str(tmp / "pose"),
            "--device", "cpu"]),
        "yolox": train_yolox.main(["--ann", ws["det"]] + W.YOLOX_CLI + [
            "--img_root", ws["img_root"], "--out", str(tmp / "yolox"),
            "--device", "cpu"])}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{'ranks': {2: [...], 4: [...]}, 'one': the port's one-process
    runs, 'jax': JAX's references, 'jax_sd': JAX's initial toy tree in
    the port's names}."""
    root = tmp_path_factory.mktemp("train_dp")
    ws = _workspace(str(root))
    model = _jax_toy()
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, *W.TOY_HW, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    toy_sd = W.toy_state_from_flax(variables)
    in_dir = root / "in"
    in_dir.mkdir()
    torch.save({"toy_sd": toy_sd, "ws": ws}, str(in_dir / "inputs.pt"))

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs, dirs = [], {}
    for world in WORLDS:
        dirs[world] = root / f"world{world}"
        dirs[world].mkdir()
        ports = ",".join(str(p) for p in _free_ports(3))
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests",
                                              "torch_train_dp_worker.py"),
                 str(rank), str(world), ports, str(in_dir),
                 str(dirs[world])],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    try:
        jax_refs = _jax_refs(variables)
        one = _one_process(ws, toy_sd, root)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = {world: [torch.load(str(dirs[world] / f"rank{r}.pt"),
                                weights_only=False) for r in range(world)]
             for world in WORLDS}
    return {"ranks": ranks, "one": one, "jax": jax_refs, "ws": ws}


def _close(got, want, rtol=RTOL, atol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _bitwise_same(ranks, key):
    """Every rank's `key` result bitwise rank 0's; returns rank 0's."""
    def eq(a, b, path):
        if torch.is_tensor(a):
            assert torch.equal(a, b), path
        elif isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                eq(a[k], b[k], f"{path}.{k}")
        else:
            assert a == b, path
    for r in ranks[1:]:
        eq(ranks[0][key], r[key], key)
    return ranks[0][key]


def _check_step(got, want, grad_keys=None):
    """A data-parallel step against the one-process step: loss, the
    gradients, then every tensor of the state and of the EMA."""
    _close(got["loss"], want["loss"], msg="loss")
    g = want["grads"]
    gmax = max(float(v.abs().max()) for v in g.values())
    assert gmax > 0
    for k in grad_keys or g:
        _close(got["grads"][k], g[k], rtol=1e-4, atol=1e-6 * gmax, msg=k)
    for part in ("state", "ema"):
        for k, v in want[part].items():
            if v.is_floating_point():
                _close(got[part][k], v, msg=f"{part} {k}")
            else:
                assert torch.equal(got[part][k], v), (part, k)


@pytest.mark.parametrize("world", WORLDS)
def test_batchnorm_statistics_over_global_batch(runs, world):
    """Output rows, running statistics (biased variance) and the input
    gradient, whose rows hold the other ranks' terms."""
    one = runs["one"]["bn"]
    ranks = runs["ranks"][world]
    for r in ranks[1:]:
        for k in ("mean", "var"):
            assert torch.equal(r["bn"][k], ranks[0]["bn"][k]), k
    for r in ranks:
        lo, hi = r["rows"]
        _close(r["bn"]["y"], one["y"][lo:hi], rtol=1e-10)
        _close(r["bn"]["gx"], one["gx"][lo:hi], rtol=1e-8, atol=1e-12)
        for k in ("mean", "var"):
            np.testing.assert_allclose(r["bn"][k], one[k], rtol=1e-12)
        assert r["bn"]["tracked"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_toy_step_matches_jax_sharded_and_one_process(runs, world):
    """JAX's toy SGD step sharded over 8 devices and on one, the port's
    one-process step and each world's: the same loss, gradients,
    parameters, statistics and EMA; every rank's bytes the same."""
    got = _bitwise_same(runs["ranks"][world], "toy")
    _check_step(got, runs["one"]["toy"])
    for name in ("single", "sharded"):
        st, loss = runs["jax"][name]
        _close(got["loss"], loss, msg=f"jax {name} loss")
        new = W.toy_state_from_flax({"params": st.params,
                                     "batch_stats": st.batch_stats})
        ema = W.toy_state_from_flax(st.ema)
        for k, v in new.items():
            if k.endswith("num_batches_tracked"):
                continue
            _close(got["state"][k], v, msg=f"jax {name} {k}")
            _close(got["ema"][k], ema[k], msg=f"jax {name} ema {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_yolox_step_global_normalizers(runs, world):
    """A small YOLOX step (L1 branch on) whose ranks hold 0-5 boxes an
    image: the global num_fg and loss, and the one-process step's
    gradients, parameters, statistics and EMA."""
    got = _bitwise_same(runs["ranks"][world], "yolox")
    one = runs["one"]["yolox"]
    _check_step(got, one)
    for k in ("num_fg", "fg_ratio", "iou", "obj", "cls", "l1"):
        _close(got["aux"][k], one["aux"][k], msg=k)
    assert float(got["aux"]["num_fg"]) > 1


@pytest.mark.parametrize("world", WORLDS)
def test_yolox_losses_match_jax(runs, world):
    """Fixed decoded outputs: the ranks' summed shares and their global
    counts against JAX's and the port's losses on the whole batch."""
    got = _bitwise_same(runs["ranks"][world], "yolox")["losses"]
    one = runs["one"]["yolox"]["losses"]
    for k, v in runs["jax"]["yolox"].items():
        _close(got[k], v, msg=f"jax {k}")
        _close(got[k], one[k], msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_hybrik_loss_global_weight_mass(runs, world):
    """Rows with unequal weight mass: the global loss and parts against
    JAX's and the port's on the whole batch; each rank's gradient on its
    rows' outputs against the one-process gradient's rows."""
    ranks = runs["ranks"][world]
    one = runs["one"]["hybrik"]
    jloss, jaux = runs["jax"]["hybrik"]
    for r in ranks:
        _close(r["hybrik"]["loss"], jloss, msg="jax loss")
        _close(r["hybrik"]["loss"], one["loss"], msg="loss")
        for k, v in jaux.items():
            _close(r["hybrik"]["aux"][k], v, msg=f"jax {k}")
        lo, hi = np.array_split(np.arange(W.HYB_N), len(ranks))[
            ranks.index(r)][[0, -1]]
        gmax = max(float(g.abs().max()) for g in one["grads"].values())
        for k, g in one["grads"].items():
            _close(r["hybrik"]["grads"][k], g[lo:hi + 1], rtol=1e-4,
                   atol=1e-6 * gmax, msg=k)


@pytest.mark.parametrize("kind", ["pose", "det_mosaic1", "det_mosaic0"])
@pytest.mark.parametrize("world", WORLDS)
def test_dataset_rows_are_the_one_process_rows(runs, world, kind):
    """Two epochs: each rank's batches are bitwise its block of the
    one-process batches, and it decoded only its own rows' images (the
    ranks' reads, in rank order, are the one-process reads)."""
    one = runs["one"]["data"][kind]
    ranks = [r["data"][kind] for r in runs["ranks"][world]]
    assert len(one) >= 4 and all(len(r) == len(one) for r in ranks)
    per = 4 // world
    for b, (batch, reads) in enumerate(one):
        for rank, r in enumerate(ranks):
            got, _ = r[b]
            for k, v in batch.items():
                np.testing.assert_array_equal(
                    got[k], v[rank * per:(rank + 1) * per], err_msg=k)
        assert sum((r[b][1] for r in ranks), []) == reads, b
    assert all(sum(len(r[b][1]) for b in range(len(one)))
               < sum(len(x) for _, x in one) for r in ranks)


@pytest.mark.parametrize("name", ["pose", "yolox"])
def test_cli_on_world_of_two(runs, name):
    """The CLI through ``env://``: every rank returns the same result,
    the first global loss is the one-process run's, rank 0 alone wrote
    its files."""
    ranks = [r["cli"] for r in runs["ranks"][2]]
    one = runs["one"]["cli"][name]
    a, b = ranks[0][name], ranks[1][name]
    assert a == b
    assert a["steps"] == one["steps"] == 2
    _close(a["losses"][0], one["losses"][0], msg="first loss")
    assert np.isfinite(a["losses"]).all()
    files = [f for f in ranks[0]["files"] if f.startswith(f"out_{name}/")]
    assert sorted(files) == [f"out_{name}/{f}" for f in (
        "ema.npz", "last.npz", "train_metrics.jsonl")]
    assert ranks[1]["files"] == []


def test_cli_refuses_indivisible_batch(runs):
    for r in runs["ranks"][2]:
        msg = r["cli"]["indivisible"]
        assert "3" in msg and "2 ranks" in msg, msg


@pytest.mark.parametrize("name,hw", [("im0.jpg", (120, 90)),
                                     ("im3.png", (140, 60)),
                                     ("im5.jpg", (130, 100))])
def test_header_size_is_the_decoded_size(runs, name, hw):
    """`image_hw` reads the size the reader decodes, EXIF turn included."""
    from mvsmplfitting_tpu_torch.data.images import image_hw, read_image
    path = os.path.join(runs["ws"]["img_root"], name)
    assert image_hw(path) == hw == read_image(path).shape[:2]



def _refused(case, ws):
    from mvsmplfitting_tpu_torch.detect.dataset import (
        CocoDetTrainDataset, CocoPoseTrainDataset)
    from mvsmplfitting_tpu_torch.parallel import init_data_parallel
    if case == "no_coordinator":
        init_data_parallel("cpu")
    elif case == "dataset_indivisible":
        CocoDetTrainDataset(ws["det"], ws["img_root"], (64, 64),
                            batch_size=4, rank=0, world=3)
    else:
        CocoPoseTrainDataset(ws["pose"], ws["img_root"], (64, 48), (16, 12),
                             batch_size=4, rank=2, world=2)


@pytest.mark.parametrize("case,error,match", [
    ("no_coordinator", RuntimeError, "WORLD_SIZE=2 without MASTER_ADDR"),
    ("dataset_indivisible", ValueError,
     "batch of 4 does not divide over a world of 3"),
    ("rank_outside", ValueError, "rank 2 is not in a world of 2")])
def test_world_is_never_quietly_one_process(runs, monkeypatch, case, error,
                                            match):
    """A world announced without a coordinator, a batch the world does
    not divide and a rank outside its world are refused."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(error, match=match):
        _refused(case, runs["ws"])
