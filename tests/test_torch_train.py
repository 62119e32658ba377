"""The port's training scaffolding (`mvsmplfitting_tpu_torch.detect.
train`) against the JAX package's `detect/train.py` on the same inputs.

Schedules and EMA at rtol 1e-6; the three optimizers fed identical
gradients for 3 steps against optax at rtol 1e-6 (atol 1e-7 max|p|), which
keeps autograd's round-off out of the comparison (Adam's first step is
sign-like); flax's train-mode BatchNorm; the integral loss and its
surrogate backward; one SGD train step of JAX's small SimplePose
(128x96, deconv 32-32-32, `tests/test_train_cli.py:102`) from JAX's
initial tree carried across with `weights.pose_state_from_flax`: loss
rtol 1e-5; gradients rtol 1e-4 / atol 1e-6 max|g|, and BatchNorm
running statistics, parameters and EMA after the step rtol 1e-5, in
float64 (see there); the HybrIK criterion with the analytic IK.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mvsmplfitting_tpu.detect import train as JT
from mvsmplfitting_tpu_torch.detect import train as T
from mvsmplfitting_tpu_torch.detect import weights as W

POSE_HW = (128, 96)
HM_HW = (32, 24)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SCHEDULE_KW = dict(warmup_epochs=2, no_aug_epochs=3, min_lr_ratio=0.05,
                   milestones=(3, 6), factor=0.1)


@pytest.mark.parametrize("name", ["cos", "warmcos", "yoloxwarmcos",
                                  "multistep"])
def test_schedule_matches_jax(name):
    js = JT.lr_schedule(name, 0.01, 7, 10, **SCHEDULE_KW)
    ts = T.lr_schedule(name, 0.01, 7, 10, **SCHEDULE_KW)
    for it in (0, 1, 5, 13, 14, 15, 22, 30, 41, 48, 49, 50, 55, 69):
        j = float(js(jnp.asarray(it, jnp.int32)))
        t = float(ts(it))
        np.testing.assert_allclose(t, j, rtol=1e-6, err_msg=f"iter {it}")


def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    for u in (1, 7, 2000, 10 ** 5):
        np.testing.assert_allclose(float(T.ema_decay(u)),
                                   float(JT.ema_decay(jnp.float32(u))),
                                   rtol=1e-6)
    ema = {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
           "n": np.asarray(5, np.int64)}
    new = {"w": rng.normal(0, 1, (3, 4)).astype(np.float32),
           "n": np.asarray(9, np.int64)}
    j = JT.ema_update({"w": jnp.asarray(ema["w"]), "n": jnp.asarray(5)},
                      {"w": jnp.asarray(new["w"]), "n": jnp.asarray(9)},
                      jnp.float32(37))
    t = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    T.ema_update(t, {k: torch.from_numpy(v) for k, v in new.items()}, 37)
    np.testing.assert_allclose(t["w"].numpy(), np.asarray(j["w"]),
                               rtol=1e-6)
    assert int(t["n"]) == 5 == int(j["n"])      # integers are not averaged


@pytest.mark.parametrize("name", ["adam", "rmsprop", "sgd"])
def test_optimizer_matches_optax(name):
    """Identical gradients, 3 steps, lr from a schedule read at optax's
    count; sgd's weight decay only on the tensors of ndim >= 2."""
    rng = np.random.default_rng(1)
    shapes = {"conv": (4, 3, 3, 3), "bias": (5,), "dense": (6, 7)}
    p0 = {k: rng.normal(0, 1, s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    js = JT.lr_schedule("cos", 0.05, 2, 3)
    tx = JT.make_optimizer(name, js)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    keys = sorted(shapes)
    tp = [torch.from_numpy(p0[k].copy()) for k in keys]
    opt = T.Optimizer(name, T.lr_schedule("cos", 0.05, 2, 3), tp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.from_numpy(g[k]) for k in keys])
    # atol: where a step nearly cancels a parameter, an ulp of the step
    # (XLA's approximate rsqrt against torch's 1/sqrt) dominates.
    pmax = max(float(np.abs(v).max()) for v in p0.values())
    for k, t in zip(keys, tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-7 * pmax, err_msg=f"{name} {k}")


def test_batchnorm_train_mode_is_flax():
    """Batch statistics in the normalization; running statistics moved
    by 0.1 toward the mean and the BIASED variance (torch's own
    BatchNorm2d folds in the unbiased one); eval mode is nn.BatchNorm2d
    bitwise."""
    from flax import linen as fnn

    from mvsmplfitting_tpu_torch.detect.blocks import BatchNorm2d
    rng = np.random.default_rng(2)
    x = rng.normal(0.3, 1.1, (4, 5, 5, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    bias = rng.normal(0, 0.1, 3).astype(np.float32)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.zeros(3), "var": jnp.ones(3)}}
    y, mut = mod.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    bn = BatchNorm2d(3, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    yt = bn(xt)
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5)
    ref = torch.nn.BatchNorm2d(3, eps=1e-5)
    ref.train()
    ref(xt)
    assert not np.allclose(ref.running_var.numpy(),
                           bn.running_var.numpy(), rtol=1e-5)
    ref.load_state_dict(bn.state_dict())
    bn.eval()
    ref.eval()
    assert torch.equal(bn(xt), ref(xt))
    assert int(bn.num_batches_tracked) == 1


@pytest.mark.parametrize("output_3d,norm_type", [(False, "softmax"),
                                                 (False, "sigmoid"),
                                                 (True, "softmax")])
def test_integral_loss_and_surrogate_backward(output_3d, norm_type):
    rng = np.random.default_rng(3)
    N, J, D, H, W_ = 2, 3, 4, 8, 6
    C = J * D if output_3d else J
    hms = rng.normal(0, 2, (N, H, W_, C)).astype(np.float32)
    dims = 3 if output_3d else 2
    target = rng.uniform(-0.5, 0.5, (N, J * dims)).astype(np.float32)
    tw = (rng.uniform(0, 1, (N, J * dims)) > 0.2).astype(np.float32)

    def jloss(h):
        return JT.integral_l1_loss(h, jnp.asarray(target), jnp.asarray(tw),
                                   norm_type, output_3d)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(hms))
    jc, js = jax.jit(JT.integral_coords, static_argnums=(1, 2, 3))(
        jnp.asarray(hms), J, norm_type, output_3d)

    th = torch.from_numpy(hms).permute(0, 3, 1, 2).contiguous()
    th.requires_grad_(True)
    tl = T.integral_l1_loss(th, torch.from_numpy(target),
                            torch.from_numpy(tw), norm_type, output_3d)
    (tg,) = torch.autograd.grad(tl, th)
    tc, ts = T.integral_coords(th.detach(), J, norm_type, output_3d)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg), rtol=1e-4, atol=1e-7)


def test_heatmap_targets_equal_jax():
    rng = np.random.default_rng(4)
    xy = rng.uniform(-10, 110, (17, 2)).astype(np.float32)
    vis = (rng.uniform(0, 1, 17) > 0.3).astype(np.float32)
    a = JT.heatmap_targets_np(xy, vis, HM_HW, POSE_HW)
    b = T.heatmap_targets_np(xy, vis, HM_HW, POSE_HW)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    a = JT.integral_targets_np(xy, vis, POSE_HW)
    b = T.integral_targets_np(xy, vis, POSE_HW)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------------------
# One train step of JAX's small SimplePose, from JAX's initial tree

LR, MOMENTUM, WD = 0.01, 0.9, 5e-4


@pytest.fixture(scope="module")
def pose_step():
    """JAX's own SGD train step (`make_pose_train_step`) in float64, and
    the port's in float32 and float64, from JAX's initial tree.  JAX's
    gradient is read back from its step: a first SGD step moves p by
    -lr (1 + momentum) (g + wd p) (wd on tensors of ndim >= 2)."""
    from mvsmplfitting_tpu.detect.zoo import build_pose_model as jbuild
    from mvsmplfitting_tpu_torch.detect.zoo import build_pose_model

    rng = np.random.default_rng(5)
    N, J = 2, 17
    jmodel = jbuild("simplepose", J, deconv_filters=(32, 32, 32))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, *POSE_HW, 3)))
    images = rng.uniform(0, 1, (N, *POSE_HW, 3)).astype(np.float32)
    targets, weights = [], []
    for _ in range(N):
        t, w = T.heatmap_targets_np(
            rng.uniform(0, 96, (J, 2)), (rng.uniform(0, 1, J) > 0.2),
            HM_HW, POSE_HW)
        targets.append(np.transpose(t, (1, 2, 0)))
        weights.append(w[:, 0])
    batch = {"image": images, "target": np.stack(targets),
             "target_weight": np.stack(weights)}

    def jax_step(dtype):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, dtype)), t)
        tx = JT.make_optimizer("sgd", LR, momentum=MOMENTUM,
                               weight_decay=WD)
        st = JT.init_train_state(cast(variables), tx)
        st, loss, _ = JT.make_pose_train_step(jmodel, tx)(st, cast(batch))
        return jax.tree_util.tree_map(np.asarray, st), float(loss)

    with jax.enable_x64(True):
        jstate64, jloss = jax_step(np.float64)
    p0 = W.pose_state_from_flax("simplepose", variables)
    p1 = W.pose_state_from_flax("simplepose", {
        "params": jstate64.params, "batch_stats": jstate64.batch_stats})
    jgrads = {k: (p0[k].astype(np.float64) - p1[k]) / (LR * (1 + MOMENTUM))
              - (WD * p0[k] if p0[k].ndim >= 2 else 0.0)
              for k in p0 if k.endswith(("weight", "bias"))}

    def port_model(dtype=torch.float32):
        m = build_pose_model("simplepose", J, deconv_filters=(32, 32, 32))
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in p0.items()})
        return m.to(dtype)

    def port_step(dtype):
        model = port_model(dtype)
        opt = T.Optimizer("sgd", LR, list(model.parameters()),
                               momentum=MOMENTUM, weight_decay=WD)
        state = T.init_train_state(model, opt)
        loss, _ = T.make_pose_train_step()(state, {
            k: torch.from_numpy(v).to(dtype) for k, v in batch.items()})
        return state, float(loss)

    gm = port_model(torch.float64).train()
    b64 = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    loss = T.pose_heatmap_loss(gm(T.nchw(b64["image"])),
                               T.nchw(b64["target"]), b64["target_weight"])
    tgrads = dict(zip([n for n, _ in gm.named_parameters()],
                      torch.autograd.grad(loss, list(gm.parameters()))))
    state, tloss = port_step(torch.float32)
    state64, _ = port_step(torch.float64)
    return dict(jgrads=jgrads, jstate64=jstate64, jloss=jloss, tgrads=tgrads, state=state, state64=state64,
                tloss=tloss)


def test_train_step_loss_and_gradients_match_jax(pose_step):
    """The float32 step's loss; the gradients in float64 in both
    packages: at batch 2 the train-mode BatchNorms' backward cancels so
    far that either package's float32 gradient of the early layers is
    1-10% from its own float64 one (ROADMAP C)."""
    s = pose_step
    np.testing.assert_allclose(s["tloss"], s["jloss"], rtol=1e-5)
    gmax = max(float(g.abs().max()) for g in s["tgrads"].values())
    assert gmax > 0 and set(s["tgrads"]) == set(s["jgrads"])
    for k, g in s["tgrads"].items():
        np.testing.assert_allclose(g.numpy(), s["jgrads"][k], rtol=1e-4,
                                   atol=1e-6 * gmax, err_msg=k)


def test_train_step_state_matches_jax(pose_step):
    """After the step, in the reference's names: the BatchNorm running
    statistics (biased variance), the parameters and the EMA of every
    float tensor at rtol 1e-5, from the float64 steps; the float32
    step's statistics at rtol 1e-4 (atol 1e-4 of each tensor's largest
    magnitude: the batch-2 train-mode forward carries float32 round-off
    of a few 1e-6 into layer 3); `num_batches_tracked` counts the step
    and is not averaged."""
    s = pose_step
    js = s["jstate64"]
    new = W.pose_state_from_flax("simplepose", {
        "params": js.params, "batch_stats": js.batch_stats})
    ema = W.pose_state_from_flax("simplepose", js.ema)
    sd = s["state64"].model.state_dict()
    sd32 = s["state"].model.state_dict()
    n = 0
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(sd32[k]) == 1
            assert int(s["state64"].ema[k]) == 0
            continue
        np.testing.assert_allclose(v.numpy(), new[k], rtol=1e-5,
                                   atol=1e-10, err_msg=k)
        np.testing.assert_allclose(s["state64"].ema[k].numpy(), ema[k],
                                   rtol=1e-5, atol=1e-10, err_msg=k)
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                sd32[k].numpy(), new[k], rtol=1e-4,
                atol=1e-4 * float(np.abs(new[k]).max()), err_msg=k)
        n += 1
    assert n == len(sd) - sum(k.endswith("num_batches_tracked") for k in sd)
    assert s["state"].step == s["state64"].step == int(js.step) == 1


# ---------------------------------------------------------------------------
# HybrIK's criterion, theta through the analytic IK

def test_hybrik_loss_matches_jax():
    from mvsmplfitting_tpu.detect import augment3d as J3
    from mvsmplfitting_tpu.models.assets import synthetic_smpl as jsmpl
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl

    rng = np.random.default_rng(6)
    N = 2
    samples = []
    for i in range(N):
        j17 = np.concatenate([rng.uniform(60, 200, (17, 2)),
                              rng.uniform(-400, 400, (17, 1))], 1)
        j29 = np.concatenate([rng.uniform(60, 200, (29, 2)),
                              rng.uniform(-400, 400, (29, 1))], 1)
        label = {"bbox": [40, 40, 220, 220], "joint_img_17": j17,
                 "joint_vis_17": np.ones((17, 3)),
                 "joint_relative_17": rng.normal(0, 300, (17, 3)),
                 "joint_img_29": j29, "joint_vis_29": np.ones((29, 3)),
                 "joint_cam_29": rng.normal(0, 300, (29, 3)),
                 "beta": rng.normal(0, 1, 10),
                 "theta": rng.normal(0, 0.3, (24, 3)),
                 "twist_phi": rng.normal(0, 1, (23, 2)),
                 "twist_weight": np.ones((23, 2))}
        samples.append(J3.hybrik_train_sample(
            np.random.default_rng(i), rng.uniform(0, 255, (260, 260, 3)),
            label))
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    out = {"pred_uvd_jts": rng.uniform(-0.3, 0.3, (N, 29, 3)),
           "pred_shape": rng.normal(0, 0.5, (N, 10)),
           "pred_phi": rng.normal(0, 1, (N, 23, 2)),
           "pred_camera": np.array([0.9, 0.0, 0.0]) + rng.normal(
               0, 0.05, (N, 3))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    keys = sorted(out)

    jassets = jsmpl("smpl")

    def jfn(*vals):
        return JT.hybrik_smpl_loss(
            dict(zip(keys, vals)), {k: jnp.asarray(v)
                                    for k, v in batch.items()},
            assets=jassets)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(len(keys))), has_aux=True))(
        *[jnp.asarray(out[k]) for k in keys])

    tv = [torch.from_numpy(out[k]).requires_grad_(True) for k in keys]
    tl, taux = T.hybrik_smpl_loss(
        dict(zip(keys, tv)), {k: torch.from_numpy(v)
                              for k, v in batch.items()},
        assets=synthetic_smpl("smpl", device="cpu"))
    tg = torch.autograd.grad(tl, tv)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    for k, a, b in zip(keys, tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
