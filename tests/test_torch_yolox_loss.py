"""The port's YOLOX training loss (`detect/yolox_loss.py`) and YOLOX
train outputs against the JAX package's, on the same inputs.

SimOTA's `fg` and `matched_gt` exactly equal on random heads, with and
without tied costs (both argsorts are stable); `yolox_losses`' parts at
rtol 1e-5 and their gradients in the decoded boxes, logits and raw reg
at rtol 1e-4; the net of `tests/test_train_cli.py:193` (YOLOX depth 0.33,
width 0.125, 64x64) from JAX's initial tree: its train outputs, and
one SGD step in train mode in float64 (loss parts rtol 1e-5, parameters,
BatchNorm statistics and EMA rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvsmplfitting_tpu.detect import train as JT
from mvsmplfitting_tpu.detect import yolox_loss as JL
from mvsmplfitting_tpu_torch.detect import train as T
from mvsmplfitting_tpu_torch.detect import weights as W
from mvsmplfitting_tpu_torch.detect import yolox_loss as L

HW = (64, 64)
A = (64 // 8) ** 2 + (64 // 16) ** 2 + (64 // 32) ** 2


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _heads(seed, N=3, C=2, G=8, ties=False):
    """Decoded heads (boxes around the anchors, obj/cls logits), raw reg
    and labels with padding rows; `ties` copies one anchor's prediction
    onto its neighbours so that several costs tie exactly."""
    rng = np.random.default_rng(seed)
    xs, ys, ss = (np.asarray(a) for a in JL.anchor_info(HW))
    ctr = np.stack([(xs + 0.5) * ss, (ys + 0.5) * ss], -1)
    raw = rng.normal(0, 0.5, (N, A, 4)).astype(np.float32)
    dec = np.concatenate([
        ctr[None] + raw[..., :2] * ss[None, :, None],
        np.exp(raw[..., 2:4]) * ss[None, :, None] * 2.0,
        rng.normal(0, 1.5, (N, A, 1 + C))], -1).astype(np.float32)
    if ties:
        dec[:, 1:12] = dec[:, :1]
        raw[:, 1:12] = raw[:, :1]
    labels = np.zeros((N, G, 5), np.float32)
    for n in range(N):
        m = rng.integers(1, G - 1)
        wh = rng.uniform(8, 40, (m, 2))
        c = rng.uniform(wh / 2, 64 - wh / 2)
        labels[n, :m] = np.concatenate(
            [rng.integers(0, C, (m, 1)), c, wh], -1)
    if ties:
        labels[:, 0, 1:] = [dec[0, 0, 0], dec[0, 0, 1], 20.0, 20.0]
    return dec, raw, labels


@pytest.mark.parametrize("seed,ties", [(0, False), (1, False), (2, True)])
def test_simota_assignment_equals_jax(seed, ties):
    dec, _, labels = _heads(seed, ties=ties)
    xs, ys, ss = JL.anchor_info(HW)
    ja = jax.jit(jax.vmap(lambda b, o, c, l: JL.simota_assign(
        b, o, c, l, xs, ys, ss, HW)))(
        jnp.asarray(dec[..., :4]), jnp.asarray(dec[..., 4]),
        jnp.asarray(dec[..., 5:]), jnp.asarray(labels))
    txs, tys, tss = L.anchor_info(HW)
    ta = L.simota_assign(torch.from_numpy(dec[..., :4]),
                         torch.from_numpy(dec[..., 4]),
                         torch.from_numpy(dec[..., 5:]),
                         torch.from_numpy(labels), txs, tys, tss, HW)
    assert int(np.asarray(ja["fg"]).sum()) > 0
    np.testing.assert_array_equal(ta["fg"].numpy(), np.asarray(ja["fg"]))
    np.testing.assert_array_equal(ta["matched_gt"].numpy(),
                                  np.asarray(ja["matched_gt"]))
    np.testing.assert_array_equal(ta["num_gt"].numpy(),
                                  np.asarray(ja["num_gt"]))
    np.testing.assert_allclose(ta["pred_iou"].numpy(),
                               np.asarray(ja["pred_iou"]), rtol=1e-6)


@pytest.mark.parametrize("use_l1,iou_type", [(False, "iou"), (True, "iou"),
                                             (True, "giou")])
def test_yolox_losses_and_gradients_match_jax(use_l1, iou_type):
    dec, raw, labels = _heads(3)

    def jfn(d, r):
        out = JL.yolox_losses(d, jnp.asarray(labels), HW, origin_reg=r,
                              use_l1=use_l1, iou_type=iou_type)
        return out["total"], out
    (_, jout), (jgd, jgr) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(dec),
                                             jnp.asarray(raw))
    td = torch.from_numpy(dec).requires_grad_(True)
    tr = torch.from_numpy(raw).requires_grad_(True)
    tout = L.yolox_losses(td, torch.from_numpy(labels), HW, origin_reg=tr,
                          use_l1=use_l1, iou_type=iou_type)
    gd, gr = torch.autograd.grad(tout["total"], [td, tr],
                                 allow_unused=True)
    for k in ("total", "iou", "obj", "cls", "l1", "fg_ratio", "num_fg"):
        np.testing.assert_allclose(float(tout[k].detach()), float(jout[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-4,
                               atol=1e-6 * float(np.abs(jgd).max()))
    if use_l1:
        np.testing.assert_allclose(gr.numpy(), np.asarray(jgr), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(jgr).max()))


# ---------------------------------------------------------------------------
# The small YOLOX in train mode, from JAX's initial tree

LR, MOMENTUM, WD = 0.01, 0.9, 5e-4


@pytest.fixture(scope="module")
def yolox_step():
    from mvsmplfitting_tpu.detect.yolox import YOLOX as JYOLOX
    from mvsmplfitting_tpu_torch.detect.yolox import YOLOX

    rng = np.random.default_rng(4)
    jmodel = JYOLOX(num_classes=1, depth_mul=0.33, width_mul=0.125,
                    input_hw=HW, train_outputs=True)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *HW, 3)))
    _, _, labels = _heads(5, N=2, C=1, G=10)
    batch = {"image": rng.uniform(0, 255, (2, *HW, 3)).astype(np.float32),
             "labels": labels}
    sd0 = W.yolox_state_from_flax(variables)

    jout = jax.jit(jmodel.apply)(variables, jnp.asarray(batch["image"]))

    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(np.asarray(a, np.float64)), t)
        tx = JT.make_optimizer("sgd", LR, momentum=MOMENTUM,
                               weight_decay=WD)
        st = JT.init_train_state(cast(variables), tx)
        st, jloss, jaux = JT.make_yolox_train_step(jmodel, tx, HW)(
            st, cast(batch))
        jstate = jax.tree_util.tree_map(np.asarray, st)
        jaux = {k: float(v) for k, v in jaux.items()}

    def port(dtype):
        m = YOLOX(1, 0.33, 0.125, train_outputs=True)
        m.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd0.items()})
        return m.to(dtype)

    m32 = port(torch.float32).eval()
    with torch.no_grad():
        tout = m32(T.nchw(torch.from_numpy(batch["image"])))
    model = port(torch.float64)
    opt = T.Optimizer("sgd", LR, list(model.parameters()),
                           momentum=MOMENTUM, weight_decay=WD)
    state = T.init_train_state(model, opt)
    tloss, taux = T.make_yolox_train_step(HW)(state, {
        k: torch.from_numpy(v).double() for k, v in batch.items()})
    return dict(jout=jout, tout=tout, jstate=jstate, jloss=float(jloss),
                jaux=jaux, state=state, tloss=float(tloss), taux=taux)


def test_train_outputs_match_jax(yolox_step):
    """`train_outputs`: obj/cls logits, the decoded boxes and the raw reg
    (BatchNorm on its running statistics, float32; train mode is the
    float64 step's below)."""
    s = yolox_step
    (jd, jr), (td, tr) = s["jout"], s["tout"]
    assert td.shape == (2, A, 6) and tr.shape == (2, A, 4)
    assert float(td[..., 4:].min()) < 0      # logits, not probabilities
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4,
                               atol=1e-5)


def test_train_step_matches_jax(yolox_step):
    s = yolox_step
    np.testing.assert_allclose(s["tloss"], s["jloss"], rtol=1e-5)
    for k in ("iou", "obj", "cls", "l1", "num_fg"):
        np.testing.assert_allclose(float(s["taux"][k]), s["jaux"][k],
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    js = s["jstate"]
    new = W.yolox_state_from_flax({"params": js.params,
                                   "batch_stats": js.batch_stats})
    ema = W.yolox_state_from_flax(js.ema)
    n = 0
    for k, v in s["state"].model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1
            continue
        np.testing.assert_allclose(v.numpy(), new[k], rtol=1e-5,
                                   atol=1e-10, err_msg=k)
        np.testing.assert_allclose(s["state"].ema[k].numpy(), ema[k],
                                   rtol=1e-5, atol=1e-10, err_msg=k)
        n += 1
    assert n > 0
