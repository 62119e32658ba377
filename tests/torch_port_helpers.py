"""Shared helpers of the PyTorch port's tests (`test_torch_*.py`).

Inputs are made by numpy from a seed and handed to both packages; the
JAX package's dataclasses are carried to the port through
`mvsmplfitting_tpu_torch.convert` as dicts of numpy arrays.
"""

import dataclasses
import functools
import os

import numpy as np

VPOSER_NPZ = os.path.join(os.path.dirname(__file__), "..", "assets",
                          "vposer_weights.npz")


def arrays(obj, skip=("joint_model",)):
    """The array fields of a JAX dataclass as a dict of numpy arrays."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in skip or isinstance(v, (str, tuple, bool, int, float)):
            continue
        out[f.name] = None if v is None else np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def port_assets(model_type="smpl"):
    """The port's synthetic assets with their reduced joint model (CPU)."""
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.joint_model import with_joint_model
    return with_joint_model(synthetic_smpl(model_type, device="cpu"))


def jax_joint_model(port_jm):
    """A JAX `JointModel` holding the port's constants, so kernel tests
    compare the two packages on identical inputs without the slow float32
    einsum build."""
    import jax.numpy as jnp

    from mvsmplfitting_tpu.models.joint_model import JointModel
    g = {f: jnp.asarray(getattr(port_jm, f).numpy())
         for f in ("H0", "Hb", "Hp", "j0", "JB", "fold", "chain_mask")}
    return JointModel(chain_idx=jnp.asarray(port_jm.chain_idx.numpy(),
                                            jnp.int32),
                      parents=port_jm.parents,
                      model_type=port_jm.model_type, **g)


@functools.lru_cache(maxsize=None)
def jax_assets(model_type="smpl"):
    """JAX synthetic assets carrying the port-built joint model."""
    from mvsmplfitting_tpu.models.assets import synthetic_smpl
    assets = synthetic_smpl(model_type)
    return assets.replace(
        joint_model=jax_joint_model(port_assets(model_type).joint_model))


@functools.lru_cache(maxsize=None)
def vposer_pair():
    """(JAX weights, port weights) from the bundled npz."""
    from mvsmplfitting_tpu.models import vposer as jv
    from mvsmplfitting_tpu_torch.models import vposer as tv
    return jv.load_npz(VPOSER_NPZ), tv.load_npz(VPOSER_NPZ, device="cpu")


def rand_joint_inputs(rng, B, J=24, NB=10):
    """theta ~ N(0, 0.4), betas ~ N(0, 1), scale ~ U(0.7, 1.5)."""
    theta = rng.normal(0, 0.4, (B, J * 3)).astype(np.float32)
    betas = rng.normal(0, 1.0, (B, NB)).astype(np.float32)
    scale = rng.uniform(0.7, 1.5, (B,)).astype(np.float32)
    return theta, betas, scale
