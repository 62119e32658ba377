"""AlphaPose model-config YAML files (port of `detect/config.py`).

The reference builds its pose nets from the YAML files of its
`configs/**/*.yaml` tree (`alphapose/utils/config.py:1-8`, read by
`alphapose_core.py:56-65`): ``MODEL`` picks the net, ``DATA_PRESET``
fixes the crop and heatmap geometry.  This module takes those files as
they are and maps them onto the port's zoo (`detect/zoo.py`) and
`PoseEstimator`.

The card's machine has no PyYAML, so the files are read by
`parse_block_yaml`, a reader for the block YAML those files use: nested
block mappings, block sequences and flow sequences of scalars, plain,
single- and double-quoted scalars and comments.  Scalars resolve as
PyYAML's `safe_load` resolves them (the scalar code of
`config.parse_yaml_subset`).  Anchors, aliases, tags, several documents,
block scalars, flow mappings and the YAML 1.1 booleans `yes`/`no`/`on`/
`off` raise `YAMLSubsetError` naming the file and line.

Keys read (the reference's ``cfg[...]`` reads): ``MODEL.TYPE``,
``NUM_LAYERS``, ``CONV_DIM``, ``DCN`` (``MODULATED``, ``DEFORM_GROUP``,
``FALLBACK_ON_STRIDE``), ``STAGE_WITH_DCN``, ``BACKBONE``,
``STAGE{1,2,3}.NUM_CONV`` (DUC), ``STAGE{2,3,4}`` (HRNet),
``FINAL_CONV_KERNEL``; ``DATA_PRESET.NUM_JOINTS``, ``NUM_JOINTS_DENSE``,
``IMAGE_SIZE``; ``DATASET.TRAIN.TYPE`` for the flip pairs.  ``LOSS.TYPE``
is not read, as in JAX.  A config naming a net the zoo does not build
raises `UnsupportedPoseConfig` naming the key, where JAX would build a
different net in three cases: a DUC head with ``CONV_DIM`` other than
256 (the reference fixes it), a ``DCN`` block whose ``DEFORM_GROUP`` or
``FALLBACK_ON_STRIDE`` it ignores, and a dataset whose flip pairs it
cannot find (JAX keeps the COCO-17 pairs silently).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

from ..config import YAMLSubsetError, _value

__all__ = [
    "UnsupportedPoseConfig", "parse_block_yaml", "load_pose_config",
    "model_spec_from_config", "pose_model_from_config",
    "estimator_kwargs_from_config", "build_pose_estimator",
]


class UnsupportedPoseConfig(ValueError):
    """A reference config names a net variant the zoo does not build."""


# ---- the block YAML reader ---------------------------------------------------

_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_.\-]*|'[^']*'|\"[^\"]*\"):(?=\s|$)"
                  r"(.*)$")


def _lines(text: str, path: str):
    """(line number, indent, content) of every line that holds more than
    a comment."""
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YAMLSubsetError(f"{path}:{n}: tabs in indentation")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise YAMLSubsetError(f"{path}:{n}: document markers and "
                                  "directives (several documents) are "
                                  "outside the subset")
        out.append((n, len(raw) - len(raw.lstrip()), raw.strip()))
    return out


def _scalar_item(text: str, fail):
    """A block-sequence item or a mapping value on the same line: a
    scalar or a flow sequence of scalars (`config._value`)."""
    if text.startswith("- ") or text == "-":
        fail("nested block sequences are outside the subset")
    return _value(text, fail)


def parse_block_yaml(text: str, path: str = "<string>") -> Dict[str, Any]:
    """The mapping of an AlphaPose config's text (see the module
    docstring); raises `YAMLSubsetError` naming `path` and the line."""
    lines = _lines(text, path)
    pos = 0

    def fail_at(n):
        def fail(msg):
            raise YAMLSubsetError(f"{path}:{n}: {msg}")
        return fail

    def mapping(indent: int) -> Dict[str, Any]:
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(lines):
            n, ind, body = lines[pos]
            fail = fail_at(n)
            if ind < indent:
                break
            if ind > indent:
                fail("unexpected indentation")
            if body.startswith("- ") or body == "-":
                fail("a sequence item where a mapping key was expected")
            m = _KEY.match(body)
            if m is None:
                fail(f"expected 'key: value', got {body!r}")
            key = m.group(1)
            if key[0] in "'\"":
                key = key[1:-1]
            if key in out:
                fail(f"duplicate key {key!r}")
            rest = m.group(2).strip()
            pos += 1
            if rest and not rest.startswith("#"):
                if rest[0] in "&*!|>{":
                    fail(f"'{rest[0]}' (anchors, aliases, tags, block "
                         "scalars and flow mappings) is outside the subset")
                out[key] = _scalar_item(rest, fail)
                continue
            # A nested block: a mapping or a sequence on the next lines.
            if pos < len(lines):
                _, nind, nbody = lines[pos]
                is_seq = nbody.startswith("- ") or nbody == "-"
                if is_seq and nind >= indent:
                    out[key] = sequence(nind)
                    continue
                if nind > indent:
                    out[key] = mapping(nind)
                    continue
            out[key] = None
        return out

    def sequence(indent: int) -> List[Any]:
        nonlocal pos
        items = []
        while pos < len(lines):
            n, ind, body = lines[pos]
            fail = fail_at(n)
            if ind != indent or not (body.startswith("- ") or body == "-"):
                if ind > indent:
                    fail("unexpected indentation in a block sequence")
                break
            item = body[1:].strip()
            if not item or item.startswith("#"):
                fail("empty or nested items of a block sequence are "
                     "outside the subset")
            if item[0] in "&*!|>{":
                fail(f"'{item[0]}' (anchors, aliases, tags, block scalars "
                     "and flow mappings) is outside the subset")
            if _KEY.match(item):
                fail("mappings inside a block sequence are outside the "
                     "subset")
            items.append(_scalar_item(item, fail))
            pos += 1
        return items

    if not lines:
        return {}
    if lines[0][1] != 0:
        fail_at(lines[0][0])("the document must start at column 0")
    out = mapping(0)
    if pos < len(lines):
        fail_at(lines[pos][0])("unexpected text after the document")
    return out


# ---- the reference's configs -> the zoo ----------------------------------------

def load_pose_config(path_or_dict) -> Dict[str, Any]:
    """A reference YAML file (or an already-read dict) -> its mapping."""
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict) as f:
        cfg = parse_block_yaml(f.read(), str(path_or_dict))
    if not isinstance(cfg, dict) or "MODEL" not in cfg:
        raise ValueError(f"{path_or_dict}: not an AlphaPose model config "
                         "(no MODEL section)")
    return cfg


def _dcn_kwargs(model: Dict[str, Any]) -> Dict[str, Any]:
    """`stage_with_dcn` / `dcn_modulated` as JAX's `_dcn_kwargs`, and the
    keys JAX ignores: `DEFORM_GROUP` builds `deformable_groups` (given
    only when it is not 1, so the spec of a reference config equals
    JAX's), `FALLBACK_ON_STRIDE` true is refused (the reference's
    Bottleneck would build a plain conv2 and then call its offsets)."""
    if "DCN" not in model:
        return {}
    dcn = model["DCN"] or {}
    known = {"MODULATED", "DEFORM_GROUP", "FALLBACK_ON_STRIDE"}
    for key in dcn:
        if key not in known:
            raise UnsupportedPoseConfig(
                f"MODEL.DCN.{key}: not a key the reference's DCN reads")
    if dcn.get("FALLBACK_ON_STRIDE", False):
        raise UnsupportedPoseConfig(
            "MODEL.DCN.FALLBACK_ON_STRIDE: true is not supported (the "
            "reference's Bottleneck then builds no offset conv)")
    if "STAGE_WITH_DCN" not in model:
        raise UnsupportedPoseConfig("MODEL.DCN without MODEL.STAGE_WITH_DCN")
    kw = {"stage_with_dcn": tuple(bool(b) for b in model["STAGE_WITH_DCN"]),
          "dcn_modulated": bool(dcn.get("MODULATED", False))}
    groups = int(dcn.get("DEFORM_GROUP", 1))
    if groups != 1:
        kw["deformable_groups"] = groups
    return kw


def _require_layers(model: Dict[str, Any], supported: Tuple[int, ...],
                    what: str) -> int:
    n = int(model.get("NUM_LAYERS", supported[0]))
    if n not in supported:
        raise UnsupportedPoseConfig(
            f"{what}: NUM_LAYERS={n} backbone not in the zoo "
            f"(supported: {supported})")
    return n


def _hrnet_width(model: Dict[str, Any]) -> int:
    """HRNet's width from STAGE2; the stages' other keys must be the
    ones `PoseHRNet` builds (module counts 1/4/3, 4 BASIC blocks a
    branch, SUM fuse, channels doubling)."""
    width = int(model["STAGE2"]["NUM_CHANNELS"][0])
    for s, (modules, branches) in zip((2, 3, 4), ((1, 2), (4, 3), (3, 4))):
        st = model.get(f"STAGE{s}")
        if st is None:
            continue
        want = {"NUM_MODULES": modules, "NUM_BRANCHES": branches,
                "NUM_BLOCKS": [4] * branches,
                "NUM_CHANNELS": [width * 2 ** b for b in range(branches)],
                "BLOCK": "BASIC", "FUSE_METHOD": "SUM"}
        for key, v in want.items():
            if key in st and st[key] != v:
                raise UnsupportedPoseConfig(
                    f"MODEL.STAGE{s}.{key}={st[key]!r}: the zoo's HRNet "
                    f"builds {v!r}")
    return width


def model_spec_from_config(cfg) -> Tuple[str, Dict[str, Any]]:
    """Config -> (zoo name, keyword arguments) for `build_pose_model`."""
    cfg = load_pose_config(cfg)
    model = cfg["MODEL"]
    preset = cfg.get("DATA_PRESET") or {}
    num_joints = int(preset.get("NUM_JOINTS", 17))
    mtype = str(model.get("TYPE", "FastPose"))
    key = mtype.lower()

    if key == "fastpose":
        _require_layers(model, (50,), mtype)
        kw: Dict[str, Any] = {"num_joints": num_joints,
                              "conv_dim": int(model.get("CONV_DIM", 128))}
        kw.update(_dcn_kwargs(model))
        return "fastpose", kw

    if key in ("fastpose_duc", "fastpose_duc_dense"):
        _require_layers(model, (50,), mtype)
        if "DCN" in model:
            raise UnsupportedPoseConfig(
                f"{mtype}: the zoo's DUC backbones do not carry DCN "
                "stages (use MODEL.TYPE FastPose for DCN configs)")
        if int(model.get("CONV_DIM", 256)) != 256:
            raise UnsupportedPoseConfig(
                f"MODEL.CONV_DIM={model['CONV_DIM']}: the reference's "
                f"{mtype} fixes its head at 256 channels")
        backbone = str(model.get("BACKBONE", "resnet"))
        kw = {
            "num_joints": num_joints,
            "num_convs": tuple(int(model[f"STAGE{i}"]["NUM_CONV"])
                               for i in (1, 2, 3)),
            "conv_dim": 256,
            "se": backbone == "se-resnet",
            "shuffle": backbone == "shuffle",
        }
        if key == "fastpose_duc_dense":
            kw["num_joints_dense"] = int(preset.get("NUM_JOINTS_DENSE", 136))
        return key, kw

    if key == "simplepose":
        _require_layers(model, (50,), mtype)
        return "simplepose", {"num_joints": num_joints}

    if key == "posehighresolutionnet":
        return "hrnet", {"num_joints": num_joints,
                         "width": _hrnet_width(model)}

    if key == "hardnetpose":
        _require_layers(model, (68,), mtype)
        return "hardnet", {
            "num_joints": num_joints,
            "final_kernel": int(model.get("FINAL_CONV_KERNEL", 1))}

    raise UnsupportedPoseConfig(f"MODEL.TYPE {mtype!r} not in the zoo")


def pose_model_from_config(cfg):
    """Config (path or dict) -> the zoo's `nn.Module`."""
    from .zoo import build_pose_model
    name, kw = model_spec_from_config(cfg)
    return build_pose_model(name, **kw)


# DATASET.TRAIN.TYPE -> skeleton-registry format (viz/skeletons.py), for
# the flip pairs of the flip test.
_DATASET_FORMATS = {
    "halpe_26": "halpe26", "halpe_26_det": "halpe26",
    "halpe_136": "halpe136", "halpe_136_det": "halpe136",
    "halpe_coco_wholebody_136": "halpe136",
    "halpe_68_noface": "halpe68", "halpe_68_noface_det": "halpe68",
    "coco_wholebody": "coco_wholebody133",
    "coco_wholebody_det": "coco_wholebody133",
    "mscoco": "coco17", "mscoco_det": "coco17",
}


def estimator_kwargs_from_config(cfg) -> Dict[str, Any]:
    """Config -> `PoseEstimator` keyword arguments: the net, the joint
    count, the crop size (IMAGE_SIZE is (H, W), as the reference's
    `_input_size`, `alphapose_core.py:40-44`) and the flip pairs of the
    dataset's format; a format whose pairs do not fit the net raises."""
    cfg = load_pose_config(cfg)
    preset = cfg.get("DATA_PRESET") or {}
    num_joints = int(preset.get("NUM_JOINTS", 17))
    kw: Dict[str, Any] = {
        "model": pose_model_from_config(cfg),
        "num_joints": num_joints,
        "input_hw": tuple(int(v) for v in preset.get("IMAGE_SIZE",
                                                     (256, 192))),
    }
    dtype = str(((cfg.get("DATASET") or {}).get("TRAIN") or {})
                .get("TYPE", "")).lower()
    fmt = _DATASET_FORMATS.get(dtype)
    if fmt is not None:
        from .preprocess import flip_pairs_for
        try:
            kw["joint_pairs"] = flip_pairs_for(num_joints, fmt)
        except (KeyError, ValueError) as e:
            raise UnsupportedPoseConfig(
                f"DATASET.TRAIN.TYPE {dtype!r}: no flip pairs of format "
                f"{fmt!r} for {num_joints} joints ({e})") from e
    return kw


def build_pose_estimator(cfg, state_dict=None, **overrides):
    """Reference YAML (or its dict) -> a `PoseEstimator`; `overrides` go
    to the estimator (flip_test, bf16, device, ...)."""
    from .predictor import PoseEstimator
    kw = estimator_kwargs_from_config(cfg)
    kw.update(overrides)
    return PoseEstimator(state_dict, **kw)
