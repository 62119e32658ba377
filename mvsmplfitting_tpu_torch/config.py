"""Typed configuration tree, YAML-loadable, CLI-overridable (port of
`config.py`).

`Config` has every field and default of the JAX package's, so a
`conf.yaml` dumped by either package lists the same keys, and
`load_config` gives the same `Config` for the same file and overrides.

The files are read without PyYAML, which the card's machine lacks: a
reader for the subset of YAML the configs use, and no more.  It takes
top-level `key: value` lines, `#` comments, plain, single- and
double-quoted scalars and one-line flow lists `[a, b]`, and resolves a
plain scalar as PyYAML's `safe_load` does (YAML 1.1): `null`/`~`/empty,
`true`/`false`, decimal ints, and floats with a dot (an exponent needs
its sign).  So `1e-9` and `4.04e2` stay strings, as they do in PyYAML,
and `_coerce` turns them into floats for the fields of `_FIELD_TYPES`.
A plain scalar that PyYAML would read as anything else (octal, hex,
`1_000`, `yes`/`no`/`on`/`off`, dates, `.inf`) and every other construct
(nesting, block lists, anchors, tags, multi-line values) raise
`YAMLSubsetError` naming the file and line.  `dump_config` writes the
same subset, in a form that PyYAML reads back to the same values.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class Config:
    # data
    data_folder: str = "data"
    img_folder: str = "images"
    keyp_folder: str = "keypoints"
    cam_param: str = "data/camparams.txt"
    dataset: str = "offline"
    # output
    output_folder: str = "output"
    result_folder: str = "results"
    mesh_folder: str = "meshes"
    save_meshes: bool = True
    save_images: bool = True
    interactive: bool = True
    visualize: bool = False
    # model
    model_folder: str = "models"
    model_type: str = "smpllsp"       # smpl | smpllsp | smplh | smplx
    gender: str = "neutral"
    float_dtype: str = "float32"
    allow_synthetic_model: bool = True  # fall back when no SMPL pkl exists
    lsp_regressor: Optional[str] = None  # path to J_regressor_lsp.npz
    # priors
    use_vposer: bool = True
    prior_folder: str = "priors"
    body_prior_type: str = "l2"       # l2 | gmm
    gmm_path: Optional[str] = None
    # annotation
    use_joints_conf: bool = True
    use_3d: bool = False
    use_hip: bool = True
    # stage weights
    data_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    body_pose_prior_weights: Tuple[float, ...] = (404.0, 404.0, 57.4, 4.78)
    shape_weights: Tuple[float, ...] = (100.0, 50.0, 10.0, 5.0)
    coll_loss_weights: Tuple[float, ...] = (0.0, 0.0, 1000.0, 4500.0)
    # optimization
    rho: float = 100.0
    optim_type: str = "lm"  # lm | lbfgsls (parity) | adam | rmsprop | sgd
    ftol: float = 1e-9
    gtol: float = 1e-9
    lr: float = 1.0
    maxiters: int = 30
    # fixed params
    fix_scale: bool = False
    scale: Optional[float] = None
    fix_shape: bool = False
    shape: Optional[Tuple[float, ...]] = None
    # modes
    is_seq: bool = False
    adjustment: bool = False
    interpenetration: bool = False
    # The reference voxelizes collisions at grid 128
    # (`code/utils/fitting.py:374`).
    coll_grid_size: int = 128
    # Kept so JAX's configs and dumps carry the same keys; it has no
    # effect here: on CUDA the voxelizer launches the two-phase kernels,
    # on the CPU it takes the plain version.
    use_pallas_sdf: Optional[bool] = None
    # Multi-person joint-refinement field: "points" (the exact field at
    # the query vertices) or "grid" (voxelize, then sample).
    sdf_engine: str = "points"
    # Multi-person: fit up to this many detected people per frame.
    num_people: int = 1
    # batching / parallelism
    batch_frames: int = 1             # frames fitted per batched call
    mesh_shape: Optional[Tuple[int, int]] = None  # (frames, cameras) axes

    def resolved(self, base: str = ".") -> "Config":
        """Resolve relative paths against `base`."""
        out = dataclasses.replace(self)
        for name in ("data_folder", "cam_param", "output_folder",
                     "model_folder", "prior_folder"):
            v = getattr(out, name)
            if v and not os.path.isabs(v):
                setattr(out, name, os.path.join(base, v))
        return out


def _coerce(value, target):
    """Coerce a YAML value to the dataclass field's declared type."""
    if value is None or target is None:
        return value
    origin = getattr(target, "__origin__", None)
    if origin in (tuple, list) or target in (tuple, list):
        return tuple(float(v) for v in value)
    if target is bool:
        return bool(value)
    if target is float:
        return float(value)
    if target is int:
        return int(value)
    return value


_FIELD_TYPES = {
    "data_weights": tuple, "body_pose_prior_weights": tuple,
    "shape_weights": tuple, "coll_loss_weights": tuple, "shape": tuple,
    "rho": float, "ftol": float, "gtol": float, "lr": float,
    "scale": float, "maxiters": int, "batch_frames": int,
}


# ---------------------------------------------------------------------------
# The YAML subset.

class YAMLSubsetError(ValueError):
    """A config file uses YAML outside the subset this reader takes."""


_KEY_LINE = re.compile(r"([A-Za-z_][A-Za-z0-9_]*):(?=\s|$)(.*)$")
_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {"true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
# Everything else PyYAML's implicit resolvers turn into a non-string
# (`yaml/resolver.py`): refused rather than read another way.
_PYYAML_OTHER = re.compile(
    r"(?:yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*|<<|=)$")
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n", "t": "\t"}


def _plain(text: str, fail):
    """Resolve a plain scalar as PyYAML's safe_load would."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.match(text):
        return float(text)
    if _INT.match(text):
        return int(text)
    if _PYYAML_OTHER.match(text):
        fail(f"the plain scalar {text!r} is outside the subset")
    if text[0] in "[]{},#&*!|>'\"%@`" or text[:2] in ("- ", "? ") \
            or ": " in text or text.endswith(":") or "\t" in text:
        fail(f"unsupported plain scalar {text!r}")
    return text


def _quoted(s: str, i: int, fail):
    """The quoted scalar starting at s[i]; returns (value, end index)."""
    q = s[i]
    out = []
    j = i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = s[j + 1:j + 2]
            if esc not in _ESCAPES:
                fail(f"unsupported escape \\{esc} in a double-quoted string")
            out.append(_ESCAPES[esc])
            j += 2
            continue
        out.append(c)
        j += 1
    fail("unterminated quoted string (multi-line values are outside the "
         "subset)")


def _scalar(s: str, i: int, flow: bool, fail):
    """One scalar from s[i:]; returns (value, end index).  A plain scalar
    ends at a comment, or in a flow list at ',' or ']'."""
    if s[i] in "'\"":
        return _quoted(s, i, fail)
    j = i
    while j < len(s):
        if s[j] == "#" and s[j - 1] in " \t":
            break
        if flow and s[j] in ",[]{}":
            break
        j += 1
    text = s[i:j].rstrip()
    if flow and not text:
        fail("empty item in a flow list")
    return _plain(text, fail), j


def _skip_space(s: str, i: int) -> int:
    while i < len(s) and s[i] in " \t":
        i += 1
    return i


def _value(s: str, fail):
    """The value of one `key: value` line."""
    i = _skip_space(s, 0)
    if i == len(s) or s[i] == "#":
        return None
    if s[i] == "[":
        items = []
        i = _skip_space(s, i + 1)
        if s[i:i + 1] == "]":
            i += 1
        else:
            while True:
                if i >= len(s):
                    fail("unterminated flow list (multi-line values are "
                         "outside the subset)")
                if s[i] in "[{":
                    fail("nested collections are outside the subset")
                v, i = _scalar(s, i, True, fail)
                items.append(v)
                i = _skip_space(s, i)
                if s[i:i + 1] == ",":
                    i = _skip_space(s, i + 1)
                    if s[i:i + 1] == "]":
                        fail("trailing comma in a flow list")
                    continue
                if s[i:i + 1] == "]":
                    i += 1
                    break
                fail("expected ',' or ']' in a flow list")
        v = items
    elif s[i] in "{|>&*!":
        fail(f"'{s[i]}' (flow mappings, block scalars, anchors, aliases "
             "and tags) is outside the subset")
    else:
        v, i = _scalar(s, i, False, fail)
    i = _skip_space(s, i)
    if i < len(s) and s[i] != "#":
        fail(f"unexpected text after the value: {s[i:]!r}")
    return v


def parse_yaml_subset(text: str, path: str = "<string>") -> dict:
    """The mapping of a config file's text (see the module docstring)."""
    out = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        def fail(msg, lineno=lineno):
            raise YAMLSubsetError(f"{path}:{lineno}: {msg}")
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if line[0] in " \t":
            fail("indented lines (nested or block collections) are outside "
                 "the subset")
        m = _KEY_LINE.match(line)
        if m is None:
            fail(f"expected 'key: value', got {line!r}")
        out[m.group(1)] = _value(m.group(2), fail)
    return out


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"cannot write {v!r} in the YAML subset")
        r = repr(v)
        if "e" in r:
            mant, exp = r.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            r = f"{mant}e{exp}"
        return r
    if isinstance(v, str):
        if any(ord(c) < 32 and c not in "\n\t" for c in v):
            raise ValueError(f"cannot write {v!r} in the YAML subset")
        return '"' + (v.replace("\\", "\\\\").replace('"', '\\"')
                      .replace("\n", "\\n").replace("\t", "\\t")) + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_scalar(x) for x in v) + "]"
    raise ValueError(f"cannot write {type(v).__name__} in the YAML subset")


def _dump_text(cfg: Config) -> str:
    return "".join(f"{k}: {_dump_scalar(v)}\n"
                   for k, v in dataclasses.asdict(cfg).items())


# ---------------------------------------------------------------------------

def load_config(path: Optional[str] = None, **overrides) -> Config:
    """Load a YAML config file, apply keyword overrides, return Config.

    Unknown YAML keys are ignored (so the reference's configs, which
    carry torch-era flags like `use_cuda`, load unchanged).
    """
    values = {}
    if path:
        with open(path) as f:
            raw = parse_yaml_subset(f.read(), path)
        values.update(raw)
    values.update({k: v for k, v in overrides.items() if v is not None})

    known = {f.name for f in dataclasses.fields(Config)}
    # Compatibility aliases from the reference's flag names.
    if "optim_type" in values and values["optim_type"] in (
            "lbfgs", "lbfgsls"):
        values["optim_type"] = "lbfgsls"
    clean = {}
    for k, v in values.items():
        if k not in known:
            continue
        clean[k] = _coerce(v, _FIELD_TYPES.get(k))
    cfg = Config(**clean)
    n = len(cfg.body_pose_prior_weights)
    if len(cfg.shape_weights) != n or len(cfg.coll_loss_weights) != n:
        raise ValueError("stage weight lists must have equal length")
    return cfg


def dump_config(cfg: Config, path: str) -> None:
    """Write the resolved config (like the reference's `output/conf.yaml`,
    `init.py:33-35`).  A file that already holds the same text is left
    as it is, so a resumed run writes nothing."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    text = _dump_text(cfg)
    if os.path.exists(path):
        with open(path) as f:
            if f.read() == text:
                return
    with open(path, "w") as f:
        f.write(text)
