"""The port's AlphaPose config reader (`mvsmplfitting_tpu_torch.detect.
config`) against PyYAML and the JAX package's bridge (`mvsmplfitting_tpu.
detect.config`).

The reference's `configs/` tree is not in this checkout, so the config
texts below are written in its layout (the demo FastPose, the `-dcn-`
FastPose, HRNet-W32, HarDNet-68, SimplePose and the DUC nets).  Each is
read by the port's block-YAML reader and by `yaml.safe_load` (equal
mappings), and mapped to a zoo spec by both packages (equal specs).  The
three places where the port refuses what JAX builds are recorded.
"""

import textwrap

import pytest
import torch
import yaml

from mvsmplfitting_tpu.detect import config as JCfg
from mvsmplfitting_tpu_torch.config import YAMLSubsetError
from mvsmplfitting_tpu_torch.detect import config as TCfg

HEAD = """\
DATASET:
  TRAIN:
    TYPE: '{dataset}'
    ROOT: './data/{root}/'
    IMG_PREFIX: 'images/train2015'
    ANN: 'annotations/train.json'
    AUG:
      FLIP: true
      ROT_FACTOR: 40
      SCALE_FACTOR: 0.3
      NUM_JOINTS_HALF_BODY: 11
      PROB_HALF_BODY: -1
  VAL:
    TYPE: '{dataset}'
    ROOT: "./data/{root}/"   # double quotes, a comment
    ANN: annotations/val.json
  TEST:
    TYPE: '{dataset}_det'
    DET_FILE: './exp/json/test_det_yolo.json'
DATA_PRESET:
  TYPE: 'simple'
  SIGMA: 2
  NUM_JOINTS: {joints}
  IMAGE_SIZE:
  - 256
  - 192
  HEATMAP_SIZE:
  - 64
  - 48
"""

TAIL = """\
LOSS:
  TYPE: 'MSELoss'
DETECTOR:
  NAME: 'yolo'
  CONFIG: 'detector/yolo/cfg/yolov3-spp.cfg'
  NMS_THRES: 0.6
  CONFIDENCE: 0.05
TRAIN:
  WORLD_SIZE: 4
  BATCH_SIZE: 32
  BEGIN_EPOCH: 0
  END_EPOCH: 270
  OPTIMIZER: 'adam'
  LR: 0.001
  LR_FACTOR: 0.1
  LR_STEP:
  - 170
  - 200
  DPG_MILESTONE: 210
  DPG_STEP: [230, 250]
  PRETRAINED: ~
  RESUME: null
"""

MODELS = {
    "fastpose": """\
MODEL:
  TYPE: 'FastPose'
  PRETRAINED: ''
  TRY_LOAD: ''
  NUM_DECONV_FILTERS:
  - 256
  - 256
  - 256
  NUM_LAYERS: 50
""",
    "fastpose_dcn": """\
MODEL:
  TYPE: 'FastPose'
  PRETRAINED: ''
  TRY_LOAD: ''
  NUM_DECONV_FILTERS:
    - 256
    - 256
    - 256
  NUM_LAYERS: 50
  CONV_DIM: 256
  DCN:
    MODULATED: false
    DEFORM_GROUP: 1
    FALLBACK_ON_STRIDE: false
  STAGE_WITH_DCN:
  - false
  - true
  - true
  - true
""",
    "hrnet": """\
MODEL:
  TYPE: 'PoseHighResolutionNet'
  PRETRAINED: ''
  TRY_LOAD: ''
  NUM_LAYERS: 32
  FINAL_CONV_KERNEL: 1
  STAGE2:
    NUM_MODULES: 1
    NUM_BRANCHES: 2
    NUM_BLOCKS: [4, 4]
    NUM_CHANNELS: [32, 64]
    BLOCK: 'BASIC'
    FUSE_METHOD: 'SUM'
  STAGE3:
    NUM_MODULES: 4
    NUM_BRANCHES: 3
    NUM_BLOCKS: [4, 4, 4]
    NUM_CHANNELS: [32, 64, 128]
    BLOCK: BASIC
    FUSE_METHOD: SUM
  STAGE4:
    NUM_MODULES: 3
    NUM_BRANCHES: 4
    NUM_BLOCKS:
    - 4
    - 4
    - 4
    - 4
    NUM_CHANNELS:
    - 32
    - 64
    - 128
    - 256
    BLOCK: 'BASIC'
    FUSE_METHOD: 'SUM'
""",
    "hardnet": """\
MODEL:
  TYPE: 'HarDNetPose'
  PRETRAINED: ''
  TRY_LOAD: ''
  NUM_LAYERS: 68
  FINAL_CONV_KERNEL: 1
  INIT_WEIGHTS: true
  TARGET_TYPE: gaussian
""",
    "simplepose": """\
MODEL:
  TYPE: 'SimplePose'
  PRETRAINED: ''
  NUM_DECONV_FILTERS: [256, 256, 256]
  NUM_LAYERS: 50
""",
    "fastpose_duc": """\
MODEL:
  TYPE: 'FastPose_DUC'
  BACKBONE: 'se-resnet'
  PRETRAINED: ''
  TRY_LOAD: ''
  NUM_LAYERS: 50
  FINAL_CONV_KERNEL: 1
  STAGE1:
    NUM_CONV: 4
  STAGE2:
    NUM_CONV: 2
  STAGE3:
    NUM_CONV: 1
""",
    "fastpose_duc_dense": """\
MODEL:
  TYPE: 'FastPose_DUC_Dense'
  BACKBONE: 'shuffle'
  PRETRAINED: ''
  NUM_LAYERS: 50
  STAGE1:
    NUM_CONV: 4
  STAGE2:
    NUM_CONV: 2
  STAGE3:
    NUM_CONV: 1
""",
}

DATASETS = {   # (DATASET type, root, joints)
    "fastpose": ("Halpe_26", "halpe", 26),
    "fastpose_dcn": ("Halpe_26", "halpe", 26),
    "hrnet": ("Mscoco", "coco", 17),
    "hardnet": ("Mscoco", "coco", 17),
    "simplepose": ("Mscoco", "coco", 17),
    "fastpose_duc": ("Mscoco", "coco", 17),
    "fastpose_duc_dense": ("Halpe_136", "halpe", 136),
}

WANT_SPEC = {
    "fastpose": ("fastpose", {"num_joints": 26, "conv_dim": 128}),
    "fastpose_dcn": ("fastpose", {
        "num_joints": 26, "conv_dim": 256,
        "stage_with_dcn": (False, True, True, True),
        "dcn_modulated": False}),
    "hrnet": ("hrnet", {"num_joints": 17, "width": 32}),
    "hardnet": ("hardnet", {"num_joints": 17, "final_kernel": 1}),
    "simplepose": ("simplepose", {"num_joints": 17}),
    "fastpose_duc": ("fastpose_duc", {
        "num_joints": 17, "num_convs": (4, 2, 1), "conv_dim": 256,
        "se": True, "shuffle": False}),
    "fastpose_duc_dense": ("fastpose_duc_dense", {
        "num_joints": 136, "num_convs": (4, 2, 1), "conv_dim": 256,
        "se": False, "shuffle": True, "num_joints_dense": 136}),
}


def config_text(name, model=None):
    dataset, root, joints = DATASETS[name]
    return (HEAD.format(dataset=dataset, root=root, joints=joints)
            + (model or MODELS[name]) + TAIL)


def write(tmp_path, name, text):
    p = tmp_path / f"{name}.yaml"
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reader_equals_pyyaml_and_spec_equals_jax(tmp_path, name):
    text = config_text(name)
    assert TCfg.parse_block_yaml(text) == yaml.safe_load(text)
    path = write(tmp_path, name, text)
    got = TCfg.model_spec_from_config(path)
    assert got == JCfg.model_spec_from_config(path) == WANT_SPEC[name]


def test_reader_scalars_as_pyyaml():
    text = textwrap.dedent("""\
        A:
          ints: [0, -3, +7]
          floats: [1.5, -0.25, .5, 2.0e+3]
          strings: [1e-3, 4.04e2, abc, 'x: y', "a#b"]
          empty:
          nulls: [~, null, Null]
          bools: [true, False, TRUE]
          quoted: 'it''s'
          key-with.dots: 3   # trailing comment
        B: [x, 'y z']
        C:
        - 'a'
        - 2
        """)
    assert TCfg.parse_block_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text,what", [
    ("A: &x 1\nB: *x\n", "anchors"),
    ("A: !!str 1\n", "tags"),
    ("A: 1\n---\nB: 2\n", "documents"),
    ("A: |\n  text\n", "block scalars"),
    ("A: >\n  text\n", "block scalars"),
    ("A: yes\n", "outside the subset"),
    ("A: on\n", "outside the subset"),
    ("A: {b: 1}\n", "flow mappings"),
    ("A:\n- - 1\n", "nested block sequences"),
    ("A:\n- b: 1\n", "mappings inside a block sequence"),
    ("A:\n\tB: 1\n", "tabs"),
    ("A: 1\nA: 2\n", "duplicate key"),
    ("A:\n  B: 1\n   C: 2\n", "indentation"),
    ("A: 0x1f\n", "outside the subset"),
])
def test_reader_refuses_outside_subset(tmp_path, text, what):
    with pytest.raises(YAMLSubsetError, match=what) as e:
        TCfg.parse_block_yaml(text, "cfg.yaml")
    assert str(e.value).startswith("cfg.yaml:")


def test_estimator_kwargs_as_jax(tmp_path):
    for name in ("fastpose", "hardnet"):
        path = write(tmp_path, name, config_text(name))
        got = TCfg.estimator_kwargs_from_config(path)
        want = JCfg.estimator_kwargs_from_config(path)
        assert got["num_joints"] == want["num_joints"]
        assert got["input_hw"] == want["input_hw"] == (256, 192)
        assert tuple(map(tuple, got["joint_pairs"])) == tuple(
            map(tuple, want["joint_pairs"]))
        assert isinstance(got["model"], torch.nn.Module)
    with pytest.raises(ValueError, match="no MODEL section"):
        TCfg.load_pose_config(write(tmp_path, "x", "DATASET:\n  A: 1\n"))


def test_duc_conv_dim_refused_where_jax_builds_it(tmp_path):
    """The reference's FastPose_DUC fixes its head at 256 channels; JAX
    passes MODEL.CONV_DIM on and builds a 128-channel head."""
    model = MODELS["fastpose_duc"] + "  CONV_DIM: 128\n"
    path = write(tmp_path, "duc", config_text("fastpose_duc", model))
    assert JCfg.model_spec_from_config(path)[1]["conv_dim"] == 128
    with pytest.raises(TCfg.UnsupportedPoseConfig, match="CONV_DIM=128"):
        TCfg.model_spec_from_config(path)


def test_flip_pair_failure_refused_where_jax_swallows_it(tmp_path):
    """A 26-joint head trained on Halpe-136: no flip pairs fit it.  JAX
    keeps the COCO-17 default pairs silently; the port refuses."""
    text = config_text("fastpose").replace("TYPE: 'Halpe_26'",
                                           "TYPE: 'Halpe_136'", 1)
    path = write(tmp_path, "flip", text)
    assert "joint_pairs" not in JCfg.estimator_kwargs_from_config(path)
    with pytest.raises(TCfg.UnsupportedPoseConfig, match="flip pairs"):
        TCfg.estimator_kwargs_from_config(path)


def test_dcn_keys_built_or_refused(tmp_path):
    """JAX reads MODULATED only; the port builds DEFORM_GROUP and refuses
    FALLBACK_ON_STRIDE true and unknown DCN keys, naming them."""
    base = MODELS["fastpose_dcn"]
    path = write(tmp_path, "dg", config_text(
        "fastpose_dcn", base.replace("DEFORM_GROUP: 1", "DEFORM_GROUP: 2")))
    assert "deformable_groups" not in JCfg.model_spec_from_config(path)[1]
    name, kw = TCfg.model_spec_from_config(path)
    assert kw["deformable_groups"] == 2
    net = TCfg.pose_model_from_config(path)
    assert net.preact.layer2[0].conv2_offset.out_channels == 2 * 18
    for old, new, key in (
            ("FALLBACK_ON_STRIDE: false", "FALLBACK_ON_STRIDE: true",
             "FALLBACK_ON_STRIDE"),
            ("DEFORM_GROUP: 1", "DEFORM_GROUP: 1\n    STRIDE: 2",
             "DCN.STRIDE")):
        path = write(tmp_path, "bad", config_text(
            "fastpose_dcn", base.replace(old, new)))
        with pytest.raises(TCfg.UnsupportedPoseConfig, match=key):
            TCfg.model_spec_from_config(path)


def test_hrnet_stages_other_than_the_zoo_refused(tmp_path):
    model = MODELS["hrnet"].replace("NUM_MODULES: 4", "NUM_MODULES: 2")
    path = write(tmp_path, "hr", config_text("hrnet", model))
    with pytest.raises(TCfg.UnsupportedPoseConfig, match="NUM_MODULES"):
        TCfg.model_spec_from_config(path)
    for bad in ("TYPE: 'HarDNetPose'\n  NUM_LAYERS: 85",
                "TYPE: 'Nope'"):
        model = "MODEL:\n  " + bad + "\n"
        path = write(tmp_path, "u", config_text("hardnet", model))
        with pytest.raises(TCfg.UnsupportedPoseConfig):
            TCfg.model_spec_from_config(path)


def test_cli_reads_the_config_once(tmp_path, monkeypatch):
    """JAX's CLI parses `--pose_cfg` twice (`cli/keypoints.py:111-115`);
    the port's once, before it builds a net."""
    from mvsmplfitting_tpu_torch.cli import keypoints
    from mvsmplfitting_tpu_torch.detect import predictor as TP
    calls = []
    real = TCfg.parse_block_yaml

    def counting(*a, **k):
        calls.append(a)
        return real(*a, **k)

    class Built(Exception):
        pass

    def detector(*a, **k):
        raise Built

    monkeypatch.setattr(TCfg, "parse_block_yaml", counting)
    monkeypatch.setattr(TP, "PersonDetector", detector)
    path = write(tmp_path, "hr", config_text("hardnet"))
    (tmp_path / "images").mkdir()
    with pytest.raises(Built):
        keypoints.main(["--data_folder", str(tmp_path), "--pose_cfg", path,
                        "--device", "cpu"])
    assert len(calls) == 1
