"""The keypoint front end (port of `detect/`): YOLOX person detection
and heatmap pose nets as NCHW PyTorch modules named as the reference's
torch modules, their pre- and post-processing on the device, and the
pipelines that turn camera images or a video into OpenPose keypoint
JSONs (`predictor.py`, `stream.py`).

The zoo (`zoo.py`): FastPose (with deformable stages,
`deform_conv.py`), SimplePose, the DUC nets, PoseHRNet (`hrnet.py`) and
HarDNet-68 (`hardnet.py`); AlphaPose config files map onto it through
`config.py`; HybrIK's SMPL regressor is `hybrik.py` with
`predictor.SmplPoseEstimator`.  No CLI reaches the rest: the YOLOv3
neck (`yolo_fpn.py`), RoIAlign (`roi_align.py`), deformable RoI pooling
(`deform_pool.py`), and the COCO masks, metrics and file IO of
evaluation (`masks.py`, `metrics.py`, `coco_io.py`).  Modules are
imported by their own names (nothing is re-exported here, so importing
one net builds no other).
"""
