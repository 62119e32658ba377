"""The keypoint front end (port of `detect/`): YOLOX person detection
and heatmap pose nets as NCHW PyTorch modules named as the reference's
torch modules, their pre- and post-processing on the device, and the
pipeline that turns camera images into OpenPose keypoint JSONs.
Modules are imported by their own names (nothing is re-exported here).
"""
