"""Overlays, skeleton drawing and video export (port of `viz/`), drawn
with OpenCV's primitives in host C++ (`viz/draw.py`)."""
