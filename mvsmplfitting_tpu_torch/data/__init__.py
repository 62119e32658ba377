"""Data layer of the port: dataset walking, keypoint and camera files,
result writers (host numpy, as in the JAX package)."""
