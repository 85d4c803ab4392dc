"""Preprocessing (README steps 1-3): COLMAP calibration drivers, chunking,
mono-depth calibration, masks and match lists. The port's own copy of
``h3dgs_tpu/preprocess``; its image work runs on the device through
``imgproc`` in place of OpenCV."""
