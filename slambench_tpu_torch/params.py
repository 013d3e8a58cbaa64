"""Compile-time algorithmic constants of the KinectFusion pipeline.

A copy of ``slambench_tpu/params.py``: the reference's constant parameter block
(reference: kfusion/include/constant_parameters.h:15-26). These values are
part of the numerical contract — changing them changes the trajectory and
therefore the ATE — so they are kept verbatim.
"""

from __future__ import annotations

# Bilateral-filter range sigma (reference: constant_parameters.h:15).
E_DELTA = 0.1
# Bilateral-filter window radius (reference: constant_parameters.h:16).
RADIUS = 2
# ICP projective-data-association distance gate in metres
# (reference: constant_parameters.h:17).
DIST_THRESHOLD = 0.1
# ICP normal-compatibility gate, cosine (reference: constant_parameters.h:18).
NORMAL_THRESHOLD = 0.8
# Minimum fraction of tracked pixels for a pose to be accepted
# (reference: constant_parameters.h:19).
TRACK_THRESHOLD = 0.15
# TSDF running-average weight cap (reference: constant_parameters.h:20).
MAX_WEIGHT = 100.0
# Raycast near/far clipping planes in metres
# (reference: constant_parameters.h:21-22).
NEAR_PLANE = 0.4
FAR_PLANE = 4.0
# Bilateral-filter spatial gaussian sigma (reference: constant_parameters.h:23).
DELTA = 4.0

# Diffuse shading constants for volume rendering
# (reference: constant_parameters.h:25-26).
LIGHT = (1.0, 1.0, -1.0)
AMBIENT = (0.1, 0.1, 0.1)

# Marker value for invalid normals / untracked pixels
# (reference: commons.h:14 `#define KFUSION_INVALID -2`).
INVALID = -2.0

# TSDF fixed-point scale: stored int16 = value * 32766, read back with
# 1/32766 ≈ 0.00003051944088 (reference: commons.h:162,178-179).
TSDF_SCALE = 32766.0
TSDF_INV_SCALE = 0.00003051944088

# Pose-rejection RMS residual bound in metres (reference: cpp/kernels.cpp:784).
RMS_RESIDUAL_BOUND = 2e-2
