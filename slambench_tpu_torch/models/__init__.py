"""The keyframe layer above the KinectFusion frame step (port of
``slambench_tpu/models``): a keyframe pose graph optimized by
Gauss-Newton, sparse Schur-complement bundle adjustment, and the
``PoseGraphKFusion`` wrapper with loop-closure ICP on K2F."""

from slambench_tpu_torch.models.posegraph import PoseGraph, optimize_pose_graph
from slambench_tpu_torch.models.keyframes import KeyframeStore, PoseGraphKFusion
