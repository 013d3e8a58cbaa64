"""Run configuration with the reference's CLI flag surface.

A copy of ``slambench_tpu/config.py`` (no JAX), so both packages parse
the same command line. TPU-native equivalent of the reference ``Configuration`` struct and its
getopt parser (reference: kfusion/include/default_parameters.h:23-75,
232-420). Flag names (short and long), defaults, scalar-broadcast vector
parsing (``atof3``/``atoi3``/``atof4``, reference:
default_parameters.h:155-230), and error-accumulating validation are kept
compatible so Makefile-style drivers written against the reference work
unchanged. TPU-specific options (mesh shape, pallas toggles) are additive.
"""

from __future__ import annotations

import dataclasses
import getopt
import os
import sys
from typing import List, Optional, Sequence, Tuple

# Defaults (reference: default_parameters.h:25-43).
DEFAULT_ITERATIONS = (10, 5, 4)
DEFAULT_MU = 0.1
DEFAULT_FPS = 0
DEFAULT_BLOCKING_READ = False
DEFAULT_ICP_THRESHOLD = 1e-5
DEFAULT_COMPUTE_SIZE_RATIO = 1
DEFAULT_INTEGRATION_RATE = 2
DEFAULT_RENDERING_RATE = 4
DEFAULT_TRACKING_RATE = 1
DEFAULT_VOLUME_RESOLUTION = (256, 256, 256)
DEFAULT_VOLUME_SIZE = (2.0, 2.0, 2.0)
DEFAULT_INITIAL_POS_FACTOR = (0.5, 0.5, 0.0)

# 'b' (blocking read): the reference declares the handler
# (default_parameters.h:266-269) but omits 'b' from its short_options
# string (:53), making the case dead code; here the flag works.
SHORT_OPTIONS = "bqc:d:f:i:l:m:k:o:p:r:s:t:v:y:z:"
LONG_OPTIONS = [
    "blocking-read",
    "compute-size-ratio=", "dump-volume=", "fps=", "input-file=", "camera=",
    "icp-threshold=", "log-file=", "mu=", "init-pose=", "no-gui",
    "integration-rate=", "volume-size=", "tracking-rate=",
    "volume-resolution=", "pyramid-levels=", "rendering-rate=",
    # TPU-native extensions (not in the reference):
    "mesh=", "backend=", "checkpoint=", "resume=", "motion-model=",
]

# Valid compute-kernel backends (pipeline.KFusion): the jnp oracle, the
# min-mip fast path, the Pallas tier, or auto (fast on CPU, pallas-fused
# reduction on TPU).
VALID_BACKENDS = ("jnp", "fast", "pallas", "auto")


def parse_float3(text: str) -> Tuple[float, float, float]:
    """Comma-separated float3 with the reference's broadcast semantics
    (reference: default_parameters.h:155-176 ``atof3``): one value ->
    (x, x, x); two values -> (x, y, y)."""
    parts = [p for p in text.split(",")]
    x = float(parts[0])
    if len(parts) == 1:
        return (x, x, x)
    y = float(parts[1])
    if len(parts) == 2:
        return (x, y, y)
    return (x, y, float(parts[2]))


def parse_uint3(text: str) -> Tuple[int, int, int]:
    """Comma-separated uint3 with broadcast semantics
    (reference: default_parameters.h:178-199 ``atoi3``)."""
    parts = text.split(",")
    x = int(parts[0])
    if len(parts) == 1:
        return (x, x, x)
    y = int(parts[1])
    if len(parts) == 2:
        return (x, y, y)
    return (x, y, int(parts[2]))


def parse_float4(text: str) -> Tuple[float, float, float, float]:
    """Comma-separated float4 with broadcast semantics
    (reference: default_parameters.h:201-230 ``atof4``)."""
    parts = text.split(",")
    x = float(parts[0])
    if len(parts) == 1:
        return (x, x, x, x)
    y = float(parts[1])
    if len(parts) == 2:
        return (x, y, y, y)
    z = float(parts[2])
    if len(parts) == 3:
        return (x, y, z, z)
    return (x, y, z, float(parts[3]))


@dataclasses.dataclass
class Configuration:
    """All runtime parameters of a KinectFusion run
    (reference: default_parameters.h:77-103)."""

    compute_size_ratio: int = DEFAULT_COMPUTE_SIZE_RATIO
    integration_rate: int = DEFAULT_INTEGRATION_RATE
    rendering_rate: int = DEFAULT_RENDERING_RATE
    tracking_rate: int = DEFAULT_TRACKING_RATE
    volume_resolution: Tuple[int, int, int] = DEFAULT_VOLUME_RESOLUTION
    volume_size: Tuple[float, float, float] = DEFAULT_VOLUME_SIZE
    initial_pos_factor: Tuple[float, float, float] = DEFAULT_INITIAL_POS_FACTOR
    pyramid: Tuple[int, ...] = DEFAULT_ITERATIONS
    dump_volume_file: str = ""
    input_file: str = ""
    log_file: str = ""
    camera: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    camera_overrided: bool = False
    mu: float = DEFAULT_MU
    fps: int = DEFAULT_FPS
    blocking_read: bool = DEFAULT_BLOCKING_READ
    icp_threshold: float = DEFAULT_ICP_THRESHOLD
    no_gui: bool = False
    render_volume_fullsize: bool = False
    # TPU-native extensions.
    mesh: str = ""          # e.g. "z:4" — shard the TSDF z-axis over 4 devices
    backend: str = "auto"   # "jnp" oracle | "pallas" | "auto"
    motion_model: str = "none"   # ICP init: "none" | "cv" (const-velocity)
    checkpoint_file: str = ""
    resume_file: str = ""

    @property
    def init_pose(self) -> Tuple[float, float, float]:
        """World-space initial camera position: factor * volume size
        (reference: benchmark.cpp:86)."""
        return tuple(
            f * s for f, s in zip(self.initial_pos_factor, self.volume_size)
        )

    def print_arguments(self, out=sys.stderr) -> None:
        """Usage text (reference: default_parameters.h:105-122)."""
        lines = [
            f"-c  (--compute-size-ratio)       : default is {DEFAULT_COMPUTE_SIZE_RATIO}   (same size)",
            "-d  (--dump-volume) <filename>   : Output volume file",
            f"-f  (--fps)                      : default is {DEFAULT_FPS}",
            "-i  (--input-file) <filename>    : Input camera file",
            "-k  (--camera)                   : default is defined by input",
            f"-l  (--icp-threshold)            : default is {DEFAULT_ICP_THRESHOLD}",
            "-o  (--log-file) <filename>      : default is stdout",
            f"-m  (--mu)                       : default is {DEFAULT_MU}",
            f"-p  (--init-pose)                : default is {DEFAULT_INITIAL_POS_FACTOR[0]},{DEFAULT_INITIAL_POS_FACTOR[1]},{DEFAULT_INITIAL_POS_FACTOR[2]}",
            "-q  (--no-gui)                   : default is to display gui",
            f"-r  (--integration-rate)         : default is {DEFAULT_INTEGRATION_RATE}",
            f"-s  (--volume-size)              : default is {DEFAULT_VOLUME_SIZE[0]},{DEFAULT_VOLUME_SIZE[1]},{DEFAULT_VOLUME_SIZE[2]}",
            f"-t  (--tracking-rate)            : default is {DEFAULT_TRACKING_RATE}",
            f"-v  (--volume-resolution)        : default is {DEFAULT_VOLUME_RESOLUTION[0]},{DEFAULT_VOLUME_RESOLUTION[1]},{DEFAULT_VOLUME_RESOLUTION[2]}",
            "-y  (--pyramid-levels)           : default is 10,5,4",
            f"-z  (--rendering-rate)           : default is {DEFAULT_RENDERING_RATE}",
            "-b  (--blocking-read)            : pace reads to --fps instead of dropping frames",
            "--mesh <axis:n>                  : shard the TSDF over an n-device mesh (TPU extension)",
            "--backend <jnp|fast|pallas|auto> : compute-kernel backend (TPU extension)",
            "--motion-model <none|cv>        : ICP warm start (TPU extension; cv = constant velocity)",
            "--fused / --scan-chunk <n>       : one-dispatch frame / scan-batched steady state (frontend flags)",
            "--keyframes [--ba]               : keyframe pose-graph backend; --ba = sparse Schur BA optimizer (frontend flags)",
        ]
        for line in lines:
            print(line, file=out)

    def print_values(self, out=sys.stdout) -> None:
        """Run-header report (reference: default_parameters.h:123-154)."""
        import time as _time
        stamp = _time.strftime("%Y-%m-%d %I:%M:%S")
        print(f"SLAMBench Report run started:\t{stamp}\n", file=out)
        print("Scene properties:\n=================\n", file=out)
        print(f"input-file: {self.input_file}", file=out)
        print("volume-size: %g,%g,%g" % self.volume_size, file=out)
        print("camera: %g,%g,%g,%g" % self.camera, file=out)
        print("init-pose: %g,%g,%g" % self.initial_pos_factor, file=out)
        print("", file=out)
        print("Algorithmic properties:\n=======================\n", file=out)
        print(f"compute-size-ratio: {self.compute_size_ratio}", file=out)
        print("volume-resolution: %d,%d,%d    " % self.volume_resolution,
              file=out)
        print(f"mu: {self.mu:g}", file=out)
        print(f"icp-threshold: {self.icp_threshold:g}", file=out)
        print("pyramid-levels: " + ",".join(str(p) for p in self.pyramid),
              file=out)
        print(f"tracking-rate: {self.tracking_rate}", file=out)
        print(f"integration-rate: {self.integration_rate}", file=out)
        print(f"rendering-rate: {self.rendering_rate}", file=out)
        print(f"fps: {self.fps}", file=out)


def parse_args(argv: Sequence[str]) -> Configuration:
    """Parse a reference-compatible command line into a Configuration.

    Mirrors the getopt loop in the reference constructor
    (reference: default_parameters.h:232-420): errors accumulate and are
    reported together; unknown options print usage and exit 0 (the
    reference's behaviour for '?').
    """
    cfg = Configuration()
    errors: List[str] = []
    try:
        opts, _ = getopt.getopt(list(argv), SHORT_OPTIONS, LONG_OPTIONS)
    except getopt.GetoptError as e:
        print(f"Unknown option {e.opt} or bad usage.", file=sys.stderr)
        cfg.print_arguments()
        raise SystemExit(0)

    for opt, arg in opts:
        if opt in ("-b", "--blocking-read"):
            cfg.blocking_read = True
            print("activate blocking read", file=sys.stderr)
        elif opt in ("-c", "--compute-size-ratio"):
            cfg.compute_size_ratio = int(arg)
            print(f"update compute_size_ratio to {cfg.compute_size_ratio}",
                  file=sys.stderr)
            if cfg.compute_size_ratio not in (1, 2, 4, 8):
                errors.append(
                    f"--compute-size-ratio (-c) must be 1, 2 ,4 or 8  (was {arg})")
        elif opt in ("-d", "--dump-volume"):
            cfg.dump_volume_file = arg
        elif opt in ("-f", "--fps"):
            cfg.fps = int(arg)
            if cfg.fps < 0:
                errors.append(f"--fps (-f) must be >= 0 (was {arg})")
        elif opt in ("-i", "--input-file"):
            cfg.input_file = arg
            if not os.path.exists(arg):
                errors.append(f"--input-file (-i) does not exist (was {arg})")
        elif opt in ("-k", "--camera"):
            cfg.camera = parse_float4(arg)
            cfg.camera_overrided = True
        elif opt in ("-o", "--log-file"):
            cfg.log_file = arg
        elif opt in ("-l", "--icp-threshold"):
            cfg.icp_threshold = float(arg)
        elif opt in ("-m", "--mu"):
            cfg.mu = float(arg)
        elif opt in ("-p", "--init-pose"):
            cfg.initial_pos_factor = parse_float3(arg)
        elif opt in ("-q", "--no-gui"):
            cfg.no_gui = True
        elif opt in ("-r", "--integration-rate"):
            cfg.integration_rate = int(arg)
            if cfg.integration_rate < 1:
                errors.append(f"--integration-rate (-r) must >= 1 (was {arg})")
        elif opt in ("-s", "--volume-size"):
            cfg.volume_size = parse_float3(arg)
            if any(v <= 0 for v in cfg.volume_size):
                errors.append(
                    f"--volume-size (-s) all dimensions must > 0 (was {arg})")
        elif opt in ("-t", "--tracking-rate"):
            cfg.tracking_rate = int(float(arg))
        elif opt in ("-z", "--rendering-rate"):
            cfg.rendering_rate = int(float(arg))
        elif opt in ("-v", "--volume-resolution"):
            cfg.volume_resolution = parse_uint3(arg)
            if any(v <= 0 for v in cfg.volume_resolution):
                errors.append(
                    f"--volume-resolution (-v) all dimensions must > 0 (was {arg})")
        elif opt in ("-y", "--pyramid-levels"):
            cfg.pyramid = tuple(int(float(s)) for s in arg.split(","))
        elif opt == "--mesh":
            cfg.mesh = arg
        elif opt == "--backend":
            cfg.backend = arg
            if cfg.backend not in VALID_BACKENDS:
                errors.append(
                    "--backend must be one of %s (was %s)"
                    % ("|".join(VALID_BACKENDS), arg))
        elif opt == "--motion-model":
            cfg.motion_model = arg
            if cfg.motion_model not in ("none", "cv"):
                errors.append(
                    "--motion-model must be one of none|cv (was %s)" % arg)
        elif opt == "--checkpoint":
            cfg.checkpoint_file = arg
        elif opt == "--resume":
            cfg.resume_file = arg

    if errors:
        for e in errors:
            print("ERROR: " + e, file=sys.stderr)
        n = len(errors)
        print(f"Exited due to {n} error{'' if n == 1 else 's'}"
              " in command line options", file=sys.stderr)
        raise SystemExit(1)
    return cfg
