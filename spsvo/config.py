"""Typed configuration for the stereo visual odometry pipeline.

Covers the complete flag surface of the reference ROS parameter set
(reference: src/odml_visual_odometry/src/visual_odometry_node.cpp:334-403 and
the compile-time constants in include/odml_visual_odometry/feature_detection.hpp:137-147,368),
plus the loader-side params (src/odml_data_processing/src/data_processing_node.cpp:194-195).

One frozen dataclass; hashable so it can be closed over by jitted functions as
a static argument.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class DetectorType(enum.Enum):
    """Feature detector families (reference feature_detection.hpp:24-42)."""

    SHI_TOMASI = "ShiTomasi"
    BRISK = "BRISK"
    FAST = "FAST"
    ORB = "ORB"
    AKAZE = "AKAZE"
    SIFT = "SIFT"
    SUPERPOINT = "SuperPoint"


class DescriptorType(enum.Enum):
    """Descriptor families (reference feature_detection.hpp:43-54)."""

    BRISK = "BRISK"
    ORB = "ORB"
    BRIEF = "BRIEF"
    AKAZE = "AKAZE"
    FREAK = "FREAK"
    SIFT = "SIFT"
    SUPERPOINT = "SuperPoint"

    @property
    def is_binary(self) -> bool:
        """Binary descriptors are matched with Hamming distance
        (reference feature_detection_base.cpp:13-20)."""
        return self in (DescriptorType.BRISK, DescriptorType.ORB,
                        DescriptorType.BRIEF, DescriptorType.AKAZE,
                        DescriptorType.FREAK)


class MatcherType(enum.Enum):
    """BF = brute force (the device path), FLANN falls back to BF on device
    (reference feature_detection.hpp:55-59)."""

    BF = "BF"
    FLANN = "FLANN"


class SelectorType(enum.Enum):
    """NN = mutual nearest neighbour (cross-check), KNN = Lowe ratio test
    (reference feature_detection.hpp:60-64, feature_detection_base.cpp:462-473)."""

    NN = "NN"
    KNN = "KNN"


class Precision(enum.Enum):
    """Compute precision of the CNN trunk. FP32/BF16 mirror the reference's
    TensorRT FP32/FP16 engine grid (reference feature_detection.hpp:240-251);
    INT8 is post-training weight+activation quantization with int8
    convolutions accumulating in int32 (beyond the reference's grid)."""

    FP32 = "FP32"
    BF16 = "BF16"
    INT8 = "INT8"

    @property
    def suffix(self) -> str:
        return self.value


# Image positions in the 4-slot sliding window; kept for API parity with the
# reference's deque offsets (feature_detection.hpp:66-77).
class ImagePosition(enum.IntEnum):
    PREV_LEFT = -4
    PREV_RIGHT = -3
    CURR_LEFT = -2
    CURR_RIGHT = -1


class MatchType(enum.IntEnum):
    """The three match passes per frame (reference feature_detection.hpp:79-90)."""

    CURR_LEFT_CURR_RIGHT = 0
    CURR_LEFT_PREV_LEFT = 1
    PREV_LEFT_PREV_RIGHT = 2


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """Full pipeline configuration.

    Defaults mirror launch/visual_odometry_superpoint.launch plus the
    compile-time constants the reference flags as "move to config".
    """

    # --- front end selection -------------------------------------------------
    is_classic: bool = False
    detector_type: DetectorType = DetectorType.SUPERPOINT
    descriptor_type: DescriptorType = DescriptorType.SUPERPOINT
    matcher_type: MatcherType = MatcherType.BF
    selector_type: SelectorType = SelectorType.NN
    cross_check: bool = True
    # --- device-resident classic front end (beyond-reference) ----------------
    # The reference's classic detectors run host OpenCV
    # (feature_detection_classic.cpp); device_classic=True replaces them with
    # the device-resident ORB-class front end (ops/orb.py: FAST-9 + intensity-
    # centroid orientation + steered BRIEF) so the classic pipeline becomes
    # one fused device program like the SuperPoint path. Requires
    # is_classic=True; the orb_* knobs mirror the reference's ORB_create
    # parameters (feature_detection_classic.cpp:13-25).
    device_classic: bool = False
    orb_n_levels: int = 8
    orb_scale_factor: float = 1.2
    orb_fast_threshold: int = 20
    orb_edge_threshold: int = 31

    # --- geometry / solver ---------------------------------------------------
    stereo_threshold: float = 2.0     # max |Δy| for a stereo match (px)
    min_disparity: float = 1.0        # min |Δx| for a stereo match (px)
    refinement_degree: int = 4        # 0..4 factor schedule for LM refinement
    ransac_iterations: int = 500      # reference solvePnPRansac iterations
    ransac_reproj_threshold: float = 2.0   # px
    ransac_confidence: float = 0.999  # adaptive early-exit bound; >=1 = off
    ransac_min_inliers: int = 6       # below this, PnP is declared failed
    solve_slots: int = 256            # solver capacity: chain survivors are
    # compacted into this many lanes before triangulation/RANSAC/LM, so the
    # geometric solve scales with real matches, not keypoint capacity; chains
    # longer than this keep only the first solve_slots (0 = no compaction)
    lm_max_iterations: int = 40       # reference Ceres max_num_iterations
    lm_unroll: int = 0                # >0: exactly this many LM iterations,
    # trace-unrolled (no while_loop), which sequential scans prefer; 0 keeps
    # the early-exit while_loop
    ransac_chunk: int = 64            # adaptive-loop chunk size; <=0 or
    # >= iterations = one exhaustive batch (best for sequential scans)
    huber_delta: float = 1.0          # reference HuberLoss(1.0)

    # --- motion gates (reference feature_detection.hpp:145-147,
    # visual_odometry_node.cpp:117-123) --------------------------------------
    time_interval: float = 0.1        # seconds per frame (KITTI 10 Hz)
    max_acceleration: float = 8.0     # m/s^2 anomaly gate
    ignore_frame_count: int = 10      # frames before the acceleration gate arms
    max_velocity_per_frame: float = 10.0  # metres per frame publish gate

    # --- input geometry ------------------------------------------------------
    image_height: int = 120           # 0 = native resolution (classic only)
    image_width: int = 392

    # --- neural network ------------------------------------------------------
    model_name_prefix: str = "superpoint_pretrained"
    model_batch_size: int = 2         # 1 = run L and R separately, 2 = stacked
    machine_name: str = "device"
    precision: Precision = Precision.FP32
    conf_thresh: float = 0.015
    dist_thresh: int = 4              # NMS suppression radius (px)
    border_remove: int = 4            # border margin for keypoints (px)
    max_keypoints: int = 1000         # K: fixed keypoint capacity per image
    nms_iterations: int = 2           # iterated max-pool NMS rounds
    subpixel_refine: object = False   # sub-pixel keypoint localisation:
    # False = integer-pixel parity; True/"axis" = per-axis parabolas;
    # "quad" = coupled 2D quadratic fit (beyond-reference option)
    knn_threshold: float = 0.8        # Lowe ratio

    # --- matching capacity ---------------------------------------------------
    # Fixed shapes for the jitted matcher; reference uses dynamic vectors.
    verbose: bool = False

    # --- loader / eval harness ----------------------------------------------
    rosbag_rate: float = 1.0          # playback rate equivalent (realtime sim)
    pre_waiting_time: int = 2         # seconds (kept for config parity)

    # --- execution -----------------------------------------------------------
    num_parallel_frames: int = 1      # frames per sharded step (multi-device DP)
    latency_warn_ms: float = 125.0    # reference per-step budget warning
    matcher_bf16: bool = False        # descriptor distance matmul in bf16
    # (fp32 accumulation). Descriptors are L2-normalised so NN ranking is
    # robust; selection agreement vs fp32 pinned by tests/test_matching.py::
    # test_matcher_bf16_selection_agreement. On in presets.flagship.
    # Float descriptors only (binary Hamming stays exact integer fp32).
    use_pallas_solver: bool = False   # fused whole-solver Pallas kernel for
    # the hybrid online scan (score+winner+refit+polish+LM+gates in ONE
    # kernel launch per frame); runs on the GPU for eligible configs
    # (single-batch RANSAC + lm_unroll>0, solver.pallas_solver_eligible)
    # --- landmark fusion (beyond-reference accuracy mode) --------------------
    # The reference re-triangulates every 3D point from a single stereo pair
    # each frame (feature_detection_base.cpp:212-223), so integer-pixel
    # disparity noise re-enters the solve every frame and accumulates as a
    # random-walk drift. Landmark fusion carries a per-track fused 3D
    # estimate across frames (track-length-weighted average of the carried
    # landmark, transformed by the solved pose, with the fresh
    # triangulation): the prev-side 3D that feeds the inlier refit and the
    # degree>=3 LM factors has its depth noise averaged down by
    # 1/track_length (the Horn hypothesis SAMPLING also sees the fused
    # points in the streaming path; the hybrid scan hoists it as a
    # prior-independent phase, so there it samples fresh triangulations —
    # ops/solver.py's landmark-fusion block). Tracks are gated by
    # reprojection consistency in BOTH current images and reset on
    # pose-gate frames.
    landmark_fusion: bool = False
    landmark_max_age: int = 30        # cap on the fusion weight / track length
    landmark_gate_px: float = 4.0     # max reprojection error (px) of the
    # predicted landmark in the current L/R images for fusion (else reset)
    landmark_weighted_lm: bool = True  # GLS re-refinement: re-run the LM
    # from the solved pose with the backward-in-time factors (whose prev-side
    # 3D is a fused landmark, variance ~ 1/track_length) weighted by the
    # capped track length — the statistically-correct weighting once tracks
    # carry unequal depth variance. Uses only observation-anchored points
    # (no pose-feedback loop, unlike landmark_refine). Needs degree >= 3.
    # Measured (docs/landmark_matrix.json, 5 drives x 3 keys): mean drift
    # 1.50% -> 0.90%, ATE 0.144 -> 0.079 m, RPE-t 0.045 -> 0.039 m.
    landmark_refine: bool = False     # after fusion, re-run the LM refinement
    # with the fused CURRENT-frame points. Default OFF on measurement
    # (docs/landmark_matrix.json): re-estimating the pose from points the
    # same pose just created is a positive-feedback loop — the pure
    # substitution mode (prev-side landmarks only, anchored to observations
    # independent of the current estimate) wins on every drive
    # (mean ATE 0.113 vs 0.158 m), while this alternation LOSES to the
    # plain baseline (1.63% vs 1.50% mean drift)
    speculative_solve: bool = False   # hybrid online mode: precompute the
    # prior-independent RANSAC winner + refinement frame-parallel, leaving
    # only prior-lane scoring + gates in the sequential scan (requires
    # single-batch RANSAC, i.e. ransac_chunk<=0 or >= iterations).
    # Default OFF: on the corridor drives the constant-velocity prior beats
    # every sampled hypothesis on most frames, so the "rare" in-scan branch
    # almost always runs and the precompute is wasted. Useful only for
    # erratic-motion workloads where the prior rarely wins.

    def __post_init__(self) -> None:
        if not self.is_classic:
            if self.image_height % 8 or self.image_width % 8:
                raise ValueError(
                    "SuperPoint input height/width must be multiples of 8 "
                    f"(got {self.image_height}x{self.image_width})")
        if self.model_batch_size not in (1, 2):
            raise ValueError("model_batch_size must be 1 or 2")
        if self.device_classic and not self.is_classic:
            raise ValueError("device_classic requires is_classic=True")
        if self.device_classic and not self.descriptor_type.is_binary:
            # the device front end emits binary descriptors (256-bit
            # steered-BRIEF, or the 512-bit BRISK ring pattern when
            # descriptor_type is BRISK); a float descriptor_type would be
            # silently ignored (and the instrumented path would match with
            # the wrong metric)
            raise ValueError(
                "device_classic emits binary (steered-BRIEF / BRISK) "
                f"descriptors; descriptor_type={self.descriptor_type.value} "
                "is not supported on the device path")
        if not 0 <= self.refinement_degree <= 4:
            raise ValueError("refinement_degree must be in [0, 4]")

    @property
    def cell(self) -> int:
        """SuperPoint cell size (heatmap upsampling factor)."""
        return 8

    @property
    def heatmap_height(self) -> int:
        return self.image_height

    @property
    def heatmap_width(self) -> int:
        return self.image_width

    @property
    def grid_height(self) -> int:
        return self.image_height // 8

    @property
    def grid_width(self) -> int:
        return self.image_width // 8

    @property
    def config_string(self) -> str:
        """Engine-style identity string, mirroring the reference file naming
        contract {prefix}_{batch}_{H}_{W}_{precision}
        (reference feature_detection_neural_network.cpp:44-49)."""
        if self.is_classic:
            host = "orbdev" if self.device_classic else "classic"
            return (f"{host}_{self.detector_type.value}_"
                    f"{self.descriptor_type.value}_{self.image_height}_"
                    f"{self.image_width}")
        return (f"{self.model_name_prefix}_{self.model_batch_size}_"
                f"{self.image_height}_{self.image_width}_"
                f"{self.precision.suffix}")


# The reference's full engine sweep grid (scripts/engine_generation.py:13-31):
# 6 backbones x 2 batch sizes x 3 resolutions x 2 precisions = 72 NN configs.
MODEL_PREFIXES = ("superpoint_pretrained", "sp_sparse", "sp_mbv1", "sp_mbv2",
                  "sp_squeeze", "sp_resnet18")
SWEEP_RESOLUTIONS = ((360, 1176), (240, 784), (120, 392))
SWEEP_BATCH_SIZES = (1, 2)
SWEEP_PRECISIONS = (Precision.FP32, Precision.BF16)


def classic_sweep_configs(base: Optional[VOConfig] = None) -> list[VOConfig]:
    """The reference benchmarks 6 classic configs alongside the 72 NN engines
    (report §4.1.2: "72 engines for the SuperPoint family, and 6 engines for
    the classical approach"). Enumerated as each classic detector paired with
    its natural descriptor (detector-only families use ORB descriptors, the
    launch default — visual_odometry_classic.launch)."""
    base = base or VOConfig()
    pairs = [
        (DetectorType.SHI_TOMASI, DescriptorType.ORB),
        (DetectorType.FAST, DescriptorType.ORB),
        (DetectorType.ORB, DescriptorType.ORB),
        (DetectorType.BRISK, DescriptorType.BRISK),
        (DetectorType.AKAZE, DescriptorType.AKAZE),
        (DetectorType.SIFT, DescriptorType.SIFT),
    ]
    rows = []
    for det, desc in pairs:
        if det in (DetectorType.BRISK, DetectorType.AKAZE):
            # cv2 5.0 dropped BRISK_create and AKAZE, so these rows run the
            # device-resident front ends at native
            # resolution instead of host OpenCV — the grid stays 6
            # measurable configs. BRISK: device FAST pyramid (a documented
            # delta from BRISK's AGAST scale space) + the paper's
            # ring-pattern descriptor (ops/orb.py brisk_descriptors).
            # AKAZE: FED nonlinear-diffusion scale space + Hessian-det
            # detection + M-LDB (ops/akaze.py). Both carry the "orbdev"
            # device tag in config_string so sweep consumers see the
            # measurement-basis difference from host cv2 rows.
            rows.append(dataclasses.replace(
                base, is_classic=True, device_classic=True,
                detector_type=det, descriptor_type=desc,
                image_height=375, image_width=1242, orb_edge_threshold=31))
            continue
        rows.append(dataclasses.replace(
            base, is_classic=True, detector_type=det, descriptor_type=desc,
            image_height=0, image_width=0))  # native res (launch default)
    return rows


def device_classic_sweep_configs(base: Optional[VOConfig] = None
                                 ) -> list[VOConfig]:
    """Beyond-reference sweep rows: the device-resident classic front ends
    (ops/orb.py) at the flagship resolution and at native KITTI resolution —
    the classic configs with zero per-frame host work."""
    base = base or VOConfig()
    rows = []
    for det in (DetectorType.ORB, DetectorType.SHI_TOMASI):
        for (h, w, border) in ((120, 392, 16), (375, 1242, 31)):
            rows.append(dataclasses.replace(
                base, is_classic=True, device_classic=True,
                detector_type=det, descriptor_type=DescriptorType.ORB,
                image_height=h, image_width=w, orb_edge_threshold=border))
    return rows


def sweep_configs(base: Optional[VOConfig] = None) -> list[VOConfig]:
    """Enumerate the 72-config NN sweep (reference engine_generation.py grid)."""
    base = base or VOConfig()
    out = []
    for prefix in MODEL_PREFIXES:
        for batch in SWEEP_BATCH_SIZES:
            for (h, w) in SWEEP_RESOLUTIONS:
                for prec in SWEEP_PRECISIONS:
                    out.append(dataclasses.replace(
                        base, model_name_prefix=prefix, model_batch_size=batch,
                        image_height=h, image_width=w, precision=prec))
    return out
