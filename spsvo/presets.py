"""Config presets mirroring the reference's launch files (C19).

Each preset reproduces one roslaunch parameter block
(src/odml_visual_odometry/launch/*.launch, src/odml_data_processing/launch/
main.launch) as a `VOConfig`; `main_config` composes like main.launch's
is_classic/is_jetson arguments.
"""

from __future__ import annotations

from spsvo.config import (DescriptorType, DetectorType, MatcherType,
                              Precision, SelectorType, VOConfig)


def classic_orb() -> VOConfig:
    """visual_odometry_classic.launch: ORB/ORB, BF matcher, NN selector,
    native resolution (image_height=0 passthrough)."""
    return VOConfig(
        is_classic=True,
        detector_type=DetectorType.ORB,
        descriptor_type=DescriptorType.ORB,
        matcher_type=MatcherType.BF,
        selector_type=SelectorType.NN,
        cross_check=True,
        image_height=0, image_width=0,
        stereo_threshold=2.0, min_disparity=1.0, refinement_degree=4)


def superpoint_laptop() -> VOConfig:
    """visual_odometry_superpoint.launch: sp_resnet18, 360x1176, FP32,
    batch 1."""
    return VOConfig(
        model_name_prefix="sp_resnet18",
        model_batch_size=1,
        image_height=360, image_width=1176,
        precision=Precision.FP32,
        conf_thresh=0.015, dist_thresh=4, border_remove=4,
        stereo_threshold=2.0, min_disparity=1.0, refinement_degree=4)


def superpoint_jetson() -> VOConfig:
    """visual_odometry_superpoint_jetson.launch: superpoint_pretrained,
    360x1176, FP16 (-> BF16 here), batch 2, verbose."""
    return VOConfig(
        model_name_prefix="superpoint_pretrained",
        model_batch_size=2,
        image_height=360, image_width=1176,
        precision=Precision.BF16,
        verbose=True,
        conf_thresh=0.015, dist_thresh=4, border_remove=4,
        stereo_threshold=2.0, min_disparity=1.0, refinement_degree=4)


def flagship() -> VOConfig:
    """This framework's flagship: superpoint_pretrained (the original
    MagicLeap VGG SuperPoint at its published widths, weights in
    weights/superpoint_pretrained.npz) @ 120x392, batch-2 stereo, bf16 trunk
    + landmark fusion + bf16 matcher — the configuration chip_smoke.py and
    bench.py run. Of the six families it had the lowest corridor drift
    (docs/family_corridor_accuracy.json)."""
    return VOConfig(
        model_name_prefix="superpoint_pretrained",
        model_batch_size=2,
        image_height=120, image_width=392,
        max_keypoints=512,
        ransac_iterations=256,
        # bf16 CNN trunk; the geometry solve stays fp32 in all trunk
        # precisions
        precision=Precision.BF16,
        # carried fused landmarks replace per-frame re-triangulation
        # (docs/landmark_matrix.json)
        landmark_fusion=True,
        # bf16 descriptor matmuls (fp32 accumulation)
        matcher_bf16=True,
        # sequential-path tuning (accuracy pinned on synthetic drives,
        # tests/test_parallel.py::test_online_hybrid_tuned_config_accuracy):
        # one exhaustive RANSAC batch, 6 unrolled LM iterations, chain
        # compaction to 128 solver lanes — the configuration the fused
        # Pallas solver requires (solver.pallas_solver_eligible)
        ransac_chunk=0, lm_unroll=6, solve_slots=128,
        use_pallas_solver=True)


def main_config(is_classic: bool = False, is_jetson: bool = False
                ) -> VOConfig:
    """main.launch composition (odml_data_processing/launch/main.launch:1-24)."""
    if is_classic:
        return classic_orb()
    return superpoint_jetson() if is_jetson else superpoint_laptop()


PRESETS = {
    "classic_orb": classic_orb,
    "superpoint_laptop": superpoint_laptop,
    "superpoint_jetson": superpoint_jetson,
    "flagship": flagship,
}
