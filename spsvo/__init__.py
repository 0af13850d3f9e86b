"""spsvo — SuperPoint stereo visual odometry in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
YukunXia/SuperPoint-Stereo-Visual-Odometry (stereo VO on KITTI with
swappable classic / SuperPoint-CNN feature front ends).
"""
import os as _os

import jax as _jax

# The geometry stack (triangulation, Kabsch, LM normal equations) is
# correctness-critical in fp32, and an fp32 matmul left at the default
# precision may run at reduced precision (TF32 on NVIDIA tensor cores,
# ~1e-3 relative error), which corrupts pose solves. Pin full fp32 matmul
# semantics globally; the CNN trunk opts into fast reduced-precision passes
# by casting its inputs to bfloat16 (unaffected by this knob) when
# Precision.BF16 is selected.
_jax.config.update("jax_default_matmul_precision", "float32")


_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def local_cache_dir() -> str:
    """Git-ignored directory inside the checkout for derived files (rendered
    training frames, the native loader's shared library)."""
    return _os.path.join(_CHECKOUT, ".spsvo_cache")


def compile_cache_dir() -> str | None:
    """Where this package keeps JAX's persistent compilation cache.

    None when JAX_COMPILATION_CACHE_DIR is set: JAX then reads that
    directory itself and the package sets none. Otherwise a fixed directory
    inside the checkout (`.jax_cache`, git-ignored), so that later processes
    on the same checkout reuse compiled programs — the analogue of the
    reference's compiled-.engine file cache keyed by config
    (feature_detection_neural_network.cpp:44-49)."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_CHECKOUT, ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from spsvo.config import (VOConfig, DetectorType, DescriptorType,  # noqa: E402
                          MatcherType, SelectorType, Precision, MatchType)

__version__ = "0.1.0"
