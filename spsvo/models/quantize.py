"""Post-training int8 quantization for the CNN trunk.

Extends the reference's FP32/FP16 engine grid with an int8 mode (the
BASELINE config list names "quantized bf16/int8 SuperPoint"): convolution
weights are quantized per-output-channel to int8 offline; activations are
quantized per-tensor dynamically at each conv input; the conv itself runs as
an int8 x int8 -> int32 contraction, then dequantizes into fp32
for bias/BN/ReLU (which XLA fuses). Heads and normalisation stay fp32 — the
descriptor L2-norm and detector softmax are precision-critical.

Two activation-scale modes:

  * dynamic (default, no data needed): per-tensor absmax computed at each
    conv input on every forward — an extra full pass over each activation,
    which at this trunk size can cost more than the int8 conv saves;
  * static (calibrated): per-conv scales measured once over calibration
    images (`calibrate_activation_scales`) and stored as `<w>#ascale`
    params — the dynamic passes disappear, AND the interpreter
    (onnx_import.make_apply) pushes each conv-input quantization up into the
    producing layer's epilogue, so inter-layer activations materialize in
    HBM as int8 (1 byte/element) instead of fp32 — a memory-bound trunk's
    win from int8 comes from these bytes. MaxPool runs on the int8 tensors directly
    (quantization is monotonic, so it commutes with max).

Accuracy is validated in tests against the fp32 trunk (descriptor cosine
similarity / keypoint overlap).
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp


def quantize_weights(params: Dict[str, jax.Array], conv_weight_names
                     ) -> Dict[str, jax.Array]:
    """Replace HWIO conv weights with int8 values + fp32 per-channel scales.

    Adds `<name>#scale` entries; non-conv params pass through.
    """
    out: Dict[str, jax.Array] = {}
    for name, w in params.items():
        if name in conv_weight_names:
            absmax = jnp.max(jnp.abs(w), axis=(0, 1, 2), keepdims=True)
            scale = jnp.maximum(absmax, 1e-12) / 127.0
            q = jnp.clip(jnp.round(w / scale), -127, 127).astype(jnp.int8)
            out[name] = q
            out[f"{name}#scale"] = scale[0, 0, 0].astype(jnp.float32)
        else:
            out[name] = w
    return out


def calibrate_activation_scales(graph, params_fp32: Dict[str, jax.Array],
                                images: jax.Array, batch: int = 8,
                                margin: float = 1.0,
                                percentile: float | None = None
                                ) -> Dict[str, jax.Array]:
    """Static per-conv activation scales from calibration images.

    Runs the fp32 graph with conv-input capture over `images`
    ((N, H, W, C) in [0, 1]) and returns `{<w>#ascale: absmax*margin/127}`
    entries to merge into the quantized params — the dynamic absmax pass at
    every conv disappears from inference.

    `percentile` (e.g. 99.9) clips each conv input at that |x| percentile
    instead of the absmax: rare activation outliers stop stretching the
    int8 grid, so the bulk of the distribution quantizes finer. Measured
    over three 96-128-frame corridor drives (3 RANSAC keys each):
    absmax calibration averages 5.4% drift — 2x worse
    than fp32's 2.6%, with a catastrophic 8.0% on one drive — while
    99.9-percentile clipping averages 2.5%, i.e. int8 accuracy on par with
    fp32/bf16.
    """
    from spsvo.models.onnx_import import make_apply
    traced = jax.jit(make_apply(
        graph, jnp.float32, capture_conv_inputs=True,
        capture_quantile=None if percentile is None else percentile / 100.0))
    best: Dict[str, float] = {}
    n = images.shape[0]
    for i in range(0, n, batch):
        _, rec = traced(params_fp32, images[i:i + batch])
        for k, v in rec.items():
            best[k] = max(best.get(k, 0.0), float(v))
    return {f"{k}#ascale": jnp.float32(max(v, 1e-12) * margin / 127.0)
            for k, v in best.items()}


def quantize_activation(x: jax.Array, a_scale: jax.Array) -> jax.Array:
    """Symmetric per-tensor activation quantization to int8."""
    return jnp.clip(jnp.round(x / a_scale), -127, 127).astype(jnp.int8)


def int8_conv(x: jax.Array, w_q: jax.Array, w_scale: jax.Array,
              strides, padding, dilations, groups: int,
              a_scale: jax.Array | None = None,
              x_q: jax.Array | None = None) -> jax.Array:
    """Int8 convolution with dynamic or static (calibrated) activation scale.

    x: (B, H, W, C) fp32; w_q: (kh, kw, Cin/g, Cout) int8;
    w_scale: (Cout,) fp32; a_scale: scalar fp32 or None (dynamic absmax).
    `x_q` (int8, already quantized with `a_scale` by the PRODUCING layer's
    epilogue — onnx_import's static-int8 requantization chain) skips the
    in-conv quantize so the inter-layer activation materializes as int8.
    Returns fp32.
    """
    if groups > 1 and jax.default_backend() == "gpu":
        # cuDNN's int8 grouped convolution under XLA:GPU returns wrong
        # values (max error larger than the outputs themselves against the
        # CPU, on a 64-group depthwise 3x3 conv): refuse instead
        raise NotImplementedError(
            "int8 grouped/depthwise convolutions give wrong results on the "
            "GPU (XLA:GPU cuDNN int8 path); run this model family with "
            "Precision.BF16 or FP32")
    if x_q is None:
        if a_scale is None:
            a_absmax = jnp.maximum(jnp.max(jnp.abs(x)), 1e-12)
            a_scale = a_absmax / 127.0
        x_q = quantize_activation(x, a_scale)
    y = jax.lax.conv_general_dilated(
        x_q, w_q, window_strides=strides, padding=padding,
        rhs_dilation=dilations,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
        preferred_element_type=jnp.int32)
    return y.astype(jnp.float32) * (a_scale * w_scale)
