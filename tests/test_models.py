"""Model zoo: ONNX import golden tests vs cv2.dnn, architecture invariants.

This is the executable replacement for the reference's side-by-side
visualization comparison against the original implementation (SURVEY.md §4.1):
the imported JAX graphs are checked numerically against an independent ONNX
runtime (OpenCV dnn) on the same inputs.
"""
import functools
import os

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from spsvo.models import zoo

REF = zoo.REFERENCE_MODELS_DIR
EXPECTED_PARAMS = {"sp_mbv1": 752779, "sp_mbv2": 945035, "sp_squeeze": 844353}


@pytest.mark.parametrize("prefix", sorted(zoo.BUNDLED_ONNX))
def test_onnx_import_matches_cv2_dnn(prefix, rng):
    if not os.path.isdir(REF):
        pytest.skip("reference models unavailable")
    x = rng.random((1, 1, 120, 392), dtype=np.float64).astype(np.float32)
    net = cv2.dnn.readNetFromONNX(os.path.join(REF, f"{prefix}_b1.onnx"))
    net.setInput(x)
    det_ref, desc_ref = net.forward(["output_det", "output_desc"])

    apply_fn, params = zoo.load_model(prefix)
    assert zoo.param_count(params) == EXPECTED_PARAMS[prefix]
    out = jax.jit(apply_fn)(params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    det = np.asarray(out["output_det"]).transpose(0, 3, 1, 2)
    desc = np.asarray(out["output_desc"]).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(det, det_ref, atol=2e-4)
    np.testing.assert_allclose(desc, desc_ref, atol=2e-4)


@pytest.mark.parametrize("prefix",
                         ["superpoint_pretrained", "sp_resnet18", "sp_sparse"])
def test_hand_defined_architectures(prefix, rng):
    apply_fn, params = zoo.load_model(prefix, seed=3)
    x = jnp.asarray(rng.random((1, 120, 392, 1), np.float32))
    out = jax.jit(apply_fn)(params, x)
    assert out["output_det"].shape == (1, 15, 49, 65)
    assert out["output_desc"].shape == (1, 15, 49, 256)
    # in-graph descriptor L2 normalisation
    norms = np.linalg.norm(np.asarray(out["output_desc"]), axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)


def test_vgg_param_count_matches_original_superpoint():
    """The original MagicLeap SuperPointNet has 1,300,865 parameters."""
    _, params = zoo.load_model("superpoint_pretrained")
    assert zoo.param_count(params) == 1_300_865


def test_bf16_trunk_close_to_fp32(rng):
    x = rng.random((1, 1, 120, 392), dtype=np.float64).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    a32, p = zoo.load_model("superpoint_pretrained", jnp.float32)
    a16, _ = zoo.load_model("superpoint_pretrained", jnp.bfloat16)
    o32 = jax.jit(a32)(p, xj)
    o16 = jax.jit(a16)(p, xj)
    # bf16 trunk mirrors the reference's FP16 engines: same predictions to
    # within low-precision tolerance
    d32 = np.asarray(o32["output_desc"])
    d16 = np.asarray(o16["output_desc"])
    cos = (d32 * d16).sum(-1)
    assert np.percentile(cos, 1) > 0.99


def test_resolutions_sweep_shapes():
    apply_fn, params = zoo.load_model("superpoint_pretrained")
    for (h, w) in [(360, 1176), (240, 784), (120, 392)]:
        out = apply_fn(params, jnp.zeros((1, h, w, 1), jnp.float32))
        assert out["output_det"].shape == (1, h // 8, w // 8, 65)


def test_save_and_reload_params(tmp_path, monkeypatch):
    monkeypatch.setenv("SPSVO_WEIGHTS_DIR", str(tmp_path))
    apply_fn, params = zoo.load_model("sp_resnet18", seed=7)
    zoo.save_params("sp_resnet18", params)
    apply2, params2 = zoo.load_model("sp_resnet18", seed=99)
    for k in params:
        np.testing.assert_array_equal(np.asarray(params[k]),
                                      np.asarray(params2[k]))


def test_gradients_finite_on_dead_activations():
    """The (ReduceL2, Div) descriptor tail is fused into a stable
    L2-normalisation: gradients must stay finite even when ReLU-dead
    activations drive the pre-norm descriptor to zero (this NaN'd training
    before the fusion)."""
    apply_fn, params = zoo.load_model("superpoint_pretrained")

    def loss(p, x):
        out = apply_fn(p, x)
        return (jnp.sum(out["output_desc"] ** 2)
                + 1e-3 * jnp.sum(out["output_det"] ** 2))

    g = jax.grad(loss)(params, jnp.zeros((1, 48, 64, 1), jnp.float32))
    assert all(bool(jnp.all(jnp.isfinite(v))) for v in jax.tree.leaves(g))


def test_int8_quantized_trunk_accuracy(rng):
    """Post-training int8 (per-channel weights, dynamic activations) must
    stay close to the fp32 trunk on real weights."""
    x = rng.random((1, 1, 120, 392), np.float64).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    a32, p32 = zoo.load_model("superpoint_pretrained")
    a8, p8 = zoo.load_model("superpoint_pretrained", int8=True)
    # every conv weight quantized: the VGG SuperPoint has 8 trunk convs and
    # 2 per head
    n_int8 = sum(1 for v in p8.values() if v.dtype == jnp.int8)
    assert n_int8 == 12
    o32 = jax.jit(a32)(p32, xj)
    o8 = jax.jit(a8)(p8, xj)
    d32 = np.asarray(o32["output_desc"]).reshape(-1, 256)
    d8 = np.asarray(o8["output_desc"]).reshape(-1, 256)
    cos = (d32 * d8).sum(-1)
    assert np.percentile(cos, 5) > 0.95, np.percentile(cos, [1, 5, 50])
    # detector heatmaps must select overlapping peaks
    from spsvo.ops.postprocess import heatmap_from_logits
    h32 = np.asarray(heatmap_from_logits(o32["output_det"]))[0]
    h8 = np.asarray(heatmap_from_logits(o8["output_det"]))[0]
    top32 = set(map(tuple, np.argwhere(h32 > np.percentile(h32, 99.8))))
    top8 = set(map(tuple, np.argwhere(h8 > np.percentile(h8, 99.8))))
    inter = len(top32 & top8) / max(len(top32 | top8), 1)
    assert inter > 0.5, inter


@pytest.mark.slow
@pytest.mark.parametrize("prefix", zoo.ALL_PREFIXES)
def test_every_family_yields_real_keypoints(prefix, sample_image_dir):
    """every model prefix must produce usable features
    on a real frame through the production pipeline — the three LFS-stripped
    families run on weights distilled from the sp_mbv1 teacher
    (weights/*.npz, tools/distill_families.py), not random init."""
    import cv2

    from spsvo.config import VOConfig
    from spsvo.pipeline import VisualOdometry
    if prefix not in zoo.BUNDLED_ONNX:
        assert os.path.exists(os.path.join(zoo.weights_dir(),
                                           f"{prefix}.npz")), \
            f"distilled weights missing for {prefix}"
    img = cv2.imread(os.path.join(sample_image_dir, "0000000000.png"),
                     cv2.IMREAD_GRAYSCALE)
    P = np.array([[718.856, 0, 607.1928, 0.0],
                  [0, 718.856, 185.2157, 0.0], [0, 0, 1.0, 0.0]])
    P_r = P.copy(); P_r[0, 3] = -386.1448
    vo = VisualOdometry(VOConfig(model_name_prefix=prefix, max_keypoints=512))
    _, info = vo.process(img, np.roll(img, -8, axis=1), P, P_r,
                         want_diagnostics=True)
    _, info2 = vo.process(np.roll(img, 3, axis=1), np.roll(img, -5, axis=1),
                          P, P_r, want_diagnostics=True)
    assert info["num_keypoints_left"] > 100, (prefix, info)
    assert info2["num_inliers"] > 20, (prefix, info2)


def test_int8_static_calibration_matches_dynamic(rng, sample_image_dir):
    """Calibrated static activation scales must match dynamic-scale int8
    closely (same quantization grid, scale from data instead of per-call),
    and stay close to fp32."""
    import cv2

    from spsvo.ops.image import preprocess_image_np
    files = sorted(os.listdir(sample_image_dir))[:4]
    imgs = np.stack([preprocess_image_np(
        cv2.imread(os.path.join(sample_image_dir, f), cv2.IMREAD_GRAYSCALE),
        120, 392) for f in files])[..., None]
    calib, test = imgs[:3], imgs[3:]

    apply_fp, p_fp = zoo.load_model("superpoint_pretrained")
    apply_dyn, p_dyn = zoo.load_model("superpoint_pretrained", int8=True)
    apply_st, p_st = zoo.load_model("superpoint_pretrained", int8=True,
                                    int8_calibration=calib)
    assert any(k.endswith("#ascale") for k in p_st)

    x = jnp.asarray(test)
    ref = apply_fp(p_fp, x)
    dyn = apply_dyn(p_dyn, x)
    st = apply_st(p_st, x)

    def desc_cos(a, b):
        return float(jnp.mean(jnp.sum(a["output_desc"] * b["output_desc"],
                                      axis=-1)))

    assert desc_cos(st, ref) > 0.95, desc_cos(st, ref)

    # absmax calibration reproduces the dynamic-absmax quantization grid
    # (same scale source, measured offline instead of per call)
    _, p_abs = zoo.load_model("superpoint_pretrained", int8=True, int8_calibration=calib,
                              int8_percentile=None)
    st_abs = apply_st(p_abs, x)
    assert desc_cos(st_abs, dyn) > 0.98, desc_cos(st_abs, dyn)
    assert desc_cos(st_abs, ref) > 0.95, desc_cos(st_abs, ref)

    # percentile clipping (the default) must tighten every scale vs absmax
    # while staying close to fp32 — absmax calibration lets rare outliers
    # stretch the int8 grid (measured: 2x worse drift)
    scale_pairs = [(float(p_st[k]), float(p_abs[k]))
                   for k in p_st if k.endswith("#ascale")]
    assert scale_pairs
    assert all(s_pct <= s_abs + 1e-12 for s_pct, s_abs in scale_pairs)
    assert any(s_pct < 0.9 * s_abs for s_pct, s_abs in scale_pairs), \
        "percentile clipping changed no scale materially"


def test_int8_grouped_conv_refused_on_gpu(monkeypatch, rng):
    """On the GPU the int8 grouped (depthwise) convolution is refused with a
    clear error (XLA:GPU's cuDNN int8 grouped conv returns wrong values);
    ungrouped int8 convs and the CPU grouped path run."""
    from spsvo.models import quantize
    x = jnp.asarray(rng.random((1, 16, 16, 8), np.float32))
    w = jnp.asarray(rng.integers(-127, 128, (3, 3, 1, 8)), jnp.int8)
    ws = jnp.full((8,), 0.01, jnp.float32)
    conv = functools.partial(quantize.int8_conv, strides=(1, 1),
                             padding="SAME", dilations=(1, 1))
    y = conv(x, w, ws, groups=8)                     # CPU: runs
    assert y.shape == (1, 16, 16, 8)
    monkeypatch.setattr(quantize.jax, "default_backend", lambda: "gpu")
    with pytest.raises(NotImplementedError, match="grouped"):
        conv(x, w, ws, groups=8)
    w1 = jnp.asarray(rng.integers(-127, 128, (3, 3, 8, 8)), jnp.int8)
    assert conv(x, w1, ws, groups=1).shape == (1, 16, 16, 8)
