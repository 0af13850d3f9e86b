"""Bring-up contracts: compile-cache location, the on-card smoke script's
device check, and the cv2-free host twins (texture blur, resize) against
cv2 as an oracle."""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_selection(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: the package sets no cache directory
    (JAX reads the variable itself). Unset: a fixed directory inside the
    checkout that git ignores."""
    import jax

    import spsvo
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert spsvo.compile_cache_dir() is None
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    d = spsvo.compile_cache_dir()
    assert d == os.path.join(REPO, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()
    assert spsvo.local_cache_dir().startswith(REPO + os.sep)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        # what `import spsvo` configured in this process
        assert jax.config.jax_compilation_cache_dir == d


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line when JAX finds
    no GPU — from the checkout, and from a directory holding only the
    script."""
    import shutil
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr


def test_main_path_imports_no_cv2():
    """The modules chip_smoke.py drives, and a rendered + preprocessed
    corridor frame, import nothing beyond JAX, numpy and scipy (no cv2, no
    optax)."""
    code = (
        "import sys, numpy as np\n"
        "import chip_smoke, spsvo\n"
        "from spsvo import presets\n"
        "from spsvo.pipeline import VisualOdometry\n"
        "from spsvo.parallel.sharding import build_online_hybrid, "
        "prepare_pairs, make_mesh\n"
        "from spsvo.ops import solver_pallas\n"
        "from spsvo.eval.synthetic import synthetic_corridor, "
        "score_trajectory\n"
        "from spsvo.ops.image import preprocess_image_np\n"
        "f, gt, P_l, P_r = synthetic_corridor(np.random.default_rng(0), "
        "n_frames=2, h=64, w=200, tex_px=256)\n"
        "preprocess_image_np(f[0][0], 16, 48)\n"
        "bad = sorted(m for m in ('cv2', 'optax', 'torch', 'triton') "
        "if m in sys.modules)\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "BAD []" in proc.stdout, proc.stdout


@pytest.mark.parametrize("dtype,sigma", [(np.float32, 6.0), (np.uint8, 1.0),
                                         (np.float32, 1.5)])
def test_gaussian_blur_matches_cv2(rng, dtype, sigma):
    """cv2.GaussianBlur's kernel size and BORDER_REFLECT_101 borders: float
    input to fp32 rounding, 8-bit input bit for bit (cv2's fixed-point
    path)."""
    from spsvo.eval.synthetic import gaussian_blur
    img = rng.random((150, 230)).astype(np.float32)
    if dtype == np.uint8:
        img = (img > 0.5).astype(np.uint8) * 200 + 30
    ours = gaussian_blur(img, sigma)
    ref = cv2.GaussianBlur(img, (0, 0), sigma)
    assert ours.dtype == ref.dtype
    if dtype == np.uint8:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_blob_texture_matches_cv2_recipe(rng):
    """The texture follows the cv2 recipe: the same draws give the same
    texture except where the blurred noise sits at its median (threshold
    flips of fp32 rounding, a few pixels in a million)."""
    from spsvo.eval.synthetic import blob_texture
    seed = int(rng.integers(1 << 30))
    ours = blob_texture(np.random.default_rng(seed), 300, 500)
    r = np.random.default_rng(seed)
    noise = cv2.GaussianBlur(r.random((300, 500)).astype(np.float32),
                             (0, 0), 6.0)
    tex = (noise > np.median(noise)).astype(np.uint8) * 200 + 30
    ref = cv2.GaussianBlur(tex, (0, 0), 1.0)
    assert (ours != ref).mean() < 1e-3, (ours != ref).mean()


@pytest.mark.parametrize("src,dst", [((375, 1242), (120, 392)),
                                     ((240, 320), (240, 784)),
                                     ((100, 300), (48, 160))])
def test_preprocess_np_matches_cv2_resize(rng, src, dst):
    """preprocess_image_np's numpy bilinear resize follows cv2.INTER_LINEAR
    (half-pixel centres): within one grey level of cv2's uint8 output
    (cv2 rounds to uint8 and uses 11-bit fixed-point weights), and equal
    to the device resize."""
    import jax.numpy as jnp

    from spsvo.ops.image import (crop_geometry, preprocess_image,
                                 preprocess_image_np)
    img = (rng.random(src) * 255).astype(np.uint8)
    ours = preprocess_image_np(img, *dst, normalize=False)
    r0, c0, h, w = crop_geometry(*src, *dst)
    ref = cv2.resize(img[r0:r0 + h, c0:c0 + w], (dst[1], dst[0]),
                     interpolation=cv2.INTER_LINEAR).astype(np.float32)
    assert ours.shape == dst and ours.dtype == np.float32
    assert np.abs(ours - ref).max() <= 1.0
    dev = np.asarray(preprocess_image(jnp.asarray(img), *dst,
                                      normalize=False))
    np.testing.assert_allclose(ours, dev, atol=1e-3)
