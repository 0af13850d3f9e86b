"""Native C++ loader vs Python preprocessing parity + ordering."""
import os

import numpy as np
import pytest

from spsvo.io.loader import (NativeStereoLoader, PythonStereoLoader,
                                 make_loader)
from spsvo.ops.image import preprocess_image_np


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    import cv2
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        img = (rng.random((375, 1242)) * 255).astype(np.uint8)
        p = str(d / f"{i:06d}.png")
        cv2.imwrite(p, img)
        paths.append(p)
    return paths


def test_native_loader_matches_python_preprocess(png_dir):
    import cv2
    try:
        loader = NativeStereoLoader(png_dir, png_dir, 120, 392,
                                    num_threads=3)
    except RuntimeError:
        pytest.skip("native toolchain unavailable")
    seen = []
    for idx, frames in loader:
        seen.append(idx)
        assert frames.shape == (2, 120, 392)
        img = cv2.imread(png_dir[idx], cv2.IMREAD_GRAYSCALE)
        ref = preprocess_image_np(img, 120, 392)
        np.testing.assert_allclose(frames[0], ref, atol=1e-5)
        np.testing.assert_allclose(frames[1], ref, atol=1e-5)
    assert seen == list(range(6))  # strict ordering


def test_python_loader_ordering(png_dir):
    loader = PythonStereoLoader(png_dir, png_dir, 120, 392)
    seen = [idx for idx, _ in loader]
    assert seen == list(range(6))


def test_make_loader_returns_working_loader(png_dir):
    loader = make_loader(png_dir[:2], png_dir[:2], 48, 160)
    out = list(loader)
    assert len(out) == 2
    assert out[0][1].dtype == np.float32


def test_native_loader_stress_small_ring(png_dir):
    """Hammer the check-then-block windows the round-1 race lived in: a
    2-slot ring with more workers than slots, many sequential drains — a
    missed wakeup deadlocks the final in-flight frame."""
    import concurrent.futures

    paths = png_dir * 5  # 30 frames through a 2-slot ring
    try:
        NativeStereoLoader(png_dir[:1], png_dir[:1], 24, 80)
    except RuntimeError:
        pytest.skip("native toolchain unavailable")

    def drain(seed):
        loader = NativeStereoLoader(paths, paths, 24, 80,
                                    queue_capacity=2, num_threads=4)
        return [idx for idx, _ in loader]

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(drain, i) for i in range(8)]
        for f in futs:
            assert f.result(timeout=60) == list(range(len(paths)))
