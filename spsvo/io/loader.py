"""Async stereo frame loading: native C++ prefetch pipeline + Python fallback.

The native loader (spsvo/native/loader.cpp) decodes + preprocesses stereo
PNG pairs with a worker pool into an order-preserving ring buffer — the
double-buffered device feed the device design calls for, replacing the
reference's rosbag-player/pub-sub data pump. Built on demand with g++
(OpenCV imgcodecs/imgproc); a threaded Python fallback keeps everything
working where no toolchain exists.
"""

from __future__ import annotations

import ctypes
import os
import queue
import subprocess
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from spsvo import local_cache_dir

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SRC = os.path.abspath(os.path.join(_NATIVE_DIR, "loader.cpp"))


def _build_native(force: bool = False) -> Optional[str]:
    """Compile the shared library if needed. Returns the .so path or None."""
    so_path = os.path.join(
        os.environ.get("SPSVO_NATIVE_DIR", local_cache_dir()),
        "libspsvo_loader.so")
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    if os.path.exists(so_path) and not force and (
            os.path.getmtime(so_path) >= os.path.getmtime(_SRC)):
        return so_path
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-I/usr/include/opencv4",
           "-lopencv_imgcodecs", "-lopencv_imgproc", "-lopencv_core",
           "-lpthread", "-o", so_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        return so_path
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        msg = getattr(e, "stderr", b"")
        if isinstance(msg, bytes):
            msg = msg.decode(errors="replace")
        import warnings
        warnings.warn(f"native loader build failed, using Python fallback: "
                      f"{msg[:400]}")
        return None


class NativeStereoLoader:
    """Order-preserving prefetching iterator over stereo PNG pairs.

    Yields (frame_idx, frames (2, H, W) float32 in [0, 1]).
    """

    def __init__(self, left_paths: List[str], right_paths: List[str],
                 dst_h: int, dst_w: int, queue_capacity: int = 8,
                 num_threads: int = 4, normalize: bool = True):
        assert len(left_paths) == len(right_paths)
        so = _build_native()
        if so is None:
            raise RuntimeError("native loader unavailable")
        self._lib = ctypes.CDLL(so)
        self._lib.spsvo_loader_create.restype = ctypes.c_void_p
        self._lib.spsvo_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        self._lib.spsvo_loader_next.restype = ctypes.c_int64
        self._lib.spsvo_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
        self._lib.spsvo_loader_destroy.argtypes = [ctypes.c_void_p]

        n = len(left_paths)
        lp = (ctypes.c_char_p * n)(*[p.encode() for p in left_paths])
        rp = (ctypes.c_char_p * n)(*[p.encode() for p in right_paths])
        self._handle = self._lib.spsvo_loader_create(
            lp, rp, n, dst_h, dst_w, queue_capacity, num_threads,
            1 if normalize else 0)
        self._shape = (2, dst_h, dst_w)
        self._n = n
        self._closed = False

    def __iter__(self) -> Iterator[Tuple[int, np.ndarray]]:
        buf = np.empty(self._shape, np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        for _ in range(self._n):
            idx = self._lib.spsvo_loader_next(self._handle, ptr)
            if idx < 0:
                break
            yield int(idx), buf.copy()
        self.close()

    def close(self) -> None:
        if not self._closed:
            self._lib.spsvo_loader_destroy(self._handle)
            self._closed = True

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PythonStereoLoader:
    """Threaded fallback with identical semantics (cv2 decode on workers)."""

    def __init__(self, left_paths: List[str], right_paths: List[str],
                 dst_h: int, dst_w: int, queue_capacity: int = 8,
                 num_threads: int = 2, normalize: bool = True):
        from spsvo.ops.image import preprocess_image_np
        self._paths = list(zip(left_paths, right_paths))
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_capacity)
        self._dst = (dst_h, dst_w)
        self._normalize = normalize
        self._pre = preprocess_image_np

        def produce():
            import cv2
            for i, (lp, rp) in enumerate(self._paths):
                il = cv2.imread(lp, cv2.IMREAD_GRAYSCALE)
                ir = cv2.imread(rp, cv2.IMREAD_GRAYSCALE)
                frames = np.stack([
                    self._pre(il, *self._dst, self._normalize),
                    self._pre(ir, *self._dst, self._normalize)])
                self._q.put((i, frames))
            self._q.put(None)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item

    def close(self) -> None:
        pass


def make_loader(left_paths: List[str], right_paths: List[str], dst_h: int,
                dst_w: int, **kw):
    """Best available loader: native if the toolchain builds it, else Python."""
    try:
        return NativeStereoLoader(left_paths, right_paths, dst_h, dst_w, **kw)
    except Exception:
        return PythonStereoLoader(left_paths, right_paths, dst_h, dst_w, **kw)
