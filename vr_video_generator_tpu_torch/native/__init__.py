"""Native host-I/O tier (C++ via ctypes): channel swizzle, packed-SBS
unpack and full-buffer pipe reads/writes for the video reader and writer.

A copy of vr_video_generator_tpu/native (the port imports nothing of the
JAX package), cut to what ``video/reader.py`` and ``video/writer.py`` call.
Python-facing wrappers around native/framepack.cpp. Degrades gracefully:
``available()`` is False when no C++ toolchain exists, and callers fall back
to numpy paths.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Optional

import numpy as np


def available() -> bool:
    try:
        from vr_video_generator_tpu_torch.native.build import load

        load()
        return True
    except Exception:
        return False


def _as_u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def bgr_to_rgb(src: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Channel swizzle of a (..., 3) uint8 array (native, GIL-free)."""
    from vr_video_generator_tpu_torch.native.build import load

    lib = load()
    src = np.ascontiguousarray(src, np.uint8)
    if out is None:
        out = np.empty_like(src)
    lib.bgr_to_rgb(_as_u8p(src), _as_u8p(out), src.size // 3)
    return out


def unpack_sbs(src: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Packed-uint32 SBS (..., W) (r|g<<8|b<<16) -> rgb24 uint8 (..., W, 3).

    Host half of the device's packed SBS output (ops/warp_pallas
    blur_select_sbs_pallas); auto-vectorized byte strip, GIL-free.
    """
    from vr_video_generator_tpu_torch.native.build import load

    assert sys.byteorder == "little", "packed-SBS unpack requires little-endian"
    lib = load()
    src = np.ascontiguousarray(src, np.uint32)
    if out is None:
        out = np.empty((*src.shape, 3), np.uint8)
    lib.u32_to_rgb24(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     _as_u8p(out), src.size)
    return out


def unpack_sbs_np(src: np.ndarray) -> np.ndarray:
    """Numpy fallback of unpack_sbs (no native library needed)."""
    # The r|g<<8|b<<16 word -> [r,g,b,x] byte map (here and in the C++
    # u32_to_rgb24 strip) assumes a little-endian host.
    assert sys.byteorder == "little", "packed-SBS unpack requires little-endian"
    src = np.ascontiguousarray(src, np.uint32)
    return src.view(np.uint8).reshape(*src.shape, 4)[..., :3]


def read_full(fd: int, buf: np.ndarray) -> int:
    """Blocking full read into a preallocated uint8 buffer; returns bytes."""
    from vr_video_generator_tpu_torch.native.build import load

    return load().read_full(fd, _as_u8p(buf), buf.nbytes)


def write_full(fd: int, buf: np.ndarray) -> int:
    from vr_video_generator_tpu_torch.native.build import load

    buf = np.ascontiguousarray(buf, np.uint8)
    return load().write_full(fd, _as_u8p(buf), buf.nbytes)
