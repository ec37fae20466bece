"""Build + load the native framepack library (g++ -O3, cached .so).

The port's own copy of vr_video_generator_tpu/native/build.py (the port
imports nothing of the JAX package), with one difference: the library is
only ever written whole. g++ writes a temporary file in the same directory,
which ``os.replace`` then moves onto ``libframepack.so``, all under an
``fcntl.flock`` on ``libframepack.so.lock`` beside it. So several processes
(xdist workers, the multi-process runtime) building at once compile once,
and none of them loads a half-written library, which ``native.available()``
would take for "no native library".

The library is built with ``-march=native``, so it belongs to the host that
built it. Beside it, ``libframepack.so.host`` holds that host's CPU model
name and flags (``/proc/cpuinfo``), written after the library, and a
library whose stamp is missing or names another CPU is rebuilt: a checkout
copied to another machine never loads code compiled for the first one.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import platform
import subprocess
import tempfile
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "framepack.cpp")
_SO = os.path.join(_HERE, "libframepack.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def host_stamp() -> str:
    """This host's CPU as ``-march=native`` sees it: the model name and the
    flags of the first processor in ``/proc/cpuinfo`` (the machine and
    processor names where there is none)."""
    keys = {"model name": "", "flags": ""}
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in keys and not keys[key]:
                    keys[key] = " ".join(value.split())
                if all(keys.values()):
                    break
    except OSError:
        pass
    if not any(keys.values()):
        keys = {"machine": platform.machine(),
                "processor": platform.processor()}
    return "".join(f"{k}: {v}\n" for k, v in keys.items())


def _stamp_path() -> str:
    return _SO + ".host"


def _fresh() -> bool:
    if not (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return False
    try:
        with open(_stamp_path(), encoding="utf-8") as f:
            return f.read() == host_stamp()
    except OSError:
        return False


def _write_stamp() -> None:
    """The stamp of this host beside the library, written whole."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_SO),
                               prefix=".libframepack.", suffix=".host")
    with os.fdopen(fd, "w", encoding="utf-8") as f:
        f.write(host_stamp())
    os.replace(tmp, _stamp_path())


def build(force: bool = False) -> str:
    """Compile the shared library if missing, stale or built on another
    host; returns its path."""
    with _lock:
        if not force and _fresh():
            return _SO
        with open(_SO + ".lock", "a") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            # Another process may have built it while this one waited.
            if not force and _fresh():
                return _SO
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_SO),
                                       prefix=".libframepack.", suffix=".tmp")
            os.close(fd)
            try:
                cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                       "-std=c++17", _SRC, "-o", tmp]
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, _SO)
                _write_stamp()
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        return _SO


def load() -> ctypes.CDLL:
    """Load (building on demand) and declare signatures."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
    path = build()
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.read_full.restype = ctypes.c_long
    lib.read_full.argtypes = [ctypes.c_int, u8p, ctypes.c_long]
    lib.write_full.restype = ctypes.c_long
    lib.write_full.argtypes = [ctypes.c_int, u8p, ctypes.c_long]
    lib.bgr_to_rgb.restype = None
    lib.bgr_to_rgb.argtypes = [u8p, u8p, ctypes.c_long]
    lib.pack_batch.restype = None
    lib.pack_batch.argtypes = [ctypes.POINTER(u8p), u8p, ctypes.c_long,
                               ctypes.c_long]
    lib.u32_to_rgb24.restype = None
    lib.u32_to_rgb24.argtypes = [u8p, u8p, ctypes.c_long]
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_long, ctypes.c_long]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    for name in ("ring_acquire_write", "ring_acquire_read"):
        fn = getattr(lib, name)
        fn.restype = u8p
        fn.argtypes = [ctypes.c_void_p]
    for name in ("ring_commit_write", "ring_commit_read"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]
    lib.ring_size.restype = ctypes.c_long
    lib.ring_size.argtypes = [ctypes.c_void_p]
    with _lock:
        _lib = lib
    return lib
