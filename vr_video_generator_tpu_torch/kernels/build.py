"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

At first use, every ``csrc/*.cu`` file is compiled for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` per source, all
started together, and the objects are linked into one shared library with a
plain C interface under ``_build/``, named by a hash of the sources and
flags, and loaded with ``ctypes``. No PyTorch header is compiled, so a build
takes seconds. Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32 bits).
SIGNATURES = {
    "vrvg_attention": [_P, _P, _P, _P, _I, _I, _I,
                       _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    "vrvg_flash_attention": [_P, _P, _P, _P, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    "vrvg_warp_composite": [_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P],
    "vrvg_warp_composite_banded": [_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _P],
    "vrvg_blur_select_sbs": [_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _P],
    "vrvg_ln_qkv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "vrvg_proj_ls_residual": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "vrvg_mlp_residual": [_P] * 11 + [_I, _I, _I, _F, _I, _P],
    "vrvg_mlp_residual_hblocked": [_P] * 11 + [_I, _I, _I, _F, _I, _P],
    "vrvg_gelu_tanh": [_P, _P, _I, _P],
    "vrvg_layernorm": [_P, _P, _P, _P, _I, _I, _F, _P],
    "vrvg_swiglu_residual": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _F, _P],
    "vrvg_silu_mul": [_P, _P, _P, _I, _P],
    "vrvg_head_tail_ext": [_P, _L, _L, _L, _L, _I, _I, _I, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "vrvg_head_tail": [_P, _I] + [_P] * 12 + [_I] * 8 + [_P],
    "vrvg_rcu_conv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _P],
    "vrvg_head_tail_big_front": [_P, _I] + [_P] * 6 + [_I] * 6 + [_P],
    "vrvg_head_tail_big_back": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _P],
    "vrvg_head_tail_ext_front": [_P, _I] + [_P] * 10 + [_I] * 6 + [_P],
    # The f32 variants (--compute_dtype float32).
    "vrvg_layernorm_f32": [_P, _P, _P, _P, _I, _I, _F, _P],
    "vrvg_qkv_f32": [_P, _P, _P, _P, _I, _I, _F, _P],
    "vrvg_ln_qkv_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "vrvg_proj_ls_residual_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # The f32 attention entries take the wrapper's scratch before the stream.
    "vrvg_attention_f32": [_P, _P, _P, _P, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _L, _L, _F, _P, _P],
    "vrvg_flash_attention_f32": [_P, _P, _P, _P, _I, _I, _I,
                                 _L, _L, _L, _L, _L, _L, _L, _L, _F, _P, _P],
    "vrvg_head_tail_ext_f32": [_P, _I] + [_P] * 18 + [_I] * 8 + [_P],
    "vrvg_head_tail_big_f32": [_P, _I] + [_P] * 15 + [_I] * 8 + [_P],
    "vrvg_conv3x3_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vrvg_tf32x3_split": [_P, _P, _I, _I, _I, _P],
    "vrvg_fc1_gelu_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vrvg_mlp_residual_f32": [_P] * 11 + [_I, _I, _I, _F, _I, _P],
    "vrvg_mlp_residual_hblocked_f32": [_P] * 11 + [_I, _I, _I, _F, _I, _P],
    "vrvg_swiglu_gate_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "vrvg_swiglu_residual_f32": [_P] * 11 + [_I, _I, _I, _F, _P],
    "vrvg_head_tail_f32": [_P, _I] + [_P] * 12 + [_I] * 8 + [_P],
    "vrvg_rcu_conv_f32": [_P] * 8 + [_I] * 6 + [_P],
    # Rows 2 and 17 at any head dim but 64, bf16 or f32 (kernel 1:
    # csrc/attention_any.cu, csrc/attention_any_f32.cu), with its pass's
    # scratch before the stream; the passes alone (csrc/attention_any_pass.cu).
    "vrvg_attention_any": [_P, _P, _P, _P, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _I, _P,
                           _P],
    "vrvg_attention_any_pad": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _P],
    "vrvg_attention_any_split": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _L, _L, _L, _L, _L, _L, _P],
}


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvrvg_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the CUDA sources unless this exact build exists; returns the
    library path. ``verbose`` adds ``-Xptxas -v`` (registers, shared memory,
    spills) and prints nvcc's output."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = os.path.join(tmp, src.stem + ".o")
            procs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, proc in procs:
            text = proc.communicate()[0]
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{text}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
                               *(obj for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        if verbose:
            print("\n".join(logs))
        os.replace(lib, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vrvg_error_string.argtypes = [ctypes.c_int]
    lib.vrvg_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        text = library().vrvg_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text})")
