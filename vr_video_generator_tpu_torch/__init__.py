"""vr_video_generator_tpu_torch: the PyTorch/CUDA port of vr_video_generator_tpu.

The 2D -> side-by-side 3D video converter (Depth-Anything-V2 depth, temporal
smoothing, depth-plane stereo warp) on one NVIDIA H100. The JAX package
``vr_video_generator_tpu`` stays the reference; this package imports
nothing of it. It keeps its own copies of the JAX package's jax-free host
modules (``utils/``, ``video/``, ``native/``, the CLI parser) and
reimplements the device path in PyTorch, with hand-written Hopper kernels
under ``csrc/`` (CUDA C++).
"""

from __future__ import annotations

from typing import NoReturn

from vr_video_generator_tpu_torch.utils.config import RunConfig, StereoConfig

__all__ = ["RunConfig", "StereoConfig", "not_ported"]


def not_ported(what: str, roadmap_item: str) -> NoReturn:
    """Raise for an option or entry point the port does not have yet."""
    raise NotImplementedError(
        f"{what} is not ported to vr_video_generator_tpu_torch yet "
        f"(ROADMAP.md, modules still to port: {roadmap_item})")
