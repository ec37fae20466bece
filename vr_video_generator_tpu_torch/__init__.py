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

from vr_video_generator_tpu_torch.utils.config import RunConfig, StereoConfig
from vr_video_generator_tpu_torch.version import __version__

__all__ = ["RunConfig", "StereoConfig", "__version__"]
