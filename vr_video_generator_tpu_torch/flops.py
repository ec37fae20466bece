"""Counted FLOPs and bytes a frame for each pipeline stage, per bench config.

The counterpart of scripts/flops.py, for the port's ``bench`` configs
(``bench.CONFIGS``). It runs four stages at the config's geometry in f32,
on seeded random weights, on CPU tensors (where every stage takes its plain
path, whose products PyTorch sees; the card's kernels would hide them),
one frame at a time (counts are linear in the batch):

  * preprocess: ``preprocess_frames`` of the u8 frame to the net size;
  * full_net: ``DepthAnythingV2.forward``;
  * encoder: the DINOv2 trunk with the config's intermediate layers;
  * bicubic_up: ``resize_bicubic`` of the depth to the frame size.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
products, convolutions and attention (2 M N K a product) and nothing
elementwise; XLA's count (the JAX script's) also counts elementwise work,
so this count is the smaller. A convolution counts only the taps that fall
inside its input (``conv_flop``), as XLA's does: a tap on the zero padding
is no work. Bytes are the sum of every ATen op's input and output bytes
(views excluded), an unfused upper bound: XLA's "bytes accessed" is counted
after fusion. Run:

    python3 -m vr_video_generator_tpu_torch.flops --config 2
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from vr_video_generator_tpu_torch.bench import CONFIGS, SEED


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every ATen op's tensor inputs and outputs; a view
    moves nothing and is not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _pairs(n_from: int, n_to: int, k: int, stride: int, pad: int,
           dil: int) -> int:
    """The (position, tap) pairs of one spatial dimension whose index
    i * stride - pad + tap * dil lands in [0, n_to), i over n_from."""
    idx = (np.arange(n_from)[:, None] * stride - pad
           + np.arange(k)[None, :] * dil)
    return int(((idx >= 0) & (idx < n_to)).sum())


def conv_flop(x_shape, w_shape, _bias, stride, padding, dilation,
              transposed, _output_padding, groups, out_shape=None,
              **_kwargs) -> int:
    """2 x the multiply-adds of ``aten.convolution`` whose input index falls
    inside the input (a transposed conv: whose output index falls inside
    the output)."""
    n, c_in = x_shape[0], x_shape[1]
    c_out = out_shape[1]
    macs = n * c_in * c_out // groups
    for d, k in enumerate(w_shape[2:]):
        n_in, n_out = x_shape[2 + d], out_shape[2 + d]
        macs *= (_pairs(n_in, n_out, k, stride[d], padding[d], dilation[d])
                 if transposed else
                 _pairs(n_out, n_in, k, stride[d], padding[d], dilation[d]))
    return 2 * macs


def count(fn: Callable, *args) -> Tuple[int, int]:
    """(FLOPs, unfused bytes) of one call of ``fn(*args)`` on CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution: conv_flop})
    moved = ByteCounter()
    with torch.inference_mode(), flops, moved:
        fn(*args)
    return flops.get_total_flops(), moved.bytes


def stage_counts(cfg, h: int, w: int, input_size: int = 518,
                 seed: int = SEED) -> List[Tuple[str, int, int]]:
    """[(stage, FLOPs, bytes)] of one (h, w) frame through the four stages
    at ModelConfig ``cfg`` and ``input_size``, f32, on the CPU."""
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.ops.preprocess import (
        network_input_size, preprocess_frames)
    from vr_video_generator_tpu_torch.ops.resize import resize_bicubic

    hn, wn = network_input_size(h, w, target=input_size,
                                multiple_of=cfg.patch_size)
    rng = np.random.default_rng(seed)
    model = build_model(cfg, random_state_dict(cfg, seed), torch.float32,
                        "cpu")
    frame = torch.from_numpy(rng.integers(0, 256, (1, h, w, 3),
                                          dtype=np.uint8))
    x = torch.from_numpy(rng.standard_normal((1, hn, wn, 3),
                                             dtype=np.float32))
    depth = torch.from_numpy(rng.random((1, hn, wn), dtype=np.float32))
    stages = [
        ("preprocess", lambda f: preprocess_frames(f, (hn, wn)), frame),
        ("full_net", model, x),
        ("encoder", lambda t: model.pretrained(t, cfg.intermediate_layers),
         x),
        ("bicubic_up", lambda d: resize_bicubic(d, (h, w), align_corners=True,
                                                h_axis=1, w_axis=2), depth)]
    return [(name, *count(fn, arg)) for name, fn, arg in stages]


def report(config: int) -> List[str]:
    """The output lines of ``--config``: a header and one line a stage."""
    from vr_video_generator_tpu_torch.ops.preprocess import network_input_size
    from vr_video_generator_tpu_torch.utils.config import ModelConfig

    encoder, h, w, b, _step = CONFIGS[config]
    cfg = ModelConfig.for_encoder(encoder)
    hn, wn = network_input_size(h, w, multiple_of=cfg.patch_size)
    lines = [f"config {config}: {encoder} {w}x{h} b={b} net {wn}x{hn}"]
    for name, fl, by in stage_counts(cfg, h, w):
        lines.append(f"{name:12s}: {fl / 1e9:9.2f} GFLOP/frame, "
                     f"{by / 2**20:9.1f} MiB unfused/frame")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, default=2, choices=sorted(CONFIGS))
    for line in report(ap.parse_args(argv).config):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
