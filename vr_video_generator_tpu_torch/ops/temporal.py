"""Temporal depth state: EWMA depth dampening + offset-range smoothing.

Mirrors vr_video_generator_tpu/ops/temporal.py (`TemporalState`,
`temporal_scan`) at depth_stride 1. Everything stays on the device with no
host sync: the 3-tap blend over RAW depth maps is one batched expression,
and the sequential 50/50 offset-range EWMA is a Python loop over the batch
of (2,)-element device ops.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from vr_video_generator_tpu_torch.ops.warp import WarpSpec


class TemporalState(NamedTuple):
    """Carry across frames and batches."""

    d_prev1: torch.Tensor       # (H, W) raw depth of frame t-1
    d_prev2: torch.Tensor       # (H, W) raw depth of frame t-2
    offset_range: torch.Tensor  # (2,) smoothed (r0, r1)
    has_state: torch.Tensor     # () bool, False only before the first frame
    overflow: torch.Tensor      # () i32 frames whose depth exceeded the cap

    @staticmethod
    def initial(height: int, width: int,
                device: torch.device | str = "cpu") -> "TemporalState":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return TemporalState(d_prev1=zeros(height, width),
                             d_prev2=zeros(height, width),
                             offset_range=zeros(2),
                             has_state=zeros(dtype=torch.bool),
                             overflow=zeros(dtype=torch.int32))


def temporal_scan(raw_depths: torch.Tensor, state: TemporalState,
                  spec: WarpSpec, n_valid: Optional[int] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, TemporalState]:
    """(B, H, W) raw depths -> (smoothed depths, (B, 2) offset ranges,
    state'). ``n_valid``: how many leading frames are real; only those count
    toward the overflow tally (None counts every frame)."""
    w0, w1, w2 = spec.cfg.dampening_weights
    b = raw_depths.shape[0]

    # Depth-cap guard: saturate at the cap the static tables are sized for
    # and count the affected frames.
    cap = float(spec.cfg.limit_step_cap)
    over_f = (raw_depths > cap).flatten(1).any(dim=1)
    if n_valid is not None:
        over_f = over_f & (torch.arange(b, device=raw_depths.device) < n_valid)
    over = over_f.sum().to(torch.int32)
    raw_depths = torch.clamp(raw_depths, max=cap)

    d1 = torch.where(state.has_state, state.d_prev1, raw_depths[0])
    d2 = torch.where(state.has_state, state.d_prev2, raw_depths[0])
    ext = torch.cat([d2[None], d1[None], raw_depths], dim=0)
    blended = w0 * ext[2:] + w1 * ext[1:-1] + w2 * ext[:-2]

    ls = torch.ceil(blended.amax(dim=(1, 2)))  # (B,)
    # f32 scalars, not a tensor built from host data: that copy would make
    # the host wait for the device mid-step.
    s_bg, s_fg = (float(np.float32(o * spec.height / 14.0))
                  for o in (spec.cfg.offset_bg, spec.cfg.offset_fg))
    r_raw = torch.stack([ls * s_bg, ls * s_fg], dim=1)

    r, has = state.offset_range, state.has_state
    ranges = []
    for t in range(b):
        r = torch.where(has, 0.5 * (r + r_raw[t]), r_raw[t])
        has = torch.ones_like(has)
        ranges.append(r)

    new_state = TemporalState(d_prev1=ext[-1], d_prev2=ext[-2],
                              offset_range=r,
                              has_state=torch.ones_like(state.has_state),
                              overflow=state.overflow + over)
    return blended, torch.stack(ranges), new_state
