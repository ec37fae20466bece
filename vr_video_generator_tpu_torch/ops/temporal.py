"""Temporal depth state: EWMA depth dampening + offset-range smoothing.

Mirrors vr_video_generator_tpu/ops/temporal.py (`TemporalState`,
`temporal_scan`, and the depth stride's `stride_interpolate` and
`stride_audit_stats`). Everything stays on the device with no host sync:
the 3-tap blend over RAW depth maps is one batched expression, and the
sequential 50/50 offset-range EWMA is a Python loop over the batch of
(2,)-element device ops.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

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
    # (H, W) raw depth of the last stride anchor; None unless depth_stride > 1
    anchor_prev: Optional[torch.Tensor] = None

    @staticmethod
    def initial(height: int, width: int, device: torch.device | str = "cpu",
                depth_stride: int = 1) -> "TemporalState":
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return TemporalState(d_prev1=zeros(height, width),
                             d_prev2=zeros(height, width),
                             offset_range=zeros(2),
                             has_state=zeros(dtype=torch.bool),
                             overflow=zeros(dtype=torch.int32),
                             anchor_prev=(zeros(height, width)
                                          if depth_stride > 1 else None))

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "TemporalState":
        """The state with ``fn`` applied to each tensor (``anchor_prev``
        stays None at depth_stride 1)."""
        return TemporalState(*(None if t is None else fn(t) for t in self))


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
                              overflow=state.overflow + over,
                              # passed through; the stride path replaces it
                              # with the batch's last anchor afterwards
                              anchor_prev=state.anchor_prev)
    return blended, torch.stack(ranges), new_state


def stride_interpolate(anchors: torch.Tensor, state: TemporalState,
                       stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth-stride expansion: (G, H, W) anchor depths -> (G*stride, H, W)
    raw depths, and the last anchor for the next carry.

    The depth net runs on the LAST frame of each stride group only. Group
    g's frame j gets ``lerp(anchor_{g-1}, anchor_g, (j+1)/stride)``, where
    anchor_{-1} is the carried ``state.anchor_prev``, or on a cold start the
    first anchor itself (group 0 holds anchor 0). Anchor frames (weight
    exactly 1) get their depth bit for bit. The anchors are not clamped
    (temporal_scan clamps what it blends, after this)."""
    g = anchors.shape[0]
    prev0 = torch.where(state.has_state, state.anchor_prev, anchors[0])
    prev = torch.cat([prev0[None], anchors[:-1]], dim=0)
    w = torch.arange(1, stride + 1, dtype=torch.float32,
                     device=anchors.device) / stride
    w = w[None, :, None, None]
    depths = prev[:, None] * (1.0 - w) + anchors[:, None] * w
    return depths.reshape(g * stride, *anchors.shape[1:]), anchors[-1]


def stride_audit_stats(true_depths: torch.Tensor, state: TemporalState,
                       stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) TRUE raw depths -> (rms, max) device scalars: what the
    stride path would interpolate for this batch (its anchors and the
    carried ``anchor_prev``) minus the true depth, over the batch's
    non-anchor frames (anchor frames are exact). Scaled raw-depth units."""
    interp, _ = stride_interpolate(true_depths[stride - 1::stride], state,
                                   stride)
    err = interp - true_depths
    nonanchor = (torch.arange(err.shape[0], device=err.device)
                 % stride) != (stride - 1)
    sq = (err * err).mean(dim=(1, 2))  # (B,)
    rms = torch.sqrt(torch.where(nonanchor, sq, 0.0).sum()
                     / nonanchor.sum().clamp(min=1))
    mx = torch.where(nonanchor[:, None, None], err.abs(), 0.0).amax()
    return rms, mx
