"""Stereo synthesis: cutoff planes, forward warp, hole fill, SBS (batched).

Mirrors vr_video_generator_tpu/ops/warp.py and the u8 path of
ops/warp_pallas.py `warp_batch_pallas`, with every table batched over the
frames (B). The plane and shift tables are plain tensor code on the device
(no host sync); the two per-pixel passes are the kernels:

  * ``warp_composite``: the forward-warp compositor (csrc/warp.cu);
  * ``blur_select_sbs``: Gaussian hole fill, hole select, left-edge copy and
    the [synth | original] concat (csrc/blur_select.cu).

Each has a plain version beside it, taken only for CPU tensors. The traps
the reference relies on are kept: circular wrap (torch.roll), round half to
even (torch.round), the zip truncation (the last cutoff never becomes a
plane), the 3/5 fill index and the 2/3 edge width.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from vr_video_generator_tpu.utils.config import StereoConfig
from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.gaussian import (gaussian_blur,
                                                        gaussian_kernel1d)

COMPOSITE_LAUNCHES = counter("warp_composite")
BLUR_SELECT_LAUNCHES = counter("blur_select_sbs")


class PlaneTables(NamedTuple):
    """Padded per-frame plane tables, (B, P) unless noted."""

    cutoffs: torch.Tensor      # f32 depth thresholds
    steps: torch.Tensor        # f32 cutoff[k+1] - cutoff[k]
    offsets: torch.Tensor      # i32 per-plane pixel shifts
    plane_valid: torch.Tensor  # bool, k < n_full - 1 (zip truncation)
    fill_offset: torch.Tensor  # (B,) i32 offset of the int(n_full*3/5) plane
    edge_width: torch.Tensor   # (B,) i32 round(offsets[n_full-2]*2/3)
    offset_range: torch.Tensor  # (B, 2) f32 clamped (r0, r1)


class ShiftTables(NamedTuple):
    """Plane tables re-indexed by pixel shift s in [-s_neg, s_pos], (B, S)."""

    lo: torch.Tensor     # f32 band lower bounds (thr - 0.05*step)
    hi: torch.Tensor     # f32 band upper bounds (thr + 1.05*step)
    valid: torch.Tensor  # bool, some plane maps to this shift
    fill_offset: torch.Tensor
    edge_width: torch.Tensor


def build_plane_tables(depth: torch.Tensor, offset_range: torch.Tensor,
                       cfg: StereoConfig, height: int,
                       max_planes: int) -> PlaneTables:
    """(B, H, W) depth + (B, 2) smoothed ranges -> padded plane tables;
    ops/warp.py `build_plane_tables` per frame, same f32 arithmetic."""
    step = cfg.offset_step_size
    cap = float(cfg.limit_step_cap)
    b = depth.shape[0]
    k = torch.arange(max_planes, dtype=torch.int32, device=depth.device)[None]
    ls = torch.clamp(torch.ceil(depth.amax(dim=(1, 2))), max=cap)[:, None]
    r0 = torch.clamp(offset_range[:, :1], min=cfg.offset_bg * height * cap / 14.0)
    r1 = torch.clamp(offset_range[:, 1:], max=cfg.offset_fg * height * cap / 14.0)
    round_r0 = torch.round(r0)
    round_r1 = torch.round(r1)

    # len(range(round(r0), 0, step)) and len(range(1, round(r1), step))
    n_neg = torch.clamp(torch.ceil(-round_r0 / step), min=0).to(torch.int32)
    n_pos = torch.clamp(torch.ceil((round_r1 - 1) / step), min=0).to(torch.int32)
    n_full = n_neg + n_pos + 2  # (B, 1)

    i_k = torch.where(k < n_neg, round_r0 + k * step,
                      torch.where(k == n_neg, 0.0,
                                  1.0 + (k - n_neg - 1) * step))
    denom = 1e-5 + r1 - r0
    cutoffs = (i_k - r0) / denom * (1e-5 + ls)
    cutoffs = torch.where(k == n_full - 1, ls, cutoffs)
    cutoffs = torch.where(k == 0, 0.0, cutoffs)
    cutoffs = torch.where(k < n_full, cutoffs, torch.inf)

    steps = torch.diff(cutoffs, dim=1,
                       append=torch.full((b, 1), torch.inf,
                                         device=depth.device))
    offsets = torch.round(cutoffs / (1e-5 + ls) * denom + r0).to(torch.int32)
    offsets = torch.where(k < n_full, offsets, 0)
    plane_valid = k < n_full - 1

    def pick(idx):
        idx = torch.clamp(idx, 0, max_planes - 1).to(torch.int64)
        return offsets.gather(1, idx)[:, 0]

    fill_offset = pick((n_full * 3) // 5)
    edge_width = torch.round(pick(n_full - 2) / 3.0 * 2.0).to(torch.int32)
    return PlaneTables(cutoffs=cutoffs, steps=steps, offsets=offsets,
                       plane_valid=plane_valid, fill_offset=fill_offset,
                       edge_width=edge_width,
                       offset_range=torch.cat([r0, r1], dim=1))


def build_shift_tables(tables: PlaneTables, s_neg: int,
                       s_pos: int) -> ShiftTables:
    """Re-index the plane tables by shift (ops/warp.py `build_shift_tables`):
    planes that round to the same shift merge into [min lo, max hi)."""
    lo_k = tables.cutoffs - 0.05 * tables.steps
    hi_k = tables.cutoffs + 1.05 * tables.steps
    shifts = torch.arange(-s_neg, s_pos + 1, dtype=torch.int32,
                          device=lo_k.device)
    hit = ((tables.offsets[:, None, :] == shifts[None, :, None])
           & tables.plane_valid[:, None, :])  # (B, S, P)
    lo = torch.where(hit, lo_k[:, None, :], torch.inf).amin(dim=2)
    hi = torch.where(hit, hi_k[:, None, :], -torch.inf).amax(dim=2)
    return ShiftTables(lo=lo, hi=hi, valid=hit.any(dim=2),
                       fill_offset=tables.fill_offset,
                       edge_width=tables.edge_width)


def warp_composite_plain(img: torch.Tensor, depth: torch.Tensor,
                         st: ShiftTables, s_neg: int,
                         s_pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, 3) u8 + (B, H, W) depth -> (composite u8, covered bool):
    ops/warp.py `warp_composite_static`, the unrolled ascending-shift loop
    (last write wins), holes from the roll by the fill offset."""
    b, h, w, _ = img.shape
    cols = torch.arange(w, device=img.device)
    src = (cols[None, :] - st.fill_offset[:, None].long()) % w
    composite = torch.gather(img, 2, src[:, None, :, None].expand(b, h, w, 3))
    covered = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    for j, s in enumerate(range(-s_neg, s_pos + 1)):
        d_s = torch.roll(depth, s, dims=2)
        m = (st.valid[:, j, None, None] & (st.lo[:, j, None, None] <= d_s)
             & (d_s < st.hi[:, j, None, None]))
        composite = torch.where(m[..., None], torch.roll(img, s, dims=2),
                                composite)
        covered = covered | m
    return composite, covered


def _require(x: torch.Tensor, dtype, shape, name: str) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")


def warp_composite(img: torch.Tensor, depth: torch.Tensor, st: ShiftTables,
                   s_neg: int, s_pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compositor: plain version for CPU tensors, csrc/warp.cu for CUDA
    tensors."""
    if not on_cuda(img, depth, st.lo):
        return warp_composite_plain(img, depth, st, s_neg, s_pos)
    b, h, w, _ = img.shape
    n_shift = s_neg + s_pos + 1
    _require(img, torch.uint8, (b, h, w, 3), "warp_composite img")
    _require(depth, torch.float32, (b, h, w), "warp_composite depth")
    lo, hi = st.lo.contiguous(), st.hi.contiguous()
    valid = st.valid.contiguous()
    fill = st.fill_offset.to(torch.int32).contiguous()
    _require(lo, torch.float32, (b, n_shift), "warp_composite lo")
    _require(valid, torch.bool, (b, n_shift), "warp_composite valid")
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty_like(img)
    covered = torch.empty((b, h, w), dtype=torch.bool, device=img.device)
    err = library().vrvg_warp_composite(
        img.data_ptr(), depth.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        valid.data_ptr(), fill.data_ptr(), out.data_ptr(), covered.data_ptr(),
        b, h, w, s_neg, n_shift, stream_handle(img.device))
    check(err, "vrvg_warp_composite")
    COMPOSITE_LAUNCHES.count += 1
    return out, covered


def blur_select_sbs_plain(composite: torch.Tensor, covered: torch.Tensor,
                          img: torch.Tensor, edge_width: torch.Tensor,
                          kernel_size: int, sigma: float) -> torch.Tensor:
    """Blur, round, select, edge copy and concat (ops/warp.py `warp_frame`,
    :228-236) -> (B, H, 2W, 3) u8."""
    kx, ky = kernel_size * 2 + 3, kernel_size * 2 + 1
    blurred = torch.clamp(torch.round(gaussian_blur(composite, (kx, ky), sigma)),
                          0, 255).to(torch.uint8)
    result = torch.where(covered[..., None], composite, blurred)
    cols = torch.arange(img.shape[2], device=img.device)
    edge = cols[None, None, :] < edge_width[:, None, None]
    result = torch.where(edge[..., None], img, result)
    return torch.cat([result, img], dim=2)


@functools.lru_cache(maxsize=None)
def _taps(ksize: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(gaussian_kernel1d(ksize, sigma)).to(device)


def blur_select_sbs(composite: torch.Tensor, covered: torch.Tensor,
                    img: torch.Tensor, edge_width: torch.Tensor,
                    kernel_size: int, sigma: float) -> torch.Tensor:
    """Hole fill + SBS: plain version for CPU tensors, csrc/blur_select.cu
    for CUDA tensors."""
    if not on_cuda(composite, covered, img, edge_width):
        return blur_select_sbs_plain(composite, covered, img, edge_width,
                                     kernel_size, sigma)
    b, h, w, _ = img.shape
    kx, ky = kernel_size * 2 + 3, kernel_size * 2 + 1
    if kx // 2 >= w or ky // 2 >= h:
        raise ValueError(f"blur window ({kx}, {ky}) too large for {h}x{w}")
    _require(composite, torch.uint8, (b, h, w, 3), "blur_select_sbs composite")
    _require(img, torch.uint8, (b, h, w, 3), "blur_select_sbs img")
    _require(covered, torch.bool, (b, h, w), "blur_select_sbs covered")
    edge = edge_width.to(torch.int32).contiguous()
    kxw, kyw = _taps(kx, sigma, img.device), _taps(ky, sigma, img.device)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    out = torch.empty((b, h, 2 * w, 3), dtype=torch.uint8, device=img.device)
    err = library().vrvg_blur_select_sbs(
        composite.data_ptr(), covered.data_ptr(), img.data_ptr(),
        edge.data_ptr(), kxw.data_ptr(), kyw.data_ptr(), out.data_ptr(),
        b, h, w, kx, ky, stream_handle(img.device))
    check(err, "vrvg_blur_select_sbs")
    BLUR_SELECT_LAUNCHES.count += 1
    return out


@dataclasses.dataclass(frozen=True)
class WarpSpec:
    """Static warp parameters for a fixed frame geometry."""

    height: int
    width: int
    cfg: StereoConfig
    max_planes: int
    kernel_size: int
    s_neg: int
    s_pos: int

    @staticmethod
    def create(height: int, width: int, cfg: StereoConfig) -> "WarpSpec":
        """ops/warp.py `WarpSpec.create` sizing."""
        cfg = cfg.normalized()
        ks = int(np.round(0.0036 * height))  # round half to even
        step = max(cfg.offset_step_size, 1)
        s_neg = int(np.ceil(-cfg.offset_bg * height * cfg.limit_step_cap
                            / 14.0 / step) * step) + 1
        s_pos = int(np.ceil(cfg.offset_fg * height * cfg.limit_step_cap
                            / 14.0 / step) * step) + 1
        return WarpSpec(height=height, width=width, cfg=cfg,
                        max_planes=cfg.max_planes(height), kernel_size=ks,
                        s_neg=s_neg, s_pos=s_pos)

    def tables(self, depths: torch.Tensor, offset_ranges: torch.Tensor
               ) -> Tuple[PlaneTables, ShiftTables]:
        t = build_plane_tables(depths, offset_ranges, self.cfg, self.height,
                               self.max_planes)
        return t, build_shift_tables(t, self.s_neg, self.s_pos)

    def warp_batch(self, imgs: torch.Tensor, depths: torch.Tensor,
                   offset_ranges: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) u8 + (B, H, W) smoothed depth + (B, 2) ranges ->
        (B, H, 2W, 3) u8 SBS, through the two kernels on CUDA."""
        _, st = self.tables(depths, offset_ranges)
        comp, covered = warp_composite(imgs, depths, st, self.s_neg,
                                       self.s_pos)
        return blur_select_sbs(comp, covered, imgs, st.edge_width,
                               self.kernel_size, self.cfg.sigma)

    def warp_batch_plain(self, imgs: torch.Tensor, depths: torch.Tensor,
                         offset_ranges: torch.Tensor) -> torch.Tensor:
        """warp_batch through the plain versions on any device."""
        _, st = self.tables(depths, offset_ranges)
        comp, covered = warp_composite_plain(imgs, depths, st, self.s_neg,
                                             self.s_pos)
        return blur_select_sbs_plain(comp, covered, imgs, st.edge_width,
                                     self.kernel_size, self.cfg.sigma)
