"""Stereo synthesis: cutoff planes, forward warp, hole fill, SBS (batched).

Mirrors vr_video_generator_tpu/ops/warp.py and ops/warp_pallas.py
`warp_batch_pallas` (both emits), with every table batched over the frames
(B). The plane and shift tables are plain tensor code on the device (no host
sync); the two per-pixel passes are the kernels:

  * ``warp_composite``: the forward-warp compositor (csrc/warp.cu), the
    classic kernel or, with ``banded=True``, the banded one (the TPU's code
    byte per source pixel: each pixel claims at most two shifts);
  * ``blur_select_sbs``: Gaussian hole fill, hole select, left-edge copy and
    the [synth | original] concat (csrc/blur_select.cu), emitting u8 HWC
    frames or packed uint32 words r | g<<8 | b<<16 (``emit="packed"``).

Each has a plain version beside it, taken only for CPU tensors. The traps
the reference relies on are kept: circular wrap (torch.roll), round half to
even (torch.round), the zip truncation (the last cutoff never becomes a
plane), the 3/5 fill index, the 2/3 edge width and the banded compositor's
unmatched sentinel (254, not 127).

``WarpSpec.impl`` follows the JAX package's ``warp_impl``: "pallas" takes
the kernel routes (their plain versions for CPU tensors), "xla" the plain
composite and blur/select on any device, "scan" the reference-shaped
composite (a loop over the planes, far to near, then one gather; ops/warp.py
`select_warp_offsets`) in plain PyTorch on any device with the same
blur/select; "auto" is "pallas" on CUDA and "xla" elsewhere.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from vr_video_generator_tpu_torch.utils.config import StereoConfig
from vr_video_generator_tpu_torch.kernels import counter, on_cuda, stream_handle
from vr_video_generator_tpu_torch.ops.gaussian import (gaussian_blur,
                                                        gaussian_kernel1d)

COMPOSITE_LAUNCHES = counter("warp_composite")
BANDED_LAUNCHES = counter("warp_composite_banded")
BLUR_SELECT_LAUNCHES = counter("blur_select_sbs")
PACKED_LAUNCHES = counter("blur_select_sbs_packed")
WARP_IMPLS = ("auto", "xla", "pallas", "scan")
EMITS = ("u8", "packed")
# The banded compositor's code byte: bits 0-6 the rank (among valid shifts)
# of the first band a source pixel's depth falls in, bit 7 set when it also
# falls in the next one; UNMATCHED for none. Ranks occupy [0, 125] and the
# compares bj + 127 / bj + 128 [127, 253], so 254 is the first value a
# pixel in no band can hold without the rank-0 shift claiming it.
UNMATCHED = 254
# Depth bins of the compositor's per-frame candidate table (csrc/warp.cu
# NB): each bin lists the valid shifts whose band can hold its depths.
WARP_BINS = 512
# The largest blur kernel_size (round(0.0036 H)) csrc/blur_select.cu is
# built for: 4320p.
BLUR_KS_MAX = 16


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


def select_warp_offsets(depth: torch.Tensor, tables: PlaneTables
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each output pixel's winning plane offset and its coverage, (B, H, W)
    int32 and bool: ops/warp.py `select_warp_offsets`, the reference's loop
    over the planes far to near (ascending cutoff). Plane k claims (y, x)
    where the source pixel (y, x - off_k), taken circularly, has depth in
    [thr - 0.05 step, thr + 1.05 step) and the plane is valid (the zip
    truncation); a nearer plane overwrites. Holes keep the 3/5 fill
    offset."""
    b, h, w = depth.shape
    cols = torch.arange(w, device=depth.device)
    lo = tables.cutoffs - 0.05 * tables.steps
    hi = tables.cutoffs + 1.05 * tables.steps
    sel_off = tables.fill_offset.to(torch.int32)[:, None, None].expand(
        b, h, w).clone()
    covered = torch.zeros((b, h, w), dtype=torch.bool, device=depth.device)
    for k in range(tables.offsets.shape[1]):
        off = tables.offsets[:, k]
        src = (cols[None, :] - off[:, None].long()) % w  # roll by off_k
        d_src = torch.gather(depth, 2, src[:, None, :].expand(b, h, w))
        m = ((d_src >= lo[:, k, None, None]) & (d_src < hi[:, k, None, None])
             & tables.plane_valid[:, k, None, None])
        sel_off = torch.where(m, off[:, None, None], sel_off)
        covered = covered | m
    return sel_off, covered


def warp_composite_scan(img: torch.Tensor, depth: torch.Tensor,
                        tables: PlaneTables
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``scan`` composite (ops/warp.py `warp_frame`, impl "scan"):
    img[y, (x - sel_off) mod W] at the offsets :func:`select_warp_offsets`
    picks, with its coverage."""
    b, h, w, _ = img.shape
    sel_off, covered = select_warp_offsets(depth, tables)
    cols = torch.arange(w, device=img.device)
    src = (cols - sel_off.long()) % w
    return torch.gather(img, 2, src[..., None].expand(b, h, w, 3)), covered


def banded_compositor_fits(s_neg: int, s_pos: int) -> bool:
    """The banded compositor's 7-bit rank covers at most 126 shifts
    (warp_pallas.banded_compositor_fits): 480p-1440p cap-sized tables fit,
    4K's (S = 134) does not."""
    return s_neg + s_pos + 1 <= 126


def resolve_banded(banded: bool | None, s_neg: int, s_pos: int) -> bool:
    """The JAX wrapper's choice (warp_pallas._composite_prepacked): None is
    the classic kernel, and True beyond 126 shifts falls back to it."""
    return bool(banded) and banded_compositor_fits(s_neg, s_pos)


def band_ranks(valid: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 rank of each valid shift among the valid shifts,
    cumsum(valid) - valid (invalid shifts: not read)."""
    v = valid.to(torch.int32)
    return torch.cumsum(v, dim=1, dtype=torch.int32) - v


def band_codes(depth: torch.Tensor, st: ShiftTables) -> torch.Tensor:
    """(B, H, W) int32 code of each SOURCE pixel: the rank of the first
    valid band (ascending shifts) its depth falls in, | 128 when a second
    one matches too, UNMATCHED when none does."""
    bid = band_ranks(st.valid)
    code = torch.full(depth.shape, UNMATCHED, dtype=torch.int32,
                      device=depth.device)
    for j in range(st.lo.shape[1]):
        m = (st.valid[:, j, None, None] & (st.lo[:, j, None, None] <= depth)
             & (depth < st.hi[:, j, None, None]))
        code = torch.where(m, torch.where(code == UNMATCHED,
                                          bid[:, j, None, None], code | 128),
                           code)
    return code


def warp_composite_banded_plain(img: torch.Tensor, depth: torch.Tensor,
                                st: ShiftTables, s_neg: int, s_pos: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The banded compositor's algorithm (warp_pallas `_warp_kernel_banded`,
    :117-158): the code of each source pixel, then per shift, ascending
    (last write wins), the rolled code compared three ways with the
    shift's rank: iv == bj (its first band), iv == bj + 128 (its first of
    two) or iv == bj + 127 (the second of two). The depth is never rolled.
    Holes take the roll by the fill offset, as the classic version's."""
    if not banded_compositor_fits(s_neg, s_pos):
        raise ValueError(f"the banded compositor takes at most 126 shifts, "
                         f"got {s_neg + s_pos + 1}")
    b, h, w, _ = img.shape
    code = band_codes(depth, st)
    bid = band_ranks(st.valid)
    cols = torch.arange(w, device=img.device)
    src = (cols[None, :] - st.fill_offset[:, None].long()) % w
    composite = torch.gather(img, 2, src[:, None, :, None].expand(b, h, w, 3))
    covered = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    for j, s in enumerate(range(-s_neg, s_pos + 1)):
        iv = torch.roll(code, s, dims=2)
        bj = bid[:, j, None, None]
        m = st.valid[:, j, None, None] & ((iv == bj) | (iv == bj + 127)
                                          | (iv == bj + 128))
        composite = torch.where(m[..., None], torch.roll(img, s, dims=2),
                                composite)
        covered = covered | m
    return composite, covered


def depth_bins(depth: torch.Tensor, origin: torch.Tensor,
               scale: torch.Tensor, bins: int = WARP_BINS) -> torch.Tensor:
    """csrc/warp.cu ``bin_of``: clamp((depth - origin) * scale, 0, bins - 1)
    in f32, truncated; NaN goes to bin 0. Monotone in depth, so a band
    [lo, hi) holds only depths whose bin lies in [bin(lo), bin(hi)]."""
    t = (depth - origin) * scale
    t = torch.where(torch.isnan(t), 0.0, t).clamp(0.0, bins - 1)
    return t.to(torch.int64)


def shift_bin_ranges(st: ShiftTables, bins: int = WARP_BINS):
    """The compositor's per-frame candidate table (csrc/warp.cu): the bin
    origin and scale over the finite bounds of the valid bands, and each
    band's bins [kl, kh], widened by one bin on each side. Invalid bands
    get the empty range [1, 0]. Returns (origin, scale, kl, kh): (B, 1),
    (B, 1), (B, S), (B, S)."""
    inf = torch.tensor(torch.inf, dtype=torch.float32, device=st.lo.device)
    fin_lo = st.valid & torch.isfinite(st.lo)
    fin_hi = st.valid & torch.isfinite(st.hi)
    low = torch.minimum(torch.where(fin_lo, st.lo, inf).amin(1),
                        torch.where(fin_hi, st.hi, inf).amin(1))
    high = torch.maximum(torch.where(fin_lo, st.lo, -inf).amax(1),
                         torch.where(fin_hi, st.hi, -inf).amax(1))
    span = high - low
    scale = torch.tensor(float(bins), dtype=torch.float32) / span
    ok = (span > 0) & torch.isfinite(span) & torch.isfinite(scale)
    origin = torch.where(ok, low, 0.0)[:, None]
    scale = torch.where(ok, scale, 0.0)[:, None]
    kl = (depth_bins(st.lo, origin, scale, bins) - 1).clamp(min=0)
    kh = (depth_bins(st.hi, origin, scale, bins) + 1).clamp(max=bins - 1)
    kl = torch.where(st.valid, kl, 1)
    kh = torch.where(st.valid, kh, 0)
    return origin, scale, kl, kh


def warp_composite_scatter_plain(img: torch.Tensor, depth: torch.Tensor,
                                 st: ShiftTables, s_neg: int, s_pos: int,
                                 bins: int = WARP_BINS
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 3's formulation on the CPU (tests only): each SOURCE pixel sx
    takes the shifts its depth bin lists as candidates, checks each band
    exactly, and scatters j to x = (sx + s_j) mod w with amax; output x
    takes the winner's source pixel, or the fill roll where none won. The
    (x, j) pairs are those of the ascending walk, and max does not depend
    on order, so this equals :func:`warp_composite_plain` bit for bit."""
    b, h, w, _ = img.shape
    origin, scale, kl, kh = shift_bin_ranges(st, bins)
    k = depth_bins(depth, origin[:, :, None], scale[:, :, None], bins)
    cols = torch.arange(w, device=img.device)
    win = torch.full(depth.shape, -1, dtype=torch.int64, device=depth.device)
    wraps = torch.remainder(torch.arange(-s_neg, s_pos + 1), w)
    for j in range(s_neg + s_pos + 1):
        v = st.valid[:, j, None, None]
        cand = v & (kl[:, j, None, None] <= k) & (k <= kh[:, j, None, None])
        m = cand & (st.lo[:, j, None, None] <= depth) \
            & (depth < st.hi[:, j, None, None])
        target = ((cols + wraps[j]) % w).expand(b, h, w)
        win.scatter_reduce_(2, target, torch.where(m, j, -1), "amax")
    covered = win >= 0
    src = torch.where(covered, cols - wraps[win.clamp(min=0)],
                      cols - st.fill_offset[:, None, None].long()) % w
    composite = torch.gather(img, 2, src[..., None].expand(b, h, w, 3))
    return composite, covered


def next_ranked(valid: torch.Tensor) -> torch.Tensor:
    """(B, S) int64: for each shift, the valid shift of the next rank, the
    first valid one after it (-1 past the last): rank r + 1's shift for a
    shift of rank r, as the banded kernel's per-frame table holds it."""
    s = valid.shape[1]
    idx = torch.where(valid, torch.arange(s, device=valid.device), s)
    after = torch.cat([idx[:, 1:], torch.full_like(idx[:, :1], s)], dim=1)
    nxt = after.flip(1).cummin(dim=1).values.flip(1)
    return torch.where(nxt < s, nxt, -1)


def warp_composite_banded_scatter_plain(img: torch.Tensor,
                                        depth: torch.Tensor, st: ShiftTables,
                                        s_neg: int, s_pos: int,
                                        bins: int = WARP_BINS
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row 14's formulation on the CPU (tests only), as csrc/warp.cu runs
    it: each SOURCE pixel walks the shifts its depth bin lists, ascending,
    with the exact band compares, to its code (the first band that holds
    it, and whether a later one does too), then claims the first band's
    shift and, with a second, the next valid shift after it (rank r + 1's,
    whichever band matched second), scattering j to x = (sx + s_j) mod w
    with amax; output x takes the winner's source pixel, or the fill roll
    where none won. Equals :func:`warp_composite_banded_plain` bit for
    bit."""
    if not banded_compositor_fits(s_neg, s_pos):
        raise ValueError(f"the banded compositor takes at most 126 shifts, "
                         f"got {s_neg + s_pos + 1}")
    b, h, w, _ = img.shape
    origin, scale, kl, kh = shift_bin_ranges(st, bins)
    k = depth_bins(depth, origin[:, :, None], scale[:, :, None], bins)
    first = torch.full(depth.shape, -1, dtype=torch.int64, device=depth.device)
    dual = torch.zeros(depth.shape, dtype=torch.bool, device=depth.device)
    for j in range(s_neg + s_pos + 1):
        cand = (st.valid[:, j, None, None] & (kl[:, j, None, None] <= k)
                & (k <= kh[:, j, None, None]))
        m = cand & (st.lo[:, j, None, None] <= depth) \
            & (depth < st.hi[:, j, None, None])
        dual = dual | (m & (first >= 0))
        first = torch.where(m & (first < 0), j, first)
    nxt = next_ranked(st.valid)
    second = torch.where(dual & (first >= 0),
                         nxt.gather(1, first.clamp(min=0).reshape(b, -1))
                         .reshape(depth.shape), -1)
    cols = torch.arange(w, device=img.device)
    wraps = torch.remainder(torch.arange(-s_neg, s_pos + 1), w)
    win = torch.full(depth.shape, -1, dtype=torch.int64, device=depth.device)
    for j in (first, second):
        target = (cols + wraps[j.clamp(min=0)]) % w
        win.scatter_reduce_(2, target, j, "amax")
    covered = win >= 0
    src = torch.where(covered, cols - wraps[win.clamp(min=0)],
                      cols - st.fill_offset[:, None, None].long()) % w
    composite = torch.gather(img, 2, src[..., None].expand(b, h, w, 3))
    return composite, covered


def _require(x: torch.Tensor, dtype, shape, name: str) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")


def warp_composite(img: torch.Tensor, depth: torch.Tensor, st: ShiftTables,
                   s_neg: int, s_pos: int, banded: bool | None = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The compositor: plain version for CPU tensors, csrc/warp.cu for CUDA
    tensors. ``banded`` resolves as the JAX wrapper's (:func:`resolve_banded`):
    the banded kernel only when asked for and at most 126 shifts."""
    banded = resolve_banded(banded, s_neg, s_pos)
    if not on_cuda(img, depth, st.lo):
        plain = warp_composite_banded_plain if banded else warp_composite_plain
        return plain(img, depth, st, s_neg, s_pos)
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
    name = "vrvg_warp_composite_banded" if banded else "vrvg_warp_composite"
    err = getattr(library(), name)(
        img.data_ptr(), depth.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        valid.data_ptr(), fill.data_ptr(), out.data_ptr(), covered.data_ptr(),
        b, h, w, s_neg, n_shift, stream_handle(img.device))
    check(err, name)
    (BANDED_LAUNCHES if banded else COMPOSITE_LAUNCHES).count += 1
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


def pack_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 -> (...) uint32 words r | g<<8 | b<<16 (top byte zero),
    built in int32 (torch has few uint32 operations) and viewed as uint32."""
    v = rgb.to(torch.int32)
    return (v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16)).view(torch.uint32)


def blur_select_sbs_packed_plain(composite: torch.Tensor,
                                 covered: torch.Tensor, img: torch.Tensor,
                                 edge_width: torch.Tensor, kernel_size: int,
                                 sigma: float) -> torch.Tensor:
    """The packed emit (warp_pallas `_blur_select_sbs_kernel`): the same SBS
    as blur_select_sbs_plain, (B, H, 2W) uint32 words."""
    return pack_rgb(blur_select_sbs_plain(composite, covered, img, edge_width,
                                          kernel_size, sigma))


@functools.lru_cache(maxsize=None)
def _taps(ksize: int, sigma: float) -> torch.Tensor:
    """The blur's taps in host memory: the kernel copies them into its
    launch's parameters."""
    return torch.from_numpy(gaussian_kernel1d(ksize, sigma))


def blur_select_sbs(composite: torch.Tensor, covered: torch.Tensor,
                    img: torch.Tensor, edge_width: torch.Tensor,
                    kernel_size: int, sigma: float,
                    emit: str = "u8") -> torch.Tensor:
    """Hole fill + SBS: plain version for CPU tensors, csrc/blur_select.cu
    for CUDA tensors. ``emit="u8"``: (B, H, 2W, 3) u8; ``emit="packed"``:
    (B, H, 2W) uint32 words r | g<<8 | b<<16."""
    if emit not in EMITS:
        raise ValueError(f"emit must be one of {EMITS}, got {emit!r}")
    if not on_cuda(composite, covered, img, edge_width):
        plain = (blur_select_sbs_packed_plain if emit == "packed"
                 else blur_select_sbs_plain)
        return plain(composite, covered, img, edge_width, kernel_size, sigma)
    b, h, w, _ = img.shape
    kx, ky = kernel_size * 2 + 3, kernel_size * 2 + 1
    if kx // 2 >= w or ky // 2 >= h:
        raise ValueError(f"blur window ({kx}, {ky}) too large for {h}x{w}")
    if kernel_size > BLUR_KS_MAX:
        raise ValueError(f"blur kernel_size {kernel_size} > {BLUR_KS_MAX}: "
                         f"csrc/blur_select.cu takes frames up to 4320 rows")
    _require(composite, torch.uint8, (b, h, w, 3), "blur_select_sbs composite")
    _require(img, torch.uint8, (b, h, w, 3), "blur_select_sbs img")
    _require(covered, torch.bool, (b, h, w), "blur_select_sbs covered")
    edge = edge_width.to(torch.int32).contiguous()
    kxw, kyw = _taps(kx, sigma), _taps(ky, sigma)
    from vr_video_generator_tpu_torch.kernels.build import check, library

    packed = emit == "packed"
    out = (torch.empty((b, h, 2 * w), dtype=torch.uint32, device=img.device)
           if packed else
           torch.empty((b, h, 2 * w, 3), dtype=torch.uint8, device=img.device))
    err = library().vrvg_blur_select_sbs(
        composite.data_ptr(), covered.data_ptr(), img.data_ptr(),
        edge.data_ptr(), kxw.data_ptr(), kyw.data_ptr(), out.data_ptr(),
        b, h, w, kx, ky, int(packed), stream_handle(img.device))
    check(err, "vrvg_blur_select_sbs")
    (PACKED_LAUNCHES if packed else BLUR_SELECT_LAUNCHES).count += 1
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
    impl: str = "xla"

    @staticmethod
    def create(height: int, width: int, cfg: StereoConfig, impl: str = "xla",
               device: torch.device | str = "cpu") -> "WarpSpec":
        """ops/warp.py `WarpSpec.create` sizing; ``impl="auto"`` resolves to
        "pallas" on a CUDA ``device`` and to "xla" elsewhere."""
        if impl not in WARP_IMPLS:
            raise ValueError(f"warp_impl must be one of {WARP_IMPLS}, "
                             f"got {impl!r}")
        if impl == "auto":
            impl = "pallas" if torch.device(device).type == "cuda" else "xla"
        cfg = cfg.normalized()
        ks = int(np.round(0.0036 * height))  # round half to even
        step = max(cfg.offset_step_size, 1)
        s_neg = int(np.ceil(-cfg.offset_bg * height * cfg.limit_step_cap
                            / 14.0 / step) * step) + 1
        s_pos = int(np.ceil(cfg.offset_fg * height * cfg.limit_step_cap
                            / 14.0 / step) * step) + 1
        return WarpSpec(height=height, width=width, cfg=cfg,
                        max_planes=cfg.max_planes(height), kernel_size=ks,
                        s_neg=s_neg, s_pos=s_pos, impl=impl)

    def tables(self, depths: torch.Tensor, offset_ranges: torch.Tensor
               ) -> Tuple[PlaneTables, ShiftTables]:
        t = build_plane_tables(depths, offset_ranges, self.cfg, self.height,
                               self.max_planes)
        return t, build_shift_tables(t, self.s_neg, self.s_pos)

    def warp_batch(self, imgs: torch.Tensor, depths: torch.Tensor,
                   offset_ranges: torch.Tensor, emit: str = "u8"
                   ) -> torch.Tensor:
        """(B, H, W, 3) u8 + (B, H, W) smoothed depth + (B, 2) ranges ->
        (B, H, 2W, 3) u8 SBS or, with ``emit="packed"`` (pallas only),
        (B, H, 2W) uint32 words; "pallas" runs the two kernels on CUDA,
        "scan" the scan composite in plain PyTorch on any device."""
        if self.impl != "pallas":
            if emit == "packed":
                raise ValueError("packed SBS output requires the pallas warp")
            if self.impl == "scan":
                t = build_plane_tables(depths, offset_ranges, self.cfg,
                                       self.height, self.max_planes)
                comp, covered = warp_composite_scan(imgs, depths, t)
                return blur_select_sbs_plain(comp, covered, imgs,
                                             t.edge_width, self.kernel_size,
                                             self.cfg.sigma)
            return self.warp_batch_plain(imgs, depths, offset_ranges)
        _, st = self.tables(depths, offset_ranges)
        comp, covered = warp_composite(imgs, depths, st, self.s_neg,
                                       self.s_pos)
        return blur_select_sbs(comp, covered, imgs, st.edge_width,
                               self.kernel_size, self.cfg.sigma, emit=emit)

    def warp_batch_plain(self, imgs: torch.Tensor, depths: torch.Tensor,
                         offset_ranges: torch.Tensor) -> torch.Tensor:
        """warp_batch through the plain versions on any device."""
        _, st = self.tables(depths, offset_ranges)
        comp, covered = warp_composite_plain(imgs, depths, st, self.s_neg,
                                             self.s_pos)
        return blur_select_sbs_plain(comp, covered, imgs, st.edge_width,
                                     self.kernel_size, self.cfg.sigma)
