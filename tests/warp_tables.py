"""Shift tables made to break the shortcuts a compositor could take, for
the compositors' tests on the CPU (tests/test_torch_warp_scatter.py,
tests/test_torch_banded_scatter.py, tests/test_torch_kernel_emulation.py)
and on the card (tests/test_torch_cuda.py). Each builder takes (spec, imgs,
depth, st) and returns (imgs, depth, st) with the tables or the depth
changed; the fill offset stays the frame's own. No JAX here: the card's
machine has none.
"""

import numpy as np
import torch

from vr_video_generator_tpu_torch.ops.warp import ShiftTables


def with_bands(st, lo, hi, valid=None):
    dev = st.lo.device
    return ShiftTables(lo=torch.as_tensor(lo, dtype=torch.float32, device=dev),
                       hi=torch.as_tensor(hi, dtype=torch.float32, device=dev),
                       valid=st.valid if valid is None
                       else torch.as_tensor(valid, device=dev),
                       fill_offset=st.fill_offset, edge_width=st.edge_width)


def hand_bands(st, make):
    """Tables of the same frames with every frame's bands replaced:
    ``make(S)`` gives (lo, hi, valid) over the S shifts."""
    b, n = st.lo.shape
    lo, hi, valid = make(n)
    return with_bands(st, *(np.broadcast_to(a, (b, n)).copy()
                            for a in (lo, hi, valid)))


def overlapping(spec, imgs, depth, st):
    """Every shift valid, each band three steps wide: a depth lies in three
    bands at once (the banded compositor's code byte holds two)."""
    def make(n):
        c = 30.0 / n
        lo = np.arange(n, dtype=np.float32) * c - c
        return lo, lo + 3 * c, np.ones(n, bool)
    return imgs, depth, hand_bands(st, make)


def descending(spec, imgs, depth, st):
    """Bands that descend as the shift ascends: the near band on the far
    shift, so no early stop over ascending bands holds."""
    def make(n):
        c = 30.0 / n
        lo = np.arange(n - 1, -1, -1, dtype=np.float32) * c
        return lo, lo + 1.1 * c, np.ones(n, bool)
    return imgs, depth, hand_bands(st, make)


def random_bands(spec, imgs, depth, st):
    """Seeded random bands: any order, any width up to 8, some invalid."""
    def make(n):
        rng = np.random.default_rng(n)
        lo = rng.uniform(-2.0, 30.0, n).astype(np.float32)
        return (lo, lo + rng.uniform(0.0, 8.0, n).astype(np.float32),
                rng.random(n) < 0.7)
    return imgs, depth, hand_bands(st, make)


def above_all(spec, imgs, depth, st):
    """Depth 1e6 (above every band) in whole rows and in short runs."""
    depth = depth.clone()
    depth[0, 3] = 1e6
    depth[1, 5:9, 10:17] = 1e6
    depth[2, :, :4] = 1e6
    return imgs, depth, st


def all_invalid(spec, imgs, depth, st):
    """No valid shift: every pixel is a hole and takes the fill roll."""
    return imgs, depth, with_bands(st, st.lo, st.hi,
                                   torch.zeros_like(st.valid))


def unbounded(spec, imgs, depth, st):
    """The overlapping bands with the first open below, the last open
    above, an empty one (lo > hi) between, and NaN depth at a few
    pixels."""
    _, _, st = overlapping(spec, imgs, depth, st)
    lo, hi = st.lo.clone(), st.hi.clone()
    n = lo.shape[1]
    lo[:, 0], hi[:, -1] = -torch.inf, torch.inf
    lo[:, n // 2], hi[:, n // 2] = 5.0, 4.0
    depth = depth.clone()
    depth[:, 2, ::7] = torch.nan
    return imgs, depth, with_bands(st, lo, hi)


def skip_one(spec, imgs, depth, st):
    """Every shift valid, band j [j c, (j + 1.1) c), the even ones reaching
    on to (j + 3.05) c: a depth in [(j + 2.1) c, (j + 3) c) lies in bands j
    and j + 2 only, not rank-adjacent, so the banded compositor's second
    claim (rank r + 1) is not the band that matched second."""
    def make(n):
        c = 30.0 / n
        lo = np.arange(n, dtype=np.float32) * c
        hi = lo + 1.1 * c
        hi[::2] = lo[::2] + 3.05 * c
        return lo, hi, np.ones(n, bool)
    return imgs, depth, hand_bands(st, make)


def last_rank_dual(spec, imgs, depth, st):
    """Three valid shifts, the last valid one not the last shift, its band
    overlapping the band before it: pixels in both claim rank 1's and rank
    2's (the last valid) shifts; the shifts after it stay invalid."""
    def make(n):
        lo = np.full(n, np.inf, np.float32)
        hi = np.full(n, -np.inf, np.float32)
        valid = np.zeros(n, bool)
        for j, (a, b) in zip((1, n // 2, n - 3), ((0.0, 4.0), (3.0, 9.0),
                                                  (8.0, 30.0))):
            lo[j], hi[j], valid[j] = a, b, True
        return lo, hi, valid
    return imgs, depth, hand_bands(st, make)


def shifts_126(st):
    """A table of 126 shifts, the most the banded compositor takes, every
    one valid and overlapping the next (codes up to 125 | 128): (tables,
    s_neg, s_pos) with the fill offsets of ``st``."""
    n, s_neg = 126, 40
    c = 30.0 / n
    lo = np.broadcast_to(np.arange(n, dtype=np.float32) * c,
                         (st.lo.shape[0], n)).copy()
    return (with_bands(st, lo, lo + 1.1 * c, np.ones(lo.shape, bool)),
            s_neg, n - 1 - s_neg)
