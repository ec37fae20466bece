"""PyTorch port, the compositor's formulation (csrc/warp.cu, row 3): each
source pixel checks only the shifts its depth bin lists and scatters the
shift index to its target with amax. ``warp_composite_scatter_plain``
mirrors that on the CPU; here it is held bit for bit against the plain
walk (``warp_composite_plain``) and against the JAX package's Pallas
compositor in interpret mode, on the JAX package's own inputs and on
tables made to break the shortcuts a compositor could take: overlapping
bands, bands that do not ascend with the shift, shifts as wide as the
frame, depths outside every band, no valid shift at all, unbounded bands
and NaN depth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_warp import synth_depth, synth_img
from tests.warp_tables import (above_all, all_invalid, descending,
                               overlapping, random_bands, unbounded)
from vr_video_generator_tpu.ops.warp import ShiftTables as JShiftTables
from vr_video_generator_tpu.ops.warp import WarpSpec as JWarpSpec
from vr_video_generator_tpu.ops.warp_pallas import warp_composite_pallas
from vr_video_generator_tpu.utils.config import StereoConfig
from vr_video_generator_tpu_torch.ops.warp import (
    WarpSpec, depth_bins, shift_bin_ranges, warp_composite,
    warp_composite_plain, warp_composite_scatter_plain)

torch.set_num_threads(2)


def jax_inputs(h, w):
    """Three frames as tests/test_torch_ops.py builds them: depth up to 5,
    14 and 30 (past the cap), each frame's own offset range."""
    rng = np.random.default_rng(h * 1000 + w)
    imgs = np.stack([synth_img(rng, h, w) for _ in range(3)])
    depths = np.stack([synth_depth(rng, h, w, tmax=t) for t in (5.0, 14.0, 30.0)])
    jspec = JWarpSpec.create(h, w, StereoConfig(), impl="pallas")
    ranges = np.stack([np.asarray(jspec.frame_offset_range(jnp.asarray(d)))
                       for d in depths])
    spec = WarpSpec.create(h, w, StereoConfig())
    _, st = spec.tables(torch.from_numpy(depths), torch.from_numpy(ranges))
    return spec, torch.from_numpy(imgs), torch.from_numpy(depths), st


def as_is(spec, imgs, depth, st):
    return imgs, depth, st


def jax_tables(st, i):
    return JShiftTables(lo=jnp.asarray(st.lo[i].numpy()),
                        hi=jnp.asarray(st.hi[i].numpy()),
                        valid=jnp.asarray(st.valid[i].numpy()),
                        fill_offset=jnp.asarray(st.fill_offset[i].numpy()),
                        edge_width=jnp.asarray(st.edge_width[i].numpy()))


CASES = {
    "jax-150x96": ((150, 96), as_is),
    "jax-61x97": ((61, 97), as_is),
    "three-overlapping-bands": ((72, 128), overlapping),
    "bands-descending": ((150, 96), descending),
    "random-bands": ((61, 97), random_bands),
    "depth-above-every-band": ((61, 97), above_all),
    "all-shifts-invalid": ((72, 128), all_invalid),
    "unbounded-bands-nan-depth": ((150, 96), unbounded),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scatter_formulation_bit_exact(case):
    (h, w), make = CASES[case]
    spec, imgs, depth, st = jax_inputs(h, w)
    imgs, depth, st = make(spec, imgs, depth, st)
    comp, cov = warp_composite_scatter_plain(imgs, depth, st, spec.s_neg,
                                             spec.s_pos)
    want, want_cov = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                          spec.s_pos)
    assert torch.equal(comp, want) and torch.equal(cov, want_cov)
    # The CPU route of the wrapper is the plain walk.
    got, got_cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos)
    assert torch.equal(got, want) and torch.equal(got_cov, want_cov)
    for i in range(len(imgs)):
        rcomp, rcov = warp_composite_pallas(
            jnp.asarray(imgs[i].numpy()), jnp.asarray(depth[i].numpy()),
            jax_tables(st, i), spec.s_neg, spec.s_pos, interpret=True)
        np.testing.assert_array_equal(comp[i].numpy(), np.asarray(rcomp))
        np.testing.assert_array_equal(cov[i].numpy(), np.asarray(rcov))


def test_scatter_shifts_wider_than_the_frame():
    """1080 rows give s_pos = 48 on a 32-pixel-wide frame: shifts wrap more
    than once, so no single conditional add makes them circular."""
    h, w = 1080, 32
    spec = WarpSpec.create(h, w, StereoConfig())
    assert spec.s_pos >= w and spec.s_neg + spec.s_pos + 1 == 69
    rng = np.random.default_rng(7)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    ramp = np.linspace(0, 1, w, dtype=np.float32)[None, None, :]
    depth = ramp * np.array([14.0, 30.0], np.float32)[:, None, None]
    depth = torch.from_numpy(np.clip(
        depth + rng.normal(0, 0.5, (2, h, w)).astype(np.float32), 0, None))
    ls = torch.ceil(depth.amax(dim=(1, 2)))
    ranges = torch.stack([spec.cfg.offset_bg * h * ls / 14.0,
                          spec.cfg.offset_fg * h * ls / 14.0], dim=1)
    _, st = spec.tables(depth, ranges)
    assert (st.valid.sum(1) > 20).all()
    comp, cov = warp_composite_scatter_plain(imgs, depth, st, spec.s_neg,
                                             spec.s_pos)
    want, want_cov = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                          spec.s_pos)
    assert torch.equal(comp, want) and torch.equal(cov, want_cov)
    assert 0 < cov.float().mean() < 1
    rcomp, rcov = warp_composite_pallas(
        jnp.asarray(imgs[1].numpy()), jnp.asarray(depth[1].numpy()),
        jax_tables(st, 1), spec.s_neg, spec.s_pos, interpret=True)
    np.testing.assert_array_equal(comp[1].numpy(), np.asarray(rcomp))
    np.testing.assert_array_equal(cov[1].numpy(), np.asarray(rcov))


@pytest.mark.parametrize("bins", [1, 7, 512])
def test_every_matching_band_is_a_candidate_of_its_bin(bins):
    """The candidate table never drops a band: for every pixel and valid
    shift whose band holds the pixel's depth, the pixel's bin lies in the
    shift's [kl, kh], at any bin count."""
    spec, imgs, depth, st = jax_inputs(150, 96)
    _, depth, st = random_bands(spec, imgs, depth, st)
    depth[:, 2, ::7] = torch.nan
    origin, scale, kl, kh = shift_bin_ranges(st, bins)
    k = depth_bins(depth, origin[:, :, None], scale[:, :, None], bins)
    assert int(k.min()) >= 0 and int(k.max()) < bins
    d = depth[:, :, :, None]
    match = (st.valid[:, None, None, :] & (st.lo[:, None, None, :] <= d)
             & (d < st.hi[:, None, None, :]))
    cand = ((kl[:, None, None, :] <= k[..., None])
            & (k[..., None] <= kh[:, None, None, :]))
    assert bool(match.any()) and not bool((match & ~cand).any())
    # The bins narrow the scan: at 512 bins a pixel has few candidates.
    if bins == 512:
        per_pixel = (cand & st.valid[:, None, None, :]).sum(-1).float()
        assert per_pixel.mean() < 0.5 * st.valid.sum(1).float().mean()
