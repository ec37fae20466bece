"""PyTorch port, the banded compositor's formulation (csrc/warp.cu
``warp_composite_banded_kernel``, row 14): each source pixel finds the TPU
kernel's code from its depth bin's candidate shifts (the first band that
holds it, and whether a later one does), then claims the first band's shift
and, with a second match, the next valid shift (rank r + 1's, whichever band
matched second), scattering the shift index to its target with amax.
``warp_composite_banded_scatter_plain`` mirrors that on the CPU; here it is
held bit for bit against the TPU kernel's own formulation in torch
(``warp_composite_banded_plain``: codes, then a compare per shift) and
against the JAX package's Pallas compositor with ``banded=True`` in
interpret mode, on the JAX package's own inputs and on every table of
tests/warp_tables.py, a table of 126 shifts (the most the kernel takes), a
table whose last valid rank is the second of a dual pair, and shifts wider
than the frame. On tables where a depth lies in three bands, or in two that
are not rank-adjacent, the banded compositor is not the classic one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_warp_scatter import as_is, jax_inputs, jax_tables
from tests.warp_tables import (above_all, all_invalid, descending,
                               last_rank_dual, overlapping, random_bands,
                               shifts_126, skip_one, unbounded)
from vr_video_generator_tpu.ops.warp_pallas import warp_composite_pallas
from vr_video_generator_tpu_torch.ops.warp import (
    WarpSpec, band_ranks, next_ranked, warp_composite,
    warp_composite_banded_plain, warp_composite_banded_scatter_plain,
    warp_composite_plain)
from vr_video_generator_tpu_torch.utils.config import StereoConfig

torch.set_num_threads(2)


def wide_table(spec, imgs, depth, st):
    """126 shifts, each band overlapping the next (shifts_126): returned
    with its own s_neg and s_pos."""
    st, s_neg, s_pos = shifts_126(st)
    return imgs, depth, st, s_neg, s_pos


def wider_than_frame():
    """1080 rows' tables (69 shifts, s_pos = 48) on frames 32 pixels wide:
    shifts wrap more than once."""
    h, w = 1080, 32
    spec = WarpSpec.create(h, w, StereoConfig())
    rng = np.random.default_rng(11)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8))
    ramp = np.linspace(0, 1, w, dtype=np.float32)[None, None, :]
    depth = torch.from_numpy(np.clip(
        ramp * np.array([14.0, 30.0], np.float32)[:, None, None]
        + rng.normal(0, 0.5, (2, h, w)).astype(np.float32), 0, None))
    ls = torch.ceil(depth.amax(dim=(1, 2)))
    ranges = torch.stack([spec.cfg.offset_bg * h * ls / 14.0,
                          spec.cfg.offset_fg * h * ls / 14.0], dim=1)
    _, st = spec.tables(depth, ranges)
    assert spec.s_pos >= w and (st.valid.sum(1) > 20).all()
    return imgs, depth, st, spec.s_neg, spec.s_pos


def case_inputs(case):
    """(imgs, depth, tables, s_neg, s_pos) of a case of CASES."""
    if case == "shifts-wider-than-the-frame":
        return wider_than_frame()
    (h, w), make = CASES[case]
    spec, imgs, depth, st = jax_inputs(h, w)
    made = make(spec, imgs, depth, st)
    return made if len(made) == 5 else (*made, spec.s_neg, spec.s_pos)


CASES = {
    "jax-150x96": ((150, 96), as_is),
    "jax-61x97": ((61, 97), as_is),
    "three-overlapping-bands": ((72, 128), overlapping),
    "bands-descending": ((150, 96), descending),
    "random-bands": ((61, 97), random_bands),
    "depth-above-every-band": ((61, 97), above_all),
    "all-shifts-invalid": ((72, 128), all_invalid),
    "unbounded-bands-nan-depth": ((150, 96), unbounded),
    "two-bands-not-rank-adjacent": ((61, 97), skip_one),
    "last-valid-rank-dual": ((61, 97), last_rank_dual),
    "126-shifts": ((61, 97), wide_table),
    "shifts-wider-than-the-frame": (None, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_banded_scatter_bit_exact(case):
    imgs, depth, st, s_neg, s_pos = case_inputs(case)
    assert s_neg + s_pos + 1 == st.lo.shape[1] <= 126
    comp, cov = warp_composite_banded_scatter_plain(imgs, depth, st, s_neg,
                                                    s_pos)
    want, want_cov = warp_composite_banded_plain(imgs, depth, st, s_neg,
                                                 s_pos)
    assert torch.equal(cov, want_cov) and torch.equal(comp, want)
    # The CPU route of the wrapper with banded=True is the TPU kernel's
    # formulation.
    got, got_cov = warp_composite(imgs, depth, st, s_neg, s_pos, banded=True)
    assert torch.equal(got, want) and torch.equal(got_cov, want_cov)
    for i in range(len(imgs)):
        rcomp, rcov = warp_composite_pallas(
            jnp.asarray(imgs[i].numpy()), jnp.asarray(depth[i].numpy()),
            jax_tables(st, i), s_neg, s_pos, interpret=True, banded=True)
        np.testing.assert_array_equal(comp[i].numpy(), np.asarray(rcomp))
        np.testing.assert_array_equal(cov[i].numpy(), np.asarray(rcov))


@pytest.mark.parametrize("case", ["three-overlapping-bands",
                                  "two-bands-not-rank-adjacent"])
def test_banded_is_not_the_classic_compositor(case):
    """Where a depth lies in three bands, or in two that are not
    rank-adjacent, the second claim goes to rank r + 1's shift, not to every
    band that holds the depth: routing banded=True to row 3 would be
    wrong."""
    imgs, depth, st, s_neg, s_pos = case_inputs(case)
    banded = warp_composite_banded_scatter_plain(imgs, depth, st, s_neg,
                                                 s_pos)
    classic = warp_composite_plain(imgs, depth, st, s_neg, s_pos)
    assert not torch.equal(banded[0], classic[0])


def test_next_ranked_is_rank_plus_one():
    """The kernel's per-frame `next` table: for each valid shift of rank r,
    the shift of rank r + 1 (cumsum(valid) - valid), -1 for the last; for
    an invalid shift, the first valid one after it."""
    rng = np.random.default_rng(3)
    valid = torch.from_numpy(rng.random((4, 69)) < 0.4)
    valid[3] = False
    rank = band_ranks(valid)
    nxt = next_ranked(valid)
    for b in range(4):
        ranked = torch.nonzero(valid[b])[:, 0].tolist()
        for j in range(69):
            later = [k for k in ranked if k > j]
            assert nxt[b, j] == (later[0] if later else -1)
            if valid[b, j] and later:
                assert rank[b, nxt[b, j]] == rank[b, j] + 1
