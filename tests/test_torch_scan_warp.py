"""PyTorch port: the ``scan`` warp (ops/warp.py `select_warp_offsets`, the
impl "scan" arm) against the JAX package's scan warp and the port's xla
warp, bit for bit on the u8 SBS, and ``perf_compare`` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_warp import synth_depth, synth_img
from vr_video_generator_tpu.ops.warp import WarpSpec as JWarpSpec
from vr_video_generator_tpu.ops.warp import build_plane_tables as jplane
from vr_video_generator_tpu.ops.warp import \
    select_warp_offsets as jselect_warp_offsets
from vr_video_generator_tpu.utils.config import StereoConfig as JStereoConfig
from vr_video_generator_tpu_torch import cli, perf_compare
from vr_video_generator_tpu_torch.ops.warp import (WARP_IMPLS, WarpSpec,
                                                   build_plane_tables,
                                                   select_warp_offsets)
from vr_video_generator_tpu_torch.utils.config import StereoConfig

torch.set_num_threads(2)

# Offsets wider than the defaults, so that at 31-54 rows every depth scale
# has several live planes and most left-eye pixels move.
WIDE = dict(offset_fg=0.25, offset_bg=-0.1)


def _inputs(h, w, tmax, seed=0, **stereo):
    """Three frames and depths x ``tmax``, the JAX spec's first-frame
    offset ranges, and both packages' StereoConfig."""
    rng = np.random.default_rng(seed)
    imgs = np.stack([synth_img(rng, h, w) for _ in range(3)])
    depths = np.stack([synth_depth(rng, h, w, tmax=tmax) for _ in range(3)])
    jspec = JWarpSpec.create(h, w, JStereoConfig(**stereo), impl="scan")
    ranges = np.stack([np.asarray(jspec.frame_offset_range(jnp.asarray(d)))
                       for d in depths])
    return imgs, depths, ranges, jspec, StereoConfig(**stereo)


@pytest.mark.parametrize("h,w,tmax,step", [
    (54, 96, 2.0, 1), (54, 96, 9.0, 1), (54, 96, 30.0, 1),
    (50, 77, 9.0, 1), (31, 130, 9.0, 1), (54, 96, 9.0, 2)])
def test_scan_warp_bit_exact_vs_jax_scan_and_xla(h, w, tmax, step):
    """The port's scan SBS equals the JAX package's scan SBS and the port's
    xla SBS, bit for bit: the circular wrap at both edges, the zip
    truncation, the 3/5 fill index, the edge width, depth above the cap
    (x 30), odd widths and an offset step of 2."""
    imgs, depths, ranges, jspec, cfg = _inputs(h, w, tmax,
                                               offset_step_size=step, **WIDE)
    ref = np.asarray(jspec.warp_batch(jnp.asarray(imgs), jnp.asarray(depths),
                                      jnp.asarray(ranges)))
    args = (torch.from_numpy(imgs), torch.from_numpy(depths),
            torch.from_numpy(ranges))
    scan = WarpSpec.create(h, w, cfg, impl="scan").warp_batch(*args).numpy()
    xla = WarpSpec.create(h, w, cfg, impl="xla").warp_batch(*args).numpy()
    np.testing.assert_array_equal(scan, ref)
    np.testing.assert_array_equal(scan, xla)
    np.testing.assert_array_equal(scan[:, :, w:], imgs)
    assert np.any(scan[:, :, :w] != imgs, axis=-1).mean() > 0.1


@pytest.mark.parametrize("h,w,tmax", [(54, 96, 9.0), (31, 130, 30.0)])
def test_select_warp_offsets_equal_jax(h, w, tmax):
    """Each frame's winning offset and coverage equal the JAX package's
    `select_warp_offsets` on its own plane tables."""
    imgs, depths, ranges, jspec, cfg = _inputs(h, w, tmax, seed=3, **WIDE)
    spec = WarpSpec.create(h, w, cfg, impl="scan")
    tables = build_plane_tables(torch.from_numpy(depths),
                                torch.from_numpy(ranges), spec.cfg, h,
                                spec.max_planes)
    sel_off, covered = select_warp_offsets(torch.from_numpy(depths), tables)
    assert sel_off.dtype == torch.int32 and covered.dtype == torch.bool
    for i in range(len(depths)):
        jt = jplane(jnp.asarray(depths[i]), jnp.asarray(ranges[i]), jspec.cfg,
                    h, jspec.max_planes)
        jsel, jcov = jselect_warp_offsets(jnp.asarray(depths[i]), jt)
        np.testing.assert_array_equal(sel_off[i].numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(covered[i].numpy(), np.asarray(jcov))
    assert len(np.unique(sel_off.numpy())) > 2 and covered.any()


def test_scan_takes_no_packed_emit_and_stays_off_the_cli():
    """"scan" is a WarpSpec impl (as in the JAX package), plain on any
    device; the packed emit still needs "pallas"; the CLI's --warp_impl
    keeps the JAX CLI's choices."""
    assert "scan" in WARP_IMPLS
    imgs, depths, ranges, _, cfg = _inputs(31, 64, 9.0)
    spec = WarpSpec.create(31, 64, cfg, impl="scan", device="cpu")
    assert spec.impl == "scan"
    with pytest.raises(ValueError, match="packed SBS output requires"):
        spec.warp_batch(torch.from_numpy(imgs), torch.from_numpy(depths),
                        torch.from_numpy(ranges), emit="packed")
    action = next(a for a in cli.build_parser()._actions
                  if a.dest == "warp_impl")
    assert action.choices == ["auto", "xla", "pallas"]


def test_perf_compare_cpu_prints_xla_and_scan(capsys):
    """--device cpu: an xla and a scan line with positive ms and fps, in the
    JAX script's format, and no pallas line."""
    assert perf_compare.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == ["xla", "scan"]
    for ln in lines:
        ms = float(ln.split(":")[1].split("ms/frame")[0])
        fps = float(ln.split("(")[1].split(" fps")[0])
        assert ms > 0 and fps > 0
