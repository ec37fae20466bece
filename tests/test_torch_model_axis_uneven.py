"""PyTorch port: a model axis that does not divide the heads, on the CPU.

The port splits the heads as a balanced, contiguous range a rank
(parallel/sharding.head_range), so ranks may hold unequal head counts, or
none where M exceeds the heads, and refuses a model axis exactly where the
JAX package's ``device_put`` of its rules refuses it (M not dividing the
embedding width or the MLP hidden). Held here: the refusals against the JAX
``ShardedSbsPipeline`` on the virtual CPU devices, the uneven shards and
their gather (also from the JAX package's params), one Block and the whole
depth net across a group of such ranks against 1 x 1, ``ShardedSbsPipeline``
against the JAX package's on the same mesh, and ``cli.main --mesh 1x4``."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_pipeline import TINY, H, W
from tests.test_video import write_synthetic_video
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.models.factory import random_params
from vr_video_generator_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vr_video_generator_tpu.parallel.sharded import (
    ShardedSbsPipeline as JaxShardedSbsPipeline)
from vr_video_generator_tpu.utils.config import ModelConfig, RunConfig
from vr_video_generator_tpu_torch.models import dinov2
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.dinov2 import group_block
from vr_video_generator_tpu_torch.models.factory import (build_group,
                                                         build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
from vr_video_generator_tpu_torch.parallel.sharded import ShardedSbsPipeline
from vr_video_generator_tpu_torch.parallel.sharding import (
    check_model_axis, gather_state_dict, head_range, param_specs,
    shard_state_dict)

torch.set_num_threads(2)

CFG = RunConfig(batch_size=2, input_size=56, compute_dtype="float32")
# As tests/test_torch_model_axis.py: a group against the port's 1 x 1 at f32
# within REL of the peak (the split products sum their partials in another
# order); against the JAX package, the depth carries within DEPTH_REL of
# their peak, the offset range to 1e-5 relative, the flags exactly, and
# >= 99.9% of the left SBS pixels equal.
REL = 1e-5
DEPTH_REL = 1e-4
# vits' 6 heads at TINY's depth: at D = 48 (head_dim 8, where nothing
# fuses) for the rules and the pipeline, at vits' D = 384 (head_dim 64,
# where `fused` runs the fused halves' plain versions) for the Block.
SIX = dataclasses.replace(TINY, embed_dim=48, num_heads=6)
SIX384 = dataclasses.replace(TINY, embed_dim=384, num_heads=6)
# vitl's encoder widths (D = 1024, 16 heads, hidden 4096) at one block and
# TINY's head: the rules split only the blocks.
VITL1 = dataclasses.replace(
    ModelConfig.for_encoder("vitl"), depth=1, features=16,
    out_channels=(8, 16, 32, 32), intermediate_layers=(0, 0, 0, 0))


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def heads_of(cfg, m):
    return [hi - lo for lo, hi in (head_range(r, m, cfg.num_heads)
                                   for r in range(m))]


# --------------------------------------------------------- the refusal rule

@pytest.mark.parametrize("cfg,m,runs", [
    (SIX, 4, True), (SIX, 5, False), (TINY, 8, True), (VITL1, 3, False),
    (VITL1, 4, True)], ids=["6heads-m4", "6heads-m5", "tiny-m8", "vitl-m3",
                            "vitl-m4"])
def test_model_axis_rule_matches_jax_device_put(cfg, m, runs):
    """``check_model_axis`` accepts (config, M) exactly where the JAX
    package's ShardedSbsPipeline, on (1, M) of the virtual CPU devices,
    places its params (``jax.device_put`` of the rules' shardings), and
    raises where that raises: D = 48 with 6 heads at M = 4 (unequal heads)
    and 5 (D), TINY's 2 heads at M = 8 (ranks with none), vitl's widths at
    M = 3 (D = 1024) and 4."""
    jmodel = JaxDepthAnythingV2(cfg, dtype=jnp.float32)
    params = random_params(jmodel)
    mesh = jax_make_mesh((1, m), devices=jax.devices()[:m])
    try:
        JaxShardedSbsPipeline(jmodel, params, H, W, mesh, run_cfg=CFG)
        jax_runs = True
    except ValueError:
        jax_runs = False
    assert jax_runs == runs
    if runs:
        check_model_axis(cfg, m)
    else:
        with pytest.raises(ValueError, match=f"model axis of {m} does not "
                                             f"divide .*embedding width"):
            check_model_axis(cfg, m)


def test_head_range_is_balanced_and_contiguous():
    """The ranges tile [0, H) in order, each floor(H / M) or one more heads;
    vits' 6 heads at M = 4 take 1, 2, 1, 2; at M = 8 two ranks take none;
    vitb's 12 at M = 8 take 1, 2, 1, 2, ..."""
    for h in (1, 2, 6, 12, 16, 24):
        for m in (1, 2, 3, 4, 5, 8, 16):
            ranges = [head_range(r, m, h) for r in range(m)]
            assert ranges[0][0] == 0 and ranges[-1][1] == h
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert {hi - lo for lo, hi in ranges} <= {h // m, h // m + 1}
    assert heads_of(SIX, 4) == [1, 2, 1, 2]
    assert heads_of(SIX, 8) == [0, 1, 1, 1, 0, 1, 1, 1]
    assert heads_of(ModelConfig.for_encoder("vitb"), 8) == [1, 2] * 4
    assert heads_of(TINY, 8) == [0, 0, 0, 1, 0, 0, 0, 1]


# ------------------------------------------------- the shards and the gather

@pytest.mark.parametrize("cfg,m", [(SIX, 4), (SIX, 8), (TINY, 8)],
                         ids=["6heads-m4", "6heads-m8", "tiny-m8"])
def test_uneven_shards_gather_back_bit_for_bit(cfg, m):
    """Every rank's shard_state_dict of the JAX package's params turned into
    the port's (models/convert.state_dict_from_jax) gathers back to them
    bit for bit, as numpy arrays and as tensors; rank r's qkv rows are q, k
    and v of its heads and its proj columns theirs (none where it holds
    none); fc1 and fc2 split evenly; replicated parameters whole."""
    jmodel = JaxDepthAnythingV2(cfg, dtype=jnp.float32)
    sd = state_dict_from_jax(
        jax.tree.map(np.asarray, random_params(jmodel)), cfg)
    shards = [shard_state_dict(sd, r, m, cfg.num_heads) for r in range(m)]
    for name, whole in gather_state_dict(shards).items():
        np.testing.assert_array_equal(whole, sd[name])
    tshards = [{k: torch.from_numpy(v) for k, v in s.items()} for s in shards]
    for name, whole in gather_state_dict(tshards).items():
        assert torch.equal(whole, torch.from_numpy(sd[name])), name
    d, hd = cfg.embed_dim, cfg.embed_dim // cfg.num_heads
    qkv = sd["pretrained.blocks.0.attn.qkv.weight"].reshape(
        3, cfg.num_heads, hd, d)
    proj = sd["pretrained.blocks.0.attn.proj.weight"]
    for r, s in enumerate(shards):
        lo, hi = head_range(r, m, cfg.num_heads)
        got = s["pretrained.blocks.0.attn.qkv.weight"]
        np.testing.assert_array_equal(got.reshape(3, hi - lo, hd, d),
                                      qkv[:, lo:hi])
        np.testing.assert_array_equal(
            s["pretrained.blocks.0.attn.proj.weight"],
            proj[:, lo * hd:hi * hd])
        for name, spec in param_specs(sd).items():
            if spec is None:
                assert s[name] is sd[name], name
            elif "mlp." in name:
                assert s[name].size == sd[name].size // m, name


# ----------------------------------------------- a Block and the depth net

@pytest.mark.parametrize("cfg,m,mlp_fused", [
    (SIX384, 4, "xla"), (SIX384, 4, "fused"), (TINY, 8, "xla")],
    ids=["6heads-m4-xla", "6heads-m4-fused", "tiny-m8-xla"])
def test_block_matches_1x1(cfg, m, mlp_fused, monkeypatch):
    """One Block across a group of m CPU ranks with unequal head counts (6
    heads at M = 4: 1, 2, 1, 2; TINY at M = 8: ranks with none) against the
    port's Block at 1 x 1 on the same tokens, f32, within REL. Unfused, the
    attention runs once a rank that holds heads, never on one that holds
    none; at ``fused`` the fused halves run on whole weights gathered from
    the uneven shards, equal to the 1 x 1 weights."""
    cfg = dataclasses.replace(cfg, mlp_fused=mlp_fused)
    whole = build_model(cfg, random_state_dict(cfg, seed=29), torch.float32,
                        "cpu")
    group = build_group(whole, ["cpu"] * m)
    assert [r.pretrained.blocks[0].attn.num_heads
            for r in group.ranks] == heads_of(cfg, m)
    calls = []
    mha = dinov2.mha
    monkeypatch.setattr(dinov2, "mha", lambda q, *a, **k: calls.append(
        q.shape[2]) or mha(q, *a, **k))
    x = torch.randn(2, 37, cfg.embed_dim,
                    generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = whole.pretrained.blocks[0](x)
        calls.clear()
        got = group_block([r.pretrained.blocks[0] for r in group.ranks],
                          [x.clone() for _ in range(m)])
    for g in got:
        assert rel_err(g, want) <= REL
    blk = group.ranks[0].pretrained.blocks[0]
    if mlp_fused == "fused":
        assert calls == []
        for name in ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight"):
            assert torch.equal(blk.whole[name], whole.pretrained.blocks[0]
                               .get_parameter(name))
    else:
        assert calls == [h for h in heads_of(cfg, m) if h]
        assert blk.whole == {}


@pytest.mark.parametrize("cfg,m,mlp_fused", [
    (SIX384, 4, "xla"), (SIX384, 4, "fused"), (TINY, 8, "xla")],
    ids=["6heads-m4-xla", "6heads-m4-fused", "tiny-m8-xla"])
def test_depth_matches_1x1(cfg, m, mlp_fused):
    """The whole depth net across such a group against the port's 1 x 1 on
    the same input, f32, within REL of its peak."""
    cfg = dataclasses.replace(cfg, mlp_fused=mlp_fused)
    whole = build_model(cfg, random_state_dict(cfg, seed=30), torch.float32,
                        "cpu")
    group = build_group(whole, ["cpu"] * m)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 56, 98, 3)).astype(np.float32))
    with torch.inference_mode():
        want, got = whole(x), group(x)
    assert got.shape == want.shape
    assert rel_err(got, want) <= REL


# ------------------------------------------------------ the sharded pipeline

def _assert_state_close(got, want):
    for field in ("d_prev1", "d_prev2", "anchor_prev"):
        g, w = getattr(got, field), getattr(want, field)
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= DEPTH_REL * max(
            np.abs(w).max(), 1e-6), field
    np.testing.assert_allclose(got.offset_range.numpy(),
                               np.asarray(want.offset_range), rtol=1e-5)
    assert bool(got.has_state) == bool(want.has_state)
    assert int(got.overflow) == int(want.overflow)


@pytest.fixture(scope="module")
def video_frames(tmp_path_factory):
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    path = tmp_path_factory.mktemp("video") / "in.mp4"
    write_synthetic_video(path, 16, h=H, w=W)
    with VideoReader(str(path), begin=0) as r:
        return np.stack(list(r.frames(0, 16)))


@pytest.mark.parametrize("cfg,shape", [(SIX, (1, 4)), (SIX, (2, 4)),
                                       (TINY, (1, 8))],
                         ids=["6heads-1x4", "6heads-2x4", "tiny-1x8"])
def test_sharded_matches_jax_sharded(video_frames, cfg, shape):
    """The port's pipeline on a (data, model) mesh of CPU devices whose
    ranks hold unequal head counts (or none) against the JAX package's on
    the same mesh of virtual CPU devices and the same weights, two steps at
    depth_stride 2: each slot's state field by field (DEPTH_REL), the right
    half equal to the input, >= 99.9% of the left pixels equal."""
    d, m = shape
    jmodel = JaxDepthAnythingV2(cfg, dtype=jnp.float32)
    weights = random_state_dict(cfg, seed=31)
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(weights, cfg))
    run_cfg = dataclasses.replace(CFG, depth_stride=2)
    jsp = JaxShardedSbsPipeline(
        jmodel, jparams, H, W,
        jax_make_mesh(shape, devices=jax.devices()[:d * m]), run_cfg=run_cfg)
    sp = ShardedSbsPipeline(build_model(cfg, weights, torch.float32, "cpu"),
                            H, W, make_mesh(shape, devices=["cpu"] * (d * m)),
                            run_cfg=run_cfg)
    assert [[b.pretrained.blocks[0].attn.num_heads for b in r.model.ranks]
            for r in sp.replicas] == [heads_of(cfg, m)] * d
    states, jstates = sp.initial_state(), jsp.initial_state()
    for k in range(2):
        batch = video_frames[2 * d * k:2 * d * (k + 1)]
        sbs, states = sp.step(batch, states)
        jsbs, jstates = jsp.step(batch, jstates)
        ours, jsbs = torch.cat(sbs).numpy(), np.asarray(jsbs)
        np.testing.assert_array_equal(ours[:, :, W:], batch)
        same = np.all(ours[:, :, :W] == jsbs[:, :, :W], axis=-1).mean()
        assert same >= 0.999, f"step {k}: {same:.5f} of left pixels equal"
        for i in range(d):
            _assert_state_close(states[i],
                                jax.tree.map(lambda a: a[i], jstates))


def test_cli_mesh_1x4_writes_subclips_that_check(tmp_path):
    """``cli.main --mesh 1x4 --device cpu`` at vits (6 heads on 4 ranks: 1,
    2, 1, 2) through the real writer (cv2): contiguous subclips that check
    clean, and the sharded log."""
    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch.video.check import check_subclips
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips

    path = str(tmp_path / "in.mp4")
    write_synthetic_video(path, 8)
    sub = str(tmp_path / "S") + "/"
    assert cli.main(["--device", "cpu", "--VideoDir", path,
                     "--OutputDir", str(tmp_path / "o.mkv"),
                     "--DebugDir", str(tmp_path / "D") + "/",
                     "--SubClipDir", sub, "--batch_size", "2",
                     "--input_size", "56", "--compute_dtype", "float32",
                     "--Max_Frame_Count", "4", "--mlp_fused", "xla",
                     "--tail", "xla", "--allow_random_weights",
                     "--encoder", "vits", "--mesh", "1x4",
                     "--writer_backend", "cv2", "--repair_mode", "1"]) == 0
    assert sorted_subclips(sub) == ["0_3.mp4", "4_7.mp4"]
    assert check_subclips(sub) == []
    assert os.listdir(tmp_path / "D") == ["sharded_p0.txt"]
