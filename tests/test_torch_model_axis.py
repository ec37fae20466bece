"""PyTorch port: the model axis on the CPU. The partition rules against the
JAX package's ``param_specs``, the shards and their gather, the model-group
collectives, one Block and the whole depth net across a group of 2 and 4
ranks against the port's 1 x 1, ``ShardedSbsPipeline`` at (1, 2), (2, 2)
and (4, 2) against the JAX package's on the same mesh of virtual CPU
devices, ``run_sharded`` and ``cli.main --mesh 2x2``, and the refusals."""

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
from vr_video_generator_tpu.parallel.sharding import (
    param_specs as jax_param_specs)
from vr_video_generator_tpu.utils.config import ModelConfig, RunConfig
from vr_video_generator_tpu_torch.models.depth_anything_v2 import \
    DepthAnythingV2
from vr_video_generator_tpu_torch.models.dinov2 import group_block
from vr_video_generator_tpu_torch.models.factory import (build_group,
                                                         build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.parallel.collectives import (all_reduce_,
                                                               broadcast_)
from vr_video_generator_tpu_torch.parallel.mesh import Mesh, make_mesh
from vr_video_generator_tpu_torch.parallel.sharded import ShardedSbsPipeline
from vr_video_generator_tpu_torch.parallel.sharding import (
    check_model_axis, gather_state_dict, param_specs, shard_state_dict)
from vr_video_generator_tpu_torch.runtime import sharded_runner as runner
from vr_video_generator_tpu_torch.video import writer as port_writer
from vr_video_generator_tpu_torch.video.reader import VideoReader

torch.set_num_threads(2)

CFG = RunConfig(batch_size=2, input_size=56, compute_dtype="float32")
# A group against the port's 1 x 1 at f32: the split products sum their
# partials in another order, so depth and tokens agree within REL of their
# peak.
REL = 1e-5
# Against the JAX package, as tests/test_torch_sharded.py holds the data
# axis: the depth carries within DEPTH_REL of their peak, the offset range
# to 1e-5 relative, the flags exactly, >= 99.9% of the left SBS pixels.
DEPTH_REL = 1e-4
# TINY at 4 heads (M = 4 splits them), and at D = 128 where `fused` runs
# the fused halves' plain versions (2 heads of 64: both halves fuse; 4
# heads of 32: only the MLP half does, the attention half splits).
TINY4 = dataclasses.replace(TINY, embed_dim=64, num_heads=4)
WIDE = {2: dataclasses.replace(TINY, embed_dim=128, num_heads=2),
        4: dataclasses.replace(TINY, embed_dim=128, num_heads=4)}


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=16)


@pytest.fixture(scope="module")
def model(weights):
    return build_model(TINY, weights, torch.float32, "cpu")


@pytest.fixture(scope="module")
def jax_model(weights):
    return (JaxDepthAnythingV2(TINY, dtype=jnp.float32),
            jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY)))


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "in.mp4"
    write_synthetic_video(path, 16, h=H, w=W)
    with VideoReader(str(path), begin=0) as r:
        frames = np.stack(list(r.frames(0, 16)))
    return str(path), frames


def cfg_for(m, mlp_fused):
    base = TINY4 if mlp_fused == "xla" and m == 4 else \
        (TINY if mlp_fused == "xla" else WIDE[m])
    return dataclasses.replace(base, mlp_fused=mlp_fused)


def sharded(model, shape, **kw):
    d, m = shape
    return ShardedSbsPipeline(model, H, W,
                              make_mesh(shape, devices=["cpu"] * (d * m)),
                              run_cfg=dataclasses.replace(CFG, **kw))


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


# ------------------------------------------------------ the partition rules

def _jax_split(params):
    """{port name: torch dim} of the parameters JAX ``param_specs`` splits,
    its (in, out) kernels read in torch's (out, in) layout."""
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            jax_param_specs(params)):
        if spec == jax.sharding.PartitionSpec():
            continue
        keys = [p.key for p in path]
        assert keys[0] == "pretrained" and keys[1].startswith("block"), keys
        leaf = "weight" if keys[-1] == "kernel" else "bias"
        name = ".".join(["pretrained", "blocks", keys[1][5:], *keys[2:-1],
                         leaf])
        out[name] = 0 if spec[-1] == "model" else 1
    return out


@pytest.mark.parametrize("encoder", ["tiny", "vits", "vitb", "vitl", "vitg"])
def test_param_specs_match_jax(encoder):
    """The port's rules split exactly the parameters JAX ``param_specs``
    splits on the same model, along the same features; no weight is built
    (JAX traces its init abstractly, the port's model is on the meta
    device)."""
    cfg = TINY if encoder == "tiny" else ModelConfig.for_encoder(encoder)
    jmodel = JaxDepthAnythingV2(cfg, dtype=jnp.float32)
    params = jax.eval_shape(lambda: random_params(jmodel))
    with torch.device("meta"):
        names = DepthAnythingV2(cfg).state_dict()
    ours = {k: v for k, v in param_specs(names).items() if v is not None}
    assert ours == _jax_split(params)
    per_block = 3 if cfg.ffn_layer == "swiglufused" else 6
    assert len(ours) == per_block * cfg.depth


@pytest.mark.parametrize("m", [2, 4])
def test_shards_gather_back_bit_for_bit(m):
    """Every rank's shard_state_dict gathers back to the whole state_dict
    bit for bit, as numpy arrays and as tensors; replicated parameters are
    whole on every rank, split ones 1/m of it."""
    sd = random_state_dict(TINY4, seed=3)
    shards = [shard_state_dict(sd, r, m, TINY4.num_heads) for r in range(m)]
    for name, whole in gather_state_dict(shards).items():
        np.testing.assert_array_equal(whole, sd[name])
    tshards = [{k: torch.from_numpy(v) for k, v in s.items()} for s in shards]
    for name, whole in gather_state_dict(tshards).items():
        assert torch.equal(whole, torch.from_numpy(sd[name])), name
    for name, spec in param_specs(sd).items():
        size = shards[0][name].size
        assert size == (sd[name].size if spec is None
                        else sd[name].size // m), name


def test_qkv_shard_is_its_heads():
    """Rank r's qkv rows are q, k and v of heads [r H/m, (r + 1) H/m): its
    output reshapes to (3, H/m, head_dim) as the whole one does."""
    sd = random_state_dict(TINY4, seed=4)
    name = "pretrained.blocks.1.attn.qkv.weight"
    whole = sd[name].reshape(3, 4, 16, 64)  # (q/k/v, heads, head_dim, D)
    for r in range(2):
        got = shard_state_dict(sd, r, 2, 4)[name].reshape(3, 2, 16, 64)
        np.testing.assert_array_equal(got, whole[:, 2 * r:2 * r + 2])


@pytest.mark.parametrize("m", [2, 4])
def test_build_group_holds_the_shards(m):
    """Rank r of ``build_group`` holds ``shard_state_dict(state_dict, r, m)``
    bit for bit, in the model's dtypes, on its device."""
    sd = random_state_dict(TINY4, seed=5)
    whole = build_model(TINY4, sd, torch.bfloat16, "cpu")
    group = build_group(whole, ["cpu"] * m)
    assert group.devices == [torch.device("cpu")] * m
    for r, rank in enumerate(group.ranks):
        want = shard_state_dict(whole.state_dict(), r, m, TINY4.num_heads)
        got = rank.state_dict()
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, name
            assert torch.equal(got[name], want[name]), name


# ---------------------------------------------------------- the collectives

def test_all_reduce_on_co_located_ranks():
    """On ranks that share a device the all-reduce is a sum there, in the
    tensors' dtype, left in every tensor."""
    gen = torch.Generator().manual_seed(0)
    ts = [torch.randn(5, 7, generator=gen).to(torch.bfloat16)
          for _ in range(4)]
    want = ((ts[0] + ts[1]) + ts[2]) + ts[3]
    all_reduce_(ts)
    for t in ts:
        assert t.dtype == torch.bfloat16 and torch.equal(t, want)


def test_broadcast_on_co_located_ranks():
    src = torch.arange(12.0).reshape(3, 4)
    ts = [src.clone()] + [torch.empty(3, 4) for _ in range(3)]
    broadcast_(ts)
    for t in ts:
        assert torch.equal(t, src)


# ----------------------------------------------- a Block and the depth net

@pytest.mark.parametrize("mlp_fused", ["xla", "fused"])
@pytest.mark.parametrize("m", [2, 4])
def test_block_matches_1x1(m, mlp_fused):
    """One Block across a group of m CPU ranks against the port's Block at
    1 x 1 on the same tokens, f32, within REL; at ``fused`` the fused
    halves run on whole weights gathered from the shards."""
    cfg = cfg_for(m, mlp_fused)
    whole = build_model(cfg, random_state_dict(cfg, seed=6), torch.float32,
                        "cpu")
    group = build_group(whole, ["cpu"] * m)
    x = torch.randn(2, 37, cfg.embed_dim,
                    generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = whole.pretrained.blocks[0](x)
        got = group_block([r.pretrained.blocks[0] for r in group.ranks],
                          [x.clone() for _ in range(m)])
    for g in got:
        assert rel_err(g, want) <= REL
    blk = group.ranks[0].pretrained.blocks[0]
    if mlp_fused == "fused":
        assert "mlp.fc1.weight" in blk.whole
        assert torch.equal(blk.whole["mlp.fc1.weight"],
                           whole.pretrained.blocks[0].mlp.fc1.weight)
        assert ("attn.qkv.weight" in blk.whole) == (m == 2)
    else:
        assert blk.whole == {}


@pytest.mark.parametrize("mlp_fused", ["xla", "fused"])
@pytest.mark.parametrize("m", [2, 4])
def test_depth_matches_1x1(m, mlp_fused):
    """The whole depth net across a group against the port's 1 x 1 on the
    same input, f32, within REL of its peak."""
    cfg = cfg_for(m, mlp_fused)
    whole = build_model(cfg, random_state_dict(cfg, seed=7), torch.float32,
                        "cpu")
    group = build_group(whole, ["cpu"] * m)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 56, 98, 3)).astype(np.float32))
    with torch.inference_mode():
        want, got = whole(x), group(x)
    assert got.shape == want.shape
    assert rel_err(got, want) <= REL


def test_swiglu_half_is_replicated():
    """vitg's SwiGLU half: the rules replicate w12 and w3, so every rank
    holds them whole and runs the half whole; the attention half splits."""
    cfg = dataclasses.replace(TINY4, ffn_layer="swiglufused", mlp_fused="xla")
    whole = build_model(cfg, random_state_dict(cfg, seed=8), torch.float32,
                        "cpu")
    group = build_group(whole, ["cpu"] * 2)
    blk = group.ranks[1].pretrained.blocks[2]
    assert torch.equal(blk.mlp.w12.weight,
                       whole.pretrained.blocks[2].mlp.w12.weight)
    assert blk.attn.qkv.weight.shape[0] == 3 * 64 // 2
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 56, 56, 3)).astype(np.float32))
    with torch.inference_mode():
        assert rel_err(group(x), whole(x)) <= REL


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


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2)])
def test_sharded_matches_jax_sharded(model, jax_model, video, shape):
    """The port's pipeline on a (data, model) mesh of CPU devices against
    the JAX package's on the same mesh of virtual CPU devices, two steps at
    depth_stride 2: each slot's state field by field (DEPTH_REL), the right
    half equal to the input, >= 99.9% of the left pixels equal."""
    _, frames = video
    jmodel, jparams = jax_model
    d, m = shape
    cfg = dataclasses.replace(CFG, depth_stride=2)
    jsp = JaxShardedSbsPipeline(
        jmodel, jparams, H, W,
        jax_make_mesh(shape, devices=jax.devices()[:d * m]), run_cfg=cfg)
    sp = sharded(model, shape, depth_stride=2)
    assert [r.model.devices for r in sp.replicas] == [
        [torch.device("cpu")] * m] * d
    states, jstates = sp.initial_state(), jsp.initial_state()
    for k in range(2):
        batch = frames[2 * d * k:2 * d * (k + 1)]
        sbs, states = sp.step(batch, states)
        jsbs, jstates = jsp.step(batch, jstates)
        ours, jsbs = torch.cat(sbs).numpy(), np.asarray(jsbs)
        np.testing.assert_array_equal(ours[:, :, W:], batch)
        same = np.all(ours[:, :, :W] == jsbs[:, :, :W], axis=-1).mean()
        assert same >= 0.999, f"step {k}: {same:.5f} of left pixels equal"
        for i in range(d):
            _assert_state_close(states[i],
                                jax.tree.map(lambda a: a[i], jstates))


def test_stride_audit_on_a_group_matches_1x1(model, video):
    """The per-slot audit of a (2, 2) pipeline against the (2, 1) one's
    within REL; the states are left as they were."""
    _, frames = video
    groups, singles = sharded(model, (2, 2), depth_stride=2), \
        sharded(model, (2, 1), depth_stride=2)
    states = groups.initial_state()
    got = groups.stride_audit(frames[:4], states)
    want = singles.stride_audit(frames[:4], singles.initial_state())
    assert sorted(got) == [0, 1]
    for i in (0, 1):
        assert abs(got[i][0] - want[i][0]) <= REL * max(want[i][0], 1e-6)
    assert all(not bool(st.has_state) for st in states)


class Capture:
    """A SubclipWriter stand-in that keeps the raw frames (no codec)."""

    def __init__(self, clips):
        self.clips = clips

    def __call__(self, *a, **k):
        return self

    def write_clip(self, begin, frames):
        self.clips[begin] = np.stack(frames)

    def close(self):
        pass


def test_run_sharded_2x2_matches_one_device_a_slot(model, video,
                                                   monkeypatch):
    """``run_sharded`` at (2, 2) with a warm-up against the same run at
    (2, 1), one device a slot: the same subclips, right halves equal,
    >= 99.9% of the left pixels equal."""
    path, _ = video
    runs = {}
    for shape in ((2, 2), (2, 1)):
        clips = {}
        monkeypatch.setattr(port_writer, "SubclipWriter", Capture(clips))
        n = runner.run_sharded(sharded(model, shape), path, "unused/", 0, 12,
                               max_frame_count=4, batch_size=2,
                               reader_backend="cv2", warmup=4)
        assert n == 12
        runs[shape] = clips
    got, want = runs[(2, 2)], runs[(2, 1)]
    assert sorted(got) == sorted(want) == [0, 4, 6, 10]
    for k in want:
        np.testing.assert_array_equal(got[k][:, :, W:], want[k][:, :, W:])
        same = np.all(got[k] == want[k], axis=-1).mean()
        assert same >= 0.999, f"clip {k}: {same:.5f}"


def test_cli_mesh_2x2_writes_subclips_that_check(tmp_path):
    """``cli.main --mesh 2x2 --device cpu`` through the real writer (cv2):
    contiguous subclips that check clean, and the sharded log."""
    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch.video.check import check_subclips
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips

    path = str(tmp_path / "in.mp4")
    write_synthetic_video(path, 10)
    sub = str(tmp_path / "S") + "/"
    assert cli.main(["--device", "cpu", "--VideoDir", path,
                     "--OutputDir", str(tmp_path / "o.mkv"),
                     "--DebugDir", str(tmp_path / "D") + "/",
                     "--SubClipDir", sub, "--batch_size", "2",
                     "--input_size", "56", "--compute_dtype", "float32",
                     "--Max_Frame_Count", "3", "--mlp_fused", "xla",
                     "--tail", "xla", "--allow_random_weights",
                     "--mesh", "2x2", "--writer_backend", "cv2",
                     "--repair_mode", "1"]) == 0
    assert sorted_subclips(sub) == ["0_2.mp4", "3_4.mp4", "5_7.mp4",
                                    "8_9.mp4"]
    assert check_subclips(sub) == []
    assert os.listdir(tmp_path / "D") == ["sharded_p0.txt"]


# ------------------------------------------------------------ the refusals

def test_refuses_a_model_axis_that_does_not_divide_the_heads(model):
    """A model axis is refused where the JAX package's ``device_put``
    refuses it, naming the dimension, before any shard is built: vits' D =
    384 at M = 5, vitl's D = 1024 at M = 3, TINY's D = 32 at M = 3 in the
    pipeline. A head count that M does not divide is no refusal (vits' 6
    heads at M = 4, vitg's 24 at M = 16)."""
    with pytest.raises(ValueError,
                       match="model axis of 5 .*vits's embedding width 384"):
        check_model_axis(ModelConfig.for_encoder("vits"), 5)
    with pytest.raises(ValueError,
                       match="model axis of 3 .*vitl's embedding width 1024"):
        check_model_axis(ModelConfig.for_encoder("vitl"), 3)
    check_model_axis(ModelConfig.for_encoder("vits"), 4)
    check_model_axis(ModelConfig.for_encoder("vitl"), 4)
    check_model_axis(ModelConfig.for_encoder("vitg"), 16)
    with pytest.raises(ValueError, match="model axis of 3"):
        sharded(model, (1, 3))


def test_refuses_a_group_spanning_processes(model):
    """A slot's model group must lie inside one process."""
    mesh = Mesh([[torch.device("cpu")] * 2], processes=[[0, 1]])
    with pytest.raises(ValueError, match="spans processes"):
        ShardedSbsPipeline(model, H, W, mesh, run_cfg=CFG)


def test_a_partly_owned_mesh_takes_local_frames(model, video, monkeypatch):
    """Process 0 of two, owning slots 0 and 1 of a (4, 2) mesh, builds
    replicas for those only; ``step`` refuses (it takes every slot's
    frames) and ``step_local`` runs the owned slots, equal to a (2, 2)
    pipeline bit for bit."""
    import vr_video_generator_tpu_torch.parallel.sharded as sharded_mod

    _, frames = video
    whole = sharded(model, (2, 2))
    want, _ = whole.step(frames[:4], whole.initial_state())
    cpu = torch.device("cpu")
    mesh = Mesh([[cpu] * 2] * 4, processes=[[0, 0], [0, 0], [1, 1], [1, 1]])
    monkeypatch.setattr(sharded_mod, "process_count", lambda: 2)
    sp = ShardedSbsPipeline(model, H, W, mesh, run_cfg=CFG)
    assert sp.local_slots == [0, 1] and sp.multi_host
    assert len(sp.replicas) == 2
    states = sp.initial_state()
    with pytest.raises(ValueError, match="step_local"):
        sp.step(frames[:8], states)
    sbs, _ = sp.step_local(frames[:4], states)
    for g, w in zip(sbs, want):
        assert torch.equal(g, w)
