"""PyTorch port, model: weight conversion and the DepthAnythingV2 forward
against the JAX model (mlp_fused="xla", tail="xla") at f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2, infer_depth as jax_infer_depth)
from vr_video_generator_tpu.models.factory import random_params
from vr_video_generator_tpu.utils.config import ModelConfig
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         load_model,
                                                         random_state_dict)

torch.set_num_threads(2)

# 3 blocks, D=128 (2 heads of 64: D % 128 == 0 keeps the Pallas LN path
# valid), a narrow DPT head.
TINY = ModelConfig(encoder="vits", embed_dim=128, depth=3, num_heads=2,
                   mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                   intermediate_layers=(0, 1, 2, 2), depth_scaler=1.618,
                   mlp_fused="xla")


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _lookup(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_state_dict_round_trip_on_random_params():
    """convert_state_dict(state_dict_from_jax(p)) == p, leaf for leaf."""
    cfg = ModelConfig(encoder="vits", embed_dim=128, depth=1, num_heads=2,
                      features=16, out_channels=(8, 16, 32, 32),
                      intermediate_layers=(0, 0, 0, 0), mlp_fused="xla")
    params = random_params(JaxDepthAnythingV2(cfg, dtype=jnp.float32,
                                              tail="xla"))
    params = jax.tree.map(np.asarray, params)
    back = convert_state_dict(state_dict_from_jax(params, cfg), cfg)
    leaves = _leaves_with_paths(params)
    assert len(leaves) > 50
    for path, leaf in leaves:
        np.testing.assert_array_equal(_lookup(back, path), leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_state_dict_keys_are_upstream_names():
    sd = random_state_dict(TINY, seed=0)
    for key in ("pretrained.blocks.0.attn.qkv.weight",
                "pretrained.blocks.2.ls2.gamma", "pretrained.mask_token",
                "pretrained.patch_embed.proj.weight",
                "depth_head.resize_layers.0.weight",
                "depth_head.scratch.refinenet4.resConfUnit1.conv1.weight",
                "depth_head.scratch.output_conv2.2.bias"):
        assert key in sd
    model = build_model(TINY, sd, torch.float32, "cpu")
    assert set(model.state_dict()) == set(sd)


def test_pth_round_trip_through_load_model(tmp_path):
    sd = random_state_dict(TINY, seed=3)
    path = tmp_path / "tiny.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    model = load_model("vits", str(path), dtype=torch.float32, device="cpu",
                       cfg=TINY)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    with pytest.raises(FileNotFoundError):
        load_model("vits", str(tmp_path / "missing.pth"), device="cpu",
                   cfg=TINY)


def test_bf16_keeps_norms_and_pos_embed_f32():
    model = build_model(TINY, random_state_dict(TINY), torch.bfloat16, "cpu")
    params = dict(model.named_parameters())
    assert params["pretrained.blocks.0.norm1.weight"].dtype == torch.float32
    assert params["pretrained.pos_embed"].dtype == torch.float32
    assert params["pretrained.blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert params["pretrained.blocks.0.ls1.gamma"].dtype == torch.bfloat16


@pytest.mark.parametrize("hw", [(48, 80), (70, 56)])
def test_depth_matches_jax_model(hw):
    """Same converted weights, non-square input (the pos-embed bicubic with
    the +0.1 offset runs): depth within 1e-4 of its max."""
    sd = random_state_dict(TINY, seed=1)
    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla")
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(sd, TINY))
    model = build_model(TINY, sd, torch.float32, "cpu")
    frames = np.random.default_rng(5).integers(0, 256, (2, *hw, 3),
                                               dtype=np.uint8)
    ref = np.asarray(jax.jit(lambda p, f: jax_infer_depth(
        jmodel, p, f, input_size=56))(jparams, jnp.asarray(frames)))
    with torch.inference_mode():
        ours = infer_depth(model, torch.from_numpy(frames),
                           input_size=56).numpy()
    assert ours.shape == ref.shape == (2, *hw)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
