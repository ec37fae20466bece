"""PyTorch port: its checkpoint directories (models/checkpoint.py) and
load_model's directory branch, against the JAX package's Orbax checkpoint
on the same parameters, and fault 4 (a checkpoint directory never falls
through to random weights)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models import checkpoint as jax_checkpoint
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2, infer_depth as jax_infer_depth)
from vr_video_generator_tpu.models.factory import random_params
from vr_video_generator_tpu.utils.config import ModelConfig
from vr_video_generator_tpu_torch.models import checkpoint
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         load_model,
                                                         random_state_dict)

torch.set_num_threads(2)

# 2 blocks, D = 128 (2 heads of 64), a narrow DPT head.
TINY = ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                   mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                   intermediate_layers=(0, 1, 1, 1), depth_scaler=1.618,
                   mlp_fused="xla")


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=16)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(16).integers(0, 256, (2, 48, 80, 3),
                                              dtype=np.uint8)


def depth(model, frames):
    with torch.inference_mode():
        return infer_depth(model, torch.from_numpy(frames),
                           input_size=56).numpy()


def test_save_writes_manifest_and_tensors(tmp_path, weights):
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, weights, encoder="vits")
    assert sorted(os.listdir(path)) == ["manifest.json", "tensors.pt"]
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    assert meta == {"format": checkpoint.FORMAT, "version": checkpoint.VERSION,
                    "encoder": "vits"}
    assert checkpoint.manifest(path) == meta


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_round_trip_is_bit_exact(tmp_path, weights, kind):
    """save then load gives every tensor back, dtype and bits, from a numpy
    or a torch state_dict."""
    sd = weights if kind == "numpy" else {k: torch.from_numpy(v)
                                          for k, v in weights.items()}
    path = str(tmp_path / kind)
    checkpoint.save(path, sd)
    back = checkpoint.load(path)
    assert set(back) == set(weights)
    for k, v in back.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), weights[k], err_msg=k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_load_model_from_directory_same_output(tmp_path, weights, frames,
                                               dtype):
    """A port checkpoint directory through load_model gives the model of
    its state_dict: the same parameters and the same depth, bit for bit
    (f32 and bf16)."""
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, weights)
    model = load_model("vits", path, dtype=dtype, device="cpu", cfg=TINY)
    direct = build_model(TINY, weights, dtype, "cpu")
    for (k, a), b in zip(model.state_dict().items(),
                         direct.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    np.testing.assert_array_equal(depth(model, frames), depth(direct, frames))


def test_directory_wins_over_allow_random(tmp_path, weights, frames):
    """With allow_random, a checkpoint directory still loads its weights,
    not the seeded random ones (the JAX load_model's directory branch comes
    first)."""
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, weights)
    model = load_model("vits", path, dtype=torch.float32, device="cpu",
                       cfg=TINY, allow_random=True, seed=0)
    rand = load_model("vits", None, dtype=torch.float32, device="cpu",
                      cfg=TINY, allow_random=True, seed=0)
    np.testing.assert_array_equal(
        model.state_dict()["pretrained.blocks.0.attn.qkv.weight"].numpy(),
        weights["pretrained.blocks.0.attn.qkv.weight"])
    assert not np.array_equal(depth(model, frames), depth(rand, frames))


def test_jax_tree_through_the_port_format(tmp_path, frames):
    """A parameter tree that the JAX package saves and loads with its Orbax
    checkpoint, converted with state_dict_from_jax, saved and loaded in the
    port's format: the port's depth unchanged by the round trip (bit for
    bit) and within 1e-4 of the JAX model's on those parameters."""
    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla")
    params = random_params(jmodel)
    orbax_dir = str(tmp_path / "orbax")
    jax_checkpoint.save(orbax_dir, params)
    restored = jax_checkpoint.load(orbax_dir, like=params)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, restored), TINY)
    port_dir = str(tmp_path / "port")
    checkpoint.save(port_dir, sd)
    model = load_model("vits", port_dir, dtype=torch.float32, device="cpu",
                       cfg=TINY)
    ours = depth(model, frames)
    np.testing.assert_array_equal(
        ours, depth(build_model(TINY, sd, torch.float32, "cpu"), frames))
    ref = np.asarray(jax.jit(lambda p, f: jax_infer_depth(
        jmodel, p, f, input_size=56))(restored, jnp.asarray(frames)))
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


# Fault 4: the port read a directory as a missing file, and with
# allow_random ran seeded random weights where the JAX package runs the
# checkpoint. Every directory that is not a port checkpoint now raises,
# whatever allow_random is.
@pytest.mark.parametrize("allow_random", [True, False])
def test_orbax_directory_raises(tmp_path, allow_random):
    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla")
    orbax_dir = str(tmp_path / "orbax")
    jax_checkpoint.save(orbax_dir, random_params(jmodel))
    with pytest.raises(ValueError, match="Orbax checkpoint.*\\.pth"):
        load_model("vits", orbax_dir, dtype=torch.float32, device="cpu",
                   cfg=TINY, allow_random=allow_random)


@pytest.mark.parametrize("allow_random", [True, False])
def test_empty_directory_raises(tmp_path, allow_random):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="an empty directory"):
        load_model("vits", str(empty), dtype=torch.float32, device="cpu",
                   cfg=TINY, allow_random=allow_random)


@pytest.mark.parametrize("manifest", [None, {"format": "other"}, "not json"])
def test_unknown_directory_raises(tmp_path, manifest):
    d = tmp_path / "other"
    d.mkdir()
    (d / "weights.bin").write_bytes(b"\0" * 8)
    if manifest is not None:
        (d / "manifest.json").write_text(
            manifest if isinstance(manifest, str) else json.dumps(manifest))
    with pytest.raises(ValueError, match="no checkpoint of the port's format"):
        load_model("vits", str(d), dtype=torch.float32, device="cpu",
                   cfg=TINY, allow_random=True)


def test_newer_version_raises(tmp_path, weights):
    path = tmp_path / "ckpt"
    checkpoint.save(str(path), weights)
    meta = json.loads((path / "manifest.json").read_text())
    (path / "manifest.json").write_text(json.dumps({**meta, "version": 2}))
    with pytest.raises(ValueError, match="version 2"):
        checkpoint.load(str(path))


def test_pth_and_missing_paths_unchanged(tmp_path, weights):
    """A .pth file still loads; a missing path still raises without
    allow_random and runs seeded random weights with it."""
    pth = tmp_path / "tiny.pth"
    torch.save({k: torch.from_numpy(v) for k, v in weights.items()}, pth)
    model = load_model("vits", str(pth), dtype=torch.float32, device="cpu",
                       cfg=TINY)
    np.testing.assert_array_equal(
        model.state_dict()["depth_head.scratch.output_conv2.2.weight"].numpy(),
        weights["depth_head.scratch.output_conv2.2.weight"])
    missing = str(tmp_path / "missing.pth")
    with pytest.raises(FileNotFoundError):
        load_model("vits", missing, device="cpu", cfg=TINY)
    assert load_model("vits", missing, dtype=torch.float32, device="cpu",
                      cfg=TINY, allow_random=True) is not None


def test_cli_with_checkpoint_directory(tmp_path, weights):
    """The CLI takes a checkpoint directory as --encoder_path (the full
    vits width: the CLI builds the encoder's own config) and refuses an
    empty one even with --allow_random_weights."""
    cv2 = pytest.importorskip("cv2")
    from vr_video_generator_tpu_torch.cli import main
    from vr_video_generator_tpu_torch.utils.config import \
        ModelConfig as PortModelConfig

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for i in range(3):
        w.write(np.full((48, 64, 3), 60 * i, np.uint8))
    w.release()
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, random_state_dict(PortModelConfig.for_encoder("vits"),
                                            seed=1))
    run = ["--device", "cpu", "--VideoDir", src,
           "--OutputDir", str(tmp_path / "o.mkv"),
           "--DebugDir", str(tmp_path / "D") + "/",
           "--SubClipDir", str(tmp_path / "S") + "/", "--batch_size", "4",
           "--input_size", "28", "--compute_dtype", "float32",
           "--mlp_fused", "xla", "--tail", "xla", "--repair_mode", "1"]
    assert main([*run, "--encoder_path", ckpt]) == 0
    assert sorted(os.listdir(tmp_path / "S")) == ["0_2.mp4"]
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="empty directory"):
        main([*run, "--encoder_path", str(empty), "--allow_random_weights"])
