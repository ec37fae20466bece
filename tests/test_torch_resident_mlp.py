"""PyTorch port on the CPU: the MLP half at the widths where the JAX package
keeps its weights resident (row 8, ``_kernel_resident``: vits' D = 384 and
vitb's D = 768), which the card now runs on row 9's chain (LayerNorm ->
fc1 + GELU -> fc2 + residual). The plain version against
``mlp_residual_pallas`` in interpret mode at the JAX tests' bounds; the
chain's plain stages, composed, equal the whole plain version bit for bit
on a ragged row count; and two vitb-width fused Blocks (D = 768, 12 heads)
against the JAX package's Block with ``mlp_fused="fused"``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.dinov2 import Block as JaxBlock
from vr_video_generator_tpu.ops.mlp_pallas import mlp_residual_pallas
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)

# Two vitb-width blocks (D = 768, 12 heads of 64) with a narrow head.
VITB2 = dataclasses.replace(
    config.ModelConfig(), encoder="vitb", embed_dim=768, depth=2,
    num_heads=12, features=32, out_channels=(8, 16, 32, 32),
    intermediate_layers=(0, 1, 1, 1), mlp_fused="fused")


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _mlp_params(rng, d):
    """Seeded MLP-half parameters in the JAX package's layout (w1 (D, 4D),
    w2 (4D, D)), LeCun-scaled as the models initialise them, with non-zero
    biases."""
    hid = 4 * d
    return dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, hid)) * d ** -0.5).astype(np.float32),
        b1=(0.1 * rng.standard_normal(hid)).astype(np.float32),
        w2=(rng.standard_normal((hid, d)) * hid ** -0.5).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))


def _port_args(x, p, tdt):
    """The port's operands (PyTorch layout; LN affine f32) of numpy x, p."""
    return (_t(x, tdt), _t(p["ln_scale"]), _t(p["ln_bias"]),
            _t(p["w1"].T, tdt), _t(p["b1"], tdt), _t(p["w2"].T, tdt),
            _t(p["b2"], tdt), _t(p["gamma"], tdt))


@pytest.mark.parametrize("dtype,atol", [
    (jnp.float32, 2e-5),    # the JAX tests' bounds
    (jnp.bfloat16, 6e-2),   # (tests/test_mlp_pallas.py:44,58)
])
@pytest.mark.parametrize("d,m", [(384, 100), (768, 72)])
def test_resident_mlp_plain_matches_pallas_interpret(d, m, dtype, atol):
    """The plain version of rows 8 and 9 against mlp_residual_pallas
    (interpret mode) at the widths where the JAX package takes the
    weights-resident body in bf16 (in f32 at D = 768 the weights pass 10
    MiB, and it takes the hidden-blocked one: the same function)."""
    tdt = getattr(torch, str(jnp.dtype(dtype)))
    assert mlp.resident(d, 4 * d, torch.bfloat16)
    assert mlp.resident(d, 4 * d, tdt) == (tdt == torch.bfloat16 or d == 384)
    rng = np.random.default_rng(d + m)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = _mlp_params(rng, d)
    ref = mlp_residual_pallas(jnp.asarray(x, dtype),
                              **{k: jnp.asarray(v) for k, v in p.items()},
                              interpret=True)
    ours = mlp.mlp_residual(*_port_args(x, p, tdt))
    assert ours.dtype == tdt and ours.shape == (m, d)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [384, 768])
def test_resident_mlp_stages_compose_to_plain(d, dtype):
    """mlp_residual_stages on CPU tensors returns the chain's plain stages
    (LN, fc1 + GELU, fc2 + residual), shaped as x (two leading axes, 3 x 43
    rows: no multiple of a tile), and they compose to mlp_residual_plain
    bit for bit."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((3, 43, d)) * 0.5).astype(np.float32)
    args = _port_args(x, _mlp_params(rng, d), dtype)
    xt, lnw, lnb, w1, b1, w2, b2, gamma = args
    a, h, out = mlp.mlp_residual_stages(*args)
    assert a.shape == (3, 43, d) and h.shape == (3, 43, 4 * d)
    assert a.dtype == h.dtype == out.dtype == dtype
    assert torch.equal(a, layernorm_plain(xt, lnw, lnb))
    assert torch.equal(h, mlp.fc1_gelu_plain(a, w1, b1))
    assert torch.equal(out, mlp.fc2_residual_plain(h, w2, b2, gamma, xt))
    assert torch.equal(out, mlp.mlp_residual_plain(*args))
    assert torch.equal(out, mlp.mlp_residual(*args))


def test_resident_widths():
    """Row 8 takes the widths the JAX rule keeps resident (both weight
    matrices within 10 MiB in bf16 and the hidden width a multiple of 512:
    vits, vitb, D = 128 and 512), row 9 the others (vitl's, and a hidden
    width of 2080 at D = 640); every D % 128 == 0 fuses the MLP half."""
    bf16 = torch.bfloat16
    assert [d for d in (128, 384, 512, 768, 1024)
            if mlp.resident(d, 4 * d, bf16)] == [128, 384, 512, 768]
    assert not mlp.resident(640, 2080, bf16)
    for d in (128, 384, 512, 640, 768, 1024):
        assert resolve_block_fusion("fused", d, d // 64, 41, "cuda",
                                    bf16)[1]


def test_vitb_width_fused_blocks_match_jax():
    """Two port Blocks at vitb's width (both halves fused: the plain
    versions on the CPU) against the JAX package's Block(mlp_fused='fused')
    (Pallas in interpret mode), applied in turn, N = 41 tokens, f32 within
    3e-5 (the JAX package's fused-vs-unfused bound,
    tests/test_mlp_pallas.py)."""
    rng = np.random.default_rng(768)
    sd = random_state_dict(VITB2, seed=3)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(
                np.float32)
    model = build_model(VITB2, sd, torch.float32, "cpu")
    params = convert_state_dict(sd, VITB2)["pretrained"]
    x = rng.standard_normal((2, 41, 768)).astype(np.float32)
    jblk = JaxBlock(dim=768, num_heads=12, mlp_ratio=4.0, mlp_fused="fused")
    ref, ours = jnp.asarray(x), _t(x)
    for i, blk in enumerate(model.pretrained.blocks):
        assert blk.mlp_fused == "fused"
        ref = jblk.apply({"params": params[f"block{i}"]}, ref)
        ours = blk(ours)
    assert resolve_block_fusion("fused", 768, 12, 41, "cpu",
                                torch.float32)[1]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=3e-5)
