"""PyTorch port, f32 on the card: the GELU MLP half at f32 (rows 8 and 9,
``csrc/mlp_f32.cu``) on the CPU. The plain versions the f32 chain is held
against on the card, at f32, against the JAX package's
``mlp_residual_pallas`` at f32 in interpret mode: the weights-resident body
(row 8) at D = 128 and 384 and the hidden-blocked one (row 9) at D = 768 and
1024, each with the A&S GELU and with ``approx`` (the tanh GELU in f32),
within the JAX tests' f32 bound (2e-5, tests/test_mlp_pallas.py:37-45; the
port sums fc2 over all of K at once, the hidden-blocked body over 512-wide
blocks). The GELUs at f32 against the JAX package's, the stages composed
against the whole plain version, which body each width takes at f32 (the
JAX rule), and two vitl-width Blocks at f32 against the JAX Block."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.dinov2 import Block as JaxBlock
from vr_video_generator_tpu.ops import gelu as jax_gelu
from vr_video_generator_tpu.ops.mlp_pallas import mlp_residual_pallas
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact, gelu_tanh
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)

F32_ATOL = 2e-5  # the JAX tests' f32 bound for the MLP half


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _mlp_params(rng, d):
    """Seeded MLP-half parameters in the JAX package's layout (w1 (D, 4D),
    w2 (4D, D)), LeCun-scaled, with non-zero biases."""
    hid = 4 * d
    return dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, hid)) * d ** -0.5).astype(np.float32),
        b1=(0.1 * rng.standard_normal(hid)).astype(np.float32),
        w2=(rng.standard_normal((hid, d)) * hid ** -0.5).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))


def _port_args(x, p):
    """The port's operands (PyTorch layout, all f32) of numpy x, p."""
    return (_t(x), _t(p["ln_scale"]), _t(p["ln_bias"]), _t(p["w1"].T),
            _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]), _t(p["gamma"]))


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "tanh"])
@pytest.mark.parametrize("d,m", [(128, 200), (384, 100), (768, 72),
                                 (1024, 40)])
def test_f32_mlp_plain_matches_pallas_interpret(d, m, approx):
    """Rows 8 (D = 128, 384: the weights resident at f32) and 9 (D = 768,
    1024: hidden-blocked) at f32: the port's wrapper on CPU tensors (the
    plain version) and its stages against mlp_residual_pallas in interpret
    mode within 2e-5; each width on the body the JAX rule gives it."""
    assert mlp.resident(d, 4 * d, torch.float32) == (d <= 384)
    rng = np.random.default_rng(d + m + approx)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = _mlp_params(rng, d)
    ref = np.asarray(mlp_residual_pallas(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()},
        approx=approx))
    args = _port_args(x, p)
    half = mlp.mlp_residual if d <= 384 else mlp.mlp_residual_hblocked
    ours = half(*args, approx=approx)
    assert ours.dtype == torch.float32 and ours.shape == (m, d)
    assert np.abs(ours.numpy() - ref).max() <= F32_ATOL
    stages = (mlp.mlp_residual_stages if d <= 384
              else mlp.mlp_residual_hblocked_stages)(*args, approx=approx)
    assert torch.equal(stages[2], ours)


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "tanh"])
def test_f32_stages_compose_to_whole_plain(approx):
    """The f32 chain's three plain stages (row 1's LayerNorm, fc1 + b1 +
    GELU, fc2 + b2 + LayerScale + residual), on a ragged row count, compose
    to mlp_residual_plain bit for bit; fc1_gelu_kernel on CPU tensors is its
    second stage."""
    rng = np.random.default_rng(5 + approx)
    d, m = 128, 77
    x = rng.standard_normal((1, m, d)).astype(np.float32)
    args = _port_args(x, _mlp_params(rng, d))
    a, h, out = mlp.mlp_residual_stages(*args, approx=approx)
    assert torch.equal(a, layernorm_plain(args[0], args[1], args[2]))
    assert torch.equal(h, mlp.fc1_gelu_plain(a, args[3], args[4], approx))
    assert torch.equal(h, mlp.fc1_gelu_kernel(a, args[3], args[4], approx))
    assert h.shape == (1, m, 4 * d) and h.dtype == torch.float32
    assert torch.equal(out, mlp.fc2_residual_plain(h, args[5], args[6],
                                                   args[7], args[0]))
    assert torch.equal(out, mlp.mlp_residual_plain(*args, approx=approx))


def _f32_sweep():
    """Every finite bf16 value as f32, and a dense sweep of f32 values over
    [-8, 8] with the neighbourhood of -5.7 (where the A&S form flushes to
    -0.0) at every f32 step for a few thousand steps. Values below 2^-124 in
    magnitude are left out: XLA's CPU backend flushes subnormal results to
    zero and PyTorch keeps them (tests/test_torch_gelu_tanh.py)."""
    bf = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).float()
    bf = bf[torch.isfinite(bf) & (bf.abs() >= 2.0 ** -124)]
    dense = torch.linspace(-8.0, 8.0, 200001)
    start = torch.tensor(-5.75).view(torch.int32)
    flush = (start - torch.arange(0, 8192, dtype=torch.int32)).view(
        torch.float32)
    return torch.cat([bf, dense, flush])


def _ulps_of_x(ours, ref, x):
    """|ours - ref| in f32 ulps of max(|ref|, |x|): GELU(x) = 0.5 x (1 +
    erf), so a one-ulp difference of the exp or the tanh moves the result by
    about an ulp of 0.5 |x|, however small the result."""
    size = np.maximum(np.abs(ref), np.abs(x)).astype(np.float32)
    return np.abs(ours.astype(np.float64) - ref) / np.spacing(size)


def test_gelu_exact_f32_matches_jax():
    """ops/gelu.gelu_exact on f32 against the JAX package's gelu_exact on
    the same f32 values: the A&S polynomial's steps are the same rounded
    operations, XLA's exp on the CPU and PyTorch's differ in the last ulp
    here and there, so within 1 f32 ulp of max(|gelu|, |x|) (measured: 1,
    at 0.5% of the inputs); the flush to -0.0 lands at the same input."""
    x = _f32_sweep().numpy()
    ours = gelu_exact(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_gelu.gelu_exact(jnp.asarray(x)))
    assert _ulps_of_x(ours, ref, x).max() <= 1
    assert ((ours == 0) == (ref == 0)).all()


def test_gelu_tanh_f32_matches_jax():
    """ops/gelu.gelu_tanh on f32 against jax.nn.gelu(approximate=True) on
    the same f32 values: every operation rounded to f32 on both sides, the
    tanh XLA's or PyTorch's, which differ by up to 2.4e-7, so within 2 f32
    ulps of max(|gelu|, |x|) (measured: 2, at 0.9 < x < 1)."""
    x = _f32_sweep().numpy()
    ours = gelu_tanh(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    assert _ulps_of_x(ours, ref, x).max() <= 2


@pytest.mark.parametrize("d", [128, 384, 768, 1024])
def test_f32_widths_and_bodies_follow_jax(d):
    """At f32 the fused GELU half takes every encoder width (takes_width with
    the dtype), on row 8's f32 entry point where the JAX rule keeps the f32
    weights resident (D = 128, 384) and row 9's above (768, 1024); each
    width is in exactly one of the two f32 width lists, and a width in
    neither is refused at f32 as at bf16."""
    f32 = torch.float32
    assert mlp.takes_width(d, "mlp", f32) and mlp.takes_width(d)
    resident = 2 * d * 4 * d * 4 <= 10 * 2 ** 20
    assert mlp.resident(d, 4 * d, f32) == resident
    assert (d in mlp.F32_WIDTHS) == resident
    assert (d in mlp.HBLOCKED_F32_WIDTHS) == (not resident)
    assert not mlp.takes_width(512, "mlp", f32)
    assert resolve_block_fusion("fused", d, d // 64, 100, "cuda", f32)[1]


# Two vitl-width blocks (D = 1024, 16 heads of 64) with a narrow head.
VITL2 = dataclasses.replace(
    config.ModelConfig(), encoder="vitl", embed_dim=1024, depth=2,
    num_heads=16, features=32, out_channels=(8, 16, 32, 32),
    intermediate_layers=(0, 1, 1, 1), mlp_fused="auto")


def test_f32_auto_vitl_blocks_match_jax_block():
    """Two vitl-width Blocks at f32 with ``auto`` as the card resolves it (the
    attention half unfused: attn_fusable(1024, ., f32) is False; the MLP
    half on row 9's hidden-blocked f32 body), run through the plain
    versions, against the JAX package's Block with mlp_fused="fused" (the
    plan its accelerator makes at f32: the same halves, Pallas in interpret
    mode), N = 41 tokens, within 3e-5 (tests/test_mlp_pallas.py's
    fused-vs-unfused bound)."""
    assert resolve_block_fusion("auto", 1024, 16, 41, "cuda",
                                torch.float32) == (False, True)
    rng = np.random.default_rng(1024)
    sd = random_state_dict(VITL2, seed=3)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(
                np.float32)
    cfg = dataclasses.replace(VITL2, mlp_fused="fused")
    model = build_model(cfg, sd, torch.float32, "cpu")
    params = convert_state_dict(sd, cfg)["pretrained"]
    x = rng.standard_normal((2, 41, 1024)).astype(np.float32)
    jblk = JaxBlock(dim=1024, num_heads=16, mlp_ratio=4.0, mlp_fused="fused")
    ref, ours = jnp.asarray(x), _t(x)
    for i, blk in enumerate(model.pretrained.blocks):
        ref = jblk.apply({"params": params[f"block{i}"]}, ref)
        ours = blk(ours)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=3e-5)
