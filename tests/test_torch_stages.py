"""PyTorch port on the CPU: the two chains on the TMA + wgmma GEMM core whose
stages the card checks one by one, LN + qkv (row 5) and the SwiGLU half
(row 10). Their plain stages, composed, are the whole plain versions bit for
bit, and match the JAX package (its Pallas kernels in interpret mode and its
XLA references) at small widths and ragged token counts; the bf16 silu of
row 10's gate matches ``jax.nn.silu`` on every bf16 input, the extreme ones
(x1 <= -44.5, where its reciprocal leaves recip_ge1's exact range, and the
values next to inf) included, apart from XLA's flush of subnormals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.ops.mlp_pallas import (swiglu_residual_pallas,
                                                   swiglu_residual_ref)
from vr_video_generator_tpu.ops.qkv_pallas import ln_qkv_pallas
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
from vr_video_generator_tpu_torch.ops.mlp import (fc2_residual_plain, silu_mul,
                                                  silu_mul_kernel,
                                                  swiglu_gate_plain,
                                                  swiglu_residual,
                                                  swiglu_residual_plain,
                                                  swiglu_residual_stages)
from vr_video_generator_tpu_torch.ops.qkv import ln_qkv, ln_qkv_plain, qkv_plain

torch.set_num_threads(2)
torch.set_grad_enabled(False)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


# --- row 10: the SwiGLU half ---------------------------------------------

def _swiglu_params(rng, d, hid):
    """JAX-layout parameters (w12 (D, 2H), w3 (H, D)) with non-zero biases."""
    return dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w12=(rng.standard_normal((d, 2 * hid)) * d ** -0.5).astype(np.float32),
        b12=(0.1 * rng.standard_normal(2 * hid)).astype(np.float32),
        w3=(rng.standard_normal((hid, d)) * hid ** -0.5).astype(np.float32),
        b3=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))


def _swiglu_torch_args(x, p, dtype):
    """The port's operands (PyTorch layout) from the JAX-layout ones."""
    return (_t(x, dtype), _t(p["ln_scale"]), _t(p["ln_bias"]),
            _t(p["w12"].T, dtype), _t(p["b12"], dtype), _t(p["w3"].T, dtype),
            _t(p["b3"], dtype), _t(p["gamma"], dtype))


# m = 1: a lone row; 127, 129: either side of a 128-row tile; (3, 43):
# tokens with a batch axis.
@pytest.mark.parametrize("shape", [(1,), (127,), (129,), (3, 43)])
def test_swiglu_stages_compose_to_plain(shape):
    """The plain versions of row 10's three stages (LayerNorm, the gate with
    silu(x1) * x2, the down product with LayerScale and the residual),
    composed, are swiglu_residual_plain bit for bit in bf16; the wrapper's
    stage-by-stage entry point takes them on the CPU."""
    d, hid = 128, 256
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal((*shape, d)) * 0.5).astype(np.float32)
    args = _swiglu_torch_args(x, _swiglu_params(rng, d, hid), torch.bfloat16)
    x_t, lnw, lnb, w12, b12, w3, b3, gamma = args
    m = x_t.numel() // d
    h = layernorm_plain(x_t, lnw, lnb).reshape(m, d)
    g = swiglu_gate_plain(h, w12, b12)
    out = fc2_residual_plain(g, w3, b3, gamma, x_t.reshape(m, d))
    assert g.shape == (m, hid)
    assert out.dtype == g.dtype == h.dtype == torch.bfloat16
    whole = swiglu_residual_plain(*args)
    assert torch.equal(out.reshape(x_t.shape), whole)
    assert torch.equal(swiglu_residual(*args), whole)
    for got, want in zip(swiglu_residual_stages(*args),
                         (h, g, out.reshape(x_t.shape))):
        assert torch.equal(got, want)


@pytest.mark.parametrize("m", [1, 77, 129])
@pytest.mark.parametrize("dtype,atol", [
    (jnp.float32, 2e-5),   # the JAX package's half-block bounds
    (jnp.bfloat16, 6e-2),  # (tests/test_mlp_pallas.py:44, 58, 89)
])
def test_swiglu_stages_match_jax(m, dtype, atol):
    """Row 10's chain, its three plain stages composed, against
    swiglu_residual_pallas(interpret=True) and swiglu_residual_ref at D =
    128, hidden 256 (two hidden blocks of 128), at ragged row counts."""
    d, hid = 128, 256
    rng = np.random.default_rng(m + 10)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = _swiglu_params(rng, d, hid)
    tdt = getattr(torch, jnp.dtype(dtype).name)
    x_t, lnw, lnb, w12, b12, w3, b3, gamma = _swiglu_torch_args(x, p, tdt)
    g = swiglu_gate_plain(layernorm_plain(x_t, lnw, lnb), w12, b12)
    ours = fc2_residual_plain(g, w3, b3, gamma, x_t).float().numpy()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for ref in (swiglu_residual_pallas(jnp.asarray(x, dtype), **jp,
                                       block_h=128, interpret=True),
                swiglu_residual_ref(jnp.asarray(x, dtype), **jp)):
        np.testing.assert_allclose(ours, np.asarray(ref.astype(jnp.float32)),
                                   rtol=0, atol=atol)


def _all_bf16() -> torch.Tensor:
    """Every bf16 bit pattern, once."""
    return torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)


def _jax_silu_mul(x1: torch.Tensor, x2: torch.Tensor) -> np.ndarray:
    a = jnp.asarray(x1.float().numpy(), jnp.bfloat16)
    b = jnp.asarray(x2.float().numpy(), jnp.bfloat16)
    return np.asarray((jax.nn.silu(a) * b).astype(jnp.float32))


SUBNORMAL = 2.0 ** -126  # the smallest normal f32 (and bf16) magnitude
BF16_MAX = 3.3895313892515355e38


def _assert_silu_matches_xla(x1, x2, ours, ref):
    """silu(x1) * x2 of the port against XLA's, both as f32 arrays: bit for
    bit, NaN where XLA's is NaN, except where XLA's CPU backend flushes a
    subnormal to zero (as the TPU does; PyTorch and the CUDA kernel keep
    subnormals): |x1| below 2^-125, a subnormal reciprocal 1 / (1 +
    exp(-x1)) (x1 in [-88.5, -87.5]), a subnormal silu(x1) or a subnormal
    result. There XLA's is a zero or the port's value, and the port's is
    below 1e-36 |x2|."""
    x, y = x1.float().numpy(), x2.float().numpy()
    silu = np.abs(silu_mul(x1, torch.ones_like(x1)).float().numpy())
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(ours), nan)
    tiny = lambda v: (v != 0) & (np.abs(v) < SUBNORMAL)
    flushed = ((np.abs(x) < 2 * SUBNORMAL) | ((x >= -88.5) & (x <= -87.5))
               | tiny(silu) | tiny(ours)) & ~nan
    keep = ~nan & ~flushed
    np.testing.assert_array_equal(ours[keep].view(np.int32),
                                  ref[keep].view(np.int32))
    assert ((ref[flushed] == 0) | (ref[flushed] == ours[flushed])).all()
    assert (np.abs(ours[flushed])
            <= 1e-36 * np.maximum(1.0, np.abs(y[flushed]))).all()


@pytest.mark.parametrize("x2", ["one", "seeded"])
def test_silu_mul_every_bf16_matches_jax(x2):
    """silu(x1) * x2 in bf16 equals jax.nn.silu(x1) * x2 on all 65536 bf16
    values of x1 (_assert_silu_matches_xla): silu alone (x2 = 1) and with
    seeded x2; the wrapper takes the plain version on the CPU."""
    x1 = _all_bf16()
    if x2 == "one":
        x2 = torch.ones_like(x1)
    else:
        rng = np.random.default_rng(65536)
        x2 = _t(rng.standard_normal(x1.shape) * 3, torch.bfloat16)
    ours = silu_mul(x1, x2)
    _assert_silu_matches_xla(x1, x2, ours.float().numpy(),
                             _jax_silu_mul(x1, x2))
    assert torch.equal(silu_mul_kernel(x1, x2).view(torch.int16),
                       ours.view(torch.int16))


# x1 at and past -44.5 (1 + exp(-x1) >= 2^64), at -87.5..-88.5 (a
# subnormal reciprocal), past -88.7 (exp(-x1) = inf), the largest finite
# bf16 values, +-inf, the smallest normal and subnormal values, +-0.
EXTREMES = [-44.25, -44.5, -45.0, -60.0, -87.5, -88.0, -88.5, -89.0, -100.0,
            -BF16_MAX, BF16_MAX, float("-inf"), float("inf"),
            1.1754944e-38, -1.1754944e-38, 9.18355e-41, -9.18355e-41, 0.0,
            -0.0]


@pytest.mark.parametrize("x2", [1.0, -2.5, BF16_MAX])
def test_silu_mul_extreme_inputs(x2):
    """silu(x1) * x2 at the extreme bf16 inputs against jax.nn.silu's
    (_assert_silu_matches_xla; NaN where it is NaN: -inf * 0, inf * 0)."""
    x1 = _t(EXTREMES, torch.bfloat16)
    x2 = torch.full_like(x1, x2)
    _assert_silu_matches_xla(x1, x2, silu_mul(x1, x2).float().numpy(),
                             _jax_silu_mul(x1, x2))


# --- row 5: LN + qkv ---------------------------------------------------------

def _qkv_case(rng, b, n, d):
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (rng.standard_normal((3 * d, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
    return x, lnw, lnb, w, bias


# D = 128 (2 heads) and 384 (vits' 6 heads): 3D is not a multiple of the
# core's 256-column tile at either; N = 1, 127, 129 tokens.
@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("n", [1, 127, 129])
def test_qkv_stages_compose_to_plain(n, d):
    """Row 5's plain stages (LayerNorm, then qkv_plain on its rows),
    composed, are ln_qkv_plain bit for bit in bf16."""
    heads = d // 64
    x, lnw, lnb, w, bias = _qkv_case(np.random.default_rng(n + d), 2, n, d)
    bf = torch.bfloat16
    args = (_t(x, bf), _t(lnw), _t(lnb), _t(w, bf), _t(bias, bf), heads,
            64 ** -0.5)
    a = layernorm_plain(*args[:3])
    got = qkv_plain(a, *args[3:])
    assert got.shape == (2, n, 3, heads, 64) and got.dtype == bf
    assert torch.equal(got, ln_qkv_plain(*args))
    assert torch.equal(ln_qkv(*args), got)


@pytest.mark.parametrize("n", [1, 127, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_stages_match_pallas_interpret(n, dtype):
    """Row 5's chain, its plain stages composed, against ln_qkv_pallas in
    interpret mode, rearranged from the TPU's (B, H, N_pad, 64) q/k/v to the
    port's (B, N, 3, H, 64). f32 within 1e-5; bf16 (the same rounding
    points, f32 sums in another order) within one bf16 ulp of the product
    before the bias at <= 1% of the outputs, as
    test_torch_fused.py::test_ln_qkv_plain_matches_pallas_interpret_bf16."""
    d, heads = 128, 2
    x, lnw, lnb, w, bias = _qkv_case(np.random.default_rng(2 * n), 2, n, d)
    jdt = jnp.dtype(dtype)
    qt, kt, vt = ln_qkv_pallas(jnp.asarray(x, jdt), jnp.asarray(lnw),
                               jnp.asarray(lnb), jnp.asarray(w.T, jdt),
                               jnp.asarray(bias, jdt), heads, 64 ** -0.5,
                               interpret=True)
    ref = np.stack([np.asarray(t.astype(jnp.float32))[:, :, :n]
                    .transpose(0, 2, 1, 3) for t in (qt, kt, vt)], axis=2)
    tdt = getattr(torch, dtype)
    a = layernorm_plain(_t(x, tdt), _t(lnw), _t(lnb))
    ours = qkv_plain(a, _t(w, tdt), _t(bias, tdt), heads, 64 ** -0.5)
    assert ours.shape == ref.shape == (2, n, 3, heads, 64)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
        return
    refb = torch.from_numpy(ref.copy()).to(torch.bfloat16)
    assert (_bf16_ulps(ours, refb) > 0).float().mean().item() <= 0.01
    bias_abs = torch.from_numpy(np.abs(bias)).reshape(3, heads, 64)
    err = (ours.float() - refb.float()).abs()
    assert bool((err <= 2.0 ** -7 * (refb.float().abs() + bias_abs)).all())
