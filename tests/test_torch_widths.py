"""PyTorch port, the ViT encoder at every width the JAX package takes, on the
CPU: the fused halves' plain versions (rows 5, 6, 8, 9, 10) at widths and
head dims of a custom ModelConfig against the JAX package's Pallas kernels
in interpret mode; ``resolve_block_fusion`` against the JAX Block's rules
(its own ``attn_fusable`` and ``supported``) over a grid of widths, heads,
token counts and dtypes; the zero padding of the hidden width (exact on the
plain versions and on the CPU model of the 3xTF32 core, kept once per
weight, handed to the entry points); every width the JAX package fuses
reaching its kernel chain (the CUDA library faked: no GPU here); the weight
converter across chip_smoke.py's five custom configurations; and narrow
analogues of those configurations, whole, against the JAX model at
``fused``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (GEMM_MAX_ULPS, WIDTH_PATHS, operand_ulps,
                        width_config)
from tests.test_torch_attention_any import FakeLibrary
from tests.test_torch_gemm_3xtf32 import core_sums
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2, infer_depth as jax_infer_depth)
from vr_video_generator_tpu.ops.attention_pallas import supported
from vr_video_generator_tpu.ops.mlp_pallas import (mlp_residual_pallas,
                                                   swiglu_residual_pallas)
from vr_video_generator_tpu.ops.qkv_pallas import (attn_fusable,
                                                   ln_qkv_pallas,
                                                   proj_ls_residual_pallas)
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops import qkv as qkv_ops
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


# --- the fused halves' plain versions against the Pallas kernels ---------

def _ln_qkv_case(rng, b, n, d):
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (rng.standard_normal((3 * d, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
    return x, lnw, lnb, w, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_plain_matches_pallas_at_head_dim_128(dtype):
    """D = 256, 2 heads of 128, N = 37: the port's (B, N, 3, H, 128)
    against the TPU's per-head (B, H, N_pad, 128) tiles; f32 within 1e-5,
    bf16 within one ulp of |q| + |bias| at <= 1% of outputs
    (tests/test_torch_fused.py's bounds at head dim 64)."""
    d, heads, n = 256, 2, 37
    x, lnw, lnb, w, bias = _ln_qkv_case(np.random.default_rng(7), 2, n, d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    qt, kt, vt = ln_qkv_pallas(jnp.asarray(x, jdt), jnp.asarray(lnw),
                               jnp.asarray(lnb), jnp.asarray(w.T, jdt),
                               jnp.asarray(bias, jdt), heads, 128 ** -0.5,
                               interpret=True)
    ref = np.stack([np.asarray(t.astype(jnp.float32))[:, :, :n]
                    .transpose(0, 2, 1, 3) for t in (qt, kt, vt)], axis=2)
    ours = qkv_ops.ln_qkv(_t(x, tdt), _t(lnw), _t(lnb), _t(w, tdt),
                          _t(bias, tdt), heads, 128 ** -0.5)
    assert ours.shape == (2, n, 3, heads, 128)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
        return
    refb = torch.from_numpy(ref.copy()).to(tdt)
    assert (_bf16_ulps(ours, refb) > 0).float().mean().item() <= 0.01
    bias_abs = torch.from_numpy(np.abs(bias)).reshape(3, heads, 128)
    err = (ours.float() - refb.float()).abs()
    assert bool((err <= 2.0 ** -7 * (refb.float().abs() + bias_abs)).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proj_plain_matches_pallas_at_head_dim_128(dtype):
    """o (B, N, 2, 128) -> x + gamma * (proj(o) + b) at D = 256 against
    proj_ls_residual_pallas on the per-head tiles padded to its 512-token
    block; f32 within 1e-5, bf16 within one ulp of the output at <= 1% of
    outputs (tests/test_torch_fused.py's bounds)."""
    b, n, heads, d = 2, 37, 2, 256
    rng = np.random.default_rng(4)
    o = rng.standard_normal((b, n, heads, d // heads)).astype(np.float32)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ot = jnp.pad(jnp.asarray(o.transpose(0, 2, 1, 3), jdt),
                 ((0, 0), (0, 0), (0, -n % 512), (0, 0)))
    ref = np.asarray(proj_ls_residual_pallas(
        ot, jnp.asarray(x, jdt), jnp.asarray(w.T), jnp.asarray(bias),
        jnp.asarray(gamma), interpret=True).astype(jnp.float32))
    ours = qkv_ops.proj_ls_residual(_t(o, tdt), _t(x, tdt), _t(w, tdt),
                                    _t(bias, tdt), _t(gamma, tdt))
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
        return
    ulps = _bf16_ulps(ours, torch.from_numpy(ref.copy()).to(tdt))
    assert (ulps > 0).float().mean().item() <= 0.01
    assert int(ulps.max()) <= 1


def _half_params(rng, d, hid, gated):
    """Half-block parameters in the JAX package's layout (kernels (in,
    out)); w12 of a SwiGLU half (D, 2H)."""
    w_in = 2 * hid if gated else hid
    return dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, w_in)) * 0.05).astype(np.float32),
        b1=(0.1 * rng.standard_normal(w_in)).astype(np.float32),
        w2=(rng.standard_normal((hid, d)) * 0.05).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))


def _torch_half(p, tdt):
    """The port's operands: (LN weight, LN bias, w_in, b_in, w_out, b_out,
    gamma) in PyTorch layout."""
    return (_t(p["ln_scale"]), _t(p["ln_bias"]), _t(p["w1"].T, tdt),
            _t(p["b1"], tdt), _t(p["w2"].T, tdt), _t(p["b2"], tdt),
            _t(p["gamma"], tdt))


# (D, hidden): the JAX package keeps the weights resident (row 8) at (256,
# 1024) and (640, 1024), and runs the hidden-blocked kernel (row 9) at a
# hidden width that is no multiple of 512: 2080 (D = 640 at mlp_ratio 3.25).
MLP_WIDTHS = [(256, 1024), (256, 2080), (640, 1024), (640, 2080)]


def _assert_half_close(ours, ref, dtype, x, gamma, b2):
    """f32 within 2e-5 (the JAX tests' bound, tests/test_mlp_pallas.py:44);
    bf16 within GEMM_MAX_ULPS["mlp_residual"] (4) bf16 ulps of the output's
    scale (chip_smoke.operand_ulps: the largest of the output, its
    feature's RMS, the residual x, gamma * b2 and the product they were
    added to), the bound chip_smoke.py holds the kernels to against the
    plain version: the f32 sums of the two products run in another order,
    and a one-ulp flip of the bf16 product (up to 2^-5 past |y| = 4) moves
    x + gamma * y by more than the JAX tests' 6e-2 at D = 640."""
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == jnp.float32:
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-5)
        return
    ulps = operand_ulps(ours, torch.from_numpy(ref), 1, x, gamma.float()
                        * b2.float())
    assert ulps.max().item() <= GEMM_MAX_ULPS["mlp_residual"]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d,hid", MLP_WIDTHS)
def test_mlp_plain_matches_pallas_at_other_widths(d, hid, dtype):
    """mlp_residual's plain version against mlp_residual_pallas (its
    resident or hidden-blocked body, by the JAX rule, which
    ops/mlp.resident is) on 72 rows (_assert_half_close's bounds)."""
    rng = np.random.default_rng(d + hid)
    x = (rng.standard_normal((72, d)) * 0.5).astype(np.float32)
    p = _half_params(rng, d, hid, False)
    tdt = getattr(torch, str(jnp.dtype(dtype)))
    jw = 2 * d * hid * jnp.dtype(dtype).itemsize
    assert mlp.resident(d, hid, tdt) == (jw <= 10 * 2 ** 20
                                         and hid % 512 == 0)
    ref = mlp_residual_pallas(jnp.asarray(x, dtype),
                              **{k: jnp.asarray(v) for k, v in p.items()},
                              interpret=True)
    half = _torch_half(p, tdt)
    ours = mlp.mlp_residual(_t(x, tdt), *half)
    _assert_half_close(ours, ref, dtype, _t(x, tdt), half[6], half[5])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_swiglu_plain_matches_pallas_at_other_widths(dtype):
    """D = 256 with SwiGLUFFNFused's hidden at mlp_ratio 4, 688 (no
    multiple of 64), against swiglu_residual_pallas on 40 rows, within the
    MLP half's bounds (_assert_half_close)."""
    d = 256
    hid = mlp.swiglu_hidden(d, 4.0)
    assert hid == 688 and hid % 64
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((40, d)) * 0.5).astype(np.float32)
    p = _half_params(rng, d, hid, True)
    ref = swiglu_residual_pallas(
        jnp.asarray(x, dtype), jnp.asarray(p["ln_scale"]),
        jnp.asarray(p["ln_bias"]), jnp.asarray(p["w1"]), jnp.asarray(p["b1"]),
        jnp.asarray(p["w2"]), jnp.asarray(p["b2"]), jnp.asarray(p["gamma"]),
        interpret=True)
    tdt = getattr(torch, str(jnp.dtype(dtype)))
    half = _torch_half(p, tdt)
    ours = mlp.swiglu_residual(_t(x, tdt), *half)
    _assert_half_close(ours, ref, dtype, _t(x, tdt), half[6], half[5])


# --- the fusion rules ------------------------------------------------------

def jax_fusion(mlp_fused, d, heads, n, dtype, on_card):
    """The JAX Block's (fuse_attn, fuse_mlp) on its accelerator (on_card)
    or off it, with its own attn_fusable and supported
    (vr_video_generator_tpu/models/dinov2.py Block.__call__)."""
    want = mlp_fused == "fused" or (mlp_fused == "auto" and on_card)
    attn = d % 128 == 0 and (d // heads) % 64 == 0 and supported(n) \
        and attn_fusable(d, n, dtype) and want
    fuse = d % 128 == 0 and (mlp_fused == "fused" or (
        mlp_fused == "auto" and d >= 512 and on_card))
    return bool(attn), bool(fuse)


@pytest.mark.parametrize("d", [128, 192, 256, 384, 512, 640, 768, 1024, 1152,
                               1536])
def test_block_fusion_follows_jax_rules(d):
    """resolve_block_fusion is the JAX Block's rule at every head count that
    divides D with a head dim from 16 to 256, at 100, 2443, 4096 and 4097
    tokens, bf16 and f32, each mlp_fused, on and off the card, and raises
    for none of them: every width either half fuses at has its kernels."""
    for heads in (h for h in range(1, d + 1) if d % h == 0
                  and 16 <= d // h <= 256):
        for n in (100, 2443, 4096, 4097):
            for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                             (torch.float32, jnp.float32)):
                for mlp_fused in ("auto", "fused", "xla"):
                    for device in ("cuda", "cpu"):
                        for ffn in ("mlp", "swiglufused"):
                            got = resolve_block_fusion(mlp_fused, d, heads,
                                                       n, device, tdt, ffn)
                            want = jax_fusion(mlp_fused, d, heads, n, jdt,
                                              device == "cuda")
                            assert got == want, (heads, n, tdt, mlp_fused,
                                                 device, ffn)


# --- the zero padding of the hidden width ---------------------------------

def test_pad_hidden_layout_and_cache():
    """fc1's rows, b1 and fc2's columns padded by one block of zeros; w12's
    rows and b12 by two, after x1's and after x2's; t itself where nothing
    pads. The padded tensor is kept on the weight (the same object at the
    next call), made again after an in-place change, and made outside
    inference mode even when asked inside it."""
    w = torch.arange(6 * 3, dtype=torch.float32).reshape(6, 3)
    p = mlp.pad_hidden(w, 6, 8, 0)
    assert p.shape == (8, 3) and torch.equal(p[:6], w) and not p[6:].any()
    assert mlp.pad_hidden(w, 6, 8, 0) is p
    w.add_(1)
    p2 = mlp.pad_hidden(w, 6, 8, 0)
    assert p2 is not p and torch.equal(p2[:6], w)
    cols = mlp.pad_hidden(w.T.contiguous(), 6, 8, 1)
    assert cols.shape == (3, 8) and torch.equal(cols[:, :6], w.T)
    assert not cols[:, 6:].any()
    w12 = torch.arange(1, 13, dtype=torch.float32).reshape(12, 1)
    g = mlp.pad_hidden(w12, 6, 8, 0, halves=2)
    assert g.flatten().tolist() == [1, 2, 3, 4, 5, 6, 0, 0,
                                    7, 8, 9, 10, 11, 12, 0, 0]
    assert mlp.pad_hidden(w, 6, 6, 0) is w
    b = torch.ones(6)
    with torch.inference_mode():
        pb = mlp.pad_hidden(b, 6, 64, 0)
    assert not pb.is_inference() and mlp.pad_hidden(b, 6, 64, 0) is pb
    assert mlp.padded_hidden(2080) == 2112 and mlp.padded_hidden(688) == 704
    assert mlp.padded_hidden(2736, 128) == 2816
    assert mlp.padded_hidden(4096) == 4096


def _padded_mlp_args(rng, d, hid, hp, tdt, gated, rows=12):
    """The half's operands, and the same with the hidden width zero-padded
    to hp (each half of w12 and b12 where ``gated``)."""
    p = _half_params(rng, d, hid, gated)
    x = _t(rng.standard_normal((rows, d)) * 0.5, tdt)
    ln_w, ln_b, w_in, b_in, w_out, b_out, gamma = _torch_half(p, tdt)
    halves = 2 if gated else 1
    padded = (ln_w, ln_b, mlp.pad_hidden(w_in, hid, hp, 0, halves),
              mlp.pad_hidden(b_in, hid, hp, 0, halves),
              mlp.pad_hidden(w_out, hid, hp, 1), b_out, gamma)
    return x, (ln_w, ln_b, w_in, b_in, w_out, b_out, gamma), padded


def _linear_in_k_order(a, w):
    """F.linear with each output's products summed in K order in f32 (a
    kernel's K loop; the CPU library's GEMM orders its sums by the shape,
    so its f32 sums over K = 2080 and 2112 differ), cast to a's dtype."""
    prods = a.float()[..., None, :] * w.float()
    return prods.cumsum(dim=-1)[..., -1].to(a.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("half", ["mlp", "swiglu"])
def test_padded_hidden_leaves_plain_bit_equal(half, dtype, monkeypatch):
    """The plain versions, their products summed in K order, on the
    zero-padded weights equal them on the unpadded ones bit for bit, stage
    by stage: a padded column's fc1 sum is 0 + 0, GELU(0) = 0 (silu(0) * 0
    = 0), and its products in the down projection are exact zeros added
    after the real ones (D = 640 with hidden 2080 -> 2112; SwiGLU at D =
    256, hidden 688 -> 768, the bf16 gated tile's multiple)."""
    import types

    monkeypatch.setattr(mlp, "F", types.SimpleNamespace(
        linear=_linear_in_k_order))
    rng = np.random.default_rng(11)
    if half == "mlp":
        d, hid, hp = 640, 2080, 2112
        x, args, padded = _padded_mlp_args(rng, d, hid, hp, dtype, False)
        a, h, out = mlp.mlp_residual_stages(x, *args)
        a2, h2, out2 = mlp.mlp_residual_stages(x, *padded)
    else:
        d, hid, hp = 256, 688, 768
        x, args, padded = _padded_mlp_args(rng, d, hid, hp, dtype, True)
        a, h, out = mlp.swiglu_residual_stages(x, *args)
        a2, h2, out2 = mlp.swiglu_residual_stages(x, *padded)
    assert h2.shape[-1] == hp and not h2[..., hid:].any()
    assert torch.equal(a2, a) and torch.equal(h2[..., :hid], h)
    assert torch.equal(out2, out)


@pytest.mark.parametrize("hid,hp", [(2080, 2112), (688, 704), (422, 448)])
def test_padded_hidden_leaves_core_model_bit_equal(hid, hp):
    """On the CPU model of the 3xTF32 core (tests/test_torch_gemm_3xtf32.py:
    a fresh tensor-core sum a 32-wide stage of K, added into f32 running
    sums), the down projection over the zero-padded hidden width equals the
    one over the unpadded width bit for bit: every padded k-step's products
    are exact zeros, so each stage sum (and the last, all-zero, stage) adds
    exactly what it did."""
    rng = np.random.default_rng(hid)
    h = _t(rng.standard_normal((64, hid)))
    w = _t(rng.standard_normal((48, hid)) / np.sqrt(hid))
    hp_ = torch.cat([h, torch.zeros(64, hp - hid)], dim=1)
    want = core_sums(h, mlp.tf32x3_weight_plain(w))
    got = core_sums(hp_, mlp.tf32x3_weight_plain(mlp.pad_hidden(w, hid, hp,
                                                                1)))
    assert torch.equal(got, want)


@pytest.fixture
def fake_card(monkeypatch):
    """The MLP wrappers believe their tensors are on the card and call a
    FakeLibrary."""
    from vr_video_generator_tpu_torch.kernels import build

    lib = FakeLibrary()
    monkeypatch.setattr(mlp, "on_cuda", lambda *t: True)
    monkeypatch.setattr(mlp, "stream_handle", lambda device: 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    return lib


# (D, mlp_ratio, ffn_layer) a custom ModelConfig may take: vitb and vitl's
# widths, D = 512 and 1152, mlp_ratio 3.25 (hidden 2080) and 3.3 (422 at D
# = 128), SwiGLU at D = 1024 (2736) and at ratio 3.25 (560 at D = 256).
JAX_WIDTHS = [(512, 4.0, "mlp"), (640, 3.25, "mlp"), (1152, 4.0, "mlp"),
              (128, 3.3, "mlp"), (1024, 4.0, "swiglufused"),
              (256, 3.25, "swiglufused")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d,ratio,ffn", JAX_WIDTHS)
def test_every_jax_width_reaches_its_kernel(fake_card, d, ratio, ffn,
                                            dtype):
    """The Block's fused MLP half at a width the JAX package fuses calls
    the entry point of the row the JAX rule picks (row 8 resident, row 9
    otherwise, row 10 for SwiGLU) once, with the hidden width padded to
    the kernels' multiple (64; SwiGLU at bf16 128), after splitting the
    padded weights at f32, and counts that row's launch."""
    from vr_video_generator_tpu_torch.models.dinov2 import Block

    blk = Block(d, d // 64, ratio, "fused", ffn).to(dtype)
    blk.norm2.float()
    x = torch.zeros((1, 5, d), dtype=dtype)
    f32 = dtype == torch.float32
    if ffn == "swiglufused":
        hid = mlp.swiglu_hidden(d, ratio)
        step, counter = mlp.GATED_STEP[dtype], "swiglu_residual"
        entry = "vrvg_swiglu_residual"
    else:
        hid = int(d * ratio)
        step = mlp.HIDDEN_STEP
        counter = "mlp_residual" if mlp.resident(d, hid, dtype) \
            else "mlp_residual_hblocked"
        entry = f"vrvg_{counter}"
    if f32:
        entry, counter = entry + "_f32", counter + "_f32"
    hp = mlp.padded_hidden(hid, step)
    before = launch_counts()
    out = blk.fused_mlp(x, blk.mlp.fc1.weight, blk.mlp.fc1.bias,
                        blk.mlp.fc2.weight) if ffn == "mlp" \
        else blk.fused_mlp(x)
    assert out.shape == x.shape
    names = [c[0] for c in fake_card.calls]
    assert names == ["vrvg_tf32x3_split"] * (2 if f32 else 0) + [entry]
    assert launch_counts()[counter] == before.get(counter, 0) + 1
    args = fake_card.calls[-1][1]
    assert args[11:14] == (5, d, hp) and hp % step == 0 and hp >= hid
    if f32:  # the split planes of the padded weights: w_in rows, w_out cols
        split = [c[1] for c in fake_card.calls[:2]]
        in_rows = 2 * hp if ffn == "swiglufused" else hp
        assert split[0][2:5] == (in_rows, d, hp if ffn == "swiglufused"
                                 else 0)
        assert split[1][2:5] == (d, hp, 0)


def test_row_wrappers_take_only_their_rows_widths(fake_card):
    """Row 8's wrapper refuses a width the JAX rule gives row 9 (D = 640,
    hidden 2080) and row 9's one it gives row 8 (D = 512, hidden 2048),
    launching nothing."""
    for fn, d, hid in ((mlp.mlp_residual, 640, 2080),
                       (mlp.mlp_residual_hblocked, 512, 2048)):
        bf = torch.bfloat16
        args = (torch.zeros(1, 3, d, dtype=bf), torch.ones(d),
                torch.zeros(d), torch.zeros(hid, d, dtype=bf),
                torch.zeros(hid, dtype=bf), torch.zeros(d, hid, dtype=bf),
                torch.zeros(d, dtype=bf), torch.ones(d, dtype=bf))
        with pytest.raises(ValueError, match="row"):
            fn(*args)
    assert fake_card.calls == []


# --- the five configurations: the converter and narrow analogues ---------

@pytest.mark.parametrize("label", list(WIDTH_PATHS))
def test_converter_carries_the_custom_config(label):
    """chip_smoke.py's configuration (at full width, one block): the port's
    seeded state_dict has the JAX model's parameter shapes (from its own
    init), the JAX package's converter takes it to a parameter tree and the
    port's takes that back unchanged, mlp_ratio 3.25 and SwiGLU at D = 1024
    included."""
    cfg = dataclasses.replace(width_config(label), depth=1,
                              intermediate_layers=(0, 0, 0, 0))
    sd = random_state_dict(cfg, seed=3)
    jparams = convert_state_dict(sd, cfg)
    jmodel = JaxDepthAnythingV2(jconfig.ModelConfig(**dataclasses.asdict(cfg)),
                                dtype=jnp.float32, tail="xla")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 28, 28, 3)))["params"]
    # Every parameter the JAX model declares, at its shape (the converter
    # also emits refinenet4's unused rcu1, which the JAX model does not).
    flat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        assert np.shape(flat[path]) == leaf.shape, path
    back = state_dict_from_jax(jparams, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# Narrow analogues of the five configurations: the same ratios of width to
# head dim, mlp_ratio and ffn_layer at CPU sizes (2 blocks, a 32-feature
# head). w512: D = 256 with 4 heads of 64 (row 8 resident, as D = 512 is);
# hd128: 2 heads of 128 (the fused attention half at head dim 128); hd32: 4
# heads of 32 (the attention half unfused); r325: D = 128, mlp_ratio 3.25
# (hidden 416, row 9); glu1024: SwiGLU at D = 256 (hidden 688).
NARROW = {
    "w512": dict(embed_dim=256, num_heads=4),
    "hd128": dict(embed_dim=256, num_heads=2),
    "hd32": dict(embed_dim=128, num_heads=4),
    "r325": dict(embed_dim=128, num_heads=2, mlp_ratio=3.25),
    "glu1024": dict(embed_dim=256, num_heads=4, ffn_layer="swiglufused"),
}
TINY = config.ModelConfig(encoder="vits", embed_dim=128, depth=2,
                          num_heads=2, mlp_ratio=4.0, features=32,
                          out_channels=(8, 16, 32, 32),
                          intermediate_layers=(0, 1, 1, 1),
                          depth_scaler=12.0, mlp_fused="fused")


@pytest.mark.parametrize("label", list(NARROW))
def test_narrow_model_matches_jax_fused(label):
    """The whole model at the narrow analogue, the JAX parameters carried
    by the port's converter: mlp_fused='fused' (plain versions here) against
    the JAX model at 'fused' (its Pallas half-blocks in interpret mode),
    both with the XLA tail, f32 depth within 1e-4 of its max
    (tests/test_torch_fused.py's bound); the Blocks fuse as the JAX ones
    do."""
    cfg = dataclasses.replace(TINY, **NARROW[label])
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(21)
    sd = random_state_dict(cfg, seed=4)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(
                np.float32)
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(sd, cfg))
    frames = rng.integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    jmodel = JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="xla")
    ref = np.asarray(jax_infer_depth(jmodel, jparams, jnp.asarray(frames),
                                     input_size=56))
    model = build_model(cfg, state_dict_from_jax(jparams, cfg),
                        torch.float32, "cpu", tail="xla")
    n = (56 // 14) * (98 // 14) + 1
    assert resolve_block_fusion("fused", cfg.embed_dim, cfg.num_heads, n,
                                "cpu", torch.float32, cfg.ffn_layer) == \
        jax_fusion("fused", cfg.embed_dim, cfg.num_heads, n, jnp.float32,
                   False)
    ours = infer_depth(model, torch.from_numpy(frames), input_size=56).numpy()
    assert ours.shape == ref.shape == (2, 48, 80)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
