"""PyTorch port, f32 on the card: vitg's SwiGLU half at f32 (row 10,
``csrc/swiglu_f32.cu``) and the f32 variants of rows 15 and 16 on the CPU.

The plain versions the f32 kernels are held against on the card, at f32,
against the JAX package's Pallas kernels at f32 in interpret mode:
``swiglu_residual_pallas`` at D = 128 and 256 with the hidden width of
``swiglu_hidden`` (344, 688: not multiples of 64) and at a hidden width the
JAX kernel blocks by 512; the stages composed; two vitg-width Blocks at f32
against the JAX Block through ``state_dict_from_jax``, whose w12, b12, w3
and b3 are what ``swiglu_residual_pallas`` reads; ``head_tail_pallas`` and
``refinenet_pre_pallas`` at vits' and vitb's widths (C = 64, 128) on small
grids, stage by stage as the f32 kernels run them. Each output is held to a
bound in f32 ulps of its scale: the sums run in another order on each side,
and XLA's CPU ``logistic`` / ``exp`` are not torch's, so the silu is never
compared bit for bit across the two packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vr_video_generator_tpu.attic.refinenet_pre import refinenet_pre_pallas
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.dinov2 import Block as JaxBlock
from vr_video_generator_tpu.ops.head_tail_pallas import head_tail_pallas
from vr_video_generator_tpu.ops.mlp_pallas import swiglu_residual_pallas
from vr_video_generator_tpu_torch.attic import refinenet_pre as rp
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)

# Bounds in f32 ulps of each output's scale (its largest magnitude): the
# sums' order differs, and so may each side's exp by an ulp.
MAX_ULPS = 64


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def ulps(ours, ref) -> float:
    """max |ours - ref| in f32 ulps of max |ref|."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 23)
    return float(np.abs(ours - ref).max() / ulp)


def _swiglu_params(rng, d, hid):
    """Seeded SwiGLU-half parameters in the JAX package's layout (w12 (D,
    2H), w3 (H, D)), LeCun-scaled, with non-zero biases."""
    return dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w12=(rng.standard_normal((d, 2 * hid)) * d ** -0.5).astype(np.float32),
        b12=(0.1 * rng.standard_normal(2 * hid)).astype(np.float32),
        w3=(rng.standard_normal((hid, d)) * hid ** -0.5).astype(np.float32),
        b3=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))


def _port_args(x, p):
    """The port's operands (PyTorch layout: w12 (2H, D), w3 (D, H))."""
    return (_t(x), _t(p["ln_scale"]), _t(p["ln_bias"]), _t(p["w12"].T),
            _t(p["b12"]), _t(p["w3"].T), _t(p["b3"]), _t(p["gamma"]))


# --- row 10 at f32 -----------------------------------------------------------

@pytest.mark.parametrize("d,hid,m", [(128, 344, 100), (256, 688, 77),
                                     (128, 1024, 60)])
def test_f32_swiglu_plain_matches_pallas_interpret(d, hid, m):
    """Row 10 at f32: the port's wrapper on CPU tensors (the plain version)
    and its stages against swiglu_residual_pallas in interpret mode, within
    MAX_ULPS of max |out|: at swiglu_hidden's H (344, 688: one hidden block
    on the TPU, no multiple of 64, as the f32 gate's last tile is ragged)
    and at H = 1024 (two 512-wide hidden blocks summed in f32 there, all of
    H at once here)."""
    if hid != 1024:
        assert mlp.swiglu_hidden(d) == hid
    rng = np.random.default_rng(d + hid + m)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = _swiglu_params(rng, d, hid)
    ref = np.asarray(swiglu_residual_pallas(
        jnp.asarray(x), **{k: jnp.asarray(v) for k, v in p.items()},
        interpret=True))
    args = _port_args(x, p)
    ours = mlp.swiglu_residual(*args)
    assert ours.dtype == torch.float32 and ours.shape == (m, d)
    assert ulps(ours.numpy(), ref) <= MAX_ULPS
    assert torch.equal(mlp.swiglu_residual_stages(*args)[2], ours)


def test_f32_swiglu_stages_compose_to_whole_plain():
    """The f32 chain's three plain stages (row 1's LayerNorm, the gate +
    b12 + silu(x1) * x2, the down product + b3 + LayerScale + residual), on
    a ragged row count and leading shape, compose to swiglu_residual_plain
    bit for bit; swiglu_gate_kernel on CPU tensors is the second stage."""
    rng = np.random.default_rng(19)
    d, m = 128, 2 * 39
    hid = mlp.swiglu_hidden(d)
    x = rng.standard_normal((2, m // 2, d)).astype(np.float32)
    args = _port_args(x, _swiglu_params(rng, d, hid))
    h, g, out = mlp.swiglu_residual_stages(*args)
    assert torch.equal(h, layernorm_plain(*args[:3]).reshape(m, d))
    assert torch.equal(g, mlp.swiglu_gate_plain(h, args[3], args[4]))
    assert torch.equal(g, mlp.swiglu_gate_kernel(h, args[3], args[4]))
    assert g.shape == (m, hid) and g.dtype == torch.float32
    assert out.shape == x.shape
    assert torch.equal(out, mlp.swiglu_residual_plain(*args))


def test_f32_silu_mul_matches_jax_within_ulps():
    """silu(x1) * x2 at f32 (ops/mlp.silu_mul, the gate epilogue's rounding
    points) against jax.nn.silu(x1) * x2 on f32 over every normal bf16 x1
    up to 2^64 and a dense sweep over [-120, 40], x2 seeded: within 4 f32
    ulps of max(|x1 x2|, |result|) (XLA's CPU logistic is its own function,
    not 1 / (1 + exp(-x))) where the logistic is normal. Below x1 = -87.4 it
    is subnormal, which XLA's CPU code flushes to zero; there both results
    are below 2^-100 |x2|, and past the overflow of exp(-x1) (x1 < -88.7)
    both are zero."""
    bf = np.arange(-2 ** 15, 2 ** 15, dtype=np.int32).astype(np.int16).view(
        np.uint16).astype(np.uint32) << 16
    x1 = np.concatenate([bf.view(np.float32),
                         np.linspace(-120.0, 40.0, 2 ** 18, dtype=np.float32)])
    x1 = x1[np.isfinite(x1) & (np.abs(x1) >= 2.0 ** -126)
            & (np.abs(x1) <= 2.0 ** 64)]
    x2 = np.random.default_rng(3).standard_normal(x1.shape).astype(np.float32)
    ours = mlp.silu_mul(_t(x1), _t(x2)).numpy().astype(np.float64)
    ref = np.asarray(jax.nn.silu(jnp.asarray(x1)) * jnp.asarray(x2),
                     np.float64)
    normal = x1 >= -87.4
    size = np.maximum(np.abs(x1 * x2.astype(np.float64)), np.abs(ref))[normal]
    # Sizes below 2^-100 count as 2^-100: XLA flushes subnormal products.
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(size, 2.0 ** -100))) - 23)
    assert (np.abs(ours - ref)[normal] / ulp).max() <= 4
    tiny = 2.0 ** -100 * np.abs(x2[~normal])
    assert (np.abs(ours[~normal]) <= tiny).all()
    assert (np.abs(ref[~normal]) <= tiny).all()
    far = x1 < -100
    assert far.sum() > 1000 and (ours[far] == 0).all() and (ref[far] == 0).all()


# Two vitg-width blocks: D = 1536, 24 heads, SwiGLU (hidden 4096).
VITG2 = dataclasses.replace(config.ModelConfig.for_encoder("vitg"), depth=2,
                            out_channels=(192, 384, 768, 768),
                            intermediate_layers=(0, 1, 1, 1),
                            depth_scaler=12.0, mlp_fused="fused")


def _jax_vitg_params(seed):
    """A JAX parameter tree of VITG2 with non-zero biases (numpy-seeded)."""
    cfg = VITG2
    sd = random_state_dict(cfg, seed=seed)
    rng = np.random.default_rng(seed + 100)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(np.float32)
    return convert_state_dict(sd, cfg)


def test_state_dict_from_jax_gives_the_f32_chain_the_pallas_operands():
    """state_dict_from_jax carries a vitg block's SwiGLU weights so that the
    f32 chain's operands are what swiglu_residual_pallas reads: w12 (2H, D)
    whose rows [0, H) are x1's (the JAX w12[:, :H], jnp.split's first
    half) and [H, 2H) x2's, b12 in the same order, w3 (D, H) the JAX w3
    transposed, b3 as it is; and the f32 widths take vitg's D."""
    params = _jax_vitg_params(7)
    sd = state_dict_from_jax(params, VITG2)
    jmlp = params["pretrained"]["block1"]["mlp"]
    jw12 = np.asarray(jmlp["w12"]["kernel"])
    hid = jw12.shape[1] // 2
    assert hid == mlp.swiglu_hidden(1536) == 4096
    w12 = np.asarray(sd["pretrained.blocks.1.mlp.w12.weight"])
    np.testing.assert_array_equal(w12[:hid], jw12[:, :hid].T)
    np.testing.assert_array_equal(w12[hid:], jw12[:, hid:].T)
    np.testing.assert_array_equal(np.asarray(sd["pretrained.blocks.1.mlp.w12"
                                                ".bias"]),
                                  np.asarray(jmlp["w12"]["bias"]))
    np.testing.assert_array_equal(
        np.asarray(sd["pretrained.blocks.1.mlp.w3.weight"]),
        np.asarray(jmlp["w3"]["kernel"]).T)
    np.testing.assert_array_equal(np.asarray(sd["pretrained.blocks.1.mlp.w3"
                                                ".bias"]),
                                  np.asarray(jmlp["w3"]["bias"]))
    # Row 10 takes every D % 128 == 0 at f32 (vitg's 1536, and 1024).
    for d in (1024, 1536):
        assert resolve_block_fusion("fused", d, d // 64, 41, "cuda",
                                    torch.float32, "swiglufused")[1]


def test_f32_vitg_blocks_match_jax_block():
    """Two vitg-width Blocks at f32 (D = 1536, 24 heads, 23 tokens) with
    mlp_fused 'fused': the SwiGLU half through swiglu_residual (the plain
    version on the CPU; row 10's f32 chain on the card), the attention half
    unfused on both sides (D = 1536 is not attn_fusable), on the weights
    state_dict_from_jax makes of a JAX tree, against the JAX Blocks
    (swiglu_residual_pallas in interpret mode) within MAX_ULPS of max
    |out| after each block."""
    params = _jax_vitg_params(11)
    sd = state_dict_from_jax(params, VITG2)
    model = build_model(VITG2, sd, torch.float32, "cpu")
    assert resolve_block_fusion("fused", 1536, 24, 23, "cuda", torch.float32,
                                "swiglufused") == (False, True)
    x = np.random.default_rng(5).standard_normal((1, 23, 1536)).astype(
        np.float32)
    ours, ref = _t(x), jnp.asarray(x)
    for i in range(2):
        jblk = JaxBlock(dim=1536, num_heads=24, mlp_ratio=4.0,
                        ffn_layer="swiglufused", mlp_fused="fused")
        ref = jblk.apply({"params": params["pretrained"][f"block{i}"]}, ref)
        ours = model.pretrained.blocks[i](ours)
        assert ulps(ours.numpy(), np.asarray(ref)) <= MAX_ULPS, i


# --- rows 15 and 16 at f32 ---------------------------------------------------

def _hwio(k):
    """A JAX (kh, kw, I, O) kernel as PyTorch's (O, I, kh, kw)."""
    return _t(np.asarray(k).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("c,h2,w2", [(64, 24, 40), (128, 24, 32)])
def test_f32_head_tail_stages_match_pallas_interpret(c, h2, w2):
    """Row 15 at f32 at vits' and vitb's widths: the three stages the f32
    kernel runs (conv1 + its f32 bias, the resize pass with f32 weights,
    conv2 with the 1x1; head_tail_stages' plain versions), composed,
    against head_tail_pallas at f32 in interpret mode within MAX_ULPS of
    the depth's largest value; and equal to head_tail_plain."""
    c2, c3 = c // 2, 32
    h1, w1 = h2 * 14 // 8, w2 * 14 // 8
    rng = np.random.default_rng(c + h2)
    arrs = [(rng.standard_normal(s) * k + o).astype(np.float32)
            for s, k, o in (((2, h2, w2, c), 1.0, 0.0),
                            ((3, 3, c, c2), (9 * c) ** -0.5, 0.0),
                            ((c2,), 0.1, 0.0),
                            ((3, 3, c2, c3), (9 * c2) ** -0.5, 0.0),
                            ((c3,), 0.1, 0.0), ((1, 1, c3, 1), c3 ** -0.5, 0.0),
                            ((1,), 0.1, 0.5))]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_pallas(*(jnp.asarray(a) for a in arrs),
                                          (h1, w1), interpret=True))
    x, k1, b1, k2, b2, k3, b3 = arrs
    wts = (_hwio(k1), _t(b1), _hwio(k2), _t(b2), _hwio(k3), _t(b3))
    c1, r, depth = ht.head_tail_stages(_t(x), *wts, (h1, w1))
    assert c1.shape == (2, h2, w2, c2) and r.shape == (2, h1, w1, c2)
    assert depth.dtype == torch.float32 and depth.shape == ref.shape
    assert (ref > 0).mean() > 0.2
    assert ulps(depth.numpy(), ref) <= MAX_ULPS
    assert torch.equal(depth, ht.head_tail_plain(_t(x), *wts, (h1, w1)))


@pytest.mark.parametrize("c,h0,w0,r", [(64, 18, 40, 8), (128, 12, 24, 8)])
def test_f32_refinenet_pre_convs_match_pallas_interpret(c, h0, w0, r):
    """Row 16 at f32 at vits' and vitb's widths: the four conv calls the f32
    kernel runs (rcu_conv's plain version: the ReLU pass, conv2a's ReLU'd
    copy, conv1b reading it), composed through refinenet_pre, against
    refinenet_pre_pallas at f32 in interpret mode within MAX_ULPS of max
    |out|; NHWC out, the TPU's 4-column halo dropped."""
    rng = np.random.default_rng(c + h0)
    specs = [((2, h0, w0, c), 1.0), ((2, h0, w0, c), 1.0)]
    for _ in range(4):
        specs += [((3, 3, c, c), (9 * c) ** -0.5), ((c,), 0.1)]
    arrs = [(rng.standard_normal(s) * k).astype(np.float32) for s, k in specs]
    with pltpu.force_tpu_interpret_mode():
        out = refinenet_pre_pallas(*(jnp.asarray(a) for a in arrs),
                                   block_rows=r, interpret=True)
    ref = np.asarray(jnp.transpose(out[:, :, :, 4:4 + w0], (0, 1, 3, 2)))
    rn0, path2, *ws = arrs
    tws = [_hwio(w) if w.ndim == 4 else _t(w) for w in ws]
    calls = []

    def conv(*args, **kw):
        calls.append(kw)
        return rp.rcu_conv(*args, **kw)

    ours = rp.rcu_chain(conv, _t(rn0), _t(path2), *tws)
    assert [k.get("relu_copy", False) for k in calls] == [False, True, False,
                                                          False]
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert ulps(ours.numpy(), ref) <= MAX_ULPS
    assert torch.equal(ours, rp.refinenet_pre(_t(rn0), _t(path2), *tws))
