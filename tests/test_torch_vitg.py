"""PyTorch port, slice 4 on the CPU: the vitg (DINOv2-giant, SwiGLU) path.
The SwiGLU half-block's plain version and the DPT tails at vitg's and vitl's
widths against the JAX package (Pallas kernels in interpret mode), the
SwiGLU Block and a vitg-shaped model against the JAX ones, the conversion of
a vitg tree, and the two dispatch repairs: the attention half follows the
JAX package's attn_fusable, and every tail the planners pick has a kernel."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2, infer_depth as jax_infer_depth)
from vr_video_generator_tpu.models.dinov2 import Block as JaxBlock
from vr_video_generator_tpu.ops.attention_pallas import \
    supported as jax_supported
from vr_video_generator_tpu.ops.head_tail_pallas import (big_pick_plan,
                                                         ext_pick_block_rows,
                                                         head_tail_big_pallas,
                                                         head_tail_ext_pallas)
from vr_video_generator_tpu.ops.mlp_pallas import (swiglu_residual_pallas,
                                                   swiglu_residual_ref)
from vr_video_generator_tpu.ops.preprocess import \
    network_input_size as jax_network_input_size
from vr_video_generator_tpu.ops.qkv_pallas import _qkv_block_n, attn_fusable
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch.models import dinov2 as port_dinov2
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.dpt import resolve_tail
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops.mlp import (silu_mul, swiglu_hidden,
                                                  swiglu_residual)
from vr_video_generator_tpu_torch.ops.preprocess import network_input_size
from vr_video_generator_tpu_torch.ops.qkv import qkv_block_n
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _biased(sd, seed):
    """Non-zero biases (where the rounding orders part) on a state_dict."""
    rng = np.random.default_rng(seed + 100)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(np.float32)
    return sd


# --- row 10: the SwiGLU half-block ------------------------------------------

def test_silu_rounding_is_xla_bf16():
    """silu(x1) * x2 in bf16 is bit-exact against jax.nn.silu(x1) * x2 on
    the CPU: XLA evaluates logistic on bf16 as 1 / (1 + exp(-x)) rounding
    after each operation (the f32 logistic rounded once differs in ~34% of
    values here)."""
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(20000).astype(np.float32) * 3 for _ in range(2))
    ref = np.asarray((jax.nn.silu(jnp.asarray(a, jnp.bfloat16))
                      * jnp.asarray(b, jnp.bfloat16)).astype(jnp.float32))
    ours = silu_mul(_t(a, torch.bfloat16), _t(b, torch.bfloat16))
    np.testing.assert_array_equal(ours.float().numpy(), ref)


@pytest.mark.parametrize("dtype,atol", [
    (jnp.float32, 2e-5),   # the JAX package's half-block bounds
    (jnp.bfloat16, 6e-2),  # (tests/test_mlp_pallas.py:44, 58, 89)
])
def test_swiglu_plain_matches_pallas_interpret(dtype, atol):
    """D=1536, hidden 4096 (vitg), 72 rows: the port's function (its plain
    version on the CPU) against swiglu_residual_pallas(interpret=True) and
    against swiglu_residual_ref."""
    d, hid, m = 1536, 4096, 72
    assert swiglu_hidden(d) == hid
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w12=(rng.standard_normal((d, 2 * hid)) * d ** -0.5).astype(np.float32),
        b12=(0.1 * rng.standard_normal(2 * hid)).astype(np.float32),
        w3=(rng.standard_normal((hid, d)) * hid ** -0.5).astype(np.float32),
        b3=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    tdt = getattr(torch, jnp.dtype(dtype).name)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ours = swiglu_residual(
        _t(x, tdt), _t(p["ln_scale"]), _t(p["ln_bias"]), _t(p["w12"].T, tdt),
        _t(p["b12"], tdt), _t(p["w3"].T, tdt), _t(p["b3"], tdt),
        _t(p["gamma"], tdt)).float().numpy()
    for ref in (swiglu_residual_pallas(jnp.asarray(x, dtype), **jp,
                                       interpret=True),
                swiglu_residual_ref(jnp.asarray(x, dtype), **jp)):
        np.testing.assert_allclose(ours, np.asarray(ref.astype(jnp.float32)),
                                   rtol=0, atol=atol)


# A vitg-width block: D=1536, 24 heads, SwiGLU.
VITG2 = dataclasses.replace(config.ModelConfig.for_encoder("vitg"), depth=2,
                            out_channels=(192, 384, 768, 768),
                            intermediate_layers=(0, 1, 1, 1),
                            depth_scaler=12.0, mlp_fused="fused")


@pytest.mark.parametrize("mlp_fused", ["fused", "xla"])
def test_swiglu_block_matches_jax(mlp_fused):
    """The port's Block(ffn_layer='swiglufused') against the JAX one on the
    same converted weights, N = 41 tokens, f32 within 3e-5 (the fused-block
    bound). 'fused' runs the attention half unfused on both sides (D=1536 is
    not attn_fusable) and the SwiGLU half through swiglu_residual (the
    Pallas kernel in interpret mode; the port's plain version on the CPU);
    'xla' runs both halves unfused."""
    cfg = dataclasses.replace(VITG2, depth=1, mlp_fused=mlp_fused)
    sd = _biased(random_state_dict(cfg, seed=11), 11)
    model = build_model(cfg, sd, torch.float32, "cpu")
    blk = model.pretrained.blocks[0]
    assert blk.mlp.w12.weight.shape == (8192, 1536)
    assert resolve_block_fusion(mlp_fused, 1536, 24, 41, "cpu", torch.float32,
                                "swiglufused") == (False, mlp_fused == "fused")
    x = np.random.default_rng(5).standard_normal((1, 41, 1536)).astype(np.float32)
    jparams = convert_state_dict(sd, cfg)["pretrained"]["block0"]
    jblk = JaxBlock(dim=1536, num_heads=24, mlp_ratio=4.0,
                    ffn_layer="swiglufused", mlp_fused=mlp_fused)
    ref = np.asarray(jblk.apply({"params": jparams}, jnp.asarray(x)))
    np.testing.assert_allclose(blk(_t(x)).numpy(), ref, rtol=0, atol=3e-5)


def test_vitg_tree_round_trips_through_state_dict_from_jax():
    """convert_state_dict(state_dict_from_jax(p)) == p on a vitg-shaped
    tree: the SwiGLU blocks carry mlp.w12 / mlp.w3 both ways."""
    cfg = dataclasses.replace(VITG2, depth=2)
    params = convert_state_dict(random_state_dict(cfg, seed=3), cfg)
    assert set(params["pretrained"]["block1"]["mlp"]) == {"w12", "w3"}
    sd = state_dict_from_jax(params, cfg)
    assert sd["pretrained.blocks.1.mlp.w12.weight"].shape == (8192, 1536)
    back = convert_state_dict(sd, cfg)
    flat = jax.tree_util.tree_flatten_with_path
    want, got = flat(params)[0], flat(back)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(k))


# --- rows 11, 12 at C=384 and row 7 at C=256 / 384 --------------------------

# The bf16 bounds of tests/test_torch_vitl.py (share of the depth range).
BIG_MAX_REL, BIG_MEAN_REL = 2e-3, 2e-4


def _tail_args(rng, shape, c, jdt):
    c2, c3 = c // 2, 32
    shapes = [(shape, 1.0, 0.0), ((1, 1, c, c), c ** -0.5, 0.0),
              ((c,), 0.1, 0.0), ((3, 3, c, c2), (9 * c) ** -0.5, 0.0),
              ((c2,), 0.1, 0.0), ((3, 3, c2, c3), (9 * c2) ** -0.5, 0.0),
              ((c3,), 0.1, 0.0), ((1, 1, c3, 1), c3 ** -0.5, 0.0),
              ((1,), 0.1, 0.5)]
    return [np.asarray(jnp.asarray(rng.standard_normal(s) * k + o, jdt)
                       .astype(jnp.float32)) for s, k, o in shapes]


def _port_tail(fn, args, tdt, out_hw):
    hwio = lambda k: _t(k.transpose(3, 2, 0, 1), tdt)  # -> (O, I, kh, kw)
    x, k_oc, b_oc, k1, b1, k2, b2, k3, b3 = args
    return fn(_t(x, tdt), hwio(k_oc), _t(b_oc, tdt), hwio(k1), _t(b1, tdt),
              hwio(k2), _t(b2, tdt), hwio(k3), _t(b3, tdt), out_hw).numpy()


def _assert_tail_close(ours, ref, dtype):
    """f32 within 5e-4 (tests/test_head_tail.py:115); bf16 within the
    share of the depth range above."""
    err = np.abs(ours - ref)
    if dtype == "float32":
        assert err.max() <= 5e-4
    else:
        span = ref.max() - ref.min()
        assert err.max() <= BIG_MAX_REL * span
        assert err.mean() <= BIG_MEAN_REL * span


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_big_tail_at_c384_matches_pallas_interpret(dtype):
    """vitg's big-C tail (C=384, C2=192) on a 20 x 32 grid against
    head_tail_big_pallas in TPU interpret mode."""
    h0, w0, c = 20, 32, 384
    h1, w1 = h0 * 14 // 4, w0 * 14 // 4
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert big_pick_plan((2, h0, w0, c), c // 2, jdt, (h1, w1)) is not None
    args = _tail_args(np.random.default_rng(384), (2, h0, w0, c), c, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_big_pallas(
            jnp.asarray(args[0], jdt), *(jnp.asarray(a) for a in args[1:]),
            (h1, w1), interpret=True))
    ours = _port_tail(ht.head_tail_big, args, tdt, (h1, w1))
    assert ours.shape == ref.shape == (2, h1, w1)
    _assert_tail_close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,h0,w0", [(256, 12, 20), (384, 12, 20)])
def test_ext_tail_at_c256_c384_matches_pallas_interpret(c, h0, w0, dtype):
    """The ext tail at vitl's and vitg's widths against
    head_tail_ext_pallas(interpret=True), on a grid the planners give the
    ext tail."""
    h1, w1 = h0 * 14 // 4, w0 * 14 // 4
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert ext_pick_block_rows((2, h0, w0, c), c // 2, jdt, (h1, w1)) is not None
    args = _tail_args(np.random.default_rng(c + h0), (2, h0, w0, c), c, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_ext_pallas(
            jnp.asarray(args[0], jdt), *(jnp.asarray(a) for a in args[1:]),
            (h1, w1), interpret=True))
    ours = _port_tail(ht.head_tail_ext, args, tdt, (h1, w1))
    assert ours.shape == ref.shape == (2, h1, w1)
    _assert_tail_close(ours, ref, dtype)


# --- repair 1: the attention half follows attn_fusable ----------------------

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d", [128, 384, 768, 1024, 1536])
def test_attention_fusion_matches_jax_condition(d, dtype):
    """The port fuses the attention half exactly where the JAX Block does
    (head dim 64, supported(N), attn_fusable(D, N, dtype)), for 'fused' off
    and on the card and 'auto' on the card; its copy of the VMEM plan is the
    JAX package's."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert qkv_block_n(d, tdt) == _qkv_block_n(d, jdt)
    ffn = "swiglufused" if d == 1536 else "mlp"
    for n in (41, 2443, 4097):
        want = d % 128 == 0 and jax_supported(n) and attn_fusable(d, n, jdt)
        for mode, dev in (("fused", "cpu"), ("fused", "cuda"), ("auto", "cuda")):
            assert resolve_block_fusion(mode, d, d // 64, n, dev, tdt,
                                        ffn)[0] == want, (mode, dev, n)


def test_block_at_d1024_f32_runs_attention_unfused(monkeypatch):
    """At D=1024 in f32 the JAX package has no qkv plan (13 MiB), so its
    fused Block runs LayerNorm -> qkv -> attention -> proj; so does the
    port's (ln_qkv is never reached), equal to the JAX Block on the same
    converted weights, f32 within 3e-5. The parent fused it here."""
    def refuse(*a, **k):
        raise AssertionError("ln_qkv reached at D=1024 in f32")

    monkeypatch.setattr(port_dinov2, "ln_qkv", refuse)
    cfg = config.ModelConfig(encoder="vitl", embed_dim=1024, depth=1,
                             num_heads=16, mlp_ratio=4.0, features=32,
                             out_channels=(8, 16, 32, 32),
                             intermediate_layers=(0, 0, 0, 0),
                             depth_scaler=12.0, mlp_fused="fused")
    assert resolve_block_fusion("fused", 1024, 16, 41, "cpu",
                                torch.float32) == (False, True)
    assert resolve_block_fusion("fused", 1024, 16, 41, "cpu",
                                torch.bfloat16) == (True, True)
    sd = _biased(random_state_dict(cfg, seed=8), 8)
    model = build_model(cfg, sd, torch.float32, "cpu")
    x = np.random.default_rng(6).standard_normal((1, 41, 1024)).astype(np.float32)
    jparams = convert_state_dict(sd, cfg)["pretrained"]["block0"]
    jblk = JaxBlock(dim=1024, num_heads=16, mlp_ratio=4.0, mlp_fused="fused")
    ref = np.asarray(jblk.apply({"params": jparams}, jnp.asarray(x)))
    ours = model.pretrained.blocks[0](_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=3e-5)


# --- repair 2: every planned tail has a kernel -------------------------------

def _jax_choice(shape, dtype, out_hw):
    c2 = shape[-1] // 2
    if ext_pick_block_rows(shape, c2, dtype, out_hw) is not None:
        return "ext"
    if big_pick_plan(shape, c2, dtype, out_hw) is not None:
        return "big"
    return None


@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl", "vitg"])
def test_every_planned_tail_has_a_kernel(encoder):
    """At 720p, 1080p and 2160p and every --input_size from 14 to 1190 in
    steps of 14, bf16: resolve_tail on the card returns the JAX planners'
    choice for 'fused' and 'auto', and the chosen tail's kernels take the
    shape (the JAX kernel's width rule, ops/head_tail.takes, at every
    grid), so no kernel wrapper's ValueError is reachable from a plan."""
    feats = config.ModelConfig.for_encoder(encoder).features
    seen = set()
    for h, w in ((720, 1280), (1080, 1920), (2160, 3840)):
        for size in range(14, 1191, 14):
            nh, nw = network_input_size(h, w, target=size, multiple_of=14)
            assert (nh, nw) == tuple(jax_network_input_size(
                h, w, target=size, multiple_of=14))
            shape = (8, 4 * nh // 14, 4 * nw // 14, feats)
            want = _jax_choice(shape, jnp.bfloat16, (nh, nw))
            seen.add(want)
            for tail in ("fused", "auto"):
                assert resolve_tail(tail, shape, torch.bfloat16, (nh, nw),
                                    "cuda") == want
            if want is not None:
                assert ht.takes(feats, want), (size, shape)
    assert "ext" in seen
    if encoder != "vits":
        assert "big" in seen


def test_unplanned_width_raises_on_the_card():
    """A head of 48 features plans the ext tail on the card and off it (its
    kernels run it zero-padded); a tail at a width the JAX kernel refuses
    (a head of 40 features, C2 = 20) raises ValueError naming the JAX
    assert on the card and off it, where the JAX package raises
    AssertionError."""
    shape, out_hw = (1, 16, 28, 48), (56, 98)
    for device in ("cpu", "cuda"):
        assert resolve_tail("fused", shape, torch.bfloat16, out_hw,
                            device) == "ext"
        with pytest.raises(ValueError, match=r"ext DPT tail takes no head "
                                             r"of C=40.*pallas.py:395"):
            resolve_tail("fused", (1, 16, 28, 40), torch.bfloat16, out_hw,
                         device)


# --- a vitg-shaped model against the JAX model -------------------------------

@pytest.mark.parametrize("input_size,tail", [(56, "ext"), (224, "big")])
def test_vitg_shaped_model_matches_jax(input_size, tail):
    """D=1536, 24 heads, depth 2, SwiGLU, features 384, out_channels
    narrowed to (192, 384, 768, 768): a JAX parameter tree carried across by
    state_dict_from_jax. The port with mlp_fused='fused', tail='fused'
    (plain versions on the CPU) against the JAX DepthAnythingV2 with the
    same flags (its Pallas kernels in TPU interpret mode), f32 depth within
    1e-4 of its max, at the input size where the planners pick each tail."""
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(VITG2))
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(
        _biased(random_state_dict(VITG2, seed=4), 4), VITG2))
    sd = state_dict_from_jax(jparams, VITG2)
    frames = np.random.default_rng(7).integers(0, 256, (1, 48, 80, 3),
                                               dtype=np.uint8)
    nh, nw = network_input_size(48, 80, target=input_size, multiple_of=14)
    pre = (1, 4 * nh // 14, 4 * nw // 14, 384)
    assert resolve_tail("fused", pre, torch.float32, (nh, nw), "cpu") == tail
    assert _jax_choice(pre, jnp.float32, (nh, nw)) == tail
    jmodel = JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="fused")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_infer_depth(jmodel, jparams, jnp.asarray(frames),
                                         input_size=input_size))
    model = build_model(VITG2, sd, torch.float32, "cpu", tail="fused")
    assert set(model.state_dict()) == set(sd)
    ours = infer_depth(model, torch.from_numpy(frames),
                       input_size=input_size).numpy()
    assert ours.shape == ref.shape == (1, 48, 80)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
