"""PyTorch port, slice 3 on the CPU: the vitl path's kernels' plain versions
against the JAX package (Pallas kernels in interpret mode), the dispatch
repairs (the attention half by token count, the DPT tail by the JAX
package's planners), and a vitl-shaped model against the JAX model."""

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
from vr_video_generator_tpu.ops.attention import _flash_mha
from vr_video_generator_tpu.ops.head_tail_pallas import (big_pick_plan,
                                                         ext_pick_block_rows,
                                                         head_tail_big_pallas)
from vr_video_generator_tpu.ops.mlp_pallas import mlp_residual_pallas
from vr_video_generator_tpu.ops.preprocess import \
    network_input_size as jax_network_input_size
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch.models import dinov2 as port_dinov2
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.dpt import resolve_tail
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops.attention import (flash_attention,
                                                        flash_attention_plain,
                                                        mha)
from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
from vr_video_generator_tpu_torch.ops.mlp import (
    fc1_gelu_plain, fc2_residual_plain, mlp_residual_hblocked,
    mlp_residual_hblocked_stages, mlp_residual_plain, resident)
from vr_video_generator_tpu_torch.ops.preprocess import network_input_size
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


# --- row 9: the hidden-blocked MLP half-block ------------------------------

@pytest.mark.parametrize("dtype,atol", [
    (jnp.float32, 2e-5),   # the bounds of the row-8 test (and of the JAX
    (jnp.bfloat16, 6e-2),  # package's tests/test_mlp_pallas.py:44,58)
])
def test_mlp_hblocked_plain_matches_pallas_interpret(dtype, atol):
    """D=1024, hidden 4096, 72 rows: the JAX package takes the blocked
    `_kernel` (16 MB of weights), and so does the port (row 9)."""
    d, m = 1024, 72
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, 4 * d)) * 0.03).astype(np.float32),
        b1=(0.1 * rng.standard_normal(4 * d)).astype(np.float32),
        w2=(rng.standard_normal((4 * d, d)) * 0.02).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    tdt = getattr(torch, jnp.dtype(dtype).name)
    assert not resident(d, 4 * d, tdt)
    ref = mlp_residual_pallas(jnp.asarray(x, dtype),
                              **{k: jnp.asarray(v) for k, v in p.items()},
                              interpret=True)
    ours = mlp_residual_hblocked(
        _t(x, tdt), _t(p["ln_scale"]), _t(p["ln_bias"]), _t(p["w1"].T, tdt),
        _t(p["b1"], tdt), _t(p["w2"].T, tdt), _t(p["b2"], tdt),
        _t(p["gamma"], tdt))
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


def _hblocked_params(rng, d):
    return dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, 4 * d)) * 0.03).astype(np.float32),
        b1=(0.1 * rng.standard_normal(4 * d)).astype(np.float32),
        w2=(rng.standard_normal((4 * d, d)) * 0.02).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))


def _hblocked_torch_args(x, p, tdt):
    return (_t(x, tdt), _t(p["ln_scale"]), _t(p["ln_bias"]),
            _t(p["w1"].T, tdt), _t(p["b1"], tdt), _t(p["w2"].T, tdt),
            _t(p["b2"], tdt), _t(p["gamma"], tdt))


def test_mlp_hblocked_stages_compose_to_plain():
    """The plain versions of row 9's three stages (LayerNorm, fc1 + GELU,
    fc2 + LayerScale + residual), composed, are mlp_residual_plain bit for
    bit in bf16, at a row count no tile divides."""
    d, m = 1024, 77
    rng = np.random.default_rng(19)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    args = _hblocked_torch_args(x, _hblocked_params(rng, d), torch.bfloat16)
    x_t, lnw, lnb, w1, b1, w2, b2, gamma = args
    a = layernorm_plain(x_t, lnw, lnb)
    h = fc1_gelu_plain(a, w1, b1)
    out = fc2_residual_plain(h, w2, b2, gamma, x_t)
    assert out.dtype == h.dtype == a.dtype == torch.bfloat16
    assert torch.equal(out, mlp_residual_plain(*args))
    # The wrapper's stage-by-stage entry point takes the same plain stages
    # on the CPU.
    for got, want in zip(mlp_residual_hblocked_stages(*args), (a, h, out)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,atol", [
    (jnp.float32, 2e-5),   # test_mlp_hblocked_plain_matches_pallas_interpret's
    (jnp.bfloat16, 6e-2),  # bounds
])
def test_mlp_hblocked_stages_match_pallas_interpret(dtype, atol):
    """Row 9's chain, its three plain stages composed, against the JAX
    hidden-blocked body (`_kernel`, taken for its 16 MB of weights) in
    interpret mode, at 72 rows."""
    d, m = 1024, 72
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = _hblocked_params(rng, d)
    tdt = getattr(torch, jnp.dtype(dtype).name)
    assert not resident(d, 4 * d, tdt)
    ref = mlp_residual_pallas(jnp.asarray(x, dtype),
                              **{k: jnp.asarray(v) for k, v in p.items()},
                              interpret=True)
    x_t, lnw, lnb, w1, b1, w2, b2, gamma = _hblocked_torch_args(x, p, tdt)
    h = fc1_gelu_plain(layernorm_plain(x_t, lnw, lnb), w1, b1)
    ours = fc2_residual_plain(h, w2, b2, gamma, x_t)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


# --- rows 11, 12: the big-C DPT tail ---------------------------------------

# bf16: the same rounding points, f32 sums in another order, so single
# pixels move by a bf16 ulp of an intermediate. Measured here: max 1.0e-3,
# mean 5.4e-5 of the depth range. Copies with a wrong fold or cast point
# (out_conv's mix applied before the upsample, the fold kept in f32, no cast
# after the W-upsample, the W-resize cast before cw) move the mean by
# 3.9e-4 to 6.4e-4 of the range, above BIG_MEAN_REL.
BIG_MAX_REL, BIG_MEAN_REL = 2e-3, 2e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0,w0,c,c2,c3", [(36, 64, 256, 128, 32),
                                           (20, 32, 256, 128, 32)])
def test_head_tail_big_plain_matches_pallas_interpret(h0, w0, c, c2, c3,
                                                      dtype):
    """f32 within 5e-4 (the JAX test's bound, tests/test_head_tail.py:115);
    bf16 within BIG_MAX_REL / BIG_MEAN_REL of the depth range. Both sides get
    the same (bf16-representable, for bf16) weights."""
    rng = np.random.default_rng(h0)
    h1, w1 = h0 * 14 // 4, w0 * 14 // 4
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert big_pick_plan((2, h0, w0, c), c2, jdt, (h1, w1)) is not None
    shapes = [((2, h0, w0, c), 1.0, 0.0), ((1, 1, c, c), c ** -0.5, 0.0),
              ((c,), 0.1, 0.0), ((3, 3, c, c2), (9 * c) ** -0.5, 0.0),
              ((c2,), 0.1, 0.0), ((3, 3, c2, c3), (9 * c2) ** -0.5, 0.0),
              ((c3,), 0.1, 0.0), ((1, 1, c3, 1), c3 ** -0.5, 0.0),
              ((1,), 0.1, 0.5)]
    args = [np.asarray(jnp.asarray(rng.standard_normal(s) * k + o, jdt)
                       .astype(jnp.float32)) for s, k, o in shapes]
    ref = np.asarray(head_tail_big_pallas(
        jnp.asarray(args[0], jdt), *(jnp.asarray(a) for a in args[1:]),
        (h1, w1), interpret=True))
    hwio = lambda k: _t(k.transpose(3, 2, 0, 1), tdt)  # -> (O, I, kh, kw)
    x, k_oc, b_oc, k1, b1, k2, b2, k3, b3 = args
    ours = ht.head_tail_big(_t(x, tdt), hwio(k_oc), _t(b_oc, tdt), hwio(k1),
                            _t(b1, tdt), hwio(k2), _t(b2, tdt), hwio(k3),
                            _t(b3, tdt), (h1, w1)).numpy()
    assert ours.shape == ref.shape == (2, h1, w1)
    err = np.abs(ours - ref)
    if dtype == "float32":
        assert err.max() <= 5e-4
    else:
        span = ref.max() - ref.min()
        assert err.max() <= BIG_MAX_REL * span
        assert err.mean() <= BIG_MEAN_REL * span


# --- row 17: flash attention past 4096 tokens ------------------------------

def test_flash_attention_plain_matches_library_kernel():
    """(B, N, H, D) = (1, 4200, 2, 64), bf16, scale 0.125, against the JAX
    package's _flash_mha (the library kernel in TPU interpret mode). The
    same 512-key blocks and rounding points; the f32 sums run in another
    order, so an output may sit one bf16 ulp away: at most 1% of outputs,
    by at most 1e-3 (mean |o| is ~0.04 here; measured: 0.33% of outputs,
    max 4.9e-4, mean 1.8e-7). The XLA attention, a one-shot softmax, is
    further from the library: max 3.9e-3, mean 7.8e-5."""
    rng = np.random.default_rng(0)
    b, n, h, d = 1, 4200, 2, 64
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               for _ in range(3))
    k *= 1.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_flash_mha(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 0.125)
            .astype(jnp.float32))
    bf = torch.bfloat16
    ours = flash_attention(_t(q, bf), _t(k, bf), _t(v, bf), 0.125)
    assert ours.dtype == bf and ours.shape == (b, n, h, d)
    err = np.abs(ours.float().numpy() - ref)
    assert (err > 0).mean() <= 0.01
    assert err.max() <= 1e-3


def test_mha_dispatches_by_token_count(monkeypatch):
    """mha runs the one-shot function up to 4096 tokens and the flash
    function above, as the JAX package's mha does on its accelerator."""
    import vr_video_generator_tpu_torch.ops.attention as att

    calls = []
    monkeypatch.setattr(att, "attention",
                        lambda q, k, v: calls.append("oneshot") or q)
    monkeypatch.setattr(att, "flash_attention",
                        lambda q, k, v, s: calls.append("flash") or q)
    for n in (4096, 4097):
        x = torch.zeros(1, n, 1, 64, dtype=torch.bfloat16)
        mha(x, x, x, 0.125)
    assert calls == ["oneshot", "flash"]
    x = torch.randn(1, 600, 1, 64, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(
        flash_attention_plain(x, x, x, 0.125).numpy(),
        torch.softmax((x[:, :, 0] @ x[:, :, 0].transpose(1, 2)) * 0.125,
                      dim=-1).matmul(x[:, :, 0]).unsqueeze(2).numpy(),
        rtol=0, atol=1e-5)


# --- repair A1: the attention half fuses only up to 4096 tokens ------------

BLOCK_CFG = config.ModelConfig(encoder="vits", embed_dim=128, depth=1,
                               num_heads=2, mlp_ratio=4.0, features=32,
                               out_channels=(8, 16, 32, 32),
                               intermediate_layers=(0, 0, 0, 0),
                               depth_scaler=12.0, mlp_fused="fused")


def test_block_above_4096_tokens_runs_attention_unfused(monkeypatch):
    """A fused Block over N = 4097 tokens runs its attention half unfused
    (LayerNorm -> qkv -> flash attention -> proj -> LayerScale), as the JAX
    package's Block does (ln_qkv is never reached), and equals JAX
    Block(mlp_fused='fused') on the same converted weights in f32 within the
    fused-block bound, 3e-5."""
    def refuse(*a, **k):
        raise AssertionError("ln_qkv reached above 4096 tokens")

    monkeypatch.setattr(port_dinov2, "ln_qkv", refuse)
    f32, bf16 = torch.float32, torch.bfloat16
    assert resolve_block_fusion("fused", 128, 2, 4097, "cpu", f32) == (False, True)
    assert resolve_block_fusion("fused", 128, 2, 4096, "cpu", f32) == (True, True)
    assert resolve_block_fusion("auto", 1024, 16, 4785, "cuda", bf16) == (False, True)
    sd = _biased(random_state_dict(BLOCK_CFG, seed=3), 3)
    model = build_model(BLOCK_CFG, sd, torch.float32, "cpu")
    x = np.random.default_rng(5).standard_normal((1, 4097, 128)).astype(np.float32)
    jparams = convert_state_dict(sd, BLOCK_CFG)["pretrained"]["block0"]
    jblk = JaxBlock(dim=128, num_heads=2, mlp_ratio=4.0, mlp_fused="fused")
    ref = np.asarray(jblk.apply({"params": jparams}, jnp.asarray(x)))
    ours = model.pretrained.blocks[0](_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=3e-5)


# --- repair A2: the tail follows the JAX package's planners ----------------

def _jax_choice(shape, dtype, out_hw):
    c2 = shape[-1] // 2
    if ext_pick_block_rows(shape, c2, dtype, out_hw) is not None:
        return "ext"
    if big_pick_plan(shape, c2, dtype, out_hw) is not None:
        return "big"
    return None


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl", "vitg"])
def test_tail_choice_matches_jax_planners(encoder, dtype):
    """At 720p, 1080p and 2160p and every --input_size of the grid, the
    port's tail is the JAX planners' (its DPTHead: ext, else big, else
    unfused), for ``fused`` off and on the card and ``auto`` on the card."""
    feats = config.ModelConfig.for_encoder(encoder).features
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    seen = set()
    for h, w in ((720, 1280), (1080, 1920), (2160, 3840)):
        for size in (56, 126, 518, 616, 728, 840, 1036):
            nh, nw = network_input_size(h, w, target=size, multiple_of=14)
            assert (nh, nw) == tuple(jax_network_input_size(
                h, w, target=size, multiple_of=14))
            shape = (8, 4 * nh // 14, 4 * nw // 14, feats)
            want = _jax_choice(shape, jdt, (nh, nw))
            seen.add(want)
            assert resolve_tail("fused", shape, tdt, (nh, nw), "cpu") == want
            assert resolve_tail("auto", shape, tdt, (nh, nw), "cpu") is None
            for tail in ("fused", "auto"):
                assert resolve_tail(tail, shape, tdt, (nh, nw), "cuda") == want
    if encoder in ("vitb", "vitl") and dtype == "bfloat16":
        assert seen == {"ext", "big", None}  # the grid reaches all three


def test_tail_choice_at_vitb_728_and_1036():
    """The parent's fixed channel list ran the ext tail here."""
    for size, want in ((728, "big"), (1036, None)):
        nh, nw = network_input_size(1080, 1920, target=size, multiple_of=14)
        shape = (8, 4 * nh // 14, 4 * nw // 14, 128)
        assert resolve_tail("auto", shape, torch.bfloat16, (nh, nw),
                            "cuda") == want


# --- a vitl-shaped model against the JAX model ------------------------------

VITL2 = dataclasses.replace(config.ModelConfig.for_encoder("vitl"), depth=2,
                            intermediate_layers=(0, 1, 1, 1),
                            depth_scaler=12.0, mlp_fused="fused")


def test_vitl_shaped_model_matches_jax():
    """D=1024, 16 heads, depth 2, features 256, out_channels (256, 512,
    1024, 1024): a JAX parameter tree carried across by state_dict_from_jax.
    The port with mlp_fused='fused', tail='fused' (plain versions on the
    CPU) against JAX DepthAnythingV2(mlp_fused='fused', tail='fused') (its
    Pallas kernels in TPU interpret mode), f32 depth within 1e-4 of its max.
    At this tiny input both resolve the tail to ext, and the MLP half to the
    hidden-blocked function."""
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(VITL2))
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(
        _biased(random_state_dict(VITL2, seed=4), 4), VITL2))
    sd = state_dict_from_jax(jparams, VITL2)
    frames = np.random.default_rng(7).integers(0, 256, (2, 48, 80, 3),
                                               dtype=np.uint8)
    nh, nw = network_input_size(48, 80, target=56, multiple_of=14)
    pre = (2, 4 * nh // 14, 4 * nw // 14, 256)
    assert resolve_tail("fused", pre, torch.float32, (nh, nw), "cpu") == "ext"
    assert _jax_choice(pre, jnp.float32, (nh, nw)) == "ext"
    assert not resident(1024, 4096, torch.float32)
    jmodel = JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="fused")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_infer_depth(jmodel, jparams, jnp.asarray(frames),
                                         input_size=56))
    model = build_model(VITL2, sd, torch.float32, "cpu", tail="fused")
    assert set(model.state_dict()) == set(sd)
    ours = infer_depth(model, torch.from_numpy(frames), input_size=56).numpy()
    assert ours.shape == ref.shape == (2, 48, 80)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
