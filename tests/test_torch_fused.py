"""PyTorch port, slice 2 on the CPU: the fused half-block and DPT tail plain
versions against the JAX package's Pallas kernels in interpret mode, the
fused Block, model and pipeline against the JAX package with the same flags,
the flax rounding of the dense and conv layers, the resolution of ``auto``,
and the port's own copies of the JAX package's configuration and CLI
parser."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu import cli as jcli
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2, infer_depth as jax_infer_depth)
from vr_video_generator_tpu.models.dinov2 import Block as JaxBlock
from vr_video_generator_tpu.models.dpt import DPTHead as JaxDPTHead
from vr_video_generator_tpu.ops.head_tail_pallas import head_tail_ext_pallas
from vr_video_generator_tpu.ops.mlp_pallas import mlp_residual_pallas
from vr_video_generator_tpu.ops.qkv_pallas import (ln_qkv_pallas,
                                                   proj_ls_residual_pallas)
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch import cli
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.dpt import resolve_tail
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.models.layers import Conv2d, Linear
from vr_video_generator_tpu_torch.ops.head_tail import head_tail_ext
from vr_video_generator_tpu_torch.ops.mlp import mlp_residual
from vr_video_generator_tpu_torch.ops.qkv import ln_qkv, proj_ls_residual
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)

# D=128 with 2 heads of 64 (the fused kernels' layout), a 32-feature head
# (the narrowest the tail kernel takes), 2 blocks.
TINY = config.ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                          mlp_ratio=4.0, features=32,
                          out_channels=(8, 16, 32, 32),
                          intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                          mlp_fused="fused")
JTINY = jconfig.ModelConfig(**dataclasses.asdict(TINY))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _weights(seed=2):
    """Seeded random upstream state_dict with non-zero biases (the bias is
    where the two rounding orders part)."""
    rng = np.random.default_rng(seed + 100)
    sd = random_state_dict(TINY, seed=seed)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(np.float32)
    return sd


# --- the plain versions against the Pallas kernels (interpret mode) ------

def _attn_case(rng, b, n, d):
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    lnw = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (rng.standard_normal((3 * d, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * d)).astype(np.float32)
    return x, lnw, lnb, w, bias


@pytest.mark.parametrize("b,n", [(2, 70), (1, 17)])
def test_ln_qkv_plain_matches_pallas_interpret_f32(b, n):
    """N = 70 and 17 are not multiples of the Pallas token block; the TPU's
    (B, H, N_pad, 64) q/k/v map to the port's (B, N, 3, H, 64)."""
    d, heads = 128, 2
    x, lnw, lnb, w, bias = _attn_case(np.random.default_rng(n), b, n, d)
    qt, kt, vt = ln_qkv_pallas(jnp.asarray(x), jnp.asarray(lnw),
                               jnp.asarray(lnb), jnp.asarray(w.T),
                               jnp.asarray(bias), heads, 64 ** -0.5,
                               interpret=True)
    ref = np.stack([np.asarray(t)[:, :, :n].transpose(0, 2, 1, 3)
                    for t in (qt, kt, vt)], axis=2)
    ours = ln_qkv(_t(x), _t(lnw), _t(lnb), _t(w), _t(bias), heads,
                  64 ** -0.5).numpy()
    assert ours.shape == (b, n, 3, heads, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        mag = bits & 0x7FFF
        return torch.where(bits < 0, -mag, mag)
    return (ordered(a) - ordered(b)).abs()


def test_ln_qkv_plain_matches_pallas_interpret_bf16():
    """bf16: the same rounding points. The f32 sums of LN and the GEMM run
    in another order, so an output may sit one bf16 ulp apart where its f32
    value lies at a rounding boundary: at most 1% of outputs, each within
    one ulp of the product before the bias (2^-7 relative to |q|+|bias|)."""
    d, heads, n = 128, 2, 40
    x, lnw, lnb, w, bias = _attn_case(np.random.default_rng(9), 2, n, d)
    xb = jnp.asarray(x, jnp.bfloat16)
    qt, kt, vt = ln_qkv_pallas(xb, jnp.asarray(lnw), jnp.asarray(lnb),
                               jnp.asarray(w.T, jnp.bfloat16),
                               jnp.asarray(bias, jnp.bfloat16), heads,
                               64 ** -0.5, interpret=True)
    ref = np.stack([np.asarray(t.astype(jnp.float32))[:, :, :n]
                    .transpose(0, 2, 1, 3) for t in (qt, kt, vt)], axis=2)
    bf = torch.bfloat16
    ours = ln_qkv(_t(x, bf), _t(lnw), _t(lnb), _t(w, bf), _t(bias, bf),
                  heads, 64 ** -0.5)
    refb = torch.from_numpy(ref.copy()).to(bf)
    assert (_bf16_ulps(ours, refb) > 0).float().mean().item() <= 0.01
    bias_abs = torch.from_numpy(np.abs(bias)).reshape(3, heads, 64)
    err = (ours.float() - refb.float()).abs()
    assert bool((err <= 2.0 ** -7 * (refb.float().abs() + bias_abs)).all())


# D = 128 (2 x 37 rows), and the widths row 6 runs at, vits' D = 384 and
# vitl's 1024, on row counts that are no multiple of the GEMM core's 128-row
# tile (300 and 2 x 131); o padded to the JAX kernel's 512-token blocks. At
# the wide cases the bf16 ulps are counted in the scale of the output's
# largest operand (the output, the residual x, the f32 product o w): a
# one-ulp flip of the bf16 product (K = 1024 sums in another order) is two
# ulps of an output that x and gamma * y nearly cancel (1 of the 536k
# outputs at D = 1024).
@pytest.mark.parametrize("dtype,b,n,heads,d", [
    pytest.param("float32", 2, 37, 2, 128, id="float32"),
    pytest.param("bfloat16", 2, 37, 2, 128, id="bfloat16"),
    pytest.param("float32", 1, 300, 6, 384, id="float32-D384-M300"),
    pytest.param("bfloat16", 1, 300, 6, 384, id="bfloat16-D384-M300"),
    pytest.param("float32", 2, 131, 16, 1024, id="float32-D1024-M262"),
    pytest.param("bfloat16", 2, 131, 16, 1024, id="bfloat16-D1024-M262"),
])
def test_proj_plain_matches_pallas_interpret(dtype, b, n, heads, d):
    """f32 within 1e-5; bf16 within one ulp (of the output at D = 128, of
    its largest operand at the wide cases) at <= 1% of the outputs."""
    rng = np.random.default_rng(4)
    o = rng.standard_normal((b, n, heads, 64)).astype(np.float32)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    ot = jnp.asarray(o.transpose(0, 2, 1, 3), jdt)
    ot = jnp.pad(ot, ((0, 0), (0, 0), (0, -n % 512), (0, 0)))
    ref = np.asarray(proj_ls_residual_pallas(
        ot, jnp.asarray(x, jdt), jnp.asarray(w.T), jnp.asarray(bias),
        jnp.asarray(gamma), interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    ours = proj_ls_residual(_t(o, tdt), _t(x, tdt), _t(w, tdt),
                            _t(bias, tdt), _t(gamma, tdt))
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    else:
        refb = torch.from_numpy(ref.copy()).to(tdt)
        ulps = _bf16_ulps(ours, refb)
        assert (ulps > 0).float().mean().item() <= 0.01
        if d == 128:
            assert int(ulps.max()) <= 1
        else:
            prod = _t(o, tdt).float().reshape(b, n, d) @ _t(w, tdt).float().T
            scale = torch.stack([refb.float().abs(), _t(x, tdt).float().abs(),
                                 prod.abs()]).amax(dim=0)
            ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
            assert bool(((ours.float() - refb.float()).abs() <= ulp).all())


def _mlp_case(rng, m, d, dtype):
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, 4 * d)) * 0.05).astype(np.float32),
        b1=(0.1 * rng.standard_normal(4 * d)).astype(np.float32),
        w2=(rng.standard_normal((4 * d, d)) * 0.05).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    ref = mlp_residual_pallas(jnp.asarray(x, dtype),
                              **{k: jnp.asarray(v) for k, v in p.items()},
                              interpret=True)
    tdt = getattr(torch, str(jnp.dtype(dtype)))
    ours = mlp_residual(_t(x, tdt), _t(p["ln_scale"]), _t(p["ln_bias"]),
                        _t(p["w1"].T, tdt), _t(p["b1"], tdt),
                        _t(p["w2"].T, tdt), _t(p["b2"], tdt),
                        _t(p["gamma"], tdt))
    return ours.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("m,dtype,atol", [
    (100, jnp.float32, 2e-5),    # the JAX tests' bounds
    (72, jnp.bfloat16, 6e-2),    # (tests/test_mlp_pallas.py:44,58)
])
def test_mlp_residual_plain_matches_pallas_interpret(m, dtype, atol):
    ours, ref = _mlp_case(np.random.default_rng(m), m, 128, dtype)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("h0,w0,c,c2,c3", [
    (12, 20, 64, 32, 32),     # vits channel widths
    (12, 20, 32, 16, 8),      # C2 != C3 (the plain version takes any width)
])
def test_head_tail_ext_plain_matches_pallas_interpret(h0, w0, c, c2, c3):
    """f32 within 5e-4, the JAX test's bound (tests/test_head_tail.py:92)."""
    rng = np.random.default_rng(11)
    h1, w1 = h0 * 2 * 14 // 8, w0 * 2 * 14 // 8
    x = rng.standard_normal((2, h0, w0, c)).astype(np.float32)
    k_oc = (rng.standard_normal((1, 1, c, c)) * 0.1).astype(np.float32)
    b_oc = (rng.standard_normal(c) * 0.1).astype(np.float32)
    k1 = (rng.standard_normal((3, 3, c, c2)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(c2) * 0.1).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, c2, c3)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(c3) * 0.1).astype(np.float32)
    k3 = (rng.standard_normal((1, 1, c3, 1)) * 0.1).astype(np.float32)
    b3 = (rng.standard_normal(1) * 0.1).astype(np.float32)
    ref = np.asarray(head_tail_ext_pallas(
        *(jnp.asarray(a) for a in (x, k_oc, b_oc, k1, b1, k2, b2, k3, b3)),
        (h1, w1), interpret=True))
    hwio = lambda k: _t(k.transpose(3, 2, 0, 1))  # HWIO -> (O, I, kh, kw)
    ours = head_tail_ext(_t(x), hwio(k_oc), _t(b_oc), hwio(k1), _t(b1),
                         hwio(k2), _t(b2), hwio(k3), _t(b3), (h1, w1)).numpy()
    assert ours.shape == ref.shape == (2, h1, w1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-4)


# --- the fused Block, model and pipeline against the JAX package ---------

def _block_params(sd, i=0):
    """The JAX Block subtree of block i of a converted state_dict."""
    return convert_state_dict(sd, TINY)["pretrained"][f"block{i}"]


def test_fused_block_matches_jax_fused_block():
    """Port Block (both halves fused: plain versions on the CPU) against JAX
    Block(mlp_fused='fused') (Pallas in interpret mode), D=128, 2 heads,
    N = 41 tokens, f32 within 3e-5 (the JAX package's fused-vs-unfused
    bound, tests/test_mlp_pallas.py)."""
    sd = _weights()
    model = build_model(TINY, sd, torch.float32, "cpu")
    x = np.random.default_rng(5).standard_normal((2, 41, 128)).astype(np.float32)
    jblk = JaxBlock(dim=128, num_heads=2, mlp_ratio=4.0, mlp_fused="fused")
    ref = np.asarray(jblk.apply({"params": _block_params(sd)}, jnp.asarray(x)))
    blk = model.pretrained.blocks[0]
    assert blk.mlp_fused == "fused"
    assert resolve_block_fusion("fused", 128, 2, 41, "cpu",
                                torch.float32) == (True, True)
    ours = blk(_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=3e-5)


def _bf16_model(sd, **kw):
    cfg = dataclasses.replace(TINY, **kw)
    return cfg, build_model(cfg, sd, torch.bfloat16, "cpu", tail="xla")


def test_unfused_block_bf16_matches_jax():
    """bf16 with the dense layers rounding as flax's: the unfused Block
    against JAX Block(mlp_fused='xla'). The f32 sums (LN, the GEMMs, the
    softmax) and the erf's exp run in another order, which moves single
    bf16 ulps; through a residual block of O(1) activations the bound is
    6e-2, the JAX package's bf16 half-block bound."""
    sd = _weights(3)
    _, model = _bf16_model(sd, mlp_fused="xla")
    x = np.random.default_rng(6).standard_normal((2, 41, 128)).astype(np.float32)
    jblk = JaxBlock(dim=128, num_heads=2, mlp_ratio=4.0, mlp_fused="xla",
                    dtype=jnp.bfloat16)
    ref = jblk.apply({"params": _block_params(sd)},
                     jnp.asarray(x, jnp.bfloat16))
    ours = model.pretrained.blocks[0](_t(x, torch.bfloat16))
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=6e-2)


def test_dpt_head_bf16_matches_jax():
    """bf16 DPTHead(tail='xla') against the JAX head on the same taps. Each
    conv and resize rounds to bf16 at the same points; the f32 sums differ
    in order, so outputs sit within a few bf16 ulps of the output range:
    max error <= 2% of the range, mean <= 0.2%."""
    sd = _weights(4)
    cfg, model = _bf16_model(sd, mlp_fused="xla")
    ph, pw = 4, 6
    rng = np.random.default_rng(8)
    taps = [(rng.standard_normal((2, ph * pw, 128)).astype(np.float32),
             rng.standard_normal((2, 128)).astype(np.float32)) for _ in range(4)]
    jhead = JaxDPTHead(JTINY, dtype=jnp.bfloat16, tail="xla")
    jparams = convert_state_dict(sd, TINY)["depth_head"]
    ref = np.asarray(jhead.apply(
        {"params": jparams},
        [tuple(jnp.asarray(a, jnp.bfloat16) for a in t) for t in taps],
        ph, pw).astype(jnp.float32))
    ours = model.depth_head([tuple(_t(a, torch.bfloat16) for a in t)
                             for t in taps], ph, pw).float().numpy()
    span = ref.max() - ref.min()
    err = np.abs(ours - ref)
    assert ours.shape == ref.shape == (2, ph * 14, pw * 14)
    assert err.max() <= 0.02 * span and err.mean() <= 0.002 * span


def test_dense_and_conv_round_as_flax():
    """One bf16 Dense and one bf16 3x3 Conv with bias, bit-exact against
    flax: the product cast to bf16, then the bf16 bias add. The parent's
    nn.Linear / nn.Conv2d (bias added in f32 before one rounding) differ in
    ~29% of these outputs. At K=384 the f32 sums' order can still flip a
    rounding boundary: at most 1e-4 of outputs."""
    rng = np.random.default_rng(0)
    bf = torch.bfloat16
    for m, k, n, limit in ((128, 128, 384, 0.0), (256, 384, 1152, 1e-4)):
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        ref = np.asarray(fnn.Dense(n, dtype=jnp.bfloat16).apply(
            {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
            jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        lin = Linear(k, n)
        lin.weight.data, lin.bias.data = _t(w.T, bf), _t(b, bf)
        ours = lin(_t(x, bf)).float().numpy()
        assert np.mean(ours != ref) <= limit, (m, k, n)
    xc = rng.standard_normal((2, 24, 32, 16)).astype(np.float32)
    kc = (rng.standard_normal((3, 3, 16, 32)) / 10).astype(np.float32)
    bc = rng.standard_normal(32).astype(np.float32)
    ref = np.asarray(fnn.Conv(32, (3, 3), padding=1, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(kc), "bias": jnp.asarray(bc)}},
        jnp.asarray(xc, jnp.bfloat16)).astype(jnp.float32))
    conv = Conv2d(16, 32, 3, padding=1)
    conv.weight.data, conv.bias.data = _t(kc.transpose(3, 2, 0, 1), bf), _t(bc, bf)
    ours = conv(_t(xc, bf).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(ours.float().numpy(), ref)


def _jax_model(sd, tail):
    jmodel = JaxDepthAnythingV2(JTINY, dtype=jnp.float32, tail=tail)
    return jmodel, jax.tree.map(jnp.asarray, convert_state_dict(sd, TINY))


# The JAX package's fused tail has no CPU path (head_tail_ext_pallas runs
# compiled on the TPU, or with interpret=True, which its DPTHead does not
# pass), so on the CPU the JAX side runs mlp_fused='fused' (its Pallas
# half-block kernels in interpret mode) with its XLA tail. The port's fused
# tail is held against head_tail_ext_pallas(interpret=True) above.
JAX_TAIL = "xla"


def test_tiny_model_fused_matches_jax():
    """The whole tiny model with mlp_fused='fused' and tail='fused' (plain
    versions on the CPU) against the JAX model with mlp_fused='fused': f32
    depth within 1e-4 of its max; and the same weights through the port's
    unfused paths agree too."""
    sd = _weights(5)
    frames = np.random.default_rng(7).integers(0, 256, (2, 48, 80, 3),
                                               dtype=np.uint8)
    jmodel, jparams = _jax_model(sd, JAX_TAIL)
    ref = np.asarray(jax_infer_depth(jmodel, jparams, jnp.asarray(frames),
                                     input_size=56))
    model = build_model(TINY, sd, torch.float32, "cpu", tail="fused")
    ours = infer_depth(model, torch.from_numpy(frames), input_size=56).numpy()
    assert ours.shape == ref.shape == (2, 48, 80)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
    unfused = build_model(dataclasses.replace(TINY, mlp_fused="xla"), sd,
                          torch.float32, "cpu", tail="xla")
    plain = infer_depth(unfused, torch.from_numpy(frames), input_size=56).numpy()
    assert np.abs(plain - ours).max() <= 1e-4 * np.abs(ref).max()


def test_pipeline_fused_matches_jax():
    """SbsPipeline with mlp_fused='fused', tail='fused' against the JAX
    SbsPipeline with mlp_fused='fused', two batches with carried state: depth
    within 1e-4 of its max, the right half equal to the input, the left
    half equal on >= 99.9% of pixels."""
    sd = _weights(6)
    h, w, bsz = 150, 96, 4
    run = config.RunConfig(batch_size=bsz, input_size=56,
                           compute_dtype="float32", mlp_fused="fused",
                           tail="fused")
    jrun = jconfig.RunConfig(**dict(dataclasses.asdict(run), tail=JAX_TAIL))
    jmodel, jparams = _jax_model(sd, JAX_TAIL)
    jpipe = JaxSbsPipeline(jmodel, jparams, h, w, run_cfg=jrun)
    pipe = SbsPipeline(build_model(TINY, sd, torch.float32, "cpu",
                                   tail="fused"), h, w, run_cfg=run)
    frames = np.random.default_rng(12).integers(0, 256, (2 * bsz, h, w, 3),
                                                dtype=np.uint8)
    jstate, state = jpipe.initial_state(), pipe.initial_state()
    for i in range(2):
        batch = frames[i * bsz:(i + 1) * bsz]
        jdepth = np.asarray(jpipe.depth_only(batch))
        depth = pipe.depth_only(batch).numpy()
        assert np.abs(depth - jdepth).max() <= 1e-4 * np.abs(jdepth).max()
        jsbs, jstate = jpipe.step(batch, jstate)
        sbs, state = pipe.step(batch, state)
        jsbs, sbs = np.asarray(jsbs), sbs.numpy()
        np.testing.assert_array_equal(sbs[:, :, w:], batch)
        same = np.all(sbs[:, :, :w] == jsbs[:, :, :w], axis=-1).mean()
        assert same >= 0.999, f"batch {i}: {same:.5f} of left pixels equal"


def test_converted_weights_load_into_both_paths():
    """One state_dict converted from the JAX package's parameters loads
    strictly into the port with mlp_fused 'xla' and 'fused' (the fused
    branches read the unfused modules' parameters), and both give the same
    depth."""
    from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax

    # a JAX parameter tree (the JAX package's layout), carried to the port
    jparams = convert_state_dict(_weights(7), TINY)
    sd = state_dict_from_jax(jparams, TINY)
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (1, 42, 56, 3), dtype=np.uint8))
    depths = []
    for fused, tail in (("xla", "xla"), ("fused", "fused")):
        cfg = dataclasses.replace(TINY, mlp_fused=fused)
        model = build_model(cfg, sd, torch.float32, "cpu", tail=tail)
        assert set(model.state_dict()) == set(sd)
        depths.append(infer_depth(model, frames, input_size=56).numpy())
    np.testing.assert_allclose(depths[1], depths[0], rtol=0,
                               atol=1e-4 * np.abs(depths[0]).max())


# --- auto resolution -------------------------------------------------------

@pytest.mark.parametrize("encoder,device,want", [
    ("vits", "cpu", (False, False, None)),
    ("vitb", "cpu", (False, False, None)),
    ("vitl", "cpu", (False, False, None)),
    ("vits", "cuda", (True, False, "ext")),  # the MLP half fuses at D >= 512
    ("vitb", "cuda", (True, True, "ext")),
    ("vitl", "cuda", (True, True, "big")),   # rows 9, 11, 12
    ("vitg", "cpu", (False, False, None)),
    ("vitg", "cuda", (False, True, "big")),  # rows 1, 2 unfused; 10, 11, 12
])
def test_auto_resolution(encoder, device, want):
    """auto resolves as the JAX package's auto on its accelerator, with CUDA
    in the TPU's place, and to the unfused paths off the card, at 1080p with
    --input_size 518 (N = 2443 tokens, refinenet1 at 148 x 264), bf16; no
    GPU is needed to check it."""
    cfg = config.ModelConfig.for_encoder(encoder)
    pre, out_hw = (8, 148, 264, cfg.features), (518, 924)
    attn, mlp = resolve_block_fusion("auto", cfg.embed_dim, cfg.num_heads,
                                     2443, device, torch.bfloat16,
                                     cfg.ffn_layer)
    tail = resolve_tail("auto", pre, torch.bfloat16, out_hw, device)
    assert (attn, mlp, tail) == want
    assert resolve_block_fusion("xla", cfg.embed_dim, cfg.num_heads, 2443,
                                device, torch.bfloat16,
                                cfg.ffn_layer) == (False, False)
    assert resolve_tail("xla", pre, torch.bfloat16, out_hw, device) is None


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.bfloat16, "folded"),   # the JAX package's TPU bf16 rule
    ("cuda", torch.float32, "exact"),
    ("cpu", torch.bfloat16, "exact"),
    ("cpu", torch.float32, "exact"),
])
def test_preprocess_auto_resolution(device, dtype, want):
    """--preprocess auto resolves as the JAX package's `_resolve_preprocess`
    on its accelerator, with CUDA in the TPU's place (folded for a bf16
    model), exact elsewhere; explicit choices pass through. No GPU is
    needed to check it."""
    from vr_video_generator_tpu_torch.pipeline import resolve_preprocess

    assert resolve_preprocess("auto", device, dtype) == want
    for explicit in ("exact", "folded"):
        assert resolve_preprocess(explicit, device, dtype) == explicit


# --- the port's own copies of the configuration and the CLI parser -------

@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl", "vitg"])
def test_config_copy_matches_jax(encoder):
    asdict = dataclasses.asdict
    assert asdict(config.ModelConfig.for_encoder(encoder)) == \
        asdict(jconfig.ModelConfig.for_encoder(encoder))
    assert asdict(config.RunConfig(encoder=encoder)) == \
        asdict(jconfig.RunConfig(encoder=encoder))
    assert asdict(config.RunConfig(encoder=encoder).model()) == \
        asdict(jconfig.RunConfig(encoder=encoder).model())
    assert asdict(config.StereoConfig()) == asdict(jconfig.StereoConfig())
    assert config.DEPTH_SCALERS == jconfig.DEPTH_SCALERS


@pytest.mark.parametrize("argv", [
    # the verify recipe
    ["--VideoDir", "in.mp4", "--OutputDir", "out.mkv", "--DebugDir", "D/",
     "--SubClipDir", "S/", "--Max_Frame_Count", "6", "--batch_size", "4",
     "--input_size", "56", "--compute_dtype", "float32",
     "--allow_random_weights"],
    # unknown flags are discarded
    ["--encoder", "vitb", "--no_such_flag", "3", "--tail", "fused",
     "--mlp_fused", "xla", "--mesh", "2x1"],
    # same-sign offsets: the reference's sign fixup
    ["--offset_fg", "0.03", "--offset_bg", "0.02"],
    ["--offset_fg", "-0.03", "--offset_bg", "-0.02"],
])
def test_parse_run_config_matches_jax(argv):
    ours, _ = cli.parse_run_config(argv)
    ref, _ = jcli.parse_run_config(argv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.stereo()) == dataclasses.asdict(ref.stereo())


def test_swapped_offset_signs_raise_the_same_error():
    argv = ["--offset_fg", "-0.03", "--offset_bg", "0.02"]
    ours, _ = cli.parse_run_config(argv)
    ref, _ = jcli.parse_run_config(argv)
    with pytest.raises(ValueError) as e_ours:
        ours.stereo()
    with pytest.raises(ValueError) as e_ref:
        ref.stereo()
    assert str(e_ours.value) == str(e_ref.value)
