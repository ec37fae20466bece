"""PyTorch port, rows 7 and 15 at f32 at C = 32 (a 32-feature head) on the
CPU. The f32 chains (csrc/head_tail_big.cu vrvg_head_tail_ext_f32,
vrvg_head_tail_f32) take C = 32 by zero padding: conv1's 16 output channels
and conv2's 16 input channels run as 32 (ops/head_tail.pad_to to
chain_widths), since the 3xTF32 conv reads its input in 32-channel slices.

Held here:
(a) the plain f32 versions of rows 7 and 15 at C = 32 against the JAX
    package's ``head_tail_ext_pallas`` / ``head_tail_pallas`` at f32 in
    interpret mode, within 64 f32 ulps of the depth's largest value (the
    bound the C = 64 and 128 chains are held to, tests/
    test_torch_base_tail_3xtf32.py);
(b) ``check_f32_plan`` passes a 32-feature head at every input size of
    tests/test_torch_f32_routing.py's SIZES, every mlp_fused and tail;
(c) the padding's arithmetic on tests/test_torch_gemm_3xtf32.py's model of
    the core (a fresh truncating tensor-core sum of each stage, the stages
    added in f32 in the kernel's order): conv2's sums over the padded
    32-channel slice equal, bit for bit, the sums over a 16-channel slice
    (two k-steps a stage) of the unpadded conv; conv1's padded columns are
    exactly zero after BiasStore, its first 16 those of the unpadded conv;
(d) the planes the wrappers keep at C = 32: the padded k columns of
    conv2's split zeros, the others the unpadded split's, b1 padded with
    zeros;
(e) each whole chain with its convs (and row 7's mix) on the model against
    the Pallas kernel in interpret mode and within chip_smoke.py's tail
    bounds of the plain version, its TF32 depth refused.
Needs g++ (C++20).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import (TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL, f32_rel_check,
                        tf32_round)
from tests.test_torch_base_tail_3xtf32 import (base_case, depth_epilogue,
                                               lib)  # noqa: F401
from tests.test_torch_conv_3xtf32 import unfold_rows
from tests.test_torch_conv_3xtf32_rcu_ext import (bias_epilogue,
                                                  model_conv_sums, seeded)
from tests.test_torch_f32_routing import SIZES
from tests.test_torch_gemm_3xtf32 import core_sums
from vr_video_generator_tpu.ops.head_tail_pallas import (head_tail_ext_pallas,
                                                         head_tail_pallas)
from vr_video_generator_tpu_torch import RunConfig
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.preprocess import network_input_size
from vr_video_generator_tpu_torch.pipeline import check_f32_plan

torch.set_num_threads(2)
torch.set_grad_enabled(False)

C, C2 = 32, 16
MIX_SUM_K = 16  # K a fresh tensor-core sum of row 7's mix (gemm<Store, 16>)


def ext_case(h0: int, w0: int, seed: int):
    """x (2, H0, W0, 32) and row 7's weights at C = 32 at chip_smoke.py's
    tail scales (f32_tail_weights), PyTorch layout."""
    rng = np.random.default_rng(seed)
    return (seeded(rng, (2, h0, w0, C)),
            seeded(rng, (C, C, 1, 1), C ** -0.5), seeded(rng, (C,), 0.1),
            *base_case(C, 4, 4, seed)[1:])


def jax_args(wts):
    """The weights as the JAX tails take them: convs HWIO."""
    return [jnp.asarray((w.permute(2, 3, 1, 0) if w.ndim == 4 else w)
                        .numpy()) for w in wts]


def ulp64(ref):
    return 64 * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 23)


# --- (a) the plain versions against the Pallas kernels ---------------------

@pytest.mark.parametrize("h0,w0", [(12, 22), (12, 16)])
def test_ext_tail_c32_plain_matches_pallas(h0, w0):
    """(a) Row 7 at f32 at C = 32: head_tail_ext_plain (the wrapper on CPU
    tensors) against head_tail_ext_pallas at f32 in interpret mode within
    64 f32 ulps of the depth's largest value."""
    x, *wts = ext_case(h0, w0, seed=h0 * w0)
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    ref = np.asarray(head_tail_ext_pallas(jnp.asarray(x.numpy()),
                                          *jax_args(wts), out_hw,
                                          interpret=True))
    ours = ht.head_tail_ext(x, *wts, out_hw)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    assert (ref > 0).mean() > 0.2
    assert np.abs(ours.numpy().astype(np.float64) - ref).max() <= ulp64(ref)


@pytest.mark.parametrize("h2,w2", [(24, 40), (28, 36)])
def test_base_tail_c32_plain_matches_pallas(h2, w2):
    """(a) Row 15 at f32 at C = 32: head_tail_plain against head_tail_pallas
    at f32 in interpret mode within 64 f32 ulps of the depth's largest
    value."""
    wts = base_case(C, h2, w2, seed=h2 + w2)
    out_hw = (h2 * 14 // 8, w2 * 14 // 8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_pallas(jnp.asarray(wts[0].numpy()),
                                          *jax_args(wts[1:]), out_hw,
                                          interpret=True))
    ours = ht.head_tail(*wts, out_hw)
    assert ours.shape == ref.shape and (ref > 0).mean() > 0.2
    assert np.abs(ours.numpy().astype(np.float64) - ref).max() <= ulp64(ref)


# --- (b) the plan check ---------------------------------------------------

@pytest.mark.parametrize("encoder", ["vits", "vitb", "vitl", "vitg"])
def test_check_f32_plan_passes_a_32_feature_head(encoder, monkeypatch):
    """(b) A custom head of 32 features at f32 on the card: check_f32_plan
    passes every input size of SIZES at 1080p, every mlp_fused and tail;
    where a tail is fused the JAX planners pick the ext one (row 7), which
    now has its f32 kernel at C = 32."""
    model = RunConfig.model
    monkeypatch.setattr(RunConfig, "model", lambda self: dataclasses.replace(
        model(self), features=C))
    for size in SIZES:
        for mlp_fused in ("auto", "fused", "xla"):
            for tail in ("auto", "fused", "xla"):
                cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                                mlp_fused=mlp_fused, tail=tail,
                                input_size=size)
                assert cfg.model().features == C
                check_f32_plan(cfg, 1080, 1920)
        hn, wn = network_input_size(1080, 1920, target=size, multiple_of=14)
        pre = (8, 4 * hn // 14, 4 * wn // 14, C)
        assert ht.plan_tail(pre, torch.float32, (hn, wn)) == "ext"


# --- (c) the padding on the model of the core -----------------------------

def model_conv16_sums(x, k):
    """The core's sums of the 3x3 conv of x (B, H, W, 16) by k (N, 16, 3, 3)
    as a conv reading 16-channel slices would sum them: per tap one stage of
    two k-steps (a fresh truncating sum), the stages added in f32 in tap
    order."""
    b, h, w, c = x.shape
    planes = ht._conv_split(k)
    sums = core_sums(unfold_rows(x), planes, span=c)
    return sums[:, :k.shape[0]].reshape(b, h, w, k.shape[0])


def pad_channels(x):
    return torch.nn.functional.pad(x, (0, C - x.shape[-1]))


@pytest.mark.parametrize("grid", [(5, 7), (9, 17), (24, 40)],
                         ids=["5x7", "9x17", "24x40"])
def test_padded_conv2_sums_equal_16_channel_sums(grid):
    """(c) conv2 as the chains run it at C = 32 (R with 16 zero channels, k2
    with zero weights for them, one 32-channel slice a tap) sums, bit for
    bit, what a 16-channel slice a tap would: the padded k-steps' products
    are exact zeros, which leave each stage's truncating sum as it is. Also
    on the model's TF32 products (one a k-step)."""
    rng = np.random.default_rng(sum(grid))
    r = seeded(rng, (2, *grid, C2))
    k2 = seeded(rng, (32, C2, 3, 3), (9 * C2) ** -0.5)
    k2p = ht.pad_to(k2, 32, C)
    assert k2p.shape == (32, C, 3, 3) and not k2p[:, C2:].any()
    got = model_conv_sums(pad_channels(r), k2p)
    want = model_conv16_sums(r, k2)
    assert torch.equal(got, want)
    tf = model_conv_sums(pad_channels(r), k2p, "tf32")
    planes = ht._conv_split(k2)
    want_tf = core_sums(unfold_rows(r), planes, "tf32", span=C2)[:, :32]
    assert torch.equal(tf, want_tf.reshape(tf.shape))


@pytest.mark.parametrize("grid", [(5, 7), (24, 40)], ids=["5x7", "24x40"])
def test_padded_conv1_columns(lib, grid):
    """(c) conv1 + b1 as the chains run it at C = 32 (32 output columns, the
    split's rows past 16 and b1's padding zeros): BiasStore writes exact
    zeros in columns 16-31, and columns 0-15 are the unpadded conv's, bit
    for bit."""
    x, k1, b1 = base_case(C, *grid, seed=grid[1])[:3]
    b1p = ht.pad_to(b1, C)
    k1p = torch.nn.functional.pad(k1, (0, 0, 0, 0, 0, 0, 0, C - C2))
    got = bias_epilogue(lib, model_conv_sums(x, k1p), b1p)
    assert got.shape[-1] == C and not got[..., C2:].any()
    assert torch.equal(got[..., :C2],
                       bias_epilogue(lib, model_conv_sums(x, k1), b1))


# --- (d) the kept planes ---------------------------------------------------

def test_c32_f32_weights_are_zero_padded():
    """(d) _ext_f32_weights and _base_f32_weights at C = 32: conv1's split
    as at any width ((2, 128, 9 C), zeros past its 16 rows); conv2's split
    over 9 x 32 k columns, (3 dh + dw) 32 + c, zeros at c >= 16 and the
    unpadded split's words elsewhere; b1 a (32,) vector, zeros past 16; b2,
    the 1x1 and b3 as they are. Both wrappers' planes are the same."""
    x, k_oc, b_oc, k1, b1, k2, b2, k3, b3 = ext_case(4, 4, seed=5)
    ext = ht._ext_f32_weights(k_oc, b_oc, k1, b1, k2, b2, k3, b3)
    base = ht._base_f32_weights(k1, b1, k2, b2, k3, b3)
    for w1s, w2s, b1f, rest in ((ext[1], ext[2], ext[4], ext[5:]),
                                (base[0], base[1], base[2], base[3:])):
        assert torch.equal(w1s, ht._conv_split(k1))
        assert w2s.shape == (2, 128, 9 * C)
        real = torch.tensor([t * C + c for t in range(9) for c in range(C2)])
        pad = torch.tensor([t * C + c for t in range(9)
                            for c in range(C2, C)])
        assert torch.equal(w2s[:, :, real], ht._conv_split(k2))
        assert not w2s[:, :, pad].any()
        assert b1f.shape == (C,) and torch.equal(b1f[:C2], b1)
        assert not b1f[C2:].any()
        assert all(torch.equal(v, w.reshape(-1))
                   for v, w in zip(rest, (b2, k3, b3)))
    assert ext[0].shape == (2, 128, C)


# --- (e) the chains on the model -------------------------------------------

def model_base_chain(lib, x, k1, b1, k2, b2, k3, b3, out_hw,
                     products="3xtf32"):
    """vrvg_head_tail_f32 at C = 32 with its convs modelled on the padded
    weights: (c1, R) at 32 channels, and the depth."""
    b1p, k2p = ht.pad_to(b1, C), ht.pad_to(k2, 32, C)
    k1p = torch.nn.functional.pad(k1, (0, 0, 0, 0, 0, 0, 0, C - C2))
    c1 = bias_epilogue(lib, model_conv_sums(x, k1p, products), b1p)
    r = ht.ext_resize_plain(c1, out_hw).contiguous()
    return c1, r, depth_epilogue(lib, model_conv_sums(r, k2p, products), b2,
                                 k3, b3)


def test_base_tail_c32_model_chain(lib):
    """(e) Row 15 at f32 at C = 32 as vrvg_head_tail_f32 runs it, its convs
    on the model over the padded channels: c1's and R's padded channels
    zero; the depth against head_tail_pallas at f32 in interpret mode
    within 64 f32 ulps of its largest value, and against head_tail_plain
    within chip_smoke.py's tail bounds relative to the depth's range, which
    refuse the plain tail on TF32-rounded operands."""
    h2, w2 = 24, 40
    h1, w1 = h2 * 14 // 8, w2 * 14 // 8
    wts = base_case(C, h2, w2, seed=h2 * w2)
    c1, r, depth = model_base_chain(lib, *wts, (h1, w1))
    assert c1.shape == (2, h2, w2, C) and r.shape == (2, h1, w1, C)
    assert not c1[..., C2:].any() and not r[..., C2:].any()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_pallas(jnp.asarray(wts[0].numpy()),
                                          *jax_args(wts[1:]), (h1, w1),
                                          interpret=True))
    assert (ref > 0).mean() > 0.2 and depth.shape == ref.shape
    assert np.abs(depth.numpy().astype(np.float64) - ref).max() <= ulp64(ref)
    want = ht.head_tail_plain(*wts, (h1, w1))
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts[1:]]
    tfw = ht.head_tail_plain(tf32_round(wts[0]), *rounded, (h1, w1))
    span = (want.max() - want.min()).item()
    print(f32_rel_check("row 15 C=32", depth, want, tfw, TAIL_F32_MAX_REL,
                        TAIL_F32_MEAN_REL, span))


def test_ext_tail_c32_model_chain(lib):
    """(e) Row 7 at f32 at C = 32 as vrvg_head_tail_ext_f32 runs it: the mix
    on the dense model (a fresh sum every 16 of K), the upsample pass's
    plain version with out_conv's bias, then row 15's chain on Z; the depth
    against head_tail_ext_pallas at f32 in interpret mode within 64 f32
    ulps of its largest value, and against head_tail_ext_plain within the
    tail bounds, its TF32 depth refused."""
    h0, w0 = 12, 22
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    x, k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts = ext_case(h0, w0, seed=29)
    planes = mlp.tf32x3_weight_plain(k_oc[:, :, 0, 0].contiguous())
    xoc = core_sums(x.reshape(-1, C), planes,
                    span=MIX_SUM_K)[:, :C].reshape(x.shape)
    z = ht.big_upsample_plain(xoc, b_oc)
    _, _, depth = model_base_chain(lib, z, k1, b1, k2, b2, k3, b3, out_hw)
    ref = np.asarray(head_tail_ext_pallas(jnp.asarray(x.numpy()),
                                          *jax_args(wts[1:]), out_hw,
                                          interpret=True))
    assert (ref > 0).mean() > 0.2 and depth.shape == ref.shape
    assert np.abs(depth.numpy().astype(np.float64) - ref).max() <= ulp64(ref)
    want = ht.head_tail_ext_plain(*wts, out_hw)
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts[1:]]
    tfw = ht.head_tail_ext_plain(tf32_round(x), *rounded, out_hw)
    span = (want.max() - want.min()).item()
    print(f32_rel_check("row 7 C=32", depth, want, tfw, TAIL_F32_MAX_REL,
                        TAIL_F32_MEAN_REL, span))
