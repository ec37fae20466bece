"""PyTorch port on the GPU: each hand-written kernel against its plain
version on the card. CUDA kernels have no CPU mode, so these tests skip
without a GPU. On a GPU machine (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.warp_tables import (above_all, all_invalid, descending,
                               last_rank_dual, overlapping, random_bands,
                               shifts_126, skip_one, unbounded)
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.ops.attention import (flash_attention,
                                                        flash_attention_plain)
from vr_video_generator_tpu_torch.ops.head_tail import (
    head_tail_big_back, head_tail_big_back_plain, head_tail_big_front,
    head_tail_ext, head_tail_ext_plain)
from vr_video_generator_tpu_torch.ops.mlp import (
    fc1_gelu_plain, fc2_residual_plain, mlp_residual, mlp_residual_hblocked,
    mlp_residual_hblocked_stages, mlp_residual_plain, swiglu_gate_plain,
    swiglu_residual, swiglu_residual_plain, swiglu_residual_stages)
from vr_video_generator_tpu_torch.ops.qkv import (ln_qkv, ln_qkv_plain,
                                                  proj_ls_residual,
                                                  proj_ls_residual_plain,
                                                  qkv_plain)
from vr_video_generator_tpu_torch.utils.config import StereoConfig
from vr_video_generator_tpu_torch.ops.attention import attention, attention_plain
from vr_video_generator_tpu_torch.ops.layernorm import layernorm, layernorm_plain
from vr_video_generator_tpu_torch.ops.warp import (
    WarpSpec, blur_select_sbs, blur_select_sbs_packed_plain,
    blur_select_sbs_plain, pack_rgb, resolve_banded, warp_composite,
    warp_composite_banded_plain, warp_composite_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _assert_rounding_boundaries_only(name, got, want, args):
    """bf16 outputs of a kernel and its plain version (the same rounding
    points, f32 sums in another order) differ only at rounding boundaries:
    a small share of outputs, each by a few ulps of the largest operand
    (chip_smoke.py's check and bounds)."""
    from chip_smoke import gemm_check

    gemm_check(name, got, want, args)


def _randn(gen, shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
    return (torch.randn(shape, generator=gen, device=gen.device) * scale
            + shift).to(dtype)


# N not a multiple of the 64-row tile; D at each width the kernel is built
# for (3D ragged against the GEMM core's 256-column tile at 128 and 384);
# at vits' and vitl's D also one row, ragged 128-row tiles and 1080p's rows
# at batch 8, and at vitb's D 1080p's rows at batch 8. Row 5's GEMM stage
# is held alone too, on the kernel's own LN.
@pytest.mark.parametrize("b,n,d", [(2, 70, 128), (1, 321, 384),
                                   (2, 2443, 384), (1, 67, 768),
                                   (1, 33, 1024), (1, 1, 384), (1, 127, 384),
                                   (1, 129, 384), (8, 2443, 384),
                                   (1, 1, 1024), (1, 127, 1024),
                                   (1, 129, 1024), (8, 2443, 1024),
                                   (8, 2443, 768)])
def test_ln_qkv_and_proj_kernels_match_plain(cuda, b, n, d):
    gen = torch.Generator(device=cuda).manual_seed(n + d)
    heads = d // 64
    x = _randn(gen, (b, n, d))
    args = (x, _randn(gen, (d,), 0.1, 1.0, torch.float32),
            _randn(gen, (d,), 0.1, 0.0, torch.float32),
            _randn(gen, (3 * d, d), d ** -0.5), _randn(gen, (3 * d,), 0.5),
            heads, 64 ** -0.5)
    before = launch_counts().get("ln_qkv", 0)
    qkv = ln_qkv(*args)
    assert launch_counts()["ln_qkv"] == before + 1
    assert qkv.shape == (b, n, 3, heads, 64)
    _assert_rounding_boundaries_only("ln_qkv", qkv, ln_qkv_plain(*args), args)
    _assert_rounding_boundaries_only(
        "ln_qkv", qkv, qkv_plain(layernorm(*args[:3]), *args[3:]), args)
    pargs = (_randn(gen, (b, n, heads, 64)), x, _randn(gen, (d, d), d ** -0.5),
             _randn(gen, (d,), 0.5), _randn(gen, (d,), 0.1, 1.0))
    _assert_rounding_boundaries_only("proj_ls_residual",
                                     proj_ls_residual(*pargs),
                                     proj_ls_residual_plain(*pargs), pargs)


# Row 8 whole and stage by stage (row 9's chain at D = 128, 384 and 768):
# the LN stage is row 1's kernel (bit-exact); each GEMM stage against its
# plain version on the chain's own input; one launch count a call, and the
# same output as the call without the stages. m = 1, 127, 129: a lone row
# and ragged 128-row tiles; 19544: 1080p's rows at batch 8. Every case is
# held to row 8's whole-output bounds.
@pytest.mark.parametrize("m,d", [(140, 128), (321, 384), (19544, 384),
                                 (100, 768), (1, 384), (127, 384), (129, 384),
                                 (1, 768), (127, 768), (129, 768),
                                 (19544, 768)])
def test_mlp_kernel_matches_plain(cuda, m, d):
    from vr_video_generator_tpu_torch.ops.mlp import mlp_residual_stages

    gen = torch.Generator(device=cuda).manual_seed(m + d)
    f32 = torch.float32
    args = (_randn(gen, (m, d)), _randn(gen, (d,), 0.1, 1.0, f32),
            _randn(gen, (d,), 0.1, 0.0, f32),
            _randn(gen, (4 * d, d), d ** -0.5), _randn(gen, (4 * d,), 0.5),
            _randn(gen, (d, 4 * d), (4 * d) ** -0.5), _randn(gen, (d,), 0.5),
            _randn(gen, (d,), 0.1, 1.0))
    x, lnw, lnb, w1, b1, w2, b2, gamma = args
    before = launch_counts().get("mlp_residual", 0)
    got = mlp_residual(*args)
    assert launch_counts()["mlp_residual"] == before + 1
    _assert_rounding_boundaries_only("mlp_residual", got,
                                     mlp_residual_plain(*args), args)
    a, h, out = mlp_residual_stages(*args)
    assert launch_counts()["mlp_residual"] == before + 2
    assert a.shape == (m, d) and h.shape == (m, 4 * d)
    assert torch.equal(a, layernorm(x, lnw, lnb))
    _assert_rounding_boundaries_only("mlp_fc1_gelu", h,
                                     fc1_gelu_plain(a, w1, b1), (b1,))
    _assert_rounding_boundaries_only(
        "mlp_fc2_residual", out, fc2_residual_plain(h, w2, b2, gamma, x),
        (x, gamma, b2))
    assert torch.equal(out, got)


def _hblocked_args(gen, m, d=1024):
    """Seeded operands of the GELU MLP half at width d (hidden 4D)."""
    f32 = torch.float32
    return (_randn(gen, (m, d)), _randn(gen, (d,), 0.1, 1.0, f32),
            _randn(gen, (d,), 0.1, 0.0, f32),
            _randn(gen, (4 * d, d), d ** -0.5), _randn(gen, (4 * d,), 0.5),
            _randn(gen, (d, 4 * d), (4 * d) ** -0.5), _randn(gen, (d,), 0.5),
            _randn(gen, (d,), 0.1, 1.0))


# m = 100 and 130: one ragged 128-row tile and a ragged second one; 19544:
# vitl-518's rows at batch 8.
@pytest.mark.parametrize("m", [100, 19544, 130])
def test_mlp_hblocked_kernel_matches_plain(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(m)
    args = _hblocked_args(gen, m)
    before = launch_counts().get("mlp_residual_hblocked", 0)
    got = mlp_residual_hblocked(*args)
    assert launch_counts()["mlp_residual_hblocked"] == before + 1
    _assert_rounding_boundaries_only("mlp_residual_hblocked", got,
                                     mlp_residual_plain(*args), args)


# Row 9's chain stage by stage, on its own scratch: the LN stage is row 1's
# kernel (bit-exact) within the LN bound of the plain LayerNorm; each GEMM
# stage against its plain version on the chain's own input; one launch count
# a call, and the same output as the call without the stages.
@pytest.mark.parametrize("m", [130, 19544])
def test_mlp_hblocked_stages_match_plain(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(m + 9)
    args = _hblocked_args(gen, m)
    x, lnw, lnb, w1, b1, w2, b2, gamma = args
    before = launch_counts().get("mlp_residual_hblocked", 0)
    a, h, out = mlp_residual_hblocked_stages(*args)
    assert launch_counts()["mlp_residual_hblocked"] == before + 1
    assert a.shape == (m, 1024) and h.shape == (m, 4096) and out.shape == x.shape
    assert torch.equal(a, layernorm(x, lnw, lnb))
    a_p = layernorm_plain(x, lnw, lnb).float()
    assert bool(((a.float() - a_p).abs() <= 2e-2 + 1e-2 * a_p.abs()).all())
    _assert_rounding_boundaries_only("mlp_fc1_gelu", h,
                                     fc1_gelu_plain(a, w1, b1), (b1,))
    _assert_rounding_boundaries_only(
        "mlp_fc2_residual", out, fc2_residual_plain(h, w2, b2, gamma, x),
        (x, gamma, b2))
    assert torch.equal(out, mlp_residual_hblocked(*args))


def _swiglu_args(gen, m, d=1536, hid=4096):
    f32 = torch.float32
    return (_randn(gen, (m, d)), _randn(gen, (d,), 0.1, 1.0, f32),
            _randn(gen, (d,), 0.1, 0.0, f32),
            _randn(gen, (2 * hid, d), d ** -0.5), _randn(gen, (2 * hid,), 0.5),
            _randn(gen, (d, hid), hid ** -0.5), _randn(gen, (d,), 0.5),
            _randn(gen, (d,), 0.1, 1.0))


# Row 10 whole and stage by stage, as row 9's chain: the LN stage is row 1's
# kernel (bit-exact); the gate against swiglu_gate_plain and the down
# product against fc2_residual_plain, each on the chain's own input; one
# launch count a call, and the same output as the call without the stages.
# m = 1, 100, 127, 129: a lone row and ragged 128-row tiles; 19544:
# vitg-518's rows at batch 8.
@pytest.mark.parametrize("m", [100, 19544, 1, 127, 129])
def test_swiglu_kernel_matches_plain(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    args = _swiglu_args(gen, m)
    x, lnw, lnb, w12, b12, w3, b3, gamma = args
    before = launch_counts().get("swiglu_residual", 0)
    h, g, out = swiglu_residual_stages(*args)
    assert launch_counts()["swiglu_residual"] == before + 1
    assert h.shape == (m, 1536) and g.shape == (m, 4096) and out.shape == x.shape
    _assert_rounding_boundaries_only("swiglu_residual", out,
                                     swiglu_residual_plain(*args), args)
    assert torch.equal(h, layernorm(x, lnw, lnb))
    _assert_rounding_boundaries_only("swiglu_gate", g,
                                     swiglu_gate_plain(h, w12, b12), ())
    _assert_rounding_boundaries_only(
        "swiglu_down", out, fc2_residual_plain(g, w3, b3, gamma, x),
        (x, gamma, b3))
    assert torch.equal(out, swiglu_residual(*args))


# The gate epilogue's silu_mul against the plain one on every bf16 x1
# (chip_smoke.py's check, which raises on any difference), one launch each
# for x2 = 1 and for seeded x2.
def test_silu_mul_kernel_exhaustive(cuda):
    from chip_smoke import check_silu_mul

    before = launch_counts().get("silu_mul", 0)
    check_silu_mul(cuda)
    assert launch_counts()["silu_mul"] == before + 2


def _refuse_library_products(extra=()):
    """F.linear, torch.matmul, mm, addmm, bmm and @ (and ``extra``) made to
    raise; returns the saved attributes."""
    def refuse(*args, **kwargs):
        raise AssertionError("a library product was called")

    saved = []
    for mod, name in ((torch.nn.functional, "linear"), (torch, "matmul"),
                      (torch, "mm"), (torch, "addmm"), (torch, "bmm"),
                      (torch.Tensor, "__matmul__"), *extra):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, refuse)
    return saved


def _profiled_kernel_names(which: str) -> list:
    """In a fresh process (utils.profiling.in_fresh_process: its first
    profile records the card's kernels, ROADMAP fault 5): the device
    kernels of ``which``'s calls under torch.profiler, with the library
    products made to raise around them. "ln_qkv_swiglu": rows 5 and 10;
    "mlp_rcu": rows 8 and 16."""
    from torch.profiler import ProfilerActivity, profile

    from vr_video_generator_tpu_torch.attic.refinenet_pre import refinenet_pre

    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if which == "ln_qkv_swiglu":
        gen = torch.Generator(device=cuda).manual_seed(5)
        d = 1024
        qargs = (_randn(gen, (2, 129, d)),
                 _randn(gen, (d,), 0.1, 1.0, torch.float32),
                 _randn(gen, (d,), 0.1, 0.0, torch.float32),
                 _randn(gen, (3 * d, d), d ** -0.5),
                 _randn(gen, (3 * d,), 0.5), d // 64, 64 ** -0.5)
        sargs = _swiglu_args(gen, 300)
        calls = lambda: (ln_qkv(*qargs), swiglu_residual(*sargs))  # noqa: E731
        extra = ()
    else:
        gen = torch.Generator(device=cuda).manual_seed(8)
        d, c = 384, 64
        margs = (_randn(gen, (300, d)),
                 _randn(gen, (d,), 0.1, 1.0, torch.float32),
                 _randn(gen, (d,), 0.1, 0.0, torch.float32),
                 _randn(gen, (4 * d, d), d ** -0.5),
                 _randn(gen, (4 * d,), 0.5),
                 _randn(gen, (d, 4 * d), (4 * d) ** -0.5),
                 _randn(gen, (d,), 0.5), _randn(gen, (d,), 0.1, 1.0))
        rn0, path2 = (_randn(gen, (2, 20, 36, c)) for _ in range(2))
        ws = []
        for _ in range(4):
            ws += [_randn(gen, (c, c, 3, 3), (9 * c) ** -0.5),
                   _randn(gen, (c,), 0.1)]
        refinenet_pre(rn0, path2, *ws)  # the weight layouts, built once
        calls = lambda: (mlp_residual(*margs),  # noqa: E731
                         refinenet_pre(rn0, path2, *ws))
        extra = ((torch.nn.functional, "conv2d"), (torch, "conv2d"))
    torch.cuda.synchronize()
    saved = _refuse_library_products(extra)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            calls()
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return sorted({e.name for e in prof.events()
                   if e.device_type.name == "CUDA"})


# Rows 5 and 10 on the card run their own kernels only: no cuBLAS product,
# F.linear or torch.matmul (all made to raise), and every kernel of the
# calls' profile is the LayerNorm's or the GEMM core's.
def test_ln_qkv_and_swiglu_call_no_library_product(cuda):
    from vr_video_generator_tpu_torch.utils.profiling import in_fresh_process

    names = in_fresh_process(_profiled_kernel_names, "ln_qkv_swiglu")
    assert names and all("layernorm_kernel" in n or "tma_gemm::gemm_kernel" in n
                         for n in names), names


# Rows 8 and 16 on the card run their own kernels only: no cuBLAS product
# or cuDNN convolution (F.linear, torch.matmul, mm, addmm, bmm and conv2d
# made to raise), and every kernel of the calls' profile is the LayerNorm's,
# the GEMM core's or the RCU pair's ReLU pass.
def test_mlp_and_rcu_pair_call_no_library_product(cuda):
    from vr_video_generator_tpu_torch.utils.profiling import in_fresh_process

    names = in_fresh_process(_profiled_kernel_names, "mlp_rcu")
    assert names and all("layernorm_kernel" in n or "tma_gemm::gemm_kernel" in n
                         or "relu_kernel" in n for n in names), names


def _attention_inputs(cuda, b, n, h, views):
    """Peaked q/k/v (attention_bench.peaked_qkv): with ``views`` strided
    views into one qkv, as the fused path passes them; else contiguous."""
    from vr_video_generator_tpu_torch.attention_bench import peaked_qkv

    qkv = peaked_qkv(torch.Generator(device=cuda).manual_seed(n + h), b, n, h)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if not views:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


# Past 4096 tokens at 2 and 16 heads; ragged and exact 128-key tiles (127,
# 128, 129); vitg's 24 heads; contiguous q/k/v and views into one qkv.
@pytest.mark.parametrize("b,n,h,views", [
    (1, 4097, 2, True), (2, 4785, 16, True), (1, 127, 2, True),
    (1, 128, 2, False), (2, 129, 2, True), (1, 4785, 24, False)])
def test_flash_attention_kernel_matches_plain(cuda, b, n, h, views):
    from chip_smoke import attention_stats

    q, k, v = _attention_inputs(cuda, b, n, h, views)
    before = launch_counts()["flash_attention"]
    got = flash_attention(q, k, v, 0.125)
    assert launch_counts()["flash_attention"] == before + 1
    attention_stats("flash_attention", got,
                    flash_attention_plain(q, k, v, 0.125))


# Odd grids (37 x 45 and 20 x 36: no multiple of the 128-pixel tile) at
# each channel width the big-C kernels are built for, one and three frames:
# every stage against its plain stage on the chain's own input
# (chip_smoke.big_tail_stages: the upsample and resize passes bit for bit,
# conv1 by the GEMM bounds, conv2 by the tail bounds), one launch a wrapper
# call, and each kernel alone against its whole plain version.
@pytest.mark.parametrize("b,h0,w0,c", [(1, 37, 45, 256), (2, 20, 36, 128),
                                       (1, 12, 20, 64), (1, 37, 45, 384),
                                       (3, 37, 45, 256), (1, 20, 36, 128),
                                       (3, 20, 36, 128), (3, 12, 20, 64),
                                       (3, 37, 45, 384)])
def test_head_tail_big_kernels_match_plain(cuda, b, h0, w0, c):
    from chip_smoke import big_tail_stages, gemm_check, tail_stats, tail_weights

    gen = torch.Generator(device=cuda).manual_seed(h0 * w0 + c)
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    x = _randn(gen, (b, c, h0, w0)).permute(0, 2, 3, 1)  # NCHW seen as NHWC
    wts = tail_weights(gen, c)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    _, mid, mid_p = big_tail_stages(f"C={c}", x, wts, out_hw)
    assert mid.shape == mid_p.shape == (b, 2 * h0, 2 * w0, c // 2)
    assert torch.equal(head_tail_big_front(x, k_oc, k1), mid)
    gemm_check("head_tail_big_front", mid, mid_p, ())
    back = (k1, b_oc, b1, k2, b2, k3, b3, out_hw)
    got = head_tail_big_back(mid_p, *back)
    assert got.shape == (b, *out_hw) and got.dtype == torch.float32
    tail_stats("head_tail_big_back", got, head_tail_big_back_plain(mid_p, *back))


# The front reads x in its own strides: NCHW seen as NHWC (as the model
# hands it over), contiguous NHWC, and a channel slice of a wider NHWC
# tensor give the same bits.
def test_head_tail_big_front_reads_any_strides(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _randn(gen, (2, 256, 13, 21)).permute(0, 2, 3, 1)
    k_oc = _randn(gen, (256, 256, 1, 1), 256 ** -0.5)
    k1 = _randn(gen, (128, 256, 3, 3), (9 * 256) ** -0.5)
    wide = torch.zeros((2, 13, 21, 320), dtype=x.dtype, device=cuda)
    wide[..., 64:] = x
    want = head_tail_big_front(x, k_oc, k1)
    for view in (x.contiguous(), wide[..., 64:]):
        assert torch.equal(head_tail_big_front(view, k_oc, k1), want)


# An odd grid (37 x 45: no multiple of the 64-pixel segment anywhere), the
# 1080p vits grid, each channel width the kernel is built for, and the
# largest rows the planners give the ext tail at C=256 and 384 (16:9 frames
# up to 2160p).
@pytest.mark.parametrize("b,h0,w0,c", [(2, 37, 45, 64), (1, 148, 264, 64),
                                       (1, 12, 20, 32), (1, 20, 36, 128),
                                       (2, 37, 45, 256), (1, 80, 144, 256),
                                       (2, 37, 45, 384), (1, 60, 108, 384)])
def test_head_tail_kernel_matches_plain(cuda, b, h0, w0, c):
    gen = torch.Generator(device=cuda).manual_seed(h0 * w0 + c)
    c2 = c // 2
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    x = _randn(gen, (b, c, h0, w0)).permute(0, 2, 3, 1)  # NCHW seen as NHWC
    wts = (_randn(gen, (c, c, 1, 1), c ** -0.5), _randn(gen, (c,), 0.1),
           _randn(gen, (c2, c, 3, 3), (9 * c) ** -0.5), _randn(gen, (c2,), 0.1),
           _randn(gen, (32, c2, 3, 3), (9 * c2) ** -0.5), _randn(gen, (32,), 0.1),
           _randn(gen, (1, 32, 1, 1), 32 ** -0.5), _randn(gen, (1,), 0.1, 0.5))
    got = head_tail_ext(x, *wts, out_hw)
    want = head_tail_ext_plain(x, *wts, out_hw)
    assert got.shape == want.shape == (b, *out_hw) and got.dtype == torch.float32
    err = (got - want).abs()
    span = (want.max() - want.min()).item()
    # chip_smoke.py's bounds, relative to the depth range
    from chip_smoke import TAIL_MAX_REL, TAIL_MEAN_REL

    assert err.max().item() <= TAIL_MAX_REL * span
    assert err.mean().item() <= TAIL_MEAN_REL * span


# Row 7 stage by stage on the chain's own inputs (chip_smoke.ext_tail_stages:
# the upsample and resize passes bit for bit, the mix and conv1 by the GEMM
# bounds, conv2 by the tail bounds, one launch a call), at every width of
# the five-stage chain: conv1 on the halo kernel (C = 64) and on the GEMM
# core's two tile shapes, odd grids and batches.
@pytest.mark.parametrize("b,h0,w0,c", [(1, 12, 20, 64), (2, 37, 45, 64),
                                       (1, 20, 36, 128), (2, 37, 45, 256),
                                       (1, 37, 45, 384), (3, 12, 20, 384)])
def test_head_tail_ext_stages_match_plain(cuda, b, h0, w0, c):
    from chip_smoke import ext_tail_stages, tail_weights

    gen = torch.Generator(device=cuda).manual_seed(h0 * w0 + c + 7)
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    x = _randn(gen, (b, c, h0, w0)).permute(0, 2, 3, 1)  # NCHW seen as NHWC
    ext_tail_stages(f"C={c}", x, tail_weights(gen, c), out_hw)


# The ext chain reads x in its own strides (NCHW seen as NHWC, contiguous
# NHWC, a channel slice of a wider tensor: the same bits), and a head of 32
# features runs the older chain, which has no stages.
def test_head_tail_ext_reads_any_strides(cuda):
    from chip_smoke import tail_weights

    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _randn(gen, (2, 64, 13, 21)).permute(0, 2, 3, 1)
    wts = tail_weights(gen, 64)
    wide = torch.zeros((2, 13, 21, 96), dtype=x.dtype, device=cuda)
    wide[..., 32:] = x
    want = head_tail_ext(x, *wts, (45, 73))
    for view in (x.contiguous(), wide[..., 32:]):
        assert torch.equal(head_tail_ext(view, *wts, (45, 73)), want)
    from vr_video_generator_tpu_torch.ops.head_tail import head_tail_ext_stages

    with pytest.raises(ValueError, match="C=32"):
        head_tail_ext_stages(x[..., :32], *tail_weights(gen, 32), (45, 73))


# Each encoder width (vits' 1080p rows, vitl-728's and vitg-518's at batch
# 8), ragged row counts, and widths only the generic kernel takes.
@pytest.mark.parametrize("rows,d", [(19544, 384), (130, 128), (7, 384),
                                    (38280, 1024), (19544, 1536),
                                    (131, 1024), (77, 1536), (45, 768),
                                    (33, 200), (9, 1000)])
def test_layernorm_kernel_matches_plain(cuda, rows, d):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, d, generator=gen, device=cuda) * 3 + 1).to(torch.bfloat16)
    w = torch.randn(d, generator=gen, device=cuda)
    b = torch.randn(d, generator=gen, device=cuda)
    before = launch_counts()["layernorm"]
    got, want = layernorm(x, w, b).float(), layernorm_plain(x, w, b).float()
    assert launch_counts()["layernorm"] == before + 1
    # bf16 output rounding (tests/test_layernorm.py bound)
    assert bool(((got - want).abs() <= 2e-2 + 1e-2 * want.abs()).all())


# An unaligned view takes the generic kernel; what the kernel does not take
# raises rather than falling back.
def test_layernorm_kernel_operands(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = _randn(gen, (65, 384 + 1))[:, 1:]
    w, b = torch.ones(384, device=cuda), torch.zeros(384, device=cuda)
    xc = x.contiguous()
    row = xc.reshape(-1)[1:1 + 384 * 64].view(64, 384)  # 2-byte offset
    got, want = layernorm(row, w, b).float(), layernorm_plain(row, w, b).float()
    assert bool(((got - want).abs() <= 2e-2 + 1e-2 * want.abs()).all())
    # f32 rows go to the f32 variant (test_layernorm_f32_kernel_matches_plain);
    # f16 rows, a bf16 affine and a short affine are refused.
    for args in ((x, w, b), (xc.half(), w, b), (xc, w.to(torch.bfloat16), b),
                 (xc, w[:-1], b)):
        with pytest.raises(ValueError):
            layernorm(*args)


# q pre-scaled as mha passes it; N < 128, ragged and exact 128-key tiles
# (127, 128, 129), vits' 1080p tokens at 6 heads and vitg's 24.
@pytest.mark.parametrize("b,n,h,views", [
    (2, 70, 2, True), (1, 321, 6, True), (2, 2443, 6, True),
    (1, 127, 3, True), (1, 128, 3, False), (2, 129, 3, True),
    (1, 2443, 24, True), (1, 2443, 24, False)])
def test_attention_kernel_matches_plain(cuda, b, n, h, views):
    from chip_smoke import attention_stats

    q, k, v = _attention_inputs(cuda, b, n, h, views)
    q = (q.float() * 0.125).to(torch.bfloat16)
    before = launch_counts()["attention"]
    got = attention(q, k, v)
    assert launch_counts()["attention"] == before + 1
    attention_stats("attention", got, attention_plain(q, k, v))


def _warp_case(cuda, h, w, b=3):
    """Frames, ramped depth (up to 5, 14 and 30: past the cap) and its shift
    tables on the card."""
    rng = np.random.default_rng(h)
    imgs = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                         dtype=np.uint8)).to(cuda)
    ramp = np.linspace(0, 1, w, dtype=np.float32)[None, None, :]
    tmax = np.array([5.0, 14.0, 30.0], np.float32)[:b, None, None]
    depth = ramp * tmax + rng.normal(0, 0.3, (b, h, w)).astype(np.float32)
    depth = torch.from_numpy(np.clip(depth, 0, None)).to(cuda)
    spec = WarpSpec.create(h, w, StereoConfig())
    ls = torch.ceil(depth.amax(dim=(1, 2)))
    ranges = torch.stack([spec.cfg.offset_bg * h * ls / 14.0,
                          spec.cfg.offset_fg * h * ls / 14.0], dim=1)
    _, st = spec.tables(depth, ranges)
    return spec, imgs, depth, st


@pytest.mark.parametrize("h,w", [(150, 96), (61, 97), (1080, 1920)])
def test_warp_kernels_bit_exact(cuda, h, w):
    spec, imgs, depth, st = _warp_case(cuda, h, w)
    comp, cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos)
    comp_p, cov_p = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                         spec.s_pos)
    assert torch.equal(comp, comp_p) and torch.equal(cov, cov_p)
    args = (comp_p, cov_p, imgs, st.edge_width, spec.kernel_size,
            spec.cfg.sigma)
    assert torch.equal(blur_select_sbs(*args), blur_select_sbs_plain(*args))


@pytest.mark.parametrize("h,w", [(150, 96), (61, 97), (1080, 1920)])
def test_packed_and_banded_kernels_bit_exact(cuda, h, w):
    """Row 13 (the packed emit) against its plain version and the u8 emit;
    row 14 (the banded compositor) against its plain version and row 3,
    with depths above every band in two rows (code 254)."""
    spec, imgs, depth, st = _warp_case(cuda, h, w)
    depth[1, 3, 5:9] = 1e6
    depth[2, h // 2, :7] = 1e6
    counts = launch_counts()
    comp, cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos)
    bd, bd_cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos,
                                banded=True)
    assert launch_counts()["warp_composite_banded"] \
        == counts.get("warp_composite_banded", 0) + 1
    bd_p, bd_cov_p = warp_composite_banded_plain(imgs, depth, st, spec.s_neg,
                                                 spec.s_pos)
    assert torch.equal(bd, bd_p) and torch.equal(bd_cov, bd_cov_p)
    assert torch.equal(bd, comp) and torch.equal(bd_cov, cov)
    args = (comp, cov, imgs, st.edge_width, spec.kernel_size, spec.cfg.sigma)
    pk = blur_select_sbs(*args, emit="packed")
    assert pk.dtype == torch.uint32 and tuple(pk.shape) == (3, h, 2 * w)
    pk_i = pk.view(torch.int32)
    assert torch.equal(pk_i, blur_select_sbs_packed_plain(*args).view(torch.int32))
    assert torch.equal(pk_i, pack_rgb(blur_select_sbs(*args)).view(torch.int32))


def test_banded_past_126_shifts_runs_classic_kernel(cuda):
    """2160 rows give 134 shifts: banded=True launches row 3."""
    spec, imgs, depth, st = _warp_case(cuda, 2160, 64, b=1)
    before = launch_counts()
    comp, cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos,
                               banded=True)
    after = launch_counts()
    assert after["warp_composite"] == before["warp_composite"] + 1
    assert after["warp_composite_banded"] == before["warp_composite_banded"]
    comp_p, cov_p = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                         spec.s_pos)
    assert torch.equal(comp, comp_p) and torch.equal(cov, cov_p)


def _warp_all_rows(spec, imgs, depth, st, banded_equals_classic=True):
    """Rows 3, 14 (where its 126 shifts allow), 4 and 13 on one input, each
    bit for bit against its plain version; row 14 also against row 3 where
    no pixel lies in more than two bands."""
    comp, cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos)
    comp_p, cov_p = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                         spec.s_pos)
    assert torch.equal(cov, cov_p) and torch.equal(comp, comp_p)
    if resolve_banded(True, spec.s_neg, spec.s_pos):
        bd, bd_cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos,
                                    banded=True)
        bd_p, bd_cov_p = warp_composite_banded_plain(imgs, depth, st,
                                                     spec.s_neg, spec.s_pos)
        assert torch.equal(bd, bd_p) and torch.equal(bd_cov, bd_cov_p)
        if banded_equals_classic:
            assert torch.equal(bd, comp) and torch.equal(bd_cov, cov)
    args = (comp, cov, imgs, st.edge_width, spec.kernel_size, spec.cfg.sigma)
    assert torch.equal(blur_select_sbs(*args), blur_select_sbs_plain(*args))
    assert torch.equal(blur_select_sbs(*args, emit="packed").view(torch.int32),
                       blur_select_sbs_packed_plain(*args).view(torch.int32))
    return comp, cov


WARP_TABLES = {"three-overlapping-bands": overlapping,
               "bands-descending": descending, "random-bands": random_bands,
               "depth-above-every-band": above_all,
               "all-shifts-invalid": all_invalid,
               "unbounded-bands-nan-depth": unbounded,
               "two-bands-not-rank-adjacent": skip_one,
               "last-valid-rank-dual": last_rank_dual}


@pytest.mark.parametrize("h,w", [(61, 97), (150, 96), (1080, 1920)])
@pytest.mark.parametrize("tables", list(WARP_TABLES))
def test_warp_rows_on_adversarial_tables(cuda, tables, h, w):
    """Rows 3, 4, 13 and 14 on tables no shortcut survives: bands that
    overlap three deep or in pairs that are not rank-adjacent (row 14's
    second claim is rank r + 1's shift, so it is held only against its own
    plain version there), that descend, random ones, depth above every
    band, no valid shift, unbounded and empty bands, NaN depth, a dual pair
    ending at the last valid rank."""
    spec, imgs, depth, st = _warp_case(cuda, h, w)
    imgs, depth, st = WARP_TABLES[tables](spec, imgs, depth, st)
    _warp_all_rows(spec, imgs, depth, st, banded_equals_classic=tables not in (
        "three-overlapping-bands", "random-bands", "unbounded-bands-nan-depth",
        "two-bands-not-rank-adjacent"))


@pytest.mark.parametrize("h,w", [(61, 97), (1080, 1920)])
def test_banded_kernel_at_126_shifts(cuda, h, w):
    """Row 14 at the most shifts it takes (126, each band overlapping the
    next: codes up to 125 | 128), launched once and bit for bit against its
    plain version."""
    _, imgs, depth, st = _warp_case(cuda, h, w)
    st, s_neg, s_pos = shifts_126(st)
    before = launch_counts()
    got = warp_composite(imgs, depth, st, s_neg, s_pos, banded=True)
    after = launch_counts()
    assert after["warp_composite_banded"] \
        == before.get("warp_composite_banded", 0) + 1
    assert after.get("warp_composite", 0) == before.get("warp_composite", 0)
    want = warp_composite_banded_plain(imgs, depth, st, s_neg, s_pos)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("b", [1, 2])
def test_warp_rows_at_2160p(cuda, b):
    """4K: 134 shifts (row 14 gives way to row 3), a (19, 17) blur."""
    spec, imgs, depth, st = _warp_case(cuda, 2160, 3840, b=b)
    assert spec.s_neg + spec.s_pos + 1 == 134 and spec.kernel_size == 8
    _warp_all_rows(spec, imgs, depth, st)


def test_warp_rows_shifts_wider_than_the_frame(cuda):
    """1080 x 32: s_pos = 48 >= w, so a shift wraps more than once."""
    spec, imgs, depth, st = _warp_case(cuda, 1080, 32)
    assert spec.s_pos >= 32
    _, cov = _warp_all_rows(spec, imgs, depth, st)
    assert 0 < cov.float().mean() < 1


@pytest.mark.parametrize("h,w", [(61, 97), (1080, 1920)])
@pytest.mark.parametrize("kind", ["all-covered", "none-covered",
                                  "edge-past-width"])
def test_blur_select_coverage_extremes(cuda, kind, h, w):
    """Rows 4 and 13 with every pixel covered (no blur at all), none
    covered (blur everywhere) and an edge at or past the width (the left
    half all original)."""
    gen = torch.Generator(device=cuda).manual_seed(h + w)
    comp, imgs = (torch.randint(0, 256, (3, h, w, 3), generator=gen,
                                device=cuda, dtype=torch.uint8)
                  for _ in range(2))
    cov = torch.full((3, h, w), kind != "none-covered", device=cuda)
    edge = torch.tensor([w, w + 3, 4 * w] if kind == "edge-past-width"
                        else [0, 5, 40], dtype=torch.int32, device=cuda)
    ksize = int(np.round(0.0036 * h))
    args = (comp, cov, imgs, edge, ksize, 3.0)
    got = blur_select_sbs(*args)
    assert torch.equal(got, blur_select_sbs_plain(*args))
    assert torch.equal(blur_select_sbs(*args, emit="packed").view(torch.int32),
                       pack_rgb(got).view(torch.int32))
    if kind == "edge-past-width":
        assert torch.equal(got[:, :, :w], imgs)


# path1 on an odd grid (37 x 45: no multiple of the 64-pixel segment), at
# vits' 1080p/518 grid, and at each width the single-kernel tail takes.
@pytest.mark.parametrize("b,h2,w2,c", [(2, 37, 45, 32), (1, 296, 528, 64),
                                       (2, 41, 70, 128), (2, 37, 45, 64)])
def test_head_tail_base_kernel_matches_plain(cuda, b, h2, w2, c):
    from chip_smoke import tail_stats, tail_weights
    from vr_video_generator_tpu_torch.ops.head_tail import (head_tail,
                                                            head_tail_plain)

    gen = torch.Generator(device=cuda).manual_seed(h2 * w2 + c)
    out_hw = (h2 * 7 // 4, w2 * 7 // 4)
    x = _randn(gen, (b, c, h2, w2)).permute(0, 2, 3, 1)  # NCHW seen as NHWC
    wts = tail_weights(gen, c)[2:]
    before = launch_counts().get("head_tail", 0)
    got = head_tail(x, *wts, out_hw)
    assert launch_counts()["head_tail"] == before + 1
    assert got.shape == (b, *out_hw) and got.dtype == torch.float32
    tail_stats("head_tail", got, head_tail_plain(x, *wts, out_hw))


# Row 15 stage by stage on the chain's own inputs (chip_smoke.base_tail_stages:
# conv1 by the GEMM bounds, the resize pass bit for bit, conv2 by the tail
# bounds, one launch a call): conv1 on the halo kernel (C = 64) and on the
# core's 256 x 64 tiles (C = 128), odd grids, vits' 1080p path1 at batch 8.
@pytest.mark.parametrize("b,h2,w2,c", [(2, 37, 45, 64), (1, 9, 33, 64),
                                       (8, 296, 528, 64), (2, 37, 45, 128),
                                       (1, 9, 33, 128), (8, 296, 528, 128)])
def test_head_tail_base_stages_match_plain(cuda, b, h2, w2, c):
    from chip_smoke import base_tail_stages, tail_weights

    gen = torch.Generator(device=cuda).manual_seed(h2 * w2 + c + 15)
    out_hw = (h2 * 7 // 4, w2 * 7 // 4)
    x = _randn(gen, (b, c, h2, w2)).permute(0, 2, 3, 1)  # NCHW seen as NHWC
    base_tail_stages(f"C={c}", x, tail_weights(gen, c)[2:], out_hw)


# The chain reads path1 in its own strides (NCHW seen as NHWC, contiguous
# NHWC, a channel slice of a wider tensor: the same bits); C = 32 runs the
# wmma chain, which has no stages.
@pytest.mark.parametrize("c", [64, 128])
def test_head_tail_base_reads_any_strides(cuda, c):
    from chip_smoke import tail_weights
    from vr_video_generator_tpu_torch.ops.head_tail import (head_tail,
                                                            head_tail_stages)

    gen = torch.Generator(device=cuda).manual_seed(c + 9)
    x = _randn(gen, (2, c, 26, 42)).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)[2:]
    wide = torch.zeros((2, 26, 42, c + 32), dtype=x.dtype, device=cuda)
    wide[..., 32:] = x
    want = head_tail(x, *wts, (45, 73))
    for view in (x.contiguous(), wide[..., 32:]):
        assert torch.equal(head_tail(view, *wts, (45, 73)), want)
    with pytest.raises(ValueError, match="C=32"):
        head_tail_stages(x[..., :32], *tail_weights(gen, 32)[2:], (45, 73))


@pytest.mark.parametrize("b,h0,w0,c", [(2, 37, 45, 64), (1, 148, 264, 64),
                                       (2, 20, 36, 128), (1, 148, 264, 128),
                                       (2, 7, 33, 64), (1, 61, 97, 64),
                                       (2, 7, 33, 128), (1, 61, 97, 128),
                                       (8, 148, 264, 64), (2, 9, 37, 16),
                                       (1, 20, 36, 96), (1, 12, 40, 192),
                                       (1, 12, 40, 256), (1, 9, 37, 384)])
def test_rcu_pair_kernel_matches_plain(cuda, b, h0, w0, c):
    """Each of the four conv calls alone against rcu_conv_plain (conv2a's
    ReLU copy bit for bit), and the chain by its error against f32
    (chip_smoke.py's check and bounds); odd grids against the core's 8-row
    x 32-pixel tiles, vits' 1080p grid at batch 8, and the widths other
    than 64 and 128: zero-padded (16, 96, 192 to 64, 128, 256; the last
    column tile half idle at 192) and unpadded at 256 and 384 (two and
    three 128-wide column tiles)."""
    from chip_smoke import rcu_pair_stats
    from vr_video_generator_tpu_torch.attic.refinenet_pre import refinenet_pre

    gen = torch.Generator(device=cuda).manual_seed(h0 * w0 + c)
    rn0, path2 = (_randn(gen, (b, c, h0, w0)).permute(0, 2, 3, 1)
                  for _ in range(2))
    ws = []
    for _ in range(4):
        ws += [_randn(gen, (c, c, 3, 3), (9 * c) ** -0.5), _randn(gen, (c,), 0.1)]
    before = launch_counts().get("rcu_pair", 0)
    got = refinenet_pre(rn0, path2, *ws)
    assert launch_counts()["rcu_pair"] == before + 4
    assert got.shape == rn0.shape and got.dtype == torch.bfloat16
    rcu_pair_stats("rcu_pair", rn0, path2, ws)


def test_host_staging_reads_back_uint32(cuda):
    """A packed (uint32) SBS batch survives the pinned readback word for
    word, and a u8 batch of the same shape after it gets a u8 buffer."""
    from vr_video_generator_tpu_torch.runtime.segment import HostStaging

    staging = HostStaging(cuda)
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 24, (2, 48, 128), dtype=np.int64)
    u8 = rng.integers(0, 256, (2, 48, 128), dtype=np.uint8)
    for _ in range(2):
        dev = torch.from_numpy(words.astype(np.int32)).to(cuda).view(torch.uint32)
        back = staging.finish_readback(staging.start_readback(dev))
        assert back.dtype == np.uint32
        np.testing.assert_array_equal(back, words.astype(np.uint32))
        back = staging.finish_readback(staging.start_readback(
            torch.from_numpy(u8).to(cuda)))
        assert back.dtype == np.uint8
        np.testing.assert_array_equal(back, u8)


@pytest.mark.parametrize("impl,sbs_output", [("xla", "u8"),
                                             ("pallas", "packed")])
def test_warp_impl_routes_on_the_card(cuda, impl, sbs_output):
    """--warp_impl xla runs the plain composite and blur/select on the card
    (no warp kernel launches); pallas with packed output launches the
    compositor and the packed blur/select, not the u8 one."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vits", batch_size=2, compute_dtype="bfloat16",
                    input_size=56, warp_impl=impl, sbs_output=sbs_output)
    pipe = SbsPipeline.create(cfg, 48, 64, allow_random=True, device=cuda)
    frames = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3),
                                               dtype=np.uint8)
    reset_launch_counts()
    sbs, _ = pipe.step(frames, pipe.initial_state())
    counts = launch_counts()
    warp = {k: counts.get(k, 0) for k in ("warp_composite", "blur_select_sbs",
                                          "blur_select_sbs_packed")}
    if impl == "xla":
        assert warp == {"warp_composite": 0, "blur_select_sbs": 0,
                        "blur_select_sbs_packed": 0}
        assert sbs.dtype == torch.uint8
    else:
        assert warp == {"warp_composite": 1, "blur_select_sbs": 0,
                        "blur_select_sbs_packed": 1}
        assert sbs.dtype == torch.uint32 and tuple(sbs.shape) == (2, 48, 128)


@pytest.mark.parametrize("fused", ["xla", "fused"])
def test_step_enqueues_without_host_sync(cuda, fused):
    """A step only enqueues device work: no host-to-device copy of host data
    and no readback inside it, so the segment loop's overlap is real; on the
    unfused and on the fused path."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vits", batch_size=2, compute_dtype="bfloat16",
                    mlp_fused=fused, tail=fused, input_size=56)
    pipe = SbsPipeline.create(cfg, 48, 64, allow_random=True, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 48, 64, 3), dtype=np.uint8)).to(cuda)
    _, state = pipe.step(frames, pipe.initial_state())  # builds, caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sbs, state = pipe.step(frames, state, n_valid=1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sbs.shape == (2, 48, 128, 3)
    if fused == "fused":
        counts = launch_counts()
        assert all(counts.get(k, 0) > 0 for k in (
            "ln_qkv", "proj_ls_residual", "mlp_residual", "head_tail_ext"))


def test_cli_f32_on_the_card_raises(cuda, tmp_path):
    """--compute_dtype float32 with --device cuda (the default) runs vitg
    fused on the card (row 10's f32 chain and the f32 tail): the CLI
    converts a small clip, its subclips double width with the right half
    the input up to the codec. Nothing raises where before the fused
    SwiGLU half had no f32 kernel."""
    cv2 = pytest.importorskip("cv2")
    from vr_video_generator_tpu_torch.cli import main

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for i in range(4):
        w.write(np.full((48, 64, 3), 40 * i, np.uint8))
    w.release()
    sub = tmp_path / "S"
    assert main(["--VideoDir", src, "--OutputDir", str(tmp_path / "out.mkv"),
                 "--DebugDir", str(tmp_path / "D") + "/",
                 "--SubClipDir", str(sub) + "/", "--batch_size", "2",
                 "--input_size", "56", "--compute_dtype", "float32",
                 "--encoder", "vitg", "--mlp_fused", "fused",
                 "--allow_random_weights"]) == 0
    clips = sorted(p.name for p in sub.iterdir())
    assert clips and all(c.endswith(".mp4") for c in clips)
    cap = cv2.VideoCapture(str(sub / clips[0]))
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (48, 128, 3)


def _graph_pipe(cuda, mlp_fused="auto", h=150, w=96, batch=2, chunk=1,
                sbs_output="auto", input_size=56, **kw):
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vits", batch_size=batch, compute_dtype="bfloat16",
                    mlp_fused=mlp_fused, tail=mlp_fused, input_size=input_size,
                    chunk_batches=chunk, sbs_output=sbs_output,
                    warp_impl="pallas" if sbs_output == "packed" else "auto",
                    **kw)
    return SbsPipeline.create(cfg, h, w, allow_random=True, device=cuda)


def _states_equal(a, b):
    """Every field equal, dtype and bits (chip_smoke.py's check):
    anchor_prev is None at depth_stride 1."""
    from chip_smoke import states_equal

    return states_equal(a, b)


def _eager(pipe, chunk, state):
    outs = []
    for batch in chunk:
        sbs, state = pipe.step(batch, state)
        outs.append(sbs)
    return outs, state


@pytest.mark.parametrize("mlp_fused,sbs_output", [
    ("xla", "auto"), ("auto", "auto"), ("fused", "auto"),
    ("auto", "packed")])
def test_step_many_graph_equals_eager_steps(cuda, mlp_fused, sbs_output):
    """step_many on the card (a CUDA graph of k = 3 steps) against 3 eager
    steps, bit for bit, SBS and every state field, on the unfused, auto and
    fused paths and the packed emit: two calls, the second on other frames
    and without a new capture; the first call's outputs survive the
    second; a replay counts k times one eager step's launches."""
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts

    pipe = _graph_pipe(cuda, mlp_fused, sbs_output=sbs_output)
    rng = np.random.default_rng(9)
    chunks = [torch.from_numpy(rng.integers(0, 256, (3, 2, 150, 96, 3),
                                            dtype=np.uint8)).to(cuda)
              for _ in range(2)]
    state0 = pipe.initial_state()
    pipe.step(chunks[0][0], state0)
    torch.cuda.synchronize()
    reset_launch_counts()
    pipe.step(chunks[0][0], state0)
    one = {k: v for k, v in launch_counts().items() if v}
    want1, st = _eager(pipe, chunks[0], state0)
    want2, st_want2 = _eager(pipe, chunks[1], st)
    got1, st1 = pipe.step_many(chunks[0], state0)
    keep = [o.clone() for o in got1]
    graph = pipe._graphs[(3, 2)]
    reset_launch_counts()
    got2, st2 = pipe.step_many(chunks[1], st1)
    assert list(pipe._graphs.values()) == [graph]
    assert graph.launches == {k: 3 * v for k, v in one.items()}
    assert {k: v for k, v in launch_counts().items() if v} == graph.launches
    for got, want in ((got1, want1), (got2, want2)):
        for g, e in zip(got, want):
            assert g.dtype == e.dtype and torch.equal(g, e)
    for a, b in ((st1, st), (st2, st_want2)):
        assert _states_equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(got1, keep))
    assert not any(o.data_ptr() == s.data_ptr()
                   for o in got2 for s in graph.outs)


def test_step_many_graph_at_1080p(cuda):
    """vits auto at 1080p, batch 8, k = 3 (chip_smoke.py's phase 5 shape):
    the graph equals the eager steps bit for bit from the cold start."""
    pipe = _graph_pipe(cuda, h=1080, w=1920, batch=8)
    chunk = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (3, 8, 1080, 1920, 3), dtype=np.uint8)).to(cuda)
    state0 = pipe.initial_state()
    want, st = _eager(pipe, chunk, state0)
    got, st_g = pipe.step_many(chunk, state0)
    assert all(torch.equal(g, e) for g, e in zip(got, want))
    assert _states_equal(st_g, st)


@pytest.mark.parametrize("chunk", [2, 3])
def test_chunked_segment_on_the_card(cuda, chunk):
    """process_segment over 22 frames at batch 4 (five full batches and a
    short one): the same bytes at chunk_batches 2 or 3 as at 1."""
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.runtime.segment import process_segment
    from vr_video_generator_tpu_torch.stage_bench import (CollectingWriter,
                                                          MemoryReader)

    base = _graph_pipe(cuda, batch=4)
    frames = np.random.default_rng(2).integers(0, 256, (22, 150, 96, 3),
                                               dtype=np.uint8)
    out = {}
    for k in (1, chunk):
        import dataclasses

        pipe = SbsPipeline(base.model, 150, 96, run_cfg=dataclasses.replace(
            base.run_cfg, chunk_batches=k))
        writer = CollectingWriter()
        assert process_segment(pipe, MemoryReader(frames), writer, 0, 22,
                               max_frame_count=5, batch_size=4) == 22
        out[k] = (np.stack(writer.frames), writer.clips)
    np.testing.assert_array_equal(out[1][0], out[chunk][0])
    assert out[1][1] == out[chunk][1]


def test_host_staging_chunk_roundtrip(cuda):
    """A chunk goes up from one pinned buffer as a (k, B, H, W, 3) stack and
    its k outputs come back in order as one (k B, ...) array."""
    from vr_video_generator_tpu_torch.runtime.segment import HostStaging

    staging = HostStaging(cuda)
    rng = np.random.default_rng(8)
    for _ in range(3):
        batches = [rng.integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
                   for _ in range(4)]
        up = staging.upload(batches)
        assert up.is_cuda and tuple(up.shape) == (4, 2, 5, 7, 3)
        back = staging.finish_readback(staging.start_readback(tuple(up)))
        np.testing.assert_array_equal(back, np.concatenate(batches))


def test_trace_records_device_kernels(cuda, tmp_path):
    """utils.profiling.trace on the card: CUDA activity is on, and the
    Chrome trace holds the block's kernels (the suite takes its other
    profiles in fresh processes, so this is the process's first)."""
    import json

    from vr_video_generator_tpu_torch.utils.profiling import trace

    a = torch.randn(256, 256, device=cuda)
    with trace(str(tmp_path), "t.json"):
        (a @ a).sum()
        torch.cuda.synchronize()
    with open(tmp_path / "t.json", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_stride_step_at_1080p(cuda, stride):
    """vits auto at 1080p, batch 8, input 518, depth_stride 2, 4 and 8
    (depth batches 4, 2, 1): two steps from the cold start, each with the
    right half equal to the input and the SBS equal to the plain warp of
    its own depth (the anchors' depth lerped, ops.temporal), the carried
    anchor the last anchor's depth, bit for bit."""
    from vr_video_generator_tpu_torch.ops.temporal import (stride_interpolate,
                                                           temporal_scan)

    pipe = _graph_pipe(cuda, h=1080, w=1920, batch=8, input_size=518,
                       depth_stride=stride)
    frames = torch.from_numpy(np.random.default_rng(stride).integers(
        0, 256, (16, 1080, 1920, 3), dtype=np.uint8)).to(cuda)
    st = pipe.initial_state()
    for i in range(2):
        batch = frames[8 * i:8 * i + 8]
        sbs, st_next = pipe.step(batch, st)
        assert torch.equal(sbs[:, :, 1920:], batch)
        with torch.inference_mode():
            anchors = pipe.depth_only(batch[stride - 1::stride])
            depth, last = stride_interpolate(anchors, st, stride)
            blended, ranges, _ = temporal_scan(depth, st, pipe.spec)
            plain = pipe.spec.warp_batch_plain(batch, blended, ranges)
        assert torch.equal(sbs, plain)
        assert torch.equal(st_next.anchor_prev, last)
        st = st_next


def test_step_audited_equals_stride_1_step(cuda):
    """step_audited at stride 2 against the stride-1 step on the same
    weights, batch and (warm) state: the SBS and the state bit for bit, the
    stats equal to stride_audit's, which leaves the state as it was."""
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    pipe = _graph_pipe(cuda, batch=4, depth_stride=2)
    p1 = SbsPipeline(pipe.model, 150, 96, run_cfg=dataclasses.replace(
        pipe.run_cfg, depth_stride=1))
    frames = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (8, 150, 96, 3), dtype=np.uint8)).to(cuda)
    _, warm = pipe.step(frames[:4], pipe.initial_state())
    before = warm.map(torch.clone)
    rms_r, mx_r = pipe.stride_audit(frames[4:], warm)
    assert _states_equal(warm, before)
    want, want_st = p1.step(frames[4:], warm._replace(anchor_prev=None))
    sbs, st, rms, mx = pipe.step_audited(frames[4:], warm)
    assert torch.equal(sbs, want)
    assert _states_equal(st._replace(anchor_prev=None), want_st)
    assert (rms, mx) == (rms_r, mx_r) and mx >= rms > 0


def test_stride_graph_equals_eager_steps(cuda):
    """step_many at stride 2 (a CUDA graph of k = 3 steps, a 6-tensor
    state) against 3 eager steps, bit for bit, the SBS and every state
    field with anchor_prev, on two calls."""
    pipe = _graph_pipe(cuda, batch=4, depth_stride=2)
    rng = np.random.default_rng(12)
    state = pipe.initial_state()
    assert state.anchor_prev is not None
    for _ in range(2):
        chunk = torch.from_numpy(rng.integers(0, 256, (3, 4, 150, 96, 3),
                                              dtype=np.uint8)).to(cuda)
        want, st_want = _eager(pipe, chunk, state)
        got, st_got = pipe.step_many(chunk, state)
        assert all(torch.equal(g, e) for g, e in zip(got, want))
        assert _states_equal(st_got, st_want)
        state = st_got
    assert list(pipe._graphs) == [(3, 4)]


@pytest.mark.parametrize("chunk", [1, 3])
def test_adaptive_segment_extremes_on_the_card(cuda, chunk):
    """process_segment over 24 frames at batch 4, stride 2: stride_max_rms
    1e-30 (always full depth) writes the stride-1 run's bytes;
    1e30 with a probe every 2 batches writes the probe schedule's
    (step_audited on batches 0, 2 and 4, step on the others)."""
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.runtime.segment import process_segment
    from vr_video_generator_tpu_torch.stage_bench import (CollectingWriter,
                                                          MemoryReader)

    base = _graph_pipe(cuda, batch=4, depth_stride=2)
    frames = np.random.default_rng(13).integers(0, 256, (24, 150, 96, 3),
                                                dtype=np.uint8)

    def segment(**kw):
        pipe = SbsPipeline(base.model, 150, 96, run_cfg=dataclasses.replace(
            base.run_cfg, chunk_batches=chunk, **kw))
        writer = CollectingWriter()
        assert process_segment(pipe, MemoryReader(frames), writer, 0, 24,
                               max_frame_count=5, batch_size=4) == 24
        return np.stack(writer.frames)

    np.testing.assert_array_equal(segment(stride_max_rms=1e-30),
                                  segment(depth_stride=1))
    st, want = base.initial_state(), []
    for i in range(6):
        if i % 2 == 0:
            sbs, st, _, _ = base.step_audited(frames[4 * i:4 * i + 4], st)
        else:
            sbs, st = base.step(frames[4 * i:4 * i + 4], st)
        want.append(sbs.cpu().numpy())
    np.testing.assert_array_equal(
        segment(stride_max_rms=1e30, stride_audit_every=2),
        np.concatenate(want))


# The tanh GELU of rows 8 and 9's fc1 epilogue against the plain gelu_tanh
# on every bf16 input (chip_smoke.py's check, which raises on any
# difference), one launch.
def test_gelu_tanh_kernel_exhaustive(cuda):
    from chip_smoke import check_gelu_tanh

    before = launch_counts().get("gelu_tanh", 0)
    check_gelu_tanh(cuda)
    assert launch_counts()["gelu_tanh"] == before + 1


# Rows 8 and 9 with the tanh GELU (--gelu tanh), whole and stage by stage:
# the LN stage row 1's kernel, the GEMM stages and the output by the exact
# chains' bounds, the GELU stage bit for bit through a selection fc1
# (chip_smoke.py's check); each call counted on the tanh variant's counter
# and on no other.
@pytest.mark.parametrize("m,d", [(140, 128), (321, 384), (19544, 384),
                                 (127, 768), (19544, 768), (130, 1024),
                                 (19544, 1024)])
def test_mlp_kernels_at_tanh_match_plain(cuda, m, d):
    from chip_smoke import selection_gelu_stage
    from vr_video_generator_tpu_torch.ops import mlp

    gen = torch.Generator(device=cuda).manual_seed(m + d + 16)
    args = _hblocked_args(gen, m, d)
    x, lnw, lnb, w1, b1, w2, b2, gamma = args
    base = "mlp_residual_hblocked" if d == 1024 else "mlp_residual"
    name = f"{base}_tanh"
    before = launch_counts()
    a, h, out = getattr(mlp, f"{base}_stages")(*args, approx=True)
    after = launch_counts()
    assert after[name] == before.get(name, 0) + 1
    assert all(after[k] == before.get(k, 0) for k in after if k != name)
    _assert_rounding_boundaries_only(
        base, out, mlp_residual_plain(*args, approx=True), args)
    assert torch.equal(a, layernorm(x, lnw, lnb))
    _assert_rounding_boundaries_only(
        "mlp_fc1_gelu", h, fc1_gelu_plain(a, w1, b1, approx=True), (b1,))
    _assert_rounding_boundaries_only(
        "mlp_fc2_residual", out, fc2_residual_plain(h, w2, b2, gamma, x),
        (x, gamma, b2))
    assert torch.equal(out, getattr(mlp, base)(*args, approx=True))
    selection_gelu_stage(9 if d == 1024 else 8, args)


def test_gelu_tanh_step_on_the_card(cuda):
    """A --gelu tanh step at vits fused runs row 8's tanh variant (and not
    the exact chain), 12 times a step, without a host sync."""
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts

    pipe = _graph_pipe(cuda, "fused", gelu="tanh")
    frames = torch.from_numpy(np.random.default_rng(16).integers(
        0, 256, (2, 150, 96, 3), dtype=np.uint8)).to(cuda)
    _, state = pipe.step(frames, pipe.initial_state())
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step(frames, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = launch_counts()
    assert counts["mlp_residual_tanh"] == 12
    assert counts.get("mlp_residual", 0) == 0


def _sharded(cuda, slots, stride=1, batch=2):
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
    from vr_video_generator_tpu_torch.parallel.sharded import \
        ShardedSbsPipeline

    base = _graph_pipe(cuda, batch=batch, depth_stride=stride)
    mesh = make_mesh((slots, 1), devices=[cuda] * slots)
    return ShardedSbsPipeline(base.model, 150, 96, mesh, run_cfg=base.run_cfg)


@pytest.mark.parametrize("slots,stride", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharded_step_equals_sbs_pipeline(cuda, slots, stride):
    """ShardedSbsPipeline at a 1 x 1 mesh and at two slots on one card:
    each slot's SBS and state (through the slot's single-step graph) equal
    to its own SbsPipeline's eager step over its own frames, bit for bit,
    over three steps; each replica holds its own copy of the weights."""
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    sp = _sharded(cuda, slots, stride)
    w = [next(r.model.parameters()) for r in sp.replicas]
    assert len({t.data_ptr() for t in w}) == slots
    assert next(sp.model.parameters()).data_ptr() not in {t.data_ptr()
                                                          for t in w}
    singles = [SbsPipeline(r.model, 150, 96, run_cfg=sp.run_cfg)
               for r in sp.replicas]
    rng = np.random.default_rng(slots + 10 * stride)
    states = sp.initial_state()
    want_states = [p.initial_state() for p in singles]
    for _ in range(3):
        frames = rng.integers(0, 256, (2 * slots, 150, 96, 3), dtype=np.uint8)
        sbs, states = sp.step(frames, states)
        for i, p in enumerate(singles):
            want, want_states[i] = p.step(frames[2 * i:2 * i + 2],
                                          want_states[i])
            assert torch.equal(sbs[i], want)
            assert _states_equal(states[i], want_states[i])


def test_sharded_short_batch_on_the_card(cuda):
    """A slot's short batch (n_valid below B) steps eagerly and counts only
    its real frames, as SbsPipeline.step does with n_valid."""
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    sp = _sharded(cuda, 2)
    singles = [SbsPipeline(r.model, 150, 96, run_cfg=sp.run_cfg)
               for r in sp.replicas]
    frames = np.random.default_rng(3).integers(0, 256, (4, 150, 96, 3),
                                               dtype=np.uint8)
    sbs, states = sp.step(frames, sp.initial_state(), n_valid=[2, 1])
    for i, (p, nv) in enumerate(zip(singles, (2, 1))):
        want, st = p.step(frames[2 * i:2 * i + 2], p.initial_state(),
                          n_valid=nv)
        assert torch.equal(sbs[i], want)
        assert _states_equal(states[i], st)


def test_sharded_on_every_card(cuda, tmp_path, monkeypatch):
    """With two cards or more: a mesh of every card (make_mesh without a
    device list), each slot's replica on its own card, its SBS and state
    equal to an SbsPipeline's on that card over the slot's frames, bit for
    bit, over three steps; then the CLI with --mesh Dx1 over a video of 8
    frames a card equal to one sequential run's frames (the warm-up covers
    every slot's prefix)."""
    import cv2

    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
    from vr_video_generator_tpu_torch.parallel.sharded import (
        ShardedSbsPipeline, device_scope)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.video import writer as writer_mod
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    base = _graph_pipe(cuda)
    sp = ShardedSbsPipeline(base.model, 150, 96, make_mesh((n, 1)),
                            run_cfg=base.run_cfg)
    assert [r.device for r in sp.replicas] == [torch.device("cuda", i)
                                               for i in range(n)]
    singles = [SbsPipeline(r.model, 150, 96, run_cfg=sp.run_cfg)
               for r in sp.replicas]
    rng = np.random.default_rng(n)
    states = sp.initial_state()
    want_states = [p.initial_state() for p in singles]
    for _ in range(3):
        frames = rng.integers(0, 256, (2 * n, 150, 96, 3), dtype=np.uint8)
        sbs, states = sp.step(frames, states)
        for i, p in enumerate(singles):
            with device_scope(p.device):
                want, want_states[i] = p.step(frames[2 * i:2 * i + 2],
                                              want_states[i])
            assert sbs[i].device == p.device and torch.equal(sbs[i], want)
            assert _states_equal(states[i], want_states[i])

    frames = rng.integers(0, 256, (8 * n, 150, 96, 3), dtype=np.uint8)
    video = str(tmp_path / "in.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                         (96, 150))
    for f in frames:
        vw.write(f[:, :, ::-1])
    vw.release()
    with VideoReader(video, begin=0, backend="cv2") as r:
        decoded = np.stack(list(r.frames(0, 8 * n)))
    clips = {}

    class Capture:
        def __init__(self, *a, **k):
            pass

        def write_clip(self, begin, fr):
            clips[begin] = np.stack(fr)

        def wait(self):
            pass

        def close(self):
            pass

    monkeypatch.setattr(writer_mod, "SubclipWriter", Capture)
    assert cli.main(["--VideoDir", video, "--OutputDir", str(tmp_path / "o"),
                     "--DebugDir", str(tmp_path / "D") + "/",
                     "--SubClipDir", str(tmp_path / "S") + "/",
                     "--batch_size", "2", "--input_size", "56",
                     "--Max_Frame_Count", "64", "--repair_mode", "1",
                     "--reader_backend", "cv2", "--allow_random_weights",
                     "--mesh", f"{n}x1"]) == 0
    assert sorted(clips) == list(range(0, 8 * n, 8))
    pipe = SbsPipeline.create(base.run_cfg, 150, 96, allow_random=True,
                              device=cuda)
    st, want = pipe.initial_state(), []
    for i in range(0, 8 * n, 2):
        out, st = pipe.step(decoded[i:i + 2], st)
        want.append(out.cpu().numpy())
    got = np.concatenate([clips[k] for k in sorted(clips)])
    np.testing.assert_array_equal(got, np.concatenate(want))


def test_step_many_capture_failure_raises(cuda, monkeypatch):
    """A step that cannot be captured (here: a host read inside it) makes
    step_many raise; it never falls back to the eager loop. (Last in the
    file: a failed capture is ended, but nothing after it depends on
    that.)"""
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    pipe = _graph_pipe(cuda)
    frames = torch.zeros((2, 2, 150, 96, 3), dtype=torch.uint8, device=cuda)
    real = SbsPipeline.step

    def step(self, frames, state, n_valid=None):
        out = real(self, frames, state, n_valid=n_valid)
        float(out[1].offset_range.sum())  # a host sync
        return out

    monkeypatch.setattr(SbsPipeline, "step", step)
    with pytest.raises(RuntimeError):
        pipe.step_many(frames, pipe.initial_state())
    torch.cuda.synchronize()


# --- f32 on the card: the f32 kernels and the f32 paths ---------------------

F32 = torch.float32


@pytest.mark.parametrize("rows,d", [(1, 384), (333, 384), (97, 768),
                                    (130, 1024), (64, 1536), (33, 200)])
def test_layernorm_f32_kernel_matches_plain(cuda, rows, d):
    """Row 1 at f32 at every encoder width and one the generic kernel takes
    (200), within chip_smoke.py's f32 bound, which refuses TF32-rounded
    input."""
    from chip_smoke import f32_dense_check, tf32_round

    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = _randn(gen, (rows, d), 3.0, 1.0, F32)
    w, b = _randn(gen, (d,), dtype=F32), _randn(gen, (d,), dtype=F32)
    before = launch_counts().get("layernorm_f32", 0)
    got = layernorm(x, w, b)
    assert launch_counts()["layernorm_f32"] == before + 1
    f32_dense_check("layernorm_f32", got, layernorm_plain(x, w, b),
                    layernorm_plain(tf32_round(x), w, b), 1, b)


def _qkv_proj_f32_args(cuda, b, n, d):
    """Seeded operands of rows 5 and 6 at f32: ln_qkv's and
    proj_ls_residual's arguments."""
    gen = torch.Generator(device=cuda).manual_seed(b * n + d)
    heads, scale = d // 64, 64 ** -0.5
    x = _randn(gen, (b, n, d), dtype=F32)
    args = (x, _randn(gen, (d,), 0.1, 1.0, F32), _randn(gen, (d,), 0.1, 0.0, F32),
            _randn(gen, (3 * d, d), d ** -0.5, dtype=F32),
            _randn(gen, (3 * d,), 0.5, dtype=F32), heads, scale)
    o = _randn(gen, (b, n, heads, 64), dtype=F32)
    pargs = (o, x, _randn(gen, (d, d), d ** -0.5, dtype=F32),
             _randn(gen, (d,), 0.5, dtype=F32), _randn(gen, (d,), 0.1, 1.0, F32))
    return args, pargs


@pytest.mark.parametrize("b,n,d,hold_mean", [
    (1, 1, 384, False), (2, 37, 384, True), (8, 2443, 384, True),
    (2, 131, 768, True), (1, 70, 128, False)])
def test_ln_qkv_and_proj_f32_kernels_match_plain(cuda, b, n, d, hold_mean):
    """Rows 5 and 6 at f32 on the 3xTF32 core: ragged row tiles, vits'
    1080p rows; within the f32 bound of the plain versions on f64 operands
    (chip_smoke.f32_qkv_check, f32_proj_check: row 5's product stage on the
    chain's own LN rows, the whole within the bound), and on average at
    least as close to them as cuBLAS's f32 sums where ``hold_mean``; the
    TF32 product of the same operands (the weights rounded to TF32: cuBLAS
    may run a small product without TF32 whatever the flag says) fails the
    bound. At one row and at K = 128 cuBLAS's f32 product (another kernel
    at those shapes) is closer to f64 on average than the core's, whose
    tensor-core sums truncate (row 5 at one row 2.02 against 1.38 mean
    ulps, row 6 at 70 rows of K = 128 0.76 against 0.66, on an NVIDIA
    H100): there the comparison is logged, not held."""
    from chip_smoke import f32_proj_check, f32_qkv_check

    args, pargs = _qkv_proj_f32_args(cuda, b, n, d)
    f32_qkv_check("ln_qkv_f32", args, ln_qkv(*args), hold_mean)
    f32_proj_check("proj_ls_residual_f32", pargs, proj_ls_residual(*pargs),
                   hold_mean)


def test_ln_qkv_and_proj_f32_split_each_weight_once(cuda):
    """Rows 5 and 6 at f32 split their weight on the first call (one
    tf32x3_split each) and not on the second on the same weights, which
    gives the same output bit for bit."""
    args, pargs = _qkv_proj_f32_args(cuda, 2, 37, 384)
    for fn, a in ((ln_qkv, args), (proj_ls_residual, pargs)):
        splits = []
        outs = []
        for _ in range(2):
            before = launch_counts().get("tf32x3_split", 0)
            outs.append(fn(*a))
            splits.append(launch_counts()["tf32x3_split"] - before)
        assert splits == [1, 0], (fn.__name__, splits)
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("flash", [False, True], ids=["row2", "row17"])
@pytest.mark.parametrize("b,n,h", [(3, 33, 1), (2, 45, 2), (1, 1000, 6),
                                   (1, 4200, 2)])
def test_attention_f32_kernels_match_plain(cuda, flash, b, n, h):
    """Rows 2 and 17 at f32 on views into one qkv, ragged key tiles and
    query blocks, against the one-shot and the blocked flash plain
    versions within chip_smoke.py's bounds, which the result on q, k and v
    rounded to TF32 fails."""
    from chip_smoke import (ATTN_F32_MAX_REL, ATTN_F32_MEAN_REL,
                            f32_rel_check, tf32_round)

    gen = torch.Generator(device=cuda).manual_seed(n + h + flash)
    qkv = _randn(gen, (b, n, 3, h, 64), 2.0, dtype=F32)
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    if flash:
        args, fn, plain = (qkv[:, :, 0], k, v, 0.125), flash_attention, \
            flash_attention_plain
    else:
        args, fn, plain = ((qkv[:, :, 0] * 0.125).contiguous(), k, v), \
            attention, attention_plain
    tfw = plain(*(tf32_round(t) for t in args[:3]), *args[3:])
    f32_rel_check("attention_f32", fn(*args), plain(*args), tfw,
                  ATTN_F32_MAX_REL, ATTN_F32_MEAN_REL)


def test_attention_f32_kernels_hold_tf32_hgmma(cuda):
    """Both f32 attention kernels (rows 2 and 17) run their products as
    wgmma with TF32 operands (3xTF32), fed by TMA: the one-thread-a-row FFMA
    design is gone."""
    from vr_video_generator_tpu_torch.attention_bench import sass_counts

    counts = {name: c for name, c in sass_counts().items()
              if "attention_f32_kernel" in name}
    assert len(counts) == 2, counts
    for name, c in counts.items():
        assert c["HGMMA_TF32"] >= 48 and c["HGMMA_TF32"] == c["HGMMA"], (
            name, c)
        assert c["UTMALDG"] > 0, (name, c)


@pytest.mark.parametrize("b,h0,w0", [(1, 7, 11), (2, 37, 66), (8, 148, 264)])
def test_head_tail_ext_f32_kernel_matches_plain(cuda, b, h0, w0):
    """Row 7 at f32, C = 64, on an NCHW activation seen as NHWC, its
    products on the 3xTF32 core: the mix, conv1 + b1 and conv2's sums
    (conv3x3_f32, the same conv) within chip_smoke.py's f32 bound of the
    product on f64 operands (f32_exact_check, TF32 refused); the depth
    against its plain version relative to its range, a bound that the plain
    version on TF32-rounded input and conv weights fails."""
    from chip_smoke import (TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL, conv3x3_f64,
                            f32_exact_check, f32_rel_check, f64, tf32,
                            tf32_round)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(b * h0 + w0)
    c = 64
    x = _randn(gen, (b, c, h0, w0), dtype=F32).permute(0, 2, 3, 1)
    wts = _f32_tail_wts(gen, c)
    k_oc, _, k1, b1, k2 = wts[:5]
    out_hw = (h0 * 7 // 2, w0 * 7 // 2)
    got = ht.head_tail_ext_stages(x, *wts, out_hw)
    # cuBLAS keeps small f32 products at f32 with TF32 allowed: the mix's
    # TF32 result from TF32-rounded operands.
    tf_mix = ht.ext_mix_plain(tf32_round(x), tf32_round(k_oc))
    with tf32(True):
        tf_c1 = ht.ext_conv1_plain(got[1], k1, b1)
        tf_c2 = ht.conv3x3_f32_plain(got[3], k2)
    f32_exact_check("head_tail_ext_f32 mix", got[0],
                    ht.ext_mix_plain(*f64(x, k_oc)), ht.ext_mix_plain(x, k_oc),
                    tf_mix, 1)
    f32_exact_check("head_tail_ext_f32 conv1", got[2],
                    conv3x3_f64(got[1], k1) + b1.double(),
                    ht.ext_conv1_plain(got[1], k1, b1), tf_c1, 1, b1)
    f32_exact_check("head_tail_ext_f32 conv2", ht.conv3x3_f32(got[3], k2),
                    conv3x3_f64(got[3], k2), ht.conv3x3_f32_plain(got[3], k2),
                    tf_c2, 1)
    want = head_tail_ext_plain(x, *wts, out_hw)
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts]
    tfw = head_tail_ext_plain(tf32_round(x), *rounded, out_hw)
    span = (want.max() - want.min()).item()
    f32_rel_check("head_tail_ext_f32", head_tail_ext(x, *wts, out_hw), want,
                  tfw, TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL, span)


def test_vits_auto_f32_step_on_the_card(cuda):
    """vits auto at f32 on a small frame: exactly the f32 kernels a step
    (LayerNorm at 12 norm2s and 4 taps, rows 5, 2, 6 a block, row 7 once),
    no host sync in the step, the right half the input, and step_many's
    graph bit for bit equal to two eager steps."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vits", batch_size=2, compute_dtype="float32",
                    input_size=56)
    pipe = SbsPipeline.create(cfg, 150, 96, allow_random=True, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 2, 150, 96, 3), dtype=np.uint8)).to(cuda)
    state = pipe.initial_state()
    pipe.step(frames[0], state)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sbs, st1 = pipe.step(frames[0], state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == {"layernorm_f32": 16, "ln_qkv_f32": 12,
                      "attention_f32": 12, "proj_ls_residual_f32": 12,
                      "head_tail_ext_f32": 1, "warp_composite": 1,
                      "blur_select_sbs": 1}
    assert torch.equal(sbs[:, :, 96:], frames[0])
    sbs2, st2 = pipe.step(frames[1], st1)
    outs, st_g = pipe.step_many(frames, state)
    assert torch.equal(outs[0], sbs) and torch.equal(outs[1], sbs2)
    assert all(torch.equal(a, b) for a, b in zip(st_g, st2) if a is not None)


# --- f32 on the card: rows 8, 9, 11 and 12, row 7 at every width ----------

def _f32_mlp_args(gen, m, d):
    hid = 4 * d
    return (_randn(gen, (1, m, d), dtype=F32),
            _randn(gen, (d,), 0.1, 1.0, F32), _randn(gen, (d,), 0.1, 0.0, F32),
            _randn(gen, (hid, d), d ** -0.5, dtype=F32),
            _randn(gen, (hid,), 0.5, dtype=F32),
            _randn(gen, (d, hid), hid ** -0.5, dtype=F32),
            _randn(gen, (d,), 0.5, dtype=F32),
            _randn(gen, (d,), 0.1, 1.0, F32))


@pytest.mark.parametrize("approx", [False, True], ids=["exact", "tanh"])
@pytest.mark.parametrize("row,d,m", [(8, 128, 77), (8, 384, 300),
                                     (9, 768, 130), (9, 1024, 64)])
def test_mlp_f32_kernels_match_plain(cuda, row, d, m, approx):
    """Rows 8 (D = 128, 384) and 9 (D = 768, 1024) at f32 on the f32 chain
    (csrc/mlp_f32.cu), ragged row tiles, the A&S and the tanh GELU: within
    chip_smoke.py's f32 bound of the plain version, which the same function
    with the weights rounded to TF32 fails; one launch on the f32 counter."""
    from chip_smoke import f32_dense_check, tf32_round

    gen = torch.Generator(device=cuda).manual_seed(row * d + m + approx)
    args = _f32_mlp_args(gen, m, d)
    x, lnw, lnb, w1, b1, w2, b2, gamma = args
    fn = mlp_residual if row == 8 else mlp_residual_hblocked
    name = "mlp_residual_f32" if row == 8 else "mlp_residual_hblocked_f32"
    before = launch_counts().get(name, 0)
    got = fn(*args, approx=approx)
    assert launch_counts()[name] == before + 1
    tf_args = (x, lnw, lnb, tf32_round(w1), b1, tf32_round(w2), b2, gamma)
    f32_dense_check(name, got, mlp_residual_plain(*args, approx=approx),
                    mlp_residual_plain(*tf_args, approx=approx), 1, x,
                    gamma * b2)


def test_mlp_f32_entry_points_refuse_other_widths(cuda):
    """Row 8's f32 chain takes D = 128 and 384, row 9's 768 and 1024: the
    wrappers raise at another width and launch nothing."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    before = dict(launch_counts())
    with pytest.raises(ValueError):
        mlp_residual(*_f32_mlp_args(gen, 5, 768))
    with pytest.raises(ValueError):
        mlp_residual_hblocked(*_f32_mlp_args(gen, 5, 384))
    assert launch_counts() == before


def test_gelu_f32_epilogue_bit_for_bit(cuda):
    """The f32 fc1 epilogue's A&S GELU equals the eager f32 chain bit for
    bit on every bf16 value, a dense sweep and the flush to -0.0 near -5.7;
    its tanh GELU within 2 f32 ulps (chip_smoke.check_gelu_f32)."""
    from chip_smoke import check_gelu_f32

    res = check_gelu_f32(cuda)
    assert res["exact"]["differ"] == 0 and res["exact"]["values"] > 300000


def _f32_tail_wts(gen, c):
    c2 = c // 2
    return (_randn(gen, (c, c, 1, 1), c ** -0.5, dtype=F32),
            _randn(gen, (c,), 0.1, dtype=F32),
            _randn(gen, (c2, c, 3, 3), (9 * c) ** -0.5, dtype=F32),
            _randn(gen, (c2,), 0.1, dtype=F32),
            _randn(gen, (32, c2, 3, 3), (9 * c2) ** -0.5, dtype=F32),
            _randn(gen, (32,), 0.1, dtype=F32),
            _randn(gen, (1, 32, 1, 1), 32 ** -0.5, dtype=F32),
            _randn(gen, (1,), 0.1, 0.5, dtype=F32))


@pytest.mark.parametrize("big", [True, False], ids=["rows11_12", "row7"])
@pytest.mark.parametrize("c,b,h0,w0", [(64, 1, 4, 7), (128, 2, 5, 9),
                                       (256, 1, 9, 13), (384, 2, 4, 6)])
def test_f32_tails_at_every_width_match_plain(cuda, big, c, b, h0, w0):
    """Rows 11 and 12 at f32 (vrvg_head_tail_big_f32) and row 7 at f32 at C
    = 64-384, on an NCHW activation seen as NHWC, on grids of 4-9 rows
    (most of rows 11 and 12's conv1 rows are cw's edge rows), against their
    plain versions relative to the depth's range: a bound that the plain
    version on TF32-rounded input and conv weights fails."""
    from chip_smoke import (TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL,
                            f32_rel_check, tf32_round)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(c + h0 + big)
    x = _randn(gen, (b, c, h0, w0), dtype=F32).permute(0, 2, 3, 1)
    wts = _f32_tail_wts(gen, c)
    out_hw = (h0 * 7 // 2, w0 * 7 // 2)
    fn, plain, counter = (
        (ht.head_tail_big, ht.head_tail_big_plain, "head_tail_big_f32")
        if big else (head_tail_ext, head_tail_ext_plain, "head_tail_ext_f32"))
    want = plain(x, *wts, out_hw)
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts]
    tfw = plain(tf32_round(x), *rounded, out_hw)
    before = launch_counts().get(counter, 0)
    got = fn(x, *wts, out_hw)
    assert launch_counts()[counter] == before + 1
    span = (want.max() - want.min()).item()
    f32_rel_check(counter, got, want, tfw, TAIL_F32_MAX_REL,
                  TAIL_F32_MEAN_REL, span)


@pytest.mark.parametrize("encoder,mlp_fused,need", [
    ("vits", "fused", "mlp_residual_f32"),
    ("vitb", "auto", "mlp_residual_hblocked_f32")])
def test_fused_f32_step_on_the_card(cuda, encoder, mlp_fused, need):
    """vits fused and vitb auto at f32 on a small frame: the MLP half on its
    f32 chain in each of the 12 blocks (row 8 at vits, row 9 at vitb), only
    f32 kernels and the warp, no host sync in the step, the right half the
    input."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder=encoder, batch_size=2, compute_dtype="float32",
                    input_size=56, mlp_fused=mlp_fused, tail=mlp_fused)
    pipe = SbsPipeline.create(cfg, 150, 96, allow_random=True, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 150, 96, 3), dtype=np.uint8)).to(cuda)
    state = pipe.initial_state()
    pipe.step(frames, state)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sbs, _ = pipe.step(frames, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts[need] == 12
    assert all(k.endswith("_f32") or k in ("warp_composite", "blur_select_sbs")
               for k in counts)
    assert torch.equal(sbs[:, :, 96:], frames)


# --- f32 on the card: row 10 (vitg), rows 15 and 16 -------------------------

@pytest.mark.parametrize("m", [77, 300])
def test_swiglu_f32_kernel_matches_plain(cuda, m):
    """Row 10 at f32 on its chain (csrc/swiglu_f32.cu) at vitg's D = 1536,
    hidden 4096, a ragged row tile: within chip_smoke.py's f32 bound of the
    plain version, which the same function with w12 and w3 rounded to TF32
    fails; one launch on the f32 counter."""
    from chip_smoke import f32_dense_check, tf32_round
    from vr_video_generator_tpu_torch.ops.mlp import (swiglu_residual,
                                                       swiglu_residual_plain)

    gen = torch.Generator(device=cuda).manual_seed(m)
    d, hid = 1536, 4096
    args = (_randn(gen, (1, m, d), dtype=F32),
            _randn(gen, (d,), 0.1, 1.0, F32), _randn(gen, (d,), 0.1, 0.0, F32),
            _randn(gen, (2 * hid, d), d ** -0.5, dtype=F32),
            _randn(gen, (2 * hid,), 0.5, dtype=F32),
            _randn(gen, (d, hid), hid ** -0.5, dtype=F32),
            _randn(gen, (d,), 0.5, dtype=F32), _randn(gen, (d,), 0.1, 1.0, F32))
    x, lnw, lnb, w12, b12, w3, b3, gamma = args
    before = launch_counts().get("swiglu_residual_f32", 0)
    got = swiglu_residual(*args)
    assert launch_counts()["swiglu_residual_f32"] == before + 1
    tf_args = (x, lnw, lnb, tf32_round(w12), b12, tf32_round(w3), b3, gamma)
    f32_dense_check("swiglu_residual_f32", got, swiglu_residual_plain(*args),
                    swiglu_residual_plain(*tf_args), 1, x, gamma * b3)


def test_swiglu_f32_silu_epilogue_bit_for_bit(cuda):
    """The f32 gate epilogue's silu equals the plain f32 silu_mul on the card
    on every bf16 value, a dense sweep over [-110, 40] and seeded x2
    (chip_smoke.check_silu_f32)."""
    from chip_smoke import check_silu_f32

    res = check_silu_f32(cuda)
    assert all(r["differ"] == 0 for r in res.values())


@pytest.mark.parametrize("c,b,h2,w2", [(64, 2, 9, 14), (128, 1, 12, 20)])
def test_head_tail_f32_kernel_matches_plain(cuda, c, b, h2, w2):
    """Row 15 at f32 (vrvg_head_tail_f32, its convs on the 3xTF32 core) at
    vits' and vitb's widths on an NCHW path1 seen as NHWC, on grids whose
    tiles are ragged (W narrower than one 32-pixel box, H not a multiple of
    the 4-row tile): conv1 + b1 and conv2's sums (conv3x3_f32, the same
    conv) within chip_smoke.py's f32 bound of the conv on f64 operands
    (f32_exact_check; the conv on TF32-rounded operands refused), the
    resize pass within F32_MAX_ULPS of its plain version, the depth against
    head_tail_plain relative to its range, a bound that the plain version
    on TF32-rounded input and conv weights fails. Each call launches the
    kernel once; the first splits the two conv weights, the second
    nothing. On these few pixels cuDNN runs an f32 conv whose sums are
    closer to f64 on average than the core's truncating tensor-core sums
    (at C = 128 1.24 against 1.34 mean ulps on an H100), so the mean is
    logged, not held (hold_mean=False); chip_smoke.py phase 8 holds it at
    the paths' shapes."""
    from chip_smoke import (F32_MAX_ULPS, TAIL_F32_MAX_REL,
                            TAIL_F32_MEAN_REL, conv3x3_f64, f32_exact_check,
                            f32_rel_check, f32_ulps, tf32_round)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(c + h2)
    x = _randn(gen, (b, c, h2, w2), dtype=F32).permute(0, 2, 3, 1)
    wts = _f32_tail_wts(gen, c)[2:]
    k1, b1, k2 = wts[:3]
    out_hw = (h2 * 7 // 4, w2 * 7 // 4)
    counts = []
    for _ in range(2):
        before = dict(launch_counts())
        got = ht.head_tail_stages(x, *wts, out_hw)
        counts.append({k: launch_counts().get(k, 0) - before.get(k, 0)
                       for k in ("head_tail_f32", "tf32x3_split")})
    assert counts == [{"head_tail_f32": 1, "tf32x3_split": 2},
                      {"head_tail_f32": 1, "tf32x3_split": 0}]
    tf_c1 = ht.base_conv1_plain(tf32_round(x), tf32_round(k1), b1)
    tf_c2 = ht.conv3x3_f32_plain(tf32_round(got[1]), tf32_round(k2))
    print(f32_exact_check("head_tail_f32 conv1", got[0],
                          conv3x3_f64(x, k1) + b1.double(),
                          ht.base_conv1_plain(x, k1, b1), tf_c1, 1, b1,
                          hold_mean=False))
    assert f32_ulps(got[1], ht.ext_resize_plain(got[0], out_hw),
                    1).max().item() <= F32_MAX_ULPS
    print(f32_exact_check("head_tail_f32 conv2", ht.conv3x3_f32(got[1], k2),
                          conv3x3_f64(got[1], k2),
                          ht.conv3x3_f32_plain(got[1], k2), tf_c2, 1,
                          hold_mean=False))
    want = ht.head_tail_plain(x, *wts, out_hw)
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts]
    tfw = ht.head_tail_plain(tf32_round(x), *rounded, out_hw)
    span = (want.max() - want.min()).item()
    f32_rel_check("head_tail_f32", got[2], want, tfw, TAIL_F32_MAX_REL,
                  TAIL_F32_MEAN_REL, span)
    assert torch.equal(ht.head_tail(x, *wts, out_hw), got[2])


@pytest.mark.parametrize("c", [64, 128, 16, 96, 256, 384])
def test_rcu_pair_f32_kernel_matches_plain(cuda, c):
    """Row 16 at f32 (vrvg_rcu_conv_f32, four calls on the 3xTF32 core) at
    vits', vitb's, vitl's and vitg's widths, C = 16 zero-padded to 32 and
    96 on two 64-wide column tiles, on a small grid with a ragged last tile
    (W = 37): within chip_smoke.py's f32 bound of the chain on f64 operands
    (f32_exact_check, the chain on TF32-rounded inputs and weights refused)
    and of the plain chain; four launches on the f32 counter, and the
    weights split at the first call only."""
    from chip_smoke import f32_dense_check, f32_exact_check, rcu_conv_f64, tf32_round
    from vr_video_generator_tpu_torch.attic.refinenet_pre import (
        rcu_chain, refinenet_pre, refinenet_pre_plain)

    gen = torch.Generator(device=cuda).manual_seed(c + 16)
    rn0, path2 = (_randn(gen, (2, c, 9, 37), dtype=F32).permute(0, 2, 3, 1)
                  for _ in range(2))
    ws = []
    for _ in range(4):
        ws += [_randn(gen, (c, c, 3, 3), (9 * c) ** -0.5, dtype=F32),
               _randn(gen, (c,), 0.1, dtype=F32)]
    counts = []
    for _ in range(2):
        before = dict(launch_counts())
        got = refinenet_pre(rn0, path2, *ws)
        counts.append({k: launch_counts().get(k, 0) - before.get(k, 0)
                       for k in ("rcu_pair_f32", "tf32x3_split")})
    assert counts == [{"rcu_pair_f32": 4, "tf32x3_split": 4},
                      {"rcu_pair_f32": 4, "tf32x3_split": 0}]
    tfw = refinenet_pre_plain(tf32_round(rn0), tf32_round(path2),
                              *(tf32_round(w) if w.ndim == 4 else w
                                for w in ws))
    want = refinenet_pre_plain(rn0, path2, *ws)
    f32_dense_check("rcu_pair_f32", got, want, tfw, 1, rn0, path2)
    f32_exact_check("rcu_pair_f32 against f64", got,
                    rcu_chain(rcu_conv_f64, rn0, path2, *ws), want, tfw, 1,
                    rn0, path2)


def test_rcu_f32_entry_point_refuses_other_kinds(cuda):
    """vrvg_rcu_conv_f32's argument checks: C no multiple of 32, an input
    ReLU pass on a conv without ReLU, a ReLU with residuals or with a copy,
    no residual without ReLU: 1 (cudaErrorInvalidValue), nothing written,
    nothing launched."""
    from vr_video_generator_tpu_torch.kernels.build import library

    x = torch.zeros((1, 4, 4, 128), dtype=F32, device=cuda)
    out = torch.full_like(x, 5.0)
    p = x.data_ptr()
    for c, in_relu, relu, nres, out_relu in (
            (80, None, 1, 0, None), (64, p, 0, 1, None), (64, None, 1, 1, None),
            (64, None, 1, 0, p), (128, None, 0, 0, None), (128, None, 0, 3,
                                                           None)):
        err = library().vrvg_rcu_conv_f32(p, in_relu, p, p, p, p,
                                          out.data_ptr(), out_relu, 1, 4, 4,
                                          c, relu, nres, None)
        torch.cuda.synchronize()
        assert err == 1 and bool((out == 5.0).all())


def test_vitg_f32_step_on_the_card(cuda):
    """vitg fused at f32 on a small frame, cut to 4 blocks: the SwiGLU half
    on row 10's f32 chain in each block, only f32 kernels and the warp, no
    host sync in the step, the right half the input."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vitg", batch_size=2, compute_dtype="float32",
                    input_size=56, mlp_fused="fused", tail="fused")
    mcfg = dataclasses.replace(cfg.model(), depth=4,
                               intermediate_layers=(0, 1, 2, 3))
    model = build_model(mcfg, random_state_dict(mcfg, 0), F32, cuda,
                        tail="fused")
    pipe = SbsPipeline(model, 150, 96, run_cfg=cfg)
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 150, 96, 3), dtype=np.uint8)).to(cuda)
    state = pipe.initial_state()
    pipe.step(frames, state)
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sbs, _ = pipe.step(frames, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts["swiglu_residual_f32"] == 4
    assert all(k.endswith("_f32") or k in ("warp_composite", "blur_select_sbs")
               for k in counts)
    assert torch.equal(sbs[:, :, 96:], frames)


# --- rows 8, 9 and 10 at f32 on the 3xTF32 core: the weights' split ---------

@pytest.mark.parametrize("change", ["none", "in place", "load_state_dict",
                                    "new data", "inference tensor"])
def test_tf32x3_weight_split_once_and_after_a_change(cuda, change):
    """mlp.tf32x3_weight splits a weight on the card once (one
    vrvg_tf32x3_split launch) and hands back the kept planes at the next
    call; a weight changed in place (its version counter), reloaded by
    load_state_dict or given new data is split again, and an inference
    tensor (no version counter) at every call. The planes equal the plain
    split bit for bit, gated (row 10's w12) and plain."""
    from vr_video_generator_tpu_torch.ops import mlp

    gen = torch.Generator(device=cuda).manual_seed(5)
    lin = torch.nn.Linear(64, 2 * 200).to(cuda).requires_grad_(False)
    lin.weight.copy_(_randn(gen, (400, 64), dtype=F32))
    w = lin.weight
    if change == "inference tensor":
        with torch.inference_mode():
            w = w.clone()

    def split(hidden):
        before = launch_counts().get("tf32x3_split", 0)
        out = mlp.tf32x3_weight(w, hidden)
        return out, launch_counts()["tf32x3_split"] - before

    for hidden in (200, 0):
        first, n1 = split(hidden)
        again, n2 = split(hidden)
        assert n1 == 1 and n2 == (1 if change == "inference tensor" else 0)
        want = mlp.tf32x3_weight_plain(w.cpu(), hidden)
        assert torch.equal(again.cpu().view(torch.int32),
                           want.view(torch.int32))
    if change in ("none", "inference tensor"):
        return
    if change == "in place":
        w.mul_(-2.0)
    elif change == "load_state_dict":
        lin.load_state_dict({"weight": torch.ones_like(lin.weight),
                             "bias": lin.bias})
    else:
        lin.weight.data = lin.weight.data.flip(0).contiguous()
    w = lin.weight
    out, n = split(0)
    assert n == 1
    assert torch.equal(out.cpu().view(torch.int32),
                       mlp.tf32x3_weight_plain(w.cpu()).view(torch.int32))


def test_weights_split_before_step_many_capture(cuda):
    """vitg fused at f32, cut to 4 blocks, on a new pipeline: step_many's
    eager step splits each block's w12 and w3 and the ext tail's (row 7 at
    C = 384, the tail at --input_size 56) mix and two convs once (8 + 3
    launches) before its capture, the capture splits nothing (a replay
    launches no split), and a second replay splits nothing either."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vitg", batch_size=2, compute_dtype="float32",
                    input_size=56, mlp_fused="fused", tail="fused")
    mcfg = dataclasses.replace(cfg.model(), depth=4,
                               intermediate_layers=(0, 1, 2, 3))
    model = build_model(mcfg, random_state_dict(mcfg, 0), F32, cuda,
                        tail="fused")
    pipe = SbsPipeline(model, 150, 96, run_cfg=cfg)
    frames = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 2, 150, 96, 3), dtype=np.uint8)).to(cuda)
    reset_launch_counts()
    outs, st = pipe.step_many(frames, pipe.initial_state())
    torch.cuda.synchronize()
    assert launch_counts()["tf32x3_split"] == 8 + 3
    per_replay = dict(pipe._graphs[(2, 2)].launches)
    assert per_replay.get("tf32x3_split", 0) == 0
    assert per_replay["swiglu_residual_f32"] == 8
    reset_launch_counts()
    pipe.step_many(frames, st)
    torch.cuda.synchronize()
    assert launch_counts().get("tf32x3_split", 0) == 0
    assert launch_counts()["swiglu_residual_f32"] == 8


def test_tf32x3_gemm_kernels_hold_tf32_hgmma(cuda):
    """Rows 5, 6, 8, 9 and 10 at f32, and row 7's out_conv mix, run their
    products as wgmma with TF32 operands (3xTF32: twelve a stage), fed by
    TMA: no FFMA main loop is left (the qkv, proj, down products' and the
    mix's kernels, whose epilogues have no transcendental, hold no FFMA at
    all; fc1's and the gate's hold their GELU's and silu's)."""
    from vr_video_generator_tpu_torch.attention_bench import sass_counts

    counts = {name: c for name, c in sass_counts(("tf32x3_gemm",)).items()
              if "gemm_kernel" in name}
    # mlp_f32.cu: BiasGelu exact and tanh, LayerScaleResidual; swiglu_f32.cu:
    # SwigluGate, LayerScaleResidual; head_tail_big.cu: Store (row 7's mix);
    # qkv_f32.cu: QkvScale (row 5), LayerScaleResidual (row 6).
    assert len(counts) == 8, sorted(counts)
    assert sum("QkvScale" in name for name in counts) == 1, sorted(counts)
    for name, c in counts.items():
        assert c["HGMMA_TF32"] >= 12 and c["HGMMA_TF32"] == c["HGMMA"], (
            name, c)
        assert c["UTMALDG"] > 0, (name, c)
        if any(k in name for k in ("LayerScaleResidual", "5Store",
                                   "QkvScale")):
            assert c["FFMA"] == 0, (name, c)


# --- rows 11 and 12 at f32 on the 3xTF32 core: the convs ---------------------

@pytest.mark.parametrize("c,n,b,h,w", [
    (64, 32, 2, 9, 45), (128, 64, 2, 13, 70), (256, 128, 1, 6, 33),
    (384, 192, 2, 5, 40), (64, 32, 1, 37, 528), (192, 32, 2, 7, 61)],
    ids=["conv1 C=64", "conv1 C=128", "conv1 C=256", "conv1 C=384",
         "W=528", "conv2 C2=192"])
def test_conv3x3_f32_kernel_matches_f64(cuda, c, n, b, h, w):
    """The 3xTF32 core's implicit-GEMM conv (vrvg_conv3x3_f32, the convs of
    rows 11 and 12 at f32) at every tile width (n = 32, 64, 128, 192 on two
    96-wide tiles), ragged W (528 = 16.5 x 32 pixels) and H: within the f32
    bound of the conv on f64 operands, at least as close to it on average
    as cuDNN's f32 conv, its TF32 conv refused (chip_smoke.f32_exact_check);
    one launch a call."""
    from chip_smoke import conv3x3_f64, f32_exact_check, tf32
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(c + n + w)
    x = _randn(gen, (b, h, w, c), dtype=F32)
    k = _randn(gen, (n, c, 3, 3), (9 * c) ** -0.5, dtype=F32)
    before = launch_counts().get("conv3x3_f32", 0)
    got = ht.conv3x3_f32(x, k)
    assert launch_counts()["conv3x3_f32"] == before + 1
    plain = ht.conv3x3_f32_plain(x, k)
    with tf32(True):
        tfw = ht.conv3x3_f32_plain(x, k)
    f32_exact_check(f"conv3x3_f32 C={c} n={n}", got, conv3x3_f64(x, k), plain,
                    tfw, 1)


@pytest.mark.parametrize("c,h0,w0", [(64, 5, 264), (128, 4, 9), (256, 3, 11),
                                     (384, 4, 6)],
                         ids=["C=64 W2=528", "C=128", "C=256", "C=384"])
def test_head_tail_big_f32_kernel_matches_plain(cuda, c, h0, w0):
    """Rows 11 and 12 at f32 on the 3xTF32 core (one head_tail_big_f32
    launch, the weights split at the first call and not after), stage by
    stage: mid against the folded conv1 on f64 operands, the depth against
    head_tail_big_plain relative to its range (TF32 refused)."""
    from chip_smoke import (TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL, conv3x3_f64,
                            f32_exact_check, f32_rel_check, tf32)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(c + w0)
    x = _randn(gen, (2, c, h0, w0), dtype=F32).permute(0, 2, 3, 1)
    wts = _f32_tail_wts(gen, c)
    out_hw = (h0 * 7 // 2, w0 * 7 // 2)
    counts = []
    for _ in range(2):
        before = dict(launch_counts())
        got = ht.head_tail_big_stages(x, *wts, out_hw)
        counts.append({k: launch_counts()[k] - before.get(k, 0)
                       for k in ("head_tail_big_f32", "tf32x3_split")})
    assert counts == [{"head_tail_big_f32": 1, "tf32x3_split": 2},
                      {"head_tail_big_f32": 1, "tf32x3_split": 0}]
    k1f = ht.fold_conv1(wts[0], wts[2], F32)
    with tf32(True):
        tf_mid = ht.conv3x3_f32_plain(got[0], k1f)
    f32_exact_check(f"head_tail_big_f32 C={c} conv1", got[1],
                    conv3x3_f64(got[0], k1f),
                    ht.conv3x3_f32_plain(got[0], k1f), tf_mid, 1)
    want = ht.head_tail_big_plain(x, *wts, out_hw)
    with tf32(True):
        tfw = ht.head_tail_big_plain(x, *wts, out_hw)
    span = (want.max() - want.min()).item()
    f32_rel_check(f"head_tail_big_f32 C={c}", got[3], want, tfw,
                  TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL, span)


def test_big_tail_f32_split_before_step_many_capture(cuda):
    """vitg fused at f32 at --input_size 126 on 90 x 160 frames (the big-C
    tail at C = 384), cut to 4 blocks, on a new pipeline: step_many's eager step splits each
    block's w12 and w3 and the tail's two convs once (10 launches) before
    its capture; a replay runs rows 11 + 12 once and splits nothing; two
    replays equal two eager steps bit for bit."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vitg", batch_size=2, compute_dtype="float32",
                    input_size=126, mlp_fused="fused", tail="fused")
    mcfg = dataclasses.replace(cfg.model(), depth=4,
                               intermediate_layers=(0, 1, 2, 3))
    model = build_model(mcfg, random_state_dict(mcfg, 0), F32, cuda,
                        tail="fused")
    # 90 x 160 frames: the net's 126 x 224 input, refinenet1's 36 x 64
    # grid, where the planner takes the big-C tail.
    pipe = SbsPipeline(model, 90, 160, run_cfg=cfg)
    frames = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 2, 90, 160, 3), dtype=np.uint8)).to(cuda)
    reset_launch_counts()
    st0 = pipe.initial_state()
    outs, st = pipe.step_many(frames, st0)
    torch.cuda.synchronize()
    assert launch_counts()["tf32x3_split"] == 10
    per_replay = dict(pipe._graphs[(2, 2)].launches)
    assert per_replay.get("tf32x3_split", 0) == 0
    assert per_replay["head_tail_big_f32"] == 2
    eager, state = [], st0
    for i in range(2):
        sbs, state = pipe.step(frames[i], state)
        eager.append(sbs)
    assert all(torch.equal(o, e) for o, e in zip(outs, eager))
    reset_launch_counts()
    pipe.step_many(frames, st)
    torch.cuda.synchronize()
    assert launch_counts().get("tf32x3_split", 0) == 0
    assert launch_counts()["head_tail_big_f32"] == 2


def test_big_tail_f32_convs_hold_tf32_hgmma(cuda):
    """Rows 7, 11, 12 and 16 at f32 run their convs as wgmma with TF32
    operands (twelve a stage) fed by TMA: the 3xTF32 core's conv_kernel
    instantiations (Store and row 7's BiasStore on 32-, 64- and 96-wide
    tiles, n = 128 on two of 64; conv2 with DepthOut; row 16's three RcuEpi
    kinds on 64) hold TF32 HGMMA only, and no FFMA."""
    from vr_video_generator_tpu_torch.attention_bench import sass_counts

    counts = {name: c for name, c in sass_counts(("tf32x3_gemm",)).items()
              if "conv_kernel" in name}
    assert len(counts) == 10, sorted(counts)
    for name, c in counts.items():
        assert c["HGMMA_TF32"] >= 12 and c["HGMMA_TF32"] == c["HGMMA"], (
            name, c)
        assert c["UTMALDG"] > 0 and c["FFMA"] == 0, (name, c)


def test_rcu_ext_f32_products_hold_tf32_hgmma(cuda):
    """Rows 16, 7 and 15 at f32 on the 3xTF32 core: row 16's conv kernels
    (RcuEpi, in rcu_pair_f32.cu's library code), rows 7 and 15's conv1
    (BiasStore) and row 7's mix (gemm_kernel with Store, a fresh sum every
    16 of K: two groups of six products a stage) hold TF32 HGMMA only,
    UTMALDG loads and no FFMA; the library holds no kernel of the retired
    SIMT FFMA core (sgemm_kernel)."""
    from vr_video_generator_tpu_torch.attention_bench import sass_counts

    counts = sass_counts(("tf32x3_gemm", "sgemm"))
    rcu = [n for n in counts if "conv_kernel" in n and "RcuEpi" in n]
    conv1 = [n for n in counts if "conv_kernel" in n and "BiasStore" in n]
    mix = [n for n in counts if "gemm_kernel" in n and "tf32x3_gemm" in n
           and "5Store" in n and "Li16E" in n]
    assert (len(rcu), len(conv1), len(mix)) == (3, 3, 1), sorted(counts)
    for name in rcu + conv1 + mix:
        c = counts[name]
        assert c["HGMMA_TF32"] >= 12 and c["HGMMA_TF32"] == c["HGMMA"], (
            name, c)
        assert c["UTMALDG"] > 0 and c["FFMA"] == 0, (name, c)
    assert not [n for n in counts if "sgemm" in n], counts


def test_vits_auto_f32_split_before_step_many_capture(cuda):
    """vits auto at f32 on a small frame (row 7's ext tail at C = 64), on a
    new pipeline: step_many's eager step splits each block's qkv and proj
    weights (rows 5 and 6) and the ext tail's mix, conv1 and conv2 once (24
    + 3 launches) before its capture; a replay runs row 7 once a step and
    splits nothing; two replays equal two eager steps bit for bit; a second
    step_many splits nothing."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vits", batch_size=2, compute_dtype="float32",
                    input_size=56)
    pipe = SbsPipeline.create(cfg, 150, 96, allow_random=True, device=cuda)
    frames = torch.from_numpy(np.random.default_rng(23).integers(
        0, 256, (2, 2, 150, 96, 3), dtype=np.uint8)).to(cuda)
    reset_launch_counts()
    st0 = pipe.initial_state()
    outs, st = pipe.step_many(frames, st0)
    torch.cuda.synchronize()
    assert launch_counts()["tf32x3_split"] == 24 + 3
    per_replay = dict(pipe._graphs[(2, 2)].launches)
    assert per_replay.get("tf32x3_split", 0) == 0
    assert per_replay["head_tail_ext_f32"] == 2
    eager, state = [], st0
    for i in range(2):
        sbs, state = pipe.step(frames[i], state)
        eager.append(sbs)
    assert all(torch.equal(o, e) for o, e in zip(outs, eager))
    reset_launch_counts()
    pipe.step_many(frames, st)
    torch.cuda.synchronize()
    assert launch_counts().get("tf32x3_split", 0) == 0
    assert launch_counts()["head_tail_ext_f32"] == 2


# ------------------------------------------------------------ the model axis

def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")
    return [torch.device("cuda", i) for i in range(n)]


def test_nccl_all_reduce_and_broadcast(cuda):
    """With two cards or more: ``all_reduce_`` over one bf16 tensor a card
    (torch.cuda.nccl) leaves a + b on both, equal to the sum on one card;
    over two ranks a card it sums on each card first; ``broadcast_`` copies
    the first rank's tensor to every other."""
    from vr_video_generator_tpu_torch.parallel.collectives import (
        all_reduce_, broadcast_)

    c0, c1 = _cards(2)
    gen = torch.Generator(device=c0).manual_seed(5)
    a, b = (_randn(gen, (1000, 384)) for _ in range(2))
    want = a + b
    ts = [a.clone(), b.to(c1)]
    all_reduce_(ts)
    torch.cuda.synchronize(c0)
    torch.cuda.synchronize(c1)
    assert torch.equal(ts[0], want) and torch.equal(ts[1].to(c0), want)
    parts = [_randn(gen, (64, 128)) for _ in range(4)]
    ts = [parts[0].clone(), parts[1].clone(), parts[2].to(c1),
          parts[3].to(c1)]
    all_reduce_(ts)
    for t in ts:
        assert torch.equal(t.to(c0), (parts[0] + parts[1])
                           + (parts[2] + parts[3]))
    ts = [want.clone(), torch.empty_like(want), torch.empty_like(want, device=c1)]
    broadcast_(ts)
    for t in ts:
        assert torch.equal(t.to(c0), want)


def _group_pipes(cfg, h, w, meshes):
    """(the 1 x 1 SbsPipeline on cuda:0, a ShardedSbsPipeline a mesh of
    ``meshes``), one random model (numpy seed 0)."""
    from vr_video_generator_tpu_torch.parallel.sharded import \
        ShardedSbsPipeline
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    single = SbsPipeline.create(cfg, h, w, allow_random=True,
                                device=torch.device("cuda", 0))
    return single, [ShardedSbsPipeline(single.model, h, w, mesh,
                                       run_cfg=cfg) for mesh in meshes]


def _depth_mean_rel(got, want):
    return float((got.to(want.device) - want).abs().mean()
                 / (want.max() - want.min()))


def test_model_group_on_two_cards_matches_one_card(cuda):
    """vitl-518 ``--mlp_fused xla`` (both halves split, row 2 at 8 heads a
    rank) on a 1 x 2 group of two cards: its SBS and depth equal, bit for
    bit, to the same group on cuda:0 named twice (NCCL's two-rank bf16 sum
    is the card's add), and its depth within chip_smoke.py's mean bound of
    the kernel path against plain (DEPTH_REL of the range) of the 1 x 1
    pipeline's at equal batch."""
    from chip_smoke import DEPTH_REL
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh

    c0, c1 = _cards(2)
    cfg = RunConfig(encoder="vitl", batch_size=2, compute_dtype="bfloat16",
                    mlp_fused="xla", input_size=518)
    single, (two, one) = _group_pipes(
        cfg, 270, 480, [make_mesh((1, 2), devices=[c0, c1]),
                        make_mesh((1, 2), devices=[c0, c0])])
    assert [p.device for p in two.replicas[0].model.parameters()][-1] == c1
    frames = np.random.default_rng(9).integers(0, 256, (2, 270, 480, 3),
                                               dtype=np.uint8)
    got, _ = two.step(frames, two.initial_state())
    want, _ = one.step(frames, one.initial_state())
    assert torch.equal(got[0], want[0])
    d_two = two.replicas[0].depth_only(frames)
    assert torch.equal(d_two, one.replicas[0].depth_only(frames))
    assert _depth_mean_rel(d_two, single.depth_only(frames)) <= DEPTH_REL


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_sharded_model_groups_on_four_cards(cuda, shape):
    """With four cards: ``ShardedSbsPipeline`` on a mesh of every card
    (vitb, 12 heads) over two steps against the same mesh shape on cuda:0
    named four times, at ``auto`` (the attention half fused on whole
    weights, the MLP half on row 8 whole) and at ``--mlp_fused xla`` (both
    halves split). At 2 x 2 each slot's SBS and state are equal bit for
    bit: NCCL's two-rank bf16 sum is the card's add. At 1 x 4 NCCL's ring
    sums the four partials in its own order, which moves a bf16 sum by an
    ulp, so the group runs f32 there: the depth carry within 1e-5 of its
    range, >= 99.9% of the SBS values equal, the right half the input and
    the flags exact."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh

    every = _cards(4)
    d = shape[0]
    dtype = "bfloat16" if d == 2 else "float32"
    for mlp_fused in ("auto", "xla"):
        cfg = RunConfig(encoder="vitb", batch_size=2, compute_dtype=dtype,
                        mlp_fused=mlp_fused, input_size=252)
        mesh = make_mesh(shape, devices=every)
        _, (cards, one) = _group_pipes(
            cfg, 150, 256, [mesh, make_mesh(shape, devices=[cuda] * 4)])
        assert [r.model.devices for r in cards.replicas] == mesh.devices
        rng = np.random.default_rng(d)
        s_cards, s_one = cards.initial_state(), one.initial_state()
        for _ in range(2):
            frames = rng.integers(0, 256, (2 * d, 150, 256, 3),
                                  dtype=np.uint8)
            got, s_cards = cards.step(frames, s_cards)
            want, s_one = one.step(frames, s_one)
            for i in range(d):
                g, st = got[i].to(cuda), s_cards[i].map(lambda t: t.to(cuda))
                assert got[i].device == cards.devices[i]
                if d == 2:
                    assert torch.equal(g, want[i])
                    assert _states_equal(st, s_one[i])
                    continue
                frame = torch.from_numpy(frames[2 * i:2 * i + 2]).to(cuda)
                assert torch.equal(g[:, :, 256:], frame)
                assert (g == want[i]).float().mean() >= 0.999
                span = s_one[i].d_prev1.max() - s_one[i].d_prev1.min()
                assert (st.d_prev1 - s_one[i].d_prev1).abs().max() \
                    <= 1e-5 * span
                assert torch.equal(st.has_state, s_one[i].has_state)
                assert torch.equal(st.overflow, s_one[i].overflow)


def test_two_processes_two_cards_each(cuda, tmp_path):
    """With four cards: two processes of the CLI, each with two cards of its
    own (CUDA_VISIBLE_DEVICES), joined through --coordinator_address
    127.0.0.1:<port>, run --mesh 2x2 (vits: a slot a process, a model group
    of its two cards): subclips that cover every frame once and check,
    and each process's log."""
    import os
    import socket
    import subprocess
    import sys

    import cv2

    from vr_video_generator_tpu_torch.video.check import check_subclips

    _cards(4)
    frames = np.random.default_rng(4).integers(0, 256, (16, 150, 96, 3),
                                               dtype=np.uint8)
    video = str(tmp_path / "in.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                         (96, 150))
    for f in frames:
        vw.write(f[:, :, ::-1])
    vw.release()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sub = str(tmp_path / "S") + "/"
    procs = []
    for pid, cards in enumerate(("0,1", "2,3")):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards,
                   PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "vr_video_generator_tpu_torch.cli",
             "--device", "cuda", "--mesh", "2x2", "--VideoDir", video,
             "--OutputDir", str(tmp_path / "o.mkv"),
             "--DebugDir", str(tmp_path / "D") + "/", "--SubClipDir", sub,
             "--batch_size", "2", "--input_size", "56",
             "--Max_Frame_Count", "3", "--repair_mode", "1",
             "--writer_backend", "cv2", "--reader_backend", "cv2",
             "--allow_random_weights",
             "--coordinator_address", f"127.0.0.1:{port}",
             "--num_processes", "2", "--process_id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert check_subclips(sub) == []
    covered = []
    for name in os.listdir(sub):
        lo, hi = os.path.splitext(name)[0].split("_")
        covered += range(int(lo), int(hi) + 1)
    assert sorted(covered) == list(range(16))
    assert {"sharded_p0.txt", "sharded_p1.txt"} <= set(
        os.listdir(tmp_path / "D"))


def test_real_weights_runbook_f32_on_the_card(cuda, tmp_path):
    """The real-weights runbook at config 1's geometry (vits, 480 x 854)
    with its parity step at f32 on the card, on a stand-in vits .pth
    (seeded random weights at full width, the final head conv amplified):
    the scaler calibrated onto the target, the card's f32 depth within the
    golden bounds of the plain CPU path, the parity gate passed,
    ``all_pass``."""
    import json
    import os

    from chip_smoke import standin_checkpoints
    from vr_video_generator_tpu_torch import real_weights_runbook

    ckpt = standin_checkpoints(str(tmp_path / "ckpt"), ("vits",),
                               amplify=True)["vits"]
    out = tmp_path / "REPORT.json"
    rc = real_weights_runbook.main(
        ["--checkpoints_dir", os.path.dirname(ckpt), "--configs", "1",
         "--frames", "2", "--compute_dtype", "float32", "--device", "cuda",
         "--workdir", str(tmp_path / "work"), "--out", str(out)])
    artifact = json.loads(out.read_text())
    assert rc == 0 and artifact["all_pass"], artifact
    g = artifact["rows"][0]["golden_depth"]
    assert g["calibrated"] and g["under_step_cap"] and g["depth_ok"]
    assert abs(g["raw_depth_max"] * g["scaler_used"]
               - real_weights_runbook.CAL_TARGET_MAX) < 1e-6


@pytest.mark.parametrize("row,b,h,w", [(7, 2, 37, 66), (7, 1, 7, 11),
                                       (15, 2, 9, 14), (15, 1, 24, 40)])
def test_f32_tails_at_c32_match_plain(cuda, row, b, h, w):
    """Rows 7 and 15 at f32 at a 32-feature head's C = 32 (conv1's 16
    outputs and conv2's 16 inputs zero-padded to 32 in the chains) on an
    NCHW activation seen as NHWC: c1 and R come back as 16-channel views;
    conv1 + b1 and conv2's sums (on the core over the same zero padding,
    chip_smoke.core_conv_sums) within chip_smoke.py's f32 bound of the conv
    on f64 operands (f32_exact_check, TF32 refused; the mean logged, as at
    C = 64 on few pixels); the depth against the plain version relative to
    its range, a bound the plain version on TF32-rounded operands fails;
    one launch on the f32 counter, splitting 3 (row 7) or 2 (row 15)
    weights at the first call and none at the second."""
    from chip_smoke import (TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL, conv3x3_f64,
                            core_conv_sums, f32_exact_check, f32_rel_check,
                            tf32_round)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(row + h * w)
    c = 32
    x = _randn(gen, (b, c, h, w), dtype=F32).permute(0, 2, 3, 1)
    wts = _f32_tail_wts(gen, c)
    if row == 15:
        wts = wts[2:]
        out_hw = (h * 7 // 4, w * 7 // 4)
        stages, whole, plain = ht.head_tail_stages, ht.head_tail, \
            ht.head_tail_plain
        counter, splits = "head_tail_f32", 2
    else:
        out_hw = (h * 7 // 2, w * 7 // 2)
        stages, whole, plain = ht.head_tail_ext_stages, ht.head_tail_ext, \
            ht.head_tail_ext_plain
        counter, splits = "head_tail_ext_f32", 3
    k1, b1, k2 = wts[-6:-3]
    counts = []
    for _ in range(2):
        before = dict(launch_counts())
        got = stages(x, *wts, out_hw)
        counts.append({k: launch_counts().get(k, 0) - before.get(k, 0)
                       for k in (counter, "tf32x3_split")})
    assert counts == [{counter: 1, "tf32x3_split": splits},
                      {counter: 1, "tf32x3_split": 0}]
    z, c1, r = (x, got[0], got[1]) if row == 15 else got[1:4]
    assert c1.shape[-1] == r.shape[-1] == 16
    conv1 = ht.base_conv1_plain if row == 15 else ht.ext_conv1_plain
    print(f32_exact_check(f"row {row} f32 C=32 conv1", c1,
                          conv3x3_f64(z, k1) + b1.double(),
                          conv1(z, k1, b1),
                          conv1(tf32_round(z), tf32_round(k1), b1), 1, b1,
                          hold_mean=False))
    print(f32_exact_check(f"row {row} f32 C=32 conv2", core_conv_sums(r, k2),
                          conv3x3_f64(r, k2), ht.conv3x3_f32_plain(r, k2),
                          ht.conv3x3_f32_plain(tf32_round(r),
                                               tf32_round(k2)), 1,
                          hold_mean=False))
    want = plain(x, *wts, out_hw)
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts]
    tfw = plain(tf32_round(x), *rounded, out_hw)
    span = (want.max() - want.min()).item()
    f32_rel_check(f"row {row} f32 C=32", got[-1], want, tfw,
                  TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL, span)
    assert torch.equal(whole(x, *wts, out_hw), got[-1])


# A custom head's DPT tail at widths the chains run zero-padded
# (ops/head_tail.chain_widths; chip_smoke.py phase 13 at full size): bf16
# stage by stage on small grids, and the same bits from a contiguous NHWC x
# (the transpose kernel copies it with its zero padding, layout 2) and a
# channel slice of a wider tensor as from the NCHW activation.
@pytest.mark.parametrize("row,c", [("ext", 16), ("ext", 48), ("ext", 144),
                                   ("big", 80), ("big", 512), ("base", 16),
                                   ("base", 96)])
def test_tails_at_padded_widths_match_plain(cuda, row, c):
    from chip_smoke import (base_tail_stages, big_tail_stages,
                            ext_tail_stages, tail_weights)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(c + 31)
    h, w = (26, 42) if row == "base" else (13, 21)
    x = _randn(gen, (2, c, h, w)).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)
    args = wts[2:] if row == "base" else wts
    out_hw = (45, 73)
    {"ext": ext_tail_stages, "big": lambda *a: big_tail_stages(*a)[0],
     "base": base_tail_stages}[row](f"C={c}", x, args, out_hw)
    fn = {"ext": ht.head_tail_ext, "big": ht.head_tail_big,
          "base": ht.head_tail}[row]
    want = fn(x, *args, out_hw)
    wide = torch.zeros((2, h, w, c + 32), dtype=x.dtype, device=cuda)
    wide[..., 32:] = x
    for view in (x.contiguous(), wide[..., 32:]):
        assert torch.equal(fn(view, *args, out_hw), want)


@pytest.mark.parametrize("row,c", [("ext", 48), ("big", 80), ("base", 16)])
def test_f32_tails_at_padded_widths_match_plain(cuda, row, c):
    """Rows 7, 11 + 12 and 15 at f32 at a custom head's C = 48 (run as 64,
    C2 = 32), 80 (96, 64) and 16 (32, 32): the stages come back as views of
    the head's channels; the depth against the plain version within
    chip_smoke.py's f32 tail bounds, refusing the plain version on
    TF32-rounded operands; a contiguous NHWC x gives the same bits."""
    from chip_smoke import (TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL,
                            f32_rel_check, tf32_round)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=cuda).manual_seed(c + 37)
    h, w = (24, 40) if row == "base" else (12, 22)
    x = _randn(gen, (2, c, h, w), dtype=F32).permute(0, 2, 3, 1)
    wts = _f32_tail_wts(gen, c)
    if row == "base":
        wts = wts[2:]
    out_hw = (h * 7 // 4, w * 7 // 4) if row == "base" else \
        (h * 7 // 2, w * 7 // 2)
    stages, whole, plain = {
        "ext": (ht.head_tail_ext_stages, ht.head_tail_ext,
                ht.head_tail_ext_plain),
        "big": (ht.head_tail_big_stages, ht.head_tail_big,
                ht.head_tail_big_plain),
        "base": (ht.head_tail_stages, ht.head_tail, ht.head_tail_plain)}[row]
    got = stages(x, *wts, out_hw)
    widths = {"ext": (c, c, c // 2, c // 2), "big": (c, c // 2, c // 2),
              "base": (c // 2, c // 2)}[row]
    assert tuple(t.shape[-1] for t in got[:-1]) == widths
    want = plain(x, *wts, out_hw)
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts]
    tfw = plain(tf32_round(x), *rounded, out_hw)
    span = (want.max() - want.min()).item()
    f32_rel_check(f"{row} f32 C={c}", got[-1], want, tfw, TAIL_F32_MAX_REL,
                  TAIL_F32_MEAN_REL, span)
    assert torch.equal(whole(x.contiguous(), *wts, out_hw), got[-1])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vits_xla_group_1x4_on_one_card_matches_1x1(cuda, dtype):
    """vits ``--mlp_fused xla`` on a 1 x 4 model group on one card (ranks of
    1, 2, 1 and 2 of the 6 heads, both halves split): a step launches the
    attention 12 x 4 times and LayerNorm 24 x 4 + 4; its SBS's right half is
    the input; its depth against the 1 x 1 pipeline's within chip_smoke.py's
    mean bound of the kernel path against plain (DEPTH_REL of the range) in
    bf16, within GROUP_F32_REL of the range at its largest in f32."""
    from chip_smoke import DEPTH_REL, GROUP_F32_REL
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.kernels import reset_launch_counts
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh

    cfg = RunConfig(encoder="vits", batch_size=2, compute_dtype=dtype,
                    mlp_fused="xla", input_size=518)
    single, (group,) = _group_pipes(
        cfg, 270, 480, [make_mesh((1, 4), devices=[cuda] * 4)])
    assert [b.pretrained.blocks[0].attn.num_heads
            for b in group.replicas[0].model.ranks] == [1, 2, 1, 2]
    frames = np.random.default_rng(29).integers(0, 256, (2, 270, 480, 3),
                                                dtype=np.uint8)
    group.step(frames, group.initial_state())
    torch.cuda.synchronize()
    reset_launch_counts()
    sbs, _ = group.step(frames, group.initial_state())
    torch.cuda.synchronize()
    counts = launch_counts()
    f32 = "_f32" if dtype == "float32" else ""
    assert counts[f"attention{f32}"] == 12 * 4
    assert counts[f"layernorm{f32}"] == 24 * 4 + 4
    assert torch.equal(sbs[0][:, :, 480:].cpu(), torch.from_numpy(frames))
    got, want = group.replicas[0].depth_only(frames), \
        single.depth_only(frames)
    span = float(want.max() - want.min())
    if dtype == "bfloat16":
        assert _depth_mean_rel(got, want) <= DEPTH_REL
    else:
        assert float((got - want).abs().max()) <= GROUP_F32_REL * span


# --- the encoder at every width (csrc/attention_any.cu; rows 5, 6, 8, 9,
# 10 at a custom ModelConfig's widths) ------------------------------------

# Kernel 1 at head dims other than 64 (an odd one among them: rows only
# 2-byte aligned), row 2 at N = 333 and row 17 at N = 4200 (the library's
# 512-key blocks), bf16 within rows 2 and 17's bounds of the plain version,
# f32 within chip_smoke.py's ATTN_ANY_F32_* of the f64 function, the TF32
# result refused (chip_smoke.check_attention_any).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [16, 20, 32, 48, 128, 256])
@pytest.mark.parametrize("flash", [False, True], ids=["row2", "row17"])
def test_attention_any_matches_plain(cuda, flash, d, dtype):
    from chip_smoke import check_attention_any

    gen = torch.Generator(device=cuda).manual_seed(d)
    n = 4200 if flash else 333
    check_attention_any(gen, flash, d, 2, 2, n, dtype, timed=False)


# Above 256 (two consumers a q group, each with its own S; past 512 a grid
# axis of column blocks and, at bf16 past 576, Q streamed with K in slabs):
# row 2 at N = 333, row 17 at N = 4200 at the head dims the library flash
# kernel takes there.
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("flash,d", [(False, 257), (False, 320),
                                     (False, 512), (True, 384), (True, 512),
                                     (False, 600), (True, 1024)],
                         ids=["row2-257", "row2-320", "row2-512",
                              "row17-384", "row17-512", "row2-600",
                              "row17-1024"])
def test_attention_any_wide_matches_plain(cuda, flash, d, dtype):
    from chip_smoke import check_attention_any

    gen = torch.Generator(device=cuda).manual_seed(d)
    n = 4200 if flash else 333
    check_attention_any(gen, flash, d, 2, 2, n, dtype, timed=False)


def test_flash_any_refuses_the_library_head_dims(cuda):
    """Row 17 at head dim 320: past 4096 tokens NotImplementedError before
    any launch, from the wrapper, and cudaErrorInvalidValue from the entry
    point; with one K block (N = 333) it runs."""
    from chip_smoke import attention_stats
    from vr_video_generator_tpu_torch.kernels.build import library
    from vr_video_generator_tpu_torch.ops.attention import (
        flash_attention, flash_attention_plain)

    gen = torch.Generator(device=cuda).manual_seed(320)
    q = _randn(gen, (1, 4200, 1, 320))
    before = launch_counts()
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        flash_attention(q, q, q, 0.05)
    assert launch_counts() == before
    o = torch.full_like(q, 3.0)
    err = library().vrvg_attention_any(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), 1, 4200, 1,
        320, q.stride(0), q.stride(1), q.stride(0), q.stride(1),
        q.stride(0), q.stride(1), o.stride(0), o.stride(1), 0.05, 1, 0, None,
        None)
    torch.cuda.synchronize()
    assert err == 1 and bool((o == 3.0).all())
    q = q[:, :333]
    attention_stats("flash_attention_any Dh=320 N=333",
                    flash_attention(q, q, q, 0.05),
                    flash_attention_plain(q, q, q, 0.05))


def test_attention_head_dim_64_keeps_its_kernels(cuda):
    """Head dim 64 still runs csrc/attention.cu and csrc/attention_f32.cu,
    never csrc/attention_any.cu."""
    gen = torch.Generator(device=cuda).manual_seed(64)
    for dtype, name in ((torch.bfloat16, "attention"),
                        (torch.float32, "attention_f32")):
        q, k, v = (_randn(gen, (2, 70, 3, 64), dtype=dtype) for _ in range(3))
        before = launch_counts()
        attention(q, k, v)
        after = launch_counts()
        assert after[name] == before.get(name, 0) + 1
        assert after.get("attention_any", 0) == before.get("attention_any", 0)
        assert after.get("attention_any_f32", 0) == \
            before.get("attention_any_f32", 0)


# Rows 5 and 6 at D = 512 (8 heads of 64), 640 (10) and 768 with 6 heads of
# 128, at 1080p/518's rows: chip_smoke.py phase 12 (b)'s checks (bf16 by
# the dense rows' bounds, f32 against f64 operands, TF32 refused).
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("d,heads", [(512, 8), (640, 10), (768, 6)])
def test_ln_qkv_and_proj_at_new_widths(cuda, d, heads, dtype):
    from chip_smoke import check_qkv_width

    gen = torch.Generator(device=cuda).manual_seed(d + heads)
    check_qkv_width(gen, d, heads, dtype)


# Row 8 at D = 512 (hidden 2048, resident), row 9 at D = 640 with hidden
# 2080 (mlp_ratio 3.25, zero-padded to 2112), row 10 at D = 1024 (hidden
# 2736, padded to 2816 at bf16 and 2752 at f32), whole and stage by stage.
@pytest.mark.parametrize("row", [8, 9, 10])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_mlp_halves_at_new_widths(cuda, row, dtype):
    import chip_smoke as cs

    from vr_video_generator_tpu_torch.ops.mlp import swiglu_hidden

    gen = torch.Generator(device=cuda).manual_seed(row)
    m = cs.B * cs.N_TOK
    if row == 10:
        hid = swiglu_hidden(1024)
        if dtype == torch.float32:
            cs.f32_swiglu_check(gen, m, 1024, hid)
        else:
            cs.check_swiglu(gen, 1024, hid, m)
        return
    d, hid = (512, 2048) if row == 8 else (640, 2080)
    if dtype == torch.float32:
        cs.f32_mlp_check(gen, row, d, m, hid)
    else:
        key = "mlp_residual" if row == 8 else "mlp_residual_hblocked"
        cs.check_mlp_chain(row, key, cs.mlp_args(gen, m, d, hid=hid), True)


# Two of chip_smoke.py phase 12's custom configurations through
# SbsPipeline.step at 1080p: exactly their kernels a step, the depth
# against the plain path.
@pytest.mark.parametrize("label", ["r325-518", "hd32-728 f32"])
def test_custom_width_paths(cuda, label):
    import chip_smoke as cs

    row = next(r for r in cs.WIDTH_RUNS if r[0] == label)
    frames = np.random.default_rng(0).integers(
        0, 256, (cs.B, cs.H, cs.W, 3), dtype=np.uint8)
    cs.width_run(cuda, frames, row)
