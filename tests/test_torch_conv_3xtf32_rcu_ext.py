"""PyTorch port, rows 16 and 7 at f32 on the 3xTF32 wgmma core
(csrc/tf32x3_gemm.cuh): refinenet1's RCU pair's four convs
(csrc/rcu_pair_f32.cu, RcuEpi) and the ext DPT tail's out_conv mix and conv1
(csrc/head_tail_big.cu vrvg_head_tail_ext_f32: the dense product with
Store, the conv with BiasStore; its conv2 with the 1x1 is row 12's,
tests/test_torch_conv_3xtf32.py), their arithmetic on the CPU.

The kernels (TMA, mbarriers, wgmma) run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8). What they compute is
held here, with g++ building csrc/tf32x3.cuh and csrc/epilogue_f32.cuh as
they are:
(a) the epilogues' per-element functions (vrvg::rcu_out_f32 for the RCU
    chain's three kinds, vrvg::relu_copy_f32 for conv2a's copy,
    vrvg::bias_f32 for row 7's conv1) equal rcu_conv_plain's and
    ext_conv1_plain's epilogues bit for bit: each plain version run on a
    conv whose only non-zero weight is the centre tap's identity, so that
    its sums are the given values exactly;
(b) tests/test_torch_gemm_3xtf32.py's model of the core (A and the split
    weights split by tf32x3::split, a fresh truncating tensor-core sum of
    each 32-wide stage, the stages added in f32 in the kernel's order) on
    the im2col of each RCU conv at C = 64 and 128 (N = C, the epilogue by
    (a)'s functions) lies within chip_smoke.py's f32 bound (F32_MAX_ULPS,
    f32_exact_check) of rcu_conv_plain on f64 operands, and the same model
    on TF32 operands does not; row 7's conv1 + b1 likewise against
    ext_conv1_plain on f64 operands;
(c) the four convs chained through that model (the ReLU pass, conv2a's
    ReLU'd copy read by conv1b) hold against refinenet_pre_plain on f64
    operands within the same bound;
(d) row 7's out_conv mix through the dense model (a fresh sum every 16
    of K) at C = 64, 128, 256 and 384 holds against ext_mix_plain on f64
    operands, TF32 refused;
(e) the split planes the wrappers keep (attic/refinenet_pre._rcu_weights at
    f32, ops/head_tail._ext_f32_weights) are the header's split() of each
    weight in the k order the kernels read.
Needs g++ (C++20).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import F32_MAX_ULPS, f32_exact_check, f32_ulps, f64, tf32_round
from tests.test_torch_conv_3xtf32 import CK, unfold_rows
from tests.test_torch_gemm_3xtf32 import core_sums
from vr_video_generator_tpu_torch.attic import refinenet_pre as rp
from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops import mlp

torch.set_num_threads(2)
torch.set_grad_enabled(False)

EMU_DIR = Path(__file__).resolve().parent / "cuda_emu"
UNIT = """#include <cuda_runtime.h>
namespace {
alignas(16) unsigned char smem[16];
}
namespace emu {
static unsigned char* shared_memory() { return smem; }
}
#include "tf32x3.cuh"
#include "epilogue_f32.cuh"
extern "C" void split_many(const uint32_t* x, uint32_t* hi, uint32_t* lo,
                           long n) {
  for (long i = 0; i < n; ++i) {
    tf32x3::split(tf32x3::from_bits(x[i]), hi[i], lo[i]);
  }
}
// kind 0: ReLU, no residual (conv1a, conv1b); 2: two residuals (conv2a);
// 1: one (conv2b). copy: relu_copy_f32 of each output.
extern "C" void rcu_out_many(const float* s, const float* b, const float* r0,
                             const float* r1, float* out, float* copy,
                             long n, int kind) {
  for (long i = 0; i < n; ++i) {
    const float o =
        kind == 0 ? vrvg::rcu_out_f32<true, 0>(s[i], b[i], r0[i], r1[i])
        : kind == 2 ? vrvg::rcu_out_f32<false, 2>(s[i], b[i], r0[i], r1[i])
                    : vrvg::rcu_out_f32<false, 1>(s[i], b[i], r0[i], r1[i]);
    out[i] = o;
    copy[i] = vrvg::relu_copy_f32(o);
  }
}
extern "C" void bias_many(const float* s, const float* b, float* out,
                          long n) {
  for (long i = 0; i < n; ++i) out[i] = vrvg::bias_f32(s[i], b[i]);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/epilogue_f32.cuh")
    tmp = tmp_path_factory.mktemp("conv_3xtf32_rcu_ext")
    (tmp / "unit.cpp").write_text(UNIT)
    so = tmp / "libconv_3xtf32_rcu_ext.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", "-w", f"-I{CSRC_DIR}", f"-I{EMU_DIR}",
         str(tmp / "unit.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    P, L, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    out.split_many.argtypes = [P, P, P, L]
    out.rcu_out_many.argtypes = [P] * 6 + [L, I]
    out.bias_many.argtypes = [P] * 3 + [L]
    for fn in (out.split_many, out.rcu_out_many, out.bias_many):
        fn.restype = None
    return out


def seeded(rng, shape, scale=1.0, shift=0.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale + shift).astype(np.float32))


# The chain's three kinds: (ReLU, residuals), the g++ unit's kind.
KINDS = {"conv1": (True, 0), "conv2a": (False, 2), "conv2b": (False, 1)}


def rcu_epilogue(lib, sums, b, kind, residuals=()):
    """RcuEpi's arithmetic on the sums (B, H, W, C) through the g++ unit:
    (out, its ReLU'd copy)."""
    s = sums.contiguous()
    zero = torch.zeros_like(s)
    r = [t.contiguous() for t in residuals] + [zero] * (2 - len(residuals))
    bias = b.expand_as(s).contiguous()
    out, copy = torch.empty_like(s), torch.empty_like(s)
    lib.rcu_out_many(s.data_ptr(), bias.data_ptr(), r[0].data_ptr(),
                     r[1].data_ptr(), out.data_ptr(), copy.data_ptr(),
                     s.numel(), KINDS[kind][1])
    return out, copy


def bias_epilogue(lib, sums, b):
    """BiasStore's arithmetic on the sums (..., N) through the g++ unit."""
    s = sums.contiguous()
    bias = b.expand_as(s).contiguous()
    out = torch.empty_like(s)
    lib.bias_many(s.data_ptr(), bias.data_ptr(), out.data_ptr(), s.numel())
    return out


def centre_identity(n: int, c: int) -> torch.Tensor:
    """(n, c, 3, 3) weights whose only non-zero taps are the centre's
    identity: the conv of x is x's first n channels, exactly."""
    k = torch.zeros((n, c, 3, 3))
    k[torch.arange(n), torch.arange(n), 1, 1] = 1.0
    return k


# --- (a) the epilogues' functions --------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_rcu_epilogue_is_the_plain_epilogue(lib, kind):
    """(a) rcu_out_f32 for each of the chain's kinds, on sums of both signs
    and spreads (a third of them tiny beside the bias), equals
    rcu_conv_plain on a centre-identity conv bit for bit: + bias, the ReLU
    (conv1a, conv1b; their input already relu'd, as the ReLU pass leaves
    it), the residuals added in order (rn0 then path2; t). The copy is
    relu_copy_f32 of the output, bit for bit the ReLU of it."""
    rng = np.random.default_rng(len(kind))
    relu, nres = KINDS[kind]
    c = 64
    s = seeded(rng, (2, 5, 7, c), 3.0)
    s[..., ::3] *= 1e-4
    if relu:
        s = torch.where(s > 0, s, torch.zeros_like(s))
    b = seeded(rng, (c,), 1.0)
    res = tuple(seeded(rng, s.shape, 2.0) for _ in range(nres))
    got, copy = rcu_epilogue(lib, s, b, kind, res)
    want = rp.rcu_conv_plain(s, centre_identity(c, c), b, relu, res,
                             relu_done=relu)
    assert torch.equal(got, want)
    assert torch.equal(copy, F.relu(got)) and bool((copy >= 0).all())
    # A sequential f32 model of the same steps.
    seq = b + s
    if relu:
        seq = F.relu(seq)
    for r in res:
        seq = seq + r
    assert torch.equal(got, seq)
    if relu:
        assert 0.2 < (got == 0).float().mean().item() < 0.9


def test_bias_store_is_ext_conv1_plain_epilogue(lib):
    """(a) bias_f32 (row 7's conv1 at f32, BiasStore) on sums of both signs
    equals ext_conv1_plain's f32 sums + b1 on a centre-identity conv (C =
    64 -> C2 = 32) and a sequential f32 add, bit for bit."""
    rng = np.random.default_rng(7)
    z = seeded(rng, (2, 6, 9, 64), 2.0)
    b1 = seeded(rng, (32,), 0.5)
    s = z[..., :32]
    got = bias_epilogue(lib, s, b1)
    assert torch.equal(got, ht.ext_conv1_plain(z, centre_identity(32, 64),
                                               b1))
    assert torch.equal(got, s + b1)


# --- (b) the convs through the model of the core -----------------------------

def model_conv_sums(x, k, products="3xtf32"):
    """The 3xTF32 core's sums of the 3x3 conv of x (B, H, W, C) by k (N, C,
    3, 3): the model on the im2col, in the kernel's stage order (each
    32-channel slice's nine taps), k split as the wrapper splits it."""
    b, h, w, c = x.shape
    n = k.shape[0]
    planes = ht._conv_split(k)
    order = torch.tensor([tap * c + cs * CK + j for cs in range(c // CK)
                          for tap in range(9) for j in range(CK)])
    sums = core_sums(unfold_rows(x)[:, order], planes[:, :, order], products)
    return sums[:, :n].reshape(b, h, w, n)


def model_rcu_conv(lib, products="3xtf32"):
    """rcu_conv's call on the card, modelled: the ReLU pass (relu_kernel:
    -0 and NaN to +0), the core's sums, RcuEpi by the g++ unit."""
    def conv(x, k, b, relu, residuals=(), relu_done=False,
             relu_copy=False):
        if relu and not relu_done:
            x = torch.where(x > 0, x, torch.zeros_like(x))
        kind = "conv1" if relu else ("conv2a" if len(residuals) == 2
                                     else "conv2b")
        out, copy = rcu_epilogue(lib, model_conv_sums(x, k, products), b,
                                 kind, residuals)
        return (out, copy) if relu_copy else out
    return conv


def rcu_case(c: int):
    """rn0, path2 (2 frames of 7 x 11, a ragged W) and the four convs'
    weights and biases at refinenet1's scales."""
    rng = np.random.default_rng(c + 16)
    shape = (2, 7, 11, c)
    rn0, path2 = seeded(rng, shape), seeded(rng, shape)
    ws = []
    for _ in range(4):
        ws += [seeded(rng, (c, c, 3, 3), (9 * c) ** -0.5),
               seeded(rng, (c,), 0.1)]
    return rn0, path2, ws


def chain_steps(rn0, path2, ws):
    """The four calls of the plain chain: (args, kwargs) each, on the plain
    chain's own inputs and residuals."""
    steps = []

    def record(*args, **kw):
        steps.append((args, kw))
        return rp.rcu_conv_plain(*args, **kw)

    rp.rcu_chain(record, rn0, path2, *ws)
    return steps


RCU_CONVS = [(c, i) for c in (64, 128) for i in range(4)]
RCU_NAMES = ("conv1a", "conv2a", "conv1b", "conv2b")
RCU_IDS = [f"C={c} {RCU_NAMES[i]}" for c, i in RCU_CONVS]


@pytest.mark.parametrize("c,i", RCU_CONVS, ids=RCU_IDS)
def test_rcu_conv_model_within_the_f32_bounds(lib, c, i):
    """(b) Conv i of the chain, on the plain chain's own input and
    residuals, through the model of the core and RcuEpi: within
    F32_MAX_ULPS of rcu_conv_plain on f64 operands (a scale taking in the
    sum of the conv's terms' magnitudes, the bias and the residuals), at
    least as close on average as the f32 plain conv; the plain conv on
    TF32-rounded weights refused (chip_smoke.f32_exact_check). conv2a's
    copy is the ReLU of its output bit for bit."""
    rn0, path2, ws = rcu_case(c)
    args, kw = chain_steps(rn0, path2, ws)[i]
    x, k, b, relu = args[:4]
    res = args[4] if len(args) > 4 else ()
    got = model_rcu_conv(lib)(*args, **kw)
    exact = rp.rcu_conv_plain(*f64(x, k, b), relu, f64(*res),
                              kw.get("relu_done", False))
    plain = rp.rcu_conv_plain(*args, **kw)
    tf = rp.rcu_conv_plain(x, tf32_round(k), b, relu, res,
                           kw.get("relu_done", False), kw.get("relu_copy",
                                                              False))
    if kw.get("relu_copy"):
        assert torch.equal(got[1], F.relu(got[0]))
        got, plain, tf = got[0], plain[0], tf[0]
    xin = F.relu(x) if relu else x
    mag = F.conv2d(xin.abs().permute(0, 3, 1, 2), k.abs(),
                   padding=1).permute(0, 2, 3, 1)
    stats = f32_exact_check(f"rcu C={c} conv {i}", got, exact, plain, tf, 1,
                            b, mag, *res)
    print(stats)


@pytest.mark.parametrize("c", [64, 128])
def test_tf32_rcu_conv_model_fails_the_f32_bounds(lib, c):
    """(b) conv2a (two residuals) through the model on TF32 operands is
    outside F32_MAX_ULPS of the f64 reference, as the card's TF32 result
    must be."""
    rn0, path2, ws = rcu_case(c)
    args, kw = chain_steps(rn0, path2, ws)[1]
    x, k, b, _, res = args
    got, _ = model_rcu_conv(lib, "tf32")(*args, **kw)
    exact = rp.rcu_conv_plain(*f64(x, k, b), False, f64(*res))
    mag = F.conv2d(x.abs().permute(0, 3, 1, 2), k.abs(),
                   padding=1).permute(0, 2, 3, 1)
    ulps = f32_ulps(got, exact, 1, b, mag, *res)
    print(f"C={c}: TF32 model {ulps.max().item():.1f} ulps at most")
    assert ulps.max().item() > F32_MAX_ULPS


@pytest.mark.parametrize("c", [64, 384])
def test_ext_conv1_model_within_the_f32_bounds(lib, c):
    """(b) Row 7's conv1 + b1 (C -> C2 = C / 2, BiasStore) through the
    model: within F32_MAX_ULPS of ext_conv1_plain on f64 operands, at least
    as close on average as the f32 plain conv, the TF32-rounded weights'
    conv refused."""
    rng = np.random.default_rng(c + 1)
    c2 = c // 2
    z = seeded(rng, (2, 8, 12, c))
    k1 = seeded(rng, (c2, c, 3, 3), (9 * c) ** -0.5)
    b1 = seeded(rng, (c2,), 0.5)
    got = bias_epilogue(lib, model_conv_sums(z, k1), b1)
    stats = f32_exact_check(f"ext conv1 C={c}", got,
                            ht.ext_conv1_plain(*f64(z, k1, b1)),
                            ht.ext_conv1_plain(z, k1, b1),
                            ht.ext_conv1_plain(z, tf32_round(k1), b1), 1, b1)
    print(stats)


# --- (c) the chain -------------------------------------------------------------

@pytest.mark.parametrize("c", [64, 128])
def test_rcu_chain_model_matches_f64_plain(lib, c):
    """(c) rcu2(path2 + rcu1(rn0)) as four modelled kernel calls
    (rp.rcu_chain, conv1b reading conv2a's copy) within F32_MAX_ULPS of
    refinenet_pre_plain on f64 operands (the scale taking in rn0 and
    path2), at least as close on average as the f32 plain chain; the chain
    on TF32-rounded weights refused."""
    rn0, path2, ws = rcu_case(c)
    got = rp.rcu_chain(model_rcu_conv(lib), rn0, path2, *ws)
    tf_ws = [tf32_round(w) if w.ndim == 4 else w for w in ws]
    stats = f32_exact_check(f"rcu chain C={c}", got,
                            rp.refinenet_pre_plain(*f64(rn0, path2, *ws)),
                            rp.refinenet_pre_plain(rn0, path2, *ws),
                            rp.refinenet_pre_plain(rn0, path2, *tf_ws), 1,
                            rn0, path2)
    print(stats)


# --- (d) row 7's mix -----------------------------------------------------------

MIX_SUM_K = 16  # K a fresh tensor-core sum of the mix (gemm<Store, 16>)


@pytest.mark.parametrize("c", [64, 128, 256, 384])
def test_ext_mix_model_within_the_f32_bounds(c):
    """(d) Row 7's out_conv mix (B H0 W0, C) x (C, C)^T through the dense
    model with a fresh tensor-core sum every 16 of K (the mix's gemm<Store,
    16>), the weight split as _ext_f32_weights splits it: within
    F32_MAX_ULPS of ext_mix_plain on f64 operands, at least as close on
    average as the f32 plain mix (at C = 64 a sum a 32-wide stage is not:
    1.15 mean ulps against the plain mix's 1.04); the mix on TF32 operands
    (the model with one product a k-step) outside the bound."""
    rng = np.random.default_rng(c + 7)
    x = seeded(rng, (2, 9, 13, c))
    k_oc = seeded(rng, (c, c, 1, 1), c ** -0.5)
    planes = mlp.tf32x3_weight_plain(k_oc[:, :, 0, 0].contiguous())
    a = x.reshape(-1, c)
    got = core_sums(a, planes, span=MIX_SUM_K)[:, :c].reshape(x.shape)
    exact = ht.ext_mix_plain(*f64(x, k_oc))
    stats = f32_exact_check(f"ext mix C={c}", got, exact,
                            ht.ext_mix_plain(x, k_oc),
                            ht.ext_mix_plain(x, tf32_round(k_oc)), 1)
    print(stats)
    tf = core_sums(a, planes, "tf32")[:, :c].reshape(x.shape)
    assert f32_ulps(tf, exact, 1).max().item() > F32_MAX_ULPS


# --- (e) the kept split planes ---------------------------------------------------

def header_split(lib, flat: torch.Tensor):
    """split() of each word of flat (rows, K) f32 by the header: (hi, lo)
    as uint32 arrays."""
    u = flat.contiguous().numpy().view(np.uint32).copy()
    hi, lo = np.empty_like(u), np.empty_like(u)
    lib.split_many(u.ctypes.data, hi.ctypes.data, lo.ctypes.data, u.size)
    return hi, lo


def assert_planes(lib, planes: torch.Tensor, flat: torch.Tensor):
    n, k = flat.shape
    assert planes.shape == (2, -(-n // 128) * 128, k)
    got = planes.numpy().view(np.uint32)
    hi, lo = header_split(lib, flat)
    assert np.array_equal(got[0, :n], hi) and np.array_equal(got[1, :n], lo)
    assert not got[:, n:].any()


@pytest.mark.parametrize("c", [64, 128])
def test_rcu_weights_hold_the_header_split(lib, c):
    """(e) _rcu_weights at f32: the conv's (C, 9 C) weights in the k order
    (3 dh + dw) C + c, split by the header's split() into (2, 128, 9 C)
    planes, zeros past C; the bias as an f32 copy. At bf16 it still hands
    the bf16 GEMM weights over."""
    rng = np.random.default_rng(c)
    k, b = seeded(rng, (c, c, 3, 3)), seeded(rng, (c,))
    planes, bias = rp._rcu_weights(k, b, torch.float32)
    flat = k.permute(0, 2, 3, 1).reshape(c, 9 * c)
    assert_planes(lib, planes, flat)
    assert torch.equal(bias, b) and bias.data_ptr() != b.data_ptr()
    w16, _ = rp._rcu_weights(k, b)
    assert w16.dtype == torch.bfloat16 and torch.equal(
        w16, flat.to(torch.bfloat16))


def test_ext_f32_weights_hold_the_header_split(lib):
    """(e) _ext_f32_weights at C = 384: the mix (C, C), conv1 (C2, 9 C) and
    conv2 (32, 9 C2) each split by the header's split() (the mix in its (C
    out, C in) layout, the convs in the k order the conv reads), zeros past
    their rows; then the f32 vectors b_oc, b1, b2, the 1x1, b3."""
    rng = np.random.default_rng(384)
    c, c2 = 384, 192
    wts = (seeded(rng, (c, c, 1, 1)), seeded(rng, (c,)),
           seeded(rng, (c2, c, 3, 3)), seeded(rng, (c2,)),
           seeded(rng, (32, c2, 3, 3)), seeded(rng, (32,)),
           seeded(rng, (1, 32, 1, 1)), seeded(rng, (1,)))
    kocs, w1s, w2s, *vecs = ht._ext_f32_weights(*wts)
    assert_planes(lib, kocs, wts[0][:, :, 0, 0])
    assert_planes(lib, w1s, wts[2].permute(0, 2, 3, 1).reshape(c2, 9 * c))
    assert_planes(lib, w2s, wts[4].permute(0, 2, 3, 1).reshape(32, 9 * c2))
    want = [wts[1], wts[3], wts[5], wts[6], wts[7]]
    assert [tuple(v.shape) for v in vecs] == [(c,), (c2,), (32,), (32,), (1,)]
    assert all(torch.equal(v, w.reshape(-1)) for v, w in zip(vecs, want))
