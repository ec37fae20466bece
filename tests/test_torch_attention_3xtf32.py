"""PyTorch port, rows 2 and 17 at f32 (csrc/attention_f32.cu): the 3xTF32
arithmetic of the wgmma kernel, on the CPU.

The kernel itself (TMA, mbarriers, wgmma) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8). What it computes is held
here:
(a) g++ builds csrc/tf32x3.cuh as it is; its split of an f32 value into
    TF32 hi and lo is checked on edge and random bit patterns against a
    numpy model of round-to-nearest, ties away, to 10 mantissa bits, and
    its split_finite (the kernel's split of P) against it on finite ones;
(b) a torch model of the kernel's arithmetic (q, k, v and P split by that
    header, the three TF32 products of each sum taken a 64-key tile at a
    time in f32, the online softmax with the kernel's tile) stays within
    chip_smoke.py's f32 attention bounds of attention_plain and
    flash_attention_plain, as row 2 and as row 17;
(c) the same model on plain TF32 operands fails those bounds, as phase 8
    requires of the card's TF32 result (the model with P unsplit is
    printed beside it, as a record);
(d) P's accumulator registers, taken as wgmma's register A fragment in the
    kernel's order against V^T stored in tf32x3::pv_slot_key's key order,
    give P V; in plain key order they do not. Needs g++.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR
from vr_video_generator_tpu_torch.ops.attention import (attention_plain,
                                                        flash_attention_plain)

torch.set_num_threads(2)

KEY_TILE = 64  # csrc/attention_f32.cu BN
UNIT = """#include "tf32x3.cuh"
extern "C" void split_many(const uint32_t* x, uint32_t* hi, uint32_t* lo,
                           long n) {
  for (long i = 0; i < n; ++i) {
    tf32x3::split(tf32x3::from_bits(x[i]), hi[i], lo[i]);
  }
}
extern "C" void split_finite_many(const uint32_t* x, uint32_t* hi,
                                  uint32_t* lo, long n) {
  for (long i = 0; i < n; ++i) {
    tf32x3::split_finite(tf32x3::from_bits(x[i]), hi[i], lo[i]);
  }
}
extern "C" int pv_slot_key(int s) { return tf32x3::pv_slot_key(s); }
"""
LOW13 = np.uint32(0x1FFF)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/tf32x3.cuh")
    tmp = tmp_path_factory.mktemp("tf32x3")
    (tmp / "unit.cpp").write_text(UNIT)
    so = tmp / "libtf32x3.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
         f"-I{CSRC_DIR}", str(tmp / "unit.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    for fn in (out.split_many, out.split_finite_many):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]
        fn.restype = None
    out.pv_slot_key.argtypes = [ctypes.c_int]
    out.pv_slot_key.restype = ctypes.c_int
    return out


def split_bits(lib, u, finite=False):
    """uint32 bit patterns -> the header's (hi, lo) bit patterns, by split()
    or, with ``finite``, split_finite()."""
    u = np.ascontiguousarray(u, dtype=np.uint32)
    hi, lo = np.empty_like(u), np.empty_like(u)
    fn = lib.split_finite_many if finite else lib.split_many
    fn(u.ctypes.data, hi.ctypes.data, lo.ctypes.data, u.size)
    return hi, lo


def split(lib, x: torch.Tensor, finite=False):
    """An f32 tensor -> its TF32 (hi, lo) tensors by the header."""
    hi, lo = split_bits(lib, x.contiguous().numpy().view(np.uint32).ravel(),
                        finite)
    as_t = lambda a: torch.from_numpy(a.view(np.float32).reshape(x.shape))
    return as_t(hi), as_t(lo)


def rna_model(x32: np.ndarray) -> np.ndarray:
    """f32 values rounded to 10 mantissa bits, to nearest with ties away
    from zero, in f64: the quantum is 2^(e - 10) for |x| in [2^e, 2^(e+1))
    (2^-136 for subnormals); past the largest finite TF32 value it is inf.
    Infinities and NaNs pass."""
    with np.errstate(invalid="ignore"):
        x = x32.astype(np.float64)
    a = np.abs(x)
    e = np.frexp(np.where(np.isfinite(a), a, 1.0))[1] - 1
    quantum = np.exp2(np.maximum(e, -126) - 10.0)
    r = np.floor(a / quantum + 0.5) * quantum
    r = np.where(r >= 2.0 ** 128, np.inf, r)
    out = np.where(np.isfinite(x), np.copysign(r, x), x)
    return out.astype(np.float32)


def _bits(rng, size, exp=None, sign=None):
    """Random f32 bit patterns, optionally of one biased exponent / sign."""
    u = rng.integers(0, 2 ** 32, size, dtype=np.uint64).astype(np.uint32)
    if exp is not None:
        u = (u & np.uint32(0x807FFFFF)) | (np.asarray(exp, np.uint32) << 23)
    if sign is not None:
        u = (u & np.uint32(0x7FFFFFFF)) | (np.uint32(sign) << 31)
    return u


def _patterns(kind: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == "random":
        return _bits(rng, 200_000)
    if kind == "every exponent":
        exps = np.repeat(np.arange(255, dtype=np.uint32), 64)
        return np.concatenate([_bits(rng, exps.size, exps, s)
                               for s in (0, 1)])
    if kind == "ties":
        # The low 13 bits exactly half a TF32 ulp, and its neighbours.
        u = _bits(rng, 30_000, rng.integers(1, 255, 30_000)) & ~LOW13
        return np.concatenate([u | np.uint32(t)
                               for t in (0x1000, 0x0FFF, 0x1001)])
    if kind == "subnormals":
        u = _bits(rng, 40_000, 0)
        edges = np.array([0, 1, 0x1000, 0x1FFF, 0x7FF000, 0x7FFFFF],
                         np.uint32)
        return np.concatenate([u, edges, edges | np.uint32(0x80000000)])
    if kind == "largest finite":
        top = np.arange(0x7F7F0000, 0x7F800000, dtype=np.uint32)
        return np.concatenate([top, top | np.uint32(0x80000000)])
    if kind == "inf and nan":
        low = np.arange(1, 0x2000, dtype=np.uint32)
        special = np.concatenate([low, low << 13, _bits(rng, 4096) & 0x7FFFFF])
        u = np.uint32(0x7F800000) | special
        return np.concatenate([u, u | np.uint32(0x80000000),
                               np.array([0x7F800000, 0xFF800000], np.uint32)])
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "every exponent", "ties",
                                  "subnormals", "largest finite",
                                  "inf and nan"])
def test_split_rounds_to_nearest_ties_away(lib, kind):
    """(a) hi and lo have their low 13 bits zero; hi is x rounded to TF32
    (the numpy model) and lo is x - hi so rounded (x - hi is exact in f32);
    for |x| >= 2^-115 whose hi is finite, |x - hi - lo| <= 2^-21 |x| (below,
    lo's step is TF32's subnormal 2^-136, so the bound is that step's half
    there). NaN stays NaN in both."""
    u = _patterns(kind)
    hi, lo = split_bits(lib, u)
    assert not (hi & LOW13).any() and not (lo & LOW13).any()
    x = u.view(np.float32)
    h, l = hi.view(np.float32), lo.view(np.float32)
    want_h = rna_model(x)
    nan = np.isnan(x)
    assert np.array_equal(np.isnan(h), nan)
    np.testing.assert_array_equal(h[~nan], want_h[~nan])
    fin = np.isfinite(x) & np.isfinite(h)
    resid = (x[fin].astype(np.float64) - h[fin]).astype(np.float32)
    np.testing.assert_array_equal(l[fin], rna_model(resid))
    xf = x[fin].astype(np.float64)
    err = np.abs(xf - h[fin] - l[fin])
    big = np.abs(xf) >= 2.0 ** -115
    assert (err[big] <= 2.0 ** -21 * np.abs(xf[big])).all()
    assert (err[~big] <= 2.0 ** -137).all()
    if kind == "ties":
        # Half an ulp rounds the magnitude up (away from zero).
        t = (u & LOW13) == 0x1000
        assert (np.abs(h[t].astype(np.float64)) > np.abs(x[t])).all()


@pytest.mark.parametrize("kind", ["random", "every exponent", "ties",
                                  "subnormals", "largest finite"])
def test_split_finite_is_split_on_finite_values(lib, kind):
    """(a) split_finite (the kernel's split of P) gives split's bits for
    every finite x."""
    u = _patterns(kind)
    u = u[np.isfinite(u.view(np.float32))]
    for got, want in zip(split_bits(lib, u, finite=True), split_bits(lib, u)):
        np.testing.assert_array_equal(got, want)


def model(lib, q, k, v, scale, scaled, products="3xtf32"):
    """(B, N, H, 64) f32 -> (B, N, H, 64) as csrc/attention_f32.cu computes
    it: K and V padded to a multiple of the 64-key tile with zeros, per tile
    S = (Q_hi K_lo + Q_lo K_hi) + Q_hi K_hi in f32 (times ``scale`` in f32
    if ``scaled``), keys >= N at -inf, the running max m, alpha = exp(m_old
    - m_new), p = exp(s - m_new), l rescaled by alpha and summed, O = O *
    alpha + ((P_hi V_lo + P_lo V_hi) + P_hi V_hi), and o / l at the end.
    ``products``: "3xtf32" (the kernel), "p unsplit" (P rounded to TF32
    alone) or "tf32" (every operand rounded to TF32, one product each)."""
    b, n, h, d = q.shape
    npad = -(-n // KEY_TILE) * KEY_TILE
    qt = q.transpose(1, 2).float()
    kt = F.pad(k.transpose(1, 2).float(), (0, 0, 0, npad - n))
    vt = F.pad(v.transpose(1, 2).float(), (0, 0, 0, npad - n))
    (qh, ql), (kh, kl), (vh, vl) = (split(lib, t) for t in (qt, kt, vt))
    if products == "tf32":
        ql, kl, vl = (torch.zeros_like(t) for t in (ql, kl, vl))
    m = torch.full((b, h, n, 1), -torch.inf)
    l = torch.zeros((b, h, n, 1))
    o = torch.zeros((b, h, n, d))
    for t0 in range(0, npad, KEY_TILE):
        kh_t, kl_t = kh[:, :, t0:t0 + KEY_TILE], kl[:, :, t0:t0 + KEY_TILE]
        s = ((qh @ kl_t.transpose(-1, -2) + ql @ kh_t.transpose(-1, -2))
             + qh @ kh_t.transpose(-1, -2))
        if scaled:
            s = s * scale
        s[..., max(n - t0, 0):] = -torch.inf
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        ph, pl = split(lib, p, finite=True)
        if products != "3xtf32":
            pl = torch.zeros_like(pl)
        vh_t, vl_t = vh[:, :, t0:t0 + KEY_TILE], vl[:, :, t0:t0 + KEY_TILE]
        o = o * alpha + ((ph @ vl_t + pl @ vh_t) + ph @ vh_t)
        m = m_new
    return (o / l).transpose(1, 2).contiguous()


def peaked_case(n: int, flash: bool):
    """chip_smoke.py phase 8's q/k/v (B = 2, H = 2): a peaked softmax,
    k and v strided views into one qkv; row 2's q pre-scaled."""
    rng = np.random.default_rng(n + 3 * flash)
    qkv = torch.from_numpy(rng.standard_normal((2, n, 3, 2, 64))
                           .astype(np.float32))
    qkv[:, :, 1] *= 1.5
    qkv[:, :, 0, :, 0] = 4.0
    qkv[:, :, 1, :, 0] = -8.0
    k, v, scale = qkv[:, :, 1], qkv[:, :, 2], 64 ** -0.5
    if flash:
        q = qkv[:, :, 0]
        return (q, k, v, scale), flash_attention_plain(q, k, v, scale)
    q = (qkv[:, :, 0] * scale).contiguous()
    return (q, k, v, 1.0), attention_plain(q, k, v)


def rel_errors(got, want):
    """max / mean |got - want| against max / mean |want| (chip_smoke.py's
    f32_rel_check)."""
    err = (got.double() - want.double()).abs()
    size = want.double().abs()
    return (err.max() / size.max()).item(), (err.mean() / size.mean()).item()


CASES = [(45, False), (160, False), (45, True), (160, True)]
IDS = ["row2 n=45", "row2 n=160", "row17 n=45", "row17 n=160"]


@pytest.mark.parametrize("n,flash", CASES, ids=IDS)
def test_3xtf32_model_within_the_f32_bounds(lib, n, flash):
    """(b) The kernel's arithmetic (one ragged tile at 45 keys, three at 160)
    within ATTN_F32_MAX_REL / ATTN_F32_MEAN_REL of the plain version."""
    from chip_smoke import ATTN_F32_MAX_REL, ATTN_F32_MEAN_REL

    args, want = peaked_case(n, flash)
    got = model(lib, *args, scaled=flash)
    mx, mean = rel_errors(got, want)
    assert mx <= ATTN_F32_MAX_REL and mean <= ATTN_F32_MEAN_REL, (mx, mean)


@pytest.mark.parametrize("n,flash", CASES, ids=IDS)
def test_plain_tf32_model_fails_the_f32_bounds(lib, n, flash):
    """(c) The same model on plain TF32 operands is outside the max bound,
    as chip_smoke.py requires of the TF32 result; the model with P alone
    rounded to TF32 is printed beside it."""
    from chip_smoke import ATTN_F32_MAX_REL

    args, want = peaked_case(n, flash)
    tf32 = rel_errors(model(lib, *args, scaled=flash, products="tf32"), want)
    unsplit = rel_errors(model(lib, *args, scaled=flash,
                               products="p unsplit"), want)
    kernel = rel_errors(model(lib, *args, scaled=flash), want)
    print(f"max / mean rel: 3xtf32 {kernel}, P unsplit {unsplit}, "
          f"tf32 {tf32}")
    assert tf32[0] > ATTN_F32_MAX_REL, tf32


def accumulator_coords(lane_rows=64, cols=64):
    """A wgmma f32 accumulator (rows x cols) in a warpgroup: for thread t
    (warp w, lane l) and value 4 j + 2 i + c, its (row, column) = (16 w +
    l / 4 + 8 i, 8 j + 2 (l % 4) + c)."""
    coords = {}
    for t in range(128):
        w, ln = divmod(t, 32)
        for j in range(cols // 8):
            for i in range(2):
                for c in range(2):
                    coords[t, 4 * j + 2 * i + c] = (
                        16 * w + ln // 4 + 8 * i, 8 * j + 2 * (ln % 4) + c)
    return coords


def a_fragment_coords(kk):
    """wgmma's .tf32 register A fragment of k-step kk: register r of thread
    t (warp w, lane l) holds (16 w + l / 4 + 8 (r % 2), 8 kk + l % 4 + 4 (r
    / 2)) (PTX ISA, wgmma .m64nNk8 A layout)."""
    out = {}
    for t in range(128):
        w, ln = divmod(t, 32)
        for r in range(4):
            out[t, r] = (16 * w + ln // 4 + 8 * (r % 2),
                         8 * kk + ln % 4 + 4 * (r // 2))
    return out


# The kernel's registers for k-step kk: Q's (qh[4 kk + r]) and P's
# (ph[4 kk], ph[4 kk + 2], ph[4 kk + 1], ph[4 kk + 3]), and the value index
# of qh: 4 kk + 2 c + i holds Q[r0 + 8 i][8 kk + quad + 4 c].
P_ORDER = (0, 2, 1, 3)


@pytest.mark.parametrize("order", ["pv_slot_key", "plain key order"])
def test_p_fragment_against_permuted_vt(lib, order):
    """(d) P in the accumulator's registers, passed as the A fragment in
    the kernel's order, times V^T with each 8-key group in pv_slot_key's
    order, equals P V exactly (integer values); with V^T in plain key order
    it does not."""
    rng = np.random.default_rng(11)
    p = rng.integers(-8, 9, (64, 64)).astype(np.float64)
    v = rng.integers(-8, 9, (64, 64)).astype(np.float64)
    acc = {key: p[rc] for key, rc in accumulator_coords().items()}
    slot_key = [lib.pv_slot_key(s) if order == "pv_slot_key" else s
                for s in range(8)]
    assert sorted(slot_key) == list(range(8))
    a = np.full((64, 64), np.nan)      # A as wgmma reads it: (row, k-slot)
    for kk in range(8):
        for (t, r), rc in a_fragment_coords(kk).items():
            a[rc] = acc[t, 4 * kk + P_ORDER[r]]
    vt = np.empty((64, 64))            # V^T in shared memory: (dim, k-slot)
    for slot in range(64):
        vt[:, slot] = v[slot - slot % 8 + slot_key[slot % 8]]
    got = a @ vt.T
    if order == "pv_slot_key":
        np.testing.assert_array_equal(got, p @ v)
    else:
        assert not np.array_equal(got, p @ v)


def test_q_fragment_is_q():
    """(d) Q's registers as the kernel loads them (qh[4 kk + 2 c + i] =
    Q[r0 + 8 i][8 kk + quad + 4 c]), taken as the A fragment in order
    (qh[4 kk + r]), are Q itself: K^T needs no permutation."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((64, 64))
    regs = {}
    for t in range(128):
        w, ln = divmod(t, 32)
        r0, quad = 16 * w + ln // 4, ln % 4
        for kk in range(8):
            for i in range(2):
                for c in range(2):
                    regs[t, 4 * kk + 2 * c + i] = q[r0 + 8 * i,
                                                    8 * kk + quad + 4 * c]
    a = np.full((64, 64), np.nan)
    for kk in range(8):
        for (t, r), rc in a_fragment_coords(kk).items():
            a[rc] = regs[t, 4 * kk + r]
    np.testing.assert_array_equal(a, q)
