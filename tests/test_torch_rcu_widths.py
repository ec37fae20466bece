"""PyTorch port, refinenet1's RCU pair (row 16) at every width the JAX kernel
takes, on the CPU.

refinenet_pre_pallas takes any C and asserts only its row block (H0 >= 4);
the port's chain runs C zero-padded to ``rcu_width`` (a multiple of 64 at
bf16, of 32 at f32) on the card. Held here:
(a) the plain chain against refinenet_pre_pallas in interpret mode at C =
    24, 96 and 256 (C = 8, 16, 64 and 128 are tests/test_torch_base_tail.py's),
    H0 no multiple of the row block: f32 within 3e-4; bf16 within the RCU
    pair's bf16-feature bounds of tests/test_torch_base_tail.py, and, since
    a one-ulp flip of a bf16 intermediate moves the next conv's sums (at C =
    256 7% of the outputs sit one or two ulps off), the chain's error
    against the f32 chain at most chip_smoke.RCU_F32_FLOOR times the JAX
    kernel's own;
(b) the zero padding: the chain on rn0 and path2 padded to Cp equals the
    unpadded plain chain bit for bit, its padded channels exact zeros; the
    weights the wrapper builds are the padded ones; on the 3xTF32 core's
    model a padded f32 conv's sums equal the unpadded sums bit for bit;
(c) the bf16 core's tile loop (tests/test_torch_rcu_core.py's model) on the
    column tiles above C = 128 (128 x 128 tiles, C / 128 of them, the last
    half idle at C = 192 and 320) with RcuSums at each tile's channel
    offset equals F.conv2d and rcu_conv_plain exactly on integer data;
(d) the entry points' width checks read from the source, and the wrappers'
    dispatch on a faked card: padded pointers and Cp at C = 16 and 96, the
    published 256 and 384 unpadded, the output a view of C channels;
(e) H0 = 3 raises in both packages.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import RCU_F32_FLOOR
from tests.test_torch_attention_any import FakeLibrary
from tests.test_torch_base_tail import (_assert_close, _pallas_rcu_nhwc,
                                        _port_rcu, _rcu_args)
from tests.test_torch_conv_3xtf32_rcu_ext import model_conv_sums, seeded
from tests.test_torch_rcu_core import P, _ints, _pixel
from tests.test_torch_tail_widths import _ragged_conv_sums
from vr_video_generator_tpu.attic.refinenet_pre import refinenet_pre_pallas
from vr_video_generator_tpu_torch.attic import refinenet_pre as rp
from vr_video_generator_tpu_torch.kernels import build, launch_counts
from vr_video_generator_tpu_torch.ops import head_tail as ht

torch.set_num_threads(2)
torch.set_grad_enabled(False)

CSRC = pathlib.Path(rp.__file__).resolve().parents[1] / "csrc"
BF16, F32 = torch.bfloat16, torch.float32


def _chain_args(rng, c, dtype, b=2, h0=7, w0=13):
    rn0, path2 = (seeded(rng, (b, h0, w0, c)).to(dtype) for _ in range(2))
    ws = []
    for _ in range(4):
        ws += [seeded(rng, (c, c, 3, 3), (9 * c) ** -0.5),
               seeded(rng, (c,), 0.1)]
    return rn0, path2, ws


# --- (a) against the Pallas kernel -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h0,w0,c", [(9, 20, 24), (10, 12, 96), (6, 10, 256)])
def test_refinenet_pre_matches_pallas_at_new_widths(h0, w0, c, dtype):
    """(a) rcu2(path2 + rcu1(rn0)), the port's plain chain against
    refinenet_pre_pallas (interpret mode, its default row block: 8, 8 and 4
    rows against H0 = 9, 10, 6). f32 within 3e-4; bf16 by its mean and its
    largest difference (_assert_close's bf16 features), at C <= 128 also by
    the share of outputs that differ, and at every C by the chain's error
    against the f32 chain (the port's plain f32 chain on the same values),
    at most RCU_F32_FLOOR times the JAX bf16 kernel's, in max and mean."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    args = _rcu_args(np.random.default_rng(c), 2, h0, w0, c, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = _pallas_rcu_nhwc(args, jdt, 32)
    ours = _port_rcu(args, tdt)
    assert ours.dtype == tdt and ours.shape == ref.shape == (2, h0, w0, c)
    got = ours.float().numpy()
    if dtype == "float32" or c <= 128:
        _assert_close(got, ref, dtype, 3e-4, bf16_features=True)
    if dtype == "float32":
        return
    err = np.abs(got - ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    assert err.mean() <= 2e-4 * float(ref.max() - ref.min())
    assert err.max() <= 2 * ulp, (err.max(), ulp)
    f32 = _port_rcu(args, F32).numpy()
    d_port, d_jax = np.abs(got - f32), np.abs(ref - f32)
    assert d_port.max() <= RCU_F32_FLOOR * d_jax.max()
    assert d_port.mean() <= RCU_F32_FLOOR * d_jax.mean()


# --- (b) the zero padding ----------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [24, 80])
def test_padded_chain_equals_unpadded(c, dtype):
    """(b) The chain as the card runs it at a width off the slices: rn0 and
    path2 zero-padded to Cp (rcu_width), each conv reading the head's
    weights as zeros past C (rcu_conv_plain on the padded layout), then
    also on weights padded by pad_to: the first C channels equal the
    unpadded plain chain bit for bit, the padded ones are exact zeros."""
    rn0, path2, ws = _chain_args(np.random.default_rng(c), c, dtype)
    cp = rp.rcu_width(c, dtype)
    assert cp > c
    want = rp.refinenet_pre_plain(rn0, path2, *ws)
    prn0, ppath2 = (F.pad(t, (0, cp - c)) for t in (rn0, path2))
    pws = [ht.pad_to(w, cp, cp) if w.ndim == 4 else ht.pad_to(w, cp)
           for w in ws]
    for weights in (ws, pws):
        got = rp.rcu_chain(rp.rcu_conv_plain, prn0, ppath2, *weights)
        assert got.shape[-1] == cp and not got[..., c:].any()
        assert torch.equal(got[..., :c], want)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [16, 80, 256])
def test_wrapper_weights_are_zero_padded(c, dtype):
    """(b) _rcu_weights builds the padded conv's layout: at bf16 the (Cp, 9
    Cp) GEMM weights of pad_to(k, Cp, Cp), at f32 its TF32 split; the bias
    zero-padded to Cp in f32."""
    rng = np.random.default_rng(c)
    k, b = seeded(rng, (c, c, 3, 3), 0.1), seeded(rng, (c,), 0.1)
    cp = rp.rcu_width(c, dtype)
    wt, bias = rp._rcu_weights(k, b, dtype)
    kp = ht.pad_to(k, cp, cp)
    want = ht._conv_split(kp) if dtype == F32 else \
        ht.conv3x3_gemm_weights(kp, dtype)
    assert torch.equal(wt, want)
    assert bias.dtype == F32 and torch.equal(bias, ht.pad_to(b, cp))


@pytest.mark.parametrize("c", [16, 80])
def test_padded_f32_rcu_conv_sums_equal_unpadded(c):
    """(b) A row 16 conv at f32 as the chain runs it at C = 16 and 80 (x
    padded to Cp = 32 and 96, the weights to (Cp, Cp)): its sums on the
    3xTF32 core's model equal, bit for bit, the sums over the head's own
    channels (each stage a fresh truncating sum); the padded outputs are
    zeros."""
    rng = np.random.default_rng(c)
    x = seeded(rng, (2, 5, 9, c))
    k = seeded(rng, (c, c, 3, 3), (9 * c) ** -0.5)
    cp = rp.rcu_width(c, F32)
    got = model_conv_sums(F.pad(x, (0, cp - c)), ht.pad_to(k, cp, cp))
    assert got.shape[-1] == cp and not got[..., c:].any()
    assert torch.equal(got[..., :c], _ragged_conv_sums(x, k))


# --- (c) the bf16 core's column tiles -----------------------------------------

BM, BN = 128, 128  # csrc/rcu_pair.cu's tile above C = 64


def _core_conv_tiles(u, wt):
    """The core's f64 sums of the 3x3 conv of u (B, H, W, C) by B operand
    wt (N, 9 C) on BM x BN tiles: the tiles of one row band's columns
    consecutive, each A box the image at (c0, x0 + dw - 1, y0 + dh - 1,
    frame), zero outside u, B's rows past N zero (TMA's fill). Returns the
    sums by GEMM row as each column tile left them, (row tiles * BM, column
    tiles * BN), and the tile grid."""
    bsz, h, w, c = u.shape
    n = wt.shape[0]
    rows = BM // P
    tiles_x, tiles_y = -(-w // P), -(-h // rows)
    tiles_n = -(-n // BN)
    up = torch.zeros((bsz, tiles_y * rows + 2, tiles_x * P + 2, c),
                     dtype=torch.float64)
    up[:, 1:h + 1, 1:w + 1] = u.double()
    b_mat = torch.zeros((tiles_n * BN, 9 * c), dtype=torch.float64)
    b_mat[:n] = wt.double()
    m_tiles = bsz * tiles_y * tiles_x
    sums = torch.full((m_tiles * BM, tiles_n * BN), float("nan"),
                      dtype=torch.float64)
    for tile in range(m_tiles * tiles_n):
        tm, tn = divmod(tile, tiles_n)
        ty, tx = divmod(tm, tiles_x)
        fb, y0, x0 = ty // tiles_y, ty % tiles_y * rows, tx * P
        n0 = tn * BN
        acc = torch.zeros((BM, BN), dtype=torch.float64)
        for t in range(9 * c // 64):
            tap, cs = divmod(t, c // 64)
            dh, dw, c0 = tap // 3, tap % 3, 64 * cs
            a = up[fb, y0 + dh:y0 + dh + rows, x0 + dw:x0 + dw + P,
                   c0:c0 + 64]
            acc += a.reshape(BM, 64) @ b_mat[n0:n0 + BN, 64 * t:64 * t + 64].T
        sums[tm * BM:(tm + 1) * BM, n0:n0 + BN] = acc
    return sums, tiles_x, tiles_y


def _rcu_conv_tiles(x, wt, bias, relu, residuals=()):
    """One RCU conv on the column tiles: the core's sums, then RcuSums'
    f32 step at each GEMM row's pixel and each global column (the tile's
    channel offset n0 + its column; a ragged tile's columns past C take
    column C - 2's operands and are not stored), the residuals read at
    pixel * C + column; f64, (B, H, W, C)."""
    bsz, h, w, c = x.shape
    sums, tiles_x, tiles_y = _core_conv_tiles(x, wt)
    out = torch.full((bsz * h * w, c), float("nan"), dtype=torch.float64)
    flat = [r.reshape(-1).double() for r in residuals]
    for row in range(sums.shape[0]):
        p = _pixel(row, h, w, tiles_x, tiles_y, BM)
        if p < 0:
            continue
        for col in range(0, sums.shape[1], 2):
            at = min(col, c - 2)
            v = sums[row, col:col + 2] + bias.double()[at:at + 2]
            if relu:
                v = v.clamp_min(0)
            for r in flat:
                v = v + r[p * c + at:p * c + at + 2]
            if col < c:
                out[p, col:col + 2] = v
    return out.reshape(bsz, h, w, c)


@pytest.mark.parametrize("c", [192, 256, 384])
def test_core_column_tiles_equal_conv2d(c):
    """(c) Small integers: the emulated core on C / 128 column tiles (the
    last half idle at C = 192), on the wrapper's (C, 9 C) weights, equals
    F.conv2d with zero padding bit for bit, the ragged row and pixel tiles
    included."""
    rng = np.random.default_rng(c)
    x = _ints(rng, (1, 5, 38, c), -2, 3)
    k = _ints(rng, (c, c, 3, 3), -1, 2)
    wt, _ = rp._rcu_weights(k, torch.zeros(c))
    assert wt.shape == (c, 9 * c)
    sums, tiles_x, tiles_y = _core_conv_tiles(x, wt)
    got = torch.full((1 * 5 * 38, c), float("nan"), dtype=torch.float64)
    for row in range(sums.shape[0]):
        p = _pixel(row, 5, 38, tiles_x, tiles_y, BM)
        if p >= 0:
            got[p] = sums[row, :c]
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), k.double(),
                    padding=1).permute(0, 2, 3, 1)
    assert torch.equal(got.reshape(1, 5, 38, c), want)


@pytest.mark.parametrize("relu,nres", [(True, 0), (False, 2), (False, 1)])
@pytest.mark.parametrize("c", [192, 320])
def test_core_column_tiles_f32_step_equals_plain(c, relu, nres):
    """(c) The chain's three kinds of conv on the column tiles with RcuSums
    at each tile's channel offset (bias, ReLU, residuals at pixel * C +
    column), on integer data, equal rcu_conv_plain exactly, the half-idle
    last tile's columns dropped."""
    rng = np.random.default_rng(c + 10 * nres + relu)
    b, h, w = 1, 6, 33
    x = _ints(rng, (b, h, w, c), -2, 3)
    k = _ints(rng, (c, c, 3, 3), -1, 2)
    bias = _ints(rng, (c,), -8, 9)
    res = [_ints(rng, (b, h, w, c), -50, 51) for _ in range(nres)]
    wt, bf32 = rp._rcu_weights(k, bias)
    got = _rcu_conv_tiles(F.relu(x) if relu else x, wt, bf32, relu, res)
    want = rp.rcu_conv_plain(x, k, bias, relu, res)
    assert torch.equal(got.float(), want)


# --- (d) the width rules in the source and the dispatch ------------------------

def test_rcu_width_rule_and_the_sources():
    """(d) rcu_width pads C to the kernels' channel slices (64 at bf16, 32
    at f32), every published width (64, 128, 256, 384) unpadded at both;
    the entry points refuse exactly the widths off those slices, and the
    bf16 one keeps 256 x 64 tiles at C = 64 and 128 x 128 above."""
    assert [rp.rcu_width(c, BF16) for c in (1, 16, 64, 65, 96, 200, 384)] \
        == [64, 64, 64, 128, 128, 256, 384]
    assert [rp.rcu_width(c, F32) for c in (1, 16, 32, 48, 96, 200, 384)] \
        == [32, 32, 32, 64, 96, 224, 384]
    for c in (64, 128, 256, 384):
        assert rp.rcu_width(c, BF16) == rp.rcu_width(c, F32) == c
    bf = (CSRC / "rcu_pair.cu").read_text()
    f32 = (CSRC / "rcu_pair_f32.cu").read_text()
    assert "if (c <= 0 || c % 64 != 0) return (int)cudaErrorInvalidValue;" \
        in bf
    assert "if (c <= 0 || c % 32 != 0) return (int)cudaErrorInvalidValue;" \
        in f32
    entry = bf[bf.index('extern "C" int vrvg_rcu_conv('):]
    assert re.findall(r"run<tma_gemm::Tile<(\d+), (\d+)>>", entry) == [
        ("256", "64"), (str(BM), str(BN))]
    assert "if (c == 64) {" in entry


@pytest.fixture
def fake_card(monkeypatch):
    """The RCU wrappers believe their tensors are on the card and call a
    FakeLibrary."""
    lib = FakeLibrary()
    monkeypatch.setattr(rp, "on_cuda", lambda *t: True)
    monkeypatch.setattr(rp, "stream_handle", lambda device: 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    return lib


@pytest.mark.parametrize("dtype,c,cp", [(BF16, 16, 64), (BF16, 96, 128),
                                        (BF16, 256, 256), (BF16, 384, 384),
                                        (F32, 16, 32), (F32, 96, 96)],
                         ids=["bf16-16", "bf16-96", "bf16-256", "bf16-384",
                              "f32-16", "f32-96"])
def test_wrapper_hands_the_padded_width(fake_card, dtype, c, cp):
    """(d) refinenet_pre on the card: four calls of its dtype's entry point,
    each with Cp, counted on its counter; a width off the slices reads rn0
    through a padded copy, a published one (256, 384) rn0 itself; the
    output is (B, H0, W0, C), a view of the chain's first C channels."""
    rn0, path2, ws = _chain_args(np.random.default_rng(c), c, dtype, b=1,
                                 h0=5, w0=6)
    name = "rcu_pair_f32" if dtype == F32 else "rcu_pair"
    before = launch_counts().get(name, 0)
    got = rp.refinenet_pre(rn0, path2, *ws)
    entry = "vrvg_rcu_conv_f32" if dtype == F32 else "vrvg_rcu_conv"
    assert [n for n, _ in fake_card.calls] == [entry] * 4
    assert [a[11] for _, a in fake_card.calls] == [cp] * 4
    assert [(a[12], a[13]) for _, a in fake_card.calls] == [
        (1, 0), (0, 2), (1, 0), (0, 1)]
    assert launch_counts()[name] == before + 4
    assert (fake_card.calls[0][1][0] == rn0.data_ptr()) == (cp == c)
    assert got.shape == rn0.shape and got.dtype == dtype
    assert got._base is not None and got._base.shape[-1] == cp


def test_single_conv_at_an_unpadded_width_pads_for_the_call(fake_card):
    """(d) rcu_conv called alone on C = 16 channels: one launch at Cp = 64,
    x and the residuals padded for it, the output and its ReLU'd copy (B,
    H0, W0, 16) views."""
    rn0, path2, ws = _chain_args(np.random.default_rng(3), 16, BF16, b=1,
                                 h0=5, w0=6)
    out, copy = rp.rcu_conv(rn0, ws[2], ws[3], False, (rn0, path2),
                            relu_copy=True)
    assert [(n, a[11], a[13]) for n, a in fake_card.calls] == [
        ("vrvg_rcu_conv", 64, 2)]
    assert out.shape == copy.shape == rn0.shape


# --- (e) the rows JAX asserts on ------------------------------------------------

@pytest.mark.parametrize("h0", [3, 4])
def test_h0_below_4_raises_in_both_packages(h0):
    """(e) refinenet_pre_pallas asserts a positive row block of 4 rows or
    more, so H0 = 3 fails there (AssertionError) and raises ValueError in
    the port, on CPU tensors and on a faked card alike, before any launch;
    H0 = 4 runs in both."""
    rng = np.random.default_rng(h0)
    args = _rcu_args(rng, 1, h0, 8, 8, jnp.dtype("float32"))
    if h0 < 4:
        with pltpu.force_tpu_interpret_mode(), pytest.raises(AssertionError):
            refinenet_pre_pallas(*(jnp.asarray(a) for a in args),
                                 interpret=True)
        with pytest.raises(ValueError, match="H0 >= 4"):
            _port_rcu(args, F32)
    else:
        with pltpu.force_tpu_interpret_mode():
            ref = _pallas_rcu_nhwc(args, jnp.dtype("float32"), 32)
        np.testing.assert_allclose(_port_rcu(args, F32).numpy(), ref,
                                   rtol=0, atol=3e-4)


def test_h0_below_4_raises_on_the_card(fake_card):
    """(e) The same refusal on a faked card: ValueError, nothing launched."""
    rn0, path2, ws = _chain_args(np.random.default_rng(5), 96, BF16, b=1,
                                 h0=3, w0=6)
    with pytest.raises(ValueError, match="H0 >= 4"):
        rp.refinenet_pre(rn0, path2, *ws)
    assert fake_card.calls == []
