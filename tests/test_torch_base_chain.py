"""PyTorch port on the CPU: the single-kernel DPT tail (row 15) as the card
now runs it, a chain of three stages: conv1 straight from path1 with its f32
bias before the cast (the halo-tile kernel at C = 64, the GEMM core's
implicit GEMM at C = 128), the resize pass, and conv2 with the 1x1. Their
plain stages (``head_tail_stages`` on CPU tensors), composed, are the whole
plain version as the kernels were held against it before the stages
existed (kept here as it was) bit for bit, at every width, in f32 and
bf16, and match the JAX package's ``head_tail_pallas`` in interpret mode.
Pure-torch emulations of the conv1 kernels (tests/test_torch_big_tail.py:
the core's tile loop on the tile csrc/head_tail_big.cu picks, and the halo
tiles), fed the weights the wrapper hands them, equal ``F.conv2d`` with
zero padding and the bias exactly on integer data; a permuted layout does
not. The width dispatch of ``vrvg_head_tail`` is read from its source and
held against the wrapper's."""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_base_tail import _hwio, _t, _tail_args
from tests.test_torch_big_tail import _conv1_tile_loop, _conv2_halo_tiles
from vr_video_generator_tpu.ops.head_tail_pallas import head_tail_pallas
from vr_video_generator_tpu_torch.ops import head_tail as ht

torch.set_num_threads(2)
torch.set_grad_enabled(False)

SRC = pathlib.Path(ht.__file__).resolve().parents[1] / "csrc" \
    / "head_tail_big.cu"
# The core's tile for conv1 at C = 128: 256 GEMM rows (8 image rows x 32
# pixels) by all 64 output channels (m64n64k16 products).
BASE_TILE = (256, 64)


def _weights(rng, c, dtype):
    """Seeded row-15 weights in PyTorch layout: conv1, its bias, conv2, its
    bias, the 1x1, its bias."""
    c2, c3 = c // 2, 32
    shapes = [((c2, c, 3, 3), (9 * c) ** -0.5, 0.0), ((c2,), 0.1, 0.0),
              ((c3, c2, 3, 3), (9 * c2) ** -0.5, 0.0), ((c3,), 0.1, 0.0),
              ((1, c3, 1, 1), c3 ** -0.5, 0.0), ((1,), 0.1, 0.5)]
    return [torch.from_numpy((rng.standard_normal(s) * k + o)
                             .astype(np.float32)).to(dtype)
            for s, k, o in shapes]


# The whole plain version as the kernels were held against it before the
# stages existed.
def _parent_head_tail_plain(path1, k1, b1, k2, b2, k3, b3, out_hw):
    dt, f32 = path1.dtype, torch.float32
    h1, w1 = out_hw
    c1 = F.conv2d(path1.permute(0, 3, 1, 2).float(), k1.to(dt).float(),
                  padding=1)
    c1 = (c1 + b1.to(f32)[:, None, None]).to(dt)
    wtb = ht._resize_matrix(c1.shape[3], w1, dt, c1.device)
    c1w = torch.einsum("bchw,vw->bchv", c1.float(), wtb).to(dt)
    r = ht._hlerp(c1w.float(), h1, 2).to(dt)
    y = F.conv2d(r.float(), k2.to(dt).float(), padding=1)
    y = F.relu(b2.float()[None, :, None, None] + y)
    res = (y * k3[0, :, 0, 0].float()[:, None, None]).sum(dim=1) + b3.float()
    return F.relu(res)


# Every width the tail takes, odd and ragged grids, f32 and bf16; path1 as
# the model hands it over (NCHW seen as NHWC).
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h2,w2,c", [(2, 10, 14, 32), (1, 14, 22, 64),
                                       (2, 9, 18, 128)])
def test_head_tail_stages_compose_to_whole_plain(b, h2, w2, c, dtype):
    rng = np.random.default_rng(h2 * w2 + c)
    dt = getattr(torch, dtype)
    path1 = torch.from_numpy(rng.standard_normal((b, c, h2, w2))
                             .astype(np.float32)).to(dt).permute(0, 2, 3, 1)
    wts = _weights(rng, c, dt)
    k1, b1, k2, b2, k3, b3 = wts
    out_hw = (h2 * 7 // 4, w2 * 7 // 4)
    c1, r, depth = ht.head_tail_stages(path1, *wts, out_hw)
    assert torch.equal(c1, ht.base_conv1_plain(path1, k1, b1))
    assert torch.equal(r, ht.ext_resize_plain(c1, out_hw))
    assert torch.equal(depth, ht.big_conv2_plain(r, k2, b2, k3, b3))
    assert c1.shape == (b, h2, w2, c // 2) and c1.dtype == dt
    assert r.shape == (b, *out_hw, c // 2) and r.dtype == dt
    assert depth.shape == (b, *out_hw) and depth.dtype == torch.float32
    assert torch.equal(depth, _parent_head_tail_plain(path1, *wts, out_hw))
    assert torch.equal(ht.head_tail_plain(path1, *wts, out_hw), depth)
    assert torch.equal(ht.head_tail(path1, *wts, out_hw), depth)


@pytest.mark.parametrize("h2,w2,c", [(72, 128, 64), (24, 40, 128)])
def test_head_tail_stages_match_pallas_interpret(h2, w2, c):
    """The stages composed, in f32, against head_tail_pallas in TPU
    interpret mode within 2e-4 (tests/test_head_tail.py, and
    tests/test_torch_base_tail.py for the whole plain version)."""
    h1, w1 = h2 * 14 // 8, w2 * 14 // 8
    args = _tail_args(np.random.default_rng(h2 * w2 + c + 1), 2, h2, w2, c,
                      jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_pallas(
            *(jnp.asarray(a) for a in args), (h1, w1), interpret=True))
    x, k1, b1, k2, b2, k3, b3 = args
    f32 = torch.float32
    *_, ours = ht.head_tail_stages(
        _t(x, f32), _hwio(k1, f32), _t(b1, f32), _hwio(k2, f32),
        _t(b2, f32), _hwio(k3, f32), _t(b3, f32), (h1, w1))
    assert ours.shape == ref.shape == (2, h1, w1)
    assert np.abs(ours.numpy() - ref).max() <= 2e-4


def _int_conv1(rng, b, h, w, c):
    """Small integers in path1 and integer conv1 weights and bias: every
    product and sum is exact in f32 and bf16."""
    c2 = c // 2
    x = torch.from_numpy(rng.integers(-3, 4, (b, h, w, c)).astype(np.float32))
    k1 = torch.from_numpy(rng.integers(-2, 3, (c2, c, 3, 3))
                          .astype(np.float32))
    b1 = torch.from_numpy(rng.integers(-4, 5, (c2,)).astype(np.float32))
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), k1.double(),
                    b1.double(), padding=1).permute(0, 2, 3, 1)
    return x, k1, b1, want


def _chain_weights(c, k1, b1, k2=None):
    """The weights the row-15 wrapper hands vrvg_head_tail at path1 width
    ``c``: (conv1, conv2, b1, b2, the 1x1, b3)."""
    c2 = c // 2
    k2 = torch.zeros((32, c2, 3, 3)) if k2 is None else k2
    return ht._base_weights(k1, b1, k2, torch.zeros(32),
                            torch.zeros((1, 32, 1, 1)), torch.zeros(1))


# conv1 on the GEMM core at C = 128 on BASE_TILE tiles; ragged heights and
# widths.
@pytest.mark.parametrize("b,h,w", [(1, 3, 38), (2, 10, 70), (1, 9, 33)])
def test_base_conv1_core_tile_loop_equals_conv2d(b, h, w):
    """The core's tile loop (Conv3x3Layout) on the (C2, 9 C) weights the
    wrapper hands it, + b1 in f32 before the cast (BiasBeforeCast):
    F.conv2d with zero padding and the bias, bit for bit."""
    rng = np.random.default_rng(h * w)
    x, k1, b1, want = _int_conv1(rng, b, h, w, 128)
    w1m, _, b1f, *_ = _chain_weights(128, k1, b1)
    assert w1m.shape == (BASE_TILE[1], 9 * 128)
    assert w1m.dtype == torch.bfloat16 and b1f.dtype == torch.float32
    got = _conv1_tile_loop(x, w1m, BASE_TILE[0]) + b1f.double()
    assert torch.equal(got, want)


# conv1 on the halo-tile kernel at C = 64 (Conv1Out): ragged tiles against 2
# rows x 128 pixels.
@pytest.mark.parametrize("b,h,w", [(1, 5, 130), (2, 3, 37)])
def test_base_conv1_halo_tiles_equal_conv2d(b, h, w):
    rng = np.random.default_rng(h + w)
    x, k1, b1, want = _int_conv1(rng, b, h, w, 64)
    w1m, _, b1f, *_ = _chain_weights(64, k1, b1)
    assert w1m.shape == (9 * 32, 64) and w1m.dtype == torch.bfloat16
    got = _conv2_halo_tiles(x, w1m) + b1f.double()
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [64, 128])
def test_base_conv2_weights_equal_conv2d(c):
    """conv2 (C2 -> 32) on the halo tiles with the rows the wrapper hands
    the back (C2 = 32 at vits, 64 at vitb)."""
    rng = np.random.default_rng(c)
    c2 = c // 2
    r = torch.from_numpy(rng.integers(-3, 4, (2, 5, 37, c2)).astype(np.float32))
    k2 = torch.from_numpy(rng.integers(-2, 3, (32, c2, 3, 3))
                          .astype(np.float32))
    _, w2m, *_ = _chain_weights(c, torch.zeros((c2, c, 3, 3)),
                                torch.zeros(c2), k2)
    assert w2m.shape == (9 * 32, c2)
    want = F.conv2d(r.permute(0, 3, 1, 2).double(), k2.double(),
                    padding=1).permute(0, 2, 3, 1)
    assert torch.equal(_conv2_halo_tiles(r, w2m), want)


def test_base_wmma_weights_are_taps_by_channels():
    """At C = 32 the wmma chain reads conv1 and conv2 as (3, 3, in, out):
    the sum over taps of each shifted input pixel times its tap's matrix is
    F.conv2d."""
    rng = np.random.default_rng(32)
    x, k1, b1, want = _int_conv1(rng, 1, 6, 9, 32)
    wt1, wt2, *_ = _chain_weights(32, k1, b1)
    assert wt1.shape == (3, 3, 32, 16) and wt2.shape == (3, 3, 16, 32)
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    got = sum(xp[:, dh:dh + 6, dw:dw + 9] @ wt1[dh, dw].double()
              for dh in range(3) for dw in range(3)) + b1.double()
    assert torch.equal(got, want)


def test_base_core_permuted_weights_fail():
    """The emulation catches a wrong B layout: PyTorch's own (O, I * 9)
    order (k = 9 c + tap) in place of the core's (k = tap C + c)."""
    rng = np.random.default_rng(5)
    x, k1, b1, want = _int_conv1(rng, 1, 9, 33, 128)
    wrong = k1.reshape(64, 9 * 128).to(torch.bfloat16)
    got = _conv1_tile_loop(x, wrong, BASE_TILE[0]) + b1.double()
    assert not torch.equal(got, want)


def test_base_dispatch_matches_the_source():
    """vrvg_head_tail runs conv1 on the kernel whose weight layout the
    wrapper builds at each width: head_tail_wmma (csrc/head_tail.cu) at C =
    32, the halo kernel's Conv1Out where the chain's C2 is 32 (C = 16 to
    64, C zero-padded to 64), the core on the tiles this file emulates
    (BASE_TILE, conv1_core's narrow tile) at C2 up to 64, wider tiles
    beyond; every other width through bf16_widths."""
    text = SRC.read_text()
    body = text[text.index('extern "C" int vrvg_head_tail('):]
    body = body[:body.index("\n}\n")]
    assert re.search(r"const bool wmma = cin == 32 && c == 32 && c2 == 16 "
                     r"&& layout == 0;", body)
    assert re.search(r"if \(!wmma && !bf16_widths\(cin, c, c2\)\)", body)
    assert re.search(r"if \(wmma\) \{\s*return head_tail_wmma\(", body)
    halo = re.search(r"if \(c2 == 32\) \{\s*err = conv2::launch<conv2::"
                     r"Conv1Out>", body)
    core = re.search(r"conv1_core\(x, k1, c1, .*?BiasBeforeCast.*?"
                     r"c2 <= 64, stream\)", body, flags=re.S)
    assert halo and core
    narrow = text[text.index("int conv1_core("):]
    tile = re.search(r"if \(narrow\) \{\s*return tma_gemm::conv3x3<tma_gemm::"
                     r"Tile<(\d+), (\d+)>>", narrow)
    assert tile and (int(tile[1]), int(tile[2])) == BASE_TILE
    kinds = {}
    for c in (16, 32, 48, 64, 96, 128, 256):
        k1, k2 = torch.zeros((c // 2, c, 3, 3)), torch.zeros((32, c // 2, 3, 3))
        w1 = _chain_weights(c, k1, torch.zeros(c // 2), k2)[0]
        cp, c2p = ht.chain_widths(c, torch.bfloat16)
        kinds[c] = ("wmma" if w1.shape == (3, 3, 32, 16) else
                    "halo" if w1.shape == (9 * 32, cp) and c2p == 32 else
                    "core" if w1.shape == (c2p, 9 * cp) else w1.shape)
    assert kinds == {16: "halo", 32: "wmma", 48: "halo", 64: "halo",
                     96: "core", 128: "core", 256: "core"}
