"""PyTorch port, the DPT tails (rows 7, 11 + 12 and 15) at every width the
JAX planners send them, on the CPU.

The JAX kernels take a head of any C whose C2 = C / 2 is a multiple of 8,
the big-C tail besides C <= 128 or a multiple of 128; the port's chains
take the same widths at bf16 and f32 by zero padding C and C2 up to the
widths their kernels' channel slices take (ops/head_tail.chain_widths).
Held here:
(a) the port's copy of the JAX planners (ext_pick_block_rows,
    big_pick_plan, plan_tail) against the JAX package's over C = 16 to 1024
    at inputs 126, 252, 518 and 728 (1080p), bf16 and f32;
(b) the routing: resolve_tail on the card and check_f32_plan raise nothing
    wherever the JAX kernels take the plan, and ValueError naming the JAX
    assert where they do not, as the JAX kernels themselves raise (in
    interpret mode) and as the wrappers raise on CPU tensors;
(d) the zero padding: pad_to, the weights each wrapper builds (padded rows,
    columns and biases zeros, the head's own entries those of the unpadded
    layout), ``cw``'s padded columns zeros; the padded f32 convs' sums bit
    for bit the unpadded sums on the 3xTF32 core's model; conv1's padded
    columns exact zeros after BiasStore; the padded chains' plain versions
    against the unpadded ones within 64 f32 ulps of each output's largest
    value (a sum over more terms, some zero, in another order), their
    padded channels exact zeros;
(f) csrc/head_tail_big.cu's width rules and tile dispatch read from the
    source against chain_widths, and the entry points' signatures in
    kernels/build.py against the source; the wrappers (the library faked:
    no GPU here) hand each entry point the padded widths and layouts.
(c) and (e), against the Pallas kernels in interpret mode, are in
tests/test_torch_tail_widths_jax.py. Needs g++ (C++20) for (d)'s BiasStore.
"""

import dataclasses
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_base_tail_3xtf32 import lib  # noqa: F401
from tests.test_torch_conv_3xtf32 import unfold_rows
from tests.test_torch_conv_3xtf32_rcu_ext import (bias_epilogue,
                                                  model_conv_sums, seeded)
from tests.test_torch_gemm_3xtf32 import K_STEP, f64, trunc_f32
from vr_video_generator_tpu.ops import head_tail_pallas as jht
from vr_video_generator_tpu_torch import RunConfig
from vr_video_generator_tpu_torch.kernels import build
from vr_video_generator_tpu_torch.models.dpt import resolve_tail
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.preprocess import network_input_size
from vr_video_generator_tpu_torch.pipeline import check_f32_plan

torch.set_num_threads(2)
torch.set_grad_enabled(False)

SRC = pathlib.Path(ht.__file__).resolve().parents[1] / "csrc" \
    / "head_tail_big.cu"
SIZES = (126, 252, 518, 728)
WIDTHS = range(16, 1025, 16)
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}
BF16, F32 = torch.bfloat16, torch.float32


def _geometry(size):
    """refinenet1's pre-upsample (H0, W0) and the net's size at 1080p."""
    nh, nw = network_input_size(1080, 1920, target=size, multiple_of=14)
    return (4 * nh // 14, 4 * nw // 14), (nh, nw)


def _jax_choice(shape, jdt, out_hw):
    c2 = shape[-1] // 2
    if jht.ext_pick_block_rows(shape, c2, jdt, out_hw) is not None:
        return "ext"
    if jht.big_pick_plan(shape, c2, jdt, out_hw) is not None:
        return "big"
    return None


def _jax_takes(c, tail):
    """The JAX kernels' asserts (head_tail_pallas.py:174, 395, 683-684)."""
    c2, cpr = c // 2, (c if c <= 128 else 128)
    return c2 % 8 == 0 and (tail != "big" or c % cpr == 0)


# --- (a) the planners --------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", SIZES)
def test_planners_match_jax(size, dtype):
    """(a) ext_pick_block_rows, big_pick_plan and plan_tail equal the JAX
    package's over C = 16 to 1024 in steps of 16; the batch does not enter
    the plan."""
    tdt, jdt = DTYPES[dtype]
    grid, out_hw = _geometry(size)
    for c in WIDTHS:
        shape = (8, *grid, c)
        assert ht.ext_pick_block_rows(shape, c // 2, tdt, out_hw) == \
            jht.ext_pick_block_rows(shape, c // 2, jdt, out_hw), c
        want = jht.big_pick_plan(shape, c // 2, jdt, out_hw)
        got = ht.big_pick_plan(shape, c // 2, tdt, out_hw)
        assert (got is None) == (want is None) and (
            got is None or tuple(got) == tuple(want)), c
        assert ht.plan_tail(shape, tdt, out_hw) == \
            _jax_choice(shape, jdt, out_hw) == \
            ht.plan_tail((1, *grid, c), tdt, out_hw), c


# The widths the port refused before the zero padding and the JAX package
# runs, with the tail it plans (1080p).
NEWLY_TAKEN = {
    (728, "bfloat16"): {"ext": (16, 48, 80, 96, 112)},
    (518, "bfloat16"): {"ext": (16, 48, 80, 96, 112, 144)},
    (252, "bfloat16"): {"ext": tuple(c for c in range(16, 321, 16)
                                     if c not in (32, 64, 128, 256)),
                        "big": (512, 640)},
    (126, "bfloat16"): {"ext": tuple(c for c in range(16, 529, 16)
                                     if c not in (32, 64, 128, 256, 384)),
                        "big": (640, 768, 896)},
    (728, "float32"): {"ext": (16, 48), "big": (80, 96)},
    (518, "float32"): {"ext": (16, 48), "big": (80, 96, 112)},
    (252, "float32"): {"ext": (16, 48, 80, 96, 112, 144, 160)},
    (126, "float32"): {"ext": tuple(c for c in range(16, 241, 16)
                                    if c not in (32, 64, 128)),
                       "big": (512,)},
}


@pytest.mark.parametrize("size,dtype", list(NEWLY_TAKEN))
def test_new_widths_plan_and_route(size, dtype):
    """(a, b) Each width the port refused before and the JAX package runs
    plans the tail named, resolve_tail on the card returns it at 'fused'
    and 'auto', and check_f32_plan passes it at f32."""
    tdt, _ = DTYPES[dtype]
    grid, out_hw = _geometry(size)
    for tail, widths in NEWLY_TAKEN[(size, dtype)].items():
        for c in widths:
            shape = (8, *grid, c)
            assert ht.plan_tail(shape, tdt, out_hw) == tail, (c, tail)
            for mode in ("fused", "auto"):
                assert resolve_tail(mode, shape, tdt, out_hw, "cuda") == tail
            if tdt == F32:
                check_f32_plan(_custom_head(c, size), 1080, 1920)


# --- (b) the routing ---------------------------------------------------------

def _custom_head(c, size, tail="auto"):
    """A RunConfig (vits, batch 8, f32) whose model() has a head of ``c``
    features (chip_smoke.with_model's stand-in)."""
    cfg = RunConfig(encoder="vits", compute_dtype="float32", mlp_fused="xla",
                    tail=tail, input_size=size)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    model = dataclasses.replace(cfg.model(), features=c)
    return types.SimpleNamespace(**fields, model=lambda: model)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", SIZES)
def test_routing_follows_the_jax_asserts(size, dtype):
    """(b) Over C = 8 to 1024 in steps of 8: where the planned tail's JAX
    kernel takes C, resolve_tail on the card returns the plan and
    check_f32_plan passes; where it asserts (C2 % 8, or the big-C tail at C
    > 128 no multiple of 128), both raise ValueError naming the assert, on
    the CPU (tail='fused') and the card alike. 'xla' never raises."""
    tdt, jdt = DTYPES[dtype]
    grid, out_hw = _geometry(size)
    refused = set()
    for c in range(8, 1025, 8):
        shape = (8, *grid, c)
        plan = _jax_choice(shape, jdt, out_hw)
        assert resolve_tail("xla", shape, tdt, out_hw, "cuda") is None
        if plan is None or _jax_takes(c, plan):
            assert ht.takes(c, plan or "ext") or plan is None
            for device in ("cpu", "cuda"):
                assert resolve_tail("fused", shape, tdt, out_hw,
                                    device) == plan
            if tdt == F32:
                check_f32_plan(_custom_head(c, size), 1080, 1920)
            continue
        refused.add(plan)
        assert not ht.takes(c, plan)
        line = {"ext": "395", "big": "684"}[plan]
        for device in ("cpu", "cuda"):
            with pytest.raises(ValueError,
                               match=f"head_tail_pallas.py:{line}"):
                resolve_tail("fused", shape, tdt, out_hw, device)
        if tdt == F32:
            with pytest.raises(ValueError, match="head_tail_pallas.py"):
                check_f32_plan(_custom_head(c, size, "fused"), 1080, 1920)
    assert "ext" in refused


def _jax_case(c, h0=4, w0=6, seed=0):
    rng = np.random.default_rng(seed)
    c2 = c // 2
    shapes = [(1, h0, w0, c), (1, 1, c, c), (c,), (3, 3, c, c2), (c2,),
              (3, 3, c2, 32), (32,), (1, 1, 32, 1), (1,)]
    return [jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.1)
            for s in shapes]


@pytest.mark.parametrize("tail,c", [("ext", 40), ("ext", 24), ("big", 160),
                                    ("big", 200), ("base", 40)])
def test_refused_widths_raise_in_jax_and_the_port(tail, c):
    """(b) Where the JAX kernel asserts (interpret mode), the port's wrapper
    raises ValueError on CPU tensors too, naming the assert; the plain
    version computes nothing there."""
    args = _jax_case(c)
    out_hw = (7, 10)
    jax_fn = {"ext": jht.head_tail_ext_pallas, "big": jht.head_tail_big_pallas,
              "base": jht.head_tail_pallas}[tail]
    jargs = args if tail != "base" else [args[0], *args[3:]]
    with pytest.raises(AssertionError):
        jax_fn(*jargs, out_hw, interpret=True)
    pt = [torch.from_numpy(np.array(a)) for a in jargs]
    pt = [pt[0]] + [a.permute(3, 2, 0, 1) if a.ndim == 4 else a
                    for a in pt[1:]]
    fns = {"ext": (ht.head_tail_ext, ht.head_tail_ext_stages),
           "big": (ht.head_tail_big, ht.head_tail_big_stages),
           "base": (ht.head_tail, ht.head_tail_stages)}[tail]
    for fn in fns:
        with pytest.raises(ValueError, match="head_tail_pallas.py"):
            fn(*pt, out_hw)
    assert not ht.takes(c, tail)


# --- (d) the zero padding ----------------------------------------------------

def test_chain_widths_and_pad_to():
    """(d) chain_widths: every encoder's head unpadded at both dtypes; a
    custom head's C up to a multiple of 64 (bf16) or 32 (f32), C2 up to a
    multiple of 16, at least 32 (bf16) or of 32 (f32). pad_to pads the
    leading dims with zeros and returns an unpadded tensor as it is."""
    for c in (64, 128, 256, 384, 512, 640, 768, 896):
        assert ht.chain_widths(c, BF16) == (c, c // 2)
    for c in (64, 128, 256, 384, 512):
        assert ht.chain_widths(c, F32) == (c, c // 2)
    assert [ht.chain_widths(c, BF16) for c in (16, 48, 80, 96, 112, 144,
                                               528)] == \
        [(64, 32), (64, 32), (128, 48), (128, 48), (128, 64), (192, 80),
         (576, 272)]
    assert [ht.chain_widths(c, F32) for c in (16, 32, 48, 96, 160, 240)] == \
        [(32, 32), (32, 32), (64, 32), (96, 64), (160, 96), (256, 128)]
    k = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3) + 1
    kp = ht.pad_to(k, 4, 5)
    assert kp.shape == (4, 5, 3, 3) and torch.equal(kp[:2, :3], k)
    assert int((kp != 0).sum()) == k.numel()
    assert ht.pad_to(k, 2, 3) is k
    b = torch.ones(3)
    assert torch.equal(ht.pad_to(b, 5), torch.tensor([1., 1, 1, 0, 0]))


def _tail_wts(c, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    c2 = c // 2
    return [seeded(rng, s, k).to(dtype) for s, k in (
        ((c, c, 1, 1), c ** -0.5), ((c,), 0.1),
        ((c2, c, 3, 3), (9 * c) ** -0.5),
        ((c2,), 0.1), ((32, c2, 3, 3), (9 * c2) ** -0.5), ((32,), 0.1),
        ((1, 32, 1, 1), 32 ** -0.5))] + [seeded(rng, (1,), 0.1, 0.5).to(dtype)]


def _k_index(cp, c):
    """The (3 dh + dw) Cp + i columns of a padded GEMM weight that hold the
    head's own channels i < C, in the unpadded (3 dh + dw) C + i order."""
    return torch.tensor([t * cp + i for t in range(9) for i in range(c)])


def _rows_index(c):
    """The halo kernel's rows (3 dh + dw) 32 + n of its outputs n < c."""
    return torch.tensor([t * 32 + n for t in range(9) for n in range(c)])


@pytest.mark.parametrize("c", [16, 48, 80, 144])
def test_ext_weights_are_zero_padded(c):
    """(d) _ext_weights (bf16) at a custom head: the mix (Cp, Cp), conv1 as
    the halo kernel's rows (C2p = 32) or the GEMM's B, conv2's rows, b_oc
    and b1, each the unpadded layout's entries at the head's channels and
    zeros elsewhere."""
    wts = _tail_wts(c, seed=c)
    k_oc, b_oc, k1, b1, k2 = wts[:5]
    cp, c2p = ht.chain_widths(c, BF16)
    c2 = c // 2
    koc, w1, w2, boc, b1f, b2f, w3f, b3f = ht._ext_weights(*wts)
    assert koc.shape == (cp, cp) and torch.equal(
        koc[:c, :c], k_oc[:, :, 0, 0].to(BF16))
    assert int(koc.count_nonzero()) == int(koc[:c, :c].count_nonzero())
    if c2p == 32:
        assert w1.shape == (9 * 32, cp)
        real = w1[_rows_index(c2)][:, :c]
        assert torch.equal(real, ht.conv2_weights(k1)[:, :c])
    else:
        assert w1.shape == (c2p, 9 * cp)
        real = w1[:c2][:, _k_index(cp, c)]
        assert torch.equal(real, ht.conv3x3_gemm_weights(k1))
    assert int(w1.count_nonzero()) == int(real.count_nonzero())
    assert w2.shape == (9 * 32, c2p)
    assert torch.equal(w2[:, :c2], ht.conv2_weights(k2))
    assert not w2[:, c2:].any()
    for v, t, n in ((boc, b_oc, cp), (b1f, b1, c2p)):
        assert v.shape == (n,) and torch.equal(v[:t.shape[0]], t)
        assert not v[t.shape[0]:].any()


@pytest.mark.parametrize("c", [16, 48, 80, 160])
def test_f32_weights_are_zero_padded_splits(c):
    """(d) _ext_f32_weights, _base_f32_weights and _big_f32_weights at a
    custom head: each split plane (2, 128 ceil(N / 128), K) holds the
    unpadded split's words at the head's rows and k columns and zeros
    elsewhere (a split of a zero is two zeros); b1 zero-padded; the big-C
    tail's conv1 the fold over the head's own channels, then padded."""
    wts = _tail_wts(c, seed=c + 1)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    cp, c2p = ht.chain_widths(c, F32)
    c2 = c // 2
    kocs, w1s, w2s, boc, b1f, *_ = ht._ext_f32_weights(*wts)
    base = ht._base_f32_weights(k1, b1, k2, b2, k3, b3)
    big = ht._big_f32_weights(k_oc, k1, k2, b2, k3, b3)
    mix = mlp.tf32x3_split_kernel(k_oc[:, :, 0, 0].contiguous())
    assert kocs.shape[2] == cp and torch.equal(kocs[:, :c, :c], mix[:, :c])
    fold = ht.fold_conv1(k_oc, k1, F32)
    for got, k, n, kk in ((w1s, k1, c2, cp), (base[0], k1, c2, cp),
                          (big[0], fold, c2, cp), (w2s, k2, 32, c2p),
                          (base[1], k2, 32, c2p), (big[1], k2, 32, c2p)):
        want = ht._conv_split(k)
        assert got.shape[2] == 9 * kk
        real = got[:, :n][:, :, _k_index(kk, k.shape[1])]
        assert torch.equal(real, want[:, :n])
        assert int(got.count_nonzero()) == int(real.count_nonzero())
    for v, t, n in ((boc, b_oc, cp), (b1f, b1, c2p), (base[2], b1, c2p)):
        assert v.shape == (n,) and torch.equal(v[:t.shape[0]], t)
        assert not v[t.shape[0]:].any()


@pytest.mark.parametrize("c", [16, 80, 112])
def test_big_weights_and_bias_are_zero_padded(c):
    """(d) The bf16 big-C front's conv1 (the fold over the head's channels,
    cast, then padded to (C2p, 9 Cp)), conv2's rows, and ``cw`` (computed on
    the head's weights as the plain version computes it) with exact zeros
    in its padded columns."""
    wts = _tail_wts(c, seed=c + 2)
    k_oc, b_oc, k1, b1, k2 = wts[:5]
    cp, c2p = ht.chain_widths(c, BF16)
    c2 = c // 2
    w1m = ht.conv1_weights(k_oc, k1)
    assert w1m.shape == (c2p, 9 * cp)
    real = w1m[:c2][:, _k_index(cp, c)]
    assert torch.equal(real, ht.conv3x3_gemm_weights(
        ht.fold_conv1(k_oc, k1, BF16)))
    assert int(w1m.count_nonzero()) == int(real.count_nonzero())
    w2m = ht._padded_conv2(k2, c2p)
    assert w2m.shape == (9 * 32, c2p) and not w2m[:, c2:].any()
    assert torch.equal(w2m[:, :c2], ht.conv2_weights(k2))
    cw = ht._padded_bias(k1, b_oc, b1, 14, 23, c2p)
    assert cw.shape == (3, 23, c2p) and not cw[..., c2:].any()
    assert torch.equal(cw[..., :c2], ht.big_tail_bias(k1, b_oc, b1, 14, 23))


@pytest.mark.parametrize("c", [16, 48, 96, 144])
def test_base_weights_are_zero_padded(c):
    """(d) _base_weights (bf16) off the wmma chain: conv1 as the halo rows
    (C2p = 32) or the GEMM's B over (C2p, 9 Cp), conv2's rows, b1, each the
    unpadded layout's entries at the head's channels, zeros elsewhere."""
    wts = _tail_wts(c, seed=c + 3)[2:]
    k1, b1, k2 = wts[:3]
    cp, c2p = ht.chain_widths(c, BF16)
    c2 = c // 2
    w1, w2, b1f, *_ = ht._base_weights(*wts)
    if c2p == 32:
        real = w1[_rows_index(c2)][:, :c]
        assert w1.shape == (9 * 32, cp) and torch.equal(
            real, ht.conv2_weights(k1)[:, :c])
    else:
        real = w1[:c2][:, _k_index(cp, c)]
        assert w1.shape == (c2p, 9 * cp) and torch.equal(
            real, ht.conv3x3_gemm_weights(k1))
    assert int(w1.count_nonzero()) == int(real.count_nonzero())
    assert w2.shape == (9 * 32, c2p) and not w2[:, c2:].any()
    assert b1f.shape == (c2p,) and not b1f[c2:].any()


def _ragged_conv_sums(x, k):
    """The core's sums of the 3x3 conv of x (B, H, W, C) by k (N, C, 3, 3)
    summed as a conv whose 32-channel slices hold only the head's C
    channels (the last one fewer): per (slice, tap) stage a fresh
    truncating sum over its k-steps (lo.hi and hi.lo, then hi.hi, as
    tests/test_torch_gemm_3xtf32.core_sums orders them), the stages added
    in f32 in the kernel's order. C a multiple of 8 (a k-step)."""
    b, h, w, c = x.shape
    a = unfold_rows(x)
    planes = ht._conv_split(k)
    ah, al = mlp.tf32x3_split_plain(a)
    ah, al, bh, bl = f64(ah, al, planes[0], planes[1])
    total = torch.zeros((a.shape[0], planes.shape[1]))
    for s0 in range(0, c, 32):
        for tap in range(9):
            cols = range(tap * c + s0, tap * c + min(s0 + 32, c), K_STEP)
            seq = [p for kk in cols for p in ((al, bh, kk), (ah, bl, kk))]
            seq += [(ah, bh, kk) for kk in cols]
            acc = torch.zeros_like(total, dtype=torch.float64)
            for u, v, kk in seq:
                acc = trunc_f32(acc + u[:, kk:kk + K_STEP]
                                @ v[:, kk:kk + K_STEP].T).double()
            total = total + acc.float()
    n = k.shape[0]
    return total[:, :n].reshape(b, h, w, n)


@pytest.mark.parametrize("c,n", [(48, 24), (80, 40), (24, 32), (40, 32)],
                         ids=["conv1-48", "conv1-80", "conv2-24",
                              "conv2-40"])
def test_padded_f32_conv_sums_equal_unpadded(c, n):
    """(d) An f32 conv as the chains run it at a custom head (x with its C
    channels zero-padded to a multiple of 32, k with zero weights for them,
    and zero output rows past n up to the chain's C2): its sums on the
    3xTF32 core's model equal, bit for bit, the sums over the head's own
    channels, each stage a fresh truncating sum; the padded outputs are
    zeros. conv1 at C = 48, 80 (C2 = 24, 40 of 32, 64); conv2 on C2 = 24,
    40 channels."""
    rng = np.random.default_rng(c + n)
    x = seeded(rng, (2, 5, 9, c))
    k = seeded(rng, (n, c, 3, 3), (9 * c) ** -0.5)
    cp, np_ = -(-c // 32) * 32, -(-n // 32) * 32
    got = model_conv_sums(F.pad(x, (0, cp - c)), ht.pad_to(k, np_, cp))
    assert got.shape[-1] == np_ and not got[..., n:].any()
    assert torch.equal(got[..., :n], _ragged_conv_sums(x, k))


def test_padded_conv1_columns_after_bias(lib):
    """(d) conv1 + b1 (BiasStore) at C = 48, f32: 32 output columns, the
    split's rows and b1 past 24 zeros: exact zeros there, and the first 24
    columns those of the unpadded conv, bit for bit."""
    rng = np.random.default_rng(48)
    x = seeded(rng, (2, 6, 11, 48))
    k1, b1 = seeded(rng, (24, 48, 3, 3), (9 * 48) ** -0.5), seeded(
        rng, (24,), 0.1)
    got = bias_epilogue(lib, model_conv_sums(F.pad(x, (0, 16)),
                                             ht.pad_to(k1, 32, 64)),
                        ht.pad_to(b1, 32))
    assert got.shape[-1] == 32 and not got[..., 24:].any()
    assert torch.equal(got[..., :24],
                       bias_epilogue(lib, _ragged_conv_sums(x, k1), b1))


def _ulps64(t):
    return 64 * 2.0 ** (np.floor(np.log2(float(t.abs().max()))) - 23)


def _padded_args(x, wts, cp, c2p):
    """x and the tail weights zero-padded to the chain's widths."""
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    return (F.pad(x, (0, cp - x.shape[3])), ht.pad_to(k_oc, cp, cp),
            ht.pad_to(b_oc, cp), ht.pad_to(k1, c2p, cp), ht.pad_to(b1, c2p),
            ht.pad_to(k2, 32, c2p), b2, k3, b3)


@pytest.mark.parametrize("tail,c", [("ext", 16), ("ext", 48), ("ext", 144),
                                    ("big", 80), ("big", 112),
                                    ("base", 16), ("base", 96)])
def test_padded_plain_chain_matches_unpadded(tail, c):
    """(d) The plain stages at f32 on the zero-padded x and weights (the
    padded chain's plain version): every intermediate's padded channels
    exact zeros, its own channels and the depth within 64 f32 ulps of the
    output's largest value of the unpadded plain stages (the same sums over
    more terms, the extra ones zeros, possibly in another order)."""
    rng = np.random.default_rng(c)
    wts = _tail_wts(c, seed=c + 4)
    cp, c2p = ht.chain_widths(c, F32)
    out_hw = (17, 26)
    if tail == "base":
        x = seeded(rng, (2, 8, 12, c))
        px, _, _, pk1, pb1, pk2, *rest = _padded_args(x, wts, cp, c2p)
        got = ht.head_tail_stages(px, pk1, pb1, pk2, *rest, out_hw)
        want = ht.head_tail_stages(x, *wts[2:], out_hw)
        widths = (c // 2, c // 2)
    else:
        x = seeded(rng, (2, 4, 6, c))
        fn = ht.head_tail_ext_stages if tail == "ext" else \
            ht.head_tail_big_stages
        if tail == "big":
            assert ht.takes(cp, "big") and ht.takes(c, "big")
        got = fn(*_padded_args(x, wts, cp, c2p), out_hw)
        want = fn(x, *wts, out_hw)
        widths = (c, c, c // 2, c // 2) if tail == "ext" else \
            (c, c // 2, c // 2)
    for g, w, n in zip(got[:-1], want[:-1], widths):
        assert not g[..., n:].any()
        assert (g[..., :n] - w).abs().max() <= _ulps64(w)
    assert (want[-1] > 0).float().mean() > 0.2
    assert (got[-1] - want[-1]).abs().max() <= _ulps64(want[-1])


# --- (f) the width dispatch in the source ------------------------------------

def _c_body(text, head):
    start = text.index(head)
    return text[start:text.index("\n}\n", start)]


def _c_rule(name):
    """csrc/head_tail_big.cu's ``inline bool name(int cin, int c, int c2)``
    as a Python function (its return expression, && and || translated)."""
    body = _c_body(SRC.read_text(), f"inline bool {name}(int cin, int c, "
                                    f"int c2)")
    expr = re.search(r"return (.*?);", body, flags=re.S)[1]
    expr = " ".join(expr.replace("&&", " and ").replace("||", " or ").split())
    return eval(f"lambda cin, c, c2: {expr}")  # noqa: S307


def test_width_rules_in_the_source_match_chain_widths():
    """(f) bf16_widths and f32_widths as written: each custom head's
    chain_widths satisfies its dtype's rule, and they are the least widths
    that do (a narrower Cp or C2p of the rule's step would not hold the
    head's channels or fails the rule); a head's C above the chain's, or a
    width off the slices, fails."""
    rules = {BF16: (_c_rule("bf16_widths"), 64, 16),
             F32: (_c_rule("f32_widths"), 32, 32)}
    for dt, (rule, cstep, c2step) in rules.items():
        for c in range(16, 1025, 16):
            cp, c2p = ht.chain_widths(c, dt)
            assert rule(c, cp, c2p), (dt, c)
            assert cp - cstep < c or not rule(c, cp - cstep, c2p)
            assert c2p - c2step < c // 2 or not rule(c, cp, c2p - c2step)
            assert not rule(cp + 1, cp, c2p)
    bf, f = rules[BF16][0], rules[F32][0]
    assert not bf(48, 48, 32) and not bf(64, 64, 24) and not bf(64, 64, 16)
    assert not f(16, 16, 32) and not f(64, 64, 48)


def test_entry_points_check_their_widths():
    """(f) Every chain's entry point refuses widths outside its dtype's rule
    before it launches anything; the bf16 back takes any C2 the rule takes;
    row 15 at bf16 keeps the wmma chain for a 32-feature head only."""
    text = SRC.read_text()
    checks = {"vrvg_head_tail_big_front": "!bf16_widths(cin, c, c2)",
              "vrvg_head_tail_big_back": "!bf16_widths(64, 64, c2)",
              "vrvg_head_tail_ext_front": "!bf16_widths(cin, c, c2)",
              "vrvg_head_tail": "!wmma && !bf16_widths(cin, c, c2)",
              "vrvg_head_tail_ext_f32": "!f32_widths(cin, c, c2)",
              "vrvg_head_tail_big_f32": "!f32_widths(cin, c, c2)",
              "vrvg_head_tail_f32": "!f32_widths(cin, c, c2)"}
    for name, check in checks.items():
        body = _c_body(text, f'extern "C" int {name}(')
        first = re.search(r"\{\s*(?:const bool wmma = [^;]*;\s*)?"
                          r"if \((.*?)\) return \(int\)cudaErrorInvalidValue;",
                          body, flags=re.S)
        assert first and first[1] == check, (name, first and first[1])
        assert "c != " not in body and "f32_c2" not in body


def _conv1_tile(n, narrow):
    """conv1_core's tile (BM, BN) at n output channels, as the source
    picks it."""
    body = _c_body(SRC.read_text(), "int conv1_core(")
    tiles = [tuple(map(int, t)) for t in
             re.findall(r"Tile<(\d+), (\d+)>>", body)]
    assert re.search(r"if \(narrow\) \{", body) and \
        re.search(r"if \(n % 192 == 0\) \{", body) and len(tiles) == 3
    return tiles[0] if narrow else tiles[1] if n % 192 == 0 else tiles[2]


def _f32_tile(n):
    """conv3x3_f32's column tile at n outputs, as the source picks it."""
    body = _c_body(SRC.read_text(), "int conv3x3_f32(const float* x")
    rules = re.findall(r"if \((.*?)\) \{\s*return tf32x3_gemm::conv3x3<(\d+)>",
                       body)
    assert [r[0] for r in rules] == ["n % 96 == 0", "n == 32"]
    assert re.search(r"return tf32x3_gemm::conv3x3<64>\(x, ws, batch, h, w, "
                     r"c, n, epi, stream\);\s*$", body)
    return 96 if n % 96 == 0 else 32 if n == 32 else 64


def test_conv1_tile_dispatch():
    """(f) conv1's tiles as read from the source: the encoders' widths keep
    their tiles (bf16 row 7 and 11: 256 x 128 up to C2 = 128, 128 x 192 at
    192; row 15 256 x 64 at C2 = 64; f32: 32 at C2 = 32, 64 at 64 and 128,
    96 at 192); every padded C2 runs on tiles that waste less than one
    tile's columns; the big-C tail's C2 = 256-448 (C = 512-896) on the same
    instantiations, several column tiles."""
    text = SRC.read_text()
    for name, narrow in (("vrvg_head_tail_big_front", "c2 < 64"),
                         ("vrvg_head_tail_ext_front", "c2 < 64"),
                         ("vrvg_head_tail(", "c2 <= 64")):
        body = _c_body(text, f'extern "C" int {name}')
        assert re.search(r"conv1_core\(.*?" + re.escape(narrow) +
                         r", stream\)", body, flags=re.S), name
    assert _conv1_tile(64, False) == (256, 128)
    assert _conv1_tile(128, False) == (256, 128)
    assert _conv1_tile(192, False) == (128, 192)
    assert _conv1_tile(64, True) == (256, 64)
    assert [_f32_tile(n) for n in (32, 64, 128, 192)] == [32, 64, 64, 96]
    for c in range(16, 1025, 16):
        for dt in (BF16, F32):
            if not ht.takes(c) and not ht.takes(c, "big"):
                continue
            c2p = ht.chain_widths(c, dt)[1]
            bn = _f32_tile(c2p) if dt == F32 else (
                32 if c2p == 32 else _conv1_tile(c2p, c2p < 64)[1])
            assert -(-c2p // bn) * bn - c2p < bn, (c, dt, c2p, bn)
    assert [_conv1_tile(n, False)[1] for n in (256, 320, 384, 448)] == \
        [128, 128, 192, 128]


def test_signatures_match_the_source():
    """(f) kernels/build.py's argument lists for the tail entry points
    match their C declarations: pointers and ints in order."""
    text = SRC.read_text()
    for name in ("vrvg_head_tail_big_front", "vrvg_head_tail_big_back",
                 "vrvg_head_tail_ext_front", "vrvg_head_tail",
                 "vrvg_head_tail_ext_f32", "vrvg_head_tail_big_f32",
                 "vrvg_head_tail_f32", "vrvg_conv3x3_f32"):
        decl = text[text.index(f'extern "C" int {name}('):]
        params = decl[decl.index("(") + 1:decl.index(")")].split(",")
        kinds = [build._P if "*" in p else build._I for p in params]
        assert build.SIGNATURES[name] == kinds, name


class FakeLibrary:
    """Stands in for the CUDA library: records each entry point called with
    its arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vrvg_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """The tail wrappers believe their tensors are on the card and call a
    FakeLibrary."""
    lib = FakeLibrary()
    for mod in (ht, mlp):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "stream_handle", lambda device: 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    return lib


# (wrapper, dtype, C): the entry points called and, for each, its (layout,
# CIN, C, C2) arguments from the end (before the output size and stream).
DISPATCH = [
    ("ext", BF16, 16, [("vrvg_head_tail_ext_front", (1, 16, 64, 32)),
                       ("vrvg_head_tail_big_back", 32)]),
    ("ext", BF16, 96, [("vrvg_head_tail_ext_front", (1, 96, 128, 48)),
                       ("vrvg_head_tail_big_back", 48)]),
    ("ext", BF16, 64, [("vrvg_head_tail_ext_front", (1, 64, 64, 32)),
                       ("vrvg_head_tail_big_back", 32)]),
    ("ext", F32, 48, [("vrvg_head_tail_ext_f32", (1, 48, 64, 32))]),
    ("big", BF16, 80, [("vrvg_head_tail_big_front", (1, 80, 128, 48)),
                       ("vrvg_head_tail_big_back", 48)]),
    ("big", BF16, 512, [("vrvg_head_tail_big_front", (1, 512, 512, 256)),
                        ("vrvg_head_tail_big_back", 256)]),
    ("big", F32, 96, [("vrvg_head_tail_big_f32", (1, 96, 96, 64))]),
    ("base", BF16, 16, [("vrvg_head_tail", (1, 16, 64, 32))]),
    ("base", BF16, 32, [("vrvg_head_tail", (0, 32, 32, 16))]),
    ("base", F32, 96, [("vrvg_head_tail_f32", (1, 96, 96, 64))]),
]


@pytest.mark.parametrize("tail,dtype,c,want", DISPATCH,
                         ids=[f"{t}-{str(d)[6:]}-{c}" for t, d, c, _ in
                              DISPATCH])
def test_wrappers_hand_the_padded_widths(fake_card, tail, dtype, c, want):
    """(f) On the card each wrapper calls its entry points with the chain's
    widths (chain_widths; the wmma chain at bf16's C = 32), an NCHW x seen
    as NHWC (the model's) as layout 1, and returns views of the head's own
    channels; a contiguous NHWC x narrower than the chain is layout 2."""
    wts = [w.to(dtype) for w in _tail_wts(c, seed=5)]
    if tail == "base":
        wts = wts[2:]
    x = torch.zeros((2, c, 4, 6), dtype=dtype).permute(0, 2, 3, 1)
    out_hw = (7, 10)
    fn = {"ext": ht.head_tail_ext_stages, "big": ht.head_tail_big_stages,
          "base": ht.head_tail_stages}[tail]
    if tail == "base" and dtype == BF16 and c == 32:
        fn = ht.head_tail
        x = x.contiguous()
    got = fn(x, *wts, out_hw)
    calls = [(n, a) for n, a in fake_card.calls if n != "vrvg_tf32x3_split"]
    assert [n for n, _ in calls] == [n for n, _ in want]
    for (name, args), (_, w) in zip(calls, want):
        if name == "vrvg_head_tail_big_back":
            assert args[13] == w
        elif name in ("vrvg_head_tail_ext_front", "vrvg_head_tail_big_front"):
            assert (args[1], *args[-4:-1]) == w
        else:
            assert (args[1], *args[-6:-3]) == w
    if isinstance(got, tuple):
        assert all(t.shape[-1] in (c, c // 2) for t in got[:-1])
    if want[0][1][2] != c:  # C padded: a contiguous NHWC x is copied
        fake_card.calls.clear()
        fn(x.contiguous(), *wts, out_hw)
        first = [a for n, a in fake_card.calls if n != "vrvg_tf32x3_split"][0]
        assert first[1] == 2
