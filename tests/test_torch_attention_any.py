"""PyTorch port, rows 2 and 17 at any head dim but 64 on the CPU (kernel 1
on the card: csrc/attention_any.cu, csrc/attention_any_f32.cu): the plain versions at head dims 16 to
256 against the JAX package's one-shot Pallas kernel in interpret mode and
its library flash kernel in TPU interpret mode, and the wrappers' dispatch
of a CUDA tensor by head dim and dtype to the kernel and its launch
counter (the CUDA library faked: no GPU here). The kernels' order of sums
is held on the CPU by tests/test_torch_attention_any_model.py, their
passes under tests/cuda_emu by tests/test_torch_attention_any_pass.py, the
kernels themselves on the card (tests/test_torch_cuda.py, chip_smoke.py
phases 12 and 14)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vr_video_generator_tpu.ops.attention import _flash_mha
from vr_video_generator_tpu.ops.attention_pallas import oneshot_mha
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.ops import attention as attn_ops

torch.set_num_threads(2)
torch.set_grad_enabled(False)


def _qkv(rng, b, n, h, d):
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32)
               for _ in range(3))
    return q, k * 1.5, v


@pytest.mark.parametrize("d", [16, 20, 32, 48, 128, 256])
def test_oneshot_plain_matches_pallas_interpret(d):
    """mha's one-shot path (q scaled in f32, the plain softmax) against
    oneshot_mha(interpret=True) at f32, N = 70 (not a multiple of the
    Pallas q block), within the head-dim-64 test's 2e-5
    (tests/test_torch_ops.py)."""
    q, k, v = _qkv(np.random.default_rng(d), 2, 70, 2, d)
    scale = d ** -0.5
    ref = np.asarray(oneshot_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, block_q=256,
                                 interpret=True))
    ours = attn_ops.mha(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert ours.shape == (2, 70, 2, d)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("d", [32, 128])
def test_flash_plain_matches_library_kernel(d):
    """(B, N, H) = (1, 4200, 2) at head dims 32 and 128, bf16, scale
    d^-0.5, against the JAX package's _flash_mha (the library kernel in TPU
    interpret mode), with the head-dim-64 test's bounds
    (tests/test_torch_vitl.py): the same 512-key blocks and rounding
    points, the f32 sums in another order, so at most 1% of outputs sit a
    bf16 ulp away, by at most 1e-3."""
    q, k, v = _qkv(np.random.default_rng(d), 1, 4200, 2, d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_flash_mha(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale)
            .astype(jnp.float32))
    bf = torch.bfloat16
    ours = attn_ops.flash_attention(
        *(torch.from_numpy(a).to(bf) for a in (q, k, v)), scale)
    assert ours.dtype == bf and ours.shape == (1, 4200, 2, d)
    err = np.abs(ours.float().numpy() - ref)
    assert (err > 0).mean() <= 0.01
    assert err.max() <= 1e-3


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
    """The attention wrappers believe their tensors are on the card and
    call a FakeLibrary."""
    from vr_video_generator_tpu_torch.kernels import build

    lib = FakeLibrary()
    monkeypatch.setattr(attn_ops, "on_cuda", lambda *t: True)
    monkeypatch.setattr(attn_ops, "stream_handle", lambda device: 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    return lib


def _views(d, dtype, b=2, n=37, h=3):
    """q, k, v as views into one (B, N, 3, H, Dh) qkv, as the fused half
    hands them over."""
    qkv = torch.randn(b, n, 3, h, d,
                      generator=torch.Generator().manual_seed(d)).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


# (row, dtype, head dim) -> (entry point, counter): head dim 64 keeps its
# kernels (csrc/attention.cu, csrc/attention_f32.cu); every other head dim
# takes csrc/attention_any.cu, counted apart.
DISPATCH = {
    ("attention", "bfloat16", 32): ("vrvg_attention_any", "attention_any"),
    ("attention", "float32", 128): ("vrvg_attention_any",
                                    "attention_any_f32"),
    ("flash_attention", "bfloat16", 128): ("vrvg_attention_any",
                                           "flash_attention_any"),
    ("flash_attention", "float32", 17): ("vrvg_attention_any",
                                         "flash_attention_any_f32"),
    ("attention", "bfloat16", 64): ("vrvg_attention", "attention"),
    ("flash_attention", "float32", 64): ("vrvg_flash_attention_f32",
                                         "flash_attention_f32"),
}


@pytest.mark.parametrize("row,dtype,d", list(DISPATCH))
def test_cuda_tensor_launches_by_head_dim(fake_card, row, dtype, d):
    """A CUDA tensor goes to its head dim's entry point once and counts on
    that kernel's counter only; csrc/attention_any.cu's entry gets the head
    dim, the views' own strides, the row (scaled: 0 for row 2, 1 for row
    17) and the dtype flag; the plain version is never reached."""
    entry, counter = DISPATCH[(row, dtype, d)]
    dt = getattr(torch, dtype)
    q, k, v = _views(d, dt)
    before = launch_counts()
    if row == "attention":
        o = attn_ops.attention(q, k, v)
    else:
        o = attn_ops.flash_attention(q, k, v, 0.25)
    after = launch_counts()
    assert [c[0] for c in fake_card.calls] == [entry]
    assert o.shape == q.shape and o.dtype == dt
    changed = {name for name in after if after[name] != before.get(name, 0)}
    assert changed == {counter}
    assert after[counter] == before.get(counter, 0) + 1
    if entry == "vrvg_attention_any":
        args = fake_card.calls[0][1]
        assert args[4:8] == (2, 37, 3, d)
        assert args[8:14] == (q.stride(0), q.stride(1), k.stride(0),
                              k.stride(1), v.stride(0), v.stride(1))
        assert args[-4:-2] == (int(row == "flash_attention"),
                               int(dt == torch.float32))


def test_head_dim_above_256_raises_not_ported(fake_card):
    """Above 256 row 2 launches csrc/attention_any.cu like any other head
    dim. Row 17 takes what the library flash kernel takes: at 272 (> 128,
    no multiple of 128) past 4096 tokens, where the library walks K in
    blocks, it raises the library's NotImplementedError and launches
    nothing (on CPU tensors too: tests/test_torch_attention_wide.py); with
    one block (5 tokens, the library's single-step kernel) it launches."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _views(272, dtype, n=4097, h=1)
        with pytest.raises(NotImplementedError,
                           match="should be a multiple of 128 if larger"):
            attn_ops.flash_attention(q, k, v, 0.1)
    assert fake_card.calls == []
    q, k, v = _views(272, torch.bfloat16, n=5, h=1)
    attn_ops.attention(q, k, v)
    attn_ops.flash_attention(q, k, v, 0.1)
    assert [(c[0], c[1][7], c[1][-3]) for c in fake_card.calls] == [
        ("vrvg_attention_any", 272, 0), ("vrvg_attention_any", 272, 0)]


def test_any_head_dim_needs_its_head_pair_contiguous(fake_card):
    """Any token and batch stride goes (odd head dims' rows unaligned
    included), but each token's (H, Dh) must be contiguous, and the dtypes
    must agree."""
    q, k, v = _views(20, torch.bfloat16)
    with pytest.raises(ValueError, match="pair"):
        attn_ops.attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v)
    with pytest.raises(ValueError, match="pair"):
        attn_ops.attention(q, k.float(), v)
    assert fake_card.calls == []


def test_f32_scratch_only_for_head_dim_64():
    """At head dim 64 the scratch is csrc/attention_f32.cu's split K and
    V^T (four planes, N rounded up to 64); at any other it is kernel 1's
    split pass's Q, K and V^T (six planes, N rounded up to 128, the head
    dim to 32)."""
    assert attn_ops.f32_scratch_numel(2, 70, 3) == 4 * 2 * 3 * 128 * 64
    assert attn_ops.f32_scratch_numel(2, 70, 3, 64) == 4 * 2 * 3 * 128 * 64
    for d, dp in ((16, 32), (17, 32), (32, 32), (128, 128), (256, 256),
                  (320, 320)):
        assert attn_ops.f32_scratch_numel(2, 70, 3, d) == \
            6 * 2 * 3 * 128 * dp
