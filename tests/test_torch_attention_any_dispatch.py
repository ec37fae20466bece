"""PyTorch port, kernel 1's wrapper on a faked card (rows 2 and 17 at any
head dim but 64; the CUDA library faked: no GPU here).

ops/attention._launch_any hands csrc/attention_any.cu's entry point the
scratch its passes need: at bf16 none where TMA reads q, k and v as they
are (head dim a multiple of 8, every token and batch stride a multiple of
16 bytes, 16-byte aligned), else the pad pass's three tensors with rows of
round_up(Dh, 8); at f32 always the split pass's six planes. It refuses head
dim 0, and row 17 past 4096 tokens at a head dim the library flash kernel
refuses, before any launch and without writing anything.
"""

import pytest
import torch

from tests.test_torch_attention_any import FakeLibrary
from vr_video_generator_tpu_torch.kernels import build as kbuild
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.ops import attention as attn_ops

torch.set_grad_enabled(False)


@pytest.fixture
def fake_card(monkeypatch):
    """The attention wrappers believe their tensors are on the card and
    call a FakeLibrary."""
    lib = FakeLibrary()
    monkeypatch.setattr(attn_ops, "on_cuda", lambda *t: True)
    monkeypatch.setattr(attn_ops, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kbuild, "library", lambda: lib)
    return lib


def qkv_views(d, dtype, b=2, n=37, h=3):
    """q, k, v as views into one (B, N, 3, H, Dh) qkv."""
    qkv = torch.randn(b, n, 3, h, d,
                      generator=torch.Generator().manual_seed(d)).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def padded_row_views(d, dtype, b=2, n=37, h=3):
    """q, k, v with their (H, Dh) pair contiguous but a token stride of H
    Dh + 4 and an address 8 bytes past a 16-byte boundary (bf16): TMA
    cannot read them at any head dim."""
    base = torch.zeros(b, n, h * d + 4, dtype=dtype)
    x = base[:, :, 4:].unflatten(-1, (h, d))
    return x, x, x


# label -> (views, dtype, head dim, whether TMA reads them as they are,
# scratch elements of the launch).
CASES = {
    "bf16 qkv d=32": (qkv_views, torch.bfloat16, 32, True, 0),
    "bf16 qkv d=384": (qkv_views, torch.bfloat16, 384, True, 0),
    "bf16 qkv d=20": (qkv_views, torch.bfloat16, 20, False,
                      3 * 2 * 37 * 3 * 24),
    "bf16 qkv d=17": (qkv_views, torch.bfloat16, 17, False,
                      3 * 2 * 37 * 3 * 24),
    "bf16 strided d=32": (padded_row_views, torch.bfloat16, 32, False,
                          3 * 2 * 37 * 3 * 32),
    "f32 qkv d=32": (qkv_views, torch.float32, 32, True,
                     6 * 2 * 3 * 128 * 32),
    "f32 qkv d=20": (qkv_views, torch.float32, 20, False,
                     6 * 2 * 3 * 128 * 32),
    "f32 qkv d=320": (qkv_views, torch.float32, 320, True,
                      6 * 2 * 3 * 128 * 320),
}


@pytest.mark.parametrize("label", list(CASES))
def test_scratch_only_where_a_pass_needs_it(fake_card, monkeypatch, label):
    """Both rows: one call of vrvg_attention_any with the views' own
    strides, its scratch (None where TMA reads bf16 views as they are; the
    split planes at f32 whatever the views) of any_scratch_numel elements,
    the row and dtype flags, one launch on the kernel's counter."""
    views, dtype, d, tma, numel = CASES[label]
    q, k, v = views(d, dtype)
    assert attn_ops.tma_reads(q, k, v) == tma
    assert attn_ops.any_scratch_numel(q, k, v) == numel
    sizes = []
    empty = torch.empty
    monkeypatch.setattr(attn_ops.torch, "empty",
                        lambda shape, **kw: sizes.append(shape) or
                        empty(shape, **kw))
    for row in ("attention", "flash_attention"):
        before = launch_counts()
        o = attn_ops.attention(q, k, v) if row == "attention" else \
            attn_ops.flash_attention(q, k, v, d ** -0.5)
        after = launch_counts()
        name = row + "_any" + ("_f32" if dtype == torch.float32 else "")
        assert {c for c in after if after[c] != before.get(c, 0)} == {name}
        assert o.shape == q.shape and o.dtype == dtype
    assert sizes[1::2] == [numel, numel]  # o, then the scratch, a call
    assert [c[0] for c in fake_card.calls] == ["vrvg_attention_any"] * 2
    for (_, args), flash in zip(fake_card.calls, (0, 1)):
        assert args[4:8] == (2, 37, 3, d)
        assert args[8:14] == (q.stride(0), q.stride(1), k.stride(0),
                              k.stride(1), v.stride(0), v.stride(1))
        assert args[-4:-2] == (flash, int(dtype == torch.float32))
        assert (args[-2] is None) == (numel == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_refusals_launch_and_write_nothing(fake_card, dtype):
    """Head dim 0 raises ValueError on both rows; row 17 past 4096 tokens
    at head dim 192 raises the library kernel's NotImplementedError: no
    call, no launch counted, the output untouched (none is made)."""
    before = launch_counts()
    q = torch.zeros(1, 5, 2, 0, dtype=dtype)
    with pytest.raises(ValueError, match="head dim must be >= 1"):
        attn_ops.attention(q, q, q)
    with pytest.raises(ValueError, match="head dim must be >= 1"):
        attn_ops.flash_attention(q, q, q, 1.0)
    q = torch.zeros(1, 4097, 1, 192, dtype=dtype)
    with pytest.raises(NotImplementedError, match="multiple of 128"):
        attn_ops.flash_attention(q, q, q, 0.1)
    assert fake_card.calls == [] and launch_counts() == before
