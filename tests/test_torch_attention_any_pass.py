"""PyTorch port, the passes before kernel 1's wgmma kernels
(csrc/attention_any_pass.cu) on the CPU, under the host emulation of CUDA
(tests/cuda_emu): g++ builds the file as it is (its launches rewritten to
the emulator's), and each pass is held bit for bit against torch at odd
head dims and ragged token counts, on strided views into one qkv:
- the bf16 pad pass: q, k and v with rows of round_up(Dh, 8), zeros past
  Dh, [q | k | v] each (B, N, H, round_up(Dh, 8));
- the f32 split pass: Q and K as TF32 hi/lo planes (B H Npad, DP) and V^T's
  (B H DP, Npad), zeros past N and Dh, V^T's 8-key groups in
  tf32x3::pv_slot_key's order, the halves those of csrc/tf32x3.cuh's
  split (built alone by tests/test_torch_attention_3xtf32.py).
The wgmma kernels after them run only on the card (chip_smoke.py phases 12
and 14). Needs g++ (C++20).
"""

import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_attention_3xtf32 import lib  # noqa: F401
from tests.test_torch_attention_3xtf32 import split
from tests.test_torch_kernel_emulation import UNIT, build, emulated
from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pass_lib(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cuda_emu_any_pass")
    for name in ("attention_any_pass.cu", "tf32x3.cuh"):
        text = (CSRC_DIR / name).read_text()
        (tmp / name).write_text(emulated(text) if name.endswith(".cu")
                                else text)
    unit = tmp / "attention_any_pass.cu.cpp"
    unit.write_text(UNIT % "attention_any_pass.cu")
    return build(tmp, [str(unit)], ("vrvg_attention_any_pad",
                                    "vrvg_attention_any_split"))


def views(d, n, dtype, b=2, h=3, seed=0):
    """q, k, v as views into one (B, N, 3, H, Dh) qkv: rows 2- or 4-byte
    aligned only at an odd head dim."""
    gen = torch.Generator().manual_seed(seed + d)
    qkv = torch.randn(b, n, 3, h, d, generator=gen).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def strides(*xs):
    return [s for x in xs for s in (x.stride(0), x.stride(1))]


@pytest.mark.parametrize("d,n", [(17, 37), (20, 70), (33, 5), (100, 129)])
def test_pad_pass_bit_for_bit(pass_lib, d, n):
    """[q | k | v] zero-padded to round_up(d, 8) columns, contiguous."""
    q, k, v = views(d, n, torch.bfloat16)
    b, _, h, _ = q.shape
    dm = -(-d // 8) * 8
    out = torch.full((3, b, n, h, dm), 7.0, dtype=torch.bfloat16)
    err = pass_lib.vrvg_attention_any_pad(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h, d,
        dm, *strides(q, k, v), None)
    assert err == 0
    want = torch.stack([F.pad(x, (0, dm - d)) for x in (q, k, v)])
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def pv_order(npad):
    """Key index of each V^T column: 8-key groups in pv_slot_key's order,
    keys 0, 2, 4, 6, 1, 3, 5, 7 of the group."""
    slot_key = [0, 2, 4, 6, 1, 3, 5, 7]
    return torch.tensor([s - s % 8 + slot_key[s % 8] for s in range(npad)])


@pytest.mark.parametrize("d,n", [(17, 37), (48, 128), (100, 129),
                                 (320, 70)])
def test_split_pass_bit_for_bit(pass_lib, lib, d, n):
    """Q_hi, Q_lo, K_hi, K_lo as (B H Npad, DP) and V^T_hi, V^T_lo as (B H
    DP, Npad), Npad = N rounded up to 128, DP = d rounded up to 32: bit for
    bit the header's split of the zero-padded tensors, V^T's keys in
    pv_slot_key's order."""
    q, k, v = views(d, n, torch.float32)
    b, _, h, _ = q.shape
    npad, dp = -(-n // 128) * 128, -(-d // 32) * 32
    plane = b * h * npad * dp
    ws = torch.full((6 * plane,), float("nan"))
    err = pass_lib.vrvg_attention_any_split(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ws.data_ptr(), b, n, npad,
        h, d, dp, *strides(q, k, v), None)
    assert err == 0

    def padded(x):  # (B, H, Npad, DP)
        return F.pad(x.transpose(1, 2), (0, dp - d, 0, npad - n))

    got = ws.view(6, b * h, -1)
    for i, x in enumerate((q, k)):
        hi, lo = split(lib, padded(x).contiguous())
        assert torch.equal(got[2 * i].view(torch.int32),
                           hi.reshape(b * h, -1).view(torch.int32))
        assert torch.equal(got[2 * i + 1].view(torch.int32),
                           lo.reshape(b * h, -1).view(torch.int32))
    vt = padded(v)[:, :, pv_order(npad)].transpose(-1, -2).contiguous()
    hi, lo = split(lib, vt)
    assert torch.equal(got[4].view(torch.int32),
                       hi.reshape(b * h, -1).view(torch.int32))
    assert torch.equal(got[5].view(torch.int32),
                       lo.reshape(b * h, -1).view(torch.int32))
