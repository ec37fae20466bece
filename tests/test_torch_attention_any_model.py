"""PyTorch port, kernel 1's order of sums on the CPU (rows 2 and 17 at any
head dim but 64; csrc/attention_any.cu at bf16, csrc/attention_any_f32.cu at
f32, which run only on the card).

Torch models of what each kernel computes, in its order, held against the
bounds chip_smoke.py holds the kernels to on the card, at chip_smoke.py's
head dims and an odd one (17), both rows:
(a) bf16: the plan's key tiles (csrc/attention_any_plan.cuh, built with
    g++), the f32 logits (times the scale at row 17), keys >= N masked, the
    running maximum, P = exp(s - m) cast to bf16 against it, l the sum of
    the f32 p rescaled a tile, O = O alpha + P V in f32, one divide at the
    end; against the plain versions (the one-shot softmax; the library's
    512-key blocks past 4096 tokens) within attention_stats' bounds;
(b) f32: q, k, v and P split into TF32 hi and lo by csrc/tf32x3.cuh, S as
    (Q_hi K_lo + Q_lo K_hi) + Q_hi K_hi a fresh sum every 64 dims added in
    f32, P V the same a fresh sum every tile, l a tile's sum at a time, O =
    O alpha + P V; against the f64 function within attn_any_f32_max_rel(d)
    and ATTN_ANY_F32_MEAN_REL, and the same model on TF32 operands outside
    the max bound (as phase 12 requires of the card's TF32 result).
Needs g++.
"""

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (ATTN_ANY_F32_MEAN_REL, attention_f64, attention_stats,
                        attn_any_f32_max_rel)
from tests.test_torch_attention_3xtf32 import lib  # noqa: F401
from tests.test_torch_attention_3xtf32 import rel_errors, split
from tests.test_torch_attention_any_plan import plan, plan_lib  # noqa: F401
from vr_video_generator_tpu_torch.attention_bench import peaked_qkv
from vr_video_generator_tpu_torch.ops.attention import (attention_plain,
                                                        flash_attention_plain)

torch.set_num_threads(2)
torch.set_grad_enabled(False)

HEAD_DIMS = [16, 17, 20, 32, 48, 128, 256, 320, 384, 512]
FLASH_DIMS = [17, 32, 128, 384, 512]  # the library rule takes each at 4200
ONESHOT_N, FLASH_N = 333, 4200


def case(d: int, flash: bool, dtype):
    """chip_smoke.check_attention_any's operands on the CPU: peaked q/k/v,
    k and v strided views into one qkv; row 2's q pre-scaled in f32 and
    cast back, row 17's unscaled. (B, N, H) = (2, 333, 2) for row 2, (1,
    4200, 1) for row 17 (nine of the library's 512-key blocks)."""
    gen = torch.Generator().manual_seed(d + 1000 * flash)
    b, n, h = (1, FLASH_N, 1) if flash else (2, ONESHOT_N, 2)
    qkv = peaked_qkv(gen, b, n, h, dtype, head_dim=d)
    k, v, scale = qkv[:, :, 1], qkv[:, :, 2], d ** -0.5
    if flash:
        return qkv[:, :, 0], k, v, scale
    return (qkv[:, :, 0].float() * scale).to(dtype), k, v, 1.0


def bf16_model(q, k, v, scale, scaled, bn):
    """csrc/attention_any.cu's arithmetic on bf16 (B, N, H, D) operands."""
    n = q.shape[1]
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    shape = (*qf.shape[:3], 1)
    m = torch.full(shape, -torch.inf)
    l = torch.zeros(shape)
    o = torch.zeros(qf.shape)
    for t0 in range(0, n, bn):
        s = qf @ kf[:, :, t0:t0 + bn].transpose(-1, -2)
        if scaled:
            s = s * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ vf[:, :, t0:t0 + bn]
        m = m_new
    return (o / l).to(torch.bfloat16).transpose(1, 2)


def f32_model(lib, q, k, v, scale, scaled, bn, products="3xtf32"):
    """csrc/attention_any_f32.cu's arithmetic on f32 (B, N, H, D) operands:
    ``products`` "3xtf32" (the kernel) or "tf32" (every operand rounded to
    TF32, one product a sum)."""
    n = q.shape[1]
    npad = -(-n // bn) * bn
    qt = q.transpose(1, 2).float()
    kt = F.pad(k.transpose(1, 2).float(), (0, 0, 0, npad - n))
    vt = F.pad(v.transpose(1, 2).float(), (0, 0, 0, npad - n))
    (qh, ql), (kh, kl), (vh, vl) = (split(lib, t) for t in (qt, kt, vt))
    if products == "tf32":
        ql, kl, vl = (torch.zeros_like(t) for t in (ql, kl, vl))
    d = q.shape[3]
    shape = (*qt.shape[:3], 1)
    m = torch.full(shape, -torch.inf)
    l = torch.zeros(shape)
    o = torch.zeros(qt.shape)
    for t0 in range(0, npad, bn):
        s = None
        for c0 in range(0, d, 64):  # a fresh sum every 64 dims
            cs = slice(c0, c0 + 64)
            kh_t = kh[:, :, t0:t0 + bn, cs].transpose(-1, -2)
            kl_t = kl[:, :, t0:t0 + bn, cs].transpose(-1, -2)
            part = ((qh[..., cs] @ kl_t + ql[..., cs] @ kh_t)
                    + qh[..., cs] @ kh_t)
            s = part if s is None else s + part
        if scaled:
            s = s * scale
        s[..., max(n - t0, 0):] = -torch.inf
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        ph, pl = split(lib, p, finite=True)
        if products == "tf32":
            pl = torch.zeros_like(pl)
        vh_t, vl_t = vh[:, :, t0:t0 + bn], vl[:, :, t0:t0 + bn]
        o = o * alpha + ((ph @ vl_t + pl @ vh_t) + ph @ vh_t)
        m = m_new
    return (o / l).transpose(1, 2)


def rows():
    return ([(d, False) for d in HEAD_DIMS]
            + [(d, True) for d in FLASH_DIMS])


IDS = [f"{'row17' if f else 'row2'}-{d}" for d, f in rows()]


@pytest.mark.parametrize("d,flash", rows(), ids=IDS)
def test_bf16_order_within_the_plain_bounds(plan_lib, d, flash):
    """(a) The bf16 kernel's order against the plain version of its row on
    the same operands, within attention_stats' bounds."""
    q, k, v, scale = case(d, flash, torch.bfloat16)
    bn = plan(plan_lib, d, 0)["bn"]
    got = bf16_model(q, k, v, scale, flash, bn)
    want = (flash_attention_plain(q, k, v, scale) if flash
            else attention_plain(q, k, v))
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    attention_stats(f"model d={d} flash={flash}", got, want)


@pytest.mark.parametrize("d,flash", rows(), ids=IDS)
def test_f32_order_within_the_f64_bounds(plan_lib, lib, d, flash):
    """(b) The f32 kernel's order against the f64 function within
    attn_any_f32_max_rel(d) and ATTN_ANY_F32_MEAN_REL of |o|."""
    q, k, v, scale = case(d, flash, torch.float32)
    bn = plan(plan_lib, d, 1)["bn"]
    got = f32_model(lib, q, k, v, scale, flash, bn)
    want = attention_f64(q, k, v, scale)
    mx, mean = rel_errors(got, want)
    assert mx <= attn_any_f32_max_rel(d) and mean <= ATTN_ANY_F32_MEAN_REL, \
        (mx, mean)


@pytest.mark.parametrize("d", [20, 384])
def test_f32_tf32_model_fails_the_bound(plan_lib, lib, d):
    """(b) The same order on TF32 operands is outside the max bound: the
    bound tells the kernel's 3xTF32 from TF32 at these head dims."""
    q, k, v, scale = case(d, False, torch.float32)
    bn = plan(plan_lib, d, 1)["bn"]
    got = f32_model(lib, q, k, v, scale, False, bn, products="tf32")
    mx, _ = rel_errors(got, attention_f64(q, k, v, scale))
    assert mx > attn_any_f32_max_rel(d), mx
