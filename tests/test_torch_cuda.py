"""PyTorch port on the GPU: each hand-written kernel against its plain
version on the card. CUDA kernels have no CPU mode, so these tests skip
without a GPU. On a GPU machine (no JAX needed):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vr_video_generator_tpu.utils.config import StereoConfig
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.ops.attention import attention, attention_plain
from vr_video_generator_tpu_torch.ops.layernorm import layernorm, layernorm_plain
from vr_video_generator_tpu_torch.ops.warp import (WarpSpec, blur_select_sbs,
                                                   blur_select_sbs_plain,
                                                   warp_composite,
                                                   warp_composite_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA and Triton kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("rows,d", [(19544, 384), (130, 128), (7, 384)])
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


@pytest.mark.parametrize("b,n,h", [(2, 70, 2), (1, 321, 6), (2, 2443, 6)])
def test_attention_kernel_matches_plain(cuda, b, n, h):
    gen = torch.Generator(device=cuda).manual_seed(n)
    qkv = torch.randn(b, n, 3, h, 64, generator=gen, device=cuda).to(torch.bfloat16)
    q = (qkv[:, :, 0].float() * 0.125).to(torch.bfloat16)
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    err = (attention(q, k, v).float() - attention_plain(q, k, v).float()).abs()
    assert err.max().item() <= 2e-2 and err.mean().item() <= 1e-3


@pytest.mark.parametrize("h,w", [(150, 96), (61, 97), (1080, 1920)])
def test_warp_kernels_bit_exact(cuda, h, w):
    rng = np.random.default_rng(h)
    b = 3
    imgs = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                         dtype=np.uint8)).to(cuda)
    ramp = np.linspace(0, 1, w, dtype=np.float32)[None, None, :]
    tmax = np.array([5.0, 14.0, 30.0], np.float32)[:, None, None]
    depth = ramp * tmax + rng.normal(0, 0.3, (b, h, w)).astype(np.float32)
    depth = torch.from_numpy(np.clip(depth, 0, None)).to(cuda)
    spec = WarpSpec.create(h, w, StereoConfig())
    ls = torch.ceil(depth.amax(dim=(1, 2)))
    ranges = torch.stack([spec.cfg.offset_bg * h * ls / 14.0,
                          spec.cfg.offset_fg * h * ls / 14.0], dim=1)
    _, st = spec.tables(depth, ranges)
    comp, cov = warp_composite(imgs, depth, st, spec.s_neg, spec.s_pos)
    comp_p, cov_p = warp_composite_plain(imgs, depth, st, spec.s_neg,
                                         spec.s_pos)
    assert torch.equal(comp, comp_p) and torch.equal(cov, cov_p)
    args = (comp_p, cov_p, imgs, st.edge_width, spec.kernel_size,
            spec.cfg.sigma)
    assert torch.equal(blur_select_sbs(*args), blur_select_sbs_plain(*args))


def test_step_enqueues_without_host_sync(cuda):
    """A step only enqueues device work: no host-to-device copy of host data
    and no readback inside it, so the segment loop's overlap is real."""
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    cfg = RunConfig(encoder="vits", batch_size=2, compute_dtype="bfloat16",
                    mlp_fused="xla", tail="xla", input_size=56)
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
