"""PyTorch port, the DPT tails at the widths a custom head gives them,
against the JAX package's Pallas kernels in interpret mode, on the CPU:
(c) the plain stages of rows 7 (ext), 11 + 12 (big-C) and 15 (single-kernel)
    at widths only a custom ModelConfig reaches, against
    ``head_tail_ext_pallas`` / ``head_tail_big_pallas`` /
    ``head_tail_pallas``: f32 within 5e-4 (the JAX package's own bound,
    tests/test_head_tail.py), bf16 within the tails' share of the depth's
    range (tests/test_torch_vitg.py's bf16 bounds, on its 20 x 32 grid: on
    an 8 x 12 grid the edge rows weigh more, and the bf16 big-C tail at the
    encoders' C = 384 is already 2.2e-4 of the range off on average there);
(e) the whole slice: a narrow model (2 blocks at vits' widths) with a head
    of 48, 96 or 512 features through both packages at tail='fused', the
    JAX model under ``pltpu.force_tpu_interpret_mode()``, f32 depth within
    1e-4 of its largest value (tests/test_torch_widths.py's bound), the
    port planning the tail the JAX planners pick (ext at 48 and 96, the
    big-C tail at 512)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_base_tail import (_arrays, _assert_close, _hwio, _t,
                                       _tail_args)
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2, infer_depth as jax_infer_depth)
from vr_video_generator_tpu.ops.head_tail_pallas import (head_tail_big_pallas,
                                                         head_tail_ext_pallas,
                                                         head_tail_pallas)
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.dpt import resolve_tail
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)

F32_ATOL = 5e-4  # tests/test_head_tail.py's bound on the f32 tails
GRIDS = {"float32": (8, 12), "bfloat16": (20, 32)}  # refinenet1's grid


def _ext_args(rng, c, h0, w0, jdt):
    """x (1, H0, W0, C) and row 7's weights (JAX layout: convs HWIO) at the
    JAX tests' scales, rounded to ``jdt`` and held in f32."""
    c2 = c // 2
    return _arrays(rng, [((1, h0, w0, c), 1.0, 0.0),
                         ((1, 1, c, c), c ** -0.5, 0.0), ((c,), 0.1, 0.0),
                         ((3, 3, c, c2), (9 * c) ** -0.5, 0.0),
                         ((c2,), 0.1, 0.0),
                         ((3, 3, c2, 32), (9 * c2) ** -0.5, 0.0),
                         ((32,), 0.1, 0.0), ((1, 1, 32, 1), 32 ** -0.5, 0.0),
                         ((1,), 0.1, 0.5)], jdt)


def _port(args, tdt):
    return [_hwio(a, tdt) if a.ndim == 4 and i else _t(a, tdt)
            for i, a in enumerate(args)]


def _jax(args, jdt):
    return [jnp.asarray(a, jdt) for a in args]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 48, 96, 144])
def test_ext_stages_match_pallas_at_new_widths(c, dtype):
    """(c) Row 7's plain stages (head_tail_ext_stages on CPU tensors)
    composed against head_tail_ext_pallas in interpret mode at C = 16, 48,
    96, 144, B = 1 on an 8 x 12 grid (bf16: 20 x 32); the stages' shapes
    the head's."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    h0, w0 = GRIDS[dtype]
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    args = _ext_args(np.random.default_rng(c), c, h0, w0, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_ext_pallas(*_jax(args, jdt), out_hw,
                                              interpret=True))
    *mid, ours = ht.head_tail_ext_stages(*_port(args, tdt), out_hw)
    assert [t.shape[-1] for t in mid] == [c, c, c // 2, c // 2]
    assert ours.shape == ref.shape == (1, *out_hw) and (ref > 0).mean() > 0.2
    _assert_close(ours.numpy(), ref, dtype, F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [80, 112, 512])
def test_big_stages_match_pallas_at_new_widths(c, dtype):
    """(c) Rows 11 and 12's plain stages (head_tail_big_stages on CPU
    tensors) composed against head_tail_big_pallas in interpret mode at C =
    80, 112 (C <= 128: one channel chunk) and 512 (four), B = 1 on an 8 x
    12 grid (bf16: 20 x 32), the plan the JAX planner picks."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    h0, w0 = GRIDS[dtype]
    out_hw = (h0 * 14 // 4, w0 * 14 // 4)
    args = _ext_args(np.random.default_rng(c + 1), c, h0, w0, jdt)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_big_pallas(*_jax(args, jdt), out_hw,
                                              interpret=True))
    *mid, ours = ht.head_tail_big_stages(*_port(args, tdt), out_hw)
    assert [t.shape[-1] for t in mid] == [c, c // 2, c // 2]
    assert ours.shape == ref.shape == (1, *out_hw) and (ref > 0).mean() > 0.2
    _assert_close(ours.numpy(), ref, dtype, F32_ATOL)


@pytest.mark.parametrize("c", [16, 96, 256])
def test_base_stages_match_pallas_at_new_widths(c):
    """(c) Row 15's plain stages (head_tail_stages on CPU tensors) composed
    against head_tail_pallas in interpret mode at f32, C = 16, 96, 256 on
    path1 (1, 16, 24, C), 8-row blocks."""
    h2, w2 = 16, 24
    out_hw = (h2 * 14 // 8, w2 * 14 // 8)
    args = list(_tail_args(np.random.default_rng(c + 2), 1, h2, w2, c,
                           jnp.float32))
    args[-1] = args[-1] + np.float32(0.4)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_pallas(*_jax(args, jnp.float32), out_hw,
                                          block_rows=8, interpret=True))
    c1, r, ours = ht.head_tail_stages(*_port(args, torch.float32), out_hw)
    assert c1.shape[-1] == r.shape[-1] == c // 2
    assert ours.shape == ref.shape == (1, *out_hw) and (ref > 0).mean() > 0.2
    _assert_close(ours.numpy(), ref, "float32", F32_ATOL)


# (e) a narrow model at vits' widths, 2 blocks, each custom head.
NARROW = config.ModelConfig(encoder="vits", embed_dim=384, depth=2,
                            num_heads=6, mlp_ratio=4.0, features=64,
                            out_channels=(48, 96, 192, 384),
                            intermediate_layers=(0, 1, 1, 1),
                            mlp_fused="xla")


@pytest.mark.parametrize("features,tail", [(48, "ext"), (96, "ext"),
                                           (512, "big")])
def test_custom_head_matches_jax_fused(features, tail):
    """(e) The whole model with a head of ``features`` at f32, input 56 on
    48 x 80 frames (refinenet1's grid 16 x 28): the JAX planners pick
    ``tail``, the port resolves the same, and its depth (the tail's plain
    versions) is the JAX model's at tail='fused' (the Pallas tail in
    interpret mode) within 1e-4 of the largest value."""
    cfg = dataclasses.replace(NARROW, features=features)
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(features)
    sd = random_state_dict(cfg, seed=7)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(
                np.float32)
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(sd, cfg))
    frames = rng.integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    pre = (2, 16, 28, features)
    assert ht.plan_tail(pre, torch.float32, (56, 98)) == tail
    assert resolve_tail("fused", pre, torch.float32, (56, 98), "cpu") == tail
    jmodel = JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="fused")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_infer_depth(jmodel, jparams,
                                         jnp.asarray(frames), input_size=56))
    model = build_model(cfg, state_dict_from_jax(jparams, cfg),
                        torch.float32, "cpu", tail="fused")
    ours = infer_depth(model, torch.from_numpy(frames), input_size=56).numpy()
    assert ours.shape == ref.shape == (2, 48, 80)
    assert np.abs(ref).max() > 0
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
