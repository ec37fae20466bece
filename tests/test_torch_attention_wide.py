"""PyTorch port, rows 2 and 17 at head dims above 256 on the CPU
(kernel 1 on the card: csrc/attention_any.cu, csrc/attention_any_f32.cu;
their order of sums is held on the CPU by
tests/test_torch_attention_any_model.py).

The JAX one-shot kernel takes any head dim; the library flash kernel that
``_flash_mha`` calls past 4096 tokens takes, once it walks K in blocks,
head dims up to 128 and multiples of 128 above (its MIN_BLOCK_SIZE), and
raises NotImplementedError at another. Held here:
(a) the plain versions of rows 2 and 17 against ``oneshot_mha`` in
    interpret mode at head dims 257, 320, 384 and 512, and row 17 against
    the library flash kernel in TPU interpret mode at 384, with
    tests/test_torch_attention_any.py's bounds;
(b) row 17's refusals: at head dims 192 and 320 past 4096 tokens both
    packages raise NotImplementedError, the port on CPU tensors and on a
    faked card alike, launching nothing; ``flash_takes`` is the library's
    rule;
(c) the wrappers' dispatch of wide head dims to kernel 1
    (csrc/attention_any.cu) on a faked card;
(e) narrow analogues of chip_smoke.py's hd384 and hd320 configurations
    (one head of 384 or 320, 2 blocks), whole, against the JAX model at
    ``fused``, the JAX parameters carried by the port's converter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_attention_any import DISPATCH, FakeLibrary, _qkv, _views
from tests.test_torch_widths import TINY, jax_fusion
from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2, infer_depth as jax_infer_depth)
from vr_video_generator_tpu.ops.attention import _flash_mha
from vr_video_generator_tpu.ops.attention_pallas import oneshot_mha
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch.kernels import build as kbuild
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.models.convert import state_dict_from_jax
from vr_video_generator_tpu_torch.models.depth_anything_v2 import infer_depth
from vr_video_generator_tpu_torch.models.dinov2 import resolve_block_fusion
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import attention as attn_ops

torch.set_num_threads(2)
torch.set_grad_enabled(False)

WIDE = [257, 320, 384, 512]


# --- (a) against the JAX kernels -----------------------------------------------

@pytest.mark.parametrize("row", ["attention", "flash_attention"])
@pytest.mark.parametrize("d", WIDE)
def test_plain_matches_oneshot_pallas_at_wide_head_dims(d, row):
    """mha's one-shot path (q scaled in f32) and row 17's plain version (one
    K block at 70 tokens, the logits scaled) against oneshot_mha(interpret=
    True) at f32, N = 70, within the head-dim-64 test's 2e-5
    (tests/test_torch_ops.py)."""
    q, k, v = _qkv(np.random.default_rng(d), 2, 70, 2, d)
    scale = d ** -0.5
    ref = np.asarray(oneshot_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, block_q=256,
                                 interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v)]
    ours = attn_ops.mha(*args, scale) if row == "attention" else \
        attn_ops.flash_attention(*args, scale)
    assert ours.shape == (2, 70, 2, d)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=2e-5)


def test_flash_plain_matches_library_kernel_at_head_dim_384():
    """(B, N, H) = (1, 4200, 1) at head dim 384, bf16, scale d^-0.5: row 17's
    plain version (nine 512-key blocks) against _flash_mha (the library
    kernel in TPU interpret mode) with tests/test_torch_attention_any.py's
    bounds: at most 1% of outputs a bf16 ulp away, by at most 1e-3."""
    d = 384
    q, k, v = _qkv(np.random.default_rng(d), 1, 4200, 1, d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_flash_mha(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale)
            .astype(jnp.float32))
    bf = torch.bfloat16
    ours = attn_ops.flash_attention(
        *(torch.from_numpy(a).to(bf) for a in (q, k, v)), scale)
    assert ours.dtype == bf and ours.shape == (1, 4200, 1, d)
    err = np.abs(ours.float().numpy() - ref)
    assert (err > 0).mean() <= 0.01
    assert err.max() <= 1e-3


# --- (b) row 17's refusals -------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """The attention wrappers believe their tensors are on the card and
    call a FakeLibrary."""
    lib = FakeLibrary()
    monkeypatch.setattr(attn_ops, "on_cuda", lambda *t: True)
    monkeypatch.setattr(attn_ops, "stream_handle", lambda device: 0)
    monkeypatch.setattr(kbuild, "library", lambda: lib)
    return lib


@pytest.mark.parametrize("d", [192, 320])
def test_flash_refuses_the_library_kernels_head_dims(monkeypatch, d):
    """Past 4096 tokens (K in 512-key blocks) the library flash kernel
    raises NotImplementedError at a head dim above 128 that is no multiple
    of 128, in _flash_mha under TPU interpret mode; so does the port's row
    17, on CPU tensors (the plain path), through mha, and on a faked card,
    where nothing is launched."""
    n = 4097
    z = jnp.zeros((1, n, 1, d), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode(), pytest.raises(
            NotImplementedError, match="should be a multiple of 128"):
        _flash_mha(z, z, z, 0.1)
    q = torch.zeros((1, n, 1, d), dtype=torch.bfloat16)
    match = f"head_dim={d} should be a multiple of 128 if larger"
    with pytest.raises(NotImplementedError, match=match):
        attn_ops.flash_attention(q, q, q, 0.1)
    with pytest.raises(NotImplementedError, match=match):
        attn_ops.mha(q, q, q, 0.1)
    lib = FakeLibrary()
    monkeypatch.setattr(attn_ops, "on_cuda", lambda *t: True)
    monkeypatch.setattr(kbuild, "library", lambda: lib)
    before = launch_counts()
    with pytest.raises(NotImplementedError, match=match):
        attn_ops.flash_attention(q, q, q, 0.1)
    assert lib.calls == [] and launch_counts() == before


def test_flash_takes_is_the_library_rule():
    """flash_takes: with one K block (up to 4096 tokens) every head dim; past
    that up to 128 and the multiples of 128; row 2 has no such rule."""
    for d in range(1, 700):
        assert attn_ops.flash_takes(d, 4096)
        assert attn_ops.flash_takes(d, 4097) == (d <= 128 or d % 128 == 0)


# --- (c) the dispatch of wide head dims --------------------------------------------

WIDE_DISPATCH = {
    ("attention", "bfloat16", 257): "attention_any",
    ("attention", "float32", 320): "attention_any_f32",
    ("attention", "bfloat16", 512): "attention_any",
    ("flash_attention", "bfloat16", 384): "flash_attention_any",
    ("flash_attention", "float32", 512): "flash_attention_any_f32",
}


@pytest.mark.parametrize("row,dtype,d", list(WIDE_DISPATCH))
def test_wide_head_dim_launches_attention_any(fake_card, row, dtype, d):
    """A CUDA tensor at a head dim above 256 goes to kernel 1's entry
    (csrc/attention_any.cu) once with its head dim, the views' strides, the
    row and the dtype flag, and counts on that kernel's counter only (as
    tests/test_torch_attention_any.py's DISPATCH does up to 256)."""
    assert (row, dtype, d) not in DISPATCH
    counter = WIDE_DISPATCH[(row, dtype, d)]
    dt = getattr(torch, dtype)
    q, k, v = _views(d, dt, n=9, h=2)
    before = launch_counts()
    o = attn_ops.attention(q, k, v) if row == "attention" else \
        attn_ops.flash_attention(q, k, v, d ** -0.5)
    after = launch_counts()
    assert [c[0] for c in fake_card.calls] == ["vrvg_attention_any"]
    args = fake_card.calls[0][1]
    assert args[4:8] == (2, 9, 2, d)
    assert args[8:14] == (q.stride(0), q.stride(1), k.stride(0),
                          k.stride(1), v.stride(0), v.stride(1))
    assert args[-4:-2] == (int(row == "flash_attention"),
                           int(dt == torch.float32))
    assert o.shape == q.shape and o.dtype == dt
    assert {c for c in after if after[c] != before.get(c, 0)} == {counter}


# --- (e) narrow analogues of the hd384 and hd320 configurations --------------------------

NARROW_WIDE = {"hd384": dict(embed_dim=384, num_heads=1),
               "hd320": dict(embed_dim=320, num_heads=1)}


@pytest.mark.parametrize("label", list(NARROW_WIDE))
def test_narrow_wide_head_model_matches_jax_fused(label):
    """The whole model with one head of 384 (the attention half fused, D %
    128 == 0) or of 320 (D = 320: unfused), 2 blocks, a 32-feature head:
    mlp_fused='fused' (plain versions here) against the JAX model at
    'fused' (its Pallas half-blocks in interpret mode), both with the XLA
    tail, the JAX parameters carried by the port's converter; f32 depth
    within 1e-4 of its max (tests/test_torch_widths.py's bound); the Blocks
    fuse as the JAX ones do."""
    cfg = dataclasses.replace(TINY, **NARROW_WIDE[label])
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(23)
    sd = random_state_dict(cfg, seed=5)
    for k in sd:
        if k.endswith(".bias") and "norm" not in k:
            sd[k] = (sd[k] + rng.normal(0, 0.1, sd[k].shape)).astype(
                np.float32)
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(sd, cfg))
    frames = rng.integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    jmodel = JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="xla")
    ref = np.asarray(jax_infer_depth(jmodel, jparams, jnp.asarray(frames),
                                     input_size=56))
    model = build_model(cfg, state_dict_from_jax(jparams, cfg),
                        torch.float32, "cpu", tail="xla")
    n = (56 // 14) * (98 // 14) + 1
    fusion = resolve_block_fusion("fused", cfg.embed_dim, cfg.num_heads, n,
                                  "cpu", torch.float32, cfg.ffn_layer)
    assert fusion == jax_fusion("fused", cfg.embed_dim, cfg.num_heads, n,
                                jnp.float32, False)
    assert fusion[0] == (label == "hd384")
    ours = infer_depth(model, torch.from_numpy(frames), input_size=56).numpy()
    assert ours.shape == ref.shape == (2, 48, 80)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()
