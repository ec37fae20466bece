"""PyTorch port, f32 on the card: ``auto``'s routing at f32 against the
JAX package's rules and planners, the plan-time check that raises before
any weight is built, the TF32 scope of the f32 forward, and each kernel
wrapper's dispatch of an f32 CUDA tensor to its f32 entry point (the CUDA
library faked: no GPU here)."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.ops.attention_pallas import supported
from vr_video_generator_tpu.ops.head_tail_pallas import (big_pick_plan,
                                                         ext_pick_block_rows)
from vr_video_generator_tpu.ops.preprocess import \
    network_input_size as jax_network_input_size
from vr_video_generator_tpu.ops.qkv_pallas import attn_fusable
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch import RunConfig
from vr_video_generator_tpu_torch import pipeline
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.models import factory
from vr_video_generator_tpu_torch.models.depth_anything_v2 import no_tf32
from vr_video_generator_tpu_torch.models.dinov2 import (kernel_device,
                                                        resolve_block_fusion)
from vr_video_generator_tpu_torch.models.dpt import resolve_tail
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import attention as attn_ops
from vr_video_generator_tpu_torch.ops import head_tail as ht
from vr_video_generator_tpu_torch.ops import layernorm as ln_ops
from vr_video_generator_tpu_torch.ops import qkv as qkv_ops
from vr_video_generator_tpu_torch.pipeline import SbsPipeline, check_f32_plan
from vr_video_generator_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(2)

ENCODERS = ("vits", "vitb", "vitl", "vitg")
SIZES = (126, 252, 518, 728)


def jax_f32_plan(encoder, mlp_fused, tail, size, h=1080, w=1920):
    """The kernel rows the JAX package's Block and DPTHead run at f32 on
    their accelerator for this geometry: ("attn", fused?), ("mlp", row or
    None), ("tail", "ext" / "big" / None)."""
    cfg = jconfig.ModelConfig.for_encoder(encoder)
    d, heads = cfg.embed_dim, cfg.num_heads
    nh, nw = jax_network_input_size(h, w, target=size, multiple_of=14)
    n = (nh // 14) * (nw // 14) + 1
    on = mlp_fused in ("auto", "fused")
    attn = (d % 128 == 0 and (d // heads) % 64 == 0 and supported(n)
            and attn_fusable(d, n, jnp.float32) and on)
    fuse = d % 128 == 0 and (mlp_fused == "fused"
                             or (mlp_fused == "auto" and d >= 512))
    hidden = int(d * cfg.mlp_ratio)
    if not fuse:
        mlp = None
    elif cfg.ffn_layer == "swiglufused":
        mlp = 10
    else:
        mlp = 8 if 2 * d * hidden * 4 <= 10 * 2 ** 20 and hidden % 512 == 0 \
            else 9
    shape = (8, 4 * nh // 14, 4 * nw // 14, cfg.features)
    choice = None
    if tail in ("auto", "fused"):
        if ext_pick_block_rows(shape, cfg.features // 2, jnp.float32,
                               (nh, nw)) is not None:
            choice = "ext"
        elif big_pick_plan(shape, cfg.features // 2, jnp.float32,
                           (nh, nw)) is not None:
            choice = "big"
    return attn, mlp, choice, n, shape, (nh, nw)


def test_kernel_device_takes_f32_on_the_card():
    """auto resolves for the card for bf16 and f32 activations there, and
    for the CPU otherwise."""
    fake = lambda cuda, dt: types.SimpleNamespace(is_cuda=cuda, dtype=dt)
    assert kernel_device(fake(True, torch.float32)) == "cuda"
    assert kernel_device(fake(True, torch.bfloat16)) == "cuda"
    assert kernel_device(fake(True, torch.float16)) == "cpu"
    assert kernel_device(fake(False, torch.float32)) == "cpu"


@pytest.mark.parametrize("encoder", ENCODERS)
def test_block_fusion_at_f32_follows_jax(encoder):
    """At f32 on the card, both halves' fusion is the JAX Block's on its
    accelerator, over --input_size 126-728 at 1080p (vits: the attention
    half fused; vitl: not, attn_fusable(1024, ., f32) being False)."""
    cfg = ModelConfig.for_encoder(encoder)
    for size in SIZES:
        for mlp_fused in ("auto", "fused", "xla"):
            attn, mlp, _, n, _, _ = jax_f32_plan(encoder, mlp_fused, "xla",
                                                 size)
            got = resolve_block_fusion(mlp_fused, cfg.embed_dim,
                                       cfg.num_heads, n, "cuda",
                                       torch.float32, cfg.ffn_layer)
            assert got == (attn, mlp is not None), (size, mlp_fused)
    attn518 = resolve_block_fusion("auto", cfg.embed_dim, cfg.num_heads, 2443,
                                   "cuda", torch.float32, cfg.ffn_layer)[0]
    assert attn518 == (encoder in ("vits", "vitb"))


@pytest.mark.parametrize("encoder", ENCODERS)
def test_tail_at_f32_follows_jax_or_raises(encoder):
    """resolve_tail at f32 is the JAX planners' choice with f32's itemsize,
    off and on the card; check_f32_plan lets it through where its f32
    kernel exists (the ext tail at C = 64, or none) and raises otherwise,
    naming the rows, under the ROADMAP item "f32 on the card"."""
    feats = ModelConfig.for_encoder(encoder).features
    for size in SIZES:
        _, _, want, _, shape, out_hw = jax_f32_plan(encoder, "auto", "auto",
                                                    size)
        for device in ("cpu", "cuda"):
            assert resolve_tail("fused", shape, torch.float32, out_hw,
                                device) == want
        assert resolve_tail("auto", shape, torch.float32, out_hw,
                            "cuda") == want
        cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                        mlp_fused="xla", tail="auto", input_size=size)
        if want is None or (want == "ext" and feats == 64):
            check_f32_plan(cfg, 1080, 1920)
            continue
        rows = "row 7" if want == "ext" else "rows 11 and 12"
        with pytest.raises(NotImplementedError,
                           match=f"{want} DPT tail at C={feats}.*{rows} at "
                                 f"f32.*f32 on the card"):
            check_f32_plan(cfg, 1080, 1920)
    if encoder == "vits":
        shape = jax_f32_plan("vits", "auto", "auto", 518)[4]
        assert resolve_tail("auto", shape, torch.float32, (518, 924),
                            "cuda") == "ext"


class Reached(Exception):
    """Raised by the stand-in for load_model."""


def _load_model(*args, **kwargs):
    raise Reached("load_model reached")


def _create_on_fake_card(monkeypatch, cfg):
    """SbsPipeline.create of ``cfg`` on a faked CUDA device: returns "built"
    when it reaches load_model, which is replaced by a stand-in."""
    monkeypatch.setattr(pipeline, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(pipeline, "load_model", _load_model)
    try:
        SbsPipeline.create(cfg, 1080, 1920, allow_random=True, device="cuda")
    except Reached:
        return "built"
    raise AssertionError("create returned without building")


@pytest.mark.parametrize("encoder,mlp_fused,tail", [
    ("vits", "auto", "auto"), ("vits", "xla", "xla"), ("vitb", "xla", "xla"),
    ("vitl", "xla", "xla"), ("vitg", "xla", "xla")])
def test_f32_plans_with_kernels_reach_load_model(monkeypatch, encoder,
                                                 mlp_fused, tail):
    """vits auto and --mlp_fused xla --tail xla at every encoder (vitl also
    at 728, past 4096 tokens: row 17) pass the plan-time check on the
    card."""
    for size in ((518, 728) if encoder == "vitl" else (518,)):
        cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                        mlp_fused=mlp_fused, tail=tail, input_size=size)
        assert _create_on_fake_card(monkeypatch, cfg) == "built"
        check_f32_plan(cfg, 1080, 1920)


@pytest.mark.parametrize("encoder,mlp_fused,tail,size,match", [
    ("vits", "fused", "fused", 518, r"weights-resident MLP half \(row 8\)"),
    ("vitb", "auto", "auto", 518, r"hidden-blocked MLP half \(row 9\)"),
    ("vitl", "auto", "auto", 518, r"hidden-blocked MLP half \(row 9\)"),
    ("vitg", "auto", "auto", 518, r"fused SwiGLU half \(row 10\)"),
    ("vitb", "xla", "auto", 518, r"big DPT tail at C=128.*rows 11 and 12"),
    ("vits", "auto", "auto", 728, r"big DPT tail at C=64.*rows 11 and 12"),
    ("vitb", "xla", "auto", 252, r"ext DPT tail at C=128.*row 7 at f32")])
def test_f32_plans_without_kernels_raise_before_load_model(
        monkeypatch, encoder, mlp_fused, tail, size, match):
    """Each f32 plan that needs a row with no f32 kernel yet raises
    not_ported naming the first such row, before load_model runs, and
    names the ROADMAP item."""
    jattn, jmlp, jtail, *_ = jax_f32_plan(encoder, mlp_fused, tail, size)
    assert jmlp is not None or jtail in ("big", "ext")
    cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                    mlp_fused=mlp_fused, tail=tail, input_size=size)
    with pytest.raises(NotImplementedError, match=match) as info:
        _create_on_fake_card(monkeypatch, cfg)
    assert "f32 on the card" in str(info.value)


def test_sharded_path_checks_the_f32_plan_before_any_weight(monkeypatch):
    """The orchestrator's --mesh path: a plan without f32 kernels raises
    before load_model; vits auto reaches it."""
    from vr_video_generator_tpu_torch.parallel import mesh as mesh_mod
    from vr_video_generator_tpu_torch.runtime import orchestrator

    monkeypatch.setattr(pipeline, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda *a, **k: None)
    monkeypatch.setattr(factory, "load_model", _load_model)
    base = RunConfig(encoder="vits", compute_dtype="float32",
                     mesh_shape=(1, 1))
    with pytest.raises(NotImplementedError, match=r"row 8"):
        orchestrator._convert_range_sharded(
            dataclasses.replace(base, mlp_fused="fused", tail="fused"), 0, 8,
            1920, 1080, device="cuda")
    with pytest.raises(Reached):
        orchestrator._convert_range_sharded(base, 0, 8, 1920, 1080,
                                            device="cuda")


TINY = ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                   mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                   intermediate_layers=(0, 1, 1, 1), mlp_fused="xla")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_f32_forward_runs_with_tf32_off(dtype):
    """An f32 model's forward sees both TF32 flags off, in the encoder and
    in the head, and leaves them as they were; a bf16 model's forward
    leaves them alone. The flags are readable on the CPU build."""
    model = build_model(TINY, random_state_dict(TINY, seed=1), dtype, "cpu")
    seen = []

    def hook(module, args, out):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    model.pretrained.blocks[0].register_forward_hook(hook)
    model.depth_head.scratch.output_conv1.register_forward_hook(hook)
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    try:
        matmul.allow_tf32, cudnn.allow_tf32 = True, True
        with torch.inference_mode():
            model(torch.zeros((1, 28, 42, 3)))
        assert len(seen) == 2
        want = (False, False) if dtype == torch.float32 else (True, True)
        assert seen == [want, want]
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (True, True)
        matmul.allow_tf32, cudnn.allow_tf32 = False, True
        with no_tf32():
            assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, False)
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (False, True)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


class FakeLibrary:
    """Stands in for the CUDA library: records each entry point called and
    returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("vrvg_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append(name) or 0


@pytest.fixture
def fake_card(monkeypatch):
    """Every kernel wrapper believes its tensors are on the card and calls
    a FakeLibrary."""
    from vr_video_generator_tpu_torch.kernels import build

    lib = FakeLibrary()
    for mod in (ln_ops, qkv_ops, attn_ops, ht):
        monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
        monkeypatch.setattr(mod, "stream_handle", lambda device: 0)
    monkeypatch.setattr(ln_ops, "library", lambda: lib)
    monkeypatch.setattr(build, "library", lambda: lib)
    return lib


def _f32(*shape):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(0))


def _x_wts(c):
    return (_f32(1, 6, 10, c), _f32(c, c, 1, 1), _f32(c),
            _f32(c // 2, c, 3, 3), _f32(c // 2), _f32(32, c // 2, 3, 3),
            _f32(32), _f32(1, 32, 1, 1), _f32(1))


CALLS = {
    "layernorm": (lambda: ln_ops.layernorm(_f32(5, 384), _f32(384),
                                           _f32(384)),
                  "vrvg_layernorm_f32", "layernorm_f32"),
    "ln_qkv": (lambda: qkv_ops.ln_qkv(_f32(1, 5, 384), _f32(384), _f32(384),
                                      _f32(1152, 384), _f32(1152), 6, 0.125),
               "vrvg_ln_qkv_f32", "ln_qkv_f32"),
    "proj_ls_residual": (lambda: qkv_ops.proj_ls_residual(
        _f32(1, 5, 6, 64), _f32(1, 5, 384), _f32(384, 384), _f32(384),
        _f32(384)), "vrvg_proj_ls_residual_f32", "proj_ls_residual_f32"),
    "attention": (lambda: attn_ops.attention(*_f32(3, 1, 5, 2, 64)),
                  "vrvg_attention_f32", "attention_f32"),
    "flash_attention": (lambda: attn_ops.flash_attention(
        *_f32(3, 1, 5, 2, 64), 0.125), "vrvg_flash_attention_f32",
        "flash_attention_f32"),
    "head_tail_ext": (lambda: ht.head_tail_ext(*_x_wts(64), (21, 35)),
                      "vrvg_head_tail_ext_f32", "head_tail_ext_f32"),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_f32_cuda_tensor_launches_the_f32_kernel(fake_card, name):
    """An f32 tensor on the card goes to its wrapper's f32 entry point, once,
    and counts on the f32 counter, never on the bf16 one; it never reaches
    the plain version."""
    call, entry, counter = CALLS[name]
    before = launch_counts()
    call()
    after = launch_counts()
    assert fake_card.calls == [entry]
    assert after[counter] == before.get(counter, 0) + 1
    assert after[name] == before.get(name, 0)


@pytest.mark.parametrize("name", ["layernorm", "ln_qkv", "attention",
                                  "head_tail_ext"])
def test_other_dtypes_on_the_card_raise(fake_card, name):
    """float16 on the card raises in the wrapper; so does the f32 ext tail
    at a width it has no kernel for (C = 128). No entry point is called."""
    h = torch.float16
    calls = {
        "layernorm": lambda: ln_ops.layernorm(_f32(5, 384).to(h), _f32(384),
                                              _f32(384)),
        "ln_qkv": lambda: qkv_ops.ln_qkv(_f32(1, 5, 384).to(h), _f32(384),
                                         _f32(384), _f32(1152, 384).to(h),
                                         _f32(1152).to(h), 6, 0.125),
        "attention": lambda: attn_ops.attention(
            *(t.to(h) for t in _f32(3, 1, 5, 2, 64))),
        "head_tail_ext": lambda: ht.head_tail_ext(*_x_wts(128), (21, 35)),
    }
    with pytest.raises(ValueError):
        calls[name]()
    assert fake_card.calls == []
