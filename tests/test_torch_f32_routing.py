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
from vr_video_generator_tpu_torch.attic import refinenet_pre as rp
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
from vr_video_generator_tpu_torch.ops import mlp as mlp_ops
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
    off and on the card; check_f32_plan lets it through, every encoder's
    head width having both f32 tails (ext and big-C), and raises ValueError
    where the planned tail's JAX kernel refuses the head's width (a
    40-feature head: C2 = 20, no multiple of 8), naming its assert."""
    feats = ModelConfig.for_encoder(encoder).features
    assert ht.takes(feats) and ht.takes(feats, "big")
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
        check_f32_plan(cfg, 1080, 1920)
    cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                    mlp_fused="xla", tail="fused", input_size=56)
    narrow = dataclasses.replace(cfg.model(), features=40)
    with pytest.raises(ValueError,
                       match=r"(ext|big) DPT tail takes no head of C=40.*"
                             r"head_tail_pallas.py:(395|684)"):
        check_f32_plan(_with_model(cfg, narrow), 1080, 1920)
    if encoder == "vits":
        shape = jax_f32_plan("vits", "auto", "auto", 518)[4]
        assert resolve_tail("auto", shape, torch.float32, (518, 924),
                            "cuda") == "ext"


def _with_model(cfg, model_cfg):
    """``cfg`` whose model() returns ``model_cfg`` (a custom head)."""
    return types.SimpleNamespace(**{f.name: getattr(cfg, f.name)
                                    for f in dataclasses.fields(cfg)},
                                 model=lambda: model_cfg)


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


# The sizes each plan is built at below: 518, and where the plan changes
# with the size (vitl past 4096 tokens at 728: row 17; the big-C tail at
# vits-728 and vitl-252, the ext tail at C = 128 and 256 at vitb-252 and
# vitl-126; vitg's fused SwiGLU half, row 10, with the big-C tail at C = 384
# at 126 and 252, the tail unfused at 518, row 17 at 728).
PLAN_SIZES = {("vits", "auto", "auto"): (518, 728),
              ("vitb", "auto", "auto"): (518, 252),
              ("vitb", "xla", "auto"): (518, 252),
              ("vitl", "auto", "auto"): (518, 728, 252, 126),
              ("vitl", "xla", "xla"): (518, 728),
              ("vitg", "auto", "auto"): (518, 126, 252, 728),
              ("vitg", "fused", "fused"): (126, 518),
              ("vitg", "auto", "xla"): (56, 518)}


@pytest.mark.parametrize("encoder,mlp_fused,tail", [
    ("vits", "auto", "auto"), ("vits", "xla", "xla"), ("vitb", "xla", "xla"),
    ("vitl", "xla", "xla"), ("vitg", "xla", "xla"),
    ("vits", "fused", "fused"), ("vitb", "auto", "auto"),
    ("vitb", "xla", "auto"), ("vitl", "auto", "auto"),
    ("vitl", "fused", "fused"), ("vitg", "auto", "auto"),
    ("vitg", "fused", "fused"), ("vitg", "auto", "xla")])
def test_f32_plans_with_kernels_reach_load_model(monkeypatch, encoder,
                                                 mlp_fused, tail):
    """Every plan of every encoder at f32 passes the plan-time check on the
    card: the fused MLP half (row 8 at vits, row 9 at vitb and vitl, row 10
    at vitg), the big-C tail (vitb at 518, vits at 728, vitl at 252, vitg at
    126 and 252) and the ext tail at every width (vitb at 252, vitl at
    126), and vitl and vitg at 728 (past 4096 tokens: row 17)."""
    for size in PLAN_SIZES.get((encoder, mlp_fused, tail), (518,)):
        if encoder == "vitg" and mlp_fused != "xla":
            assert jax_f32_plan(encoder, mlp_fused, tail, size)[1] == 10
        cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                        mlp_fused=mlp_fused, tail=tail, input_size=size)
        assert _create_on_fake_card(monkeypatch, cfg) == "built"
        check_f32_plan(cfg, 1080, 1920)


def _narrow_head(monkeypatch):
    """RunConfig.model() with a custom head of 40 features, whose DPT tail
    the JAX kernels refuse (C2 = 20, no multiple of 8)."""
    model = RunConfig.model
    monkeypatch.setattr(RunConfig, "model", lambda self: dataclasses.replace(
        model(self), features=40))


@pytest.mark.parametrize("encoder,mlp_fused,tail,size,match", [
    ("vitg", "auto", "auto", 126, r"tail takes no head of C=40"),
    ("vitg", "fused", "fused", 126, r"tail takes no head of C=40"),
    ("vits", "auto", "auto", 518, r"tail takes no head of C=40")])
def test_f32_plans_without_kernels_raise_before_load_model(
        monkeypatch, encoder, mlp_fused, tail, size, match):
    """An f32 plan whose DPT tail the JAX kernels refuse (a custom head of
    40 features) raises ValueError naming the JAX assert, before load_model
    runs; vitg's fused SwiGLU half (row 10) no longer raises, so its plans
    here fail only at the tail."""
    _narrow_head(monkeypatch)
    cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                    mlp_fused=mlp_fused, tail=tail, input_size=size)
    assert cfg.model().features == 40
    with pytest.raises(ValueError, match=match) as info:
        _create_on_fake_card(monkeypatch, cfg)
    assert "head_tail_pallas.py" in str(info.value)


@pytest.mark.parametrize("encoder", ENCODERS)
def test_every_f32_plan_of_the_jax_package(encoder):
    """Over --input_size 56-728 at 1080p and every mlp_fused and tail
    choice, check_f32_plan passes each f32 plan of the JAX package at every
    encoder, vitg's plans that fuse the SwiGLU half (auto, fused: row 10)
    included."""
    fused_swiglu = 0
    for size in (56, *SIZES):
        for mlp_fused in ("auto", "fused", "xla"):
            for tail in ("auto", "fused", "xla"):
                _, jmlp, *_ = jax_f32_plan(encoder, mlp_fused, tail, size)
                cfg = RunConfig(encoder=encoder, compute_dtype="float32",
                                mlp_fused=mlp_fused, tail=tail,
                                input_size=size)
                check_f32_plan(cfg, 1080, 1920)
                fused_swiglu += jmlp == 10
    assert (fused_swiglu > 0) == (encoder == "vitg")


def test_sharded_path_checks_the_f32_plan_before_any_weight(monkeypatch):
    """The orchestrator's --mesh path: a plan the JAX kernels refuse (a
    custom head of 40 features, its tail) raises before load_model; vits
    auto and vitg fused reach it."""
    from vr_video_generator_tpu_torch.parallel import mesh as mesh_mod
    from vr_video_generator_tpu_torch.runtime import orchestrator

    monkeypatch.setattr(pipeline, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(mesh_mod, "make_mesh", lambda *a, **k: None)
    monkeypatch.setattr(factory, "load_model", _load_model)
    base = RunConfig(encoder="vits", compute_dtype="float32",
                     mesh_shape=(1, 1))
    vitg = dataclasses.replace(base, encoder="vitg", mlp_fused="fused",
                               tail="fused", input_size=126)
    for cfg in (base, vitg):
        with pytest.raises(Reached):
            orchestrator._convert_range_sharded(cfg, 0, 8, 1920, 1080,
                                                device="cuda")
    _narrow_head(monkeypatch)
    with pytest.raises(ValueError, match=r"tail takes no head of C=40"):
        orchestrator._convert_range_sharded(vitg, 0, 8, 1920, 1080,
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
    for mod in (ln_ops, qkv_ops, attn_ops, ht, mlp_ops, rp):
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


def _mlp_args(d):
    return (_f32(1, 5, d), _f32(d), _f32(d), _f32(4 * d, d), _f32(4 * d),
            _f32(d, 4 * d), _f32(d), _f32(d))


def _swiglu_args(d=1536, hid=4096):
    return (_f32(1, 3, d), _f32(d), _f32(d), _f32(2 * hid, d), _f32(2 * hid),
            _f32(d, hid), _f32(d), _f32(d))


def _base_args(c):
    return (_f32(1, 6, 10, c), _f32(c // 2, c, 3, 3), _f32(c // 2),
            _f32(32, c // 2, 3, 3), _f32(32), _f32(1, 32, 1, 1), _f32(1))


def _rcu_conv_args(c, nres=0):
    return (_f32(1, 4, 6, c), _f32(c, c, 3, 3), _f32(c), nres == 0,
            tuple(_f32(1, 4, 6, c) for _ in range(nres)))


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
    "head_tail_ext C=256": (lambda: ht.head_tail_ext(*_x_wts(256), (21, 35)),
                            "vrvg_head_tail_ext_f32", "head_tail_ext_f32"),
    "head_tail_ext C=32": (lambda: ht.head_tail_ext(*_x_wts(32), (21, 35)),
                           "vrvg_head_tail_ext_f32", "head_tail_ext_f32"),
    "head_tail_big_front": (lambda: ht.head_tail_big(*_x_wts(128), (21, 35)),
                            "vrvg_head_tail_big_f32", "head_tail_big_f32"),
    "conv3x3": (lambda: ht.conv3x3_f32(_f32(1, 6, 10, 64), _f32(32, 64, 3, 3)),
                "vrvg_conv3x3_f32", "conv3x3_f32"),
    "mlp_residual": (lambda: mlp_ops.mlp_residual(*_mlp_args(384)),
                     "vrvg_mlp_residual_f32", "mlp_residual_f32"),
    "mlp_residual_tanh": (lambda: mlp_ops.mlp_residual(*_mlp_args(128),
                                                       approx=True),
                          "vrvg_mlp_residual_f32", "mlp_residual_f32"),
    "mlp_residual_hblocked": (lambda: mlp_ops.mlp_residual_hblocked(
        *_mlp_args(768)), "vrvg_mlp_residual_hblocked_f32",
        "mlp_residual_hblocked_f32"),
    "mlp_residual_hblocked_tanh": (lambda: mlp_ops.mlp_residual_hblocked(
        *_mlp_args(1024), approx=True), "vrvg_mlp_residual_hblocked_f32",
        "mlp_residual_hblocked_f32"),
    "fc1_gelu": (lambda: mlp_ops.fc1_gelu_kernel(_f32(1, 5, 128),
                                                 _f32(512, 128), _f32(512)),
                 "vrvg_fc1_gelu_f32", "fc1_gelu_f32"),
    "swiglu_residual": (lambda: mlp_ops.swiglu_residual(*_swiglu_args()),
                        "vrvg_swiglu_residual_f32", "swiglu_residual_f32"),
    "swiglu_gate": (lambda: mlp_ops.swiglu_gate_kernel(
        _f32(1, 5, 128), _f32(688, 128), _f32(688)), "vrvg_swiglu_gate_f32",
        "swiglu_gate_f32"),
    "head_tail": (lambda: ht.head_tail(*_base_args(64), (21, 35)),
                  "vrvg_head_tail_f32", "head_tail_f32"),
    "head_tail C=128": (lambda: ht.head_tail(*_base_args(128), (21, 35)),
                        "vrvg_head_tail_f32", "head_tail_f32"),
    "head_tail C=32": (lambda: ht.head_tail(*_base_args(32), (21, 35)),
                       "vrvg_head_tail_f32", "head_tail_f32"),
    "rcu_pair": (lambda: rp.rcu_conv(*_rcu_conv_args(64)),
                 "vrvg_rcu_conv_f32", "rcu_pair_f32"),
    "rcu_pair C=128": (lambda: rp.rcu_conv(*_rcu_conv_args(128, 2),
                                           relu_copy=True),
                       "vrvg_rcu_conv_f32", "rcu_pair_f32"),
}


# The weights each f32 chain on the 3xTF32 core splits first (fresh weights
# here: nothing is kept from an earlier call), one vrvg_tf32x3_split each:
# rows 5 and 6's product, rows 8, 9 and 10's two products, rows 11 and 12's
# two convs, row 7's mix and two convs, row 15's two convs, row 16's conv.
SPLITS = {"ln_qkv": 1, "proj_ls_residual": 1, "mlp_residual": 2, "mlp_residual_tanh": 2,
          "mlp_residual_hblocked": 2, "mlp_residual_hblocked_tanh": 2,
          "fc1_gelu": 1, "swiglu_residual": 2, "swiglu_gate": 1,
          "head_tail_big_front": 2, "conv3x3": 1, "head_tail_ext": 3,
          "head_tail_ext C=256": 3, "head_tail_ext C=32": 3, "head_tail": 2,
          "head_tail C=128": 2, "head_tail C=32": 2,
          "rcu_pair": 1, "rcu_pair C=128": 1}


@pytest.mark.parametrize("name", list(CALLS))
def test_f32_cuda_tensor_launches_the_f32_kernel(fake_card, name):
    """An f32 tensor on the card goes to its wrapper's f32 entry point, once,
    and counts on the f32 counter, never on the bf16 one (the case's name,
    where the kernel has one); it never reaches the plain version. Rows
    5-12, 15 and 16 split each weight on the card first
    (vrvg_tf32x3_split)."""
    call, entry, counter = CALLS[name]
    before = launch_counts()
    call()
    after = launch_counts()
    splits = SPLITS.get(name, 0)
    assert fake_card.calls == ["vrvg_tf32x3_split"] * splits + [entry]
    assert after["tf32x3_split"] == before.get("tf32x3_split", 0) + splits
    assert after[counter] == before.get(counter, 0) + 1
    bf16 = name.split()[0]
    assert after.get(bf16, 0) == before.get(bf16, 0)


@pytest.mark.parametrize("name", ["layernorm", "ln_qkv", "attention",
                                  "head_tail_ext", "head_tail_big",
                                  "mlp_residual", "mlp_residual_hblocked",
                                  "mlp_residual f16", "swiglu_residual f16",
                                  "head_tail f16", "rcu_pair f16",
                                  "head_tail C=40", "swiglu_gate width",
                                  "rcu_pair mixed"])
def test_other_dtypes_on_the_card_raise(fake_card, name):
    """float16 on the card raises in the wrapper (rows 1, 5, 2, 8, 10, 15
    and 16); so does an f32 kernel at a width it has no kernel for (row 8
    at D = 768, row 9 at D = 384), a DPT tail at a width the JAX kernels
    refuse (rows 7 and 15 at C = 40, rows 11 and 12 at C = 160), the f32
    gate stage given a w12 of another width than h, or an RCU conv whose
    residual's dtype is not its input's. No entry point is called."""
    h = torch.float16
    calls = {
        "layernorm": lambda: ln_ops.layernorm(_f32(5, 384).to(h), _f32(384),
                                              _f32(384)),
        "ln_qkv": lambda: qkv_ops.ln_qkv(_f32(1, 5, 384).to(h), _f32(384),
                                         _f32(384), _f32(1152, 384).to(h),
                                         _f32(1152).to(h), 6, 0.125),
        "attention": lambda: attn_ops.attention(
            *(t.to(h) for t in _f32(3, 1, 5, 2, 64))),
        "head_tail_ext": lambda: ht.head_tail_ext(*_x_wts(40), (21, 35)),
        "head_tail_big": lambda: ht.head_tail_big(*_x_wts(160), (21, 35)),
        "mlp_residual": lambda: mlp_ops.mlp_residual(*_mlp_args(768)),
        "mlp_residual_hblocked": lambda: mlp_ops.mlp_residual_hblocked(
            *_mlp_args(384)),
        "mlp_residual f16": lambda: mlp_ops.mlp_residual(
            *(t.to(h) for t in _mlp_args(384))),
        "swiglu_residual f16": lambda: mlp_ops.swiglu_residual(
            *(t.to(h) for t in _swiglu_args())),
        "head_tail f16": lambda: ht.head_tail(
            *(t.to(h) for t in _base_args(64)), (21, 35)),
        "rcu_pair f16": lambda: rp.rcu_conv(
            *(t.to(h) if torch.is_tensor(t) else t
              for t in _rcu_conv_args(64))),
        "head_tail C=40": lambda: ht.head_tail(*_base_args(40), (21, 35)),
        "swiglu_gate width": lambda: mlp_ops.swiglu_gate_kernel(
            _f32(1, 5, 126), _f32(688, 128), _f32(688)),
        "rcu_pair mixed": lambda: rp.rcu_conv(
            _f32(1, 4, 6, 64), _f32(64, 64, 3, 3), _f32(64), False,
            (_f32(1, 4, 6, 64).to(torch.bfloat16),)),
    }
    with pytest.raises(ValueError):
        calls[name]()
    assert fake_card.calls == []


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
def test_bench_configs_at_f32_pass_the_plan_check(config):
    """Every bench configuration at f32 on the card (its encoder, geometry
    and batch, input 518, auto) passes check_f32_plan: configs 3 (vitb) and
    4, 5 (vitl) now run rows 9, 11 and 12 at f32, where before only config
    2's vits reached its f32 metric; the metric takes _f32."""
    from vr_video_generator_tpu_torch import bench

    encoder, h, w, b, step = bench.CONFIGS[config]
    cfg = RunConfig(encoder=encoder, batch_size=b, offset_step_size=step,
                    input_size=518, compute_dtype="float32")
    check_f32_plan(cfg, h, w)
    assert bench._dtype_tag("float32", True) == ("float32", "_f32")
    assert bench._dtype_tag(None, True) == ("bfloat16", "")
