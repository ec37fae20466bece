"""PyTorch port: --gelu tanh on the CPU. ops/gelu.gelu_tanh against
jax.nn.gelu(approximate=True) on every bf16 input and at f32, the MLP
half's plain versions at approx against the JAX reference and the Pallas
kernel in interpret mode, the wrappers' routing of the flag, and a
--gelu tanh pipeline against the JAX SbsPipeline with the same weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.ops.mlp_pallas import (mlp_residual_pallas,
                                                   mlp_residual_ref)
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils import config as jconfig
from vr_video_generator_tpu_torch.kernels import launch_counts
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops import mlp
from vr_video_generator_tpu_torch.ops.gelu import gelu_exact, gelu_tanh
from vr_video_generator_tpu_torch.pipeline import SbsPipeline, check_supported
from vr_video_generator_tpu_torch.utils import config

torch.set_num_threads(2)
torch.set_grad_enabled(False)

# The smallest normal f32 (and bf16) value. XLA's CPU backend flushes
# subnormal results to zero and PyTorch keeps them, so where 0.5 * x is
# below it (|x| < 2**-125) the two differ by design, not by a rounding
# point; those inputs are left out of the bit-for-bit check.
TINY_NORMAL = float(np.finfo(np.float32).tiny)


def _all_bf16():
    return torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)


def _jax_gelu(x: torch.Tensor, dtype) -> np.ndarray:
    return np.asarray(jax.nn.gelu(jnp.asarray(x.float().numpy()).astype(dtype),
                                  approximate=True).astype(jnp.float32))


def test_gelu_tanh_matches_jax_on_every_bf16_input():
    """Bit for bit on every bf16 input whose result is a normal number
    (NaN inputs give NaN on both sides); the subnormal results are left out
    (see TINY_NORMAL)."""
    x = _all_bf16()
    ours = gelu_tanh(x).float().numpy()
    ref = _jax_gelu(x, jnp.bfloat16)
    xs = x.float().numpy()
    keep = ~(np.abs(xs) < 2 * TINY_NORMAL)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(ours), nan)
    ok = keep & ~nan
    # all but the 512 inputs below 2**-125 in magnitude and the NaNs
    assert (~keep).sum() == 512 and ok.sum() == 65536 - 512 - nan.sum()
    np.testing.assert_array_equal(ours[ok].view(np.int32),
                                  ref[ok].view(np.int32))


def test_gelu_tanh_f32_matches_jax():
    """At f32 XLA's tanh differs from torch's by up to ~2.4e-7, so the two
    agree to within 1e-6 * max(1, |x|), not bit for bit."""
    rng = np.random.default_rng(16)
    xs = np.concatenate([rng.normal(0, 3, 50000),
                         rng.uniform(-12, 12, 50000)]).astype(np.float32)
    ours = gelu_tanh(torch.from_numpy(xs)).numpy()
    ref = _jax_gelu(torch.from_numpy(xs), jnp.float32)
    assert ours.dtype == np.float32
    assert (np.abs(ours - ref) <= 1e-6 * np.maximum(1.0, np.abs(xs))).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_tanh_constants_in_the_input_dtype(dtype):
    """0.044715 and sqrt(2/pi) are taken in x's dtype, as jax.nn.gelu holds
    them (a weak-typed float, and numpy's astype)."""
    from vr_video_generator_tpu_torch.ops.gelu import _tanh_consts

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = (float(jnp.asarray(0.044715, jdt)),
            float(np.sqrt(2 / np.pi).astype(jdt)))
    assert _tanh_consts(dtype) == want


def test_gelu_tanh_is_not_the_f32_form():
    """torch's F.gelu(approximate='tanh') computes in f32 and rounds once;
    it differs from the JAX function on over a thousand bf16 inputs, which
    is why the port does not call it."""
    x = _all_bf16()
    x = x[torch.isfinite(x) & (x.float().abs() >= 2 * TINY_NORMAL)]
    ref = torch.from_numpy(_jax_gelu(x, jnp.bfloat16).copy())
    assert torch.equal(gelu_tanh(x).float(), ref)
    assert int((F.gelu(x, approximate="tanh").float() != ref).sum()) > 1000


def _mlp_case(rng, m, d):
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    p = dict(
        ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
        ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
        w1=(rng.standard_normal((d, 4 * d)) * 0.05).astype(np.float32),
        b1=(0.1 * rng.standard_normal(4 * d)).astype(np.float32),
        w2=(rng.standard_normal((4 * d, d)) * 0.05).astype(np.float32),
        b2=(0.1 * rng.standard_normal(d)).astype(np.float32),
        gamma=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    return x, p


def _port_args(x, p, tdt):
    t = lambda a, dt=tdt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    return (t(x), t(p["ln_scale"], torch.float32),
            t(p["ln_bias"], torch.float32), t(p["w1"].T), t(p["b1"]),
            t(p["w2"].T), t(p["b2"]), t(p["gamma"]))


@pytest.mark.parametrize("dtype,atol", [
    (jnp.float32, 2e-5),    # the JAX tests' bounds
    (jnp.bfloat16, 6e-2),   # (tests/test_mlp_pallas.py:44,58)
])
@pytest.mark.parametrize("against", ["ref", "pallas"])
def test_mlp_residual_plain_at_tanh_matches_jax(dtype, atol, against):
    """mlp_residual_plain(approx=True) against JAX's mlp_residual_ref(...,
    approx=True) and the Pallas kernel (interpret mode) with approx=True."""
    x, p = _mlp_case(np.random.default_rng(16), 72, 128)
    jargs = {k: jnp.asarray(v) for k, v in p.items()}
    if against == "ref":
        ref = mlp_residual_ref(jnp.asarray(x, dtype), *jargs.values(),
                               approx=True)
    else:
        ref = mlp_residual_pallas(jnp.asarray(x, dtype), **jargs, approx=True,
                                  interpret=True)
    tdt = getattr(torch, str(jnp.dtype(dtype)))
    ours = mlp.mlp_residual_plain(*_port_args(x, p, tdt), approx=True)
    np.testing.assert_allclose(ours.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=0, atol=atol)


def test_tanh_and_exact_mlp_differ():
    """The flag reaches the GELU: approx=True and False give other outputs
    on the same operands, and the fc1 stage is exactly the chosen GELU of
    the product plus bias."""
    x, p = _mlp_case(np.random.default_rng(3), 40, 128)
    args = _port_args(x, p, torch.float32)
    assert not torch.equal(mlp.mlp_residual_plain(*args, approx=True),
                           mlp.mlp_residual_plain(*args))
    a = torch.from_numpy(x)
    t = F.linear(a, args[3]) + args[4]
    assert torch.equal(mlp.fc1_gelu_plain(a, args[3], args[4], approx=True),
                       gelu_tanh(t))
    assert torch.equal(mlp.fc1_gelu_plain(a, args[3], args[4]),
                       gelu_exact(t))


@pytest.mark.parametrize("fn", ["mlp_residual", "mlp_residual_hblocked"])
@pytest.mark.parametrize("approx", [True, False])
def test_wrappers_route_the_flag_on_the_cpu(fn, approx):
    """On CPU tensors the row 8 and row 9 wrappers and their stage functions
    run the plain versions with the flag, and count no launch."""
    x, p = _mlp_case(np.random.default_rng(5), 24, 128)
    args = _port_args(x, p, torch.bfloat16)
    before = launch_counts()
    got = getattr(mlp, fn)(*args, approx=approx)
    a, h, out = getattr(mlp, f"{fn}_stages")(*args, approx=approx)
    want = mlp.mlp_residual_plain(*args, approx=approx)
    assert torch.equal(got, want) and torch.equal(out, want)
    assert torch.equal(h, mlp.fc1_gelu_plain(a, args[3], args[4], approx))
    assert launch_counts() == before


def test_gelu_tanh_kernel_wrapper_on_the_cpu():
    x = _all_bf16()
    assert torch.equal(mlp.gelu_tanh_kernel(x).view(torch.int16),
                       gelu_tanh(x).view(torch.int16))


# --- the model and the pipeline ------------------------------------------

TINY = config.ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                          mlp_ratio=4.0, features=32,
                          out_channels=(8, 16, 32, 32),
                          intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                          mlp_fused="xla", gelu_approx=True)


def test_run_config_sets_the_flag_and_check_passes():
    cfg = config.RunConfig(gelu="tanh")
    assert cfg.model().gelu_approx
    check_supported(cfg)
    model = build_model(TINY, random_state_dict(TINY), torch.float32, "cpu")
    assert all(b.mlp.gelu_approx for b in model.pretrained.blocks)


@pytest.mark.parametrize("mlp_fused", ["xla", "fused"])
def test_tanh_pipeline_matches_jax(mlp_fused):
    """A --gelu tanh SbsPipeline (unfused, and fused through the plain
    versions) against the JAX SbsPipeline with gelu_approx and the same
    weights, two batches with carried state: depth within 1e-4 of its max,
    the right half equal to the input, the left half equal on >= 99.9% of
    pixels (an f32 ulp of depth can move a pixel across a band edge)."""
    cfg = dataclasses.replace(TINY, mlp_fused=mlp_fused)
    sd = random_state_dict(cfg, seed=16)
    h, w, bsz = 150, 96, 4
    run = config.RunConfig(batch_size=bsz, input_size=56,
                           compute_dtype="float32", mlp_fused=mlp_fused,
                           tail="xla", gelu="tanh")
    jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
    jmodel = JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="xla")
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(sd, cfg))
    jpipe = JaxSbsPipeline(jmodel, jparams, h, w,
                           run_cfg=jconfig.RunConfig(**dataclasses.asdict(run)))
    pipe = SbsPipeline(build_model(cfg, sd, torch.float32, "cpu", tail="xla"),
                       h, w, run_cfg=run)
    frames = np.random.default_rng(12).integers(0, 256, (2 * bsz, h, w, 3),
                                                dtype=np.uint8)
    jstate, state = jpipe.initial_state(), pipe.initial_state()
    for i in range(2):
        batch = frames[i * bsz:(i + 1) * bsz]
        jdepth = np.asarray(jpipe.depth_only(batch))
        depth = pipe.depth_only(batch).numpy()
        assert np.abs(depth - jdepth).max() <= 1e-4 * np.abs(jdepth).max()
        jsbs, jstate = jpipe.step(batch, jstate)
        sbs, state = pipe.step(batch, state)
        jsbs, sbs = np.asarray(jsbs), sbs.numpy()
        np.testing.assert_array_equal(sbs[:, :, w:], batch)
        same = np.all(sbs[:, :, :w] == jsbs[:, :, :w], axis=-1).mean()
        assert same >= 0.999, f"batch {i}: {same:.5f} of left pixels equal"
    exact = SbsPipeline(build_model(dataclasses.replace(cfg, gelu_approx=False),
                                    sd, torch.float32, "cpu", tail="xla"),
                        h, w, run_cfg=dataclasses.replace(run, gelu="exact"))
    assert not np.array_equal(exact.depth_only(frames[:bsz]).numpy(),
                              pipe.depth_only(frames[:bsz]).numpy())
