"""PyTorch port: ``parity_report`` (the counterpart of
scripts/parity_report.py) on the CPU: its per-pixel gate, a whole report
with --spread_depth, and its reference side's pipeline against the JAX
package's through the same gate."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import \
    DepthAnythingV2 as JaxDepthAnythingV2
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils.config import ModelConfig as JModelConfig
from vr_video_generator_tpu.utils.config import RunConfig as JRunConfig
from vr_video_generator_tpu_torch import RunConfig, parity_report
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline
from vr_video_generator_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(2)

GATE, BUDGET = 1e-2, 1e-3


def test_gate_counts_the_fraction_over_the_gate():
    """|diff| / 255 over the gate: 3 pixel values of 4800 off by 5 (past
    0.01 x 255 = 2.55), 10 by 2 (under it); the fraction, mean and max
    are those of the values, and the frame passes a budget of 1e-3."""
    ref = np.full((40, 40, 3), 100, np.uint8)
    ours = ref.copy()
    ours.reshape(-1)[:3] += 5
    ours.reshape(-1)[100:110] -= 2
    mean, mx, frac = parity_report.frame_stats(ours, ref, GATE)
    assert frac == 3 / ref.size
    assert mx == 5 / 255
    assert mean == (3 * 5 + 10 * 2) / 255 / ref.size
    assert parity_report.gate_passes([(mean, mx, frac)], GATE, BUDGET)
    assert not parity_report.gate_passes([(mean, mx, frac)], GATE, 5e-4)


def test_gate_fails_a_report_on_one_frame():
    """One frame over the fraction budget, or over the gate in mean, fails
    the report; the per-frame lines and the RESULT line are the JAX
    script's."""
    good = (1e-4, 0.02, 1e-4)
    stats = [good, (2e-3, 0.9, 2e-3), good]
    assert not parity_report.gate_passes(stats, GATE, BUDGET)
    lines = parity_report.report_lines(stats, GATE, BUDGET)
    assert lines[1] == "frame 1: mean=0.00200 max=0.900 frac_over_gate=0.002000"
    assert lines[-1] == ("RESULT: worst frac(|diff|>0.01) = 0.002000 (budget "
                         "0.001), worst mean = 0.00200, worst max = 0.900 -> "
                         "FAIL")
    assert not parity_report.gate_passes([(0.02, 0.03, 0.0)], GATE, BUDGET)
    assert parity_report.report_lines([good], GATE, BUDGET)[-1].endswith(
        "-> PASS")


def test_parity_report_cpu_spread_depth_passes(tmp_path, capsys):
    """A 4-frame 64 x 48 clip at f32 with --spread_depth on the CPU: exit 0,
    the spread applied, one line a frame."""
    video = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (48, 128, 3), dtype=np.uint8)
    for i in range(4):
        w.write(np.ascontiguousarray(base[:, 3 * i:3 * i + 64]))
    w.release()
    assert parity_report.main(["--video", video, "--frames", "4",
                               "--input_size", "56", "--device", "cpu",
                               "--spread_depth"]) == 0
    out = capsys.readouterr().out
    assert "spread_depth: median=" in out
    assert sum(ln.startswith("frame ") for ln in out.splitlines()) == 4
    assert out.strip().splitlines()[-1].endswith("-> PASS")


def test_spread_depth_scales_the_final_conv():
    """--spread_depth changes only the final 1x1 head conv: weight x g,
    bias -> (bias - median) x g, g = 9.5 / (scaler (max - median)), so the
    probe's maximum depth sits midway between two integers: a last-ulp
    change of the depth leaves ceil(max), and with it the plane tables, as
    they were."""
    cfg = ModelConfig(encoder="vits", embed_dim=64, depth=2, num_heads=2,
                      mlp_ratio=4.0, features=16,
                      out_channels=(8, 16, 32, 32),
                      intermediate_layers=(0, 1, 1, 1), depth_scaler=3.0,
                      mlp_fused="xla")
    sd = random_state_dict(cfg, seed=1)
    model = build_model(cfg, sd, torch.float32, "cpu")
    probe = np.random.default_rng(2).integers(0, 256, (48, 64, 3),
                                              dtype=np.uint8)
    new = parity_report.spread_depth(model.state_dict(), model, probe, 56, 3.0)
    key = parity_report.FINAL_CONV
    changed = [k for k in sd if not torch.equal(torch.as_tensor(sd[k]),
                                                new[k])]
    assert sorted(changed) == [f"{key}.bias", f"{key}.weight"]
    g = float(new[f"{key}.weight"].flatten()[0] / sd[f"{key}.weight"].flat[0])
    spread = build_model(cfg, new, torch.float32, "cpu")
    from vr_video_generator_tpu_torch.models.depth_anything_v2 import \
        infer_depth
    with torch.inference_mode():
        d = infer_depth(spread, torch.from_numpy(probe[None]), 56)[0]
    assert g > 1
    assert abs(float(d.max()) - parity_report.SPREAD_MAX) < 1e-4
    assert parity_report.SPREAD_MAX % 1 == 0.5


def test_reference_side_pipeline_against_jax_through_the_gate():
    """The port's CPU SbsPipeline (the reference side's plain path) against
    the JAX package's SbsPipeline on the same converted weights, three
    batches with carried state, each frame through the report's gate."""
    tiny = dict(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                mlp_fused="xla")
    h, w, b = 150, 96, 4
    cfg = ModelConfig(**tiny)
    sd = random_state_dict(cfg, seed=2)
    run = dict(batch_size=b, input_size=56, compute_dtype="float32",
               mlp_fused="xla", tail="xla")
    pipe = SbsPipeline(build_model(cfg, sd, torch.float32, "cpu"), h, w,
                       run_cfg=RunConfig(**run))
    jcfg = JModelConfig(**tiny)
    jpipe = JaxSbsPipeline(
        JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="xla"),
        jax.tree.map(jnp.asarray, convert_state_dict(sd, jcfg)), h, w,
        run_cfg=JRunConfig(**run))
    frames = np.random.default_rng(11).integers(0, 256, (3 * b, h, w, 3),
                                                dtype=np.uint8)
    state, jstate = pipe.initial_state(), jpipe.initial_state()
    stats = []
    for i in range(3):
        batch = frames[i * b:(i + 1) * b]
        ours, state = pipe.step(batch, state)
        ref, jstate = jpipe.step(batch, jstate)
        ours, ref = ours.numpy(), np.asarray(ref)
        assert np.any(ours[:, :, :w] != batch, axis=-1).mean() > 0.5
        stats += [parity_report.frame_stats(o, r, GATE)
                  for o, r in zip(ours, ref)]
    assert parity_report.gate_passes(stats, GATE, BUDGET), stats
    defaults = parity_report.build_parser().parse_args(["--video", "x"])
    assert (defaults.gate, defaults.frac_budget) == (GATE, BUDGET)
