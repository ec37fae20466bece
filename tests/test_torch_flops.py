"""PyTorch port: ``flops`` (the counterpart of scripts/flops.py) on the CPU:
the encoder's count against the analytic ViT count, full_net against
XLA's own count of the JAX package's model, and ``--config 1``'s output."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import \
    DepthAnythingV2 as JaxDepthAnythingV2
from vr_video_generator_tpu.utils.config import ModelConfig as JModelConfig
from vr_video_generator_tpu_torch import flops
from vr_video_generator_tpu_torch.models.factory import random_state_dict
from vr_video_generator_tpu_torch.ops.preprocess import network_input_size
from vr_video_generator_tpu_torch.utils.config import ModelConfig

torch.set_num_threads(2)

# A 4 x 4 pretraining grid, so that a 56 x 56 net input keeps the pos-embed
# as it is and a 56 x 98 one resamples it.
TINY = dict(encoder="vits", embed_dim=128, depth=2, num_heads=2,
            mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
            intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
            mlp_fused="xla", pretrain_img_size=56)
# full_net's count over XLA's (flops of jit(...).lower().compile()
# .cost_analysis()): XLA also counts the elementwise work, so the port's is
# no larger; measured 0.98 at this geometry (CPU), held to 0.95.
FULL_NET_MIN_RATIO = 0.95


def analytic_encoder_flops(cfg, hn: int, wn: int) -> int:
    """The DINOv2 trunk's products at one (hn, wn) input: the patch embed;
    the pos-embed's separable bicubic resample (H, then W) where the grid
    is not the pretraining one; and per block qkv + proj 2 N D (3D + D),
    attention 4 N^2 D and the MLP 2 N D 2 hidden."""
    p, d = cfg.patch_size, cfg.embed_dim
    ph, pw = hn // p, wn // p
    side = cfg.pretrain_img_size // p
    n = ph * pw + 1
    hidden = int(d * cfg.mlp_ratio)
    total = 2 * ph * pw * d * 3 * p * p
    if (ph, pw) != (side, side):
        total += 2 * d * ph * side * (side + pw)
    block = 2 * n * d * (3 * d + d) + 4 * n * n * d + 2 * n * d * 2 * hidden
    return total + cfg.depth * block


@pytest.mark.parametrize("h,w", [(56, 56), (60, 100)])
def test_encoder_count_equals_the_analytic_vit_count(h, w):
    cfg = ModelConfig(**TINY)
    hn, wn = network_input_size(h, w, target=56, multiple_of=14)
    counts = {name: (fl, by) for name, fl, by in
              flops.stage_counts(cfg, h, w, input_size=56)}
    assert counts["encoder"][0] == analytic_encoder_flops(cfg, hn, wn)
    assert counts["full_net"][0] > counts["encoder"][0]
    assert all(by > 0 for _, by in counts.values())


def test_full_net_count_against_xla_cost_analysis():
    """The port's full_net count against XLA's count of the JAX package's
    full_net on the same weights and geometry: no larger, since XLA's adds
    the elementwise work, and at least FULL_NET_MIN_RATIO of it."""
    cfg = ModelConfig(**TINY)
    h, w = 60, 100
    hn, wn = network_input_size(h, w, target=56, multiple_of=14)
    ours = dict((name, fl) for name, fl, _ in
                flops.stage_counts(cfg, h, w, input_size=56))["full_net"]
    jcfg = JModelConfig(**dataclasses.asdict(cfg))
    params = jax.tree.map(jnp.asarray, convert_state_dict(
        random_state_dict(cfg, 0), jcfg))
    model = JaxDepthAnythingV2(jcfg, dtype=jnp.float32, tail="xla")
    x = jnp.zeros((1, hn, wn, 3), jnp.float32)
    ca = jax.jit(lambda p, x: model.apply({"params": p}, x)).lower(
        params, x).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    xla = ca["flops"]
    assert FULL_NET_MIN_RATIO * xla <= ours <= xla, (ours, xla, ours / xla)


def test_flops_config_1_prints_four_stage_lines(capsys):
    """--config 1 (vits, 480 x 854, net 924 x 518): the header and the four
    stages in the JAX script's format, bytes labelled unfused."""
    assert flops.main(["--config", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "config 1: vits 854x480 b=8 net 924x518"
    pat = re.compile(r"^(\w+)\s*: +(\d+\.\d\d) GFLOP/frame, +(\d+\.\d) "
                     r"MiB unfused/frame$")
    rows = [pat.match(ln) for ln in lines[1:]]
    assert all(rows) and len(rows) == 4, lines
    got = {m.group(1): float(m.group(2)) for m in rows}
    assert list(got) == ["preprocess", "full_net", "encoder", "bicubic_up"]
    # the vits trunk at 37 x 66 patches: ~215 GFLOP, the head ~68 more
    assert 200 < got["encoder"] < got["full_net"] < 300
    assert 0 < got["bicubic_up"] < got["preprocess"] < 10
