"""PyTorch port: the folded preprocess against the JAX package's on the CPU,
and the pipeline's use of the preprocess ``auto`` resolves to."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.ops.preprocess import (
    preprocess_frames as jax_preprocess_frames)
from vr_video_generator_tpu_torch.ops.preprocess import (network_input_size,
                                                         preprocess_frames)

torch.set_num_threads(2)

# Output scale: the folded path's values lie in [-2.2, 2.7], where a bf16 ulp
# is 2^-6. The two frameworks run the same bf16 ops with f32 accumulation, so
# they may differ only where a sum sits at a bf16 rounding boundary: at most
# one ulp of the output's scale (measured: no difference at all).
MAX_ULPS = 1


def _ulp(size: float) -> float:
    return 2.0 ** (np.floor(np.log2(size)) - 7)


# 1080p -> 518 x 924 (the main path), an upsample (cv2's zoom emulation on
# both axes) and two small downsamples.
@pytest.mark.parametrize("b,h,w,target", [(1, 1080, 1920, 518),
                                          (2, 240, 320, 518),
                                          (3, 150, 96, 56), (2, 61, 97, 56)])
def test_folded_preprocess_matches_jax(b, h, w, target):
    frames = np.random.default_rng(h * w).integers(0, 256, (b, h, w, 3),
                                                   dtype=np.uint8)
    net_hw = network_input_size(h, w, target)
    want = np.asarray(jax_preprocess_frames(
        jnp.asarray(frames), net_hw, dtype=jnp.bfloat16,
        impl="folded").astype(jnp.float32))
    got = preprocess_frames(torch.from_numpy(frames), net_hw,
                            dtype=torch.bfloat16, impl="folded")
    assert got.dtype == torch.bfloat16 and got.shape == (b, *net_hw, 3)
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= MAX_ULPS * _ulp(np.abs(want).max())
    # and the fold stays within bf16 rounding of the exact f32 path
    exact = preprocess_frames(torch.from_numpy(frames), net_hw,
                              dtype=torch.float32, impl="exact").numpy()
    assert np.abs(got.float().numpy() - exact).max() < 0.1


def test_unknown_preprocess_raises():
    with pytest.raises(ValueError, match="'exact' or 'folded'"):
        preprocess_frames(torch.zeros(1, 28, 28, 3, dtype=torch.uint8),
                          (28, 28), impl="banded")


@pytest.mark.parametrize("preprocess", ["folded", "exact", "auto"])
def test_pipeline_passes_the_resolved_preprocess(preprocess):
    """SbsPipeline resolves ``preprocess`` once and its depth goes through
    that path (``auto`` is exact off the card)."""
    from vr_video_generator_tpu_torch.models.depth_anything_v2 import \
        infer_depth
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.utils.config import (ModelConfig,
                                                           RunConfig)

    cfg = ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                      mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                      intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                      mlp_fused="xla")
    model = build_model(cfg, random_state_dict(cfg, 0), torch.bfloat16, "cpu",
                        tail="xla")
    run_cfg = RunConfig(batch_size=2, input_size=56, mlp_fused="xla",
                        tail="xla", preprocess=preprocess)
    pipe = SbsPipeline(model, 61, 97, run_cfg=run_cfg)
    impl = "exact" if preprocess == "auto" else preprocess
    assert pipe.preprocess_impl == impl
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 61, 97, 3), dtype=np.uint8))
    depth = pipe.depth_only(frames)
    with torch.inference_mode():
        for other in ("exact", "folded"):
            want = infer_depth(model, frames, input_size=56, preprocess=other)
            assert torch.equal(depth, want) == (other == impl)
