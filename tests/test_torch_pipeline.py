"""PyTorch port, the slice: SbsPipeline against the JAX SbsPipeline, the
pipeline and segment contracts, the CLI on the CPU, and the explicit
failures of what is not ported."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vr_video_generator_tpu.models.convert import convert_state_dict
from vr_video_generator_tpu.models.depth_anything_v2 import (
    DepthAnythingV2 as JaxDepthAnythingV2)
from vr_video_generator_tpu.ops.temporal import (TemporalState as
                                                 JaxTemporalState,
                                                 temporal_scan as
                                                 jax_temporal_scan)
from vr_video_generator_tpu.pipeline import SbsPipeline as JaxSbsPipeline
from vr_video_generator_tpu.utils.config import ModelConfig, RunConfig
from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                         random_state_dict)
from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                       temporal_scan)
from vr_video_generator_tpu_torch.pipeline import SbsPipeline, check_supported
from vr_video_generator_tpu_torch.runtime.segment import process_segment

torch.set_num_threads(2)

# The depth scaler lifts the random net's raw depth (max ~0.2) to ~[0, 14]
# and 150 rows give a (5, 3) blur window, so many shifts are live and the
# warp moves most pixels.
TINY = ModelConfig(encoder="vits", embed_dim=128, depth=2, num_heads=2,
                   mlp_ratio=4.0, features=16, out_channels=(8, 16, 32, 32),
                   intermediate_layers=(0, 1, 1, 1), depth_scaler=12.0,
                   mlp_fused="xla")
H, W, BATCH = 150, 96, 4
CFG = RunConfig(batch_size=BATCH, input_size=56, compute_dtype="float32",
                mlp_fused="xla", tail="xla")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights():
    return random_state_dict(TINY, seed=2)


@pytest.fixture(scope="module")
def pipe(weights):
    return SbsPipeline(build_model(TINY, weights, torch.float32, "cpu"), H, W,
                       run_cfg=CFG)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(11).integers(0, 256, (3 * BATCH, H, W, 3),
                                              dtype=np.uint8)


def test_slice_matches_jax_pipeline(pipe, weights, frames):
    """Three consecutive batches with carried state: depth within 1e-4
    relative, the right half bit-equal to the input, the warp bit-exact
    given identical depth, and the left half equal on >= 99.9% of pixels
    (an f32 ulp of depth can move a pixel across a band edge)."""
    jmodel = JaxDepthAnythingV2(TINY, dtype=jnp.float32, tail="xla")
    jparams = jax.tree.map(jnp.asarray, convert_state_dict(weights, TINY))
    jpipe = JaxSbsPipeline(jmodel, jparams, H, W, run_cfg=CFG)
    jstate, state = jpipe.initial_state(), pipe.initial_state()
    wstate, jwstate = TemporalState.initial(H, W), JaxTemporalState.initial(H, W)
    for i in range(3):
        batch = frames[i * BATCH:(i + 1) * BATCH]
        jdepth = np.asarray(jpipe.depth_only(batch))
        depth = pipe.depth_only(batch).numpy()
        assert np.abs(depth - jdepth).max() <= 1e-4 * np.abs(jdepth).max()

        # the warp of identical depth, through both temporal scans
        jblend, jranges, jwstate = jax_temporal_scan(jnp.asarray(jdepth),
                                                     jwstate, jpipe.spec)
        jsbs_warp = np.asarray(jpipe.spec.warp_batch(
            jnp.asarray(batch), jblend, jranges))
        blend, ranges, wstate = temporal_scan(torch.from_numpy(jdepth.copy()),
                                              wstate, pipe.spec)
        np.testing.assert_array_equal(blend.numpy(), np.asarray(jblend))
        np.testing.assert_array_equal(ranges.numpy(), np.asarray(jranges))
        np.testing.assert_array_equal(
            pipe.spec.warp_batch(torch.from_numpy(batch), blend, ranges).numpy(),
            jsbs_warp)

        jsbs, jstate = jpipe.step(batch, jstate)
        sbs, state = pipe.step(batch, state)
        jsbs, sbs = np.asarray(jsbs), sbs.numpy()
        np.testing.assert_array_equal(sbs[:, :, W:], batch)
        np.testing.assert_array_equal(jsbs[:, :, W:], batch)
        # the warp is not degenerate: most left-eye pixels moved
        assert np.any(sbs[:, :, :W] != batch, axis=-1).mean() > 0.5
        same = np.all(sbs[:, :, :W] == jsbs[:, :, :W], axis=-1).mean()
        assert same >= 0.999, f"batch {i}: {same:.5f} of left pixels equal"
    np.testing.assert_allclose(state.offset_range.numpy(),
                               np.asarray(jstate.offset_range), rtol=1e-5)


def test_step_shapes_and_dtype(pipe, frames):
    sbs, state = pipe.step(frames[:BATCH], pipe.initial_state())
    assert sbs.shape == (BATCH, H, 2 * W, 3) and sbs.dtype == torch.uint8
    np.testing.assert_array_equal(sbs[:, :, W:].numpy(), frames[:BATCH])
    assert bool(state.has_state) and state.overflow.dtype == torch.int32


def test_batch_boundaries_are_invisible(pipe, frames):
    full, st_full = pipe.step(frames[:4], pipe.initial_state())
    st = pipe.initial_state()
    a, st = pipe.step(frames[:2], st)
    b, st = pipe.step(frames[2:4], st)
    np.testing.assert_array_equal(full.numpy(), torch.cat([a, b]).numpy())
    np.testing.assert_array_equal(st.d_prev1.numpy(), st_full.d_prev1.numpy())
    np.testing.assert_array_equal(st.offset_range.numpy(),
                                  st_full.offset_range.numpy())


def test_primed_state_removes_segment_reset(pipe, frames):
    st = pipe.initial_state()
    outs = []
    for lo in range(0, 12, 4):
        sbs, st = pipe.step(frames[lo:lo + 4], st)
        outs.append(sbs.numpy())
    full = np.concatenate(outs)
    # 6 warm-up frames at batch 4 front-pad 2 copies of frame 0
    primed = pipe.primed_state(frames[:6], batch_size=4)
    assert bool(primed.has_state) and int(primed.overflow) == 0
    sbs, _ = pipe.step(frames[6:10], primed)
    np.testing.assert_array_equal(sbs.numpy(), full[6:10])
    sbs2, after = pipe.step(frames[8:12],
                            pipe.primed_state(frames[:8], batch_size=4))
    np.testing.assert_array_equal(sbs2.numpy(), full[8:12])
    np.testing.assert_array_equal(after.offset_range.numpy(),
                                  st.offset_range.numpy())
    assert not bool(pipe.primed_state(frames[:0], batch_size=4).has_state)


def test_n_valid_masks_overflow_tally(pipe):
    """Only the first n_valid frames count toward the over-cap tally, and
    the depth is clamped at the cap."""
    raw = np.full((4, H, W), 5.0, np.float32)
    raw[1:, 0, 0] = 40.0  # frames 1..3 exceed limit_step_cap (24)
    for n_valid, want in ((None, 3), (2, 1), (1, 0)):
        blended, _, st = temporal_scan(torch.from_numpy(raw),
                                       TemporalState.initial(H, W), pipe.spec,
                                       n_valid=n_valid)
        _, _, jst = jax_temporal_scan(jnp.asarray(raw),
                                      JaxTemporalState.initial(H, W),
                                      pipe.spec, n_valid=n_valid)
        assert int(st.overflow) == int(jst.overflow) == want
        assert float(blended.max()) <= 24.0


class _Reader:
    def __init__(self, frames):
        self.frames, self.pos = frames, 0
        self.height, self.width = frames.shape[1], frames.shape[2]

    def read_into(self, out):
        out[...] = self.frames[self.pos]
        self.pos += 1
        return True


class _Writer:
    def __init__(self):
        self.clips, self.waited = [], False

    def write_clip(self, begin, frames):
        self.clips.append((begin, np.stack(frames)))

    def wait(self):
        self.waited = True


@pytest.mark.parametrize("discard_first", [0, 3])
def test_process_segment_matches_sequential_steps(pipe, frames, discard_first):
    """10 frames at batch 4: the short last batch is padded, clips follow
    Max_Frame_Count, the output equals plain step() calls, and the
    discarded leading frames only advance the state."""
    n = 10
    writer = _Writer()
    written = process_segment(pipe, _Reader(frames[:n]), writer,
                              discard_first, n, max_frame_count=3,
                              batch_size=BATCH, discard_first=discard_first)
    assert written == n - discard_first and writer.waited
    assert [b for b, _ in writer.clips] == list(range(discard_first, n, 3))
    got = np.concatenate([c for _, c in writer.clips])
    st, want = pipe.initial_state(), []
    for lo in range(0, n, BATCH):
        batch = frames[lo:min(lo + BATCH, n)]
        pad = np.repeat(batch[-1:], BATCH - len(batch), axis=0)
        sbs, st = pipe.step(np.concatenate([batch, pad]), st)
        want.append(sbs.numpy()[:len(batch)])
    np.testing.assert_array_equal(got, np.concatenate(want)[discard_first:])


def test_cli_drive_recipe_on_cpu(tmp_path):
    """The verify recipe through the port's CLI: 14 frames of 64x48 ->
    three subclips and a 128x48 SBS output."""
    cv2 = pytest.importorskip("cv2")
    from vr_video_generator_tpu_torch.cli import main

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(7)
    for i in range(14):
        f = np.full((48, 64, 3), i * 9 % 256, np.uint8)
        f[:, :20] = rng.integers(0, 255, 3, dtype=np.uint8)
        w.write(f[:, :, ::-1])
    w.release()
    out = str(tmp_path / "out.mkv")
    assert main(["--device", "cpu", "--mlp_fused", "xla", "--tail", "xla",
                 "--VideoDir", src, "--OutputDir", out,
                 "--DebugDir", str(tmp_path / "Debug") + "/",
                 "--SubClipDir", str(tmp_path / "Subclip") + "/",
                 "--Max_Frame_Count", "6", "--batch_size", "4",
                 "--input_size", "56", "--compute_dtype", "float32",
                 "--allow_random_weights"]) == 0
    assert sorted(os.listdir(tmp_path / "Subclip")) == ["0_5.mp4", "12_13.mp4",
                                                        "6_11.mp4"]
    assert os.path.exists(tmp_path / "Debug" / "segment_0.txt")
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 14
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (48, 128, 3)


def test_packed_sbs_output_runs_on_cpu(tmp_path):
    """--sbs_output packed --warp_impl pallas through the port's CLI on the
    CPU (the kernels' plain versions): the same subclips and output as the
    u8 recipe; with --warp_impl xla it raises the JAX package's
    ValueError."""
    cv2 = pytest.importorskip("cv2")
    from vr_video_generator_tpu_torch.cli import main

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(7)
    for _ in range(10):
        w.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    w.release()

    def run(tag, impl):
        return main(["--device", "cpu", "--sbs_output", "packed",
                     "--warp_impl", impl, "--VideoDir", src,
                     "--OutputDir", str(tmp_path / f"{tag}.mkv"),
                     "--DebugDir", str(tmp_path / f"D{tag}") + "/",
                     "--SubClipDir", str(tmp_path / f"S{tag}") + "/",
                     "--Max_Frame_Count", "6", "--batch_size", "4",
                     "--input_size", "56", "--compute_dtype", "float32",
                     "--allow_random_weights"])

    assert run("packed", "pallas") == 0
    assert sorted(os.listdir(tmp_path / "Spacked")) == ["0_5.mp4", "6_9.mp4"]
    cap = cv2.VideoCapture(str(tmp_path / "packed.mkv"))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (48, 128, 3)
    with pytest.raises(ValueError, match="requires the pallas warp"):
        run("xla", "xla")


def test_range_with_warm_up_continues_the_full_run(pipe, tmp_path):
    """convert_range from frame 6 with a 6-frame halo warm-up writes the same
    SBS frames as a run from frame 0 (the primed state removes the segment
    reset); both encodes decode to equal frames."""
    import dataclasses

    cv2 = pytest.importorskip("cv2")
    from vr_video_generator_tpu_torch.runtime.orchestrator import convert_range

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    rng = np.random.default_rng(3)
    for _ in range(14):
        w.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    w.release()
    clips = {}
    for tag, begin in (("full", 0), ("range", 6)):
        cfg = dataclasses.replace(
            CFG, video_dir=src, max_frame_count=6, warmup_frames=6,
            subclip_dir=str(tmp_path / tag) + "/",
            debug_dir=str(tmp_path / f"debug_{tag}") + "/",
            writer_backend="cv2", reader_backend="cv2")
        assert convert_range(cfg, begin, 14, pipeline=pipe) == 14 - begin
        cap = cv2.VideoCapture(str(tmp_path / tag / "6_11.mp4"))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        clips[tag] = np.stack(frames)
    assert clips["full"].shape == (6, H, 2 * W, 3)
    np.testing.assert_array_equal(clips["range"], clips["full"])


def test_f32_on_the_card_raises_before_any_weight(monkeypatch):
    """compute_dtype float32 on a CUDA device raises in SbsPipeline.create,
    before load_model builds a weight, where the f32 plan needs a kernel
    the JAX package's kernels refuse too: a custom head of 40 features,
    whose DPT tail's JAX kernel asserts C2 % 8 == 0 (ValueError naming
    head_tail_pallas.py). A head of 16 features passes (its tails run
    zero-padded), bf16 on the card passes the check, and so does f32 on a
    plan whose kernels all have their f32 variants (CFG: xla/xla; vits
    fused, rows 8 and 7 at f32; vitg fused, row 10 and the big-C tail at
    f32)."""
    import dataclasses

    import vr_video_generator_tpu_torch.pipeline as pipeline

    def load_model(*args, **kwargs):
        raise AssertionError("load_model ran")

    monkeypatch.setattr(pipeline, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(pipeline, "load_model", load_model)
    vitg = dataclasses.replace(CFG, encoder="vitg", mlp_fused="fused",
                               tail="fused")
    for ok in (CFG, dataclasses.replace(CFG, compute_dtype="bfloat16"),
               dataclasses.replace(CFG, mlp_fused="fused", tail="fused"),
               vitg):
        with pytest.raises(AssertionError, match="load_model ran"):
            SbsPipeline.create(ok, H, W, allow_random=True, device="cuda")
    model = RunConfig.model
    monkeypatch.setattr(RunConfig, "model", lambda self: dataclasses.replace(
        model(self), features=16))  # CFG's class: a custom head
    # At 1080p and --input_size 126 the JAX planners pick a fused tail.
    narrow = dataclasses.replace(vitg, input_size=126)
    with pytest.raises(AssertionError, match="load_model ran"):
        SbsPipeline.create(narrow, 1080, 1920, allow_random=True,
                           device="cuda")
    monkeypatch.setattr(RunConfig, "model", lambda self: dataclasses.replace(
        model(self), features=40))
    with pytest.raises(ValueError, match="head_tail_pallas.py"):
        SbsPipeline.create(narrow, 1080, 1920, allow_random=True,
                           device="cuda")
    with pytest.raises(ValueError, match="head_tail_pallas.py"):
        SbsPipeline.create(dataclasses.replace(narrow,
                                               compute_dtype="bfloat16"),
                           1080, 1920, allow_random=True, dtype=torch.float32)
    with pytest.raises(AssertionError, match="load_model ran"):
        SbsPipeline.create(dataclasses.replace(narrow,
                                               compute_dtype="bfloat16"),
                           1080, 1920, allow_random=True, device="cuda")


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the refusal is for machines "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SbsPipeline.create(CFG, H, W, allow_random=True, device="cuda")


@pytest.mark.parametrize("field,value,item", [
    ("depth_stride", 2, "depth_stride"), ("chunk_batches", 2, "step_many"),
    ("gelu", "tanh", "UI impl switches"),
])
def test_unported_run_options_raise(field, value, item, pipe, frames,
                                    weights):
    """Every option here is ported now. The tanh GELU passes the check, and
    a pipeline built with it (ModelConfig.gelu_approx) runs one step: the
    right half the input, the left half other than the exact GELU's.
    chunk_batches > 1 (step_many) passes the check, and a pipeline built
    with it runs a chunk of two batches as two steps do. depth_stride 2
    passes the check (it divides the batch of 4), 3 raises the JAX
    package's ValueError, and a stride-2 pipeline's two batches of 2 equal
    one batch of 4."""
    import dataclasses

    cfg = dataclasses.replace(CFG, **{field: value})
    if field == "gelu":
        check_supported(cfg)
        tanh = SbsPipeline(build_model(dataclasses.replace(
            TINY, gelu_approx=True), weights, torch.float32, "cpu"), H, W,
            run_cfg=cfg)
        assert tanh.model.pretrained.blocks[0].mlp.gelu_approx
        sbs, _ = tanh.step(frames[:BATCH], tanh.initial_state())
        exact, _ = pipe.step(frames[:BATCH], pipe.initial_state())
        np.testing.assert_array_equal(sbs.numpy()[:, :, W:], frames[:BATCH])
        assert not torch.equal(sbs, exact)
        return
    if item == "depth_stride":
        check_supported(cfg)
        with pytest.raises(ValueError, match="must divide batch_size"):
            check_supported(dataclasses.replace(cfg, depth_stride=3))
        strided = SbsPipeline(pipe.model, H, W, run_cfg=cfg)
        whole, _ = strided.step(frames[:BATCH], strided.initial_state())
        a, st = strided.step(frames[:2], strided.initial_state())
        b, _ = strided.step(frames[2:BATCH], st)
        np.testing.assert_array_equal(whole.numpy(), torch.cat([a, b]).numpy())
        return
    check_supported(cfg)
    chunked = SbsPipeline(pipe.model, H, W, run_cfg=cfg)
    two = frames[:2 * BATCH].reshape(2, BATCH, H, W, 3)
    outs, _ = chunked.step_many(two, chunked.initial_state())
    st, want = pipe.initial_state(), []
    for batch in two:
        sbs, st = pipe.step(batch, st)
        want.append(sbs.numpy())
    np.testing.assert_array_equal(np.stack([o.numpy() for o in outs]),
                                  np.stack(want))


@pytest.mark.parametrize("overrides,kernel", [
    pytest.param(dict(encoder="vitl", tail="fused"), "head_tail_ext",
                 id=r"overrides0-big-C DPT tail kernels \(rows 11, 12\)"),
    pytest.param(dict(encoder="vitg", mlp_fused="fused"), "swiglu_residual",
                 id=r"overrides1-hidden-blocked MLP kernel \(row 9\)"),
])
def test_unported_fused_combinations_raise(overrides, kernel):
    """Every encoder runs fused now, and the two combinations that raised
    here run on the card: vitl's ext tail at C=256 (the JAX planners pick
    it at small inputs) and vitg's fused MLP half (the SwiGLU kernel). A
    fused MLP half at D = 512, no published encoder's width, fuses too:
    every D % 128 == 0 has its kernels."""
    import dataclasses

    from vr_video_generator_tpu_torch.models.dinov2 import \
        resolve_block_fusion
    from vr_video_generator_tpu_torch.models.dpt import resolve_tail
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    for encoder in ("vits", "vitb", "vitl", "vitg"):
        check_supported(dataclasses.replace(CFG, encoder=encoder,
                                            mlp_fused="fused", tail="fused"))
    cfg = dataclasses.replace(CFG, **overrides)
    check_supported(cfg)
    m = cfg.model()
    if kernel == "head_tail_ext":
        # refinenet1's grid at 1080p with --input_size 56: the ext tail
        assert resolve_tail(cfg.tail, (1, 16, 28, m.features), torch.bfloat16,
                            (56, 98), "cuda") == "ext"
        assert ht.takes(m.features)
    else:
        assert resolve_block_fusion(cfg.mlp_fused, m.embed_dim, m.num_heads,
                                    2443, "cuda", torch.bfloat16,
                                    m.ffn_layer) == (False, True)
    assert resolve_block_fusion("fused", 512, 8, 41, "cpu", torch.float32,
                                m.ffn_layer) == (True, True)


@pytest.mark.parametrize("argv,item", [
    (["--mesh", "2x1"], "multi-GPU"),
    (["--profile_dir", "trace"], "profiling"),
    (["--repair_mode", "1"], "repair modes 1 and 3"),
    (["--repair_mode", "3"], "repair modes 1 and 3"),
])
def test_unported_cli_options_raise(argv, item, tmp_path):
    """Every option here is ported now. --mesh 2x1 with --device cpu
    converts through the sharded runtime, one segment per CPU slot, into
    contiguous subclips and its log. --profile_dir: a conversion with it
    writes its torch.profiler trace into the directory. Repair modes 1 and
    3: mode 1 converts into the subclip dir, keeps the debug dir and
    combines nothing; mode 3, after it, clears the debug dir and combines
    the subclips, video only."""
    from vr_video_generator_tpu_torch.cli import main

    dirs = ["--DebugDir", str(tmp_path / "D") + "/",
            "--SubClipDir", str(tmp_path / "S") + "/"]
    cv2 = pytest.importorskip("cv2")
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for i in range(5):
        w.write(np.full((48, 64, 3), 40 * i, np.uint8))
    w.release()
    run = ["--device", "cpu", *dirs, "--VideoDir", src,
           "--OutputDir", str(tmp_path / "o.mkv"), "--batch_size", "4",
           "--input_size", "56", "--compute_dtype", "float32",
           "--mlp_fused", "xla", "--tail", "xla", "--allow_random_weights"]
    if item == "multi-GPU":
        assert main([*run, *argv, "--Max_Frame_Count", "2"]) == 0
        assert sorted(os.listdir(tmp_path / "S")) == ["0_1.mp4", "2_2.mp4",
                                                      "3_4.mp4"]
        assert os.listdir(tmp_path / "D") == ["sharded_p0.txt"]
        cap = cv2.VideoCapture(str(tmp_path / "o.mkv"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
        cap.release()
        return
    if item == "profiling":
        trace_dir = tmp_path / argv[1]
        assert main([*run, "--profile_dir", str(trace_dir)]) == 0
        assert [f.endswith(".json") for f in os.listdir(trace_dir)] == [True]
        return
    os.makedirs(tmp_path / "D")
    (tmp_path / "D" / "earlier.txt").write_text("kept by mode 1")
    assert main([*run, "--repair_mode", "1"]) == 0
    assert sorted(os.listdir(tmp_path / "S")) == ["0_4.mp4"]
    assert (tmp_path / "D" / "earlier.txt").exists()
    assert not (tmp_path / "o.mkv").exists()
    if argv[1] == "3":
        assert main([*run, "--repair_mode", "3"]) == 0
        assert not (tmp_path / "D" / "earlier.txt").exists()
        cap = cv2.VideoCapture(str(tmp_path / "o.mkv"))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 5
        cap.release()


def test_unported_entry_points_raise(pipe, frames):
    from vr_video_generator_tpu_torch.models.dinov2 import \
        DinoVisionTransformer
    from vr_video_generator_tpu_torch.ops.preprocess import preprocess_frames

    # step_many is ported: one whole batch as a chunk of one is one step.
    (sbs,), st = pipe.step_many(frames[None, :BATCH], pipe.initial_state())
    want, want_st = pipe.step(frames[:BATCH], pipe.initial_state())
    np.testing.assert_array_equal(sbs.numpy(), want.numpy())
    np.testing.assert_array_equal(st.d_prev1.numpy(), want_st.d_prev1.numpy())
    # the folded preprocess is ported; an unknown path still raises
    assert preprocess_frames(torch.zeros(1, H, W, 3, dtype=torch.uint8),
                             (56, 70), impl="folded").shape == (1, 56, 70, 3)
    with pytest.raises(ValueError, match="'exact' or 'folded'"):
        preprocess_frames(torch.zeros(1, H, W, 3, dtype=torch.uint8),
                          (56, 70), impl="banded")
    # vitg builds now (on the meta device: no storage for its 1.1 B
    # encoder parameters), with its SwiGLU blocks.
    with torch.device("meta"):
        vitg = DinoVisionTransformer(ModelConfig.for_encoder("vitg"))
    assert vitg.blocks[39].mlp.w12.weight.shape == (8192, 1536)


def test_port_imports_no_jax():
    """Importing the port's entry points and loading chip_smoke.py pulls in
    neither JAX, flax, cv2, tkinter, the root bench.py nor any module of
    the JAX package."""
    code = ("import sys, importlib.util; import vr_video_generator_tpu_torch.cli, "
            "vr_video_generator_tpu_torch.pipeline, "
            "vr_video_generator_tpu_torch.runtime.segment, "
            "vr_video_generator_tpu_torch.runtime.orchestrator, "
            "vr_video_generator_tpu_torch.runtime.sharded_runner, "
            "vr_video_generator_tpu_torch.parallel.sharded, "
            "vr_video_generator_tpu_torch.models.checkpoint, "
            "vr_video_generator_tpu_torch.stage_bench, "
            "vr_video_generator_tpu_torch.attention_bench, "
            "vr_video_generator_tpu_torch.bench, "
            "vr_video_generator_tpu_torch.checktool, "
            "vr_video_generator_tpu_torch.stride_study, "
            "vr_video_generator_tpu_torch.perf_compare, "
            "vr_video_generator_tpu_torch.flops, "
            "vr_video_generator_tpu_torch.host_io_bench, "
            "vr_video_generator_tpu_torch.soak_gen, "
            "vr_video_generator_tpu_torch.soak, "
            "vr_video_generator_tpu_torch.parity_report, "
            "vr_video_generator_tpu_torch.real_weights_runbook, "
            "vr_video_generator_tpu_torch.ui.app, "
            "vr_video_generator_tpu_torch.ui.tkapp, "
            "vr_video_generator_tpu_torch.ui.pathpick, "
            "vr_video_generator_tpu_torch.utils.profiling, "
            "vr_video_generator_tpu_torch.utils.benchlib; "
            "spec = importlib.util.spec_from_file_location('chip_smoke', "
            "'chip_smoke.py'); spec.loader.exec_module("
            "importlib.util.module_from_spec(spec)); "
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'cv2', "
            "'tkinter', 'vr_video_generator_tpu', 'bench') "
            "or m.startswith('vr_video_generator_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_import_no_jax_package():
    """An ast scan: no module of the port, and not chip_smoke.py, names the
    JAX package, JAX, flax or the root bench.py in an import."""
    import ast
    import pathlib

    files = sorted(pathlib.Path(REPO, "vr_video_generator_tpu_torch").rglob(
        "*.py")) + [pathlib.Path(REPO, "chip_smoke.py")]
    assert len(files) > 20
    banned = ("vr_video_generator_tpu", "jax", "flax", "bench")
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in banned]
    assert not found, found
