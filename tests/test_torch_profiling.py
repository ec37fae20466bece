"""PyTorch port: utils/profiling.py (StageTimer, trace) against the JAX
package's, trace's refusal of a profile that lost the device's events and
the fresh-process helper, and --profile_dir and --chunk_batches through the
port's CLI on the CPU."""

import csv
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vr_video_generator_tpu.utils.profiling import StageTimer as JaxStageTimer
from vr_video_generator_tpu_torch.utils import profiling
from vr_video_generator_tpu_torch.utils.profiling import StageTimer, trace

torch.set_num_threads(2)

STAGES = {"decode_wait": (0.25, 3), "device_dispatch": (1.5, 7),
          "device_readback": (0.0125, 7), "encode": (2.0, 1)}


def _filled(cls):
    timer = cls()
    for name, (total, hits) in STAGES.items():
        timer.totals[name] = total
        timer.hits[name] = hits
    return timer


def test_stage_timer_csv_equals_jax(tmp_path):
    """The same stages dump the same CSV (header, rows, formats), appended
    across two dumps with one header, as the JAX StageTimer's."""
    paths = {}
    for tag, cls in (("jax", JaxStageTimer), ("torch", StageTimer)):
        paths[tag] = str(tmp_path / tag / "segment_0_profile.csv")
        for _ in range(2):
            _filled(cls).dump_csv(paths[tag])
    with open(paths["jax"], encoding="utf-8") as f:
        want = f.read()
    with open(paths["torch"], encoding="utf-8") as f:
        got = f.read()
    assert got == want
    rows = list(csv.reader(got.splitlines()))
    assert rows[0] == ["Function", "Line #", "Line Content", "Hits",
                       "Total Time (µs)", "Per Hit (µs)"]
    assert rows[1] == ["decode_wait", "0", "", "3", "250000", "83333.33"]
    assert len(rows) == 1 + 2 * len(STAGES)


def test_stage_timer_times_stages_and_is_reexported():
    """stage() adds wall time and a hit per use, also when its body raises;
    runtime.segment re-exports the same class."""
    from vr_video_generator_tpu_torch.runtime import segment

    assert segment.StageTimer is StageTimer
    timer = StageTimer()
    with timer.stage("a"):
        pass
    with pytest.raises(KeyError):
        with timer.stage("a"):
            raise KeyError("x")
    assert timer.hits["a"] == 2 and timer.totals["a"] >= 0.0


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_off_is_a_no_op(log_dir, tmp_path, monkeypatch):
    """A falsy log_dir yields None, starts no profiler and writes nothing."""
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError("profiler started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    with trace(log_dir) as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """trace(dir) profiles the block (CPU activity here) and writes one
    Chrome trace into a directory it makes; the ops of the block are in
    it. A name puts the file where the caller wants it."""
    out = tmp_path / "new" / "dir"
    a = torch.randn(64, 64)
    with trace(str(out)) as prof:
        (a @ a).sum()
    assert prof is not None
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(out / files[0], encoding="utf-8") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names
    with trace(str(out), "mine.json"):
        a.sum()
    assert sorted(os.listdir(out)) == sorted(files + ["mine.json"])


def test_trace_writes_nothing_when_the_block_fails(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with trace(str(tmp_path / "t")):
            raise RuntimeError("boom")
    assert not os.path.exists(tmp_path / "t")


def _events(*pairs):
    """Profiler events: (name, on the device) pairs."""
    return [SimpleNamespace(name=n, device_type=SimpleNamespace(
        name="CUDA" if dev else "CPU")) for n, dev in pairs]


LAUNCH, KERNEL = ("cudaLaunchKernel", False), ("kernel_a", True)


@pytest.mark.parametrize("events,lost", [
    ([LAUNCH] * 3 + [KERNEL] * 3, False),
    ([LAUNCH] * 3, True),
    ([LAUNCH] * 3 + [KERNEL], True),
    ([LAUNCH] * 2 + [("Memcpy HtoD", True)] * 2, True),
    ([("cudaGraphLaunch", False)], True),
    ([("cudaGraphLaunch", False)] + [KERNEL] * 40, False),
    ([("cudaMemcpyAsync", False), ("Memcpy DtoH", True)], False),
    ([("aten::mm", False)], False)],
    ids=["all kept", "none kept", "one of three", "copies only",
         "graph, none kept", "graph kept", "copy kept", "no device work"])
def test_lost_device_events(events, lost):
    """A profile lost the device's events when device work was launched
    and none was recorded, or fewer kernels than the host launched one by
    one (a graph launch's kernels are not counted on the host)."""
    got = profiling.lost_device_events(_events(*events))
    assert (got is not None) == lost
    if lost:
        assert "fresh process" in got


class _FakeProfile:
    """torch.profiler.profile's stand-in: events of a session that lost the
    device's kernels."""

    def __init__(self, activities):
        self.activities = activities

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return _events(LAUNCH, LAUNCH)

    def export_chrome_trace(self, path):
        raise AssertionError("a trace that lost its device events written")


def test_trace_raises_and_writes_nothing_when_the_card_was_lost(
        tmp_path, monkeypatch):
    """With CUDA activity, a session whose device events are missing raises
    RuntimeError naming the cause and writes no trace; the device is
    synchronized before the session ends."""
    import torch.profiler

    synced = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: synced.append(1))
    with pytest.raises(RuntimeError, match="fault 5"):
        with trace(str(tmp_path / "t")) as prof:
            assert len(prof.activities) == 2
    assert synced and not os.path.exists(tmp_path / "t")


def _child_facts(x):
    return os.getpid(), x * 2, torch.get_num_threads() > 0


def _child_fails():
    raise ValueError("from the child")


def test_in_fresh_process_runs_the_function_in_a_child():
    """in_fresh_process runs a module-level function in a spawned child and
    hands back its result; the child's error is raised in the caller."""
    pid, doubled, ok = profiling.in_fresh_process(_child_facts, 21)
    assert pid != os.getpid() and doubled == 42 and ok
    with pytest.raises(ValueError, match="from the child"):
        profiling.in_fresh_process(_child_fails)


def _video(tmp_path, n=14):
    cv2 = pytest.importorskip("cv2")
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    rng = np.random.default_rng(7)
    for i in range(n):
        f = np.full((48, 64, 3), i * 9 % 256, np.uint8)
        f[:, :20] = rng.integers(0, 255, 3, dtype=np.uint8)
        w.write(f[:, :, ::-1])
    w.release()
    return src


def _cli(tmp_path, src, tag, *extra):
    from vr_video_generator_tpu_torch.cli import main

    return main(["--device", "cpu", "--mlp_fused", "xla", "--tail", "xla",
                 "--VideoDir", src, "--OutputDir", str(tmp_path / f"{tag}.mkv"),
                 "--DebugDir", str(tmp_path / f"D{tag}") + "/",
                 "--SubClipDir", str(tmp_path / f"S{tag}") + "/",
                 "--Max_Frame_Count", "6", "--batch_size", "4",
                 "--input_size", "56", "--compute_dtype", "float32",
                 "--allow_random_weights", *extra])


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """The verify recipe with --profile_dir: the conversion runs under a
    torch.profiler trace, which lands in the directory with the port's
    ops in it; the subclips and the output are those of the recipe."""
    src = _video(tmp_path)
    prof_dir = tmp_path / "trace"
    assert _cli(tmp_path, src, "p", "--profile_dir", str(prof_dir)) == 0
    assert sorted(os.listdir(tmp_path / "Sp")) == ["0_5.mp4", "12_13.mp4",
                                                   "6_11.mp4"]
    files = os.listdir(prof_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(prof_dir / files[0], encoding="utf-8") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_cli_chunk_batches_writes_the_same_subclips(tmp_path):
    """--chunk_batches 2 through the port's CLI: the same subclip files,
    decoded to the same frames, as --chunk_batches 1."""
    cv2 = pytest.importorskip("cv2")
    src = _video(tmp_path, n=18)
    for tag, chunk in (("one", "1"), ("two", "2")):
        assert _cli(tmp_path, src, tag, "--chunk_batches", chunk) == 0
    names = sorted(os.listdir(tmp_path / "Sone"))
    assert names == sorted(os.listdir(tmp_path / "Stwo")) == \
        ["0_5.mp4", "12_17.mp4", "6_11.mp4"]
    for name in names:
        decoded = []
        for tag in ("one", "two"):
            cap = cv2.VideoCapture(str(tmp_path / f"S{tag}" / name))
            frames = []
            while True:
                ok, f = cap.read()
                if not ok:
                    break
                frames.append(f)
            cap.release()
            decoded.append(np.stack(frames))
        np.testing.assert_array_equal(decoded[0], decoded[1])
