"""PyTorch port: the port's benchmark (vr_video_generator_tpu_torch.bench)
and utils/benchlib.py on the CPU."""

import json

import numpy as np
import pytest
import torch

import bench as root_bench
from vr_video_generator_tpu_torch import bench
from vr_video_generator_tpu_torch.utils.benchlib import (checksum,
                                                         device_time, poison)

torch.set_num_threads(2)

KEYS = {"metric", "value", "unit", "vs_baseline", "host_fps",
        "chunk_batches", "card"}


def test_configs_equal_the_root_bench():
    """The port's own copy of the root bench.py's table and baseline."""
    assert bench.CONFIGS == root_bench.CONFIGS
    assert bench.BASELINE_FPS == root_bench.BASELINE_FPS


@pytest.mark.parametrize("chunk", [1, 2])
def test_bench_cpu_prints_one_json_line(chunk, capsys):
    """--device cpu at the smoke geometry, cut to two chained steps, one
    repeat and two batches: one JSON line with the keys the records read,
    the metric named by height and encoder, both rates positive, no card."""
    assert bench.main(["--device", "cpu", "--chunk_batches", str(chunk),
                       "--steps", "2", "--reps", "1",
                       "--segment_batches", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert KEYS <= set(line)
    assert line["metric"] == "torch_sbs_fps_270p_vits"
    assert line["unit"] == "frames/s" and line["chunk_batches"] == chunk
    assert line["card"] is None and line["device"] == "cpu"
    assert line["value"] > 0 and line["host_fps"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 12.0)
    assert line["steps"] == 2 and line["host_frames"] == 4


def test_bench_on_a_missing_card_fails():
    """The default device is the card; without one the bench raises rather
    than measuring the CPU under the card's metric."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present; the refusal is for machines "
                    "without one")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        bench.run_config(2, steps=1, reps=1, segment_batches=1)


def test_device_time_chains_k_calls():
    """One untimed call, then reps chains of k calls; each call after the
    first of a chain takes the poisoned (unchanged) inputs; per call is the
    best chain over k."""
    seen = []

    def fn(x, y):
        seen.append((x.clone(), y))
        return x * 2, {"s": x.sum()}

    x = torch.arange(6, dtype=torch.float32)
    per_call, total = device_time(fn, x, "not a tensor", k=4, reps=3)
    assert len(seen) == 1 + 4 * 3
    assert all(torch.equal(a, x) and b == "not a tensor" for a, b in seen)
    assert total > 0 and per_call == pytest.approx(total / 4)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.bool,
                                   torch.float32, torch.bfloat16])
def test_poison_and_checksum(dtype):
    """poison is the identity for the dtypes a step carries; checksum sums
    every tensor of a nested tree in f32."""
    x = torch.from_numpy(np.arange(12, dtype=np.int32) % 3).to(dtype)
    y = poison(x, torch.tensor(5.0))
    assert y.dtype == x.dtype and torch.equal(y, x)
    want = float(np.sum(np.arange(12) % 3 if dtype != torch.bool
                        else (np.arange(12) % 3) > 0))
    assert float(checksum([x, (x,), {"a": x}])) == 3 * want
