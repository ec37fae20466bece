"""PyTorch port: multi-host runs on the CPU. Two real processes join a gloo
group at a local rendezvous, each putting 4 CPU devices into the global
mesh; each decodes, steps and encodes only its own ``data`` slots, at
depth_stride 2 with the stride audit (the counterpart of
tests/test_multihost.py, at an 8-slot mesh and at a mesh of 2-rank model
groups). The parent checks that the subclips cover the video once and
check clean, and that each process logged only its own slots' audits.
Also the bootstrap's single-process behaviour and the CLI's flags."""

import os
import socket
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from vr_video_generator_tpu_torch.parallel import multihost
from vr_video_generator_tpu_torch.video.check import check_subclips

torch.set_num_threads(2)

_WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_video(path, n=24, h=48, w=64):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    rng = np.random.default_rng(3)
    for i in range(n):
        f = np.full((h, w, 3), (i * 11) % 256, np.uint8)
        f[:, : w // 3] = rng.integers(0, 255, 3, dtype=np.uint8)
        vw.write(f)
    vw.release()


# 24 frames at stride 2: partition_segments rounds the step to the stride
# grid. 8 slots: step 4, slots 0-5 own [0, 4) .. [20, 24) (2 full audited
# steps each), slots 6-7 are empty (never logged); process 0 owns slots
# 0-3, process 1 slots 4-7. 4 slots of 2-rank groups: step 6, 3 audited
# steps a slot; process 0 owns slots 0-1, process 1 slots 2-3.
AUDITS = {"8x1": ([0, 0, 1, 1, 2, 2, 3, 3], [4, 4, 5, 5]),
          "4x2": ([0, 0, 0, 1, 1, 1], [2, 2, 2, 3, 3, 3])}


@pytest.mark.parametrize("mesh", sorted(AUDITS))
def test_two_process_sharded_conversion(tmp_path, mesh):
    _write_video(str(tmp_path / "in.mp4"))
    os.makedirs(tmp_path / "Subclip", exist_ok=True)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(_WORKER))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "2"
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(port), str(pid), "2", str(tmp_path),
         mesh], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    sub = str(tmp_path / "Subclip")
    assert check_subclips(sub, remove_bad=False) == []
    covered = []
    for name in os.listdir(sub):
        lo, hi = os.path.splitext(name)[0].split("_")
        covered += range(int(lo), int(hi) + 1)
    assert sorted(covered) == list(range(24))

    for pid, expect in enumerate(AUDITS[mesh]):
        text = (tmp_path / f"mh_{pid}.txt").read_text()
        lines = [ln for ln in text.splitlines() if "stride audit" in ln]
        got = sorted(int(ln.split("slot ")[1].split()[0]) for ln in lines)
        assert got == expect, text[-1500:]


def test_initialize_is_a_noop_on_one_host():
    multihost.initialize()
    multihost.initialize(None, 1, None)
    multihost.initialize(None, 1, 0)
    assert not torch.distributed.is_initialized()
    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    multihost.barrier()


@pytest.mark.parametrize("args", [("127.0.0.1:1", None, None),
                                  ("127.0.0.1:1", 2, None),
                                  (None, 2, 0)])
def test_initialize_needs_address_count_and_id(args):
    with pytest.raises(ValueError, match="coordinator_address"):
        multihost.initialize(*args)
    assert not torch.distributed.is_initialized()


def test_global_mesh_on_one_process():
    """Without a process group the global mesh is this process's devices,
    every slot owned here."""
    mesh = multihost.make_global_mesh((2, 2), local=["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.processes == [[0, 0], [0, 0]]
    assert multihost.local_data_slots(mesh) == [0, 1]
    with pytest.raises(ValueError, match="!= 4 devices"):
        multihost.make_global_mesh((4, 2), local=["cpu"] * 4)


def test_cli_with_a_coordinator_runs_a_group_of_one(tmp_path):
    """The three multi-host flags at one process: ``cli.main`` joins a gloo
    group of one, converts with --mesh 2x1, logs to ``sharded_p0.txt`` and
    leaves the group."""
    from tests.test_video import write_synthetic_video
    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips

    path = str(tmp_path / "in.mp4")
    write_synthetic_video(path, 6)
    sub = str(tmp_path / "S") + "/"
    assert cli.main(["--device", "cpu", "--VideoDir", path,
                     "--OutputDir", str(tmp_path / "o.mkv"),
                     "--DebugDir", str(tmp_path / "D") + "/",
                     "--SubClipDir", sub, "--batch_size", "2",
                     "--input_size", "56", "--compute_dtype", "float32",
                     "--Max_Frame_Count", "3", "--mlp_fused", "xla",
                     "--tail", "xla", "--allow_random_weights",
                     "--writer_backend", "cv2", "--repair_mode", "1",
                     "--mesh", "2x1",
                     "--coordinator_address", f"127.0.0.1:{_free_port()}",
                     "--num_processes", "1", "--process_id", "0"]) == 0
    assert not torch.distributed.is_initialized()
    assert sorted_subclips(sub) == ["0_2.mp4", "3_5.mp4"]
    assert check_subclips(sub) == []
    assert os.listdir(tmp_path / "D") == ["sharded_p0.txt"]
