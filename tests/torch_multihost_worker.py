"""Worker process of tests/test_torch_multihost.py (the port only: it
imports nothing of JAX).

Each process joins a gloo group at a local rendezvous, puts its share of
CPU devices into the global mesh, and converts only its own ``data`` slots'
segments of the video through ``run_sharded`` at depth_stride 2 with the
stride audit on every step:

    python torch_multihost_worker.py PORT PID NPROC TMPDIR DxM
"""

import os
import sys


def main() -> int:
    port, pid, nproc, tmpdir, mesh_arg = sys.argv[1:6]
    import torch

    torch.set_num_threads(2)
    from vr_video_generator_tpu_torch import RunConfig
    from vr_video_generator_tpu_torch.models.factory import load_model
    from vr_video_generator_tpu_torch.parallel.multihost import (
        initialize, make_global_mesh, process_count, shutdown)
    from vr_video_generator_tpu_torch.parallel.sharded import \
        ShardedSbsPipeline
    from vr_video_generator_tpu_torch.runtime.sharded_runner import \
        run_sharded
    from vr_video_generator_tpu_torch.utils.logging import WorkerLog

    initialize(f"127.0.0.1:{port}", int(nproc), int(pid))
    try:
        assert process_count() == int(nproc)
        d, m = (int(v) for v in mesh_arg.split("x"))
        mesh = make_global_mesh((d, m), local=["cpu"] * (d * m // int(nproc)))
        cfg = RunConfig(batch_size=2, input_size=42, compute_dtype="float32",
                        warp_impl="xla", encoder="vits", depth_stride=2,
                        stride_audit_every=1)
        model = load_model("vits", dtype=torch.float32, device="cpu",
                           allow_random=True, cfg=cfg.model())
        pipe = ShardedSbsPipeline(model, 48, 64, mesh, run_cfg=cfg)
        owned = pipe.local_slots
        assert 0 < len(owned) < d, owned  # each process owns a strict subset
        done = run_sharded(pipe, os.path.join(tmpdir, "in.mp4"),
                           os.path.join(tmpdir, "Subclip/"), 0, 24,
                           max_frame_count=3, batch_size=2,
                           writer_backend="cv2",
                           log=WorkerLog(os.path.join(tmpdir,
                                                      f"mh_{pid}.txt")))
        print(f"proc {pid}: slots {owned} frames {done}", flush=True)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
