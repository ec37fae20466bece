"""Command-line interface of the PyTorch port.

The same flags as vr_video_generator_tpu.cli (its jax-free
``parse_run_config`` parses them: the 15 reference flags and the build
knobs), plus ``--device`` (default ``cuda``).

Usage:  python -m vr_video_generator_tpu_torch.cli --VideoDir in.mp4 \
            --OutputDir out.mkv [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from vr_video_generator_tpu_torch import not_ported


def main(argv: Optional[List[str]] = None) -> int:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", type=str, default="cuda",
                     help="torch device to run on: cuda or cpu")
    ours, rest = pre.parse_known_args(argv)
    from vr_video_generator_tpu.cli import parse_run_config

    cfg, args = parse_run_config(rest)
    if args.mesh or args.coordinator_address or args.num_processes > 1:
        not_ported("--mesh / multi-host runs", "sharded and multi-GPU runtime")
    if args.profile_dir:
        not_ported("--profile_dir", "bench, profiling and records")
    from vr_video_generator_tpu_torch.runtime.orchestrator import run

    run(cfg, allow_random=args.allow_random_weights, device=ours.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
