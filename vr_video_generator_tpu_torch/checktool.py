"""Subclip integrity checker and repairer as a package entry point.

The port's counterpart of vr_video_generator_tpu/checktool.py, with the
same flags plus ``--device`` (default ``cuda``): ``--repair_mode 0`` only
reports issues; any other value removes the bad clips and converts their
exact frame ranges again, taking the run-config flags for that conversion
(encoder, offsets, batch, ...) through ``cli.parse_run_config``.

Usage:  python -m vr_video_generator_tpu_torch.checktool --SubClipDir Subclip/ \
            [--repair_mode 1 --VideoDir in.mp4 ... --device cuda]
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="vr_video_generator_tpu_torch.checktool")
    parser.add_argument("--SubClipDir", type=str, required=True)
    parser.add_argument("--repair_mode", type=int, default=0)
    parser.add_argument("--DebugDir", type=str, default="",
                        help="also report the run's depth-overflow records "
                             "(OVERFLOW.jsonl) from this debug dir")
    args, rest = parser.parse_known_args(argv)

    from vr_video_generator_tpu_torch.video.check import check_subclips

    def report_overflow() -> None:
        if not args.DebugDir:
            return
        from vr_video_generator_tpu_torch.utils.logging import (
            overflow_message, overflow_path, summarize_overflow)

        total, _ = summarize_overflow(overflow_path(args.DebugDir))
        if total:
            print(overflow_message(total))

    if args.repair_mode == 0:
        issues = check_subclips(args.SubClipDir)
        for issue in issues:
            print(f"{issue.kind} issue on {issue.filename}: "
                  f"repair range {issue.repair_range}")
        if not issues:
            print(f"OK: no issues in {args.SubClipDir}")
        report_overflow()
        return 0

    from vr_video_generator_tpu_torch.cli import parse_run_config
    from vr_video_generator_tpu_torch.runtime.orchestrator import \
        check_and_repair

    # --DebugDir was consumed above; hand it back to the run config so the
    # repaired segments log (and record overflow) in that dir.
    debug = ["--DebugDir", args.DebugDir] if args.DebugDir else []
    cfg, cli_args = parse_run_config(
        rest + debug + ["--SubClipDir", args.SubClipDir,
                        "--repair_mode", "1"])
    issues = check_and_repair(cfg, repair=True,
                              allow_random=cli_args.allow_random_weights,
                              device=cli_args.device)
    print(f"repaired {len(issues)} issue(s)")
    if not issues:
        report_overflow()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
