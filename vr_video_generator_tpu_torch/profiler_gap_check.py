"""Whether a second torch.profiler session in one process still records
the card's kernels after an idle gap.

    python3 -m vr_video_generator_tpu_torch.profiler_gap_check [--gap S]

Runs a product under ``torch.profiler`` (CUDA activity), waits ``S``
seconds (default 0), then runs it again under ``utils.profiling.trace``
(as ``--profile_dir`` does) and prints, as one JSON line, the card, the
gap and the kernel events of each session. The second count is 0 where
the profiler stops recording device activity after the gap.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gap", type=float, default=0.0,
                    help="seconds between the two sessions")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_gap_check: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from vr_video_generator_tpu_torch.stage_bench import card_line
    from vr_video_generator_tpu_torch.utils.profiling import trace

    a = torch.randn(256, 256, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        (a @ a).sum()
        torch.cuda.synchronize()
    first = sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    time.sleep(opts.gap)
    with tempfile.TemporaryDirectory() as d:
        with trace(d, "t.json"):
            (a @ a).sum()
            torch.cuda.synchronize()
        with open(os.path.join(d, "t.json"), encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    second = sum(1 for e in events if e.get("cat") == "kernel")
    print(json.dumps(dict(card=card_line(), torch=torch.__version__,
                          gap_s=opts.gap, first_kernels=first,
                          second_kernels=second)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
