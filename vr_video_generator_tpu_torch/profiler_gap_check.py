"""Whether a later torch.profiler session records the card's kernels after
an idle gap, taken as the port takes it.

    python3 -m vr_video_generator_tpu_torch.profiler_gap_check [--gap S]

Runs a product under ``torch.profiler`` (CUDA activity), waits ``S``
seconds (default 0), then profiles it again twice: in this process under
``utils.profiling.trace`` (as ``--profile_dir`` does), which writes its
trace or, where the session lost the device's events (ROADMAP fault 5),
raises and writes nothing; and in a fresh process
(``utils.profiling.in_fresh_process``), as the port's benches take each
profile after their first. Prints, as one JSON line, the card, the gap,
the kernel events of the first session, the later in-process session's
(or the reason ``trace`` refused it) and the fresh process's. Exits 0 when
the fresh process recorded as many kernels as the first session and no
trace was written with fewer.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch


def product_kernels(traced: bool = True) -> int:
    """The kernel events of one profile of the product: ``trace``'s Chrome
    trace, or with ``traced`` False a bare CUDA-activity session's."""
    from torch.profiler import ProfilerActivity, profile

    from vr_video_generator_tpu_torch.utils.profiling import trace

    a = torch.randn(256, 256, device="cuda")
    (a @ a).sum()
    torch.cuda.synchronize()
    if not traced:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (a @ a).sum()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type.name == "CUDA")
    with tempfile.TemporaryDirectory() as d:
        with trace(d, "t.json"):
            (a @ a).sum()
        with open(os.path.join(d, "t.json"), encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gap", type=float, default=0.0,
                    help="seconds between the first session and the later ones")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_gap_check: no CUDA device", file=sys.stderr)
        return 2
    from vr_video_generator_tpu_torch.stage_bench import card_line
    from vr_video_generator_tpu_torch.utils.profiling import in_fresh_process

    first = product_kernels(traced=False)
    time.sleep(opts.gap)
    try:
        later = product_kernels()
    except RuntimeError as e:
        later = f"refused: {e}"
    fresh = in_fresh_process(product_kernels)
    print(json.dumps(dict(card=card_line(), torch=torch.__version__,
                          gap_s=opts.gap, first_kernels=first,
                          later_in_process=later,
                          fresh_process_kernels=fresh)))
    silent = isinstance(later, int) and later < first
    return 0 if 0 < first <= fresh and not silent else 1


if __name__ == "__main__":
    sys.exit(main())
