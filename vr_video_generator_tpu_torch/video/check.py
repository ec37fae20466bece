"""Subclip integrity checking and repair — parity with reference Check_Clips.py.

Every subclip's real frame count must match the count its ``{begin}_{end}``
name promises, and consecutive clips must be frame-contiguous (reference
Check_Clips.py:15-37). Issues are returned as structured records; repair
(regenerating exactly the broken ranges) is orchestrated by the runtime
(runtime/orchestrator.py), mirroring the reference's re-invocation with
--repair_mode 1.

The port's own copy of vr_video_generator_tpu/video/check.py, kept in step
with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Tuple

from vr_video_generator_tpu_torch.video.combine import sorted_subclips
from vr_video_generator_tpu_torch.video.reader import probe_video


@dataclasses.dataclass(frozen=True)
class ClipIssue:
    kind: str                 # 'length' | 'continuity'
    filename: str
    repair_range: Tuple[int, int]  # [start, end) frame range to regenerate


def parse_clip_name(name: str) -> Tuple[int, int]:
    stem = os.path.splitext(name)[0]
    begin, end_inclusive = stem.split("_")
    return int(begin), int(end_inclusive)


def check_subclips(subclip_dir: str, remove_bad: bool = False) -> List[ClipIssue]:
    """Scan sorted subclips for length and continuity issues
    (reference Check_Clips.py:19-37)."""
    issues: List[ClipIssue] = []
    prev_name = None
    prev_end = None  # end-inclusive frame of the last clip kept so far
    for name in sorted_subclips(subclip_dir):
        begin, end_inclusive = parse_clip_name(name)
        path = os.path.join(subclip_dir, name)
        # The writer's names are end-INCLUSIVE (video/writer.py), so the
        # only contiguous layout is begin == prev_end + 1. Accepting
        # begin == prev_end too would mask a real 1-frame gap.
        if prev_end is not None and begin <= prev_end:  # overlap
            # Frames [begin, prev_end] are owned by the clip we kept: drop
            # the later clip and regenerate ONLY its tail past the kept
            # clip — a full-range repair would re-create the same overlap
            # (and re-flag forever). A clip fully contained in the kept one
            # gets an empty repair range (removal alone fixes it). Length
            # is not checked: the clip is removed regardless.
            lo = min(prev_end + 1, end_inclusive + 1)
            issues.append(ClipIssue("continuity", name,
                                    (lo, end_inclusive + 1)))
            if remove_bad:
                os.remove(path)
            continue
        _, real_len, _, _ = probe_video(path)
        expected = end_inclusive + 1 - begin
        if real_len != expected:
            issues.append(ClipIssue("length", name, (begin, end_inclusive + 1)))
            if remove_bad:
                os.remove(path)
        if prev_end is not None and begin > prev_end + 1:  # gap
            issues.append(ClipIssue("continuity", prev_name,
                                    (prev_end + 1, begin)))
        prev_name, prev_end = name, end_inclusive
    return issues
