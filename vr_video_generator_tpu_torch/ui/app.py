"""Interactive console front-end — capability parity with the reference GUI.

The port's counterpart of vr_video_generator_tpu/ui/app.py, with the same
form, commands and report. The commands it builds run the port's entry
points, ``vr_video_generator_tpu_torch.cli`` and ``.checktool``, which run
on the card unless the form's command says otherwise (the CLI's
``--device`` defaults to ``cuda`` and raises without a card).

The reference ships a dearpygui desktop app (reference UserInterface.py):
a form over all run parameters, a live CLI-command preview, Run/Stop
buttons that spawn/kill the pipeline subprocess, and a Debug-folder opener.
The same capabilities are provided as a dependency-free interactive
console:

  * parameter form with the same field set and defaults
    (reference UserInterface.py:30-50);
  * auto-derived output filename (`auto_update_filename`, :100-104);
  * command preview string (`update_preview`, :82-99) — config IS the
    command line, same as the reference;
  * run/stop of the pipeline as a child process group (psutil-free
    equivalent of the child-tree kill, :127-140);
  * debug-folder listing (:263,279).

Run with: python -m vr_video_generator_tpu_torch.ui.app
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
from typing import Dict, Optional

from vr_video_generator_tpu_torch.ui.pathpick import pick_path

# Field set mirrors the reference's args dict (UserInterface.py:30-50).
DEFAULT_FIELDS: Dict[str, str] = {
    "VideoDir": "./Videos/Input/input.mp4",
    "OutputDir": "",
    "DebugDir": "./Debug/",
    "SubClipDir": "./Subclip/",
    "encoder": "vits",
    "encoder_path": "./checkpoints/depth_anything_v2_vits.pth",
    "offset_fg": "0.025",
    "offset_bg": "-0.01",
    "offset_step_size": "1",
    "Num_Workers": "4",
    "num_gpu": "1",
    "Num_GPU_Workers": "1",
    "Max_Frame_Count": "15",
    "start_frame": "0",
    "end_frame": "99999999999999",
    "repair_mode": "0",
    "batch_size": "8",
    "compute_dtype": "bfloat16",
    "depth_stride": "1",
    "stride_audit_every": "0",
}


def auto_output_name(video_dir: str) -> str:
    """'SBS <name>.mkv' next to the input (reference UserInterface.py:100-104)."""
    base = os.path.basename(video_dir)
    stem = os.path.splitext(base)[0]
    return os.path.join(os.path.dirname(video_dir), f"SBS {stem}.mkv")


def build_command(fields: Dict[str, str]) -> list:
    """CLI argv preview (reference update_preview, UserInterface.py:82-99)."""
    cmd = [sys.executable, "-m", "vr_video_generator_tpu_torch.cli"]
    for key, value in fields.items():
        if value != "":
            cmd += [f"--{key}", str(value)]
    return cmd


def repair_command(fields: Dict[str, str]) -> list:
    """argv for check-and-repair: the form's run config with repair forced
    on, through the vr_video_generator_tpu_torch.checktool entry point."""
    fields = dict(_with_auto_output(fields))
    fields["repair_mode"] = "1"
    argv = build_command(fields)
    argv[argv.index("vr_video_generator_tpu_torch.cli")] = \
        "vr_video_generator_tpu_torch.checktool"
    return argv


class PipelineProcess:
    """Run/Stop management of the conversion subprocess; Stop kills the whole
    process group (the reference kills the psutil child tree,
    UserInterface.py:127-140)."""

    def __init__(self) -> None:
        self._proc: Optional[subprocess.Popen] = None

    def running(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def start(self, cmd: list) -> None:
        if self.running():
            raise RuntimeError("pipeline already running")
        self._proc = subprocess.Popen(cmd, start_new_session=True)

    def returncode(self) -> Optional[int]:
        """The exit code of the last process started, None while it runs or
        when none was started (or it was stopped)."""
        return None if self._proc is None else self._proc.poll()

    def stop(self) -> None:
        if self._proc is None:
            return
        if self._proc.poll() is None:
            try:
                os.killpg(os.getpgid(self._proc.pid), signal.SIGTERM)
                self._proc.wait(timeout=10)
            except (ProcessLookupError, subprocess.TimeoutExpired):
                try:
                    os.killpg(os.getpgid(self._proc.pid), signal.SIGKILL)
                except ProcessLookupError:
                    pass
        self._proc = None


def run_app(input_fn=input, print_fn=print) -> None:  # pragma: no cover - interactive
    fields = dict(DEFAULT_FIELDS)
    proc = PipelineProcess()
    print_fn("vr_video_generator_tpu_torch console UI — commands: set <key> "
             "<value>, pick <key>, show, run, stop, debug, verify, repair, "
             "quit")
    while True:
        try:
            line = input_fn("> ").strip()
        except (EOFError, KeyboardInterrupt):
            line = "quit"
        if not line:
            continue
        cmd, *rest = line.split(maxsplit=2)
        if cmd == "quit":
            proc.stop()
            return
        elif cmd == "show":
            for k, v in fields.items():
                print_fn(f"  {k} = {v}")
            print_fn("Command preview:")
            print_fn("  " + shlex.join(build_command(_with_auto_output(fields))))
        elif cmd == "set" and len(rest) == 2:
            key, value = rest
            if key not in fields:
                print_fn(f"unknown field {key!r}")
                continue
            fields[key] = value
        elif cmd == "pick" and rest:
            key = rest[0]
            chosen = pick_path(input_fn=input_fn, print_fn=print_fn)
            if chosen:
                fields[key] = chosen
        elif cmd == "run":
            proc.start(build_command(_with_auto_output(fields)))
            print_fn("pipeline started")
        elif cmd == "stop":
            proc.stop()
            print_fn("pipeline stopped")
        elif cmd == "debug":
            dbg = fields["DebugDir"]
            if os.path.isdir(dbg):
                for f in sorted(os.listdir(dbg)):
                    print_fn("  " + f)
            else:
                print_fn(f"no debug dir at {dbg}")
        elif cmd == "verify":
            print_fn(integrity_report(fields["SubClipDir"],
                                      fields["VideoDir"]))
        elif cmd == "repair":
            proc.start(repair_command(fields))
            print_fn("repair started (stop with 'stop')")
        else:
            print_fn("commands: set/pick/show/run/stop/debug/verify/"
                     "repair/quit")


def integrity_report(subclip_dir: str, video_dir: str = "",
                     debug_dir: str = "") -> str:
    """Human-readable subclip integrity report for the UI "Verify Integrity"
    action. The reference GUI has this button but never implemented it
    (reference UserInterface.py:276, callback=None) — here it runs the real
    checker (video/check.py, the reference Check_Clips.py logic) plus a
    coverage summary against the source video, and suggests the exact
    --repair_mode 1 command for anything broken. With ``debug_dir`` it also
    surfaces the run's depth-overflow records (clamped frames)."""
    from vr_video_generator_tpu_torch.video.check import (check_subclips,
                                                          parse_clip_name)
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips

    if not os.path.isdir(subclip_dir):
        return f"no subclip directory at {subclip_dir}"
    try:
        # validate the names up front: stray files (e.g. 'backup4',
        # 'clip_v4.mp4') break the numeric sort, and a report action must
        # not crash the UI over them. Narrow scope on purpose — a
        # ValueError out of the probing below is a different problem and
        # must not be misreported as a naming one.
        for name in sorted_subclips(subclip_dir):
            parse_clip_name(name)
    except ValueError as exc:
        return (f"cannot parse subclip names in {subclip_dir}: {exc} — "
                "expected '{begin}_{end_inclusive}.mp4'")
    return _integrity_report_body(subclip_dir, video_dir, check_subclips,
                                  parse_clip_name, sorted_subclips,
                                  debug_dir=debug_dir)


def _integrity_report_body(subclip_dir, video_dir, check_subclips,
                           parse_clip_name, sorted_subclips,
                           debug_dir: str = "") -> str:
    names = sorted_subclips(subclip_dir)
    if not names:
        return f"no subclips in {subclip_dir}"
    first_begin, _ = parse_clip_name(names[0])
    _, last_end = parse_clip_name(names[-1])
    lines = [f"{len(names)} subclips covering frames "
             f"[{first_begin}, {last_end}] in {subclip_dir}"]

    issues = check_subclips(subclip_dir)
    if issues:
        repair_ranges = []
        for issue in issues:
            lo, hi = issue.repair_range
            lines.append(f"  BAD {issue.kind}: {issue.filename} "
                         f"-> regenerate frames [{lo}, {hi})")
            repair_ranges.append((lo, hi))
        lo = min(r[0] for r in repair_ranges)
        hi = max(r[1] for r in repair_ranges)
        lines.append(f"repair with: --repair_mode 1 "
                     f"--start_frame {lo} --end_frame {hi}")
    else:
        lines.append("all subclips OK (lengths match names, no gaps/overlaps)")

    if video_dir and os.path.isfile(video_dir):
        from vr_video_generator_tpu_torch.video.reader import probe_video

        _, n_frames, _, _ = probe_video(video_dir)
        covered = last_end + 1 - first_begin
        if first_begin == 0 and last_end + 1 >= n_frames and not issues:
            lines.append(f"coverage complete: {covered}/{n_frames} "
                         f"source frames")
        else:
            lines.append(f"coverage: frames [{first_begin}, {last_end}] of "
                         f"{n_frames} source frames")

    if debug_dir:
        from vr_video_generator_tpu_torch.utils.logging import (
            overflow_message, overflow_path, summarize_overflow)

        total, n_recs = summarize_overflow(overflow_path(debug_dir))
        if total:
            lines.append(overflow_message(total))
            lines.append(f"  ({n_recs} affected range(s) recorded in "
                         f"{overflow_path(debug_dir)})")
    return "\n".join(lines)


def _with_auto_output(fields: Dict[str, str]) -> Dict[str, str]:
    out = dict(fields)
    if not out.get("OutputDir"):
        out["OutputDir"] = auto_output_name(out["VideoDir"])
    return out


if __name__ == "__main__":  # pragma: no cover
    run_app()
