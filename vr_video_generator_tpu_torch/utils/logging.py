"""Per-worker file logging, progress/ETA telemetry, and error capture.

Capability parity with the reference's support tier: per-process
stdout/stderr redirect into the Debug dir (reference SupportFunction.py:73-79),
``print_flush`` (:81-83), ETA lines (reference PredictAndGenerate.py:238-239)
and ERROR.txt capture (:259-272) — rebuilt as a logger-based API so in-process
host threads (the TPU build has no per-GPU server processes) get the same
observability.

The port's own copy of vr_video_generator_tpu/utils/logging.py, kept in step
with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from typing import Optional, TextIO


def print_flush(*args, **kwargs) -> None:
    print(*args, **kwargs)
    try:
        sys.stdout.flush()
    except Exception:
        pass


def redirect_stdout(out_path: str) -> TextIO:
    """Redirect this process's stdout+stderr into ``out_path`` (append).

    Same contract as the reference's ``redirrect_stdout``
    (SupportFunction.py:73-79): used by worker processes so every worker owns
    a log file under the Debug dir.
    """
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    out_file = open(out_path, "a+")
    sys.stdout = out_file
    sys.stderr = out_file
    out_file.flush()
    return out_file


class WorkerLog:
    """Lightweight per-worker log writer that does not hijack global stdout.

    Preferred over ``redirect_stdout`` for in-process workers (threads); the
    subprocess entry points still use ``redirect_stdout`` for strict parity.
    """

    def __init__(self, path: Optional[str]):
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a+")

    def write(self, *args) -> None:
        line = " ".join(str(a) for a in args)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print_flush(line)

    def error(self, context: str, exc: BaseException, error_path: Optional[str] = None) -> None:
        """Capture a failure to this log and (like the reference's ERROR.txt
        funnel, PredictAndGenerate.py:259-272) to a shared error file."""
        tb = traceback.format_exc()
        self.write(f"[ERROR] {context}: {exc}")
        self.write(tb)
        if error_path:
            os.makedirs(os.path.dirname(error_path) or ".", exist_ok=True)
            with open(error_path, "a+") as fh:
                fh.write(f"[ERROR] {context}: {exc}\n{tb}\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class ProgressMeter:
    """ETA/progress telemetry matching the reference's per-batch print format
    (reference PredictAndGenerate.py:238-239)."""

    def __init__(self, total_steps: int, log: Optional[WorkerLog] = None):
        self.total_steps = max(int(total_steps), 1)
        self.begin_time = time.time()
        self.log = log or WorkerLog(None)

    def report(self, steps_taken: int) -> None:
        steps_taken = max(int(steps_taken), 1)
        elapsed = time.time() - self.begin_time
        per_step = elapsed / steps_taken
        self.log.write(
            "Estimated Total Time (minutes):", per_step * self.total_steps / 60.0,
            ", Time elapsed (minutes):", elapsed / 60.0,
            ", ETA:", per_step * (self.total_steps - steps_taken) / 60.0,
        )
        self.log.write(str(int(steps_taken / self.total_steps * 10000) / 100), " %")


OVERFLOW_FILE = "OVERFLOW.jsonl"


def overflow_path(debug_dir: str) -> str:
    return os.path.join(debug_dir, OVERFLOW_FILE)


def record_overflow(path: Optional[str], begin: int, end: int,
                    count: int) -> None:
    """Append one machine-readable depth-overflow record.

    The in-graph clamp (ops/temporal.py) counts frames whose scaled depth
    exceeded StereoConfig.limit_step_cap; the runtimes log a per-segment
    warning, and this record lets the RUN-level summary, the checktool, and
    the GUI integrity view surface the total without reading per-segment
    logs — the reference's equivalent condition is silently unbounded
    (reference PredictAndGenerate.py:101-118 cutoff_list)."""
    if not path or count <= 0:
        return
    import json
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps({"begin": int(begin), "end": int(end),
                            "overflow": int(count)}) + "\n")


def summarize_overflow(path: str) -> tuple[int, int]:
    """(total clamped frames, record count); (0, 0) when no records exist.
    Malformed lines (e.g. a crashed writer's partial tail) are skipped."""
    import json
    total = n = 0
    try:
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    total += int(rec["overflow"])
                    n += 1
                except (ValueError, KeyError, TypeError):
                    continue
    except OSError:
        return 0, 0
    return total, n


def overflow_message(total: int, encoder: str = "") -> str:
    """The one user-visible wording for the depth-overflow condition."""
    enc = f" ({encoder})" if encoder else ""
    return (f"WARNING: scaled depth exceeded limit_step_cap on {total} "
            f"frame(s) — clamped in-graph; depth detail past the cap is "
            f"flattened. Recalibrate the encoder's depth_scaler{enc} "
            f"(utils/config.py) or raise StereoConfig.limit_step_cap.")


def stride_audit_line(lo: int, hi: int, rms: float, mx: float, cap: int,
                      slot: int | None = None) -> str:
    """One shared format for the sampled stride-fidelity audit — the
    single-chip (runtime/segment.py) and sharded (runtime/sharded_runner.py)
    runtimes must emit identical lines for log-consuming tooling."""
    where = f"slot {slot} " if slot is not None else ""
    return (f"stride audit {where}frames [{lo}, {hi}): lerp-vs-true raw "
            f"depth rms={rms:.4f} max={mx:.4f} (scaled units; cap={cap})")
