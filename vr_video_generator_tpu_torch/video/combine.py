"""Subclip concatenation + audio remux — parity with reference Combine_Clips.py.

ffmpeg path: concat demuxer with stream copy, extract every audio track from
the original to .mka, remux (reference Combine_Clips.py:19-42); soft subtitle
tracks, global metadata, and chapters are carried too (capabilities the
reference lacks — it drops all three).
cv2 fallback (no ffmpeg binary): re-encode concat, video only.

The port's own copy of vr_video_generator_tpu/video/combine.py, kept in step
with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import List, Optional

import cv2

from vr_video_generator_tpu_torch.utils.logging import print_flush
from vr_video_generator_tpu_torch.video.reader import find_binary, probe_video

# format-level tags every muxer writes on its own — carrying only these is
# not worth a full container rewrite on the fast path
_BOILERPLATE_TAGS = frozenset({
    "encoder", "duration", "major_brand", "minor_version",
    "compatible_brands", "creation_time",
})


def sorted_subclips(subclip_dir: str) -> List[str]:
    """Subclip filenames sorted by numeric begin-frame (reference
    Combine_Clips.py:9-10 — '*4' filter keeps .mp4 only)."""
    files = [f for f in os.listdir(subclip_dir) if f.endswith("4")]
    return sorted(files, key=lambda x: int(os.path.splitext(x)[0].split("_")[0]))


def _concat_entry(path: str) -> str:
    """One concat-demuxer list line. The demuxer parses `file '<path>'` with
    shell-style quoting, so embedded single quotes need the close-escape-
    reopen dance ('\\'') or a path like /home/O'Brien/ truncates the entry."""
    return "file '" + path.replace("'", "'\\''") + "'\n"


def _probe_original(original_path: str) -> Optional[dict]:
    """ffprobe the original for carryable side content: audio/subtitle
    stream counts, chapter count, and whether the container has global tags
    beyond muxer boilerplate. Returns None when ffprobe is unavailable or
    unparseable — callers must then assume everything is present."""
    ffprobe = find_binary("ffprobe")
    if not ffprobe:
        return None
    try:
        proc = subprocess.run(
            [ffprobe, "-v", "error", "-show_streams", "-show_format",
             "-show_chapters", "-of", "json", original_path],
            capture_output=True, text=True)
        if proc.returncode != 0:
            return None
        info = json.loads(proc.stdout)
    except (OSError, ValueError, TypeError, AttributeError):
        return None
    if "chapters" not in info or "streams" not in info:
        return None  # unexpected shape: treat as unknown, not as absent
    streams = info["streams"]
    tags = (info.get("format") or {}).get("tags") or {}
    return {
        "audio": sum(s.get("codec_type") == "audio" for s in streams),
        "subs": sum(s.get("codec_type") == "subtitle" for s in streams),
        "chapters": len(info["chapters"]),
        "tags": any(k.lower() not in _BOILERPLATE_TAGS for k in tags),
    }


def combine_clips(subclip_dir: str, original_path: str, output_path: str,
                  just_combine: int = 0, workdir: Optional[str] = None) -> int:
    """Concatenate subclips; just_combine=1 skips the audio remux (the
    reference's repair_mode 3 debug path, PredictAndGenerate.py:417-419).

    Temp side-cars land in ``workdir`` (default: the output's directory,
    which must be writable anyway) with pid-unique names, so concurrent
    combines and a read-only cwd are both safe."""
    ffmpeg = find_binary("ffmpeg")
    clips = sorted_subclips(subclip_dir)
    if not clips:
        raise FileNotFoundError(f"no subclips in {subclip_dir}")

    if ffmpeg:
        if workdir is None:
            workdir = os.path.dirname(os.path.abspath(output_path))
        pid = os.getpid()
        file_list_path = os.path.join(workdir, f"input_list_{pid}.txt")
        temp_video = os.path.join(workdir, f"temp_video_{pid}.mkv")
        audio_path = os.path.join(workdir, f"original_audio_{pid}.mka")
        subs_path = os.path.join(workdir, f"original_subs_{pid}.mks")
        # In-place conversion (output over the original): ffmpeg refuses to
        # read and write the same file, and the original is an input of the
        # final remux — stage to a sibling temp, then replace.
        try:
            in_place = os.path.samefile(original_path, output_path)
        except OSError:
            in_place = False
        base = os.path.basename(output_path)
        staged_out = (os.path.join(os.path.dirname(os.path.abspath(
            output_path)), f".combine_{pid}_{base}") if in_place
            else output_path)
        try:
            with open(file_list_path, "w+") as f:
                for name in clips:
                    f.write(_concat_entry(
                        os.path.abspath(os.path.join(subclip_dir, name))))
            subprocess.run([ffmpeg, "-f", "concat", "-safe", "0", "-y",
                            "-i", file_list_path, "-c", "copy", temp_video],
                           check=True)
            if just_combine == 1:
                os.replace(temp_video, output_path)
                return 0

            probe = _probe_original(original_path)
            has_audio = (probe is None or probe["audio"] > 0) and \
                subprocess.run(
                    [ffmpeg, "-y", "-i", original_path, "-map", "0:a",
                     "-c:a", "copy", audio_path]).returncode == 0
            if not has_audio and probe is not None and probe["audio"] > 0:
                # reference parity: silently losing audio is not acceptable
                raise RuntimeError(
                    f"original has {probe['audio']} audio stream(s) but "
                    "extraction to .mka failed — refusing to emit a "
                    "silent output")
            # Capability win over the reference (Combine_Clips.py:19-42
            # remuxes audio only): soft subtitle tracks ride along via a
            # Matroska side-car. Codecs Matroska can't store as-is (e.g.
            # mp4's mov_text) get a text transcode to SRT; if the OUTPUT
            # container then rejects the subtitle copy, the remux retries
            # without subtitles instead of failing.
            has_subs = (probe is None or probe["subs"] > 0) and \
                _extract_subs(ffmpeg, original_path, subs_path)
            if not has_subs and probe is not None and probe["subs"] > 0:
                print_flush("WARNING: subtitle tracks could not be "
                            "extracted from the original; dropped")

            if (probe is not None and not has_audio and not has_subs
                    and probe["chapters"] == 0 and not probe["tags"]):
                # nothing to carry: skip the full container rewrite
                os.replace(temp_video, output_path)
                return 0

            def _remux(with_subs: bool) -> "subprocess.CompletedProcess":
                cmd = [ffmpeg, "-y", "-i", temp_video]
                maps = ["-map", "0:v"]
                idx = 1
                if has_audio:
                    cmd += ["-i", audio_path]
                    maps += ["-map", f"{idx}:a"]
                    idx += 1
                if with_subs:
                    cmd += ["-i", subs_path]
                    maps += ["-map", f"{idx}:s"]
                    idx += 1
                # global metadata + chapters from the original (no-ops when
                # the source has none) — the reference's remux drops both
                cmd += ["-i", original_path]
                maps += ["-map_metadata", str(idx), "-map_chapters", str(idx)]
                cmd += maps + ["-c", "copy", staged_out]
                return subprocess.run(cmd)

            # Remux even for video-only sources so global metadata and
            # chapters carry (unless the probe proved there are none, above).
            proc = _remux(has_subs)
            if proc.returncode != 0 and has_subs:
                proc = _remux(False)
                if proc.returncode == 0:
                    print_flush("WARNING: output container rejected the "
                                "subtitle copy; subtitle tracks dropped "
                                "(use a .mkv output to keep them)")
            if proc.returncode != 0:
                if has_audio:
                    # losing audio is a hard failure (reference parity);
                    # keep the failing argv for diagnostics
                    raise subprocess.CalledProcessError(proc.returncode,
                                                        proc.args)
                print_flush("WARNING: metadata remux failed; output carries "
                            "the combined video only")
                os.replace(temp_video, output_path)
            elif in_place:
                os.replace(staged_out, output_path)
        finally:
            for p in (temp_video, audio_path, subs_path, file_list_path,
                      *([staged_out] if in_place else [])):
                try:
                    os.remove(p)
                except OSError:
                    pass
        return 0

    # cv2 fallback: re-encode concat, no audio.
    first = os.path.join(subclip_dir, clips[0])
    fps, _, width, height = probe_video(first)
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {output_path}")
    for name in clips:
        cap = cv2.VideoCapture(os.path.join(subclip_dir, name))
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            writer.write(frame)
        cap.release()
    writer.release()
    return 0


def _extract_subs(ffmpeg: str, original_path: str, subs_path: str) -> bool:
    """Extract every subtitle track to a Matroska side-car: stream copy
    first, then an SRT transcode for text codecs Matroska rejects as-is."""
    if subprocess.run([ffmpeg, "-y", "-i", original_path, "-map", "0:s",
                       "-c:s", "copy", subs_path]).returncode == 0:
        return True
    if subprocess.run([ffmpeg, "-y", "-i", original_path, "-map", "0:s",
                       "-c:s", "srt", subs_path]).returncode == 0:
        print_flush("NOTE: subtitle tracks transcoded to SRT for carry "
                    "(original codec not storable in Matroska as-is)")
        return True
    return False


def verify_frame_count(original_path: str, output_path: str,
                       verbose: bool = False) -> int:
    """Post-combine frame-count check (reference Combine_Clips.py:56-62);
    returns the absolute difference. ``verbose`` prints the reference's
    comparison lines (each file probed exactly once)."""
    _, n_orig, _, _ = probe_video(original_path)
    _, n_out, _, _ = probe_video(output_path)
    if verbose:
        print_flush("These frames count should be the same")
        print_flush(f"Original: {n_orig} output: {n_out}, "
                    f"difference: {abs(n_out - n_orig)}")
    return abs(n_out - n_orig)
