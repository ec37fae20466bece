"""Filesystem helpers — parity with reference SupportFunction.py:51-71.

The port's own copy of vr_video_generator_tpu/utils/fsutil.py, kept in step
with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
import random
import shutil
import time
from pathlib import Path

from vr_video_generator_tpu_torch.utils.logging import print_flush


def remove_all_files(dir_path: str) -> None:
    """Clear a directory's contents without removing the directory itself
    (reference SupportFunction.py:51-61)."""
    if os.path.isdir(dir_path) and os.listdir(dir_path):
        for filename in os.listdir(dir_path):
            file_path = os.path.join(dir_path, filename)
            if os.path.isfile(file_path) or os.path.islink(file_path):
                try:
                    os.unlink(file_path)
                except PermissionError:
                    pass
            elif os.path.isdir(file_path):
                shutil.rmtree(file_path)


def create_folder_if_not_exist(folder_dir: str) -> None:
    Path(folder_dir).mkdir(parents=True, exist_ok=True)


def random_sleep(sleep_range, message: str = "") -> None:
    """Staggered-start sleep (reference SupportFunction.py:64-71). The TPU
    build needs no staggering (one program owns the device; encode
    subprocesses are serialized by SubclipWriter) — kept as operator API
    parity for external scripts that used the reference's helper."""
    length = random.uniform(sleep_range[0], sleep_range[1])
    print_flush(f"{message} : {length} seconds.")
    time.sleep(length)
