"""The port's checkpoint directories: a converted state_dict that reloads
without parsing a ``.pth`` again.

The counterpart of vr_video_generator_tpu/models/checkpoint.py `save` and
`load`, which persist the JAX package's parameter tree through Orbax. The
port cannot read Orbax without JAX, so it keeps a format of its own: one
directory holding ``tensors.pt`` (the upstream-named state_dict, written by
``torch.save``) and ``manifest.json`` (the format's name and version and the
encoder). ``load`` reads the tensors back with ``weights_only=True``, so a
checkpoint can hold tensors and nothing that runs code.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

FORMAT = "vr_video_generator_tpu_torch.state_dict"
VERSION = 1
MANIFEST = "manifest.json"
TENSORS = "tensors.pt"
# Files that mark an Orbax checkpoint directory (the JAX package's format).
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def save(path: str, state_dict: Mapping, encoder: str = "") -> None:
    """Write ``state_dict`` (tensors or numpy arrays, upstream names) as a
    checkpoint directory at ``path``, replacing one that is there."""
    os.makedirs(path, exist_ok=True)
    tensors = {k: (v.detach().cpu().contiguous() if isinstance(v, torch.Tensor)
                   else torch.from_numpy(np.array(v)))
               for k, v in state_dict.items()}
    tmp = os.path.join(path, TENSORS + ".tmp")
    torch.save(tensors, tmp)
    os.replace(tmp, os.path.join(path, TENSORS))
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump({"format": FORMAT, "version": VERSION, "encoder": encoder},
                  f, indent=1)


def manifest(path: str) -> Optional[dict]:
    """The manifest of a port checkpoint directory, or None where ``path``
    holds none of this format."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    return meta if isinstance(meta, dict) and meta.get("format") == FORMAT \
        else None


def describe(path: str) -> str:
    """What a directory that is not a port checkpoint holds, for errors."""
    if any(os.path.exists(os.path.join(path, m)) for m in ORBAX_MARKERS):
        return ("an Orbax checkpoint (the JAX package's format, which the "
                "port cannot read without JAX)")
    if not os.listdir(path):
        return "an empty directory"
    return "a directory that holds no checkpoint of the port's format"


def load(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of the checkpoint directory at ``path``; raises
    ValueError for any other directory and for a newer format version."""
    meta = manifest(path)
    if meta is None:
        raise ValueError(
            f"{path!r} is {describe(path)}, not a checkpoint directory of "
            f"vr_video_generator_tpu_torch ({MANIFEST} with format {FORMAT!r}). "
            "Pass the official Depth-Anything-V2 .pth as --encoder_path, or "
            "a directory written by vr_video_generator_tpu_torch.models."
            "checkpoint.save")
    if meta.get("version") != VERSION:
        raise ValueError(f"{path!r}: checkpoint format version "
                         f"{meta.get('version')!r}, this package reads "
                         f"version {VERSION}")
    return torch.load(os.path.join(path, TENSORS), map_location="cpu",
                      weights_only=True)
