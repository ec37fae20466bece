"""Shows that chip_smoke.py's ln_qkv check refuses a kernel that adds the
bias at the wrong rounding point.

It copies the package and chip_smoke.py into a temporary directory, changes
csrc/qkv.cu so the bias is added to the f32 product before the one cast to
bf16 (what nn.Linear does, and not what flax's nn.Dense and the TPU kernel
do), builds that copy and runs chip_smoke's row-5 check on it. Run on a
machine with an NVIDIA Hopper GPU, from the root of a checkout:

    python3 -m vr_video_generator_tpu_torch.bias_order_check

It prints the check's verdict and statistics and exits 0 when the broken
copy is refused, 1 when it passes (the check would not catch the fault).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = "vr_video_generator_tpu_torch"
# The bf16 cast, then the bf16 bias add -> the bias added in f32, one cast.
RIGHT = "bf16 t = add_bf(rbf(Cs[r * LDC + c + e]), bias[n + e]);"
WRONG = "bf16 t = rbf(__fadd_rn(Cs[r * LDC + c + e], bf(bias[n + e])));"

CHECK = """
import json, sys
import chip_smoke
device, _ = chip_smoke.setup()
try:
    stats = chip_smoke.check_ln_qkv(device)
except chip_smoke.SmokeFailure as e:
    print("bias added before the cast: REFUSED:", e, flush=True)
    sys.exit(0)
print("bias added before the cast: ACCEPTED:", json.dumps(stats), flush=True)
sys.exit(1)
"""


def main() -> int:
    repo = Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(repo / PKG, Path(tmp) / PKG,
                        ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                      "*.so"))
        shutil.copy(repo / "chip_smoke.py", tmp)
        src = Path(tmp) / PKG / "csrc" / "qkv.cu"
        text = src.read_text()
        if text.count(RIGHT) != 1:
            print(f"bias_order_check: the epilogue line is not in {src.name}",
                  file=sys.stderr)
            return 2
        src.write_text(text.replace(RIGHT, WRONG))
        return subprocess.run([sys.executable, "-c", CHECK], cwd=tmp,
                              timeout=900).returncode


if __name__ == "__main__":
    sys.exit(main())
