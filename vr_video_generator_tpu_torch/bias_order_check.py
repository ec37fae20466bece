"""Shows that chip_smoke.py's ln_qkv check refuses a kernel that adds the
bias at the wrong rounding point.

It copies the package and chip_smoke.py into a temporary directory and
changes the copy so row 5 adds the bias to the f32 product before the one
cast to bf16 (what nn.Linear does, and not what flax's nn.Dense and the TPU
kernel do): the GEMM core (csrc/wgmma_gemm.cuh) starts each tile's f32 sums
from its epilogue's bias, and row 5's epilogue (csrc/qkv.cu) no longer adds
it to the bf16 sums. (Every epilogue of the core names its bias ``bias``,
so the changed core still builds; only row 5 is checked.) It builds that
copy and runs chip_smoke's row-5 check on it at vits' D = 384 and
vitl-518's D = 1024. Run on a machine with an NVIDIA Hopper GPU, from the
root of a checkout:

    python3 -m vr_video_generator_tpu_torch.bias_order_check

It prints the check's verdict and statistics at each width and exits 0 when
the broken copy is refused at both, 1 when it passes at either (the check
would not catch the fault).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = "vr_video_generator_tpu_torch"
# (source, right, wrong): the f32 sums start from the bias; the bf16 bias
# add after the cast goes.
EDITS = (
    ("wgmma_gemm.cuh",
     "for (int i = 0; i < 128; ++i) acc[i] = 0.f;",
     "for (int i = 0; i < 128; ++i) {"
     " const int c = col0 + 8 * (i / 4) + (i & 1);"
     " acc[i] = c < n ? bf(epi.bias[c]) : 0.f; }"),
    ("qkv.cu", "bf16 t = add_bf(v[e], b[e]);", "bf16 t = v[e];"),
)

CHECK = """
import json, sys
import chip_smoke
device, _ = chip_smoke.setup()
refused = 0
for d in (chip_smoke.DIM, chip_smoke.DIM_L):
    try:
        stats = chip_smoke.check_ln_qkv(device, d)
    except chip_smoke.SmokeFailure as e:
        print(f"D={d}: bias added before the cast: REFUSED:", e, flush=True)
        refused += 1
        continue
    print(f"D={d}: bias added before the cast: ACCEPTED:", json.dumps(stats),
          flush=True)
sys.exit(0 if refused == 2 else 1)
"""


def main() -> int:
    repo = Path(__file__).resolve().parent.parent
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(repo / PKG, Path(tmp) / PKG,
                        ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                      "*.so"))
        shutil.copy(repo / "chip_smoke.py", tmp)
        for name, right, wrong in EDITS:
            src = Path(tmp) / PKG / "csrc" / name
            text = src.read_text()
            if text.count(right) != 1:
                print(f"bias_order_check: {right!r} is not once in {name}",
                      file=sys.stderr)
                return 2
            src.write_text(text.replace(right, wrong))
        return subprocess.run([sys.executable, "-c", CHECK], cwd=tmp,
                              timeout=900).returncode


if __name__ == "__main__":
    sys.exit(main())
