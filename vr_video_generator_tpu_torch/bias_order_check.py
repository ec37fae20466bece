"""Shows that chip_smoke.py's checks refuse kernels that add a bias at the
wrong rounding point.

For each fault it copies the package and chip_smoke.py into a temporary
directory, changes the copy's CUDA sources, builds that copy and runs one of
chip_smoke's checks on it:

  - row 5 adds the bias to the f32 product before the one cast to bf16
    (what nn.Linear does, and not what flax's nn.Dense and the TPU kernel
    do): the GEMM core (csrc/wgmma_gemm.cuh) starts each tile's f32 sums
    from its epilogue's bias, and row 5's epilogue (csrc/qkv.cu) no longer
    adds it to the bf16 sums. (Every epilogue of the core names its bias
    ``bias``, so the changed core still builds; only row 5 is checked.) The
    row-5 check runs at vits' D = 384 and vitl-518's D = 1024.
  - row 15's conv1 adds its f32 bias after the cast, to the bf16 sums (the
    TPU kernel adds it to the f32 sums, then casts): the core's
    BiasBeforeCast step and the halo kernel's Conv1Out epilogue round the
    sums to bf16 first. The row-15 stage check runs at vits' C = 64 (the
    halo kernel) and vitb's C = 128 (the core).

Run on a machine with an NVIDIA Hopper GPU, from the root of a checkout:

    python3 -m vr_video_generator_tpu_torch.bias_order_check

It prints each check's verdict and statistics and exits 0 when every broken
copy is refused at every width, 1 when one passes anywhere (the check would
not catch the fault).
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = "vr_video_generator_tpu_torch"

ROW5_CHECK = """
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

ROW15_CHECK = """
import json, sys
import torch
import chip_smoke as cs
device, _ = cs.setup()
gen = torch.Generator(device=device).manual_seed(cs.SEED + 15)
refused = 0
for c in (cs.FEATURES, 2 * cs.FEATURES):
    x = cs.randn(gen, (cs.B, c, 2 * cs.H0, 2 * cs.W0),
                 dtype=torch.bfloat16).permute(0, 2, 3, 1)
    try:
        stats, _ = cs.base_tail_stages(f"C={c}", x, cs.tail_weights(gen, c)[2:],
                                       cs.OUT_HW)
    except cs.SmokeFailure as e:
        print(f"C={c}: conv1's bias added after the cast: REFUSED:", e,
              flush=True)
        refused += 1
        continue
    print(f"C={c}: conv1's bias added after the cast: ACCEPTED:",
          json.dumps(stats), flush=True)
sys.exit(0 if refused == 2 else 1)
"""

# (label, [(source, right, wrong)], check).
FAULTS = (
    ("row 5, bias before the cast", (
        ("wgmma_gemm.cuh",
         "for (int i = 0; i < BN / 2; ++i) acc[mw][i] = 0.f;",
         "for (int i = 0; i < BN / 2; ++i) {"
         " const int c = col0 + 8 * (i / 4) + (i & 1);"
         " acc[mw][i] = c < n ? bf(epi.bias[c]) : 0.f; }"),
        ("qkv.cu", "bf16 t = add_bf(v[e], b[e]);", "bf16 t = v[e];"),
    ), ROW5_CHECK),
    ("row 15, conv1's bias after the cast", (
        ("wgmma_gemm.cuh",
         "v0 = __fadd_rn(v0, __ldg(sum_bias + col));\n"
         "    v1 = __fadd_rn(v1, __ldg(sum_bias + col + 1));",
         "v0 = __fadd_rn(bf(rbf(v0)), __ldg(sum_bias + col));\n"
         "    v1 = __fadd_rn(bf(rbf(v1)), __ldg(sum_bias + col + 1));"),
        ("head_tail_big.cu",
         "__fadd_rn(acc[mt][nt][2 * h], bias[2 * nt]),\n"
         "                __fadd_rn(acc[mt][nt][2 * h + 1], bias[2 * nt + 1]))",
         "__fadd_rn(bf(rbf(acc[mt][nt][2 * h])), bias[2 * nt]),\n"
         "                __fadd_rn(bf(rbf(acc[mt][nt][2 * h + 1])),"
         " bias[2 * nt + 1]))"),
    ), ROW15_CHECK),
)


def run_fault(repo: Path, label: str, edits, check: str) -> int:
    """Build a copy of the package with ``edits`` and run ``check`` on it:
    0 when the check refuses it everywhere, 1 when it does not, 2 when an
    edit does not apply."""
    print(f"bias_order_check: {label}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(repo / PKG, Path(tmp) / PKG,
                        ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                      "*.so"))
        shutil.copy(repo / "chip_smoke.py", tmp)
        for name, right, wrong in edits:
            src = Path(tmp) / PKG / "csrc" / name
            text = src.read_text()
            if text.count(right) != 1:
                print(f"bias_order_check: {right!r} is not once in {name}",
                      file=sys.stderr)
                return 2
            src.write_text(text.replace(right, wrong))
        return subprocess.run([sys.executable, "-c", check], cwd=tmp,
                              timeout=900).returncode


def main() -> int:
    repo = Path(__file__).resolve().parent.parent
    codes = [run_fault(repo, *fault) for fault in FAULTS]
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
