"""PyTorch port, row 15 at f32 on the 3xTF32 wgmma core
(csrc/tf32x3_gemm.cuh): the single-kernel DPT tail's two convs
(csrc/head_tail_big.cu vrvg_head_tail_f32: conv1 + b1 on the conv with
BiasStore, the f32 resize pass, conv2 with the 1x1 on the conv with
DepthOut, as row 7's f32 chain runs them from conv1 on), their arithmetic
on the CPU.

The kernels (TMA, mbarriers, wgmma) run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 8). What they compute is
held here, with g++ building csrc/tf32x3.cuh and csrc/epilogue_f32.cuh as
they are, and tests/test_torch_gemm_3xtf32.py's model of the core (A and
the split weights split by tf32x3::split, a fresh truncating tensor-core
sum of each 32-wide stage, the stages added in f32 in the kernel's order)
as the product:
(a) conv1 + b1 (BiasStore's vrvg::bias_f32 on the model's sums) at C = 64
    and 128 (C2 = C / 2), on grids narrower than one 32-pixel box and
    ragged ones, within chip_smoke.py's f32 bound (F32_MAX_ULPS,
    f32_exact_check) of the conv on f64 operands + b1, at least as close
    on average as the f32 plain conv1, the TF32-rounded weights' conv1
    refused;
(b) the same model on TF32 operands outside that bound;
(c) the planes ops/head_tail._base_f32_weights keeps are the header's
    split() of each conv's weight rows in the k order the conv reads, the
    f32 vectors copies;
(d) the whole chain on the model (conv1 + b1, the resize pass's plain
    version, conv2's sums through vrvg::depth_out_f32) against
    head_tail_pallas at f32 in interpret mode and within chip_smoke.py's
    tail bounds of head_tail_plain (its TF32 depth refused);
(e) no source or test names the retired SIMT core's headers;
(f) head_tail at f32 at a width the JAX kernel asserts on raises
    ValueError naming the JAX assert, before any launch.
Needs g++ (C++20).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import (F32_MAX_ULPS, TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL,
                        conv3x3_f64, f32_exact_check, f32_rel_check, f32_ulps,
                        tf32_round)
from tests.test_torch_conv_3xtf32_rcu_ext import (assert_planes,
                                                  bias_epilogue,
                                                  model_conv_sums, seeded)
from vr_video_generator_tpu.ops.head_tail_pallas import head_tail_pallas
from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR
from vr_video_generator_tpu_torch.ops import head_tail as ht

torch.set_num_threads(2)
torch.set_grad_enabled(False)

REPO = Path(__file__).resolve().parent.parent
EMU_DIR = REPO / "tests" / "cuda_emu"
UNIT = """#include <cuda_runtime.h>
namespace {
alignas(16) unsigned char smem[16];
}
namespace emu {
static unsigned char* shared_memory() { return smem; }
}
#include "tf32x3.cuh"
#include "epilogue_f32.cuh"
extern "C" void split_many(const uint32_t* x, uint32_t* hi, uint32_t* lo,
                           long n) {
  for (long i = 0; i < n; ++i) {
    tf32x3::split(tf32x3::from_bits(x[i]), hi[i], lo[i]);
  }
}
extern "C" void bias_many(const float* s, const float* b, float* out,
                          long n) {
  for (long i = 0; i < n; ++i) out[i] = vrvg::bias_f32(s[i], b[i]);
}
// Each pixel's 32 sums s (n, 32) -> depth by depth_out_f32 (DepthOut).
extern "C" void depth_out_many(const float* s, const float* b2,
                               const float* w3, const float* b3, float* out,
                               long n) {
  for (long p = 0; p < n; ++p) {
    const float(&v)[32] = *reinterpret_cast<const float(*)[32]>(s + 32 * p);
    out[p] = vrvg::depth_out_f32(v, b2, w3, b3[0]);
  }
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/epilogue_f32.cuh")
    tmp = tmp_path_factory.mktemp("base_tail_3xtf32")
    (tmp / "unit.cpp").write_text(UNIT)
    so = tmp / "libbase_tail_3xtf32.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", "-w", f"-I{CSRC_DIR}", f"-I{EMU_DIR}",
         str(tmp / "unit.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(so))
    P, L = ctypes.c_void_p, ctypes.c_long
    out.split_many.argtypes = [P, P, P, L]
    out.bias_many.argtypes = [P] * 3 + [L]
    out.depth_out_many.argtypes = [P] * 5 + [L]
    for fn in (out.split_many, out.bias_many, out.depth_out_many):
        fn.restype = None
    return out


def base_case(c: int, h2: int, w2: int, seed: int):
    """path1 (2, H2, W2, C) and row 15's weights at chip_smoke.py's tail
    scales (f32_tail_weights), PyTorch layout."""
    rng = np.random.default_rng(seed)
    c2 = c // 2
    return (seeded(rng, (2, h2, w2, c)),
            seeded(rng, (c2, c, 3, 3), (9 * c) ** -0.5),
            seeded(rng, (c2,), 0.1),
            seeded(rng, (32, c2, 3, 3), (9 * c2) ** -0.5),
            seeded(rng, (32,), 0.1),
            seeded(rng, (1, 32, 1, 1), 32 ** -0.5),
            seeded(rng, (1,), 0.1, 0.5))


def depth_epilogue(lib, sums, b2, k3, b3):
    """DepthOut's arithmetic on conv2's sums (B, H, W, 32) through the g++
    unit: depth (B, H, W)."""
    s = sums.contiguous()
    out = torch.empty(s.shape[:-1])
    lib.depth_out_many(s.data_ptr(), b2.contiguous().data_ptr(),
                       k3.reshape(32).contiguous().data_ptr(),
                       b3.contiguous().data_ptr(), out.data_ptr(),
                       out.numel())
    return out


def model_chain(lib, x, k1, b1, k2, b2, k3, b3, out_hw, products="3xtf32"):
    """vrvg_head_tail_f32's chain with its convs modelled: (c1, R, depth)."""
    c1 = bias_epilogue(lib, model_conv_sums(x, k1, products), b1)
    r = ht.ext_resize_plain(c1, out_hw).contiguous()
    return c1, r, depth_epilogue(lib, model_conv_sums(r, k2, products), b2,
                                 k3, b3)


# --- (a), (b) conv1 + b1 ------------------------------------------------------

GRIDS = [(5, 7), (9, 17), (24, 40)]


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("grid", GRIDS, ids=[f"{h}x{w}" for h, w in GRIDS])
def test_conv1_bias_model_within_the_f32_bounds(lib, c, grid):
    """(a) conv1 + b1 through the model and BiasStore's bias_f32: within
    F32_MAX_ULPS of the conv on f64 operands + b1 (chip_smoke.conv3x3_f64,
    as phase 8 holds the kernel), at least as close on average as the f32
    plain conv1 (base_conv1_plain), the conv1 on TF32-rounded weights
    refused. The 5 x 7 grid is narrower than one 32-pixel box, the others
    end in a ragged box."""
    x, k1, b1 = base_case(c, *grid, seed=c + grid[1])[:3]
    got = bias_epilogue(lib, model_conv_sums(x, k1), b1)
    exact = conv3x3_f64(x, k1) + b1.double()
    stats = f32_exact_check(f"row 15 conv1 C={c} {grid}", got, exact,
                            ht.base_conv1_plain(x, k1, b1),
                            ht.base_conv1_plain(x, tf32_round(k1), b1), 1,
                            b1)
    print(stats)


@pytest.mark.parametrize("c", [64, 128])
def test_tf32_conv1_model_fails_the_f32_bounds(lib, c):
    """(b) conv1 + b1 through the model on TF32 operands (one product a
    k-step) is outside F32_MAX_ULPS of the f64 reference, as the card's
    TF32 result must be."""
    x, k1, b1 = base_case(c, 9, 17, seed=c + 17)[:3]
    got = bias_epilogue(lib, model_conv_sums(x, k1, "tf32"), b1)
    ulps = f32_ulps(got, conv3x3_f64(x, k1) + b1.double(), 1, b1)
    print(f"C={c}: TF32 model {ulps.max().item():.1f} ulps at most")
    assert ulps.max().item() > F32_MAX_ULPS


# --- (c) the kept planes -------------------------------------------------------

@pytest.mark.parametrize("c", [64, 128])
def test_base_f32_weights_hold_the_header_split(lib, c):
    """(c) _base_f32_weights: conv1 (C2, 9 C) and conv2 (32, 9 C2) each
    split by the header's split() in the k order (3 dh + dw) C + c the conv
    reads, (2, 128, 9 C) planes with zeros past their rows; then b1, b2,
    the 1x1 and b3 as f32 copies."""
    _, k1, b1, k2, b2, k3, b3 = base_case(c, 5, 7, seed=c)
    c2 = c // 2
    w1s, w2s, *vecs = ht._base_f32_weights(k1, b1, k2, b2, k3, b3)
    assert_planes(lib, w1s, k1.permute(0, 2, 3, 1).reshape(c2, 9 * c))
    assert_planes(lib, w2s, k2.permute(0, 2, 3, 1).reshape(32, 9 * c2))
    want = (b1, b2, k3, b3)
    assert [tuple(v.shape) for v in vecs] == [(c2,), (32,), (32,), (1,)]
    assert all(torch.equal(v, w.reshape(-1)) and v.data_ptr() != w.data_ptr()
               for v, w in zip(vecs, want))


# --- (d) the chain ----------------------------------------------------------------

CHAINS = [(64, 24, 40), (128, 24, 32), (64, 28, 36), (128, 32, 44)]


@pytest.mark.parametrize("c,h2,w2", CHAINS,
                         ids=[f"C={c} {h}x{w}" for c, h, w in CHAINS])
def test_base_tail_model_chain_matches_pallas_and_plain(lib, c, h2, w2):
    """(d) Row 15 at f32 as vrvg_head_tail_f32 runs it, its convs on the
    model: the depth against head_tail_pallas at f32 in interpret mode
    within 64 f32 ulps of the depth's largest value (the bound
    tests/test_torch_f32_swiglu.py holds the plain stages to), and against
    head_tail_plain within chip_smoke.py's tail bounds relative to the
    depth's range, which refuse the plain tail on TF32-rounded operands; c1
    and R have head_tail_stages' shapes."""
    h1, w1 = h2 * 14 // 8, w2 * 14 // 8
    x, k1, b1, k2, b2, k3, b3 = wts = base_case(c, h2, w2, seed=c + h2 + w2)
    c1, r, depth = model_chain(lib, *wts, (h1, w1))
    assert c1.shape == (2, h2, w2, c // 2) and r.shape == (2, h1, w1, c // 2)
    # The JAX kernel takes its conv weights as (kh, kw, I, O).
    jax_args = [jnp.asarray(x.numpy())] + [
        jnp.asarray((t.permute(2, 3, 1, 0) if t.ndim == 4 else t).numpy())
        for t in wts[1:]]
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(head_tail_pallas(*jax_args, (h1, w1),
                                          interpret=True))
    assert (ref > 0).mean() > 0.2 and depth.shape == ref.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 23)
    assert np.abs(depth.numpy().astype(np.float64) - ref).max() <= 64 * ulp
    want = ht.head_tail_plain(*wts, (h1, w1))
    rounded = [tf32_round(t) if t.ndim == 4 else t for t in wts[1:]]
    tfw = ht.head_tail_plain(tf32_round(x), *rounded, (h1, w1))
    span = (want.max() - want.min()).item()
    print(f32_rel_check(f"row 15 C={c}", depth, want, tfw, TAIL_F32_MAX_REL,
                        TAIL_F32_MEAN_REL, span))


# --- (e) the SIMT core is gone ---------------------------------------------------

@pytest.mark.parametrize("header", ["sgemm", "sconv"])
def test_no_file_names_the_simt_headers(header):
    """(e) The SIMT core's headers are gone from csrc/, and no source,
    script or test of the port includes or names them (gemm_bench finds an
    older tree's SIMT kernels by their kernel names, not these files)."""
    name = f"{header}.cuh"
    assert not (CSRC_DIR / name).exists()
    here = Path(__file__).resolve()
    files = [REPO / "chip_smoke.py"]
    for top in ("vr_video_generator_tpu_torch", "tests"):
        files += [p for p in (REPO / top).rglob("*")
                  if p.suffix in (".py", ".cu", ".cuh", ".h", ".cpp")
                  and "_build" not in p.parts and p.resolve() != here]
    assert len(files) > 50
    assert [str(p) for p in files if name in p.read_text()] == []


# --- (f) widths without an f32 kernel --------------------------------------------

@pytest.mark.parametrize("c,item", [(40, "head_tail_pallas.py:174"),
                                    (264, "head_tail_pallas.py:174")])
def test_f32_width_without_kernel_raises_not_ported(monkeypatch, c, item):
    """(f) head_tail and head_tail_stages on f32 path1 on the card at C =
    40 or 264 (C2 no multiple of 8: the JAX kernel asserts, so no row 15
    kernel takes them at any dtype) raise ValueError naming the JAX assert,
    before any weight is split or kernel launched."""
    monkeypatch.setattr(ht, "on_cuda", lambda *t: True)
    monkeypatch.setattr(ht, "_prepared", lambda *a: pytest.fail("prepared"))
    x, *wts = base_case(c, 5, 7, seed=c)
    for fn in (ht.head_tail, ht.head_tail_stages):
        with pytest.raises(ValueError, match=item):
            fn(x, *wts, (8, 12))
