"""PyTorch port, kernel 1's launch plan (rows 2 and 17 at any head dim but
64): g++ builds csrc/attention_any_plan.cuh as it is and its plan is held,
for every head dim from 1 to 1024 at bf16 and f32, to the card's budgets
(shared memory a block <= 232,448 bytes, registers an SM <= 65,536), to the
padding rules (DP the head dim rounded up to a chunk of 64 bf16 or 32 f32),
to an instantiation of the kernel templates in csrc/attention_any.cu and
csrc/attention_any_f32.cu, and to ops/attention.py's scratch sizes. Needs
g++."""

import ctypes
import re
import shutil
import subprocess

import pytest

from vr_video_generator_tpu_torch.kernels.build import CSRC_DIR
from vr_video_generator_tpu_torch.ops import attention as attn_ops

FIELDS = ("c", "qg", "g", "oc", "cb", "bn", "sc", "stages", "pw", "dp",
          "threads", "consumers", "thread_regs", "block_regs", "smem_bytes",
          "q_bytes", "stage_bytes", "resident")
UNIT = """#include "attention_any_plan.cuh"
extern "C" void plan_of(int d, int f32, int* out) {
  const attn_any::Plan p = attn_any::plan(d, f32);
  const int v[] = {p.c, p.qg, p.g, p.oc, p.cb, p.bn, p.sc, p.stages, p.pw,
                   p.dp(), p.threads(), p.consumers(), p.thread_regs(),
                   p.block_regs(), p.smem_bytes(), p.q_bytes(),
                   p.stage_bytes(), p.resident()};
  for (int i = 0; i < (int)(sizeof v / sizeof v[0]); ++i) out[i] = v[i];
}
extern "C" double flop_multiple(int d, int f32) {
  return attn_any::plan(d, f32).flop_multiple(d);
}
extern "C" int limit(int which) {
  return which == 0 ? attn_any::SMEM_LIMIT : attn_any::REG_LIMIT;
}
"""
DTYPES = {"bf16": 0, "f32": 1}
HEAD_DIMS = range(1, 1025)


@pytest.fixture(scope="module")
def plan_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build csrc/attention_any_plan.cuh")
    tmp = tmp_path_factory.mktemp("attention_any_plan")
    (tmp / "unit.cpp").write_text(UNIT)
    so = tmp / "libplan.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", f"-I{CSRC_DIR}",
         str(tmp / "unit.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    lib.plan_of.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.plan_of.restype = None
    lib.flop_multiple.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flop_multiple.restype = ctypes.c_double
    lib.limit.argtypes = [ctypes.c_int]
    lib.limit.restype = ctypes.c_int
    return lib


def plan(lib, d: int, f32: int) -> dict:
    """The header's plan of head dim ``d`` as a dict of FIELDS."""
    out = (ctypes.c_int * len(FIELDS))()
    lib.plan_of(d, f32, out)
    return dict(zip(FIELDS, out))


def instantiations(source: str) -> dict:
    """The (qg, g, oc, bn, resident, producer warp) tuples a source's
    dispatch instantiates (its VRVG_ANY(...) lines), each with the most
    chunks a stage of S may hold there (bf16's unrolled chunk loop; f32
    walks two at a time, any number, and always has a producer warp)."""
    text = (CSRC_DIR / source).read_text()
    found = re.findall(r"^\s*VRVG_ANY\((\d+), (\d+), (\d+), (\d+), "
                       r"(true|false)(?:, (\d+), (true|false))?\)\s*$",
                       text, flags=re.M)
    return {(int(a), int(b), int(c), int(d), e == "true", pw != "false"):
            int(kc) if kc else 10 ** 9 for a, b, c, d, e, kc, pw in found}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_fits_the_card_at_every_head_dim(plan_lib, dtype):
    """Shared memory <= 232,448 bytes a block and registers <= 65,536 an SM
    (255 a thread with two consumer warpgroups, 168 with two and a producer
    warp or three, which never take one), at least two stages, at most
    three consumer warpgroups, the header's limits the card's."""
    assert plan_lib.limit(0) == 232448 and plan_lib.limit(1) == 65536
    for d in HEAD_DIMS:
        p = plan(plan_lib, d, DTYPES[dtype])
        assert p["smem_bytes"] <= 232448, (d, p)
        assert p["block_regs"] <= 65536, (d, p)
        assert p["stages"] >= 2, (d, p)
        assert 1 <= p["consumers"] <= 3, (d, p)
        assert p["threads"] == 128 * p["consumers"] + 32 * p["pw"], (d, p)
        assert p["thread_regs"] == (168 if p["pw"] or p["consumers"] == 3
                                    else 255), (d, p)
        assert not (p["pw"] and p["consumers"] == 3), (d, p)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_pads_and_covers_the_head_dim(plan_lib, dtype):
    """DP is the head dim rounded up to a chunk (64 bf16 or 32 f32); the
    column blocks' g * oc chunks cover DP with less than one block's
    columns to spare; the key tile is a multiple of the P V k-step and at
    most 128; Q is resident exactly where sc == c, else a slab is 4 chunks
    (bf16) or 2 (f32); O (and at f32 its P V sum) fits a consumer's
    registers."""
    chunk = 32 if DTYPES[dtype] else 64
    for d in HEAD_DIMS:
        p = plan(plan_lib, d, DTYPES[dtype])
        assert p["dp"] == -(-d // chunk) * chunk == p["c"] * chunk, (d, p)
        cols = p["g"] * p["oc"]
        assert p["cb"] * cols >= p["c"] > (p["cb"] - 1) * cols, (d, p)
        assert p["bn"] in ((32, 64) if DTYPES[dtype] else (64, 128))
        assert p["resident"] == (p["sc"] == p["c"]), (d, p)
        if not p["resident"]:
            assert p["sc"] == (2 if DTYPES[dtype] else 4), (d, p)
            assert p["q_bytes"] == 0
        # bf16 O, or f32 O and its P V sum: 32 oc registers a thread.
        assert 32 * p["oc"] <= 128, (d, p)


@pytest.mark.parametrize("dtype,source", [("bf16", "attention_any.cu"),
                                          ("f32", "attention_any_f32.cu")])
def test_every_plan_has_an_instantiation(plan_lib, dtype, source):
    """Each head dim's (qg, g, oc, bn, resident) is one of the source's
    VRVG_ANY instantiations, its stage of S within the chunks that
    instantiation unrolls, and each instantiation serves a head dim: no
    head dim reaches the dispatch's cudaErrorInvalidValue."""
    inst = instantiations(source)
    used = set()
    for d in HEAD_DIMS:
        p = plan(plan_lib, d, DTYPES[dtype])
        key = (p["qg"], p["g"], p["oc"], p["bn"], bool(p["resident"]),
               bool(p["pw"]))
        assert key in inst, (d, key, inst)
        assert p["sc"] <= inst[key], (d, p, inst[key])
        used.add(key)
    assert used == set(inst)


# The plans chip_smoke.py's head dims run (PERF.md): (dtype, d) -> (qg, g,
# oc, cb, bn, resident, stages, producer warp) and the FLOP multiple.
PINNED = {
    ("bf16", 32): ((3, 1, 1, 1, 128, 1, 8, 0), 2.0),
    ("bf16", 128): ((2, 1, 2, 1, 128, 1, 6, 1), 1.0),
    ("bf16", 384): ((1, 2, 3, 1, 64, 1, 3, 1), 1.5),
    ("bf16", 512): ((1, 2, 4, 1, 64, 1, 2, 0), 1.5),
    ("f32", 32): ((2, 1, 1, 1, 64, 1, 8, 1), 1.0),
    ("f32", 128): ((2, 1, 4, 1, 32, 1, 3, 1), 1.0),
    ("f32", 384): ((1, 2, 4, 2, 32, 0, 3, 1), 8 / 3),
    ("f32", 512): ((1, 2, 4, 2, 32, 0, 3, 1), 2.5),
}


@pytest.mark.parametrize("key", list(PINNED), ids=[f"{k[0]}-{k[1]}"
                                                   for k in PINNED])
def test_plans_of_the_measured_head_dims(plan_lib, key):
    """The plans behind PERF.md's kernel-1 rows, and their FLOP multiple
    (products done against the useful 4 N^2 Dh)."""
    dtype, d = key
    p = plan(plan_lib, d, DTYPES[dtype])
    want, multiple = PINNED[key]
    assert (p["qg"], p["g"], p["oc"], p["cb"], p["bn"], p["resident"],
            p["stages"], p["pw"]) == want
    assert plan_lib.flop_multiple(d, DTYPES[dtype]) == pytest.approx(multiple)


def test_f32_scratch_matches_the_plan(plan_lib):
    """ops/attention.f32_scratch_numel at every head dim but 64 is the split
    pass's six planes at the plan's DP and N rounded up to 128 (what
    csrc/attention_any_f32.cu hands the split pass and its tensor maps)."""
    for d in HEAD_DIMS:
        if d == 64:
            continue
        dp = plan(plan_lib, d, 1)["dp"]
        for n in (1, 127, 128, 333):
            npad = -(-n // 128) * 128
            assert attn_ops.f32_scratch_numel(2, n, 3, d) == \
                6 * 2 * 3 * npad * dp, (d, n)
