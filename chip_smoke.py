#!/usr/bin/env python3
"""Smoke test of the PyTorch port (vr_video_generator_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py [--verbose-build]

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ with nvcc (one process per source,
     all started together);
  3. each of the seventeen kernels against its plain PyTorch version on the
     card at its path's shapes (1080p; vits, batch 8; vitl, batch 8 at
     --input_size 518 and batch 2 at 728; vitg, batch 8 at 518), with
     CUDA-event timings of both, of one PyTorch library call where one
     computes the same function, and the least time the card could take
     (bound); row 1 also at vitl-728's (38280, 1024) and vitg-518's (19544,
     1536) rows; row 9 also at vitl-728's batch of 8 (M = 38280), and each
     stage of its chain against its plain version (the LN stage bit-exact
     against row 1); row 10 likewise stage by stage, and the device silu of
     its gate epilogue bit for bit against the plain one on every bf16
     input; row 8 stage by stage (the LN stage bit-exact against row 1)
     at vits' D = 384 and vitb's D = 768; rows 5 and 6 also at vitb-518's
     D = 768 and vitl-518's D = 1024; row 2 also at vitg-518's 24 heads; rows 11 and 12 stage by
     stage (the upsample and resize passes bit for bit, conv1 by the dense
     kernels' bounds, conv2 with its 1x1 by the tail bounds) and also at
     vitl-728's grid; row 7 stage by stage the same way (its out_conv mix
     and conv1 by the dense kernels' bounds) at vits' C=64; the DPT tail
     kernels at the widths vitg, vitl and vitb add (the big-C tail at
     C=384, the ext tail stage by stage at C=128, 256 and 384, and at C=32
     the older ext chain); the packed blur/select and the banded
     compositor bit-exact (the banded one also
     against the classic kernel, and a 4K frame, past its 126 shifts,
     through the classic kernel); the single-kernel tail and the RCU pair at
     vits' and vitb's widths (the tail stage by stage: conv1 by the dense
     kernels' bounds, the resize pass bit for bit, conv2 with the 1x1 by the
     tail bounds; each of the RCU pair's four conv calls alone, conv2a's
     ReLU copy bit for bit), and the chain RCU pair -> ext tail;
  4. the main paths through ``runtime.segment.process_segment`` with bf16
     and seeded random weights (``--preprocess auto``: folded; the f32
     references exact), each with the launch counts reset just
     before it and read just after, each required to launch exactly its
     kernels: vits fused (``--mlp_fused fused --tail fused``, 3 batches of 8
     random 1080x1920 frames, no host sync in a step, the output held
     against the input, the plain warp and the plain versions' depth;
     rows 3, 4, 13 and 14 held bit for bit and timed, kernel-only, on
     that step's own depth),
     slice 1's unfused path (``xla``/``xla``, 1 batch) and one batch of the
     default ``auto`` path; Depth-Anything-V2-Base (vitb) ``auto`` at
     --input_size 518 (1 batch of 8: row 8 at D = 768, the ext tail at
     C=128; the same checks as vits fused, and each kernel's launches in the
     step counted); then Depth-Anything-V2-Large (vitl) fused at
     --input_size 518 (2 batches of 8, the same checks) and ``auto`` at 728
     (1 batch of 2: the attention half unfused past 4096 tokens, through
     the flash kernel), and ``auto`` at 252 (1 batch of 8: the ext tail at
     C=256); then DINOv2-giant (vitg, SwiGLU) ``auto`` at 518 (1 batch of 8,
     the same checks as vits fused) and at 126 (1 batch of 8: the ext tail
     at C=384); vits ``auto`` with ``--sbs_output packed --warp_impl
     pallas`` (1 batch of 8: the packed blur/select kernel in the u8 one's
     place, its unpacked frames equal to the u8 path's bit for bit); and
     the entry points no CLI path calls, as a user would call them (the
     banded compositor at 1080p, batch 8; the single-kernel tail and the
     RCU pair -> ext tail at vits' shapes), each launching exactly its
     kernels;
  5. ``SbsPipeline.step_many`` as a CUDA graph at vits ``auto`` (1080p,
     batch 8, k = 3): bit for bit against three eager steps, SBS and state,
     on two calls, the second replayed on fresh frames without a new
     capture and leaving the first call's outputs intact; its launches per
     replay 3 times one eager step's; ``process_segment`` over 40 frames
     writing the same bytes at ``--chunk_batches`` 3 and 1; a
     ``utils.profiling.trace`` of a replay; and the port's ``bench
     --config 2 --chunk_batches 4`` once, cut to 2 repeats, its JSON line
     printed;
  6. ``--depth_stride`` at vits ``auto`` (1080p, batch 8, input 518, bf16,
     the calibrated scaler): the stride-2 path through ``process_segment``
     (exactly its kernels launched, no host sync in a step, the right half
     the input, the SBS the plain warp of its own depth, the anchors' depth
     held against the plain versions and f32 with phase 4's bounds); the
     depth net at batch 4, 2 and 1 (strides 2, 4, 8) against the rows of
     batch 8 (phase 4's mean bound; whether each is bit-equal, and where
     not the first module that differs); ``step_audited`` equal to a
     stride-1 step bit for bit and its stats to ``stride_audit``'s, which
     leaves the state as it was; ``step_many`` at k = 3 equal to 3 eager
     steps, anchor_prev included; the adaptive segment loop over 48 frames
     at ``stride_max_rms`` 1e-30 (the stride-1 bytes) and 1e30 with a probe
     every 2 batches (the probe schedule's bytes), at ``chunk_batches`` 1
     and 3; ``convert_range`` over ranges off the stride grid equal to the
     full run's frames; and the port's ``bench --config 2 --depth_stride
     2`` once, cut to 2 repeats, its JSON line printed;
  7. ``--gelu tanh`` and the data axis: (a) the tanh GELU of rows 8 and
     9's fc1 epilogue bit for bit against ``gelu_tanh`` on all 65536 bf16
     inputs (``vrvg_gelu_tanh``); (b) rows 8 (D = 384, 768) and 9 (vitl-518's
     D = 1024) at ``approx`` stage by stage against their plain versions,
     the GELU stage bit for bit through a selection fc1, each timed beside
     the exact chain; (c) one batch of vitb-518 ``--gelu tanh --mlp_fused
     auto`` through ``process_segment`` with phase 4's checks (row 8's tanh
     variant in the exact one's place) and one of vitl-518 ``--gelu tanh``
     (row 9's); (d) ``ShardedSbsPipeline`` at a 1 x 1 mesh (vits ``auto``,
     1080p, B = 8): three steps' SBS and state equal to ``SbsPipeline
     .step``'s bit for bit; (e) the same at two slots on one card, each slot
     against its own ``SbsPipeline``, at depth_stride 1 and 2, with the host
     ms of one sharded step's dispatch (graphs and eager); (f) ``cli.main``
     with ``--mesh 1x1`` on a 1080p mp4 equal to the run without it, and
     ``check_and_repair`` of a lost subclip with the mesh equal to the full
     run's; (g) ``bench --sharded 1x1 --config 2`` once, cut to 2 repeats,
     its JSON line printed;
  8. f32 on the card (``--compute_dtype float32``): (a) the f32 kernels of
     rows 1 (at vits', vitl-728's and vitg-518's rows), 5 and 6 (D = 384
     and vitb's 768), 2 (vits' shapes and vitg-518's 24 heads), 17
     (vitl-728's), 8 (D = 128, 384), 9 (D = 768, 1024) and 10 (vitg-518's
     (19544, 1536), hidden 4096) stage by stage, 17 also at 24 heads
     (vitg-728's), 7 (C = 32 and 64 at vits', 128 at vitb-252's, 256 and
     384 at the 126 grid, 384 at vitg-56's), 11 + 12 (C = 64 at vits-728's
     grid, 128 at vitb-518's, 256 at vitl-252's, 384 at vitg-126's), 15
     (C = 32, 64, 128 on path1 at vits' grid) and 16 (C = 64, 128 on
     refinenet1's grid, each conv call alone) stage by stage (at C = 32
     conv2's sums through ``conv3x3_f32`` on the chains' zero padding),
     against their plain versions with both
     TF32 flags off (the products of rows 8-12, on the 3xTF32 core, against
     the plain versions on f64 operands: rows 11 + 12's conv1 and conv2
     before its 1x1, the latter through ``conv3x3_f32``), each bound shown
     to refuse the TF32 result of the same operands, timed beside the plain version, one library call
     (F.layer_norm, cuBLAS SGEMM, SDPA, cuDNN's convs, all f32) and the f32
     bound (165 TFLOP/s: 3xTF32 on the tensor cores); the GELU of rows 8
     and 9's f32 fc1 epilogue bit for bit against the eager f32 chain
     through a selection fc1 (every bf16 value, a dense sweep, the flush
     near -5.7), and the silu of row
     10's f32 gate epilogue against the plain f32 silu_mul through a
     selection w12 (every bf16 value, a dense sweep past the overflow of
     exp(-x1)); with PyTorch's
     default TF32 flags (cuDNN's on): (b) vits ``auto`` at f32 through
     ``process_segment`` (1 batch of 8): TF32 off inside the forward and
     restored after, exactly the f32 kernels a step (16, 12, 12, 12 and 1),
     none of their plain versions, no host sync in a step, the right half
     the input, the SBS the plain warp of its own depth, ``step_many`` (k =
     2) bit for bit equal to two steps, and the depth against a plain f64
     forward at most 2x the plain f32 path's error; (b') vitb-518 ``auto``
     at f32 at full width (12 blocks, B = 8) with the same checks, its
     launches (rows 1, 5, 2, 6, 9, 11 + 12, 3, 4: 4, 12, 12, 12, 12, 1, 1,
     1) and its depth against f64 at most 1.25x the plain f32 path's;
     (b'') vitg-518 ``auto`` at f32 at full width and depth (40 blocks, B =
     8) with the same checks and ``step_many``: rows 1, 2, 10, 3, 4 (44,
     40, 40, 1, 1 a step), its depth against f64 at most 1.25x the plain
     f32 path's; (c'') vitg-126 ``fused`` at f32 on the same weights, one
     batch: row 10 and rows 11 + 12 at C = 384; (c''') rows 15 and 16 at
     f32 called as a user calls them at C = 64 and 128, and row 15 at C =
     32, exactly their kernels, and row 15 again on the same weights, which
     splits none; (c4) the f32 CLI paths not run before, one batch each,
     exactly their kernels, none of the plain versions, the depth against
     the plain f32 path: a 32-feature vits-518 head ``auto`` (row 7 at C =
     32 once a step, the head's cuDNN output convs not run), vitg-728
     ``auto`` (4 blocks, batch 2: row 17 at 24 heads), vitl-126 and
     vitg-56 ``auto`` (4 blocks: row 7 at C = 256 and 384), vits-728
     ``auto`` (rows 11 + 12 at C = 64) and vitl-252 ``auto`` (4 blocks:
     rows 11 + 12 at C = 256); (c)
     vitl-518, vitg-518 and vitl-728 ``xla``/``xla`` at f32 (4 blocks,
     batch 2) through rows 1 and 2, or 1 and 17; (c') vits ``fused`` (row
     8), vitb-252 ``auto`` (row 7 at C = 128) and vitl-518 ``auto`` (4
     blocks, batch 2: row 9, the attention half and the tail unfused) at
     f32, one batch each, exactly their kernels; (d) ``cli.main
     --compute_dtype float32`` plainly, with ``--mesh 1x1``, with
     ``--depth_stride 2``, with ``--encoder vitb`` and with ``--encoder
     vitg --input_size 126`` on a 1080p mp4; (e)
     ``bench --config 2`` and ``--config 3`` at ``--compute_dtype float32``
     once each, their lines printed;
  9. the records' tools: (a) the ``scan`` warp at 1080p, B = 8, on a vits
     ``auto`` step's depth, bit for bit against the pallas kernels' SBS and
     the xla plain warp's on the card; (b) ``soak.device_soak`` for 400
     frames at vits 1080p on a ``soak_gen`` source, passing its memory
     rule, its memory series printed; (c) ``parity_report``'s gate at 480 x
     854, 2 frames, f32 on the card, ``--spread_depth``, passing;
 10. the model axis on one card (``[cuda:0] * M``): (a) rows 2 and 17 at
     the heads a model-group rank runs (row 17 at vitl-728's 8 and 4, row
     2 at vitl-518's 8 and 4, vitg-518's 12, and 1 and 2 at vits' and
     vitb's uneven splits) against their plain versions, timed as in phase
     3; (b) one batch of 1080p ``soak_gen`` frames through
     ``ShardedSbsPipeline`` at vitl-728 ``auto`` (B = 2) at 1 x 2 and 1 x 4,
     vitl-518 ``--mlp_fused xla`` at 1 x 2 and 1 x 4, vitg-518 ``auto`` at
     1 x 2, f32 vitl-518 ``auto`` (B = 2) at 1 x 2, vits-518 ``--mlp_fused
     xla`` at 1 x 4 and 1 x 8 (ranks of 1 and 2 heads, and of none),
     vits-518 ``auto`` at 1 x 4 and vitb-518 ``--mlp_fused xla`` at 1 x 8
     (4 blocks), each with its launch counts reset just before the group's
     step and read just after (exactly the blocks' kernels on every rank,
     a split attention once a rank that holds heads), its depth and
     SBS against the 1 x 1 pipeline's at equal batch (bf16: within 1.25x
     the 1 x 1 kernel path's own error against its plain versions on the
     same weights and frames, the SBS within parity_report's gate; f32:
     within 1e-5 of the range), and the host ms of one group step's
     dispatch beside the 1 x 1 step's; (c) ``cli.main --mesh 1x2`` and
     ``--mesh 1x4 --encoder vits`` with ``--device cuda:0`` over a 24-frame
     1080p mp4 whose subclips check;
 11. the front ends, on stand-in checkpoints saved from the port's seeded
     state_dict at full width: (a) ``real_weights_runbook`` at configs 2
     and 3 (vits, vitb; 1080p, input 518, 2 frames), the final head conv
     amplified, its parity step at f32: every row calibrated onto the
     target, under the step cap, depth_ok and passing; (b) the same at its
     default bf16, config 2: the golden checks, and the parity gate or the
     in-run yardstick (1.25 x the plain bf16 path's fraction against the
     same oracle); (c) ``ui.tkapp.FormModel`` on a 24-frame 1080p mp4 with
     the un-amplified vits: Run (the CLI, on the card by default) gives
     subclips 0_5 .. 18_23 and the combined output, Verify is clean, names a
     truncated subclip with its repair range, and is clean after Repair;
     the launches of the runbook's and the form's processes counted
     (``kernels.COUNTS_DIR_ENV``), each exactly its path's kernels;
 12. the encoder at every width the JAX package takes (custom ModelConfigs,
     built as a library user builds them: models/factory, then
     SbsPipeline): (a) kernel 1 (rows 2 and 17 at head dims other than 64:
     ``csrc/attention_any.cu`` at bf16 on wgmma, ``csrc/attention_any_f32
     .cu`` at f32 on the 3xTF32 wgmma core) at head dims 16, 20 (through
     the pad pass), 32, 48, 128 and 256, one-shot at N = 2443 and flash at
     N = 4785, bf16 against the plain versions within rows 2 and 17's
     bounds, f32 against f64 operands within 3.7e-6 of max |o|, each f32
     bound refusing the TF32 result, each timed beside the plain version
     and SDPA; the built library's SASS holding HGMMA in every bf16 kernel
     1 and TF32 HGMMA in every f32 one; (b) rows
     5 and 6 at D = 512, 640 and 768 with 6 heads of 128, row 8 at D = 512,
     row 9 at D = 640 with hidden 2080 (zero-padded to 2112), row 10 at D
     = 1024 with hidden 2736, bf16 and f32, with phase 3's and phase 8's
     bounds; (c) one batch of each of the five configurations (WIDTH_PATHS:
     w512, hd128, hd32, r325, glu1024) at 1080p, B = 8, input 518, bf16
     ``auto``, hd32 also at 728 (B = 2), w512 and hd128 also at f32, with
     exactly their kernels a step, the weight splits at f32's first step,
     ``resolve_block_fusion`` and ``check_f32_plan`` raising nothing, and
     the depth against the plain path;
 13. the DPT tails at every width the JAX planners take (a custom head's
     features; the chains zero-padded to their kernels' widths): (a) row 7
     at bf16 C = 16, 48, 96, 144 on vits' 1080p/518 grid, 320 at 252's and
     528 at 126's, at f32 C = 16, 48 at 518 and 160 at 252; rows 11 + 12 at
     f32 C = 80, 96, 112 at 518 and 512 at 126, at bf16 C = 512, 640 at
     252 and 896 at 126; row 15 at C = 16, 96 and 256 at both dtypes on
     path1 at vits' grid (TAIL_CASES), each stage by stage against its
     plain version with phase 3's bf16 and phase 8's f32 bounds (the f32
     ones refusing the TF32 result), timed beside the plain version and
     cuDNN's two convs, the bound counted on the head's own C; bf16 row 7
     at C = 16 timed on the five-stage chain (C = 64) and on the wmma chain
     (C = 32); each width's wrapper, called as a user calls it, launching
     exactly its kernels; (b) four vits paths at full depth (12 blocks,
     1080p, B = 8, ``auto``) with a custom head, built through
     models/factory (TAIL_RUNS): 96 features at 518 bf16 (row 7 at C = 96)
     and f32 (rows 11 + 12 at C = 96), 48 at 518 f32 (row 7 at C = 48),
     512 at 252 bf16 (rows 11 + 12 at C = 512), each with exactly its
     kernels a step, the depth against the plain path (f32: and against a
     plain f64 forward);
 14. the last widths: (a) row 16 at C = 16, 96 (zero-padded to
     ``rcu_width``), 256 and 384 (unpadded), bf16 and f32, on refinenet1's
     1080p/518 grid (RCU_WIDTHS): each conv call alone and the chain
     against the plain version with phase 3's bf16 bounds and phase 8's f32
     bound against f64 operands (TF32 refused), timed beside the plain
     chain and cuDNN's four convs, the bound counted on the real C, the
     padding's share and the wrapper's padding copies timed; each width's
     wrapper, called as a user calls it, launching exactly its four convs;
     (b) kernel 1 above head dim 256 (WIDE_ATTN: row 2 at 320, 384 and 512,
     N = 2443, B = 8; row 17 at 384 and 512, N = 4785, B = 2; 2 heads),
     bf16 and f32, with phase 12's bounds, timed beside the plain version
     and SDPA, and row 17 at 320 past 4096 tokens refused before any launch
     (the library flash kernel's NotImplementedError); (c) the custom
     configurations hd384 (D = 768, 2 heads) and hd320 (D = 640, 2 heads),
     4 blocks, 1080p, ``auto`` (WIDE_RUNS): hd384 at 518 bf16 and f32 (row 2
     at head dim 384 in the fused attention half) and at 728 bf16 (B = 2,
     row 17 at 384), hd320 at 518 bf16, each with exactly its kernels a
     step and the depth against the plain path (f32: and against a plain
     f64 forward); hd320 at 728 raising the library's NotImplementedError
     before any launch of row 17.

It prints the per-kernel JSON line before the last line (row 1 three times:
at vits', vitl-728's and vitg-518's rows; row 2 twice: at vits' shapes and
at vitg-518's 24 heads; rows 5 and 6 three times: at D = 384, 768 and
1024; row 8
twice: at D = 384 and 768; row 9 twice: at M = 19544 and 38280; row 7 four
times: at vits' C=64, vitb's C=128, vitl-252's C=256 and vitg-126's C=384;
rows 11 and 12 three times: at vitl-518's, vitl-728's and vitg-518's
shapes; the tanh variants of rows 8 and 9 at vitb-518's D = 768 and
vitl-518's D = 1024, with the launches of phase 7's paths; the f32 kernels
of phase 8 with the launches of its paths: row 1 at f32 three times, rows
5 and 6 at f32 twice (D = 384, 768), row 9 at f32 twice (D = 768, 1024),
row 7 at f32 five times (C = 32, 64, 128, 256, and 384 at vitg-56's
grid), rows 11 + 12 at f32 four times (vits-728's C = 64, vitb's 128,
vitl-252's 256, vitg-126's 384), row 1 at f32 also at vitg-518's batch of
8, row 2 at f32 also at its 24 heads, row 17 at f32 also at vitg-728's 24
heads, row 10 at f32 once, row 15 at f32 three times (C = 32, 64, 128) and
row 16 twice (C = 64, 128); row 17 at 8 and 4 heads and row 2 at 8, 4, 12,
1 and 2 with the launches of phase 10's model-group paths; kernel 1 at
head dims 32 and 128 (row 2, bf16), 32 (row 17, bf16 and f32) and 128 (row
2, f32), and rows 5 and 6 at D = 512 and 640, row 8 at D = 512, row 9 at D
= 640 and row 10 at D = 1024, bf16, and rows 5, 6 and 8 at D = 512 at f32,
with the launches of phase 12's paths; rows 7, 11 + 12 and 15 at each of
phase 13's widths, the four paths' tails with those paths' launches, the
other widths with their wrapper calls'; row 16 at phase 14's widths, bf16
and f32, with their wrapper calls' launches, and kernel 1 at head dims
320, 384 and 512, those phase 14's paths run with the paths' launches,
the others with their one counted call), and
as the last line ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np

H, W, B = 1080, 1920, 8
N_TOK, DIM, HEADS = 2443, 384, 6  # 37 x 66 patches + cls at 1080p, vits
FEATURES, H0, W0 = 64, 148, 264   # refinenet1's pre-upsample grid, vits
OUT_HW = (518, 924)               # the depth net's size at --input_size 518
DIM_L, HEADS_L, FEATURES_L = 1024, 16, 256  # vitl, same grids at 518
DIM_G, HID_G, FEATURES_G = 1536, 4096, 384  # vitg (SwiGLU hidden), at 518
DIM_B, FEATURES_B = 768, 128  # vitb, same grids at 518
HEADS_G = 24
# refinenet1's grid and the net's size at 1080p with --input_size 126 (vitg,
# ext tail at C=384) and 252 (vitl, ext tail at C=256)
EXT_WIDE = {384: ((36, 64), (126, 224)), 256: ((72, 128), (252, 448))}
N_L728 = 4785  # 52 x 92 patches + cls at 1080p, vitl --input_size 728
GRID_L728, OUT_HW_L728 = (208, 368), (728, 1288)  # its tail's grid, depth
# vitl-728 runs 2 frames a batch (a cut from 8): the plain attention the
# kernels are held against materialises f32 logits per 512-key block, and
# the depth check runs the whole model three times.
B_L728 = 2
SEED = 0
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense): HBM bytes/s and
# bf16 tensor-core FLOP/s, for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# bf16 LayerNorm bound of the JAX package's tests (tests/test_layernorm.py).
LN_ATOL, LN_RTOL = 2e-2, 1e-2
# Row 1's rows: vits (every path), vitl-728's unfused attention half and
# vitg-518's, at batch 8.
LN_SHAPES = ((B * N_TOK, DIM), (B * N_L728, DIM_L), (B * N_TOK, DIM_G))
# Online rescaling and the bf16 probabilities reorder the rounding. The
# absolute bounds are those of the port's design; the relative ones hold the
# error to a small share of the output's own size (max against max |o|,
# mean against mean |o|). Rows 2 and 17 both; on an NVIDIA H100 80GB HBM3,
# 700.00 W, with 128-key tiles and ex2 of log2(e)-scaled logits: row 2
# max 2.5e-3 and mean 1.15e-3 of |o| (2.1e-3 and 1.15e-3 at 24 heads), row
# 17 (against the library's 512-key order at vitl-728) max 3.8e-3 and mean
# 5.3e-4; the earlier 64-key wmma kernel measured 1.9e-3 and 5.8e-4 there.
ATTN_MAX_ABS, ATTN_MEAN_ABS = 2e-2, 1e-3
ATTN_MAX_REL, ATTN_MEAN_REL = 2e-2, 5e-3
# The dense kernels (rows 5, 6, 8) against their plain versions, both bf16
# at the same rounding points: their f32 sums (the LayerNorm's and the
# GEMM's) run in another order, so an output differs only where an f32 value
# sits at a bf16 rounding boundary. Bounds: the fraction of outputs that
# differ at all, and the largest difference in bf16 ulps of the output's
# scale: the larger of the output, the operands of its final sums (bias,
# residual, the product they were added to) and the RMS of its output
# feature. The feature's RMS stands for the dot product's terms: one ulp of
# a LayerNorm output moves a product by ~1e-3 whatever the product's own
# size, so a product near zero would count that as many of its own ulps.
# Measured at these shapes (NVIDIA H100 80GB HBM3, 700.00 W): ln_qkv 1.5e-4
# of outputs differ, by at most 2 ulps; proj_ls_residual none; mlp_residual
# 3.4e-4, 2 ulps. The bounds leave 15x (fraction) and 2x (ulps) of margin.
# A copy of ln_qkv that
# adds the bias before the cast moved 0.306 of its outputs and was refused
# (python3 -m vr_video_generator_tpu_torch.bias_order_check).
# Row 9 at vitl-518 sums 4096 hidden products per output (4x row 8's
# reach): 3.1e-3 of outputs differ, by at most 4 ulps; row 11's bf16
# conv1 products: 1.3e-3, 1 ulp (same card). Their bounds leave ~3x
# (fraction) and 2x (ulps) of margin. Row 10 at vitg-518 (two products over
# K = 1536 and 4096 around the bf16 silu chain): 1.2e-3 of outputs differ,
# by at most 3 ulps, under row 9's bounds (8x and 2.7x of margin); row 11 at
# vitg's C=384: 2.0e-3, 1 ulp (same card; 2.5x and 4x). Row 7's stages on
# the same cores, its out_conv mix (K = C) and its conv1 (K = 9 C, the f32
# bias added before the cast), are held to row 11's conv1 bounds.
# Row 16, the RCU pair, is four launches of one 3x3 conv (576 or 1152
# products an output) with bf16 between them: each launch is held alone to
# row 9's bounds. Chained, a one-ulp flip of an intermediate moves the next
# conv's sums, so 1.1% (C=64, vits 1080p) to 4.6% (C=128) of the chain's
# outputs differ from the plain chain's, by at most 3 ulps (NVIDIA H100 80GB
# HBM3, 700.00 W); the chain is held instead by its error against the same
# chain in f32, at most RCU_F32_FLOOR times the plain bf16 chain's, as the
# depth is (DEPTH_FLOOR).
# Row 9's chain is held stage by stage too: its two GEMM stages
# (mlp_fc1_gelu, K = 1024 under the GELU; mlp_fc2_residual, K = 4096) each
# on the chain's own input, to row 9's bounds; and so is row 10's
# (swiglu_gate, K = 1536 under the bf16 silu chain; swiglu_down, K = 4096).
# Row 8 runs row 9's chain at D = 384 and 768 and is held the same way: its
# stages to those bounds, the whole at both widths to row 8's (mlp_residual;
# at D = 768, 5.8e-4 of outputs differ, by at most 3 ulps, NVIDIA H100 80GB
# HBM3, 700.00 W).
GEMM_MAX_FRAC = {"ln_qkv": 0.005, "proj_ls_residual": 0.005,
                 "mlp_residual": 0.005,
                 "mlp_residual_hblocked": 0.01,
                 "mlp_fc1_gelu": 0.01, "mlp_fc2_residual": 0.01,
                 "swiglu_residual": 0.01, "swiglu_gate": 0.01,
                 "swiglu_down": 0.01, "head_tail_big_front": 0.005,
                 "head_tail_ext_mix": 0.005, "head_tail_ext_conv1": 0.005,
                 "head_tail_conv1": 0.005, "rcu_pair": 0.01}
GEMM_MAX_ULPS = {"ln_qkv": 4, "proj_ls_residual": 4, "mlp_residual": 4,
                 "mlp_residual_hblocked": 8,
                 "mlp_fc1_gelu": 8,
                 "mlp_fc2_residual": 8, "swiglu_residual": 8,
                 "swiglu_gate": 8, "swiglu_down": 8,
                 "head_tail_big_front": 4, "head_tail_ext_mix": 4,
                 "head_tail_ext_conv1": 4, "head_tail_conv1": 4,
                 "rcu_pair": 8}
# The DPT tail's f32 depth against its plain version, relative to the
# output's range: a one-ulp flip of a bf16 intermediate moves single pixels
# (measured on an NVIDIA H100 80GB HBM3, 700.00 W: row 7 max 1.7e-3, mean
# 1.5e-6 of the range; row 12 on the plain front's output max 1.4e-6, mean
# 1.5e-7; rows 11 + 12 chained max 6.2e-4, mean 5.0e-6; at vitg's C=384
# row 12 max 1.9e-6, mean 2.4e-7, chained max 7.3e-4, mean 9.8e-6; row 7 at
# C=256 and 384 max 9.8e-4 and 1.1e-3, mean 1.1e-5 and 2.1e-5). Row 11
# alone is held as the dense kernels are (GEMM_MAX_FRAC, GEMM_MAX_ULPS).
TAIL_MAX_REL, TAIL_MEAN_REL = 1e-2, 1e-4
# Depth through the kernels against the plain versions. A random-weight
# 12-block ViT amplifies any one-ulp bf16 difference: on the H100 the plain
# bf16 path itself is up to ~3.8% of the depth range off the same weights in
# f32 at single pixels, while its mean error is ~0.4%. So the 2% bound holds
# the mean error, and the kernel path's error against f32 may be at most
# DEPTH_FLOOR times the plain bf16 path's, in max and in mean.
# vitl's 24 blocks hold to the same bounds (NVIDIA H100 80GB HBM3, 700.00
# W): at 518 the kernel path's error against f32 is max 0.745 against the
# plain bf16 path's 0.707 and mean 0.0523 against 0.0530; at 728, 0.612
# against 0.602 and 0.0494 against 0.0496; kernel against plain mean 0.39%
# and 0.30% of the range. So do vitg's 40 SwiGLU blocks at 518 (same card):
# max 0.444 against 0.497, mean 1.42e-4 against 1.51e-4; kernel against
# plain mean 0.001% of the range. With ``--preprocess auto`` folded on both
# bf16 paths (the f32 reference exact), the plain bf16 path's mean error
# against f32 rose to 0.252 (2.0% of the range) at vits, 0.165 at vitl-518,
# 0.095 at vitl-728 and 2.8e-4 at vitg-518, and the kernel path's stayed at
# 1.00-1.02x it in mean and 0.98-1.11x in max (same card).
DEPTH_REL = 0.02
DEPTH_FLOOR = 1.25
RCU_F32_FLOOR = DEPTH_FLOOR
PKG = "vr_video_generator_tpu_torch"
JAX_PKG = "vr_video_generator_tpu"
KERNELS = {
    "layernorm": ("cuda", f"{PKG}/csrc/layernorm.cu",
                  f"{JAX_PKG}/ops/layernorm.py:33"),
    "attention": ("cuda", f"{PKG}/csrc/attention.cu",
                  f"{JAX_PKG}/ops/attention_pallas.py:43"),
    "warp_composite": ("cuda", f"{PKG}/csrc/warp.cu",
                       f"{JAX_PKG}/ops/warp_pallas.py:45"),
    "blur_select_sbs": ("cuda", f"{PKG}/csrc/blur_select.cu",
                        f"{JAX_PKG}/ops/warp_pallas.py:301"),
    "ln_qkv": ("cuda", f"{PKG}/csrc/qkv.cu",
               f"{JAX_PKG}/ops/qkv_pallas.py:59"),
    "proj_ls_residual": ("cuda", f"{PKG}/csrc/qkv.cu",
                         f"{JAX_PKG}/ops/qkv_pallas.py:137"),
    "mlp_residual": ("cuda", f"{PKG}/csrc/mlp_hblocked.cu",
                     f"{JAX_PKG}/ops/mlp_pallas.py:66"),
    "head_tail_ext": ("cuda", f"{PKG}/csrc/head_tail_big.cu",
                      f"{JAX_PKG}/ops/head_tail_pallas.py:254"),
    "mlp_residual_hblocked": ("cuda", f"{PKG}/csrc/mlp_hblocked.cu",
                              f"{JAX_PKG}/ops/mlp_pallas.py:38"),
    "head_tail_big_front": ("cuda", f"{PKG}/csrc/head_tail_big.cu",
                            f"{JAX_PKG}/ops/head_tail_pallas.py:480"),
    "head_tail_big_back": ("cuda", f"{PKG}/csrc/head_tail_big.cu",
                           f"{JAX_PKG}/ops/head_tail_pallas.py:570"),
    "flash_attention": ("cuda", f"{PKG}/csrc/attention.cu",
                        f"{JAX_PKG}/ops/attention.py:53"),
    "swiglu_residual": ("cuda", f"{PKG}/csrc/swiglu.cu",
                        f"{JAX_PKG}/ops/mlp_pallas.py:101"),
    "blur_select_sbs_packed": ("cuda", f"{PKG}/csrc/blur_select.cu",
                               f"{JAX_PKG}/ops/warp_pallas.py:389"),
    "warp_composite_banded": ("cuda", f"{PKG}/csrc/warp.cu",
                              f"{JAX_PKG}/ops/warp_pallas.py:89"),
    "head_tail": ("cuda", f"{PKG}/csrc/head_tail_big.cu",
                  f"{JAX_PKG}/ops/head_tail_pallas.py:90"),
    "rcu_pair": ("cuda", f"{PKG}/csrc/rcu_pair.cu",
                 f"{JAX_PKG}/attic/refinenet_pre.py:47"),
}
# The kernels each main path must launch, exactly. ``auto`` on the card at
# vits fuses the attention half and the tail, and keeps the MLP half unfused
# (D < 512). vitl-518 (``fused``; ``auto`` on the card resolves the same)
# runs LayerNorm only at the four final-norm taps, the fused attention half,
# the hidden-blocked MLP and the big-C tail; vitl-728 (``auto``, N = 4785 >
# 4096) runs the attention half unfused: LayerNorm, cuBLAS qkv and proj, and
# the flash kernel.
SLICE1 = ("layernorm", "attention", "warp_composite", "blur_select_sbs")
AUTO_VITS = SLICE1 + ("ln_qkv", "proj_ls_residual", "head_tail_ext")
FUSED_VITS = AUTO_VITS + ("mlp_residual",)
# vitb-518 (``auto``: D = 768 >= 512 fuses the MLP half) runs vits fused's
# kernels at D = 768 and 12 heads, the ext tail at C = 128; its launches in
# one step (12 blocks; LayerNorm at the four taps).
VITB_518 = FUSED_VITS
VITB_518_STEP = {"layernorm": 4, "ln_qkv": 12, "attention": 12,
                 "proj_ls_residual": 12, "mlp_residual": 12,
                 "head_tail_ext": 1, "warp_composite": 1,
                 "blur_select_sbs": 1}
BIG_TAIL = ("head_tail_big_front", "head_tail_big_back")
VITL_518 = SLICE1 + ("ln_qkv", "proj_ls_residual",
                     "mlp_residual_hblocked") + BIG_TAIL
VITL_728 = ("layernorm", "flash_attention", "mlp_residual_hblocked",
            "warp_composite", "blur_select_sbs") + BIG_TAIL
# vitl-252 (``auto``) is vitl-518 with the ext tail at C=256. vitg (``auto``)
# runs its attention half unfused at every size (its qkv weights exceed the
# JAX package's plan: LayerNorm, cuBLAS qkv and proj, the one-shot
# attention), the SwiGLU half-block kernel, and the big-C tail at 518 or the
# ext tail at 126.
VITL_252 = SLICE1 + ("ln_qkv", "proj_ls_residual", "mlp_residual_hblocked",
                     "head_tail_ext")
VITG = SLICE1 + ("swiglu_residual",)
VITG_518 = VITG + BIG_TAIL
VITG_126 = VITG + ("head_tail_ext",)
# vits auto with --sbs_output packed: the packed emit in the u8 one's place.
AUTO_VITS_PACKED = tuple(k for k in AUTO_VITS if k != "blur_select_sbs") \
    + ("blur_select_sbs_packed",)
# The entry points no CLI path calls (as in the JAX package): the banded
# compositor, the single-kernel tail, and the RCU pair feeding the ext tail.
OFF_CLI = ("warp_composite_banded", "head_tail", "rcu_pair", "head_tail_ext")
# --gelu tanh: rows 8 and 9 with the tanh GELU in fc1's epilogue, counted
# apart from the exact chains, in their place on vitb-518 and vitl-518.
TANH_KERNELS = {
    "mlp_residual_tanh": ("cuda", f"{PKG}/csrc/mlp_hblocked.cu",
                          f"{JAX_PKG}/ops/mlp_pallas.py:66"),
    "mlp_residual_hblocked_tanh": ("cuda", f"{PKG}/csrc/mlp_hblocked.cu",
                                   f"{JAX_PKG}/ops/mlp_pallas.py:38"),
}
VITB_518_TANH = tuple(k for k in VITB_518 if k != "mlp_residual") \
    + ("mlp_residual_tanh",)
VITB_518_TANH_STEP = {("mlp_residual_tanh" if k == "mlp_residual" else k): v
                      for k, v in VITB_518_STEP.items()}
VITL_518_TANH = tuple(k for k in VITL_518 if k != "mlp_residual_hblocked") \
    + ("mlp_residual_hblocked_tanh",)


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the tensor-core FLOPs over the bf16 peak."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def operand_ulps(got, want, feature_dims, *addends):
    """|got - want| in bf16 ulps of the output's scale: the largest of
    |want|, the RMS of its feature (over all but the last ``feature_dims``
    axes), each addend's magnitude (broadcast against the output) and what
    is left of want when the addends are taken off (the product the bias or
    the residual was added to)."""
    import torch

    w = want.float()
    lead = tuple(range(w.ndim - feature_dims))
    size = torch.maximum(w.abs(), w.square().mean(dim=lead).sqrt())
    rest = w
    for t in addends:
        size = torch.maximum(size, t.float().abs())
        rest = rest - t.float()
        size = torch.maximum(size, rest.abs())
    ulp = torch.exp2(torch.floor(torch.log2(size.clamp_min(2.0 ** -126))) - 7)
    return (got.float() - w).abs() / ulp


def gemm_addends(name: str, want, args):
    """What each dense kernel adds to its product, as operand_ulps takes
    them: the bias (scaled like q on q's columns) for ln_qkv; the residual x
    and gamma * bias for proj_ls_residual and the MLP and SwiGLU halves."""
    if name.startswith("head_tail_big_front"):
        return ()  # a bare conv sum, cast
    if name.startswith("head_tail_ext") or name == "head_tail_conv1":
        return tuple(args)  # the mix: none; conv1 (rows 7, 15): its f32 bias
    if name.startswith("rcu_pair"):
        return tuple(args)  # the conv's residuals
    if name == "mlp_fc1_gelu":
        return (args[0],)  # b1, which its product was added to
    if name == "swiglu_gate":
        return ()  # silu(x1 + b1) * (x2 + b2): no addend of the output
    if name in ("mlp_fc2_residual", "swiglu_down"):
        x, gamma, b = args
        return x, gamma.float() * b.float()
    if name == "ln_qkv":
        b, heads, scale = args[4], args[5], args[6]
        bias = b.float().reshape(3, heads, -1).clone()
        bias[0] *= scale
        return (bias,)
    x, gamma, b = (args[1], args[4], args[3]) if name == "proj_ls_residual" \
        else (args[0], args[7], args[6])
    return x, gamma.float() * b.float()


def gemm_check(name: str, got, want, args) -> dict:
    """Rows 5, 6, 8-11 and row 9's stages: the share of bf16 outputs that
    differ and the largest difference in ulps of the largest operand, each
    against its bound (``name`` may carry a width after a space)."""
    kernel = name.split()[0]
    ulps = operand_ulps(got, want, 3 if kernel == "ln_qkv" else 1,
                        *gemm_addends(kernel, want, args))
    stats = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                 max_ulps=ulps.max().item(),
                 frac_differ=(got != want).float().mean().item())
    require(stats["frac_differ"] <= GEMM_MAX_FRAC[kernel]
            and stats["max_ulps"] <= GEMM_MAX_ULPS[kernel],
            f"{name}: {json.dumps(stats)} over bounds: fraction "
            f"{GEMM_MAX_FRAC[kernel]}, ulps {GEMM_MAX_ULPS[kernel]}")
    return stats


def synthetic_depth(rng, device):
    """(B, H, W) depth: a left-to-right ramp over [0, 14] plus noise, so
    many shifts are live and the warp leaves holes."""
    import torch

    ramp = np.linspace(0.0, 14.0, W, dtype=np.float32)[None, None, :]
    noise = rng.normal(0.0, 0.4, (B, H, W)).astype(np.float32)
    return torch.from_numpy(np.clip(ramp + noise, 0.0, None)).to(device)


def randn(gen, shape, scale=1.0, shift=0.0, dtype=None):
    import torch

    t = torch.randn(shape, generator=gen, device=gen.device) * scale + shift
    return t.to(dtype) if dtype is not None else t


def check_ln_qkv(device, d: int = DIM) -> dict:
    """Row 5 at a main path's shapes: vits' (D = 384, 6 heads), vitb-518's
    (D = 768, 12 heads) or vitl-518's (D = 1024, 16 heads), batch 8 at
    1080p. Module-level so a deliberately broken copy of the kernel can be
    held against the same check."""
    import torch

    from vr_video_generator_tpu_torch.ops.qkv import ln_qkv, ln_qkv_plain
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    # vits' inputs come from the seed they always had; vitl's and vitb's
    # from their own.
    gen = torch.Generator(device=device).manual_seed(
        {DIM: SEED + 5, DIM_L: SEED + 50, DIM_B: SEED + 70}[d])
    bf = torch.bfloat16
    x = randn(gen, (B, N_TOK, d), dtype=bf)
    lnw, lnb = randn(gen, (d,), 0.1, 1.0), randn(gen, (d,), 0.1)
    w = randn(gen, (3 * d, d), d ** -0.5, dtype=bf)
    b = randn(gen, (3 * d,), 0.5, dtype=bf)
    args = (x, lnw, lnb, w, b, d // 64, 64 ** -0.5)
    got, want = ln_qkv(*args), ln_qkv_plain(*args)
    torch.cuda.synchronize()
    stats = gemm_check(f"ln_qkv D={d}", got, want, args)
    m = B * N_TOK
    return dict(**stats, ms=event_ms(lambda: ln_qkv(*args)),
                plain_ms=event_ms(lambda: ln_qkv_plain(*args)),
                library_ms=None,
                **bound(nbytes(x, lnw, lnb, w, b, got), 2 * m * d * 3 * d))


def check_proj(gen, d: int):
    """Row 6 at a main path's shapes: vits' (D = 384), vitb-518's (D = 768)
    or vitl-518's (D = 1024), batch 8 at 1080p, on inputs drawn from ``gen``: its statistics,
    times and bound, and the inputs (o, x, w, b, gamma)."""
    import torch

    from vr_video_generator_tpu_torch.ops.qkv import (proj_ls_residual,
                                                       proj_ls_residual_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    bf = torch.bfloat16
    o = randn(gen, (B, N_TOK, d // 64, 64), dtype=bf)
    xr = randn(gen, (B, N_TOK, d), dtype=bf)
    wp = randn(gen, (d, d), d ** -0.5, dtype=bf)
    bp = randn(gen, (d,), 0.5, dtype=bf)
    gp = randn(gen, (d,), 0.1, 1.0, dtype=bf)
    args = (o, xr, wp, bp, gp)
    got, want = proj_ls_residual(*args), proj_ls_residual_plain(*args)
    torch.cuda.synchronize()
    return dict(**gemm_check(f"proj_ls_residual D={d}", got, want, args),
                ms=event_ms(lambda: proj_ls_residual(*args)),
                plain_ms=event_ms(lambda: proj_ls_residual_plain(*args)),
                library_ms=None,
                **bound(nbytes(*args, got), 2 * B * N_TOK * d * d)), args


def check_layernorm(gen, rows: int, d: int) -> dict:
    """Row 1 on (rows, d) seeded bf16 rows with an f32 affine: every output
    within the JAX package's LayerNorm bound (LN_ATOL, LN_RTOL) of the plain
    version, the share of outputs that differ and the largest difference in
    ulps (as the dense rows are measured), times of the kernel, the plain
    version and one F.layer_norm call, and the bound."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops.layernorm import (layernorm,
                                                             layernorm_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    bf = torch.bfloat16
    x = torch.randn(rows, d, generator=gen, device=gen.device).to(bf)
    w = torch.randn(d, generator=gen, device=gen.device)
    b = torch.randn(d, generator=gen, device=gen.device)
    got, want = layernorm(x, w, b), layernorm_plain(x, w, b)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    require(bool((err <= LN_ATOL + LN_RTOL * want.float().abs()).all()),
            f"layernorm D={d}: max abs err {err.max().item()} over "
            f"atol {LN_ATOL} + rtol {LN_RTOL}")
    # The library call takes its affine in the input's dtype.
    wb, bb = w.to(bf), b.to(bf)
    return dict(
        max_abs_err=err.max().item(),
        max_ulps=operand_ulps(got, want, 1).max().item(),
        frac_differ=(got != want).float().mean().item(),
        ms=event_ms(lambda: layernorm(x, w, b)),
        plain_ms=event_ms(lambda: layernorm_plain(x, w, b)),
        library_ms=event_ms(lambda: F.layer_norm(x, (d,), wb, bb, 1e-6)),
        **bound(nbytes(x, w, b, got), 0))


def attention_stats(name: str, got, want) -> dict:
    """Rows 2 and 17 against their plain versions: max and mean error,
    absolute and against max / mean |o|, each against its bound."""
    from vr_video_generator_tpu_torch.attention_bench import error_stats

    stats = error_stats(got, want)
    require(stats["max_abs_err"] <= ATTN_MAX_ABS
            and stats["mean_abs_err"] <= ATTN_MEAN_ABS
            and stats["max_rel_err"] <= ATTN_MAX_REL
            and stats["mean_rel_err"] <= ATTN_MEAN_REL,
            f"{name}: {json.dumps(stats)} over bounds max abs "
            f"{ATTN_MAX_ABS}, mean abs {ATTN_MEAN_ABS}, max rel "
            f"{ATTN_MAX_REL}, mean rel {ATTN_MEAN_REL}")
    return stats


def check_attention(name: str, b: int, n: int, heads: int, seed: int) -> dict:
    """Row 2 (``name`` "attention", q pre-scaled) or row 17
    ("flash_attention", q unscaled) at (B, N, H) on seeded peaked q/k/v
    with k and v strided views into one qkv
    (attention_bench.attention_case): statistics against the plain version
    (ATTN_* bounds), times of the kernel, the plain version and one SDPA
    call, and the bound."""
    import torch

    from vr_video_generator_tpu_torch.attention_bench import attention_case
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    args, fn, plain, sdpa = attention_case(name, b, n, heads, seed)
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    stats = attention_stats(f"{name} B={b} N={n} H={heads}", got, want)
    del want
    return dict(**stats, ms=event_ms(lambda: fn(*args)),
                plain_ms=event_ms(lambda: plain(*args)),
                library_ms=event_ms(sdpa),
                **bound(nbytes(*args[:3], got), 4 * b * heads * n * n * 64))


def tail_stats(name: str, got, want) -> dict:
    """f32 depth against its plain version, relative to the output's range."""
    err = (got - want).abs()
    span = (want.max() - want.min()).item()
    stats = dict(max_abs_err=err.max().item(), mean_abs_err=err.mean().item(),
                 max_rel_err=err.max().item() / span,
                 mean_rel_err=err.mean().item() / span, range=span,
                 frac_nonzero=(want > 0).float().mean().item())
    require(span > 0 and stats["max_rel_err"] <= TAIL_MAX_REL
            and stats["mean_rel_err"] <= TAIL_MEAN_REL,
            f"{name}: {json.dumps(stats)} over bounds max rel "
            f"{TAIL_MAX_REL}, mean rel {TAIL_MEAN_REL} of the range")
    return stats


def tail_weights(gen, c):
    """Seeded DPT tail weights in PyTorch layout, bf16: out_conv, conv1,
    conv2, the 1x1, each with its bias."""
    import torch

    bf = torch.bfloat16
    c2, c3 = c // 2, 32
    return (randn(gen, (c, c, 1, 1), c ** -0.5, dtype=bf),
            randn(gen, (c,), 0.1, dtype=bf),
            randn(gen, (c2, c, 3, 3), (9 * c) ** -0.5, dtype=bf),
            randn(gen, (c2,), 0.1, dtype=bf),
            randn(gen, (c3, c2, 3, 3), (9 * c2) ** -0.5, dtype=bf),
            randn(gen, (c3,), 0.1, dtype=bf),
            randn(gen, (1, c3, 1, 1), c3 ** -0.5, dtype=bf),
            randn(gen, (1,), 0.1, 0.5, dtype=bf))


def mlp_args(gen, m: int, d: int, x=None, gamma=None, hid=None):
    """Seeded operands of the GELU MLP half at width ``d`` on ``m`` rows,
    hidden ``hid`` (4D unless given; x and gamma drawn here unless
    given)."""
    import torch

    bf = torch.bfloat16
    hid = hid or 4 * d
    x = randn(gen, (m, d), dtype=bf) if x is None else x
    lnw, lnb = randn(gen, (d,), 0.1, 1.0), randn(gen, (d,), 0.1)
    w1 = randn(gen, (hid, d), d ** -0.5, dtype=bf)
    b1 = randn(gen, (hid,), 0.5, dtype=bf)
    w2 = randn(gen, (d, hid), hid ** -0.5, dtype=bf)
    b2 = randn(gen, (d,), 0.5, dtype=bf)
    gamma = randn(gen, (d,), 0.1, 1.0, dtype=bf) if gamma is None else gamma
    return (x, lnw, lnb, w1, b1, w2, b2, gamma)


def check_mlp_chain(row: int, key: str, args, stages: bool,
                    approx: bool = False) -> dict:
    """Row 8 (``row`` 8, vits' and vitb's widths) or row 9 (vitl's) on
    ``args`` (:func:`mlp_args`, x 2-D), with the tanh GELU where
    ``approx``: the output against mlp_residual_plain by the bounds of
    ``key`` (GEMM_MAX_FRAC, GEMM_MAX_ULPS); with ``stages``, each stage of
    the chain against its plain version on the chain's own input (the LN
    stage bit-exact against row 1's kernel and within the LN bound of the
    plain LayerNorm; the two GEMM stages to row 9's stage bounds); the call
    must launch its kernel (the tanh variant's counter with ``approx``)
    once. Times of the kernel and the plain version, and the bound."""
    import torch

    from vr_video_generator_tpu_torch.kernels import launch_counts
    from vr_video_generator_tpu_torch.ops.layernorm import (layernorm,
                                                             layernorm_plain)
    from vr_video_generator_tpu_torch.ops import mlp
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    base = "mlp_residual" if row == 8 else "mlp_residual_hblocked"
    fn, stages_fn = getattr(mlp, base), getattr(mlp, f"{base}_stages")
    name = f"{base}_tanh" if approx else base
    x, lnw, lnb, w1, b1, w2, b2, gamma = args
    (m, d), hid = x.shape, w1.shape[0]
    label = f"{key} D={d} M={m}" + (" gelu tanh" if approx else "")
    before = launch_counts()
    a, h, got = stages_fn(*args, approx=approx)
    torch.cuda.synchronize()
    after = launch_counts()
    require(after[name] == before.get(name, 0) + 1
            and all(after[k] == before.get(k, 0) for k in after if k != name),
            f"{label}: launches {before} -> {after}")
    want = mlp.mlp_residual_plain(*args, approx=approx)
    out = gemm_check(label, got, want, args)
    del want
    if stages:
        require(torch.equal(a, layernorm(x, lnw, lnb)),
                f"{label}: the LN stage differs from row 1")
        a_p = layernorm_plain(x, lnw, lnb)
        err = (a.float() - a_p.float()).abs()
        require(bool((err <= LN_ATOL + LN_RTOL * a_p.float().abs()).all()),
                f"{label} LN stage: max abs err {err.max().item()} over atol "
                f"{LN_ATOL} + rtol {LN_RTOL}")
        del a_p, err
        fc1 = gemm_check(f"mlp_fc1_gelu {label}", h,
                         mlp.fc1_gelu_plain(a, w1, b1, approx), (b1,))
        fc2 = gemm_check(f"mlp_fc2_residual {label}", got,
                         mlp.fc2_residual_plain(h, w2, b2, gamma, x),
                         (x, gamma, b2))
        log(f"row {row} stages at D={d}, M={m}: LN bit-exact against row 1; "
            f"fc1 + GELU {json.dumps(fc1)}; fc2 + residual {json.dumps(fc2)}")
        out.update(fc1_gelu=fc1, fc2_residual=fc2)
    del a, h, got
    torch.cuda.empty_cache()
    return dict(**out, ms=event_ms(lambda: fn(*args, approx=approx)),
                plain_ms=event_ms(lambda: mlp.mlp_residual_plain(
                    *args, approx=approx)),
                library_ms=None,
                **bound(nbytes(*args, x), 2 * 2 * m * d * hid))


def check_vitl_kernels(device, results, widths) -> None:
    """Row 9 at vitl-518's shapes (and at vitl-728's batch of 8, into
    ``widths``), rows 11, 12 at vitl-518's (and at vitl-728's batch of 8,
    into ``widths``) and row 17 at vitl-728's."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    results["mlp_residual_hblocked"] = check_mlp_chain(
        9, "mlp_residual_hblocked", mlp_args(gen, B * N_TOK, DIM_L), True)
    widths[f"mlp_residual_hblocked M={B * N_L728}"] = check_mlp_chain(
        9, "mlp_residual_hblocked",
        mlp_args(torch.Generator(device=device).manual_seed(SEED + 90),
                 B * N_L728, DIM_L), False)

    # Row 17 at vitl-728: q, k and v unscaled strided views into one qkv.
    results["flash_attention"] = check_attention(
        "flash_attention", B_L728, N_L728, HEADS_L, SEED + 17)
    results.update(check_big_tail(gen, FEATURES_L))
    # Rows 11 and 12 at vitl-728's grid, batch 8.
    for name, r in check_big_tail(gen, FEATURES_L, GRID_L728,
                                  OUT_HW_L728).items():
        widths[f"{name} 728"] = r


def require_equal(label, got, want) -> None:
    """Bit for bit, or fail with the count of values that differ."""
    import torch

    require(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}, "
            f"its plain stage's {tuple(want.shape)}")
    require(torch.equal(got, want),
            f"{label}: differs from its plain stage in "
            f"{int((got != want).sum())} of {want.numel()} values")


def big_tail_stages(label, x, wts, out_hw):
    """Rows 11 and 12 stage by stage, each stage on the kernel chain's own
    input: the upsample pass and the resize pass bit for bit against their
    plain stages; conv1 (its bf16 sums) as the dense kernels are held
    (GEMM_MAX_FRAC, GEMM_MAX_ULPS); conv2 with the 1x1 by TAIL_MAX_REL and
    TAIL_MEAN_REL; the back's stages on the plain front's output. Each
    wrapper call must launch once. Returns (statistics, the front's output,
    the plain front's output)."""
    import torch

    from vr_video_generator_tpu_torch.kernels import launch_counts
    from vr_video_generator_tpu_torch.ops.head_tail import (
        big_conv1_plain, big_conv2_plain, big_resize_plain, big_upsample_plain,
        head_tail_big_back_stages, head_tail_big_front_plain,
        head_tail_big_front_stages)

    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    before = launch_counts()
    u, mid = head_tail_big_front_stages(x, k_oc, k1)
    torch.cuda.synchronize()
    require_equal(f"{label} upsample pass", u, big_upsample_plain(x))
    conv1 = gemm_check(f"head_tail_big_front {label} conv1", mid,
                       big_conv1_plain(u, k_oc, k1), ())
    del u
    mid_p = head_tail_big_front_plain(x, k_oc, k1)
    r, depth = head_tail_big_back_stages(mid_p, k1, b_oc, b1, k2, b2, k3, b3,
                                         out_hw)
    torch.cuda.synchronize()
    after = launch_counts()
    require(all(after[k] == before[k] + 1 for k in BIG_TAIL),
            f"{label}: launches {before} -> {after}")
    require_equal(f"{label} resize pass", r,
                  big_resize_plain(mid_p, k1, b_oc, b1, out_hw))
    conv2 = tail_stats(f"head_tail_big_back {label} conv2", depth,
                       big_conv2_plain(r, k2, b2, k3, b3))
    log(f"big-C tail stages {label}: upsample and resize passes bit-exact; "
        f"conv1 {json.dumps(conv1)}; conv2 {json.dumps(conv2)}")
    return dict(conv1=conv1, conv2=conv2), mid, mid_p


def check_big_tail(gen, c, grid=(H0, W0), out_hw=OUT_HW, batch=B) -> dict:
    """Rows 11 and 12 at ``c`` channels on refinenet1's pre-upsample
    activation on ``grid`` (1080p, --input_size 518 unless given), as the
    model hands it over (NCHW seen as (B, H0, W0, C)), depth at ``out_hw``:
    stage by stage (:func:`big_tail_stages`), each kernel alone (the back on
    the plain front's output) and the chain. Returns each kernel's
    statistics, times and bound."""
    import torch

    from vr_video_generator_tpu_torch.ops.head_tail import (
        head_tail_big, head_tail_big_back, head_tail_big_back_plain,
        head_tail_big_front, head_tail_big_front_plain, head_tail_big_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    c2, c3 = c // 2, 32
    (h0, w0), (h1, w1) = grid, out_hw
    hm, w2 = 2 * h0, 2 * w0
    label = f"C={c} {batch}x{h0}x{w0}"
    xt = randn(gen, (batch, c, h0, w0), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    stages, mid, mid_p = big_tail_stages(label, xt, wts, (h1, w1))
    out = {"head_tail_big_front": dict(
        **gemm_check(f"head_tail_big_front {label}", mid, mid_p, ()),
        conv1=stages["conv1"],
        ms=event_ms(lambda: head_tail_big_front(xt, k_oc, k1)),
        plain_ms=event_ms(lambda: head_tail_big_front_plain(xt, k_oc, k1)),
        library_ms=None,
        **bound(nbytes(xt, k_oc, k1, mid),
                2 * batch * hm * w2 * 9 * c * c2))}
    del mid
    back = (k1, b_oc, b1, k2, b2, k3, b3, (h1, w1))
    got = head_tail_big_back(mid_p, *back)
    want = head_tail_big_back_plain(mid_p, *back)
    torch.cuda.synchronize()
    out["head_tail_big_back"] = dict(
        **tail_stats(f"head_tail_big_back {label}", got, want),
        conv2=stages["conv2"],
        ms=event_ms(lambda: head_tail_big_back(mid_p, *back)),
        plain_ms=event_ms(lambda: head_tail_big_back_plain(mid_p, *back)),
        library_ms=None,
        **bound(nbytes(mid_p, k1, b_oc, b1, k2, b2, k3, b3, got),
                2 * batch * (h1 * w1 * c3 * 9 * c2 + h1 * w1 * c3)))
    del got, want, mid_p
    chain = tail_stats(f"head_tail_big {label} (front + back)",
                       head_tail_big(xt, *wts, (h1, w1)),
                       head_tail_big_plain(xt, *wts, (h1, w1)))
    log(f"big-C tail chain {label} against its plain version: "
        f"{json.dumps(chain)}")
    torch.cuda.empty_cache()
    return out


def ext_tail_stages(label, x, wts, out_hw) -> dict:
    """Row 7 stage by stage, each stage on the kernel chain's own input: the
    out_conv mix and conv1 (its f32 bias before the cast) as the dense
    kernels are held (GEMM_MAX_FRAC, GEMM_MAX_ULPS, row 11's conv1 bounds);
    the upsample pass (with the out_conv bias) and the resize pass bit for
    bit against their plain stages; conv2 with the 1x1 by TAIL_MAX_REL and
    TAIL_MEAN_REL. The call must launch head_tail_ext once."""
    import torch

    from vr_video_generator_tpu_torch.kernels import launch_counts
    from vr_video_generator_tpu_torch.ops.head_tail import (
        big_conv2_plain, big_upsample_plain, ext_conv1_plain, ext_mix_plain,
        ext_resize_plain, head_tail_ext_stages)

    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    before = launch_counts()
    xoc, z, c1, r, depth = head_tail_ext_stages(x, *wts, out_hw)
    torch.cuda.synchronize()
    after = launch_counts()
    require(after["head_tail_ext"] == before["head_tail_ext"] + 1
            and all(after[k] == before[k] for k in after
                    if k != "head_tail_ext"),
            f"{label}: launches {before} -> {after}")
    mix = gemm_check(f"head_tail_ext_mix {label}", xoc,
                     ext_mix_plain(x, k_oc), ())
    require_equal(f"{label} upsample pass", z, big_upsample_plain(xoc, b_oc))
    del xoc
    conv1 = gemm_check(f"head_tail_ext_conv1 {label}", c1,
                       ext_conv1_plain(z, k1, b1), (b1,))
    del z
    require_equal(f"{label} resize pass", r, ext_resize_plain(c1, out_hw))
    conv2 = tail_stats(f"head_tail_ext {label} conv2", depth,
                       big_conv2_plain(r, k2, b2, k3, b3))
    log(f"ext tail stages {label}: upsample and resize passes bit-exact; "
        f"mix {json.dumps(mix)}; conv1 {json.dumps(conv1)}; conv2 "
        f"{json.dumps(conv2)}")
    return dict(mix=mix, conv1=conv1, conv2=conv2)


def check_ext_tail(gen, c, grid, out_hw) -> dict:
    """Row 7 at ``c`` channels on refinenet1's pre-upsample activation on
    ``grid`` (H0, W0) as the model hands it over (an NCHW tensor seen as
    (B, H0, W0, C)), depth at ``out_hw``: stage by stage
    (:func:`ext_tail_stages`; not at C = 32, whose older chain has no
    stages), the whole tail against its plain version, times and bound."""
    import torch

    from vr_video_generator_tpu_torch.ops.head_tail import (
        head_tail_ext, head_tail_ext_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    (h0, w0), (h1, w1) = grid, out_hw
    c2, c3 = c // 2, 32
    xt = randn(gen, (B, c, h0, w0), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)
    stages = ext_tail_stages(f"C={c} {B}x{h0}x{w0}", xt, wts, (h1, w1)) \
        if c > 32 else {}
    torch.cuda.empty_cache()
    got = head_tail_ext(xt, *wts, (h1, w1))
    want = head_tail_ext_plain(xt, *wts, (h1, w1))
    torch.cuda.synchronize()
    stats = dict(**tail_stats(f"head_tail_ext C={c}", got, want), **stages)
    hm, w2 = 2 * h0, 2 * w0
    flops = 2 * B * (h0 * w0 * c * c + hm * w2 * c2 * 9 * c
                     + h1 * w1 * c3 * 9 * c2 + h1 * w1 * c3)
    return dict(**stats, ms=event_ms(lambda: head_tail_ext(xt, *wts, (h1, w1))),
                plain_ms=event_ms(lambda: head_tail_ext_plain(xt, *wts, (h1, w1))),
                library_ms=None, **bound(nbytes(xt, *wts, got), flops))


def check_silu_mul(device) -> None:
    """Row 10's gate epilogue applies silu_mul on the card: its device
    function, launched elementwise on every bf16 value of x1 (x2 = 1, then
    seeded x2), must equal the plain silu_mul bit for bit (NaN where the
    plain one is NaN: the card's f32 -> bf16 conversion has its own NaN
    payload)."""
    import torch

    from vr_video_generator_tpu_torch.ops.mlp import silu_mul, silu_mul_kernel

    x1 = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED + 65536)
    for label, x2 in (("x2 = 1", torch.ones_like(x1)),
                      ("seeded x2", randn(gen, x1.shape, 3.0,
                                          dtype=torch.bfloat16))):
        got, want = silu_mul_kernel(x1, x2), silu_mul(x1, x2)
        nan = torch.isnan(want)
        same = torch.equal(torch.isnan(got), nan) and torch.equal(
            got[~nan].view(torch.int16), want[~nan].view(torch.int16))
        require(same, f"silu_mul, {label}: the device function differs from "
                f"the plain one in {int((got != want).sum())} of "
                f"{x1.numel()} bf16 inputs")
        log(f"silu_mul, {label}: equal to the plain one on all {x1.numel()} "
            f"bf16 x1 ({int(nan.sum())} NaN)")


def check_swiglu(gen, d: int, hid: int, m: int) -> dict:
    """Row 10 on (m, d) seeded rows, hidden ``hid``, whole and stage by
    stage, each stage on the chain's own input: the LN stage bit-exact
    against row 1's kernel and within the LN bound of the plain LayerNorm;
    the gate and the down product to row 9's stage bounds; the whole to
    row 10's. Times of the chain and its plain version, and the bound."""
    import torch

    from vr_video_generator_tpu_torch.ops.layernorm import (layernorm,
                                                             layernorm_plain)
    from vr_video_generator_tpu_torch.ops.mlp import (
        fc2_residual_plain, swiglu_gate_plain, swiglu_residual,
        swiglu_residual_plain, swiglu_residual_stages)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    bf = torch.bfloat16
    args = (randn(gen, (m, d), dtype=bf), randn(gen, (d,), 0.1, 1.0),
            randn(gen, (d,), 0.1),
            randn(gen, (2 * hid, d), d ** -0.5, dtype=bf),
            randn(gen, (2 * hid,), 0.5, dtype=bf),
            randn(gen, (d, hid), hid ** -0.5, dtype=bf),
            randn(gen, (d,), 0.5, dtype=bf), randn(gen, (d,), 0.1, 1.0, dtype=bf))
    x, lnw, lnb, w12, b12, w3, b3, gamma = args
    h, g, got = swiglu_residual_stages(*args)
    want = swiglu_residual_plain(*args)
    torch.cuda.synchronize()
    label = "" if (d, hid) == (DIM_G, HID_G) else f" D={d} H={hid}"
    whole = gemm_check("swiglu_residual" + label, got, want, args)
    del want
    require(torch.equal(h, layernorm(x, lnw, lnb)),
            f"swiglu_residual{label}: the LN stage differs from row 1")
    h_p = layernorm_plain(x, lnw, lnb)
    err = (h.float() - h_p.float()).abs()
    require(bool((err <= LN_ATOL + LN_RTOL * h_p.float().abs()).all()),
            f"swiglu_residual{label} LN stage: max abs err "
            f"{err.max().item()} over atol {LN_ATOL} + rtol {LN_RTOL}")
    del h_p, err
    gate = gemm_check("swiglu_gate" + label, g,
                      swiglu_gate_plain(h, w12, b12), ())
    down = gemm_check("swiglu_down" + label, got,
                      fc2_residual_plain(g, w3, b3, gamma, x), (x, gamma, b3))
    log(f"row 10 stages at D={d}, H={hid}, M={m}: LN bit-exact against row "
        f"1; gate + silu {json.dumps(gate)}; down + residual "
        f"{json.dumps(down)}")
    del h, g, got
    torch.cuda.empty_cache()
    return dict(**whole, gate=gate, down=down,
                ms=event_ms(lambda: swiglu_residual(*args)),
                plain_ms=event_ms(lambda: swiglu_residual_plain(*args)),
                library_ms=None,
                **bound(nbytes(*args, x), 2 * m * d * 2 * hid
                        + 2 * m * hid * d))


def check_vitg_kernels(device, results, widths) -> None:
    """Row 10 at vitg-518's shapes into ``results``, whole and stage by
    stage, and its silu on every bf16 input; rows 11 and 12 at vitg's C=384
    and row 7 at C=384 (vitg-126's grid) and C=256 (vitl-252's) into
    ``widths``."""
    import torch

    check_silu_mul(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 10)
    results["swiglu_residual"] = check_swiglu(gen, DIM_G, HID_G, B * N_TOK)
    for name, r in check_big_tail(gen, FEATURES_G).items():
        widths[f"{name} C={FEATURES_G}"] = r
    for c, (grid, out_hw) in EXT_WIDE.items():
        widths[f"head_tail_ext C={c}"] = check_ext_tail(gen, c, grid, out_hw)
    # Row 7 at vitb's C=128 and at C=32 (a custom head's width, on the older
    # chain of csrc/head_tail.cu), on vits' grid.
    for c in (2 * FEATURES, FEATURES // 2):
        widths[f"head_tail_ext C={c}"] = check_ext_tail(gen, c, (H0, W0),
                                                        OUT_HW)


def base_tail_stages(label, x, wts, out_hw) -> dict:
    """Row 15 stage by stage, each stage on the kernel chain's own input:
    conv1 (its f32 bias before the cast) as the dense kernels are held
    (GEMM_MAX_FRAC, GEMM_MAX_ULPS), the resize pass bit for bit against its
    plain stage, conv2 with the 1x1 by TAIL_MAX_REL and TAIL_MEAN_REL. The
    call must launch head_tail once and nothing else. Returns (statistics,
    R)."""
    import torch

    from vr_video_generator_tpu_torch.kernels import launch_counts
    from vr_video_generator_tpu_torch.ops.head_tail import (
        base_conv1_plain, big_conv2_plain, ext_resize_plain, head_tail_stages)

    k1, b1, k2, b2, k3, b3 = wts
    before = launch_counts()
    c1, r, depth = head_tail_stages(x, *wts, out_hw)
    torch.cuda.synchronize()
    after = launch_counts()
    require(after["head_tail"] == before["head_tail"] + 1
            and all(after[k] == before[k] for k in after if k != "head_tail"),
            f"{label}: launches {before} -> {after}")
    conv1 = gemm_check(f"head_tail_conv1 {label}", c1,
                       base_conv1_plain(x, k1, b1), (b1,))
    require_equal(f"{label} resize pass", r, ext_resize_plain(c1, out_hw))
    del c1
    conv2 = tail_stats(f"head_tail {label} conv2", depth,
                       big_conv2_plain(r, k2, b2, k3, b3))
    log(f"single-kernel tail stages {label}: resize pass bit-exact; conv1 "
        f"{json.dumps(conv1)}; conv2 {json.dumps(conv2)}")
    return dict(conv1=conv1, conv2=conv2), r


def check_base_tail(gen, c) -> dict:
    """Row 15 at ``c`` channels on path1 at vits' 1080p/518 grid (2 H0 x 2
    W0, NCHW seen as (B, H2, W2, C)), depth at 518 x 924: stage by stage
    (:func:`base_tail_stages`), the whole tail against its plain version,
    times and bound, and cuDNN's two bf16 channels-last convolutions (conv1
    on path1, conv2 on R) as the library time: the port never calls them,
    and no one PyTorch call computes the tail."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops.head_tail import (head_tail,
                                                             head_tail_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    c2, c3 = c // 2, 32
    h2, w2, out_hw = 2 * H0, 2 * W0, OUT_HW
    x = randn(gen, (B, c, h2, w2), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)[2:]
    stages, r = base_tail_stages(f"C={c} {B}x{h2}x{w2}", x, wts, out_hw)
    got, want = head_tail(x, *wts, out_hw), head_tail_plain(x, *wts, out_hw)
    torch.cuda.synchronize()
    stats = dict(**tail_stats(f"head_tail C={c}", got, want), **stages)
    h1, w1 = out_hw
    flops = 2 * B * (h2 * w2 * c2 * 9 * c + h1 * w1 * c3 * 9 * c2
                     + h1 * w1 * c3)
    k1, b1, k2 = wts[0], wts[1], wts[2]
    cl = torch.channels_last
    x_cl, k1_cl = (t.contiguous(memory_format=cl)
                   for t in (x.permute(0, 3, 1, 2), k1))
    r_cl, k2_cl = r.permute(0, 3, 1, 2), k2.contiguous(memory_format=cl)
    cudnn = event_ms(lambda: (F.conv2d(x_cl, k1_cl, b1, padding=1),
                              F.conv2d(r_cl, k2_cl, padding=1)))
    del x_cl, r_cl, r
    out = dict(**stats, ms=event_ms(lambda: head_tail(x, *wts, out_hw)),
               plain_ms=event_ms(lambda: head_tail_plain(x, *wts, out_hw)),
               library_ms=cudnn, **bound(nbytes(x, *wts, got), flops))
    torch.cuda.empty_cache()
    return out


def rcu_inputs(gen, c):
    """rn0 and path2 on refinenet1's 1080p/518 grid (NCHW seen as NHWC)
    and the four convs' seeded bf16 weights and biases."""
    import torch

    bf = torch.bfloat16
    rn0, path2 = (randn(gen, (B, c, H0, W0), dtype=bf).permute(0, 2, 3, 1)
                  for _ in range(2))
    ws = []
    for _ in range(4):
        ws += [randn(gen, (c, c, 3, 3), (9 * c) ** -0.5, dtype=bf),
               randn(gen, (c,), 0.1, dtype=bf)]
    return rn0, path2, ws


def rcu_pair_stats(label, rn0, path2, ws):
    """Row 16 against its plain version: each of its four conv calls alone,
    on the plain chain's own input and residuals, as the dense kernels are
    held (GEMM_MAX_FRAC, GEMM_MAX_ULPS), conv2a's ReLU copy bit for bit
    against the ReLU of its own output; and the chain by its error against
    the same chain in f32, at most RCU_F32_FLOOR times the plain bf16
    chain's, in max and in mean. Returns (statistics, the kernel's output,
    the plain output)."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.attic.refinenet_pre import (
        rcu_chain, rcu_conv, rcu_conv_plain, refinenet_pre,
        refinenet_pre_plain)

    steps = []

    def record(*args, **kw):
        steps.append((args, kw))
        return rcu_conv_plain(*args, **kw)

    want = rcu_chain(record, rn0, path2, *ws)
    convs = []
    for i, (args, kw) in enumerate(steps):
        got_i, want_i = rcu_conv(*args, **kw), rcu_conv_plain(*args, **kw)
        torch.cuda.synchronize()
        if kw.get("relu_copy"):
            require_equal(f"{label} conv {i} ReLU copy", got_i[1],
                          F.relu(got_i[0]))
            got_i, want_i = got_i[0], want_i[0]
        res = args[4] if len(args) > 4 else ()
        convs.append(gemm_check(f"{label} conv {i}", got_i, want_i, res))
    got = refinenet_pre(rn0, path2, *ws)
    ref32 = refinenet_pre_plain(*(t.float() for t in (rn0, path2, *ws)))
    torch.cuda.synchronize()
    require(got.shape == want.shape == rn0.shape, f"{label} shape {got.shape}")
    d_k32, d_p32 = (got.float() - ref32).abs(), (want.float() - ref32).abs()
    stats = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                 frac_differ=(got != want).float().mean().item(),
                 conv_max_ulps=max(c["max_ulps"] for c in convs),
                 conv_frac_differ=max(c["frac_differ"] for c in convs),
                 kernel_vs_f32_max=d_k32.max().item(),
                 kernel_vs_f32_mean=d_k32.mean().item(),
                 plain_vs_f32_max=d_p32.max().item(),
                 plain_vs_f32_mean=d_p32.mean().item())
    for kind in ("max", "mean"):
        require(stats[f"kernel_vs_f32_{kind}"]
                <= RCU_F32_FLOOR * stats[f"plain_vs_f32_{kind}"],
                f"{label}: the chain's error against f32 ({kind}) exceeds "
                f"{RCU_F32_FLOOR} x the plain bf16 chain's: "
                f"{json.dumps(stats)}")
    return stats, got, want


def check_rcu_pair(gen, c) -> dict:
    """Row 16 at ``c`` channels on refinenet1's 1080p/518 grid
    (:func:`rcu_pair_stats`), times (beside the plain chain and cuDNN's four
    channels-last convs on the same operands) and bound; at vits' C=64 also
    the chain
    RCU pair -> ext tail against the plain chain (TAIL_MAX_REL,
    TAIL_MEAN_REL)."""
    from vr_video_generator_tpu_torch.attic.refinenet_pre import (
        refinenet_pre, refinenet_pre_plain)
    from vr_video_generator_tpu_torch.ops.head_tail import (
        head_tail_ext, head_tail_ext_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    rn0, path2, ws = rcu_inputs(gen, c)
    stats, got, want = rcu_pair_stats(f"rcu_pair C={c}", rn0, path2, ws)
    out = dict(**stats, ms=event_ms(lambda: refinenet_pre(rn0, path2, *ws)),
               plain_ms=event_ms(lambda: refinenet_pre_plain(rn0, path2, *ws)),
               library_ms=cudnn_convs_ms(*((rn0, ws[2 * i], ws[2 * i + 1])
                                           for i in range(4))),
               **bound(nbytes(rn0, path2, *ws, got),
                       4 * 2 * B * H0 * W0 * 9 * c * c))
    if c == FEATURES:
        tail = tail_weights(gen, c)
        chain = tail_stats(
            f"rcu_pair -> head_tail_ext C={c}",
            head_tail_ext(got, *tail, OUT_HW),
            head_tail_ext_plain(want, *tail, OUT_HW))
        log(f"rcu_pair -> head_tail_ext chain at C={c} against the plain "
            f"chain: {json.dumps(chain)}")
    return out


def check_warp_4k_banded(device, rng) -> None:
    """A 4K frame with banded=True: 134 shifts exceed the banded kernel's
    126, so the classic kernel (row 3) must run, equal to its plain
    version."""
    import torch

    from vr_video_generator_tpu_torch import StereoConfig
    from vr_video_generator_tpu_torch.kernels import launch_counts
    from vr_video_generator_tpu_torch.ops.warp import (WarpSpec,
                                                       resolve_banded,
                                                       warp_composite,
                                                       warp_composite_plain)

    h, w = 2160, 3840
    spec = WarpSpec.create(h, w, StereoConfig())
    n_shift = spec.s_neg + spec.s_pos + 1
    require(not resolve_banded(True, spec.s_neg, spec.s_pos),
            f"4K: {n_shift} shifts resolved to the banded kernel")
    img = torch.from_numpy(rng.integers(0, 256, (1, h, w, 3),
                                        dtype=np.uint8)).to(device)
    ramp = np.linspace(0.0, 14.0, w, dtype=np.float32)[None, None, :]
    depth = torch.from_numpy(np.clip(
        ramp + rng.normal(0.0, 0.4, (1, h, w)).astype(np.float32),
        0.0, None)).to(device)
    ls = torch.ceil(depth.amax(dim=(1, 2)))
    ranges = torch.stack([spec.cfg.offset_bg * h * ls / 14.0,
                          spec.cfg.offset_fg * h * ls / 14.0], dim=1)
    _, st = spec.tables(depth, ranges)
    torch.cuda.synchronize()
    before = launch_counts()
    comp, cov = warp_composite(img, depth, st, spec.s_neg, spec.s_pos,
                               banded=True)
    after = launch_counts()
    comp_p, cov_p = warp_composite_plain(img, depth, st, spec.s_neg,
                                         spec.s_pos)
    torch.cuda.synchronize()
    require(after["warp_composite"] == before["warp_composite"] + 1
            and after["warp_composite_banded"]
            == before["warp_composite_banded"],
            f"4K banded=True did not run the classic kernel: {before} -> "
            f"{after}")
    require(torch.equal(comp, comp_p) and torch.equal(cov, cov_p),
            "4K: the classic kernel differs from its plain version")
    log(f"4K frame, banded=True: {n_shift} shifts > 126, the classic kernel "
        f"ran, bit-exact against its plain version")


def kernel_parity(device, rng, results, widths):
    """Phase 3: each kernel against its plain version at main-path shapes
    (``results``), and the DPT tails at the widths vitg and vitl add
    (``widths``)."""
    import torch

    from vr_video_generator_tpu_torch import StereoConfig
    from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                            temporal_scan)
    from vr_video_generator_tpu_torch.ops.warp import (
        WarpSpec, blur_select_sbs, blur_select_sbs_packed_plain,
        blur_select_sbs_plain, pack_rgb, warp_composite,
        warp_composite_banded_plain, warp_composite_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    gen = torch.Generator(device=device).manual_seed(SEED)
    m = B * N_TOK

    results["layernorm"] = check_layernorm(gen, *LN_SHAPES[0])
    gen_ln = torch.Generator(device=device).manual_seed(SEED + 1)
    for rows, d in LN_SHAPES[1:]:
        widths[f"layernorm D={d}"] = check_layernorm(gen_ln, rows, d)

    # Row 2: q pre-scaled as mha does; k and v strided views into a fused
    # qkv; at vits' 6 heads and at vitg-518's 24, where it costs the most.
    results["attention"] = check_attention("attention", B, N_TOK, HEADS,
                                           SEED + 2)
    widths[f"attention H={HEADS_G}"] = check_attention(
        "attention", B, N_TOK, HEADS_G, SEED + 2)

    results["ln_qkv"] = check_ln_qkv(device)
    widths[f"ln_qkv D={DIM_B}"] = check_ln_qkv(device, DIM_B)
    widths[f"ln_qkv D={DIM_L}"] = check_ln_qkv(device, DIM_L)

    # Row 8 below takes row 6's x and gamma.
    results["proj_ls_residual"], (_, xr, _, _, gp) = check_proj(gen, DIM)
    widths[f"proj_ls_residual D={DIM_B}"] = check_proj(
        torch.Generator(device=device).manual_seed(SEED + 75), DIM_B)[0]
    widths[f"proj_ls_residual D={DIM_L}"] = check_proj(
        torch.Generator(device=device).manual_seed(SEED + 60), DIM_L)[0]

    # Row 8 stage by stage at vits' D = 384 (on row 6's x and gamma) and
    # vitb's D = 768.
    results["mlp_residual"] = check_mlp_chain(
        8, "mlp_residual", mlp_args(gen, m, DIM, xr.reshape(m, DIM), gp), True)
    widths[f"mlp_residual D={DIM_B}"] = check_mlp_chain(
        8, "mlp_residual",
        mlp_args(torch.Generator(device=device).manual_seed(SEED + 80), m,
                 DIM_B), True)
    del xr

    results["head_tail_ext"] = check_ext_tail(gen, FEATURES, (H0, W0),
                                              OUT_HW)

    spec = WarpSpec.create(H, W, StereoConfig())
    imgs = torch.from_numpy(
        rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(device)
    depth = synthetic_depth(rng, device)
    blended, ranges, _ = temporal_scan(depth, TemporalState.initial(H, W, device),
                                       spec)
    _, st = spec.tables(blended, ranges)
    comp, cov = warp_composite(imgs, blended, st, spec.s_neg, spec.s_pos)
    comp_p, cov_p = warp_composite_plain(imgs, blended, st, spec.s_neg,
                                         spec.s_pos)
    torch.cuda.synchronize()
    warp_err = max(float((comp.int() - comp_p.int()).abs().max()),
                   float((cov.int() - cov_p.int()).abs().max()))
    require(warp_err == 0, f"warp_composite differs from plain by {warp_err}")
    log(f"warp check input: live shifts per frame "
        f"{st.valid.sum(dim=1).tolist()} of {spec.s_neg + spec.s_pos + 1}, "
        f"hole fraction {1.0 - cov.float().mean().item():.4f}")
    results["warp_composite"] = dict(
        max_abs_err=warp_err,
        ms=event_ms(lambda: warp_composite(imgs, blended, st, spec.s_neg,
                                          spec.s_pos)),
        plain_ms=event_ms(lambda: warp_composite_plain(imgs, blended, st,
                                                      spec.s_neg, spec.s_pos)),
        library_ms=None,
        **bound(nbytes(imgs, blended, *st, comp, cov), 0))

    args = (comp_p, cov_p, imgs, st.edge_width, spec.kernel_size,
            spec.cfg.sigma)
    sbs, sbs_p = blur_select_sbs(*args), blur_select_sbs_plain(*args)
    torch.cuda.synchronize()
    sbs_err = float((sbs.int() - sbs_p.int()).abs().max())
    require(sbs_err == 0, f"blur_select_sbs differs from plain by {sbs_err}")
    results["blur_select_sbs"] = dict(
        max_abs_err=sbs_err, ms=event_ms(lambda: blur_select_sbs(*args)),
        plain_ms=event_ms(lambda: blur_select_sbs_plain(*args)),
        library_ms=None,
        **bound(nbytes(comp_p, cov_p, imgs, st.edge_width, sbs), 0))

    # Row 13: the packed emit of the same pass, compared as int32 words.
    pk = blur_select_sbs(*args, emit="packed")
    pk_p = blur_select_sbs_packed_plain(*args)
    torch.cuda.synchronize()
    require(pk.dtype == torch.uint32 and tuple(pk.shape) == (B, H, 2 * W),
            f"blur_select_sbs packed: {pk.dtype} {tuple(pk.shape)}")
    pk_i, pk_pi = pk.view(torch.int32), pk_p.view(torch.int32)
    pk_err = float((pk_i.long() - pk_pi.long()).abs().max())
    require(pk_err == 0, f"blur_select_sbs packed differs from plain by {pk_err}")
    require(torch.equal(pk_i, pack_rgb(sbs).view(torch.int32)),
            "blur_select_sbs: the packed emit differs from the u8 emit")
    results["blur_select_sbs_packed"] = dict(
        max_abs_err=pk_err,
        ms=event_ms(lambda: blur_select_sbs(*args, emit="packed")),
        plain_ms=event_ms(lambda: blur_select_sbs_packed_plain(*args)),
        library_ms=None,
        **bound(nbytes(comp_p, cov_p, imgs, st.edge_width, pk), 0))

    # Row 14: the banded compositor against its plain version and row 3.
    bd, bd_cov = warp_composite(imgs, blended, st, spec.s_neg, spec.s_pos,
                                banded=True)
    bd_p, bd_cov_p = warp_composite_banded_plain(imgs, blended, st,
                                                 spec.s_neg, spec.s_pos)
    torch.cuda.synchronize()
    bd_err = max(float((bd.int() - bd_p.int()).abs().max()),
                 float((bd_cov.int() - bd_cov_p.int()).abs().max()))
    require(bd_err == 0, f"warp_composite banded differs from plain by {bd_err}")
    require(torch.equal(bd, comp) and torch.equal(bd_cov, cov),
            "warp_composite banded differs from the classic kernel (row 3)")
    results["warp_composite_banded"] = dict(
        max_abs_err=bd_err,
        ms=event_ms(lambda: warp_composite(imgs, blended, st, spec.s_neg,
                                          spec.s_pos, banded=True)),
        plain_ms=event_ms(lambda: warp_composite_banded_plain(
            imgs, blended, st, spec.s_neg, spec.s_pos)),
        library_ms=None,
        **bound(nbytes(imgs, blended, *st, bd, bd_cov), 0))
    del imgs, depth, blended, comp, cov, comp_p, cov_p, sbs, sbs_p, pk, pk_p
    del bd, bd_cov, bd_p, bd_cov_p
    check_warp_4k_banded(device, rng)

    # Rows 15 and 16 at vits' C=64 and vitb's C=128.
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    for c in (FEATURES, 2 * FEATURES):
        base, rcu = check_base_tail(gen, c), check_rcu_pair(gen, c)
        if c == FEATURES:
            results["head_tail"], results["rcu_pair"] = base, rcu
        else:
            widths[f"head_tail C={c}"], widths[f"rcu_pair C={c}"] = base, rcu
    check_vitl_kernels(device, results, widths)
    check_vitg_kernels(device, results, widths)
    for name, r in {**results, **widths}.items():
        log(f"kernel {name}: {json.dumps(r)}")


class PlainKernels:
    """Swap the model's kernel wrappers for their plain versions (to hold
    the kernel path against the plain path on the same card)."""

    SWAPS = (("models.dinov2", "layernorm", "ops.layernorm", "layernorm_plain"),
             ("ops.attention", "attention", "ops.attention", "attention_plain"),
             ("ops.attention", "flash_attention", "ops.attention",
              "flash_attention_plain"),
             ("models.dinov2", "attention", "ops.attention", "attention_plain"),
             ("models.dinov2", "ln_qkv", "ops.qkv", "ln_qkv_plain"),
             ("models.dinov2", "proj_ls_residual", "ops.qkv",
              "proj_ls_residual_plain"),
             ("models.dinov2", "mlp_residual", "ops.mlp", "mlp_residual_plain"),
             ("models.dinov2", "mlp_residual_hblocked", "ops.mlp",
              "mlp_residual_plain"),
             ("models.dinov2", "swiglu_residual", "ops.mlp",
              "swiglu_residual_plain"),
             ("models.dpt", "head_tail_ext", "ops.head_tail",
              "head_tail_ext_plain"),
             ("models.dpt", "head_tail_big", "ops.head_tail",
              "head_tail_big_plain"))

    def __enter__(self):
        import importlib

        self._saved = []
        for mod, name, src, plain in self.SWAPS:
            target = importlib.import_module(f"{PKG}.{mod}")
            self._saved.append((target, name, getattr(target, name)))
            setattr(target, name,
                    getattr(importlib.import_module(f"{PKG}.{src}"), plain))
        return self

    def __exit__(self, *exc):
        for target, name, fn in reversed(self._saved):
            setattr(target, name, fn)
        return False


def drive(pipe, frames, batch):
    """One process_segment over ``frames`` with the launch counts reset just
    before it and read just after: (counts, writer, frames written, s)."""
    import torch

    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.runtime.segment import process_segment
    from vr_video_generator_tpu_torch.stage_bench import (CollectingWriter,
                                                          MemoryReader)

    writer = CollectingWriter()
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    n = process_segment(pipe, MemoryReader(frames), writer, 0, len(frames),
                        max_frame_count=15, batch_size=batch)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return launch_counts(), writer, n, elapsed


def check_output(writer, n, frames) -> None:
    out = np.stack(writer.frames)
    require(n == len(frames) and out.shape == (len(frames), H, 2 * W, 3)
            and out.dtype == np.uint8,
            f"output {out.shape} {out.dtype}, {n} frames written")
    require(np.array_equal(out[:, :, W:], frames),
            "right half of the SBS differs from the input")


def run_config(encoder, mlp_fused, tail, batch=B, input_size=518,
               dtype="bfloat16"):
    from vr_video_generator_tpu_torch import RunConfig

    return RunConfig(encoder=encoder, batch_size=batch, compute_dtype=dtype,
                     mlp_fused=mlp_fused, tail=tail, max_frame_count=15,
                     input_size=input_size)


def make_pipe(device, cfg, state_dict=None):
    """The pipeline of RunConfig ``cfg`` with numpy-seeded random weights
    (``state_dict``, drawn once per encoder, or drawn here)."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    t0 = time.perf_counter()
    if state_dict is None:
        state_dict = random_state_dict(cfg.model(), SEED)
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    model = build_model(cfg.model(), state_dict, dtype, device, tail=cfg.tail)
    pipe = SbsPipeline(model, H, W, run_cfg=cfg)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"model: {cfg.encoder}, {cfg.compute_dtype}, --input_size "
        f"{cfg.input_size}, mlp_fused={cfg.mlp_fused}, tail={cfg.tail}, "
        f"preprocess={pipe.preprocess_impl}, "
        f"random weights (numpy seed {SEED}), {weights / 1e9:.3f} GB of "
        f"parameters on {device}, {time.perf_counter() - t0:.2f} s to build")
    return pipe


def one_batch(label, pipe, frames, need) -> dict:
    """One batch of ``frames`` through process_segment after a warm-up
    step: exactly the kernels ``need``, the right half equal to the input."""
    p_batch = pipe.run_cfg.batch_size
    pipe.step(frames[:p_batch], pipe.initial_state())  # warm-up
    got, writer, n, secs = drive(pipe, frames[:p_batch], p_batch)
    log(f"{label}: {n} frames in {secs:.4f} s; launch counts "
        f"{json.dumps(got)}")
    launched_exactly(label, got, need)
    check_output(writer, n, frames[:p_batch])
    return dict(frames=n, seconds=secs, launches=got)


def packed_path(p_u8, frames) -> dict:
    """vits auto with --sbs_output packed --warp_impl pallas, on the model of
    ``p_u8`` (the u8 auto path): one batch through process_segment, exactly
    its kernels, and the written uint32 (H, 2W) frames, unpacked by
    native.unpack_sbs, equal bit for bit to the u8 path's frames on the
    same batch and state, the right half to the input."""
    from vr_video_generator_tpu_torch import native

    label = "vits auto/auto --sbs_output packed"
    bsz = p_u8.run_cfg.batch_size
    pk = type(p_u8)(p_u8.model, H, W, run_cfg=dataclasses.replace(
        p_u8.run_cfg, sbs_output="packed", warp_impl="pallas"))
    pk.step(frames[:bsz], pk.initial_state())  # warm-up
    counts, writer, n, secs = drive(pk, frames[:bsz], bsz)
    log(f"{label}: {n} frames in {secs:.4f} s; launch counts "
        f"{json.dumps(counts)}")
    launched_exactly(label, counts, AUTO_VITS_PACKED)
    out = np.stack(writer.frames)
    require(n == bsz and out.dtype == np.uint32
            and out.shape == (bsz, H, 2 * W),
            f"{label}: output {out.shape} {out.dtype}, {n} frames written")
    require(not np.any(out >> 24), f"{label}: a word's top byte is set")
    _, w_u8, _, _ = drive(p_u8, frames[:bsz], bsz)
    rgb = native.unpack_sbs(out)
    require(np.array_equal(rgb, np.stack(w_u8.frames)),
            f"{label}: unpacked frames differ from the u8 path's")
    require(np.array_equal(rgb[:, :, W:], frames[:bsz]),
            f"{label}: right half of the SBS differs from the input")
    log(f"{label}: {n} frames unpacked by native.unpack_sbs equal the u8 "
        f"path's bit for bit")
    return dict(frames=n, seconds=secs, launches=counts)


def off_cli_entry_points(device, rng) -> dict:
    """The entry points no CLI path calls, called once each as a user
    would, with the launch counts reset just before and read just after:
    the banded compositor on the main path's 1080p geometry (batch 8), the
    single-kernel tail on vits' path1, and the RCU pair feeding the ext
    tail on vits' refinenet1 grid. Exactly their kernels must launch."""
    import torch

    from vr_video_generator_tpu_torch import StereoConfig
    from vr_video_generator_tpu_torch.attic.refinenet_pre import refinenet_pre
    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.ops.head_tail import (head_tail,
                                                             head_tail_ext)
    from vr_video_generator_tpu_torch.ops.temporal import (TemporalState,
                                                            temporal_scan)
    from vr_video_generator_tpu_torch.ops.warp import WarpSpec, warp_composite

    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    spec = WarpSpec.create(H, W, StereoConfig(), impl="pallas", device=device)
    imgs = torch.from_numpy(
        rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)).to(device)
    blended, ranges, _ = temporal_scan(synthetic_depth(rng, device),
                                       TemporalState.initial(H, W, device),
                                       spec)
    _, st = spec.tables(blended, ranges)
    path1 = randn(gen, (B, FEATURES, 2 * H0, 2 * W0),
                  dtype=torch.bfloat16).permute(0, 2, 3, 1)
    tail = tail_weights(gen, FEATURES)
    rn0, path2, ws = rcu_inputs(gen, FEATURES)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    warp_composite(imgs, blended, st, spec.s_neg, spec.s_pos, banded=True)
    head_tail(path1, *tail[2:], OUT_HW)
    head_tail_ext(refinenet_pre(rn0, path2, *ws), *tail, OUT_HW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    log(f"off-CLI entry points: {secs:.4f} s; launch counts "
        f"{json.dumps(counts)}")
    launched_exactly("off-CLI entry points", counts, OFF_CLI)
    return dict(seconds=secs, launches=counts)


def launched_exactly(label, counts, need) -> None:
    launched = {k for k, v in counts.items() if v > 0}
    require(launched == set(need),
            f"{label} launched {sorted(launched)}, expected {sorted(need)}")


def warp_at_step_depth(label, imgs, depth, st, spec) -> dict:
    """Rows 3, 4, 13 and 14 on a main-path step's own depth (its blended
    depth and tables), each bit for bit against its plain version, with
    its kernel-only time (torch.profiler), its event time and the bound's
    share of its kernel-only time."""
    import torch

    from vr_video_generator_tpu_torch.gemm_bench import kernel_us
    from vr_video_generator_tpu_torch.ops.warp import (
        blur_select_sbs, blur_select_sbs_packed_plain, blur_select_sbs_plain,
        resolve_banded, warp_composite, warp_composite_banded_plain,
        warp_composite_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    args = (imgs, depth, st, spec.s_neg, spec.s_pos)
    comp, cov = warp_composite(*args)
    comp_p, cov_p = warp_composite_plain(*args)
    bargs = (comp_p, cov_p, imgs, st.edge_width, spec.kernel_size,
             spec.cfg.sigma)
    sbs, sbs_p = blur_select_sbs(*bargs), blur_select_sbs_plain(*bargs)
    pk = blur_select_sbs(*bargs, emit="packed").view(torch.int32)
    pk_p = blur_select_sbs_packed_plain(*bargs).view(torch.int32)
    torch.cuda.synchronize()
    require(torch.equal(comp, comp_p) and torch.equal(cov, cov_p),
            f"{label}: warp_composite differs from plain at the step's depth")
    require(torch.equal(sbs, sbs_p) and torch.equal(pk, pk_p),
            f"{label}: blur_select_sbs differs from plain at the step's depth")
    moved_warp = nbytes(imgs, depth, *st, comp, cov)
    moved_blur = nbytes(comp_p, cov_p, imgs, st.edge_width)
    rows = [("warp_composite", "warp_composite_kernel",
             lambda: warp_composite(*args), moved_warp),
            ("blur_select_sbs", "blur_select_sbs_kernel",
             lambda: blur_select_sbs(*bargs), moved_blur + nbytes(sbs)),
            ("blur_select_sbs_packed", "blur_select_sbs_kernel",
             lambda: blur_select_sbs(*bargs, emit="packed"),
             moved_blur + nbytes(pk))]
    if resolve_banded(True, spec.s_neg, spec.s_pos):
        bd = warp_composite(*args, banded=True)
        bd_p = warp_composite_banded_plain(*args)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(bd, bd_p)),
                f"{label}: warp_composite banded differs from plain at the "
                f"step's depth")
        rows.append(("warp_composite_banded", "warp_composite_banded_kernel",
                     lambda: warp_composite(*args, banded=True), moved_warp))
    out = dict(live_shifts=st.valid.sum(dim=1).tolist(),
               hole_fraction=1.0 - cov.float().mean().item())
    for name, key, fn, moved in rows:
        kernels, _, _ = kernel_us(fn)
        ms = sum(us for k, us in kernels.items() if key in k) * 1e-3
        b = bound(moved, 0)
        out[name] = dict(kernel_ms=ms, event_ms=event_ms(fn),
                         bound_ms=b["bound_ms"],
                         bound_share=b["bound_ms"] / ms)
    log(f"{label} warp kernels at the step's depth: {json.dumps(out)}")
    return out


def checked_path(label, pipe, frames, need, pipe32=None,
                 warp_timing=False) -> dict:
    """A main path with every output check: a step with no host sync, the
    launch counts of one process_segment over ``frames`` (exactly ``need``),
    the right half equal to the input, the SBS equal to the plain warp of
    its own depth, and, with ``pipe32``, depth held against the plain
    versions and f32; with ``warp_timing``, the warp kernels on the step's
    depth (:func:`warp_at_step_depth`)."""
    import torch

    from vr_video_generator_tpu_torch.ops.temporal import temporal_scan
    from vr_video_generator_tpu_torch.ops.warp import warp_composite_plain

    bsz = pipe.run_cfg.batch_size
    _, state = pipe.step(frames[:bsz], pipe.initial_state())  # warm-up
    # A step must only enqueue work: a host sync inside it would serialise
    # the segment loop's upload, compute and readback.
    on_device = pipe.frames_to_device(frames[bsz:2 * bsz] if len(frames) > bsz
                                      else frames[:bsz])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step(on_device, state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{label} step: no host sync (torch.cuda sync debug mode 'error')")

    counts, writer, n, elapsed = drive(pipe, frames, bsz)
    fps = len(frames) / elapsed
    log(f"{label}: {n} frames in {elapsed:.4f} s = {fps:.3f} frames/s")
    log(f"{label} launch counts: {json.dumps(counts)}")
    launched_exactly(label, counts, need)
    check_output(writer, n, frames)

    # The step's SBS against the plain warp of its own blended depth.
    batch = pipe.frames_to_device(frames[:bsz])
    state0 = pipe.initial_state()
    sbs, _ = pipe.step(batch, state0)
    with torch.inference_mode():
        depth = pipe.depth_only(batch)
        blended, ranges, _ = temporal_scan(depth, state0, pipe.spec)
        plain_sbs = pipe.spec.warp_batch_plain(batch, blended, ranges)
        _, st = pipe.spec.tables(blended, ranges)
        _, cov = warp_composite_plain(batch, blended, st, pipe.spec.s_neg,
                                      pipe.spec.s_pos)
    n_bad = int((sbs != plain_sbs).sum())
    require(n_bad == 0, f"{label}: step SBS differs from the plain warp in "
            f"{n_bad} values")
    live = st.valid.sum(dim=1).tolist()
    holes = 1.0 - cov.float().mean().item()
    log(f"{label} warp: live shifts per frame {live} of "
        f"{pipe.spec.s_neg + pipe.spec.s_pos + 1}, hole fraction {holes:.4f}, "
        f"depth range [{float(depth.min()):.4f}, {float(depth.max()):.4f}]")
    stats = dict(frames=n, seconds=elapsed, fps=fps, launches=counts,
                 live_shifts=live, hole_fraction=holes)
    if warp_timing:
        with torch.inference_mode():
            stats["warp_step"] = warp_at_step_depth(label, batch, blended, st,
                                                    pipe.spec)
    if pipe32 is not None:
        stats.update(depth_agreement(label, pipe, pipe32, batch, depth))
    return stats


def main_path(device, rng):
    """Phase 4: the port's main paths through process_segment; returns the
    launch counts of each kernel's path and the paths' statistics."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import random_state_dict
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler

    frames = rng.integers(0, 256, (3 * B, H, W, 3), dtype=np.uint8)
    paths, launches = {}, {}

    def keep(label, stats):
        # A kernel's count is that of the first path, in this order, that
        # launches it: vits fused, vits auto packed, vitb-518, vitl-518,
        # vitl-728, vitg-518, then the off-CLI entry points.
        paths[label] = stats
        for k, v in stats["launches"].items():
            if v > 0 and k not in launches:
                launches[k] = v
        log(f"phase 4 {label}: {time.perf_counter() - t0:.1f} s")

    # vits fused: every vits kernel of slice 2.
    t0 = time.perf_counter()
    cfg = run_config("vits", "fused", "fused")
    sd = random_state_dict(cfg.model(), SEED)
    pipe = make_pipe(device, cfg, sd)
    scaler = calibrate_random_scaler(pipe, frames[:B])
    log(f"depth scaler calibrated to {scaler:.6g} on the first batch")
    pipe32 = make_pipe(device, run_config("vits", "fused", "fused",
                                          dtype="float32"), sd)
    pipe32.model.cfg = pipe.model.cfg  # the calibrated scaler
    keep("vits fused/fused", checked_path("vits fused/fused", pipe, frames,
                                          FUSED_VITS, pipe32,
                                          warp_timing=True))
    model_cfg = pipe.model.cfg
    del pipe, pipe32
    torch.cuda.empty_cache()

    # Slice 1's unfused path, cut to one batch, and one batch of auto.
    for mlp_fused, tail, need in (("xla", "xla", SLICE1),
                                  ("auto", "auto", AUTO_VITS)):
        t0 = time.perf_counter()
        p = make_pipe(device, run_config("vits", mlp_fused, tail), sd)
        p.model.cfg = model_cfg  # the calibrated scaler
        label = f"vits {mlp_fused}/{tail}"
        keep(label, one_batch(label, p, frames, need))
        if mlp_fused == "auto":
            t0 = time.perf_counter()
            keep(f"{label} packed", packed_path(p, frames))
        del p
        torch.cuda.empty_cache()

    # vitb (Depth-Anything-V2-Base) at 518 through the CLI's default (auto):
    # row 8 at D = 768, the ext tail at C = 128; one batch, its own weights
    # and f32 reference, each kernel launched its count a step.
    t0 = time.perf_counter()
    cfg = run_config("vitb", "auto", "auto")
    sd = random_state_dict(cfg.model(), SEED)
    pipe = make_pipe(device, cfg, sd)
    scaler = calibrate_random_scaler(pipe, frames[:B])
    log(f"vitb depth scaler calibrated to {scaler:.6g} on the first batch")
    pipe32 = make_pipe(device, run_config("vitb", "auto", "auto",
                                          dtype="float32"), sd)
    del sd
    pipe32.model.cfg = pipe.model.cfg
    stats = checked_path("vitb-518 auto/auto", pipe, frames[:B], VITB_518,
                         pipe32)
    per_step = {k: v for k, v in stats["launches"].items() if v}
    require(per_step == VITB_518_STEP, f"vitb-518 auto/auto launched "
            f"{per_step} in one step, expected {VITB_518_STEP}")
    keep("vitb-518 auto/auto", stats)
    del pipe, pipe32
    torch.cuda.empty_cache()

    # vitl, one set of weights for both geometries and the f32 reference.
    t0 = time.perf_counter()
    cfg = run_config("vitl", "fused", "fused")
    sd = random_state_dict(cfg.model(), SEED)
    pipe = make_pipe(device, cfg, sd)
    scaler = calibrate_random_scaler(pipe, frames[:B])
    log(f"vitl depth scaler calibrated to {scaler:.6g} on the first batch")
    pipe32 = make_pipe(device, run_config("vitl", "fused", "fused",
                                          dtype="float32"), sd)
    pipe32.model.cfg = pipe.model.cfg
    keep("vitl-518 fused/fused", checked_path(
        "vitl-518 fused/fused", pipe, frames[:2 * B], VITL_518, pipe32))
    del pipe
    torch.cuda.empty_cache()

    # vitl-728 through the CLI's default (auto), on the same weights; the
    # f32 reference is the same f32 model (plain versions throughout).
    t0 = time.perf_counter()
    cfg = run_config("vitl", "auto", "auto", batch=B_L728, input_size=728)
    pipe = make_pipe(device, cfg, sd)
    del sd
    pipe.model.cfg = dataclasses.replace(pipe.model.cfg, depth_scaler=scaler)
    pipe32 = type(pipe32)(pipe32.model, H, W, run_cfg=dataclasses.replace(
        cfg, compute_dtype="float32"))
    keep("vitl-728 auto/auto", checked_path(
        "vitl-728 auto/auto", pipe, frames[:B_L728], VITL_728, pipe32))
    del pipe32

    # vitl-252 (auto, one batch of 8) on the same model: the ext tail at
    # C=256.
    t0 = time.perf_counter()
    pipe = type(pipe)(pipe.model, H, W, run_cfg=run_config(
        "vitl", "auto", "auto", input_size=252))
    keep("vitl-252 auto/auto", one_batch("vitl-252 auto/auto", pipe, frames,
                                         VITL_252))
    del pipe
    torch.cuda.empty_cache()

    # vitg (DINOv2-giant, SwiGLU) through the CLI's default (auto), one set
    # of weights for both geometries and the f32 reference.
    t0 = time.perf_counter()
    cfg = run_config("vitg", "auto", "auto")
    sd = random_state_dict(cfg.model(), SEED)
    pipe = make_pipe(device, cfg, sd)
    scaler = calibrate_random_scaler(pipe, frames[:B])
    log(f"vitg depth scaler calibrated to {scaler:.6g} on the first batch")
    pipe32 = make_pipe(device, run_config("vitg", "auto", "auto",
                                          dtype="float32"), sd)
    del sd
    pipe32.model.cfg = pipe.model.cfg
    keep("vitg-518 auto/auto", checked_path(
        "vitg-518 auto/auto", pipe, frames[:B], VITG_518, pipe32))
    del pipe32
    torch.cuda.empty_cache()

    # vitg-126 (auto, one batch of 8) on the same model: the ext tail at
    # C=384.
    t0 = time.perf_counter()
    pipe = type(pipe)(pipe.model, H, W, run_cfg=run_config(
        "vitg", "auto", "auto", input_size=126))
    keep("vitg-126 auto/auto", one_batch("vitg-126 auto/auto", pipe, frames,
                                         VITG_126))
    del pipe
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    keep("off-CLI entry points", off_cli_entry_points(device, rng))
    return launches, paths


def states_equal(a, b) -> bool:
    """Every field of two TemporalStates equal, dtype and bits; anchor_prev
    (None at depth_stride 1) included."""
    import torch

    return all((x is None and y is None)
               or (x is not None and y is not None and x.dtype == y.dtype
                   and torch.equal(x, y)) for x, y in zip(a, b))


def step_many_path(device, rng) -> dict:
    """Phase 5: ``SbsPipeline.step_many`` as a CUDA graph at vits ``auto``,
    1080p, batch 8, k = 3: the graph's SBS and state equal to three eager
    steps bit for bit; a second call on fresh frames replays without a new
    capture, equals the eager steps too, and leaves the first call's
    outputs intact; the launches captured per replay are 3 times one eager
    step's (exactly ``AUTO_VITS``); ``process_segment`` over 40 frames
    writes the same bytes at ``chunk_batches`` 3 and 1; ``utils.profiling
    .trace`` writes a trace holding the replay's kernels; and the port's
    ``bench --config 2 --chunk_batches 4`` runs once, cut to 2 repeats."""
    import tempfile

    import torch

    from vr_video_generator_tpu_torch import bench
    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler
    from vr_video_generator_tpu_torch.utils.profiling import trace

    k = 3
    label = f"vits auto/auto step_many k={k}"
    pipe = make_pipe(device, run_config("vits", "auto", "auto"))
    frames = rng.integers(0, 256, (2 * k * B, H, W, 3), dtype=np.uint8)
    calibrate_random_scaler(pipe, frames[:B])
    chunks = [torch.from_numpy(frames[i * k * B:(i + 1) * k * B].reshape(
        k, B, H, W, 3)).to(device) for i in range(2)]
    state0 = pipe.initial_state()
    pipe.step(chunks[0][0], state0)  # warm-up: kernels built, tables cached
    torch.cuda.synchronize()
    reset_launch_counts()
    pipe.step(chunks[0][0], state0)
    one_step = {n: v for n, v in launch_counts().items() if v}
    eager, st = [], state0
    for chunk in chunks:
        outs = []
        for batch in chunk:
            sbs, st = pipe.step(batch, st)
            outs.append(sbs)
        eager.append((outs, st))

    t0 = time.perf_counter()
    first, st1 = pipe.step_many(chunks[0], state0)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    require(len(pipe._graphs) == 1, f"{label}: {len(pipe._graphs)} graphs")
    graph = pipe._graphs[(k, B)]
    per_replay = dict(graph.launches)
    launched_exactly(label, per_replay, AUTO_VITS)
    require(per_replay == {n: k * v for n, v in one_step.items()},
            f"{label}: a replay launches {per_replay}, {k} x one eager "
            f"step's {one_step} expected")
    first_copy = [o.clone() for o in first]
    reset_launch_counts()
    t0 = time.perf_counter()
    second, st2 = pipe.step_many(chunks[1], st1)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay_counts = {n: v for n, v in launch_counts().items() if v}
    require(pipe._graphs == {(k, B): graph},
            f"{label}: the second call captured again")
    require(replay_counts == per_replay,
            f"{label}: a replay counted {replay_counts}, captured "
            f"{per_replay}")
    for i, (outs, st_g) in enumerate(((first, st1), (second, st2))):
        want, st_e = eager[i]
        bad = [j for j, (g, e) in enumerate(zip(outs, want))
               if not torch.equal(g, e)]
        require(not bad, f"{label}: call {i + 1}'s SBS of batches {bad} "
                f"differ from the eager steps'")
        require(states_equal(st_g, st_e),
                f"{label}: call {i + 1}'s state differs from the eager "
                f"steps'")
    require(all(torch.equal(a, b) for a, b in zip(first, first_copy)),
            f"{label}: the second call overwrote the first call's outputs")
    log(f"{label}: graph SBS and state equal to {k} eager steps bit for bit "
        f"(two calls, the second on fresh frames without a new capture); "
        f"first call with capture {capture_s:.3f} s, replay call "
        f"{replay_s:.4f} s; launches per replay {json.dumps(per_replay)}")

    # process_segment over 40 frames (chunks of 3 and 2 full batches) at
    # chunk_batches 3 against chunk_batches 1.
    seg = {}
    for chunk in (3, 1):
        p = type(pipe)(pipe.model, H, W, run_cfg=dataclasses.replace(
            pipe.run_cfg, chunk_batches=chunk))
        counts, writer, n, secs = drive(p, frames[:40], B)
        check_output(writer, n, frames[:40])
        seg[chunk] = (np.stack(writer.frames), counts, secs)
        del p
    require(np.array_equal(seg[3][0], seg[1][0]),
            f"{label}: process_segment at chunk_batches 3 wrote other bytes "
            f"than at 1")
    launched_exactly(f"{label} process_segment", seg[3][1], AUTO_VITS)
    log(f"{label}: process_segment, 40 frames, the same bytes at "
        f"chunk_batches 3 ({seg[3][2]:.3f} s, with two captures) and 1 "
        f"({seg[1][2]:.3f} s)")

    with tempfile.TemporaryDirectory() as d:
        with trace(d, "step_many.json"):
            pipe.step_many(chunks[1], st1)
            torch.cuda.synchronize()
        with open(os.path.join(d, "step_many.json"), encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    require(kernels > 0, f"{label}: the trace holds no device kernel")
    log(f"{label}: trace written, {kernels} device kernels in one call")
    del pipe, graph, chunks, first, second, first_copy, eager, seg
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    line = bench.run_config(2, chunk_batches=4, reps=2, segment_batches=8)
    print(json.dumps(line), flush=True)
    require(line["value"] > 0 and line["host_fps"] > 0,
            f"bench --config 2: {line}")
    log(f"bench --config 2 --chunk_batches 4 --reps 2 --segment_batches 8: "
        f"{time.perf_counter() - t0:.1f} s")
    return dict(launches_per_replay=per_replay, one_step=one_step,
                capture_s=capture_s, replay_s=replay_s,
                trace_kernels=kernels, bench=line)


def first_divergence(pipe, frames, s):
    """The first module of the depth net, in call order, whose output on
    the anchors ``frames[s-1::s]`` (depth batch B/s) differs from its
    output rows s-1, 2s-1, ... on all of ``frames`` (depth batch B), with
    the largest difference; None when every module's output is equal."""
    import torch

    full_rows, found, seen = {}, [], {}

    def record(name):
        def hook(_mod, _inp, out):
            if isinstance(out, torch.Tensor) and out.shape[0] == len(frames):
                full_rows.setdefault(name, []).append(out[s - 1::s].clone())
        return hook

    def compare(name):
        def hook(_mod, _inp, out):
            if not isinstance(out, torch.Tensor) or found \
                    or out.shape[0] != len(frames) // s:
                return
            i = seen[name] = seen.get(name, -1) + 1
            want = full_rows.get(name, [])
            if i < len(want) and not torch.equal(out, want[i]):
                found.append((name, float((out.float() - want[i].float())
                                          .abs().max())))
        return hook

    for hook_of, batch in ((record, frames), (compare, frames[s - 1::s])):
        handles = [m.register_forward_hook(hook_of(n))
                   for n, m in pipe.model.named_modules() if n]
        try:
            pipe.depth_only(batch)
        finally:
            for h in handles:
                h.remove()
    return found[0] if found else None


def stride_path(device, rng) -> dict:
    """Phase 6: ``--depth_stride`` at vits ``auto``, 1080p, batch 8, input
    518, bf16, numpy-seeded weights with the calibrated scaler: (a) the
    stride-2 path through ``process_segment`` (exactly ``AUTO_VITS``
    launched, no host sync in a step, the right half the input, the SBS
    the plain warp of its own depth, the anchors' depth held against the
    plain versions and f32 with phase 4's bounds); (b) the depth batches of
    strides 2, 4, 8 (B/s = 4, 2, 1) against the rows of batch 8; (c)
    ``step_audited`` against a stride-1 step and ``stride_audit``; (d)
    ``step_many`` at stride 2 against eager steps; (e) the adaptive segment
    loop at both extreme thresholds; (f) repair ranges off the stride grid
    through ``convert_range``; (g) ``bench --config 2 --depth_stride 2``."""
    import tempfile

    import torch

    from vr_video_generator_tpu_torch import bench
    from vr_video_generator_tpu_torch.models.factory import random_state_dict
    from vr_video_generator_tpu_torch.ops.temporal import (stride_interpolate,
                                                           temporal_scan)
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler

    out = {}
    label = "vits auto/auto depth_stride 2"
    cfg = dataclasses.replace(run_config("vits", "auto", "auto"),
                              depth_stride=2)
    sd = random_state_dict(cfg.model(), SEED)
    pipe = make_pipe(device, cfg, sd)
    frames = rng.integers(0, 256, (6 * B, H, W, 3), dtype=np.uint8)
    scaler = calibrate_random_scaler(pipe, frames[:B])
    pipe32 = make_pipe(device, dataclasses.replace(cfg,
                                                   compute_dtype="float32"), sd)
    del sd
    pipe32.model.cfg = pipe.model.cfg
    model = pipe.model

    def variant(**kw):
        return type(pipe)(model, H, W, run_cfg=dataclasses.replace(
            cfg, **kw))

    # (a) the stride-2 step: no host sync, its launches, its output.
    t0 = time.perf_counter()
    _, st = pipe.step(frames[:B], pipe.initial_state())
    on_device = pipe.frames_to_device(frames[B:2 * B])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step(on_device, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts, writer, n, secs = drive(pipe, frames[:3 * B], B)
    launched_exactly(label, counts, AUTO_VITS)
    check_output(writer, n, frames[:3 * B])
    batch = pipe.frames_to_device(frames[:B])
    state0 = pipe.initial_state()
    sbs, _ = pipe.step(batch, state0)
    with torch.inference_mode():
        anchors = batch[1::2]
        depth_a = pipe.depth_only(anchors)
        depth, _ = stride_interpolate(depth_a, state0, 2)
        blended, ranges, _ = temporal_scan(depth, state0, pipe.spec)
        plain_sbs = pipe.spec.warp_batch_plain(batch, blended, ranges)
    n_bad = int((sbs != plain_sbs).sum())
    require(n_bad == 0, f"{label}: step SBS differs from the plain warp of "
            f"its own depth in {n_bad} values")
    out["a"] = dict(frames=n, seconds=secs, launches=counts, **depth_agreement(
        f"{label} anchors", pipe, pipe32, anchors, depth_a))
    log(f"{label}: no host sync in a step; {n} frames in {secs:.4f} s, "
        f"launch counts {json.dumps(counts)}; SBS equal to the plain warp of "
        f"its own depth; (a) {time.perf_counter() - t0:.1f} s")
    del pipe32

    # (b) the depth net at batch B/s against the rows of batch B.
    t0 = time.perf_counter()
    full = pipe.depth_only(batch)
    span = float(full.max() - full.min())
    out["b"] = {}
    for s in (2, 4, 8):
        sub = pipe.depth_only(batch[s - 1::s])
        want = full[s - 1::s]
        diff = (sub - want).abs()
        bit_equal = bool(torch.equal(sub, want))
        where = None if bit_equal else first_divergence(pipe, batch, s)
        out["b"][s] = dict(depth_batch=B // s, bit_equal=bit_equal,
                           mean_abs=float(diff.mean()),
                           max_abs=float(diff.max()), first_diff=where)
        log(f"{label}: depth at batch {B // s} (stride {s}) against batch "
            f"{B}'s rows: bit-equal {bit_equal}, mean |diff| "
            f"{float(diff.mean()):.3g}, max {float(diff.max()):.3g} (range "
            f"{span:.4g})" + ("" if bit_equal else
                              f"; first module that differs: {where}"))
        require(float(diff.mean()) <= DEPTH_REL * span,
                f"{label}: depth at batch {B // s} is off batch {B}'s rows by "
                f"{float(diff.mean())} on average (limit {DEPTH_REL} x range "
                f"{span})")
    log(f"(b) {time.perf_counter() - t0:.1f} s")

    # (c) step_audited against a stride-1 step on the same weights, batch
    # and state; stride_audit on the same batch and state, read-only.
    t0 = time.perf_counter()
    p1 = variant(depth_stride=1)
    _, warm = pipe.step(frames[:B], pipe.initial_state())
    batch2 = pipe.frames_to_device(frames[B:2 * B])
    before = warm.map(torch.clone)
    rms_r, mx_r = pipe.stride_audit(batch2, warm)
    require(states_equal(warm, before), f"{label}: stride_audit changed the "
            f"state")
    want_sbs, want_st = p1.step(batch2, warm._replace(anchor_prev=None))
    sbs_a, st_a, rms, mx = pipe.step_audited(batch2, warm)
    require(torch.equal(sbs_a, want_sbs), f"{label}: step_audited's SBS "
            f"differs from the stride-1 step's")
    require(states_equal(st_a._replace(anchor_prev=None), want_st),
            f"{label}: step_audited's state differs from the stride-1 step's")
    require((rms, mx) == (rms_r, mx_r), f"{label}: step_audited's stats "
            f"({rms}, {mx}) differ from stride_audit's ({rms_r}, {mx_r})")
    out["c"] = dict(rms=rms, max=mx)
    log(f"{label}: step_audited SBS and state equal to a stride-1 step bit "
        f"for bit; rms {rms:.6g} and max {mx:.6g} equal to stride_audit's; "
        f"stride_audit read-only; (c) {time.perf_counter() - t0:.1f} s")

    # (d) the graph of k = 3 stride-2 steps against eager steps.
    t0 = time.perf_counter()
    k = 3
    chunk = torch.from_numpy(frames[:k * B].reshape(k, B, H, W, 3)).to(device)
    eager, st_e = [], pipe.initial_state()
    for b_ in chunk:
        o, st_e = pipe.step(b_, st_e)
        eager.append(o)
    got, st_g = pipe.step_many(chunk, pipe.initial_state())
    got2, st_g2 = pipe.step_many(chunk, pipe.initial_state())
    for g_outs, g_st in ((got, st_g), (got2, st_g2)):
        require(all(torch.equal(x, y) for x, y in zip(g_outs, eager)),
                f"{label}: step_many's SBS differs from the eager steps'")
        require(states_equal(g_st, st_e), f"{label}: step_many's state "
                f"(anchor_prev included) differs from the eager steps'")
    graph = pipe._graphs.get((k, B))
    require(graph is not None or device.type != "cuda",
            f"{label}: step_many captured no graph")
    out["d"] = dict(k=k, launches_per_replay=graph and dict(graph.launches))
    log(f"{label}: step_many k={k} equal to {k} eager steps bit for bit, "
        f"SBS and state with anchor_prev, capture and replay; (d) "
        f"{time.perf_counter() - t0:.1f} s")
    del chunk, eager, got, got2

    # (e) the segment loop over 48 frames at both extreme thresholds.
    t0 = time.perf_counter()
    seg = frames[:6 * B]
    _, w1, _, _ = drive(p1, seg, B)
    parity = np.stack(w1.frames)
    high_ref, st_h = [], pipe.initial_state()
    for i in range(6):
        b_ = seg[i * B:(i + 1) * B]
        if i % 2 == 0:
            o, st_h, _, _ = pipe.step_audited(b_, st_h)
        else:
            o, st_h = pipe.step(b_, st_h)
        high_ref.append(o.cpu().numpy())
    high_ref = np.concatenate(high_ref)
    out["e"] = {}
    for chunk_k in (1, 3):
        for name, kw, want in (
                ("rms 1e-30", dict(stride_max_rms=1e-30), parity),
                ("rms 1e30 every 2", dict(stride_max_rms=1e30,
                                          stride_audit_every=2), high_ref)):
            p = variant(chunk_batches=chunk_k, **kw)
            counts, wr, n, secs = drive(p, seg, B)
            launched_exactly(f"{label} {name}", counts, AUTO_VITS)
            check_output(wr, n, seg)
            require(np.array_equal(np.stack(wr.frames), want),
                    f"{label}: the adaptive loop ({name}, chunk_batches "
                    f"{chunk_k}) wrote other bytes than its reference")
            out["e"][f"{name} K={chunk_k}"] = dict(seconds=secs)
            del p, wr
    log(f"{label}: adaptive segment loop, 48 frames: stride_max_rms 1e-30 "
        f"writes the stride-1 bytes, 1e30 with a probe every 2 batches the "
        f"probe schedule's (step_audited on batches 0, 2, 4), at "
        f"chunk_batches 1 and 3; (e) {time.perf_counter() - t0:.1f} s")
    del parity, high_ref, w1

    # (f) repair ranges off the stride grid, warm-ups reaching frame 0.
    t0 = time.perf_counter()
    import cv2

    from vr_video_generator_tpu_torch.runtime import orchestrator
    from vr_video_generator_tpu_torch.video import writer as writer_mod
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    with tempfile.TemporaryDirectory() as d:
        video = os.path.join(d, "in.mp4")
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (W, H))
        for f in frames[:3 * B]:
            vw.write(f[:, :, ::-1])
        vw.release()
        with VideoReader(video, begin=0, backend="cv2") as r:
            decoded = np.stack(list(r.frames(0, 3 * B)))
        full_run, st_f = [], pipe.initial_state()
        for i in range(3):
            o, st_f = pipe.step(decoded[i * B:(i + 1) * B], st_f)
            full_run.append(o.cpu().numpy())
        full_run = np.concatenate(full_run)
        clips = {}

        class Capture:
            def __init__(self, *a, **kw):
                pass

            def write_clip(self, begin, fr):
                clips[begin] = np.stack(fr)

            def wait(self):
                pass

            def close(self):
                pass

        real_writer = writer_mod.SubclipWriter
        writer_mod.SubclipWriter = Capture
        try:
            for lo, hi, warmup in ((9, 15, 8), (17, 23, 16)):
                rcfg = dataclasses.replace(
                    cfg, video_dir=video, debug_dir=d + os.sep,
                    subclip_dir=d + os.sep, warmup_frames=warmup,
                    reader_backend="cv2", max_frame_count=30)
                clips.clear()
                n = orchestrator.convert_range(rcfg, lo, hi, pipeline=pipe)
                require(n == hi - lo and list(clips) == [lo],
                        f"{label}: convert_range [{lo}, {hi}) wrote {n} "
                        f"frames in clips {sorted(clips)}")
                require(np.array_equal(clips[lo], full_run[lo:hi]),
                        f"{label}: convert_range [{lo}, {hi}) differs from "
                        f"the full run's frames")
        finally:
            writer_mod.SubclipWriter = real_writer
    out["f"] = dict(ranges=[[9, 15, 8], [17, 23, 16]])
    log(f"{label}: convert_range over [9, 15) and [17, 23) (off the stride "
        f"grid at both ends; warm-ups of 8 and 16 frames from frame 0) equal "
        f"to the full run's frames bit for bit; (f) "
        f"{time.perf_counter() - t0:.1f} s")
    del pipe, p1, model, full_run, decoded, graph
    torch.cuda.empty_cache()

    # (g) the port's bench at stride 2.
    t0 = time.perf_counter()
    line = bench.run_config(2, reps=2, segment_batches=8, depth_stride=2)
    print(json.dumps(line), flush=True)
    require(line["value"] > 0 and line["host_fps"] > 0
            and line["metric"].endswith("_stride2"),
            f"bench --config 2 --depth_stride 2: {line}")
    out["g"] = line
    log(f"bench --config 2 --depth_stride 2 --reps 2 --segment_batches 8: "
        f"{time.perf_counter() - t0:.1f} s")
    out["depth_scaler"] = scaler
    return out


def depth_agreement(label, pipe, pipe32, batch, depth):
    """Depth through the kernels (bf16) against the plain versions in bf16
    and in f32, on the same weights and frames."""
    with PlainKernels():
        plain = pipe.depth_only(batch)
        ref32 = pipe32.depth_only(batch)
    span = float(plain.max() - plain.min())
    d_kp = (depth - plain).abs()
    d_k32 = (depth - ref32).abs()
    d_p32 = (plain - ref32).abs()
    stats = dict(preprocess=pipe.preprocess_impl,
                 preprocess_f32=pipe32.preprocess_impl, depth_range=span,
                 depth_kernel_vs_plain_max=float(d_kp.max()),
                 depth_kernel_vs_plain_mean=float(d_kp.mean()),
                 depth_kernel_vs_f32_max=float(d_k32.max()),
                 depth_kernel_vs_f32_mean=float(d_k32.mean()),
                 depth_plain_bf16_vs_f32_max=float(d_p32.max()),
                 depth_plain_bf16_vs_f32_mean=float(d_p32.mean()))
    log(f"{label} depth agreement: {json.dumps(stats)}")
    # --preprocess auto: folded for bf16 on the card, exact for the f32 one.
    require(stats["preprocess"] == "folded"
            and stats["preprocess_f32"] == "exact",
            f"{label}: preprocess resolved to {stats['preprocess']} (bf16) "
            f"and {stats['preprocess_f32']} (f32)")
    require(stats["depth_kernel_vs_plain_mean"] <= DEPTH_REL * span,
            f"{label}: depth through the kernels is off the plain path by "
            f"{stats['depth_kernel_vs_plain_mean']} on average (limit "
            f"{DEPTH_REL} x range {span})")
    for kind in ("max", "mean"):
        require(stats[f"depth_kernel_vs_f32_{kind}"]
                <= DEPTH_FLOOR * stats[f"depth_plain_bf16_vs_f32_{kind}"],
                f"{label}: kernel depth error vs f32 ({kind}) exceeds "
                f"{DEPTH_FLOOR} "
                f"x the plain bf16 path's: {json.dumps(stats)}")
    return stats


def check_gelu_tanh(device) -> None:
    """Phase 7 (a): the tanh GELU of rows 8 and 9's fc1 epilogue, its device
    function launched elementwise (``vrvg_gelu_tanh``) on every bf16 value,
    must equal the plain ``gelu_tanh`` bit for bit (NaN where the plain one
    is NaN)."""
    import torch

    from vr_video_generator_tpu_torch.ops.gelu import gelu_tanh
    from vr_video_generator_tpu_torch.ops.mlp import gelu_tanh_kernel

    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16)
    got, want = gelu_tanh_kernel(x), gelu_tanh(x)
    nan = torch.isnan(want)
    same = torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int16), want[~nan].view(torch.int16))
    require(same, f"gelu_tanh: the device function differs from the plain "
            f"one in {int((got != want).sum())} of {x.numel()} bf16 inputs")
    log(f"gelu_tanh: the epilogue's device function equal to the plain one "
        f"on all {x.numel()} bf16 inputs ({int(nan.sum())} NaN)")


def selection_gelu_stage(row: int, args) -> dict:
    """The tanh GELU stage of row ``row``'s chain bit for bit in place: with
    fc1 a selection (w1[j, j mod D] = 1, every product one element of the
    LN rows, exact in f32 and in bf16) the stage is gelu_tanh(a[:, j mod D]
    + b1[j]) on the chain's own LN rows, so the kernel's h must equal
    ``fc1_gelu_plain``'s bit for bit."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp

    x, lnw, lnb, w1, b1, w2, b2, gamma = args
    hid, d = w1.shape
    sel = torch.zeros_like(w1)
    sel[torch.arange(hid, device=w1.device),
        torch.arange(hid, device=w1.device) % d] = 1
    base = "mlp_residual" if row == 8 else "mlp_residual_hblocked"
    a, h, _ = getattr(mlp, f"{base}_stages")(x, lnw, lnb, sel, b1, w2, b2,
                                             gamma, approx=True)
    want = mlp.fc1_gelu_plain(a, sel, b1, approx=True)
    torch.cuda.synchronize()
    n_bad = int((h.view(torch.int16) != want.view(torch.int16)).sum())
    require(n_bad == 0, f"row {row} D={d}: the tanh GELU stage differs from "
            f"the plain one in {n_bad} of {h.numel()} values (selection fc1)")
    return dict(values=h.numel(), range=[float(want.min()),
                                         float(want.max())])


def tanh_kernels(device) -> dict:
    """Phase 7 (a) and (b): the tanh epilogue on every bf16 input; rows 8
    (D = 384, 768) and 9 (vitl-518's D = 1024) at ``approx`` stage by stage
    against their plain versions (the GELU stage bit for bit through a
    selection fc1, the rest by the exact chains' bounds), each timed with
    CUDA events beside the exact-GELU chain on the same operands."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    check_gelu_tanh(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    out = {}
    for row, d in ((8, DIM), (8, DIM_B), (9, DIM_L)):
        key = "mlp_residual" if row == 8 else "mlp_residual_hblocked"
        args = mlp_args(gen, B * N_TOK, d)
        r = check_mlp_chain(row, key, args, stages=True, approx=True)
        r["gelu_stage_bit_exact"] = selection_gelu_stage(row, args)
        r["exact_ms"] = event_ms(lambda: getattr(mlp, key)(*args))
        log(f"row {row} gelu tanh D={d} M={B * N_TOK}: {json.dumps(r)}")
        out[f"{key}_tanh D={d}"] = r
        del args
        torch.cuda.empty_cache()
    return out


def gelu_tanh_paths(device, rng) -> dict:
    """Phase 7 (c): one batch of vitb-518 ``--gelu tanh --mlp_fused auto``
    through process_segment with every check of phase 4's checked paths
    (exactly its kernels, row 8's tanh variant in the exact one's place,
    and each its count a step; no host sync in a step; the right half the
    input; the SBS the plain warp of its own depth; depth against the plain
    versions and f32 with phase 4's bounds), and one batch of vitl-518
    ``--gelu tanh`` (row 9's tanh variant in the exact one's place)."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import random_state_dict
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler

    frames = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    out = {}
    cfg = dataclasses.replace(run_config("vitb", "auto", "auto"), gelu="tanh")
    sd = random_state_dict(cfg.model(), SEED)
    pipe = make_pipe(device, cfg, sd)
    calibrate_random_scaler(pipe, frames)
    pipe32 = make_pipe(device, dataclasses.replace(
        cfg, compute_dtype="float32"), sd)
    del sd
    pipe32.model.cfg = pipe.model.cfg
    label = "vitb-518 auto/auto gelu tanh"
    stats = checked_path(label, pipe, frames, VITB_518_TANH, pipe32)
    per_step = {k: v for k, v in stats["launches"].items() if v}
    require(per_step == VITB_518_TANH_STEP, f"{label} launched {per_step} in "
            f"one step, expected {VITB_518_TANH_STEP}")
    out[label] = stats
    del pipe, pipe32
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(run_config("vitl", "auto", "auto"), gelu="tanh")
    pipe = make_pipe(device, cfg)
    calibrate_random_scaler(pipe, frames)
    label = "vitl-518 auto/auto gelu tanh"
    out[label] = one_batch(label, pipe, frames, VITL_518_TANH)
    del pipe
    torch.cuda.empty_cache()
    return out


def sharded_steps(device, rng) -> dict:
    """Phase 7 (d) and (e): ``ShardedSbsPipeline`` at vits ``auto``, 1080p,
    B = 8, with the calibrated scaler: at a 1 x 1 mesh on ``device``, three
    steps' SBS and state equal to ``SbsPipeline.step``'s bit for bit, its
    kernels exactly vits ``auto``'s; at two slots on ``device``
    (``make_mesh((2, 1), devices=[device, device])``), each slot equal to
    its own ``SbsPipeline`` over its own frames bit for bit over three
    steps, at depth_stride 1 and 2. The host ms of one sharded step's
    dispatch (every slot's work issued, nothing read back), median of 10,
    at 1 and 2 slots, beside the same round of eager replica steps (what a
    one-thread loop without the graphs would issue)."""
    import torch

    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
    from vr_video_generator_tpu_torch.parallel.sharded import \
        ShardedSbsPipeline
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler

    out = {}
    frames = rng.integers(0, 256, (6 * B, H, W, 3), dtype=np.uint8)
    base = make_pipe(device, run_config("vits", "auto", "auto"))
    calibrate_random_scaler(base, frames[:B])
    model = base.model
    del base

    def eager_round(sp, parts, states):
        return None, [r.step(p, st)[1] for r, p, st in zip(sp.replicas,
                                                            parts, states)]

    def dispatch_ms(step, parts, states, n=10):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, states = step(parts, states)
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(times))

    for s in (1, 2):
        cfg = dataclasses.replace(run_config("vits", "auto", "auto"),
                                  depth_stride=s)
        for slots in (1, 2):
            label = f"sharded {slots}x1 on {device} depth_stride {s}"
            mesh = make_mesh((slots, 1), devices=[device] * slots)
            sp = ShardedSbsPipeline(model, H, W, mesh, run_cfg=cfg)
            singles = [SbsPipeline(r.model, H, W, run_cfg=cfg)
                       for r in sp.replicas]
            states = sp.initial_state()
            sstates = [p.initial_state() for p in singles]
            parts_seq = [[torch.from_numpy(frames[(3 * i + k) * B:
                                                  (3 * i + k + 1) * B]).to(
                device) for i in range(slots)] for k in range(3)]
            sp.step(parts_seq[0], states)  # warm-up: builds, graph capture
            torch.cuda.synchronize()
            reset_launch_counts()
            for k, parts in enumerate(parts_seq):
                sbs, states = sp.step(parts, states)
                for i, single in enumerate(singles):
                    want, sstates[i] = single.step(parts[i], sstates[i])
                    require(torch.equal(sbs[i], want),
                            f"{label}: slot {i}'s SBS of step {k} differs "
                            f"from its SbsPipeline's")
                    require(states_equal(states[i], sstates[i]),
                            f"{label}: slot {i}'s state after step {k} "
                            f"differs from its SbsPipeline's")
            torch.cuda.synchronize()
            counts = launch_counts()
            launched_exactly(label, counts, AUTO_VITS)
            ms = {"graphs": dispatch_ms(sp.step, parts_seq[0], states),
                  "eager": dispatch_ms(lambda p, st: eager_round(sp, p, st),
                                       parts_seq[0], states)}
            out[label] = dict(host_dispatch_ms=ms,
                              launches={k: v for k, v in counts.items() if v})
            log(f"{label}: 3 steps, each slot's SBS and state equal to its "
                f"SbsPipeline's bit for bit; host ms of one sharded step's "
                f"dispatch (median of 10): {json.dumps(ms)}")
            del sp, singles, states, sstates, parts_seq
            torch.cuda.empty_cache()
    del model
    return out


def mesh_cli(device, rng) -> dict:
    """Phase 7 (f): ``cli.main`` with ``--mesh 1x1`` end to end (repair mode
    1: convert only) on a 1080p mp4 (cv2, 24 frames) equal to the run
    without ``--mesh``, decoded subclip by subclip; then, with the middle
    subclip of the mesh run lost, ``check_and_repair`` with the mesh set
    finds the gap and converts it again, equal to the full run's."""
    import tempfile

    import cv2

    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch.runtime import orchestrator
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    frames = rng.integers(0, 256, (3 * B, H, W, 3), dtype=np.uint8)

    def decoded(d):
        clips = {}
        for name in sorted_subclips(d):
            path = os.path.join(d, name)
            with VideoReader(path, begin=0, backend="cv2") as r:
                clips[name] = np.stack(list(r.frames(0, r.frame_count)))
        return clips

    out = {}
    with tempfile.TemporaryDirectory() as d:
        video = os.path.join(d, "in.mp4")
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (W, H))
        for f in frames:
            vw.write(f[:, :, ::-1])
        vw.release()
        runs = {}
        for tag, extra in (("single", []), ("mesh", ["--mesh", "1x1"])):
            sub = os.path.join(d, f"S_{tag}") + os.sep
            argv = ["--device", device.type, "--VideoDir", video,
                    "--OutputDir", os.path.join(d, f"{tag}.mkv"),
                    "--DebugDir", os.path.join(d, f"D_{tag}") + os.sep,
                    "--SubClipDir", sub, "--Max_Frame_Count", "6",
                    "--batch_size", str(B), "--repair_mode", "1",
                    "--reader_backend", "cv2", "--writer_backend", "cv2",
                    "--allow_random_weights", *extra]
            t0 = time.perf_counter()
            require(cli.main(argv) == 0, f"cli {tag}: non-zero exit")
            runs[tag] = (sub, argv, time.perf_counter() - t0)
        single, mesh = decoded(runs["single"][0]), decoded(runs["mesh"][0])
        names = [f"{i}_{min(i + 6, 3 * B) - 1}.mp4" for i in range(0, 3 * B, 6)]
        require(list(single) == list(mesh) == names,
                f"cli --mesh 1x1: subclips {list(mesh)}, without "
                f"{list(single)}")
        for name in single:
            require(np.array_equal(single[name], mesh[name]),
                    f"cli --mesh 1x1: {name} differs from the run without "
                    f"--mesh")
        os.remove(os.path.join(runs["mesh"][0], "6_11.mp4"))
        cfg, _ = cli.parse_run_config(runs["mesh"][1])
        t0 = time.perf_counter()
        issues = orchestrator.check_and_repair(cfg, repair=True,
                                               allow_random=True,
                                               device=device.type)
        repair_s = time.perf_counter() - t0
        require([i.repair_range for i in issues] == [(6, 12)],
                f"check_and_repair found {issues}")
        repaired = decoded(runs["mesh"][0])
        require(np.array_equal(repaired["6_11.mp4"], single["6_11.mp4"]),
                "check_and_repair with --mesh 1x1: the repaired 6_11 differs "
                "from the full run's")
        out = dict(clips=list(single), single_s=runs["single"][2],
                   mesh_s=runs["mesh"][2], repair_s=repair_s)
    log(f"cli --mesh 1x1: 24 frames of a 1080p mp4, subclips equal to the run "
        f"without --mesh; the lost 6_11 repaired by check_and_repair with "
        f"the mesh, equal to the full run's: {json.dumps(out)}")
    return out


def sharded_path(device, rng) -> dict:
    """Phase 7: --gelu tanh and the data axis (see the module's header)."""
    from vr_video_generator_tpu_torch import bench

    out, t0 = {}, time.perf_counter()
    out["tanh_kernels"] = tanh_kernels(device)
    log(f"phase 7 (a, b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["tanh_paths"] = gelu_tanh_paths(device, rng)
    log(f"phase 7 (c): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["sharded_steps"] = sharded_steps(device, rng)
    log(f"phase 7 (d, e): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["mesh_cli"] = mesh_cli(device, rng)
    log(f"phase 7 (f): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    line = bench.run_sharded_config(2, (1, 1), reps=2)
    print(json.dumps(line), flush=True)
    require(line["value"] > 0 and line["metric"].endswith("_sharded_mesh1x1"),
            f"bench --sharded 1x1 --config 2: {line}")
    out["bench"] = line
    log(f"phase 7 (g) bench --sharded 1x1 --config 2 --reps 2: "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 8: f32 on the card.

# The f32 variants of rows 1, 2, 5-12 and 15-17 (--compute_dtype float32),
# with their sources and the TPU kernels they replace (rows 11 and 12 at
# f32 are one entry point, front and back: the row-11 body is named).
KERNELS_F32 = {
    "layernorm_f32": ("cuda", f"{PKG}/csrc/layernorm.cu",
                      f"{JAX_PKG}/ops/layernorm.py:33"),
    "ln_qkv_f32": ("cuda", f"{PKG}/csrc/qkv_f32.cu",
                   f"{JAX_PKG}/ops/qkv_pallas.py:59"),
    "proj_ls_residual_f32": ("cuda", f"{PKG}/csrc/qkv_f32.cu",
                             f"{JAX_PKG}/ops/qkv_pallas.py:137"),
    "attention_f32": ("cuda", f"{PKG}/csrc/attention_f32.cu",
                      f"{JAX_PKG}/ops/attention_pallas.py:43"),
    "flash_attention_f32": ("cuda", f"{PKG}/csrc/attention_f32.cu",
                            f"{JAX_PKG}/ops/attention.py:53"),
    "head_tail_ext_f32": ("cuda", f"{PKG}/csrc/head_tail_big.cu",
                          f"{JAX_PKG}/ops/head_tail_pallas.py:254"),
    "mlp_residual_f32": ("cuda", f"{PKG}/csrc/mlp_f32.cu",
                         f"{JAX_PKG}/ops/mlp_pallas.py:66"),
    "mlp_residual_hblocked_f32": ("cuda", f"{PKG}/csrc/mlp_f32.cu",
                                  f"{JAX_PKG}/ops/mlp_pallas.py:38"),
    "head_tail_big_f32": ("cuda", f"{PKG}/csrc/head_tail_big.cu",
                          f"{JAX_PKG}/ops/head_tail_pallas.py:480"),
    "swiglu_residual_f32": ("cuda", f"{PKG}/csrc/swiglu_f32.cu",
                            f"{JAX_PKG}/ops/mlp_pallas.py:101"),
    # The weights' TF32 split that rows 5-12, 15 and 16 at f32 take (once
    # per weight, at a path's first step), named with row 10's TPU kernel.
    "tf32x3_split": ("cuda", f"{PKG}/csrc/tf32x3_split.cu",
                     f"{JAX_PKG}/ops/mlp_pallas.py:101"),
    "head_tail_f32": ("cuda", f"{PKG}/csrc/head_tail_big.cu",
                      f"{JAX_PKG}/ops/head_tail_pallas.py:90"),
    "rcu_pair_f32": ("cuda", f"{PKG}/csrc/rcu_pair_f32.cu",
                     f"{JAX_PKG}/attic/refinenet_pre.py:47"),
}
# The f32 kernels' operations bound: the least time for the work at f32
# accuracy, whatever implements it. The larger of the card's f32 rate
# outside the tensor cores (67 TFLOP/s, H100 SXM data sheet) and a third of
# its dense TF32 rate (495 TFLOP/s): 3xTF32 takes three TF32 products for
# one f32-accurate one (rows 2 and 17 run so, csrc/attention_f32.cu).
F32_SIMT_FLOP_PER_S, TF32_FLOP_PER_S = 67e12, 495e12
F32_FLOP_PER_S = max(F32_SIMT_FLOP_PER_S, TF32_FLOP_PER_S / 3)
# One vits auto step at f32 (1080p, B = 8, --input_size 518): the attention
# half fused (attn_fusable(384, 2443, f32)), the MLP half unfused (D < 512:
# cuBLAS SGEMMs and the eager GELU), the ext tail at C = 64; LayerNorm at
# norm2 of each block and the four taps.
AUTO_VITS_F32_STEP = {"layernorm_f32": 16, "ln_qkv_f32": 12,
                      "attention_f32": 12, "proj_ls_residual_f32": 12,
                      "head_tail_ext_f32": 1, "warp_composite": 1,
                      "blur_select_sbs": 1}
# vitb-518 auto at f32 (1080p, B = 8): the attention half fused
# (attn_fusable(768, 2443, f32): 128-token blocks), the MLP half on row 9 at
# f32 (its f32 weights, 18.9 MB, pass 10 MiB), the big-C tail at C = 128;
# LayerNorm only at the four taps.
AUTO_VITB_F32_STEP = {"layernorm_f32": 4, "ln_qkv_f32": 12,
                      "attention_f32": 12, "proj_ls_residual_f32": 12,
                      "mlp_residual_hblocked_f32": 12, "head_tail_big_f32": 1,
                      "warp_composite": 1, "blur_select_sbs": 1}
# vitg-518 auto at f32 (1080p, B = 8, 40 blocks): the attention half
# unfused (D = 1536 is not attn_fusable: LayerNorm, cuBLAS qkv and proj,
# the one-shot attention at 2443 tokens), the SwiGLU half on row 10 at f32,
# the tail unfused (no f32 plan fits: cuDNN); LayerNorm at norm1 of each
# block and the four taps.
AUTO_VITG_F32_STEP = {"layernorm_f32": 44, "attention_f32": 40,
                      "swiglu_residual_f32": 40, "warp_composite": 1,
                      "blur_select_sbs": 1}
# The weight splits (tf32x3_split) of an auto path's first step at f32: two
# a block whose attention half is fused (qkv and proj, rows 5 and 6: vits'
# and vitb's 12 blocks; vitg's D = 1536 is not attn_fusable), two a block
# whose MLP half is fused (vitb's 12 row 9 halves, vitg's 40 row 10 halves;
# vits auto leaves the MLP half unfused), the big-C tail's two convs (rows
# 11 + 12 at vitb-518; vitg-518 auto takes cuDNN's tail) and the ext tail's
# mix and two convs (row 7 at vits); later steps split none.
AUTO_F32_SPLITS = {"vits": 24 + 3, "vitb": 24 + 24 + 2, "vitg": 80}
# vitg-126 fused at f32 (1080p, B = 8, 40 blocks, 145 tokens): the same
# encoder kernels, and the big-C tail at C = 384 at f32 (rows 11 + 12).
VITG_126_F32_STEP = {"layernorm_f32": 44, "attention_f32": 40,
                     "swiglu_residual_f32": 40, "head_tail_big_f32": 1,
                     "warp_composite": 1, "blur_select_sbs": 1}
# Rows 15 and 16 at f32 called as a user calls them, one width at a time
# (vits' C = 64, vitb's 128): the single-kernel tail on path1, and the RCU
# pair feeding the ext tail, each on fresh weights: the single-kernel
# tail's two convs, the RCU pair's four and the ext tail's mix and two
# convs split once (9 tf32x3_split).
OFF_CLI_F32 = ("head_tail_f32", "rcu_pair_f32", "head_tail_ext_f32",
               "tf32x3_split")
OFF_CLI_F32_SPLITS = 2 + 4 + 3
# The other fused f32 paths of phase 8 (c), one batch each: (label, encoder,
# --input_size, mlp_fused = tail, blocks (None: all), batch, one step's
# launches). vits fused runs row 8 at f32 (4.7 MB of f32 weights, resident)
# and the ext tail at C = 64; vitb-252 auto the ext tail at C = 128; vitl-518
# auto (4 blocks, batch 2) its attention half unfused (attn_fusable is False
# at D = 1024 in f32: LayerNorm, cuBLAS qkv and proj, the one-shot
# attention), row 9 at f32 and the tail unfused (no plan fits at f32).
F32_FUSED_PATHS = (
    ("vits-518 fused/fused f32", "vits", 518, "fused", None, B,
     {"layernorm_f32": 4, "ln_qkv_f32": 12, "attention_f32": 12,
      "proj_ls_residual_f32": 12, "mlp_residual_f32": 12,
      "head_tail_ext_f32": 1, "warp_composite": 1, "blur_select_sbs": 1}),
    ("vitb-252 auto/auto f32", "vitb", 252, "auto", None, B,
     {"layernorm_f32": 4, "ln_qkv_f32": 12, "attention_f32": 12,
      "proj_ls_residual_f32": 12, "mlp_residual_hblocked_f32": 12,
      "head_tail_ext_f32": 1, "warp_composite": 1, "blur_select_sbs": 1}),
    ("vitl-518 auto/auto f32", "vitl", 518, "auto", 4, 2,
     {"layernorm_f32": 4 + 4, "attention_f32": 4,
      "mlp_residual_hblocked_f32": 4, "warp_composite": 1,
      "blur_select_sbs": 1}))
# The f32 CLI paths first run in phase 8 (c4), one batch each, held as
# F32_FUSED_PATHS are (label, encoder, --input_size, mlp_fused = tail,
# blocks (None: all), batch, one step's launches, head features (None: the
# encoder's)). A custom 32-feature head at vits-518 auto: row 7 at f32 at C
# = 32, once a step, and no cuDNN conv in its tail. vitg-728 auto (4 of 40
# blocks, batch 2): the attention half unfused past 4096 tokens, row 17 at
# f32 at 24 heads, row 10, the tail unfused (no f32 plan fits); vitl-126
# auto (4 of 24 blocks): row 2, row 9, row 7 at C = 256; vitg-56 auto (4
# of 40 blocks): row 2, row 10, row 7 at C = 384; vits-728 auto (all 12
# blocks): row 17 at 6 heads, the MLP half unfused, rows 11 + 12 at C = 64;
# vitl-252 auto (4 of 24 blocks): row 2, row 9, rows 11 + 12 at C = 256.
F32_NEW_PATHS = (
    ("vits-518 auto/auto f32 C=32", "vits", 518, "auto", None, B,
     dict(AUTO_VITS_F32_STEP), 32),
    ("vitg-728 auto/auto f32", "vitg", 728, "auto", 4, 2,
     {"layernorm_f32": 4 + 4, "flash_attention_f32": 4,
      "swiglu_residual_f32": 4, "warp_composite": 1, "blur_select_sbs": 1},
     None),
    ("vitl-126 auto/auto f32", "vitl", 126, "auto", 4, B,
     {"layernorm_f32": 4 + 4, "attention_f32": 4,
      "mlp_residual_hblocked_f32": 4, "head_tail_ext_f32": 1,
      "warp_composite": 1, "blur_select_sbs": 1}, None),
    ("vitg-56 auto/auto f32", "vitg", 56, "auto", 4, B,
     {"layernorm_f32": 4 + 4, "attention_f32": 4, "swiglu_residual_f32": 4,
      "head_tail_ext_f32": 1, "warp_composite": 1, "blur_select_sbs": 1},
     None),
    ("vits-728 auto/auto f32", "vits", 728, "auto", None, B,
     {"layernorm_f32": 24 + 4, "flash_attention_f32": 12,
      "head_tail_big_f32": 1, "warp_composite": 1, "blur_select_sbs": 1},
     None),
    ("vitl-252 auto/auto f32", "vitl", 252, "auto", 4, B,
     {"layernorm_f32": 4 + 4, "attention_f32": 4,
      "mlp_residual_hblocked_f32": 4, "head_tail_big_f32": 1,
      "warp_composite": 1, "blur_select_sbs": 1}, None))
# The f32 tails held in phase 8 (a): (C, grid, depth size) of the path that
# runs each. Rows 11 and 12: vits-728 (C = 64), vitb-518 (128), vitl-252
# (256), vitg-126 (384). Row 7: a 32-feature vits-518 head (C = 32, C2
# zero-padded to 32), vits-518 (64), vitb-252 (128), vitl-126 (256), C =
# 384 at the 126 grid (vitg's f32 plans take the big-C tail there and at
# 252) and at vitg-56's (row 7 at small inputs).
GRID_56, OUT_HW_56 = (16, 28), (56, 98)
BIG_F32_SHAPES = ((64, GRID_L728, OUT_HW_L728), (128, (H0, W0), OUT_HW),
                  (256, *EXT_WIDE[256]), (384, *EXT_WIDE[384]))
EXT_F32_SHAPES = ((32, (H0, W0), OUT_HW), (64, (H0, W0), OUT_HW),
                  (128, *EXT_WIDE[256]), (256, *EXT_WIDE[384]),
                  (384, *EXT_WIDE[384]), (384, GRID_56, OUT_HW_56))
# --mlp_fused xla --tail xla at f32: LayerNorm twice a block and at the four
# taps, the one-shot attention (N <= 4096) or the flash kernel (N > 4096).
XLA_F32 = ("layernorm_f32", "attention_f32", "warp_composite",
           "blur_select_sbs")
XLA_F32_FLASH = ("layernorm_f32", "flash_attention_f32", "warp_composite",
                 "blur_select_sbs")
# vitl and vitg on the xla path in phase 8 run 4 of their blocks (taps at
# blocks 0-3) at their full width: the kernels' shapes are the width's and
# the token count's, not the depth's; at batch 2.
F32_CUT_DEPTH, F32_CUT_BATCH = 4, 2
# Bounds of the f32 kernels against their plain versions, both f32 with
# both TF32 flags off. The dense rows (1, 5, 6) in f32 ulps of each output's
# scale (as operand_ulps, at 23 bits): only the sums' order differs. Rows 2
# and 17 relative to max / mean |o|, the tail relative to the depth's
# range. Each bound must refuse the same function computed with TF32 (10
# mantissa bits: thousands of f32 ulps, ~1e-3 relative), which the check
# shows on the same operands. Measured (NVIDIA H100 80GB HBM3, 700.00 W):
# row 1 6 ulps, row 5 24, row 6 0, row 7's conv1 (K = 576) 64, its passes
# 3-6; TF32 10698-24430 ulps. Rows 2, 17 and 7 at most 3.4e-6 (max) of
# |o| or the range; TF32 5.4e-4-8.3e-4. Rows 2 and 17 on 3xTF32 wgmma: at
# most 3.7e-6 (max) and 1.1e-6 (mean) of |o| (attention_bench). Rows 8, 9
# and 10 on 3xTF32 wgmma, against the plain versions on f64 operands: at
# most 54 ulps on vitg-518's gate, where cuBLAS's f32 products are 282 off.
F32_MAX_ULPS = 256
ATTN_F32_MAX_REL, ATTN_F32_MEAN_REL = 1e-4, 1e-5
TAIL_F32_MAX_REL, TAIL_F32_MEAN_REL = 1e-4, 1e-5
# Depth of the f32 kernel path against a plain f64 forward on the same
# weights and input: at most this many times the plain f32 path's error,
# in max and in mean (vits auto; vitb-518 auto, the slice's path, at
# F32_DEPTH_FACTOR_VITB).
F32_DEPTH_FACTOR = 2.0
F32_DEPTH_FACTOR_VITB = 1.25


def bound_f32(moved: int, flops: float) -> dict:
    """The least time the card could take for an f32 kernel: the larger of
    the bytes over the HBM rate and the FLOPs over the f32 rate."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def tf32(on: bool):
    """Both TF32 flags set to ``on``, restored after."""
    import torch

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = on
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def tf32_round(x):
    """x rounded to TF32's 10 mantissa bits (to nearest, ties to even)."""
    import torch

    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def f32_ulps(got, want, feature_dims, *addends):
    """|got - want| in f32 ulps of the output's scale (operand_ulps' scale:
    |want|, its feature's RMS, each addend and what the addends leave)."""
    import torch

    w = want.double()
    lead = tuple(range(w.ndim - feature_dims))
    size = torch.maximum(w.abs(), w.square().mean(dim=lead).sqrt())
    rest = w
    for t in addends:
        size = torch.maximum(size, t.double().abs())
        rest = rest - t.double()
        size = torch.maximum(size, rest.abs())
    ulp = torch.exp2(torch.floor(torch.log2(size.clamp_min(2.0 ** -126))) - 23)
    return (got.double() - w).abs() / ulp


def f32_dense_check(name, got, want, tf32_want, feature_dims, *addends):
    """A dense f32 kernel against its plain version within F32_MAX_ULPS; the
    same function at TF32 must be outside it."""
    ulps = f32_ulps(got, want, feature_dims, *addends)
    tf = f32_ulps(tf32_want, want, feature_dims, *addends)
    stats = dict(max_abs_err=(got.double() - want.double()).abs().max().item(),
                 max_ulps=ulps.max().item(), mean_ulps=ulps.mean().item(),
                 tf32_max_ulps=tf.max().item(),
                 tf32_mean_ulps=tf.mean().item())
    require(stats["max_ulps"] <= F32_MAX_ULPS,
            f"{name}: {json.dumps(stats)} over the bound of {F32_MAX_ULPS} "
            f"f32 ulps")
    require(stats["tf32_max_ulps"] > F32_MAX_ULPS,
            f"{name}: the TF32 result is within the f32 bound "
            f"({json.dumps(stats)}): the bound cannot tell f32 from TF32")
    return stats


def f32_exact_check(name, got, exact, plain, tf32_want, feature_dims,
                    *addends, hold_mean=True):
    """A kernel on the 3xTF32 core (rows 5-10 at f32) within
    F32_MAX_ULPS of its plain version evaluated on f64 operands (``exact``:
    its products and sums to f64, each elementwise step as the plain version
    has it), the TF32 result of the same operands refused by that bound
    (f32_dense_check). The f32 plain version (``plain``: cuBLAS's f32
    sums) is held against the same reference and logged beside it, with the
    kernel's distance from it: its own error reaches the bound (282 ulps on
    vitg-518's gate, where the kernel is 54 off, on an NVIDIA H100), so a
    kernel that sums in another order than cuBLAS is not held to cuBLAS's
    own error. The kernel must be at least as close to the reference as
    the f32 plain version on average (unless ``hold_mean`` is False: then
    that comparison is only logged)."""
    stats = f32_dense_check(name, got, exact, tf32_want, feature_dims,
                            *addends)
    u_plain = f32_ulps(plain, exact, feature_dims, *addends)
    u_got = f32_ulps(got, plain, feature_dims, *addends)
    stats.update(plain_max_ulps=u_plain.max().item(),
                 plain_mean_ulps=u_plain.mean().item(),
                 vs_plain_max_ulps=u_got.max().item(),
                 vs_plain_mean_ulps=u_got.mean().item())
    require(not hold_mean or stats["mean_ulps"] <= stats["plain_mean_ulps"],
            f"{name}: {json.dumps(stats)}: further from the f64 reference "
            f"on average than the f32 plain version")
    return stats


def f64(*tensors):
    """The tensors as f64 (the plain versions' exact reference)."""
    return tuple(t.double() for t in tensors)


def f32_rel_check(name, got, want, tf32_want, max_rel, mean_rel, span=None):
    """An f32 kernel against its plain version, its error relative to max /
    mean |want| (attention) or to ``span`` (the depth's range); the same
    function at TF32 must exceed the max bound."""
    def rel(a):
        err = (a.double() - want.double()).abs()
        size_max = span if span else want.double().abs().max().item()
        size_mean = span if span else want.double().abs().mean().item()
        return (err.max().item(), err.mean().item(),
                err.max().item() / size_max, err.mean().item() / size_mean)
    mx, mean, mx_rel, mean_rel_err = rel(got)
    _, _, tf_mx_rel, tf_mean_rel = rel(tf32_want)
    stats = dict(max_abs_err=mx, mean_abs_err=mean, max_rel_err=mx_rel,
                 mean_rel_err=mean_rel_err, tf32_max_rel_err=tf_mx_rel,
                 tf32_mean_rel_err=tf_mean_rel)
    require(mx_rel <= max_rel and mean_rel_err <= mean_rel,
            f"{name}: {json.dumps(stats)} over bounds max rel {max_rel}, "
            f"mean rel {mean_rel}")
    require(tf_mx_rel > max_rel,
            f"{name}: the TF32 result is within the f32 bound "
            f"({json.dumps(stats)}): the bound cannot tell f32 from TF32")
    return stats


def f32_mlp_check(gen, row: int, d: int, m: int = B * N_TOK,
                  hid: int = 0) -> dict:
    """Row 8 or 9 at f32 on (m, d) seeded rows, hidden ``hid`` (4D unless
    given): each stage on
    the chain's own input (the LN rows within the f32 bound of the plain
    LayerNorm; fc1 + b1 + GELU, its scale taking in the GELU's input, and
    fc2 + b2 + LayerScale + residual with the dense f32 bound), the whole
    output against mlp_residual_plain, the products' stages and the whole
    against the plain versions on f64 operands (f32_exact_check); each
    bound refuses the same function with the weights rounded to TF32.
    Timed beside the plain version and cuBLAS's two f32 products (addmm,
    TF32 off), with the f32 bound."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp
    from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    hid = hid or 4 * d
    x = randn(gen, (B, m // B, d))
    args = (x, randn(gen, (d,), 0.1, 1.0), randn(gen, (d,), 0.1),
            randn(gen, (hid, d), d ** -0.5), randn(gen, (hid,), 0.5),
            randn(gen, (d, hid), hid ** -0.5), randn(gen, (d,), 0.5),
            randn(gen, (d,), 0.1, 1.0))
    _, lnw, lnb, w1, b1, w2, b2, gamma = args
    tf_args = (*args[:3], tf32_round(w1), b1, tf32_round(w2), *args[6:])
    fn = mlp.mlp_residual if row == 8 else mlp.mlp_residual_hblocked
    stages = (mlp.mlp_residual_stages if row == 8
              else mlp.mlp_residual_hblocked_stages)
    a, h, got = stages(*args)
    torch.cuda.synchronize()
    name = f"{'mlp_residual' if row == 8 else 'mlp_residual_hblocked'}_f32"
    label = f"{name} D={d}" + ("" if hid == 4 * d else f" H={hid}")
    st = {}
    u = f32_ulps(a, layernorm_plain(x, lnw, lnb).reshape(m, d), 1, lnb)
    st["ln"] = dict(max_ulps=u.max().item())
    require(st["ln"]["max_ulps"] <= F32_MAX_ULPS,
            f"{label} LN stage: {st['ln']} over {F32_MAX_ULPS} f32 ulps")
    t = torch.addmm(b1, a, w1.t())
    st["fc1_gelu"] = f32_exact_check(
        f"{label} fc1 + GELU", h, mlp.fc1_gelu_plain(*f64(a, w1, b1)),
        mlp.fc1_gelu_plain(a, w1, b1),
        mlp.fc1_gelu_plain(a, tf32_round(w1), b1), 1, t)
    del t
    x2 = x.reshape(m, d)
    st["fc2_residual"] = f32_exact_check(
        f"{label} fc2 + residual", got.reshape(m, d),
        mlp.fc2_residual_plain(*f64(h, w2, b2, gamma, x2)),
        mlp.fc2_residual_plain(h, w2, b2, gamma, x2),
        mlp.fc2_residual_plain(h, tf32_round(w2), b2, gamma, x2), 1, x2,
        gamma * b2)
    del a
    stats = f32_exact_check(label, got, mlp.mlp_residual_plain(*f64(*args)),
                            mlp.mlp_residual_plain(*args),
                            mlp.mlp_residual_plain(*tf_args), 1, x, gamma * b2)
    del got
    log(f"{label} stages: {json.dumps(st)}")
    fc = 2 * m * d * hid
    hh = torch.empty_like(h)
    res = dict(**stats, stages=st, ms=event_ms(lambda: fn(*args)),
               plain_ms=event_ms(lambda: mlp.mlp_residual_plain(*args)),
               library_ms=event_ms(lambda: (torch.addmm(b1, x2, w1.t()),
                                            torch.addmm(b2, hh, w2.t()))),
               **bound_f32(nbytes(*args) + 4 * m * d, 2 * fc))
    log(f"kernel {label}: {json.dumps(res)}")
    return res


def f32_qkv_check(label, args, got, hold_mean=True) -> dict:
    """Row 5 at f32 (``got`` = ln_qkv(*args)): its product stage, on the LN
    rows the chain's first launch writes (row 1's f32 kernel on the same
    operands), by f32_exact_check (``hold_mean`` passed on) against
    qkv_plain on f64 operands, the f32 plain stage (cuBLAS's sums) beside
    it; the whole within F32_MAX_ULPS of ln_qkv_plain on f64 operands (its
    LN torch's f32 one), the TF32 result refused. The scale takes in the
    bias, q's scaled."""
    from vr_video_generator_tpu_torch.ops.layernorm import layernorm
    from vr_video_generator_tpu_torch.ops.qkv import ln_qkv_plain, qkv_plain

    x, lnw, lnb, w, b, heads, scale = args
    a = layernorm(x, lnw, lnb)
    bias = b.reshape(3, heads, -1).clone()
    bias[0] *= scale
    stage = f32_exact_check(
        f"{label} qkv", got, qkv_plain(*f64(a, w, b), heads, scale),
        qkv_plain(a, w, b, heads, scale),
        qkv_plain(a, tf32_round(w), b, heads, scale), 3, bias,
        hold_mean=hold_mean)
    del a
    whole = f32_dense_check(
        label, got, ln_qkv_plain(*f64(x, lnw, lnb, w, b), heads, scale),
        ln_qkv_plain(x, lnw, lnb, tf32_round(w), b, heads, scale), 3, bias)
    return dict(**stage, whole=whole)


def f32_proj_check(label, args, got, hold_mean=True) -> dict:
    """Row 6 at f32 (``got`` = proj_ls_residual(*args)) by f32_exact_check
    (``hold_mean`` passed on) against proj_ls_residual_plain on f64
    operands, the scale taking in the residual and gamma * b."""
    from vr_video_generator_tpu_torch.ops.qkv import proj_ls_residual_plain

    o, x, w, b, gamma = args
    return f32_exact_check(
        label, got, proj_ls_residual_plain(*f64(*args)),
        proj_ls_residual_plain(*args),
        proj_ls_residual_plain(o, x, tf32_round(w), b, gamma), 1, x,
        gamma * b, hold_mean=hold_mean)


def selection_sum(v):
    """What a 3xTF32 product of v with 1 gives, every other term 0: hi(v) +
    lo(v) (csrc/tf32x3.cuh's split), exact in f32."""
    from vr_video_generator_tpu_torch.ops import mlp

    hi, lo = mlp.tf32x3_split_plain(v)
    return hi + lo


def check_gelu_f32(device) -> dict:
    """The GELU of rows 8 and 9's f32 fc1 epilogue (csrc/gelu_as.cuh) bit for
    bit against the eager f32 chain (ops/gelu.gelu_exact), through a
    selection fc1 (fc1_gelu_kernel with w1 (512, 128) picking input column n
    mod 128 for output n and b1 = 0): every finite bf16 value as f32, 2^18
    values spaced evenly over [-8, 8], and the 8192 f32 values below -5.75
    where the A&S form flushes to -0.0. On the 3xTF32 core the selection's
    sum of a is hi(a) + lo(a) (its only non-zero products, a_lo * 1 and
    a_hi * 1, added exactly): a itself where a has at most 22 significant
    bits (every bf16 value, required), else a to 2^-22 (the linspace and
    flush sets, counted). So each value is compared with the eager chain on
    that sum (selection_sum), and no value set is dropped. The tanh
    variant (approx) against ops/gelu.gelu_tanh on the same sums: bit for
    bit where the card's tanhf and PyTorch's agree, else within 2 f32 ulps
    of max(|x|, |gelu|) (logged)."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp
    from vr_video_generator_tpu_torch.ops.gelu import gelu_exact, gelu_tanh

    f32 = torch.float32
    bf = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16).to(f32)
    flush = (torch.tensor(-5.75, device=device).view(torch.int32)
             - torch.arange(8192, dtype=torch.int32, device=device)).view(f32)
    vals = torch.cat([bf[torch.isfinite(bf)],
                      torch.linspace(-8.0, 8.0, 2 ** 18, device=device),
                      flush])
    sets = {"bf16": int(torch.isfinite(bf).sum()), "linspace": 2 ** 18,
            "flush": 8192}
    vals = torch.cat([vals, torch.zeros((-len(vals)) % 128, device=device)])
    a = vals.reshape(-1, 128)
    sum_a = selection_sum(a)
    moved = (sum_a != a).flatten()
    split_moves, at = {}, 0
    for name, n in sets.items():
        split_moves[name] = int(moved[at:at + n].sum())
        at += n
    require(split_moves["bf16"] == 0,
            f"gelu_f32: hi + lo is not the bf16 value itself: {split_moves}")
    w1 = torch.eye(128, device=device).repeat(4, 1)
    b1 = torch.zeros(512, device=device)
    out = {"values_the_split_moves": split_moves}
    for approx, eager in ((False, gelu_exact), (True, gelu_tanh)):
        got = mlp.fc1_gelu_kernel(a, w1, b1, approx)
        want = eager(sum_a).repeat(1, 4)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        x = a.repeat(1, 4).double()
        size = torch.maximum(x.abs(), want.double().abs()).clamp_min(2 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(size)) - 23)
        ulps = ((got.double() - want.double()).abs() / ulp).max().item()
        key = "tanh" if approx else "exact"
        out[key] = dict(values=len(vals), differ=differ, max_ulps=ulps,
                        flushed_to_zero=int((got[:, :128] == 0).sum()))
        if differ:
            bad = (got != want).any(dim=1).nonzero()[:8, 0]
            out[key]["first_rows_a"] = a[bad, :4].tolist()
        if approx:
            require(ulps <= 2, f"gelu_f32 tanh: {out[key]}")
        else:
            require(differ == 0, f"gelu_f32: the fc1 epilogue's A&S GELU "
                    f"differs from the eager f32 chain: {out[key]}")
    log(f"gelu_f32 (the fc1 epilogue through a selection fc1): "
        f"{json.dumps(out)}")
    return out


def f32_tail_weights(gen, c):
    """Seeded f32 DPT tail weights in PyTorch layout (tail_weights' shapes
    and scales)."""
    c2 = c // 2
    return (randn(gen, (c, c, 1, 1), c ** -0.5), randn(gen, (c,), 0.1),
            randn(gen, (c2, c, 3, 3), (9 * c) ** -0.5), randn(gen, (c2,), 0.1),
            randn(gen, (32, c2, 3, 3), (9 * c2) ** -0.5), randn(gen, (32,), 0.1),
            randn(gen, (1, 32, 1, 1), 32 ** -0.5), randn(gen, (1,), 0.1, 0.5))


def f32_tail_result(label, got_depth, want, tfw, stages, run, plain, library,
                    moved, flops) -> dict:
    """The depth of an f32 tail against its plain version relative to its
    range (TAIL_F32_* bounds, refusing the TF32 depth), the stages logged,
    and the kernel's, the plain version's and the library's times."""
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    span = (want.max() - want.min()).item()
    stats = f32_rel_check(label, got_depth, want, tfw, TAIL_F32_MAX_REL,
                          TAIL_F32_MEAN_REL, span)
    require(span > 0 and (want > 0).float().mean().item() > 0.2,
            f"{label}: depth range {span}, a ReLU left too few pixels")
    log(f"{label} stages: {json.dumps(stages)}")
    return dict(**stats, stages=stages, ms=event_ms(run),
                plain_ms=event_ms(plain), library_ms=event_ms(library),
                **bound_f32(moved, flops))


def f32_ext_tail_check(gen, c: int, grid, out_hw) -> dict:
    """Row 7 at f32, C = c, batch 8, x an NCHW activation seen as NHWC as the
    model hands it over, stage by stage, each on the chain's own input: the
    passes in f32 ulps; the mix, conv1 + b1 and conv2 before its 1x1
    (conv3x3_f32, the same conv on the 3xTF32 core) by f32_exact_check
    against the product on f64 operands (cuBLAS's or cuDNN's f32 result
    logged beside it, its TF32 result refused); conv2 with the 1x1 relative
    to the depth's range; the whole depth against head_tail_ext_plain
    (refusing it with TF32); the library time is cuDNN's two f32 convs."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops import head_tail as ht

    (h0, w0), c2 = grid, c // 2
    x = randn(gen, (B, c, h0, w0)).permute(0, 2, 3, 1)
    wts = f32_tail_weights(gen, c)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    label = f"head_tail_ext_f32 C={c}"
    got = ht.head_tail_ext_stages(x, *wts, out_hw)
    # The mix's TF32 result from TF32-rounded operands (cuBLAS may keep
    # a small f32 product at f32 with TF32 allowed). At C = 32 (K = 32) the
    # core's two truncating 16-wide sums sit further from f64 on average
    # than cuBLAS's f32 product (0.840 against 0.747 mean ulps on an NVIDIA
    # H100 80GB HBM3, 700.00 W; the core's model on the CPU, 0.87 against
    # the CPU's 0.74, and 0.82 with a fresh sum every 8 of K), so there the
    # mean is logged and the max held to the bound.
    tf_mix = ht.ext_mix_plain(tf32_round(x), tf32_round(k_oc))
    stages = dict(mix=f32_exact_check(
        f"{label} mix", got[0], ht.ext_mix_plain(*f64(x, k_oc)),
        ht.ext_mix_plain(x, k_oc), tf_mix, 1, hold_mean=c > 32))
    del tf_mix
    stages["upsample"] = dict(max_ulps=f32_ulps(
        got[1], ht.big_upsample_plain(got[0], b_oc), 1, b_oc).max().item())
    with tf32(True):
        tf_c1 = ht.ext_conv1_plain(got[1], k1, b1)
    stages["conv1"] = f32_exact_check(
        f"{label} conv1", got[2], conv3x3_f64(got[1], k1) + b1.double(),
        ht.ext_conv1_plain(got[1], k1, b1), tf_c1, 1, b1)
    del tf_c1
    stages["resize"] = dict(max_ulps=f32_ulps(
        got[3], ht.ext_resize_plain(got[2], out_hw), 1).max().item())
    for name in ("upsample", "resize"):
        require(stages[name]["max_ulps"] <= F32_MAX_ULPS,
                f"{label} {name}: {stages[name]} over {F32_MAX_ULPS} f32 ulps")
    with tf32(True):
        tf_c2 = ht.conv3x3_f32_plain(got[3], k2)
    stages["conv2"] = f32_exact_check(
        f"{label} conv2", core_conv_sums(got[3], k2), conv3x3_f64(got[3], k2),
        ht.conv3x3_f32_plain(got[3], k2), tf_c2, 1)
    del tf_c2
    depth = ht.big_conv2_plain(got[3], k2, b2, k3, b3)
    want = ht.head_tail_ext_plain(x, *wts, out_hw)
    with tf32(True):
        tfw = ht.head_tail_ext_plain(x, *wts, out_hw)
    torch.cuda.synchronize()
    span = (want.max() - want.min()).item()
    stages["depth"] = dict(max_rel_err=(got[4] - depth).abs().max().item()
                           / span)
    require(stages["depth"]["max_rel_err"] <= TAIL_F32_MAX_REL,
            f"{label} conv2 with the 1x1: {stages['depth']}")
    del depth
    zc = got[1].permute(0, 3, 1, 2).contiguous()
    rc = got[3].permute(0, 3, 1, 2).contiguous()
    m0, m1 = B * h0 * w0, B * 2 * h0 * 2 * w0
    m2 = B * out_hw[0] * out_hw[1]
    flops = 2 * (m0 * c * c + m1 * c2 * 9 * c + m2 * 32 * 9 * c2)
    res = f32_tail_result(
        label, got[4], want, tfw, stages,
        lambda: ht.head_tail_ext(x, *wts, out_hw),
        lambda: ht.head_tail_ext_plain(x, *wts, out_hw),
        lambda: (F.conv2d(zc, k1, b1, padding=1),
                 F.conv2d(rc, k2, b2, padding=1)),
        nbytes(x, *wts, got[4]), flops)
    del got, zc, rc
    log(f"kernel {label}: {json.dumps(res)}")
    return res


def conv3x3_f64(x, k):
    """The 3x3 conv with zero padding of x (B, H, W, C) by k (O, C, 3, 3) on
    f64 operands, (B, H, W, O) f64: a frame at a time, its im2col (F.unfold)
    times k on cuBLAS's f64 product."""
    import torch
    import torch.nn.functional as F

    b, h, w, _ = x.shape
    km = k.double().reshape(k.shape[0], -1)
    out = torch.empty((b, h, w, k.shape[0]), dtype=torch.float64,
                      device=x.device)
    for i in range(b):
        cols = F.unfold(x[i:i + 1].permute(0, 3, 1, 2).double(), 3, padding=1)
        out[i] = (km @ cols[0]).reshape(-1, h, w).permute(1, 2, 0)
    return out


def core_conv_sums(x, k):
    """conv3x3_f32 (the 3x3 conv's sums on the 3xTF32 core) of x by k, their
    channels zero-padded to a multiple of 32: conv2's input channels at a
    custom head's C2 (16 at C = 32), as the f32 chains pad them
    (ops/head_tail.chain_widths)."""
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops import head_tail as ht

    pad = (-x.shape[-1]) % 32
    if pad:
        x, k = F.pad(x, (0, pad)), F.pad(k, (0, 0, 0, 0, 0, pad))
    return ht.conv3x3_f32(x, k)


def f32_big_tail_check(gen, c: int, grid, out_hw) -> dict:
    """Rows 11 and 12 at f32 (vrvg_head_tail_big_f32), C = c, batch 8, x an
    NCHW activation seen as NHWC, stage by stage, each on the chain's own
    input: the upsample and resize passes (with cw) in f32 ulps; the folded
    conv1 and conv2 before its 1x1 (conv3x3_f32, the same conv on the
    3xTF32 core) by f32_exact_check against the conv on f64 operands (cuDNN's
    f32 conv logged beside it, its TF32 conv refused); conv2 with the 1x1
    relative to the depth's range; the whole depth against
    head_tail_big_plain (refusing it with TF32); the library time is cuDNN's
    f32 conv1 (folded weights) and conv2."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops import head_tail as ht

    (h0, w0), c2 = grid, c // 2
    x = randn(gen, (B, c, h0, w0)).permute(0, 2, 3, 1)
    wts = f32_tail_weights(gen, c)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    label = f"head_tail_big_f32 C={c}"
    got = ht.head_tail_big_stages(x, *wts, out_hw)
    stages = dict(upsample=dict(max_ulps=f32_ulps(
        got[0], ht.big_upsample_plain(x), 1).max().item()))
    k1f = ht.fold_conv1(k_oc, k1, torch.float32)
    for name, src, k, out in (("conv1", got[0], k1f, got[1]),
                              ("conv2", got[2], k2, None)):
        if out is None:
            out = core_conv_sums(src, k)
        plain = ht.conv3x3_f32_plain(src, k)
        with tf32(True):
            tf_plain = ht.conv3x3_f32_plain(src, k)
        stages[name] = f32_exact_check(f"{label} {name}", out,
                                       conv3x3_f64(src, k), plain, tf_plain, 1)
        del plain, tf_plain
    r = ht.big_resize_plain(got[1], k1, b_oc, b1, out_hw)
    stages["resize"] = dict(max_ulps=f32_ulps(got[2], r, 1).max().item())
    del r
    depth = ht.big_conv2_plain(got[2], k2, b2, k3, b3)
    want = ht.head_tail_big_plain(x, *wts, out_hw)
    with tf32(True):
        tfw = ht.head_tail_big_plain(x, *wts, out_hw)
    torch.cuda.synchronize()
    for name in ("upsample", "resize"):
        require(stages[name]["max_ulps"] <= F32_MAX_ULPS,
                f"{label} {name}: {stages[name]} over {F32_MAX_ULPS} f32 ulps")
    span = (want.max() - want.min()).item()
    stages["depth"] = dict(max_rel_err=(got[3] - depth).abs().max().item()
                           / span)
    require(stages["depth"]["max_rel_err"] <= TAIL_F32_MAX_REL,
            f"{label} conv2 with the 1x1: {stages['depth']}")
    del depth
    uc = got[0].permute(0, 3, 1, 2).contiguous()
    rc = got[2].permute(0, 3, 1, 2).contiguous()
    hm, w2 = 2 * h0, 2 * w0
    flops = 2 * B * (hm * w2 * c2 * 9 * c + out_hw[0] * out_hw[1] * 32 * 9
                     * c2)
    res = f32_tail_result(
        label, got[3], want, tfw, stages,
        lambda: ht.head_tail_big(x, *wts, out_hw),
        lambda: ht.head_tail_big_plain(x, *wts, out_hw),
        lambda: (F.conv2d(uc, k1f, padding=1),
                 F.conv2d(rc, k2, b2, padding=1)),
        nbytes(x, *wts, got[3]), flops)
    del got, uc, rc
    log(f"kernel {label}: {json.dumps(res)}")
    return res


def f32_swiglu_check(gen, m: int = B * N_TOK, d: int = DIM_G,
                     hid: int = HID_G) -> dict:
    """Row 10 at f32 on (m, d) rows, hidden ``hid`` (vitg-518's (m, 1536)
    rows and 4096 unless given), stage by
    stage, each stage on the chain's own input: the LN rows within the f32
    bound of the plain LayerNorm; the gate (+ b12, silu(x1) * x2), its scale
    taking in |x1 x2|, and the down product (+ b3, LayerScale, residual) by
    the dense f32 bound; the whole output against swiglu_residual_plain; the
    products' stages and the whole against the plain versions on f64
    operands (f32_exact_check). Each bound refuses the same function with
    the weights rounded to TF32. Timed beside the plain version and cuBLAS's two f32 products (addmm,
    TF32 off), with the f32 bound."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp
    from vr_video_generator_tpu_torch.ops.layernorm import layernorm_plain
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    x = randn(gen, (B, m // B, d))
    args = (x, randn(gen, (d,), 0.1, 1.0), randn(gen, (d,), 0.1),
            randn(gen, (2 * hid, d), d ** -0.5), randn(gen, (2 * hid,), 0.5),
            randn(gen, (d, hid), hid ** -0.5), randn(gen, (d,), 0.5),
            randn(gen, (d,), 0.1, 1.0))
    _, lnw, lnb, w12, b12, w3, b3, gamma = args
    tf_args = (*args[:3], tf32_round(w12), b12, tf32_round(w3), *args[6:])
    h, g, got = mlp.swiglu_residual_stages(*args)
    torch.cuda.synchronize()
    label = f"swiglu_residual_f32 D={d}" + (
        "" if hid == HID_G else f" H={hid}")
    st = {}
    u = f32_ulps(h, layernorm_plain(x, lnw, lnb).reshape(m, d), 1, lnb)
    st["ln"] = dict(max_ulps=u.max().item())
    require(st["ln"]["max_ulps"] <= F32_MAX_ULPS,
            f"{label} LN stage: {st['ln']} over {F32_MAX_ULPS} f32 ulps")
    t = torch.addmm(b12, h, w12.t())
    scale = (t[:, :hid] * t[:, hid:]).abs()
    del t
    st["gate"] = f32_exact_check(
        f"{label} gate + silu", g, mlp.swiglu_gate_plain(*f64(h, w12, b12)),
        mlp.swiglu_gate_plain(h, w12, b12),
        mlp.swiglu_gate_plain(h, tf32_round(w12), b12), 1, scale)
    del scale
    x2 = x.reshape(m, d)
    st["down_residual"] = f32_exact_check(
        f"{label} down + residual", got.reshape(m, d),
        mlp.fc2_residual_plain(*f64(g, w3, b3, gamma, x2)),
        mlp.fc2_residual_plain(g, w3, b3, gamma, x2),
        mlp.fc2_residual_plain(g, tf32_round(w3), b3, gamma, x2), 1, x2,
        gamma * b3)
    stats = f32_exact_check(label, got, mlp.swiglu_residual_plain(*f64(*args)),
                            mlp.swiglu_residual_plain(*args),
                            mlp.swiglu_residual_plain(*tf_args), 1, x,
                            gamma * b3)
    del got
    log(f"{label} stages: {json.dumps(st)}")
    gate, down = 2 * m * d * 2 * hid, 2 * m * hid * d
    res = dict(**stats, stages=st,
               ms=event_ms(lambda: mlp.swiglu_residual(*args)),
               plain_ms=event_ms(lambda: mlp.swiglu_residual_plain(*args)),
               library_ms=event_ms(lambda: (torch.addmm(b12, h, w12.t()),
                                            torch.addmm(b3, g, w3.t()))),
               **bound_f32(nbytes(*args) + 4 * m * d, gate + down))
    del h, g
    log(f"kernel {label}: {json.dumps(res)}")
    return res


def check_tf32x3_split(gen) -> dict:
    """The weights' TF32 split (csrc/tf32x3_split.cu) at row 10's shapes,
    w12 (8192, 1536) in the gated order and w3 (1536, 4096), bit for bit
    against its plain version (mlp.tf32x3_weight_plain). Timed on w12, the
    kernel at every call (mlp.tf32x3_split_kernel), beside the plain
    version; bound by its bytes (w12 read, both planes written); no one
    PyTorch call computes it."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    w12 = randn(gen, (2 * HID_G, DIM_G), DIM_G ** -0.5)
    w3 = randn(gen, (DIM_G, HID_G), HID_G ** -0.5)
    for w, hid in ((w12, HID_G), (w3, 0)):
        got = mlp.tf32x3_split_kernel(w, hid)
        want = mlp.tf32x3_weight_plain(w, hid)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        require(differ == 0 and got.shape == want.shape,
                f"tf32x3_split {tuple(w.shape)} hidden={hid}: {differ} words "
                f"differ from the plain split")
    res = dict(max_abs_err=0.0,
               ms=event_ms(lambda: mlp.tf32x3_split_kernel(w12, HID_G)),
               plain_ms=event_ms(lambda: mlp.tf32x3_weight_plain(w12, HID_G)),
               library_ms=None,
               **bound_f32(nbytes(w12) + 2 * nbytes(w12), 0))
    log(f"kernel tf32x3_split (w12 {tuple(w12.shape)}, gated): "
        f"{json.dumps(res)}")
    return res


def check_silu_f32(device) -> dict:
    """The silu of row 10's f32 gate epilogue (vrvg::silu_mul_f32) bit for
    bit against the plain f32 silu_mul on the card, through a selection w12
    (swiglu_gate_kernel with h (rows, 256) = [x1 values | x2 values], x1's
    row c picking h's column c mod 128 and x2's row c column 128 + c mod
    128, b12 = 0; or x2's rows zero and its bias 1): every finite bf16 value
    as f32, 2^20 values spaced evenly over [-110, 40] (past x1 = -87.3 the
    logistic is subnormal, past -88.7 exp(-x1) overflows and it is 0), x2 =
    1 or seeded. On the 3xTF32 core a selected sum of v is hi(v) + lo(v)
    exactly (check_gelu_f32), so silu_mul takes those sums (selection_sum)
    of x1 and of the seeded x2. Equal as numbers
    (+0 and -0 alike: the bias add turns x1 = -0 into +0), NaN nowhere; a
    difference is logged with its values and ulps before the check fails."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp

    f32 = torch.float32
    bf = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=device).to(
        torch.int16).view(torch.bfloat16).to(f32)
    vals = torch.cat([bf[torch.isfinite(bf)],
                      torch.linspace(-110.0, 40.0, 2 ** 20, device=device)])
    vals = torch.cat([vals, torch.zeros((-len(vals)) % 128, device=device)])
    x1 = vals.reshape(-1, 128)
    gen = torch.Generator(device=device).manual_seed(SEED + 1010)
    hid = 512
    eye = torch.eye(128, device=device).repeat(4, 1)
    zero = torch.zeros_like(eye)
    out = {}
    for label, x2, w2, b2 in (
            ("x2 = 1", torch.ones_like(x1), zero, 1.0),
            ("seeded x2", randn(gen, x1.shape, 3.0), eye, 0.0)):
        h = torch.cat([x1, x2], dim=1).contiguous()
        w12 = torch.cat([torch.cat([eye, zero], dim=1),
                         torch.cat([zero, w2], dim=1)]).contiguous()
        b12 = torch.cat([torch.zeros(hid, device=device),
                         torch.full((hid,), b2, device=device)])
        got = mlp.swiglu_gate_kernel(h, w12, b12)
        want = mlp.silu_mul(selection_sum(x1), selection_sum(x2) if b2 == 0.0
                            else x2).repeat(1, 4)
        torch.cuda.synchronize()
        bad = got != want
        res = dict(values=x1.numel(), differ=int(bad.sum()),
                   nan=int(torch.isnan(got).sum()),
                   zero=int((got == 0).sum()))
        if res["differ"]:
            a = x1.repeat(1, 4)[bad]
            size = torch.maximum(got[bad].abs(), want[bad].abs()).double()
            ulp = torch.exp2(torch.floor(torch.log2(size.clamp_min(
                2.0 ** -126))) - 23)
            res["max_ulps"] = ((got[bad].double() - want[bad].double()).abs()
                               / ulp).max().item()
            res["first_x1"] = a[:16].tolist()
        out[label] = res
        require(res["differ"] == 0 and res["nan"] == 0,
                f"silu_f32, {label}: the gate epilogue's silu differs from "
                f"the plain f32 silu_mul: {json.dumps(res)}")
    log(f"silu_f32 (row 10's gate epilogue through a selection w12): "
        f"{json.dumps(out)}")
    return out


def f32_base_tail_check(gen, c: int) -> dict:
    """Row 15 at f32 (vrvg_head_tail_f32), C = c, on path1 at vits' 1080p/518
    grid (B = 8, 296 x 528, an NCHW tensor seen as NHWC), depth 518 x 924,
    stage by stage, each on the chain's own input: conv1 + b1 and conv2
    before its 1x1 (conv3x3_f32, the same conv on the 3xTF32 core) by
    f32_exact_check against the product on f64 operands (cuDNN's f32 result
    logged beside it, its TF32 result refused); the resize pass in f32
    ulps; conv2 with the 1x1 relative to the depth's range; the whole depth
    against head_tail_plain (refusing it with TF32); the library time is
    cuDNN's two f32 convs (conv1 with its bias, conv2)."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops import head_tail as ht

    h2, w2, c2 = 2 * H0, 2 * W0, c // 2
    h1, w1 = OUT_HW
    x = randn(gen, (B, c, h2, w2)).permute(0, 2, 3, 1)
    wts = f32_tail_weights(gen, c)[2:]
    k1, b1, k2, b2, k3, b3 = wts
    label = f"head_tail_f32 C={c}"
    got = ht.head_tail_stages(x, *wts, OUT_HW)
    with tf32(True):
        tf_c1 = ht.base_conv1_plain(x, k1, b1)
    stages = dict(conv1=f32_exact_check(
        f"{label} conv1", got[0], conv3x3_f64(x, k1) + b1.double(),
        ht.base_conv1_plain(x, k1, b1), tf_c1, 1, b1))
    del tf_c1
    r = ht.ext_resize_plain(got[0], OUT_HW)
    stages["resize"] = dict(max_ulps=f32_ulps(got[1], r, 1).max().item())
    require(stages["resize"]["max_ulps"] <= F32_MAX_ULPS,
            f"{label} resize: {stages['resize']} over {F32_MAX_ULPS} f32 "
            f"ulps")
    del r
    with tf32(True):
        tf_c2 = ht.conv3x3_f32_plain(got[1], k2)
    stages["conv2"] = f32_exact_check(
        f"{label} conv2", core_conv_sums(got[1], k2), conv3x3_f64(got[1], k2),
        ht.conv3x3_f32_plain(got[1], k2), tf_c2, 1)
    del tf_c2
    depth = ht.big_conv2_plain(got[1], k2, b2, k3, b3)
    want = ht.head_tail_plain(x, *wts, OUT_HW)
    with tf32(True):
        tfw = ht.head_tail_plain(x, *wts, OUT_HW)
    torch.cuda.synchronize()
    span = (want.max() - want.min()).item()
    stages["depth"] = dict(max_rel_err=(got[2] - depth).abs().max().item()
                           / span)
    require(stages["depth"]["max_rel_err"] <= TAIL_F32_MAX_REL,
            f"{label} conv2 with the 1x1: {stages['depth']}")
    del depth
    xc = x.permute(0, 3, 1, 2)
    rc = got[1].permute(0, 3, 1, 2)
    flops = 2 * B * (h2 * w2 * c2 * 9 * c + h1 * w1 * 32 * 9 * c2)
    res = f32_tail_result(
        label, got[2], want, tfw, stages,
        lambda: ht.head_tail(x, *wts, OUT_HW),
        lambda: ht.head_tail_plain(x, *wts, OUT_HW),
        lambda: (F.conv2d(xc, k1, b1, padding=1),
                 F.conv2d(rc, k2, b2, padding=1)),
        nbytes(x, *wts, got[2]), flops)
    del got, rc
    log(f"kernel {label}: {json.dumps(res)}")
    return res


def f32_rcu_inputs(gen, c):
    """rn0 and path2 on refinenet1's 1080p/518 grid (NCHW seen as NHWC) and
    the four convs' weights and biases, f32 (rcu_inputs' shapes and
    scales, drawn in f32: bf16 values would be exact in TF32 too)."""
    rn0, path2 = (randn(gen, (B, c, H0, W0)).permute(0, 2, 3, 1)
                  for _ in range(2))
    ws = []
    for _ in range(4):
        ws += [randn(gen, (c, c, 3, 3), (9 * c) ** -0.5),
               randn(gen, (c,), 0.1)]
    return rn0, path2, ws


def rcu_conv_f64(x, k, b, relu, residuals=(), relu_done=False,
                 relu_copy=False):
    """rcu_conv_plain's function on f64 operands, (B, H, W, C) f64, the
    conv by conv3x3_f64 (cuBLAS's f64 product): the exact reference of the
    RCU convs at f32; with ``relu_copy`` (out, relu(out))."""
    import torch.nn.functional as F

    xin = x.double()
    if relu and not relu_done:
        xin = F.relu(xin)
    y = b.double() + conv3x3_f64(xin, k)
    if relu:
        y = F.relu(y)
    for r in residuals:
        y = y + r.double()
    return (y, F.relu(y)) if relu_copy else y


def f32_rcu_check(gen, c: int) -> dict:
    """Row 16 at f32 (vrvg_rcu_conv_f32), C = c, on refinenet1's 1080p/518
    grid: each of the four conv calls alone, on the plain chain's own input
    and residuals, by f32_exact_check against the conv on f64 operands
    (rcu_conv_f64; cuDNN's f32 conv logged beside it, the same conv by
    cuDNN's TF32 refused), conv2a's ReLU'd copy bit for bit the ReLU of its
    output; the chain the same way against the chain on f64 operands, and
    against refinenet_pre_plain by the dense f32 bound (refusing it with
    TF32); timed beside the plain chain and cuDNN's four f32 convs. A
    conv's f32 ulps are of a scale that takes in the sum of its terms'
    magnitudes (the sums' order is all that differs)."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.attic.refinenet_pre import (
        rcu_chain, rcu_conv, rcu_conv_plain, refinenet_pre,
        refinenet_pre_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    rn0, path2, ws = f32_rcu_inputs(gen, c)
    label = f"rcu_pair_f32 C={c}"
    steps = []

    def record(*args, **kw):
        steps.append((args, kw))
        return rcu_conv_plain(*args, **kw)

    rcu_chain(record, rn0, path2, *ws)
    convs = []
    for i, (args, kw) in enumerate(steps):
        got_i, want_i = rcu_conv(*args, **kw), rcu_conv_plain(*args, **kw)
        exact_i = rcu_conv_f64(*args, **kw)
        with tf32(True):
            tf_i = rcu_conv_plain(*args, **kw)
        torch.cuda.synchronize()
        if kw.get("relu_copy"):
            require_equal(f"{label} conv {i} ReLU copy", got_i[1],
                          F.relu(got_i[0]))
            got_i, want_i, tf_i, exact_i = (got_i[0], want_i[0], tf_i[0],
                                            exact_i[0])
        # The scale takes in the sum of the conv's terms' magnitudes: its
        # input is ReLU'd (non-negative), so a channel whose weights sum
        # negative is mostly 0 after its own ReLU, its RMS far below the
        # sums that cancel in its few positive outputs.
        x, k, b = args[:3]
        mag = F.conv2d((F.relu(x) if args[3] else x).abs().permute(0, 3, 1, 2),
                       k.abs(), padding=1).permute(0, 2, 3, 1)
        res = args[4] if len(args) > 4 else ()
        convs.append(f32_exact_check(f"{label} conv {i}", got_i, exact_i,
                                     want_i, tf_i, 1, b, mag, *res))
        del got_i, want_i, tf_i, exact_i, mag
    got = refinenet_pre(rn0, path2, *ws)
    want = refinenet_pre_plain(rn0, path2, *ws)
    with tf32(True):
        tfw = refinenet_pre_plain(rn0, path2, *ws)
    torch.cuda.synchronize()
    require(got.shape == want.shape == rn0.shape, f"{label} shape {got.shape}")
    stats = f32_dense_check(label, got, want, tfw, 1, rn0, path2)
    exact = rcu_chain(rcu_conv_f64, rn0, path2, *ws)
    chain = f32_exact_check(f"{label} chain", got, exact, want, tfw, 1, rn0,
                            path2)
    stats.update({f"vs_f64_{k}": v for k, v in chain.items()})
    del want, tfw, exact
    stats["conv_max_ulps"] = max(cv["max_ulps"] for cv in convs)
    log(f"{label} convs: {json.dumps(convs)}")
    x = rn0.permute(0, 3, 1, 2)
    out = dict(**stats, convs=convs,
               ms=event_ms(lambda: refinenet_pre(rn0, path2, *ws)),
               plain_ms=event_ms(lambda: refinenet_pre_plain(rn0, path2, *ws)),
               library_ms=event_ms(lambda: [
                   F.conv2d(x, ws[2 * i], ws[2 * i + 1], padding=1)
                   for i in range(4)]),
               **bound_f32(nbytes(rn0, path2, *ws, got),
                           4 * 2 * B * H0 * W0 * 9 * c * c))
    log(f"kernel {label}: {json.dumps(out)}")
    return out


def f32_kernel_parity(device) -> dict:
    """Phase 8 (a): each f32 kernel against its plain version at its path's
    shapes, TF32 off, with the TF32 result of the same operands refused by
    the same bound; the kernel's, the plain version's and one library
    call's times (F.layer_norm, cuBLAS SGEMM, SDPA, cuDNN's two convs, each
    f32 with TF32 off) and the f32 bound."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops.attention import (
        attention, attention_plain, flash_attention, flash_attention_plain)
    from vr_video_generator_tpu_torch.ops.layernorm import (layernorm,
                                                             layernorm_plain)
    from vr_video_generator_tpu_torch.ops.qkv import (ln_qkv, ln_qkv_plain,
                                                       proj_ls_residual,
                                                       proj_ls_residual_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 800)
    scale = 64 ** -0.5

    # Row 1 at vits' rows, vitl-728's and vitg-518's (at phase 8's batch
    # of 2, and at vitg-518 auto's batch of 8); TF32 here is the input
    # rounded to 10 mantissa bits.
    for rows, d in ((B * N_TOK, DIM), (F32_CUT_BATCH * N_L728, DIM_L),
                    (F32_CUT_BATCH * N_TOK, DIM_G), (B * N_TOK, DIM_G)):
        x = randn(gen, (rows, d), 3.0, 1.0)
        w, b = randn(gen, (d,)), randn(gen, (d,))
        got, want = layernorm(x, w, b), layernorm_plain(x, w, b)
        tfw = layernorm_plain(tf32_round(x), w, b)
        torch.cuda.synchronize()
        stats = f32_dense_check(f"layernorm_f32 D={d}", got, want, tfw, 1, b)
        key = f"layernorm_f32 D={d}" + (f" M={rows}" if rows == B * N_TOK
                                        and d == DIM_G else "")
        out[key] = dict(
            **stats, ms=event_ms(lambda: layernorm(x, w, b)),
            plain_ms=event_ms(lambda: layernorm_plain(x, w, b)),
            library_ms=event_ms(lambda: F.layer_norm(x, (d,), w, b, 1e-6)),
            **bound_f32(nbytes(x, w, b, got), 0))
        del x, got, want, tfw

    # Rows 5 and 6 at vits' D = 384 and vitb-518's D = 768 (B = 8, 2443
    # tokens) on the 3xTF32 core, held against the plain versions on f64
    # operands (f32_qkv_check, f32_proj_check); row 5's library call is the
    # qkv product and bias alone (cuBLAS SGEMM through addmm) on the
    # LayerNorm'd rows, row 6's the proj product. The weights are split
    # (their first call) before the timing, as a path's first step splits
    # them.
    m = B * N_TOK
    for d in (DIM, DIM_B):
        tag = "" if d == DIM else f" D={d}"
        x = randn(gen, (B, N_TOK, d))
        lnw, lnb = randn(gen, (d,), 0.1, 1.0), randn(gen, (d,), 0.1)
        w, b = randn(gen, (3 * d, d), d ** -0.5), randn(gen, (3 * d,), 0.5)
        args = (x, lnw, lnb, w, b, d // 64, scale)
        got = ln_qkv(*args)
        torch.cuda.synchronize()
        a2 = layernorm_plain(x, lnw, lnb).reshape(m, d)
        out[f"ln_qkv_f32{tag}"] = dict(
            **f32_qkv_check(f"ln_qkv_f32 D={d}", args, got),
            ms=event_ms(lambda: ln_qkv(*args)),
            plain_ms=event_ms(lambda: ln_qkv_plain(*args)),
            library_ms=event_ms(lambda: torch.addmm(b, a2, w.t())),
            **bound_f32(nbytes(x, lnw, lnb, w, b, got), 2 * m * d * 3 * d))
        del got, a2

        o = randn(gen, (B, N_TOK, d // 64, 64))
        gp = randn(gen, (d,), 0.1, 1.0)
        wp, bp = randn(gen, (d, d), d ** -0.5), randn(gen, (d,), 0.5)
        args = (o, x, wp, bp, gp)
        got = proj_ls_residual(*args)
        torch.cuda.synchronize()
        o2 = o.reshape(m, d)
        out[f"proj_ls_residual_f32{tag}"] = dict(
            **f32_proj_check(f"proj_ls_residual_f32 D={d}", args, got),
            ms=event_ms(lambda: proj_ls_residual(*args)),
            plain_ms=event_ms(lambda: proj_ls_residual_plain(*args)),
            library_ms=event_ms(lambda: torch.addmm(bp, o2, wp.t())),
            **bound_f32(nbytes(*args, got), 2 * m * d * d))
        del o, x, got, o2

    # Rows 2 (vits: B = 8, N = 2443, 6 heads; vitg-518: 24 heads; q
    # pre-scaled) and 17 (vitl-728: B = 2, N = 4785, 16 heads; q unscaled)
    # on peaked q/k/v, k and v strided views into one qkv.
    for name, bsz, n, heads in (("attention_f32", B, N_TOK, HEADS),
                                ("attention_f32", B, N_TOK, HEADS_G),
                                ("flash_attention_f32", B_L728, N_L728,
                                 HEADS_L),
                                ("flash_attention_f32", B_L728, N_L728,
                                 HEADS_G)):
        qkv = randn(gen, (bsz, n, 3, heads, 64))
        qkv[:, :, 1] *= 1.5
        qkv[:, :, 0, :, 0] = 4.0
        qkv[:, :, 1, :, 0] = -8.0
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        if name == "attention_f32":
            q = (qkv[:, :, 0] * scale).contiguous()
            key = name + ("" if heads == HEADS else f" H={heads}")
            fn, plain, args, s = attention, attention_plain, (q, k, v), 1.0
        else:
            q = qkv[:, :, 0]
            fn, plain = flash_attention, flash_attention_plain
            args, s = (q, k, v, scale), scale
            key = name + ("" if heads == HEADS_L else f" H={heads}")
        got, want = fn(*args), plain(*args)
        with tf32(True):
            tfw = plain(*args)
        torch.cuda.synchronize()
        stats = f32_rel_check(f"{name} B={bsz} N={n} H={heads}", got, want,
                              tfw, ATTN_F32_MAX_REL, ATTN_F32_MEAN_REL)
        del want, tfw
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        out[key] = dict(
            **stats, ms=event_ms(lambda: fn(*args)),
            plain_ms=event_ms(lambda: plain(*args)),
            library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, scale=s)),
            **bound_f32(nbytes(q, k, v, got), 4 * bsz * heads * n * n * 64))
        del qkv, q, k, v, got, qt, kt, vt

    # Rows 8 and 9 (the MLP half, hidden 4D) at 1080p/518 rows (B = 8): row
    # 8 at D = 128 and vits' 384, row 9 at vitb's 768 and vitl's 1024.
    for row, d in ((8, 128), (8, DIM), (9, DIM_B), (9, DIM_L)):
        name = "mlp_residual_f32" if row == 8 else "mlp_residual_hblocked_f32"
        out[f"{name} D={d}"] = f32_mlp_check(gen, row, d)
        torch.cuda.empty_cache()
    out["gelu_f32"] = check_gelu_f32(device)
    # Row 10 at vitg-518's rows, and its gate epilogue's silu.
    out[f"swiglu_residual_f32 D={DIM_G}"] = f32_swiglu_check(gen)
    torch.cuda.empty_cache()
    out["silu_f32"] = check_silu_f32(device)
    out["tf32x3_split"] = check_tf32x3_split(gen)
    torch.cuda.empty_cache()

    # Row 7 at every width, stage by stage, at the grid of the path that
    # runs it; rows 11 and 12 the same way.
    for c, grid, out_hw in EXT_F32_SHAPES:
        key = "head_tail_ext_f32" + ("" if c == FEATURES else f" C={c}") \
            + (" 56" if grid == GRID_56 else "")
        out[key] = f32_ext_tail_check(gen, c, grid, out_hw)
        torch.cuda.empty_cache()
    for c, grid, out_hw in BIG_F32_SHAPES:
        out[f"head_tail_big_f32 C={c}"] = f32_big_tail_check(gen, c, grid,
                                                             out_hw)
        torch.cuda.empty_cache()
    # Rows 15 and 16 at vits' and vitb's widths; row 15 also at a
    # 32-feature head's (C2 zero-padded to 32).
    for c in (FEATURES, FEATURES_B):
        out[f"head_tail_f32 C={c}"] = f32_base_tail_check(gen, c)
        torch.cuda.empty_cache()
        out[f"rcu_pair_f32 C={c}"] = f32_rcu_check(gen, c)
        torch.cuda.empty_cache()
    out["head_tail_f32 C=32"] = f32_base_tail_check(gen, 32)
    torch.cuda.empty_cache()
    for name, res in out.items():
        log(f"kernel {name}: {json.dumps(res)}")
    return out


class NoPlainF32:
    """The plain versions of the f32 kernels' wrappers raise while active:
    a run inside shows that no CUDA f32 tensor reached one."""

    NAMES = (("ops.layernorm", "layernorm_plain"),
             ("ops.qkv", "ln_qkv_plain"), ("ops.qkv", "proj_ls_residual_plain"),
             ("ops.attention", "attention_plain"),
             ("ops.attention", "flash_attention_plain"),
             ("ops.head_tail", "head_tail_ext_plain"),
             ("ops.head_tail", "ext_mix_plain"),
             ("ops.head_tail", "head_tail_big_plain"),
             ("ops.head_tail", "big_upsample_plain"),
             ("ops.mlp", "mlp_residual_plain"),
             ("ops.mlp", "fc1_gelu_plain"),
             ("ops.mlp", "swiglu_residual_plain"),
             ("ops.mlp", "swiglu_gate_plain"),
             ("ops.mlp", "tf32x3_weight_plain"))

    def __enter__(self):
        import importlib

        self._saved = []
        for mod, name in self.NAMES:
            target = importlib.import_module(f"{PKG}.{mod}")
            self._saved.append((target, name, getattr(target, name)))

            def refuse(*args, _name=name, **kwargs):
                raise SmokeFailure(f"{_name} ran on the f32 path")
            setattr(target, name, refuse)
        return self

    def __exit__(self, *exc):
        for target, name, fn in reversed(self._saved):
            setattr(target, name, fn)
        return False


class F64Plain:
    """The model's kernel calls swapped for f64 computations of the same
    functions (LayerNorm, the attention softmax, the A&S GELU in the input's
    dtype): with an f64 model, a plain f64 forward (its MLP half and tail
    unfused, as ``auto`` resolves off the card)."""

    def __enter__(self):
        import importlib

        import torch
        import torch.nn.functional as F

        from vr_video_generator_tpu_torch.ops import gelu as gelu_mod

        def layernorm64(x, w, b, eps=1e-6):
            return F.layer_norm(x, (x.shape[-1],), w.to(x.dtype),
                                b.to(x.dtype), eps)

        def mha64(q, k, v, scale):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            p = torch.softmax((qt @ kt.transpose(-1, -2)) * scale, dim=-1)
            return (p @ vt).transpose(1, 2).contiguous()

        def gelu64(x):
            z = x * gelu_mod._INV_SQRT2
            a = z.abs()
            t = 1.0 / (1.0 + gelu_mod._P * a)
            c = gelu_mod._A
            poly = t * (c[0] + t * (c[1] + t * (c[2] + t * (c[3] + t * c[4]))))
            erf = torch.sign(z) * (1.0 - poly * torch.exp(-a * a))
            return 0.5 * x * (1.0 + erf)

        swaps = (("models.dinov2", "layernorm", layernorm64),
                 ("models.dinov2", "mha", mha64),
                 ("ops.mlp", "gelu_exact", gelu64))
        self._saved = []
        for mod, name, fn in swaps:
            target = importlib.import_module(f"{PKG}.{mod}")
            self._saved.append((target, name, getattr(target, name)))
            setattr(target, name, fn)
        return self

    def __exit__(self, *exc):
        for target, name, fn in reversed(self._saved):
            setattr(target, name, fn)
        return False


def f64_depth(label, pipe, sd, cfg, frames, factor) -> dict:
    """The depth at the net's output on two frames through the kernels, the
    plain f32 path and a plain f64 forward on the same weights (state dict
    ``sd``) and input: the kernel path's max and mean error against f64 at
    most ``factor`` times the plain f32 path's."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import build_model
    from vr_video_generator_tpu_torch.ops.preprocess import (
        network_input_size, preprocess_frames)

    net_hw = network_input_size(H, W, target=cfg.input_size, multiple_of=14)
    with torch.inference_mode():
        x32 = preprocess_frames(torch.from_numpy(frames[:2]).to(pipe.device),
                                net_hw, dtype=torch.float32, impl="exact")
        d_kernel = pipe.model(x32)
        with PlainKernels():
            d_plain = pipe.model(x32)
        model64 = build_model(pipe.model.cfg, sd, torch.float64, pipe.device,
                              tail=cfg.tail)
        with F64Plain():
            d64 = model64(x32.double())
    del model64
    span = float(d64.max() - d64.min())
    dk, dp = (d_kernel.double() - d64).abs(), (d_plain.double() - d64).abs()
    depth = dict(depth_range=span, kernel_vs_f64_max=float(dk.max()),
                 kernel_vs_f64_mean=float(dk.mean()),
                 plain_f32_vs_f64_max=float(dp.max()),
                 plain_f32_vs_f64_mean=float(dp.mean()),
                 kernel_vs_plain_f32_max=float((d_kernel - d_plain).abs().max()),
                 factor=factor)
    log(f"{label} depth against a plain f64 forward: {json.dumps(depth)}")
    require(span > 0 and bool(torch.isfinite(d_kernel).all()),
            f"{label}: depth {depth}")
    for kind in ("max", "mean"):
        require(depth[f"kernel_vs_f64_{kind}"]
                <= factor * depth[f"plain_f32_vs_f64_{kind}"],
                f"{label}: the kernel path's {kind} error against f64 "
                f"exceeds {factor} x the plain f32 path's: "
                f"{json.dumps(depth)}")
    del d_kernel, d_plain, d64, x32
    torch.cuda.empty_cache()
    return depth


def f32_auto_path(device, frames, label, encoder, step) -> tuple:
    """``auto`` at f32 for ``encoder`` (1080p, B = 8, input 518) with
    PyTorch's default TF32 flags, through process_segment (checked_path: no
    host sync in a step, the right half the input, the SBS the plain warp
    of its own depth): exactly the kernels ``step`` a step, none of the f32
    kernels' plain versions, TF32 off inside the forward and as it was
    after. Returns (stats, pipe, state dict, RunConfig)."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import random_state_dict
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler

    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)

    cfg = run_config(encoder, "auto", "auto", dtype="float32")
    sd = random_state_dict(cfg.model(), SEED)
    pipe = make_pipe(device, cfg, sd)
    # The first forward splits the fused MLP halves' weights, once.
    reset_launch_counts()
    scaler = calibrate_random_scaler(pipe, frames[:B])
    splits = launch_counts().get("tf32x3_split", 0)
    require(splits == AUTO_F32_SPLITS[encoder],
            f"{label}: the first step split {splits} weights, expected "
            f"{AUTO_F32_SPLITS[encoder]}")
    seen = []
    hook = pipe.model.depth_head.scratch.layer1_rn.register_forward_hook(
        lambda *a: seen.append((torch.backends.cuda.matmul.allow_tf32,
                                torch.backends.cudnn.allow_tf32)))
    with NoPlainF32():
        stats = checked_path(label, pipe, frames[:B], tuple(step))
    hook.remove()
    per_step = {k: v for k, v in stats["launches"].items() if v}
    require(per_step == step,
            f"{label}: one step launched {per_step}, expected {step}")
    require(seen and set(seen) == {(False, False)},
            f"{label}: TF32 flags inside the forward {set(seen)}")
    require((torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) == (False, True),
            f"{label}: the forward left the TF32 flags changed")
    stats["scaler"] = scaler
    stats["first_step_splits"] = splits
    return stats, pipe, sd, cfg


def f32_vits_auto(device, frames) -> dict:
    """Phase 8 (b): vits ``auto`` at f32 (f32_auto_path, AUTO_VITS_F32_STEP);
    step_many's graph (k = 2) bit for bit equal to two steps; and the depth,
    at the net's output on two frames, against a plain f64 forward on the
    same weights: the kernel path's max and mean error at most
    F32_DEPTH_FACTOR times the plain f32 path's."""
    import torch

    label = "vits auto/auto f32"
    stats, pipe, sd, cfg = f32_auto_path(device, frames, label, "vits",
                                         AUTO_VITS_F32_STEP)
    per_replay = step_many_check(label, pipe, frames, AUTO_VITS_F32_STEP)
    depth = f64_depth(label, pipe, sd, cfg, frames, F32_DEPTH_FACTOR)
    stats.update(depth=depth, launches_per_replay=per_replay)
    del pipe, sd
    torch.cuda.empty_cache()
    return stats


def f32_xla_paths(device, frames) -> dict:
    """Phase 8 (c): vitl-518, vitg-518 and vitl-728 with ``--mlp_fused xla
    --tail xla`` at f32 (F32_CUT_DEPTH blocks, batch F32_CUT_BATCH): one
    batch each through process_segment with exactly the f32 LayerNorm and
    one-shot (518) or flash (728) attention kernels, their per-step
    launches, the right half the input, and the depth within 1e-3 of its
    range of the plain f32 path's on average."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    out = {}
    taps = tuple(range(F32_CUT_DEPTH))
    for encoder, size, need, attn in (
            ("vitl", 518, XLA_F32, "attention_f32"),
            ("vitg", 518, XLA_F32, "attention_f32"),
            ("vitl", 728, XLA_F32_FLASH, "flash_attention_f32")):
        label = f"{encoder}-{size} xla/xla f32"
        cfg = run_config(encoder, "xla", "xla", batch=F32_CUT_BATCH,
                         input_size=size, dtype="float32")
        mcfg = dataclasses.replace(cfg.model(), depth=F32_CUT_DEPTH,
                                   intermediate_layers=taps)
        model = build_model(mcfg, random_state_dict(mcfg, SEED),
                            torch.float32, device, tail="xla")
        pipe = SbsPipeline(model, H, W, run_cfg=cfg)
        stats = one_batch(label, pipe, frames, need)
        per_step = {k: v for k, v in stats["launches"].items() if v}
        want = {"layernorm_f32": 2 * F32_CUT_DEPTH + 4, attn: F32_CUT_DEPTH,
                "warp_composite": 1, "blur_select_sbs": 1}
        require(per_step == want,
                f"{label}: one step launched {per_step}, expected {want}")
        batch = pipe.frames_to_device(frames[:F32_CUT_BATCH])
        d_kernel = pipe.depth_only(batch)
        with PlainKernels():
            d_plain = pipe.depth_only(batch)
        span = float(d_plain.max() - d_plain.min())
        mean = float((d_kernel - d_plain).abs().mean())
        require(bool(torch.isfinite(d_kernel).all()) and span > 0
                and mean <= 1e-3 * span,
                f"{label}: depth off the plain f32 path by {mean} on average "
                f"(range {span})")
        stats.update(depth_vs_plain_mean=mean, depth_range=span)
        log(f"{label}: depth against the plain f32 path: mean {mean}, range "
            f"{span}")
        out[label] = stats
        del model, pipe, batch, d_kernel, d_plain
        torch.cuda.empty_cache()
    return out


def f32_vitb_auto(device, frames) -> dict:
    """Phase 8 (b'): the slice's path, vitb-518 ``auto`` at f32 at full width
    (12 blocks, D = 768, 1080p, B = 8; f32_auto_path): exactly the f32
    kernels a step (AUTO_VITB_F32_STEP: rows 1, 5, 2, 6, 9, 11 + 12, 3, 4);
    the depth on two frames against a plain f64 forward within
    F32_DEPTH_FACTOR_VITB times the plain f32 path's error."""
    import torch

    label = "vitb-518 auto/auto f32"
    stats, pipe, sd, cfg = f32_auto_path(device, frames, label, "vitb",
                                         AUTO_VITB_F32_STEP)
    stats["depth"] = f64_depth(label, pipe, sd, cfg, frames,
                               F32_DEPTH_FACTOR_VITB)
    del pipe, sd
    torch.cuda.empty_cache()
    return stats


def f32_fused_paths(device, frames, paths=None) -> dict:
    """Phase 8 (c'): the other fused f32 paths (F32_FUSED_PATHS: vits fused,
    vitb-252 auto, vitl-518 auto cut to 4 blocks at batch 2; or ``paths``,
    F32_NEW_PATHS' rows), one batch each through process_segment with
    exactly their f32 kernels, their per-step launches, none of the f32
    kernels' plain versions, the right half the input, and the depth within
    1e-3 of its range of the plain f32 path's on average. Where a fused
    tail runs, the head's output convs (cuDNN's) run in no step."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    out = {}
    for row in paths or [(*p, None) for p in F32_FUSED_PATHS]:
        label, encoder, size, fused, blocks, batch, want, features = row
        cfg = run_config(encoder, fused, fused, batch=batch, input_size=size,
                         dtype="float32")
        mcfg = cfg.model()
        if blocks is not None:
            mcfg = dataclasses.replace(mcfg, depth=blocks,
                                       intermediate_layers=tuple(
                                           range(blocks)))
        if features is not None:
            mcfg = dataclasses.replace(mcfg, features=features)
        model = build_model(mcfg, random_state_dict(mcfg, SEED),
                            torch.float32, device, tail=fused)
        pipe = SbsPipeline(model, H, W, run_cfg=cfg)
        scratch = model.depth_head.scratch
        convs = []
        hooks = [m.register_forward_hook(lambda *a: convs.append(1))
                 for m in (scratch.output_conv1, scratch.output_conv2)]
        with NoPlainF32():
            stats = one_batch(label, pipe, frames, tuple(want))
        for h in hooks:
            h.remove()
        per_step = {k: v for k, v in stats["launches"].items() if v}
        require(per_step == want,
                f"{label}: one step launched {per_step}, expected {want}")
        require(not (convs and any(k.startswith("head_tail") for k in want)),
                f"{label}: the head's output convs ran beside the fused tail")
        x = pipe.frames_to_device(frames[:batch])
        d_kernel = pipe.depth_only(x)
        with PlainKernels():
            d_plain = pipe.depth_only(x)
        span = float(d_plain.max() - d_plain.min())
        mean = float((d_kernel - d_plain).abs().mean())
        require(bool(torch.isfinite(d_kernel).all()) and span > 0
                and mean <= 1e-3 * span,
                f"{label}: depth off the plain f32 path by {mean} on average "
                f"(range {span})")
        stats.update(depth_vs_plain_mean=mean, depth_range=span, batch=batch,
                     blocks=f"{mcfg.depth} of {cfg.model().depth}")
        log(f"{label}: depth against the plain f32 path: mean {mean}, range "
            f"{span}; {stats['blocks']} blocks, batch {batch}")
        out[label] = stats
        del model, pipe, x, d_kernel, d_plain
        torch.cuda.empty_cache()
    return out


def step_many_check(label, pipe, frames, step) -> dict:
    """``step_many`` (k = 2) as a CUDA graph bit for bit equal to two eager
    steps on two batches of ``frames``, its replay launching twice ``step``.
    Returns the launches per replay."""
    import torch

    batches = torch.from_numpy(frames[:2 * B].reshape(2, B, H, W, 3)).to(
        pipe.device)
    state0 = pipe.initial_state()
    eager, st = [], state0
    for batch in batches:
        sbs, st = pipe.step(batch, st)
        eager.append(sbs)
    graph_out, st_g = pipe.step_many(batches, state0)
    torch.cuda.synchronize()
    require(all(torch.equal(g, e) for g, e in zip(graph_out, eager))
            and states_equal(st_g, st),
            f"{label}: step_many's graph differs from two eager steps")
    per_replay = dict(pipe._graphs[(2, B)].launches)
    require(per_replay == {k: 2 * v for k, v in step.items()},
            f"{label}: a replay launches {per_replay}")
    log(f"{label}: step_many (k = 2) as a CUDA graph equal to two eager "
        f"steps bit for bit; launches per replay {json.dumps(per_replay)}")
    return per_replay


def f32_vitg_auto(device, frames) -> dict:
    """Phase 8 (b''): the slice's path, vitg-518 ``auto`` at f32 at full width
    and depth (40 blocks, D = 1536, 1080p, B = 8; f32_auto_path): exactly
    the f32 kernels a step (AUTO_VITG_F32_STEP: rows 1, 2, 10, 3, 4);
    step_many (k = 2) bit for bit equal to two steps; the depth on two
    frames against a plain f64 forward within F32_DEPTH_FACTOR_VITB times
    the plain f32 path's error. Then (c'') vitg-126 ``fused`` at f32 on the
    same weights, one batch through process_segment: exactly
    VITG_126_F32_STEP (row 10 and rows 11 + 12 at C = 384), none of the
    plain versions, the right half the input, and the depth within 1e-3 of
    its range of the plain f32 path's on average."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import build_model
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    label = "vitg-518 auto/auto f32"
    stats, pipe, sd, cfg = f32_auto_path(device, frames, label, "vitg",
                                         AUTO_VITG_F32_STEP)
    stats["launches_per_replay"] = step_many_check(label, pipe, frames,
                                                   AUTO_VITG_F32_STEP)
    stats["depth"] = f64_depth(label, pipe, sd, cfg, frames,
                               F32_DEPTH_FACTOR_VITB)
    del pipe
    torch.cuda.empty_cache()

    label = "vitg-126 fused/fused f32"
    cfg = run_config("vitg", "fused", "fused", input_size=126,
                     dtype="float32")
    model = build_model(cfg.model(), sd, torch.float32, device, tail="fused")
    del sd
    pipe = SbsPipeline(model, H, W, run_cfg=cfg)
    with NoPlainF32():
        st = one_batch(label, pipe, frames, tuple(VITG_126_F32_STEP))
    per_step = {k: v for k, v in st["launches"].items() if v}
    require(per_step == VITG_126_F32_STEP,
            f"{label}: one step launched {per_step}, expected "
            f"{VITG_126_F32_STEP}")
    x = pipe.frames_to_device(frames[:B])
    d_kernel = pipe.depth_only(x)
    with PlainKernels():
        d_plain = pipe.depth_only(x)
    span = float(d_plain.max() - d_plain.min())
    mean = float((d_kernel - d_plain).abs().mean())
    require(bool(torch.isfinite(d_kernel).all()) and span > 0
            and mean <= 1e-3 * span,
            f"{label}: depth off the plain f32 path by {mean} on average "
            f"(range {span})")
    st.update(depth_vs_plain_mean=mean, depth_range=span)
    log(f"{label}: depth against the plain f32 path: mean {mean}, range "
        f"{span}")
    stats["vitg-126"] = st
    del model, pipe, x, d_kernel, d_plain
    torch.cuda.empty_cache()
    return stats


def f32_off_cli(device) -> dict:
    """Phase 8 (c'''): rows 15 and 16 at f32 called as a user calls them, at
    vits' C = 64 and vitb's C = 128, with the launch counts reset just
    before and read just after each width: the single-kernel tail on f32
    path1 (an NCHW tensor seen as NHWC) at vits' 1080p/518 grid, and the RCU
    pair feeding the ext tail on refinenet1's grid. Exactly OFF_CLI_F32
    must launch, the tail and the ext tail once, the RCU conv four times,
    the split OFF_CLI_F32_SPLITS times (their fresh weights); the depths
    finite. Then the tail once more on the same weights: one launch of it
    and no split. At a 32-feature head's C = 32 (no RCU pair kernel there)
    the single-kernel tail alone: one launch, its two convs split."""
    import torch

    from vr_video_generator_tpu_torch.attic.refinenet_pre import refinenet_pre
    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.ops.head_tail import (head_tail,
                                                             head_tail_ext)

    gen = torch.Generator(device=device).manual_seed(SEED + 1516)
    out = {}
    for c in (FEATURES, FEATURES_B, 32):
        label = f"off-CLI f32 entry points C={c}"
        rcu = c != 32
        path1 = randn(gen, (B, c, 2 * H0, 2 * W0)).permute(0, 2, 3, 1)
        tail = f32_tail_weights(gen, c)
        if rcu:
            rn0, path2, ws = f32_rcu_inputs(gen, c)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        depth = head_tail(path1, *tail[2:], OUT_HW)
        depth2 = head_tail_ext(refinenet_pre(rn0, path2, *ws), *tail,
                               OUT_HW) if rcu else depth
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        log(f"{label}: {secs:.4f} s; launch counts {json.dumps(counts)}")
        launched_exactly(label, counts, OFF_CLI_F32 if rcu
                         else ("head_tail_f32", "tf32x3_split"))
        require(counts["head_tail_f32"] == 1
                and counts["rcu_pair_f32"] == (4 if rcu else 0)
                and counts["head_tail_ext_f32"] == (1 if rcu else 0)
                and counts["tf32x3_split"] == (OFF_CLI_F32_SPLITS if rcu
                                               else 2),
                f"{label}: launches {counts}")
        require(bool(torch.isfinite(depth).all() & torch.isfinite(depth2).all())
                and depth.shape == depth2.shape == (B, *OUT_HW),
                f"{label}: depth {tuple(depth.shape)} {tuple(depth2.shape)}")
        reset_launch_counts()
        again = head_tail(path1, *tail[2:], OUT_HW)
        torch.cuda.synchronize()
        later = launch_counts()
        log(f"{label}, the tail again: launch counts {json.dumps(later)}")
        launched_exactly(f"{label}, the tail again", later, ("head_tail_f32",))
        require(later["head_tail_f32"] == 1 and torch.equal(again, depth),
                f"{label}, the tail again: launches {later}, depth equal "
                f"{torch.equal(again, depth)}")
        out[f"C={c}"] = dict(seconds=secs, launches=counts)
        del path1, depth, depth2, again
        if rcu:
            del rn0, path2, ws
        torch.cuda.empty_cache()
    return out


def f32_cli(device) -> dict:
    """Phase 8 (d): ``cli.main --compute_dtype float32`` on a 1080p mp4 of 16
    smooth frames (cv2): plainly, with ``--mesh 1x1``, with
    ``--depth_stride 2``, with ``--encoder vitb`` (row 9 and the big-C tail
    at f32) and with ``--encoder vitg --input_size 126`` (row 10 and the
    big-C tail at C = 384 at f32); each writes subclips 0_7 and 8_15 whose right
    half is the input up to the codec (mean |difference| at most 4 of 255
    against the decoded input: mp4v encodes the SBS again; measured 2.2 on
    an NVIDIA H100 80GB HBM3, 700.00 W), and the mesh run's decoded
    subclips equal the plain run's."""
    import tempfile

    import cv2

    from vr_video_generator_tpu_torch import cli
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    n = 2 * B
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    frames = np.stack([np.stack([(xx / W * 255 + 9 * i) % 256,
                                 (yy / H * 255) % 256,
                                 128 + 100 * np.sin((xx + yy + 40 * i) / 90)],
                                axis=-1).astype(np.uint8) for i in range(n)])

    def decoded(path):
        with VideoReader(path, begin=0, backend="cv2") as r:
            return np.stack(list(r.frames(0, r.frame_count)))

    out = {}
    with tempfile.TemporaryDirectory() as d:
        video = os.path.join(d, "in.mp4")
        vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (W, H))
        for f in frames:
            vw.write(f[:, :, ::-1])
        vw.release()
        source = decoded(video)
        runs = {}
        for tag, extra in (("plain", []), ("mesh", ["--mesh", "1x1"]),
                           ("stride", ["--depth_stride", "2"]),
                           ("vitb", ["--encoder", "vitb"]),
                           ("vitg", ["--encoder", "vitg", "--input_size",
                                     "126"])):
            sub = os.path.join(d, f"S_{tag}") + os.sep
            argv = ["--device", device.type, "--VideoDir", video,
                    "--OutputDir", os.path.join(d, f"{tag}.mkv"),
                    "--DebugDir", os.path.join(d, f"D_{tag}") + os.sep,
                    "--SubClipDir", sub, "--Max_Frame_Count", str(B),
                    "--batch_size", str(B), "--repair_mode", "1",
                    "--compute_dtype", "float32",
                    "--reader_backend", "cv2", "--writer_backend", "cv2",
                    "--allow_random_weights", *extra]
            t0 = time.perf_counter()
            require(cli.main(argv) == 0, f"cli f32 {tag}: non-zero exit")
            secs = time.perf_counter() - t0
            names = sorted_subclips(sub)
            require(names == ["0_7.mp4", "8_15.mp4"],
                    f"cli f32 {tag}: subclips {names}")
            clips = np.concatenate([decoded(os.path.join(sub, c))
                                    for c in names])
            require(clips.shape == (n, H, 2 * W, 3),
                    f"cli f32 {tag}: {clips.shape}")
            diff = np.abs(clips[:, :, W:].astype(np.int16)
                          - source.astype(np.int16))
            runs[tag] = clips
            out[tag] = dict(seconds=secs, right_half_mean_abs=float(diff.mean()),
                            left_vs_right_mean_abs=float(np.abs(
                                clips[:, :, :W].astype(np.int16)
                                - clips[:, :, W:].astype(np.int16)).mean()))
            require(out[tag]["right_half_mean_abs"] <= 4.0,
                    f"cli f32 {tag}: the right half is off the input by "
                    f"{out[tag]['right_half_mean_abs']} on average")
        require(np.array_equal(runs["plain"], runs["mesh"]),
                "cli f32 --mesh 1x1: subclips differ from the run without "
                "--mesh")
    log(f"cli --compute_dtype float32 (plain, --mesh 1x1, --depth_stride 2, "
        f"--encoder vitb, --encoder vitg --input_size 126) on a 16-frame "
        f"1080p mp4: {json.dumps(out)}")
    return out


def f32_path(device, rng) -> dict:
    """Phase 8: f32 on the card (see the module's header)."""
    import torch

    from vr_video_generator_tpu_torch import bench

    out, t0 = {}, time.perf_counter()
    out["kernels"] = f32_kernel_parity(device)
    log(f"phase 8 (a) f32 kernel parity: {time.perf_counter() - t0:.1f} s")
    frames = rng.integers(0, 256, (2 * B, H, W, 3), dtype=np.uint8)
    # PyTorch's own defaults for the f32 paths: cuDNN's TF32 on, cuBLAS's
    # off; the f32 forward turns both off itself.
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        out["vits_auto"] = f32_vits_auto(device, frames)
        log(f"phase 8 (b) vits auto f32: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["vitb_auto"] = f32_vitb_auto(device, frames)
        log(f"phase 8 (b') vitb-518 auto f32: {time.perf_counter() - t0:.1f} "
            f"s")
        t0 = time.perf_counter()
        out["vitg_auto"] = f32_vitg_auto(device, frames)
        log(f"phase 8 (b'', c'') vitg-518 auto, vitg-126 fused f32: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["off_cli"] = f32_off_cli(device)
        log(f"phase 8 (c''') rows 15 and 16 at f32: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["xla"] = f32_xla_paths(device, frames)
        log(f"phase 8 (c) vitl/vitg xla f32: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["fused"] = f32_fused_paths(device, frames)
        log(f"phase 8 (c') vits fused, vitb-252 auto, vitl-518 auto f32: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["new"] = f32_fused_paths(device, frames, F32_NEW_PATHS)
        log(f"phase 8 (c4) a 32-feature vits-518 head, vitg-728 (4 blocks, "
            f"batch 2), vitl-126 (4 blocks), vitg-56 (4 blocks), vits-728, "
            f"vitl-252 (4 blocks) auto f32: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["cli"] = f32_cli(device)
        log(f"phase 8 (d) cli f32: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        line = bench.run_config(2, reps=2, segment_batches=4,
                                compute_dtype="float32")
        print(json.dumps(line), flush=True)
        require(line["value"] > 0 and line["metric"].endswith("_f32"),
                f"bench --config 2 --compute_dtype float32: {line}")
        out["bench"] = line
        log(f"phase 8 (e) bench --config 2 --compute_dtype float32 --reps 2 "
            f"--segment_batches 4: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        line = bench.run_config(3, reps=2, segment_batches=2,
                                compute_dtype="float32")
        print(json.dumps(line), flush=True)
        require(line["value"] > 0
                and line["metric"] == "torch_sbs_fps_1080p_vitb_f32",
                f"bench --config 3 --compute_dtype float32: {line}")
        out["bench_vitb"] = line
        log(f"phase 8 (e) bench --config 3 --compute_dtype float32 --reps 2 "
            f"--segment_batches 2: {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return out


def scan_warp_check(device, rng) -> dict:
    """Phase 9 (a): the scan warp on the card at config 2's geometry (B = 8)
    on a vits ``auto`` step's blended depth (the calibrated scaler): its u8
    SBS equal, bit for bit, to the pallas kernels' (rows 3 and 4) and to
    the xla plain warp's on the card."""
    import torch

    from vr_video_generator_tpu_torch.ops.temporal import temporal_scan
    from vr_video_generator_tpu_torch.ops.warp import WarpSpec
    from vr_video_generator_tpu_torch.stage_bench import calibrate_random_scaler

    frames = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    pipe = make_pipe(device, run_config("vits", "auto", "auto"))
    calibrate_random_scaler(pipe, frames)
    batch = pipe.frames_to_device(frames)
    with torch.inference_mode():
        blended, ranges, _ = temporal_scan(pipe.depth_only(batch),
                                           pipe.initial_state(), pipe.spec)
        sbs = {impl: WarpSpec.create(H, W, pipe.run_cfg.stereo(), impl=impl,
                                     device=device).warp_batch(batch, blended,
                                                               ranges)
               for impl in ("scan", "pallas", "xla")}
    torch.cuda.synchronize()
    for impl in ("pallas", "xla"):
        n_bad = int((sbs["scan"] != sbs[impl]).sum())
        require(n_bad == 0, f"phase 9 scan warp differs from {impl} in "
                f"{n_bad} values")
    moved = float((sbs["scan"][:, :, :W] != batch).any(dim=-1).float().mean())
    require(moved > 0.1, f"phase 9 scan warp: only {moved:.4f} of the left "
            f"eye's pixels moved")
    log(f"phase 9 (a) scan warp == pallas == xla on the card, bit for bit "
        f"({H}x{W}, B = {B}; {moved:.4f} of left-eye pixels moved)")
    return dict(moved=moved)


def tooling_path(device, rng) -> dict:
    """Phase 9: the records' tools on the card. (a) :func:`scan_warp_check`;
    (b) ``soak.device_soak`` for 400 frames at vits 1080p (the soak's
    defaults: B = 8, depth_stride 2, bf16, input 518) on a ``soak_gen``
    source, passing its own memory rule, its memory series printed; (c)
    ``parity_report``'s gate at config 1's geometry (480 x 854), 2 frames,
    f32 on the card, --spread_depth, passing."""
    import tempfile

    from vr_video_generator_tpu_torch import parity_report, soak, soak_gen

    out, t0 = {}, time.perf_counter()
    out["scan_warp"] = scan_warp_check(device, rng)
    log(f"phase 9 (a): {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        t0 = time.perf_counter()
        video = os.path.join(tmp, "soak_1080p.mp4")
        soak_gen.generate(video, 8 * B, H, W)
        art_path = os.path.join(tmp, "soak_device.json")
        rc = soak.device_soak(soak.build_parser().parse_args(
            ["--device_only", "400", "--video", video, "--out", art_path]))
        with open(art_path) as f:
            art = json.load(f)
        series = [(s["frames"], s["device_mb"], s["allocated_mb"])
                  for s in art["samples"]]
        log(f"phase 9 (b) device soak memory (frames, MiB used on the card, "
            f"allocated MiB): {json.dumps(series)}")
        require(rc == 0 and art["frames"] >= 400
                and art["device_mb"]["available"],
                f"phase 9 device soak failed: rc {rc}, "
                f"{art['frames']} frames, device_mb {art['device_mb']}")
        out["soak"] = {k: v for k, v in art.items() if k != "samples"}
        log(f"phase 9 (b): {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        video = os.path.join(tmp, "parity_480p.mp4")
        soak_gen.generate(video, 2, 480, 854)
        args = parity_report.build_parser().parse_args(
            ["--video", video, "--frames", "2", "--device", "cuda",
             "--compute_dtype", "float32", "--spread_depth"])
        stats, lines = parity_report.run(args)
        require(parity_report.gate_passes(stats, args.gate, args.frac_budget),
                f"phase 9 parity report at 480x854 f32: {lines[-1]}")
        out["parity"] = dict(stats=stats, result=lines[-1])
        log(f"phase 9 (c): {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the model axis on one card. A model group of M ranks on
# [cuda:0] * M: each rank holds its shards (parallel/sharding.py), the
# unfused halves run split with one all-reduce each (on one card a sum
# there), the fused halves on whole weights on every rank, the head on the
# first rank.
#
# Each path is one batch of `soak_gen` frames against the 1 x 1
# SbsPipeline on the same weights and frames at equal batch. The split
# products round their partials to bf16 and sum them in bf16 (as XLA
# all-reduces the dot's output), which moves about half of each split
# output by an ulp; a random-weight ViT carries any such change to its
# bf16 noise level, the level at which the 1 x 1 kernel path itself sits
# against its plain versions (phase 4's comparison). So the yardstick is
# that comparison, on the same weights and frames, in this run: the
# group's depth against the 1 x 1 one at most GROUP_FLOOR times the 1 x 1
# kernel path's against plain in mean (and at most DEPTH_REL of the range);
# its SBS within parity_report's gate, a fraction at most GATE_FRAC of a
# frame's values off by more than GATE (of 255), the budget raised to
# GROUP_FLOOR times the 1 x 1 kernel path's own fraction against plain
# where that is larger. Measured before these bounds were set (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 6): the group's mean 1.02-1.06
# times the yardstick's (vitl-728 0.449% and 0.462% of the range at 1 x 2
# and 1 x 4 against 0.441%, vitl-518 xla 0.491% and 0.504% against
# 0.477%, vitg-518 8.1e-6 against 7.9e-6), its SBS fraction 8.6e-4 to
# 1.18e-3 against the yardstick's 8.9e-4, 1.07e-3 and 7.9e-5. A fixed mean
# bound of 0.40% (the kernels' own error on phase 4's frames) would refuse
# the 1 x 1 kernel path itself on these.
GROUP_FLOOR = DEPTH_FLOOR
GATE, GATE_FRAC = 1e-2, 1e-3
# The calibrated scaler puts the batch's peak depth near GROUP_PEAK and
# every frame's peak, raw and temporally blended, between two integers, as
# far from the nearer one as a scaler within GROUP_PEAK_SPAN of
# GROUP_PEAK's allows (off_integer_scaler): the warp's plane table starts
# from ceil(a frame's max depth) and its offset range from ceil(the blended
# max) of every frame so far, so a peak on an integer moves every plane of
# a frame for a change of an ulp. (On frames of uniform noise a vits-518
# xla 1 x 4 group, its mean depth 1.11 x the yardstick's, moved 46% of one
# frame's SBS values when only the batch's peak was placed so; 1 x 8,
# another frame's, when only the raw peaks were: NVIDIA H100 80GB HBM3,
# 700.00 W.)
GROUP_PEAK, GROUP_PEAK_SPAN = 11.5, 0.1
# f32: the partials' f32 rounding only; the max against the range.
GROUP_F32_REL = 1e-5
# A rank holds the balanced, contiguous head range [floor(r H / M),
# floor((r + 1) H / M)) (parallel/sharding.head_range): a split attention
# half launches its LayerNorm and the attention once a rank that holds
# heads (a rank with none adds a zero partial).
def head_holders(heads: int, m: int) -> int:
    return sum((r + 1) * heads // m > r * heads // m for r in range(m))


# (label, encoder, mlp_fused, --input_size, batch, compute dtype, model
# ranks M, one step's launches at M ranks (24 blocks at vitl, 40 at vitg;
# the final norm at the 4 taps on the first rank), blocks (None: all)).
# vitl-728 `auto`: the
# attention half unfused (N = 4785 > 4096): LayerNorm, the qkv shard, row
# 17 at 16/M heads, the proj shard, one all-reduce; the MLP half row 9 on
# whole weights on every rank. vitl-518 `--mlp_fused xla`: both halves
# split, row 2 at 16/M heads. vitg-518 `auto`: the attention half unfused
# (attn_fusable is False at D = 1536), row 2 at 24/M heads; the SwiGLU half
# row 10 whole (the rules replicate w12 and w3). f32 vitl-518 `auto`: the
# attention half unfused (attn_fusable is False at D = 1024 in f32), row 2
# at f32, row 9 at f32 whole, the tail unfused (no f32 plan fits). vits'
# 6 heads and vitb's 12 split unevenly: vits-518 `--mlp_fused xla` at 1 x
# 4 (1, 2, 1, 2 heads) and 1 x 8 (two ranks with none: 6 attention
# launches a block), both halves split, the ext tail at C = 64; vits-518
# `auto` at 1 x 4, the attention half fused on whole weights, the MLP half
# split; vitb-518 `--mlp_fused xla` at 1 x 8 (1 or 2 heads a rank), cut to
# 4 of its 12 blocks, the ext tail at C = 128.
GROUP_PATHS = (
    ("vitl-728 auto", "vitl", "auto", 728, B_L728, "bfloat16", (2, 4),
     lambda m: {"layernorm": 24 * m + 4, "flash_attention": 24 * m,
                "mlp_residual_hblocked": 24 * m, "head_tail_big_front": 1,
                "head_tail_big_back": 1, "warp_composite": 1,
                "blur_select_sbs": 1}, None),
    ("vitl-518 xla", "vitl", "xla", 518, B, "bfloat16", (2, 4),
     lambda m: {"layernorm": 48 * m + 4, "attention": 24 * m,
                "head_tail_big_front": 1, "head_tail_big_back": 1,
                "warp_composite": 1, "blur_select_sbs": 1}, None),
    ("vitg-518 auto", "vitg", "auto", 518, B, "bfloat16", (2,),
     lambda m: {"layernorm": 40 * m + 4, "attention": 40 * m,
                "swiglu_residual": 40 * m, "head_tail_big_front": 1,
                "head_tail_big_back": 1, "warp_composite": 1,
                "blur_select_sbs": 1}, None),
    ("vitl-518 auto f32", "vitl", "auto", 518, 2, "float32", (2,),
     lambda m: {"layernorm_f32": 24 * m + 4, "attention_f32": 24 * m,
                "mlp_residual_hblocked_f32": 24 * m, "warp_composite": 1,
                "blur_select_sbs": 1}, None),
    ("vits-518 xla", "vits", "xla", 518, B, "bfloat16", (4, 8),
     lambda m: {"layernorm": 12 * (m + head_holders(HEADS, m)) + 4,
                "attention": 12 * head_holders(HEADS, m),
                "head_tail_ext": 1, "warp_composite": 1,
                "blur_select_sbs": 1}, None),
    ("vits-518 auto", "vits", "auto", 518, B, "bfloat16", (4,),
     lambda m: {"layernorm": 12 * m + 4, "ln_qkv": 12 * m,
                "attention": 12 * m, "proj_ls_residual": 12 * m,
                "head_tail_ext": 1, "warp_composite": 1,
                "blur_select_sbs": 1}, None),
    ("vitb-518 xla", "vitb", "xla", 518, B, "bfloat16", (8,),
     lambda m: {"layernorm": 4 * (m + head_holders(12, m)) + 4,
                "attention": 4 * head_holders(12, m), "head_tail_ext": 1,
                "warp_composite": 1, "blur_select_sbs": 1}, 4))
# Rows 2 and 17 at the head counts a rank runs on these paths: (kernel,
# batch, tokens, heads, the path at 1 x M that launches it).
GROUP_ATTENTION = (
    ("flash_attention", B_L728, N_L728, HEADS_L // 2, "vitl-728 auto 1x2"),
    ("flash_attention", B_L728, N_L728, HEADS_L // 4, "vitl-728 auto 1x4"),
    ("attention", B, N_TOK, HEADS_L // 2, "vitl-518 xla 1x2"),
    ("attention", B, N_TOK, HEADS_L // 4, "vitl-518 xla 1x4"),
    ("attention", B, N_TOK, HEADS_G // 2, "vitg-518 auto 1x2"),
    ("attention", B, N_TOK, 1, "vits-518 xla 1x4"),
    ("attention", B, N_TOK, 2, "vits-518 xla 1x4"))


def card_state_dict(cfg, device):
    """``models.factory.random_state_dict``'s distributions (LeCun-normal
    weights, zero biases and tokens, unit scales, N(0, 0.02) pos-embed),
    drawn by torch on the card from SEED: seconds for vitg's 1.3 B
    parameters, where numpy takes ~40 s."""
    import torch

    from vr_video_generator_tpu_torch.models.depth_anything_v2 import \
        DepthAnythingV2

    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in DepthAnythingV2(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        if name.endswith("pos_embed"):
            sd[name] = 0.02 * torch.randn(shape, generator=gen, device=device)
        elif name.endswith(("cls_token", "mask_token", ".bias")):
            sd[name] = torch.zeros(shape, device=device)
        elif name.endswith(".gamma") or len(shape) == 1:
            sd[name] = torch.ones(shape, device=device)
        else:
            fan_in = (shape[0] * shape[2] * shape[3]
                      if "resize_layers.0" in name or "resize_layers.1" in name
                      else int(np.prod(shape[1:])))
            sd[name] = torch.randn(shape, generator=gen,
                                   device=device) / fan_in ** 0.5
    return sd


def off_integer_scaler(peaks, scaler: float):
    """(the scaler within GROUP_PEAK_SPAN of ``scaler`` that puts each of
    the frames' raw depth ``peaks`` farthest from an integer, that least
    distance)."""
    cands = scaler * np.linspace(1 - GROUP_PEAK_SPAN, 1 + GROUP_PEAK_SPAN,
                                 4001)
    depth = cands[:, None] * np.asarray(peaks, np.float64)[None]
    gap = np.abs(depth - np.round(depth)).min(axis=1)
    best = int(np.argmax(gap))
    return float(cands[best]), float(gap[best])


def group_path(device, frames, label, encoder, mlp_fused, size, batch,
               dtype, ms, need, blocks=None) -> dict:
    """One path of phase 10: the 1 x 1 SbsPipeline (calibrated scaler) and
    ``ShardedSbsPipeline`` at 1 x M on ``[device] * M`` for each M of
    ``ms``, one batch each after a warm-up step, the launch counts reset
    just before the group's step and read just after (exactly ``need(M)``);
    the group's depth and SBS held against the 1 x 1 ones, the right half
    equal to the input; the host ms of one group step's dispatch (nothing
    read back, median of 5) beside the 1 x 1 eager step's. ``blocks`` cuts
    the encoder's depth (taps at blocks 0 .. blocks - 1)."""
    import torch

    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.models.factory import build_model
    from vr_video_generator_tpu_torch.ops.temporal import temporal_scan
    from vr_video_generator_tpu_torch.parallel.mesh import make_mesh
    from vr_video_generator_tpu_torch.parallel.sharded import \
        ShardedSbsPipeline
    from vr_video_generator_tpu_torch.parity_report import (frame_stats,
                                                            gate_passes)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline
    from vr_video_generator_tpu_torch.stage_bench import (
        TARGET_DEPTH_MAX, calibrate_random_scaler)

    cfg = run_config(encoder, mlp_fused, "auto", batch=batch,
                     input_size=size, dtype=dtype)
    mcfg = cfg.model()
    if blocks is not None:
        mcfg = dataclasses.replace(mcfg, depth=blocks,
                                   intermediate_layers=tuple(range(blocks)))
    t0 = time.perf_counter()
    sd = card_state_dict(mcfg, device)
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    single = SbsPipeline(build_model(mcfg, sd, tdtype, device), H, W,
                         run_cfg=cfg)
    del sd
    build_s = time.perf_counter() - t0
    frames = frames[:batch]
    batch_dev = single.frames_to_device(frames)
    scaler = calibrate_random_scaler(single, frames) * GROUP_PEAK \
        / TARGET_DEPTH_MAX
    with torch.inference_mode():
        depth = single.depth_only(batch_dev)
        blended = temporal_scan(depth, single.initial_state(), single.spec)[0]
        peaks = torch.cat([depth.amax(dim=(1, 2)), blended.amax(dim=(1, 2))])
    scaler, gap = off_integer_scaler(
        peaks.cpu().numpy() / single.model.cfg.depth_scaler, scaler)
    del depth, blended
    single.model.cfg = dataclasses.replace(single.model.cfg,
                                           depth_scaler=scaler)
    log(f"{label}: depth scaler {scaler}, every frame's peak at least {gap} "
        f"from an integer")

    def dispatch_ms(step):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return float(np.median(times))

    with torch.inference_mode():
        want_depth = single.depth_only(batch_dev)
        want_sbs, _ = single.step(batch_dev, single.initial_state())
    want_sbs = want_sbs.cpu().numpy()
    span = float(want_depth.max() - want_depth.min())
    out = {"build_s": build_s, "depth_range": span,
           "blocks": f"{mcfg.depth} of {cfg.model().depth}",
           "host_dispatch_ms_1x1": dispatch_ms(
               lambda: single.step(batch_dev, single.initial_state()))}
    if dtype == "bfloat16":
        # The yardstick: the 1 x 1 kernel path against its plain versions
        # on the same weights and frames (phase 4's comparison).
        with PlainKernels(), torch.inference_mode():
            plain_depth = single.depth_only(batch_dev)
            plain_sbs, _ = single.step(batch_dev, single.initial_state())
        err = (plain_depth - want_depth).abs()
        gate = [frame_stats(g, w, GATE)
                for g, w in zip(plain_sbs.cpu().numpy(), want_sbs)]
        out["kernel_vs_plain"] = dict(
            depth_mean_rel=float(err.mean()) / span,
            depth_max_rel=float(err.max()) / span,
            sbs_worst_frac=max(f for _, _, f in gate))
        log(f"{label} 1x1 kernels against plain: "
            f"{json.dumps(out['kernel_vs_plain'])}")
        del plain_depth, plain_sbs
    for m in ms:
        tag = f"{label} 1x{m}"
        t0 = time.perf_counter()
        sp = ShardedSbsPipeline(single.model, H, W,
                                make_mesh((1, m), devices=[device] * m),
                                run_cfg=cfg)
        sp.step([batch_dev], sp.initial_state())  # warm-up: whole weights
        torch.cuda.synchronize()
        states = sp.initial_state()
        reset_launch_counts()
        sbs, _ = sp.step([batch_dev], states)
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        step_s = time.perf_counter() - t0
        require(counts == need(m), f"{tag}: launched {json.dumps(counts)}, "
                f"expected {json.dumps(need(m))}")
        with torch.inference_mode():
            depth = sp.replicas[0].depth_only(batch_dev)
        err = (depth - want_depth).abs()
        got = sbs[0].cpu().numpy()
        require(np.array_equal(got[:, :, W:], frames),
                f"{tag}: the SBS's right half differs from the input")
        gate = [frame_stats(g, w, GATE) for g, w in zip(got, want_sbs)]
        stats = dict(depth_mean_rel=float(err.mean()) / span,
                     depth_max_rel=float(err.max()) / span,
                     sbs_worst_frac=max(f for _, _, f in gate),
                     sbs_worst_mean=max(mn for mn, _, _ in gate),
                     host_dispatch_ms=dispatch_ms(
                         lambda: sp.step([batch_dev], states)),
                     seconds=step_s, launches=counts)
        log(f"{tag}: {json.dumps(stats)}")
        if dtype == "float32":
            require(stats["depth_max_rel"] <= GROUP_F32_REL,
                    f"{tag}: depth off the 1x1 by {stats['depth_max_rel']} "
                    f"of its range at most (limit {GROUP_F32_REL})")
            budget = GATE_FRAC
        else:
            yard = out["kernel_vs_plain"]
            limit = min(GROUP_FLOOR * yard["depth_mean_rel"], DEPTH_REL)
            require(stats["depth_mean_rel"] <= limit,
                    f"{tag}: depth off the 1x1 by {stats['depth_mean_rel']} "
                    f"of its range on average (limit {limit}: "
                    f"{GROUP_FLOOR} x the 1x1 kernels' against plain)")
            budget = max(GATE_FRAC, GROUP_FLOOR * yard["sbs_worst_frac"])
        require(gate_passes(gate, GATE, budget),
                f"{tag}: SBS against the 1x1: {json.dumps(gate)} over the "
                f"gate {GATE}, budget {budget}")
        out[f"1x{m}"] = stats
        del sp, states, sbs, depth
        torch.cuda.empty_cache()
    del single
    torch.cuda.empty_cache()
    return out


def group_cli(device, mesh: str = "1x2") -> dict:
    """Phase 10 (c): ``cli.main --mesh <mesh> --encoder vits --device
    cuda:0`` (vits ``auto``, every rank on the card; at 1x4 the ranks hold
    1, 2, 1 and 2 of the 6 heads) over a 24-frame 1080p ``soak_gen`` mp4
    (cv2): subclips 0_5 .. 18_23 that ``check_subclips`` passes, and the
    sharded log."""
    import tempfile

    from vr_video_generator_tpu_torch import cli, soak_gen
    from vr_video_generator_tpu_torch.video.check import check_subclips
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips

    with tempfile.TemporaryDirectory() as d:
        video = os.path.join(d, "in.mp4")
        soak_gen.generate(video, 3 * B, H, W)
        sub = os.path.join(d, "S") + os.sep
        argv = ["--device", str(device), "--mesh", mesh, "--encoder", "vits",
                "--VideoDir", video,
                "--OutputDir", os.path.join(d, "out.mkv"),
                "--DebugDir", os.path.join(d, "D") + os.sep,
                "--SubClipDir", sub, "--Max_Frame_Count", "6",
                "--batch_size", str(B), "--repair_mode", "1",
                "--reader_backend", "cv2", "--writer_backend", "cv2",
                "--allow_random_weights"]
        t0 = time.perf_counter()
        require(cli.main(argv) == 0, f"cli --mesh {mesh}: non-zero exit")
        secs = time.perf_counter() - t0
        names = sorted_subclips(sub)
        issues = check_subclips(sub)
        logs = sorted(os.listdir(os.path.join(d, "D")))
    want = [f"{i}_{i + 5}.mp4" for i in range(0, 3 * B, 6)]
    require(names == want and issues == [] and "sharded_p0.txt" in logs,
            f"cli --mesh {mesh}: subclips {names}, issues {issues}, logs "
            f"{logs}")
    out = dict(clips=names, seconds=secs)
    log(f"phase 10 (c) cli --mesh {mesh} --encoder vits --device {device}: "
        f"24 frames of a 1080p mp4, subclips that check: {json.dumps(out)}")
    return out


def model_axis_path(device) -> dict:
    """Phase 10: the model axis on one card (see the constants above): (a)
    rows 2 and 17 at the head counts a rank runs; (b) vitl-728 ``auto`` at
    1 x 2 and 1 x 4, vitl-518 ``--mlp_fused xla`` at 1 x 2 and 1 x 4,
    vitg-518 ``auto`` at 1 x 2, f32 vitl-518 ``auto`` at 1 x 2, and the
    uneven head splits: vits-518 ``--mlp_fused xla`` at 1 x 4 and 1 x 8,
    vits-518 ``auto`` at 1 x 4, vitb-518 ``--mlp_fused xla`` at 1 x 8 (4
    blocks), each against 1 x 1; (c) ``cli.main --mesh 1x2`` and ``--mesh
    1x4``."""
    import tempfile

    from vr_video_generator_tpu_torch import soak_gen
    from vr_video_generator_tpu_torch.video.reader import VideoReader

    out, t0 = {"kernels": {}, "paths": {}}, time.perf_counter()
    for i, (name, b, n, heads, _) in enumerate(GROUP_ATTENTION):
        out["kernels"][f"{name} H={heads}"] = check_attention(
            name, b, n, heads, SEED + 100 + i)
    log(f"phase 10 (a) rows 2 and 17 at a rank's heads: "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_group_") as tmp:
        video = os.path.join(tmp, "group_1080p.mp4")
        soak_gen.generate(video, B, H, W)
        with VideoReader(video, begin=0, backend="cv2") as r:
            frames = np.stack(list(r.frames(0, B)))
    for label, encoder, mlp_fused, size, batch, dtype, ms, need, blocks \
            in GROUP_PATHS:
        t0 = time.perf_counter()
        res = group_path(device, frames, label, encoder, mlp_fused, size,
                         batch, dtype, ms, need, blocks)
        for m in ms:
            out["paths"][f"{label} 1x{m}"] = res.pop(f"1x{m}")
        out["paths"][label] = res
        log(f"phase 10 (b) {label}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["cli"] = group_cli(device)
    out["cli 1x4"] = group_cli(device, "1x4")
    log(f"phase 10 (c): {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 11: the front ends on the card. The real-weights runbook and the
# tkinter form's model, each driven as a user drives it, on stand-in
# checkpoints saved from the port's seeded random state_dict at full width
# (no real Depth-Anything-V2 weights are in the repository). The runbook's
# parity step and the form's Run and Repair are processes of their own:
# each writes its launch counts on exit (kernels.COUNTS_DIR_ENV), and the
# path's counts are its own process's (the golden depth) and theirs.
#
# The runbook's stand-ins amplify the final head conv as
# tests/test_real_weights_runbook.py does (weight x 50, bias |b| + 450):
# raw depth lies far outside the family bands, so the scaler is calibrated
# and the warp has planes. Its golden depth is always f32 (on the card the
# 3xTF32 kernel path against the plain CPU path); (a) runs its parity step
# at f32 at configs 2 and 3, (b) at its own default, bf16, at config 2. A
# random ViT in bf16 carries any one-ulp change to its noise level, so (b)
# passes the runbook's gate or phase 10's in-run yardstick: the kernel
# path's fraction over the gate at most GROUP_FLOOR times the plain bf16
# path's (PlainKernels) against the same oracle on the same frames.
# Measured before this rule was kept (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md section 6): at f32 both configs 2e-6 over the gate; at bf16 the
# kernel path 0.0161 against the plain path's 0.0160 (the 1e-3 budget
# missed by both).
RUNBOOK_STANDINS = ("vits", "vitb")
F32_VITS_AUTO = ("layernorm_f32", "ln_qkv_f32", "attention_f32",
                 "proj_ls_residual_f32", "head_tail_ext_f32", "tf32x3_split")
F32_VITB_518_AUTO = ("layernorm_f32", "ln_qkv_f32", "attention_f32",
                     "proj_ls_residual_f32", "mlp_residual_hblocked_f32",
                     "head_tail_big_f32", "tf32x3_split")
WARP_PAIR = ("warp_composite", "blur_select_sbs")
# (label, the runbook's flags, by encoder: the kernels of the golden depth
# (in this process), and those of a parity step (a process of its own))
RUNBOOK_RUNS = (
    ("f32", ["--configs", "2,3", "--compute_dtype", "float32"],
     {"vits": F32_VITS_AUTO, "vitb": F32_VITB_518_AUTO},
     {"vits": F32_VITS_AUTO + WARP_PAIR,
      "vitb": F32_VITB_518_AUTO + WARP_PAIR}),
    ("bf16", ["--configs", "2"], {"vits": F32_VITS_AUTO},
     {"vits": AUTO_VITS}))
UI_TIMEOUT_S = 300


def standin_checkpoints(directory, encoders, amplify: bool) -> dict:
    """``depth_anything_v2_<encoder>.pth`` in ``directory`` for each of
    ``encoders``: ``models.factory.random_state_dict`` (seed 0, the CLI's
    ``--allow_random_weights``) at full width, saved as tensors
    (``load_model`` reads with weights_only=True); with ``amplify`` the
    final head conv's weight x 50 and bias |b| + 450. Returns the paths."""
    import torch

    from vr_video_generator_tpu_torch.models.factory import random_state_dict
    from vr_video_generator_tpu_torch.parity_report import FINAL_CONV
    from vr_video_generator_tpu_torch.utils.config import ModelConfig

    os.makedirs(directory, exist_ok=True)
    paths = {}
    for encoder in encoders:
        sd = {k: torch.from_numpy(v) for k, v in random_state_dict(
            ModelConfig.for_encoder(encoder)).items()}
        if amplify:
            sd[f"{FINAL_CONV}.weight"] = sd[f"{FINAL_CONV}.weight"] * 50.0
            sd[f"{FINAL_CONV}.bias"] = sd[f"{FINAL_CONV}.bias"].abs() + 450.0
        paths[encoder] = os.path.join(directory,
                                      f"depth_anything_v2_{encoder}.pth")
        torch.save(sd, paths[encoder])
    return paths


@contextlib.contextmanager
def counted(directory):
    """Count the launches of the block: this process's counts are reset on
    entry, and every process started inside (with the repository on its
    PYTHONPATH) writes its own into ``directory`` when it exits
    (``kernels.COUNTS_DIR_ENV``). Yields a dict that holds, after the
    block, ``own`` (this process's non-zero counts) and ``children``
    ([(argv, counts)] of those processes)."""
    import torch

    from vr_video_generator_tpu_torch.kernels import (COUNTS_DIR_ENV,
                                                       launch_counts,
                                                       reset_launch_counts)

    os.makedirs(directory, exist_ok=True)
    saved = {k: os.environ.get(k) for k in (COUNTS_DIR_ENV, "PYTHONPATH")}
    repo = os.path.dirname(os.path.abspath(__file__))
    os.environ[COUNTS_DIR_ENV] = directory
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (repo, saved["PYTHONPATH"]) if p)
    out = {}
    reset_launch_counts()
    try:
        yield out
    finally:
        torch.cuda.synchronize()
        out["own"] = {k: v for k, v in launch_counts().items() if v}
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    children = []
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name)) as f:
            rec = json.load(f)
        children.append((rec["argv"], rec["counts"]))
    out["children"] = children


def parity_result(line: str) -> tuple:
    """(worst fraction over the gate, worst mean) of a parity_report
    RESULT line."""
    import re

    m = re.search(r"worst frac\(\|diff\|>[^)]*\) = ([0-9.e+-]+) .*"
                  r"worst mean = ([0-9.e+-]+)", line)
    require(m is not None, f"not a parity RESULT line: {line!r}")
    return float(m.group(1)), float(m.group(2))


def runbook_path(tmp, ckpt_dir, label, flags, need_own, need_parity) -> dict:
    """Phase 11 (a) or (b): ``real_weights_runbook.main`` on the card at
    --frames 2 and --input_size 518 on its 1080p ``synth_clip``, counted;
    every row calibrated, under the step cap, its depth_ok, and raw max x
    scaler on the target within 1e-6."""
    from vr_video_generator_tpu_torch import real_weights_runbook as rb

    out_path = os.path.join(tmp, f"runbook_{label}.json")
    t0 = time.perf_counter()
    with counted(os.path.join(tmp, f"counts_runbook_{label}")) as counts:
        rc = rb.main(["--checkpoints_dir", ckpt_dir, "--frames", "2",
                      "--input_size", "518", "--device", "cuda",
                      "--workdir", os.path.join(tmp, "runbook"),
                      "--out", out_path, *flags])
    secs = time.perf_counter() - t0
    with open(out_path) as f:
        art = json.load(f)
    launched_exactly(f"runbook {label} golden depth", counts["own"],
             set().union(*need_own.values()))
    parity = {}
    for argv, c in counts["children"]:
        encoder = argv[argv.index("--encoder") + 1]
        launched_exactly(f"runbook {label} parity step {argv[1:]}", c,
                 need_parity[encoder])
        parity[encoder] = c
    require(len(counts["children"]) == len(art["rows"]),
            f"runbook {label}: {len(counts['children'])} parity processes "
            f"counted for {len(art['rows'])} rows")
    rows = []
    for row in art["rows"]:
        g = row["golden_depth"]
        tag = f"runbook {label} config {row['config']} ({row['encoder']})"
        require(g["calibrated"] and g["under_step_cap"] and g["depth_ok"],
                f"{tag}: golden depth {json.dumps(g)}")
        on_target = abs(g["raw_depth_max"] * g["scaler_used"]
                        - rb.CAL_TARGET_MAX)
        require(on_target <= 1e-6, f"{tag}: raw max x scaler is "
                f"{on_target} off the target {rb.CAL_TARGET_MAX}")
        frac, mean = parity_result(row["parity_tail"][-1])
        rows.append(dict(config=row["config"], encoder=row["encoder"],
                         status=row["status"],
                         depth_rel_mean=g["depth_rel_mean"],
                         depth_rel_max=g["depth_rel_max"],
                         raw_depth_max=g["raw_depth_max"],
                         scaler_used=g["scaler_used"], sbs_worst_frac=frac,
                         sbs_worst_mean=mean, parity=row["parity_tail"][-1]))
        log(f"phase 11 {tag}: {json.dumps(rows[-1])}")
    return dict(rc=rc, all_pass=art["all_pass"], rows=rows, seconds=secs,
                launches=dict(golden=counts["own"], parity=parity))


def runbook_yardstick(tmp, ckpt, row) -> dict:
    """Phase 11 (b)'s yardstick: the parity step of ``row`` (config 2,
    bf16, its calibrated scaler) run again with the depth net's kernels
    swapped for their plain versions on the card (launches not counted):
    its worst fraction over the gate against the same oracle."""
    from vr_video_generator_tpu_torch import parity_report

    args = parity_report.build_parser().parse_args(
        ["--video", os.path.join(tmp, "runbook", "clip_1080p.mp4"),
         "--frames", "2", "--encoder", row["encoder"], "--encoder_path", ckpt,
         "--input_size", "518", "--device", "cuda",
         "--compute_dtype", "bfloat16",
         "--depth_scaler", repr(row["scaler_used"])])
    with PlainKernels():
        stats, lines = parity_report.run(args)
    return dict(sbs_worst_frac=max(f for _, _, f in stats),
                sbs_worst_mean=max(m for m, _, _ in stats), result=lines[-1])


def wait_for(model, label) -> float:
    """Poll the form's ``running()`` until its process ends, at most
    UI_TIMEOUT_S; require exit code 0. Returns the seconds."""
    t0 = time.perf_counter()
    while model.running():
        if time.perf_counter() - t0 > UI_TIMEOUT_S:
            model.stop()
            require(False, f"{label}: still running after {UI_TIMEOUT_S} s")
        time.sleep(0.25)
    rc = model.proc.returncode()
    require(rc == 0, f"{label}: exit code {rc}")
    return time.perf_counter() - t0


def truncate_clip(path: str, keep: int) -> None:
    """Rewrite the mp4 at ``path`` with only its first ``keep`` frames."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    frames = [cap.read()[1] for _ in range(keep)]
    cap.release()
    h, w = frames[0].shape[:2]
    tmp = path + ".part.mp4"
    vw = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(f)
    vw.release()
    os.replace(tmp, path)


def ui_path(tmp, ckpt) -> dict:
    """Phase 11 (c): ``ui.tkapp.FormModel`` filled as a user fills it (a
    24-frame 1080p ``soak_gen`` mp4, the un-amplified stand-in vits,
    Max_Frame_Count 6, batch_size 8, the form's own repair_mode 0, the
    rest its defaults: bf16 vits on the card), Run until its process ends:
    subclips 0_5 .. 18_23 and the combined output, Verify clean; one
    subclip truncated: Verify names it with its repair range; Repair, and
    Verify clean again. Each process launches exactly vits ``auto``'s
    kernels."""
    from vr_video_generator_tpu_torch import soak_gen
    from vr_video_generator_tpu_torch.ui.app import auto_output_name
    from vr_video_generator_tpu_torch.ui.tkapp import FormModel
    from vr_video_generator_tpu_torch.video.combine import sorted_subclips
    from vr_video_generator_tpu_torch.video.reader import probe_video

    n = 3 * B
    video = os.path.join(tmp, "ui_1080p.mp4")
    soak_gen.generate(video, n, H, W)
    sub = os.path.join(tmp, "ui", "Subclip") + os.sep
    form = FormModel()
    for key, value in (("VideoDir", video), ("encoder_path", ckpt),
                       ("Max_Frame_Count", "6"), ("batch_size", str(B)),
                       ("DebugDir", os.path.join(tmp, "ui", "Debug") + os.sep),
                       ("SubClipDir", sub)):
        form.set_field(key, value)
    require(form.fields["repair_mode"] == "0" and "--device" not in
            form.preview(), f"the form's command: {form.preview()}")
    log(f"phase 11 (c) form command: {form.preview()}")
    want = [f"{i}_{i + 5}.mp4" for i in range(0, n, 6)]
    out = {}
    with counted(os.path.join(tmp, "counts_ui_run")) as run_counts:
        form.run()
        out["run_s"] = wait_for(form, "ui Run")
    names = sorted_subclips(sub)
    report = form.verify_report()
    output = auto_output_name(video)
    _, out_frames, out_w, _ = probe_video(output)
    require(names == want and "all subclips OK" in report
            and f"coverage complete: {n}/{n}" in report,
            f"ui Run: subclips {names}; report:\n{report}")
    require(out_frames == n and out_w == 2 * W,
            f"ui Run: {output} has {out_frames} frames {out_w} wide")
    log(f"phase 11 (c) Verify after Run:\n{report}")
    truncate_clip(os.path.join(sub, want[1]), 3)
    report = form.verify_report()
    require(f"BAD length: {want[1]} -> regenerate frames [6, 12)" in report
            and "--repair_mode 1 --start_frame 6 --end_frame 12" in report,
            f"ui Verify of a truncated subclip:\n{report}")
    log(f"phase 11 (c) Verify after truncating {want[1]}:\n{report}")
    with counted(os.path.join(tmp, "counts_ui_repair")) as repair_counts:
        form.repair()
        out["repair_s"] = wait_for(form, "ui Repair")
    report = form.verify_report()
    require(sorted_subclips(sub) == want and "all subclips OK" in report
            and f"coverage complete: {n}/{n}" in report,
            f"ui Repair: subclips {sorted_subclips(sub)}; report:\n{report}")
    for label, counts in (("Run", run_counts), ("Repair", repair_counts)):
        require(not counts["own"] and len(counts["children"]) == 1,
                f"ui {label}: {counts}")
        launched_exactly(f"ui {label}", counts["children"][0][1], AUTO_VITS)
        out[f"{label.lower()}_launches"] = counts["children"][0][1]
    log(f"phase 11 (c) ui: {json.dumps(out)}")
    return out


def front_ends_path() -> dict:
    """Phase 11: (a) the runbook at f32, configs 2 and 3, amplified
    stand-in vits and vitb; (b) the runbook at bf16, config 2, its gate or
    the yardstick; (c) the tkinter form's Run, Verify and Repair."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_front_") as tmp:
        t0 = time.perf_counter()
        ckpts = standin_checkpoints(os.path.join(tmp, "amplified"),
                                    RUNBOOK_STANDINS, amplify=True)
        plain = standin_checkpoints(os.path.join(tmp, "plain"), ("vits",),
                                    amplify=False)["vits"]
        log(f"phase 11 stand-in checkpoints: {time.perf_counter() - t0:.1f} s")
        ckpt_dir = os.path.dirname(ckpts["vits"])
        for label, flags, need_own, need_parity in RUNBOOK_RUNS:
            res = runbook_path(tmp, ckpt_dir, label, flags, need_own,
                               need_parity)
            if label == "f32":
                require(res["rc"] == 0 and res["all_pass"],
                        f"runbook f32: rc {res['rc']}, rows {res['rows']}")
            else:
                row = res["rows"][0]
                yard = runbook_yardstick(tmp, ckpts["vits"], row)
                budget = max(GATE_FRAC, GROUP_FLOOR * yard["sbs_worst_frac"])
                res["yardstick"] = dict(yard, budget=budget)
                log(f"phase 11 (b) plain bf16 path against the oracle: "
                    f"{json.dumps(res['yardstick'])}")
                require(res["all_pass"] or (
                    row["sbs_worst_frac"] <= budget
                    and row["sbs_worst_mean"] <= GATE),
                    f"runbook bf16: {row['parity']}, over the gate and the "
                    f"yardstick's budget {budget}")
            out[f"runbook {label}"] = res
            log(f"phase 11 ({'a' if label == 'f32' else 'b'}) runbook "
                f"{label}: {res['seconds']:.1f} s")
        out["ui"] = ui_path(tmp, plain)
    return out


# ---------------------------------------------------------------------------
# Phase 12: the encoder at every width the JAX package takes. No CLI flag
# reaches a custom ModelConfig (in the JAX package or in the port), so the
# paths are built as a library user builds them: models/factory.build_model
# on a seeded state_dict of the custom configuration, then SbsPipeline.step.
#
# Kernel 1 (csrc/attention_any.cu at bf16, csrc/attention_any_f32.cu at
# f32): rows 2 and 17 at head dims other than 64, (head dim, heads,
# one-shot batch, flash batch): D = 384's heads at 16, 32 and 48, D = 768's
# at 128 and 256, and 12 heads of 20 (no multiple of 8: the bf16 kernel
# reads q, k and v through the pad pass). One-shot at N = 2443 (1080p,
# input 518), flash at N = 4785 (input 728); head dims 32 and 128 at their
# paths' batches (hd32 runs row 2 at B = 8 and row 17 at B = 2). Each is
# timed.
ATTN_ANY = ((16, 24, 2, 1), (20, 12, 2, 1), (32, 12, 8, 2), (48, 8, 2, 1),
            (128, 6, 8, 2), (256, 3, 2, 1))
# The kernels whose SASS phase 12 reads (attention_bench.sass_counts): the
# bf16 ones must hold HGMMA, the f32 ones HGMMA with TF32 operands.
ATTN_ANY_SASS = {"attention_any_kernel": "HGMMA",
                 "attention_any_f32_kernel": "HGMMA_TF32"}
# At f32 against the same function on f64 operands: the 3xTF32 rows' bound
# (PERF.md: rows 2 and 17 at most 3.7e-6 of max |o|), which the TF32 result
# of the plain version exceeds. Measured (NVIDIA H100 80GB HBM3, 700.00 W)
# on csrc/attention_any_f32.cu: at most 1.5e-6 max and 7e-7 mean of |o| at
# every head dim 16-1024, both rows (its exponentials with ex2.approx: up to
# 4.5e-6 at 4785 keys; with expf, as it runs); the f32 plain version (cuBLAS,
# TF32 off) 5e-7-3.7e-6 max; TF32 5.3e-4-1.0e-3 max, 5.1e-4-6.2e-4 mean. The
# mean bound is twice the largest mean error the FFMA kernel before it
# measured (1.25e-6).
ATTN_ANY_F32_MAX_REL, ATTN_ANY_F32_MEAN_REL = 3.7e-6, 2.5e-6


def attn_any_f32_max_rel(d: int) -> float:
    """Kernel 1's f32 max bound at head dim ``d``: ATTN_ANY_F32_MAX_REL up
    to 256; above, scaled by d / 256, as the rounding bound of an f32 dot
    product grows with its length. At 512 (B = 8, N = 2443, 2 heads) the
    plain f32 version itself (cuBLAS, TF32 off) was 3.73e-6 of max |o| off
    f64 and kernel 1 3.84e-6 (NVIDIA H100 80GB HBM3, 700.00 W); TF32
    6.1e-4, 80x the scaled bound."""
    return ATTN_ANY_F32_MAX_REL * max(1.0, d / 256)
# The five custom configurations, at full width (ModelConfig fields over
# its defaults). w512: D = 512 with 8 heads of 64 (rows 5 and 6, row 8
# resident at D = 512, row 2); hd128: vitb's width and head with 6 heads of
# 128 (rows 5 and 6 at head dim 128, kernel 1 in the fused block); hd32:
# vits' width and head with 12 heads of 32 (kernel 1 in the unfused half;
# at input 728 its flash variant); r325: D = 640, 10 heads, mlp_ratio 3.25
# (hidden 2080, no multiple of 512: row 9, zero-padded to 2112); glu1024:
# SwiGLU at D = 1024 with 16 heads (hidden 2736, padded to 2816 at bf16).
# r325 and glu1024 are cut to 4 blocks. Phase 14 adds two head dims above
# 256, cut to 4 blocks: hd384, vitb's width with 2 heads of 384 (kernel 1
# in the fused attention half at 518, its flash variant at 728), and
# hd320, D = 640 with 2 heads of 320 (the fused half at 518; at 728 the
# library flash kernel's rule refuses the head dim).
WIDTH_PATHS = {
    "w512": dict(encoder="vitb", embed_dim=512, depth=12, num_heads=8,
                 mlp_ratio=4.0, features=64, out_channels=(64, 128, 256, 512),
                 intermediate_layers=(2, 5, 8, 11)),
    "hd128": dict(encoder="vitb", embed_dim=768, depth=12, num_heads=6,
                  mlp_ratio=4.0, features=128,
                  out_channels=(96, 192, 384, 768),
                  intermediate_layers=(2, 5, 8, 11)),
    "hd32": dict(encoder="vits", embed_dim=384, depth=12, num_heads=12,
                 mlp_ratio=4.0, features=64, out_channels=(48, 96, 192, 384),
                 intermediate_layers=(2, 5, 8, 11)),
    "r325": dict(encoder="vitb", embed_dim=640, depth=4, num_heads=10,
                 mlp_ratio=3.25, features=64,
                 out_channels=(80, 160, 320, 640),
                 intermediate_layers=(0, 1, 2, 3)),
    "glu1024": dict(encoder="vitl", embed_dim=1024, depth=4, num_heads=16,
                    mlp_ratio=4.0, features=256,
                    out_channels=(256, 512, 1024, 1024),
                    intermediate_layers=(0, 1, 2, 3),
                    ffn_layer="swiglufused"),
    "hd384": dict(encoder="vitb", embed_dim=768, depth=4, num_heads=2,
                  mlp_ratio=4.0, features=128,
                  out_channels=(96, 192, 384, 768),
                  intermediate_layers=(0, 1, 2, 3)),
    "hd320": dict(encoder="vitb", embed_dim=640, depth=4, num_heads=2,
                  mlp_ratio=4.0, features=64,
                  out_channels=(80, 160, 320, 640),
                  intermediate_layers=(0, 1, 2, 3)),
}
_TAIL = {"warp_composite": 1, "blur_select_sbs": 1}
# The paths, 1080p, `auto`, each step's launches exactly: (label, config,
# --input_size, batch, dtype, launches a step, weight splits at the first
# step (f32)).
WIDTH_RUNS = (
    ("w512-518", "w512", 518, B, "bfloat16",
     {"layernorm": 4, "ln_qkv": 12, "attention": 12, "proj_ls_residual": 12,
      "mlp_residual": 12, "head_tail_ext": 1, **_TAIL}, 0),
    ("hd128-518", "hd128", 518, B, "bfloat16",
     {"layernorm": 4, "ln_qkv": 12, "attention_any": 12,
      "proj_ls_residual": 12, "mlp_residual": 12, "head_tail_ext": 1,
      **_TAIL}, 0),
    ("hd32-518", "hd32", 518, B, "bfloat16",
     {"layernorm": 28, "attention_any": 12, "head_tail_ext": 1, **_TAIL}, 0),
    ("hd32-728", "hd32", 728, B_L728, "bfloat16",
     {"layernorm": 28, "flash_attention_any": 12, "head_tail_ext": 1,
      **_TAIL}, 0),
    ("r325-518", "r325", 518, B, "bfloat16",
     {"layernorm": 4, "ln_qkv": 4, "attention": 4, "proj_ls_residual": 4,
      "mlp_residual_hblocked": 4, "head_tail_ext": 1, **_TAIL}, 0),
    ("glu1024-518", "glu1024", 518, B, "bfloat16",
     {"layernorm": 4, "ln_qkv": 4, "attention": 4, "proj_ls_residual": 4,
      "swiglu_residual": 4, "head_tail_big_front": 1,
      "head_tail_big_back": 1, **_TAIL}, 0),
    ("w512-518 f32", "w512", 518, B, "float32",
     {"layernorm_f32": 4, "ln_qkv_f32": 12, "attention_f32": 12,
      "proj_ls_residual_f32": 12, "mlp_residual_f32": 12,
      "head_tail_ext_f32": 1, **_TAIL}, 24 + 24 + 3),
    ("hd128-518 f32", "hd128", 518, B, "float32",
     {"layernorm_f32": 4, "ln_qkv_f32": 12, "attention_any_f32": 12,
      "proj_ls_residual_f32": 12, "mlp_residual_hblocked_f32": 12,
      "head_tail_big_f32": 1, **_TAIL}, 24 + 24 + 2),
    ("hd32-728 f32", "hd32", 728, B_L728, "float32",
     {"layernorm_f32": 28, "flash_attention_any_f32": 12,
      "head_tail_big_f32": 1, **_TAIL}, 2),
)
# Kernel 1's entries in the kernels line: (counter, head dim, the path whose
# launches it carries).
ATTN_ANY_ENTRIES = (("attention_any", 32, "hd32-518"),
                    ("attention_any", 128, "hd128-518"),
                    ("flash_attention_any", 32, "hd32-728"),
                    ("attention_any_f32", 128, "hd128-518 f32"),
                    ("flash_attention_any_f32", 32, "hd32-728 f32"))
# Rows 5, 6, 8, 9 and 10 at the new widths (phase 12 (b)), with the path
# whose launches each carries in the kernels line: (counter, key, path).
WIDTH_ENTRIES = (
    ("ln_qkv", "ln_qkv D=512", "w512-518"),
    ("proj_ls_residual", "proj_ls_residual D=512", "w512-518"),
    ("mlp_residual", "mlp_residual D=512", "w512-518"),
    ("ln_qkv", "ln_qkv D=640", "r325-518"),
    ("proj_ls_residual", "proj_ls_residual D=640", "r325-518"),
    ("mlp_residual_hblocked", "mlp_residual_hblocked D=640 H=2080",
     "r325-518"),
    ("swiglu_residual", "swiglu_residual D=1024 H=2736", "glu1024-518"),
    ("ln_qkv_f32", "ln_qkv_f32 D=512", "w512-518 f32"),
    ("proj_ls_residual_f32", "proj_ls_residual_f32 D=512", "w512-518 f32"),
    ("mlp_residual_f32", "mlp_residual_f32 D=512", "w512-518 f32"))
KERNELS_ANY = {
    "attention_any": ("cuda", f"{PKG}/csrc/attention_any.cu",
                      f"{JAX_PKG}/ops/attention_pallas.py:43"),
    "flash_attention_any": ("cuda", f"{PKG}/csrc/attention_any.cu",
                            f"{JAX_PKG}/ops/attention.py:53"),
    "attention_any_f32": ("cuda", f"{PKG}/csrc/attention_any_f32.cu",
                          f"{JAX_PKG}/ops/attention_pallas.py:43"),
    "flash_attention_any_f32": ("cuda", f"{PKG}/csrc/attention_any_f32.cu",
                                f"{JAX_PKG}/ops/attention.py:53"),
}


def width_config(label: str):
    """The ModelConfig of WIDTH_PATHS' (or TAIL_PATHS') ``label``,
    ``auto``."""
    from vr_video_generator_tpu_torch.utils.config import ModelConfig

    return dataclasses.replace(ModelConfig(), mlp_fused="auto",
                               **{**WIDTH_PATHS, **TAIL_PATHS}[label])


def with_model(run_cfg, model_cfg):
    """``run_cfg`` whose model() returns ``model_cfg``, for the plan
    checks that read the model from a RunConfig."""
    import types

    fields = {f.name: getattr(run_cfg, f.name)
              for f in dataclasses.fields(run_cfg)}
    return types.SimpleNamespace(**fields, model=lambda: model_cfg)


def attention_f64(q, k, v, scale):
    """Softmax attention of (B, N, H, D) operands in f64, the logits times
    ``scale``: the f32 rows' exact reference."""
    import torch

    qt, kt, vt = (t.double().transpose(1, 2) for t in (q, k, v))
    p = torch.softmax((qt @ kt.transpose(-1, -2)) * scale, dim=-1)
    return (p @ vt).transpose(1, 2)


def check_attention_any(gen, flash: bool, d: int, heads: int, b: int, n: int,
                        dtype, timed: bool) -> dict:
    """Kernel 1, row 2 (q pre-scaled) or row 17 (``flash``), at head dim
    ``d`` on peaked q/k/v (attention_bench.peaked_qkv), k and v strided
    views into one qkv: one launch of its counter; bf16 against the plain
    version within rows 2 and 17's bounds (attention_stats); f32 against
    the same function on f64 operands within attn_any_f32_max_rel(d) and
    ATTN_ANY_F32_MEAN_REL of |o|, the TF32 result of the plain version
    refused (f32_rel_check), the plain f32 version's own error logged. With
    ``timed``: the kernel, the plain version and one SDPA call timed, and
    the bound."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.attention_bench import peaked_qkv
    from vr_video_generator_tpu_torch.kernels import launch_counts
    from vr_video_generator_tpu_torch.ops import attention as A
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    f32 = dtype == torch.float32
    qkv = peaked_qkv(gen, b, n, heads, dtype, head_dim=d)
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    scale = d ** -0.5
    if flash:
        q = qkv[:, :, 0]
        args, fn, plain, s = (q, k, v, scale), A.flash_attention, \
            A.flash_attention_plain, scale
    else:
        q = (qkv[:, :, 0].float() * scale).to(dtype)
        args, fn, plain, s = (q, k, v), A.attention, A.attention_plain, 1.0
    name = ("flash_attention_any" if flash else "attention_any") \
        + ("_f32" if f32 else "")
    label = f"{name} Dh={d} B={b} N={n} H={heads}"
    before = launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    after = launch_counts()
    require(after[name] == before.get(name, 0) + 1
            and all(after[c] == before.get(c, 0) for c in after if c != name),
            f"{label}: launches {before} -> {after}")
    if f32:
        want = attention_f64(q, k, v, s)
        err = (plain(*args).double() - want).abs()
        plain_err = dict(
            plain_max_rel_err=(err.max() / want.abs().max()).item(),
            plain_mean_rel_err=(err.mean() / want.abs().mean()).item())
        log(f"{label}: the plain f32 version's error {json.dumps(plain_err)}")
        with tf32(True):
            tfw = plain(*args)
        stats = f32_rel_check(label, got, want, tfw, attn_any_f32_max_rel(d),
                              ATTN_ANY_F32_MEAN_REL)
        stats.update(plain_err)
        del tfw, err
    else:
        want = plain(*args)
        stats = attention_stats(label, got, want)
    del want
    torch.cuda.synchronize()
    log(f"kernel {label}: {json.dumps(stats)}")
    if not timed:
        return stats
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = 4 * b * heads * n * n * d
    res = dict(**stats, ms=event_ms(lambda: fn(*args)),
               plain_ms=event_ms(lambda: plain(*args)),
               library_ms=event_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, scale=s)),
               **(bound_f32 if f32 else bound)(nbytes(q, k, v, got), flops))
    res["tflops"] = flops / res["ms"] * 1e-9
    res["bound_ms_f32_simt"] = flops / F32_SIMT_FLOP_PER_S * 1e3
    log(f"kernel {label} times: {json.dumps(res)}")
    return res


def check_qkv_width(gen, d: int, heads: int, dtype) -> tuple:
    """Rows 5 and 6 at width ``d``, ``heads`` heads (B = 8 at 1080p, 518):
    bf16 by the dense rows' bounds (gemm_check), f32 by f32_qkv_check and
    f32_proj_check; each timed beside its plain version and cuBLAS's
    product, with the bound. Returns (row 5's, row 6's) results."""
    import torch

    from vr_video_generator_tpu_torch.ops.qkv import (
        ln_qkv, ln_qkv_plain, proj_ls_residual, proj_ls_residual_plain)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    f32 = dtype == torch.float32
    dh, m = d // heads, B * N_TOK
    x = randn(gen, (B, N_TOK, d), dtype=dtype)
    qargs = (x, randn(gen, (d,), 0.1, 1.0), randn(gen, (d,), 0.1),
             randn(gen, (3 * d, d), d ** -0.5, dtype=dtype),
             randn(gen, (3 * d,), 0.5, dtype=dtype), heads, dh ** -0.5)
    got = ln_qkv(*qargs)
    torch.cuda.synchronize()
    require(tuple(got.shape) == (B, N_TOK, 3, heads, dh),
            f"ln_qkv D={d} H={heads}: shape {tuple(got.shape)}")
    suffix = "_f32" if f32 else ""
    label = f"ln_qkv{suffix} D={d} H={heads}"
    q_stats = (f32_qkv_check(label, qargs, got) if f32 else
               gemm_check(f"ln_qkv D={d} H={heads}", got,
                          ln_qkv_plain(*qargs), qargs))
    w, b = qargs[3], qargs[4]
    xf = x.reshape(m, d)
    q_res = dict(**q_stats, ms=event_ms(lambda: ln_qkv(*qargs)),
                 plain_ms=event_ms(lambda: ln_qkv_plain(*qargs)),
                 library_ms=None,
                 cublas_ms=event_ms(lambda: torch.addmm(b, xf, w.t())),
                 **(bound_f32 if f32 else bound)(
                     nbytes(*qargs[:5], got), 2 * m * d * 3 * d))
    log(f"kernel {label}: {json.dumps(q_res)}")
    o = randn(gen, (B, N_TOK, heads, dh), dtype=dtype)
    pargs = (o, randn(gen, (B, N_TOK, d), dtype=dtype),
             randn(gen, (d, d), d ** -0.5, dtype=dtype),
             randn(gen, (d,), 0.5, dtype=dtype),
             randn(gen, (d,), 0.1, 1.0, dtype=dtype))
    got = proj_ls_residual(*pargs)
    torch.cuda.synchronize()
    label = f"proj_ls_residual{suffix} D={d} H={heads}"
    p_stats = (f32_proj_check(label, pargs, got) if f32 else
               gemm_check(f"proj_ls_residual D={d} H={heads}", got,
                          proj_ls_residual_plain(*pargs), pargs))
    of, wp, bp = o.reshape(m, d), pargs[2], pargs[3]
    p_res = dict(**p_stats, ms=event_ms(lambda: proj_ls_residual(*pargs)),
                 plain_ms=event_ms(lambda: proj_ls_residual_plain(*pargs)),
                 library_ms=None,
                 cublas_ms=event_ms(lambda: torch.addmm(bp, of, wp.t())),
                 **(bound_f32 if f32 else bound)(nbytes(*pargs, got),
                                                 2 * m * d * d))
    log(f"kernel {label}: {json.dumps(p_res)}")
    return q_res, p_res


def attention_any_sass() -> dict:
    """Kernel 1's SASS in the built library (attention_bench.sass_counts):
    every bf16 kernel holds HGMMA, every f32 one HGMMA with TF32 operands
    (ATTN_ANY_SASS). Returns each kernel's counts."""
    from vr_video_generator_tpu_torch.attention_bench import sass_counts

    counts = sass_counts(tuple(ATTN_ANY_SASS))
    for kind, op in ATTN_ANY_SASS.items():
        found = {name: c for name, c in counts.items()
                 if kind + "I" in name}
        require(found and all(c[op] > 0 for c in found.values()),
                f"kernel 1's SASS: {kind} needs {op} in each instantiation, "
                f"found {json.dumps(found)}")
    log(f"kernel 1's SASS: {json.dumps(counts)}")
    return counts


def width_kernels(device) -> dict:
    """Phase 12 (a), (b): kernel 1 at head dims 16, 20, 32, 48, 128 and
    256, one-shot and flash, bf16 and f32, and its SASS
    (attention_any_sass); rows 5 and 6 at D = 512 (8 heads),
    640 (10) and 768 with 6 heads of 128, row 8 at D = 512 (hidden 2048),
    row 9 at D = 640 (hidden 2080, padded to 2112), row 10 at D = 1024
    (hidden 2736), bf16 and f32, at 1080p/518 rows (B = 8), against their
    plain versions with phase 3's and phase 8's bounds."""
    import torch

    from vr_video_generator_tpu_torch.ops import mlp

    out = dict(attention_any_sass=attention_any_sass())
    gen = torch.Generator(device=device).manual_seed(SEED + 120)
    for dtype in (torch.bfloat16, torch.float32):
        suffix = "_f32" if dtype == torch.float32 else ""
        for d, heads, b1, b2 in ATTN_ANY:
            for flash, b, n in ((False, b1, N_TOK), (True, b2, N_L728)):
                name = ("flash_attention_any" if flash
                        else "attention_any") + suffix
                out[f"{name} Dh={d}"] = check_attention_any(
                    gen, flash, d, heads, b, n, dtype, True)
                torch.cuda.empty_cache()
        for d, heads in ((512, 8), (640, 10), (768, 6)):
            q, p = check_qkv_width(gen, d, heads, dtype)
            tag = f" D={d}" if d != 768 else f" D={d} H={heads}"
            out[f"ln_qkv{suffix}{tag}"] = q
            out[f"proj_ls_residual{suffix}{tag}"] = p
            torch.cuda.empty_cache()
    m = B * N_TOK
    out["mlp_residual D=512"] = check_mlp_chain(
        8, "mlp_residual", mlp_args(gen, m, 512), True)
    out["mlp_residual_hblocked D=640 H=2080"] = check_mlp_chain(
        9, "mlp_residual_hblocked", mlp_args(gen, m, 640, hid=2080), True)
    hid = mlp.swiglu_hidden(1024)
    out[f"swiglu_residual D=1024 H={hid}"] = check_swiglu(gen, 1024, hid, m)
    out["mlp_residual_f32 D=512"] = f32_mlp_check(gen, 8, 512)
    out["mlp_residual_hblocked_f32 D=640 H=2080"] = f32_mlp_check(
        gen, 9, 640, hid=2080)
    out[f"swiglu_residual_f32 D=1024 H={hid}"] = f32_swiglu_check(
        gen, m, 1024, hid)
    torch.cuda.empty_cache()
    return out


def width_run(device, frames, row, f64_factor=None) -> dict:
    """One WIDTH_RUNS path: the custom configuration built with seeded
    random weights (models/factory), its pipeline's plan checks
    (resolve_block_fusion at each dtype, check_f32_plan), one batch through
    process_segment after a warm-up step with exactly its kernels a step
    (one_batch; at f32 none of the plain versions, and the weights split at
    the first step only), one step's time (event_ms), and its depth against
    the plain path (PlainKernels)
    on the same weights and frames: on average within DEPTH_REL of the
    range at bf16 (phase 4's bound), 1e-3 at f32 (phase 8 (c')'s); with
    ``f64_factor``, at f32 also against a plain f64 forward (f64_depth:
    at most that factor times the plain f32 path's error)."""
    import torch

    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.models.dinov2 import \
        resolve_block_fusion
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import (SbsPipeline,
                                                       check_f32_plan)
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    label, key, size, batch, dtype_name, step, splits = row
    t0 = time.perf_counter()
    mcfg = width_config(key)
    cfg = run_config(mcfg.encoder, "auto", "auto", batch=batch,
                     input_size=size, dtype=dtype_name)
    for dt in (torch.bfloat16, torch.float32):
        resolve_block_fusion("auto", mcfg.embed_dim, mcfg.num_heads, N_TOK,
                             "cuda", dt, mcfg.ffn_layer)
    check_f32_plan(with_model(dataclasses.replace(cfg,
                                                  compute_dtype="float32"),
                              mcfg), H, W)
    dtype = getattr(torch, dtype_name)
    sd = random_state_dict(mcfg, SEED)
    model = build_model(mcfg, sd, dtype, device, tail=cfg.tail)
    pipe = SbsPipeline(model, H, W, run_cfg=cfg)
    f32 = dtype == torch.float32
    reset_launch_counts()
    pipe.step(frames[:batch], pipe.initial_state())
    first = launch_counts().get("tf32x3_split", 0)
    require(first == splits, f"{label}: the first step split {first} "
            f"weights, expected {splits}")
    with NoPlainF32() if f32 else contextlib.nullcontext():
        stats = one_batch(label, pipe, frames, tuple(step))
    per_step = {k: v for k, v in stats["launches"].items() if v}
    require(per_step == step,
            f"{label}: one step launched {per_step}, expected {step}")
    state = pipe.initial_state()
    stats["step_ms"] = event_ms(lambda: pipe.step(frames[:batch], state))
    log(f"{label}: one step {stats['step_ms']:.3f} ms (event_ms, the "
        f"frames uploaded from the host)")
    x = pipe.frames_to_device(frames[:batch])
    d_kernel = pipe.depth_only(x)
    with PlainKernels():
        d_plain = pipe.depth_only(x)
    span = float(d_plain.max() - d_plain.min())
    mean = float((d_kernel - d_plain).abs().mean())
    limit = (1e-3 if f32 else DEPTH_REL) * span
    require(bool(torch.isfinite(d_kernel).all()) and span > 0
            and mean <= limit,
            f"{label}: depth off the plain path by {mean} on average (range "
            f"{span}, limit {limit})")
    stats.update(depth_vs_plain_mean=mean, depth_range=span,
                 depth_vs_plain_max=float((d_kernel - d_plain).abs().max()),
                 first_step_splits=first)
    del x, d_kernel, d_plain
    if f32 and f64_factor:
        stats["f64"] = f64_depth(label, pipe, sd, cfg, frames, f64_factor)
    stats["seconds_total"] = time.perf_counter() - t0
    log(f"{label}: depth against the plain path: mean {mean} "
        f"({mean / span:.3e} of the range {span}); "
        f"{stats['seconds_total']:.1f} s")
    del model, pipe, sd
    torch.cuda.empty_cache()
    return stats


def widths_path(device, rng) -> dict:
    """Phase 12: the encoder at every width the JAX package takes: (a) and
    (b) the kernels at the new head dims and widths (width_kernels), (c)
    the five custom configurations' paths (WIDTH_RUNS)."""
    t0 = time.perf_counter()
    out = dict(kernels=width_kernels(device))
    log(f"phase 12 (a, b) kernels: {time.perf_counter() - t0:.1f} s")
    frames = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    out["paths"] = {row[0]: width_run(device, frames, row)
                    for row in WIDTH_RUNS}
    log(f"phase 12 (c) paths: {time.perf_counter() - t0:.1f} s")
    return out


# Phase 13: the DPT tails at every width the JAX planners take. A custom
# head (ModelConfig.features) reaches rows 7, 11 + 12 and 15 at widths no
# encoder has; the chains run them zero-padded (ops/head_tail.chain_widths).
# refinenet1's grid and the net's size at 1080p for each --input_size.
TAIL_GRIDS = {518: ((H0, W0), OUT_HW), 252: EXT_WIDE[FEATURES_L],
              126: EXT_WIDE[FEATURES_G]}
# (a): (row, dtype, C, input size), each padded chain against its plain
# version stage by stage: the ext tail (row 7) at the widths the JAX
# planners send it at 518 and that only 252 and 126 reach, the big-C tail
# (rows 11 + 12) at f32's C <= 128 and the C = 512-896 of both dtypes, the
# single-kernel tail (row 15) on path1 at vits' grid.
TAIL_CASES = (
    tuple(("ext", "bfloat16", c, 518) for c in (16, 48, 96, 144))
    + (("ext", "bfloat16", 320, 252), ("ext", "bfloat16", 528, 126))
    + (("ext", "float32", 16, 518), ("ext", "float32", 48, 518),
       ("ext", "float32", 160, 252))
    + tuple(("big", "float32", c, 518) for c in (80, 96, 112))
    + (("big", "float32", 512, 126), ("big", "bfloat16", 512, 252),
       ("big", "bfloat16", 640, 252), ("big", "bfloat16", 896, 126))
    + tuple(("base", dt, c, 518) for dt in ("bfloat16", "float32")
            for c in (16, 96, 256)))
# (b): the slice's paths, vits at full depth and width with a custom head,
# 1080p, B = 8, `auto`, as WIDTH_RUNS' rows (the vits encoder's attention
# half fused, its MLP half not).
_VITS_STEP = {"layernorm": 16, "ln_qkv": 12, "attention": 12,
              "proj_ls_residual": 12, **_TAIL}
_VITS_F32_STEP = {f"{k}_f32" if k in _VITS_STEP and k not in _TAIL else k: v
                  for k, v in _VITS_STEP.items()}
TAIL_PATHS = {
    f"f{c}": dict(encoder="vits", embed_dim=384, depth=12, num_heads=6,
                  mlp_ratio=4.0, features=c, out_channels=(48, 96, 192, 384),
                  intermediate_layers=(2, 5, 8, 11))
    for c in (48, 96, 512)}
TAIL_RUNS = (
    ("f96-518", "f96", 518, B, "bfloat16",
     {**_VITS_STEP, "head_tail_ext": 1}, 0),
    ("f96-518 f32", "f96", 518, B, "float32",
     {**_VITS_F32_STEP, "head_tail_big_f32": 1}, 24 + 2),
    ("f48-518 f32", "f48", 518, B, "float32",
     {**_VITS_F32_STEP, "head_tail_ext_f32": 1}, 24 + 3),
    ("f512-252", "f512", 252, B, "bfloat16",
     {**_VITS_STEP, "head_tail_big_front": 1, "head_tail_big_back": 1}, 0),
)
# Each path's tail in the kernels line, at its width, with the path's
# launches: (counter, TAIL_CASES key, path).
TAIL_ENTRIES = (
    ("head_tail_ext", "head_tail_ext C=96", "f96-518"),
    ("head_tail_big_f32", "head_tail_big_f32 C=96", "f96-518 f32"),
    ("head_tail_ext_f32", "head_tail_ext_f32 C=48", "f48-518 f32"),
    ("head_tail_big_front", "head_tail_big_front C=512", "f512-252"),
    ("head_tail_big_back", "head_tail_big_back C=512", "f512-252"))
# The counter each (row, dtype) launches, the kernels line's names.
TAIL_COUNTERS = {("ext", "bfloat16"): ("head_tail_ext",),
                 ("ext", "float32"): ("head_tail_ext_f32",),
                 ("big", "bfloat16"): BIG_TAIL,
                 ("big", "float32"): ("head_tail_big_f32",),
                 ("base", "bfloat16"): ("head_tail",),
                 ("base", "float32"): ("head_tail_f32",)}


def cudnn_convs_ms(*convs) -> float:
    """The library time of a tail's kernel: cuDNN's channels-last 3x3
    convolutions ``convs`` ((input (B, H, W, C), weight, bias or None)
    each: conv1 on its input, conv2 on R) on the same operands, in their
    dtype. The port never calls them; no one PyTorch call computes a
    tail."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.stage_bench import event_ms

    cl = torch.channels_last
    ops = [(x.permute(0, 3, 1, 2).contiguous(memory_format=cl),
            k.contiguous(memory_format=cl), b) for x, k, b in convs]
    return event_ms(lambda: [F.conv2d(x, k, b, padding=1)
                             for x, k, b in ops])


def padded_share(row, dtype, c, size) -> dict:
    """The zero padding's share of a chain's work at a head of C features
    on TAIL_CASES' grid: of its convolutions' and row 7's mix's products,
    and of the elements of x as the chain reads it and of its
    intermediates (xoc, Z or U, c1 or mid, R), at the chain's widths
    (ops/head_tail.chain_widths) against the head's own C and C / 2 (a
    ragged conv1 tile's idle columns not counted)."""
    import torch

    from vr_video_generator_tpu_torch.ops import head_tail as ht

    cp, c2p = ht.chain_widths(c, getattr(torch, dtype))
    (h, w), (h1, w1) = ((2 * H0, 2 * W0), OUT_HW) if row == "base" \
        else TAIL_GRIDS[size]
    po = h1 * w1
    if row == "base":
        def prods(a, b):
            return h * w * 9 * a * b + po * 9 * b * 32

        def moved(a, b):
            return h * w * (a + b) + po * b
    else:
        mix, n0, n1 = row == "ext", h * w, 4 * h * w

        def prods(a, b):
            return mix * n0 * a * a + n1 * 9 * a * b + po * 9 * b * 32

        def moved(a, b):
            return n0 * a * (1 + mix) + n1 * (a + b) + po * b
    return dict(products=1 - prods(c, c // 2) / prods(cp, c2p),
                elements=1 - moved(c, c // 2) / moved(cp, c2p),
                widths=(cp, c2p))


def tail_width_case(gen, row, dtype, c, size) -> dict:
    """One TAIL_CASES row: the padded chain stage by stage against its
    plain version with phase 3's bf16 and phase 8's f32 bounds (the f32
    ones refusing the TF32 result), the whole tail against its plain
    version, timed beside the plain version and cuDNN's two convs, the
    bound counted on the head's own C. Returns {kernel: statistics}."""
    import torch

    from vr_video_generator_tpu_torch.ops import head_tail as ht

    (grid, out_hw) = TAIL_GRIDS[size]
    f32 = dtype == "float32"
    if row == "base":
        res = (f32_base_tail_check if f32 else check_base_tail)(gen, c)
        return {TAIL_COUNTERS[(row, dtype)][0]: res}
    if f32:
        check = f32_ext_tail_check if row == "ext" else f32_big_tail_check
        return {TAIL_COUNTERS[(row, dtype)][0]: check(gen, c, grid, out_hw)}
    if row == "ext":
        res = check_ext_tail(gen, c, grid, out_hw)
        xt = randn(gen, (B, c, *grid), dtype=torch.bfloat16).permute(
            0, 2, 3, 1)
        wts = tail_weights(gen, c)
        _, z, _, r, _ = ht.head_tail_ext_stages(xt, *wts, out_hw)
        res["library_ms"] = cudnn_convs_ms((z, wts[2], wts[3]),
                                           (r, wts[4], None))
        return {"head_tail_ext": res}
    res = check_big_tail(gen, c, grid, out_hw)
    xt = randn(gen, (B, c, *grid), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)
    u, _, r, _ = ht.head_tail_big_stages(xt, *wts, out_hw)
    k1f = ht.fold_conv1(wts[0], wts[2], torch.bfloat16)
    res["head_tail_big_front"]["library_ms"] = cudnn_convs_ms((u, k1f, None))
    res["head_tail_big_back"]["library_ms"] = cudnn_convs_ms(
        (r, wts[4], None))
    return res


def c16_chain_choice(gen) -> dict:
    """bf16 row 7 at C = 16 on vits' 1080p/518 grid (B = 8, x an NCHW
    activation seen as NHWC): the five-stage chain zero-padded to C = 64
    (the port's route) against csrc/head_tail.cu's wmma chain zero-padded
    to C = 32 (x copied to 32 channels first, the copy timed with it; its
    row fits one block's shared memory at W0 = 264), each against the plain
    version by the tail bounds, both timed by CUDA events."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.ops import head_tail as ht
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    c, out_hw = 16, OUT_HW
    xt = randn(gen, (B, c, H0, W0), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    wts = tail_weights(gen, c)
    k_oc, b_oc, k1, b1, k2, b2, k3, b3 = wts
    w32 = (ht.pad_to(k_oc, 32, 32), ht.pad_to(b_oc, 32), ht.pad_to(k1, 16, 32),
           ht.pad_to(b1, 16), ht.pad_to(k2, 32, 16), b2, k3, b3)
    require(ht.wmma_takes(32, W0), "the wmma chain takes W0 = 264")
    want = ht.head_tail_ext_plain(xt, *wts, out_hw)
    five = tail_stats("head_tail_ext C=16 five-stage (C = 64)",
                      ht.head_tail_ext(xt, *wts, out_hw), want)
    wmma = tail_stats("head_tail_ext C=16 wmma (C = 32)", ht.head_tail_ext(
        F.pad(xt, (0, 16)), *w32, out_hw), want)
    out = dict(five_stage=dict(**five, ms=event_ms(
        lambda: ht.head_tail_ext(xt, *wts, out_hw))),
        wmma=dict(**wmma, ms=event_ms(lambda: ht.head_tail_ext(
            F.pad(xt, (0, 16)), *w32, out_hw))),
        pad_copy_ms=event_ms(lambda: F.pad(xt, (0, 16))))
    log(f"bf16 row 7 at C = 16: the five-stage chain at C = 64 "
        f"{out['five_stage']['ms']} ms, the wmma chain at C = 32 "
        f"{out['wmma']['ms']} ms (its x copy {out['pad_copy_ms']} ms)")
    return out


def tail_entry_calls(device) -> dict:
    """Each TAIL_CASES width's wrapper called once as a user calls it, on
    fresh inputs, with the launch counts reset just before and read just
    after: exactly its kernels, once each. Returns {case key: counts}."""
    import torch

    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.ops import head_tail as ht

    gen = torch.Generator(device=device).manual_seed(SEED + 131)
    out = {}
    for row, dtype, c, size in TAIL_CASES:
        f32 = dtype == "float32"
        (h0, w0), out_hw = ((2 * H0, 2 * W0), OUT_HW) if row == "base" \
            else TAIL_GRIDS[size]
        x = randn(gen, (B, c, h0, w0),
                  dtype=None if f32 else torch.bfloat16).permute(0, 2, 3, 1)
        wts = (f32_tail_weights if f32 else tail_weights)(gen, c)
        fn = {"ext": ht.head_tail_ext, "big": ht.head_tail_big,
              "base": ht.head_tail}[row]
        args = wts[2:] if row == "base" else wts
        fn(x, *args, out_hw)  # weights laid out (split at f32) once
        torch.cuda.synchronize()
        reset_launch_counts()
        depth = fn(x, *args, out_hw)
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        need = {k: 1 for k in TAIL_COUNTERS[(row, dtype)]}
        require(got == need and bool(torch.isfinite(depth).all()),
                f"{row} {dtype} C={c}: launched {got}, expected {need}")
        out[(row, dtype, c)] = got
        del x, wts, depth
    torch.cuda.empty_cache()
    return out


def tails_path(device, rng) -> dict:
    """Phase 13: the DPT tails at every width the JAX planners take: (a) the
    padded chains against their plain versions (TAIL_CASES), bf16 row 7's
    C = 16 route timed both ways, each width's wrapper launching exactly
    its kernels; (b) the four paths (TAIL_RUNS) through models/factory and
    SbsPipeline, exactly their kernels a step, the depth against the plain
    path (f32: and against a plain f64 forward, F32_DEPTH_FACTOR)."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 130)
    kernels = {}
    for row, dtype, c, size in TAIL_CASES:
        t1 = time.perf_counter()
        share = padded_share(row, dtype, c, size)
        for name, res in tail_width_case(gen, row, dtype, c, size).items():
            kernels[f"{name} C={c}"] = dict(**res, padded_share=share)
            log(f"phase 13 (a) {name} {dtype} C={c} at {size}: ms "
                f"{res['ms']}, plain {res['plain_ms']}, library "
                f"{res['library_ms']}, bound {res['bound_ms']} "
                f"({res['bound_by']}); padded share {json.dumps(share)}")
        log(f"phase 13 (a) {row} {dtype} C={c} at {size}: "
            f"{time.perf_counter() - t1:.1f} s")
        torch.cuda.empty_cache()
    out = dict(kernels=kernels, c16=c16_chain_choice(gen),
               calls={f"{r} {d} C={c}": v for (r, d, c), v in
                      tail_entry_calls(device).items()})
    log(f"phase 13 (a) kernels: {time.perf_counter() - t0:.1f} s")
    frames = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    out["paths"] = {row[0]: width_run(device, frames, row,
                                      f64_factor=F32_DEPTH_FACTOR)
                    for row in TAIL_RUNS}
    log(f"phase 13 (b) paths: {time.perf_counter() - t0:.1f} s")
    return out


# Phase 14: the last widths. Row 16 at C the encoders' heads give it only
# off the CLI (16 and 96 zero-padded to rcu_width, vitl's 256 and vitg's 384
# unpadded) on refinenet1's 1080p/518 grid; kernel 1 above head dim 256
# (row 2 at N = 2443, B = 8; row 17 at N = 4785, B = 2, at the head dims
# the library flash kernel takes there), 2 heads; and the custom
# configurations hd384 and hd320 (WIDTH_PATHS, 4 blocks) through
# SbsPipeline, as WIDTH_RUNS' rows.
RCU_WIDTHS = (16, 96, 256, 384)
WIDE_ATTN = ((320, False), (384, False), (512, False), (384, True),
             (512, True))  # (head dim, row 17)
WIDE_HEADS = 2
WIDE_RUNS = (
    ("hd384-518", "hd384", 518, B, "bfloat16",
     {"layernorm": 4, "ln_qkv": 4, "attention_any": 4,
      "proj_ls_residual": 4, "mlp_residual": 4, "head_tail_ext": 1,
      **_TAIL}, 0),
    ("hd384-518 f32", "hd384", 518, B, "float32",
     {"layernorm_f32": 4, "ln_qkv_f32": 4, "attention_any_f32": 4,
      "proj_ls_residual_f32": 4, "mlp_residual_hblocked_f32": 4,
      "head_tail_big_f32": 1, **_TAIL}, 8 + 8 + 2),
    ("hd384-728", "hd384", 728, B_L728, "bfloat16",
     {"layernorm": 8, "flash_attention_any": 4, "mlp_residual": 4,
      "head_tail_big_front": 1, "head_tail_big_back": 1, **_TAIL}, 0),
    ("hd320-518", "hd320", 518, B, "bfloat16",
     {"layernorm": 4, "ln_qkv": 4, "attention_any": 4,
      "proj_ls_residual": 4, "mlp_residual": 4, "head_tail_ext": 1,
      **_TAIL}, 0),
)
# hd320 at 728: row 17 past 4096 tokens at a head dim the library flash
# kernel refuses; the step raises its NotImplementedError.
WIDE_REFUSED = ("hd320-728", "hd320", 728, B_L728, "bfloat16")
# Kernel 1's wide entries in the kernels line that a path carries: (counter,
# key, path); the others carry their wrapper call's one launch.
WIDE_ON_PATH = (("attention_any", "attention_any Dh=384", "hd384-518"),
                ("attention_any", "attention_any Dh=320", "hd320-518"),
                ("attention_any_f32", "attention_any_f32 Dh=384",
                 "hd384-518 f32"),
                ("flash_attention_any", "flash_attention_any Dh=384",
                 "hd384-728"))


def rcu_width_case(gen, dtype: str, c: int) -> dict:
    """Row 16 at C = c, bf16 by check_rcu_pair (each conv alone by the dense
    bounds, the chain against the f32 chain), f32 by f32_rcu_check (each
    conv and the chain against f64 operands, TF32 refused), each timed
    beside the plain chain and cuDNN's four convs, the bound counted on the
    real C; with the zero padding's share of the products and elements at
    Cp = rcu_width, and the time of the wrapper's two padding copies."""
    import torch
    import torch.nn.functional as F

    from vr_video_generator_tpu_torch.attic.refinenet_pre import rcu_width
    from vr_video_generator_tpu_torch.stage_bench import event_ms

    f32 = dtype == "float32"
    res = f32_rcu_check(gen, c) if f32 else check_rcu_pair(gen, c)
    cp = rcu_width(c, getattr(torch, dtype))
    x = randn(gen, (B, c, H0, W0), dtype=None if f32 else torch.bfloat16
              ).permute(0, 2, 3, 1)
    res.update(padded_width=cp, padded_share=dict(
        products=1 - (c / cp) ** 2, elements=1 - c / cp),
        pad_copies_ms=event_ms(lambda: (F.pad(x, (0, cp - c)),
                                        F.pad(x, (0, cp - c))))
        if cp != c else 0.0)
    return res


def rcu_entry_calls(device) -> dict:
    """refinenet_pre at each RCU_WIDTHS width and dtype called as a user
    calls it, on fresh inputs: the first call splits the f32 weights (4
    tf32x3_split) and launches its four convs; then, with the launch counts
    reset just before and read just after, exactly four launches of its
    dtype's counter and nothing else. Returns {"<dtype> C=<c>": counts}."""
    import torch

    from vr_video_generator_tpu_torch.attic.refinenet_pre import \
        refinenet_pre
    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)

    gen = torch.Generator(device=device).manual_seed(SEED + 141)
    out = {}
    for dtype in ("bfloat16", "float32"):
        f32 = dtype == "float32"
        name = "rcu_pair_f32" if f32 else "rcu_pair"
        for c in RCU_WIDTHS:
            rn0, path2, ws = (f32_rcu_inputs if f32 else rcu_inputs)(gen, c)
            reset_launch_counts()
            refinenet_pre(rn0, path2, *ws)
            torch.cuda.synchronize()
            first = {k: v for k, v in launch_counts().items() if v}
            need = {name: 4, **({"tf32x3_split": 4} if f32 else {})}
            require(first == need, f"{name} C={c}: the first call launched "
                    f"{first}, expected {need}")
            reset_launch_counts()
            got = refinenet_pre(rn0, path2, *ws)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            require(counts == {name: 4} and got.shape == rn0.shape
                    and bool(torch.isfinite(got).all()),
                    f"{name} C={c}: launched {counts}, expected {{{name!r}: "
                    f"4}}, shape {tuple(got.shape)}")
            out[f"{dtype} C={c}"] = counts
            del rn0, path2, ws, got
    torch.cuda.empty_cache()
    return out


def wide_attention(device) -> dict:
    """Kernel 1 above head dim 256 (WIDE_ATTN), bf16 and f32, each by
    check_attention_any (one launch of its counter; bf16 within rows 2 and
    17's bounds of the plain version, f32 within attn_any_f32_max_rel(d)
    and ATTN_ANY_F32_MEAN_REL of the f64 function, TF32 refused), timed beside the plain version and SDPA; and
    row 17 at head dim 320 past 4096 tokens refused with the library
    kernel's NotImplementedError before any launch."""
    import torch

    from vr_video_generator_tpu_torch.kernels import launch_counts
    from vr_video_generator_tpu_torch.ops import attention as A

    out = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 142)
    for dtype in (torch.bfloat16, torch.float32):
        suffix = "_f32" if dtype == torch.float32 else ""
        for d, flash in WIDE_ATTN:
            name = ("flash_attention_any" if flash else "attention_any") \
                + suffix
            b, n = (B_L728, N_L728) if flash else (B, N_TOK)
            out[f"{name} Dh={d}"] = check_attention_any(
                gen, flash, d, WIDE_HEADS, b, n, dtype, True)
            torch.cuda.empty_cache()
    q = randn(gen, (B_L728, N_L728, WIDE_HEADS, 320), dtype=torch.bfloat16)
    before = launch_counts()
    try:
        A.flash_attention(q, q, q, 320 ** -0.5)
    except NotImplementedError as e:
        refused = str(e)
    else:
        refused = None
    torch.cuda.synchronize()
    require(refused is not None and "multiple of 128" in refused
            and launch_counts() == before,
            f"row 17 at head dim 320 past 4096 tokens: {refused!r}, launch "
            f"counts {before} -> {launch_counts()}")
    out["flash_attention_any Dh=320 refused"] = refused
    return out


def refused_run(device, frames, row) -> dict:
    """WIDE_REFUSED: the configuration built as a user builds it, its step
    raising the library flash kernel's NotImplementedError (row 17 past
    4096 tokens at head dim 320) before any launch of row 17."""
    import torch

    from vr_video_generator_tpu_torch.kernels import (launch_counts,
                                                       reset_launch_counts)
    from vr_video_generator_tpu_torch.models.factory import (build_model,
                                                             random_state_dict)
    from vr_video_generator_tpu_torch.pipeline import SbsPipeline

    label, key, size, batch, dtype_name = row
    mcfg = width_config(key)
    cfg = run_config(mcfg.encoder, "auto", "auto", batch=batch,
                     input_size=size, dtype=dtype_name)
    model = build_model(mcfg, random_state_dict(mcfg, SEED),
                        getattr(torch, dtype_name), device, tail=cfg.tail)
    pipe = SbsPipeline(model, H, W, run_cfg=cfg)
    reset_launch_counts()
    try:
        pipe.step(frames[:batch], pipe.initial_state())
    except NotImplementedError as e:
        refused = str(e)
    else:
        refused = None
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    require(refused is not None and "multiple of 128" in refused
            and not counts.get("flash_attention_any"),
            f"{label}: the step gave {refused!r}, launches {counts}")
    log(f"{label}: the step raised {refused!r} after launches {counts}")
    del model, pipe
    torch.cuda.empty_cache()
    return dict(refused=refused, launches_before=counts)


def last_widths_path(device, rng) -> dict:
    """Phase 14: (a) row 16 at RCU_WIDTHS, bf16 and f32 (rcu_width_case),
    each width's wrapper launching exactly its kernels (rcu_entry_calls);
    (b) kernel 1 above head dim 256 (wide_attention); (c) the hd384 and
    hd320 paths (WIDE_RUNS, width_run: exactly their kernels a step, the
    depth against the plain path, at f32 against a plain f64 forward) and
    hd320 at 728 refused (refused_run)."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 140)
    kernels = {}
    for dtype in ("bfloat16", "float32"):
        name = "rcu_pair_f32" if dtype == "float32" else "rcu_pair"
        for c in RCU_WIDTHS:
            t1 = time.perf_counter()
            res = rcu_width_case(gen, dtype, c)
            kernels[f"{name} C={c}"] = res
            log(f"phase 14 (a) {name} C={c}: ms {res['ms']}, plain "
                f"{res['plain_ms']}, library {res['library_ms']}, bound "
                f"{res['bound_ms']} ({res['bound_by']}), padded to "
                f"{res['padded_width']} ({json.dumps(res['padded_share'])}, "
                f"copies {res['pad_copies_ms']} ms); "
                f"{time.perf_counter() - t1:.1f} s")
            torch.cuda.empty_cache()
    out = dict(calls=rcu_entry_calls(device))
    log(f"phase 14 (a) row 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kernels.update(wide_attention(device))
    out["kernels"] = kernels
    log(f"phase 14 (b) kernel 1 above 256: {time.perf_counter() - t0:.1f} s")
    frames = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    out["paths"] = {row[0]: width_run(device, frames, row,
                                      f64_factor=F32_DEPTH_FACTOR)
                    for row in WIDE_RUNS}
    out["refused"] = refused_run(device, frames, WIDE_REFUSED)
    log(f"phase 14 (c) paths: {time.perf_counter() - t0:.1f} s")
    return out


def setup(verbose_build: bool = False):
    """The card, the numeric settings of every reference, and the built
    kernels; returns (device, the nvidia-smi card line)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS may otherwise reduce bf16 products in reduced precision; the
    # plain versions accumulate in f32, as the kernels do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    device = torch.device("cuda", 0)

    from vr_video_generator_tpu_torch.kernels import build
    from vr_video_generator_tpu_torch.stage_bench import card_line

    card = card_line()
    log(card)  # nvidia-smi's own "name, power.limit" line
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    if verbose_build:
        build.build(verbose=True)
    build.library()
    log(f"build: nvcc {time.perf_counter() - t0:.2f} s")
    return device, card


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's -Xptxas -v report")
    opts = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, PKG)):
        print(f"chip_smoke: the package {PKG} is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    t0 = time.perf_counter()
    device, card = setup(opts.verbose_build)
    log(f"phases 1-2 (card, build): {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)

    t0 = time.perf_counter()
    results, widths = {}, {}
    kernel_parity(device, rng, results, widths)
    log(f"phase 3 (kernel parity): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, paths = main_path(device, rng)
    log(f"phase 4 (main paths): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["vits auto/auto step_many"] = step_many_path(device, rng)
    log(f"phase 5 (step_many, chunked segment, trace, bench): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["vits auto/auto depth_stride"] = stride_path(device, rng)
    log(f"phase 6 (depth stride, audit, adaptive loop, repair ranges, "
        f"bench): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase7 = sharded_path(device, rng)
    log(f"phase 7 (gelu tanh, sharded steps, --mesh 1x1, bench --sharded): "
        f"{time.perf_counter() - t0:.1f} s")
    paths["phase 7"] = phase7
    t0 = time.perf_counter()
    phase8 = f32_path(device, rng)
    log(f"phase 8 (f32 on the card: kernel parity, vits, vitb and vitg "
        f"auto, rows 15 and 16, vitl/vitg xla, the fused and the newly run "
        f"paths, cli, bench): "
        f"{time.perf_counter() - t0:.1f} s")
    paths["phase 8"] = phase8
    t0 = time.perf_counter()
    paths["phase 9"] = tooling_path(device, rng)
    log(f"phase 9 (tooling: scan warp, device soak, parity report): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase10 = model_axis_path(device)
    paths["phase 10"] = phase10
    log(f"phase 10 (the model axis: rows 2 and 17 at a rank's heads, "
        f"vitl-728, vitl-518 xla, vitg-518, f32 vitl-518, vits-518 xla and "
        f"auto, vitb-518 xla model groups, cli --mesh 1x2 and 1x4): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["phase 11"] = front_ends_path()
    log(f"phase 11 (the front ends: the real-weights runbook at f32 and "
        f"bf16, the form's Run, Verify and Repair): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase12 = widths_path(device, rng)
    paths["phase 12"] = phase12
    log(f"phase 12 (the encoder at every width: kernel 1 at head dims 16-256, "
        f"rows 5, 6, 8, 9, 10 at new widths, the five custom "
        f"configurations): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase13 = tails_path(device, rng)
    paths["phase 13"] = phase13
    log(f"phase 13 (the DPT tails at every width: rows 7, 11 + 12 and 15 "
        f"zero-padded, bf16 and f32, and four custom-head paths): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase14 = last_widths_path(device, rng)
    paths["phase 14"] = phase14
    log(f"phase 14 (the last widths: row 16 at C = 16-384, kernel 1 above "
        f"head dim 256, the hd384 and hd320 paths): "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"slice: {json.dumps(dict(paths=paths, widths=widths, card=card))}")

    # Rows 1, 2, 5-9, 11 and 12 appear more than once: at the first path's
    # shapes with its launches, and at the widths of a later path with that
    # path's launches (rows 5, 6 and 8 at vitb-518's D = 768, rows 5 and 6
    # at vitl-518's D = 1024, row 1 at vitl-728's and vitg-518's rows, row 2 at
    # vitg-518's 24 heads, row 9 at vitl-728's rows, rows 11 and 12 at
    # vitl-728's grid and vitg-518's C = 384, row 7 at vitb-518's C = 128,
    # vitl-252's C = 256 and vitg-126's C = 384).
    entries = [(name, results[name], counts[name]) for name in KERNELS]
    b518 = paths["vitb-518 auto/auto"]["launches"]
    l518 = paths["vitl-518 fused/fused"]["launches"]
    l728 = paths["vitl-728 auto/auto"]["launches"]
    g518 = paths["vitg-518 auto/auto"]["launches"]
    entries += [("ln_qkv", widths[f"ln_qkv D={DIM_B}"], b518["ln_qkv"]),
                ("proj_ls_residual", widths[f"proj_ls_residual D={DIM_B}"],
                 b518["proj_ls_residual"]),
                ("mlp_residual", widths[f"mlp_residual D={DIM_B}"],
                 b518["mlp_residual"]),
                ("head_tail_ext", widths[f"head_tail_ext C={FEATURES_B}"],
                 b518["head_tail_ext"]),
                ("ln_qkv", widths[f"ln_qkv D={DIM_L}"], l518["ln_qkv"]),
                ("proj_ls_residual", widths[f"proj_ls_residual D={DIM_L}"],
                 l518["proj_ls_residual"]),
                ("layernorm", widths["layernorm D=1024"], l728["layernorm"]),
                ("layernorm", widths["layernorm D=1536"], g518["layernorm"]),
                ("attention", widths[f"attention H={HEADS_G}"],
                 g518["attention"]),
                ("mlp_residual_hblocked",
                 widths[f"mlp_residual_hblocked M={B * N_L728}"],
                 l728["mlp_residual_hblocked"])]
    entries += [(name, widths[f"{name} 728"], l728[name]) for name in BIG_TAIL]
    entries += [(name, widths[f"{name} C={FEATURES_G}"], g518[name])
                for name in BIG_TAIL]
    entries += [("head_tail_ext", widths[f"head_tail_ext C={c}"],
                 paths[label]["launches"]["head_tail_ext"])
                for c, label in ((FEATURES_L, "vitl-252 auto/auto"),
                                 (FEATURES_G, "vitg-126 auto/auto"))]
    # The tanh variants of rows 8 and 9 at the widths of the paths that
    # launch them (phase 7): vitb-518's D = 768 and vitl-518's D = 1024.
    tanh = phase7["tanh_kernels"]
    entries += [(name, tanh[f"{name} D={d}"],
                 phase7["tanh_paths"][label]["launches"][name])
                for name, d, label in (
                    ("mlp_residual_tanh", DIM_B,
                     "vitb-518 auto/auto gelu tanh"),
                    ("mlp_residual_hblocked_tanh", DIM_L,
                     "vitl-518 auto/auto gelu tanh"))]
    # The f32 kernels (phase 8) with the launches of the f32 path that runs
    # them: vits auto's, vitl-728 xla's (row 1 at D = 1024, row 17) and
    # vitg-518 xla's (row 1 at D = 1536).
    f32k, v32 = phase8["kernels"], phase8["vits_auto"]["launches"]
    l728 = phase8["xla"]["vitl-728 xla/xla f32"]["launches"]
    g518 = phase8["xla"]["vitg-518 xla/xla f32"]["launches"]
    entries += [("layernorm_f32", f32k[f"layernorm_f32 D={DIM}"],
                 v32["layernorm_f32"]),
                ("layernorm_f32", f32k[f"layernorm_f32 D={DIM_L}"],
                 l728["layernorm_f32"]),
                ("layernorm_f32", f32k[f"layernorm_f32 D={DIM_G}"],
                 g518["layernorm_f32"])]
    entries += [(name, f32k[name], v32[name]) for name in (
        "ln_qkv_f32", "proj_ls_residual_f32", "attention_f32",
        "head_tail_ext_f32")]
    entries.append(("flash_attention_f32", f32k["flash_attention_f32"],
                    l728["flash_attention_f32"]))
    # The f32 kernels of this slice with the launches of the f32 paths that
    # run them: vitb-518 auto (rows 5 and 6 at D = 768, row 9 at D = 768,
    # rows 11 and 12 at C = 128), vits fused (row 8 at D = 384), vitl-518
    # auto (row 9 at D = 1024) and vitb-252 auto (row 7 at C = 128).
    b32 = phase8["vitb_auto"]["launches"]
    fused32 = phase8["fused"]
    entries += [("ln_qkv_f32", f32k[f"ln_qkv_f32 D={DIM_B}"],
                 b32["ln_qkv_f32"]),
                ("proj_ls_residual_f32",
                 f32k[f"proj_ls_residual_f32 D={DIM_B}"],
                 b32["proj_ls_residual_f32"]),
                ("mlp_residual_f32", f32k[f"mlp_residual_f32 D={DIM}"],
                 fused32["vits-518 fused/fused f32"]["launches"][
                     "mlp_residual_f32"]),
                ("mlp_residual_hblocked_f32",
                 f32k[f"mlp_residual_hblocked_f32 D={DIM_B}"],
                 b32["mlp_residual_hblocked_f32"]),
                ("mlp_residual_hblocked_f32",
                 f32k[f"mlp_residual_hblocked_f32 D={DIM_L}"],
                 fused32["vitl-518 auto/auto f32"]["launches"][
                     "mlp_residual_hblocked_f32"]),
                ("head_tail_big_f32", f32k[f"head_tail_big_f32 C={FEATURES_B}"],
                 b32["head_tail_big_f32"]),
                ("head_tail_ext_f32", f32k[f"head_tail_ext_f32 C={FEATURES_B}"],
                 fused32["vitb-252 auto/auto f32"]["launches"][
                     "head_tail_ext_f32"])]
    # The f32 kernels of vitg's f32 path with its launches: vitg-518 auto
    # (row 1 at its rows, row 2 at 24 heads, row 10) and vitg-126 fused
    # (rows 11 + 12 at C = 384); rows 15 and 16 at f32 with the launches of
    # their off-CLI calls at C = 64 and 128.
    g32 = phase8["vitg_auto"]["launches"]
    g126 = phase8["vitg_auto"]["vitg-126"]["launches"]
    off32 = phase8["off_cli"]
    entries += [("layernorm_f32",
                 f32k[f"layernorm_f32 D={DIM_G} M={B * N_TOK}"],
                 g32["layernorm_f32"]),
                ("attention_f32", f32k[f"attention_f32 H={HEADS_G}"],
                 g32["attention_f32"]),
                ("swiglu_residual_f32", f32k[f"swiglu_residual_f32 D={DIM_G}"],
                 g32["swiglu_residual_f32"]),
                ("tf32x3_split", f32k["tf32x3_split"],
                 phase8["vitg_auto"]["first_step_splits"]),
                ("head_tail_big_f32", f32k[f"head_tail_big_f32 C={FEATURES_G}"],
                 g126["head_tail_big_f32"])]
    entries += [(name, f32k[f"{name} C={c}"],
                 off32[f"C={c}"]["launches"][name])
                for c in (FEATURES, FEATURES_B)
                for name in ("head_tail_f32", "rcu_pair_f32")]
    # The f32 paths first run in phase 8 (c4), each with its kernels at
    # its shapes: row 7 at a 32-feature head's C = 32 (vits-518), at C =
    # 256 (vitl-126) and 384 (vitg-56's grid), rows 11 + 12 at C = 64
    # (vits-728) and 256 (vitl-252), row 17 at 24 heads (vitg-728); row 15
    # at C = 32 off the CLI.
    new32 = {label: res["launches"] for label, res in phase8["new"].items()}
    entries += [(name, f32k[key], new32[label][name])
                for name, key, label in (
                    ("head_tail_ext_f32", "head_tail_ext_f32 C=32",
                     "vits-518 auto/auto f32 C=32"),
                    ("head_tail_ext_f32", f"head_tail_ext_f32 C={FEATURES_L}",
                     "vitl-126 auto/auto f32"),
                    ("head_tail_ext_f32",
                     f"head_tail_ext_f32 C={FEATURES_G} 56",
                     "vitg-56 auto/auto f32"),
                    ("head_tail_big_f32", f"head_tail_big_f32 C={FEATURES}",
                     "vits-728 auto/auto f32"),
                    ("head_tail_big_f32", f"head_tail_big_f32 C={FEATURES_L}",
                     "vitl-252 auto/auto f32"),
                    ("flash_attention_f32",
                     f"flash_attention_f32 H={HEADS_G}",
                     "vitg-728 auto/auto f32"))]
    entries.append(("head_tail_f32", f32k["head_tail_f32 C=32"],
                    off32["C=32"]["launches"]["head_tail_f32"]))
    # Rows 2 and 17 at the heads a model-group rank runs (phase 10), with
    # the launches of the 1 x M path that runs them.
    entries += [(name, phase10["kernels"][f"{name} H={heads}"],
                 phase10["paths"][label]["launches"][name])
                for name, _, _, heads, label in GROUP_ATTENTION]
    # Phase 12: kernel 1 at head dims 32 and 128, and rows 5, 6, 8, 9 and 10
    # at the new widths, each with the launches of the custom configuration
    # that runs it.
    k12, p12 = phase12["kernels"], phase12["paths"]
    entries += [(name, k12[f"{name} Dh={d}"], p12[label]["launches"][name])
                for name, d, label in ATTN_ANY_ENTRIES]
    entries += [(name, k12[key], p12[label]["launches"][name])
                for name, key, label in WIDTH_ENTRIES]
    # Phase 13: rows 7, 11 + 12 and 15 at the widths a custom head gives
    # them: the four paths' tails with the paths' launches, every other
    # width with the launches of its wrapper's call as a user calls it.
    k13, p13 = phase13["kernels"], phase13["paths"]
    on_path = [(name, key) for name, key, _ in TAIL_ENTRIES]
    entries += [(name, k13[key], p13[label]["launches"][name])
                for name, key, label in TAIL_ENTRIES]
    entries += [(name, k13[f"{name} C={c}"],
                 phase13["calls"][f"{row} {dtype} C={c}"][name])
                for row, dtype, c, _ in TAIL_CASES
                for name in TAIL_COUNTERS[(row, dtype)]
                if (name, f"{name} C={c}") not in on_path]
    # Phase 14: row 16 at each width with its wrapper call's launches;
    # kernel 1 above head dim 256 with the launches of the path that runs
    # it (WIDE_ON_PATH), the other head dims with their one counted call.
    k14, p14 = phase14["kernels"], phase14["paths"]
    entries += [(name, k14[f"{name} C={c}"],
                 phase14["calls"][f"{dtype} C={c}"][name])
                for dtype, name in (("bfloat16", "rcu_pair"),
                                    ("float32", "rcu_pair_f32"))
                for c in RCU_WIDTHS]
    wide_on_path = {key for _, key, _ in WIDE_ON_PATH}
    entries += [(name, k14[key], p14[label]["launches"][name])
                for name, key, label in WIDE_ON_PATH]
    entries += [(name, k14[f"{name} Dh={d}"], 1)
                for suffix in ("", "_f32") for d, flash in WIDE_ATTN
                for name in [("flash_attention_any" if flash
                              else "attention_any") + suffix]
                if f"{name} Dh={d}" not in wide_on_path]
    kernels = []
    for name, r, launches in entries:
        route, source, replaces = {**KERNELS, **TANH_KERNELS,
                                   **KERNELS_F32, **KERNELS_ANY}[name]
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=launches,
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
