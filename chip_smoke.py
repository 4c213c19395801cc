#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: build, check and time.

Run from the root of a checkout, on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. env: card, torch/CUDA versions, TF32 flags (asserted off).
2. build: the hand-written kernels of pytorch_wavelets_tpu_torch/csrc/,
   from the checkout's sources (one nvcc per source, in parallel).
3. main path: DTCWTForward(J=2, near_sym_a, qshift_a) then DTCWTInverse
   on a 10x10x128x128 fp32 batch (torch.Generator seed 0), with every
   kernel's launch count set to 0 just before and read just after;
   checked against the port's own CPU plain run of the same input and
   for perfect reconstruction; timed (CUDA events) in ms and Mpix/s, as
   the caller waits and as device time alone (their ratio is the device
   busy share).
4. banded path: the same at 8x3x512x512, J=3, whose operators have
   short bands, so K1 skips most of their tiles.
5. train_main: the main path with x.requires_grad_() and fixed random
   cotangents on the reconstruction, yl and every yh; x.grad checked
   against the CPU plain run, the adjoint identity <A x, g> = <x, A^T g>
   checked on the card for both pyramids; forward + backward timed; the
   launches counted per step and per pyramid role.
6. scat_j2: ScatLayerj2() on 128x3x256x256 fp32 (the reference's
   published ScatterNet workload): the forward alone, then forward +
   backward (the gradient of sum(Z * G) for a fixed random G); output and
   x.grad checked finite, shaped, and against the CPU plain run on the
   first 8 images; forward / backward ms, Mpix/s and peak memory, beside
   the reference's GTX1080 figures.  Then scat_j2_colour: the same for
   combine_colour=True at 16x3x256x256, checked on its first 4 images;
   and mag_edge_cases: K4, K5 and K18 at edge views (offsets of 4, 8 and
   16 bytes, odd and unit widths, two chunks a plane, strided, transposed
   and re/im-last slices, combine over 3 and 5 channels, the cotangent as
   torch.cat's backward hands it, K18's cotangent contiguous, off its
   line or strided, b = 0), each instantiation against its plain
   version; quad_edge_cases: K2 at edge views (odd k, bands off
   their 16-byte lines, per-level rows off theirs, every o_dim / ri_dim
   layout, fp32 and bf16), both instantiations bit for bit;
   c2q_edge_cases: K3 likewise (odd w, w = 1, bands 4, 8 and 12 bytes
   off a line, both output layouts, every layout), into NaN-filled
   outputs.
7. dwt_main: DWTForward(J=3, db4, symmetric) then DWTInverse on
   32x10x512x512 fp32 (benchmarks/run.py:8's --dwt workload, the
   reference's DWT graph setting), checked on its first 4 images against
   the CPU plain run and for perfect reconstruction; Mpix/s as the caller
   waits, device time, busy share, launches per role (K6 analysis, K7
   synthesis), peak memory.  dwt_train: the same modules with the
   gradient of sum(rec * G0) + sum(yl * G1) + sum(yh_j * G2+j) w.r.t. x
   (the reference-semantics backwards: K7, then K6), x.grad checked on the
   first 4 images, and the adjoint identity of both Functions in 'zero'
   mode on the card (the only mode where the reference's backward is the
   true adjoint).  dwt1d: DWT1DForward(J=5, db4, symmetric) + inverse +
   gradient on 16x8x65536, checked the same way.  Then K6/K7 at edge
   cases (odd sizes, db38 at periodization's single-fold sizes, strided,
   aligned and transposed views as inputs: each instantiation) against
   their plain versions.
8. the per-level DTCWT path (K8-K11, K2/K3 per level): scat_bp,
   ScatLayerj2(biort="near_sym_b_bp", qshift="qshift_b_bp") on
   128x3x256x256 fp32 (the reference's ScatterNet workload with its
   bandpass-diagonal filters, which only the per-level path runs), forward
   and backward, checked and timed as scat_j2; scat_bp_small, the bp
   ScatLayer and the bp combine_colour ScatLayerj2 on 16x3x256x256;
   dtcwt_large, DTCWTForward(J=3) -> DTCWTInverse on 1x3x9216x9216 (an
   axis above MAX_MATMUL_N), perfect reconstruction, one forward and one
   inverse against the plain versions run on the card, the adjoint
   identity of the four level Functions, the round trip and a gradient
   step timed; per_level_main, the main path under
   set_operator_matmul(False), against the composed path on the card,
   both timed.  Every K8-K11 and per-level K2/K3 call of these phases is
   replayed against its plain version right after its phase, and K8-K11
   run at edge cases (even taps, N = 4/8/12, both parities of the q-shift
   phase table, zero mode, strided inputs, accumulation into a slice).
9. the SWT (K12, K13, K1): swt_main, SWTForward(J=3, db4,
   periodization) then SWTInverse on 32x3x256x256 fp32 (the JAX package's
   published SWT configuration, docs/performance.md:28), counted, the
   host operators built anew for its first call, checked on its first 4
   images against the CPU plain run and for perfect reconstruction
   (2e-4), timed; swt_train, the gradient w.r.t. x of sum(rec * G0) +
   sum_j sum(y_j * G1+j), x.grad checked, the adjoint identity of the
   level Function in every mode and of the least-squares merge in each
   of its three branches; swt_long, axes of 4096 ('periodization' on
   1x3x4096^2: the FFT merge, cuFFT + K13; 'symmetric' on 1x1x4096^2:
   banded least squares, K1), every stage checked against the CPU plain
   version on a crop, the round trip and a gradient step timed; then K12
   and K13 at edge cases (every mode, pads longer than the axis, odd
   sizes, odd L d, strided, aligned and transposed inputs: every K12
   instantiation; odd and even spectra, offset, stored along either axis,
   and mixed: every K13 walk).  The profiles sum
   PyTorch's layout copies and cuFFT apart (device_us_per_iter_by_kind;
   swt_long's round trip's in round_trip_copies_and_cufft_us).
10. per kernel: every kernel call of one run of each path, recorded and
   replayed on the same tensors against its plain PyTorch version (with
   the tolerance stated), timed (device time) beside the plain version
   and one PyTorch library call where one computes the same function,
   with the least time the card could take for the call (bound: bytes
   over HBM rate or FLOPs over the fp32 rate, whichever is larger),
   summed per kernel and per role (forward pyramid, its adjoint B4, the
   inverse's adjoint, the magnitudes; the DWT's analysis, synthesis and
   their backwards).
11. the Selesnick DTCWT, the non-separable filterbanks and the à trous
   merge (K6/K7, K14, K15, K16): alt_main, DTCWTForward2(farras,
   qshift_a, J=3, symmetric) then DTCWTInverse2 on 128x3x256x256 fp32
   (the reference's published image batch), counted (K6 forward, K7
   inverse), checked on its first 4 images against the CPU plain run and
   for perfect reconstruction, timed; alt_train, the gradient w.r.t. x
   of sum(rec * G0) + sum(lows * G1) + sum_j sum(yh_j * G2+j), x.grad
   checked, timed; cplxdual_mag, cplxdual2d(J=3, periodization,
   mag=True) on the same batch, checked and timed; quad_nonsep,
   quad_afb2d_nonsep (K14, 16 PSFs of 10x10) against the separable
   quad_afb2d (K6) in 'zero' mode, both timed; nonsep_rt, afb2d_nonsep
   -> sfb2d_nonsep (K14 -> K15, db4) on 32x10x512x512 in 'periodization'
   and 'symmetric', perfect reconstruction, the adjoint identity of both
   Functions, a gradient step timed; swt_sfb, afb2d_atrous ->
   sfb2d_atrous (K12 -> K16, db4) on 32x3x256x256 at dilations 1, 2, 4,
   reconstruction in 'periodization', the other modes replayed against
   the plain version, the adjoint identity of K16's Function in every
   mode; then K14-K16 at edge cases (every mode, odd sizes, Ly != Lx,
   db38, K = 16, pads longer than the axis, K14's and K15's adjoints on
   the separable plans, strided and transposed inputs).  Every K14-K16
   call of these phases, and the alt path's K6/K7 calls, are replayed
   as in 10, each kernel line with the launches its phase read from the
   counters, reset just before each counted run.
12. the matmul precision levels and bf16 (K17, csrc/banded_apply_tc.cu:
   K1's product on the tensor cores; the levels set through the port's
   API only, the TF32 flags of phase 1 stay off): prec_main, the main
   path's round trip and train_main's step under 'high' (3xTF32),
   'default' (TF32) and in bf16; prec_banded, the banded path's forward
   (8x3x512x512, J=3: short-banded operators, most tiles skipped) under
   'default' and in bf16; prec_scat, ScatLayerj2 on 128x3x256x256
   forward + backward under 'default' and in bf16; prec_swt, swt_main's
   round trip under 'high'; prec_dwt_bf16, dwt_main's round trip in bf16
   (K6/K7 through their wrappers' casts).  Each counted (K17's mode
   launched, K1 not), checked against the fp32 CPU run ('high' 2e-5,
   'default' 1e-2 of max(1, max |CPU|); bf16 reconstructions 2e-2 of
   max |x|, other outputs 1e-1 of max(1, max |CPU|)), timed; every K17 call
   replayed against its mode's plain version and timed beside
   torch.matmul (TF32 allowed for the TF32 mode, bf16 for bf16; none for
   3xTF32); on bf16 every K2/K3 call replayed bit for bit against its
   plain version computed in fp32 and rounded once to bf16, and the
   wrappers' casts replayed and timed as a share of the path's device
   time.
13. second-order gradients and the batch_chunk dial: six phases, each the
   reverse-over-reverse Hessian-vector product of one path (the gradient
   of <d loss / dx, v>, the first gradient taken with create_graph=True),
   checked against the port's CPU plain run on the first 4 images within
   2e-5 * max(1, max |CPU|), counted (each kernel of the path must
   launch), timed with utils/profiling.py's time_op (v -> H v chained: ms
   as the caller waits) and as device time: hvp_scat_j2, sum(Z^2) of
   ScatLayerj2() on 128x3x256x256 (K1-K5 and K18, the magnitude's second
   derivative, every K18 call on its vector walk); hvp_scat_bp, the same
   with the bandpass-diagonal filters (K8-K11, K2-K5, K18); hvp_main,
   sum(c^3) over DTCWTForward(J=2)'s coefficients on 10x10x128x128;
   hvp_dwt, DWTForward(J=3, db4, symmetric) -> DWTInverse on
   32x10x512x512, sum(c^3) over the coefficients and the reconstruction
   (K6, K7, and K14's and K15's adjoints as the transposes of the
   reference's backwards); hvp_swt, SWTForward(J=3, db4, periodization)
   -> SWTInverse on 32x3x256x256 likewise (K12, K1); hvp_alt,
   DTCWTForward2(J=3) on 16x3x256x256.  K18's kernel lines come from the
   two scattering phases' calls, replayed against scat_mag_bwd2_plain
   within 1e-6 + 1e-6 of its terms' magnitudes.  chunk_scat:
   ScatLayerj2(batch_chunk=8) and (batch_chunk=32) on 128x3x256x256,
   output and x.grad within 1e-6 of the unchunked layer's, forward and
   step timed beside it.  third_order_scat: the gradient of
   <grad <grad sum(Z^3), v>, w> through ScatLayerj2 on 2x3x32x32 (K18's
   call a Function differentiated once more: K5 and K18 again), against
   the CPU plain run within 2e-5 * max(1, max |CPU|).
14. the sharded DTCWT (parallel/, K19 csrc/halo.cu): sharded_main spawns
   a world of 2 and one of 4 processes on gloo, every rank on this card
   (the halos through pinned host memory): meshes (2, 1) and (1, 2) at
   the main path's full width, (2, 2) and (1, 2 spatial_h, 2) on it,
   (1, 4) on the banded path (halo 26).  Each rank's forward, inverse
   and x.grad (fixed random cotangents on the reconstruction, yl and
   every yh) against the card's run without a mesh (1e-5 / 2e-5 / 2e-5;
   x.grad 0 outside the rank's chunk), the composed route taken, K1
   launched on every rank and K19 on every rank of a mesh with a sharded
   spatial axis (on the main meshes every K19 launch on its vector walk;
   each exchange one pack and one assemble or fold launch), the bytes
   staged, the round trip and the step timed on the host clock,
   labelled "gloo, one card, host-staged halos" (not a multi-GPU
   figure); each world joined with a deadline.  halo_edge_cases: K19's
   three entries against their plain versions bit for bit (widths 0,
   equal to the tile and between, both axes, every source on each side,
   the views of _k19_views at row pitches off and on 16-byte lines,
   windows on the lines and one sample off them, fp32 and bf16, calls of
   3 and 10 parts), each call on the walk ops/halo.py:halo_walk names,
   both walks taken by every entry; K19's kernel lines at the main
   path's stage-1 tile on (1, 2) and at the stage-1 tile of
   128x3x256x256 on (1, 2) along W and H (fp32) and W (bf16), torch.cat
   of the same buffer as the library call;
   sharded_nccl: a world of one on NCCL, mesh (1, 1), bit for bit the
   path without a mesh (the main path's DTCWT and ScatLayerj2 on
   128x3x256x256).  The same worlds run sharded_dwt (the DWT, 1-D DWT and
   SWT) and sharded_scat: ScatLayerj2 on 128x3x256x256 on (1, 2) and
   (1, 2 spatial_h, 2), ScatLayer on 128x3x255x255 (padded even) on
   (1, 2), ScatLayerj2(combine_colour=True) on 15x3x256x256 on (2, 2)
   (an odd batch over 'data'), all on the composed fronts, and on
   1x3x9216x9216 (past MAX_MATMUL_N) DTCWTForward(J=3) -> DTCWTInverse
   and ScatLayer on the per-level route, both on (1, 2): each rank's
   forward (inverse) and x.grad against the card's run without a mesh
   within 2e-5, the route LAST_PATH names, K1, K2 / K4 in the forward and
   K3 / K5 in the backward (K11 both ways on the per-level front, none on
   the composed ones), K19 as in sharded_main, the first call's seconds
   (host plans) and the forward (round trip) and step on the host clock;
   K1's kernel lines on rank 0's stage-1 blocks of both ScatLayerj2
   fronts and of the per-level DTCWT's level 1 on (1, 2).
15. profile: device time by kernel of the main path, of one ScatLayerj2
   training step, of one DWT training step, of one bandpass-diagonal
   ScatLayerj2 training step, of one SWT training step, of one
   DTCWTForward2 training step, and of hvp_scat_j2's and hvp_dwt's
   Hessian-vector products (torch.profiler).

Each path's peak_mem_bytes (torch.cuda.max_memory_allocated over its
timed calls) includes mem_held_before_bytes: what was allocated when its
peak was reset (its inputs, and the calls recorded by earlier paths).
The operator-product paths' lines (main, banded, scat_j2, swt_main and
the precision phases) carry ``copies``: K1's and K17's launches of the
counted run by instantiation, the copy width their staging took (16- or
4-byte cp.async, plain 2-byte loads; csrc/banded_pipe.cuh) and K1's
64-column tile (async16_narrow); K1's and K17's
kernel lines carry ``instantiations``, the same count for the recorded
calls they replay.  K6's to K10's, K12's and K14's to K16's do too (K6's
to K10's, K12's and K16's axis and vector width, K6's and K7's
long_fold, K14's PSF count and tile, the adjoints' band gathers), and so
do the DWT, Selesnick, scat_bp, dtcwt_large, per_level_main, SWT,
quad_nonsep, nonsep_rt and swt_sfb lines for their counted runs; a main
path fails if a K6 or K7 call took long_fold or a K6, K9 or K12 call ran
off the tiles (tiles_only), and the edge-case phases check every
instantiation of K6, K7, K9 and K12.  K4's and K5's kernel lines and the
scattering paths' lines carry theirs (vector or strided); a scattering
path (scat_j2, scat_j2_colour, scat_bp, scat_bp_small) fails if a K4 or
K5 call took the strided one (vector_mags); main, banded, train_main,
the scattering paths, dtcwt_large, per_level_main and the precision
phases fail if a K2 or K3 call took its strided instantiation
(vector_quads, vector_c2qs), the scattering paths if a K11 call did
(vector_pools), swt_long if a K13 call did not stream (stream_specs).  K16's
lines give torch.matmul on the probed operator (its transpose for the
adjoint) as the library yardstick, with K1 on the same operator
(k1_on_operator_ms) and the adjoint's partial transposed convolution
(partial_conv_transpose_ms) timed beside it; K9's and K10's the plain
version's one cuDNN convolution of the phase streams (partial work:
without the pad, the streams and the interleave).

Then a {"kernels": [...]} line, the card's name and power limit as
nvidia-smi prints them, and last {"ok": true, "device": {...}}.
Imports torch, numpy and the port only.
"""
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12      # fp32 on the CUDA cores
PEAK_HBM_BYTES = 3.35e12     # HBM3
K1_TOL = dict(rtol=1e-5, atol=1e-5)   # fp32 sums in another order
FWD_ATOL, INV_ATOL = 1e-5, 2e-5       # the JAX suite's DTCWT tolerances
PR_TOL = 1e-5                         # perfect reconstruction
SPIN_CYCLES = 100_000_000   # ~50 ms at ~2 GHz: covers enqueuing a batch

MAG_TOL = dict(rtol=3e-7, atol=1e-7)  # K4/K5: IEEE ops, the same order
GRAD_ATOL = 2e-5                      # the JAX suite's ScatterNet/DTCWT
ADJOINT_TOL = 1e-6                    # fp32 dot-product test, relative
# the reference's published ScatterNet fwd / bwd on (128, 3, 256, 256),
# GTX1080 (BASELINE.md:18, from its docs/scatternet.rst:31-41)
GTX1080_SCAT_S = {"forward": 0.10, "backward": 0.16}
# the paths' inputs (N, C, H, W), and how many images of each ScatLayerj2
# batch the CPU plain run checks
MAIN_SHAPE = (10, 10, 128, 128)        # the reference's DTCWT workload
BANDED_SHAPE = (8, 3, 512, 512)
SCAT_SHAPE = (128, 3, 256, 256)        # the reference's ScatterNet one
COLOUR_SHAPE = (16, 3, 256, 256)
SCAT_CHECK_N, COLOUR_CHECK_N = 8, 4
# (reps, batches) of the ScatLayerj2 timings: the colour step is an
# eighth of the work, so more of both to steady its host-clock times
SCAT_TIMING, COLOUR_TIMING = (3, 5), (10, 15)
PYRAMID_KERNELS = ("apply_row", "apply_col", "q2c_pack", "c2q_unpack")
# the DWT paths: benchmarks/run.py:8 (--dwt --wave db4 -j 3 --size 512
# --batch 32, its defaults --ch 10 and --mode symmetric), and a 1-D run
DWT_SHAPE, DWT_J = (32, 10, 512, 512), 3
DWT1D_SHAPE, DWT1D_J = (16, 8, 65536), 5
DWT_WAVE, DWT_MODE = "db4", "symmetric"
DWT_CHECK_N = 4                       # images checked against the CPU run
DWT_KERNELS = ("afb1d_corr", "sfb1d_conv")
DWT_TOL = K1_TOL                      # K6/K7: fp32 sums in another order
# the role of a K6/K7 call: (kernel, inside the backward) -> role
DWT_ROLES = {("afb1d_corr", False): "analysis",
             ("sfb1d_conv", False): "synthesis",
             ("sfb1d_conv", True): "analysis's backward",
             ("afb1d_corr", True): "synthesis's backward"}

# the per-level DTCWT paths: the bandpass-diagonal ScatLayerj2 (full
# width and depth), the small bp layers, a DTCWT past MAX_MATMUL_N, and
# the main path forced onto the per-level stencils
BP = dict(biort="near_sym_b_bp", qshift="qshift_b_bp")
BP_SHAPE, BP_SMALL_SHAPE = (128, 3, 256, 256), (16, 3, 256, 256)
LARGE_SHAPE, LARGE_J = (1, 3, 9216, 9216), 3
STENCIL_TOL = K1_TOL                  # K8-K10: fp32 sums in another order
# The level Functions' adjoint identity at LARGE_SHAPE (relative to the
# Cauchy-Schwarz scale; near_sym_a / qshift_a, 'symmetric'): on the H100
# fp32 rounding reads at most 9.2e-12 there, and a level-1 backward with
# the wrong boundary mode 2.5e-7 to 3.9e-7 (tools/level_adjoint_fault.py,
# four seeds).  Both fall with the size, so the limit is set between them
# for this shape alone.
LEVEL_ADJOINT_TOL = 1e-9
STENCILS = ("dtcwt_filt", "dtcwt_dfilt", "dtcwt_ifilt")
POOLS = ("avg_pool2_fwd", "avg_pool2_bwd")
PER_LEVEL = STENCILS + POOLS + ("q2c_pack", "c2q_unpack")
# (reps, batches) of a replay's timings: the default, and for the calls of
# the 1x3x9216^2 path (each moves gigabytes).  Each batch spins the card
# for SPIN_CYCLES first, so the batches set most of a replay's time: 3,
# not more, keeps the whole script near 750 s
REPLAY_TIMING, LARGE_REPLAY_TIMING = (20, 3), (3, 3)
# the JAX function each per-level K2/K3 call replaces
PER_LEVEL_REPLACES = {
    "q2c_pack": "pytorch_wavelets_tpu/ops/dtcwt_fb.py:294",
    "c2q_unpack": "pytorch_wavelets_tpu/ops/dtcwt_fb.py:304",
}

SOURCES = {
    "apply_row": ("banded_apply_row", "banded_apply.cu",
                  "pytorch_wavelets_tpu/ops/banded.py:332"),
    "apply_col": ("banded_apply_col", "banded_apply.cu",
                  "pytorch_wavelets_tpu/ops/banded.py:321"),
    "q2c_pack": ("q2c_pack", "q2c_pack.cu",
                 "pytorch_wavelets_tpu/ops/fused_dtcwt.py:126"),
    "c2q_unpack": ("c2q_unpack", "c2q_unpack.cu",
                   "pytorch_wavelets_tpu/ops/fused_dtcwt.py:290"),
    "scat_mag_fwd": ("scat_mag_fwd", "scat_mag.cu",
                     "pytorch_wavelets_tpu/transforms/scatternet.py:25"),
    "scat_mag_bwd": ("scat_mag_bwd", "scat_mag.cu",
                     "pytorch_wavelets_tpu/transforms/scatternet.py:25"),
    "scat_mag_bwd2": ("scat_mag_bwd2", "scat_mag.cu",
                      "pytorch_wavelets_tpu/transforms/scatternet.py:25"),
    "afb1d_corr": ("dwt_afb", "dwt_afb.cu",
                   "pytorch_wavelets_tpu/ops/afb_sfb.py:125"),
    "sfb1d_conv": ("dwt_sfb", "dwt_sfb.cu",
                   "pytorch_wavelets_tpu/ops/afb_sfb.py:262"),
    "dtcwt_filt": ("dtcwt_filt", "dtcwt_filt.cu",
                   "pytorch_wavelets_tpu/ops/dtcwt_fb.py:66"),
    "dtcwt_dfilt": ("dtcwt_dfilt", "dtcwt_dfilt.cu",
                    "pytorch_wavelets_tpu/ops/dtcwt_fb.py:126"),
    "dtcwt_ifilt": ("dtcwt_ifilt", "dtcwt_ifilt.cu",
                    "pytorch_wavelets_tpu/ops/dtcwt_fb.py:220"),
    "avg_pool2_fwd": ("avg_pool2_fwd", "avg_pool2.cu",
                      "pytorch_wavelets_tpu/transforms/scatternet.py:46"),
    "avg_pool2_bwd": ("avg_pool2_bwd", "avg_pool2.cu",
                      "pytorch_wavelets_tpu/transforms/scatternet.py:46"),
    "afb1d_atrous_corr": ("swt_afb", "swt_atrous.cu",
                          "pytorch_wavelets_tpu/ops/afb_sfb.py:207"),
    "afb1d_atrous_adjoint": ("swt_afb_adjoint", "swt_atrous.cu",
                             "pytorch_wavelets_tpu/ops/afb_sfb.py:207"),
    "spec_merge": ("spec_merge", "iswt_spec.cu",
                   "pytorch_wavelets_tpu/transforms/dwt.py:394"),
    "spec_split": ("spec_split", "iswt_spec.cu",
                   "pytorch_wavelets_tpu/transforms/dwt.py:394"),
    "nonsep_afb": ("nonsep_afb", "nonsep_afb.cu",
                   "pytorch_wavelets_tpu/ops/afb_sfb.py:482"),
    "nonsep_afb_adjoint": ("nonsep_afb_adjoint", "nonsep_afb.cu",
                           "pytorch_wavelets_tpu/ops/afb_sfb.py:482"),
    "nonsep_sfb": ("nonsep_sfb", "nonsep_sfb.cu",
                   "pytorch_wavelets_tpu/ops/afb_sfb.py:527"),
    "nonsep_sfb_adjoint": ("nonsep_sfb_adjoint", "nonsep_sfb.cu",
                           "pytorch_wavelets_tpu/ops/afb_sfb.py:527"),
    "sfb1d_atrous_conv": ("swt_sfb", "swt_atrous.cu",
                          "pytorch_wavelets_tpu/ops/afb_sfb.py:337"),
    "sfb1d_atrous_adjoint": ("swt_sfb_adjoint", "swt_atrous.cu",
                             "pytorch_wavelets_tpu/ops/afb_sfb.py:337"),
}
BANDED_REPLACES = "pytorch_wavelets_tpu/ops/banded.py:410"

# the SWT paths: the JAX package's published SWT configuration
# (docs/performance.md:28, benchmarks/run.py:139-148's --swt workload),
# forward, inverse and the training step; then axes past the dense pinv's
# 2048 samples, where the inverse's other two branches run
SWT_SHAPE, SWT_J = (32, 3, 256, 256), 3
SWT_WAVE, SWT_MODE = "db4", "periodization"
SWT_CHECK_N = 4                       # images checked against the CPU run
SWT_PR_TOL = 2e-4                     # tests/test_swt.py:53
SWT_LONG = (("periodization", (1, 3, 4096, 4096)),   # FFT merge: K13
            ("symmetric", (1, 1, 4096, 4096)))       # banded LS: K1
SWT_LONG_J = 2
SWT_LONG_PR_TOL = 5e-4                # tests/test_swt.py:117
SWT_CROP = 32       # lines of each long-path stage checked on the CPU
SWT_MODES = ("zero", "symmetric", "reflect", "periodic", "periodization",
             "replicate")
# K13: a few fp32 products a value, against the sum of the magnitudes of
# its terms (|g0 A| + |g1 B|, or |g Z|), not of the result: the spectra's
# terms grow with the square root of the length, and cancel
SPEC_TOL = dict(rtol=1e-6, atol=1e-6)
SWT_KERNELS = ("afb1d_atrous_corr", "afb1d_atrous_adjoint", "spec_merge",
               "spec_split")
# the position of the axis among each kernel's recorded arguments
SWT_AXIS_ARG = {"afb1d_atrous_corr": 4, "afb1d_atrous_adjoint": 4,
                "spec_merge": 4, "spec_split": 3}
# the JAX function each role's kernels replace ('merge': _ls_merge's
# operator products, dense pinv l.366-368 or banded l.358-363)
_SPLIT, _MERGE = ("pytorch_wavelets_tpu/ops/afb_sfb.py:207",
                  "pytorch_wavelets_tpu/transforms/dwt.py:345")
SWT_REPLACES = {"split": _SPLIT, "split's adjoint": _SPLIT,
                "merge": _MERGE, "merge's adjoint": _MERGE}
# the Selesnick DTCWT (K6/K7 pyramids), the non-separable filterbanks (K14,
# K15) and the à trous merge (K16): DTCWTForward2's defaults on the
# reference's published image batch (BASELINE.md, the ScatterNet
# workload); the quad analysis on it; the non-separable round trip on
# dwt_main's shape and the à trous one on swt_main's
ALT_SHAPE = (128, 3, 256, 256)
ALT_KW = dict(biort="farras", qshift="qshift_a", mode="symmetric")
ALT_J = 3
ALT_CHECK_N = 4                       # images checked against the CPU run
ALT_TOL = 2e-5                        # the JAX suite's DTCWT tolerance
QUAD_MODE = "zero"
NONSEP_WAVE = "db4"
NONSEP_MODES = ("periodization", "symmetric")
SFB_DILATIONS = (1, 2, 4)
NONSEP_TOL = dict(rtol=1e-5, atol=1e-5)   # K14-K16: fp32 sums, other order
NONSEP_KERNELS = ("nonsep_afb", "nonsep_afb_adjoint", "nonsep_sfb",
                  "nonsep_sfb_adjoint", "sfb1d_atrous_conv",
                  "sfb1d_atrous_adjoint")
# (reps, batches) of the replays of the alt path's K6/K7 calls (120) and
# of sfb2d_atrous' K16 calls (57): one batch each, as every device-time
# batch first spins the card for ~50 ms; and of the non-separable round
# trip's, whose plain K15 and adjoints take 0.1 s a call at 32x10x512^2
ALT_REPLAY_TIMING = (5, 1)
NONSEP_REPLAY_TIMING = (3, 3)

# the pyramid functions whose kernel calls make up each role, and the JAX
# function each backward role replaces
ROLES = {"_analysis": "forward pyramid", "_synthesis": "inverse pyramid",
         "_analysis_adjoint": "forward pyramid's adjoint (B4)",
         "_synthesis_adjoint": "inverse pyramid's adjoint"}
MAG_ROLE = "magnitudes"
ROLE_REPLACES = {
    "forward pyramid's adjoint (B4)":
        "pytorch_wavelets_tpu/ops/fused_dtcwt.py:224",
    "inverse pyramid's adjoint":
        "pytorch_wavelets_tpu/ops/fused_dtcwt.py:273",
}


_T0 = time.perf_counter()


def emit(phase, **fields):
    """One JSON line; ``elapsed_s`` is the seconds since the script
    started (the run must end within its time limit)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _T0}), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def timed_ms(fn, reps=20, batches=5, device_only=True):
    """Median over batches of the mean CUDA-event time of ``reps``
    back-to-back calls (after a warm-up).  With ``device_only`` the card
    first spins (``torch.cuda._sleep``) while the host enqueues the whole
    batch, so the events time the device work alone, not the host's
    launch rate; without it they time what a caller waits for."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / reps)
    return statistics.median(out)


def shape_str(shape):
    return "x".join(map(str, shape))


def copy_counts(ops):
    """K1's and K17's launches of the run just counted, by instantiation:
    the copy width their staging took (csrc/banded_pipe.cuh: 16- or
    4-byte cp.async, plain 2-byte loads) and K1's narrow column tile
    (``async16_narrow``), for the wrappers that launched."""
    return {k: {w: n for w, n in v.items() if n}
            for k, v in ops.copy_counts().items() if any(v.values())}


def inst_counts(ops):
    """K8's and K14's launches of the run just counted, by instantiation
    (``ops.instantiation_counts``: K8's axis and vector width, K14's PSF
    count and tile, its adjoint's band), for the wrappers that
    launched."""
    return {k: {w: n for w, n in v.items() if n}
            for k, v in ops.instantiation_counts().items() if any(v.values())}


def copies_of(wrapper, run):
    """``run()``'s result and the copy widths ``wrapper`` counted for it."""
    before = dict(wrapper.copies)
    out = run()
    return out, {w: n - before[w] for w, n in wrapper.copies.items()
                 if n != before[w]}


@contextlib.contextmanager
def one_cpu_thread():
    """Run the body's CPU plain references at one thread, as the port's
    CPU tests do: PyTorch's CPU ``sqrt`` can differ in one worker thread on
    its first call in a multi-threaded process (ROADMAP.md, section C)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def max_err(a, b):
    if not a.numel():
        return 0.0
    if a.is_complex():
        return float((a.detach() - b.detach()).abs().max())
    return float((a.detach().float() - b.detach().float()).abs().max())


def within(got, want, tol, scale=None):
    """``got`` agrees with ``want``: bit for bit (``tol`` "exact"), or
    |got - want| <= atol + rtol * |want|, or, with ``scale``,
    <= atol + rtol * scale (the magnitude of the terms summed)."""
    if tol == "exact":
        return torch.equal(got, want)
    if scale is None:
        return torch.allclose(got, want, equal_nan=True, **tol)
    return bool(((got - want).abs() <= tol["atol"] + tol["rtol"] * scale)
                .all())


def scat_mag_bwd2_scale(h, g, u, bias, combine):
    """The magnitudes of the terms of K18's outputs, flattened as a
    replay flattens (dg, dh'): with s = sqrt(sum h^2 + bias^2) and
    T = sum |u * h| (over (re, im), and C with ``combine``), T / s for dg
    and |g| / s (|u| + |h| T / s^2) for dh'."""
    sq = h[..., 0] * h[..., 0] + h[..., 1] * h[..., 1]
    t = (u[..., 0] * h[..., 0]).abs() + (u[..., 1] * h[..., 1]).abs()
    if combine:
        sq, t = sq.sum(2, keepdim=True), t.sum(2, keepdim=True)
    s = torch.sqrt(sq + bias * bias)
    ratio = (t / s / s)[..., None]
    dh = (g.abs() / s)[..., None] * (u.abs() + h.abs() * ratio)
    return torch.cat([(t / s).flatten(), dh.flatten()])


def adjoint_error(outs, gs, ins, grads):
    """|<A x, g> - <x, A^T g>| over max(|A x| |g|, |x| |A^T g|), every
    sum in float64: the dot-product test relative to the Cauchy-Schwarz
    scale of its sides, so that products that cancel do not inflate it."""
    def dot(a, b):
        return sum(float((u.detach().double() * v.detach().double()).sum())
                   for u, v in zip(a, b))

    def norm(a):
        return dot(a, a) ** 0.5
    scale = max(norm(outs) * norm(gs), norm(ins) * norm(grads))
    return abs(dot(outs, gs) - dot(ins, grads)) / scale


# ---------------------------------------------------------------------------
# recording the kernel calls of one run
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def swapped(swaps):
    """Set ``module.name = fn`` for each (module, name, fn) of ``swaps``
    for the body, and restore the attributes after it."""
    saved = [(module, name, getattr(module, name))
             for module, name, _ in swaps]
    try:
        for module, name, fn in swaps:
            setattr(module, name, fn)
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


class Swapping:
    """A run's context manager: the attributes that ``swaps()`` gives are
    set on entry and restored on exit."""

    def __enter__(self):
        self._ctx = swapped(self.swaps())
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


class Tracer(Swapping):
    """For one run: wraps the pyramid functions of ROLES and the
    magnitude kernels' wrappers so that each kernel call is tagged with
    the role it serves, and each wrapper's own launch counter is read at
    the role's start and end (launches per role).  With ``record`` it
    also swaps the kernel wrappers that the pyramids and the magnitudes
    call for recording ones, which keep each call's inputs for replay."""

    def __init__(self, ops, fused, scat, record=False):
        self.ops, self.fused, self.scat, self.record = (ops, fused, scat,
                                                        record)
        self.role = None
        self.calls = []
        self.by_role = {}

    def _tag(self, role, fn):
        def wrapped(*args, **kwargs):
            prev, self.role = self.role, role
            before = self.ops.launch_counts()
            try:
                return fn(*args, **kwargs)
            finally:
                after = self.ops.launch_counts()
                c = self.by_role.setdefault(role, {})
                for k, v in after.items():
                    c[k] = c.get(k, 0) + v - before[k]
                self.role = prev
        return wrapped

    def swaps(self):
        calls, f, m = self.calls, self.fused, self.scat
        out = [(f, name, self._tag(role, getattr(f, name)))
               for name, role in ROLES.items()]
        # the magnitudes' wrappers, tagged (and recorded over the tags)
        orig = {n: self._tag(MAG_ROLE, getattr(m, n))
                for n in ("scat_mag_fwd", "scat_mag_bwd", "scat_mag_bwd2")}
        if not self.record:
            return out + [(m, n, fn) for n, fn in orig.items()]
        orig.update({n: getattr(f, n) for n in ("apply_row", "apply_col",
                                                "q2c_pack", "c2q_unpack")})

        def apply_row(x, T):
            calls.append(("apply_row", self.role, (x, T)))
            return orig["apply_row"](x, T)

        def apply_col(x, T, out=None, accumulate=True):
            calls.append(("apply_col", self.role,
                          (x, T, _out_mode(out, accumulate))))
            return orig["apply_col"](x, T, out, accumulate)

        def q2c_pack(y, out, orients):
            calls.append(("q2c_pack", self.role,
                          (y, out.size(), out.stride(), orients)))
            return orig["q2c_pack"](y, out, orients)

        def c2q_unpack(h, orients):
            calls.append(("c2q_unpack", self.role, (h, orients)))
            return orig["c2q_unpack"](h, orients)

        def scat_mag_fwd(h, bias, combine=False):
            calls.append(("scat_mag_fwd", MAG_ROLE, (h, bias, combine)))
            return orig["scat_mag_fwd"](h, bias, combine)

        def scat_mag_bwd(h, g, bias, combine=False):
            calls.append(("scat_mag_bwd", MAG_ROLE, (h, g, bias, combine)))
            return orig["scat_mag_bwd"](h, g, bias, combine)

        def scat_mag_bwd2(h, g, u, bias, combine=False):
            calls.append(("scat_mag_bwd2", MAG_ROLE,
                          (h, g, u, bias, combine)))
            return orig["scat_mag_bwd2"](h, g, u, bias, combine)

        return out + [
            (f, "apply_row", apply_row), (f, "apply_col", apply_col),
            (f, "q2c_pack", q2c_pack), (f, "c2q_unpack", c2q_unpack),
            (m, "scat_mag_fwd", scat_mag_fwd),
            (m, "scat_mag_bwd", scat_mag_bwd),
            (m, "scat_mag_bwd2", scat_mag_bwd2)]


def _out_mode(out, accumulate):
    """How a K1 call wrote its result, in the form replay() reads: None
    (a new tensor), ('acc', what ``out`` held) or ('write', size,
    strides)."""
    if out is None:
        return None
    return (("acc", out.clone()) if accumulate
            else ("write", out.size(), out.stride()))


class DwtRecorder(Swapping):
    """For one run: swaps the K6/K7 wrappers (``afb1d_corr``,
    ``sfb1d_conv``) where the DWT Functions and the 2-D compositions call
    them for recording ones, which keep each call's inputs for replay and
    tag it with its role; the caller sets ``backward`` around the
    gradient."""

    def __init__(self, afb, dwt):
        self.modules = (afb, dwt)
        self.calls = []
        self.backward = False

    def swaps(self):
        afb = self.modules[0]
        orig_a, orig_s = afb.afb1d_corr, afb.sfb1d_conv

        def afb1d_corr(x, h0, h1, mode, axis, out_len=None):
            self.calls.append(("afb1d_corr",
                               DWT_ROLES[("afb1d_corr", self.backward)],
                               (x, h0, h1, mode, axis % 4, out_len)))
            return orig_a(x, h0, h1, mode, axis, out_len)

        def sfb1d_conv(lo, hi, g0, g1, mode, axis, out_len=None):
            self.calls.append(("sfb1d_conv",
                               DWT_ROLES[("sfb1d_conv", self.backward)],
                               (lo, hi, g0, g1, mode, axis % 4, out_len)))
            return orig_s(lo, hi, g0, g1, mode, axis, out_len)

        return [(module, name, fn) for module in self.modules
                for name, fn in (("afb1d_corr", afb1d_corr),
                                 ("sfb1d_conv", sfb1d_conv))]


def _out_spec(out, accumulate):
    """How a recorded call wrote its result: None (a new tensor), or
    (kind, what ``out`` held, its size, its strides) for an accumulation
    onto ``out`` ('acc') or a write through it ('write')."""
    if out is None:
        return None
    return ("acc" if accumulate else "write", out.clone() if accumulate
            else None, out.size(), out.stride())


class PerLevelRecorder(Swapping):
    """For one run of the per-level path: swaps the wrappers of K8-K11,
    of K2/K3 where the level functions call them and of K4/K5 for
    recording ones, which keep each call's inputs for replay and tag it
    'forward' or 'backward' (the caller sets ``backward`` around the
    gradient)."""

    def __init__(self, fb, lev, scat):
        self.fb, self.lev, self.scat = fb, lev, scat
        self.calls = []
        self.backward = False

    def _role(self):
        return "backward" if self.backward else "forward"

    def swaps(self):
        fb, lev, scat, calls = self.fb, self.lev, self.scat, self.calls
        orig = {n: getattr(fb, n) for n in STENCILS}
        orig.update({n: getattr(lev, n) for n in ("q2c_pack", "c2q_unpack")})
        orig.update({n: getattr(scat, n) for n in POOLS + (
            "scat_mag_fwd", "scat_mag_bwd", "scat_mag_bwd2")})

        def dtcwt_filt(x, taps, axis, mode, out=None, accumulate=False):
            calls.append(("dtcwt_filt", self._role(),
                          (x, taps, axis % 4, mode,
                           _out_spec(out, accumulate))))
            return orig["dtcwt_filt"](x, taps, axis, mode, out, accumulate)

        def dtcwt_dfilt(x, ha, hb, highpass, axis, out=None):
            calls.append(("dtcwt_dfilt", self._role(),
                          (x, ha, hb, highpass, axis % 4,
                           _out_spec(out, False))))
            return orig["dtcwt_dfilt"](x, ha, hb, highpass, axis, out)

        def dtcwt_ifilt(x, ha, hb, highpass, axis, out=None,
                        accumulate=False):
            calls.append(("dtcwt_ifilt", self._role(),
                          (x, ha, hb, highpass, axis % 4,
                           _out_spec(out, accumulate))))
            return orig["dtcwt_ifilt"](x, ha, hb, highpass, axis, out,
                                       accumulate)

        def q2c_pack(y, out, orients, interleaved=False):
            calls.append(("q2c_pack", self._role(),
                          (y, out.size(), out.stride(), orients,
                           interleaved)))
            return orig["q2c_pack"](y, out, orients, interleaved)

        def c2q_unpack(h, orients, interleaved=False):
            calls.append(("c2q_unpack", self._role(),
                          (h, orients, interleaved)))
            return orig["c2q_unpack"](h, orients, interleaved)

        def one_arg(name):
            def fn(t):
                calls.append((name, self._role(), (t,)))
                return orig[name](t)
            return fn

        def scat_mag_fwd(h, bias, combine=False):
            calls.append(("scat_mag_fwd", self._role(), (h, bias, combine)))
            return orig["scat_mag_fwd"](h, bias, combine)

        def scat_mag_bwd(h, g, bias, combine=False):
            calls.append(("scat_mag_bwd", self._role(),
                          (h, g, bias, combine)))
            return orig["scat_mag_bwd"](h, g, bias, combine)

        def scat_mag_bwd2(h, g, u, bias, combine=False):
            calls.append(("scat_mag_bwd2", self._role(),
                          (h, g, u, bias, combine)))
            return orig["scat_mag_bwd2"](h, g, u, bias, combine)

        return [(fb, "dtcwt_filt", dtcwt_filt),
                (fb, "dtcwt_dfilt", dtcwt_dfilt),
                (fb, "dtcwt_ifilt", dtcwt_ifilt),
                (lev, "q2c_pack", q2c_pack), (lev, "c2q_unpack", c2q_unpack),
                *[(scat, name, one_arg(name)) for name in POOLS],
                (scat, "scat_mag_fwd", scat_mag_fwd),
                (scat, "scat_mag_bwd", scat_mag_bwd),
                (scat, "scat_mag_bwd2", scat_mag_bwd2)]


def plain_on_card(fb, lev, scat, quad, pool):
    """Swaps the per-level path's kernel wrappers for their plain
    versions, so that one run computes the same function with PyTorch's
    own operations on the card (the reference the kernels are held to
    where the CPU is too slow)."""
    return swapped([
        (fb, "dtcwt_filt", fb.dtcwt_filt_plain),
        (fb, "dtcwt_dfilt", fb.dtcwt_dfilt_plain),
        (fb, "dtcwt_ifilt", fb.dtcwt_ifilt_plain),
        (lev, "q2c_pack", quad.q2c_pack_plain),
        (lev, "c2q_unpack", quad.c2q_unpack_plain),
        (scat, "avg_pool2_fwd", pool.avg_pool2_fwd_plain),
        (scat, "avg_pool2_bwd", pool.avg_pool2_bwd_plain)])


def _fresh_out(x, spec):
    """A fresh tensor of a recorded ``out``'s size and strides, holding
    what it held for an accumulation (None for a new output)."""
    if spec is None:
        return None
    buf = torch.empty_strided(spec[2], spec[3], device=x.device)
    return buf.copy_(spec[1]) if spec[0] == "acc" else buf


def _write_spec(x, spec, fn):
    """Run ``fn(out, accumulate)`` as the recorded call ran."""
    return fn(_fresh_out(x, spec), spec is not None and spec[0] == "acc")


def stencil_call_parts(call, fb, pool):
    """One recorded K8-K11 call: (got, want, run, plain, lib, ops, bytes,
    tol).  ``lib`` is cuDNN's ``F.conv2d`` of the input padded here (not
    timed) for K8, plus ``add_`` where K8 accumulates; ``F.avg_pool2d``
    for K11's forward and ``F.conv_transpose2d`` of the cotangent (reshaped
    here, not timed) by a 2x2 kernel of 1/4 at stride 2 for its adjoint
    (checked exact against the plain version).  K9 and K10's function no
    single PyTorch call computes: theirs is partial work, the plain
    version's own cuDNN call (``F.conv2d`` of the two or four phase
    streams by the block-diagonal kernels, ``dfilt_operands`` /
    ``ifilt_operands``, prepared here and not timed), checked against
    the plain version after the interleave (and the accumulation) done
    here, timed without them."""
    import torch.nn.functional as F
    name, _, args = call
    lib = None
    if name in POOLS:
        x, = args
        kern = getattr(pool, name)
        plainf = getattr(pool, name + "_plain")
        got, want = kern(x), plainf(x)
        run = lambda: kern(x)                                 # noqa: E731
        plain = lambda: plainf(x)                             # noqa: E731
        if name == "avg_pool2_fwd":
            lib = lambda: F.avg_pool2d(x, 2)                  # noqa: E731
            ops = 4.0 * got.numel()
        else:
            N, C, h, w = x.shape
            quarter = torch.full((1, 1, 2, 2), 0.25, device=x.device)
            g = x.reshape(N * C, 1, h, w)      # a copy if strided: not timed
            lib = lambda: F.conv_transpose2d(g, quarter,      # noqa: E731
                                             stride=2)
            require(torch.equal(lib().view_as(want), want),
                    f"avg_pool2_bwd: conv_transpose2d is not the adjoint "
                    f"on {tuple(x.shape)}")
            ops = 1.0 * got.numel()
        return (got, want, run, plain, lib, ops,
                4.0 * (x.numel() + got.numel()), "exact")
    x, spec = args[0], args[-1]
    kern, plainf = getattr(fb, name), getattr(fb, name + "_plain")
    if name == "dtcwt_filt":
        _, taps, axis, mode, _ = args
        rest = (taps, axis, mode)
        taps_per_out = len(taps)
    else:
        _, ha, hb, highpass, axis, _ = args
        rest = (ha, hb, highpass, axis)
        taps_per_out = len(ha) if name == "dtcwt_dfilt" else len(ha) // 2
    if name == "dtcwt_dfilt":
        def call_with(f, out, acc):
            return f(x, *rest, out=out)
    else:
        def call_with(f, out, acc):
            return f(x, *rest, out=out, accumulate=acc)
    got = _write_spec(x, spec, lambda o, a: call_with(kern, o, a))
    want = _write_spec(x, spec, lambda o, a: call_with(plainf, o, a))
    acc = spec is not None and spec[0] == "acc"
    buf, pbuf = _fresh_out(x, spec), _fresh_out(x, spec)
    run = lambda: call_with(kern, buf, acc)                   # noqa: E731
    plain = lambda: call_with(plainf, pbuf, acc)              # noqa: E731
    if name == "dtcwt_filt":
        taps, axis, mode = rest
        L, m = len(taps), len(taps) // 2
        xp = fb.pad1d(x, m, m, axis, "symmetric" if mode == "symmetric"
                      else "zero")
        N, C = x.shape[:2]
        xp = xp.reshape(N * C, 1, *xp.shape[2:]).contiguous()
        w = torch.tensor(np.asarray(taps), dtype=torch.float32,
                         device=x.device)
        w = w.view(1, 1, 1, L) if axis == 3 else w.view(1, 1, L, 1)
        shape = want.shape
        if acc:
            lib = lambda: F.conv2d(xp, w).view(shape).add_(   # noqa: E731
                spec[1])
        else:
            lib = lambda: F.conv2d(xp, w)                     # noqa: E731
        ref = F.conv2d(xp, w).view(shape) + (spec[1] if acc else 0)
        require(torch.allclose(ref, want, **STENCIL_TOL),
                "dtcwt_filt: the library yardstick differs from the plain "
                "version")
    else:
        ha, hb, highpass, axis = rest
        ifilt = name == "dtcwt_ifilt"
        streams, blocks = (fb.ifilt_operands(x, ha, hb, highpass, axis)
                           if ifilt else fb.dfilt_operands(x, ha, hb, axis))
        N, C = x.shape[:2]
        G, L = blocks.shape[0], blocks.shape[-1]
        xr = streams.reshape(N * C, G, *streams.shape[2:]).contiguous()
        w = torch.as_tensor(blocks.reshape((G, G, L, 1) if axis == 2 else
                                           (G, G, 1, L)),
                            dtype=torch.float32, device=x.device)
        stride = (1, 1) if ifilt else ((2, 1) if axis == 2 else (1, 2))
        lib = lambda: F.conv2d(xr, w, stride=stride)          # noqa: E731
        y = lib()
        y = y.reshape(N, C, G, *y.shape[2:])
        ref = (fb.ifilt_finish(y, x.shape, axis) if ifilt else
               fb.dfilt_finish(y, highpass, x.shape, axis))
        ref = ref + spec[1] if acc else ref
        require(torch.allclose(ref, want, **STENCIL_TOL),
                f"{name}: the plain version's convolution, interleaved, "
                f"differs from the plain version")
    ops = 2.0 * taps_per_out * got.numel()
    nbytes = 4.0 * (x.numel() + got.numel() * (2 if acc else 1))
    return got, want, run, plain, lib, ops, nbytes, STENCIL_TOL


def dwt_call_parts(call, afb, pad):
    """One recorded K6/K7 call: (got, want, run, plain, lib, ops, bytes).
    ``lib`` is cuDNN on the same work where one call does it: for K6
    ``F.conv2d`` of the padded input (padded here, not timed) with the
    two taps stacked, stride 2 along the axis; for K7 ``F.conv_transpose2d``
    of (lo, hi) as two channels (stacked here), stride 2, outside
    'periodization' (whose wrap-add no single call does); else None."""
    import torch.nn.functional as F
    name, _, args = call
    if name == "afb1d_corr":
        x, h0, h1, mode, axis, out_len = args
        got = afb.afb1d_corr(x, h0, h1, mode, axis, out_len)

        def plain():
            y = afb.afb1d_corr_plain(x, h0, h1, mode, axis)
            return y if out_len is None else y.narrow(axis + 1, 0, out_len)
        run = lambda: afb.afb1d_corr(x, h0, h1, mode, axis,   # noqa: E731
                                     out_len)
        L, n = len(h0), x.shape[axis]
        _, front, ne, pmode, shift, fold = afb.afb_plan(n, L, mode)
        lib = None
        if shift == 0 and fold == 0:
            q = 2 * (got.shape[axis + 1] - 1) + L
            idx = pad.pad_index(ne, front, max(q - front - ne, 0), pmode)[:q]
            xp = torch.index_select(x, axis, torch.as_tensor(
                np.clip(idx, 0, n - 1), device=x.device))
            if (idx < 0).any():
                shape = [1] * 4
                shape[axis] = q
                xp = xp * torch.as_tensor(idx >= 0, device=x.device,
                                          dtype=x.dtype).view(shape)
            N, C = x.shape[:2]
            xp = xp.reshape(N * C, 1, *xp.shape[2:]).contiguous()
            w = torch.tensor(np.stack([h0, h1]), dtype=torch.float32,
                             device=x.device)
            w = w.view(2, 1, 1, L) if axis == 3 else w.view(2, 1, L, 1)
            stride = (1, 2) if axis == 3 else (2, 1)
            lib = lambda: F.conv2d(xp, w, stride=stride)      # noqa: E731
        ops = 2.0 * L * got.numel()
        nbytes = 4.0 * (x.numel() + got.numel())
    else:
        lo, hi, g0, g1, mode, axis, out_len = args
        got = afb.sfb1d_conv(lo, hi, g0, g1, mode, axis, out_len)

        def plain():
            y = afb.sfb1d_conv_plain(lo, hi, g0, g1, mode, axis)
            return y if out_len is None else y.narrow(axis, 0, out_len)
        run = lambda: afb.sfb1d_conv(lo, hi, g0, g1, mode,   # noqa: E731
                                     axis, out_len)
        L = len(g0)
        lib = None
        if mode not in ("per", "periodization") and L >= 2:
            N, C, H, W = lo.shape
            xin = torch.stack([lo, hi], dim=2).reshape(N * C, 2, H, W)
            w = torch.tensor(np.stack([g0, g1]), dtype=torch.float32,
                             device=lo.device)
            w = w.view(2, 1, 1, L) if axis == 3 else w.view(2, 1, L, 1)
            stride, padding = (((1, 2), (0, L - 2)) if axis == 3
                               else ((2, 1), (L - 2, 0)))
            lib = lambda: F.conv_transpose2d(                 # noqa: E731
                xin, w, stride=stride, padding=padding)
        ops = 2.0 * L * got.numel()
        nbytes = 4.0 * (lo.numel() + hi.numel() + got.numel())
    want = plain()
    if lib is not None:   # the yardstick computes the same function
        ax = axis + 1 if name == "afb1d_corr" else axis
        ref = lib().reshape(*want.shape[:ax], -1, *want.shape[ax + 1:])
        require(torch.allclose(ref.narrow(ax, 0, want.shape[ax]), want,
                               **DWT_TOL),
                f"{name}: the library yardstick differs from the plain "
                f"version")
    return got, want, run, plain, lib, ops, nbytes


def replay(call, banded, quad, mag, afb, pad, fb=None, pool=None,
           timing=REPLAY_TIMING, im=None):
    """Check one recorded call against its plain version and time it
    (``timing``: reps, batches).  Returns (err, ms, plain_ms, library_ms,
    bound_ms, op_t, byte_t, copies, extra_ms): ``copies`` the copy widths
    K1's wrapper counted for the checked call, or the instantiations K8's
    and K14's counted (None for other kernels); ``extra_ms`` {name: ms}
    of the other yardsticks a call has (K16's: K1 on the probed
    operator, and the partial transposed convolution of its adjoint)."""
    name, _, args = call
    lib = scale = inst = None
    extra = {}
    counter = _inst_counter(name, fb)
    before = dict(counter.instantiations) if counter else None
    if name in NONSEP_KERNELS:
        got, want, run, plain, lib, ops, nbytes, extra = nonsep_call_parts(
            call, banded)
        tol = NONSEP_TOL
    elif name in SWT_KERNELS:
        got, want, run, plain, lib, ops, nbytes, tol, scale = \
            swt_call_parts(call, afb, pad, im)
    elif name in STENCILS + POOLS:
        got, want, run, plain, lib, ops, nbytes, tol = stencil_call_parts(
            call, fb, pool)
    elif name in DWT_KERNELS:
        got, want, run, plain, lib, ops, nbytes = dwt_call_parts(call, afb,
                                                                 pad)
        tol = DWT_TOL
    elif name in ("apply_row", "apply_col"):
        # mode: None (a new output), ("acc", what out held) or ("write",
        # out's size, strides), as the calls were recorded
        x, T, *mode = args
        mode = mode[0] if mode else None
        kind = mode[0] if mode else None
        kern, plainf = getattr(banded, name), getattr(banded, name + "_plain")
        Td = T.T
        if name == "apply_row":
            prod = lambda: torch.matmul(x, Td.t())            # noqa: E731
        else:
            prod = lambda: torch.matmul(Td, x)                # noqa: E731
        if kind is None:
            got, inst = copies_of(kern, lambda: kern(x, T))
            want = plainf(x, T)
            run = lambda: kern(x, T)                          # noqa: E731
            plain = lambda: plainf(x, T)                      # noqa: E731
            lib = prod
        elif kind == "acc":
            out = mode[1]
            got, inst = copies_of(kern, lambda: kern(x, T, out.clone()))
            want = plainf(x, T, out)
            buf = out.clone()
            run = lambda: kern(x, T, buf)                     # noqa: E731
            plain = lambda: plainf(x, T, out)                 # noqa: E731
            lib = lambda: prod().add_(out)                    # noqa: E731
        else:   # written through the strides of a view (B4's dz blocks)
            buf = torch.empty_strided(mode[1], mode[2], device=x.device)
            pbuf = torch.empty_strided(mode[1], mode[2], device=x.device)
            got, inst = copies_of(kern, lambda: kern(x, T, buf,
                                                     accumulate=False))
            want = plainf(x, T)
            run = lambda: kern(x, T, buf,                     # noqa: E731
                               accumulate=False)
            plain = lambda: plainf(x, T, pbuf,                # noqa: E731
                                   accumulate=False)
            lib = prod
        K = x.shape[3 if name == "apply_row" else 2]
        ops = 2.0 * T.nnz * x.numel() / K
        nbytes = 4.0 * (x.numel() + Td.numel() + got.numel()
                        * (2 if kind == "acc" else 1))
        tol = K1_TOL
    elif name == "q2c_pack":
        y, size, stride, orients, *il = args
        il = bool(il and il[0])          # per level: interleaved corners
        got = torch.empty_strided(size, stride, device=y.device,
                                  dtype=y.dtype)
        want = torch.empty_strided(size, stride, device=y.device)
        quad.q2c_pack(y, got, orients, il)
        # the plain version in fp32, rounded once (bf16: as K2 rounds)
        quad.q2c_pack_plain(y.float(), want, orients, il)
        written = [o for pair in orients for o in pair]  # orientations filled
        got, want = got[:, :, written], want[:, :, written].to(y.dtype)
        buf = torch.empty_strided(size, stride, device=y.device,
                                  dtype=y.dtype)
        run = lambda: quad.q2c_pack(y, buf, orients, il)      # noqa: E731
        plain = lambda: quad.q2c_pack_plain(                  # noqa: E731
            y, buf, orients, il)
        # one add or subtract per value, and per level a scaling per read
        ops = (2.0 if il else 1.0) * got.numel()
        nbytes = y.element_size() * (y.numel() + got.numel())
        tol = "exact"
    elif name == "c2q_unpack":
        h, orients, *il = args
        il = bool(il and il[0])
        got = quad.c2q_unpack(h, orients, il)
        # the plain version in fp32, rounded once (bf16: as K3 rounds)
        want = quad.c2q_unpack_plain(h.float(), orients, il).to(h.dtype)
        run = lambda: quad.c2q_unpack(h, orients, il)         # noqa: E731
        plain = lambda: quad.c2q_unpack_plain(                # noqa: E731
            h, orients, il)
        ops = (2.0 if il else 1.0) * got.numel()
        # each read once, each written once
        nbytes = h.element_size() * 2 * got.numel()
        tol = "exact"
    elif name == "scat_mag_fwd":
        h, bias, combine = args
        got = mag.scat_mag_fwd(h, bias, combine)
        want = mag.scat_mag_fwd_plain(h, bias, combine)
        run = lambda: mag.scat_mag_fwd(h, bias, combine)      # noqa: E731
        plain = lambda: mag.scat_mag_fwd_plain(               # noqa: E731
            h, bias, combine)
        ops = 2.0 * h.numel() + 3.0 * got.numel()
        nbytes = 4.0 * (h.numel() + got.numel())
        tol = MAG_TOL
    elif name == "scat_mag_bwd2":
        h, g, u, bias, combine = args
        got = torch.cat([t.flatten() for t in
                         mag.scat_mag_bwd2(h, g, u, bias, combine)])
        want = torch.cat([t.flatten() for t in
                          mag.scat_mag_bwd2_plain(h, g, u, bias, combine)])
        scale = scat_mag_bwd2_scale(h, g, u, bias, combine)
        run = lambda: mag.scat_mag_bwd2(h, g, u, bias,        # noqa: E731
                                        combine)
        plain = lambda: mag.scat_mag_bwd2_plain(              # noqa: E731
            h, g, u, bias, combine)
        # per (re, im) value: its square and product with u, the sums, the
        # two products and the difference of dh'; per output: the root
        # and three quotients
        ops = 7.0 * h.numel() + 6.0 * g.numel()
        nbytes = 4.0 * (3 * h.numel() + 2 * g.numel())
        tol = BWD2_TOL
    else:
        h, g, bias, combine = args
        got = mag.scat_mag_bwd(h, g, bias, combine)
        want = mag.scat_mag_bwd_plain(h, g, bias, combine)
        run = lambda: mag.scat_mag_bwd(h, g, bias, combine)   # noqa: E731
        plain = lambda: mag.scat_mag_bwd_plain(               # noqa: E731
            h, g, bias, combine)
        ops = 4.0 * h.numel() + 2.0 * g.numel()
        nbytes = 4.0 * (2 * h.numel() + g.numel())
        tol = MAG_TOL
    require(within(got, want, tol, scale),
            f"{name} {tuple(args[0].shape)} disagrees with its plain "
            f"version by {max_err(got, want)}")
    if counter:
        inst = {w: n - before.get(w, 0)
                for w, n in counter.instantiations.items()
                if n != before.get(w, 0)}
    op_t, byte_t = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    reps, batches = timing
    return (max_err(got, want), timed_ms(run, reps, batches),
            timed_ms(plain, reps, batches),
            None if lib is None else timed_ms(lib, reps, batches),
            max(op_t, byte_t), op_t, byte_t, inst,
            {k: timed_ms(f, reps, batches) for k, f in extra.items()})


def _inst_counter(name, fb):
    """The wrapper whose ``instantiations`` a call of kernel ``name``
    bumps (K2's, K3's, K4's to K10's, K11's two, K12's two, K13's two,
    K14's two, K15's two, K16's two), else None."""
    from pytorch_wavelets_tpu_torch.ops import (
        afb_sfb, iswt_merge, nonsep, pool, quad, scat_mag,
    )
    if name in ("scat_mag_fwd", "scat_mag_bwd", "scat_mag_bwd2"):
        return getattr(scat_mag, name)
    if name in ("q2c_pack", "c2q_unpack"):
        return getattr(quad, name)
    if name in POOLS:
        return getattr(pool, name)
    if name in ("spec_merge", "spec_split"):
        return getattr(iswt_merge, name)
    if name in ("dtcwt_filt", "dtcwt_dfilt", "dtcwt_ifilt") and \
            fb is not None:
        return getattr(fb, name)
    if name in ("nonsep_afb", "nonsep_afb_adjoint", "nonsep_sfb",
                "nonsep_sfb_adjoint"):
        return getattr(nonsep, name)
    if name in ("afb1d_corr", "sfb1d_conv", "afb1d_atrous_corr",
                "afb1d_atrous_adjoint", "sfb1d_atrous_conv",
                "sfb1d_atrous_adjoint"):
        return getattr(afb_sfb, name)
    return None


TILE_INSTS = ("col_scalar", "col_float4", "row_run", "row_gather")


def tiles_only(insts, phase, counts):
    """Every K6, K7, K9 and K12 launch of a main path ran a tile: none
    took K6's or K7's per-output long_fold, and K6's, K9's and K12's tile
    counts (K12's adjoint's band aside) add up to the run's launches
    ``counts``."""
    for k in ("afb1d_corr", "sfb1d_conv"):
        got = insts.get(k, {})
        require(not got.get("long_fold"), f"{phase}: {SOURCES[k][0]} ran "
                f"its per-output long_fold on a main path: {got}")
    for k in ("afb1d_corr", "dtcwt_dfilt", "afb1d_atrous_corr",
              "afb1d_atrous_adjoint"):
        got = insts.get(k, {})
        require(sum(got.get(w, 0) for w in TILE_INSTS) == counts.get(k, 0),
                f"{phase}: {SOURCES[k][0]} launched {counts.get(k, 0)} "
                f"times, {got} on its tiles")
    return insts


def vector_mags(insts, phase, counts):
    """Every K4 and K5 launch of a scattering path took the vector
    instantiation (16-byte loads of the bands the pyramids write)."""
    for k in ("scat_mag_fwd", "scat_mag_bwd"):
        got = insts.get(k, {})
        require(got.get("vector", 0) == counts.get(k, 0),
                f"{phase}: {k} launched {counts.get(k, 0)} times, {got} "
                f"on its vector instantiation")
    return insts


def vector_quads(insts, phase, counts):
    """Every K2 launch of a path that writes the default band layout took
    the vector instantiation (16-byte stores of (re, im) pairs)."""
    got = insts.get("q2c_pack", {})
    require(got.get("vector", 0) == counts.get("q2c_pack", 0),
            f"{phase}: q2c_pack launched {counts.get('q2c_pack', 0)} times, "
            f"{got} on its vector instantiation")
    return insts


def vector_c2qs(insts, phase, counts):
    """Every K3 launch of a path that reads the default band layout took
    the vector instantiation (16-byte loads of (re, im) pairs)."""
    got = insts.get("c2q_unpack", {})
    require(got.get("vector", 0) == counts.get("c2q_unpack", 0),
            f"{phase}: c2q_unpack launched {counts.get('c2q_unpack', 0)} "
            f"times, {got} on its vector instantiation")
    return insts


def vector_pools(insts, phase, counts):
    """Every K11 launch of a per-level scattering path took the vector
    instantiation (16-byte loads of the lowpass rows; 16-byte stores of
    the adjoint's)."""
    for k in POOLS:
        got = insts.get(k, {})
        require(got.get("vector", 0) == counts.get(k, 0),
                f"{phase}: {k} launched {counts.get(k, 0)} times, {got} on "
                f"its vector instantiation")
    return insts


def stream_specs(insts, phase, counts):
    """Every K13 launch of the FFT merge streamed (its spectra, and the
    outputs it writes, at stride 1 along the frequency axis)."""
    for k in ("spec_merge", "spec_split"):
        got = insts.get(k, {})
        require(got.get("stream", 0) == counts.get(k, 0),
                f"{phase}: {k} launched {counts.get(k, 0)} times, {got} on "
                f"its stream walk")
    return insts


def _tolerance(kernel):
    if kernel in ("q2c_pack", "c2q_unpack") or kernel in POOLS:
        return "exact"
    if kernel.startswith("spec_"):
        return dict(SPEC_TOL, relative_to="the terms' magnitudes")
    if kernel == "scat_mag_bwd2":
        return dict(BWD2_TOL, relative_to="the terms' magnitudes")
    if kernel.startswith("scat_mag"):
        return MAG_TOL
    if kernel in NONSEP_KERNELS:
        return NONSEP_TOL
    return DWT_TOL if kernel in DWT_KERNELS + SWT_KERNELS[:2] \
        else STENCIL_TOL if kernel in STENCILS else K1_TOL


def kernel_rows(groups, banded, quad, mag, afb, pad, fb=None, pool=None,
                timing=REPLAY_TIMING, im=None):
    """One row per group (name, replaces, launches, calls): the replays of
    its calls summed; ``per_call`` lists [input shape (by operator
    shape), ms, plain_ms, library_ms, bound_ms] for each call; K1's rows
    count its calls by copy width (``instantiations``)."""
    rows = []
    for name, replaces, launches, calls in groups:
        a = dict(err=0.0, ms=0.0, plain=0.0, lib=0.0, bound=0.0, op=0.0,
                 byte=0.0, haslib=True, per_call=[], inst={}, extra={})
        for call in calls:
            err, ms, plain_ms, lib_ms, bound, op_t, byte_t, inst, extra = \
                replay(call, banded, quad, mag, afb, pad, fb, pool, timing,
                       im)
            for w, n in (inst or {}).items():
                a["inst"][w] = a["inst"].get(w, 0) + n
            for k, v in extra.items():
                a["extra"][k] = a["extra"].get(k, 0.0) + v
            a["err"] = max(a["err"], err)
            a["ms"] += ms
            a["plain"] += plain_ms
            a["haslib"] &= lib_ms is not None
            a["lib"] += lib_ms or 0.0
            a["bound"] += bound
            a["op"] += op_t
            a["byte"] += byte_t
            shape = "x".join(map(str, call[2][0].shape))
            if call[0].startswith("apply"):
                shape += " by " + "x".join(map(str, call[2][1].shape))
            elif call[0] in DWT_KERNELS:
                shape += f" axis {call[2][-2]}"
            elif call[0] in SWT_KERNELS:
                shape += f" axis {call[2][SWT_AXIS_ARG[call[0]]]}"
            elif call[0].startswith("nonsep"):
                shape += " by " + "x".join(map(str, np.shape(call[2][1])))
                shape += f" {call[2][2]}"
            elif call[0] in NONSEP_KERNELS:
                mode, axis, d = call[2][-3:]
                shape += f" axis {axis} d {d} {mode}"
            elif call[0] in STENCILS:
                axis = call[2][2 if call[0] == "dtcwt_filt" else 4]
                shape += f" axis {axis}"
                if call[2][-1] is not None:
                    shape += f" {call[2][-1][0]}"
            a["per_call"].append([shape, ms, plain_ms, lib_ms, bound])
        kernel = calls[0][0]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"pytorch_wavelets_tpu_torch/csrc/"
                      f"{SOURCES[kernel][1]}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": a["err"],
            "tolerance": _tolerance(kernel),
            "ms": a["ms"], "plain_ms": a["plain"],
            "bound_ms": a["bound"],
            "bound_by": "bytes" if a["byte"] >= a["op"] else "operations",
            "library_ms": a["lib"] if a["haslib"] else None,
            **a["extra"], "per_call": a["per_call"]})
        if kernel.startswith("apply_") or _inst_counter(kernel, fb):
            rows[-1]["instantiations"] = a["inst"]
    return rows


def phase_groups(calls, by_role, label, roles, replaces=None):
    """Groups for :func:`kernel_rows`: per role of ``roles`` and per
    kernel, the calls of that role, named after the path and role, with
    the launches ``by_role[role][kernel]`` and the JAX function
    ``replaces(role, kernel)`` (the kernel's own by default)."""
    groups = []
    for role in roles:
        for kernel in SOURCES:
            mine = [c for c in calls if c[0] == kernel and c[1] == role]
            if mine:
                groups.append((
                    f"{SOURCES[kernel][0]} ({label}: {role})",
                    replaces(role, kernel) if replaces
                    else SOURCES[kernel][2],
                    by_role.get(role, {}).get(kernel, 0), mine))
    return groups


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

def drive(tt, ops, fused, scat, shape, J, phase):
    """One path: CPU plain reference, counted GPU run, checks, timing, and
    the recorded kernel calls.  Returns (counts, calls, fields)."""
    N, C, H, W = shape
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    with one_cpu_thread():
        ref_yl, ref_yh = tt.DTCWTForward(J=J, device="cpu")(x_cpu)
        ref_rec = tt.DTCWTInverse(device="cpu")((ref_yl, ref_yh))
    cpu_s = time.perf_counter() - t0

    fwd = tt.DTCWTForward(J=J, device="cuda")
    inv = tt.DTCWTInverse(device="cuda")
    x = x_cpu.cuda()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        yl, yh = fwd(x)
        rec = inv((yl, yh))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        copies = copy_counts(ops)
        insts = vector_c2qs(vector_quads(inst_counts(ops), phase, counts),
                            phase, counts)
        first_s = time.perf_counter() - t0
        require(all(counts[k] > 0 for k in PYRAMID_KERNELS),
                f"{phase}: a kernel of the path never launched: {counts}")
        outs = [yl, *yh]
        require(all(bool(torch.isfinite(o).all()) for o in outs + [rec]),
                f"{phase}: non-finite output")
        require(tuple(rec.shape) == shape and tuple(yl.shape) ==
                tuple(ref_yl.shape), f"{phase}: wrong output shapes")
        fwd_err = max(max_err(a.cpu(), b) for a, b in
                      zip(outs, [ref_yl, *ref_yh]))
        inv_err = max_err(rec.cpu(), ref_rec)
        pr_err = max_err(rec, x)
        require(fwd_err <= FWD_ATOL and inv_err <= INV_ATOL,
                f"{phase}: GPU differs from the CPU plain run: forward "
                f"{fwd_err}, inverse {inv_err}")
        require(pr_err <= PR_TOL, f"{phase}: reconstruction error {pr_err}")

        # host-clock-bound times vary from batch to batch on a shared
        # host: more batches, and the median
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: inv(fwd(x)), reps=10, batches=15,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: inv(fwd(x)), reps=10)
        fwd_ms = timed_ms(lambda: fwd(x), reps=10, batches=15,
                          device_only=False)
        inv_ms = timed_ms(lambda: inv((yl, yh)), reps=10, batches=15,
                          device_only=False)
        with Tracer(ops, fused, scat, record=True) as r:
            inv(fwd(x))
        torch.cuda.synchronize()
    fields = dict(
        shape=list(shape), J=J, launches=counts, copies=copies,
        instantiations=insts,
        max_abs_err_vs_cpu={"forward": fwd_err, "inverse": inv_err},
        tolerance={"forward": FWD_ATOL, "inverse": INV_ATOL},
        reconstruction_err=pr_err, reconstruction_tol=PR_TOL,
        first_call_s=first_s, fwd_inv_ms=both_ms, fwd_ms=fwd_ms,
        inv_ms=inv_ms, mpix_per_s=N * C * H * W / 1e6 / (both_ms / 1e3),
        fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms,
        peak_mem_bytes=peak, mem_held_before_bytes=held,
        cpu_reference_s=cpu_s)
    return counts, r.calls, fields


def train_main(tt, ops, fused, scat, shape, J):
    """DTCWT forward -> inverse with gradients: the gradient of
    sum(rec * G0) + sum(yl * G1) + sum(yh_j * G2+j) w.r.t. x, for fixed
    random cotangents G.  Returns (fields, launches per role, calls)."""
    N, C, H, W = shape
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    fwd_c = tt.DTCWTForward(J=J, device="cpu")
    inv_c = tt.DTCWTInverse(device="cpu")

    def step(fwd, inv, x, cts):
        yl, yh = fwd(x)
        outs = [inv((yl, yh)), yl, *yh]
        return outs, torch.autograd.grad(outs, x, cts)[0]

    with torch.no_grad(), one_cpu_thread():
        yl, yh = fwd_c(x_cpu)
    cts_cpu = [torch.randn(t.shape, generator=torch.Generator()
                           .manual_seed(1 + k))
               for k, t in enumerate([x_cpu, yl, *yh])]
    t0 = time.perf_counter()
    with one_cpu_thread():
        _, ref_grad = step(fwd_c, inv_c, x_cpu.clone().requires_grad_(),
                           cts_cpu)
    cpu_s = time.perf_counter() - t0

    fwd = tt.DTCWTForward(J=J, device="cuda")
    inv = tt.DTCWTInverse(device="cuda")
    x = x_cpu.cuda().requires_grad_()
    cts = [c.cuda() for c in cts_cpu]
    with Tracer(ops, fused, scat) as tr:
        torch.cuda.synchronize()
        ops.reset_launches()
        yl, yh = fwd(x)
        outs = [inv((yl, yh)), yl, *yh]
        fwd_counts = ops.launch_counts()
        grad = torch.autograd.grad(outs, x, cts)[0]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        insts = vector_c2qs(vector_quads(inst_counts(ops), "train_main",
                                         counts), "train_main", counts)
    bwd_counts = {k: counts[k] - fwd_counts[k] for k in counts}
    require(all(fwd_counts[k] > 0 and bwd_counts[k] > 0
                for k in PYRAMID_KERNELS),
            f"train_main: a kernel of the path never launched: forward "
            f"{fwd_counts}, backward {bwd_counts}")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) == shape,
            "train_main: x.grad is not finite or has the wrong shape")
    grad_err = max_err(grad.cpu(), ref_grad)
    require(grad_err <= GRAD_ATOL, f"train_main: x.grad differs from the "
            f"CPU plain run by {grad_err}")

    # the adjoint identity of both pyramids, on the card
    yl, yh = fwd(x)
    fouts = [yl, *yh]
    fgrad = torch.autograd.grad(fouts, x, cts[1:])[0]
    adj_fwd = adjoint_error(fouts, cts[1:], [x], [fgrad])
    leaves = [t.detach().requires_grad_() for t in fouts]
    rec = inv((leaves[0], leaves[1:]))
    igrads = torch.autograd.grad(rec, leaves, cts[0])
    adj_inv = adjoint_error([rec], cts[:1], leaves, igrads)
    require(adj_fwd <= ADJOINT_TOL and adj_inv <= ADJOINT_TOL,
            f"train_main: adjoint identity off by {adj_fwd} (forward), "
            f"{adj_inv} (inverse)")

    run = lambda: step(fwd, inv, x, cts)                      # noqa: E731
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(run, reps=10, batches=15, device_only=False)
    peak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(run, reps=10)
    with Tracer(ops, fused, scat, record=True) as rec_tr:
        run()
    torch.cuda.synchronize()
    fields = dict(
        shape=list(shape), J=J,
        launches={"forward": fwd_counts, "backward": bwd_counts},
        instantiations=insts,
        launches_by_role=tr.by_role,
        max_abs_err_grad_vs_cpu=grad_err, tolerance=GRAD_ATOL,
        adjoint_rel_err={"forward pyramid": adj_fwd,
                         "inverse pyramid": adj_inv},
        adjoint_tol=ADJOINT_TOL,
        fwd_bwd_ms=step_ms, fwd_bwd_device_ms=step_dev_ms,
        device_busy_share=step_dev_ms / step_ms,
        mpix_per_s=N * C * H * W / 1e6 / (step_ms / 1e3),
        peak_mem_bytes=peak, mem_held_before_bytes=held,
        cpu_reference_s=cpu_s)
    return fields, tr.by_role, rec_tr.calls


def scat_step(tt, ops, fused, scat, shape, check_n, phase, timing,
              layer="ScatLayerj2", need=None, recorder=None, **kw):
    """``layer``(**kw) (ScatLayerj2 or ScatLayer) forward alone, then
    forward + backward (the gradient of sum(Z * G) for a fixed random G,
    as grad_outputs), against the CPU plain run on the first ``check_n``
    images (images are independent, so that part is exact).  Returns
    (fields, launches per role, calls of one recorded step).  ``timing``
    is (reps, batches) for :func:`timed_ms`; ``need`` the kernels that
    must launch (forward, backward), the composed path's by default;
    ``recorder`` makes the recording context (a :class:`Tracer` by
    default)."""
    N, C, H, W = shape
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    colour = kw.get("combine_colour")
    if layer == "ScatLayerj2":
        cout, down = (51 if colour else 49 * C), 4
    else:
        cout, down = (9 if colour else 7 * C), 2
    G_cpu = torch.randn((N, cout, H // down, W // down),
                        generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    with one_cpu_thread():
        xc = x_cpu[:check_n].clone().requires_grad_()
        z_ref = getattr(tt, layer)(device="cpu", **kw)(xc)
        g_ref = torch.autograd.grad(z_ref, xc, G_cpu[:check_n])[0]
    cpu_s = time.perf_counter() - t0

    m = getattr(tt, layer)(device="cuda", **kw)
    x = x_cpu.cuda().requires_grad_()
    G = G_cpu.cuda()
    with Tracer(ops, fused, scat) as tr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        z = m(x)
        fwd_counts = ops.launch_counts()
        grad = torch.autograd.grad(z, x, G)[0]
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        copies = copy_counts(ops)
        insts = vector_pools(vector_c2qs(vector_quads(vector_mags(
            tiles_only(inst_counts(ops), phase, counts), phase, counts),
            phase, counts), phase, counts), phase, counts)
        first_s = time.perf_counter() - t0
    bwd_counts = {k: counts[k] - fwd_counts[k] for k in counts}
    need_fwd, need_bwd = need or (
        ("apply_row", "apply_col", "q2c_pack", "scat_mag_fwd"),
        ("apply_row", "apply_col", "c2q_unpack", "scat_mag_bwd"))
    require(all(fwd_counts[k] > 0 for k in need_fwd)
            and all(bwd_counts[k] > 0 for k in need_bwd),
            f"{phase}: a kernel of the path never launched: forward "
            f"{fwd_counts}, backward {bwd_counts}")
    if need is not None:     # the per-level path: no operator product
        require(counts["apply_row"] == counts["apply_col"] == 0,
                f"{phase}: the per-level path launched K1: {counts}")
    require(tuple(z.shape) == tuple(G.shape) and tuple(grad.shape) == shape,
            f"{phase}: wrong shapes {tuple(z.shape)}, {tuple(grad.shape)}")
    require(bool(torch.isfinite(z).all()) and bool(torch.isfinite(grad)
                                                  .all()),
            f"{phase}: non-finite output or gradient")
    z_err = max_err(z[:check_n].detach().cpu(), z_ref.detach())
    g_err = max_err(grad[:check_n].cpu(), g_ref)
    require(z_err <= GRAD_ATOL and g_err <= GRAD_ATOL,
            f"{phase}: GPU differs from the CPU plain run on the first "
            f"{check_n} images: output {z_err}, x.grad {g_err}")
    fields = dict(
        shape=list(shape), layer=layer, options=kw,
        launches={"forward": fwd_counts, "backward": bwd_counts},
        copies=copies, instantiations=insts,
        launches_by_role=tr.by_role if need is None else {
            "forward": {k: v for k, v in fwd_counts.items() if v},
            "backward": {k: v for k, v in bwd_counts.items() if v}},
        checked_images=check_n,
        max_abs_err_vs_cpu={"output": z_err, "x_grad": g_err},
        tolerance=GRAD_ATOL, first_step_s=first_s, cpu_reference_s=cpu_s)
    del z, grad
    step = lambda: torch.autograd.grad(m(x), x, G)            # noqa: E731
    reps, batches = timing
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=reps, batches=batches, device_only=False)
    peak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=reps, batches=batches)
    fwd_ms = timed_ms(lambda: m(x), reps=reps, batches=batches,
                      device_only=False)
    with torch.no_grad():
        infer_ms = timed_ms(lambda: m(x), reps=reps, batches=batches,
                            device_only=False)
    z = m(x)
    bwd_ms = timed_ms(lambda: torch.autograd.grad(z, x, G,
                                                  retain_graph=True),
                      reps=reps, batches=batches, device_only=False)
    del z
    if recorder is None:
        with Tracer(ops, fused, scat, record=True) as rec_tr:
            step()
    else:
        with recorder() as rec_tr:
            z = m(x)
            rec_tr.backward = True
            torch.autograd.grad(z, x, G)
            del z
    torch.cuda.synchronize()
    mpix = N * C * H * W / 1e6
    fields.update(
        fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_bwd_ms=step_ms,
        fwd_bwd_device_ms=step_dev_ms, device_busy_share=step_dev_ms /
        step_ms, fwd_no_grad_ms=infer_ms,
        mpix_per_s={"forward": mpix / (fwd_ms / 1e3),
                    "fwd_bwd": mpix / (step_ms / 1e3)},
        timing_reps_batches=[reps, batches], peak_mem_bytes=peak,
        mem_held_before_bytes=held)
    return fields, fields["launches_by_role"], rec_tr.calls


def mag_edge_cases(mag):
    """K4, K5 and K18 at edge views against their plain versions on the
    same inputs, at b = 1e-2 and b = 0 (a zero coefficient: 0 forward, NaN
    backward and second derivative): offsets of 4, 8 and 16 bytes (the
    8-byte one at 128^2 too, every plane a head and a tail), odd and unit
    widths, planes of two chunks, a re/im-last slice, a transposed view,
    combine over 3 and 5 channels, the cotangent as torch.cat's backward
    hands it and a strided one; K18's cotangent u in turn contiguous, 8
    bytes off a line (its heads apart from the bands') and a strided
    slice.  Both instantiations of every kernel must run.  Returns (calls,
    max |err| of K4/K5 where the plain version is finite, instantiations,
    K18's max |err| there; K18 within BWD2_TOL of its terms'
    magnitudes, NaN where its plain version is NaN)."""
    gen = torch.Generator(device="cuda").manual_seed(5)

    def view(shape, strides=None, offset=0):
        if strides is None:
            strides = [int(np.prod(shape[d + 1:])) for d in range(len(shape))]
        size = offset + 1 + sum((n - 1) * s for n, s in zip(shape, strides))
        return torch.as_strided(torch.randn(size, generator=gen,
                                            device="cuda"),
                                shape, strides, offset)

    def band(n=2, c=3, hh=5, ww=8, offset=0):
        return view((n, 6, c, hh, ww, 2), offset=offset)

    def cat_slice(n, c, hh, ww):
        G = view((n, 49 * c, hh, ww))
        return G[:, 7 * c:13 * c].view(n, 6, c, hh, ww)

    cases = [   # (bands, combine, cotangent or None: a contiguous one)
        (lambda: band(), False, None), (lambda: band(), True, None),
        (lambda: band(c=5), True, None),
        (lambda: view((2, 6, 3, 9, 11, 3))[..., 1:10, :2], False, None),
        (lambda: band().transpose(3, 4), False, None),
        (lambda: band(offset=1), False, None),
        (lambda: band(offset=2), False, None),
        (lambda: band(offset=2), True, None),
        (lambda: band(offset=4), True, None),
        (lambda: band(n=4, hh=128, ww=128, offset=2), False, None),
        (lambda: band(hh=5, ww=7), False, None),
        (lambda: band(hh=5, ww=7), True, None),
        (lambda: band(hh=4, ww=1), False, None),
        (lambda: band(n=1, c=2, hh=33, ww=35), False, None),
        (lambda: band(hh=3, ww=5), False, lambda: cat_slice(2, 3, 3, 5)),
        (lambda: band(), False, lambda: view((2, 6, 3, 5, 16))[..., ::2])]
    insts = {"scat_mag_fwd": {}, "scat_mag_bwd": {}, "scat_mag_bwd2": {}}
    calls, err, err2 = 0, 0.0, 0.0
    u_views = (lambda h: view(h.shape), lambda h: view(h.shape, offset=2),
               lambda h: view((*h.shape[:-1], 3))[..., 1:])
    for bias in (1e-2, 0.0):
        for i, (make_h, combine, make_g) in enumerate(cases):
            h = make_h()
            h[0, 0, :, 0, 0] = 0
            N, _, C, hh, ww, _ = h.shape
            g = make_g() if make_g else view(
                (N, 6, 1 if combine else C, hh, ww))
            for name, args in (("scat_mag_fwd", (h, bias, combine)),
                               ("scat_mag_bwd", (h, g, bias, combine))):
                wrapper = getattr(mag, name)
                before = dict(wrapper.instantiations)
                got = wrapper(*args)
                want = getattr(mag, name + "_plain")(*args)
                require(within(got, want, MAG_TOL),
                        f"mag_edge_cases: {name} {tuple(h.shape)} strides "
                        f"{h.stride()} combine {combine} b {bias} disagrees "
                        f"with its plain version by {max_err(got, want)}")
                for k, v in wrapper.instantiations.items():
                    if v != before[k]:
                        insts[name][k] = insts[name].get(k, 0) + v - before[k]
                fin = torch.isfinite(want)
                err = max(err, max_err(got[fin], want[fin]))
                calls += 1
            require(bias or bool(torch.isnan(got).any()),
                    "mag_edge_cases: no NaN gradient at b = 0")
            u = u_views[i % len(u_views)](h)
            wrapper = mag.scat_mag_bwd2
            before = dict(wrapper.instantiations)
            got = torch.cat([t.flatten() for t in
                             wrapper(h, g, u, bias, combine)])
            want = torch.cat([t.flatten() for t in mag.scat_mag_bwd2_plain(
                h, g, u, bias, combine)])
            fin = torch.isfinite(want)
            scale = scat_mag_bwd2_scale(h, g, u, bias, combine)
            require(torch.equal(torch.isnan(got), torch.isnan(want))
                    and within(got[fin], want[fin], BWD2_TOL, scale[fin]),
                    f"mag_edge_cases: scat_mag_bwd2 {tuple(h.shape)} strides "
                    f"{h.stride()}, u {u.stride()} combine {combine} b "
                    f"{bias} disagrees with its plain version by "
                    f"{max_err(got[fin], want[fin])}")
            for k, v in wrapper.instantiations.items():
                if v != before[k]:
                    insts["scat_mag_bwd2"][k] = (
                        insts["scat_mag_bwd2"].get(k, 0) + v - before[k])
            err2 = max(err2, max_err(got[fin], want[fin]))
            calls += 1
            require(bias or bool(torch.isnan(got).any()),
                    "mag_edge_cases: no NaN second derivative at b = 0")
    for name, got in insts.items():
        require(set(got) == set(mag.MAG_INSTS), f"mag_edge_cases: {name} "
                f"ran {got}, not every instantiation")
    return calls, err, insts, err2


def quad_edge_cases(quad):
    """K2 in each instantiation at edge views, fp32 and bf16, bit for bit
    against its plain version computed in fp32 and rounded once: the
    composed and per-level corner layouts, odd k (a row's partial last
    slot), bands 8 or 12 bytes into a line (partial first slots), per-level
    rows shifted off their lines (the corners' loads value by value),
    every o_dim / ri_dim layout, bands off a whole (re, im) pair.  Returns
    (calls checked, elements that differ from the plain version, K2's
    launches by instantiation)."""
    from pytorch_wavelets_tpu_torch.ops import fused_dtcwt
    from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5
    gen = torch.Generator().manual_seed(120)
    before = dict(quad.q2c_pack.instantiations)
    n = mismatches = 0
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, il, o_dim, ri_dim, off, shift in (
                (3, 8, False, 2, -1, 0, 0), (3, 7, False, 2, -1, 0, 0),
                (2, 6, False, 2, -1, 2, 0), (3, 5, False, 1, -1, 0, 0),
                (2, 9, False, 0, 5, 6, 0), (5, 130, False, 2, -1, 0, 0),
                (3, 8, True, 2, -1, 0, 0), (3, 5, True, 1, -1, 0, 0),
                (2, 6, True, 2, -1, 4, 1), (4, 300, True, 2, -1, 0, 2),
                (3, 8, False, 1, 3, 0, 0), (3, 8, False, 2, -1, 1, 0),
                (3, 5, True, 4, 2, 0, 0)):
            od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
            orients = ((0, 5), (2, 3), (1, 4)) if il else ((2, 3), (1, 4))
            nm = len(orients)
            if il:
                y = torch.randn((2, 3, nm, 2 * m, 2 * k + 3),
                                generator=gen).to("cuda", dtype)
                y = y[..., shift:shift + 2 * k]
            else:
                y = torch.randn((2, 3, nm * 2 * m, 2 * k),
                                generator=gen).to("cuda", dtype)
            shape = [2, 3, m, k]
            shape.insert(od, 6)
            shape.insert(rd, 2)
            buf = torch.full((int(np.prod(shape)) + off,), float("nan"),
                             device="cuda", dtype=dtype)
            h = torch.as_strided(buf, shape, torch.empty(shape).stride(),
                                 off)
            want = torch.full(shape, float("nan"), device="cuda")
            quad.q2c_pack(y, fused_dtcwt.canonical_bands(h, od, rd),
                          orients, il)
            quad.q2c_pack_plain(y.float(),
                                fused_dtcwt.canonical_bands(want, od, rd),
                                orients, il)
            want = want.to(dtype)
            bad = int((~((h == want) | (h.isnan() & want.isnan()))).sum()
                      + (~buf[:off].isnan()).sum())
            require(bad == 0,
                    f"q2c_pack edge case m={m} k={k} interleaved={il} "
                    f"o_dim={o_dim} ri_dim={ri_dim} offset={off} {dtype}: "
                    f"{bad} elements differ from its plain version")
            mismatches += bad
            n += 1
    torch.cuda.synchronize()
    insts = {w: c - before[w] for w, c in quad.q2c_pack.instantiations.items()}
    require(all(insts.values()), f"quad_edge_cases: a K2 instantiation was "
            f"not checked: {insts}")
    return n, mismatches, insts


def c2q_edge_cases(quad):
    """K3 in each instantiation at edge views, fp32 and bf16, bit for bit
    against its plain version computed in fp32 and rounded once, written
    into NaN-filled outputs (a missed or doubled write shows): both
    output layouts, odd w and w = 1 (a row's partial slots), bands 4, 8
    and 12 bytes into a line (bf16: 2, 4 and 6 values; fp32: 8 bytes, a
    line, 12 bytes off a pair), rows of several chunks, every o_dim /
    ri_dim layout, bands off a whole (re, im) pair.  Returns (calls
    checked, elements that differ from the plain version, K3's launches
    by instantiation)."""
    from pytorch_wavelets_tpu_torch.ops import fused_dtcwt
    from pytorch_wavelets_tpu_torch.transforms.dtcwt import get_dimensions5
    gen = torch.Generator().manual_seed(121)
    before = dict(quad.c2q_unpack.instantiations)
    n = mismatches = 0
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, il, o_dim, ri_dim, off in (
                (3, 8, False, 2, -1, 0), (3, 7, False, 2, -1, 0),
                (2, 1, False, 2, -1, 0), (2, 6, False, 2, -1, 2),
                (3, 9, False, 2, -1, 4), (2, 10, False, 2, -1, 6),
                (2, 6, False, 2, -1, 3), (3, 5, False, 1, -1, 0),
                (2, 9, False, 0, 5, 6), (5, 300, False, 2, -1, 2),
                (3, 8, True, 2, -1, 0), (3, 5, True, 1, -1, 0),
                (2, 1, True, 2, -1, 0), (2, 6, True, 2, -1, 4),
                (4, 300, True, 2, -1, 0), (3, 8, False, 1, 3, 0),
                (3, 8, False, 2, -1, 1), (3, 5, True, 4, 2, 0),
                (2, 6, True, 2, 3, 2)):
            od, rd, _, _ = get_dimensions5(o_dim, ri_dim)
            orients = ((0, 5), (2, 3), (1, 4)) if il else ((2, 3), (1, 4))
            shape = [2, 3, m, k]
            shape.insert(od, 6)
            shape.insert(rd, 2)
            size = int(np.prod(shape))
            buf = torch.randn(size + off, generator=gen).to("cuda", dtype)
            h = fused_dtcwt.canonical_bands(torch.as_strided(
                buf, shape, torch.empty(shape).stride(), off), od, rd)
            oshape = quad._c2q_addr(h, len(orients), il)[0]
            got = torch.full(oshape, float("nan"), device="cuda",
                             dtype=dtype)
            quad.c2q_unpack(h, orients, il, out=got)
            want = quad.c2q_unpack_plain(h.float(), orients, il).to(dtype)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            bad = int((got.view(bits) != want.view(bits)).sum())
            require(bad == 0,
                    f"c2q_unpack edge case m={m} k={k} interleaved={il} "
                    f"o_dim={o_dim} ri_dim={ri_dim} offset={off} {dtype}: "
                    f"{bad} elements differ from its plain version")
            mismatches += bad
            n += 1
    torch.cuda.synchronize()
    insts = {w: c - before[w]
             for w, c in quad.c2q_unpack.instantiations.items()}
    require(all(insts.values()), f"c2q_edge_cases: a K3 instantiation was "
            f"not checked: {insts}")
    return n, mismatches, insts


def dwt_adjoint(tt, x_cpu, J, one_d):
    """The dot-product test of both DWT Functions on the card in 'zero'
    mode, where the reference's backward is the true adjoint (in the
    other modes it ignores the boundary fold).  Returns (forward,
    inverse) relative errors."""
    fcls, icls = ((tt.DWT1DForward, tt.DWT1DInverse) if one_d
                  else (tt.DWTForward, tt.DWTInverse))
    f = fcls(J=J, wave=DWT_WAVE, mode="zero", device="cuda")
    i = icls(wave=DWT_WAVE, mode="zero", device="cuda")
    x = x_cpu.cuda().requires_grad_()
    yl, yh = f(x)
    outs = [yl, *yh]
    gs = [torch.randn(o.shape, generator=torch.Generator().manual_seed(
        50 + k)).cuda() for k, o in enumerate(outs)]
    gx = torch.autograd.grad(outs, x, gs)[0]
    adj_f = adjoint_error(outs, gs, [x], [gx])
    leaves = [o.detach().requires_grad_() for o in outs]
    rec = i((leaves[0], leaves[1:]))
    g = torch.randn(rec.shape, generator=torch.Generator().manual_seed(
        60)).cuda()
    grads = torch.autograd.grad(rec, leaves, g)
    return adj_f, adjoint_error([rec], [g], leaves, grads)


def dwt_path(tt, ops, afb, dwt, shape, J, one_d, phase):
    """A DWT path (2-D, or 1-D with ``one_d``): forward + inverse, counted,
    checked against the CPU plain run on the first DWT_CHECK_N items and
    for perfect reconstruction, timed; then the training step (the
    gradient of sum(rec * G0) + sum(yl * G1) + sum(yh_j * G2+j) w.r.t. x
    for fixed random G), counted, x.grad checked, timed, and one step
    recorded; the adjoint identity in 'zero' mode.  Returns (fields of
    the forward + inverse, fields of the training step, launches per
    role, recorded calls, the step)."""
    fcls, icls = ((tt.DWT1DForward, tt.DWT1DInverse) if one_d
                  else (tt.DWTForward, tt.DWTInverse))
    kw = dict(wave=DWT_WAVE, mode=DWT_MODE)
    n = DWT_CHECK_N
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    with one_cpu_thread():
        fc, ic = fcls(J=J, device="cpu", **kw), icls(device="cpu", **kw)
        xc = x_cpu[:n].clone().requires_grad_()
        yl, yh = fc(xc)
        outs = [ic((yl, yh)), yl, *yh]
        ref = [o.detach() for o in outs]
        cts_cpu = [torch.randn((shape[0], *o.shape[1:]), generator=torch
                               .Generator().manual_seed(1 + k))
                   for k, o in enumerate(outs)]
        ref_grad = torch.autograd.grad(outs, xc,
                                       [c[:n] for c in cts_cpu])[0]
    cpu_s = time.perf_counter() - t0
    del yl, yh, outs

    f, i = fcls(J=J, device="cuda", **kw), icls(device="cuda", **kw)
    x = x_cpu.cuda()
    cts = [c.cuda() for c in cts_cpu]
    mpix = x.numel() / 1e6
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        yl, yh = f(x)
        fwd_counts = ops.launch_counts()
        rec = i((yl, yh))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        first_s = time.perf_counter() - t0
        insts = tiles_only(inst_counts(ops), phase, counts)
        inv_counts = {k: counts[k] - fwd_counts[k] for k in counts}
        require(fwd_counts["afb1d_corr"] > 0 and inv_counts["sfb1d_conv"] > 0,
                f"{phase}: a kernel of the path never launched: forward "
                f"{fwd_counts}, inverse {inv_counts}")
        outs = [yl, *yh]
        require(all(bool(torch.isfinite(o).all()) for o in outs + [rec]),
                f"{phase}: non-finite output")
        require(tuple(rec.shape) == shape and all(
            tuple(a.shape[1:]) == tuple(b.shape[1:])
            for a, b in zip([rec, *outs], ref)), f"{phase}: wrong shapes")
        fwd_err = max(max_err(a[:n].cpu(), b) for a, b in zip(outs, ref[1:]))
        inv_err = max_err(rec[:n].cpu(), ref[0])
        pr_err = max_err(rec, x)
        require(fwd_err <= FWD_ATOL and inv_err <= INV_ATOL,
                f"{phase}: GPU differs from the CPU plain run: forward "
                f"{fwd_err}, inverse {inv_err}")
        require(pr_err <= PR_TOL, f"{phase}: reconstruction error {pr_err}")
        del yl, yh, rec, outs
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: i(f(x)), reps=5, batches=10,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: i(f(x)), reps=5, batches=5)
        fwd_ms = timed_ms(lambda: f(x), reps=5, batches=10,
                          device_only=False)
        coeffs = f(x)
        inv_ms = timed_ms(lambda: i(coeffs), reps=5, batches=10,
                          device_only=False)
        del coeffs
    fields = dict(
        shape=list(shape), J=J, wave=DWT_WAVE, mode=DWT_MODE,
        launches={"forward": fwd_counts, "inverse": inv_counts},
        instantiations=insts, checked_images=n,
        max_abs_err_vs_cpu={"forward": fwd_err, "inverse": inv_err},
        tolerance={"forward": FWD_ATOL, "inverse": INV_ATOL},
        reconstruction_err=pr_err, reconstruction_tol=PR_TOL,
        first_call_s=first_s, fwd_inv_ms=both_ms, fwd_ms=fwd_ms,
        inv_ms=inv_ms, mpix_per_s=mpix / (both_ms / 1e3),
        fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms,
        peak_mem_bytes=peak, mem_held_before_bytes=held,
        cpu_reference_s=cpu_s)

    x.requires_grad_()

    def step():
        yl, yh = f(x)
        outs = [i((yl, yh)), yl, *yh]
        return torch.autograd.grad(outs, x, cts)[0]

    torch.cuda.synchronize()
    ops.reset_launches()
    yl, yh = f(x)
    outs = [i((yl, yh)), yl, *yh]
    tf_counts = ops.launch_counts()
    grad = torch.autograd.grad(outs, x, cts)[0]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    tinsts = tiles_only(inst_counts(ops), f"{phase} training", counts)
    tb_counts = {k: counts[k] - tf_counts[k] for k in counts}
    require(all(tf_counts[k] > 0 and tb_counts[k] > 0 for k in DWT_KERNELS),
            f"{phase} training: a kernel of the path never launched: "
            f"forward {tf_counts}, backward {tb_counts}")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) == shape,
            f"{phase} training: x.grad is not finite or has the wrong shape")
    grad_err = max_err(grad[:n].cpu(), ref_grad)
    require(grad_err <= GRAD_ATOL, f"{phase} training: x.grad differs from "
            f"the CPU plain run by {grad_err}")
    del yl, yh, outs, grad
    adj_f, adj_i = dwt_adjoint(tt, x_cpu[:n], J, one_d)
    require(adj_f <= ADJOINT_TOL and adj_i <= ADJOINT_TOL,
            f"{phase}: adjoint identity ('zero' mode) off by {adj_f} "
            f"(forward), {adj_i} (inverse)")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=5, batches=10, device_only=False)
    tpeak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=5, batches=5)
    with DwtRecorder(afb, dwt) as r:
        yl, yh = f(x)
        outs = [i((yl, yh)), yl, *yh]
        r.backward = True
        torch.autograd.grad(outs, x, cts)
        torch.cuda.synchronize()
    del yl, yh, outs
    by_role = {"analysis": tf_counts["afb1d_corr"],
               "synthesis": tf_counts["sfb1d_conv"],
               "synthesis's backward": tb_counts["afb1d_corr"],
               "analysis's backward": tb_counts["sfb1d_conv"]}
    tfields = dict(
        shape=list(shape), J=J, wave=DWT_WAVE, mode=DWT_MODE,
        launches={"forward": tf_counts, "backward": tb_counts},
        launches_by_role=by_role, instantiations=tinsts, checked_images=n,
        max_abs_err_grad_vs_cpu=grad_err, tolerance=GRAD_ATOL,
        adjoint_rel_err_zero_mode={"forward": adj_f, "inverse": adj_i},
        adjoint_tol=ADJOINT_TOL,
        fwd_bwd_ms=step_ms, fwd_bwd_device_ms=step_dev_ms,
        device_busy_share=step_dev_ms / step_ms,
        mpix_per_s=mpix / (step_ms / 1e3),
        peak_mem_bytes=tpeak, mem_held_before_bytes=held)
    return fields, tfields, by_role, r.calls, step


PAIR_INSTS = TILE_INSTS + ("long_fold",)   # K6's and K7's


def dwt_edge_cases(afb, pad):
    """K6/K7 against their plain versions where the main paths do not
    reach: every mode along both axes, odd sizes, db38 (76 taps) at
    periodization's single-fold sizes, L = 3 and 10 (the run-time and
    5-tap windows), strided views as inputs (bands of a stack, aligned
    rows and transposed views: each instantiation of both), cropped
    outputs.  Returns (calls checked, max error, K6's and K7's launches
    by instantiation)."""
    gen = torch.Generator().manual_seed(70)
    calls = []
    for L, n in ((8, 33), (8, 6), (76, 20), (76, 7), (10, 29), (3, 12)):
        taps = torch.randn((4, L), generator=gen, dtype=torch.float64)
        h0, h1, g0, g1 = (t.numpy() / np.sqrt(L) for t in taps)
        for mode in ("zero", "symmetric", "reflect", "periodic",
                     "periodization"):
            for axis in (2, 3):
                shape = [2, 3, 9, 11]
                shape[axis] = n
                wide = torch.randn((shape[0], shape[1], 4, *shape[2:]),
                                   generator=gen).cuda()
                x = wide[:, :, 2]
                m = afb.afb_plan(n, L, mode)[0]
                calls.append(("afb1d_corr", "edge",
                              (x, h0, h1, mode, axis, None)))
                calls.append(("afb1d_corr", "edge",
                              (x, h0, h1, mode, axis, max(m - 1, 1))))
                # aligned rows (float4 columns) or a transposed view (the
                # row tile's gather)
                xv = (torch.randn((2, 3, n, 12), generator=gen).cuda()
                      if axis == 2 else torch.randn(
                          (2, 3, n, 9), generator=gen).cuda().transpose(2, 3))
                calls.append(("afb1d_corr", "edge",
                              (xv, h0, h1, mode, axis, None)))
                shape[axis] = m
                stack = torch.randn((shape[0], shape[1], 3, *shape[2:]),
                                    generator=gen).cuda()
                lo, hi = stack[:, :, 2], stack[:, :, 0]
                calls.append(("sfb1d_conv", "edge",
                              (lo, hi, g0, g1, mode, axis, None)))
                calls.append(("sfb1d_conv", "edge",
                              (lo, hi, g0, g1, mode, axis, n)))
                # aligned rows (float4 columns) or transposed rows (the
                # row tile's gather)
                pair = [torch.randn((*shape[:3], 12), generator=gen).cuda()
                        for _ in range(2)] if axis == 2 else [
                    torch.randn(shape[:2] + shape[2:][::-1], generator=gen)
                    .cuda().transpose(2, 3) for _ in range(2)]
                calls.append(("sfb1d_conv", "edge",
                              (*pair, g0, g1, mode, axis, None)))
    err = 0.0
    wrappers = {"dwt_afb": afb.afb1d_corr, "dwt_sfb": afb.sfb1d_conv}
    before = {k: dict(w.instantiations) for k, w in wrappers.items()}
    for call in calls:
        got, want = dwt_call_parts(call, afb, pad)[:2]
        require(torch.allclose(got, want, **DWT_TOL),
                f"{call[0]} edge case {tuple(call[2][0].shape)} "
                f"{call[2][-3:]} disagrees with its plain version by "
                f"{max_err(got, want)}")
        err = max(err, max_err(got, want))
    torch.cuda.synchronize()
    insts = {k: {i: v - before[k].get(i, 0)
                 for i, v in w.instantiations.items()}
             for k, w in wrappers.items()}
    require(all(v.get(i) for v in insts.values() for i in PAIR_INSTS),
            f"dwt_edge_cases: a K6 or K7 instantiation was not checked: "
            f"{insts}")
    return len(calls), err, insts


def level_adjoints(lev, x, ff, fi):
    """The dot-product test <A x, g> = <x, A^T g> of the four level
    Functions on the card (mode 'symmetric', where the JAX custom VJPs'
    bwd is the adjoint): level 1 on ``x``, level 2 on its lowpass, each
    inverse on its forward's outputs.  Returns {function: relative
    error}."""
    gen = torch.Generator(device="cuda").manual_seed(80)

    def rnd(t):
        return torch.randn(t.shape, generator=gen, device="cuda")

    def fwd_err(fn, z, *taps):
        z = z.detach().requires_grad_()
        outs = fn(z, *taps, False, 2, -1, "symmetric")
        gs = [rnd(o) for o in outs]
        gz = torch.autograd.grad(outs, z, gs)[0]
        return adjoint_error(outs, gs, [z], [gz]), [o.detach() for o in outs]

    def inv_err(fn, outs, *taps):
        lo, hi = (o.detach().requires_grad_() for o in outs)
        y = fn(lo, hi, *taps, 2, -1, "symmetric")
        g = rnd(y)
        d = torch.autograd.grad(y, [lo, hi], g)
        return adjoint_error([y], [g], [lo, hi], list(d))

    out = {}
    out["fwd_j1_op"], c1 = fwd_err(lev.fwd_j1_op, x, ff["h0o"], ff["h1o"])
    out["fwd_j2plus_op"], c2 = fwd_err(lev.fwd_j2plus_op, c1[0], ff["h0a"],
                                       ff["h1a"], ff["h0b"], ff["h1b"])
    out["inv_j1_op"] = inv_err(lev.inv_j1_op, c1, fi["g0o"], fi["g1o"])
    out["inv_j2plus_op"] = inv_err(lev.inv_j2plus_op, c2, fi["g0a"],
                                   fi["g1a"], fi["g0b"], fi["g1b"])
    return out


def _need(counts, kernels, phase, what):
    require(all(counts[k] > 0 for k in kernels),
            f"{phase}: a kernel of the {what} never launched: {counts}")
    require(counts["apply_row"] == counts["apply_col"] == 0,
            f"{phase}: the per-level path launched K1: {counts}")


def dtcwt_large(tt, ops, lev, fb, scat, quad, pool, replay_calls):
    """DTCWTForward(J=3) -> DTCWTInverse on LARGE_SHAPE, an axis above
    MAX_MATMUL_N, so the default dispatch takes the per-level path:
    counted, checked (perfect reconstruction; one forward and one inverse
    against the plain versions run on the card, the CPU being too slow at
    this size; the level Functions' adjoint identity), the round trip
    and one gradient step (of the train_main loss) timed.  One round trip
    and the backward of one step are recorded, each handed to
    ``replay_calls(calls, launches per role, label)`` at once (together
    they would not fit on the card).  Returns the fields."""
    N, C, H, W = LARGE_SHAPE
    cuda_gen = torch.Generator(device="cuda")
    x = torch.randn(LARGE_SHAPE, generator=cuda_gen.manual_seed(0),
                    device="cuda")
    f = tt.DTCWTForward(J=LARGE_J, device="cuda")
    i = tt.DTCWTInverse(device="cuda")
    mpix = x.numel() / 1e6
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        yl, yh = f(x)
        fwd_counts = ops.launch_counts()
        rec = i((yl, yh))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        insts = vector_c2qs(vector_quads(tiles_only(
            inst_counts(ops), "dtcwt_large", counts), "dtcwt_large", counts),
            "dtcwt_large", counts)
        first_s = time.perf_counter() - t0
        inv_counts = {k: counts[k] - fwd_counts[k] for k in counts}
        _need(fwd_counts, ("dtcwt_filt", "dtcwt_dfilt", "q2c_pack"),
              "dtcwt_large", "forward")
        _need(inv_counts, ("dtcwt_filt", "dtcwt_ifilt", "c2q_unpack"),
              "dtcwt_large", "inverse")
        outs = [yl, *yh]
        require(all(bool(torch.isfinite(o).all()) for o in outs + [rec])
                and tuple(rec.shape) == LARGE_SHAPE,
                "dtcwt_large: non-finite output or wrong shape")
        pr_err = max_err(rec, x)
        require(pr_err <= PR_TOL, f"dtcwt_large: reconstruction error "
                f"{pr_err}")
        ops.reset_launches()
        with plain_on_card(fb, lev, scat, quad, pool):
            pyl, pyh = f(x)
            prec = i((yl, yh))
        torch.cuda.synchronize()
        plain_counts = ops.launch_counts()
        require(not any(plain_counts[k] for k in PER_LEVEL),
                f"dtcwt_large: the plain run launched kernels: "
                f"{plain_counts}")
        fwd_err = max(max_err(a, b) for a, b in zip(outs, [pyl, *pyh]))
        inv_err = max_err(rec, prec)
        require(fwd_err <= INV_ATOL and inv_err <= INV_ATOL,
                f"dtcwt_large: the kernels differ from the plain versions "
                f"on the card: forward {fwd_err}, inverse {inv_err}")
        del pyl, pyh, prec, rec
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: i(f(x)), reps=3, batches=3,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: i(f(x)), reps=3, batches=3)
        with PerLevelRecorder(fb, lev, scat) as r:
            i(f(x))
        torch.cuda.synchronize()
    # the round trip's forward and inverse
    replay_calls(r.calls, {"forward": {k: v for k, v in counts.items()
                                       if v}},
                 f"DTCWT J={LARGE_J} {shape_str(LARGE_SHAPE)} round trip")
    del r
    cts = [torch.randn(t.shape, generator=cuda_gen.manual_seed(1 + k),
                       device="cuda") for k, t in enumerate([x, *outs])]
    del yl, yh, outs
    adj = level_adjoints(lev, x, f._filters, i._filters)
    require(all(v <= LEVEL_ADJOINT_TOL for v in adj.values()),
            f"dtcwt_large: adjoint identity of the level Functions off: "
            f"{adj}")
    xg = x.requires_grad_()

    def step_outs():
        yl, yh = f(xg)
        return [i((yl, yh)), yl, *yh]

    def step():
        return torch.autograd.grad(step_outs(), xg, cts)[0]

    # the counted step: its forward + inverse, then its backward, each
    # counted from 0
    torch.cuda.synchronize()
    ops.reset_launches()
    outs = step_outs()
    torch.cuda.synchronize()
    step_fwd_counts = ops.launch_counts()
    ops.reset_launches()
    grad = torch.autograd.grad(outs, xg, cts)[0]
    torch.cuda.synchronize()
    step_bwd_counts = ops.launch_counts()
    step_bwd_insts = vector_c2qs(vector_quads(tiles_only(
        inst_counts(ops), "dtcwt_large", step_bwd_counts), "dtcwt_large",
        step_bwd_counts), "dtcwt_large", step_bwd_counts)
    del outs
    _need(step_bwd_counts, ("dtcwt_filt", "dtcwt_dfilt", "dtcwt_ifilt",
                            "q2c_pack", "c2q_unpack"), "dtcwt_large",
          "step's backward")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) ==
            LARGE_SHAPE, "dtcwt_large: x.grad not finite or misshapen")
    del grad
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=2, batches=3, device_only=False)
    step_peak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=2, batches=3)
    outs = step_outs()
    with PerLevelRecorder(fb, lev, scat) as r:
        r.backward = True
        torch.autograd.grad(outs, xg, cts)
    torch.cuda.synchronize()
    del outs, cts
    replay_calls(r.calls, {"backward": {k: v for k, v in
                                        step_bwd_counts.items() if v}},
                 f"DTCWT J={LARGE_J} {shape_str(LARGE_SHAPE)} step")
    del r
    fields = dict(
        shape=list(LARGE_SHAPE), J=LARGE_J, dispatch="per level (auto: "
        "axis above MAX_MATMUL_N)",
        launches={"forward": fwd_counts, "inverse": inv_counts,
                  "step_forward": step_fwd_counts,
                  "step_backward": step_bwd_counts},
        instantiations={"round_trip": insts, "step_backward": step_bwd_insts},
        reconstruction_err=pr_err, reconstruction_tol=PR_TOL,
        max_abs_err_vs_plain_on_card={"forward": fwd_err,
                                      "inverse": inv_err},
        tolerance=INV_ATOL, level_adjoint_rel_err=adj,
        level_adjoint_tol=LEVEL_ADJOINT_TOL, first_call_s=first_s,
        fwd_inv_ms=both_ms, fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms,
        mpix_per_s=mpix / (both_ms / 1e3), fwd_bwd_ms=step_ms,
        fwd_bwd_device_ms=step_dev_ms,
        step_device_busy_share=step_dev_ms / step_ms,
        step_mpix_per_s=mpix / (step_ms / 1e3), peak_mem_bytes=peak,
        step_peak_mem_bytes=step_peak, mem_held_before_bytes=held)
    x.requires_grad_(False)
    return fields


def per_level_main(tt, ops, banded, fb, lev, scat):
    """The main path (MAIN_SHAPE, J=2) under set_operator_matmul(False):
    the per-level stencils against the composed operator products on the
    card, both timed.  Returns (fields, launches per role, calls)."""
    N, C, H, W = MAIN_SHAPE
    x = torch.randn(MAIN_SHAPE,
                    generator=torch.Generator().manual_seed(0)).cuda()
    f = tt.DTCWTForward(J=2, device="cuda")
    i = tt.DTCWTInverse(device="cuda")
    mpix = x.numel() / 1e6
    out = {}
    with torch.no_grad():
        yl, yh = f(x)
        ref = [yl, *yh, i((yl, yh))]
        out["composed_fwd_inv_ms"] = timed_ms(lambda: i(f(x)), reps=10,
                                              batches=15, device_only=False)
        out["composed_fwd_inv_device_ms"] = timed_ms(lambda: i(f(x)),
                                                     reps=10)
        banded.set_operator_matmul(False)
        try:
            torch.cuda.synchronize()
            ops.reset_launches()
            yl, yh = f(x)
            fwd_counts = ops.launch_counts()
            rec = i((yl, yh))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            insts = vector_c2qs(vector_quads(tiles_only(
                inst_counts(ops), "per_level_main", counts),
                "per_level_main", counts), "per_level_main", counts)
            inv_counts = {k: counts[k] - fwd_counts[k] for k in counts}
            _need(fwd_counts, ("dtcwt_filt", "dtcwt_dfilt", "q2c_pack"),
                  "per_level_main", "forward")
            _need(inv_counts, ("dtcwt_filt", "dtcwt_ifilt", "c2q_unpack"),
                  "per_level_main", "inverse")
            err = max(max_err(a, b) for a, b in zip([yl, *yh, rec], ref))
            require(err <= INV_ATOL, f"per_level_main: the per-level path "
                    f"differs from the composed one by {err}")
            pr_err = max_err(rec, x)
            require(pr_err <= PR_TOL, f"per_level_main: reconstruction "
                    f"error {pr_err}")
            out["per_level_fwd_inv_ms"] = timed_ms(
                lambda: i(f(x)), reps=10, batches=15, device_only=False)
            out["per_level_fwd_inv_device_ms"] = timed_ms(
                lambda: i(f(x)), reps=10)
            with PerLevelRecorder(fb, lev, scat) as r:
                i(f(x))
            torch.cuda.synchronize()
        finally:
            banded.set_operator_matmul(None)
    by_role = {"forward": {k: v for k, v in counts.items() if v}}
    fields = dict(
        shape=list(MAIN_SHAPE), J=2, dispatch="set_operator_matmul(False)",
        launches={"forward": fwd_counts, "inverse": inv_counts},
        instantiations=insts,
        max_abs_err_vs_composed_on_card=err, tolerance=INV_ATOL,
        reconstruction_err=pr_err, **out,
        mpix_per_s={"composed": mpix / (out["composed_fwd_inv_ms"] / 1e3),
                    "per_level": mpix / (out["per_level_fwd_inv_ms"]
                                         / 1e3)},
        device_busy_share={
            "composed": out["composed_fwd_inv_device_ms"]
            / out["composed_fwd_inv_ms"],
            "per_level": out["per_level_fwd_inv_device_ms"]
            / out["per_level_fwd_inv_ms"]})
    return fields, by_role, r.calls


def stencil_edge_cases(fb, pool):
    """K8-K11 against their plain versions where the main paths do not
    reach: even-length taps (n + 1 outputs), 'zero' mode, K9 at N = 4, 8,
    12 and in each of its instantiations (the run-time window with
    qshift_c and qshift_32), K10 with qshift_c and qshift_32 (m // 2
    even) and qshift_b (odd), strided views as inputs, writes into and
    accumulation onto a slice.  Returns (calls checked, max error, K9's
    launches by instantiation)."""
    from pytorch_wavelets_tpu_torch.filters import qshift
    gen = torch.Generator().manual_seed(90)
    calls = []

    def band(shape, axis, n):
        s = list(shape)
        s[axis] = n
        wide = torch.randn((s[0], s[1], 3, s[2], s[3] + 5),
                           generator=gen).cuda()
        return wide[:, :, 1, :, 2:2 + s[3]]

    def acc_spec(x, axis, factor, extra):
        """Accumulation onto a column slice of a wider tensor."""
        shape = list(x.shape)
        shape[axis] = shape[axis] * factor + extra
        big = torch.randn((*shape[:3], shape[3] + 4), generator=gen).cuda()
        out = big[..., 2:2 + shape[3]]
        return ("acc", out, out.size(), out.stride())

    for L in (4, 6, 13, 19):
        t = torch.randn(L, generator=gen).numpy() / np.sqrt(L)
        for mode in ("symmetric", "zero"):
            for axis in (2, 3):
                for n in (1, 6, 33):
                    x = band((2, 3, 9, 11), axis, n)
                    calls.append(("dtcwt_filt", "edge",
                                  (x, t, axis, mode, None)))
                    calls.append(("dtcwt_filt", "edge",
                                  (x, t, axis, mode,
                                   acc_spec(x, axis, 1, 1 - L % 2))))
    for name in ("qshift_b", "qshift_c", "qshift_32", "qshift_b_bp"):
        q = qshift(name)
        taps = [fb.prep_taps(q[k]) for k in (0, 1, 4, 5)]
        for highpass in (False, True):
            ha, hb = (taps[3], taps[2]) if highpass else (taps[1], taps[0])
            for axis in (2, 3):
                for n in (4, 8, 12):
                    x = band((2, 3, 8, 12), axis, n)
                    calls.append(("dtcwt_dfilt", "edge",
                                  (x, ha, hb, highpass, axis, None)))
                # K9's other instantiations: aligned rows (float4
                # columns), a transposed view (the row tile's gather)
                shape = [2, 3, 8, 12]
                shape[axis] = 16
                xv = (torch.randn(shape, generator=gen).cuda() if axis == 2
                      else torch.randn(shape[:2] + shape[2:][::-1],
                                       generator=gen).cuda().transpose(2, 3))
                calls.append(("dtcwt_dfilt", "edge",
                              (xv, ha, hb, highpass, axis, None)))
                for n in (2, 6, 10):
                    x = band((2, 3, 6, 8), axis, n)
                    calls.append(("dtcwt_ifilt", "edge",
                                  (x, ha, hb, highpass, axis, None)))
                    calls.append(("dtcwt_ifilt", "edge",
                                  (x, ha, hb, highpass, axis,
                                   acc_spec(x, axis, 2, 0))))
    # K11: the 17-wide edge view x[..., 1:15] (rows at odd offsets) and
    # its every other column, transposed views (strided); aligned rows,
    # rows 8 bytes into a line, odd widths, h = 1, w = 1, a slice along H
    # (vector; the adjoint also at odd offsets)
    x = torch.randn((2, 3, 10, 17), generator=gen).cuda()[..., 1:15]
    calls += [("avg_pool2_fwd", "edge", (x,)),
              ("avg_pool2_bwd", "edge", (x[..., ::2],))]
    wide = torch.randn((2, 3, 12, 22), generator=gen).cuda()
    for v in (wide[..., :16], wide[..., 2:18], wide[..., 2:12],
              wide[:, :, 3:5, :12], wide[..., 4:6], wide[:, :, 2:10, 1:15],
              wide[..., :16].transpose(2, 3), wide[:, :, :1, 2:7],
              wide[..., :7].transpose(2, 3)[..., :1]):
        if v.shape[2] % 2 == 0 and v.shape[3] % 2 == 0:
            calls.append(("avg_pool2_fwd", "edge", (v,)))
        calls.append(("avg_pool2_bwd", "edge", (v,)))
    err = 0.0
    before = dict(fb.dtcwt_dfilt.instantiations)
    pool_before = {k: dict(getattr(pool, k).instantiations) for k in POOLS}
    for call in calls:
        got, want, *_, tol = stencil_call_parts(call, fb, pool)
        ok = (torch.equal(got, want) if tol == "exact"
              else torch.allclose(got, want, **tol))
        require(ok, f"{call[0]} edge case {tuple(call[2][0].shape)} "
                f"disagrees with its plain version by {max_err(got, want)}")
        err = max(err, max_err(got, want))
    torch.cuda.synchronize()
    insts = {i: v - before.get(i, 0)
             for i, v in fb.dtcwt_dfilt.instantiations.items()}
    require(all(insts.get(i) for i in TILE_INSTS),
            f"stencil_edge_cases: a K9 instantiation was not checked: "
            f"{insts}")
    pool_insts = {k: {i: v - pool_before[k][i] for i, v in
                      getattr(pool, k).instantiations.items()}
                  for k in POOLS}
    require(all(all(v.values()) for v in pool_insts.values()),
            f"stencil_edge_cases: a K11 instantiation was not checked: "
            f"{pool_insts}")
    return len(calls), err, insts, pool_insts


# ---------------------------------------------------------------------------
# the SWT paths
# ---------------------------------------------------------------------------

class SwtRecorder(Swapping):
    """For one run of the SWT: swaps the K12 wrappers where the 2-D split
    and the level Function call them, and the K1 / K13 wrappers where the
    least-squares merges call them, for recording ones, which keep each
    call's inputs for replay and tag it with its role ('split', 'merge',
    and their adjoints: the caller sets ``backward`` around the
    gradient)."""

    def __init__(self, afb, dwt):
        self.afb, self.dwt = afb, dwt
        self.calls = []
        self.backward = False

    def swaps(self):
        afb, dwt, calls = self.afb, self.dwt, self.calls
        orig = {n: getattr(afb, n) for n in ("afb1d_atrous_corr",
                                             "afb1d_atrous_adjoint")}
        orig.update({n: getattr(dwt, n) for n in (
            "apply_col", "apply_row", "spec_merge", "spec_split")})

        def rec(name, args):
            role = "split" if name.startswith("afb1d_atrous") else "merge"
            calls.append((name, role + ("'s adjoint" if self.backward
                                        else ""), args))

        def afb1d_atrous_corr(x, h0, h1, mode, axis, d):
            rec("afb1d_atrous_corr", (x, h0, h1, mode, axis % 4, d))
            return orig["afb1d_atrous_corr"](x, h0, h1, mode, axis, d)

        def afb1d_atrous_adjoint(dy, h0, h1, mode, axis, d, n):
            rec("afb1d_atrous_adjoint", (dy, h0, h1, mode, axis % 4, d, n))
            return orig["afb1d_atrous_adjoint"](dy, h0, h1, mode, axis, d, n)

        def apply_col(x, T, out=None, accumulate=True):
            rec("apply_col", (x, T, _out_mode(out, accumulate)))
            return orig["apply_col"](x, T, out, accumulate)

        def apply_row(x, T, out=None, accumulate=True):
            rec("apply_row", (x, T, _out_mode(out, accumulate)))
            return orig["apply_row"](x, T, out, accumulate)

        def spec_merge(A, B, g0, g1, axis):
            rec("spec_merge", (A, B, g0, g1, axis))
            return orig["spec_merge"](A, B, g0, g1, axis)

        def spec_split(Z, g0, g1, axis):
            rec("spec_split", (Z, g0, g1, axis))
            return orig["spec_split"](Z, g0, g1, axis)

        return [(afb, "afb1d_atrous_corr", afb1d_atrous_corr),
                (afb, "afb1d_atrous_adjoint", afb1d_atrous_adjoint),
                (dwt, "apply_col", apply_col), (dwt, "apply_row", apply_row),
                (dwt, "spec_merge", spec_merge),
                (dwt, "spec_split", spec_split)]


def folded(padded, shape, pad_fn):
    """The adjoint of ``pad_fn`` (a padding of a ``shape`` tensor, or a
    tuple of such paddings) applied to ``padded`` (its padded-domain
    result, channels in dim 1 where there are several): how a library
    transpose that ends in the padded domain is checked against a
    kernel's whole adjoint."""
    z = torch.zeros(shape, device=padded.device, requires_grad=True)
    with torch.enable_grad():
        zp = pad_fn(z)
        return torch.autograd.grad(zp, z, padded.reshape(zp.shape))[0]


def swt_call_parts(call, afb, pad, im):
    """One recorded K12/K13 call: (got, want, run, plain, lib, ops, bytes,
    tol, scale), ``scale`` the magnitude of each K13 value's terms (None
    for K12).  ``lib`` is cuDNN's ``F.conv2d`` of the input padded here (not
    timed), both taps stacked, at ``dilation`` (1, d) or (d, 1), for
    ``swt_afb``; ``torch.mul`` of the spectrum by both conjugated filters,
    stacked and broadcast along the axis here (not timed), for
    ``spec_split``; each checked against the plain version.  For the
    adjoint, cuDNN's dilated ``F.conv_transpose2d`` of the cotangent (both
    bands as input channels) into the padded domain, checked by folding it
    back with the pad's adjoint (:func:`folded`, not timed): the fold is
    the one step no single call does.  None for ``spec_merge`` (two
    products and a sum, no single call)."""
    import torch.nn.functional as F
    name, _, args = call
    lib = scale = None
    if name == "afb1d_atrous_corr":
        x, h0, h1, mode, axis, d = args
        got = afb.afb1d_atrous_corr(x, h0, h1, mode, axis, d)
        run = lambda: afb.afb1d_atrous_corr(x, h0, h1, mode,  # noqa: E731
                                            axis, d)
        plain = lambda: afb.afb1d_atrous_corr_plain(          # noqa: E731
            x, h0, h1, mode, axis, d)
        want = plain()
        L = len(h0)
        front, back, _, _ = afb.atrous_plan(x.shape[axis], L, d, mode)
        N, C = x.shape[:2]
        xp = pad.pad1d(x, front, back, axis, mode)
        xp = xp.reshape(N * C, 1, *xp.shape[2:]).contiguous()
        w = torch.tensor(np.stack([h0, h1]), dtype=torch.float32,
                         device=x.device)
        w = w.view(2, 1, 1, L) if axis == 3 else w.view(2, 1, L, 1)
        dil = (1, d) if axis == 3 else (d, 1)
        lib = lambda: F.conv2d(xp, w, dilation=dil)           # noqa: E731
        require(torch.allclose(lib().view_as(want), want, **DWT_TOL),
                "swt_afb: the library yardstick differs from the plain "
                "version")
        ops = 2.0 * L * got.numel()
        nbytes = 4.0 * (x.numel() + got.numel())
        tol = DWT_TOL
    elif name == "afb1d_atrous_adjoint":
        dy, h0, h1, mode, axis, d, n = args
        got = afb.afb1d_atrous_adjoint(dy, h0, h1, mode, axis, d, n)
        run = lambda: afb.afb1d_atrous_adjoint(               # noqa: E731
            dy, h0, h1, mode, axis, d, n)
        plain = lambda: afb.afb1d_atrous_adjoint_plain(       # noqa: E731
            dy, h0, h1, mode, axis, d, n)
        want = plain()
        L = len(h0)
        front, back, _, _ = afb.atrous_plan(n, L, d, mode)
        N, C = dy.shape[:2]
        dyr = dy.reshape(N * C, 2, *dy.shape[3:])   # a copy: not timed
        w = torch.tensor(np.stack([h0, h1]), dtype=torch.float32,
                         device=dy.device)
        w = w.view(2, 1, 1, L) if axis == 3 else w.view(2, 1, L, 1)
        dil = (1, d) if axis == 3 else (d, 1)
        lib = lambda: F.conv_transpose2d(dyr, w, dilation=dil)  # noqa: E731
        require(torch.allclose(folded(
            lib(), got.shape, lambda z: pad.pad1d(z, front, back, axis,
                                                  mode)), want, **DWT_TOL),
                "swt_afb_adjoint: the library yardstick folded back "
                "differs from the plain version")
        ops = 2.0 * len(h0) * dy.numel()
        nbytes = 4.0 * (dy.numel() + got.numel())
        tol = DWT_TOL
    elif name == "spec_merge":
        A, B, g0, g1, axis = args
        got = im.spec_merge(A, B, g0, g1, axis)
        run = lambda: im.spec_merge(A, B, g0, g1, axis)       # noqa: E731
        plain = lambda: im.spec_merge_plain(                  # noqa: E731
            A, B, g0, g1, axis)
        want = plain()
        ops = 14.0 * got.numel()      # two complex products and a sum
        nbytes = 8.0 * (A.numel() + B.numel() + got.numel())
        tol = SPEC_TOL
        scale = (im.spec_merge_plain(A.abs(), B.abs(), g0.abs(), g1.abs(),
                                     axis))
    else:
        Z, g0, g1, axis = args
        got = im.spec_split(Z, g0, g1, axis)
        run = lambda: im.spec_split(Z, g0, g1, axis)          # noqa: E731
        plain = lambda: im.spec_split_plain(Z, g0, g1, axis)  # noqa: E731
        want = plain()
        shape = [2, 1, 1, 1, 1]
        shape[axis + 1] = -1
        gc = torch.stack([g0, g1]).conj().resolve_conj().view(shape)
        zu = Z.unsqueeze(0)
        lib = lambda: torch.mul(zu, gc)                       # noqa: E731
        ops = 6.0 * got.numel()       # a complex product per output value
        nbytes = 8.0 * (Z.numel() + got.numel())
        tol = SPEC_TOL
        scale = im.spec_split_plain(Z.abs(), g0.abs(), g1.abs(), axis)
        require(within(lib(), want, tol, scale),
                "spec_split: the library yardstick differs from the plain "
                "version")
    return got, want, run, plain, lib, ops, nbytes, tol, scale


def swt_adjoints(dwt):
    """The dot-product test <A x, g> = <x, A^T g> on the card of the SWT
    level Function in every mode (db4 at dilation 2 on a strided input)
    and of the least-squares merge in each branch along both axes: the
    dense pinv (256 samples), the FFT merge (2304, circular) and banded
    least squares (2304, 'symmetric').  Returns {function: relative
    error}."""
    gen = torch.Generator(device="cuda").manual_seed(100)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    taps = tuple(dwt._rev(t) for t in dwt.dec_filters(SWT_WAVE))
    out = {}
    for mode in SWT_MODES:
        x = rnd((2, 3, 4, 40, 36))[:, :, 1].requires_grad_()
        y = dwt._AFB2DAtrous.apply(x, taps, mode, 2)
        g = rnd(y.shape)
        gx = torch.autograd.grad(y, x, g)[0]
        out[f"_AFB2DAtrous {mode}"] = adjoint_error([y], [g], [x], [gx])
    pair = tuple(dwt._tup(t) for t in taps[:2])
    for branch, mode, n in (("pinv", "symmetric", 256),
                            ("fft", "periodization", 2304),
                            ("banded", "symmetric", 2304)):
        for axis in (2, 3):
            shape = [1, 2, 6, 8]
            shape[axis] = n
            lo, hi = (rnd(shape).requires_grad_() for _ in range(2))
            z = dwt.ls_merge(lo, hi, pair, 2, axis, mode)
            g = rnd(z.shape)
            grads = torch.autograd.grad(z, [lo, hi], g)
            out[f"_LSMerge {branch} axis {axis}"] = adjoint_error(
                [z], [g], [lo, hi], list(grads))
    return out


def swt_main(tt, ops, afb, dwt):
    """SWTForward(J=3, db4, periodization) -> SWTInverse on SWT_SHAPE:
    counted (the host operators built anew, so that the first call's
    time holds the probes and the pinv SVDs), checked against the CPU
    plain run on the first SWT_CHECK_N images and for perfect
    reconstruction, timed, and one round trip recorded; then the training
    step (the gradient w.r.t. x of sum(rec * G0) + sum_j sum(y_j * G1+j)),
    counted, x.grad checked, the adjoint identities, timed, and its
    backward recorded.  Returns (fields, training fields, launches per
    role, calls, the step)."""
    N, C, H, W = SWT_SHAPE
    kw = dict(wave=SWT_WAVE, mode=SWT_MODE)
    n = SWT_CHECK_N
    x_cpu = torch.randn(SWT_SHAPE, generator=torch.Generator().manual_seed(0))
    cts_cpu = [torch.randn(SWT_SHAPE if k == 0 else (N, C, 4, H, W),
                           generator=torch.Generator().manual_seed(1 + k))
               for k in range(SWT_J + 1)]
    t0 = time.perf_counter()
    with one_cpu_thread():
        fc = tt.SWTForward(J=SWT_J, device="cpu", **kw)
        ic = tt.SWTInverse(device="cpu", **kw)
        xc = x_cpu[:n].clone().requires_grad_()
        ys = fc(xc)
        outs = [ic(ys), *ys]
        ref = [o.detach() for o in outs]
        ref_grad = torch.autograd.grad(outs, xc,
                                       [c[:n] for c in cts_cpu])[0]
    cpu_s = time.perf_counter() - t0
    del ys, outs

    f = tt.SWTForward(J=SWT_J, device="cuda", **kw)
    i = tt.SWTInverse(device="cuda", **kw)
    x = x_cpu.cuda()
    cts = [c.cuda() for c in cts_cpu]
    mpix = x.numel() / 1e6
    for cached in (dwt._iswt_pinv, afb._afb_atrous_matrix):
        cached.cache_clear()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        ys = f(x)
        fwd_counts = ops.launch_counts()
        rec = i(ys)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        copies = copy_counts(ops)
        insts = tiles_only(inst_counts(ops), "swt_main", counts)
        first_s = time.perf_counter() - t0
        inv_counts = {k: counts[k] - fwd_counts[k] for k in counts}
        require(fwd_counts["afb1d_atrous_corr"] > 0
                and inv_counts["apply_col"] > 0
                and inv_counts["apply_row"] > 0,
                f"swt_main: a kernel of the path never launched: forward "
                f"{fwd_counts}, inverse {inv_counts}")
        require(all(bool(torch.isfinite(o).all()) for o in [rec, *ys])
                and tuple(rec.shape) == SWT_SHAPE
                and all(tuple(y.shape) == (N, C, 4, H, W) for y in ys),
                "swt_main: non-finite output or wrong shapes")
        fwd_err = max(max_err(a[:n].cpu(), b) for a, b in zip(ys, ref[1:]))
        inv_err = max_err(rec[:n].cpu(), ref[0])
        pr_err = max_err(rec, x)
        require(fwd_err <= FWD_ATOL and inv_err <= INV_ATOL,
                f"swt_main: GPU differs from the CPU plain run: forward "
                f"{fwd_err}, inverse {inv_err}")
        require(pr_err <= SWT_PR_TOL, f"swt_main: reconstruction error "
                f"{pr_err}")
        del ys, rec
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: i(f(x)), reps=5, batches=10,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: i(f(x)), reps=5, batches=5)
        fwd_ms = timed_ms(lambda: f(x), reps=5, batches=10,
                          device_only=False)
        coeffs = f(x)
        inv_ms = timed_ms(lambda: i(coeffs), reps=5, batches=10,
                          device_only=False)
        del coeffs
        with SwtRecorder(afb, dwt) as r:
            i(f(x))
        torch.cuda.synchronize()
    fields = dict(
        shape=list(SWT_SHAPE), J=SWT_J, wave=SWT_WAVE, mode=SWT_MODE,
        launches={"forward": fwd_counts, "inverse": inv_counts},
        copies=copies, instantiations=insts, checked_images=n,
        max_abs_err_vs_cpu={"forward": fwd_err, "inverse": inv_err},
        tolerance={"forward": FWD_ATOL, "inverse": INV_ATOL},
        reconstruction_err=pr_err, reconstruction_tol=SWT_PR_TOL,
        first_call_s=first_s, fwd_inv_ms=both_ms, fwd_ms=fwd_ms,
        inv_ms=inv_ms, mpix_per_s=mpix / (both_ms / 1e3),
        fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms, peak_mem_bytes=peak,
        mem_held_before_bytes=held, cpu_reference_s=cpu_s)
    calls = r.calls

    x.requires_grad_()

    def step():
        ys = f(x)
        return torch.autograd.grad([i(ys), *ys], x, cts)[0]

    torch.cuda.synchronize()
    ops.reset_launches()
    ys = f(x)
    outs = [i(ys), *ys]
    tf_counts = ops.launch_counts()
    tf_insts = tiles_only(inst_counts(ops), "swt_train", tf_counts)
    ops.reset_launches()
    grad = torch.autograd.grad(outs, x, cts)[0]
    torch.cuda.synchronize()
    tb_counts = ops.launch_counts()
    tb_insts = tiles_only(inst_counts(ops), "swt_train", tb_counts)
    require(all(tf_counts[k] > 0 for k in ("afb1d_atrous_corr", "apply_col",
                                           "apply_row"))
            and all(tb_counts[k] > 0 for k in (
                "afb1d_atrous_adjoint", "apply_col", "apply_row")),
            f"swt_train: a kernel of the path never launched: forward "
            f"{tf_counts}, backward {tb_counts}")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) ==
            SWT_SHAPE, "swt_train: x.grad is not finite or misshapen")
    grad_err = max_err(grad[:n].cpu(), ref_grad)
    require(grad_err <= GRAD_ATOL, f"swt_train: x.grad differs from the "
            f"CPU plain run by {grad_err}")
    del ys, outs, grad
    adj = swt_adjoints(dwt)
    require(all(v <= ADJOINT_TOL for v in adj.values()),
            f"swt_train: adjoint identity off: {adj}")
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=5, batches=10, device_only=False)
    tpeak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=5, batches=5)
    ys = f(x)
    outs = [i(ys), *ys]
    with SwtRecorder(afb, dwt) as r:
        r.backward = True
        torch.autograd.grad(outs, x, cts)
        torch.cuda.synchronize()
    del ys, outs
    calls += r.calls
    by_role = {"split": fwd_counts, "merge": inv_counts,
               "split's adjoint": tb_counts, "merge's adjoint": tb_counts}
    tfields = dict(
        shape=list(SWT_SHAPE), J=SWT_J, wave=SWT_WAVE, mode=SWT_MODE,
        launches={"forward": tf_counts, "backward": tb_counts},
        instantiations={"forward": tf_insts, "backward": tb_insts},
        checked_images=n, max_abs_err_grad_vs_cpu=grad_err,
        tolerance=GRAD_ATOL, adjoint_rel_err=adj, adjoint_tol=ADJOINT_TOL,
        fwd_bwd_ms=step_ms, fwd_bwd_device_ms=step_dev_ms,
        device_busy_share=step_dev_ms / step_ms,
        mpix_per_s=mpix / (step_ms / 1e3), peak_mem_bytes=tpeak,
        mem_held_before_bytes=held)
    return fields, tfields, by_role, calls, step


class StageRecorder(Swapping):
    """Keeps every K12 split and every least-squares merge of one run with
    its output, to check each against the CPU plain version on a crop."""

    def __init__(self, afb, dwt):
        self.afb, self.dwt = afb, dwt
        self.stages = []

    def swaps(self):
        split, merge = self.afb.afb1d_atrous_corr, self.dwt.ls_merge

        def afb1d_atrous_corr(x, h0, h1, mode, axis, d):
            y = split(x, h0, h1, mode, axis, d)
            self.stages.append(("split", (x, h0, h1, mode, axis % 4, d), y))
            return y

        def ls_merge(lo, hi, taps, d, axis, mode):
            z = merge(lo, hi, taps, d, axis, mode)
            self.stages.append(("merge", (lo, hi, taps, d, axis, mode), z))
            return z
        return [(self.afb, "afb1d_atrous_corr", afb1d_atrous_corr),
                (self.dwt, "ls_merge", ls_merge)]


def check_stages_on_crops(stages, afb, dwt):
    """Each recorded stage against the CPU plain version on SWT_CROP lines
    across the axis it filters (a split or merge along H works per column,
    along W per row, so the crop is exact).  Returns the largest error of
    each kind."""
    errs = {"split": 0.0, "merge": 0.0}
    for kind, args, out in stages:
        axis = args[4]
        other = 5 - axis
        k0 = max((args[0].shape[other] - SWT_CROP) // 2, 0)

        def crop(t, dim=other):
            return t.narrow(dim, k0, min(SWT_CROP, t.shape[dim])).cpu()
        with one_cpu_thread():
            if kind == "split":
                x, h0, h1, mode, _, d = args
                want = afb.afb1d_atrous_corr_plain(crop(x), h0, h1, mode,
                                                   axis, d)
                got = crop(out, other + 1)
            else:
                lo, hi, taps, d, _, mode = args
                want = dwt.ls_merge(crop(lo), crop(hi), taps, d, axis, mode)
                got = crop(out)
        errs[kind] = max(errs[kind], max_err(got, want))
    return errs


def swt_long(tt, ops, afb, dwt, mode, shape, replay_calls):
    """SWTForward(J=2, db4) -> SWTInverse on ``shape``, axes past the dense
    pinv's 2048 samples: the FFT merge ('periodization': cuFFT + K13) or
    banded least squares ('symmetric': K1 with T^T, then the dense G^-1),
    counted (first call: the host probes and Cholesky solves), every
    stage checked against the CPU plain version on a crop, perfect
    reconstruction, the round trip and a gradient step timed, the round
    trip profiled (device time by kernel: cuFFT's share); one round
    trip and one step's backward recorded and handed to
    ``replay_calls(calls, launches per role, label)``.  Returns the
    fields."""
    gen = torch.Generator(device="cuda")
    x = torch.randn(shape, generator=gen.manual_seed(0), device="cuda")
    f = tt.SWTForward(J=SWT_LONG_J, wave=SWT_WAVE, mode=mode, device="cuda")
    i = tt.SWTInverse(wave=SWT_WAVE, mode=mode, device="cuda")
    mpix = x.numel() / 1e6
    label = f"SWT J={SWT_LONG_J} {mode} {shape_str(shape)}"
    fft = mode != "symmetric"
    merge_kernels = ("spec_merge",) if fft else ("apply_col", "apply_row")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        with StageRecorder(afb, dwt) as st:
            ys = f(x)
            fwd_counts = ops.launch_counts()
            rec = i(ys)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        insts = stream_specs(tiles_only(inst_counts(ops), f"swt_long {mode}",
                                        counts), f"swt_long {mode}", counts)
        first_s = time.perf_counter() - t0
        inv_counts = {k: counts[k] - fwd_counts[k] for k in counts}
        require(fwd_counts["afb1d_atrous_corr"] > 0
                and all(inv_counts[k] > 0 for k in merge_kernels),
                f"swt_long {mode}: a kernel of the path never launched: "
                f"forward {fwd_counts}, inverse {inv_counts}")
        require(all(bool(torch.isfinite(o).all()) for o in [rec, *ys])
                and tuple(rec.shape) == shape,
                f"swt_long {mode}: non-finite output or wrong shape")
        pr_err = max_err(rec, x)
        require(pr_err <= SWT_LONG_PR_TOL, f"swt_long {mode}: "
                f"reconstruction error {pr_err}")
        t0 = time.perf_counter()
        crop_err = check_stages_on_crops(st.stages, afb, dwt)
        crop_s = time.perf_counter() - t0
        require(crop_err["split"] <= FWD_ATOL
                and crop_err["merge"] <= INV_ATOL,
                f"swt_long {mode}: the card differs from the CPU plain run "
                f"on crops: {crop_err}")
        del st, ys, rec
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: i(f(x)), reps=2, batches=3,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: i(f(x)), reps=2, batches=3)
        with SwtRecorder(afb, dwt) as r:
            i(f(x))
        torch.cuda.synchronize()
        # device time by kernel: cuFFT's share of the FFT merges
        prof = profile(lambda: i(f(x)), 2)
    replay_calls(r.calls, {"split": fwd_counts, "merge": inv_counts},
                 label + " round trip")
    del r
    cts = [torch.randn(t.shape, generator=gen.manual_seed(1 + k),
                       device="cuda")
           for k, t in enumerate([x] + [x.unsqueeze(2).expand(
               -1, -1, 4, -1, -1)] * SWT_LONG_J)]
    xg = x.requires_grad_()

    def step_outs():
        ys = f(xg)
        return [i(ys), *ys]

    def step():
        return torch.autograd.grad(step_outs(), xg, cts)[0]

    torch.cuda.synchronize()
    ops.reset_launches()
    outs = step_outs()
    torch.cuda.synchronize()
    step_fwd_counts = ops.launch_counts()
    step_fwd_insts = stream_specs(tiles_only(
        inst_counts(ops), f"swt_long {mode}", step_fwd_counts),
        f"swt_long {mode}", step_fwd_counts)
    ops.reset_launches()
    grad = torch.autograd.grad(outs, xg, cts)[0]
    torch.cuda.synchronize()
    step_bwd_counts = ops.launch_counts()
    step_bwd_insts = stream_specs(tiles_only(
        inst_counts(ops), f"swt_long {mode}", step_bwd_counts),
        f"swt_long {mode}", step_bwd_counts)
    del outs
    adj_kernels = ("spec_split",) if fft else ("apply_col", "apply_row")
    require(step_bwd_counts["afb1d_atrous_adjoint"] > 0
            and all(step_bwd_counts[k] > 0 for k in adj_kernels),
            f"swt_long {mode}: a kernel of the step's backward never "
            f"launched: {step_bwd_counts}")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) == shape,
            f"swt_long {mode}: x.grad not finite or misshapen")
    del grad
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=2, batches=3, device_only=False)
    step_peak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=2, batches=3)
    outs = step_outs()
    with SwtRecorder(afb, dwt) as r:
        r.backward = True
        torch.autograd.grad(outs, xg, cts)
    torch.cuda.synchronize()
    del outs, cts
    replay_calls(r.calls, {"split's adjoint": step_bwd_counts,
                           "merge's adjoint": step_bwd_counts},
                 label + " step")
    del r
    x.requires_grad_(False)
    return dict(
        shape=list(shape), J=SWT_LONG_J, wave=SWT_WAVE, mode=mode,
        merge="FFT (cuFFT + K13)" if fft else
        "banded least squares (K1: T^T, then G^-1)",
        launches={"forward": fwd_counts, "inverse": inv_counts,
                  "step_forward": step_fwd_counts,
                  "step_backward": step_bwd_counts},
        instantiations={"round_trip": insts, "step_forward": step_fwd_insts,
                        "step_backward": step_bwd_insts},
        reconstruction_err=pr_err, reconstruction_tol=SWT_LONG_PR_TOL,
        max_abs_err_vs_cpu_on_crops=crop_err, crop_lines=SWT_CROP,
        tolerance={"split": FWD_ATOL, "merge": INV_ATOL},
        cpu_crop_check_s=crop_s, first_call_s=first_s, fwd_inv_ms=both_ms,
        fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms,
        mpix_per_s=mpix / (both_ms / 1e3), fwd_bwd_ms=step_ms,
        fwd_bwd_device_ms=step_dev_ms,
        step_device_busy_share=step_dev_ms / step_ms,
        peak_mem_bytes=peak, step_peak_mem_bytes=step_peak,
        mem_held_before_bytes=held,
        # PyTorch's layout copies and cuFFT around the merges, device us a
        # round trip (the profile's kinds)
        round_trip_copies_and_cufft_us=prof["device_us_per_iter_by_kind"],
        round_trip_profile=prof)


def swt_edge_cases(afb, pad, im):
    """K12's split and adjoint and K13's merge and split against their
    plain versions where the main paths do not reach: every mode along
    both axes, db1, db4 and bior2.4 and db20 (40 taps at dilation 4 on a
    7x9 image: pads of several axis lengths), 3 taps at dilation 3 (odd
    L d: one output fewer), odd sizes, strided inputs (the LL band of a
    stack, every other plane of a cotangent), aligned rows and transposed
    views (each of K12's instantiations, both entries, its adjoint's
    band); K13 on odd and even lengths along both axes, and each of its
    walks (stream on rfft spectra, offset by 8 bytes and stored along the
    other axis; strided on mixed layouts and a broadcast input), both
    entries.  Returns (calls checked,
    max error, K12's and K13's launches by instantiation)."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    gen = torch.Generator().manual_seed(110)
    calls = []
    for name, d, shape in (("db1", 1, (2, 3, 9, 16)),
                           ("db4", 2, (2, 3, 13, 11)),
                           ("bior2.4", 4, (1, 2, 33, 17)),
                           ("db20", 4, (2, 3, 7, 9)),
                           ("3 taps", 3, (2, 3, 10, 14))):
        if name == "3 taps":
            h0, h1 = torch.randn((2, 3), generator=gen,
                                 dtype=torch.float64).numpy() / np.sqrt(3)
        else:
            w = wavelet(name)
            h0, h1 = (afb.as_taps(t)[::-1] for t in (w.dec_lo, w.dec_hi))
        for mode in SWT_MODES:
            for axis in (2, 3):
                x = torch.randn((shape[0], shape[1], 4, *shape[2:]),
                                generator=gen).cuda()[:, :, 0]
                calls.append(("afb1d_atrous_corr", "edge",
                              (x, h0, h1, mode, axis, d)))
                gshape = [shape[0], 2 * shape[1], 2, *shape[2:]]
                gshape[axis + 1] = afb.atrous_plan(shape[axis], len(h0), d,
                                                   mode)[3]
                g = torch.randn(gshape, generator=gen).cuda()[:, 1::2]
                calls.append(("afb1d_atrous_adjoint", "edge",
                              (g, h0, h1, mode, axis, d, shape[axis])))
                # aligned rows (float4 columns) or a transposed view (the
                # row tile's gather), input and cotangent
                other = 12 if axis == 2 else shape[2]
                xv = torch.randn((shape[0], shape[1], shape[axis], other)
                                 if axis == 2 else
                                 (shape[0], shape[1], shape[3], other),
                                 generator=gen).cuda()
                if axis == 3:
                    xv = xv.transpose(2, 3)
                calls.append(("afb1d_atrous_corr", "edge",
                              (xv, h0, h1, mode, axis, d)))
                m = gshape[axis + 1]
                gv = torch.randn((shape[0], shape[1], 2, m, other),
                                 generator=gen).cuda()
                if axis == 3:
                    gv = gv.transpose(3, 4)
                calls.append(("afb1d_atrous_adjoint", "edge",
                              (gv, h0, h1, mode, axis, d, shape[axis])))
    for n in (9, 10, 4097):
        for axis in (2, 3):
            shape = [2, 3, 5, 6]
            shape[axis] = n
            A, B = (torch.fft.rfft(torch.randn(shape, generator=gen).cuda(),
                                   dim=axis) for _ in range(2))
            g0, g1 = (torch.randn(n // 2 + 1, dtype=torch.complex64,
                                  generator=gen).cuda() for _ in range(2))
            calls.append(("spec_merge", "edge", (A, B, g0, g1, axis)))
            calls.append(("spec_split", "edge", (A, g0, g1, axis)))
            for A2, B2 in spec_views(A, B):
                calls.append(("spec_merge", "edge", (A2, B2, g0, g1, axis)))
                calls.append(("spec_split", "edge", (A2, g0, g1, axis)))
    err = 0.0
    wrappers = {k: getattr(afb, k) for k in SWT_KERNELS[:2]}
    wrappers.update(spec_merge=im.spec_merge, spec_split=im.spec_split)
    before = {k: dict(w.instantiations) for k, w in wrappers.items()}
    for call in calls:
        got, want, *_, tol, scale = swt_call_parts(call, afb, pad, im)
        require(within(got, want, tol, scale),
                f"{call[0]} edge case {tuple(call[2][0].shape)} "
                f"{call[2][3:]} disagrees with its plain version by "
                f"{max_err(got, want)}")
        err = max(err, max_err(got, want))
    torch.cuda.synchronize()
    insts = {k: {i: v - before[k].get(i, 0)
                 for i, v in w.instantiations.items()}
             for k, w in wrappers.items()}
    require(all(insts[k].get(i) for k in SWT_KERNELS[:2]
                for i in TILE_INSTS)
            and insts["afb1d_atrous_adjoint"].get("band"),
            f"swt_edge_cases: a K12 instantiation was not checked: {insts}")
    require(all(insts[k].get(w) for k in ("spec_merge", "spec_split")
                for w in im.SPEC_WALKS),
            f"swt_edge_cases: a K13 walk was not checked: {insts}")
    return len(calls), err, insts


def spec_views(A, B):
    """(A', B') of K13's edge cases from the rfft spectra A, B (the
    frequency axis at stride 1): the same values 8 bytes further into a
    buffer (every row's pairs shifted), stored along the other axis (a
    row's filter pair constant), and of mixed layouts and a broadcast one
    (the strided walk)."""
    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = torch.as_strided(buf, t.shape, t.stride(), 1)
        v.copy_(t)
        return v

    def other(t):
        if t.stride(3) == 1:
            return t.transpose(2, 3).contiguous().transpose(2, 3)
        return t.contiguous()
    bcast = A.narrow(2, 0, 1).expand(A.shape)
    return [(offset(A), offset(B)), (other(A), other(B)), (A, other(B)),
            (bcast, bcast.contiguous())]


# ---------------------------------------------------------------------------
# the Selesnick DTCWT, the non-separable filterbanks and the à trous merge
# ---------------------------------------------------------------------------

class NonsepRecorder(Swapping):
    """For one run: swaps the K14/K15/K16 wrappers where the autograd
    Functions call them for recording ones, which keep each call's
    inputs for replay and tag it 'forward' or 'backward' (the caller
    sets ``backward`` around the gradient)."""

    def __init__(self, nonsep, afb):
        self.nonsep, self.afb = nonsep, afb
        self.calls = []
        self.backward = False

    def swaps(self):
        out = []
        for module, names in ((self.nonsep, NONSEP_KERNELS[:4]),
                              (self.afb, NONSEP_KERNELS[4:])):
            for name in names:
                out.append((module, name, self._wrap(name,
                                                     getattr(module, name))))
        return out

    def _wrap(self, name, fn):
        def wrapped(*args):
            self.calls.append((name, "backward" if self.backward
                               else "forward", args))
            return fn(*args)
        return wrapped


def _padded(x, src, dims):
    """``x`` read at the source indices ``src`` (one numpy array per dim of
    ``dims``, -1 for a zero): the padded copy a library call takes."""
    for idx, dim in zip(src, dims):
        y = torch.index_select(x, dim, torch.as_tensor(
            np.clip(idx, 0, None), device=x.device))
        if (idx < 0).any():
            shape = [1] * y.ndim
            shape[dim] = -1
            y = y * torch.as_tensor(idx >= 0, device=x.device,
                                    dtype=x.dtype).view(shape)
        x = y
    return x


@functools.lru_cache(maxsize=None)
def sfb_atrous_matrix(g0, g1, mode, dilation, n):
    """The (n, 2n) operator of the à trous merge on concat(lo, hi) along
    an axis (convolution-order tap tuples), probed on the host from
    ``sfb1d_atrous_conv_plain``: the JAX package's device route for the
    merge (``_sfb_atrous_matrix`` l.322), K1's operand where K16's
    library time is taken."""
    from pytorch_wavelets_tpu_torch.ops import afb_sfb, banded

    def direct(m):
        def fn(I):
            return afb_sfb.sfb1d_atrous_conv_plain(
                I[:, :, :m], I[:, :, m:], np.asarray(g0), np.asarray(g1),
                mode, 2, dilation)
        return banded.probe_op(fn, 2 * m)

    return banded.synthesized_or_probe(
        direct, n, afb_sfb._ext_ns(len(g0), dilation), 1, 2, (1, 1))


def nonsep_call_parts(call, banded):
    """One recorded K14/K15/K16 call: (got, want, run, plain, lib, ops,
    bytes, extra).  ``lib``: for K14 cuDNN's ``F.conv2d`` of the input padded
    here (not timed), the K PSFs as output channels, stride 2; for K15
    ``F.conv_transpose2d`` of the bands as 4 input channels, stride 2,
    outside 'periodization' (whose wrap-add and roll no single call
    does), and for its adjoint ``F.conv2d`` of the cotangent padded here
    by the crop, stride 2; for K16 ``torch.matmul`` of the probed operator
    of the merge (:func:`sfb_atrous_matrix`, the JAX package's device
    route) and (lo, hi) concatenated here, and for its adjoint
    ``torch.matmul`` of the operator's transpose and the cotangent (split
    into lo and hi here, not timed).  For K14's adjoint (on the
    non-separable plan) ``F.conv_transpose2d`` of the cotangent, the K
    PSFs as input channels, stride 2: it ends in the padded domain, and
    is checked folded back by the pad's adjoint (:func:`folded`, not
    timed).  Each other library result is checked against the plain
    version as it is.  ``extra``: {name: callable} of other yardsticks
    timed beside them, K16's: K1 on the probed operator
    (``k1_on_operator_ms``), and for its adjoint the dilated
    ``F.conv_transpose2d`` of the cotangent into lo and hi's padded
    domain (``partial_conv_transpose_ms``, checked folded back)."""
    import torch.nn.functional as F
    from pytorch_wavelets_tpu_torch.ops import afb_sfb, nonsep
    name, _, args = call
    kern = getattr(nonsep if name.startswith("nonsep") else afb_sfb, name)
    plainf = getattr(nonsep if name.startswith("nonsep") else afb_sfb,
                     name + "_plain")
    got, want = kern(*args), plainf(*args)
    run = lambda: kern(*args)                                 # noqa: E731
    plain = lambda: plainf(*args)                             # noqa: E731
    lib = None
    lib_checked = False     # checked folded back instead
    extra = {}
    if name == "nonsep_afb":
        x, f, mode = args
        K, Ly, Lx = np.shape(f)
        N, C, H, W = x.shape
        src = []
        for n, L, m in ((H, Ly, got.shape[3]), (W, Lx, got.shape[4])):
            _, front, code, per, shift = nonsep.afb_axis_plan(n, L, mode)
            src.append(nonsep.afb_axis_src(
                n, front, code, per, shift,
                np.arange(2 * (m - 1) + L) - front))
        xp = _padded(x, src, (2, 3)).reshape(N * C, 1, *[len(i) for i in
                                                         src])
        w = torch.as_tensor(np.ascontiguousarray(f)[:, None],
                            dtype=torch.float32, device=x.device)
        lib = lambda: F.conv2d(xp, w, stride=2)               # noqa: E731
        ops = 2.0 * Ly * Lx * got.numel()
        nbytes = 4.0 * (x.numel() + got.numel())
    elif name == "nonsep_afb_adjoint":
        dy, f, mode, H, W = args[:5]
        if not (args[5:] and args[5]):    # the non-separable plan
            K, Ly, Lx = np.shape(f)
            N, C, _, my, mx = dy.shape
            src = []
            for n, L, m in ((H, Ly, my), (W, Lx, mx)):
                _, front, code, per, shift = nonsep.afb_axis_plan(n, L, mode)
                src.append(nonsep.afb_axis_src(
                    n, front, code, per, shift,
                    np.arange(2 * (m - 1) + L) - front))
            dyr = dy.reshape(N * C, K, my, mx)    # a copy if strided
            w = torch.as_tensor(np.ascontiguousarray(f)[:, None],
                                dtype=torch.float32, device=dy.device)
            lib = lambda: F.conv_transpose2d(dyr, w,          # noqa: E731
                                             stride=2)
            require(torch.allclose(folded(
                lib(), got.shape, lambda z: _padded(z, src, (2, 3))),
                want, **NONSEP_TOL),
                "nonsep_afb_adjoint: the library yardstick folded back "
                "differs from the plain version")
            lib_checked = True
        ops = 2.0 * np.size(f) / len(f) * dy.numel()
        nbytes = 4.0 * (dy.numel() + got.numel())
    elif name == "nonsep_sfb":
        c, f, mode = args
        N, C, _, Ny, Nx = c.shape
        Ly, Lx = np.shape(f)[1:]
        if mode not in ("per", "periodization"):
            cr = c.reshape(N * C, 4, Ny, Nx)   # a copy if strided: not timed
            w = torch.as_tensor(np.ascontiguousarray(f)[:, None],
                                dtype=torch.float32, device=c.device)
            lib = lambda: F.conv_transpose2d(                 # noqa: E731
                cr, w, stride=2, padding=(Ly - 2, Lx - 2))
        ops = 2.0 * Ly * Lx * c.numel()
        nbytes = 4.0 * (c.numel() + got.numel())
    elif name == "nonsep_sfb_adjoint":
        dy, f, mode = args[:3]
        Ly, Lx = np.shape(f)[1:]
        N, C = dy.shape[:2]
        if mode not in ("per", "periodization"):
            s0, s1 = Ly - 2, Lx - 2      # the crop's offset, then L - 2
            dp = F.pad(dy, (s1, Lx - 2, s0, Ly - 2)).reshape(
                N * C, 1, dy.shape[2] + 2 * s0, dy.shape[3] + 2 * s1)
            w = torch.as_tensor(np.ascontiguousarray(f)[:, None],
                                dtype=torch.float32, device=dy.device)
            lib = lambda: F.conv2d(dp, w, stride=2)           # noqa: E731
        ops = 2.0 * Ly * Lx * got.numel()
        nbytes = 4.0 * (dy.numel() + got.numel())
    elif name == "sfb1d_atrous_conv":
        lo, hi, g0, g1, mode, axis, d = args
        T = sfb_atrous_matrix(tuple(g0), tuple(g1), mode, d,
                              lo.shape[axis])
        op = banded.Operator(np.asarray(T), lo.device)
        Tt = torch.as_tensor(np.asarray(T), dtype=torch.float32,
                             device=lo.device)
        both = torch.cat([lo, hi], dim=axis)
        apply = banded.apply_col if axis == 2 else banded.apply_row
        if axis == 2:
            lib = lambda: torch.matmul(Tt, both)              # noqa: E731
        else:
            lib = lambda: torch.matmul(both, Tt.t())          # noqa: E731
        extra = {"k1_on_operator_ms": lambda: apply(both, op)}
        require(torch.allclose(apply(both, op), want, **NONSEP_TOL),
                "swt_sfb: K1 on the probed operator differs from the "
                "plain version")
        ops = 4.0 * len(g0) * got.numel()
        nbytes = 4.0 * (lo.numel() + hi.numel() + got.numel())
    else:
        dy, g0, g1, mode, axis, d = args
        L = len(g0)
        front, back, _, _ = afb_sfb.atrous_merge_plan(dy.shape[axis], L, d,
                                                      mode)
        N, C, H, W = dy.shape
        dyr = dy.reshape(N * C, 1, H, W)
        w = 0.5 * torch.as_tensor(
            np.stack([np.asarray(g0)[::-1], np.asarray(g1)[::-1]]),
            dtype=torch.float32, device=dy.device)
        w = w.view(1, 2, 1, L) if axis == 3 else w.view(1, 2, L, 1)
        dil = (1, d) if axis == 3 else (d, 1)
        partial = lambda: F.conv_transpose2d(                 # noqa: E731
            dyr, w, dilation=dil)
        from pytorch_wavelets_tpu_torch.ops.pad import pad1d
        both = folded(partial(), (N * C, 2, H, W),   # lo and hi as channels
                      lambda z: pad1d(z, front, back, axis, mode))
        require(torch.allclose(both.reshape(want.shape), want,
                               **NONSEP_TOL),
                "swt_sfb_adjoint: the partial transposed convolution "
                "folded back differs from the plain version")
        extra = {"partial_conv_transpose_ms": partial}
        n = dy.shape[axis]
        Tt = torch.as_tensor(np.asarray(sfb_atrous_matrix(
            tuple(g0), tuple(g1), mode, d, n)), dtype=torch.float32,
            device=dy.device)
        if axis == 2:
            lib = lambda: torch.matmul(Tt.t(), dy)            # noqa: E731
        else:
            lib = lambda: torch.matmul(dy, Tt)                # noqa: E731
        lo_hi = lib()
        require(torch.allclose(torch.stack(
            [lo_hi.narrow(axis, 0, n), lo_hi.narrow(axis, n, n)], dim=2),
            want, **NONSEP_TOL),
            "swt_sfb_adjoint: torch.matmul by the probed operator's "
            "transpose differs from the plain version")
        lib_checked = True
        ops = 4.0 * len(g0) * dy.numel()
        nbytes = 4.0 * (dy.numel() + got.numel())
    if lib is not None and not lib_checked:   # the same function
        require(torch.allclose(lib().reshape(want.shape), want,
                               **NONSEP_TOL),
                f"{name}: the library yardstick differs from the plain "
                f"version")
    return got, want, run, plain, lib, ops, nbytes, extra


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def alt_main(ops, afb, dwt, alt):
    """DTCWTForward2(farras, qshift_a, J=3, symmetric) -> DTCWTInverse2 on
    ALT_SHAPE: counted (K6 forward, K7 inverse), checked against the CPU
    plain run on the first ALT_CHECK_N images and for perfect
    reconstruction, timed, one round trip recorded; then the training
    step (the gradient w.r.t. x of sum(rec * G0) + sum(lows * G1) +
    sum_j sum(yh_j * G2+j)), counted, x.grad checked, timed, its backward
    recorded.  Returns (fields, training fields, launches per role,
    calls, the step)."""
    n = ALT_CHECK_N
    x_cpu = torch.randn(ALT_SHAPE, generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    with one_cpu_thread():
        fc = alt.DTCWTForward2(J=ALT_J, device="cpu", **ALT_KW)
        ic = alt.DTCWTInverse2(device="cpu", **ALT_KW)
        xc = x_cpu[:n].clone().requires_grad_()
        coeffs = fc(xc)
        outs = [ic(coeffs), *_flat(coeffs)]
        gen = torch.Generator(device="cuda").manual_seed(1)
        cts = [torch.randn((ALT_SHAPE[0], *o.shape[1:]), generator=gen,
                           device="cuda") for o in outs]
        ref = [o.detach() for o in outs]
        ref_grad = torch.autograd.grad(outs, xc, [c[:n].cpu() for c in cts])[0]
    cpu_s = time.perf_counter() - t0
    del coeffs, outs

    f = alt.DTCWTForward2(J=ALT_J, device="cuda", **ALT_KW)
    i = alt.DTCWTInverse2(device="cuda", **ALT_KW)
    x = x_cpu.cuda()
    mpix = x.numel() / 1e6
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.reset_launches()
        coeffs = f(x)
        fwd_counts = ops.launch_counts()
        rec = i(coeffs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        first_s = time.perf_counter() - t0
        insts = tiles_only(inst_counts(ops), "alt_main", counts)
        inv_counts = {k: counts[k] - fwd_counts[k] for k in counts}
        require(fwd_counts["afb1d_corr"] > 0 and inv_counts["sfb1d_conv"] > 0,
                f"alt_main: a kernel of the path never launched: forward "
                f"{fwd_counts}, inverse {inv_counts}")
        outs = _flat(coeffs)
        require(all(bool(torch.isfinite(o).all()) for o in outs + [rec])
                and tuple(rec.shape) == ALT_SHAPE and all(
                    tuple(a.shape[1:]) == tuple(b.shape[1:])
                    for a, b in zip(outs, ref[1:])),
                "alt_main: non-finite output or wrong shapes")
        fwd_err = max(max_err(a[:n].cpu(), b) for a, b in zip(outs, ref[1:]))
        inv_err = max_err(rec[:n].cpu(), ref[0])
        pr_err = max_err(rec, x)
        require(fwd_err <= ALT_TOL and inv_err <= ALT_TOL,
                f"alt_main: GPU differs from the CPU plain run: forward "
                f"{fwd_err}, inverse {inv_err}")
        require(pr_err <= PR_TOL, f"alt_main: reconstruction error {pr_err}")
        del coeffs, rec, outs
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        both_ms = timed_ms(lambda: i(f(x)), reps=5, batches=10,
                           device_only=False)
        peak = torch.cuda.max_memory_allocated()
        both_dev_ms = timed_ms(lambda: i(f(x)), reps=5, batches=5)
        fwd_ms = timed_ms(lambda: f(x), reps=5, batches=10,
                          device_only=False)
        coeffs = f(x)
        inv_ms = timed_ms(lambda: i(coeffs), reps=5, batches=10,
                          device_only=False)
        del coeffs
        with DwtRecorder(afb, dwt) as r:
            i(f(x))
        torch.cuda.synchronize()
    fields = dict(
        shape=list(ALT_SHAPE), J=ALT_J, **ALT_KW,
        launches={"forward": fwd_counts, "inverse": inv_counts},
        instantiations=insts, checked_images=n,
        max_abs_err_vs_cpu={"forward": fwd_err, "inverse": inv_err},
        tolerance=ALT_TOL, reconstruction_err=pr_err,
        reconstruction_tol=PR_TOL, first_call_s=first_s,
        fwd_inv_ms=both_ms, fwd_ms=fwd_ms, inv_ms=inv_ms,
        mpix_per_s=mpix / (both_ms / 1e3), fwd_inv_device_ms=both_dev_ms,
        device_busy_share=both_dev_ms / both_ms, peak_mem_bytes=peak,
        mem_held_before_bytes=held, cpu_reference_s=cpu_s)
    calls = r.calls

    x.requires_grad_()

    def step():
        coeffs = f(x)
        return torch.autograd.grad([i(coeffs), *_flat(coeffs)], x, cts)[0]

    torch.cuda.synchronize()
    ops.reset_launches()
    coeffs = f(x)
    outs = [i(coeffs), *_flat(coeffs)]
    tf_counts = ops.launch_counts()
    tf_insts = tiles_only(inst_counts(ops), "alt_train", tf_counts)
    ops.reset_launches()
    grad = torch.autograd.grad(outs, x, cts)[0]
    torch.cuda.synchronize()
    tb_counts = ops.launch_counts()
    tb_insts = tiles_only(inst_counts(ops), "alt_train", tb_counts)
    require(all(tf_counts[k] > 0 and tb_counts[k] > 0 for k in DWT_KERNELS),
            f"alt_train: a kernel of the path never launched: forward "
            f"{tf_counts}, backward {tb_counts}")
    require(bool(torch.isfinite(grad).all()) and tuple(grad.shape) ==
            ALT_SHAPE, "alt_train: x.grad is not finite or misshapen")
    grad_err = max_err(grad[:n].cpu(), ref_grad)
    require(grad_err <= GRAD_ATOL, f"alt_train: x.grad differs from the "
            f"CPU plain run by {grad_err}")
    del coeffs, outs, grad
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = timed_ms(step, reps=3, batches=10, device_only=False)
    tpeak = torch.cuda.max_memory_allocated()
    step_dev_ms = timed_ms(step, reps=3, batches=5)
    coeffs = f(x)
    outs = [i(coeffs), *_flat(coeffs)]
    with DwtRecorder(afb, dwt) as r:
        r.backward = True
        torch.autograd.grad(outs, x, cts)
        torch.cuda.synchronize()
    del coeffs, outs
    calls += r.calls
    by_role = {"analysis": fwd_counts["afb1d_corr"],
               "synthesis": inv_counts["sfb1d_conv"],
               "synthesis's backward": tb_counts["afb1d_corr"],
               "analysis's backward": tb_counts["sfb1d_conv"]}
    tfields = dict(
        shape=list(ALT_SHAPE), J=ALT_J, **ALT_KW,
        launches={"forward": tf_counts, "backward": tb_counts},
        instantiations={"forward": tf_insts, "backward": tb_insts},
        checked_images=n, max_abs_err_grad_vs_cpu=grad_err,
        tolerance=GRAD_ATOL, fwd_bwd_ms=step_ms,
        fwd_bwd_device_ms=step_dev_ms,
        device_busy_share=step_dev_ms / step_ms,
        mpix_per_s=mpix / (step_ms / 1e3), peak_mem_bytes=tpeak,
        mem_held_before_bytes=held)
    return fields, tfields, by_role, calls, step


def cplxdual_mag(ops, alt):
    """cplxdual2d(x, J=3, mode='periodization', mag=True) on ALT_SHAPE:
    counted, checked against the CPU plain run on the first ALT_CHECK_N
    images, timed."""
    n = ALT_CHECK_N
    kw = dict(J=ALT_J, mode="periodization", mag=True)
    x_cpu = torch.randn(ALT_SHAPE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        with one_cpu_thread():
            ref = _flat(alt.cplxdual2d(x_cpu[:n], **kw))
        x = x_cpu.cuda()
        torch.cuda.synchronize()
        ops.reset_launches()
        out = _flat(alt.cplxdual2d(x, **kw))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        require(counts["afb1d_corr"] > 0, f"cplxdual_mag: K6 never "
                f"launched: {counts}")
        require(all(bool(torch.isfinite(o).all()) for o in out) and all(
            tuple(a.shape[1:]) == tuple(b.shape[1:]) for a, b in
            zip(out, ref)), "cplxdual_mag: non-finite output or wrong shapes")
        err = max(max_err(a[:n].cpu(), b) for a, b in zip(out, ref))
        require(err <= ALT_TOL, f"cplxdual_mag: GPU differs from the CPU "
                f"plain run by {err}")
        del out
        ms = timed_ms(lambda: alt.cplxdual2d(x, **kw), reps=5, batches=10,
                      device_only=False)
        dev_ms = timed_ms(lambda: alt.cplxdual2d(x, **kw), reps=5,
                          batches=5)
    return dict(shape=list(ALT_SHAPE), **kw, launches=counts,
                checked_images=n, max_abs_err_vs_cpu=err, tolerance=ALT_TOL,
                fwd_ms=ms, fwd_device_ms=dev_ms,
                device_busy_share=dev_ms / ms,
                mpix_per_s=x.numel() / 1e6 / (ms / 1e3))


def quad_nonsep(ops, nonsep, afb, alt):
    """quad_afb2d_nonsep (K14, K = 16 PSFs of 10x10) against the
    separable quad_afb2d (K6) on ALT_SHAPE in QUAD_MODE: both counted,
    agreeing on the card, timed; the K14 call recorded.  Returns
    (fields, launches per role, calls)."""
    from pytorch_wavelets_tpu_torch.filters import qshift
    h0a, h0b, _, _, h1a, h1b, _, _ = qshift("qshift_a")
    bank = (h0a, h1a, h0b, h1b)
    x = torch.randn(ALT_SHAPE, generator=torch.Generator().manual_seed(0))
    x = x.cuda()
    runs = {}
    with torch.no_grad():
        for name, kern in (("quad_afb2d", "afb1d_corr"),
                           ("quad_afb2d_nonsep", "nonsep_afb")):
            fn = getattr(alt, name)
            torch.cuda.synchronize()
            ops.reset_launches()
            out = fn(x, *bank, mode=QUAD_MODE)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            require(counts[kern] > 0, f"quad_nonsep: {kern} never launched "
                    f"in {name}: {counts}")
            runs[name] = dict(out=out, launches=counts,
                              instantiations=inst_counts(ops), ms=timed_ms(
                lambda: fn(x, *bank, mode=QUAD_MODE), reps=5, batches=10,
                device_only=False), device_ms=timed_ms(
                lambda: fn(x, *bank, mode=QUAD_MODE), reps=5, batches=5))
        a, b = (runs[k].pop("out") for k in runs)
        err = max(max_err(u, v) for u, v in zip(a, b))
        require(all(bool(torch.isfinite(t).all()) for t in b)
                and err <= ALT_TOL, f"quad_nonsep: quad_afb2d_nonsep "
                f"differs from quad_afb2d by {err}")
        del a, b
        with NonsepRecorder(nonsep, afb) as r:
            alt.quad_afb2d_nonsep(x, *bank, mode=QUAD_MODE)
        torch.cuda.synchronize()
    by_role = {"forward": runs["quad_afb2d_nonsep"]["launches"]}
    return dict(shape=list(ALT_SHAPE), mode=QUAD_MODE, qshift="qshift_a",
                max_abs_err_nonsep_vs_separable=err, tolerance=ALT_TOL,
                **runs), by_role, r.calls


def nonsep_rt(ops, nonsep, afb):
    """afb2d_nonsep -> sfb2d_nonsep (K14 -> K15) with db4 on DWT_SHAPE in
    each of NONSEP_MODES: counted, perfect reconstruction, the adjoint
    identity of both Functions on the card (on the first DWT_CHECK_N
    images), the round trip and its gradient step (K15's and K14's
    adjoints) timed and recorded.  Returns (fields, launches per role,
    calls)."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    w = wavelet(NONSEP_WAVE)
    dec, rec_f = (w.dec_lo, w.dec_hi), (w.rec_lo, w.rec_hi)
    x = torch.randn(DWT_SHAPE, generator=torch.Generator().manual_seed(0))
    x = x.cuda()
    G = torch.randn(DWT_SHAPE, generator=torch.Generator(device="cuda")
                    .manual_seed(2), device="cuda")
    fields, by_role, calls = {}, {}, []
    for mode in NONSEP_MODES:
        def rt(v, mode=mode):
            return afb.sfb2d_nonsep(afb.afb2d_nonsep(v, *dec, mode=mode),
                                    *rec_f, mode=mode)
        with torch.no_grad():
            torch.cuda.synchronize()
            ops.reset_launches()
            rec = rt(x)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            insts = inst_counts(ops)
            pr = max_err(rec, x)
            del rec
            require(counts["nonsep_afb"] > 0 and counts["nonsep_sfb"] > 0,
                    f"nonsep_rt: K14/K15 never launched: {counts}")
            require(pr <= PR_TOL, f"nonsep_rt {mode}: reconstruction error "
                    f"{pr}")
            ms = timed_ms(lambda: rt(x), reps=5, batches=10,
                          device_only=False)
            dev_ms = timed_ms(lambda: rt(x), reps=5, batches=5)
        # the adjoint identity of each Function on the card
        xs = x[:DWT_CHECK_N].clone().requires_grad_()
        f_a = nonsep.outer_filters(*dec, *dec)[:, ::-1, ::-1].copy()
        y = nonsep.NonsepAFB.apply(xs, f_a, mode)
        gy = torch.randn_like(y)
        adj_a = adjoint_error([y], [gy], [xs], torch.autograd.grad(y, xs, gy))
        c = y.detach().requires_grad_()
        z = nonsep.NonsepSFB.apply(c, nonsep.outer_filters(*rec_f, *rec_f),
                                   mode)
        gz = torch.randn_like(z)
        adj_s = adjoint_error([z], [gz], [c], torch.autograd.grad(z, c, gz))
        require(adj_a <= ADJOINT_TOL and adj_s <= ADJOINT_TOL,
                f"nonsep_rt {mode}: adjoint identity off: {adj_a} (K14), "
                f"{adj_s} (K15)")
        del xs, y, gy, c, z, gz
        xg = x.clone().requires_grad_()

        def step(mode=mode, xg=xg):
            return torch.autograd.grad(rt(xg, mode), xg, G)[0]
        ops.reset_launches()
        step()
        torch.cuda.synchronize()
        scounts = ops.launch_counts()
        sinsts = inst_counts(ops)
        require(scounts["nonsep_afb_adjoint"] > 0
                and scounts["nonsep_sfb_adjoint"] > 0,
                f"nonsep_rt {mode}: the adjoints never launched: {scounts}")
        step_ms = timed_ms(step, reps=3, batches=10, device_only=False)
        step_dev_ms = timed_ms(step, reps=3, batches=5)
        with NonsepRecorder(nonsep, afb) as r:
            z = rt(xg)
            r.backward = True
            torch.autograd.grad(z, xg, G)
            torch.cuda.synchronize()
        del z
        calls += [(k, f"{mode} {role}", a) for k, role, a in r.calls]
        by_role[f"{mode} forward"] = counts
        by_role[f"{mode} backward"] = scounts
        fields[mode] = dict(
            launches=counts, step_launches=scounts,
            instantiations={"round_trip": insts, "step": sinsts},
            reconstruction_err=pr,
            reconstruction_tol=PR_TOL, adjoint_rel_err={"K14": adj_a,
                                                        "K15": adj_s},
            adjoint_tol=ADJOINT_TOL, fwd_inv_ms=ms, fwd_inv_device_ms=dev_ms,
            device_busy_share=dev_ms / ms,
            mpix_per_s=x.numel() / 1e6 / (ms / 1e3), step_ms=step_ms,
            step_device_ms=step_dev_ms)
    return dict(shape=list(DWT_SHAPE), wave=NONSEP_WAVE, **fields), by_role, \
        calls


def swt_sfb(ops, nonsep, afb):
    """afb2d_atrous -> sfb2d_atrous (K12 -> K16) with db4 on SWT_SHAPE at
    each of SFB_DILATIONS: counted, reconstruction in 'periodization',
    timed and recorded; the other modes (on the first SWT_CHECK_N
    images, where the shift-averaged synthesis does not invert) recorded
    for their replays against the plain version; the gradient of one
    merge (K16's adjoint) recorded; the adjoint identity of K16's
    Function in every mode on the card.  Each role's launches are read
    from the counters, reset just before its run.  Returns (fields,
    launches per role, calls)."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    w = wavelet(NONSEP_WAVE)
    dec = (w.dec_lo, w.dec_hi) * 2
    rec_f = (w.rec_lo, w.rec_hi) * 2
    x = torch.randn(SWT_SHAPE, generator=torch.Generator().manual_seed(0))
    x = x.cuda()
    fields, by_role, calls = {}, {}, []
    with torch.no_grad():
        for d in SFB_DILATIONS:
            torch.cuda.synchronize()
            ops.reset_launches()
            y = afb.afb2d_atrous(x, *dec, "periodization", d)
            torch.cuda.synchronize()
            scounts = ops.launch_counts()
            require(scounts["afb1d_atrous_corr"] == 2, f"swt_sfb d={d}: "
                    f"K12 launches {scounts}")
            sinsts = tiles_only(inst_counts(ops), f"swt_sfb d={d}", scounts)
            ops.reset_launches()
            rec = afb.sfb2d_atrous(y, *rec_f, "periodization", d)
            torch.cuda.synchronize()
            counts, insts = ops.launch_counts(), inst_counts(ops)
            require(counts["sfb1d_atrous_conv"] == 3, f"swt_sfb: K16 "
                    f"launches {counts}")
            pr = max_err(rec, x)
            require(pr <= SWT_PR_TOL, f"swt_sfb d={d}: reconstruction "
                    f"error {pr}")
            del rec
            ms = timed_ms(lambda: afb.sfb2d_atrous(
                y, *rec_f, "periodization", d), reps=5, batches=10,
                device_only=False)
            dev_ms = timed_ms(lambda: afb.sfb2d_atrous(
                y, *rec_f, "periodization", d), reps=5, batches=5)
            with NonsepRecorder(nonsep, afb) as r:
                afb.sfb2d_atrous(y, *rec_f, "periodization", d)
                n_main = len(r.calls)
                ys = y[:SWT_CHECK_N]
                torch.cuda.synchronize()
                ops.reset_launches()
                for mode in SWT_MODES:
                    if mode != "periodization":
                        afb.sfb2d_atrous(ys, *rec_f, mode, d)
                torch.cuda.synchronize()
                ocounts = ops.launch_counts()
            require(ocounts["sfb1d_atrous_conv"] == 3 * (len(SWT_MODES) - 1),
                    f"swt_sfb d={d}: K16 launches in the other modes "
                    f"{ocounts}")
            calls += [(k, f"d={d}" + (" other modes" if j >= n_main else ""),
                       a) for j, (k, _, a) in enumerate(r.calls)]
            by_role[f"d={d}"] = counts
            by_role[f"d={d} other modes"] = ocounts
            fields[f"d={d}"] = dict(launches=counts, instantiations=insts,
                                    split_launches=scounts,
                                    split_instantiations=sinsts,
                                    reconstruction_err=pr,
                                    reconstruction_tol=SWT_PR_TOL,
                                    merge_ms=ms, merge_device_ms=dev_ms,
                                    device_busy_share=dev_ms / ms)
            del y
    # one merge's gradient (K16's adjoint), recorded
    st = afb.afb2d_atrous(x, *dec, "periodization", 2).requires_grad_()
    G = torch.randn(SWT_SHAPE, generator=torch.Generator(device="cuda")
                    .manual_seed(3), device="cuda")
    ops.reset_launches()
    with NonsepRecorder(nonsep, afb) as r:
        z = afb.sfb2d_atrous(st, *rec_f, "periodization", 2)
        r.backward = True
        gst = torch.autograd.grad(z, st, G)[0]
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(counts["sfb1d_atrous_adjoint"] == 3 and bool(
        torch.isfinite(gst).all()), f"swt_sfb: K16's adjoint: {counts}")
    calls += [(k, "d=2 step", a) for k, role, a in r.calls
              if role == "backward"]
    by_role["d=2 step"] = counts
    fields["d=2 step"] = dict(launches=counts, instantiations=inst_counts(ops))
    del st, z, gst
    # the adjoint identity of K16's Function, every mode, both axes
    gen = torch.Generator(device="cuda").manual_seed(4)
    g0, g1 = (np.asarray(t) for t in (w.rec_lo, w.rec_hi))
    adj = {}
    for mode in SWT_MODES:
        for axis in (2, 3):
            stk = torch.randn((2, 3, 4, 40, 36), generator=gen,
                              device="cuda").requires_grad_()
            lo, hi = stk[:, :, 3], stk[:, :, 1]
            z = afb._SFB1DAtrous.apply(lo, hi, g0, g1, mode, axis, 2)
            gz = torch.randn(z.shape, generator=gen, device="cuda")
            gl, gh = torch.autograd.grad(z, (lo, hi), gz)
            adj[f"{mode} axis {axis}"] = adjoint_error([z], [gz], [lo, hi],
                                                       [gl, gh])
    require(all(v <= ADJOINT_TOL for v in adj.values()),
            f"swt_sfb: adjoint identity off: {adj}")
    return dict(shape=list(SWT_SHAPE), wave=NONSEP_WAVE, **fields,
                adjoint_rel_err=adj, adjoint_tol=ADJOINT_TOL), by_role, calls


def nonsep_edge_cases(banded):
    """K14, K15 and K16 against their plain versions where the main paths
    do not reach: every mode, odd sizes (periodization's evening), Ly !=
    Lx, db38 (92 KB of taps), K = 16, pads longer than the axis, the
    periodization tail as long as the output, K14's adjoint on the
    separable split's plan (its single fold), strided and transposed
    inputs.  Returns (calls checked, max error)."""
    from pytorch_wavelets_tpu_torch.filters import wavelet
    from pytorch_wavelets_tpu_torch.ops import afb_sfb, nonsep
    gen = torch.Generator().manual_seed(130)
    calls = []

    def rnd(*shape):
        return torch.randn(shape, generator=gen).cuda()
    db38 = wavelet("db38")
    f38 = np.stack([np.outer(a, b) for a in (db38.dec_lo, db38.dec_hi)
                    for b in (db38.dec_lo, db38.dec_hi)])
    for K, Ly, Lx, H, W in ((4, 8, 8, 9, 11), (4, 8, 2, 7, 13),
                            (16, 10, 10, 5, 6), (1, 3, 5, 6, 6)):
        f = torch.randn((K, Ly, Lx), generator=gen,
                        dtype=torch.float64).numpy() / np.sqrt(Ly * Lx)
        for mode in ("zero", "symmetric", "reflect", "periodization"):
            x = rnd(2, 3, 4, H, W)[:, :, 1]
            calls.append(("nonsep_afb", "edge", (x, f, mode)))
            xt = rnd(2, 3, W, H).transpose(2, 3)
            calls.append(("nonsep_afb", "edge", (xt, f, mode)))
            Ho, Wo = (nonsep.afb_axis_plan(n, L, mode)[0]
                      for n, L in ((H, Ly), (W, Lx)))
            g = rnd(2, 6, K, Ho, Wo)[:, ::2]
            calls.append(("nonsep_afb_adjoint", "edge", (g, f, mode, H, W)))
            # the separable split's plan (quad_afb2d's backward): the
            # single fold of both axes in 'periodization' at 5 x 6
            calls.append(("nonsep_afb_adjoint", "edge", (g, f, mode, H, W,
                                                         True)))
    for mode in ("zero", "periodization"):
        calls.append(("nonsep_afb", "edge", (rnd(1, 2, 40, 39), f38[:, ::-1,
                                                                    ::-1].copy(),
                                             mode)))
    for Ly, Lx, Ny, Nx in ((8, 8, 5, 4), (8, 4, 4, 6), (12, 6, 7, 3),
                           (76, 76, 40, 39)):
        f = f38 if Ly == 76 else torch.randn(
            (4, Ly, Lx), generator=gen, dtype=torch.float64).numpy() / Ly
        for mode in ("zero", "symmetric", "periodic", "periodization"):
            if mode != "periodization" and min(2 * Ny - Ly,
                                               2 * Nx - Lx) + 2 < 1:
                continue
            c = rnd(2, 3, 6, Ny, Nx)[:, :, 1:5]
            calls.append(("nonsep_sfb", "edge", (c, f, mode)))
            out = [afb_sfb.sfb_plan(n, L, mode)[0] for n, L in ((Ny, Ly),
                                                                 (Nx, Lx))]
            g = rnd(2, 3, out[1], out[0]).transpose(2, 3)
            calls.append(("nonsep_sfb_adjoint", "edge", (g, f, mode, Ny,
                                                         Nx)))
    # K15's adjoint on the separable merge's plan (sfb2d's backward):
    # 'periodization' tails longer than the 4 or 6 samples they wrap onto
    for Ly, Lx, Ny, Nx in ((8, 8, 2, 3), (12, 6, 2, 2)):
        f = torch.randn((4, Ly, Lx), generator=gen,
                        dtype=torch.float64).numpy() / Ly
        g = rnd(2, 3, 2 * Nx, 2 * Ny).transpose(2, 3)
        calls.append(("nonsep_sfb_adjoint", "edge", (g, f, "periodization",
                                                     Ny, Nx, True)))
    # and with the one-axis PSFs of sfb1d's backward (a one-tap axis read
    # twice as long), along each axis
    for axis, L, Ny, Nx in ((3, 8, 5, 7), (2, 10, 6, 3), (3, 76, 4, 20)):
        taps = torch.randn((2, L), generator=gen,
                           dtype=torch.float64).numpy() / np.sqrt(L)
        f = afb_sfb._one_axis_psfs(taps, axis, 4)
        for mode in ("zero", "symmetric", "periodization"):
            out = [afb_sfb.sfb_plan(n, L_, mode)[0]
                   for n, L_ in zip((Ny, Nx), f.shape[1:])]
            if min(out) < 1:
                continue
            calls.append(("nonsep_sfb_adjoint", "edge", (
                rnd(2, 3, *out), f, mode, Ny, Nx, True)))
    for L, d, n in ((2, 1, 9), (8, 2, 6), (10, 4, 7), (40, 4, 5)):
        g0, g1 = (torch.randn(L, generator=gen, dtype=torch.float64).numpy()
                  / np.sqrt(L) for _ in range(2))
        for mode in SWT_MODES:
            for axis in (2, 3):
                shape = [2, 3, 9, 7]
                shape[axis] = n
                stk = rnd(shape[0], shape[1], 4, *shape[2:])
                calls.append(("sfb1d_atrous_conv", "edge",
                              (stk[:, :, 3], stk[:, :, 0], g0, g1, mode,
                               axis, d)))
                dy = rnd(shape[0], 2 * shape[1], *shape[2:])[:, 1::2]
                calls.append(("sfb1d_atrous_adjoint", "edge",
                              (dy, g0, g1, mode, axis, d)))
    err = 0.0
    before = {k: dict(getattr(nonsep, k).instantiations)
              for k in ("nonsep_sfb", "nonsep_sfb_adjoint")}
    for call in calls:
        got, want = nonsep_call_parts(call, banded)[:2]
        require(torch.allclose(got, want, **NONSEP_TOL),
                f"{call[0]} edge case {tuple(call[2][0].shape)} disagrees "
                f"with its plain version by {max_err(got, want)}")
        err = max(err, max_err(got, want))
    torch.cuda.synchronize()
    # K15's kinds of instantiation: the polyphase tiles and their band
    # (forward), the staged tiles (adjoint), by tile
    insts = {k: {w: n - before[k].get(w, 0)
                 for w, n in getattr(nonsep, k).instantiations.items()
                 if n != before[k].get(w, 0)} for k in before}
    kinds = {w.split()[0] for v in insts.values() for w in v}
    require(kinds == {"poly", "band", "staged"},
            f"nonsep_edge_cases: a K15 instantiation was not checked: "
            f"{insts}")
    return len(calls), err, insts


# ---------------------------------------------------------------------------
# the precision levels and bf16: K17 (csrc/banded_apply_tc.cu) on the
# paths that run operator products, and the CUDA-core stencils on bf16
# through their wrappers' casts
# ---------------------------------------------------------------------------

# each K17 mode: the matmul precision level that selects it for fp32 data
# (bf16 data takes the bf16 mode at every level; 'highest' is used), the
# data's dtype, and the tensor-core peak of the card for its products
# (NVIDIA H100 SXM data sheet, dense, at 700 W), with the number of
# products it issues per product of the operator
K17_LEVEL = {"3xtf32": "high", "tf32": "default", "bf16": "highest"}
K17_DTYPE = {"3xtf32": torch.float32, "tf32": torch.float32,
             "bf16": torch.bfloat16}
# second-order gradients: the reverse-over-reverse Hessian-vector product
# of each path against the CPU plain run's on its first images, within
# HVP_TOL of max(1, max |CPU|); its timing (time_op repeats, iters; and
# timed_ms's reps, batches); the Selesnick phase at a smaller batch
HVP_CHECK_N = 4
HVP_TOL = 2e-5
HVP_TIMING = (3, 3)
HVP_ALT_SHAPE, HVP_ALT_J = (16, 3, 256, 256), ALT_J
# K18 against its plain version: a few IEEE ops a value, summed in another
# order, against the magnitudes of its terms (scat_mag_bwd2_scale)
BWD2_TOL = dict(rtol=1e-6, atol=1e-6)
# the batch_chunk dial on the ScatterNet workload: the chunks timed beside
# the unchunked layer, which they must match within CHUNK_TOL
CHUNKS = (8, 32)
CHUNK_TOL = 1e-6

PEAK_TC_FLOPS = {"3xtf32": 495e12 / 3, "tf32": 495e12, "bf16": 989e12}
# K17 against its mode's plain version (ops/banded.py:_tc_plain): the same
# rounded operands, fp32 sums in another order; a bf16 output is that sum
# rounded once, one bf16 step (at most 2^-7 relative) where the sums straddle a
# rounding midpoint
K17_TOL = {"3xtf32": K1_TOL, "tf32": K1_TOL,
           "bf16": dict(rtol=2.0 ** -7, atol=1e-5)}
# the paths against the fp32 CPU run: 'high' at the JAX suite's DTCWT
# tolerance (absolute); 'default' at 1e-2 of the larger of 1 and max |CPU|
# (the JAX package gives ~4e-2 at 'default' on a TPU, its
# ops/precision.py:6-12); in bf16 a reconstruction at 2e-2 of max |x|
# (tests/test_precision.py:88), every other output (coefficients,
# scattering outputs, gradients: many bf16 roundings deep) loosely, at
# 1e-1 of the larger of 1 and max |CPU|
PREC_TOL = {"3xtf32": (2e-5, False), "tf32": (1e-2, True),
            "bf16": (1e-1, True)}
BF16_RECON_TOL = 2e-2
PREC_BANDED_CHECK_N = 1         # images of prec_banded checked on the CPU
PREC_TIMING = (5, 3)            # (reps, batches) of the paths' timings
K17_REPLAY_TIMING = (3, 2)      # of a group of replayed calls, as one
QUAD_REPLAY_TIMING = (5, 3)     # of each replayed bf16 K2/K3 call
K17_REPLACES = {"row": "pytorch_wavelets_tpu/ops/banded.py:332",
                "col": "pytorch_wavelets_tpu/ops/banded.py:321"}


class K17Recorder(Swapping):
    """For one run: swaps K17's wrappers (``banded.apply_{col,row}_{mode}``,
    which ``apply_col`` / ``apply_row`` look up at each call) for
    recording ones, which keep each call's inputs for replay."""

    def __init__(self, banded):
        self.banded = banded
        self.calls = []

    def swaps(self):
        swaps = []
        for entry in ("col", "row"):
            for mode in K17_LEVEL:
                name = f"apply_{entry}_{mode}"
                swaps.append((self.banded, name,
                              self._recording(entry, mode,
                                              getattr(self.banded, name))))
        return swaps

    def _recording(self, entry, mode, orig):
        def fn(x, T, out=None, accumulate=True):
            self.calls.append((entry, mode, x, T,
                               _out_mode(out, accumulate)))
            return orig(x, T, out, accumulate)
        return fn


class CastRecorder(Swapping):
    """For one run: records the casts of the CUDA-core kernels' wrappers
    (``ops._cuda.cast``, bf16 <-> fp32 around K4-K16) for a timed
    replay."""

    def __init__(self, cuda):
        self.cuda = cuda
        self.calls = []

    def swaps(self):
        orig = self.cuda.cast

        def cast(t, dtype):
            self.calls.append((t, dtype))
            return orig(t, dtype)
        return [(self.cuda, "cast", cast)]


class QuadRecorder(Swapping):
    """For one run: swaps the K2/K3 wrappers (``q2c_pack``, ``c2q_unpack``)
    where the composed pyramids (``fused``) and the level functions
    (``lev``) call them for recording ones, which keep each call's inputs
    in the form :func:`replay` reads."""

    def __init__(self, fused, lev):
        self.modules = (fused, lev)
        self.calls = []

    def swaps(self):
        calls, swaps = self.calls, []
        for module in self.modules:
            def q2c_pack(y, out, orients, interleaved=False,
                         orig=module.q2c_pack):
                calls.append(("q2c_pack", None, (y, out.size(), out.stride(),
                                                 orients, interleaved)))
                return orig(y, out, orients, interleaved)

            def c2q_unpack(h, orients, interleaved=False,
                           orig=module.c2q_unpack):
                calls.append(("c2q_unpack", None, (h, orients, interleaved)))
                return orig(h, orients, interleaved)
            swaps += [(module, "q2c_pack", q2c_pack),
                      (module, "c2q_unpack", c2q_unpack)]
        return swaps


def quad_rows(quad, calls, counts, label):
    """One kernel line per K2/K3 kernel of ``calls`` (bf16 calls of one
    run): every call held bit for bit against its plain version computed
    in fp32 and rounded once to bf16, as the kernel rounds."""
    groups = []
    for kernel in ("q2c_pack", "c2q_unpack"):
        mine = [c for c in calls if c[0] == kernel]
        if mine:
            per_level = all(c[2][-1] for c in mine)
            groups.append((f"{kernel} bf16 ({label})",
                           PER_LEVEL_REPLACES[kernel] if per_level
                           else SOURCES[kernel][2], counts[kernel], mine))
    return kernel_rows(groups, None, quad, None, None, None,
                       timing=QUAD_REPLAY_TIMING)


def k17_call_parts(banded, call):
    """One recorded K17 call: (got, want, run, plain, lib, ops, bytes,
    copies).  ``lib``: ``torch.matmul`` on the same operands (TF32 allowed
    for the TF32 mode, in bf16 for the bf16 mode; + ``add_`` where K17
    accumulates), None for 3xTF32 (no PyTorch call does it); ``copies``
    the copy widths the wrapper counted for ``got``."""
    entry, mode, x, op, spec = call
    kern = getattr(banded, f"apply_{entry}_{mode}")
    plainf = getattr(banded, f"apply_{entry}_{mode}_plain")
    kind = spec[0] if spec else None
    if kind is None:
        got, inst = copies_of(kern, lambda: kern(x, op))
        want = plainf(x, op)
        run = lambda: kern(x, op)                             # noqa: E731
        plain = lambda: plainf(x, op)                         # noqa: E731
    elif kind == "acc":
        acc = spec[1]
        got, inst = copies_of(kern, lambda: kern(x, op, acc.clone()))
        want = plainf(x, op, acc)
        buf = acc.clone()
        run = lambda: kern(x, op, buf)                        # noqa: E731
        plain = lambda: plainf(x, op, acc)                    # noqa: E731
    else:
        buf = torch.empty_strided(spec[1], spec[2], device=x.device,
                                  dtype=x.dtype)
        pbuf = torch.empty_strided(spec[1], spec[2], device=x.device,
                                   dtype=x.dtype)
        got, inst = copies_of(kern, lambda: kern(x, op, buf,
                                                  accumulate=False).clone())
        want = plainf(x, op)
        run = lambda: kern(x, op, buf, accumulate=False)      # noqa: E731
        plain = lambda: plainf(x, op, pbuf,                   # noqa: E731
                               accumulate=False)
    lib = None
    if mode != "3xtf32":
        Td = op.values(x.dtype)

        def prod():
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
            try:
                return (torch.matmul(x, Td.t()) if entry == "row"
                        else torch.matmul(Td, x))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
        lib = (lambda: prod().add_(spec[1])) if kind == "acc" else prod
    K = x.shape[3 if entry == "row" else 2]
    flops = 2.0 * op.nnz * x.numel() / K
    nbytes = x.element_size() * (x.numel() + op.T.numel() + got.numel()
                                 * (2 if kind == "acc" else 1))
    return got, want, run, plain, lib, flops, nbytes, inst


def k17_rows(banded, calls, counts, label):
    """One kernel line per (entry, mode) of ``calls``: every call checked
    against its mode's plain version, the group's calls timed back to
    back (kernel, plain version, library), the bound summed over them."""
    rows = []
    for entry in ("row", "col"):
        for mode in K17_LEVEL:
            mine = [c for c in calls if c[:2] == (entry, mode)]
            if not mine:
                continue
            runs, plains, libs = [], [], []
            err = op_t = byte_t = 0.0
            shapes = []
            insts = {}
            for call in mine:
                got, want, run, plain, lib, flops, nbytes, inst = \
                    k17_call_parts(banded, call)
                for w, n in inst.items():
                    insts[w] = insts.get(w, 0) + n
                require(within(got.float(), want.float(), K17_TOL[mode]),
                        f"K17 {entry} {mode} {tuple(call[2].shape)} "
                        f"disagrees with its plain version by "
                        f"{max_err(got, want)}")
                err = max(err, max_err(got, want))
                runs.append(run)
                plains.append(plain)
                libs.append(lib)
                op_t += flops / PEAK_TC_FLOPS[mode] * 1e3
                byte_t += nbytes / PEAK_HBM_BYTES * 1e3
                shapes.append(f"{shape_str(call[2].shape)} by "
                              f"{shape_str(call[3].shape)}")
                del got, want
            reps, batches = K17_REPLAY_TIMING
            ms = timed_ms(lambda: [r() for r in runs], reps, batches)
            plain_ms = timed_ms(lambda: [r() for r in plains], reps,
                                batches)
            lib_ms = None if None in libs else timed_ms(
                lambda: [r() for r in libs], reps, batches)
            rows.append({
                "name": f"banded_tc_{entry} {mode} ({label})",
                "route": "cuda",
                "source": "pytorch_wavelets_tpu_torch/csrc/"
                          "banded_apply_tc.cu",
                "replaces": K17_REPLACES[entry],
                "launches": counts[f"apply_{entry}_{mode}"],
                "max_abs_err": err,
                "tolerance": K17_TOL[mode], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(op_t, byte_t),
                "bound_by": "bytes" if byte_t >= op_t else "operations",
                "library_ms": lib_ms, "calls": len(mine),
                "instantiations": insts, "per_call": shapes})
    return rows


def _path_errors(outs, refs, n, mode, phase, recon, x_max):
    """max |card - CPU fp32| of each output on its first ``n`` items,
    gated by PREC_TOL (relative to max(1, max |CPU|) where it says so),
    the reconstruction (output ``recon``, or None) in bf16 by
    BF16_RECON_TOL of ``x_max``."""
    errs = []
    for k, (o, r) in enumerate(zip(outs, refs)):
        require(bool(torch.isfinite(o).all()), f"{phase}: non-finite output")
        require(o.dtype == K17_DTYPE[mode], f"{phase}: output {k} is "
                f"{o.dtype}, not {K17_DTYPE[mode]}")
        e = max_err(o[:n].float().cpu(), r)
        tol, rel = PREC_TOL[mode]
        limit = tol * (max(1.0, float(r.abs().max())) if rel else 1.0)
        if mode == "bf16" and recon is not None and k == recon % len(outs):
            limit = BF16_RECON_TOL * x_max
        require(e <= limit, f"{phase} ({mode}): output {k} differs from "
                f"the fp32 CPU run by {e} (limit {limit})")
        errs.append(e)
    return errs


def precision_path(tt, ops, banded, cuda, phase, mode, runs, x_cpu, refs,
                   n, need=None):
    """One path under K17's ``mode``: ``runs`` maps a name to (a function
    of x giving its outputs (fwd / inv, or a step with x.grad last), the
    index of the reconstruction among them or None); ``refs`` the same
    functions' fp32 CPU outputs on the first ``n`` items.  Counted
    (K17's ``mode`` launched, K1 not; ``need`` instead names the kernels
    that must launch where the path has no operator product), checked,
    timed, one run of each recorded (K17's calls, the wrappers' casts
    and, in bf16, the K2/K3 calls).  Returns (fields, calls, counts,
    casts, quad_calls)."""
    from pytorch_wavelets_tpu_torch.ops import fused_dtcwt
    from pytorch_wavelets_tpu_torch.transforms import dtcwt as lev
    level = K17_LEVEL[mode]
    x = x_cpu.cuda().to(K17_DTYPE[mode])
    fields = dict(mode=mode, level=level, dtype=str(x.dtype),
                  shape=list(x.shape), checked_items=n,
                  tolerance=dict(zip(("max_abs", "relative"),
                                     PREC_TOL[mode])))
    if mode == "bf16":
        fields["tolerance"]["reconstruction_of_max_abs_x"] = BF16_RECON_TOL
    x_max = float(x_cpu.abs().max())
    with tt.matmul_precision(level):
        torch.cuda.synchronize()
        ops.reset_launches()
        outs = {name: run(x) for name, (run, _) in runs.items()}
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        fields["copies"] = copy_counts(ops)
        if need is None:
            require(counts[f"apply_row_{mode}"] > 0
                    and counts[f"apply_col_{mode}"] > 0,
                    f"{phase}: K17 {mode} never launched: {counts}")
        else:
            require(all(counts[k] > 0 for k in need),
                    f"{phase}: a kernel of the path never launched: "
                    f"{counts}")
        require(counts["apply_row"] == counts["apply_col"] == 0,
                f"{phase}: K1 (fp32) launched under {mode}: {counts}")
        fields["launches"] = {k: v for k, v in counts.items() if v}
        fields["instantiations"] = vector_c2qs(vector_quads(
            inst_counts(ops), phase, counts), phase, counts)
        fields["max_abs_err_vs_cpu_fp32"] = {
            name: _path_errors(outs[name], refs[name], n, mode, phase, recon,
                               x_max)
            for name, (_, recon) in runs.items()}
        del outs
        reps, batches = PREC_TIMING
        for name, (run, _) in runs.items():
            fields[f"{name}_ms"] = timed_ms(lambda: run(x), reps, batches,
                                            device_only=False)
            fields[f"{name}_device_ms"] = timed_ms(lambda: run(x), reps,
                                                   batches)
            fields[f"{name}_mpix_per_s"] = x.numel() / 1e6 / (
                fields[f"{name}_ms"] / 1e3)
        with K17Recorder(banded) as rec, CastRecorder(cuda) as cst, \
                QuadRecorder(fused_dtcwt, lev) as qr:
            for run, _ in runs.values():
                run(x)
        torch.cuda.synchronize()
    quad_calls = [c for c in qr.calls if c[2][0].dtype == torch.bfloat16]
    return fields, rec.calls, counts, cst.calls, quad_calls


def cast_share(casts, device_ms, phase):
    """The wrappers' casts of one run, replayed back to back and timed,
    over the path's device ms."""
    if not casts:
        return dict(casts=0, cast_ms=0.0, cast_share=0.0)
    ms = timed_ms(lambda: [t.to(d) for t, d in casts], *PREC_TIMING)
    return dict(casts=len(casts), cast_ms=ms,
                cast_bytes=sum(t.numel() * (t.element_size() + (
                    2 if d == torch.bfloat16 else 4)) for t, d in casts),
                cast_share=ms / device_ms)


def _step_of(fwd, inv, cts):
    """train_main's step: outputs rec, yl, yh..., then x.grad."""
    cs = {}

    def step(x):
        if x.dtype not in cs:
            cs[x.dtype] = [t.to(x.dtype) for t in cts]
        xg = x.detach().requires_grad_()
        yl, yh = fwd(xg)
        outs = [inv((yl, yh)), yl, *yh]
        return [o.detach() for o in outs] + list(
            torch.autograd.grad(outs, xg, cs[x.dtype]))
    return step


def prec_main(tt, ops, banded, cuda):
    """The bench.py workload (DTCWT J=2, 10x10x128^2) round trip and
    train_main's step under 'high' (3xTF32), 'default' (TF32) and in
    bf16."""
    x_cpu = torch.randn(MAIN_SHAPE,
                        generator=torch.Generator().manual_seed(0))
    fc, ic = tt.DTCWTForward(J=2, device="cpu"), tt.DTCWTInverse(
        device="cpu")
    with torch.no_grad(), one_cpu_thread():
        yl, yh = fc(x_cpu)
    cts = [torch.randn(t.shape, generator=torch.Generator()
                       .manual_seed(1 + k))
           for k, t in enumerate([x_cpu, yl, *yh])]
    with one_cpu_thread():
        refs = {"round_trip": [yl, *yh, ic((yl, yh))],
                "step": _step_of(fc, ic, cts)(x_cpu)}
    f, i = tt.DTCWTForward(J=2, device="cuda"), tt.DTCWTInverse(
        device="cuda")
    cts_gpu = [c.cuda() for c in cts]

    def round_trip(x):
        with torch.no_grad():
            yl, yh = f(x)
            return [yl, *yh, i((yl, yh))]
    runs = {"round_trip": (round_trip, -1),
            "step": (_step_of(f, i, cts_gpu), 0)}
    return [precision_path(tt, ops, banded, cuda, "prec_main", mode, runs,
                           x_cpu, refs, MAIN_SHAPE[0])
            for mode in ("3xtf32", "tf32", "bf16")]


def prec_banded(tt, ops, banded, cuda):
    """The banded cell's forward (DTCWT J=3 on 8x3x512^2, whose operators
    have short bands, so K17 skips most of their tiles) under 'default'
    (TF32) and in bf16; checked on the first PREC_BANDED_CHECK_N
    images."""
    n = PREC_BANDED_CHECK_N
    x_cpu = torch.randn(BANDED_SHAPE,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), one_cpu_thread():
        yl, yh = tt.DTCWTForward(J=3, device="cpu")(x_cpu[:n])
    refs = {"forward": [yl, *yh]}
    f = tt.DTCWTForward(J=3, device="cuda")

    def forward(x):
        with torch.no_grad():
            yl, yh = f(x)
            return [yl, *yh]
    runs = {"forward": (forward, None)}
    return [precision_path(tt, ops, banded, cuda, "prec_banded", mode, runs,
                           x_cpu, refs, n)
            for mode in ("tf32", "bf16")]


def prec_scat(tt, ops, banded, cuda):
    """ScatLayerj2() on 128x3x256^2, forward + backward (the gradient of
    sum(Z * G)), under 'default' (TF32) and in bf16; checked on the first
    SCAT_CHECK_N images."""
    N, C, H, W = SCAT_SHAPE
    n = SCAT_CHECK_N
    x_cpu = torch.randn(SCAT_SHAPE, generator=torch.Generator()
                        .manual_seed(0))
    G_cpu = torch.randn((N, 49 * C, H // 4, W // 4),
                        generator=torch.Generator().manual_seed(1))

    def step_of(m, G):
        Gs = {}

        def step(x):
            if x.dtype not in Gs:
                Gs[x.dtype] = G.to(x.dtype)
            xg = x.detach().requires_grad_()
            z = m(xg)
            return [z.detach(), torch.autograd.grad(z, xg, Gs[x.dtype])[0]]
        return step
    with one_cpu_thread():
        refs = {"fwd_bwd": step_of(tt.ScatLayerj2(device="cpu"),
                                   G_cpu[:n])(x_cpu[:n])}
    m = tt.ScatLayerj2(device="cuda")
    runs = {"fwd_bwd": (step_of(m, G_cpu.cuda()), None)}
    return [precision_path(tt, ops, banded, cuda, "prec_scat", mode, runs,
                           x_cpu, refs, n)
            for mode in ("tf32", "bf16")]


def prec_swt(tt, ops, banded, cuda):
    """swt_main's round trip (32x3x256^2, db4, J=3, periodization) under
    'high' (3xTF32 on the dense pinv); checked on the first SWT_CHECK_N
    images."""
    kw = dict(wave=SWT_WAVE, mode=SWT_MODE)
    n = SWT_CHECK_N
    x_cpu = torch.randn(SWT_SHAPE, generator=torch.Generator()
                        .manual_seed(0))

    def rt_of(f, i):
        def rt(x):
            with torch.no_grad():
                ys = f(x)
                return [*ys, i(ys)]
        return rt
    with one_cpu_thread():
        refs = {"round_trip": rt_of(
            tt.SWTForward(J=SWT_J, device="cpu", **kw),
            tt.SWTInverse(device="cpu", **kw))(x_cpu[:n])}
    runs = {"round_trip": (rt_of(tt.SWTForward(J=SWT_J, device="cuda", **kw),
                                 tt.SWTInverse(device="cuda", **kw)), -1)}
    return precision_path(tt, ops, banded, cuda, "prec_swt", "3xtf32", runs,
                          x_cpu, refs, n)


def prec_dwt_bf16(tt, ops, banded, cuda):
    """dwt_main's round trip (32x10x512^2, db4, J=3, symmetric) in bf16:
    K6/K7 through their wrappers' casts (the path has no operator
    product); checked on the first DWT_CHECK_N images."""
    kw = dict(wave=DWT_WAVE, mode=DWT_MODE)
    n = DWT_CHECK_N
    x_cpu = torch.randn(DWT_SHAPE, generator=torch.Generator()
                        .manual_seed(0))

    def rt_of(f, i):
        def rt(x):
            with torch.no_grad():
                yl, yh = f(x)
                return [yl, *yh, i((yl, yh))]
        return rt
    with one_cpu_thread():
        refs = {"round_trip": rt_of(
            tt.DWTForward(J=DWT_J, device="cpu", **kw),
            tt.DWTInverse(device="cpu", **kw))(x_cpu[:n])}
    runs = {"round_trip": (rt_of(tt.DWTForward(J=DWT_J, device="cuda", **kw),
                                 tt.DWTInverse(device="cuda", **kw)), -1)}
    return precision_path(tt, ops, banded, cuda, "prec_dwt_bf16", "bf16",
                          runs, x_cpu, refs, n,
                          need=("afb1d_corr", "sfb1d_conv"))


def precision_phases(tt, ops, banded, cuda):
    """The four precision phases, each emitted with its K17 kernel lines,
    and, for bf16, its K2/K3 kernel lines and the share of its device time
    in the wrappers' casts.  Returns the kernel rows."""
    from pytorch_wavelets_tpu_torch.ops import quad
    rows = []

    def finish(phase, label, result, step_name):
        fields, calls, counts, casts, quad_calls = result
        dev_ms = fields[f"{step_name}_device_ms"]
        if fields["mode"] == "bf16":
            fields["bf16_casts"] = cast_share(casts, dev_ms, phase)
        emit(phase, **fields)
        with torch.no_grad():
            new = k17_rows(banded, calls, counts,
                           f"{label} {fields['mode']}")
            new += quad_rows(quad, quad_calls, counts, label)
        for row in new:
            emit("kernel", **row)
        rows.extend(new)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    for result in prec_main(tt, ops, banded, cuda):
        finish("prec_main", f"DTCWT J=2 {shape_str(MAIN_SHAPE)}", result,
               "step")
    for result in prec_banded(tt, ops, banded, cuda):
        finish("prec_banded", f"DTCWT J=3 {shape_str(BANDED_SHAPE)} forward",
               result, "forward")
    for result in prec_scat(tt, ops, banded, cuda):
        finish("prec_scat", f"ScatLayerj2 {shape_str(SCAT_SHAPE)}", result,
               "fwd_bwd")
    finish("prec_swt", f"SWT J={SWT_J} {shape_str(SWT_SHAPE)}",
           prec_swt(tt, ops, banded, cuda), "round_trip")
    finish("prec_dwt_bf16", f"DWT J={DWT_J} {shape_str(DWT_SHAPE)}",
           prec_dwt_bf16(tt, ops, banded, cuda), "round_trip")
    return rows


# ---------------------------------------------------------------------------
# second-order gradients (every backward's backward, K18) and batch_chunk
# ---------------------------------------------------------------------------

def _cubic(out):
    """sum(o^3) over every tensor of a (nested) module output."""
    return sum((o ** 3).sum() for o in _flat(out) if o is not None)


def _squares(out):
    return sum((o ** 2).sum() for o in _flat(out) if o is not None)


def _dwt_round_trip(tt, **kw):
    """DWTForward -> its coefficients and DWTInverse's reconstruction."""
    def make(device):
        f = tt.DWTForward(device=device, **kw)
        i = tt.DWTInverse(device=device, wave=kw["wave"], mode=kw["mode"])

        def fn(x):
            yl, yh = f(x)
            return yl, yh, i((yl, yh))
        return fn
    return make


def _swt_round_trip(tt, **kw):
    """SWTForward -> its stacks and SWTInverse's reconstruction."""
    def make(device):
        f = tt.SWTForward(device=device, **kw)
        i = tt.SWTInverse(device=device, wave=kw["wave"], mode=kw["mode"])

        def fn(x):
            ys = f(x)
            return ys, i(ys)
        return fn
    return make


def hvp_of(fn, loss):
    """The reverse-over-reverse Hessian-vector product of loss(fn(x)) at x
    along v: the gradient of <d loss / dx, v>, the first gradient taken
    with create_graph=True."""
    def hvp(x, v):
        xt = x.detach().requires_grad_()
        g, = torch.autograd.grad(loss(fn(xt)), xt, create_graph=True)
        return torch.autograd.grad((g * v).sum(), xt)[0]
    return hvp


def hvp_phase(ops, profiling, phase, make, shape, loss, need, recorder=None,
              check_n=HVP_CHECK_N):
    """One module's Hessian-vector product on the card: ``make(device)``
    the module (or composition), ``loss`` of its output.  The CPU plain
    run's on the first ``check_n`` images (the loss sums over images, so
    its Hessian is block-diagonal by image) is the reference, within
    HVP_TOL of max(1, max |CPU|); the kernels of ``need`` must launch in
    the counted run.  Timed with ``profiling.time_op`` (v -> H v chained:
    ms as the caller waits) and as device time.  Returns (fields, launch
    counts, recorded calls: ``recorder()`` around one product)."""
    x_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    v_cpu = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    ref = hvp_of(make("cpu"), loss)(x_cpu[:check_n], v_cpu[:check_n])
    cpu_s = time.perf_counter() - t0
    hvp = hvp_of(make("cuda"), loss)
    x, v = x_cpu.cuda(), v_cpu.cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ops.reset_launches()
    hv = hvp(x, v)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    insts = inst_counts(ops)
    require(all(counts[k] > 0 for k in need),
            f"{phase}: a kernel of the path never launched: {counts}")
    require(tuple(hv.shape) == shape and bool(torch.isfinite(hv).all()),
            f"{phase}: non-finite Hessian-vector product or wrong shape")
    err = max_err(hv[:check_n].cpu(), ref)
    scale = max(1.0, float(ref.abs().max()))
    require(err <= HVP_TOL * scale, f"{phase}: GPU differs from the CPU "
            f"plain run by {err} (limit {HVP_TOL * scale})")
    del hv
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    repeats, iters = HVP_TIMING
    wait_ms = profiling.time_op(lambda z: hvp(x, z), v, repeats=repeats,
                                iters=iters) * 1e3
    peak = torch.cuda.max_memory_allocated()
    dev_ms = timed_ms(lambda: hvp(x, v), reps=repeats, batches=iters)
    calls = []
    if recorder is not None:
        with recorder() as rec:
            hvp(x, v)
        torch.cuda.synchronize()
        calls = rec.calls
    fields = dict(
        shape=list(shape), launches={k: n for k, n in counts.items() if n},
        instantiations=insts, checked_images=check_n,
        max_abs_err_vs_cpu=err, tolerance=HVP_TOL * scale,
        tolerance_rule=f"{HVP_TOL} * max(1, max |CPU|)",
        first_call_s=first_s, hvp_ms=wait_ms, hvp_device_ms=dev_ms,
        device_busy_share=dev_ms / wait_ms,
        mpix_per_s=x.numel() / 1e6 / (wait_ms / 1e3),
        timing=dict(time_op_repeats=repeats, time_op_iters=iters),
        peak_mem_bytes=peak, mem_held_before_bytes=held,
        cpu_reference_s=cpu_s)
    return fields, counts, calls


def vector_bwd2(insts, phase, counts):
    """Every K18 launch of a scattering path took the vector walk."""
    got = insts.get("scat_mag_bwd2", {})
    require(got.get("vector", 0) == counts.get("scat_mag_bwd2", 0),
            f"{phase}: scat_mag_bwd2 launched "
            f"{counts.get('scat_mag_bwd2', 0)} times, {got} on its vector "
            f"walk")
    return insts


def hvp_phases(tt, ops, kern, profiling, fused, scat, fb, lev):
    """The six Hessian-vector product phases at full width, and K18's
    kernel rows from the two scattering ones.  Returns the rows."""
    from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt as alt
    mags = ("scat_mag_fwd", "scat_mag_bwd", "scat_mag_bwd2")
    phases = [
        ("hvp_scat_j2", lambda d: tt.ScatLayerj2(device=d), SCAT_SHAPE,
         _squares, PYRAMID_KERNELS + mags,
         lambda: Tracer(ops, fused, scat, record=True)),
        ("hvp_scat_bp", lambda d: tt.ScatLayerj2(device=d, **BP), BP_SHAPE,
         _squares, STENCILS + POOLS + ("q2c_pack", "c2q_unpack") + mags,
         lambda: PerLevelRecorder(fb, lev, scat)),
        ("hvp_main", lambda d: tt.DTCWTForward(J=2, device=d), MAIN_SHAPE,
         _cubic, PYRAMID_KERNELS, None),
        ("hvp_dwt", _dwt_round_trip(tt, J=DWT_J, wave=DWT_WAVE,
                                    mode=DWT_MODE), DWT_SHAPE, _cubic,
         DWT_KERNELS + ("nonsep_afb_adjoint", "nonsep_sfb_adjoint"), None),
        ("hvp_swt", _swt_round_trip(tt, J=SWT_J, wave=SWT_WAVE,
                                    mode=SWT_MODE), SWT_SHAPE, _cubic,
         ("afb1d_atrous_corr", "afb1d_atrous_adjoint", "apply_row",
          "apply_col"), None),
        ("hvp_alt", lambda d: alt.DTCWTForward2(J=HVP_ALT_J, device=d,
                                                 **ALT_KW), HVP_ALT_SHAPE,
         _cubic, DWT_KERNELS + ("nonsep_sfb_adjoint",), None)]
    rows = []
    for phase, make, shape, loss, need, recorder in phases:
        fields, counts, calls = hvp_phase(ops, profiling, phase, make, shape,
                                          loss, need, recorder)
        if phase.startswith("hvp_scat"):
            vector_bwd2(fields["instantiations"], phase, counts)
        emit(phase, **fields)
        k18 = [c for c in calls if c[0] == "scat_mag_bwd2"]
        if k18:
            label = "ScatLayerj2" + (" bp" if phase == "hvp_scat_bp" else "")
            with torch.no_grad():
                new = kernel_rows([(
                    f"scat_mag_bwd2 ({label} {shape_str(shape)}: "
                    f"Hessian-vector product)", SOURCES["scat_mag_bwd2"][2],
                    counts["scat_mag_bwd2"], k18)], *kern)
            for row in new:
                emit("kernel", **row)
            rows.extend(new)
        del calls, k18
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return rows


def chunk_scat(tt, profiling):
    """ScatLayerj2 on SCAT_SHAPE with batch_chunk 8 and 32 against the
    unchunked layer: outputs and x.grad (the gradient of sum(Z * G)) within
    CHUNK_TOL, forward and step times beside the unchunked ones (ms as the
    caller waits, ``profiling.time_op``, and device time)."""
    N, C, H, W = SCAT_SHAPE
    x = torch.randn(SCAT_SHAPE, generator=torch.Generator().manual_seed(0))
    x = x.cuda().requires_grad_()
    G = torch.randn((N, 49 * C, H // 4, W // 4),
                    generator=torch.Generator().manual_seed(1)).cuda()
    out = {}
    ref = None
    for chunk in (None, *CHUNKS):
        m = tt.ScatLayerj2(batch_chunk=chunk, device="cuda")
        z = m(x)
        g, = torch.autograd.grad(z, x, G)
        z = z.detach()
        if ref is None:
            ref = (z, g)
            errs = None
        else:
            errs = {"output": max_err(z, ref[0]), "x_grad": max_err(g, ref[1])}
            require(max(errs.values()) <= CHUNK_TOL,
                    f"chunk_scat: batch_chunk={chunk} differs from the "
                    f"unchunked layer by {errs}")
        del z, g

        def step(_, m=m):
            torch.autograd.grad(m(x), x, G)
            return _

        def fwd(_, m=m):
            m(x)
            return _

        with torch.no_grad():
            fwd_ms = profiling.time_op(fwd, x, repeats=3, iters=5) * 1e3
        step_ms = profiling.time_op(step, x, repeats=3, iters=5) * 1e3
        step_dev_ms = timed_ms(lambda: step(None), reps=3, batches=5)
        out["off" if chunk is None else str(chunk)] = dict(
            max_abs_err_vs_unchunked=errs, fwd_no_grad_ms=fwd_ms,
            fwd_bwd_ms=step_ms, fwd_bwd_device_ms=step_dev_ms,
            device_busy_share=step_dev_ms / step_ms)
    return dict(shape=list(SCAT_SHAPE), tolerance=CHUNK_TOL, by_chunk=out)


# ---------------------------------------------------------------------------
# third-order gradients through the magnitude (K18 differentiated again)
# ---------------------------------------------------------------------------

THIRD_SHAPE = (2, 3, 32, 32)     # tests/test_torch_higher_order.py's


def third_order_scat(tt, ops):
    """grad_x <grad_x <grad_x sum(Z^3), v>, w> through ScatLayerj2 on the
    card against the port's CPU plain run, within HVP_TOL of max(1,
    max |CPU|): K18's call is a Function whose backward runs K5 and K18
    again (and elementwise PyTorch for the third derivative), so every
    order differentiates on the card.  K18 must launch."""
    x, v, w = (torch.randn(THIRD_SHAPE, generator=torch.Generator()
                           .manual_seed(s)) for s in (0, 1, 2))

    def third(device):
        m = tt.ScatLayerj2(device=device)
        xt = x.to(device).requires_grad_()
        g1, = torch.autograd.grad((m(xt) ** 3).sum(), xt, create_graph=True)
        g2, = torch.autograd.grad((g1 * v.to(device)).sum(), xt,
                                  create_graph=True)
        return torch.autograd.grad((g2 * w.to(device)).sum(), xt)[0]
    with one_cpu_thread():
        ref = third("cpu")
    ops.reset_launches()
    got = third("cuda")
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    require(all(counts.get(k, 0) > 0 for k in
                ("scat_mag_fwd", "scat_mag_bwd", "scat_mag_bwd2")),
            f"third_order_scat: a magnitude kernel never launched: {counts}")
    err = max_err(got.cpu(), ref)
    scale = max(1.0, float(ref.abs().max()))
    require(bool(torch.isfinite(got).all()) and err <= HVP_TOL * scale,
            f"third_order_scat: GPU differs from the CPU plain run by {err} "
            f"(limit {HVP_TOL * scale})")
    return dict(shape=list(THIRD_SHAPE), launches=counts,
                max_abs_err_vs_cpu=err, tolerance=HVP_TOL * scale,
                tolerance_rule=f"{HVP_TOL} * max(1, max |CPU|)")


# ---------------------------------------------------------------------------
# the sharded DTCWT (parallel/, K19) in worlds of processes on the one card
# ---------------------------------------------------------------------------

# (label, (n_data, n_spatial_h, n_spatial), shape, J) per world size: the
# main path on every mesh, the banded path (halo 26) on four 'spatial'
# ranks
SHARDED_WORLDS = {
    2: [("main (2, 1)", (2, 1, 1), MAIN_SHAPE, 2),
        ("main (1, 2)", (1, 1, 2), MAIN_SHAPE, 2)],
    4: [("main (2, 2)", (2, 1, 2), MAIN_SHAPE, 2),
        ("main (1, 2, 2)", (1, 2, 2), MAIN_SHAPE, 2),
        ("banded (1, 4)", (1, 1, 4), BANDED_SHAPE, 3)]}
SHARDED_TOL = {"forward": 1e-5, "inverse": 2e-5, "x_grad": 2e-5}
SHARDED_DEADLINE = 480        # seconds a world may take, its start included
SHARDED_REPS = 3
SHARDED_LABEL = "gloo, one card, host-staged halos"
HALO_KERNELS = ("halo_pack", "halo_assemble", "halo_fold")
HALO_REPLACES = "pytorch_wavelets_tpu/parallel/halo.py:23"
K19_TILE = (10, 10, 128, 64)  # the main path's stage-1 tile on (1, 2)
K19_HALO = (10, 10)
# the stage-1 tile of a sharded DTCWT of 128x3x256x256 on 1 data x 2
# spatial ranks (its window, 58 MB, is past the 50 MB L2), along W and,
# transposed, along H
K19_LARGE_IMAGE = (128, 3, 256, 256)
K19_LARGE_TILE = (128, 3, 256, 128)


def _dt_chunk(full, dt):
    """The chunk of ``full`` that DTensor ``dt`` holds on this rank
    (``torch.chunk``'s split of every sharded dim)."""
    from torch.distributed.tensor import Shard
    mesh = dt.device_mesh
    names = mesh.mesh_dim_names
    for name, p in zip(names, dt.placements):
        if isinstance(p, Shard):
            n = mesh.size(names.index(name))
            s = -(-full.shape[p.dim] // n)
            start = min(full.shape[p.dim], mesh.get_local_rank(name) * s)
            full = full.narrow(p.dim, start, max(0, min(
                s, full.shape[p.dim] - start)))
    return full


def sharded_case(tt, ops, parallel, label, mesh_shape, shape, J):
    """One mesh on this rank: the counted forward, inverse and gradient
    of <rec, G0> + <yl, G1> + sum_j <yh_j, G2+j> through DTCWTForward /
    DTCWTInverse with ``mesh=``, against the port without a mesh on the
    card (:func:`sharded_run`).  The references and cotangents are then
    held on the host: at 9216² they are 11 GB a rank."""
    nd, nh, ns = mesh_shape
    mesh = parallel.make_mesh(nd, ns, nh)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).cuda()
    fwd_r = tt.DTCWTForward(J=J, device="cuda")
    inv_r = tt.DTCWTInverse(device="cuda")
    fwd = tt.DTCWTForward(J=J, device="cuda", mesh=mesh)
    inv = tt.DTCWTInverse(device="cuda", mesh=mesh)
    xr = x.clone().requires_grad_()
    yl, yh = fwd_r(xr)
    rec = inv_r((yl, yh))
    gs = [torch.randn(t.shape, generator=torch.Generator().manual_seed(1 + i))
          .cuda() for i, t in enumerate([rec, yl, *yh])]
    loss = sum((t * g).sum() for t, g in zip([rec, yl, *yh], gs))
    gref, = torch.autograd.grad(loss, xr)
    refs = [t.detach().cpu() for t in [rec, yl, *yh]]
    gs, gref = [g.cpu() for g in gs], gref.cpu()
    del xr, yl, yh, rec, loss
    torch.cuda.empty_cache()

    def step(z):
        ylm, yhm = fwd(z)
        recm = inv((ylm, yhm))
        return [recm, ylm, *yhm]
    return dict(label=label,
                mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                shape=list(shape), J=J,
                **sharded_run(ops, parallel, step, x, gs, refs, gref))


def sharded_run(ops, parallel, step, x, gs, refs, gref, fwd_only=False,
                reps=SHARDED_REPS):
    """The first call of ``step`` (a round trip returning [rec, *forward
    leaves] as DTensors, or with ``fwd_only`` the forward's leaves alone)
    without a gradient, timed (the host plans built, the operators put
    on the card) and counted; then the counted run of ``step`` and the
    gradient of sum_j <out_j, gs_j> on this rank, held against ``refs`` /
    ``gref`` from the card's run without a mesh (this rank's chunks;
    x.grad outside the rank's chunk must be 0), then the round trip and
    the step timed on the host clock (median of ``reps`` after a
    warm-up and a barrier).  Returns the first call's seconds and
    launches, the launches, K19's walks, the exchanges, the bytes staged,
    ``LAST_PATH``, the errors (the inverse's None with ``fwd_only``) and
    the times."""
    import torch.distributed as dist
    dist.barrier()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        step(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = {k: n for k, n in ops.launch_counts().items() if n}
    dist.barrier()
    ops.reset_launches()
    parallel.reset_staged_bytes()
    parallel.reset_exchanges()
    xs = x.clone().requires_grad_()
    outs = step(xs)
    # this rank's chunks of the cotangents, on its device (``refs``,
    # ``gs`` and ``gref`` may be held on the host)
    gl = [_dt_chunk(g, t).to(t.device) for t, g in zip(outs, gs)]
    lossm = sum((t.to_local() * g).sum() for t, g in zip(outs, gl))
    gm, = torch.autograd.grad(lossm, xs)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    walks = {k: ops.instantiation_counts()[k] for k in HALO_KERNELS}
    exchanges = dict(parallel.EXCHANGES)
    staged = dict(parallel.STAGED_BYTES)
    path = dict(parallel.LAST_PATH)
    k = 0 if fwd_only else 1
    err_fwd = max(max_err(t.to_local(), _dt_chunk(r, t).to(t.device))
                  for t, r in zip(outs[k:], refs[k:]))
    err_inv = None if fwd_only else max_err(
        outs[0].to_local(), _dt_chunk(refs[0], outs[0]).to(x.device))
    mask = torch.zeros_like(gm)
    _dt_chunk(mask, outs[0]).fill_(1.0)       # x is placed as rec
    err_grad = max_err(gm, gref.to(gm.device) * mask)
    del outs, gm, xs, mask

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    with torch.no_grad():
        rt_ms = timed(lambda: step(x))

    def train():
        z = x.clone().requires_grad_()
        o = step(z)
        torch.autograd.grad(sum((t.to_local() * g).sum()
                                for t, g in zip(o, gl)), z)
    return dict(
        path=path, first_call_s=first_s, first_call_launches=first,
        launches=counts,
        k1_launches=counts.get("apply_row", 0) + counts.get("apply_col", 0),
        k19_launches={k: counts.get(k, 0) for k in HALO_KERNELS},
        k19_walks=walks, exchanges=exchanges, staged_bytes=staged,
        max_abs_err={"forward": err_fwd, "inverse": err_inv,
                     "x_grad": err_grad},
        round_trip_ms=rt_ms, step_ms=timed(train))


def sharded_worker(rank, world, store, out_dir, cases, dwt_cases,
                   scat_cases, fallback_cases=()):
    """One rank of a gloo world on the card (every rank on cuda:0, the
    halos through pinned host memory): its DTCWT cases', its DWT / SWT
    cases', its scattering / per-level DTCWT cases' and its
    sharded_fallbacks cases' results to ``out_dir/rank<r>.json``; any
    failure exits non-zero."""
    import os
    import traceback
    try:
        import torch.distributed as dist
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        import pytorch_wavelets_tpu_torch as tt
        from pytorch_wavelets_tpu_torch import ops, parallel
        from pytorch_wavelets_tpu_torch.ops import afb_sfb, banded
        from pytorch_wavelets_tpu_torch.transforms import dwt
        res = {"dtcwt": [sharded_case(tt, ops, parallel, *case)
                         for case in cases],
               "dwt": [sharded_dwt_case(tt, ops, parallel, banded, afb_sfb,
                                        dwt, *case) for case in dwt_cases],
               "scat": [sharded_scat_case(tt, ops, parallel, *case)
                        for case in scat_cases],
               "fallback": [fallback_case(tt, ops, parallel, banded, *case)
                            for case in fallback_cases]}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def sharded_world(world, cases, dwt_cases, scat_cases, fallback_cases=()):
    """Run ``cases``, ``dwt_cases``, ``scat_cases`` and
    ``fallback_cases`` in a world of ``world`` processes, joined with
    SHARDED_DEADLINE; a failing or hung rank fails the phase.  Returns the
    ranks' results."""
    import multiprocessing as mp
    import os
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=sharded_worker,
                         args=(r, world, os.path.join(tmp, "store"), tmp,
                               cases, dwt_cases, scat_cases,
                               fallback_cases))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + SHARDED_DEADLINE
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    require(not hung, f"sharded_main: world of {world}: ranks {hung} still "
            f"running after {SHARDED_DEADLINE} s")
    codes = [p.exitcode for p in procs]
    require(codes == [0] * world, f"sharded_main: world of {world}: rank "
            f"exit codes {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def k19_exchange_gates(label, r, res):
    """One rank's K19 launches on one mesh: each exchange one pack and one
    assemble (forward) or fold (adjoint) launch, however many parts it
    carried; on the main meshes every launch on the vector walk."""
    ex, n = res["exchanges"], res["k19_launches"]
    require(n["halo_pack"] == ex["forward"] + ex["adjoint"]
            and n["halo_assemble"] == ex["forward"]
            and n["halo_fold"] == ex["adjoint"],
            f"sharded_main {label} rank {r}: K19 launches {n} for "
            f"exchanges {ex}")
    if label.startswith("main"):
        strided = {k: w["strided"] for k, w in res["k19_walks"].items()
                   if w["strided"]}
        require(not strided, f"sharded_main {label} rank {r}: K19 launches "
                f"off the vector walk {strided}")


# ---------------------------------------------------------------------------
# the sharded DWT, 1-D DWT and SWT (parallel/sharded_dwt.py) in the same
# worlds: the operator route (K19 and K1) and the conv halo route (K19 with
# the windows' K6 / K7 or K12 / K16)
# ---------------------------------------------------------------------------

# (label, kind, (n_data, n_spatial_h, n_spatial), mode, route) per world:
# kind 'dwt' (DWTForward J=3 db4 on DWT_SHAPE), 'swt' (SWTForward J=3 db4
# on SWT_SHAPE) or 'dwt1d' (DWT1DForward J=3 db4 on DWT1D_SHARD_SHAPE); the
# dwt1d cell's 65,536 samples are past the JAX sharded cap of 32,768
SHARDED_DWT_WORLDS = {
    2: [("dwt (1, 2)", "dwt", (1, 1, 2), "symmetric", "matmul"),
        ("dwt (2, 1)", "dwt", (2, 1, 1), "symmetric", "matmul"),
        ("dwt per (1, 2)", "dwt", (1, 1, 2), "periodization", "matmul"),
        ("dwt per (1, 2) conv", "dwt", (1, 1, 2), "periodization", "conv"),
        ("swt (1, 2)", "swt", (1, 1, 2), "periodization", "matmul"),
        ("swt (2, 1)", "swt", (2, 1, 1), "periodization", "matmul"),
        ("swt (1, 2) conv", "swt", (1, 1, 2), "periodization", "conv"),
        ("dwt1d (1, 2)", "dwt1d", (1, 1, 2), "zero", "matmul")],
    4: [("dwt (1, 4)", "dwt", (1, 1, 4), "symmetric", "matmul"),
        ("dwt (1, 2, 2)", "dwt", (1, 2, 2), "symmetric", "matmul"),
        ("swt (1, 4)", "swt", (1, 1, 4), "periodization", "matmul"),
        ("swt (1, 2, 2)", "swt", (1, 2, 2), "periodization", "matmul"),
        ("swt (1, 4) conv", "swt", (1, 1, 4), "periodization", "conv"),
        ("dwt1d (1, 4)", "dwt1d", (1, 1, 4), "zero", "matmul")]}
DWT1D_SHARD_SHAPE = (16, 8, 4096)
SHARDED_DWT_J, SHARDED_DWT_WAVE = 3, "db4"
SHARDED_DWT_ENTRIES = {"dwt": ("dwt2d", "idwt2d"),
                       "dwt1d": ("dwt1d", "idwt1d"),
                       "swt": ("swt2d", "iswt2d")}
WINDOW_KERNELS = ("afb1d_window", "sfb1d_window", "afb1d_atrous_window",
                  "sfb1d_atrous_window")


def _dwt_kind(tt, kind, mode, mesh=None):
    """The (forward, inverse) modules of a sharded_dwt case, without a
    mesh where ``mesh`` is None."""
    w, J = SHARDED_DWT_WAVE, SHARDED_DWT_J
    cls = {"dwt": (tt.DWTForward, tt.DWTInverse),
           "dwt1d": (tt.DWT1DForward, tt.DWT1DInverse),
           "swt": (tt.SWTForward, tt.SWTInverse)}[kind]
    return (cls[0](J=J, wave=w, mode=mode, mesh=mesh, device="cuda"),
            cls[1](wave=w, mode=mode, mesh=mesh, device="cuda"))


def _dwt_shape(kind):
    return {"dwt": DWT_SHAPE, "swt": SWT_SHAPE,
            "dwt1d": DWT1D_SHARD_SHAPE}[kind]


def exact_dwt_round_trip(afb, dwt, x, mode):
    """The 2-D DWT round trip without a mesh whose backward is the exact
    transpose (``ops.afb2d`` / ``ops.sfb2d``: K6 / K7 forward, K14's /
    K15's adjoints backward), as the sharded route's is: ``DWTForward``'s
    backward is the reference's, the transpose only in 'zero' mode.
    Returns [rec, yl, *yh]."""
    dec = dwt.dec_filters(SHARDED_DWT_WAVE)
    rec = dwt.rec_filters(SHARDED_DWT_WAVE)
    ll, yh = x, []
    for _ in range(SHARDED_DWT_J):
        # the first pair along W, as transforms/dwt.py:dwt2d
        y = afb.afb2d(ll, dec[2], dec[3], dec[0], dec[1], mode)
        ll = y[:, :, 0]
        yh.append(y[:, :, 1:])
    r = ll
    for h in yh[::-1]:
        r = r[..., :h.shape[-2], :h.shape[-1]]
        r = afb.sfb2d(r, h[:, :, 0], h[:, :, 1], h[:, :, 2], rec[2], rec[3],
                      rec[0], rec[1], mode)
    return [r, ll, *yh]


def _leaves_of(kind, out, rec):
    """[rec, *forward leaves] of a round trip."""
    return [rec, *(out if kind == "swt" else [out[0], *out[1]])]


def sharded_dwt_case(tt, ops, parallel, banded, afb, dwt, label, kind,
                     mesh_shape, mode, route):
    """One sharded DWT / SWT mesh on this rank: the counted round trip and
    the gradient of <rec, G0> + sum_j <leaf_j, G1+j> through the modules
    with ``mesh=`` on ``route`` ('matmul': ``set_operator_matmul(None)``,
    'conv': ``(False)``), against the card's run without a mesh (this
    rank's chunks, :func:`sharded_run`; the 2-D DWT's gradient against
    :func:`exact_dwt_round_trip`)."""
    nd, nh, ns = mesh_shape
    mesh = parallel.make_mesh(nd, ns, nh)
    shape = _dwt_shape(kind)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).cuda()
    fwd_r, inv_r = _dwt_kind(tt, kind, mode)
    fwd, inv = _dwt_kind(tt, kind, mode, mesh)
    with torch.no_grad():
        out_r = fwd_r(x)
        refs = _leaves_of(kind, out_r, inv_r(out_r))
    gs = [torch.randn(t.shape, generator=torch.Generator().manual_seed(1 + i))
          .cuda() for i, t in enumerate(refs)]
    xr = x.clone().requires_grad_()
    if kind == "dwt":
        trip = exact_dwt_round_trip(afb, dwt, xr, mode)
    else:
        out = fwd_r(xr)
        trip = _leaves_of(kind, out, inv_r(out))
    gref, = torch.autograd.grad(sum((t * g).sum() for t, g in zip(trip, gs)),
                                xr)
    del trip, xr

    def step(z):
        o = fwd(z)
        return _leaves_of(kind, o, inv(o))
    banded.set_operator_matmul(False if route == "conv" else None)
    try:
        res = sharded_run(ops, parallel, step, x, gs, refs, gref)
    finally:
        banded.set_operator_matmul(None)
    res["path"] = {e: res["path"][e] for e in SHARDED_DWT_ENTRIES[kind]}
    res["window_launches"] = {k: res["launches"].get(k, 0)
                              for k in WINDOW_KERNELS}
    return dict(label=label, kind=kind, mode=mode, route=route,
                mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                shape=list(shape), J=SHARDED_DWT_J, wave=SHARDED_DWT_WAVE,
                **res)


def sharded_dwt_gates(label, r, res, nh, ns):
    """One rank's checks of a sharded_dwt mesh: within SHARDED_TOL, the
    route asked for, K1 on the operator route, K19 where a spatial axis
    is sharded and on the conv route, the windows' kernels on the conv
    route (K6 / K7 for the DWT, K12 / K16 for the SWT), one K19 launch an
    exchange and pass."""
    for what, tol in SHARDED_TOL.items():
        require(res["max_abs_err"][what] <= tol,
                f"sharded_dwt {label} rank {r}: {what} differs from the "
                f"card's run without a mesh by {res['max_abs_err'][what]} "
                f"(limit {tol})")
    require(set(res["path"].values()) == {res["route"]},
            f"sharded_dwt {label} rank {r}: path {res['path']}, route "
            f"{res['route']}")
    n19 = sum(res["k19_launches"].values())
    win = res["window_launches"]
    if res["route"] == "conv":
        want = (("afb1d_window", "sfb1d_window") if res["kind"] == "dwt"
                else ("afb1d_atrous_window", "sfb1d_atrous_window"))
        require(n19 > 0 and all(win[k] > 0 for k in want),
                f"sharded_dwt {label} rank {r}: K19 {res['k19_launches']} "
                f"and windows {win} on the conv route")
    else:
        require(res["k1_launches"] > 0 and not any(win.values()),
                f"sharded_dwt {label} rank {r}: K1 launches "
                f"{res['k1_launches']}, windows {win}")
        require(n19 > 0 if nh * ns > 1 else n19 == 0,
                f"sharded_dwt {label} rank {r}: K19 launches "
                f"{res['k19_launches']}")
    k19_exchange_gates(label, r, res)


def sharded_dwt_phase(smi, worlds, seconds):
    """Emit the sharded_dwt phase of every world (every rank's results
    gated by :func:`sharded_dwt_gates`); returns every kernel's launches
    summed over every rank of every mesh."""
    total = {}
    for world, cases in SHARDED_DWT_WORLDS.items():
        meshes = []
        for i, (label, kind, (nd, nh, ns), mode, route) in enumerate(cases):
            per_rank = [worlds[world][r]["dwt"][i] for r in range(world)]
            for r, res in enumerate(per_rank):
                sharded_dwt_gates(label, r, res, nh, ns)
                for k, n in res["launches"].items():
                    total[k] = total.get(k, 0) + n
            meshes.append(dict(
                label=label, kind=kind, mode=mode, route=route,
                mesh=per_rank[0]["mesh"], shape=per_rank[0]["shape"],
                J=SHARDED_DWT_J, wave=SHARDED_DWT_WAVE, ranks=per_rank,
                max_abs_err={w: max(r["max_abs_err"][w] for r in per_rank)
                             for w in SHARDED_TOL},
                round_trip_ms=max(r["round_trip_ms"] for r in per_rank),
                step_ms=max(r["step_ms"] for r in per_rank)))
        emit("sharded_dwt", world=world, timing_label=SHARDED_LABEL,
             nvidia_smi=smi, tolerance=SHARDED_TOL,
             world_seconds_with_sharded_main=seconds[world], meshes=meshes)
    emit("sharded_dwt_launches", launches=total)
    return total


# ---------------------------------------------------------------------------
# the sharded scattering layers (parallel/sharded_scat.py) and the per-level
# sharded DTCWT (parallel/sharded.py) in the same worlds
# ---------------------------------------------------------------------------

# (label, kind, (n_data, n_spatial_h, n_spatial), shape, route) per world:
# kind 'j2' (ScatLayerj2()), 'j2_colour' (ScatLayerj2(combine_colour=True)),
# 'j1' (ScatLayer()) or 'dtcwt' (DTCWTForward(J=LARGE_J) -> DTCWTInverse, a
# round trip); route the LAST_PATH each entry must name: 'matmul' the
# composed fronts, 'perlevel' level by level (LARGE_SHAPE's 9216 is past
# MAX_MATMUL_N).  Both 9216² cases run in the world of 2, so that at most
# two ranks hold their runs without a mesh on the card at once.
SCAT_ODD_SHAPE = (128, 3, 255, 255)        # ScatLayer pads it even
SCAT_ODD_BATCH_SHAPE = (15, 3, 256, 256)   # 15 does not divide over 'data'
SHARDED_SCAT_WORLDS = {
    2: [("scat_j2 (1, 2)", "j2", (1, 1, 2), SCAT_SHAPE, "matmul"),
        ("scat_j1 (1, 2) odd", "j1", (1, 1, 2), SCAT_ODD_SHAPE, "matmul"),
        ("perlevel dtcwt (1, 2)", "dtcwt", (1, 1, 2), LARGE_SHAPE,
         "perlevel"),
        ("scat_j1 giant (1, 2)", "j1", (1, 1, 2), LARGE_SHAPE, "perlevel")],
    4: [("scat_j2 (1, 2, 2)", "j2", (1, 2, 2), SCAT_SHAPE, "matmul"),
        ("scat_j2 colour (2, 2)", "j2_colour", (2, 1, 2),
         SCAT_ODD_BATCH_SHAPE, "matmul")]}
SCAT_SHARDED_TOL = {"forward": 2e-5, "inverse": 2e-5, "x_grad": 2e-5}
SCAT_ENTRIES = {"j2": ("scat_j2",), "j2_colour": ("scat_j2",),
                "j1": ("scat_j1",), "dtcwt": ("dtcwt2d", "idtcwt2d")}


def _scat_layer(tt, kind, mesh=None):
    """The scattering layer of a sharded_scat case, without a mesh where
    ``mesh`` is None."""
    cls = tt.ScatLayer if kind == "j1" else tt.ScatLayerj2
    kw = {"combine_colour": True} if kind == "j2_colour" else {}
    return cls(mesh=mesh, device="cuda", **kw)


def sharded_scat_case(tt, ops, parallel, label, kind, mesh_shape, shape,
                      route):
    """One scattering or per-level DTCWT mesh on this rank: the card's
    run without a mesh first (for 'dtcwt' :func:`sharded_case`'s round
    trip and loss, else the layer and the gradient of <out, G>), then
    with ``mesh=`` (:func:`sharded_run`: the first call, whose host plans
    and operators a 9216² run holds GBs of, the counted run and the
    times).  The backward's launches are the counted run's less the first
    call's."""
    import gc

    from pytorch_wavelets_tpu_torch.parallel import sharded
    gc.collect()
    torch.cuda.empty_cache()
    if kind == "dtcwt":
        res = sharded_case(tt, ops, parallel, label, mesh_shape, shape,
                           LARGE_J)
    else:
        nd, nh, ns = mesh_shape
        mesh = parallel.make_mesh(nd, ns, nh)
        x = torch.randn(shape,
                        generator=torch.Generator().manual_seed(0)).cuda()
        xr = x.clone().requires_grad_()
        out = _scat_layer(tt, kind)(xr)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            1)).cuda()
        gref, = torch.autograd.grad((out * g).sum(), xr)
        refs, g, gref = [out.detach().cpu()], g.cpu(), gref.cpu()
        del out, xr
        m = _scat_layer(tt, kind, mesh)
        res = dict(label=label,
                   mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                   shape=list(shape),
                   **sharded_run(ops, parallel, lambda z: [m(z)], x, [g],
                                 refs, gref, fwd_only=True))
        res["forward_ms"] = res.pop("round_trip_ms")
        del refs, g, gref, x, m
    first = res["first_call_launches"]
    res["path"] = {e: res["path"].get(e) for e in SCAT_ENTRIES[kind]}
    res.update(kind=kind, route=route, backward_launches={
        k: n - first.get(k, 0) for k, n in res["launches"].items()
        if n > first.get(k, 0)})
    # the 9216² plans hold GBs of operators on the card
    sharded._dtcwt_fwd_perlevel_shard_plans.cache_clear()
    sharded._dtcwt_inv_perlevel_shard_plans.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_scat_gates(label, r, res, nh, ns):
    """One rank's checks of a sharded_scat mesh: within SCAT_SHARDED_TOL,
    the route named, K1 launched; the scattering layers' first call (a
    forward) launching K2 and K4 and their backward K3 and K5, the
    per-level fronts K11 both ways and the composed ones none (the pool is
    composed into their operators); the DTCWT round trip K2 and K3 both
    ways; K19 where a spatial axis is sharded, one launch an exchange and
    pass."""
    for what, tol in SCAT_SHARDED_TOL.items():
        err = res["max_abs_err"][what]
        require(err is None or err <= tol,
                f"sharded_scat {label} rank {r}: {what} differs from the "
                f"card's run without a mesh by {err} (limit {tol})")
    require(set(res["path"].values()) == {res["route"]},
            f"sharded_scat {label} rank {r}: path {res['path']}, route "
            f"{res['route']}")
    require(res["k1_launches"] > 0,
            f"sharded_scat {label} rank {r}: K1 never launched")
    fwd, bwd = res["first_call_launches"], res["backward_launches"]
    if res["kind"] == "dtcwt":
        need = (("q2c_pack", "c2q_unpack"), ("q2c_pack", "c2q_unpack"))
    else:
        need = (("q2c_pack", "scat_mag_fwd"),
                ("c2q_unpack", "scat_mag_bwd"))
        pools = {k: fwd.get(k, 0) + bwd.get(k, 0) for k in POOLS}
        if res["route"] == "perlevel":
            need = (need[0] + ("avg_pool2_fwd",),
                    need[1] + ("avg_pool2_bwd",))
        else:
            require(not any(pools.values()), f"sharded_scat {label} rank "
                    f"{r}: K11 launched on the composed fronts: {pools}")
    require(all(fwd.get(k, 0) > 0 for k in need[0])
            and all(bwd.get(k, 0) > 0 for k in need[1]),
            f"sharded_scat {label} rank {r}: first call {fwd}, backward "
            f"{bwd}; need {need}")
    n19 = sum(res["k19_launches"].values())
    require(n19 > 0 if nh * ns > 1 else n19 == 0,
            f"sharded_scat {label} rank {r}: K19 launches "
            f"{res['k19_launches']}")
    k19_exchange_gates(label, r, res)


def sharded_scat_phase(smi, worlds, seconds):
    """Emit the sharded_scat phase of every world (every rank's results
    gated by :func:`sharded_scat_gates`); returns every kernel's launches
    summed over every rank of every mesh."""
    total = {}
    for world, cases in SHARDED_SCAT_WORLDS.items():
        meshes = []
        for i, (label, kind, (_, nh, ns), shape, route) in enumerate(
                cases):
            per_rank = [worlds[world][r]["scat"][i] for r in range(world)]
            for r, res in enumerate(per_rank):
                sharded_scat_gates(label, r, res, nh, ns)
                for k, n in res["launches"].items():
                    total[k] = total.get(k, 0) + n
            ms = "round_trip_ms" if kind == "dtcwt" else "forward_ms"
            meshes.append({
                "label": label, "kind": kind, "route": route,
                "mesh": per_rank[0]["mesh"], "shape": list(shape),
                "ranks": per_rank,
                "max_abs_err": {
                    w: max((r["max_abs_err"][w] for r in per_rank
                            if r["max_abs_err"][w] is not None),
                           default=None) for w in SCAT_SHARDED_TOL},
                ms: max(r[ms] for r in per_rank),
                "step_ms": max(r["step_ms"] for r in per_rank),
                "first_call_s": max(r["first_call_s"] for r in per_rank),
                "staged_bytes": max(sum(r["staged_bytes"].values())
                                    for r in per_rank)})
        emit("sharded_scat", world=world, timing_label=SHARDED_LABEL,
             nvidia_smi=smi, tolerance=SCAT_SHARDED_TOL,
             world_seconds_with_sharded_main=seconds[world], meshes=meshes)
    emit("sharded_scat_launches", launches=total)
    return total


def sharded_scat_k1_rows(tt, banded, sharded, sharded_scat, launches):
    """K1 on rank 0's block of three stage-1 operators on (1, 2), each over
    its halo'd window, against its plain version and ``torch.matmul``:
    ScatLayerj2's two composed fronts on SCAT_SHAPE (orders 1 + 2 on the
    image; order 2 on the 6C first-order magnitudes at half size) and the
    per-level DTCWT's level 1 on LARGE_SHAPE.  ``launches`` are the
    sharded_scat meshes' (every rank)."""
    f = tt.ScatLayerj2(device="cpu")._filters
    taps = tuple(f[k] for k in ("h0o", "h1o", "h0a", "h1a", "h0b", "h1b"))
    N, C, H, W = SCAT_SHAPE
    dt = _k19_filters()
    (lev, _), = sharded._fwd_level_plans(
        *(dt[k] for k in ("h0o", "h1o", "h0a", "h1a", "h0b", "h1b")), 1,
        (False,), "symmetric", *LARGE_SHAPE[2:])
    cases = (
        (f"ScatLayerj2 orders 1 + 2 front, {shape_str(SCAT_SHAPE)}",
         (N, C, H), sharded_scat._scat_shard_plans(
             *taps, 2, "symmetric", H, W, 2, 1)[0]),
        ("ScatLayerj2 order 2 front, "
         f"{shape_str((N, 6 * C, H // 2, W // 2))}",
         (N, 6 * C, H // 2), sharded_scat._scat_shard_plans(
             *taps, 1, "symmetric", H // 2, W // 2, 2, 1)[0]),
        (f"per-level DTCWT level 1, {shape_str(LARGE_SHAPE)}",
         LARGE_SHAPE[:3], sharded._pyramid_shard_op((lev,), LARGE_SHAPE[3],
                                                    2)))
    gen = torch.Generator().manual_seed(7)
    rows = []
    for label, lead, st in cases:
        B, _ = st.obj.local(0, "cuda")    # the stage-1 'shard' strategy
        win = torch.randn((*lead, B.shape[1]), generator=gen).cuda()
        rows.append(k1_block_row(banded, f"{label} on (1, 2)", B, win,
                                 launches, LARGE_REPLAY_TIMING))
        del win, B
        torch.cuda.empty_cache()
    return rows


# the windows' calls on the conv route's meshes of SHARDED_DWT_WORLDS, per
# level: the tiles of a (1, n) mesh, and edge cases (a window as wide as
# its halo, odd tiles along H); tolerance DWT_TOL
WINDOW_REPLACES = {
    "afb1d_window": "pytorch_wavelets_tpu/parallel/sharded.py:253",
    "sfb1d_window": "pytorch_wavelets_tpu/parallel/sharded.py:296",
    "afb1d_atrous_window": "pytorch_wavelets_tpu/parallel/sharded.py:1946",
    "sfb1d_atrous_window": "pytorch_wavelets_tpu/parallel/sharded.py:1969"}
WINDOW_SOURCES = {"afb1d_window": ("dwt_afb", "dwt_afb.cu"),
                  "sfb1d_window": ("dwt_sfb", "dwt_sfb.cu"),
                  "afb1d_atrous_window": ("swt_afb", "swt_atrous.cu"),
                  "sfb1d_atrous_window": ("swt_sfb", "swt_atrous.cu")}


def window_calls(afb, dwt, n_sp, shapes=None):
    """The window applies of the conv route on a (1, n_sp) mesh: per
    level, the DWT's K6 split of its (L - 1 - L/2, L/2 - 1)-halo'd W tile
    and the adjoint merge (K7, s = 0), the inverse's K7 merge of its (lo,
    hi) windows and the adjoint split (K6, front s), the SWT's K12 split
    and K16 merge of their dilated windows: [(kernel, role, args)] on
    random windows of the card, at the DWT_SHAPE / SWT_SHAPE tiles (or
    ``shapes``: {'dwt': (N, C, H, W), 'swt': ...} for the edge cases)."""
    shapes = shapes or {"dwt": DWT_SHAPE, "swt": SWT_SHAPE}
    dec = dwt.dec_filters(SHARDED_DWT_WAVE)
    rec = dwt.rec_filters(SHARDED_DWT_WAVE)
    h = tuple(np.asarray(f, dtype=np.float64)[::-1].copy() for f in dec[:2])
    g = tuple(np.asarray(f, dtype=np.float64) for f in rec[:2])
    L = len(h[0])
    L2 = L // 2
    gen = torch.Generator().manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).cuda()
    calls = []
    N, C, H, W = shapes["dwt"]
    w = W // n_sp
    for j in range(SHARDED_DWT_J):
        Hj, wj = -(-H // 2 ** j), w >> j
        nw = wj + L - 1 - L2 + max(L2 - 1, 0)
        m = (nw - L) // 2 + 1
        calls.append(("afb1d_window", "split", (rnd(N, C, Hj, nw), *h, 3, 0,
                                                m)))
        calls.append(("sfb1d_window", "split's adjoint", (
            rnd(N, C, Hj, m), rnd(N, C, Hj, m), *h, 3, 0, nw)))
        hl, hr = (L2 + 1) // 2, L2 // 2
        nwi = wj // 2 + hl + hr
        win = rnd(N, C, Hj, 2 * nwi)
        s = 2 * hl - L2 + L - 1
        calls.append(("sfb1d_window", "merge", (
            win.narrow(3, 0, nwi), win.narrow(3, nwi, nwi), *g, 3, s, wj)))
        calls.append(("afb1d_window", "merge's adjoint", (
            rnd(N, C, Hj, wj), *g, 3, s, nwi)))
    N, C, H, W = shapes["swt"]
    w = W // n_sp
    for j in range(SHARDED_DWT_J):
        d = 2 ** j
        Ld2 = L * d // 2
        calls.append(("afb1d_atrous_window", "split", (
            rnd(N, C, H, w + 2 * Ld2 - d), *h, 3, d)))
        front, back = Ld2, L * d - d - Ld2
        win = rnd(N, C, H, 2 * (w + front + back))
        nw = w + front + back
        calls.append(("sfb1d_atrous_window", "merge", (
            win.narrow(3, 0, nw), win.narrow(3, nw, nw), *g, 3, d)))
    return calls


def _window_parts(afb, call):
    """(got, want, run, plain, lib, ops, bytes) of one window call: ``lib``
    the one cuDNN call computing the same function (K6: ``F.conv2d``
    stride 2, padding front, of the window; K7: ``F.conv_transpose2d``
    stride 2, padding s, of (lo, hi) as two channels (each where its
    length is the window's m);
    K12: ``F.conv2d`` dilated; K16: ``F.conv2d`` dilated of (lo, hi) as
    two channels, the halved taps)."""
    import torch.nn.functional as F
    name, _, args = call
    fn = getattr(afb, name)
    plain = getattr(afb, name + "_plain")
    got = fn(*args)
    want = plain(*args)
    run = lambda: fn(*args)                                  # noqa: E731
    plain_run = lambda: plain(*args)                         # noqa: E731
    lib = None
    if name == "afb1d_window":
        x, h0, h1, axis, front, m = args
        L = len(h0)
        xin = x.reshape(-1, 1, *x.shape[2:])
        wt = torch.tensor(np.stack([h0, h1]), dtype=torch.float32,
                          device=x.device).view(2, 1, 1, L)
        if (x.shape[3] + 2 * front - L) // 2 + 1 == m:
            lib = lambda: F.conv2d(xin, wt, stride=(1, 2),   # noqa: E731
                                   padding=(0, front))
        nin = x.numel()
    elif name == "sfb1d_window":
        lo, hi, g0, g1, axis, s, m = args
        L = len(g0)
        N, C, H, n = lo.shape
        xin = torch.stack([lo, hi], dim=2).reshape(N * C, 2, H, n)
        wt = torch.tensor(np.stack([g0, g1]), dtype=torch.float32,
                          device=lo.device).view(2, 1, 1, L)
        if (n - 1) * 2 - 2 * s + L == m:
            lib = lambda: F.conv_transpose2d(                # noqa: E731
                xin, wt, stride=(1, 2), padding=(0, s))
        nin = lo.numel() + hi.numel()
    elif name == "afb1d_atrous_window":
        x, h0, h1, axis, d = args
        L = len(h0)
        xin = x.reshape(-1, 1, *x.shape[2:])
        wt = torch.tensor(np.stack([h0, h1]), dtype=torch.float32,
                          device=x.device).view(2, 1, 1, L)
        lib = lambda: F.conv2d(xin, wt, dilation=(1, d))     # noqa: E731
        nin = x.numel()
    else:
        lo, hi, g0, g1, axis, d = args
        L = len(g0)
        N, C, H, n = lo.shape
        xin = torch.stack([lo, hi], dim=2).reshape(N * C, 2, H, n)
        wt = 0.5 * torch.tensor(np.stack([g0[::-1], g1[::-1]]).copy(),
                                dtype=torch.float32,
                                device=lo.device).view(1, 2, 1, L)
        lib = lambda: F.conv2d(xin, wt, dilation=(1, d))     # noqa: E731
        nin = lo.numel() + hi.numel()
    if lib is not None:   # the yardstick computes the same function
        ref = lib().reshape(want.shape)
        require(torch.allclose(ref, want, **DWT_TOL),
                f"{name}: the library yardstick differs from the plain "
                f"version")
    # multiply-adds an output: L (K16's merge: L of lo and L of hi)
    ops_ = 2.0 * L * got.numel() * (2 if name == "sfb1d_atrous_window"
                                    else 1)
    nbytes = 4.0 * (nin + got.numel())
    return got, want, run, plain_run, lib, ops_, nbytes


def window_rows(afb, dwt, launches, timing=LARGE_REPLAY_TIMING):
    """The window applies' kernel rows: each call of :func:`window_calls`
    on the (1, 2) conv route's tiles checked against its plain version
    (DWT_TOL) and timed beside it and its library call; ``launches`` the
    windows' launches on the sharded_dwt meshes (every rank)."""
    agg = {}
    for call in window_calls(afb, dwt, 2):
        got, want, run, plain, lib, ops_, nbytes = _window_parts(afb, call)
        err = max_err(got, want)
        require(within(got, want, DWT_TOL),
                f"{call[0]} ({call[1]}): differs from its plain version by "
                f"{err}")
        a = agg.setdefault(call[0], dict(err=0.0, ms=0.0, plain=0.0,
                                         lib=0.0, haslib=True, op=0.0,
                                         byte=0.0, per_call=[]))
        ms = timed_ms(run, *timing)
        plain_ms = timed_ms(plain, *timing)
        lib_ms = timed_ms(lib, *timing) if lib else None
        bound = max(ops_ / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        a["err"] = max(a["err"], err)
        a["ms"] += ms
        a["plain"] += plain_ms
        a["haslib"] &= lib_ms is not None
        a["lib"] += lib_ms or 0.0
        a["op"] += ops_ / PEAK_FP32_FLOPS * 1e3
        a["byte"] += nbytes / PEAK_HBM_BYTES * 1e3
        a["per_call"].append([f"{shape_str(call[2][0].shape)} {call[1]}", ms,
                              plain_ms, lib_ms, bound])
        del got, want
    rows = []
    for name, a in agg.items():
        swt = "atrous" in name
        rows.append({
            "name": f"{WINDOW_SOURCES[name][0]} window plan (sharded "
                    f"{'SWT' if swt else 'DWT'} conv route, "
                    f"{shape_str(SWT_SHAPE if swt else DWT_SHAPE)} on "
                    f"(1, 2))",
            "route": "cuda",
            "source": "pytorch_wavelets_tpu_torch/csrc/"
                      f"{WINDOW_SOURCES[name][1]}",
            "replaces": WINDOW_REPLACES[name],
            "launches": launches.get(name, 0), "max_abs_err": a["err"],
            "tolerance": DWT_TOL, "ms": a["ms"], "plain_ms": a["plain"],
            "bound_ms": max(a["op"], a["byte"]),
            "bound_by": "bytes" if a["byte"] >= a["op"] else "operations",
            "library_ms": a["lib"] if a["haslib"] else None,
            "per_call": a["per_call"]})
    return rows


def sharded_dwt_k1_rows(banded, sd, launches):
    """K1 on rank 0's block of three operators the sharded_dwt meshes
    apply on (1, 2): the DWT's level-0 split along W (zero-embedded,
    'symmetric', DWT_SHAPE), the SWT's level-0 split and the ISWT's
    level-0 averaging merge along W (circular, SWT_SHAPE), each over its
    halo'd window, against its plain version and ``torch.matmul``.
    ``launches`` are the sharded_dwt meshes' (every rank)."""
    rev = sd._rev
    dec = sd.dec_filters(SHARDED_DWT_WAVE)
    rec = sd._iswt_synth_filters(SHARDED_DWT_WAVE)
    W_d, W_s = DWT_SHAPE[3], SWT_SHAPE[3]
    cases = (
        ("DWT split, symmetric, level 0", DWT_SHAPE,
         sd._dwt_mode_split_strategies(sd._dwt_taps(SHARDED_DWT_WAVE)[0],
                                       "symmetric", W_d, 2,
                                       SHARDED_DWT_J)[0][0]),
        ("SWT split, periodization, level 0", SWT_SHAPE,
         sd._swt_split_strategies((rev(dec[2]), rev(dec[3])), W_s, 2,
                                  SHARDED_DWT_J)[0]),
        ("ISWT averaging merge, periodization, level 0", SWT_SHAPE,
         sd._swt_merge_strategies((sd._fwd(rec[2]), sd._fwd(rec[3])), W_s,
                                  2, SHARDED_DWT_J)[0]))
    gen = torch.Generator().manual_seed(5)
    rows = []
    for label, shape, strat in cases:
        require(strat.kind == "shard", f"sharded_dwt_k1_rows: {label} is "
                f"{strat.kind}")
        B, _ = strat.obj.local(0, "cuda")
        win = torch.randn((*shape[:3], B.shape[1]), generator=gen).cuda()
        rows.append(k1_block_row(banded, f"{label} on (1, 2)", B, win,
                                 launches, LARGE_REPLAY_TIMING))
        del win
    return rows


def window_edge_cases(ops, afb, dwt):
    """The window applies at edge cases against their plain versions
    (DWT_TOL): small tiles (two samples at the deepest DWT level, whose
    windows are mostly halo; SWT tiles narrower than the dilated halo of
    d = 4) and odd heights, on 1, 2 and 4 'spatial' ranks' tiles.  Returns
    (calls, max error, instantiations)."""
    n, err = 0, 0.0
    insts = {}
    cases = [({"dwt": (2, 3, 9, 8), "swt": (2, 3, 7, 8)}, 1),
             ({"dwt": (3, 2, 17, 16), "swt": (3, 2, 5, 64)}, 2),
             ({"dwt": (1, 5, 33, 64), "swt": (1, 1, 31, 112)}, 4)]
    for shapes, n_sp in cases:
        for call in window_calls(afb, dwt, n_sp, shapes):
            before = ops.instantiation_counts()
            got, want = getattr(afb, call[0])(*call[2]), getattr(
                afb, call[0] + "_plain")(*call[2])
            after = ops.instantiation_counts()
            e = max_err(got, want)
            require(within(got, want, DWT_TOL),
                    f"window_edge_cases {call[0]} ({call[1]}) on "
                    f"{shape_str(call[2][0].shape)}: differs from its plain "
                    f"version by {e}")
            err = max(err, e)
            n += 1
            for k in WINDOW_KERNELS:
                for w, c in after[k].items():
                    if c != before[k][w]:
                        insts.setdefault(k, {})
                        insts[k][w] = insts[k].get(w, 0) + c - before[k][w]
    return n, err, insts


def sharded_main(smi):
    """Every world of SHARDED_WORLDS: per mesh, every rank's results within
    SHARDED_TOL of the card's run without a mesh, the composed route
    taken, K1 launched on every rank and K19 on every rank of a mesh with
    a sharded spatial axis (none where no spatial axis is sharded), one
    K19 launch an exchange and pass (``k19_exchange_gates``).  Emits
    K19's launches, walks and exchanges summed over every rank of every
    mesh beside the launches one a part would take.  The same worlds run
    the sharded_dwt and sharded_scat cases (:func:`sharded_dwt_phase` and
    :func:`sharded_scat_phase` read them).
    Returns every kernel's launches summed over every rank of every
    DTCWT mesh, K19's launches an exchange, the worlds' results by rank
    and each world's seconds."""
    total = {}
    walks = {k: {} for k in HALO_KERNELS}
    exchanges = {}
    worlds, world_s = {}, {}
    for world, cases in SHARDED_WORLDS.items():
        t0 = time.perf_counter()
        ranks = worlds[world] = sharded_world(
            world, cases, SHARDED_DWT_WORLDS[world],
            SHARDED_SCAT_WORLDS[world], SHARDED_FALLBACK_WORLDS[world])
        seconds = world_s[world] = time.perf_counter() - t0
        meshes = []
        for i, (label, (nd, nh, ns), shape, J) in enumerate(cases):
            per_rank = [ranks[r]["dtcwt"][i] for r in range(world)]
            for r, res in enumerate(per_rank):
                for what, tol in SHARDED_TOL.items():
                    require(res["max_abs_err"][what] <= tol,
                            f"sharded_main {label} rank {r}: {what} differs "
                            f"from the card's run without a mesh by "
                            f"{res['max_abs_err'][what]} (limit {tol})")
                require(res["path"] == {"dtcwt2d": "matmul",
                                        "idtcwt2d": "matmul"},
                        f"sharded_main {label} rank {r}: path {res['path']}")
                require(res["k1_launches"] > 0,
                        f"sharded_main {label} rank {r}: K1 never launched")
                n19 = sum(res["k19_launches"].values())
                require(n19 > 0 if nh * ns > 1 else n19 == 0,
                        f"sharded_main {label} rank {r}: K19 launches "
                        f"{res['k19_launches']}")
                k19_exchange_gates(label, r, res)
                for k, n in res["launches"].items():
                    total[k] = total.get(k, 0) + n
                for k, w in res["k19_walks"].items():
                    for name, n in w.items():
                        walks[k][name] = walks[k].get(name, 0) + n
                for k, n in res["exchanges"].items():
                    exchanges[k] = exchanges.get(k, 0) + n
            meshes.append(dict(
                label=label, mesh=per_rank[0]["mesh"], shape=list(shape),
                J=J, ranks=per_rank,
                max_abs_err={w: max(r["max_abs_err"][w] for r in per_rank)
                             for w in SHARDED_TOL},
                round_trip_ms=max(r["round_trip_ms"] for r in per_rank),
                step_ms=max(r["step_ms"] for r in per_rank)))
        emit("sharded_main", world=world, timing_label=SHARDED_LABEL,
             nvidia_smi=smi, tolerance=SHARDED_TOL,
             seconds_with_sharded_dwt=seconds, meshes=meshes)
    emit("sharded_k19", launches={k: total.get(k, 0) for k in HALO_KERNELS},
         walks=walks, exchanges=exchanges,
         launches_one_a_part={
             "halo_pack": exchanges.get("forward_parts", 0)
             + exchanges.get("adjoint_parts", 0),
             "halo_assemble": exchanges.get("forward_parts", 0),
             "halo_fold": exchanges.get("adjoint_parts", 0)},
         launches_per_exchange=k19_per_exchange(total, exchanges))
    return total, k19_per_exchange(total, exchanges), worlds, world_s


def k19_per_exchange(launches, exchanges):
    """K19's launches an exchange, by entry (pack: every exchange; assemble:
    the windows'; fold: their adjoints')."""
    n = {"halo_pack": exchanges.get("forward", 0)
         + exchanges.get("adjoint", 0),
         "halo_assemble": exchanges.get("forward", 0),
         "halo_fold": exchanges.get("adjoint", 0)}
    return {k: launches.get(k, 0) / n[k] if n[k] else None
            for k in HALO_KERNELS}


K19_VIEWS = ("contiguous", "transposed", "strided", "offset", "rows",
             "narrow")


def _k19_views(base, kind):
    """An (N, C, H, W) tile of ``base`` as ``kind``: contiguous, a
    transposed view or a strided slice along W (those two take K19's
    ``strided`` walk), one at an element offset along W (its rows start
    off the 16-byte lines), every other row (twice the row pitch) or one
    column short of W (an odd length on rows of ``base``'s pitch)."""
    if kind == "transposed":
        return base.transpose(2, 3)
    if kind == "strided":
        return base[..., ::2]
    if kind == "offset":
        return base[..., 1:]
    if kind == "rows":
        return base[:, :, ::2]
    if kind == "narrow":
        return base[..., :-1]
    return base


def _k19_window(like, axis, width, offset, fill):
    """A ``width``-long window for tile ``like`` along ``axis``: a slice of
    a wider tensor, ``offset`` samples into it along W, its rows on
    16-sample lines before the offset."""
    shape = list(like.shape)
    shape[axis] = width
    wide = list(shape)
    wide[3] = -(-(wide[3] + offset) // 16) * 16
    return torch.full(wide, fill, dtype=like.dtype, device="cuda").narrow(
        3, offset, shape[3])


def halo_edge_cases(halo):
    """K19's three entries against their plain versions, bit for bit: halo
    widths 0, equal to the tile and in between (3 and 5, off the
    multiples of 4), both axes, every source on each side, the tile views
    of ``_k19_views`` at a row pitch off the 16-byte lines (W = 7) and on
    them (W = 16), windows on the lines and one sample off them, window
    cotangents on the lines and with H innermost, fp32 and bf16; and
    calls of 3 and 10 parts (one launch for every 8).  Every call must
    take the walk ``halo.halo_walk`` names, and every entry both walks.
    Returns (calls, mismatched elements, the walks taken by entry,
    multi-part calls)."""
    calls = mismatched = multi = 0
    walks = {k: dict.fromkeys(halo.HALO_WALKS, 0) for k in HALO_KERNELS}
    wrong = []
    gen = torch.Generator().manual_seed(7)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen).to(dtype).cuda()

    def run(name, want, launches, fn):
        """fn()'s result; its launches of entry ``name`` must be
        ``launches``, all on walk ``want``."""
        k = getattr(halo, name)
        before = dict(k.instantiations)
        out = fn()
        got = {w: n - before[w] for w, n in k.instantiations.items()
               if n != before[w]}
        if got != ({want: launches} if launches else {}):
            wrong.append((name, want, launches, got))
        for w, n in got.items():
            walks[name][w] += n
        return out

    def diff(a, b):
        return int((a != b).sum()) if isinstance(a, torch.Tensor) else \
            sum(int((u != v).sum()) for u, v in zip(a, b))

    def case(parts, axis, left, right, srcs, offsets):
        """pack, then per (lsrc, rsrc) and window offset an assemble and a
        fold of ``parts`` (a tile or a list): their differing elements."""
        nonlocal calls
        tiles = [parts] if isinstance(parts, torch.Tensor) else parts
        Ls = [t.shape[axis] for t in tiles]
        lengths = None if isinstance(parts, torch.Tensor) else Ls
        n = tiles[0].numel() // Ls[0] * len(tiles)
        groups = -(-len(tiles) // halo.MAX_PARTS)
        dtype = tiles[0].dtype
        tail, head = (torch.full((n * left,), float("nan"), dtype=dtype,
                                 device="cuda"),
                      torch.full((n * right,), float("nan"), dtype=dtype,
                                 device="cuda"))
        ptail, phead = tail.clone(), head.clone()
        run("halo_pack", halo.halo_walk(*tiles),
            groups if n * (left + right) else 0,
            lambda: halo.halo_pack(parts, axis, left, right, tail, head))
        halo.halo_pack_plain(parts, axis, left, right, ptail, phead)
        bad = int((tail.nan_to_num(9.0) != ptail.nan_to_num(9.0)).sum() +
                  (head.nan_to_num(9.0) != phead.nan_to_num(9.0)).sum())
        calls += 1
        recv_l, recv_r = rand(n * left, dtype), rand(n * right, dtype)
        width = sum(Ls) + len(tiles) * (left + right)
        for lsrc, rsrc in srcs:
            for offset in offsets:
                win = _k19_window(tiles[0], axis, width, offset,
                                  float("nan"))
                pwin = win.clone()
                wins = halo._windows(win, axis, Ls, left, right)
                run("halo_assemble", halo.halo_walk(*tiles, *wins),
                    groups if win.numel() else 0,
                    lambda: halo.halo_assemble(parts, axis, left, right,
                                               lsrc, rsrc, recv_l, recv_r,
                                               win))
                halo.halo_assemble_plain(parts, axis, left, right, lsrc,
                                         rsrc, recv_l, recv_r, pwin)
                bad += int((win.nan_to_num(9.0) != pwin.nan_to_num(9.0))
                           .sum())
                gw = _k19_window(tiles[0], axis, width, offset, 0.0)
                if offset:      # a cotangent laid out with H innermost
                    gw = gw.transpose(2, 3).contiguous().transpose(2, 3)
                gw.copy_(torch.randn(gw.shape, generator=gen).to(dtype))
                gws = halo._windows(gw, axis, Ls, left, right)
                dx = run("halo_fold", halo.halo_walk(*gws),
                         groups if gw.numel() and sum(Ls) else 0,
                         lambda: halo.halo_fold(gw, axis, left, right, lsrc,
                                                rsrc, recv_r, recv_l,
                                                lengths))
                pdx = halo.halo_fold_plain(gw, axis, left, right, lsrc,
                                           rsrc, recv_r, recv_l, lengths)
                bad += diff(dx, pdx)
                calls += 2
        return bad

    srcs = (("recv", "recv"), ("flip", "zero"), ("zero", "flip"),
            ("flip", "recv"))
    for dtype in (torch.float32, torch.bfloat16):
        for W in (7, 16):
            base = torch.randn((2, 4, 10, W), generator=gen).to(dtype).cuda()
            for kind in K19_VIEWS:
                x = _k19_views(base, kind)
                for axis in (2, 3):
                    L = x.shape[axis]
                    for left, right in ((0, 3), (3, 0), (L, L), (3, 5),
                                        (0, 0)):
                        if max(left, right) <= L:
                            mismatched += case(x, axis, left, right, srcs,
                                               (0, 1))
        for axis in (2, 3):
            for nparts in (3, 10):
                for W in (7, 16):
                    parts = []
                    for i in range(nparts):
                        shape = [2, 3, 7, W]
                        shape[axis] = 8 + 8 * (i % 3)
                        parts.append(rand(shape, dtype))
                    mismatched += case(parts, axis, 3, 5, srcs[:2], (0,))
                    multi += 1
    torch.cuda.synchronize()
    require(mismatched == 0, f"halo_edge_cases: {mismatched} elements differ "
            f"from the plain versions")
    require(not wrong, f"halo_edge_cases: launches off halo_walk's walk "
            f"(entry, walk, launches, taken): {wrong[:5]}")
    require(all(all(w.values()) for w in walks.values()),
            f"halo_edge_cases: an entry did not take both walks: {walks}")
    return calls, mismatched, walks, multi


def _k19_halo(sharded, shape):
    """(halo_left, halo_right) of the stage-1 row operator of DTCWT J=2
    (near_sym_a, qshift_a, 'symmetric') on ``shape`` on (1, 2), and the
    operator."""
    f = _k19_filters()
    st, _ = sharded._dtcwt_fwd_shard_plans(
        f["h0o"], f["h1o"], f["h0a"], f["h1a"], f["h0b"], f["h1b"], 2,
        (False, False), (False, False), "symmetric", shape[2], shape[3], 2,
        1)
    op = st.obj       # the stage-1 'shard' strategy's ShardedOp
    return (op.halo_left, op.halo_right), op


def k19_tile_rows(halo, label, tile, axis, dtype, halos, launches,
                  per_exchange):
    """K19's kernel lines at one tile: each entry (an interior rank's:
    "recv" on both sides) against its plain version (exact), timed beside
    it and beside one PyTorch call that builds the same buffer
    (``torch.cat``; none for the fold), with its bytes bound and the walk
    it took."""
    left, right = halos
    gen = torch.Generator().manual_seed(3)

    def rand(shape):
        return torch.randn(shape, generator=gen).to(dtype).cuda()
    x = rand(tile)
    L = x.shape[axis]
    per = x.numel() // L
    tail, head = x.new_empty(per * left), x.new_empty(per * right)
    ptail, phead = tail.clone(), head.clone()
    recv_l, recv_r = rand(per * left), rand(per * right)
    wshape = halo.block_shape(x, axis, left + L + right)
    win, pwin = x.new_empty(wshape), x.new_empty(wshape)
    gw = rand(wshape)
    blk_l, blk_r = (halo.block_shape(x, axis, k) for k in (left, right))
    entries = {
        "halo_pack": (
            lambda: halo.halo_pack(x, axis, left, right, tail, head),
            lambda: halo.halo_pack_plain(x, axis, left, right, ptail, phead),
            lambda: torch.cat([x.narrow(axis, L - left, left).reshape(-1),
                               x.narrow(axis, 0, right).reshape(-1)]),
            lambda: (torch.cat([tail, head]), torch.cat([ptail, phead])),
            2 * per * (left + right)),
        "halo_assemble": (
            lambda: halo.halo_assemble(x, axis, left, right, "recv", "recv",
                                       recv_l, recv_r, win),
            lambda: halo.halo_assemble_plain(x, axis, left, right, "recv",
                                             "recv", recv_l, recv_r, pwin),
            lambda: torch.cat([recv_l.view(blk_l), x, recv_r.view(blk_r)],
                              dim=axis),
            lambda: (win, pwin),
            per * (left + right + L) * 2),
        "halo_fold": (
            lambda: halo.halo_fold(gw, axis, left, right, "recv", "recv",
                                   recv_r, recv_l),
            lambda: halo.halo_fold_plain(gw, axis, left, right, "recv",
                                         "recv", recv_r, recv_l),
            None,
            lambda: (halo.halo_fold(gw, axis, left, right, "recv", "recv",
                                    recv_r, recv_l),
                     halo.halo_fold_plain(gw, axis, left, right, "recv",
                                          "recv", recv_r, recv_l)),
            per * (2 * (left + right) + 2 * L)),
    }
    rows = []
    for name, (kernel, plain, lib, outs, values) in entries.items():
        k = getattr(halo, name)
        before = dict(k.instantiations)
        kernel()
        walk = "+".join(w for w, n in k.instantiations.items()
                        if n != before[w])
        plain()
        got, want = outs()
        require(torch.equal(got, want), f"{name}: differs from its plain "
                f"version at {label}")
        ms = timed_ms(kernel)
        plain_ms = timed_ms(plain)
        lib_ms = None if lib is None else timed_ms(lib)
        bound = values * x.element_size() / PEAK_HBM_BYTES * 1e3
        rows.append({
            "name": f"{name} ({label}, halos {left} + {right})",
            "route": "cuda", "source": "pytorch_wavelets_tpu_torch/csrc/"
                                       "halo.cu",
            "replaces": HALO_REPLACES, "launches": launches[name],
            "max_abs_err": max_err(got, want), "tolerance": "exact",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
            "library": "torch.cat of the same buffer" if lib else None,
            "walk": walk, "launches_per_exchange": per_exchange[name],
            "share_of_bound": bound / ms})
    return rows


def k19_rows(halo, banded, sharded, launches, per_exchange):
    """K19's kernel lines (``k19_tile_rows``) at the main path's stage-1
    tile on (1, 2) (10 + 10 samples of halo an interior rank receives),
    and at the stage-1 tile of K19_LARGE_IMAGE on (1, 2) along W, along H
    (the tile transposed) and in bf16 along W; then ``apply_sharded_op``'s
    product, K1 on rank 0's block of the main stage-1 operator over its
    halo'd window, against its plain version and ``torch.matmul``.
    ``launches`` are the sharded runs' counts (K1's: its row entry's,
    every row apply of those runs), ``per_exchange`` K19's launches an
    exchange there."""
    halos, op = _k19_halo(sharded, MAIN_SHAPE)
    require(halos == K19_HALO, f"k19_rows: the main stage-1 halos are "
            f"{halos}, not {K19_HALO}")
    large, _ = _k19_halo(sharded, K19_LARGE_IMAGE)
    lt = K19_LARGE_TILE
    rows = []
    for label, tile, axis, dtype, hl in (
            (f"DTCWT J=2 stage-1 tile {shape_str(K19_TILE)}", K19_TILE, 3,
             torch.float32, halos),
            (f"large tile {shape_str(lt)} along W", lt, 3, torch.float32,
             large),
            (f"large tile {shape_str((*lt[:2], lt[3], lt[2]))} along H",
             (*lt[:2], lt[3], lt[2]), 2, torch.float32, large),
            (f"large tile {shape_str(lt)} along W, bf16", lt, 3,
             torch.bfloat16, large)):
        rows.extend(k19_tile_rows(halo, label, tile, axis, dtype, hl,
                                  launches, per_exchange))
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(3)
    B, _ = op.local(0, "cuda")
    win = torch.randn((*MAIN_SHAPE[:3], B.shape[1]), generator=gen).cuda()
    rows.append(k1_block_row(banded, "DTCWT J=2 stage 1 on (1, 2)", B, win,
                             launches))
    return rows


def k1_block_row(banded, label, B, win, launches, timing=REPLAY_TIMING,
                 replaces="pytorch_wavelets_tpu/parallel/banded_shard.py:184"):
    """The kernel line of K1 (``apply_sharded_op``'s product) on a rank's
    block ``B`` over its halo'd window ``win``, against its plain version
    and ``torch.matmul``; ``launches`` the sharded runs' counts (K1's row
    entry's, every row apply of those runs)."""
    got = banded.apply_row(win, B)
    want = banded.apply_row_plain(win, B)
    err = max_err(got, want)
    require(within(got, want, K1_TOL), f"apply_sharded_op ({label}): K1 on "
            f"rank 0's block differs from its plain version by {err}")
    Bt = B.T.t().contiguous()
    ms = timed_ms(lambda: banded.apply_row(win, B), *timing)
    plain_ms = timed_ms(lambda: banded.apply_row_plain(win, B), *timing)
    lib_ms = timed_ms(lambda: torch.matmul(win, Bt), *timing)
    rows_n = win.numel() // win.shape[3]
    op_t = 2 * B.nnz * rows_n / PEAK_FP32_FLOPS * 1e3
    byte_t = (win.numel() + rows_n * B.shape[0] + B.nnz) * 4 \
        / PEAK_HBM_BYTES * 1e3
    return {
        "name": f"apply_sharded_op (K1 row on rank 0's block "
                f"{B.shape[0]}x{B.shape[1]}, window "
                f"{shape_str(win.shape)}: {label})",
        "route": "cuda", "source": "pytorch_wavelets_tpu_torch/csrc/"
                                   "banded_apply.cu",
        "replaces": replaces,
        "launches": launches.get("apply_row", 0), "max_abs_err": err,
        "tolerance": K1_TOL, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(op_t, byte_t),
        "bound_by": "bytes" if byte_t >= op_t else "operations",
        "library_ms": lib_ms, "library": "torch.matmul"}


def _k19_filters():
    from pytorch_wavelets_tpu_torch.transforms.dtcwt_xfm import (
        dtcwt_fwd_filters,
    )
    return dtcwt_fwd_filters("near_sym_a", "qshift_a")


# ---------------------------------------------------------------------------
# sharded_fallbacks: where the JAX package runs GSPMD, the port's own routes
# (parallel/sharded.py's per-level route on zero-embedded storage,
# parallel/sharded_dwt.py's least-squares ISWT gathered per axis,
# parallel/sharded_conv.py's stencil halo route on K19 windows) and
# DTCWTForward2's batch data parallelism, in the same worlds
# ---------------------------------------------------------------------------

RAGGED_SHAPE = (10, 10, 126, 130)    # the reference's batch; 130 = 4 x 32.5
GIANT_W_SHAPE = (1, 3, 256, 36864)   # W past the sharded cap of 32,768
ALT_ODD_BATCH_SHAPE = (127, 3, 256, 256)
# (label, kind, (n_data, n_spatial_h, n_spatial), shape, options, route)
# per world: kind 'dtcwt' (DTCWTForward J=options' J -> DTCWTInverse;
# 'drop': the inverse with the lowpass and the coarsest level None), 'j2' /
# 'j1' (ScatLayerj2 / ScatLayer; 'bp': the bandpass-diagonal filters),
# 'swt' (SWTForward J=2 db4 -> SWTInverse in options' mode; wave 'bior2.2
# tuple': dec_filters('bior2.2') as raw taps) or 'alt' (DTCWTForward2 J=3
# farras / qshift_a -> DTCWTInverse2); 'conv': set_operator_matmul(False);
# route the LAST_PATH every entry names, or each entry's ('batch' for alt,
# which records none).  The JAX package runs GSPMD in every one of them
# (the inverse without the lowpass and the coarsest level it refuses).
SHARDED_FALLBACK_WORLDS = {
    2: [("scat_j2 252 (1, 2)", "j2", (1, 1, 2), (128, 3, 252, 252), {},
         "matmul"),
        ("dtcwt lowpass and level 3 None (1, 2)", "dtcwt", (1, 1, 2),
         MAIN_SHAPE, {"J": 3, "drop": True},
         {"dtcwt2d": "matmul", "idtcwt2d": "perlevel"}),
        ("swt symmetric (1, 2)", "swt", (1, 1, 2), SWT_SHAPE,
         {"mode": "symmetric"}, "matmul"),
        ("swt bior2.2 tuple (1, 2)", "swt", (1, 1, 2), SWT_SHAPE,
         {"mode": "periodization", "wave": "bior2.2 tuple"}, "matmul"),
        ("scat_j2 bp (1, 2)", "j2", (1, 1, 2), BP_SHAPE, {"bp": True},
         "conv"),
        ("dtcwt W 36864 (1, 2)", "dtcwt", (1, 1, 2), GIANT_W_SHAPE,
         {"J": 2}, "conv"),
        ("alt (2, 1)", "alt", (2, 1, 1), ALT_SHAPE, {}, "batch")],
    4: [("dtcwt ragged W (1, 4)", "dtcwt", (1, 1, 4), RAGGED_SHAPE,
         {"J": 2}, "perlevel"),
        ("dtcwt ragged H (4, 1)", "dtcwt", (1, 4, 1), RAGGED_SHAPE,
         {"J": 2}, "perlevel"),
        ("scat_j1 250 (1, 4)", "j1", (1, 1, 4), (128, 3, 256, 250), {},
         "perlevel"),
        ("swt symmetric (1, 2, 2)", "swt", (1, 2, 2), SWT_SHAPE,
         {"mode": "symmetric"}, "matmul"),
        ("scat_j2 bp (1, 2, 2)", "j2", (1, 2, 2), BP_SHAPE, {"bp": True},
         "conv"),
        ("dtcwt operator route off (1, 4)", "dtcwt", (1, 1, 4), MAIN_SHAPE,
         {"J": 2, "conv": True}, "conv"),
        ("alt batch 127 (4, 1)", "alt", (4, 1, 1), ALT_ODD_BATCH_SHAPE, {},
         "batch")]}
FALLBACK_TOL = 2e-5           # times max(1, max |reference|)
FALLBACK_ENTRIES = {"dtcwt": ("dtcwt2d", "idtcwt2d"), "j2": ("scat_j2",),
                    "j1": ("scat_j1",), "swt": ("swt2d", "iswt2d"),
                    "alt": ()}
STENCILS = ("dtcwt_filt", "dtcwt_dfilt", "dtcwt_ifilt")


def _fallback_modules(tt, kind, opts, mesh):
    """The (forward, inverse or None) modules of a sharded_fallbacks case,
    without a mesh where ``mesh`` is None."""
    kw = dict(mesh=mesh, device="cuda")
    if kind == "dtcwt":
        return (tt.DTCWTForward(J=opts["J"], **kw), tt.DTCWTInverse(**kw))
    if kind in ("j1", "j2"):
        cls = tt.ScatLayer if kind == "j1" else tt.ScatLayerj2
        bp = ({"biort": BP["biort"]} if kind == "j1" else BP) \
            if opts.get("bp") else {}
        return cls(**bp, **kw), None
    if kind == "swt":
        from pytorch_wavelets_tpu_torch.transforms.dwt import dec_filters
        wave = (tuple(np.asarray(f) for f in dec_filters("bior2.2"))
                if opts.get("wave") == "bior2.2 tuple" else "db4")
        return (tt.SWTForward(J=2, wave=wave, mode=opts["mode"], **kw),
                tt.SWTInverse(wave=wave, mode=opts["mode"], **kw))
    from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt
    return (dtcwt_alt.DTCWTForward2(J=ALT_J, **kw),
            dtcwt_alt.DTCWTInverse2(**kw))


def _fallback_leaves(kind, opts, fwd, inv, z):
    """[reconstruction, *forward leaves] of a case's round trip, or the
    scattering layer's output alone."""
    if kind in ("j1", "j2"):
        return [fwd(z)]
    if kind == "dtcwt":
        yl, yh = fwd(z)
        rec = inv((None, [*yh[:-1], None]) if opts.get("drop")
                  else (yl, yh))
        return [rec, yl, *yh]
    if kind == "swt":
        coeffs = fwd(z)
        return [inv(coeffs), *coeffs]
    yl, yh = fwd(z)
    return [inv((yl, yh)), *[t for row in yl for t in row], *yh]


def fallback_case(tt, ops, parallel, banded, label, kind, mesh_shape, shape,
                  opts, route):
    """One sharded_fallbacks case on this rank: the card's run without a
    mesh first (the round trip or the layer, and the gradient of
    sum_j <leaf_j, G_j>), then with ``mesh=`` (:func:`sharded_run`), the
    warnings of the routes that move more than a halo caught."""
    import gc
    import warnings

    from pytorch_wavelets_tpu_torch.parallel import sharded
    gc.collect()
    torch.cuda.empty_cache()
    nd, nh, ns = mesh_shape
    mesh = parallel.make_mesh(nd, ns, nh)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).cuda()
    banded.set_operator_matmul(False if opts.get("conv") else None)
    try:
        fwd_r, inv_r = _fallback_modules(tt, kind, opts, None)
        xr = x.clone().requires_grad_()
        trip = _fallback_leaves(kind, opts, fwd_r, inv_r, xr)
        gs = [torch.randn(t.shape, generator=torch.Generator().manual_seed(
            1 + i)).cuda() for i, t in enumerate(trip)]
        gref, = torch.autograd.grad(sum((t * g).sum()
                                        for t, g in zip(trip, gs)), xr)
        k = 0 if kind in ("j1", "j2") else 1
        scale = {"forward": max([1.0] + [t.abs().max().item()
                                         for t in trip[k:]]),
                 "inverse": None if k == 0 else max(
                     1.0, trip[0].abs().max().item()),
                 "x_grad": max(1.0, gref.abs().max().item())}
        refs = [t.detach().cpu() for t in trip]
        gs, gref = [g.cpu() for g in gs], gref.cpu()
        del trip, xr, fwd_r, inv_r
        torch.cuda.empty_cache()
        fwd, inv = _fallback_modules(tt, kind, opts, mesh)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = sharded_run(
                ops, parallel,
                lambda z: _fallback_leaves(kind, opts, fwd, inv, z), x, gs,
                refs, gref, fwd_only=k == 0)
    finally:
        banded.set_operator_matmul(None)
    res["warnings"] = sorted({str(w.message) for w in caught
                              if "more than a halo" in str(w.message)})
    res["path"] = {e: res["path"].get(e) for e in FALLBACK_ENTRIES[kind]}
    res["stencil_launches"] = {n: res["launches"].get(n, 0)
                               for n in STENCILS}
    if k == 0:
        res["forward_ms"] = res.pop("round_trip_ms")
    del refs, gs, gref, x, fwd, inv
    sharded._dtcwt_fwd_perlevel_shard_plans.cache_clear()
    sharded._dtcwt_inv_perlevel_shard_plans.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(label=label, kind=kind, route=route, options=opts,
                mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                shape=list(shape), scale=scale, **res)


def fallback_gates(label, r, res, nh, ns):
    """One rank's checks of a sharded_fallbacks case: every error within
    FALLBACK_TOL of the reference's scale, the route named; the operator
    routes launching K1, the stencil halo route K8, K9 (past level 1) and
    K10 (the inverse, or the backward), the batch-parallel one K6 / K7 and
    no K19; K19 on every rank of a mesh with a sharded spatial axis, one
    launch an exchange and pass; the least-squares ISWT's warning."""
    for what, err in res["max_abs_err"].items():
        lim = None if err is None else FALLBACK_TOL * res["scale"][what]
        require(err is None or err <= lim,
                f"sharded_fallbacks {label} rank {r}: {what} differs from "
                f"the card's run without a mesh by {err} (limit {lim})")
    route, kind = res["route"], res["kind"]
    if isinstance(route, dict):
        want, route = route, route[FALLBACK_ENTRIES[kind][-1]]
    else:
        want = {e: route for e in FALLBACK_ENTRIES[kind]}
    require(res["path"] == want,
            f"sharded_fallbacks {label} rank {r}: path {res['path']}, "
            f"route {res['route']}")
    n19 = sum(res["k19_launches"].values())
    stencils = res["stencil_launches"]
    if route == "conv":
        need = STENCILS if kind != "j1" else ("dtcwt_filt",)
        require(all(stencils[n] > 0 for n in need),
                f"sharded_fallbacks {label} rank {r}: stencils {stencils} "
                f"on the stencil halo route")
    elif route == "batch":
        n = res["launches"]
        require(n19 == 0 and n.get("afb1d_corr", 0) > 0
                and n.get("sfb1d_conv", 0) > 0,
                f"sharded_fallbacks {label} rank {r}: K19 {n19}, launches "
                f"{n}")
    else:
        require(res["k1_launches"] > 0 and not any(stencils.values()),
                f"sharded_fallbacks {label} rank {r}: K1 "
                f"{res['k1_launches']}, stencils {stencils}")
    if route != "batch":
        require(n19 > 0 if nh * ns > 1 else n19 == 0,
                f"sharded_fallbacks {label} rank {r}: K19 launches "
                f"{res['k19_launches']}")
    k19_exchange_gates(label, r, res)
    if kind == "swt":
        require(any("least-squares" in w for w in res["warnings"]),
                f"sharded_fallbacks {label} rank {r}: no warning of the "
                f"least-squares merge: {res['warnings']}")


def sharded_fallback_phase(smi, worlds, seconds):
    """Emit the sharded_fallbacks phase of every world (every rank's
    results gated by :func:`fallback_gates`); returns every kernel's
    launches summed over every rank of every case."""
    total = {}
    for world, cases in SHARDED_FALLBACK_WORLDS.items():
        meshes = []
        for i, (label, kind, (_, nh, ns), shape, opts, route) in enumerate(
                cases):
            per_rank = [worlds[world][r]["fallback"][i] for r in range(world)]
            for r, res in enumerate(per_rank):
                fallback_gates(label, r, res, nh, ns)
                for k, n in res["launches"].items():
                    total[k] = total.get(k, 0) + n
            ms = "forward_ms" if kind in ("j1", "j2") else "round_trip_ms"
            meshes.append({
                "label": label, "kind": kind, "route": route,
                "options": opts, "mesh": per_rank[0]["mesh"],
                "shape": list(shape), "ranks": per_rank,
                "max_abs_err": {
                    w: max((r["max_abs_err"][w] for r in per_rank
                            if r["max_abs_err"][w] is not None),
                           default=None)
                    for w in ("forward", "inverse", "x_grad")},
                "scale": per_rank[0]["scale"],
                ms: max(r[ms] for r in per_rank),
                "step_ms": max(r["step_ms"] for r in per_rank),
                "first_call_s": max(r["first_call_s"] for r in per_rank),
                "staged_bytes": max(sum(r["staged_bytes"].values())
                                    for r in per_rank),
                "k1_launches": sum(r["k1_launches"] for r in per_rank),
                "k19_launches": sum(sum(r["k19_launches"].values())
                                    for r in per_rank),
                "stencil_launches": {n: sum(r["stencil_launches"][n]
                                            for r in per_rank)
                                     for n in STENCILS},
                "warnings": per_rank[0]["warnings"]})
        emit("sharded_fallbacks", world=world, timing_label=SHARDED_LABEL,
             nvidia_smi=smi, tolerance=f"{FALLBACK_TOL} x max(1, max "
             f"|reference|)", world_seconds_with_sharded_main=seconds[world],
             meshes=meshes)
    emit("sharded_fallbacks_launches", launches=total)
    return total


def fallback_k1_rows(tt, banded, sharded, sharded_dwt, launches):
    """K1 on two operators of the sharded_fallbacks routes, against its
    plain version and ``torch.matmul``: rank 0's block of the per-level
    route's embedded level-1 stage-1 operator of RAGGED_SHAPE on (1, 4)
    over its halo'd window, and the least-squares ISWT's dense merge (the
    level-0 pinv along W of SWT_SHAPE in 'symmetric', db4: (256, 2 x 256),
    the 'gather' strategy's whole operator) over the gathered [lo | hi].
    ``launches`` are the sharded_fallbacks cases' (every rank)."""
    f = _k19_filters()
    taps = tuple(f[k] for k in ("h0o", "h1o", "h0a", "h1a", "h0b", "h1b"))
    N, C, H, W = RAGGED_SHAPE
    ((st1, _), _) = sharded._dtcwt_fwd_perlevel_shard_plans(
        *taps, 2, (False, False), "symmetric", H, W, 4, 1)[0]
    require(st1.kind == "shard", f"fallback_k1_rows: level 1 is "
            f"{st1.kind}")
    dec = sharded_dwt.dec_filters("db4")
    (merge,) = sharded_dwt._iswt_ls_strategies(
        (sharded_dwt._rev(dec[2]), sharded_dwt._rev(dec[3])), "symmetric",
        1, SWT_SHAPE[3], 2)
    require(merge.kind == "gather", f"fallback_k1_rows: the ISWT merge is "
            f"{merge.kind}")
    gen = torch.Generator().manual_seed(11)
    rows = []
    B, _ = st1.obj.local(0, "cuda")
    win = torch.randn((N, C, H, B.shape[1]), generator=gen).cuda()
    rows.append(k1_block_row(
        banded, f"per-level DTCWT level 1 on zero-embedded storage, "
        f"{shape_str(RAGGED_SHAPE)} on (1, 4)", B, win, launches,
        LARGE_REPLAY_TIMING))
    del win, B
    T, _ = merge.operators("cuda")
    win = torch.randn((*SWT_SHAPE[:3], T.shape[1]), generator=gen).cuda()
    rows.append(k1_block_row(
        banded, f"least-squares ISWT merge, symmetric, level 0, "
        f"{shape_str(SWT_SHAPE)} on (1, 2)", T, win, launches,
        LARGE_REPLAY_TIMING,
        replaces="pytorch_wavelets_tpu/transforms/dwt.py:345"))
    del win, T
    torch.cuda.empty_cache()
    return rows


def nccl_world_of_one(tt, parallel, banded):
    """A world of one on NCCL and its (1, 1) mesh: DTCWTForward /
    DTCWTInverse with ``mesh=`` on the main path and ScatLayerj2 on
    SCAT_SHAPE, bit for bit the paths without a mesh; the DWT (DWT_SHAPE)
    and SWT (SWT_SHAPE) round trips in 'periodization' on the conv halo
    route, bit for bit the path without a mesh but the SWT's inverse (the
    sharded averaging merge against the least-squares merge: within
    SHARDED_TOL), and on the operator route (K1 products against the
    stencils: within SHARDED_TOL)."""
    import os
    import tempfile

    import torch.distributed as dist
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(
        prefix="chip_smoke_nccl"), "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = parallel.make_mesh(1, 1)
        x = torch.randn(MAIN_SHAPE,
                        generator=torch.Generator().manual_seed(0)).cuda()
        with torch.no_grad():
            yl, yh = tt.DTCWTForward(J=2, device="cuda", mesh=mesh)(x)
            rec = tt.DTCWTInverse(device="cuda", mesh=mesh)((yl, yh))
            ryl, ryh = tt.DTCWTForward(J=2, device="cuda")(x)
            rrec = tt.DTCWTInverse(device="cuda")((ryl, ryh))
        equal = (torch.equal(yl.to_local(), ryl)
                 and all(torch.equal(a.to_local(), b)
                         for a, b in zip(yh, ryh))
                 and torch.equal(rec.to_local(), rrec))
        del x, yl, yh, rec, ryl, ryh, rrec
        x = torch.randn(SCAT_SHAPE,
                        generator=torch.Generator().manual_seed(0)).cuda()
        with torch.no_grad():
            scat_equal = torch.equal(
                tt.ScatLayerj2(device="cuda", mesh=mesh)(x).to_local(),
                tt.ScatLayerj2(device="cuda")(x))
        del x
        dwt_swt = []
        for kind, route in (("dwt", "conv"), ("swt", "conv"),
                            ("dwt", "matmul"), ("swt", "matmul")):
            x = torch.randn(_dwt_shape(kind), generator=torch.Generator()
                            .manual_seed(0)).cuda()
            fwd_r, inv_r = _dwt_kind(tt, kind, "periodization")
            fwd, inv = _dwt_kind(tt, kind, "periodization", mesh)
            with torch.no_grad():
                out_r = fwd_r(x)
                refs = _leaves_of(kind, out_r, inv_r(out_r))
                banded.set_operator_matmul(False if route == "conv"
                                           else None)
                try:
                    out = fwd(x)
                    got = _leaves_of(kind, out, inv(out))
                finally:
                    banded.set_operator_matmul(None)
            bits = {"forward": all(torch.equal(a.to_local(), b)
                                   for a, b in zip(got[1:], refs[1:])),
                    "inverse": torch.equal(got[0].to_local(), refs[0])}
            errs = {"forward": max(max_err(a.to_local(), b)
                                   for a, b in zip(got[1:], refs[1:])),
                    "inverse": max_err(got[0].to_local(), refs[0])}
            dwt_swt.append(dict(kind=kind, route=route, mode="periodization",
                                shape=list(x.shape), bit_equal=bits,
                                max_abs_err=errs))
            del x, out_r, refs, out, got
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    require(equal, "sharded_nccl: the (1, 1) mesh differs from the path "
            "without a mesh")
    require(scat_equal, "sharded_nccl: ScatLayerj2 on the (1, 1) mesh "
            "differs from the layer without a mesh")
    for c in dwt_swt:
        exact = ({"forward", "inverse"} if c["kind"] == "dwt" else
                 {"forward"}) if c["route"] == "conv" else set()
        for what in ("forward", "inverse"):
            require(c["bit_equal"][what] if what in exact else
                    c["max_abs_err"][what] <= SHARDED_TOL[what],
                    f"sharded_nccl: {c['kind']} {what} on the {c['route']} "
                    f"route of the (1, 1) mesh: bit equal "
                    f"{c['bit_equal'][what]}, max error "
                    f"{c['max_abs_err'][what]}")
    return dict(backend=backend, mesh=[1, 1], shape=list(MAIN_SHAPE),
                bit_equal=equal, path=dict(parallel.LAST_PATH),
                dwt_swt=dwt_swt,
                scat_j2=dict(shape=list(SCAT_SHAPE), bit_equal=scat_equal))



def profile(step, iters):
    """Device time by kernel over a window of ``iters`` steps
    (torch.profiler; its own host overhead inflates the window's wall
    time, so the busy shares come from the path phases instead)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
    by_name = {}
    by_kind = {"layout copies": 0.0, "cuFFT": 0.0}
    for e in prof.key_averages():
        # device events only: the autograd Functions' host ranges are
        # credited with the ctypes-launched kernels inside them too
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == DeviceType.CUDA:
            kind = profile_kind(e.key)
            if kind:
                by_kind[kind] += us / iters
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0][:60]
            by_name[name] = by_name.get(name, 0.0) + us / iters
    total = sum(by_name.values())
    return dict(window_iters=iters,
                device_us_per_iter=total if total else "not measured",
                device_us_per_iter_by_kind=by_kind if total else
                "not measured",
                device_us_per_iter_by_kernel=sorted(
                    by_name.items(), key=lambda kv: -kv[1]))


def profile_kind(key):
    """The kind of a device event the profiles sum apart: PyTorch's layout
    copies (its copy kernel, device-to-device memcpy) and cuFFT's kernels;
    None for any other."""
    low = key.lower()
    if "direct_copy_kernel" in low or low.startswith("memcpy dtod"):
        return "layout copies"
    if "fft" in low and "at::native" not in low:
        return "cuFFT"
    return None


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import pytorch_wavelets_tpu_torch as tt
    from pytorch_wavelets_tpu_torch import ops
    from pytorch_wavelets_tpu_torch.ops import (
        _cuda, afb_sfb, banded, dtcwt_fb, fused_dtcwt, iswt_merge, pad,
        pool, quad, scat_mag,
    )
    from pytorch_wavelets_tpu_torch.transforms import dtcwt as lev
    from pytorch_wavelets_tpu_torch.transforms import dwt, scatternet

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    emit("env", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), python=sys.version.split()[0],
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32},
         precision=tt.get_matmul_precision())

    t0 = time.perf_counter()
    log = _cuda.build()
    regs = {n: [ln.strip() for ln in v["log"].splitlines()
                if "registers" in ln or "spill" in ln]
            for n, v in log.items()}
    emit("build", seconds=time.perf_counter() - t0, ptxas=regs)

    kern = (banded, quad, scat_mag, afb_sfb, pad)
    counts, calls, fields = drive(tt, ops, fused_dtcwt, scatternet,
                                  MAIN_SHAPE, 2, "main")
    emit("main_path", **fields)
    bcounts, bcalls, bfields = drive(tt, ops, fused_dtcwt, scatternet,
                                     BANDED_SHAPE, 3, "banded")
    emit("banded_path", **bfields)
    tfields, t_roles, tcalls = train_main(tt, ops, fused_dtcwt, scatternet,
                                          MAIN_SHAPE, 2)
    emit("train_main", **tfields)
    sfields, s_roles, scalls = scat_step(tt, ops, fused_dtcwt, scatternet,
                                         SCAT_SHAPE, SCAT_CHECK_N, "scat_j2",
                                         SCAT_TIMING)
    emit("scat_j2", **sfields, gtx1080_reference_s=dict(
        GTX1080_SCAT_S, source="BASELINE.md:18", hardware="GTX1080"))
    cfields, c_roles, ccalls = scat_step(
        tt, ops, fused_dtcwt, scatternet, COLOUR_SHAPE, COLOUR_CHECK_N,
        "scat_j2_colour", COLOUR_TIMING, combine_colour=True)
    emit("scat_j2_colour", **cfields)
    n_edge, edge_err, edge_insts, k18_err = mag_edge_cases(scat_mag)
    emit("mag_edge_cases", calls=n_edge, max_abs_err=edge_err,
         tolerance=MAG_TOL, instantiations=edge_insts,
         k18_max_abs_err=k18_err,
         k18_tolerance=dict(BWD2_TOL, relative_to="the terms' magnitudes"))
    n_edge, mismatches, edge_insts = quad_edge_cases(quad)
    emit("quad_edge_cases", calls=n_edge, mismatched_elements=mismatches,
         tolerance="exact", instantiations=edge_insts)
    n_edge, mismatches, edge_insts = c2q_edge_cases(quad)
    emit("c2q_edge_cases", calls=n_edge, mismatched_elements=mismatches,
         tolerance="exact", instantiations=edge_insts)
    dfields, dtfields, d_roles, dcalls, dstep = dwt_path(
        tt, ops, afb_sfb, dwt, DWT_SHAPE, DWT_J, False, "dwt_main")
    emit("dwt_main", **dfields)
    emit("dwt_train", **dtfields)
    ofields, otfields, o_roles, ocalls, _ = dwt_path(
        tt, ops, afb_sfb, dwt, DWT1D_SHAPE, DWT1D_J, True, "dwt1d")
    emit("dwt1d", **ofields, training=otfields)
    n_edge, edge_err, edge_insts = dwt_edge_cases(afb_sfb, pad)
    emit("dwt_edge_cases", calls=n_edge, max_abs_err=edge_err,
         tolerance=DWT_TOL, instantiations=edge_insts)

    groups = [(SOURCES[k][0], SOURCES[k][2], counts[k],
               [c for c in calls if c[0] == k])
              for k in PYRAMID_KERNELS]
    groups += [(f"{SOURCES[k][0]} ({shape_str(BANDED_SHAPE)} J=3)",
                BANDED_REPLACES,
                bcounts[k], [c for c in bcalls if c[0] == k])
               for k in ("apply_row", "apply_col")]
    def role_replaces(role, kernel):
        return ROLE_REPLACES.get(role, SOURCES[kernel][2])
    groups += phase_groups(
        tcalls, t_roles, f"DTCWT J=2 {shape_str(MAIN_SHAPE)} backward",
        ["forward pyramid's adjoint (B4)", "inverse pyramid's adjoint"],
        role_replaces)
    scat_roles = ["forward pyramid", MAG_ROLE,
                  "forward pyramid's adjoint (B4)"]
    groups += phase_groups(scalls, s_roles,
                           f"ScatLayerj2 {shape_str(SCAT_SHAPE)}",
                           scat_roles, role_replaces)
    groups += phase_groups(
        ccalls, c_roles,
        f"ScatLayerj2 combine_colour {shape_str(COLOUR_SHAPE)}", scat_roles,
        role_replaces)
    for dc, roles, label, line in (
            (dcalls, d_roles, f"DWT J={DWT_J} {shape_str(DWT_SHAPE)}",
             (109, 143)),
            (ocalls, o_roles, f"DWT1D J={DWT1D_J} {shape_str(DWT1D_SHAPE)}",
             (176, 198))):
        for role in ("analysis", "synthesis", "analysis's backward",
                     "synthesis's backward"):
            mine = [c for c in dc if c[1] == role]
            kernel = mine[0][0]
            replaces = {"analysis's backward": line[0],
                        "synthesis's backward": line[1]}.get(role)
            groups.append((
                f"{SOURCES[kernel][0]} ({label}: {role})",
                SOURCES[kernel][2] if replaces is None else
                f"pytorch_wavelets_tpu/transforms/dwt.py:{replaces}",
                roles[role], mine))
    # the earlier paths' calls are replayed (and freed) before the
    # per-level paths run, which need the card's memory
    with torch.no_grad():
        rows = kernel_rows(groups, *kern)
    for row in rows:
        emit("kernel", **row)
    del calls, bcalls, tcalls, scalls, ccalls, dcalls, ocalls
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the per-level and SWT paths; each phase's calls are replayed right
    # after it
    def phase_rows(calls, by_role, label, roles, replaces, timing):
        with torch.no_grad():
            new = kernel_rows(phase_groups(calls, by_role, label, roles,
                                           replaces), *kern, dtcwt_fb, pool,
                              timing, im=iswt_merge)
        torch.cuda.synchronize()
        for row in new:
            emit("kernel", **row)
        rows.extend(new)

    def level_rows(calls, by_role, label, timing=REPLAY_TIMING):
        phase_rows(calls, by_role, label, ("forward", "backward"),
                   lambda r, k: PER_LEVEL_REPLACES.get(k, SOURCES[k][2]),
                   timing)

    def swt_rows(calls, by_role, label, timing=REPLAY_TIMING):
        phase_rows(calls, by_role, label, tuple(SWT_REPLACES),
                   lambda r, k: SWT_REPLACES[r], timing)

    def recorder():
        return PerLevelRecorder(dtcwt_fb, lev, scatternet)
    need = (("dtcwt_filt", "dtcwt_dfilt", "q2c_pack", "scat_mag_fwd",
             "avg_pool2_fwd"),
            ("dtcwt_filt", "dtcwt_ifilt", "c2q_unpack", "scat_mag_bwd",
             "avg_pool2_bwd"))
    pfields, p_roles, pcalls = scat_step(
        tt, ops, fused_dtcwt, scatternet, BP_SHAPE, SCAT_CHECK_N, "scat_bp",
        SCAT_TIMING, need=need, recorder=recorder, **BP)
    emit("scat_bp", **pfields, gtx1080_reference_s=dict(
        GTX1080_SCAT_S, source="BASELINE.md:18", hardware="GTX1080",
        filters="near_sym_a / qshift_a"))
    level_rows(pcalls, p_roles, f"ScatLayerj2 bp {shape_str(BP_SHAPE)}")
    del pcalls
    for layer, kw, check_n in (
            ("ScatLayer", dict(biort="near_sym_b_bp"), COLOUR_CHECK_N),
            ("ScatLayerj2", dict(BP, combine_colour=True), COLOUR_CHECK_N)):
        j1 = layer == "ScatLayer"
        sneed = (tuple(k for k in need[0] if not (j1 and k == "dtcwt_dfilt")),
                 tuple(k for k in need[1] if not (j1 and k == "dtcwt_ifilt")))
        qfields, q_roles, qcalls = scat_step(
            tt, ops, fused_dtcwt, scatternet, BP_SMALL_SHAPE, check_n,
            f"scat_bp_small {layer}", COLOUR_TIMING, layer=layer, need=sneed,
            recorder=recorder, **kw)
        emit("scat_bp_small", **qfields)
        colour = " combine_colour" if kw.get("combine_colour") else ""
        level_rows(qcalls, q_roles,
                   f"{layer} bp{colour} {shape_str(BP_SMALL_SHAPE)}")
        del qcalls
    gfields = dtcwt_large(
        tt, ops, lev, dtcwt_fb, scatternet, quad, pool,
        lambda c, r, label: level_rows(c, r, label, LARGE_REPLAY_TIMING))
    emit("dtcwt_large", **gfields)
    mfields, m_roles, mcalls = per_level_main(tt, ops, banded, dtcwt_fb,
                                              lev, scatternet)
    emit("per_level_main", **mfields)
    level_rows(mcalls, m_roles, f"DTCWT J=2 {shape_str(MAIN_SHAPE)} per "
               f"level")
    del mcalls
    n_edge, edge_err, edge_insts, pool_insts = stencil_edge_cases(dtcwt_fb,
                                                                  pool)
    emit("stencil_edge_cases", calls=n_edge, max_abs_err=edge_err,
         tolerance=STENCIL_TOL, k9_instantiations=edge_insts,
         k11_instantiations=pool_insts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the SWT (K12, K13, and K1 for the inverse's operator merges)
    wfields, wtfields, w_roles, wcalls, wstep = swt_main(tt, ops, afb_sfb,
                                                         dwt)
    emit("swt_main", **wfields)
    emit("swt_train", **wtfields)
    swt_rows(wcalls, w_roles, f"SWT J={SWT_J} {shape_str(SWT_SHAPE)}")
    del wcalls
    torch.cuda.empty_cache()
    for mode, shape in SWT_LONG:
        emit("swt_long", **swt_long(
            tt, ops, afb_sfb, dwt, mode, shape,
            lambda c, r, label: swt_rows(c, r, label, LARGE_REPLAY_TIMING)))
        torch.cuda.empty_cache()
    n_edge, edge_err, edge_insts = swt_edge_cases(afb_sfb, pad, iswt_merge)
    emit("swt_edge_cases", calls=n_edge, max_abs_err=edge_err,
         tolerance={"K12": DWT_TOL, "K13": SPEC_TOL},
         instantiations=edge_insts)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the Selesnick DTCWT (its four K6/K7 pyramids), the non-separable
    # filterbanks (K14, K15) and the à trous merge (K16)
    from pytorch_wavelets_tpu_torch.ops import nonsep
    from pytorch_wavelets_tpu_torch.transforms import dtcwt_alt as alt
    afields, atfields, a_roles, acalls, astep = alt_main(ops, afb_sfb, dwt,
                                                         alt)
    emit("alt_main", **afields)
    emit("alt_train", **atfields)
    label = f"DTCWTForward2 J={ALT_J} {shape_str(ALT_SHAPE)}"
    groups = []
    for role, line in (("analysis", None), ("synthesis", None),
                       ("analysis's backward", 109),
                       ("synthesis's backward", 143)):
        mine = [c for c in acalls if c[1] == role]
        kernel = mine[0][0]
        groups.append((
            f"{SOURCES[kernel][0]} ({label}: {role})",
            SOURCES[kernel][2] if line is None else
            f"pytorch_wavelets_tpu/transforms/dwt.py:{line}",
            a_roles[role], mine))
    with torch.no_grad():
        new = kernel_rows(groups, *kern, timing=ALT_REPLAY_TIMING)
    for row in new:
        emit("kernel", **row)
    rows.extend(new)
    del acalls
    torch.cuda.empty_cache()
    emit("cplxdual_mag", **cplxdual_mag(ops, alt))

    def nonsep_rows(calls, by_role, label, timing=REPLAY_TIMING):
        phase_rows(calls, by_role, label,
                   list(dict.fromkeys(c[1] for c in calls)), None, timing)

    qfields, q_roles, qcalls = quad_nonsep(ops, nonsep, afb_sfb, alt)
    emit("quad_nonsep", **qfields)
    nonsep_rows(qcalls, q_roles, f"quad_afb2d_nonsep {shape_str(ALT_SHAPE)} "
                f"{QUAD_MODE}")
    del qcalls
    nfields, n_roles, ncalls = nonsep_rt(ops, nonsep, afb_sfb)
    emit("nonsep_rt", **nfields)
    nonsep_rows(ncalls, n_roles, f"{NONSEP_WAVE} {shape_str(DWT_SHAPE)}",
                NONSEP_REPLAY_TIMING)
    del ncalls
    torch.cuda.empty_cache()
    sfields, s_roles, scalls = swt_sfb(ops, nonsep, afb_sfb)
    emit("swt_sfb", **sfields)
    nonsep_rows(scalls, s_roles, f"sfb2d_atrous {NONSEP_WAVE} "
                f"{shape_str(SWT_SHAPE)}", ALT_REPLAY_TIMING)
    del scalls
    n_edge, edge_err, edge_insts = nonsep_edge_cases(banded)
    emit("nonsep_edge_cases", calls=n_edge, max_abs_err=edge_err,
         tolerance=NONSEP_TOL, k15_instantiations=edge_insts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the precision levels and bf16 (K17; the stencils through casts), set
    # through the port's API only: the TF32 flags above stay off
    rows.extend(precision_phases(tt, ops, banded, _cuda))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # second-order gradients: every backward's backward (K18 for the
    # magnitudes'), and the batch_chunk dial, timed with utils.profiling
    from pytorch_wavelets_tpu_torch.utils import profiling
    rows.extend(hvp_phases(tt, ops, kern, profiling, fused_dtcwt, scatternet,
                           dtcwt_fb, lev))
    emit("chunk_scat", **chunk_scat(tt, profiling))
    emit("third_order_scat", **third_order_scat(tt, ops))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the sharded DTCWT on meshes of 2 and 4 processes (gloo, every rank
    # on this card), K19 at edge cases and timed, a NCCL world of one
    from pytorch_wavelets_tpu_torch import parallel
    from pytorch_wavelets_tpu_torch.ops import halo
    from pytorch_wavelets_tpu_torch.parallel import (
        sharded, sharded_dwt, sharded_scat,
    )
    launches, per_exchange, worlds, world_s = sharded_main(smi)
    dwt_launches = sharded_dwt_phase(smi, worlds, world_s)
    scat_launches = sharded_scat_phase(smi, worlds, world_s)
    fb_launches = sharded_fallback_phase(smi, worlds, world_s)
    del worlds
    n_edge, mismatches, walks, multi = halo_edge_cases(halo)
    emit("halo_edge_cases", calls=n_edge, mismatched_elements=mismatches,
         tolerance="exact", walks=walks, multi_part_calls=multi)
    n_edge, edge_err, edge_insts = window_edge_cases(ops, afb_sfb, dwt)
    emit("window_edge_cases", calls=n_edge, max_abs_err=edge_err,
         tolerance=DWT_TOL, instantiations=edge_insts)
    every = {k: launches.get(k, 0) + dwt_launches.get(k, 0)
             + scat_launches.get(k, 0) + fb_launches.get(k, 0)
             for k in {*launches, *dwt_launches, *scat_launches,
                       *fb_launches}}
    new = k19_rows(halo, banded, sharded, every, per_exchange)
    new += window_rows(afb_sfb, dwt, dwt_launches)
    new += sharded_dwt_k1_rows(banded, sharded_dwt, dwt_launches)
    new += sharded_scat_k1_rows(tt, banded, sharded, sharded_scat,
                                scat_launches)
    new += fallback_k1_rows(tt, banded, sharded, sharded_dwt, fb_launches)
    for row in new:
        emit("kernel", **row)
    rows.extend(new)
    emit("sharded_nccl", **nccl_world_of_one(tt, parallel, banded))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    fwd = tt.DTCWTForward(J=2, device="cuda")
    inv = tt.DTCWTInverse(device="cuda")
    x = torch.randn(MAIN_SHAPE,
                    generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        emit("profile", path="main", **profile(lambda: inv(fwd(x)), 10))
    m = tt.ScatLayerj2(device="cuda")
    N, C, H, W = SCAT_SHAPE
    xs = torch.randn(SCAT_SHAPE, generator=torch.Generator().manual_seed(0))
    xs = xs.cuda().requires_grad_()
    G = torch.randn((N, 49 * C, H // 4, W // 4),
                    generator=torch.Generator().manual_seed(1)).cuda()
    emit("profile", path="scat_j2 forward + backward",
         **profile(lambda: torch.autograd.grad(m(xs), xs, G), 3))
    del m, xs, G
    emit("profile", path="dwt_train", **profile(dstep, 3))
    m = tt.ScatLayerj2(device="cuda", **BP)
    N, C, H, W = BP_SHAPE
    xs = torch.randn(BP_SHAPE, generator=torch.Generator().manual_seed(0))
    xs = xs.cuda().requires_grad_()
    G = torch.randn((N, 49 * C, H // 4, W // 4),
                    generator=torch.Generator().manual_seed(1)).cuda()
    emit("profile", path="scat_bp forward + backward",
         **profile(lambda: torch.autograd.grad(m(xs), xs, G), 3))
    del m, xs, G
    emit("profile", path="swt_train", **profile(wstep, 3))
    emit("profile", path="alt_train", **profile(astep, 2))
    for path, fn, shape, loss in (
            ("hvp_scat_j2", tt.ScatLayerj2(device="cuda"), SCAT_SHAPE,
             _squares),
            ("hvp_dwt", _dwt_round_trip(tt, J=DWT_J, wave=DWT_WAVE,
                                        mode=DWT_MODE)("cuda"), DWT_SHAPE,
             _cubic)):
        hvp = hvp_of(fn, loss)
        x, v = (torch.randn(shape, generator=torch.Generator()
                            .manual_seed(s)).cuda() for s in (0, 1))
        emit("profile", path=path, **profile(lambda: hvp(x, v), 2))
        del hvp, x, v

    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [{k: v for k, v in r.items()
                                   if k != "per_call"} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
