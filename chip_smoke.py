#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card.

    python3 chip_smoke.py [--profile]

1. Reads the card (name and power limit from nvidia-smi), pins f32 math to
   true f32 (no TF32) and cuDNN to deterministic algorithms.
2. Builds the hand-written flow-step kernels (`csrc/*.cu`) with nvcc, one
   process per source, and holds their GEMM core alone (17).
3. Holds each kernel against its plain PyTorch version on the same CUDA
   tensors at every celeba64 level shape (hidden 512, b=64) and two odd
   shapes, both directions, affine and additive coupling, with the repo's
   bf16 bounds (tests/test_flowstep_pallas.py): elementwise atol/rtol 5e-2,
   mean |diff| < 2e-3, logdet atol 2e-1 / rtol 2e-2; and the per-step
   round-trip under the kernel to 2e-5 (or to twice the plain f32
   version's own round-trip, where the C x C mix is wider and that is
   larger).  Times each step beside its plain
   version and the library yardstick (one unfused bf16 `FlowStep` call).
4. Serves the celeba64 preset at full width (K=32, L=4, hidden 512) with
   random weights from a seed: `init_glow`, DDI on a uint8 batch, then an
   Inferer answers nll on 64 images, a T=0.7 sample of 64 and a
   reconstruct, with the kernels' launch counts checked against K*L per
   request; reconstruct exact to 2e-4; fused nll against the unfused
   PyTorch path within rtol 2e-2.  Then, with the zero-convs perturbed so
   every coupling depends on the data, nll against the unfused path again.
5. Times the kernel and the plain path with CUDA events (median of reps
   after warm-up): each level's step, nll and sample images/s.
6. Holds the backward kernel (`csrc/flowstep_bwd.cu`, its recompute and six
   gradient products on the GEMM core of 17) against
   `step_backward_ref` at every celeba64 level shape at b=128 and the odd
   shapes, affine and additive: g_z and each weight grad within 5e-2 of the
   plain version's largest magnitude (g_z also elementwise rtol 5e-2 and
   mean |diff| < 2e-3 of that scale: the repo's gradient bound on
   scale-normalised grads, since the plain version's own sum order moves
   g_z by more than an absolute 5e-2 at full width; that noise floor, the
   plain version on the CPU against it on the card, is printed for the
   first images of every case); a second launch bitwise equal.  Times it
   beside the plain version and the library yardstick (an unfused bf16
   `FlowStep` forward plus `autograd.grad`).
7. Trains the celeba64 preset at full width, b=128, with synthetic
   textured data: `build` then one `train` call of steps_per_call=5,
   with K*L backward launches per step; then one `loss_fn` on the fused
   and on the unfused path (cuDNN bf16 through autograd) and the unfused
   path at f32 coupling: non-zero coupling grads, and every parameter's
   fused grad no further (relative l2) from the f32 grad than 1.5x the
   unfused bf16 grad's distance plus 1e-3; then 3 steps from one state on
   both paths, grad_norm within rtol 2e-2 at each step and losses within
   rtol 2e-2 after the third; and the train step's time, images/s and
   peak memory on both paths, and the peak memory of train steps without
   and with the trainer's eval copy of the model.
18. Runs after 7: celeba64 trained at full width (b=128, steps_per_call=5,
   synthetic textured data) through the train CLI in-process for 10 steps,
   with a plot and an eval at steps 5 and 10 (2 test batches each), an
   SWD of 64 images at 10, snapshots every 5 and the profiler over steps
   5-10: each boundary's time (SWD's host numpy apart) and flow-step
   launches from the trainer's metrics.csv, the launches against their
   count, and the run's K1/K2/K3 launches against the sum of its steps and
   boundaries (K*L = 128 per pass); the step-5 eval_nll
   against an Inferer on the step-5 snapshot's EMA weights and the same
   test batches (rtol 1e-6) and against the unfused path (rtol 2e-2); the
   step-5 sample PNG against the same samples drawn again; swd_x1e3 finite
   and above 0; best.json at the lowest eval_nll, `build(restore="best")`
   giving it again (rtol 1e-6), `cli.infer nll --best` with no fallback;
   the profiler's trace and its kernel events.
19. Runs beside 18 and 20 in a process of its own (`--beside`, which
   then runs 22; its output is printed after 21, and the times of 18-22
   are taken while the two processes share the card and the host): the
   data layer.  Every `build` above reads its batches
   through `data/pipeline.make_dataset` and the prefetcher.  (a) Writes a
   full-size CIFAR-10 python-pickle set (data_batch_1..5 of 10000 and
   test_batch of 10000, textured images from seed 0) and trains the
   cifar10 preset from it at full width (K=32, L=3, hidden 512, b=256,
   fused, bf16 coupling) through the train CLI in-process for 20 steps
   with an eval at 10 and 20; the same profile fed the same 20 steps on
   the launch thread with no prefetcher ends with bitwise-equal
   parameters; a run stopped at step 10 with the prefetch queue full
   (the prefetcher at least `prefetch` batches ahead) and resumed through
   the CLI ends at 20 with the same parameters and stream position.
   (b) 50 batches of the files through the prefetcher to the card, the
   consumer's stream sleeping (`torch.cuda._sleep`) and writing a fresh
   allocation between them: each device batch, read before and after the
   sleep, byte-equal to its host batch.  (c) A CelebA folder of 800
   178x218 PNGs (`utils/image.encode_png`), `list_attr_celeba.txt` and
   `list_eval_partition.txt`: the first celeba64 train batch within 1 of
   the numpy crop-and-bilinear plain version of the decoder in use (the
   native decoder's half-pixel bilinear, or Pillow's antialiased one),
   then celeba64 (b=128) trained 10 steps through the train CLI with an
   eval at 10, its device batches carrying "attr" (128, 40) in ±1.
   (d) The host ms of a batch of each source (textured at cifar10 and
   celeba64, the CIFAR gather, the celeba decode), the cifar10 preset's
   median step through the trainer from the files with the batches built
   on the prefetcher's thread and in 4 worker processes, and the device's
   idle share over trainer steps 10-15 (the trainer's torch.profiler
   trace, in a run of its own).
20. Runs after 18 (19 beside them): the conditional model, the imagenet64-cond preset
   (K=48, L=4, hidden 512, 1000 classes, b=128, fused, remat) at full
   width.  (a) Writes an ImageNet-64 npz set from seed 0 (two train shards
   and val_data of 4000 textured images each, 'data' (N, 12288) CHW
   uint8, 1-based 'labels' over all 1000 classes).  (b) Trains the
   unmodified preset from it through the train CLI in-process, 10 steps
   with a plot and an eval at 5 and 10 and an SWD of 64 at 10: the run's
   K1/K2/K3 launches against its steps and boundaries (192 a pass),
   `loss_class` in metrics.csv with loss = nll + 0.01 * loss_class, the
   step-5 sample PNG equal to the same samples drawn again with the same
   labels.  (c) With the class heads perturbed, `loss_fn` (loss, nll,
   loss_class) and 3 steps' grad_norm fused against unfused within rtol
   2e-2.  (d) Serving at b=64 with labels: nll against the unfused path
   (rtol 2e-2) and moved by other labels, a sample, `nll_bound` (elbo k=1
   bitwise equal to `log_prob` on the same generator state, iwae k=4 at
   most elbo k=4 per image), `cli.infer sample --class-id 7` and `nll
   --dequant-samples 4 --bound iwae`, each request's launches.  (e) The
   preset with `glow.dequant=variational`: `neg_log_q` exactly 0 at init,
   5 steps, `vardeq_logq_bits` logged, every vardeq parameter's gradient
   non-zero after them.  (f) The train step with and without vardeq
   (ms, images/s, peak memory), nll, sample and nll_bound (k=4) images/s.
21. Runs after 20: serving artifacts (`serve.py`), the attribute workflow
   and lineage snapshots.  (a) celeba64 at full width (hidden 512, L=4,
   bf16, fused) with its export depth cut to K=1 (SERVE_EXPORT_K),
   DDI'd and with perturbed zero-convs, exported at b=64 as a kernel
   artifact (all six functions, the K1/K2 chains as `torch.library` ops)
   and a portable one (nll, sample), saved, loaded and served: the kernel
   artifact's sample, encode, decode and reconstruct bitwise equal to the
   live Inferer's with the same seed, nll and nll_elbo within rtol 1e-6,
   K*L K1/K2 launches a request; the portable artifact launches none, its
   sample bitwise and nll within rtol 1e-6 of a live unfused Inferer, its
   nll within rtol 2e-2 of the fused one; both artifacts' nll bitwise
   unchanged with TF32 allowed around the call (the loader's pin); times.
   (b) One call each of
   the K4 ops (celebahq256 level 0, b=64) and the K6a / K6b ops (65536 x
   12), bitwise equal to direct launches.  (c) `cli.infer` delta,
   manipulate, interpolate and report (`--batches 2 --swd-images 64`) on
   phase 19's CelebA folder and celeba64 snapshot, each request's K1/K2
   launches counted, report.json's keys checked.  (d) A lineage .pth of
   the model imported by `scripts.torch_migrate` and scored bitwise as
   the live model, and by `cli.infer nll`.  (e) An SPMD kernel artifact
   of the same model (sample, encode, nll) with a data axis of 2, and the
   one-device kernel artifact's outputs, for 23.
22. Runs after 19 in 19's process, beside 20 and 21: multi-device
   training of celeba64 at full width
   (K=32, L=4, hidden 512, b=128 global, fused), every run through
   `cli.train.main` (steps_per_call 1 and a scalar log every step, so each
   step's loss and grad_norm reach metrics.csv; an eval of one batch at
   step 5).  (a') In-process, not distributed: `--steps 0` (DDI and a
   step-0 snapshot), then 5 steps resumed from it.  (a) The same two runs
   under `torch.distributed.run --nproc_per_node 1` (NCCL): the step-0
   and step-5 snapshots (parameters, EMA, optimizer state) and every
   logged number bitwise equal to (a'), since a one-rank group's
   collectives leave their input as it is.  (b) 2 ranks on gloo sharing the card (NCCL refuses two ranks
   on one GPU), mesh (data=2, model=1), 64 rows each: a fresh `--steps 0`
   whose DDI'd actnorms hold to (a')'s by phase 14's rule (rtol 1e-3 with
   an absolute 1e-5; the bf16 coupling nets' own actnorms to 2^-8 on
   their output), its other parameters bitwise; then 5 steps from (a')'s
   step-0 snapshot: step 1's loss within rtol 1e-5 and grad_norm within
   rtol 1e-4 of (a')'s, steps 2-5 within rtol 2e-2 (bf16 rounding flips
   compound).
   (c) The same 2 ranks as (data=1, model=2), 3 steps from that snapshot
   on the fused path (conv1/conv2 gathered over the model group before
   K1/K3): the same bounds, which a gradient scaled by the model axis
   breaks in grad_norm.  Each rank counts its own launches: K*L K1 and
   K3 per step, and the eval's K1 / K2 (K2 on every rank).  The measured
   distances and each run's step ms and images/s are printed.
23. Runs after 22: spatial sharding of celebahq256 (256x256, K=32, L=6,
   hidden 512, additive, 5-bit, bf16 coupling, fused, remat) at full width
   and depth, image rows over a model group of 2.  (a) K4 and K5 in slab
   form at level 0 (b=64, each rank's 64 of 128 rows with 2 rows of the
   other's around them, 128 wide, C=12): each slab's K4 forward and
   reverse against its plain slab version (the bounds of 3), the slabs'
   rows concatenated bitwise equal to the unsharded band chain's in both
   directions and their logdets' sum within 1e-6 relative of its logdet;
   K5 on each slab, a second launch bitwise equal, the slabs' g_z with
   their halo rows added on the neighbour and their weight grads summed
   against `step_backward_ref` at the bounds of 6; each timed beside its
   plain slab version, the library yardstick on the padded slab and the
   bound of the slab's own rows.  (b) `cli.train` not distributed,
   `--steps 0` (DDI, a step-0 snapshot) then SPATIAL_STEPS steps; the
   same steps from that snapshot under `torch.distributed.run
   --nproc_per_node 2` on gloo as (data=1, model=2) with the preset's
   `shard_spatial`: at every step (step 2 after the update) the loss
   within 1e-5 relative and grad_norm within 1e-4 of the unsharded run's,
   phase 22's step-1 bounds, K*L slab-form K4 and K5 launches a step on
   each rank, no whole-chain or unsharded band launch; each arm's
   step ms.  (c) On the same two ranks, from the step-0 snapshot: the
   sharded encode's z and split halves bitwise equal to the unsharded
   chain's (the parent's, K4 bands at level 0 and K1 below), its logdet
   within 1e-6 relative, decode(encode(x)) bitwise equal to the unsharded
   one (whose f32 round trip through 192 steps misses x by about 2e-4,
   held within 1e-3, a thirtieth of a 5-bit bin).  (d) The ranks serve 21's SPMD kernel
   artifact (data axis of 2, 32 rows a rank, outputs all-gathered): the
   sample and encode bitwise equal to the one-device kernel artifact's,
   nll within 1e-5 relative; K*L K1 launches a rank for nll and encode,
   K*L K2 for the sample.

8. Holds K1/K2 at celebahq256's levels 1-5 and K3 at its levels 2-5, the
   shapes they run at on its path (b=64, additive, the preset's coupling),
   as in 3 and 6, timed; there each weight grad is held to the
   f32-coupling grads by 7's rule
   (no further than 1.5x the plain bf16 version's distance plus 1e-3),
   since at these widths the plain version's own sum order moves w2's grad
   by several percent of its largest magnitude.
9. Holds the row-band kernels (`csrc/flowstep_band.cu`, K4, and
   `csrc/flowstep_band_bwd.cu`, K5) at celebahq256's band levels,
   128x128x12 and 64x64x24 (b=64), affine and additive: K4 against its
   plain band version at the bounds of 3, its z output bitwise equal to
   the whole chain's in both directions, the per-step round-trip to 2e-5;
   K5 against `step_backward_ref` at the bound of 6, a second launch
   bitwise equal; the chooser's copy of the backward workspace size
   against the library's.  Times each case beside the plain band version,
   the library yardstick and the bound of the centre work.
10. Serves the celebahq256 preset at full width (K=32, L=6, hidden 512,
   additive, 5-bit) with random weights from a seed, b=64: init + DDI,
   then nll, a T=0.7 sample and reconstruct, with the launches each
   request must make (level 0 on K4: 32 band_forward and 160 forward per
   nll, 32 band_reverse and 160 reverse per sample); reconstruct exact to
   2e-4; nll against the unfused path within rtol 2e-2 (and again with
   perturbed zero-convs); nll of 256 images (levels 0 and 1 on K4) whose
   first 64 match the b=64 call within rtol 1e-5; times and peak memory.
11. Trains the celebahq256 preset at full width, b=64, on synthetic
   textured data, as in 7: `build`, one `train` call of 2 steps (each 32
   band_forward, 160 forward, 64 band_backward and 128 backward), the
   per-parameter grad rule, fused vs unfused (with remat) over 3 steps,
   step time, images/s and peak memory.

12. Holds the LU 1x1 conv kernels (`csrc/invconv.cu`: K6a builds W from
   the LU factors and mixes, K6b mixes with W^-1) against their plain
   versions on CUDA tensors at the cifar10 level shapes (b=256), the
   celebahq256 DDI widths (C = 96, 192, 384) and two odd cases: y within
   2e-5 * max(1, max|y|), the round-trip within 2e-4 (or twice the plain
   f32 version's own), a second launch bitwise equal.  At C = 12, 24, 48
   the narrow path's W and y (K6a, W built by each block) and y (K6b)
   bitwise equal to the tiled kernels' on a misaligned
   copy of the same input, W within the y bound of `lu_assemble`.  Each
   path timed (call time, CUDA events; device time, torch.profiler)
   beside the plain version, the library yardstick and the bound.
13. Serves cifar10 at full width (K=32, L=3, hidden 512, b=256) on the
   unfused flow step with invconv_impl="pallas": DDI (96 K6a), nll (96
   K6a), a T=0.7 sample (96 K6b), reconstruct (96 + 96, exact to 2e-4),
   every K6 call on the narrow path (`path_launches`); nll against
   invconv_impl="xla" within rtol 1e-4, also with perturbed zero-convs;
   times and peak memory.  Then the true-f32 pin: one cifar10 log_prob at
   f32 coupling on the unfused path with PyTorch's TF32 defaults switched
   on, bitwise equal to the same call under this script's pins.
14. DDIs celeba64 (the fused preset) with invconv_impl="pallas" (128 K6a
   calls: levels 0-2 on the narrow path, one kernel each, level 3 on the
   tiled pair, two) against the "xla" DDI (rtol 1e-3, atol 1e-5; the bf16 coupling nets'
   own actnorms to bf16 resolution), and again at f32 coupling; runs the plain
   1x1 conv and the fixed shuffle / reverse permutations on the fused path
   (K=4 celeba64, nll against the unfused path within rtol 2e-2).
15. Trains cifar10 through the train CLI in-process (10 steps with
   snapshots every 5, a second call that resumes to 15, against an
   uninterrupted 15-step run within rtol 1e-5); grads of one loss_fn at
   f32 coupling, K6 against the plain mix, within relative l2 1e-4 or
   twice the plain path's own distance with its mix in f64; 3 bf16
   steps on both within rtol 2e-2; step time (the two paths in turns,
   three rounds).  Then the infer CLI on the
   snapshot: nll, sample -n 16 (its PNG decoded and held to the same
   samples drawn again), recon, and --exact with no K6 launch.  Every K6
   call of the train and infer CLIs and of the loss_fn on the narrow path.
   Then a SIGTERM from a `threading.Timer` during a call to step 30: it
   returns `preempted: true` with its snapshot on disk, and a rerun resumes
   to 30; and `--retries 1` with a train that fails once finishes at 40
   from the newest snapshot.
16. The anatomy studies S1-S3 (`csrc/anatomy.cu`, `ops/anatomy.py`), at
   the anatomy path's shape, b=128, 32x32x12, hidden 512: (a) with a flow
   step far from the identity, each variant of K1, K2 and K3 against its
   plain version at the bounds of 3 and 6 (no_logdet's logdet and the
   grads no_wgrad / no_rowsum drop exactly 0), a second launch bitwise
   equal, and `full` bitwise equal to the production kernel; (b) the
   correct-math reverse variants recip_exp and split_mix against K2
   within the per-step round-trip bound 2e-5; (c) the three anatomy
   scripts' mains with reduced N, their tables printed (two-N times,
   share of the bound, change against `full`, `full`'s device time by
   kernel), then each timed variant's output held as in (a) and (b)
   against its plain version on the scripts' own operands (celeba64's
   initial level-0 step, the scripts' inputs and staged patches), and
   bitwise against a launch outside the timing loop's buffers; `full`'s
   plain version and library yardstick (one unfused bf16 `FlowStep`
   call) timed at b=128.

17. Runs first, before 3: the chains' wgmma/TMA GEMM core
   (`csrc/gemm_sm90.cuh`, the products of K1-K5) alone, through
   `ops/flowstep.gemm_core`, against torch.matmul in f32 on the same bf16
   operands, at every product shape the backward chain uses (N or K of
   54, 108, 512, 1728 and 3456, celeba64 level 0, a ragged band-group M,
   the odd shapes' 27 columns) in both operand orders, and the forward's
   conv3 (N = 108): max |diff| within 1e-5 of the largest |a| |b| product
   sum; then with the coupling net's actnorm-ReLU epilogue at the forward's
   conv1 and conv2 shapes (celeba64 level 0 at b=64 and b=128, a K4 band
   group at 128x128x12, the odd shapes), against torch.matmul + actnorm +
   ReLU in f32 on the same operands: within one bf16 rounding (2^-8 of the
   value) plus twice that sum-order bound times e^logs; a second launch
   bitwise equal everywhere, each product timed.

With --profile, also prints torch.profiler's device time by kernel, and
the device's idle share, for one fused and one unfused train step of
celeba64 and celebahq256, and one cifar10 unfused step with and without
the K6 kernels.

Prints each phase's seconds, and a JSON line of per-kernel results (each
kernel's launches from the main-path run that drives it: K1/K2/K3 from
18, K4 from 10, K5 from 11, K4 and K5 in slab form from 23 (rank 0's
train run, and its encode and decode), K6a/K6b from 13, S1-S3 from 16c),
the card line, and last
`{"ok": true, "device": {...}}`.  Exits non-zero, with no result line,
without a CUDA device or when any check fails.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 64
TRAIN_BATCH = 128
LEVEL_SHAPES = [(32, 32, 12), (16, 16, 24), (8, 8, 48), (4, 4, 96)]
ODD_SHAPES = [(5, 7, 6), (3, 5, 16)]
ODD_BATCH = 6
KERNEL_SOURCE = "pytorch_glow_tpu_torch/csrc/flowstep.cu"
TPU_KERNEL = "pytorch_glow_tpu/ops/flowstep_pallas.py:248"
BWD_SOURCE = "pytorch_glow_tpu_torch/csrc/flowstep_bwd.cu"
BWD_TPU_KERNEL = "pytorch_glow_tpu/ops/flowstep_pallas.py:701"
BAND_SOURCE = "pytorch_glow_tpu_torch/csrc/flowstep_band.cu"
BAND_TPU_KERNEL = "pytorch_glow_tpu/ops/flowstep_pallas.py:341"
BAND_BWD_SOURCE = "pytorch_glow_tpu_torch/csrc/flowstep_band_bwd.cu"
BAND_BWD_TPU_KERNEL = "pytorch_glow_tpu/ops/flowstep_pallas.py:886"
# celebahq256 (K=32, L=6, additive; served and trained at b=64): the two
# levels the chooser sends to row bands (level 1 in the backward only), and
# the levels K1/K2 (all but level 0) and K3 (levels 2-5) run.
HQ_BAND_SHAPES = [(128, 128, 12), (64, 64, 24)]
HQ_WHOLE_SHAPES = [(64, 64, 24), (32, 32, 48), (16, 16, 96), (8, 8, 192), (4, 4, 384)]
ANATOMY_SOURCE = "pytorch_glow_tpu_torch/csrc/anatomy.cu"
ANATOMY_TPU_KERNELS = {"anatomy_forward": "scripts/perf_kernel_anatomy.py:125",
                       "anatomy_reverse": "scripts/perf_reverse_anatomy.py:121",
                       "anatomy_backward": "scripts/perf_bwd_anatomy.py:283"}
# The anatomy scripts' launch counts in phase 16c, (N1, N2), cut from their
# defaults (30/130, 20/70 for the backward).
ANATOMY_N = {"forward": (10, 40), "reverse": (10, 40), "backward": (5, 20)}
INVCONV_SOURCE = "pytorch_glow_tpu_torch/csrc/invconv.cu"
INVCONV_TPU_KERNELS = {"invconv_forward": "pytorch_glow_tpu/ops/invconv_pallas.py:52",
                       "invconv_reverse": "pytorch_glow_tpu/ops/invconv_pallas.py:158"}
CIFAR_BATCH = 256
# Phase 15's preemption check: seconds into a train call before the SIGTERM.
PREEMPT_AFTER_S = 1.0
# Phase 19: the CelebA folder's images and test split, the timed cifar10
# runs' steps and the worker loader's processes.
CELEBA_IMAGES, CELEBA_TEST = 800, 160
TIMED_STEPS = 20
DATA_WORKERS = 4
# Phase 20: images in each ImageNet-64 npz shard (the real widths, the count cut).
IMAGENET_PER_FILE = 4000
# Phase 21: the depth the serving artifacts are exported at (celeba64's K=32 cut).
SERVE_EXPORT_K = 1
# Phase 22: the steps of the data-parallel and the tensor-parallel runs.
MULTI_STEPS, TP_STEPS = 5, 3
# Phase 23: the model group that shards celebahq256's rows, the train steps
# of each arm, the SPMD artifact's data axis and functions (exported in 21).
SPATIAL_MODEL, SPATIAL_STEPS = 2, 2
SPMD_DATA, SPMD_FUNCTIONS, SPMD_SEED = 2, ("sample", "encode", "nll"), SEED + 23


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def median_ms(fn, torch, reps: int = 5, inner: int = 3) -> float:
    """Median over `reps` of the mean time of `inner` calls, CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def noisy_step(c: int, mode: str, generator, torch):
    """A random flow step whose coupling net is far from the identity."""
    from pytorch_glow_tpu_torch.models.layers import FlowStep

    step = FlowStep(c, 512, mode, torch.bfloat16, generator=generator)
    with torch.no_grad():
        for name, p in step.named_parameters():
            if not name.startswith("invconv."):
                p.add_(0.05 * torch.randn(p.shape, generator=generator))
    return step.cuda()


def hold_outputs(torch, tag: str, name: str, got, want, results: dict) -> None:
    """A forward or reverse kernel output against its plain version, the
    repo's bf16 bounds: elementwise atol/rtol 5e-2, mean |diff| < 2e-3."""
    err = (got - want).abs()
    require(bool(torch.isfinite(got).all()), f"{tag} {name}: non-finite output")
    require(bool((err <= 5e-2 + 5e-2 * want.abs()).all()),
            f"{tag} {name}: max |diff| {float(err.max())} beyond atol/rtol 5e-2")
    require(float(err.mean()) < 2e-3, f"{tag} {name}: mean |diff| {float(err.mean())}")
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], float(err.max()))


def hold_logdet_and_round_trip(tag: str, ldk, ldr, rt_err: float, rt_bound: float = 2e-5) -> None:
    ld_err = float((ldk - ldr).abs().max())
    require(bool(((ldk - ldr).abs() <= 2e-1 + 2e-2 * ldr.abs()).all()), f"{tag}: logdet |diff| {ld_err}")
    require(rt_err <= rt_bound, f"{tag}: step round-trip error {rt_err} (bound {rt_bound})")


def describe(torch, zk, zr, ldk, ldr, xk, xr, rt_err: float) -> str:
    fwd, rev = (zk - zr).abs(), (xk - xr).abs()
    return (f"fwd max {float(fwd.max()):.3e} mean {float(fwd.mean()):.3e} | logdet max "
            f"{float((ldk - ldr).abs().max()):.3e} | rev max {float(rev.max()):.3e} mean "
            f"{float(rev.mean()):.3e} | round-trip {rt_err:.3e}")


def print_times(fs, tag: str, times: dict, b, h, w, c, affine, results: dict,
                record: bool) -> None:
    """Print each kernel's (kernel, plain, library) ms beside its bound;
    with `record`, keep them as that kernel's numbers in `results`."""
    for name, (ms, plain_ms, lib_ms) in times.items():
        bound, by = fs.bound_ms(name.removeprefix("band_"), b, h, w, c, 512, affine)
        print(f"time step {name} {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        if record:
            results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                                 bound_by=by)


def check_kernels(torch, fs, results: dict, cases=None, time_all: bool = False,
                  modes=("affine", "additive")) -> None:
    """Kernel vs plain version for every level shape and the odd shapes
    (or the given (b, h, w, c) cases and coupling modes); times the b=64
    affine cases, or every case with `time_all`."""
    gen = torch.Generator().manual_seed(SEED + 10 + (cases is not None))
    if cases is None:
        cases = ([(BATCH, *shape) for shape in LEVEL_SHAPES]
                 + [(ODD_BATCH, *shape) for shape in ODD_SHAPES])
    cases = [(b, h, w, c, mode, noisy_step(c, mode, gen, torch))
             for b, h, w, c in cases for mode in modes]

    for b, h, w, c, mode, step in cases:
        affine = mode == "affine"
        z = torch.randn(b, h, w, c, generator=gen).cuda()
        with torch.no_grad():
            wf = fs.pack_weights(step, affine, reverse=False)
            wr = fs.pack_weights(step, affine, reverse=True)
            zk, ldk = fs.step_forward(wf, z, affine)
            zr, ldr = fs.step_forward_ref(wf, z, affine)
            xk = fs.step_reverse(wr, zk, affine)
            xr = fs.step_reverse_ref(wr, zk, affine)
            plain_rt = float((fs.step_reverse_ref(wr, zr, affine) - z).abs().max())
        torch.cuda.synchronize()
        tag = f"{b}x{h}x{w}x{c} {mode}"
        hold_outputs(torch, tag, "forward", zk, zr, results)
        hold_outputs(torch, tag, "reverse", xk, xr, results)
        rt_err = float((xk - z).abs().max())
        # The f32 mix and its inverse round more as C grows; at C <= 96 the
        # plain version's own round-trip is about 1e-6.
        hold_logdet_and_round_trip(tag, ldk, ldr, rt_err, max(2e-5, 2.0 * plain_rt))
        print(f"kernel {tag}: {describe(torch, zk, zr, ldk, ldr, xk, xr, rt_err)} (plain f32 "
              f"{plain_rt:.3e})")

        if (b == BATCH and affine) or time_all:
            zeros = torch.zeros(b, device=z.device)
            with torch.no_grad():
                times = {
                    "forward": (median_ms(lambda: fs.step_forward(wf, z, affine), torch),
                                median_ms(lambda: fs.step_forward_ref(wf, z, affine), torch),
                                median_ms(lambda: step(z, zeros), torch)),
                    "reverse": (median_ms(lambda: fs.step_reverse(wr, zk, affine), torch),
                                median_ms(lambda: fs.step_reverse_ref(wr, zk, affine), torch),
                                median_ms(lambda: step.reverse(zk), torch)),
                }
            print_times(fs, tag, times, b, h, w, c, affine, results,
                        (h, w, c) == LEVEL_SHAPES[0])


def rel_l2(g, r) -> float:
    d, n = float((g - r).norm()), float(r.norm())
    return d / n if n > 0 else (0.0 if d == 0 else math.inf)


def hold_backward(torch, fs, tag: str, step, affine: bool, z, gzn, gld, launch, name: str,
                  results: dict, f32_rule: bool = False) -> None:
    """One backward kernel (`launch`) against `step_backward_ref`: a second
    launch bitwise equal; g_z within 5e-2 of the plain version's largest
    magnitude (elementwise rtol 5e-2, mean |diff| < 2e-3 of that scale),
    since the plain version's own sum order moves g_z by more than an
    absolute 5e-2 at full width, a noise floor printed for the first
    images; each weight grad within 5e-2 of its plain version's largest
    magnitude, or with `f32_rule` no further from the f32-coupling grads,
    in relative l2, than 1.5x the plain bf16 version plus 1e-3 (at C >= 96
    the plain version alone moves w2's grad by a few percent of its largest
    magnitude between the CPU and the card)."""
    b, h, w, _ = z.shape
    with torch.no_grad():
        wf = fs.pack_weights(step, affine, reverse=False)
        gz, grads = launch(wf, z, gzn, gld, affine)
        gz2, grads2 = launch(wf, z, gzn, gld, affine)
        rz, rgrads = fs.step_backward_ref(wf, z, gzn, gld, affine)
    torch.cuda.synchronize()
    require(torch.equal(gz, gz2) and all(torch.equal(a, a2) for a, a2 in zip(grads, grads2)),
            f"{tag} {name}: a second launch differs")
    del gz2, grads2
    err, scale = hold_gz(torch, tag, name, gz, rz, results)
    rel = [float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
           for g, r in zip(grads, rgrads)]
    if f32_rule:
        with torch.no_grad():
            w32 = fs.pack_weights(step, affine, False, torch.float32)
            _, fgrads = fs.step_backward_ref(w32, z, gzn, gld, affine, torch.float32)
        f32_rows = [(rel_l2(g, f), rel_l2(r, f)) for g, r, f in zip(grads, rgrads, fgrads)]
        print(f"{name} {tag}: weight grads relative l2 to f32 coupling, kernel / plain bf16: "
              + ", ".join(f"{k:.2e}/{p_:.2e}" for k, p_ in f32_rows))
    for i, (g, r) in enumerate(zip(grads, rgrads)):
        require(bool(torch.isfinite(g).all()), f"{tag} {name}: non-finite grad {i}")
        if f32_rule:
            k, p_ = f32_rows[i]
            require(k <= 1.5 * p_ + 1e-3,
                    f"{tag} {name}: weight grad {i} relative l2 to f32 {k}, plain bf16 {p_}")
        else:
            gmax = float((g - r).abs().max())
            require(gmax <= 5e-2 * float(r.abs().max()),
                    f"{tag} {name}: weight grad {i} max |diff| {gmax}")
    # The plain version's own sum-order noise, CPU vs card, on the first
    # images (g_z of an image depends on that image alone).
    nb = max(1, min(b, 4096 // (h * w)))
    with torch.no_grad():
        cz, _ = fs.step_backward_ref([t.cpu() for t in wf], z[:nb].cpu(), gzn[:nb].cpu(),
                                     gld[:nb].cpu(), affine)
    floor = float((cz.cuda() - rz[:nb]).abs().max())
    print(f"{name} {tag}: g_z max {float(err.max()):.3e} mean {float(err.mean()):.3e} "
          f"scale {scale:.3f} | weight grads max rel {max(rel):.2e} | noise floor "
          f"(plain CPU vs card, {nb} images) g_z max {floor:.3e}, kernel on them "
          f"{float(err[:nb].max()):.3e}")


def hold_gz(torch, tag: str, name: str, gz, rz, results: dict):
    """A backward kernel's g_z against the plain version's: within 5e-2 of
    the plain version's largest magnitude (elementwise rtol 5e-2, mean
    |diff| < 2e-3 of that scale); returns (|diff|, scale)."""
    scale = float(rz.abs().max())
    err = (gz - rz).abs()
    require(bool(torch.isfinite(gz).all()), f"{tag} {name}: non-finite g_z")
    require(bool((err <= 5e-2 * scale + 5e-2 * rz.abs()).all()),
            f"{tag} {name}: g_z max |diff| {float(err.max())} at scale {scale}")
    require(float(err.mean()) < 2e-3 * scale,
            f"{tag} {name}: g_z mean |diff| {float(err.mean())} at scale {scale}")
    results[name]["max_abs_err"] = max(results[name]["max_abs_err"], float(err.max()))
    return err, scale


def library_backward(torch, step, z, gzn, gld):
    """The yardstick: one unfused bf16 `FlowStep` forward plus autograd.grad."""
    params = [z.detach().requires_grad_(), *step.parameters()]
    zeros = torch.zeros(z.shape[0], device=z.device)

    def library():
        out = step(params[0], zeros)
        torch.autograd.grad(out, params, (gzn, gld))

    return library


def check_backward(torch, fs, results: dict, cases=None, time_all: bool = False,
                   modes=("affine", "additive"), f32_rule: bool = False) -> None:
    """Backward kernel vs plain version (`hold_backward`) at every level
    shape (b=128) and the odd shapes (or the given (b, h, w, c) cases and
    coupling modes); times beside the plain version and the library (b=128
    affine, or every case with `time_all`)."""
    gen = torch.Generator().manual_seed(SEED + 20 + (cases is not None))
    if cases is None:
        cases = ([(TRAIN_BATCH, *shape) for shape in LEVEL_SHAPES]
                 + [(ODD_BATCH, *shape) for shape in ODD_SHAPES])
    for b, h, w, c in cases:
        for mode in modes:
            affine = mode == "affine"
            step = noisy_step(c, mode, gen, torch)
            z, gzn = (torch.randn(b, h, w, c, generator=gen).cuda() for _ in range(2))
            gld = torch.randn(b, generator=gen).cuda()
            tag = f"{b}x{h}x{w}x{c} {mode}"
            hold_backward(torch, fs, tag, step, affine, z, gzn, gld, fs.step_backward, "backward",
                          results, f32_rule)
            if (b == TRAIN_BATCH and affine) or time_all:
                with torch.no_grad():
                    wf = fs.pack_weights(step, affine, reverse=False)
                    times = {"backward": (
                        median_ms(lambda: fs.step_backward(wf, z, gzn, gld, affine), torch),
                        median_ms(lambda: fs.step_backward_ref(wf, z, gzn, gld, affine), torch))}
                times["backward"] += (median_ms(library_backward(torch, step, z, gzn, gld), torch),)
                print_times(fs, tag, times, b, h, w, c, affine, results,
                        (h, w, c) == LEVEL_SHAPES[0])


# (trans, m, n, k) of the GEMM core check (phase 17): the chain's six
# products at celeba64 level 0 (b=128), celebahq256's widest levels and a
# K5 band group, N or K of 54, 108, 512, 1728 and 3456, ragged M, and the
# odd shapes' narrow 27-column patches.  trans 0: out (m, n) = a (m, k)
# b (n, k)^T, the data gradients; trans 1: out (m, n) = a (k, m)^T b (k, n),
# the weight gradients over k pixels.
GEMM_CASES = [
    (0, 131072, 512, 108), (0, 131072, 512, 512), (0, 131072, 54, 512),
    (1, 512, 512, 131072), (1, 512, 54, 131072), (1, 108, 512, 131072),
    (0, 4096, 512, 1728), (0, 4096, 1728, 512), (0, 1024, 512, 3456),
    (1, 512, 1728, 4096), (1, 3456, 512, 1024),
    (0, 36000, 512, 54), (0, 36000, 54, 512), (1, 512, 54, 36000), (1, 54, 512, 36000),
    (0, 210, 27, 512), (1, 512, 27, 210), (0, 65536, 108, 512),
]


def epilogue_cases(fs) -> list[tuple[int, int, int]]:
    """(m, n, k) of the actnorm-ReLU epilogue check (phase 17): the coupling
    net's conv1 (k = 9 * C/2) and conv2 (k = 512) products at celeba64 level
    0 (b=64, b=128), in a K4 band group at celebahq256's 128x128x12 (the
    chooser's G at b=64, additive: G * 36 * 128 staged pixels) and at the
    odd shapes (b=6: 5x7x6, 3x5x16)."""
    g = fs.bands_per_launch("forward", BATCH, 128, 128, 12, 512, False)
    band_m = g * (fs.band_rows(128, 128) + 4) * 128
    cases = [(m, 512, k) for m in (BATCH * 1024, TRAIN_BATCH * 1024, band_m) for k in (54, 512)]
    return cases + [(ODD_BATCH * h * w, 512, k) for h, w, c in ODD_SHAPES
                    for k in (9 * (c // 2), 512)]


def check_gemm_core(torch, fs) -> None:
    """Phase 17: the chains' wgmma/TMA GEMM core alone (`fs.gemm_core`)
    against torch.matmul in f32 on the same bf16 operands, at GEMM_CASES,
    rows padded to a multiple of 8 columns with a non-zero pad the core
    must not read: max |diff| within 1e-5 of the largest |a| |b| product
    sum (about 2^-24 times the reduction length at most, far under what a
    wrong tile, lane or chunk moves), and a second launch bitwise equal.
    Then the actnorm-ReLU epilogue at `epilogue_cases`."""
    gen = torch.Generator().manual_seed(SEED + 60)
    for trans, m, n, k in GEMM_CASES:
        shapes = ((k, m), (k, n)) if trans else ((m, k), (n, k))
        a, b = (torch.full((rows, fs.padded(cols)), 7.0, dtype=torch.bfloat16)
                for rows, cols in shapes)
        a[:, :shapes[0][1]] = torch.randn(shapes[0], generator=gen)
        b[:, :shapes[1][1]] = torch.randn(shapes[1], generator=gen)
        a, b = a.cuda(), b.cuda()
        got = fs.gemm_core(a, b, bool(trans), m, n, k)
        again = fs.gemm_core(a, b, bool(trans), m, n, k)
        av, bv = a[:, :shapes[0][1]].float(), b[:, :shapes[1][1]].float()
        want = av.T @ bv if trans else av @ bv.T
        scale = float((av.abs().T @ bv.abs() if trans else av.abs() @ bv.abs().T).max())
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tag = f"gemm core trans={trans} ({m}, {n}) over k={k}"
        require(torch.equal(got, again), f"{tag}: a second launch differs")
        require(bool(torch.isfinite(got).all()) and err <= 1e-5 * scale,
                f"{tag}: max |diff| {err} at scale {scale}")
        ms = median_ms(lambda: fs.gemm_core(a, b, bool(trans), m, n, k), torch)
        print(f"{tag}: max |diff| {err:.3e} (scale {scale:.1f}), {ms:.4f} ms, "
              f"{2e-9 * m * n * k / ms:.1f} TFLOP/s")
        del a, b, got, again, want
    for m, n, k in epilogue_cases(fs):
        check_gemm_epilogue(torch, fs, m, n, k, gen)


def check_gemm_epilogue(torch, fs, m: int, n: int, k: int, gen) -> None:
    """The core with the coupling net's conv epilogue, out = bf16(relu((a
    b^T + bias) e^logs)), against torch.matmul + actnorm + ReLU in f32 on
    the same operands (a pad of 7s the core must not read; w1-like weights
    scaled by 1/sqrt(k); bias and logs about the actnorms'): within one
    bf16 rounding of the value (2^-8) plus twice phase 17's sum-order bound
    times e^logs (a rounding can flip where the f32 sums differ in order),
    some outputs zero and some not, and a second launch bitwise equal."""
    a = torch.full((m, fs.padded(k)), 7.0, dtype=torch.bfloat16)
    b = torch.full((n, fs.padded(k)), 7.0, dtype=torch.bfloat16)
    a[:, :k] = torch.randn(m, k, generator=gen)
    b[:, :k] = torch.randn(n, k, generator=gen) / math.sqrt(k)
    bias, logs = 0.5 * torch.randn(n, generator=gen), 0.2 * torch.randn(n, generator=gen)
    a, b, bias, logs = a.cuda(), b.cuda(), bias.cuda(), logs.cuda()
    got = fs.gemm_core(a, b, False, m, n, k, (bias, logs))
    again = fs.gemm_core(a, b, False, m, n, k, (bias, logs))
    av, bv = a[:, :k].float(), b[:, :k].float()
    want = torch.relu((av @ bv.T + bias) * torch.exp(logs))
    scale = float((av.abs() @ bv.abs().T).max())
    excess = float(((got.float() - want).abs()
                    - (2.0 ** -8 * want.abs() + 2e-5 * scale * torch.exp(logs))).max())
    torch.cuda.synchronize()
    tag = f"gemm core actnorm-relu ({m}, {n}) over k={k}"
    require(torch.equal(got, again), f"{tag}: a second launch differs")
    require(excess <= 0.0, f"{tag}: beyond the bound by {excess}")
    require(bool((got == 0).any()) and bool((got > 0).any()), f"{tag}: ReLU all one side")
    err = float((got.float() - want).abs().max())
    ms = median_ms(lambda: fs.gemm_core(a, b, False, m, n, k, (bias, logs)), torch)
    print(f"{tag}: max |diff| {err:.3e} (scale {scale:.1f}), {ms:.4f} ms, "
          f"{2e-9 * m * n * k / ms:.1f} TFLOP/s")


def random_lu(c: int, generator, torch):
    """LU factors of a random 1x1 conv, perturbed off the rotation as the
    JAX package's own K6 tests perturb theirs (tests/test_invconv_pallas.py
    `_lu`), on the card."""
    from pytorch_glow_tpu_torch.models.layers import InvConv1x1LU

    conv = InvConv1x1LU(c, generator)
    with torch.no_grad():
        conv.lower.add_(0.02 * torch.randn(c, c, generator=generator))
        conv.upper.add_(0.02 * torch.randn(c, c, generator=generator))
        conv.log_s.add_(0.1)
    return conv.cuda()


def invconv_bound_ms(kind: str, n: int, c: int):
    """The least time of one K6 call: each input read once and each output
    written once over the memory rate, against its f32 FMAs over the f32
    peak.  K6a reads x and the LU factors (L, U, log_s, sign_s, the int64
    permutation), builds W (sum over k <= min(p[i], j): about C^3 / 3
    FMAs) and mixes; K6b reads x and W^-1 and mixes."""
    from pytorch_glow_tpu_torch.ops.flowstep import PEAK_BYTES, PEAK_F32

    if kind == "invconv_forward":
        nbytes = 4 * (2 * n * c + 2 * c * c + 2 * c) + 8 * c
        flops = 2 * n * c * c + 2 * c ** 3 / 3
    else:
        nbytes = 4 * (2 * n * c + c * c)
        flops = 2 * n * c * c
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_invconv(torch, icf, results: dict, card: str) -> None:
    """K6a and K6b against their plain versions on CUDA tensors: the cifar10
    level shapes at b=256, the celebahq256 DDI widths (C = 96, 192, 384 at
    b=64) and two odd cases.  y within 2e-5 * max(1, max|y|) (the JAX
    bound, tests/test_invconv_pallas.py:34), the logdet equal to sum(log_s),
    the reverse likewise against its plain version, the round-trip
    K6b(K6a(x)) within 2e-4 (:52) or twice the plain f32 version's own where
    C is wide, a second launch bitwise equal.  At the narrow widths
    (`icf.NARROW_C`) the narrow path's W and y (K6a, W built by each block)
    and y (K6b) bitwise equal to the tiled
    kernels' on the same inputs (a misaligned copy takes the tiled path).
    Times each case beside its plain version, the library yardstick (the
    unfused `InvConv1x1LU.forward` for K6a, one `torch.matmul(x, W.T)` for
    K6b) and the bound, call time (CUDA events) and device time
    (torch.profiler, `scripts/perf_invconv.device_ms`, CUDA events where
    its traces hold no kernel) per path; the
    cases are `icf.INVCONV_CASES`; the first, cifar10's level 0, gives the
    kernels line its numbers."""
    from pytorch_glow_tpu_torch.ops import invconv as ic
    from pytorch_glow_tpu_torch.scripts.perf_invconv import device_ms

    gen = torch.Generator().manual_seed(SEED + 40)
    device_ms(lambda: torch.zeros(1, device="cuda"))  # the profiler's first trace
    for n, c in icf.INVCONV_CASES:
        conv = random_lu(c, gen, torch)
        x = torch.randn(n, c, generator=gen).cuda()
        with torch.no_grad():
            lu = conv.lu_params()
            w, w_inv = ic.lu_assemble(lu), ic.lu_inverse(lu)
            yk, ld = icf.invconv_lu_forward(x, lu)
            yk2, _ = icf.invconv_lu_forward(x, lu)
            yr = ic.mix_channels(x, w)
            xk = icf.invconv_lu_reverse(yk, lu)
            xk2 = icf.invconv_lu_reverse(yk, lu)
            xr = ic.mix_channels(yk, w_inv)
            plain_rt = float((ic.mix_channels(yr, w_inv) - x).abs().max())
        torch.cuda.synchronize()
        tag = f"K6 {n}x{c}"
        require(torch.equal(yk, yk2) and torch.equal(xk, xk2), f"{tag}: a second launch differs")
        require(bool(torch.isfinite(yk).all() and torch.isfinite(xk).all()), f"{tag}: non-finite")
        fwd_err, rev_err = float((yk - yr).abs().max()), float((xk - xr).abs().max())
        fwd_tol = 2e-5 * max(1.0, float(yr.abs().max()))
        rev_tol = 2e-5 * max(1.0, float(xr.abs().max()))
        rt_err = float((xk - x).abs().max())
        rt_tol = max(2e-4, 2.0 * plain_rt)
        print(f"kernel {tag} ({icf.tensor_path(x)} path): forward max |diff| {fwd_err:.3e} "
              f"(bound {fwd_tol:.3e}), reverse {rev_err:.3e} (bound {rev_tol:.3e}), round-trip "
              f"{rt_err:.3e} (bound {rt_tol:.3e}, plain f32 {plain_rt:.3e})")
        require(fwd_err <= fwd_tol, f"{tag}: forward max |diff| {fwd_err}")
        require(rev_err <= rev_tol, f"{tag}: reverse max |diff| {rev_err}")
        require(rt_err <= rt_tol, f"{tag}: round-trip {rt_err}")
        require(torch.equal(ld, lu.log_s.sum()), f"{tag}: logdet is not sum(log_s)")
        results["invconv_forward"]["max_abs_err"] = max(results["invconv_forward"]["max_abs_err"],
                                                        fwd_err)
        results["invconv_reverse"]["max_abs_err"] = max(results["invconv_reverse"]["max_abs_err"],
                                                        rev_err)

        # Each path's launcher on the same values: K6a from the LU factors,
        # K6b from W^-1 (its solves are outside the kernel, timed apart).
        paths = {"invconv_forward": {"": lambda: icf._launch_forward(x, *lu)},
                 "invconv_reverse": {"": lambda: icf._launch_mix(yk, w_inv)}}
        if c in icf.NARROW_C:
            x_t, yk_t = misaligned(torch, x), misaligned(torch, yk)
            require(icf.tensor_path(x) == "narrow" and icf.tensor_path(x_t) == "tiled",
                    f"{tag}: paths {icf.tensor_path(x)}, {icf.tensor_path(x_t)}")
            paths["invconv_forward"]["tiled"] = lambda: icf._launch_forward(x_t, *lu)
            paths["invconv_reverse"]["tiled"] = lambda: icf._launch_mix(yk_t, w_inv)
            with torch.no_grad():
                outs = {name: {path: fn() for path, fn in fns.items()}
                        for name, fns in paths.items()}
            torch.cuda.synchronize()
            fwd, rev = outs["invconv_forward"], outs["invconv_reverse"]
            require(same(torch, fwd[""], fwd["tiled"]),
                    f"{tag}: K6a's narrow y, W differ from the tiled kernels'")
            require(torch.equal(rev[""], rev["tiled"]), f"{tag}: K6b narrow vs tiled differ")
            w_err = float((fwd[""][1] - w).abs().max())
            require(torch.equal(fwd[""][0], yk), f"{tag}: K6a's launcher differs from the call")
            require(w_err <= 2e-5 * max(1.0, float(w.abs().max())), f"{tag}: W |diff| {w_err}")
            print(f"kernel {tag}: narrow K6a and K6b bitwise equal to the tiled kernels; W max |diff| {w_err:.3e} from "
                  f"lu_assemble")
        with torch.no_grad():
            plain_lib = {
                "invconv_forward": (
                    median_ms(lambda: ic.mix_channels(x, ic.lu_assemble(lu)), torch),
                    median_ms(lambda: conv(x.view(1, 1, n, c)), torch)),
                "invconv_reverse": (
                    median_ms(lambda: ic.mix_channels(yk, w_inv), torch),
                    median_ms(lambda: torch.matmul(yk, w_inv.T), torch)),
            }
            timed = {name: {path: (median_ms(fn, torch), device_ms(fn))
                            for path, fn in fns.items()} for name, fns in paths.items()}
            wrappers = (median_ms(lambda: icf.invconv_lu_forward(x, lu), torch),
                        median_ms(lambda: icf.invconv_lu_reverse(yk, lu), torch),
                        median_ms(lambda: ic.lu_inverse(lu), torch))
        for name, (plain_ms, lib_ms) in plain_lib.items():
            bound, by = invconv_bound_ms(name, n, c)
            ms, dev_ms = timed[name][""]
            others = "".join(f", {path} {t:.4f} ms (device {d:.4f} ms)"
                             for path, (t, d) in timed[name].items() if path)
            print(f"time {name} {n}x{c}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms, "
                  f"{icf.tensor_path(x)} path){others}, plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            if (n, c) == icf.INVCONV_CASES[0]:
                results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by)
        print(f"time K6 wrappers {n}x{c}: invconv_lu_forward {wrappers[0]:.4f} ms, "
              f"invconv_lu_reverse {wrappers[1]:.4f} ms, of which lu_inverse {wrappers[2]:.4f} ms")
    print(f"card for these times: {card}")


def misaligned(torch, t):
    """A copy of `t` whose storage starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    out.copy_(t)
    return out


def clone_state(state: dict, model) -> dict:
    """A train state on `model` with copies of the optimizer state and EMA."""
    out = {**state, "model": model,
           "opt_state": {k: v.clone() for k, v in state["opt_state"].items()}}
    if "ema" in state:
        out["ema"] = [e.clone() for e in state["ema"]]
    return out


def train_step_ms(step_fn, state, batches, torch):
    """Median CUDA-event time of single train steps over `batches` (after
    one warm-up step), and the peak memory of those steps."""
    state, _ = step_fn(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for batch in batches[1:]:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step_fn(state, batch)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), torch.cuda.max_memory_allocated()


def profile_step(step_fn, state, batch, torch, what: str) -> None:
    """Device time by kernel over one train step (torch.profiler), and the
    share of the step's wall time the device sat idle; "not measured"
    where the trace holds no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        print(f"profile {what} train step: wall {wall_ms:.3f} ms (profiler on), device busy "
              "not measured: the trace held no kernel")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"profile {what} train step: wall {wall_ms:.3f} ms (profiler on), device busy "
          f"{busy_ms:.3f} ms in {sum(e.count for e in events)} kernels, "
          f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d}x  {e.key[:100]}")


def counts(fs, **kw) -> dict:
    """A launch-count dict with every chain's key, zero unless given."""
    return {key: kw.get(key, 0) for key in fs.launches}


def expected_launches(fs, cfg, b: int, directions, times: int = 1) -> dict:
    """Launches of `times` passes of the model in each direction: K per
    level, on the chain `tiling()` picks for that level."""
    out = counts(fs)
    for h, w, c in cfg.latent_shapes():
        for d in directions:
            whole = fs.tiling(d, b, h, w, c, cfg.hidden_channels, cfg.flow_coupling == "affine")
            out[d if whole == "whole" else "band_" + d] += times * cfg.K
    return out


def check_training(torch, fs, card: str, out_dir: str, profiling: bool = False,
                   preset: str = "celeba64", batch: int = TRAIN_BATCH,
                   num_steps: int | None = None, time_steps: int = 3,
                   want: dict | None = None, eval_copy_memory: bool = False) -> dict:
    """The training path of a preset at full width and its own batch, with
    snapshots under `out_dir`: one `train` call of `num_steps` steps
    (default: steps_per_call), whose launches must be `want` (default: each
    level's chain, K per step).  With `eval_copy_memory`, the peak memory
    of that call beside that of as many more steps with the trainer's eval
    copy of the model allocated."""
    from pytorch_glow_tpu_torch import PRESETS, build, init_glow, train
    from pytorch_glow_tpu_torch.train import step as steplib

    profile = PRESETS[preset]
    profile = profile.replace(data=dataclasses.replace(profile.data, name="synthetic_textured"),
                              out_dir=out_dir)
    cfg, t = profile.glow, profile.train
    require(t.batch_size == batch, f"{preset} batch {t.batch_size}")
    num_steps = num_steps or t.steps_per_call
    t0 = time.perf_counter()
    built = build(profile)
    torch.cuda.synchronize()
    print(f"train build ({preset}, K={cfg.K}, L={cfg.L}, hidden {cfg.hidden_channels}, "
          f"{cfg.flow_coupling}, {cfg.n_bits_x}-bit, remat={cfg.remat}, b={t.batch_size}, "
          f"steps_per_call={t.steps_per_call}): {time.perf_counter() - t0:.2f} s")

    # -- the main path: one train call --------------------------------------
    fs.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = train(built, num_steps=num_steps, quiet=True)
    torch.cuda.synchronize()
    launches = dict(fs.launches)
    peak_alone = torch.cuda.max_memory_allocated()
    per_step = expected_launches(fs, cfg, batch, ("forward", "backward"))
    print(f"train ({preset}, {num_steps} steps, {time.perf_counter() - t0:.2f} s): {result}; "
          f"launches {launches} (per step {per_step})")
    require(result["final_step"] == num_steps and math.isfinite(result["loss"]),
            f"train result {result}")
    require(launches == expected_launches(fs, cfg, batch, ("forward", "backward"), num_steps),
            f"train launches {launches}")
    if want is not None:
        require(per_step == want, f"{preset} launches per train step {per_step}, want {want}")
    if eval_copy_memory:
        # The boundaries' eval copy of the model (`Built.serving`), made at
        # the first boundary, stays allocated through the later train steps.
        require(built.eval_model is None, "an eval copy before any boundary")
        before = torch.cuda.memory_allocated()
        built.serving(steplib.ema_params(built.state))
        copy_bytes = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        train(built, num_steps=2 * num_steps, quiet=True)
        torch.cuda.synchronize()
        peak_with = torch.cuda.max_memory_allocated()
        print(f"peak memory of {num_steps} train steps {preset} b={batch}: without the eval "
              f"copy {peak_alone / 2**30:.3f} GiB, with it {peak_with / 2**30:.3f} GiB (the copy "
              f"holds {copy_bytes / 2**30:.3f} GiB); card: {card}")
        built.eval_model = None
        torch.cuda.empty_cache()

    # -- fault 1: every coupling net gets gradients through the kernels, and
    # every parameter's grad is as close to the f32 grad as the unfused
    # bf16 path's -----------------------------------------------------------
    model = built.state["model"]
    plain_cfg = dataclasses.replace(cfg, flowstep_impl="xla")
    plain = init_glow(plain_cfg)
    plain.load_state_dict(model.state_dict())
    x = model.preprocess(next(built.data)["image"])

    def param_grads(m):
        params = list(m.parameters())
        loss, _ = m.loss_fn(x, torch.Generator(device="cuda").manual_seed(SEED))
        got = torch.autograd.grad(loss, params, allow_unused=True)
        return [g if g is not None else torch.zeros_like(p) for g, p in zip(got, params)]

    fused_g, plain_g = param_grads(model), param_grads(plain)
    ref = init_glow(dataclasses.replace(plain_cfg, compute_dtype="float32"))
    ref.load_state_dict(model.state_dict())
    ref_g = param_grads(ref)
    del ref
    names = [n for n, _ in model.named_parameters()]
    coupling = [i for i, n in enumerate(names) if ".f." in n and n.endswith("weight")]
    dead = [names[i] for i in coupling if not bool((fused_g[i] != 0).any())]
    bad = [n for n, g in zip(names, fused_g) if not bool(torch.isfinite(g).all())]
    print(f"coupling weight grads: {len(coupling)} tensors, {len(dead)} all-zero; "
          f"{len(bad)} of {len(names)} parameter grads non-finite")
    require(not dead and not bad, f"coupling grads all-zero {dead[:3]} or non-finite {bad[:3]}")
    # Both bf16 paths round the coupling net, in different orders, so their
    # grads differ by bf16 noise (up to 0.17 of the largest magnitude in the
    # deepest levels' conv1 weights, for the unfused path against f32 too).
    # A wrong gradient is off by its own size.  So each tensor's fused grad
    # must be no further from the f32-coupling grad than 1.5x the unfused
    # bf16 grad's distance, plus 1e-3, in relative l2: |g - ref| / |ref|.
    def rel_max(g, r):
        d, n = float((g - r).abs().max()), float(r.abs().max())
        return d / n if n > 0 else (0.0 if d == 0 else math.inf)

    rows = [(rel_l2(f, r), rel_l2(p, r), rel_max(f, p), n)
            for n, f, p, r in zip(names, fused_g, plain_g, ref_g)]
    over = [(fr, pr, n) for fr, pr, _, n in rows if fr > 1.5 * pr + 1e-3]
    worst_f = max(rows)
    worst_p = max(rows, key=lambda r: r[1])
    worst_fp = max(rows, key=lambda r: r[2])
    print(f"parameter grads, one loss_fn at b={t.batch_size}, {len(rows)} tensors, relative l2 "
          f"to the f32-coupling grads: fused worst {worst_f[0]:.3e} ({worst_f[3]}), unfused bf16 "
          f"worst {worst_p[1]:.3e} ({worst_p[3]}), fused / unfused worst "
          f"{max(fr / max(pr, 1e-30) for fr, pr, _, _ in rows):.3f}; fused vs unfused bf16 "
          f"max |diff| / max |unfused| worst {worst_fp[2]:.3e} ({worst_fp[3]})")
    require(not over, f"fused grads further from f32 than 1.5x unfused bf16 + 1e-3: {over[:3]}")
    del fused_g, plain_g, ref_g

    # -- 3 steps from one state: fused vs unfused ---------------------------
    schedule = built.schedule
    fused_step = steplib.make_train_step(cfg, built.tx, t.ema_decay, schedule, t.augment_flip)
    plain_step = steplib.make_train_step(plain_cfg, built.tx, t.ema_decay, schedule,
                                         t.augment_flip)
    state_f = built.state
    state_p = clone_state(state_f, plain)
    # The unfused path fits at the preset's batch (about 27 GiB at b=128).
    # Losses within rtol 2e-2 after 3 steps (tests/test_flowstep_pallas.py:492),
    # and the raw grads' global norm within rtol 2e-2 at every step.
    print(f"fused vs unfused, 3 steps from one state on the same batches, b={t.batch_size}")
    for _ in range(3):
        batch = next(built.data)["image"]
        state_f, mf = fused_step(state_f, batch)
        state_p, mp = plain_step(state_p, batch)
        lf, lp = float(mf["loss"]), float(mp["loss"])
        nf, np_ = float(mf["grad_norm"]), float(mp["grad_norm"])
        print(f"train step {state_f['step']}: loss fused {lf:.6f} unfused {lp:.6f} "
              f"(rel {abs(lf - lp) / abs(lp):.2e}), grad_norm {nf:.6f} vs {np_:.6f} "
              f"(rel {abs(nf - np_) / abs(np_):.2e})")
        require(math.isfinite(nf) and abs(nf - np_) <= 2e-2 * abs(np_),
                f"fused vs unfused grad_norm at step {state_f['step']}: {nf} vs {np_}")
    require(math.isfinite(lf) and abs(lf - lp) <= 2e-2 * abs(lp),
            f"fused vs unfused loss after 3 steps: {lf} vs {lp}")

    # -- times: train step, fused and unfused -------------------------------
    batches = [next(built.data)["image"] for _ in range(time_steps + 1)]
    del state_p
    fused_ms, fused_mem = train_step_ms(fused_step, state_f, batches, torch)
    plain_ms, plain_mem = train_step_ms(plain_step, clone_state(state_f, plain), batches, torch)
    b = t.batch_size
    print(f"time train step {preset} b={b}: fused {fused_ms:.3f} ms ({b * 1e3 / fused_ms:.1f} img/s, "
          f"peak {fused_mem / 2**30:.2f} GiB), unfused {plain_ms:.3f} ms "
          f"({b * 1e3 / plain_ms:.1f} img/s, peak {plain_mem / 2**30:.2f} GiB)")
    print(f"card for these times: {card}")
    if profiling:
        profile_step(fused_step, state_f, batches[0], torch, f"{preset} fused")
        profile_step(plain_step, clone_state(state_f, plain), batches[0], torch, f"{preset} unfused")
    return launches


def add_counts(*dicts) -> dict:
    return {k: sum(d[k] for d in dicts) for k in dicts[0]}


def check_boundaries(torch, fs, card: str, out_root: str) -> dict:
    """Phase 18: celeba64 at full width (K=32, L=4, hidden 512, b=128,
    steps_per_call=5) trained through the train CLI in-process for 10 steps
    with every boundary at step 5 or 10: a plot and an eval at both, an SWD
    at 10, snapshots every 5, the profiler over steps 5-10.  Each
    boundary's time and flow-step launches as the trainer logs them to
    metrics.csv, the launches against their count, and the run's K1/K2/K3
    launches against the sum of its steps and boundaries (K*L = 128 per
    pass: a plot is a sample of 16 and a reconstruct of 16; an eval is
    2 x 2 batches forward and a reconstruct of 16; an SWD a sample of 64; a
    train step a forward and a backward at b=128).  Then: the
    step-5 eval_nll against an Inferer's nll on the EMA weights of the
    step-5 snapshot and the same test batches (rtol 1e-6) and against the
    unfused path (rtol 2e-2); the step-5 sample PNG against the same
    samples drawn again; swd_x1e3 finite and above 0; best.json at the
    lowest eval_nll, `build(restore="best")` at that step giving that
    eval_nll again (rtol 1e-6), and `cli.infer nll --best` loading it with
    no fallback; the profiler's trace.  Returns the run's launches."""
    import contextlib
    import io

    import numpy as np

    from pytorch_glow_tpu_torch import Inferer, build, init_glow
    from pytorch_glow_tpu_torch.cli import infer as infer_cli
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager
    from pytorch_glow_tpu_torch.utils.image import make_grid

    argv = ["celeba64", "--synthetic", "textured", "--quiet", "--out-dir", out_root,
            "--steps", "10", "--set", "train.plot_gap=5", "--set", "train.eval_gap=5",
            "--set", "train.swd_gap=10", "--set", "train.checkpoint_gap=5",
            "--set", "train.eval_batches=2", "--set", "train.swd_images=64",
            "--set", "train.profile_step=5", "--set", "train.profile_num_steps=5"]
    prof = train_cli.resolve_profile(train_cli.parse_args(argv))
    cfg, t = prof.glow, prof.train
    run = os.path.join(out_root, prof.name)
    n_img, n_swd, b = t.num_sample_images, min(t.swd_images, t.batch_size), t.batch_size

    # -- the main path: the train CLI through every boundary; the trainer logs
    # each boundary's wall time and launches, and SWD's host numpy part -----
    fs.reset_launches()
    t0 = time.perf_counter()
    result, _ = run_cli(train_cli.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fs.launches)
    print(f"train CLI celeba64 through the boundaries (K={cfg.K}, L={cfg.L}, hidden "
          f"{cfg.hidden_channels}, b={b}, steps_per_call={t.steps_per_call}), 10 steps: "
          f"{wall:.2f} s; launches {launches}")
    require(result["final_step"] == 10 and math.isfinite(result["loss"])
            and "preempted" not in result, f"train {result}")

    recon = expected_launches(fs, cfg, n_img, ("forward", "reverse"))
    want = {"plot": add_counts(expected_launches(fs, cfg, n_img, ("reverse",)), recon),
            "eval": add_counts(expected_launches(fs, cfg, b, ("forward",), 2 * t.eval_batches),
                               recon),
            "swd": expected_launches(fs, cfg, n_swd, ("reverse",))}
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    boundaries = [{"kind": kind, "step": int(r["step"]), "ms": float(r[f"{kind}_ms"]),
                   "launches": int(float(r[f"{kind}_launches"])), "row": r}
                  for r in rows for kind in ("plot", "eval", "swd") if r.get(f"{kind}_ms")]
    order = [(r["kind"], r["step"]) for r in boundaries]
    require(order == [("plot", 5), ("eval", 5), ("plot", 10), ("eval", 10), ("swd", 10)],
            f"boundaries {order}")
    # Each boundary's launches (the trainer logs their sum), and the run's
    # launches of each chain: ten train steps and these boundaries.
    for r in boundaries:
        print(f"boundary {r['kind']} at step {r['step']}: {r['ms']:.3f} ms, "
              f"{r['launches']} launches")
        require(r["launches"] == sum(want[r["kind"]].values()),
                f"{r['kind']} at step {r['step']}: launches {r['launches']}, "
                f"want {want[r['kind']]}")
    steps = expected_launches(fs, cfg, b, ("forward", "backward"), 10)
    require(launches == add_counts(steps, *(want[r["kind"]] for r in boundaries)),
            f"run launches {launches}")
    require(want["plot"]["reverse"] == 2 * cfg.K * cfg.L and want["swd"]["reverse"] == 128
            and want["eval"]["forward"] == (2 * t.eval_batches + 1) * 128, f"counts {want}")
    for kind in ("plot", "eval", "swd"):
        rs = [r for r in boundaries if r["kind"] == kind]
        part = {"swd": ("the host SWD", "swd_host_ms"),
                "eval": ("the best snapshot's check and write", "best_save_ms")}.get(kind)
        print(f"time boundary {kind} celeba64 b={b}: " + ", ".join(f"{r['ms']:.3f}" for r in rs)
              + " ms" + (f" (of which {part[0]} "
                         + ", ".join(f"{float(r['row'][part[1]]):.3f}" for r in rs) + " ms)"
                         if part else ""))
    print(f"card for these times: {card}")
    evals = {int(r["step"]): r for r in rows if r.get("eval_nll")}
    swds = [float(r["swd_x1e3"]) for r in rows if r.get("swd_x1e3")]
    print("eval rows: " + "; ".join(
        f"step {s}: " + ", ".join(f"{k} {r[k]}" for k in r if r[k] and k != "step")
        for s, r in evals.items()) + f"; swd_x1e3 {swds}")
    require(sorted(evals) == [5, 10] and all(r.get("eval_nll_raw") for r in evals.values()),
            f"eval rows {evals}")
    require(len(swds) == 1 and math.isfinite(swds[0]) and swds[0] > 0, f"swd_x1e3 {swds}")

    # -- eval_nll against an Inferer on the step-5 snapshot's EMA weights ----
    test = make_dataset(prof.data, cfg, t, split="test")
    test_batches = {s: [next(test)["image"] for _ in range(t.eval_batches)] for s in (5, 10)}

    def ema_model(snapshot, config=cfg):
        m = init_glow(config, device="cuda")
        m.load_state_dict(snapshot["model"])
        m.load_state_dict(steplib.ema_params({"model": m, "ema": snapshot["ema"]}))
        return m

    def eval_nll(m, step):
        inf = Inferer(m)
        return float(np.mean([float(inf.nll(x).mean()) for x in test_batches[step]]))

    snap5 = torch.load(os.path.join(run, "checkpoints", "5.pt"), map_location="cuda",
                       weights_only=True)
    model5 = ema_model(snap5)
    logged5, again5 = float(evals[5]["eval_nll"]), eval_nll(model5, 5)
    plain5 = ema_model(snap5, dataclasses.replace(cfg, flowstep_impl="xla"))
    print(f"step-5 eval_nll: logged {logged5:.7f}, Inferer on the snapshot's EMA weights "
          f"{again5:.7f} (rel {abs(logged5 - again5) / abs(again5):.2e})")
    require(abs(logged5 - again5) <= 1e-6 * abs(again5), f"eval_nll {logged5} vs {again5}")
    compare_nll(Inferer(model5), Inferer(plain5), test_batches[5][0], "step-5 EMA weights")
    del plain5

    # -- the step-5 sample grid, drawn again ---------------------------------
    with open(os.path.join(run, "samples", "step_00000005.png"), "rb") as f:
        grid = decode_png(f.read())
    temp = t.sample_temperature * min(1.0, 5 / t.temperature_anneal_steps)
    redraw = make_grid(steplib.make_sample_fn(cfg, n_img, t.sample_temperature)(
        model5, steplib.step_generator(t.seed + 2, 5, "cuda"), temp).cpu().numpy())
    diff = int(np.abs(grid.astype(np.int16) - redraw.astype(np.int16)).max())
    print(f"step-5 sample PNG {grid.shape} at T={temp}: against the same samples drawn again, "
          f"max uint8 diff {diff}")
    require(grid.shape == redraw.shape and diff == 0, f"sample PNG diff {diff}")
    require(os.path.isfile(os.path.join(run, "recon", "step_00000010.png")), "recon PNG")
    del model5, snap5

    # -- the best snapshot -----------------------------------------------------
    info = CheckpointManager(os.path.join(run, "checkpoints")).best_info()
    lowest = min(evals, key=lambda s: float(evals[s]["eval_nll"]))
    print(f"best.json {info}; lowest logged eval_nll at step {lowest}")
    require(info is not None and info["step"] == lowest
            and info["metric"] == float(evals[lowest]["eval_nll"]), f"best {info}")
    best = build(prof, restore="best")
    require(best.restored == "best" and best.start_step == lowest,
            f"build(restore='best') {best.restored} at {best.start_step}")
    best_model = init_glow(cfg, device="cuda")
    best_model.load_state_dict(steplib.ema_params(best.state))
    again = eval_nll(best_model, lowest)
    print(f"build(restore='best'): step {best.start_step}, eval_nll on its EMA weights {again:.7f} "
          f"(rel {abs(again - info['metric']) / abs(info['metric']):.2e})")
    require(abs(again - info["metric"]) <= 1e-6 * abs(info["metric"]), f"best eval_nll {again}")
    del best, best_model
    torch.cuda.empty_cache()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _, text = run_cli(infer_cli.main, ["nll", "celeba64", "--synthetic", "textured",
                                           "--out-dir", out_root, "--batches", "1", "--best"])
    require(f"loaded the best snapshot, step {lowest}" in text and "warning" not in err.getvalue(),
            f"infer --best: {text!r} {err.getvalue()!r}")

    # -- the profiler's trace --------------------------------------------------
    trace = os.path.join(run, "profile", "trace_step_00000005.json")
    require(os.path.isfile(trace), "no profiler trace")
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if str(e.get("cat", "")).lower() == "kernel")
    print(f"profiler trace of steps 5-10: {os.path.getsize(trace)} bytes, {len(events)} events, "
          + (f"{kernels} kernel events" if kernels else "kernel events not measured (none recorded)"))
    return launches


def check_band(torch, fs, lib, results: dict) -> None:
    """K4 and K5 at the celebahq256 band levels (b=64), affine and additive:
    K4 against its plain band version at the bounds of check_kernels, its z
    output bitwise equal to the whole chain's in both directions, the
    per-step round-trip to 2e-5; K5 by `hold_backward`.  Times each case
    beside the plain band version, the library yardstick and the bound of
    the centre work.  Also holds the CPU chooser's copy of the backward
    workspace size to the library's."""
    for b, (h, w, c) in [(BATCH, s) for s in HQ_BAND_SHAPES] + [(TRAIN_BATCH, LEVEL_SHAPES[0])]:
        for affine in (True, False):
            got = lib.glow_flowstep_bwd_workspace(int(affine), b, h, w, c, 512)
            want = fs.bwd_workspace_bytes(b * h * w, c, 512, affine)
            require(got == want, f"backward workspace {b}x{h}x{w}x{c}: library {got}, chooser {want}")
    gen = torch.Generator().manual_seed(SEED + 30)
    b = BATCH
    for h, w, c in HQ_BAND_SHAPES:
        for mode in ("affine", "additive"):
            affine = mode == "affine"
            step = noisy_step(c, mode, gen, torch)
            z, gzn = (torch.randn(b, h, w, c, generator=gen).cuda() for _ in range(2))
            gld = torch.randn(b, generator=gen).cuda()
            groups = [fs.bands_per_launch(d, b, h, w, c, 512, affine)
                      for d in ("forward", "reverse", "backward")]
            tag = f"{b}x{h}x{w}x{c} {mode} (R={fs.band_rows(h, w)}, G={groups})"
            with torch.no_grad():
                wf = fs.pack_weights(step, affine, reverse=False)
                wr = fs.pack_weights(step, affine, reverse=True)
                zk, ldk = fs._launch_band(wf, z, affine, reverse=False)
                zr, ldr = fs.step_forward_band_ref(wf, z, affine)
                zw, _ = fs._launch(wf, z, affine, reverse=False)
                xk, _ = fs._launch_band(wr, zk, affine, reverse=True)
                xr = fs.step_reverse_band_ref(wr, zk, affine)
                xw, _ = fs._launch(wr, zk, affine, reverse=True)
            torch.cuda.synchronize()
            require(torch.equal(zk, zw) and torch.equal(xk, xw),
                    f"{tag}: band output differs from the whole chain's")
            hold_outputs(torch, tag, "band_forward", zk, zr, results)
            hold_outputs(torch, tag, "band_reverse", xk, xr, results)
            rt_err = float((xk - z).abs().max())
            hold_logdet_and_round_trip(tag, ldk, ldr, rt_err)
            print(f"band kernel {tag}: {describe(torch, zk, zr, ldk, ldr, xk, xr, rt_err)} | "
                  f"bitwise = whole chain")
            del zr, xr, zw, xw
            hold_backward(torch, fs, tag, step, affine, z, gzn, gld, fs._launch_band_backward,
                          "band_backward", results)
            torch.cuda.empty_cache()

            def timed(fn):
                return median_ms(fn, torch, reps=3, inner=2)

            zeros = torch.zeros(b, device=z.device)
            with torch.no_grad():
                times = {
                    "band_forward": (timed(lambda: fs._launch_band(wf, z, affine, False)),
                                     timed(lambda: fs.step_forward_band_ref(wf, z, affine)),
                                     timed(lambda: step(z, zeros))),
                    "band_reverse": (timed(lambda: fs._launch_band(wr, zk, affine, True)),
                                     timed(lambda: fs.step_reverse_band_ref(wr, zk, affine)),
                                     timed(lambda: step.reverse(zk))),
                    "band_backward": (
                        timed(lambda: fs._launch_band_backward(wf, z, gzn, gld, affine)),
                        timed(lambda: fs.step_backward_band_ref(wf, z, gzn, gld, affine))),
                }
            times["band_backward"] += (timed(library_backward(torch, step, z, gzn, gld)),)
            print_times(fs, tag, times, b, h, w, c, affine, results,
                        (h, w, c) == HQ_BAND_SHAPES[0] and not affine)
            del step, z, zk, xk, gzn
            torch.cuda.empty_cache()


def check_serving(torch, fs, card: str, preset: str, want_nll=None, want_sample=None,
                  big_batch: int | None = None) -> dict:
    """A preset's serving path at full width with random weights from a
    seed: init + DDI on a uint8 batch of BATCH images, then an Inferer
    answers nll, a T=0.7 sample and a reconstruct, with the launches each
    request must make (K per level, on the chain `tiling()` picks; with
    `want_*` also those literal counts); reconstruct exact to 2e-4 and
    within one input bin; fused nll against the unfused path within rtol
    2e-2; with `big_batch`, nll of that many images whose first BATCH match
    the BATCH call within rtol 1e-5; times; then, with the zero-convs
    perturbed so every coupling depends on the data, nll against the
    unfused path again.  Returns the launches of nll + sample +
    reconstruct x2."""
    import numpy as np

    from pytorch_glow_tpu_torch import PRESETS, Inferer, init_glow

    cfg = PRESETS[preset].glow
    t0 = time.perf_counter()
    model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
    rng = np.random.default_rng(SEED)
    all_images = torch.from_numpy(
        rng.integers(0, 256, (big_batch or BATCH, *cfg.image_shape), dtype="uint8")).cuda()
    images = all_images[:BATCH]
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    model.ddi_init(model.dequantize(model.preprocess(images), cuda_gen))
    torch.cuda.synchronize()
    print(f"init + DDI ({preset}, K={cfg.K}, L={cfg.L}, hidden {cfg.hidden_channels}, "
          f"{cfg.flow_coupling}, {cfg.n_bits_x}-bit, b={BATCH}): {time.perf_counter() - t0:.2f} s")

    # -- the main path: an Inferer answers nll, sample and reconstruct -------
    nll_launches = expected_launches(fs, cfg, BATCH, ("forward",))
    smp_launches = expected_launches(fs, cfg, BATCH, ("reverse",))
    require(want_nll in (None, nll_launches) and want_sample in (None, smp_launches),
            f"{preset} tiling: nll {nll_launches}, sample {smp_launches}")
    inf = Inferer(model)
    x = model.preprocess(images)
    fs.reset_launches()
    nll = inf.nll(images)
    torch.cuda.synchronize()
    after_nll = dict(fs.launches)
    with torch.no_grad():
        xs = model.sample(BATCH, 0.7, cuda_gen)
        imgs = model.postprocess(xs)
    torch.cuda.synchronize()
    after_sample = dict(fs.launches)
    with torch.no_grad():
        rec = model.reconstruct(x)
    rec_u8 = inf.reconstruct(images)
    torch.cuda.synchronize()
    launches = dict(fs.launches)
    print(f"{preset} launches: after nll {after_nll}, after sample {after_sample}, "
          f"after reconstruct x2 {launches}")
    require(nll.shape == (BATCH,) and bool(torch.isfinite(nll).all()), f"{preset} nll finite, shape")
    require(after_nll == nll_launches, f"{preset} nll launches {after_nll}")
    require(bool(torch.isfinite(xs).all()), f"{preset} sample finite")
    require(imgs.dtype == torch.uint8 and imgs.shape == (BATCH, *cfg.image_shape),
            f"{preset} sample images")
    both = {k: nll_launches[k] + smp_launches[k] for k in nll_launches}
    require(after_sample == both, f"{preset} sample launches {after_sample}")
    require(launches == {k: 3 * v for k, v in both.items()},
            f"{preset} reconstruct launches {launches}")
    rec_err = float((rec - x).abs().max())
    bin_err = int((rec_u8.int() - model.postprocess(x).int()).abs().max())
    in_range = float(((xs >= 0) & (xs <= 1)).float().mean())
    bin_width = int(256 / cfg.n_bins)
    print(f"{preset} nll bits/dim: mean {float(nll.mean()):.6f} min {float(nll.min()):.6f} "
          f"max {float(nll.max()):.6f}")
    print(f"{preset} sample T=0.7: float range [{float(xs.min()):.4f}, {float(xs.max()):.4f}], "
          f"share in [0,1] {in_range:.4f}")
    print(f"{preset} reconstruct: max |x - rec| {rec_err:.3e}, max uint8 diff {bin_err} "
          f"(one input bin is {bin_width})")
    require(rec_err <= 2e-4, f"{preset} reconstruct error {rec_err}")
    require(bin_err <= bin_width, f"{preset} reconstruct uint8 diff {bin_err}")

    plain = init_glow(dataclasses.replace(cfg, flowstep_impl="xla"), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain_inf = Inferer(plain)
    compare_nll(inf, plain_inf, images, f"{preset}, init + DDI")

    if big_batch:
        fs.reset_launches()
        nll_all = inf.nll(all_images)
        torch.cuda.synchronize()
        rel = float(((nll_all[:BATCH] - nll).abs() / nll.abs()).max())
        print(f"{preset} nll b={big_batch}: launches {dict(fs.launches)}; first {BATCH} against "
              f"the b={BATCH} call: max rel diff {rel:.3e}")
        require(bool(torch.isfinite(nll_all).all()) and rel <= 1e-5,
                f"{preset} nll b={big_batch} rel diff {rel}")

    nll_ms = median_ms(lambda: inf.nll(images), torch, reps=3, inner=1)
    nll_plain_ms = median_ms(lambda: plain_inf.nll(images), torch, reps=3, inner=1)
    smp_ms = median_ms(lambda: inf.sample(BATCH, 0.7, cuda_gen), torch, reps=3, inner=1)
    smp_plain_ms = median_ms(lambda: plain_inf.sample(BATCH, 0.7, cuda_gen), torch, reps=3, inner=1)
    torch.cuda.reset_peak_memory_stats()
    inf.nll(images)
    nll_mem = torch.cuda.max_memory_allocated()
    print(f"time {preset} nll b={BATCH}: kernel {nll_ms:.3f} ms ({BATCH * 1e3 / nll_ms:.1f} img/s, "
          f"peak {nll_mem / 2**30:.2f} GiB), plain {nll_plain_ms:.3f} ms "
          f"({BATCH * 1e3 / nll_plain_ms:.1f} img/s)")
    print(f"time {preset} sample b={BATCH} T=0.7: kernel {smp_ms:.3f} ms "
          f"({BATCH * 1e3 / smp_ms:.1f} img/s), plain {smp_plain_ms:.3f} ms "
          f"({BATCH * 1e3 / smp_plain_ms:.1f} img/s)")
    print(f"card for these times: {card}")

    # -- couplings that depend on the data ------------------------------------
    # init + DDI leaves every zero-conv at 0, so f()'s output does not reach
    # z.  Perturbed zero-convs make every coupling data-dependent; kept small,
    # since a random flow with strongly data-dependent scales is unstable in
    # reverse (0.01 sends a T=0.7 sample to NaN on the plain path too).
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".f.4." in name:
                p.add_(0.003 * torch.randn(p.shape, generator=gen).cuda())
    plain.load_state_dict(model.state_dict())
    compare_nll(inf, plain_inf, images, f"{preset}, perturbed zero-convs")
    with torch.no_grad():
        rec = model.reconstruct(x)
    print(f"{preset} perturbed zero-convs: reconstruct max |x - rec| "
          f"{float((rec - x).abs().max()):.3e} (bf16 coupling: not bit-exact once f() depends "
          f"on z1; see PERF.md)")
    require(bool(torch.isfinite(rec).all()), f"{preset} perturbed reconstruct finite")
    del plain, plain_inf, inf, model
    torch.cuda.empty_cache()
    return launches


def decode_png(data: bytes):
    """The 8-bit, filter-0 PNGs `utils/image.encode_png` writes -> (H, W, C)
    uint8 (the card's machine may have no Pillow)."""
    import struct
    import zlib

    import numpy as np

    require(data[:8] == b"\x89PNG\r\n\x1a\n", "PNG signature")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        require(zlib.crc32(kind + body) & 0xFFFFFFFF
                == struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0], f"PNG {kind} CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = header
    c = {0: 1, 2: 3, 6: 4}[ctype]
    require(depth == 8, f"PNG bit depth {depth}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    require(bool((raw[:, 0] == 0).all()), "PNG row filters")
    return raw[:, 1:].reshape(h, w, c)


def cifar_cfg(invconv_impl: str = "pallas"):
    """The cifar10 preset on the unfused flow step, with the 1x1 conv's
    implementation as given."""
    from pytorch_glow_tpu_torch import PRESETS

    return dataclasses.replace(PRESETS["cifar10"].glow, flowstep_impl="xla",
                               invconv_impl=invconv_impl)


def require_narrow(icf, what: str) -> None:
    """Every K6 call since the counts were reset took the narrow path: one
    narrow launch for each public call, no tiled one."""
    paths = icf.path_launches
    print(f"{what}: K6 kernel launches by path {paths}")
    require(all(paths[d] == {"narrow": icf.launches[d], "tiled": 0} for d in paths),
            f"{what}: K6 calls {icf.launches}, launches by path {paths}")


def check_invconv_serving(torch, icf, fs, card: str) -> dict:
    """cifar10 served at full width (K=32, L=3, hidden 512, bf16 coupling)
    on the unfused flow step with invconv_impl="pallas", random weights
    from a seed, b=256: init + DDI (96 K6a calls), then an Inferer answers
    nll (96 K6a), a T=0.7 sample (96 K6b) and a reconstruct (96 + 96,
    exact to 2e-4) with no fused flow-step launch; nll against the same
    model with invconv_impl="xla" within rtol 1e-4 (the JAX bound,
    tests/test_invconv_pallas.py:91-93), again with the zero-convs
    perturbed; nll and sample images/s beside the "xla" model's, and peak
    memory.  Returns the K6 launches of nll + sample + reconstruct."""
    import numpy as np

    from pytorch_glow_tpu_torch import Inferer, init_glow

    cfg = cifar_cfg()
    b, k = CIFAR_BATCH, cfg.K * cfg.L
    t0 = time.perf_counter()
    model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
    images = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (b, *cfg.image_shape), dtype="uint8")).cuda()
    cuda_gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    icf.reset_launches()
    model.ddi_init(model.dequantize(model.preprocess(images), cuda_gen))
    torch.cuda.synchronize()
    ddi = dict(icf.launches)
    print(f"init + DDI (cifar10 unfused, invconv_impl=pallas, K={cfg.K}, L={cfg.L}, hidden "
          f"{cfg.hidden_channels}, b={b}): {time.perf_counter() - t0:.2f} s, K6 launches {ddi}")
    require(ddi == {"invconv_forward": k, "invconv_reverse": 0}, f"cifar10 DDI launches {ddi}")
    require_narrow(icf, "cifar10 DDI")

    # -- the main path: an Inferer answers nll, sample and reconstruct -------
    inf = Inferer(model)
    x = model.preprocess(images)
    fs.reset_launches()
    icf.reset_launches()
    nll = inf.nll(images)
    torch.cuda.synchronize()
    after_nll = dict(icf.launches)
    with torch.no_grad():
        xs = model.sample(b, 0.7, cuda_gen)
    torch.cuda.synchronize()
    after_sample = dict(icf.launches)
    with torch.no_grad():
        rec = model.reconstruct(x)
    torch.cuda.synchronize()
    launches = dict(icf.launches)
    print(f"cifar10 K6 launches: after nll {after_nll}, after sample {after_sample}, after "
          f"reconstruct {launches}; fused flow-step launches {dict(fs.launches)}")
    require(after_nll == {"invconv_forward": k, "invconv_reverse": 0}, f"nll {after_nll}")
    require(after_sample == {"invconv_forward": k, "invconv_reverse": k}, f"sample {after_sample}")
    require(launches == {"invconv_forward": 2 * k, "invconv_reverse": 2 * k},
            f"reconstruct {launches}")
    require_narrow(icf, "cifar10 nll, sample and reconstruct")
    require(not any(fs.launches.values()), f"fused launches on the unfused path {fs.launches}")
    require(nll.shape == (b,) and bool(torch.isfinite(nll).all()), "cifar10 nll finite, shape")
    require(bool(torch.isfinite(xs).all()) and xs.shape == (b, *cfg.image_shape),
            "cifar10 sample finite, shape")
    rec_err = float((rec - x).abs().max())
    print(f"cifar10 nll bits/dim: mean {float(nll.mean()):.6f}; sample T=0.7 range "
          f"[{float(xs.min()):.4f}, {float(xs.max()):.4f}]; reconstruct max |x - rec| "
          f"{rec_err:.3e}")
    require(rec_err <= 2e-4, f"cifar10 reconstruct error {rec_err}")

    plain = init_glow(cifar_cfg("xla"), device="cuda")
    plain.load_state_dict(model.state_dict())
    plain_inf = Inferer(plain)

    def compare(what: str) -> None:
        got, want = inf.nll(images), plain_inf.nll(images)
        rel = float(((got - want).abs() / want.abs()).max())
        print(f"cifar10 nll, invconv_impl pallas vs xla ({what}): max rel diff {rel:.3e}")
        require(rel <= 1e-4, f"cifar10 nll pallas vs xla rel diff {rel} ({what})")

    compare("init + DDI")
    nll_ms = median_ms(lambda: inf.nll(images), torch, reps=3, inner=1)
    nll_plain_ms = median_ms(lambda: plain_inf.nll(images), torch, reps=3, inner=1)
    smp_ms = median_ms(lambda: inf.sample(b, 0.7, cuda_gen), torch, reps=3, inner=1)
    smp_plain_ms = median_ms(lambda: plain_inf.sample(b, 0.7, cuda_gen), torch, reps=3, inner=1)
    torch.cuda.reset_peak_memory_stats()
    inf.nll(images)
    nll_mem = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    inf.sample(b, 0.7, cuda_gen)
    smp_mem = torch.cuda.max_memory_allocated()
    print(f"time cifar10 nll b={b}: invconv kernels {nll_ms:.3f} ms ({b * 1e3 / nll_ms:.1f} "
          f"img/s, peak {nll_mem / 2**30:.2f} GiB), invconv xla {nll_plain_ms:.3f} ms "
          f"({b * 1e3 / nll_plain_ms:.1f} img/s)")
    print(f"time cifar10 sample b={b} T=0.7: invconv kernels {smp_ms:.3f} ms "
          f"({b * 1e3 / smp_ms:.1f} img/s, peak {smp_mem / 2**30:.2f} GiB), invconv xla "
          f"{smp_plain_ms:.3f} ms ({b * 1e3 / smp_plain_ms:.1f} img/s)")
    print(f"card for these times: {card}")

    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".f.4." in name:
                p.add_(0.003 * torch.randn(p.shape, generator=gen).cuda())
    plain.load_state_dict(model.state_dict())
    compare("perturbed zero-convs")
    del model, plain, inf, plain_inf
    torch.cuda.empty_cache()
    return launches


def check_invconv_ddi(torch, icf, card: str) -> None:
    """celeba64 (the fused preset) DDI'd with invconv_impl="pallas": K*L = 128
    K6a calls, and its post-DDI tensors against the "xla" DDI from the same
    init and batch, each element within rtol 1e-3 with an absolute 1e-5
    beside it (DDI leaves every actnorm output at zero mean, so all but each
    level's first step's actnorm biases are f32 rounding noise near 0, where
    a relative bound means nothing; the activations they shift have unit
    scale).  At init the coupling nets add nothing to the flow, so the flow
    itself stays f32 under either coupling dtype; but at the preset's bf16
    coupling the nets apply their own DDI'd actnorms (f.0, f.2) rounded to
    bf16, so an f32 last-bit difference in a bias flips its rounding and
    shifts every later mean in that net.  There those actnorms are held to
    bf16 resolution on their unit-scale output: |d bias| * exp(logs) and
    |d logs| within 2^-8.  At f32 coupling every tensor takes the rtol."""
    import numpy as np

    from pytorch_glow_tpu_torch import PRESETS, init_glow

    base = PRESETS["celeba64"].glow
    images = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (BATCH, *base.image_shape), dtype="uint8")).cuda()
    for dtype in (base.compute_dtype, "float32"):
        states = {}
        for impl in ("pallas", "xla"):
            cfg = dataclasses.replace(base, invconv_impl=impl, compute_dtype=dtype)
            model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
            noise = torch.Generator(device="cuda").manual_seed(SEED + 2)
            icf.reset_launches()
            model.ddi_init(model.dequantize(model.preprocess(images), noise))
            torch.cuda.synchronize()
            want = cfg.K * cfg.L if impl == "pallas" else 0
            require(icf.launches == {"invconv_forward": want, "invconv_reverse": 0},
                    f"celeba64 DDI ({dtype}, {impl}) launches {icf.launches}")
            # Levels 0-2 (C = 12, 24, 48) on the narrow path, one kernel a
            # call; level 3 (96) on the tiled pair, two.
            paths = icf.path_launches["invconv_forward"]
            require(paths == {"narrow": want // cfg.L * 3, "tiled": 2 * (want // cfg.L)},
                    f"celeba64 DDI ({dtype}, {impl}) K6a launches by path {paths}")
            states[impl] = model.state_dict()
            del model
        print(f"celeba64 DDI ({dtype} coupling; {cfg.K * cfg.L} K6a launches), post-DDI "
              f"tensors, pallas vs xla:")
        hold_ddi(states["pallas"], states["xla"], dtype == "bfloat16",
                 f"celeba64 DDI ({dtype}) pallas vs xla")
    torch.cuda.empty_cache()


def hold_ddi(got: dict, want_sd: dict, bf16: bool, what: str) -> None:
    """Phase 14's rule for two DDI'd state dicts (`check_invconv_ddi`): each
    element within rtol 1e-3 with an absolute 1e-5, except, at bf16
    coupling, the coupling nets' actnorms, held to bf16 resolution on their
    unit-scale output (|d bias| * exp(logs) and |d logs| within 2^-8)."""
    rows = {"rtol": [], "bf16": []}
    for name, want in want_sd.items():
        if not want.is_floating_point():
            continue
        err = (got[name] - want).abs()
        if bf16 and ".f." in name and ".actnorm." in name:
            if name.endswith(".bias"):
                err = err * want_sd[name.removesuffix("bias") + "logs"].exp()
            rows["bf16"].append((float(err.max()) / 2.0 ** -8, float(err.max()), name))
        else:
            rows["rtol"].append((float((err / (1e-3 * want.abs() + 1e-5)).max()),
                                 float(err.max()), name))
    for rule, text in (("rtol", "each element within 1e-3 |ref| + 1e-5"),
                       ("bf16", "the nets' actnorms within 2^-8 on their output")):
        if rows[rule]:
            worst, largest = max(rows[rule]), max(rows[rule], key=lambda r: r[1])
            print(f"  {len(rows[rule])} tensors, {text}: worst {worst[0]:.3e} of the bound "
                  f"({worst[2]}); largest |diff| {largest[1]:.3e} ({largest[2]})")
            require(worst[0] <= 1.0, f"{what}: {worst}")


def check_fused_permutations(torch, fs) -> None:
    """The plain 1x1 conv and the fixed shuffle / reverse on the fused flow
    step: for each, a K=4 celeba64 model (init + DDI, zero-convs perturbed)
    whose fused nll is within rtol 2e-2 of its unfused nll (the repo's
    fused-vs-unfused bound), with K*L forward launches."""
    import numpy as np

    from pytorch_glow_tpu_torch import PRESETS, Inferer, init_glow

    base = dataclasses.replace(PRESETS["celeba64"].glow, K=4)
    images = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, 256, (BATCH, *base.image_shape), dtype="uint8")).cuda()
    for mode, lu in (("invconv", False), ("shuffle", True), ("reverse", True)):
        cfg = dataclasses.replace(base, flow_permutation=mode, lu_decomposed=lu)
        model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
        noise = torch.Generator(device="cuda").manual_seed(SEED + 2)
        model.ddi_init(model.dequantize(model.preprocess(images), noise))
        gen = torch.Generator().manual_seed(SEED + 1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".f.4." in name:
                    p.add_(0.003 * torch.randn(p.shape, generator=gen).cuda())
        plain = init_glow(dataclasses.replace(cfg, flowstep_impl="xla"), device="cuda")
        plain.load_state_dict(model.state_dict())
        fs.reset_launches()
        nll = Inferer(model).nll(images)
        torch.cuda.synchronize()
        fused_launches = fs.launches["forward"]
        nll_plain = Inferer(plain).nll(images)
        rel = float(((nll - nll_plain).abs() / nll_plain.abs()).max())
        kind = "plain 1x1 conv" if mode == "invconv" else mode
        print(f"fused path, {kind} permutation (celeba64, K=4): nll fused vs unfused max rel "
              f"diff {rel:.3e}, mean {float(nll.mean()):.6f}; {fused_launches} forward launches")
        require(fused_launches == cfg.K * cfg.L, f"{kind}: fused launches {fused_launches}")
        require(bool(torch.isfinite(nll).all()) and rel <= 2e-2, f"{kind}: nll rel diff {rel}")
        del model, plain
    torch.cuda.empty_cache()


def run_cli(main, argv: list[str]):
    """One in-process CLI call -> (its return value, its standard output)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    print("\n".join(f"  | {line}" for line in out.getvalue().strip().splitlines()))
    return result, out.getvalue()


def check_invconv_training(torch, icf, card: str, out_root: str,
                           profiling: bool = False) -> dict:
    """cifar10 trained at full width (b=256) through the train CLI,
    in-process (so the TF32 and determinism pins hold), on the unfused
    flow step with invconv_impl="pallas" and synthetic textured data: 10
    steps with a snapshot every 5 (DDI's 96 K6a calls, then 96 per step),
    a second call to 15 that resumes from step 10 (96 per step, no DDI),
    and its step-15 loss against an uninterrupted 15-step run within rtol
    1e-5.  Then one `loss_fn` at f32 coupling with invconv_impl "pallas"
    against "xla": every parameter's grad within relative l2 1e-4, or twice
    the plain path's own worst distance with its mix in f64 where that is
    larger (a last-bit move of the mix flips ReLUs downstream); three
    steps from one state at the preset's bf16 on both, grad_norm and loss
    within rtol 2e-2; step time, images/s and peak memory.  Then the infer
    CLI on the snapshot: nll, `sample -n 16` (a PNG that decodes to the
    grid of the same samples drawn again) and recon, with their K6
    launches, and `--exact` with none.  Returns the K6 launches of the
    first train call."""
    import numpy as np

    from pytorch_glow_tpu_torch import Inferer, build, init_glow
    from pytorch_glow_tpu_torch.cli import infer as infer_cli
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.ops import invconv as ic
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.utils.image import make_grid

    sets = ["--set", "glow.flowstep_impl=xla", "--set", "glow.invconv_impl=pallas"]
    common = ["cifar10", "--synthetic", "textured", "--quiet", *sets]
    run_dir, straight_dir = os.path.join(out_root, "run"), os.path.join(out_root, "straight")
    cfg = cifar_cfg()
    k = cfg.K * cfg.L

    # -- the main path: the train CLI, 10 steps, snapshots every 5 ---------
    icf.reset_launches()
    t0 = time.perf_counter()
    first, _ = run_cli(train_cli.main, [*common, "--out-dir", run_dir, "--steps", "10",
                                        "--set", "train.checkpoint_gap=5"])
    torch.cuda.synchronize()
    launches = dict(icf.launches)
    print(f"train CLI cifar10 (unfused, invconv_impl=pallas, b={CIFAR_BATCH}), 10 steps: "
          f"{time.perf_counter() - t0:.2f} s, K6 launches {launches}")
    snaps = sorted(os.listdir(os.path.join(run_dir, "cifar10", "checkpoints")))
    require(first["final_step"] == 10 and math.isfinite(first["loss"]), f"train {first}")
    require(launches == {"invconv_forward": k + 10 * k, "invconv_reverse": 0},
            f"train launches {launches}")
    require_narrow(icf, "train CLI cifar10")
    require(snaps == ["10.pt", "5.pt"], f"snapshots {snaps}")

    icf.reset_launches()
    resumed, text = run_cli(train_cli.main, [*common, "--out-dir", run_dir, "--steps", "15",
                                             "--set", "train.checkpoint_gap=5"])
    torch.cuda.synchronize()
    require("resumed from step 10" in text, "the second call did not resume")
    require(icf.launches["invconv_forward"] == 5 * k, f"resumed launches {icf.launches}")
    require_narrow(icf, "train CLI cifar10, resumed")
    straight, _ = run_cli(train_cli.main, [*common, "--out-dir", straight_dir, "--steps", "15",
                                           "--set", "train.checkpoint_gap=5"])
    rel = abs(resumed["loss"] - straight["loss"]) / abs(straight["loss"])
    print(f"step-15 loss: resumed {resumed['loss']:.7f}, uninterrupted {straight['loss']:.7f} "
          f"(rel {rel:.2e})")
    require(resumed["final_step"] == 15 and rel <= 1e-5, f"resume: {resumed} vs {straight}")

    # -- grads: pallas vs xla at f32 coupling --------------------------------
    built = build(train_cli.resolve_profile(train_cli.parse_args(
        [*common, "--out-dir", run_dir, "--set", "train.checkpoint_gap=5"])))
    require(built.resumed and built.start_step == 15, "build did not restore step 15")
    model, t = built.state["model"], built.profile.train
    x = model.preprocess(next(built.data)["image"])

    def param_grads(impl: str):
        m = init_glow(dataclasses.replace(cifar_cfg(impl), compute_dtype="float32"))
        m.load_state_dict(model.state_dict())
        params = list(m.parameters())
        loss, _ = m.loss_fn(x, torch.Generator(device="cuda").manual_seed(SEED))
        got = torch.autograd.grad(loss, params, allow_unused=True)
        return [g if g is not None else torch.zeros_like(p) for g, p in zip(got, params)]

    def distance(got, want):
        """-> (the three worst (relative l2, name) over the tensors, the
        relative l2 of all grads as one vector)."""
        rows = sorted(((rel_l2(g, w), n) for (n, _), g, w in
                       zip(model.named_parameters(), got, want)), reverse=True)
        whole = rel_l2(torch.cat([g.flatten() for g in got]),
                       torch.cat([w.flatten() for w in want]))
        return rows[:3], whole

    icf.reset_launches()
    got = param_grads("pallas")
    require(icf.launches["invconv_forward"] == k, f"loss_fn launches {icf.launches}")
    require_narrow(icf, "loss_fn cifar10")
    want = param_grads("xla")
    # The floor: the plain path against itself with its 1x1 mix (forward and
    # backward) in f64, i.e. the same function summed in another order; a
    # last-bit move of the mix flips ReLUs in the coupling nets downstream.
    mix = ic.mix_channels
    ic.mix_channels = lambda a, w: (a.double() @ w.double().T).float()
    try:
        f64 = param_grads("xla")
    finally:
        ic.mix_channels = mix
    (worst, *_), whole = got_d = distance(got, want)
    (floor, *_), floor_whole = floor_d = distance(f64, want)
    bound = max(1e-4, 2.0 * floor[0])
    for what, (rows, all_l2) in (("invconv pallas vs xla", got_d),
                                 ("the plain path with an f64 mix vs xla", floor_d)):
        print(f"parameter grads at f32 coupling, one loss_fn, {what}: {len(want)} tensors, "
              f"all as one vector relative l2 {all_l2:.3e}; worst tensors "
              + ", ".join(f"{d:.3e} ({n})" for d, n in rows))
    print(f"bound on the worst tensor: {bound:.3e}")
    require(worst[0] <= bound and all(bool(torch.isfinite(g).all()) for g in got),
            f"grads pallas vs xla: {worst}, floor {floor}")
    del got, want, f64

    # -- three steps from one state at bf16: pallas vs xla -------------------
    plain = init_glow(cifar_cfg("xla"))
    plain.load_state_dict(model.state_dict())
    step_p = steplib.make_train_step(cifar_cfg(), built.tx, t.ema_decay, built.schedule)
    step_x = steplib.make_train_step(cifar_cfg("xla"), built.tx, t.ema_decay, built.schedule)
    state_p, state_x = built.state, clone_state(built.state, plain)
    for _ in range(3):
        batch = next(built.data)["image"]
        state_p, mp = step_p(state_p, batch)
        state_x, mx = step_x(state_x, batch)
        lp, lx = float(mp["loss"]), float(mx["loss"])
        gp, gx = float(mp["grad_norm"]), float(mx["grad_norm"])
        print(f"train step {state_p['step']}: loss pallas {lp:.6f} xla {lx:.6f}, grad_norm "
              f"{gp:.6f} vs {gx:.6f} (rel {abs(gp - gx) / abs(gx):.2e})")
        require(math.isfinite(gp) and abs(gp - gx) <= 2e-2 * abs(gx), f"grad_norm {gp} vs {gx}")
    require(abs(lp - lx) <= 2e-2 * abs(lx), f"loss after 3 steps {lp} vs {lx}")
    batches = [next(built.data)["image"] for _ in range(4)]
    del state_x
    # Three rounds in turns: this step is host-bound, and the host's speed
    # drifts within a call by more than the two paths differ.  The peak
    # memory of each is its first round's, where no other copy of a train
    # state is kept.
    ms, mem_p = train_step_ms(step_p, state_p, batches, torch)
    rounds = {"kernels": [ms], "xla": []}
    ms, mem_x = train_step_ms(step_x, clone_state(state_p, plain), batches, torch)
    rounds["xla"].append(ms)
    state_x = clone_state(state_p, plain)
    for _ in range(2):
        rounds["kernels"].append(train_step_ms(step_p, state_p, batches, torch)[0])
        rounds["xla"].append(train_step_ms(step_x, state_x, batches, torch)[0])
    del state_x
    ms_p, ms_x = (statistics.median(rounds[k]) for k in ("kernels", "xla"))
    b = CIFAR_BATCH
    print("train step cifar10 rounds (ms): " + "; ".join(
        f"invconv {k} " + ", ".join(f"{t:.3f}" for t in v) for k, v in rounds.items()))
    print(f"time train step cifar10 unfused b={b}: invconv kernels {ms_p:.3f} ms "
          f"({b * 1e3 / ms_p:.1f} img/s, peak {mem_p / 2**30:.2f} GiB), invconv xla "
          f"{ms_x:.3f} ms ({b * 1e3 / ms_x:.1f} img/s, peak {mem_x / 2**30:.2f} GiB)")
    print(f"card for these times: {card}")
    if profiling:
        profile_step(step_p, state_p, batches[0], torch, "cifar10 unfused, invconv kernels")
        profile_step(step_x, clone_state(state_p, plain), batches[0], torch,
                     "cifar10 unfused, invconv xla")
    del built, model, plain, state_p
    torch.cuda.empty_cache()

    # -- the infer CLI on the step-15 snapshot ---------------------------------
    infer = ["cifar10", "--synthetic", "textured", "--out-dir", run_dir, *sets]
    icf.reset_launches()
    _, text = run_cli(infer_cli.main, ["nll", *infer, "--batches", "2"])
    torch.cuda.synchronize()
    nll = float(text.split("nll: ")[1].split()[0])
    require(math.isfinite(nll) and icf.launches == {"invconv_forward": 2 * k,
                                                     "invconv_reverse": 0},
            f"infer nll {nll}, launches {icf.launches}")
    require_narrow(icf, "infer CLI nll")
    png = os.path.join(out_root, "samples.png")
    icf.reset_launches()
    run_cli(infer_cli.main, ["sample", *infer, "-n", "16", "-o", png])
    require(icf.launches == {"invconv_forward": 0, "invconv_reverse": k},
            f"infer sample launches {icf.launches}")
    require_narrow(icf, "infer CLI sample")
    with open(png, "rb") as f:
        grid = decode_png(f.read())
    snapshot = torch.load(os.path.join(run_dir, "cifar10", "checkpoints", "15.pt"),
                          map_location="cuda", weights_only=True)
    again = init_glow(cifar_cfg())
    again.load_state_dict(snapshot["model"])
    redraw = make_grid(Inferer(again).sample(
        16, 0.7, torch.Generator(device="cuda").manual_seed(0)).cpu().numpy())
    diff = int(np.abs(grid.astype(np.int16) - redraw.astype(np.int16)).max())
    print(f"infer sample -n 16: PNG {grid.shape}, against the same samples drawn again: max "
          f"uint8 diff {diff}")
    h, w, c = cfg.image_shape
    require(grid.shape == redraw.shape == (4 * (h + 2) + 2, 4 * (w + 2) + 2, c) and diff == 0,
            f"sample PNG {grid.shape} diff {diff}")
    icf.reset_launches()
    _, text = run_cli(infer_cli.main, ["recon", *infer, "-n", "16",
                                       "-o", os.path.join(out_root, "recon.png")])
    require(icf.launches == {"invconv_forward": k, "invconv_reverse": k},
            f"infer recon launches {icf.launches}")
    require_narrow(icf, "infer CLI recon")
    require(float(text.split("max |x - rec| = ")[1].split()[0]) <= 1, "recon error")
    icf.reset_launches()
    _, text = run_cli(infer_cli.main, ["nll", *infer, "--batches", "2", "--exact"])
    exact = float(text.split("nll: ")[1].split()[0])
    print(f"infer nll on the step-15 snapshot: {nll:.4f} bits/dim (bf16 coupling, K6), "
          f"--exact {exact:.4f} (f32, no K6: launches {dict(icf.launches)})")
    require(not any(icf.launches.values()), f"--exact launched K6: {icf.launches}")
    require(abs(exact - nll) <= 2e-2 * abs(exact), f"--exact nll {exact} vs {nll}")
    check_preemption_and_retries(run_dir, common)
    return launches


def check_preemption_and_retries(run_dir: str, common: list[str]) -> None:
    """On the cifar10 CLI run (at step 15): a `threading.Timer` sends SIGTERM
    to this process PREEMPT_AFTER_S into a call to 30, which must return
    `preempted: true` with its snapshot on disk, and a rerun must resume
    from it to step 30.  Then `--retries 1` with a `train` that fails once
    after a call to 35: the run finishes at 40 from the step-35 snapshot."""
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.train import trainer as trainer_mod
    from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager

    args = [*common, "--out-dir", run_dir, "--set", "train.checkpoint_gap=5"]
    real_train = trainer_mod.train
    stray = []
    timers = []

    def train_then_sigterm(built, **kw):
        timer = threading.Timer(PREEMPT_AFTER_S, os.kill, (os.getpid(), signal.SIGTERM))
        timers.append(timer)
        timer.start()
        return real_train(built, **kw)

    # A SIGTERM outside the train loop lands here instead of ending the script.
    prev = signal.signal(signal.SIGTERM, lambda signum, frame: stray.append(signum))
    trainer_mod.train = train_then_sigterm
    t0 = time.perf_counter()
    try:
        stopped, _ = run_cli(train_cli.main, [*args, "--steps", "30"])
    finally:
        trainer_mod.train = real_train
        for timer in timers:
            timer.cancel()
            timer.join()
        signal.signal(signal.SIGTERM, prev)
    step = stopped["final_step"]
    ckpt = CheckpointManager(os.path.join(run_dir, "cifar10", "checkpoints"))
    print(f"SIGTERM {PREEMPT_AFTER_S} s into a train call to 30 (from 15): stopped at {step} "
          f"after {time.perf_counter() - t0:.2f} s, preempted {stopped.get('preempted')}, "
          f"snapshots {ckpt.steps()}")
    require(not stray and stopped.get("preempted") is True and 15 < step < 30
            and ckpt.latest_step() == step, f"preemption: {stopped}, stray {stray}")
    resumed, text = run_cli(train_cli.main, [*args, "--steps", "30"])
    require(f"resumed from step {step}" in text and resumed["final_step"] == 30
            and "preempted" not in resumed, f"rerun after preemption: {resumed}")

    def fails_once(built, num_steps=None, quiet=False):
        calls.append(built.start_step)
        if len(calls) == 1:
            real_train(built, num_steps=built.start_step + 5, quiet=quiet)
            raise RuntimeError("injected failure")
        return real_train(built, num_steps=num_steps, quiet=quiet)

    calls: list[int] = []
    trainer_mod.train = fails_once
    try:
        retried, text = run_cli(train_cli.main, [*args, "--steps", "40", "--retries", "1"])
    finally:
        trainer_mod.train = real_train
    print(f"--retries 1 with one injected failure: attempts from steps {calls}, "
          f"final step {retried['final_step']}")
    require(calls == [30, 35] and "resumed from step 35" in text
            and retried["final_step"] == 40, f"--retries: {calls}, {retried}")


def check_true_f32(torch, card: str) -> None:
    """Section 0's pin: one cifar10 log_prob at f32 coupling on the unfused
    path (invconv_impl="xla", so the 1x1 mix is a cuBLAS product), with
    the zero-convs perturbed, is bitwise equal with PyTorch's TF32 defaults
    switched on (cuDNN and matmul) to the same call under this script's
    pins.  Beside it, a bare f32 conv at a coupling-net shape under both
    settings, to show TF32 is live on this card.  The pins come back."""
    import torch.nn.functional as F

    from pytorch_glow_tpu_torch import init_glow

    cfg = dataclasses.replace(cifar_cfg("xla"), compute_dtype="float32")
    model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = torch.randint(0, 256, (64, *cfg.image_shape), generator=gen, device="cuda",
                           dtype=torch.uint8)
    x = model.preprocess(images)
    model.ddi_init(model.dequantize(x, gen))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".f.4." in name or ".conv." in name or name.startswith("learn_top"):
                p.add_(0.003 * torch.randn(p.shape, generator=gen, device="cuda"))
        pinned = model.log_prob(x)
        a = torch.randn(64, 512, 16, 16, generator=gen, device="cuda")
        w = torch.randn(512, 512, 3, 3, generator=gen, device="cuda") / 48
        conv_pinned = F.conv2d(a, w, padding=1)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            loose = model.log_prob(x)
            conv_loose = F.conv2d(a, w, padding=1)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    same_nll = torch.equal(pinned["nll"], loose["nll"]) and torch.equal(pinned["z"], loose["z"])
    tf32_diff = float((conv_pinned - conv_loose).abs().max())
    print(f"true f32 (cifar10 log_prob, f32 coupling, unfused, b=64): with TF32 allowed "
          f"bitwise equal to the pinned call: {same_nll} (mean nll "
          f"{float(pinned['nll'].mean()):.6f}); a bare f32 conv 64x512x16x16 3x3 moves by "
          f"{tf32_diff:.3e} under TF32; card: {card}")
    require(same_nll, "log_prob at f32 changed with TF32 allowed")
    require(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
            "pins not restored")
    del model
    torch.cuda.empty_cache()


def same(torch, a, b) -> bool:
    """Bitwise equality of two tensors or of nested tuples / lists of them."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(same(torch, x, y) for x, y in zip(a, b))


def check_anatomy(torch, fs, results: dict) -> dict:
    """Phase 16: the anatomy variants against their plain versions and K2,
    then the three anatomy mains (the anatomy path), each timed variant's
    output held against its plain version on the scripts' operands;
    returns the launches of that path."""
    from pytorch_glow_tpu_torch.ops import anatomy as an
    from pytorch_glow_tpu_torch.scripts import perf_bwd_anatomy, perf_kernel_anatomy
    from pytorch_glow_tpu_torch.scripts import perf_reverse_anatomy

    variants = {"forward": an.FORWARD, "reverse": an.REVERSE, "backward": an.BACKWARD}
    launch = {"forward": an.forward_variant, "reverse": an.reverse_variant,
              "backward": an.backward_variant}
    plain = {"forward": an.forward_variant_ref, "reverse": an.reverse_variant_ref,
             "backward": an.backward_variant_ref}

    def hold(tag: str, d: str, v: str, got, want, full) -> None:
        """A variant's outputs against its plain version's at K1/K2/K3's
        bounds (`hold_outputs`, the logdet bound, `hold_gz`, each weight
        grad within 5e-2 of its plain version's largest magnitude), what it
        drops exactly 0; (b) a correct-math reverse variant within 2e-5 of
        `full`, the production K2."""
        name = f"anatomy_{d}"
        if d == "backward":
            (gz, grads), (rz, rgrads) = got, want
            hold_gz(torch, tag, name, gz, rz, results)
            *_, rowsum, wgrad = an.BACKWARD[v]
            zero = (set(range(fs.N_WEIGHTS)) if not wgrad
                    else set(an.ROWSUM_GRADS) if not rowsum else set())
            rel = 0.0
            for i, (g, r) in enumerate(zip(grads, rgrads)):
                if i in zero:
                    require(not g.any() and not r.any(), f"{tag} backward {v}: grad {i} is not 0")
                    continue
                gmax = float((g - r).abs().max())
                require(bool(torch.isfinite(g).all()) and gmax <= 5e-2 * float(r.abs().max()),
                        f"{tag} backward {v}: weight grad {i} max |diff| {gmax}")
                rel = max(rel, gmax / max(float(r.abs().max()), 1e-30))
            print(f"anatomy backward {v} {tag}: g_z max {float((gz - rz).abs().max()):.3e}, "
                  f"weight grads max rel {rel:.2e}")
            return
        if d == "forward":
            (out, ld), (ref, ldr) = got, want
            if v == "no_logdet":
                require(not bool(ld.any()), f"{tag} forward no_logdet: logdet {ld}")
            else:
                require(bool(((ld - ldr).abs() <= 2e-1 + 2e-2 * ldr.abs()).all()),
                        f"{tag} forward {v}: logdet |diff| {float((ld - ldr).abs().max())}")
            text = f", logdet max {float((ld - ldr).abs().max()):.3e}"
        else:
            out, ref = got, want
            full_err = float((out - full).abs().max())
            text = f", against K2 {full_err:.3e}"
            if v in ("recip_exp", "split_mix"):
                require(full_err <= 2e-5, f"{tag} reverse {v} against K2: {full_err} (bound 2e-5)")
        hold_outputs(torch, f"{tag} {v}", name, out, ref, results)
        print(f"anatomy {d} {v} {tag}: max {float((out - ref).abs().max()):.3e}{text}")

    # -- (a) every variant against its plain version, at the anatomy path's
    # shape with a flow step far from the identity; each launch allocates
    # its own outputs --------------------------------------------------------
    gen = torch.Generator().manual_seed(SEED + 50)
    b, (h, w, c) = TRAIN_BATCH, LEVEL_SHAPES[0]
    step = noisy_step(c, "affine", gen, torch)
    z, gzn = (torch.randn(b, h, w, c, generator=gen).cuda() for _ in range(2))
    gld = torch.randn(b, generator=gen).cuda()
    patches = an.staged_patches(b, h, w, c, gen)
    tag = f"{b}x{h}x{w}x{c} affine"
    with torch.no_grad():
        wf = fs.pack_weights(step, True, reverse=False)
        wr = fs.pack_weights(step, True, reverse=True)
        operands = {"forward": {"weights": wf, "z": z, "patches": patches},
                    "reverse": {"weights": wr, "z": z, "patches": patches},
                    "backward": {"weights": wf, "z": z, "g_zn": gzn, "g_ld": gld,
                                 "patches": patches}}
        production = {"forward": fs.step_forward(wf, z, True),
                      "reverse": fs.step_reverse(wr, z, True),
                      "backward": fs.step_backward(wf, z, gzn, gld, True)}
        for d, table in variants.items():
            for v in table:
                got, again = (launch[d](v, **operands[d]) for _ in range(2))
                want = plain[d](v, **operands[d])
                torch.cuda.synchronize()
                require(same(torch, got, again), f"{tag} {d} {v}: a second launch differs")
                hold(tag, d, v, got, want, production[d])
                if v == "full":
                    require(same(torch, got, production[d]),
                            f"anatomy {d} full is not the production kernel")
        del got, again, want, production

    # -- (c) the anatomy path: the three scripts' mains, b=128 --------------
    tb = TRAIN_BATCH
    an.reset_launches()
    tables = {"forward": perf_kernel_anatomy.main(tb, *ANATOMY_N["forward"]),
              "reverse": perf_reverse_anatomy.main(tb, *ANATOMY_N["reverse"]),
              "backward": perf_bwd_anatomy.main(tb, *ANATOMY_N["backward"])}
    launches = dict(an.launches)
    print(f"anatomy-path launches: {launches}")
    # Each timed variant's output (one more launch into the timing loop's
    # buffers) against its plain version on the scripts' operands, and
    # bitwise against a launch with buffers of its own.
    tag = f"{tb}x{h}x{w}x{c} scripts' operands"
    with torch.no_grad():
        for d, table in tables.items():
            ops = table["operands"]
            for v, got in table["outputs"].items():
                want = plain[d](v, **ops)
                require(same(torch, got, launch[d](v, **ops)),
                        f"{tag} {d} {v}: the timing loop's output differs from a launch of its own")
                hold(tag, d, v, got, want, table["outputs"]["full"])
            del table["outputs"], table["operands"]

    # -- full's plain version and library yardstick at b=128 ---------------
    step = noisy_step(c, "affine", gen, torch)
    z, gzn = (torch.randn(tb, h, w, c, generator=gen).cuda() for _ in range(2))
    gld = torch.ones(tb, device="cuda")
    zeros = torch.zeros(tb, device="cuda")
    with torch.no_grad():
        wf = fs.pack_weights(step, True, reverse=False)
        wr = fs.pack_weights(step, True, reverse=True)
        times = {"forward": (median_ms(lambda: an.forward_variant_ref("full", wf, z), torch),
                             median_ms(lambda: step(z, zeros), torch)),
                 "reverse": (median_ms(lambda: an.reverse_variant_ref("full", wr, z), torch),
                             median_ms(lambda: step.reverse(z), torch)),
                 "backward": (median_ms(lambda: an.backward_variant_ref("full", wf, z, gzn, gld),
                                        torch),)}
    times["backward"] += (median_ms(library_backward(torch, step, z, gzn, gld), torch),)
    for d, table in tables.items():
        bound, by = fs.bound_ms(d, tb, h, w, c, 512, True)
        full = table["rows"][0]
        results["anatomy_" + d].update(ms=full["ms"], plain_ms=times[d][0],
                                       library_ms=times[d][1], bound_ms=bound, bound_by=by)
        print(f"time anatomy {d} full {tb}x{h}x{w}x{c}: kernel {full['ms']:.4f} ms (two-N), "
              f"plain {times[d][0]:.4f} ms, library {times[d][1]:.4f} ms, bound {bound:.4f} ms "
              f"({by})")
    return launches


# ---------------------------------------------------------------------------
# Phase 19: the data layer
# ---------------------------------------------------------------------------


def crop_resize_plain(img, size: int, antialias: bool):
    """The plain version of a folder decoder's centre crop and bilinear
    resize, in numpy: half-pixel centres with no antialias (the native
    decoder), or Pillow's BILINEAR, a triangle filter widened by the
    downscale factor, horizontal pass first, each pass rounded to uint8."""
    import numpy as np

    h, w, _ = img.shape
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    crop = img[y0:y0 + s, x0:x0 + s].astype(np.float64)
    scale = s / size
    weights = np.zeros((size, s))
    for o in range(size):
        if antialias:
            width = max(scale, 1.0)
            center = (o + 0.5) * scale
            lo, hi = max(int(center - width + 0.5), 0), min(int(center + width + 0.5), s)
            x = np.arange(lo, hi)
            k = np.maximum(0.0, 1.0 - np.abs((x - center + 0.5) / width))
            weights[o, lo:hi] = k / k.sum()
        else:
            f = (o + 0.5) * scale - 0.5
            i = int(np.floor(f))
            weights[o, min(max(i, 0), s - 1)] += 1 - (f - i)
            weights[o, min(max(i + 1, 0), s - 1)] += f - i
    rows = np.einsum("ox,yxc->yoc", weights, crop)
    if antialias:
        rows = np.clip(np.round(rows), 0, 255)
    out = np.einsum("oy,yxc->oxc", weights, rows)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


class DirectBatches:
    """The host stream handed to the trainer on the launch thread, each
    batch copied to the card as it is asked for: the trainer's input
    without the prefetcher."""

    def __init__(self, host, torch):
        self.host, self.torch = host, torch

    def __next__(self):
        return {k: self.torch.from_numpy(v).cuda() for k, v in next(self.host).items()}

    def get_state(self):
        return self.host.get_state()

    def close(self):
        pass


def same_params(torch, a: dict, b: dict) -> tuple[int, float]:
    """(tensors that differ, their largest |diff|) between two state dicts."""
    diff = [float((a[k].float() - b[k].float()).abs().max())
            for k in a if not torch.equal(a[k], b[k])]
    return len(diff), max(diff, default=0.0)


def median_step(run: str, batch: int, gap: int) -> float:
    from pytorch_glow_tpu_torch.scripts.run_summary import summarize_run

    with open(os.path.join(run, "metrics.csv")) as f:
        return summarize_run(list(csv.DictReader(f)), batch, gap)["median_step_ms"]


def check_data(torch, fs, card: str, out_root: str) -> None:
    """Phase 19: the data layer.  (a) A full-size CIFAR-10 pickle set
    (textured images from a seed) trains the cifar10 preset at full width
    (K=32, L=3, hidden 512, b=256, fused, bf16 coupling) through the train
    CLI for 20 steps with an eval at 10 and 20; the same 20 steps fed on
    the launch thread with no prefetcher end with bitwise-equal
    parameters, as does a run stopped at step 10 with a full prefetch queue
    and resumed.  (b) 50 batches through the prefetcher to the card, the
    consumer's stream sleeping and allocating between them: each device
    batch, read before and after the sleep, equal to its host batch.  (c)
    A CelebA folder of 178x218 PNGs: the decoder's first train batch within
    1 of its plain version, and celeba64 (b=128) trained 10 steps through
    the train CLI with "attr" (128, 40) in its device batches.  (d) The host
    ms of a batch of each source, the cifar10 preset's median step through
    the trainer from the files with batches built on the prefetcher's
    thread and in worker processes, and the device's idle share over
    trainer steps."""
    import numpy as np

    from pytorch_glow_tpu_torch import build, train
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.data import native_loader
    from pytorch_glow_tpu_torch.data.celeba import CelebAFolder
    from pytorch_glow_tpu_torch.data.pipeline import DevicePrefetch, epoch_permutation, make_dataset
    from pytorch_glow_tpu_torch.scripts import perf_data

    t0 = time.perf_counter()
    cifar = perf_data.write_cifar10(os.path.join(out_root, "cifar10-data"), seed=SEED)
    print(f"CIFAR-10 pickles written (5 x 10000 + 10000 textured images): "
          f"{time.perf_counter() - t0:.2f} s")
    argv = ["cifar10", "--data-root", cifar, "--quiet", "--set", "train.eval_gap=10",
            "--set", "train.eval_batches=2", "--set", "train.checkpoint_gap=10"]

    def profile_of(out_dir: str, *extra: str):
        return train_cli.resolve_profile(train_cli.parse_args([*argv, "--out-dir", out_dir,
                                                               *extra]))

    # -- (a) the main path: cifar10 from the files through the train CLI ------
    fs.reset_launches()
    t0 = time.perf_counter()
    result, _ = run_cli(train_cli.main, [*argv, "--out-dir", os.path.join(out_root, "a"),
                                         "--steps", "20"])
    torch.cuda.synchronize()
    prof = profile_of(os.path.join(out_root, "a"))
    cfg, t = prof.glow, prof.train
    print(f"train CLI cifar10 from the CIFAR-10 files (K={cfg.K}, L={cfg.L}, hidden "
          f"{cfg.hidden_channels}, b={t.batch_size}, {cfg.flowstep_impl}, {cfg.compute_dtype} "
          f"coupling, steps_per_call={t.steps_per_call}, prefetch {prof.data.prefetch}), "
          f"20 steps: {time.perf_counter() - t0:.2f} s; launches {dict(fs.launches)}")
    require(result["final_step"] == 20 and math.isfinite(result["loss"]), f"train {result}")
    steps20 = expected_launches(fs, cfg, t.batch_size, ("backward",), 20)
    require(fs.launches["forward"] > 0 and fs.launches["backward"] == steps20["backward"],
            f"launches {fs.launches}, want {steps20['backward']} backward")
    with open(os.path.join(out_root, "a", prof.name, "metrics.csv")) as f:
        evals = [r for r in csv.DictReader(f) if r.get("eval_nll")]
    require([int(r["step"]) for r in evals] == [10, 20]
            and all(math.isfinite(float(r["eval_nll"])) for r in evals), f"evals {evals}")
    want = torch.load(os.path.join(out_root, "a", prof.name, "checkpoints", "20.pt"),
                      map_location="cuda", weights_only=True)
    require(want["data_state"] == {"next_index": 21}, f"data state {want['data_state']}")

    # The same 20 steps on batches built and copied on the launch thread.
    built = build(profile_of(os.path.join(out_root, "direct")))
    host = make_dataset(built.profile.data, cfg, t)
    host.set_state(built.data.get_state())
    built.data.close()
    built.data = DirectBatches(host, torch)
    train(built, num_steps=20, quiet=True)
    n, worst = same_params(torch, built.state["model"].state_dict(), want["model"])
    print(f"cifar10 20 steps, prefetched (train CLI) vs on the launch thread: {n} parameter "
          f"tensors differ, max |diff| {worst:.3e}")
    require(n == 0, f"prefetched vs direct: {n} tensors differ by up to {worst}")

    # Stopped at step 10 with a full prefetch queue, then resumed to 20.
    stop = build(profile_of(os.path.join(out_root, "resume")))
    train(stop, num_steps=10, quiet=True)
    built_ahead = stop.data._inner.get_state()["next_index"]
    print(f"stopped at step 10: consumed {stop.data.get_state()}, the prefetcher had built up "
          f"to batch {built_ahead}")
    require(stop.data.get_state() == {"next_index": 11}
            and built_ahead >= 11 + prof.data.prefetch, f"stop {stop.data.get_state()} "
            f"{built_ahead}")
    del stop
    resumed, text = run_cli(train_cli.main, [*argv, "--out-dir", os.path.join(out_root, "resume"),
                                             "--steps", "20"])
    require("resumed from step 10" in text and resumed["final_step"] == 20, f"resume {resumed}")
    got = torch.load(os.path.join(out_root, "resume", prof.name, "checkpoints", "20.pt"),
                     map_location="cuda", weights_only=True)
    n, worst = same_params(torch, got["model"], want["model"])
    print(f"cifar10 resumed at 10 through a full prefetch queue vs 20 straight: {n} parameter "
          f"tensors differ, max |diff| {worst:.3e}")
    require(n == 0 and got["data_state"] == want["data_state"], f"resume: {n} differ by {worst}")
    del built, want, got
    torch.cuda.empty_cache()

    # -- (b) the prefetcher under load ----------------------------------------
    stream = DevicePrefetch(make_dataset(prof.data, cfg, t), "cuda", prof.data.prefetch)
    host = make_dataset(prof.data, cfg, t)
    expected, early, late = [], [], []
    try:
        for _ in range(50):
            expected.append(next(host)["image"])
            batch = next(stream)["image"]
            early.append(batch.clone())
            torch.cuda._sleep(5_000_000)
            late.append(batch.clone())
            del batch
            torch.empty(t.batch_size * 32 * 32 * 3, dtype=torch.uint8, device="cuda").fill_(7)
        torch.cuda.synchronize()
    finally:
        stream.close()
    bad = [i for i in range(50) for x in (early[i], late[i])
           if not np.array_equal(x.cpu().numpy(), expected[i])]
    print(f"50 prefetched batches (b={t.batch_size}) under a sleeping, allocating consumer: "
          f"{len(bad)} differ from their host batches")
    require(not bad, f"prefetched batches differ: {bad[:5]}")
    del expected, early, late

    # -- (c) CelebA at celeba64 -------------------------------------------------
    decoder = "native" if native_loader.available() else "pillow"
    t0 = time.perf_counter()
    celeba = perf_data.write_celeba(os.path.join(out_root, "celeba-data"), CELEBA_IMAGES,
                                    CELEBA_TEST, seed=SEED)
    print(f"CelebA folder written ({CELEBA_IMAGES} 178x218 PNGs): "
          f"{time.perf_counter() - t0:.2f} s; decoder: {decoder}")
    cargv = ["celeba64", "--data-root", celeba, "--quiet", "--out-dir",
             os.path.join(out_root, "c"), "--set", "train.eval_gap=10",
             "--set", "train.eval_batches=1"]
    cprof = train_cli.resolve_profile(train_cli.parse_args(cargv))
    size, b = cprof.data.image_size, cprof.train.batch_size
    files = CelebAFolder(celeba, size, "train")
    order = epoch_permutation(cprof.train.seed, 0, len(files), True)[:b]
    first = next(make_dataset(cprof.data, cprof.glow, cprof.train))
    plain = []
    for j in order:
        with open(files.path(int(j)), "rb") as f:
            plain.append(crop_resize_plain(decode_png(f.read()), size, decoder == "pillow"))
    plain = np.stack(plain)
    err = int(np.abs(first["image"].astype(np.int16) - plain.astype(np.int16)).max())
    print(f"celeba64 first train batch ({decoder} decoder, b={b}) against the numpy crop and "
          f"bilinear plain version: max |diff| {err} (bound 1)")
    require(first["image"].shape == (b, size, size, 3) and err <= 1, f"decode err {err}")
    require(first["attr"].shape == (b, 40), f"attr {first['attr'].shape}")
    t0 = time.perf_counter()
    cres, _ = run_cli(train_cli.main, [*cargv, "--steps", "10"])
    print(f"train CLI celeba64 from the CelebA folder (b={b}), 10 steps: "
          f"{time.perf_counter() - t0:.2f} s; {cres}")
    require(cres["final_step"] == 10 and math.isfinite(cres["loss"]), f"celeba64 {cres}")
    again = build(cprof)
    require(again.resumed and again.start_step == 10, "celeba64 did not resume")
    dev = next(again.data)
    again.data.close()
    require(dev["image"].is_cuda and dev["attr"].is_cuda and tuple(dev["attr"].shape) == (b, 40)
            and set(dev["attr"].unique().tolist()) <= {-1, 1}, f"device attr {dev['attr']}")
    print(f"celeba64 device batch: image {tuple(dev['image'].shape)} {dev['image'].dtype}, "
          f"attr {tuple(dev['attr'].shape)} {dev['attr'].dtype}")
    del again, dev

    # -- (d) timing ---------------------------------------------------------------
    host_ms = perf_data.source_host_ms(cifar)
    host_ms[f"celeba64_decode_b128_{decoder}"] = perf_data.host_ms(
        make_dataset(cprof.data, cprof.glow, cprof.train), batches=5)
    print(f"host ms per batch: {json.dumps(host_ms)}; card: {card}")
    steps = {}
    for arm, workers in (("thread", 0), ("workers", DATA_WORKERS)):
        out = os.path.join(out_root, f"d-{arm}")
        run_cli(train_cli.main, ["cifar10", "--data-root", cifar, "--quiet", "--out-dir", out,
                                 "--steps", str(TIMED_STEPS), "--set", "train.scalar_log_gap=10",
                                 "--set", f"data.grain_workers={workers}"])
        steps[arm] = median_step(os.path.join(out, "cifar10"), 256, 10)
    print(f"cifar10 from the files, median train step ms through the trainer ({TIMED_STEPS} "
          f"steps, windows of 10 after the first; thread: the prefetcher's thread builds the "
          f"batches, workers: {DATA_WORKERS} worker processes do; scripts/perf_data.py times "
          f"more runs in turns): {json.dumps(steps)}; card: {card}")
    # The device's idle share over steps 10-15 from the files, in a run of
    # its own (the profiler slows the host): the trainer's profiler trace,
    # the union of its kernel and copy intervals against the trace's span.
    out = os.path.join(out_root, "d-profiled")
    run_cli(train_cli.main, ["cifar10", "--data-root", cifar, "--quiet", "--out-dir", out,
                             "--steps", "15", "--set", "train.profile_step=10",
                             "--set", "train.profile_num_steps=5"])
    with open(os.path.join(out, "cifar10", "profile", "trace_step_00000010.json")) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if "ts" in e and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset"))
    if device:
        busy, end = 0.0, -math.inf
        for lo, hi in device:
            busy += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        span = max(float(e["ts"]) + float(e["dur"]) for e in events) - min(
            float(e["ts"]) for e in events)
        print(f"cifar10 trainer steps 10-15 from the CIFAR files (torch.profiler trace, "
              f"profiler on): span {span / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms in "
              f"{len(device)} kernels and copies, idle share {max(0.0, 1 - busy / span):.3f}; "
              f"card: {card}")
    else:
        print("cifar10 trainer idle share: not measured (the trace held no kernel)")


# ---------------------------------------------------------------------------
# Phase 20: the conditional model
# ---------------------------------------------------------------------------


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check_conditional(torch, fs, card: str, out_root: str) -> dict:
    """Phase 20: the imagenet64-cond preset (K=48, L=4, hidden 512, 1000
    classes, b=128, bf16 coupling, fused flow steps, remat) at full width.
    (a) Writes an ImageNet-64 npz set from seed 0 (`train_data_batch_1..2`
    and `val_data`, 'data' (N, 12288) CHW-flattened uint8, 1-based 'labels'
    over all 1000 classes, textured images; the count cut to
    IMAGENET_PER_FILE a shard).  (b) Trains the unmodified preset from it
    through the train CLI in-process for 10 steps (steps_per_call=5), with a
    plot and an eval (2 batches) at 5 and 10 and an SWD of 64 at 10: the
    run's K1/K2/K3 launches against its steps and boundaries (K*L = 192 per
    pass), `loss_class` in metrics.csv, finite, with loss = nll + 0.01 *
    loss_class to f32 rounding, and the step-5 plot PNG equal to the same
    samples drawn again from the step-5 snapshot's EMA weights, generator
    and labels.  (c) From the step-10 snapshot with project_ycond and
    project_class perturbed: `loss_fn` fused and unfused (loss, nll,
    loss_class within rtol 2e-2), then 3 steps on both paths (grad_norm
    within rtol 2e-2 at each).  (d) Serving at b=64 on those weights:
    `Inferer.nll` with labels against the unfused path (rtol 2e-2) and
    different under other labels; a sample; `nll_bound` elbo k=1 bitwise
    equal to `log_prob` on the same generator state, iwae k=4 at most elbo
    k=4 per image; `cli.infer sample --class-id 7` and `cli.infer nll
    --dequant-samples 4 --bound iwae`; each request's launches.  (e) The
    preset with `glow.dequant=variational`: `neg_log_q` exactly 0 at init,
    5 steps through `train`, `vardeq_logq_bits` logged, every vardeq
    parameter with a non-zero gradient after those updates.  (f) The train
    step's median ms, images/s and peak memory at b=128 without and with
    vardeq, nll / sample / nll_bound (k=4) images/s at b=64, the phase's
    seconds.  Returns the train CLI run's launches."""
    import numpy as np

    from pytorch_glow_tpu_torch import PRESETS, Inferer, build, init_glow, train
    from pytorch_glow_tpu_torch.cli import infer as infer_cli
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.data.pipeline import make_dataset
    from pytorch_glow_tpu_torch.scripts.perf_data import write_imagenet64
    from pytorch_glow_tpu_torch.train import step as steplib
    from pytorch_glow_tpu_torch.train.builder import labels_to_onehot
    from pytorch_glow_tpu_torch.utils.image import make_grid

    t_phase = time.perf_counter()

    # -- (a) the ImageNet-64 npz files -----------------------------------------
    t0 = time.perf_counter()
    root = write_imagenet64(os.path.join(out_root, "imagenet64"), IMAGENET_PER_FILE, seed=SEED)
    print(f"ImageNet-64 npz set (train_data_batch_1..2 and val_data, {IMAGENET_PER_FILE} "
          f"images each, 12288 CHW bytes an image, labels 1..1000): "
          f"{time.perf_counter() - t0:.2f} s")

    # -- (b) the main path: the train CLI through every boundary ---------------
    argv = ["imagenet64-cond", "--data-root", root, "--quiet", "--out-dir", out_root,
            "--steps", "10", "--set", "train.plot_gap=5", "--set", "train.eval_gap=5",
            "--set", "train.swd_gap=10", "--set", "train.checkpoint_gap=5",
            "--set", "train.eval_batches=2", "--set", "train.swd_images=64"]
    prof = train_cli.resolve_profile(train_cli.parse_args(argv))
    cfg, t = prof.glow, prof.train
    require(cfg == PRESETS["imagenet64-cond"].glow and t.batch_size == TRAIN_BATCH
            and t.steps_per_call == 5, f"imagenet64-cond profile {prof}")
    run = os.path.join(out_root, prof.name)
    b, n_img, n_swd = t.batch_size, t.num_sample_images, min(t.swd_images, t.batch_size)
    fs.reset_launches()
    t0 = time.perf_counter()
    result, _ = run_cli(train_cli.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fs.launches)
    print(f"train CLI imagenet64-cond (K={cfg.K}, L={cfg.L}, hidden {cfg.hidden_channels}, "
          f"{cfg.y_classes} classes, b={b}, steps_per_call={t.steps_per_call}), 10 steps: "
          f"{wall:.2f} s; launches {launches}")
    require(result["final_step"] == 10 and math.isfinite(result["loss"])
            and math.isfinite(result["loss_class"]), f"train {result}")
    per_pass = expected_launches(fs, cfg, b, ("forward",))
    require(per_pass == counts(fs, forward=cfg.K * cfg.L) and cfg.K * cfg.L == 192,
            f"launches per pass {per_pass}")
    recon = expected_launches(fs, cfg, n_img, ("forward", "reverse"))
    plot = add_counts(expected_launches(fs, cfg, n_img, ("reverse",)), recon)
    evals = add_counts(expected_launches(fs, cfg, b, ("forward",), 2 * t.eval_batches), recon)
    want = add_counts(expected_launches(fs, cfg, b, ("forward", "backward"), 10), plot, plot,
                      evals, evals, expected_launches(fs, cfg, n_swd, ("reverse",)))
    require(launches == want, f"run launches {launches}, want {want}")
    print(f"K1/K2/K3 launches of the run: forward {launches['forward']}, reverse "
          f"{launches['reverse']}, backward {launches['backward']} (192 a pass: 10 train steps "
          f"of one forward and one backward, 2 plots, 2 evals of 2 x {t.eval_batches} batches "
          f"and a reconstruct, an SWD of {n_swd})")
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    logged = [r for r in rows if r.get("loss")]
    require(logged and all(r.get("loss_class") for r in logged), f"metrics rows {logged}")
    for r in logged:
        loss, nll, cls = (float(r[k]) for k in ("loss", "nll", "loss_class"))
        require(all(map(math.isfinite, (loss, nll, cls)))
                and rel_diff(loss, nll + cfg.weight_y * cls) <= 1e-6,
                f"loss {loss} vs nll {nll} + {cfg.weight_y} * loss_class {cls}")
        print(f"metrics.csv step {r['step']}: loss {loss}, nll {nll}, loss_class {cls}")
    for r in rows:
        for kind in ("plot", "eval", "swd"):
            if r.get(f"{kind}_ms"):
                print(f"boundary {kind} at step {r['step']}: {float(r[f'{kind}_ms']):.3f} ms, "
                      f"{int(float(r[f'{kind}_launches']))} launches"
                      + (f", eval_nll {r['eval_nll']}" if kind == "eval" else ""))

    # The step-5 sample grid, drawn again: the step-5 snapshot's EMA weights,
    # the plot's generator and the first labels of the step's last batch
    # (the DDI batch first, then steps 1-5).
    stream = make_dataset(prof.data, cfg, t)
    batch5 = [next(stream) for _ in range(6)][5]
    y5 = labels_to_onehot(batch5, prof)[:n_img]
    require(bool((y5.sum(1) == 1).all()), "one-hot labels")
    snap5 = torch.load(os.path.join(run, "checkpoints", "5.pt"), map_location="cuda",
                       weights_only=True)
    model5 = init_glow(cfg, device="cuda")
    model5.load_state_dict(snap5["model"])
    model5.load_state_dict(steplib.ema_params({"model": model5, "ema": snap5["ema"]}))
    temp = t.sample_temperature * (min(1.0, 5 / t.temperature_anneal_steps)
                                   if t.temperature_anneal_steps else 1.0)
    redraw = make_grid(steplib.make_sample_fn(cfg, n_img, t.sample_temperature)(
        model5, steplib.step_generator(t.seed + 2, 5, "cuda"), temp,
        y_onehot=y5).cpu().numpy())
    with open(os.path.join(run, "samples", "step_00000005.png"), "rb") as f:
        grid = decode_png(f.read())
    diff = int(np.abs(grid.astype(np.int16) - redraw.astype(np.int16)).max())
    print(f"step-5 sample PNG {grid.shape} at T={temp}, classes {y5.argmax(1).tolist()}: against "
          f"the same samples drawn again, max uint8 diff {diff}")
    require(grid.shape == redraw.shape and diff == 0, f"sample PNG diff {diff}")
    del model5, snap5, stream

    # -- the repaired zero conv of the unfused bf16 path, on the card: the f32
    # sum of the bf16 operands (tap-packed bf16 product with an f32 result)
    # against the true-f32 conv of the same operands, within 1e-5 of the
    # output's largest magnitude (a bf16-rounded output is off by up to
    # 2^-9 of it), and its backward bitwise equal to the bf16 conv's --------
    from pytorch_glow_tpu_torch.models import layers as tlayers

    gen = torch.Generator().manual_seed(SEED + 39)
    h0, w0, c0 = cfg.latent_shapes()[0]
    zero_conv = tlayers.Conv2dZeros(cfg.hidden_channels, c0)
    with torch.no_grad():
        for p in zero_conv.parameters():
            p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    zero_conv = zero_conv.cuda()
    h2 = torch.relu(torch.randn(b, h0, w0, cfg.hidden_channels, generator=gen)).bfloat16().cuda()
    h2.requires_grad_()
    gy = torch.randn(b, h0, w0, c0, generator=gen).cuda()
    y = zero_conv(h2)
    old = (tlayers._conv_nhwc(h2, zero_conv.weight).float() + zero_conv.bias) * torch.exp(
        zero_conv.logs.view(-1) * 3.0)
    with torch.no_grad():
        f32 = (tlayers._conv_nhwc(h2.float(), zero_conv.weight.bfloat16().float())
               + zero_conv.bias) * torch.exp(zero_conv.logs.view(-1) * 3.0)
        scale = float(f32.abs().max())
        err, err_old = float((y - f32).abs().max()), float((old - f32).abs().max())
    got = torch.autograd.grad(y, (h2, zero_conv.weight), gy)
    want = torch.autograd.grad(old, (h2, zero_conv.weight), gy)
    same_grads = all(torch.equal(a, c) for a, c in zip(got, want))
    print(f"zero conv {b}x{h0}x{w0}x{cfg.hidden_channels} -> {c0}: max |diff| from the f32 conv "
          f"{err:.3e} (the bf16-rounded output's {err_old:.3e}, scale {scale:.3f}); backward "
          f"bitwise equal to the bf16 conv's: {same_grads}")
    require(y.dtype == torch.float32 and err <= 1e-5 * scale and same_grads,
            f"zero conv: max |diff| {err} at scale {scale}, grads equal {same_grads}")
    del zero_conv, h2, gy, y, old, f32, got, want

    # -- (c) fused against unfused, on one state ------------------------------
    built = build(prof)
    require(built.resumed and built.start_step == 10, f"resume at {built.start_step}")
    model = built.state["model"]
    gen = torch.Generator().manual_seed(SEED + 40)
    with torch.no_grad():
        for head in (model.project_ycond, model.project_class):
            for p in head.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen).cuda())
    plain_cfg = dataclasses.replace(cfg, flowstep_impl="xla")
    plain = init_glow(plain_cfg)
    plain.load_state_dict(model.state_dict())
    batch = next(built.data)
    x, y = model.preprocess(batch["image"]), labels_to_onehot(batch, prof)
    with torch.no_grad():
        _, mf = model.loss_fn(x, torch.Generator(device="cuda").manual_seed(SEED), y)
        _, mp = plain.loss_fn(x, torch.Generator(device="cuda").manual_seed(SEED), y)
    print(f"loss_fn fused vs unfused, perturbed class heads, b={b}: " + ", ".join(
        f"{k} {float(mf[k]):.6f} vs {float(mp[k]):.6f}" for k in ("loss", "nll", "loss_class")))
    for k in ("loss", "nll", "loss_class"):
        require(rel_diff(float(mf[k]), float(mp[k])) <= 2e-2, f"loss_fn {k}: {mf[k]} vs {mp[k]}")
    fused_step = steplib.make_train_step(cfg, built.tx, t.ema_decay, built.schedule,
                                         t.augment_flip)
    plain_step = steplib.make_train_step(plain_cfg, built.tx, t.ema_decay, built.schedule,
                                         t.augment_flip)
    state_f = built.state
    state_p = clone_state(state_f, plain)
    for _ in range(3):
        batch = next(built.data)
        y = labels_to_onehot(batch, prof)
        state_f, mf = fused_step(state_f, batch["image"], y)
        state_p, mp = plain_step(state_p, batch["image"], y)
        nf, np_ = float(mf["grad_norm"]), float(mp["grad_norm"])
        print(f"train step {state_f['step']}: loss fused {float(mf['loss']):.6f} unfused "
              f"{float(mp['loss']):.6f}, loss_class {float(mf['loss_class']):.6f} vs "
              f"{float(mp['loss_class']):.6f}, grad_norm {nf:.6f} vs {np_:.6f} "
              f"(rel {rel_diff(nf, np_):.2e})")
        require(math.isfinite(nf) and rel_diff(nf, np_) <= 2e-2,
                f"fused vs unfused grad_norm at step {state_f['step']}: {nf} vs {np_}")
    del state_p

    # -- (d) serving at b=64 on the perturbed weights --------------------------
    plain.load_state_dict(model.state_dict())
    tb = next(make_dataset(prof.data, cfg, dataclasses.replace(t, batch_size=BATCH),
                           split="test"))
    images = torch.from_numpy(tb["image"]).cuda()
    y = labels_to_onehot(tb, prof).cuda()
    y_other = labels_to_onehot({**tb, "label": (tb["label"] + 1) % cfg.y_classes}, prof).cuda()
    inf, plain_inf = Inferer(model), Inferer(plain)
    fs.reset_launches()
    nll = inf.nll(images, y)
    require(fs.launches == counts(fs, forward=192), f"nll launches {fs.launches}")
    nll_plain, nll_other = plain_inf.nll(images, y), inf.nll(images, y_other)
    rel = float(((nll - nll_plain).abs() / nll_plain.abs()).max())
    moved = float((nll - nll_other).abs().max())
    print(f"nll with labels b={BATCH}: fused {float(nll.mean()):.6f} vs unfused "
          f"{float(nll_plain.mean()):.6f} bits/dim (max rel {rel:.3e}); under other labels "
          f"{float(nll_other.mean()):.6f} (max |diff| {moved:.3e})")
    require(rel <= 2e-2 and moved > 0, f"conditional nll rel {rel}, label effect {moved}")
    del plain, plain_inf
    torch.cuda.empty_cache()
    fs.reset_launches()
    samples = inf.sample(BATCH, 0.7, torch.Generator(device="cuda").manual_seed(SEED), y)
    require(fs.launches == counts(fs, reverse=192) and samples.shape == images.shape
            and samples.dtype == torch.uint8, f"sample launches {fs.launches}")

    def clone_gen(g):
        out = torch.Generator(device="cuda")
        out.set_state(g.get_state())
        return out

    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    g2 = clone_gen(g)
    elbo1 = inf.nll_bound(images, 1, "elbo", g, y)
    with torch.no_grad():
        lp = model.log_prob(model.preprocess(images), g2, y)["nll"]
    g = torch.Generator(device="cuda").manual_seed(SEED + 42)
    g2 = clone_gen(g)
    fs.reset_launches()
    iwae4 = inf.nll_bound(images, 4, "iwae", g, y)
    require(fs.launches == counts(fs, forward=4 * 192), f"nll_bound launches {fs.launches}")
    elbo4 = inf.nll_bound(images, 4, "elbo", g2, y)
    print(f"nll_bound b={BATCH}: elbo k=1 {float(elbo1.mean()):.6f} (log_prob on the same "
          f"generator state {float(lp.mean()):.6f}, bitwise {torch.equal(elbo1, lp)}); k=4 iwae "
          f"{float(iwae4.mean()):.6f} <= elbo {float(elbo4.mean()):.6f} per image: "
          f"{bool((iwae4 <= elbo4).all())}; the bin-corner nll {float(nll.mean()):.6f}")
    require(torch.equal(elbo1, lp) and bool((iwae4 <= elbo4).all()), "nll_bound")
    png = os.path.join(out_root, "class7.png")
    _, text = run_cli(infer_cli.main, ["sample", "imagenet64-cond", "--data-root", root,
                                       "--out-dir", out_root, "--class-id", "7", "-n", "16",
                                       "-o", png])
    with open(png, "rb") as f:
        grid7 = decode_png(f.read())
    require("class 7" in text and grid7.shape == (4 * 66 + 2, 4 * 66 + 2, 3),
            f"sample --class-id: {text!r} {grid7.shape}")
    _, text = run_cli(infer_cli.main, ["nll", "imagenet64-cond", "--data-root", root,
                                       "--out-dir", out_root, "--batches", "1",
                                       "--dequant-samples", "4", "--bound", "iwae"])
    require("(iwae bound, 4 noise draws)" in text
            and math.isfinite(float(text.split("nll: ")[1].split()[0])), f"infer nll: {text!r}")

    # -- (f) times: the train step without vardeq, serving ----------------------
    def labelled(step_fn):
        return lambda state, batch: step_fn(state, batch["image"], labels_to_onehot(batch, prof))

    step_ms, step_mem = train_step_ms(labelled(fused_step), state_f,
                                      [next(built.data) for _ in range(4)], torch)
    built.data.close()
    times = {"nll": median_ms(lambda: inf.nll(images, y), torch, reps=3, inner=2),
             "sample": median_ms(lambda: inf.sample(BATCH, 0.7, g, y), torch, reps=3, inner=2),
             "nll_bound k=4": median_ms(lambda: inf.nll_bound(images, 4, "iwae", g, y), torch,
                                        reps=3, inner=1)}
    del built, state_f, model, inf
    torch.cuda.empty_cache()

    # -- (e) variational dequantization ----------------------------------------
    argv_vd = ["imagenet64-cond", "--data-root", root, "--quiet", "--steps", "5",
               "--out-dir", os.path.join(out_root, "vardeq"), "--set", "glow.dequant=variational"]
    prof_vd = train_cli.resolve_profile(train_cli.parse_args(argv_vd))
    built_vd = build(prof_vd)
    model_vd = built_vd.state["model"]
    with torch.no_grad():
        out = model_vd.log_prob(model_vd.preprocess(images),
                                torch.Generator(device="cuda").manual_seed(SEED + 43), y)
    zero = bool((out["neg_log_q"] == 0).all())
    print(f"vardeq at init, b={BATCH}: neg_log_q exactly 0: {zero}")
    require(zero, f"neg_log_q at init {out['neg_log_q']}")
    fs.reset_launches()
    result_vd = train(built_vd, num_steps=5, quiet=True)
    require(fs.launches == counts(fs, forward=5 * 192, backward=5 * 192),
            f"vardeq train launches {fs.launches}")
    with open(os.path.join(prof_vd.out_dir, prof_vd.name, "metrics.csv")) as f:
        rows_vd = [r for r in csv.DictReader(f) if r.get("loss")]
    bits = [float(r["vardeq_logq_bits"]) for r in rows_vd if r.get("vardeq_logq_bits")]
    print(f"vardeq train, 5 steps: {result_vd}; vardeq_logq_bits in metrics.csv {bits}")
    require(result_vd["final_step"] == 5 and bits and all(map(math.isfinite, bits)),
            f"vardeq run {result_vd} {bits}")
    batch = next(built_vd.data)
    names = [n for n, _ in model_vd.named_parameters() if n.startswith("vardeq.")]
    params = dict(model_vd.named_parameters())
    loss, _ = model_vd.loss_fn(model_vd.preprocess(batch["image"]),
                               torch.Generator(device="cuda").manual_seed(SEED + 44),
                               labels_to_onehot(batch, prof_vd))
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    dead = [n for n, gr in zip(names, grads)
            if not bool((gr != 0).any()) or not bool(torch.isfinite(gr).all())]
    print(f"vardeq parameter grads after 5 updates: {len(names)} tensors, {len(dead)} all-zero "
          f"or non-finite")
    require(not dead and len(names) == 8 + 9 * prof_vd.glow.vardeq_steps, f"vardeq grads {dead}")
    vd_step = steplib.make_train_step(prof_vd.glow, built_vd.tx, t.ema_decay, built_vd.schedule)
    vd_ms, vd_mem = train_step_ms(labelled(vd_step), built_vd.state,
                                  [next(built_vd.data) for _ in range(4)], torch)
    built_vd.data.close()
    del built_vd, model_vd, grads, loss
    torch.cuda.empty_cache()

    print(f"time train step imagenet64-cond b={b}: {step_ms:.3f} ms ({b * 1e3 / step_ms:.1f} "
          f"img/s, peak {step_mem / 2**30:.2f} GiB); with vardeq {vd_ms:.3f} ms "
          f"({b * 1e3 / vd_ms:.1f} img/s, peak {vd_mem / 2**30:.2f} GiB)")
    print(f"time serving imagenet64-cond b={BATCH}: " + ", ".join(
        f"{k} {ms:.3f} ms ({BATCH * 1e3 / ms:.1f} img/s)" for k, ms in times.items()))
    print(f"card for these times: {card}")
    print(f"phase 20 (the conditional model): {time.perf_counter() - t_phase:.2f} s")
    return launches


def served_launches(torch, fs, fn):
    """(fn()'s result, the flow-step launches it made, the non-zero counts)."""
    fs.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in fs.launches.items() if v}


def max_rel(a, b) -> float:
    return float(((a - b).abs() / b.abs()).max())


def export_spmd(torch, serve, model, cfg, images, km, out: str) -> None:
    """Phase 21 (e): `model` exported to `out` as an SPMD kernel artifact of
    SPMD_FUNCTIONS at b=BATCH with a data axis of SPMD_DATA, and the
    one-device kernel artifact `km`'s outputs on `images` (and its sample
    of seed SPMD_SEED) beside it, for phase 23's ranks."""
    t0 = time.perf_counter()
    man = serve.export_artifact(model, cfg, out, BATCH, SPMD_FUNCTIONS, keep_kernels=True,
                                mesh={"data": SPMD_DATA})
    require(man["mesh"] == {"shape": [SPMD_DATA], "axis_names": ["data"]}
            and all(m["arg_specs"] for m in man["functions"].values()), f"SPMD manifest {man}")
    torch.save({"images": images.cpu(), "nll": km.nll(images).cpu(),
                "encode": km.encode(images).cpu(),
                "sample": km.sample(seed=SPMD_SEED, temperature=0.7).cpu()},
               os.path.join(out, "one_device.pt"))
    print(f"SPMD kernel artifact (data={SPMD_DATA}, functions {list(SPMD_FUNCTIONS)}, b={BATCH}, "
          f"{BATCH // SPMD_DATA} rows a rank): export + save {time.perf_counter() - t0:.2f} s, "
          f"{sum(m['bytes'] for m in man['functions'].values())} bytes; the one-device "
          f"artifact's outputs kept for phase 23")


def check_serving_artifacts(torch, fs, icf, card: str, out_root: str, data_root: str) -> None:
    """Phase 21: the serving artifact, the attribute workflow and lineage
    snapshots.  (a) celeba64 at full width (hidden 512, L=4, bf16, fused),
    export depth cut to SERVE_EXPORT_K, random weights from a seed, DDI and
    perturbed zero-convs: a kernel artifact (all six functions) and a
    portable one (nll, sample) at b=64, exported, saved and loaded (each
    step's seconds and bytes printed), then served: the kernel artifact's
    sample, encode, decode and reconstruct bitwise equal to the live
    Inferer's with the same seed, nll and nll_elbo within rtol 1e-6, K*L
    K1/K2 launches per request (reconstruct K*L of each); the portable
    artifact's 0 launches, its sample and nll against a live unfused
    Inferer (bitwise, rtol 1e-6) and its nll against the fused one (rtol
    2e-2); both nll bitwise unchanged with TF32 allowed around the call;
    served and live times.  (b) One call each of the K4 ops (forward
    and reverse, celebahq256 level 0 at b=64) and of the K6a / K6b ops
    (65536 x 12) bitwise equal to a direct launch of the same kernel.  (c)
    `cli.infer` delta / manipulate / interpolate / report (`--batches 2
    --swd-images 64`) on phase 19's CelebA folder and its celeba64
    snapshot, each with its K1/K2 launches, report.json's keys checked.
    (d) The live model's weights written as a lineage .pth, imported by
    `scripts.torch_migrate` and scored (`Inferer.nll` bitwise equal to the
    live one, and `cli.infer nll`).  (e) The same model exported as an
    SPMD kernel artifact (sample, encode, nll; a data axis of 2, 32 rows a
    rank), with the one-device kernel artifact's outputs on phase 23's
    inputs, for phase 23's two ranks to serve."""
    import numpy as np

    from pytorch_glow_tpu_torch import serve
    from pytorch_glow_tpu_torch.cli import infer as infer_cli
    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.inference import Inferer
    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.ops import invconv as ic
    from pytorch_glow_tpu_torch.ops import library
    from pytorch_glow_tpu_torch.scripts import torch_migrate
    from pytorch_glow_tpu_torch.utils import lineage
    from pytorch_glow_tpu_torch.utils.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    full = PRESETS["celeba64"].glow
    cfg = dataclasses.replace(full, K=SERVE_EXPORT_K)
    kl = cfg.K * cfg.L
    print(f"phase 21: celeba64 export depth cut to K={cfg.K} of the preset's {full.K} (L={cfg.L}, "
          f"hidden {cfg.hidden_channels}, {cfg.flowstep_impl}, {cfg.compute_dtype}), b={BATCH}")

    def ddi_model(c):
        m = init_glow(c, torch.Generator().manual_seed(SEED), "cuda")
        m.ddi_init(m.dequantize(m.preprocess(images), torch.Generator(device="cuda").manual_seed(SEED + 2)))
        return m

    rng = np.random.default_rng(SEED + 21)
    images = torch.from_numpy(rng.integers(0, 256, (BATCH, *cfg.image_shape), dtype="uint8")).cuda()
    model = ddi_model(cfg)
    gen = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():  # every coupling data-dependent (as phase 4)
        for name, p in model.named_parameters():
            if ".f.4." in name:
                p.add_(0.003 * torch.randn(p.shape, generator=gen).cuda())
    live = Inferer(model)

    # -- (a) export, load, serve ----------------------------------------------------
    served = {}
    for name, keep, fns in (("kernels", True, None), ("portable", False, ("nll", "sample"))):
        out = os.path.join(out_root, name)
        t0 = time.perf_counter()
        man = serve.export_artifact(model, cfg, out, BATCH, fns, keep_kernels=keep)
        t1 = time.perf_counter()
        sm = serve.load_artifact(out)
        for fn in man["functions"]:
            sm.fn(fn)
        t2 = time.perf_counter()
        total = sum(m["bytes"] for m in man["functions"].values())
        print(f"{name} artifact (K={cfg.K}, b={BATCH}, device {man['device']}): export + save "
              f"{t1 - t0:.2f} s, load {t2 - t1:.2f} s, {total} bytes; per function "
              + ", ".join(f"{f} export {m['seconds']['export']:.2f} s save "
                          f"{m['seconds']['save']:.2f} s {m['bytes']} bytes"
                          for f, m in man["functions"].items()))
        require(man["device"] == "cuda" and man["keep_kernels"] == keep, f"manifest {name}")
        served[name] = sm
    km, pm = served["kernels"], served["portable"]

    # -- (e) an SPMD kernel artifact for phase 23's ranks ------------------------------
    export_spmd(torch, serve, model, cfg, images, km, os.path.join(out_root, "spmd"))
    cuda_seed = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa: E731

    s, launched = served_launches(torch, fs, lambda: km.sample(seed=7, temperature=0.7))
    require(launched == {"reverse": kl}, f"kernel artifact sample launches {launched}")
    require(torch.equal(s, live.sample(BATCH, 0.7, cuda_seed(7))), "served sample != live")
    require(not torch.equal(km.sample(seed=8, temperature=0.7), s), "seed 8 drew seed 7's sample")
    z, launched = served_launches(torch, fs, lambda: km.encode(images))
    require(launched == {"forward": kl}, f"kernel artifact encode launches {launched}")
    require(torch.equal(z, live.encode(images)), "served encode != live")
    d, launched = served_launches(torch, fs, lambda: km.decode(z, seed=3, temperature=0.7))
    require(launched == {"reverse": kl}, f"kernel artifact decode launches {launched}")
    require(torch.equal(d, live.decode(z, cuda_seed(3), 0.7)), "served decode != live")
    rec, launched = served_launches(torch, fs, lambda: km.reconstruct(images))
    require(launched == {"forward": kl, "reverse": kl}, f"reconstruct launches {launched}")
    require(torch.equal(rec, live.reconstruct(images)), "served reconstruct != live")
    nll, launched = served_launches(torch, fs, lambda: km.nll(images))
    require(launched == {"forward": kl}, f"kernel artifact nll launches {launched}")
    rel_nll = max_rel(nll, live.nll(images))
    elbo, launched = served_launches(torch, fs, lambda: km.nll_elbo(images, seed=5))
    require(launched == {"forward": kl}, f"kernel artifact nll_elbo launches {launched}")
    rel_elbo = max_rel(elbo, live.nll_bound(images, 1, "elbo", cuda_seed(5)))
    drift = int((rec.int() - images.int()).abs().max())
    print(f"kernel artifact against the live Inferer: sample, encode, decode, reconstruct "
          f"bitwise; nll max rel {rel_nll:.3e}, nll_elbo {rel_elbo:.3e} (bound 1e-6); "
          f"{kl} K1/K2 launches a request; reconstruct max |x - rec| {drift} bins")
    require(rel_nll <= 1e-6 and rel_elbo <= 1e-6, f"served nll {rel_nll}, elbo {rel_elbo}")

    unfused = ddi_model(dataclasses.replace(cfg, flowstep_impl="xla"))
    unfused.load_state_dict(model.state_dict())
    plain = Inferer(unfused)
    ps, launched = served_launches(torch, fs, lambda: pm.sample(seed=7, temperature=0.7))
    require(launched == {}, f"portable artifact sample launched {launched}")
    require(torch.equal(ps, plain.sample(BATCH, 0.7, cuda_seed(7))), "portable sample != live")
    pn, launched = served_launches(torch, fs, lambda: pm.nll(images))
    require(launched == {}, f"portable artifact nll launched {launched}")
    rel_plain, rel_fused = max_rel(pn, plain.nll(images)), max_rel(pn, live.nll(images))
    print(f"portable artifact: no kernel launch; sample bitwise the live unfused Inferer's, nll "
          f"max rel {rel_plain:.3e} against it (bound 1e-6), {rel_fused:.3e} against the fused "
          f"live path (bound 2e-2)")
    require(rel_plain <= 1e-6 and rel_fused <= 2e-2, f"portable nll {rel_plain}, {rel_fused}")
    # The loader's pin: with PyTorch's TF32 defaults switched on around the
    # call, both artifacts' nll (f32 split priors, mix) keep their bits.
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        loose = (pm.nll(images), km.nll(images))
        with torch.no_grad():
            unpinned = pm.fn("nll")(images)  # the program alone, as a bare caller runs it
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    require(torch.equal(loose[0], pn) and torch.equal(loose[1], nll),
            "a served nll moved with TF32 allowed around the call")
    print(f"served nll with TF32 allowed around the call: bitwise the pinned one (both "
          f"artifacts); the portable program called without the loader's pin moves by "
          f"{float((unpinned - pn).abs().max()):.3e} bits/dim")
    times = {"live nll": lambda: live.nll(images), "kernels nll": lambda: km.nll(images),
             "portable nll": lambda: pm.nll(images),
             "live sample": lambda: live.sample(BATCH, 0.7, cuda_seed(9)),
             "kernels sample": lambda: km.sample(seed=9, temperature=0.7),
             "portable sample": lambda: pm.sample(seed=9, temperature=0.7)}
    print(f"time served b={BATCH} K={cfg.K} (ms, CUDA events): " + ", ".join(
        f"{k} {median_ms(fn, torch):.3f}" for k, fn in times.items()))
    print(f"card for these times: {card}")
    del served, km, pm, plain, unfused

    # -- (b) the K4 and K6 ops, one call each ---------------------------------------
    gen = torch.Generator().manual_seed(SEED + 3)
    step = noisy_step(12, "additive", gen, torch)
    zb = torch.randn(BATCH, 128, 128, 12, generator=gen).cuda()
    require(fs.tiling("forward", BATCH, 128, 128, 12, 512, False) == "band", "K4 shape not banded")
    with torch.no_grad():
        fwd, rev = fs.pack_weights(step, False, False), fs.pack_weights(step, False, True)
        (yo, ldo), launched = served_launches(torch, fs,
                                              lambda: library.flowstep_forward(zb, False, fwd))
        require(launched == {"band_forward": 1}, f"K4 op launches {launched}")
        yd, ldd = fs._launch_band(fwd, zb, False, reverse=False)
        xo, launched = served_launches(torch, fs, lambda: library.flowstep_reverse(zb, False, rev))
        require(launched == {"band_reverse": 1}, f"K4 reverse op launches {launched}")
        xd, _ = fs._launch_band(rev, zb, False, reverse=True)
        require(torch.equal(yo, yd) and torch.equal(ldo, ldd) and torch.equal(xo, xd),
                "K4 op != direct launch")
        conv = random_lu(12, gen, torch)
        lu = conv.lu_params()
        x6 = torch.randn(65536, 12, generator=gen).cuda()
        icf.reset_launches()
        y6 = library.invconv_lu_forward(x6, *lu)
        w_inv = ic.lu_inverse(lu)
        x6o = library.invconv_mix(y6, w_inv)
        require(icf.launches == {"invconv_forward": 1, "invconv_reverse": 1},
                f"K6 op launches {icf.launches}")
        require(torch.equal(y6, icf._launch_forward(x6, *lu)[0])
                and torch.equal(x6o, icf._launch_mix(y6, w_inv)), "K6 op != direct launch")
    print(f"ops: K4 forward and reverse (b={BATCH}, 128x128x12) and K6a / K6b (65536x12) "
          f"through torch.library, bitwise equal to direct launches, one launch each")
    del step, zb, yo, yd, xo, xd, x6, y6, x6o

    # -- (c) the attribute workflow through the infer CLI --------------------------------
    celeba = os.path.join(data_root, "celeba-data")
    common = ["celeba64", "--data-root", celeba, "--out-dir", os.path.join(data_root, "c"),
              "--batches", "2"]
    klf = full.K * full.L
    delta = os.path.join(out_root, "delta.npz")
    cli = {
        "delta": (["delta", *common, "-o", delta], {"forward": 2 * klf}),
        "manipulate": (["manipulate", *common, "--delta", delta, "--attr", "31", "--strength",
                        "1.5", "-n", "8", "-o", os.path.join(out_root, "manip.png")],
                       {"forward": klf, "reverse": klf}),
        "interpolate": (["interpolate", *common, "--steps", "8", "-o",
                         os.path.join(out_root, "interp.png")],
                        {"forward": 2 * klf, "reverse": klf}),
        "report": (["report", *common, "--swd-images", "64", "-o", os.path.join(out_root, "rep")],
                   None),
    }
    for op, (argv, want) in cli.items():
        t0 = time.perf_counter()
        _, launched = served_launches(torch, fs, lambda: run_cli(infer_cli.main, argv))
        print(f"cli.infer {op}: {time.perf_counter() - t0:.2f} s, launches {launched}")
        if want is not None:
            require(launched == want, f"cli.infer {op} launches {launched}, want {want}")
        require(launched.get("forward", 0) > 0, f"cli.infer {op} launched no K1")
    d = np.load(delta, allow_pickle=True)["delta"]
    require(d.shape == (40, *full.final_latent_shape) and np.isfinite(d).all(), f"delta {d.shape}")
    with open(os.path.join(out_root, "manip.png"), "rb") as f:
        require(decode_png(f.read()).shape[:2] == (8 * 66 + 2, 2 * 66 + 2), "manipulate grid")
    with open(os.path.join(out_root, "rep", "report.json")) as f:
        report = json.load(f)
    keys = {"profile", "step", "snapshot", "ema", "params_millions", "image_shape",
            "temperatures", "recon_drift_u8", "manipulate", "bits_dim", "swd_x1e3"}
    require(keys <= set(report) and report["step"] == 10, f"report keys {sorted(report)}")
    bits = report["bits_dim"]
    require(report["manipulate"]["num_attributes"] == 40
            and all(math.isfinite(bits[k]) for k in ("noise_free_corner", "elbo_1draw",
                                                     "iwae_8draw"))
            and report["swd_x1e3"]["images_per_set"] == 64, f"report {report}")
    print(f"report.json: step {report['step']}, bits_dim {bits}, recon drift "
          f"{report['recon_drift_u8']}, swd_avg {report['swd_x1e3']['swd_avg']:.3f}")

    # -- (d) a lineage snapshot, imported and scored -----------------------------------
    pth = os.path.join(out_root, "lineage.pth")
    lineage.save_torch_snapshot(pth, lineage.export_state_dict(model.state_dict()), step=3)
    mig = os.path.join(out_root, "migrated")
    depth = ["--set", f"glow.K={cfg.K}"]
    run_cli(torch_migrate.main, ["import", pth, "celeba64", "--out-dir", mig, "--keep-step",
                                 *depth])
    snap = CheckpointManager(os.path.join(mig, "celeba64", "checkpoints")).restore("cuda")
    require(snap["step"] == 3, f"imported step {snap['step']}")
    imported = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
    imported.load_state_dict(snap["model"])
    require(torch.equal(Inferer(imported).nll(images), live.nll(images)),
            "imported lineage snapshot scores otherwise")
    _, text = run_cli(infer_cli.main, ["nll", "celeba64", "--out-dir", mig, "--synthetic",
                                       "textured", "--batches", "1", *depth])
    require("bits/dim over" in text, text)
    print("lineage .pth imported (step 3 kept): nll bitwise equal to the live model's")
    del imported, model, live

    print(f"phase 21 (serving artifacts, attributes, lineage): {time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------------------
# Phase 22: multi-device training
# ---------------------------------------------------------------------------


# The process groups of the rank launches under way, which a SIGTERM to
# the side process kills (`phases_beside`).
_LAUNCHED: set[int] = set()


def launch_ranks(nproc: int, backend: str, out: str, runs: list[list[str]], threads: int,
                 timeout: float = 600.0, mode: str = "--rank-cli", extra: list[str] = (),
                 outputs: bool = True) -> list[list[dict]]:
    """`torch.distributed.run --standalone --nproc_per_node nproc` of this
    script's `--rank-cli` mode over `runs` -> per run, each rank's counts
    and result (or of `mode` with `extra` arguments, whose outputs the
    caller reads: `outputs` False).  Each rank gets this process's
    `threads` host threads (OMP_NUM_THREADS; the launcher would set 1), so
    the host math of the model's init (the LU factors of random rotations)
    gives the same bits.  Its output goes to OUT.log, whose end is printed
    on a failure; the whole process group is killed on a timeout."""
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(nproc), os.path.join(HERE, "chip_smoke.py"), mode,
            backend, out, *extra]
    for i, run in enumerate(runs):
        argv += (["--next"] if i else []) + run
    with open(out + ".log", "w") as log:
        proc = subprocess.Popen(argv, cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True,
                                env={**os.environ, "OMP_NUM_THREADS": str(threads)})
        _LAUNCHED.add(proc.pid)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
        finally:
            _LAUNCHED.discard(proc.pid)
    if rc != 0:
        with open(out + ".log") as f:
            print(f.read()[-6000:])
        require(False, f"{nproc}-rank {backend} launch exited {rc}")
    if not outputs:
        return []
    outs = []
    for i in range(len(runs)):
        per_rank = []
        for r in range(nproc):
            with open(f"{out}.{i}.rank{r}.json") as f:
                per_rank.append(json.load(f))
        outs.append(per_rank)
    return outs


def csv_rows(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def step_rows(run_dir: str) -> list[dict]:
    """metrics.csv's per-step rows (loss, grad_norm, images_per_sec ...)."""
    return [r for r in csv_rows(run_dir) if r.get("loss")]


def check_multi_device(torch, fs, card: str, out_root: str) -> None:
    """Phase 22 (module docstring): celeba64 at full width through the train
    CLI, not distributed, on one NCCL rank and on two gloo ranks sharing the
    card as (data=2, model=1) and (data=1, model=2)."""
    from pytorch_glow_tpu_torch.cli import train as train_cli

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    common = ["celeba64", "--synthetic", "textured", "--quiet", "--set", "train.steps_per_call=1",
              "--set", "train.scalar_log_gap=1", "--set", "train.eval_gap=5",
              "--set", "train.eval_batches=1"]
    prof = train_cli.resolve_profile(train_cli.parse_args(common))
    cfg, b = prof.glow, prof.train.batch_size
    kl = cfg.K * cfg.L

    def argv(tag: str, steps: int, *extra: str) -> list[str]:
        return [*common, "--out-dir", os.path.join(out_root, tag), "--steps", str(steps), *extra]

    def run_dir(tag: str) -> str:
        return os.path.join(out_root, tag, "celeba64")

    def snapshot(tag: str, step: int) -> dict:
        return torch.load(os.path.join(run_dir(tag), "checkpoints", f"{step}.pt"),
                          map_location="cpu", weights_only=False)

    def seed_from(tag: str) -> None:
        """(a')'s step-0 snapshot as the start of run `tag`."""
        ckpts = os.path.join(run_dir(tag), "checkpoints")
        os.makedirs(ckpts)
        shutil.copy(os.path.join(run_dir("a1"), "checkpoints", "0.pt"), ckpts)

    def step_ms(tag: str) -> str:
        rates = [float(r["images_per_sec"]) for r in step_rows(run_dir(tag))[1:]]
        med = statistics.median(rates)
        return (f"median step {1e3 * b / med:.3f} ms, {med:.3f} images/s over steps "
                f"2-{len(rates) + 1}")

    train_launches = {"forward": MULTI_STEPS * kl, "backward": MULTI_STEPS * kl}
    evals = {"forward": 3 * kl, "reverse": kl}  # nll EMA and live, a reconstruct
    want = {k: train_launches.get(k, 0) + evals.get(k, 0) for k in fs.launches}

    # -- (a') not distributed, in-process ---------------------------------------
    t0 = time.perf_counter()
    run_cli(train_cli.main, argv("a1", 0))
    fs.reset_launches()
    result, _ = run_cli(train_cli.main, argv("a1", MULTI_STEPS))
    launched = dict(fs.launches)
    require(result["final_step"] == MULTI_STEPS and launched == want,
            f"(a') {result}, launches {launched}, want {want}")
    ref = step_rows(run_dir("a1"))
    print(f"(a') cli.train celeba64, not distributed: {time.perf_counter() - t0:.2f} s, "
          f"{step_ms('a1')}; launches {launched}")

    # -- (a) one NCCL rank -----------------------------------------------------
    t0 = time.perf_counter()
    threads = torch.get_num_threads()
    (_, ), (r5, ) = launch_ranks(1, "nccl", os.path.join(out_root, "a"),
                                 [argv("a", 0), argv("a", MULTI_STEPS)], threads)
    require(r5["launches"] == want, f"(a) launches {r5['launches']}")
    for step in (0, MULTI_STEPS):
        x, y = snapshot("a1", step), snapshot("a", step)
        same = (all(torch.equal(x["model"][k], y["model"][k]) for k in x["model"])
                and all(torch.equal(x["opt_state"][k], y["opt_state"][k]) for k in x["opt_state"])
                and all(torch.equal(u, v) for u, v in zip(x["ema"], y["ema"])))
        require(same and len(x["model"]) == len(y["model"]), f"(a) step-{step} snapshot differs")
    keys = ("step", "loss", "nll", "grad_norm", "lr", "eval_nll", "eval_nll_raw",
            "recon_err_max_u8", "best_eval_nll")
    got, ref_all = csv_rows(run_dir("a")), csv_rows(run_dir("a1"))
    require([{k: r.get(k) for k in keys} for r in got]
            == [{k: r.get(k) for k in keys} for r in ref_all],
            f"(a) logged numbers differ:\n{got}\n{ref_all}")
    print(f"(a) torchrun 1 rank: {time.perf_counter() - t0:.2f} s, {step_ms('a')}; "
          f"step-0 and step-{MULTI_STEPS} snapshots and every logged number bitwise equal "
          f"to (a'); launches {r5['launches']}")

    # -- (b), (c) two gloo ranks sharing the card ---------------------------------
    seed_from("b2")
    seed_from("c")
    t0 = time.perf_counter()
    outs = launch_ranks(2, "gloo", os.path.join(out_root, "bc"), [
        argv("b1", 0, "--dist-backend", "gloo"),
        argv("b2", MULTI_STEPS, "--dist-backend", "gloo"),
        argv("c", TP_STEPS, "--dist-backend", "gloo", "--set", "mesh.model=2")], threads)
    wall = time.perf_counter() - t0
    x, y = snapshot("a1", 0)["model"], snapshot("b1", 0)["model"]
    for k in x:
        if "actnorm" not in k:
            require(torch.equal(x[k], y[k]), f"(b) fresh {k} differs from (a')")
    print(f"(b) 2 gloo ranks, DDI on {b // 2} rows each with the global statistics, against "
          f"(a')'s on {b} (phase 14's rule; the other parameters bitwise):")
    hold_ddi({k: v for k, v in y.items() if "actnorm" in k},
             {k: v for k, v in x.items() if "actnorm" in k}, cfg.compute_dtype == "bfloat16",
             "(b) DDI on 2 ranks against one")
    for tag, steps, per_rank, mesh in (("b2", MULTI_STEPS, outs[1], "data=2, model=1"),
                                       ("c", TP_STEPS, outs[2], "data=1, model=2")):
        rows = step_rows(run_dir(tag))
        require(len(rows) == steps, f"({tag}) rows {rows}")
        dist_txt = []
        for i, (r, q) in enumerate(zip(rows, ref)):
            rl = rel_diff(float(r["loss"]), float(q["loss"]))
            rg = rel_diff(float(r["grad_norm"]), float(q["grad_norm"]))
            bounds = (1e-5, 1e-4) if i == 0 else (2e-2, 2e-2)
            require(rl <= bounds[0] and rg <= bounds[1],
                    f"({tag}) step {i + 1}: loss rel {rl:.3e}, grad_norm rel {rg:.3e}")
            dist_txt.append(f"step {i + 1} loss {rl:.3e} grad_norm {rg:.3e}")
        want_r = {k: steps * kl if k in ("forward", "backward") else 0 for k in fs.launches}
        if steps == MULTI_STEPS:
            want_r = want
        for rank, o in enumerate(per_rank):
            require(o["launches"] == want_r and o["result"]["final_step"] == steps,
                    f"({tag}) rank {rank} launches {o['launches']}, want {want_r}")
        print(f"({tag}) 2 gloo ranks ({mesh}) from (a')'s step-0 snapshot, {steps} steps, "
              f"relative distances to (a'): " + "; ".join(dist_txt)
              + f"; {step_ms(tag)}; launches per rank "
              + ", ".join(str(o["launches"]) for o in per_rank))
    grad_mb = snapshot("a1", 0)["opt_state"]["mu"].numel() * 4 / 1e6
    print(f"(b)+(c) launch: {wall:.2f} s; each gloo step moves the {grad_mb:.1f} MB f32 "
          f"gradient through host memory: no measure of NCCL across cards")
    print(f"card for these times: {card}")
    shutil.rmtree(out_root, ignore_errors=True)
    print(f"phase 22 (multi-device training): {time.perf_counter() - t_phase:.2f} s")


# ---------------------------------------------------------------------------
# Phase 23: spatial sharding and SPMD serving
# ---------------------------------------------------------------------------


def padded_slabs(torch, fs, z, n: int):
    """The n row slabs of z, each with fs.HALO rows of its neighbours around
    it (zeros beyond the image), and their Slabs."""
    h, k = z.shape[1], fs.HALO
    s = h // n
    zp = torch.nn.functional.pad(z, (0, 0, 0, 0, k, k))
    return [(zp[:, m * s:m * s + s + 2 * k].contiguous(), fs.Slab(m * s, h)) for m in range(n)]


def check_slab(torch, fs, results: dict) -> None:
    """Phase 23 (a) (module docstring): K4 / K5 in slab form at celebahq256
    level 0 under a model group of SPATIAL_MODEL, additive, b=64."""
    b, (h, w, c), n = BATCH, HQ_BAND_SHAPES[0], SPATIAL_MODEL
    gen = torch.Generator().manual_seed(SEED + 40)
    step = noisy_step(c, "additive", gen, torch)
    z, gzn = (torch.randn(b, h, w, c, generator=gen).cuda() for _ in range(2))
    gld = torch.randn(b, generator=gen).cuda()
    s = h // n
    tag = f"{b}x{s}(+{2 * fs.HALO})x{w}x{c} additive slabs of {h} rows (R={fs.band_rows(s, w)})"
    slabs = padded_slabs(torch, fs, z, n)
    with torch.no_grad():
        wf = fs.pack_weights(step, False, reverse=False)
        wr = fs.pack_weights(step, False, reverse=True)
        zb, ldb = fs._launch_band(wf, z, False, False)
        xb = fs._launch_band(wr, zb, False, True)[0]
        outs = [fs._launch_band(wf, zp, False, False, slab) for zp, slab in slabs]
        backs = [fs._launch_band(wr, zp, False, True, slab)[0]
                 for zp, slab in padded_slabs(torch, fs, zb, n)]
        for (zp, slab), (zk, _), (zq, sq), xk in zip(slabs, outs, padded_slabs(torch, fs, zb, n),
                                                      backs):
            hold_outputs(torch, tag, "slab_forward", zk,
                         fs.step_forward_band_ref(wf, zp, False, slab=slab)[0], results)
            hold_outputs(torch, tag, "slab_reverse", xk,
                         fs.step_reverse_band_ref(wr, zq, False, slab=sq), results)
    torch.cuda.synchronize()
    require(torch.equal(torch.cat([o for o, _ in outs], dim=1), zb)
            and torch.equal(torch.cat(backs, dim=1), xb),
            f"{tag}: the slabs' rows differ from the unsharded band chain's")
    # Relative to the largest |logdet| (additive coupling's is exactly 0).
    ld_rel = float((sum(ld for _, ld in outs) - ldb).abs().max()) / max(float(ldb.abs().max()),
                                                                        1e-30)
    require(ld_rel <= 1e-6, f"{tag}: the slabs' logdet sum rel {ld_rel}")
    rt_err = float((xb - z).abs().max())
    require(rt_err <= 2e-5, f"{tag}: round-trip {rt_err}")
    print(f"slab kernel {tag}: K4 forward and reverse on each slab within the bounds of 3 of "
          f"their plain slab versions, the slabs' rows bitwise the unsharded band chain's, "
          f"logdet sum rel {ld_rel:.3e}, round-trip {rt_err:.3e}")
    del zb, xb, backs
    k = fs.HALO
    with torch.no_grad():
        runs = []
        for _ in range(2):
            g_pad = torch.zeros(b, h + 2 * k, w, c, device=z.device)
            grads = None
            for m, (zp, slab) in enumerate(slabs):
                g, part = fs._launch_band_backward(wf, zp, gzn[:, m * s:(m + 1) * s], gld, False,
                                                   slab)
                g_pad[:, m * s:m * s + s + 2 * k] += g
                grads = part if grads is None else [a + p_ for a, p_ in zip(grads, part)]
            runs.append((g_pad, grads))
        rz, rgrads = fs.step_backward_ref(wf, z, gzn, gld, False)
    torch.cuda.synchronize()
    (g_pad, grads), (g2, grads2) = runs
    require(torch.equal(g_pad, g2) and all(torch.equal(a, a2) for a, a2 in zip(grads, grads2)),
            f"{tag} slab_backward: a second launch differs")
    require(not g_pad[:, :k].any() and not g_pad[:, -k:].any(),
            f"{tag} slab_backward: a cotangent beyond the image")
    err, scale = hold_gz(torch, tag, "slab_backward", g_pad[:, k:-k], rz, results)
    rel = []
    for i, (g, r) in enumerate(zip(grads, rgrads)):
        gmax = float((g - r).abs().max())
        require(bool(torch.isfinite(g).all()) and gmax <= 5e-2 * float(r.abs().max()),
                f"{tag} slab_backward: weight grad {i} max |diff| {gmax}")
        rel.append(gmax / max(float(r.abs().max()), 1e-30))
    print(f"slab_backward {tag}: the slabs' g_z (halo rows added on the neighbour) against "
          f"step_backward_ref max {float(err.max()):.3e} mean {float(err.mean()):.3e} scale "
          f"{scale:.3f}; summed weight grads max rel {max(rel):.2e}; a second launch bitwise")
    del runs, g_pad, g2, grads, grads2, rz, rgrads
    torch.cuda.empty_cache()

    def timed(fn):
        return median_ms(fn, torch, reps=3, inner=2)

    zp, slab = slabs[0]
    g0 = gzn[:, :s].contiguous()
    zeros = torch.zeros(b, device=z.device)
    with torch.no_grad():
        zk = outs[0][0]
        zq, sq = padded_slabs(torch, fs, torch.cat([o for o, _ in outs], dim=1), n)[0]
        times = {
            "slab_forward": (timed(lambda: fs._launch_band(wf, zp, False, False, slab)),
                             timed(lambda: fs.step_forward_band_ref(wf, zp, False, slab=slab)),
                             timed(lambda: step(zp, zeros))),
            "slab_reverse": (timed(lambda: fs._launch_band(wr, zq, False, True, sq)),
                             timed(lambda: fs.step_reverse_band_ref(wr, zq, False, slab=sq)),
                             timed(lambda: step.reverse(zq))),
            "slab_backward": (
                timed(lambda: fs._launch_band_backward(wf, zp, g0, gld, False, slab)),
                timed(lambda: fs.step_backward_band_ref(wf, zp, g0, gld, False, slab=slab))),
        }
    times["slab_backward"] += (timed(library_backward(
        torch, step, zp, gzn[:, :zp.shape[1]].contiguous(), gld)),)
    del zk
    for name, (ms, plain_ms, lib_ms) in times.items():
        bound, by = fs.bound_ms(name.removeprefix("slab_"), b, s, w, c, 512, False)
        print(f"time step {name} {tag}, one slab: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library (unfused FlowStep on the padded slab) {lib_ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by})")
        results[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                             bound_by=by)
    del step, z, gzn, slabs, outs
    torch.cuda.empty_cache()


def check_spatial(torch, fs, card: str, out_root: str, spmd: str) -> dict:
    """Phase 23 (module docstring); returns rank 0's slab-form launches."""
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.config import PRESETS
    from pytorch_glow_tpu_torch.models.glow import init_glow

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = PRESETS["celebahq256"].glow
    b, kl = BATCH, cfg.K * cfg.L
    common = ["celebahq256", "--synthetic", "textured", "--quiet", "--set",
              "train.scalar_log_gap=1", "--set", "train.plot_gap=0", "--set", "train.eval_gap=0",
              "--set", "train.swd_gap=0", "--set", "train.checkpoint_gap=1000"]

    def run_dir(tag: str) -> str:
        return os.path.join(out_root, tag, "celebahq256")

    def argv(tag: str, steps: int, *extra: str) -> list[str]:
        return [*common, "--out-dir", os.path.join(out_root, tag), "--steps", str(steps), *extra]

    def step_ms(tag: str) -> str:
        rates = [float(r["images_per_sec"]) for r in step_rows(run_dir(tag))[1:]]
        med = statistics.median(rates)
        return f"step {1e3 * b / med:.3f} ms ({med:.3f} images/s) over steps 2-{len(rates) + 1}"

    # -- (b) the unsharded arm, in-process ---------------------------------------
    t0 = time.perf_counter()
    run_cli(train_cli.main, argv("u", 0))
    snap = os.path.join(run_dir("u"), "checkpoints", "0.pt")
    fs.reset_launches()
    run_cli(train_cli.main, argv("u", SPATIAL_STEPS))
    unsharded = dict(fs.launches)
    ref = step_rows(run_dir("u"))
    print(f"(u) cli.train celebahq256 b={b}, not distributed: {time.perf_counter() - t0:.2f} s, "
          f"{step_ms('u')}; launches {unsharded}")

    # -- (c)'s reference: the unsharded encode and decode of one batch ------------
    model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
    model.load_state_dict(torch.load(snap, map_location="cuda", weights_only=False)["model"])
    rng = torch.Generator(device="cuda").manual_seed(SEED + 41)
    images = torch.randint(0, 256, (b, *cfg.image_shape), generator=rng, device="cuda",
                           dtype=torch.uint8)
    with torch.no_grad():
        x = model.preprocess(images)
        z, ld, zs = model.encode(x)
        rec = model.decode(z, z_splits=zs)
    coding = os.path.join(out_root, "coding.pt")
    torch.save({"x": x, "z": z, "ld": ld, "zs": zs, "rec": rec}, coding)
    del model, x, z, ld, zs, rec
    torch.cuda.empty_cache()

    # -- (b) sharded, (c), (d) on two gloo ranks -------------------------------------
    ckpts = os.path.join(run_dir("s"), "checkpoints")
    os.makedirs(ckpts)
    shutil.copy(snap, ckpts)
    spec = os.path.join(out_root, "spatial.json")
    with open(spec, "w") as f:
        json.dump({"train": argv("s", SPATIAL_STEPS, "--dist-backend", "gloo", "--set",
                                 f"mesh.model={SPATIAL_MODEL}"),
                   "snapshot": snap, "coding": coding, "spmd": spmd}, f)
    t0 = time.perf_counter()
    out = os.path.join(out_root, "spatial")
    launch_ranks(SPATIAL_MODEL, "gloo", out, [], torch.get_num_threads(), mode="--rank-spatial",
                 extra=[spec], outputs=False)
    ranks = []
    for r in range(SPATIAL_MODEL):
        with open(f"{out}.rank{r}.json") as f:
            ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    rows = step_rows(run_dir("s"))
    require(len(rows) == len(ref) == SPATIAL_STEPS, f"sharded rows {rows}, unsharded {ref}")
    dist_txt = []
    for i, (r, q) in enumerate(zip(rows, ref)):
        rl = rel_diff(float(r["loss"]), float(q["loss"]))
        rg = rel_diff(float(r["grad_norm"]), float(q["grad_norm"]))
        require(rl <= 1e-5 and rg <= 1e-4,
                f"sharded step {i + 1}: loss rel {rl:.3e}, grad_norm rel {rg:.3e}")
        dist_txt.append(f"step {i + 1} loss rel {rl:.3e} grad_norm rel {rg:.3e}")
    want = counts(fs, slab_forward=SPATIAL_STEPS * kl, slab_backward=SPATIAL_STEPS * kl)
    coding_want = counts(fs, slab_forward=kl, slab_reverse=kl)
    skl = SERVE_EXPORT_K * PRESETS["celeba64"].glow.L  # the SPMD artifact's K*L
    serve_want = {"forward": 2 * skl, "reverse": skl}  # nll and encode; the sample
    for r, o in enumerate(ranks):
        require(o["train_launches"] == want and o["result"]["final_step"] == SPATIAL_STEPS,
                f"rank {r}: train launches {o['train_launches']}, want {want}")
        require(o["coding_launches"] == coding_want,
                f"rank {r}: encode/decode launches {o['coding_launches']}, want {coding_want}")
        require(o["z_equal"] and o["splits_equal"] and o["ld_rel"] <= 1e-6,
                f"rank {r}: sharded encode {o}")
        require(o["rec_equal"] and o["rec_err"] <= 1e-3, f"rank {r}: sharded decode {o}")
        sv = o["serve"]
        require(sv["sample_equal"] and sv["encode_equal"] and sv["nll_rel"] <= 1e-5
                and sv["launches"] == serve_want, f"rank {r}: SPMD serving {sv}")
    o = ranks[0]
    print(f"(s) 2 gloo ranks (data=1, model={SPATIAL_MODEL}, shard_spatial) from (u)'s step-0 "
          f"snapshot, {SPATIAL_STEPS} steps: {wall:.2f} s with start-up, {step_ms('s')}; "
          + "; ".join(dist_txt) + " against (u); launches per rank "
          + ", ".join(str({k: v for k, v in q["train_launches"].items() if v}) for q in ranks))
    print(f"sharded encode (b={b}) from the step-0 snapshot: z and the split halves bitwise the "
          f"unsharded chain's on every rank, logdet rel {max(q['ld_rel'] for q in ranks):.3e}; "
          f"decode(encode(x)) bitwise the unsharded one, max |x - rec| {o['rec_err']:.3e}; "
          f"launches {o['coding_launches']}")
    print(f"SPMD kernel artifact on 2 gloo ranks (data={SPMD_DATA}, {b // SPMD_DATA} rows a "
          f"rank): sample and encode bitwise the one-device artifact's, nll max rel "
          f"{max(q['serve']['nll_rel'] for q in ranks):.3e}; launches per rank "
          f"{o['serve']['launches']}; served ms (rank 0, CUDA events around each call): "
          f"{o['serve']['ms']}")
    print(f"card for these times: {card}")
    shutil.rmtree(os.path.join(out_root, "u"), ignore_errors=True)
    shutil.rmtree(os.path.join(out_root, "s"), ignore_errors=True)
    print(f"phase 23 (spatial sharding, SPMD serving): {time.perf_counter() - t_phase:.2f} s")
    return {k: o["train_launches"][k] + o["coding_launches"][k]
            for k in ("slab_forward", "slab_reverse", "slab_backward")}


def rank_spatial(argv: list[str]) -> int:
    """One rank of phase 23: `chip_smoke.py --rank-spatial gloo OUT SPEC`.
    Joins the gloo group, then (b) `cli.train.main` on SPEC's arguments,
    (c) the sharded encode and decode of the step-0 snapshot against the
    parent's unsharded ones, (d) the SPMD artifact served; each with its
    launches counted from 0, written to OUT.rank<R>.json."""
    import torch

    sys.path.insert(0, HERE)
    import torch.distributed as dist

    from pytorch_glow_tpu_torch import serve
    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.config import PRESETS, MeshConfig
    from pytorch_glow_tpu_torch.models.glow import init_glow
    from pytorch_glow_tpu_torch.ops import flowstep as fs
    from pytorch_glow_tpu_torch.parallel import distributed
    from pytorch_glow_tpu_torch.parallel import mesh as meshlib

    pin_backends(torch)
    backend, out, spec_path = argv
    with open(spec_path) as f:
        spec = json.load(f)
    require(distributed.maybe_initialize(distributed.local_device(), backend),
            "torchrun's environment is missing")
    res = {}
    try:
        fs.reset_launches()
        res["result"] = train_cli.main(spec["train"])
        torch.cuda.synchronize()
        res["train_launches"] = dict(fs.launches)

        cfg = PRESETS["celebahq256"].glow
        model = init_glow(cfg, torch.Generator().manual_seed(SEED), "cuda")
        model.load_state_dict(torch.load(spec["snapshot"], map_location="cuda",
                                         weights_only=False)["model"])
        model.set_mesh(meshlib.make_mesh(MeshConfig(1, SPATIAL_MODEL), spatial=True))
        ref = torch.load(spec["coding"], map_location="cuda", weights_only=False)
        fs.reset_launches()
        with torch.no_grad():
            z, ld, zs = model.encode(ref["x"])
            rec = model.decode(z, z_splits=zs)
        torch.cuda.synchronize()
        res["coding_launches"] = dict(fs.launches)
        res.update(z_equal=torch.equal(z, ref["z"]),
                   splits_equal=all(torch.equal(a, r) for a, r in zip(zs, ref["zs"])),
                   ld_rel=max_rel(ld, ref["ld"]), rec_equal=torch.equal(rec, ref["rec"]),
                   rec_err=float((rec - ref["x"]).abs().max()))
        del model, z, zs, rec, ref
        torch.cuda.empty_cache()

        sm = serve.load_artifact(spec["spmd"])
        one = torch.load(os.path.join(spec["spmd"], "one_device.pt"), map_location="cuda",
                         weights_only=False)
        images = one["images"]
        fs.reset_launches()
        got = {"nll": sm.nll(images), "encode": sm.encode(images),
               "sample": sm.sample(seed=SPMD_SEED, temperature=0.7)}
        torch.cuda.synchronize()
        launched = {k: v for k, v in fs.launches.items() if v}
        ms = {"nll": median_ms(lambda: sm.nll(images), torch, reps=3, inner=1),
              "sample": median_ms(lambda: sm.sample(seed=SPMD_SEED, temperature=0.7), torch,
                                  reps=3, inner=1)}
        res["serve"] = {"nll_rel": max_rel(got["nll"], one["nll"]),
                        "encode_equal": torch.equal(got["encode"], one["encode"]),
                        "sample_equal": torch.equal(got["sample"], one["sample"]),
                        "launches": launched, "ms": {k: round(v, 3) for k, v in ms.items()}}
        with open(f"{out}.rank{dist.get_rank()}.json", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def compare_nll(inf, plain_inf, images, what: str) -> None:
    """Fused-kernel nll against the unfused PyTorch layers, the repo's rtol 2e-2."""
    nll, nll_plain = inf.nll(images), plain_inf.nll(images)
    rel = float(((nll - nll_plain).abs() / nll_plain.abs()).max())
    print(f"nll fused vs unfused PyTorch path ({what}): max rel diff {rel:.3e}, "
          f"mean bits/dim {float(nll.mean()):.6f} vs {float(nll_plain.mean()):.6f}")
    require(rel <= 2e-2, f"fused nll vs plain path rel diff {rel} ({what})")


def pin_backends(torch) -> None:
    """True f32 (no TF32) and deterministic cuDNN algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def rank_cli(argv: list[str]) -> int:
    """One rank of a phase-22 launch: `chip_smoke.py --rank-cli BACKEND OUT
    ARGS [--next ARGS ...]`.  Joins the process group on BACKEND, then runs
    `cli.train.main` on each argument list in turn, the flow-step launch
    counts set to 0 just before each and written just after it, with the
    run's result, to OUT.<i>.rank<R>.json."""
    import torch

    sys.path.insert(0, HERE)
    import torch.distributed as dist

    from pytorch_glow_tpu_torch.cli import train as train_cli
    from pytorch_glow_tpu_torch.ops import flowstep as fs
    from pytorch_glow_tpu_torch.parallel import distributed

    pin_backends(torch)
    backend, out = argv[0], argv[1]
    runs, cur = [], []
    for a in argv[2:]:
        if a == "--next":
            runs.append(cur)
            cur = []
        else:
            cur.append(a)
    runs.append(cur)
    require(distributed.maybe_initialize(distributed.local_device(), backend),
            "torchrun's environment is missing")
    try:
        for i, run in enumerate(runs):
            fs.reset_launches()
            result = train_cli.main(run)
            torch.cuda.synchronize()
            with open(f"{out}.{i}.rank{dist.get_rank()}.json", "w") as f:
                json.dump({"launches": dict(fs.launches), "result": result}, f)
    finally:
        dist.destroy_process_group()
    return 0


def phases_beside(argv: list[str]) -> int:
    """Phases 19 and 22 in a process of their own: `chip_smoke.py --beside
    OUT`.  Phase 19's files go under OUT/data, then OUT/data.done marks
    them complete (phase 21 reads them); phase 22 runs under OUT/multi.
    A SIGTERM kills the rank launches under way, then this process group
    (phase 19's worker processes with it)."""
    import torch

    sys.path.insert(0, HERE)
    from pytorch_glow_tpu_torch.ops import _build
    from pytorch_glow_tpu_torch.ops import flowstep as fs

    def stop(signum, frame):
        for pid in list(_LAUNCHED):
            os.killpg(pid, signal.SIGKILL)
        os.killpg(0, signal.SIGKILL)

    signal.signal(signal.SIGTERM, stop)
    pin_backends(torch)
    _build.library()
    card, out = card_line(), argv[0]
    t0 = time.perf_counter()
    check_data(torch, fs, card, os.path.join(out, "data"))
    print(f"phase 19 (the data layer): {time.perf_counter() - t0:.2f} s", flush=True)
    open(os.path.join(out, "data.done"), "w").close()
    check_multi_device(torch, fs, card, os.path.join(out, "multi"))
    return 0


@contextlib.contextmanager
def beside(argv: list[str], log_path: str, timeout: float):
    """Runs `chip_smoke.py ARGV` in a process of its own, its output to
    `log_path`, while the body runs; then waits for it, prints its output
    and fails if it failed.  The body gets `until(path)`, which waits for
    the process to write `path` and fails if it ends first.  On an error
    in the body or a timeout the process is sent SIGTERM (then SIGKILL),
    nothing is left running and its output is printed too."""
    rc = None
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"), *argv],
                                cwd=HERE, stdout=log, stderr=subprocess.STDOUT,
                                start_new_session=True)

        def until(path: str, wait_s: float = 900.0) -> None:
            deadline = time.monotonic() + wait_s
            while not os.path.exists(path):
                require(proc.poll() is None and time.monotonic() < deadline,
                        f"{argv[0]} ended ({proc.poll()}) or timed out before writing {path}")
                time.sleep(0.5)

        try:
            yield until
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = "timeout"
        finally:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
            with open(log_path) as f:
                print(f.read(), end="")
    require(rc == 0, f"{argv[0]} exited {rc}")


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--rank-cli"]:
        return rank_cli(sys.argv[2:])
    if sys.argv[1:2] == ["--rank-spatial"]:
        return rank_spatial(sys.argv[2:])
    if sys.argv[1:2] == ["--beside"]:
        return phases_beside(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pytorch_glow_tpu_torch.ops import _build
    from pytorch_glow_tpu_torch.ops import anatomy as an
    from pytorch_glow_tpu_torch.ops import flowstep as fs
    from pytorch_glow_tpu_torch.ops import invconv_fused as icf

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    pin_backends(torch)

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s")

    results = {d: {"max_abs_err": 0.0, "ms": None, "plain_ms": None, "bound_ms": None,
                   "bound_by": None, "library_ms": None}
               for d in [*fs.launches, *icf.launches, *an.launches]}
    out_root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        return run_phases(torch, fs, icf, card, results, out_root)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)


def run_phases(torch, fs, icf, card: str, results: dict, out_root: str) -> int:
    from pytorch_glow_tpu_torch.ops import _build

    def done(what: str, since: float) -> float:
        now = time.perf_counter()
        print(f"{what}: {now - since:.2f} s")
        return now

    t0 = time.perf_counter()
    check_gemm_core(torch, fs)
    t0 = done("phase 17 (the GEMM core)", t0)
    check_kernels(torch, fs, results)
    launches = check_serving(torch, fs, card, "celeba64")
    t0 = done("phases 3-5 (celeba64 kernels and serving)", t0)

    # -- the training path ----------------------------------------------------
    check_backward(torch, fs, results)
    train_launches = check_training(torch, fs, card, os.path.join(out_root, "celeba64"),
                                    "--profile" in sys.argv[1:], eval_copy_memory=True)
    t0 = done("phases 6-7 (celeba64 backward and training)", t0)
    # Phases 19 and 22 (the data layer, multi-device training) run in a
    # process of their own beside 18, 20 and 21: all five are mostly host
    # work (CLI runs, exports, the ranks' start-up), and one after another
    # they would take most of the script's time limit.  None of them times
    # a kernel of the kernels line; 21 reads 19's files.
    with beside(["--beside", out_root], os.path.join(out_root, "beside.log"),
                timeout=900) as until:
        boundary_launches = check_boundaries(torch, fs, card,
                                             os.path.join(out_root, "boundaries"))
        print(f"phase 18 (the trainer's boundaries): {time.perf_counter() - t0:.2f} s")
        cond_launches = check_conditional(torch, fs, card, os.path.join(out_root, "conditional"))
        until(os.path.join(out_root, "data.done"))
        check_serving_artifacts(torch, fs, icf, card, os.path.join(out_root, "serving"),
                                os.path.join(out_root, "data"))
    t0 = time.perf_counter()
    check_slab(torch, fs, results)
    print(f"phase 23 (a), the slab-form kernels: {time.perf_counter() - t0:.2f} s")
    slab_launches = check_spatial(torch, fs, card, os.path.join(out_root, "spatial"),
                                  os.path.join(out_root, "serving", "spmd"))

    # -- the 256x256 path: celebahq256 ---------------------------------------
    # K1-K3 at the level shapes they run at, in the preset's (additive) coupling.
    t0 = time.perf_counter()
    hq_cases = [(BATCH, *shape) for shape in HQ_WHOLE_SHAPES]
    check_kernels(torch, fs, results, hq_cases, time_all=True, modes=("additive",))
    check_backward(torch, fs, results, hq_cases[1:], time_all=True, modes=("additive",),
                   f32_rule=True)
    check_band(torch, fs, _build.library(), results)
    hq_launches = check_serving(
        torch, fs, card, "celebahq256", want_nll=counts(fs, band_forward=32, forward=160),
        want_sample=counts(fs, band_reverse=32, reverse=160), big_batch=4 * BATCH)
    hq_train_launches = check_training(
        torch, fs, card, os.path.join(out_root, "celebahq256"), "--profile" in sys.argv[1:],
        preset="celebahq256", batch=BATCH, num_steps=2, time_steps=2,
        want=counts(fs, band_forward=32, forward=160, band_backward=64, backward=128))
    t0 = done("phases 8-11 (celebahq256)", t0)

    # -- the unfused cifar10 path: the LU 1x1 conv kernels K6a / K6b ---------
    check_invconv(torch, icf, results, card)
    invconv_launches = check_invconv_serving(torch, icf, fs, card)
    check_true_f32(torch, card)
    check_invconv_ddi(torch, icf, card)
    check_fused_permutations(torch, fs)
    cli_launches = check_invconv_training(torch, icf, card, os.path.join(out_root, "cifar10"),
                                          "--profile" in sys.argv[1:])
    t0 = done("phases 12-15 (cifar10 and the K6 kernels)", t0)

    # -- the anatomy studies S1-S3 --------------------------------------------
    anatomy_launches = check_anatomy(torch, fs, results)
    done("phase 16 (the anatomy studies)", t0)

    # Launches: each kernel's count from the main-path run that drives it:
    # K1/K2/K3 from the celeba64 train CLI run through the boundaries (18),
    # K4 from the celebahq256 serving run, K5 from the celebahq256
    # training run, K6a/K6b from the cifar10 serving run, S1-S3 from the
    # anatomy scripts' run (their other launches are checked and printed
    # above).
    print(f"serving-run launches: celeba64 {launches}")
    for d in ("forward", "reverse", "backward"):
        launches[d] = boundary_launches[d]
    for d in ("band_forward", "band_reverse"):
        launches[d] = hq_launches[d]
    launches["band_backward"] = hq_train_launches["band_backward"]
    launches.update(slab_launches)
    launches.update(invconv_launches)
    launches.update(anatomy_launches)
    print(f"training-run launches: celeba64 {train_launches}, celebahq256 {hq_train_launches}, "
          f"cifar10 train CLI (K6) {cli_launches}, imagenet64-cond train CLI {cond_launches}")
    sources = {"forward": (KERNEL_SOURCE, TPU_KERNEL), "reverse": (KERNEL_SOURCE, TPU_KERNEL),
               "backward": (BWD_SOURCE, BWD_TPU_KERNEL),
               "band_forward": (BAND_SOURCE, BAND_TPU_KERNEL),
               "band_reverse": (BAND_SOURCE, BAND_TPU_KERNEL),
               "band_backward": (BAND_BWD_SOURCE, BAND_BWD_TPU_KERNEL),
               "slab_forward": (BAND_SOURCE, BAND_TPU_KERNEL),
               "slab_reverse": (BAND_SOURCE, BAND_TPU_KERNEL),
               "slab_backward": (BAND_BWD_SOURCE, BAND_BWD_TPU_KERNEL),
               **{d: (INVCONV_SOURCE, tpu) for d, tpu in INVCONV_TPU_KERNELS.items()},
               **{d: (ANATOMY_SOURCE, tpu) for d, tpu in ANATOMY_TPU_KERNELS.items()}}
    kernels = [
        {"name": d if d.startswith(("invconv", "anatomy")) else f"flowstep_{d}", "route": "cuda",
         "source": sources[d][0], "replaces": sources[d][1], "launches": launches[d],
         **results[d]}
        for d in sources
    ]
    require(all(k["launches"] > 0 for k in kernels), f"a kernel never launched: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
