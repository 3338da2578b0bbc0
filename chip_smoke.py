#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sbmc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last:

1. device: needs a CUDA device; prints the card's name and power limit as
   ``nvidia-smi`` reports them;
2. build: compiles the CUDA kernels from ``sbmc_tpu_torch/ops/csrc`` with
   nvcc and prints the build seconds;
3. kernel: holds the fused progressive splat step against its plain
   PyTorch version on the card (k in {3, 5, 21}, odd widths, which take the
   generic kernel, and a width the tiled kernel takes, float32 and bfloat16
   logits, initial and random state, 2 and 3 channels) and at every shape
   the paths below give it; then times the tiled kernel (at both tile
   heights) and the generic one as device times (CUDA graph replay), the
   op on the host clock, and the plain version at the flagship tile
   shape (1, 3, 1080, 2048), k = 21, bf16 logits, at the default denoise
   CLI's tiles (1, 3, 512, 512) and (1, 3, 312, 512) and at the training
   shape, with each kernel's share of its bound;
4. backward kernels: holds the two kernels of the splat step's backward
   (gradient to the data, gradient to the logits, each as the vector and
   the generic kernel) against their plain version, with the running max
   of a real forward and random cotangents (k in {3, 5, 21} and 7, odd and
   vector widths, 2 and 3 channels, float32 and bfloat16 logits, the
   vector d_data kernel at every group count, and the shapes of the paths
   below); times them at the training shape (4, 3, 128, 128), k = 21, in
   both logit types, at (1, 3, 1080, 2048) in both and at (1, 3, 512, 512)
   and (1, 3, 160, 160) bf16, the vector d_data kernel at every group count
   too, beside a torch.sum of the logits;
5. reference: the flagship model on the card against the same model on the
   CPU (plain splat), on a small input, in float32 and in bfloat16 convs;
6. gradient: loss, every parameter gradient and the gradient to the input
   radiance of the flagship model (float32 convs) on the card (kernels)
   against the CPU (plain versions); the gradient to the radiance is where
   the data-gradient kernel runs inside the whole model;
7. denoise path: writes a synthetic 256x256, 4-spp frame and denoises it
   with ``sbmc_tpu_torch.denoise`` and ``weights/flagship_f16`` (full
   width: ksize 21, width 128, nsteps 3, bf16 convs) through uniform tiles;
   checks the EXR and that every sample step of every tile launched the
   forward kernel;
8. training path: writes 8 synthetic 128x128 tiles at 8 spp and runs
   ``sbmc_tpu_torch.train`` at the flagship architecture (batch 4,
   randomized sample counts) for a few steps, in float32 and with
   ``--bf16``; checks the losses, the launches of the forward and
   logits-gradient kernels (steps x spp each; the data-gradient kernel 0:
   nothing asks for the gradient to a batch input), the checkpoint and the
   CSV log, then denoises with the trained checkpoint;
9. scale: times the flagship forward on one full 1080x2048 tile at 4 spp,
   then each classical baseline on one 1080x2048 frame at 4 spp, with its
   peak device memory;
10. bench: ``sbmc_tpu_torch.bench`` in-process at its defaults (the
   flagship architecture with random weights, a 1080x1920 frame at 4 spp,
   bf16, one uniform 1080x2048 tile), then with the denoise CLI's ragged
   tiles, then KPCN; prints each JSON line and checks its keys and that the
   forward kernel launched tiles x spp times a frame (KPCN: two kernel
   weightings a tile).

11. render: the wavefront renderer's kernels (R1 ``tri_nearest``, R2
   ``tri_any``, R3 ``threefry_uniform``) and its path, in four parts:
   (a) R1 and R2, the tiled kernels and their generic variants, against
   their plain versions at 0, 64, 512 (a moving
   mesh), 1024 (the largest bucket the repo's meshes give) and 2048
   triangles (the tiled kernels' capacity) on rays that hit, miss, graze
   edges, run parallel to a face or are NaN, and the tiled kernels against
   the generic ones ray for ray; R3 bit for bit against its plain version
   and the host's numpy draws; each timed at the path's shape (a 64-pass
   wavefront of 1048576 rays), the tiled and generic R1 and R2 in turns in
   one call, and at 2048 triangles;
   (b) a 32x32 tile with meshes, image textures and an envmap rendered on
   the card and by the port on the CPU, the share of samples that differ;
   (c) ``python -m sbmc_tpu_torch.generate_training_data --renderer
   wavefront`` at the corpus configuration (2 scenes of 256x256, tiles of
   128, 8 spp, 512 ground-truth spp, the repo's 10 meshes, 14 textures and
   6 envmaps): s/scene and its split, the device's busy share over one more
   tile, the files read back, R1-R3's launches (per tile, 6, 12 and 2 per
   pass batch), R1 and R2 (tiled and generic) held against their plain
   versions on the inputs the CLI gave them; then one tile with R1-R3's
   plain versions on the card, and one at 8 to 128 passes a wavefront;
   (d) the flagship architecture trained on that corpus for 4 steps (bf16
   convs; the forward and logits-gradient kernels steps x spp times) and
   its frames denoised with the checkpoint.
12. scatter vs gather: ``python -m sbmc_tpu_torch.scatter_vs_gather`` at its
   defaults (200 steps a variant, batch 4 x 4 spp of 64x64, one channel,
   k = 3, width 32): kernel weighting, its weight gradient and
   scatter2gather first held against their plain versions at the toy's
   (16, 1, 64, 64), k = 3, float32; every splat step launches
   scatter2gather twice (forward, and backward: it is self-adjoint) and
   kernel weighting and its weight gradient once each, every gather step no
   scatter2gather; losses.csv, the strips and the ``final:`` line are
   checked, and three steps of both variants on the card agree with the
   CPU's;
13. checkpoint probes: ``python -m sbmc_tpu_torch.probe_vs_input`` on the
   corpus of 11c with the checkpoint of 11d and with
   ``weights/flagship_f16`` (4 tiles of 128x128 at 8 spp: the splat kernel
   tiles x spp times), the flagship's first tile scored on the CPU too; then
   ``python -m sbmc_tpu_torch.kernel_grids`` on 11d's checkpoint (a 64x64
   crop: 8 launches) and its PNGs;
14. microbenchmarks: ``python -m sbmc_tpu_torch.profile_kernel_weighting``
   and ``profile_scatter2gather`` at their defaults (4x3x128x128, k = 21,
   float32), with the kernels and with ``--backend plain`` (no launch), and
   ``profile_model_stages`` at its defaults (1216x768, 4 spp, width 128, k
   = 21) in bfloat16 and with ``--f32``; their lines are printed, their
   launches counted (the splat kernel at (1, 3, 1216, 768) in both logit
   types).
15. PBRT data path (after 14), with the ``pbrt`` and ``obj2pbrt``
   stand-ins of ``sbmc_tpu_torch.pbrt_stand_ins`` (test doubles: the repo
   does not hold the patched PBRTv2 or PBRT's converter): (a) scenes 0 and 1
   of the procedural generator at the datagen CLI's defaults (512x512 crops
   of a x1/2/4/8 film, 32 spp, 512 ground-truth spp, tiles of 128, the
   repo's envmaps, textures and meshes) held to the digest of the JAX
   package's (PBRT_SCENE_DIGEST); (b) ``python -m
   sbmc_tpu_torch.generate_training_data`` at those defaults, 2 scenes on 2
   threads: the seconds a scene of synthesis and of the stand-in's render,
   the folders cleaned to 16 tiles each, read back; (c) ``python -m
   sbmc_tpu_torch.render_exr`` and ``render_samples`` on scene 0; (d) the
   flagship architecture trained on (b)'s tiles for 4 steps (11d's
   settings; the forward and logits-gradient kernels steps x spp times),
   then one scene denoised with that checkpoint.

The composed kernels' phases and the other entry points run between these
(4b to 4e after 4, 6b after 6, 8b to 8i after 8; 12 after 8i, 13 after 11d,
14 after 10):

4b. composed kernels: holds kernel weighting and its gradient to the
    weights (each as the tiled kernel and the generic one) and
    scatter2gather against their plain versions (k in {3, 5, 21}, odd
    shapes, 2 and 3 channels, float32 and bfloat16 weights, a base not
    aligned to two elements, k = 7, which only the generic kernels take,
    the shapes of the paths below and a ragged 1080p KPCN tile;
    scatter2gather, vector and generic, bit-exact in both types, the vector
    kernel at every item width a row takes; the weight gradient written in
    the weights' type); times each at KPCN's training shape (4, 3, 92, 92)
    and at (1, 3, 1080, 2048), k = 21, float32 and bfloat16, the tiled
    kernels at every group count too, scatter2gather beside a copy_ of the
    same bytes;
6b. gradient, composed: ``kernel_apply(splat=True)`` and KPCN at full width
    (float32) with the buffers requiring a gradient, card against CPU: loss,
    every parameter gradient and the gradient to the buffers, which is where
    scatter2gather and kernel weighting's gradient to the data run inside a
    model;
8b. KPCN path: trains ``sbmc_tpu_torch.train --kpcn_mode`` at full width
    (depth 9, width 100, ksize 21) on the 128x128 tiles, batch 4, in float32
    and with ``--bf16``; checks losses, launches (two weightings and two
    weight gradients per step, no transpose), checkpoint and CSV log; then
    denoises the 256x256 frame with each checkpoint through
    ``sbmc_tpu_torch.denoise`` (two weightings per tile) and checks the EXR;
8c. gather path: trains ``sbmc_tpu_torch.train --gather`` at the flagship
    architecture for a few steps: every sample slot launches kernel
    weighting and its weight gradient, none the fused splat;
4c. exp kernels: holds scatter2gather_max (bit-exact, float32 and bfloat16)
    and kernel weighting of exp(logits - max) against their plain versions
    (k in {3, 5, 21}, odd shapes, 2 and 3 channels, and every shape of 4d;
    the tiled kw_exp at every group count with 1- and 2-pixel items and
    with a misaligned logits or maxes base, the generic kernel at k = 7 and
    at the small cases); times both at (1, 3, 1080, 2048) and (4, 3, 128,
    128), k = 21, on the host clock and by CUDA-graph replay, kw_exp at
    every group count and its generic variant too, beside two yardsticks:
    kw_fwd on weights of the logits' shape and type, and a torch.sum of the
    logits over their taps;
4e. channels: the splat step, its two gradients, kernel weighting, its
    weight gradient and kernel weighting of exp(logits - max) at 1, 4 and 5
    channels, which the ops run in channel groups of the kernels' 2 and 3
    (``ops.channel_groups``), against their plain versions, the launches
    counted per group; the autograd gradients of kernel weighting (c = 4)
    and of the splat step (c = 1) card against CPU;
4d. composed splat step: the step built from ``ops.scatter2gather_max`` and
    ``ops.kernel_weighting_exp`` as the JAX package's unfused branch builds
    it, held against the fused kernel (``ops.progressive_splat_update``) from
    the initial and from a random state, and both timed at (1, 3, 1080,
    2048) bf16: the path on which the two exp kernels run;
8d. LBF: two training steps and one denoise at its default window radius 8;
    it launches none of the hand-written kernels, and the run checks that;
8e. evaluation path: writes two synthetic 256x256 scenes at 4 spp and runs
    ``sbmc_tpu_torch.eval_suite`` with ``weights/flagship_f16`` and the KPCN
    (bf16) and LBF checkpoints of 8b and 8d, in ragged tiles of 160 (pad
    32), with the four classical baselines; checks the EXRs, ``metrics.csv``,
    the launches (tiles x spp of the splat kernel per scene, two kernel
    weightings per KPCN tile) and each baseline on the card against the same
    baseline on the CPU;
8f. reservoir path: ``sbmc_tpu_torch.train --device_reservoir 8
    --refresh_every 2`` at the flagship architecture on 12 tiles (8's and 4
    more), so that the feeder thread refreshes slots, in float32 and with
    ``--bf16``: the launches of 8 (steps x spp of the forward and
    logits-gradient kernels), at least one refresh, the device buffers and
    pinned staging buffers never moved, and ms/step beside the host
    loader's; then refreshes queued back to back on the card, each slot
    checked after a synchronize;
8g. decode: the native ``.bin`` decoder (``src/fastbin.cpp``) must be the
    one in use; on the 128x128 8-spp tiles it gives the pure-Python
    decoder's arrays bit for bit; both timed;
8h. checkpoint tools: ``sbmc_tpu_torch.export_params`` exports the float32
    reservoir run's checkpoint to a float16 snapshot and imports it back;
    the imported parameters are the trained ones rounded to float16, bit
    for bit; the 256x256 frame is denoised from both through the CLI, and
    in float32 the frame from the snapshot is the trained weights' rounded
    to float16 in memory, within CKPT_EVAL_RTOL;
8i. trace: ``sbmc_tpu_torch.denoise --trace`` on the 256x256 frame writes a
    Chrome trace with one ``psf_tma`` kernel event per launch.

Every path records the shapes and logit or weight types it gives the splat
step, kernel weighting and scatter2gather; the run fails if a kernel met a
shape on a path at which it was not held against its plain version, or if
any path (but the composed step's yardstick at odd widths) launched a
generic variant of the splat, kernel-weighting or scatter2gather kernels
(NEVER_ON_A_PATH). Then
one JSON line with each kernel's numbers (``launches`` by path) and, last,
the device line. Any failure raises and exits non-zero without printing a
result.
"""

import csv
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel against plain version: |kernel - plain| <= ATOL + RTOL * |plain|.
# ATOL is the JAX package's bound for its fused splat kernel against the
# composed version (tests/test_ops.py); RTOL covers float32 sums over up to
# 441 taps taken in another order (sum_w reaches hundreds at 1080x2048).
ATOL, RTOL = 2e-4, 2e-5
# The flagship model on the card against the CPU, on the same input:
# float32 convs (no TF32) differ by summation order only; bfloat16 convs
# round at other places in cuDNN and on the CPU, which moves outputs by as
# much as the JAX model's own bf16-vs-f32 drift (~1.7e-2 max, ~2.3e-3 mean).
MODEL_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (5e-2, 5e-3)}

#: (name in ops.launch_counts, source, the Pallas kernel it replaces)
_CSRC = "sbmc_tpu_torch/ops/csrc/"
KERNELS = (
    ("progressive_splat", _CSRC + "progressive_splat.cu",
     "sbmc_tpu/ops/pallas_kernels.py:535"),
    ("progressive_splat_generic", _CSRC + "progressive_splat.cu",
     "sbmc_tpu/ops/pallas_kernels.py:535"),
    ("progressive_splat_ddata", _CSRC + "progressive_splat_bwd.cu",
     "sbmc_tpu/ops/pallas_kernels.py:728"),
    ("progressive_splat_ddata_generic", _CSRC + "progressive_splat_bwd.cu",
     "sbmc_tpu/ops/pallas_kernels.py:728"),
    ("progressive_splat_dlogits", _CSRC + "progressive_splat_bwd.cu",
     "sbmc_tpu/ops/pallas_kernels.py:755"),
    ("progressive_splat_dlogits_generic", _CSRC + "progressive_splat_bwd.cu",
     "sbmc_tpu/ops/pallas_kernels.py:755"),
    ("kernel_weighting", _CSRC + "kernel_weighting.cu",
     "sbmc_tpu/ops/pallas_kernels.py:151"),
    ("kernel_weighting_generic", _CSRC + "kernel_weighting.cu",
     "sbmc_tpu/ops/pallas_kernels.py:151"),
    ("kernel_weighting_dw", _CSRC + "kernel_weighting.cu",
     "sbmc_tpu/ops/pallas_kernels.py:321"),
    ("kernel_weighting_dw_generic", _CSRC + "kernel_weighting.cu",
     "sbmc_tpu/ops/pallas_kernels.py:321"),
    ("scatter2gather", _CSRC + "scatter2gather.cu",
     "sbmc_tpu/ops/pallas_kernels.py:393"),
    ("scatter2gather_generic", _CSRC + "scatter2gather.cu",
     "sbmc_tpu/ops/pallas_kernels.py:393"),
    ("scatter2gather_max", _CSRC + "scatter2gather.cu",
     "sbmc_tpu/ops/pallas_kernels.py:419"),
    ("kernel_weighting_exp", _CSRC + "kernel_weighting.cu",
     "sbmc_tpu/ops/pallas_kernels.py:232"),
    ("kernel_weighting_exp_generic", _CSRC + "kernel_weighting.cu",
     "sbmc_tpu/ops/pallas_kernels.py:232"),
    # The renderer's kernels have no Pallas counterpart: they replace the
    # JAX renderer's triangle test (_tri_ts, reduced by _intersect's argmin
    # and by _occluded's any) and its jax.random draws.
    ("tri_nearest", _CSRC + "trace_hits.cu",
     "sbmc_tpu/render/pathtracer.py:679"),
    ("tri_nearest_generic", _CSRC + "trace_hits.cu",
     "sbmc_tpu/render/pathtracer.py:679"),
    ("tri_any", _CSRC + "trace_hits.cu",
     "sbmc_tpu/render/pathtracer.py:886"),
    ("tri_any_generic", _CSRC + "trace_hits.cu",
     "sbmc_tpu/render/pathtracer.py:886"),
    ("threefry_uniform", _CSRC + "threefry.cu",
     "sbmc_tpu/render/pathtracer.py:1104"),
)
#: The paths on which a kernel must have launched. The data-gradient kernel
#: lies on neither main path by nature (its gradient goes to a batch input,
#: which nothing asks for): the gradient phase runs it inside the model.
#: Likewise scatter2gather: KPCN and the gather model predict gather kernels,
#: so only the composed gradient phase (splat kernels through
#: ``kernel_apply``, and every backward to the data), the scatter-vs-gather
#: experiment's splat variant (the first training path that transposes) and
#: the op profiles transpose any. The two exp kernels run where the op API
#: composes them into the splat step.
MUST_LAUNCH = {
    "progressive_splat": ("denoise", "train", "train_bf16", "gradient",
                          "eval", "reservoir", "reservoir_bf16",
                          "checkpoint_tools", "trace", "bench",
                          "bench_ragged", "render_train", "render_denoise",
                          "probe_vs_input", "probe_vs_input_flagship",
                          "kernel_grids", "profile_model_stages",
                          "profile_model_stages_f32", "pbrt_train",
                          "pbrt_denoise"),
    "progressive_splat_ddata": ("gradient",),
    "progressive_splat_dlogits": ("train", "train_bf16", "gradient",
                                  "reservoir", "reservoir_bf16",
                                  "render_train", "pbrt_train"),
    "kernel_weighting": ("kpcn_train", "kpcn_train_bf16", "kpcn_denoise",
                         "gather_train", "gradient_composed", "eval",
                         "bench_kpcn", "scatter_vs_gather",
                         "profile_kernel_weighting"),
    "kernel_weighting_dw": ("kpcn_train", "kpcn_train_bf16", "gather_train",
                            "gradient_composed", "scatter_vs_gather",
                            "profile_kernel_weighting"),
    "scatter2gather": ("gradient_composed", "scatter_vs_gather",
                       "profile_kernel_weighting", "profile_scatter2gather"),
    "scatter2gather_max": ("composed_step",),
    "kernel_weighting_exp": ("composed_step",),
    "progressive_splat_generic": (),
    "progressive_splat_ddata_generic": (),
    "progressive_splat_dlogits_generic": (),
    "kernel_weighting_generic": (),
    "kernel_weighting_dw_generic": (),
    "scatter2gather_generic": (),
    "kernel_weighting_exp_generic": (),
    "tri_nearest": ("render",),
    "tri_nearest_generic": (),
    "tri_any": ("render",),
    "tri_any_generic": (),
    "threefry_uniform": ("render",),
}
#: The generic variants of the splat, kernel-weighting (plain and exp),
#: scatter2gather and triangle kernels (the first port's per-pixel,
#: per-element or per-ray kernels) take only shapes the tiled kernels cannot
#: address, which no path gives them: the kernel phases check them there and
#: at the paths' shapes, and the run fails if any path launched one.
NEVER_ON_A_PATH = ("progressive_splat_generic",
                   "progressive_splat_ddata_generic",
                   "progressive_splat_dlogits_generic",
                   "kernel_weighting_generic", "kernel_weighting_dw_generic",
                   "scatter2gather_generic", "kernel_weighting_exp_generic",
                   "tri_nearest_generic", "tri_any_generic")
#: The wrapped op whose recorded cases speak for each kernel.
_OP_OF = {"progressive_splat": "splat", "progressive_splat_ddata": "splat",
          "progressive_splat_ddata_generic": "splat",
          "progressive_splat_dlogits": "splat",
          "progressive_splat_generic": "splat",
          "progressive_splat_dlogits_generic": "splat",
          "kernel_weighting": "kw", "kernel_weighting_generic": "kw",
          "kernel_weighting_dw": "kw", "kernel_weighting_dw_generic": "kw",
          "scatter2gather": "s2g", "scatter2gather_generic": "s2g",
          "scatter2gather_max": "s2g_max", "kernel_weighting_exp": "kw_exp",
          "kernel_weighting_exp_generic": "kw_exp"}

#: (bs, c, h, w, logit type) the paths give the splat step, k = 21: the
#: denoise path's tile, a training batch in float32 and with --bf16 (from
#: the host loader or the reservoir), a frame denoised with the trained
#: checkpoint, the gradient phase's input, the evaluation path's ragged
#: tiles of a 256x256 frame (160 and 64 px sides), and the bench's 1080x1920
#: frame: one uniform tile of 1080x2048, or the denoise CLI's ragged tiles
#: (512 and 312 rows, 512 and 384 columns); the stage profile's 1216x768
#: strip in both logit types (phase 14). The probes' tiles and crop (phase
#: 13) are the 128x128 and 64x64 bf16 entries. The kernel phases compare at
#: each; _check_shapes holds the paths to it.
PATH_SHAPES = (
    (1, 3, 160, 160, torch.bfloat16),
    (4, 3, 128, 128, torch.float32),
    (4, 3, 128, 128, torch.bfloat16),
    (1, 3, 128, 128, torch.bfloat16),
    (1, 3, 48, 48, torch.float32),
    (1, 3, 160, 64, torch.bfloat16),
    (1, 3, 64, 160, torch.bfloat16),
    (1, 3, 64, 64, torch.bfloat16),
    (1, 3, 1080, 2048, torch.bfloat16),
    (1, 3, 512, 512, torch.bfloat16),
    (1, 3, 512, 384, torch.bfloat16),
    (1, 3, 312, 512, torch.bfloat16),
    (1, 3, 312, 384, torch.bfloat16),
    (1, 3, 1216, 768, torch.bfloat16),
    (1, 3, 1216, 768, torch.float32),
)
#: (bs, c, h, w, weight type) the paths give kernel weighting, k = 21: a
#: KPCN training batch of 128x128 tiles less the 36 px the valid convs take
#: (float32, and bfloat16 kernels with --bf16), a KPCN tile of the denoised
#: frame (160 less 36) from either checkpoint, a gather-model training batch
#: (its weights are exp(logits - max), float32), and the composed gradient
#: phase's KPCN tile (64 less 36) and kernel_apply input, the
#: evaluation path's ragged KPCN tiles (bf16 checkpoint; 160 and 64 px
#: sides less 36), and the KPCN bench's tile (1160x2000 less 36, bf16). The
#: gather-model batch is also the op profiles' shape (phase 14: kernel
#: weighting, its gradients and scatter2gather at 4x3x128x128, k = 21).
KW_PATH_SHAPES = (
    (4, 3, 92, 92, torch.float32),
    (4, 3, 92, 92, torch.bfloat16),
    (1, 3, 124, 124, torch.float32),
    (1, 3, 124, 124, torch.bfloat16),
    (4, 3, 128, 128, torch.float32),
    (1, 3, 28, 28, torch.float32),
    (2, 3, 37, 53, torch.float32),
    (1, 3, 124, 28, torch.bfloat16),
    (1, 3, 28, 124, torch.bfloat16),
    (1, 3, 28, 28, torch.bfloat16),
    (1, 3, 1124, 1964, torch.bfloat16),
)
#: (bs, c, h, w, k, logit type) at which phase 4d composes the splat step
#: from the two exp kernels, each from the initial and from a random state:
#: odd shapes, both channel counts, and the flagship tile of 1080x2048 last
#: (the one it times). Phase 4c compares both kernels at each.
STEP_SHAPES = (
    (2, 3, 37, 53, 3, torch.float32),
    (2, 3, 130, 3, 5, torch.bfloat16),
    (2, 2, 5, 7, 21, torch.bfloat16),
    (4, 3, 128, 128, 21, torch.float32),
    (1, 3, 1080, 2048, 21, torch.bfloat16),
)
#: kernel -> {(data shape, k2, logit or weight type)} held against the plain
#: version. scatter2gather sees no data: its cases carry (bs, h, w).
_COMPARED = {name: set() for name, _, _ in KERNELS}
#: kernel -> its largest abs error against the plain version so far.
_MAX_ERR = {}
#: training run -> (median, min, max) ms of its steps after the first.
_STEP_MS = {}

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12      # float32 outside the tensor cores


def _device_phase():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    print(smi[0])


def _time_ms(fn, warmup, iters):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters=20, reps=5):
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph
    and replayed ``reps`` times between two events, so the host's cost per
    call (the wrappers' Python, tens of microseconds) does not hide a kernel
    that takes less."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def _bound(nbytes, flops):
    by_bytes = nbytes / H100_BYTES_PER_S
    by_ops = flops / H100_F32_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def _splat_inputs(gen, bs, c, h, w, k, dtype, init):
    """The splat step's inputs, drawn on the card from ``gen``: data, logits
    (3x a standard normal, in ``dtype``) and the initial state (``max_w =
    -1e30``) or a random one."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    data, logits = randn(bs, c, h, w), (3 * randn(bs, k * k, h, w)).to(dtype)
    if init:
        state = (torch.zeros(bs, c, h, w, device="cuda"),
                 torch.zeros(bs, 1, h, w, device="cuda"),
                 torch.full((bs, 1, h, w), -1e30, device="cuda"))
    else:
        state = (randn(bs, c, h, w), randn(bs, 1, h, w).abs(),
                 randn(bs, 1, h, w))
    return (data, logits) + state


def _case(data, logits):
    return tuple(data.shape), logits.shape[1], str(logits.dtype)


def _variant(ops, name, logits):
    """The splat kernel that ``logits`` are dispatched to: ``name``
    (``progressive_splat``, ``progressive_splat_ddata`` or
    ``progressive_splat_dlogits``, the tiled kernels) or its generic
    variant."""
    route = ops.splat_route(logits.shape[-1],
                            ops.reference.ksize_of(logits),
                            logits.element_size())
    return name if route == "tiled" else name + "_generic"


def _note_err(name, err):
    _MAX_ERR[name] = max(_MAX_ERR.get(name, 0.0), err)


def _s2g_case(weights):
    bs, k2, h, w = weights.shape
    return (bs, h, w), k2, str(weights.dtype)


class _record_shapes:
    """While active, notes every case the models give the splat step
    (``seen["splat"]``), kernel weighting (``seen["kw"]``), scatter2gather
    (``seen["s2g"]``) and the two exp ops (``seen["s2g_max"]``,
    ``seen["kw_exp"]``) on the card. The calls themselves go through
    unchanged."""

    def __init__(self, ops):
        self.ops = ops
        self.seen = {"splat": set(), "kw": set(), "s2g": set(),
                     "s2g_max": set(), "kw_exp": set()}

    def __enter__(self):
        ops, seen = self.ops, self.seen
        self.plain = (ops.progressive_splat_update, ops.kernel_weighting,
                      ops.scatter2gather, ops.scatter2gather_max,
                      ops.kernel_weighting_exp)
        splat, kw, s2g, s2g_max, kw_exp = self.plain

        def rec_splat(data, klogits, *state):
            if data.is_cuda:
                seen["splat"].add(_case(data, klogits))
            return splat(data, klogits, *state)

        def rec_kw(data, weights):
            if data.is_cuda:
                seen["kw"].add(_case(data, weights))
            return kw(data, weights)

        def rec_s2g(weights):
            if weights.is_cuda:
                seen["s2g"].add(_s2g_case(weights))
            return s2g(weights)

        def rec_s2g_max(weights):
            if weights.is_cuda:
                seen["s2g_max"].add(_s2g_case(weights))
            return s2g_max(weights)

        def rec_kw_exp(data, logits, maxes):
            if data.is_cuda:
                seen["kw_exp"].add(_case(data, logits))
            return kw_exp(data, logits, maxes)

        ops.progressive_splat_update = rec_splat
        ops.kernel_weighting = rec_kw
        ops.scatter2gather = rec_s2g
        ops.scatter2gather_max = rec_s2g_max
        ops.kernel_weighting_exp = rec_kw_exp
        return seen

    def __exit__(self, *exc):
        (self.ops.progressive_splat_update, self.ops.kernel_weighting,
         self.ops.scatter2gather, self.ops.scatter2gather_max,
         self.ops.kernel_weighting_exp) = self.plain


def _check_shapes(path, seen, kernels):
    """Fails if the path did not reach the op of one of ``kernels``, or met
    a case at which that kernel was not compared with its plain version."""
    for name in kernels:
        cases = seen[_OP_OF[name]]
        if not cases:
            raise AssertionError("the %s path never reached the op of %s"
                                 % (path, name))
        missing = cases - _COMPARED[name]
        if missing:
            raise AssertionError(
                "%s ran on the %s path at %s, where it was not held against "
                "its plain version" % (name, path, sorted(missing)))


def _nonzero(counts):
    return {name: n for name, n in counts.items() if n}


def _compare(ops, args, tile_h=None):
    """Max abs error of one splat step through the op (the kernel and tile
    height the paths would take), or through the tiled kernel at ``tile_h``
    rows; raises beyond the tolerance."""
    name = _variant(ops, "progressive_splat", args[1])
    if tile_h is None:
        _COMPARED[name].add(_case(*args[:2]))
        got = ops.progressive_splat_update(*args)
    else:
        got = ops._progressive_splat_cuda(*args, route="tiled",
                                          tile_h=tile_h)
    want = ops.progressive_splat_update_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for g, r in zip(got, want):
        if not bool(torch.all((g - r).abs() <= ATOL + RTOL * r.abs())):
            raise AssertionError(
                "splat kernel disagrees with its plain version: max abs "
                "err %.3g" % float((g - r).abs().max()))
        err = max(err, float((g - r).abs().max()))
    _note_err(name, err)
    return err


def _share(ms, bound_ms):
    return "%.0f%% of bound" % (100 * bound_ms / ms)


def _kernel_phase(ops, main_tile):
    rng = torch.Generator(device="cuda").manual_seed(0)
    err = 0.0
    cases = 0
    for k in (3, 5, 21):
        for hw in ((37, 53), (130, 3), (5, 7)):
            for dtype in (torch.float32, torch.bfloat16):
                for init in (True, False):
                    args = _splat_inputs(rng, 2, 3, *hw, k, dtype, init)
                    err = max(err, _compare(ops, args))
                    cases += 1
    # Those widths take the generic kernel; the same at a width the tiled
    # kernel takes (64 pixels: 256- and 128-byte rows; 37 rows: ragged
    # tiles). Then two channels (the kernels' other template instance) on
    # both, and every shape the paths give the kernel, from the initial
    # state (a frame's first sample) and from a random one.
    for k in (3, 5, 21):
        for dtype in (torch.float32, torch.bfloat16):
            for init in (True, False):
                args = _splat_inputs(rng, 2, 3, 37, 64, k, dtype, init)
                err = max(err, _compare(ops, args))
                cases += 1
    for hw in ((37, 53), (37, 64)):
        args = _splat_inputs(rng, 2, 2, *hw, 21, torch.bfloat16, False)
        err = max(err, _compare(ops, args))
        cases += 1
    for bs, c, h, w, dtype in PATH_SHAPES:
        for init in (True, False):
            args = _splat_inputs(rng, bs, c, h, w, 21, dtype, init)
            err = max(err, _compare(ops, args))
            cases += 1
    # Each tile height of the tiled kernel at every k, logit type and
    # channel count, whichever height splat_tile_rows would pick here.
    for tile_h in (8, 16):
        for k in (3, 5, 21):
            for dtype in (torch.float32, torch.bfloat16):
                for c in (2, 3):
                    args = _splat_inputs(rng, 2, c, 37, 64, k, dtype, False)
                    err = max(err, _compare(ops, args, tile_h))
                    cases += 1
    print("kernel check: %d cases (%d shapes on the tiled kernel, %d on the "
          "generic one), max abs err tiled %.3g, generic %.3g (tolerance "
          "%.0e + %.0e * |plain|)" % (
              cases, len(_COMPARED["progressive_splat"]),
              len(_COMPARED["progressive_splat_generic"]),
              _MAX_ERR["progressive_splat"],
              _MAX_ERR["progressive_splat_generic"], ATOL, RTOL))
    args = _splat_inputs(rng, 1, 3, *main_tile, 21, torch.bfloat16, False)
    print("kernel time at the main path's tile (1, 3, %d, %d), k=21, bf16: "
          "%.4f ms through the op, %.4f ms on the device" % (
              *main_tile,
              _time_ms(lambda: ops.progressive_splat_update(*args), 3, 50),
              _graph_ms(lambda: ops._progressive_splat_cuda(*args))))

    # Times: the flagship tile (1080x2048, k = 21, bf16 logits, bs 1, 3
    # channels), the default denoise CLI's tiles (512x512, and 312x512 at a
    # 1080p frame's bottom edge), then a training batch in both logit types.
    # "ms" is the host clock (events around 20 calls) through the op, as for
    # every kernel of this script; "device_ms" the device time alone
    # (_graph_ms), which at the small shapes is below the wrappers' Python.
    # The generic kernel runs beside the tiled one at each shape (its "ms"
    # through its wrapper), and the tiled kernel at the tile height
    # splat_tile_rows did not choose, each checked before it is timed.
    rows, generic_rows = [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (bs, c, h, w), dtype in (((1, 3, 1080, 2048), torch.bfloat16),
                                 ((1, 3, 512, 512), torch.bfloat16),
                                 ((1, 3, 312, 512), torch.bfloat16),
                                 ((4, 3, 128, 128), torch.float32),
                                 ((4, 3, 128, 128), torch.bfloat16)):
        args = _splat_inputs(rng, bs, c, h, w, 21, dtype, False)
        err = max(err, _compare(ops, args))
        tile_h = ops.splat_tile_rows(bs, h, w, sms)
        other_h = 24 - tile_h  # the other of 8 and 16
        want = ops.progressive_splat_update_ref(*args)
        for name, got in (
                ("progressive_splat", ops._progressive_splat_cuda(
                    *args, route="tiled", tile_h=other_h)),
                ("progressive_splat_generic", ops._progressive_splat_cuda(
                    *args, route="generic"))):
            for g, r in zip(got, want):
                if not bool(torch.all((g - r).abs()
                                      <= ATOL + RTOL * r.abs())):
                    raise AssertionError(
                        "%s disagrees with its plain version at %s" % (
                            name, _case(*args[:2])))
                _note_err(name, float((g - r).abs().max()))
        del got, want
        ms = _time_ms(lambda: ops.progressive_splat_update(*args), 3, 20)
        device_ms = _graph_ms(lambda: ops._progressive_splat_cuda(*args))
        other_ms = _graph_ms(lambda: ops._progressive_splat_cuda(
            *args, route="tiled", tile_h=other_h))
        generic_ms = _time_ms(lambda: ops._progressive_splat_cuda(
            *args, route="generic"), 3, 20)
        generic_device_ms = _graph_ms(lambda: ops._progressive_splat_cuda(
            *args, route="generic"))
        plain_ms = _time_ms(
            lambda: ops.progressive_splat_update_ref(*args), 1, 3)
        px = bs * h * w
        logits_bytes = args[1].numel() * args[1].element_size()
        # Each input read once (data, logits, three state planes), each
        # output written once (three state planes); per tap a subtract, an
        # exp, an add to sum_w and one FMA per channel.
        nbytes = logits_bytes + px * 4 * (c + (c + 2) + (c + 2))
        bound_ms, by = _bound(nbytes, px * 21 * 21 * (3 + 2 * c))
        tag = "%dx%dx%dx%d %s" % (bs, c, h, w,
                                  str(dtype).replace("torch.", ""))
        print("kernel time at (%s), k=21: tiled %.4f ms through the op (%s), "
              "%.4f ms on the device (%s; %d-row tiles; %d-row tiles %.4f "
              "ms); generic %.4f ms through its wrapper (%s), %.4f ms on the "
              "device (%s); plain version %.4f ms; bound %.4f ms (%s: %.4g "
              "GB, logits alone %.4f ms)" % (
                  tag, ms, _share(ms, bound_ms), device_ms,
                  _share(device_ms, bound_ms), tile_h, other_h, other_ms,
                  generic_ms, _share(generic_ms, bound_ms),
                  generic_device_ms, _share(generic_device_ms, bound_ms),
                  plain_ms, bound_ms, by, nbytes / 1e9,
                  logits_bytes / H100_BYTES_PER_S * 1e3))
        rows.append({"shape": tag, "ms": ms, "device_ms": device_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": by, "tile_rows": tile_h,
                     "other_tile_rows_device_ms": other_ms})
        generic_rows.append({"shape": tag, "ms": generic_ms,
                             "device_ms": generic_device_ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": by})
        del args
        torch.cuda.empty_cache()
    return {
        "progressive_splat": dict(rows[0], max_abs_err=_MAX_ERR[
            "progressive_splat"], other_shapes=rows[1:]),
        "progressive_splat_generic": dict(generic_rows[0], max_abs_err=_MAX_ERR[
            "progressive_splat_generic"], other_shapes=generic_rows[1:])}

# Backward kernels against their plain version: the absolute part is the JAX
# package's bound for its fused backward against the composed version
# (tests/test_ops.py); a bfloat16 gradient may also sit on the neighbouring
# bfloat16 value (2**-7 relative).
BWD_ATOL, BWD_RTOL, BF16_RTOL = 3e-4, 2e-5, 2.0 ** -7
# Flagship gradients on the card against the CPU, float32 convs, per tensor:
# |card - cpu| <= GRAD_RTOL * max|cpu| + GRAD_ATOL (float32 sums in another
# order through three U-Nets, the 441-tap splat and their backward).
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-7


def _bwd_inputs(ops, rng, bs, c, h, w, k, dtype):
    """Inputs of the backward kernels: data, logits, the running max of a
    real forward from a random state (so every exponent is <= 0) and random
    cotangents."""
    data, logits, sr, sw, mw = _splat_inputs(rng, bs, c, h, w, k, dtype,
                                             False)
    new_max = ops.progressive_splat_update(data, logits, sr, sw, mw)[2]
    d_r = torch.randn(bs, c, h, w, device="cuda", generator=rng)
    d_w = torch.randn(bs, 1, h, w, device="cuda", generator=rng)
    return data, logits, new_max, d_r, d_w


def _compare_bwd(ops, inputs):
    """Max abs error of (d_data, d_logits); raises beyond the tolerance."""
    data, logits, new_max, d_r, d_w = inputs
    names = (_variant(ops, "progressive_splat_ddata", logits),
             _variant(ops, "progressive_splat_dlogits", logits))
    for name in names:
        _COMPARED[name].add(_case(data, logits))
    got = (ops._ddata_cuda(logits, new_max, d_r),
           ops._dlogits_cuda(data, logits, new_max, d_r, d_w))
    want = ops.progressive_splat_bwd_ref(data, logits, new_max, d_r, d_w)
    torch.cuda.synchronize()
    if got[1].dtype != logits.dtype or got[0].dtype != torch.float32:
        raise AssertionError("backward kernels returned %s / %s" % (
            got[0].dtype, got[1].dtype))
    rtols = (BWD_RTOL, BF16_RTOL if logits.dtype == torch.bfloat16
             else BWD_RTOL)
    errs = []
    for name, kernel, g, r, rt in zip(("d_data", "d_logits"), names, got,
                                      want, rtols):
        g, r = g.float(), r.float()
        if not bool(torch.all((g - r).abs() <= BWD_ATOL + rt * r.abs())):
            raise AssertionError(
                "%s kernel %s disagrees with its plain version: max abs err "
                "%.3g" % (name, kernel, float((g - r).abs().max())))
        errs.append(float((g - r).abs().max()))
        _note_err(kernel, errs[-1])
    return errs


def _by_groups(counts, fn_of, graph_iters=20):
    """Device time at each group count (``fn_of(g)`` -> a call), the best of
    two turns over the counts."""
    turns = [[_graph_ms(fn_of(g), graph_iters) for g in counts]
             for _ in range(2)]
    return {g: min(t) for g, t in zip(counts, zip(*turns))}


def _time_bwd(ops, inputs, plain_iters):
    """[(kernel, ms, plain ms, bound ms, bound by, device ms, extra)] on
    these inputs: ``ms`` on the host clock (events around 20 calls through
    the wrapper), ``device_ms`` by CUDA-graph replay; the vector d_data
    kernel's ``extra`` holds the group count the route picks, the device
    time at every group count and a yardstick."""
    data, logits, new_max, d_r, d_w = inputs
    bs, c, h, w = data.shape
    k2 = logits.shape[1]
    k = int(round(k2 ** 0.5))
    px = bs * h * w
    size = logits.element_size()
    lbytes = logits.numel() * size
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def add(name, fn, plain_ms, bound, extra=dict):
        rows.append((name, _time_ms(fn, 3, 20), plain_ms) + bound
                    + (_graph_ms(fn), extra()))

    # d_data: reads the logits, the max plane and c cotangent planes, writes
    # c planes; per tap a subtract, an exp and one FMA per channel. Its
    # yardstick of the reachable read rate: torch.sum over the logits' tap
    # dimension (the same bytes read, a float32 plane written).
    plain_ms = _time_ms(lambda: ops.reference.progressive_splat_ddata_ref(
        logits, new_max, d_r), 1, plain_iters)
    bound = _bound(lbytes + px * 4 * (1 + 2 * c), px * k2 * (2 + 2 * c))
    groups = ops.ddata_groups(bs, h, w, k, size, sms)

    def ddata_at(g):
        return lambda: ops._ddata_cuda(logits, new_max, d_r, "tiled", g)

    add("progressive_splat_ddata",
        lambda: ops._ddata_cuda(logits, new_max, d_r), plain_ms, bound,
        lambda: {"groups": groups,
                 "device_ms_by_groups": _by_groups(
                     [g for g in (1, 2, 4, 8) if g <= k], ddata_at),
                 "logits_sum_device_ms": _graph_ms(
                     lambda: logits.sum(1, dtype=torch.float32))})
    add("progressive_splat_ddata_generic",
        lambda: ops._ddata_cuda(logits, new_max, d_r, "generic"), plain_ms,
        bound)
    # d_logits: reads the logits, data, max and the c + 1 cotangent planes,
    # writes a gradient of the logits' size and type; per tap a subtract, an
    # exp, c FMAs and a multiply. The vector kernel, then the generic one.
    plain_ms = _time_ms(lambda: ops.reference.progressive_splat_dlogits_ref(
        data, logits, new_max, d_r, d_w), 1, plain_iters)
    bound = _bound(2 * lbytes + px * 4 * (2 + 2 * c), px * k2 * (3 + 2 * c))
    for name, route in (("progressive_splat_dlogits", "tiled"),
                        ("progressive_splat_dlogits_generic", "generic")):
        add(name, lambda: ops._dlogits_cuda(data, logits, new_max, d_r, d_w,
                                            route=route), plain_ms, bound)
    return rows


def _record_times(numbers, name, tag, ms, plain_ms, bound_ms, by,
                  device_ms=None, **extra):
    """Prints one kernel's times at one shape and files them in
    ``numbers[name]``: the first shape is the main path's, the others go
    under ``other_shapes``. ``ms`` is on the host clock; ``device_ms``, where
    given, the device time alone; ``extra`` goes into the row as it is."""
    device = "" if device_ms is None else ", %.4f ms on the device, %s" % (
        device_ms, _share(device_ms, bound_ms))
    print("%s at (%s), k=21: %.4f ms, %s%s; plain version %.4f ms; bound "
          "%.4f ms (%s)%s" % (name, tag, ms, _share(ms, bound_ms), device,
                              plain_ms, bound_ms, by,
                              "; " + json.dumps(extra) if extra else ""))
    entry = numbers.setdefault(name, {"other_shapes": []})
    row = dict(extra, shape=tag, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=by)
    if device_ms is not None:
        row["device_ms"] = device_ms
    if "ms" not in entry:
        entry.update(row)
    else:
        entry["other_shapes"].append(row)


def _check_ddata(ops, inputs, route, groups=None):
    """Holds the d_data kernel of ``route`` (the vector one at ``groups``
    groups) against the plain version."""
    data, logits, new_max, d_r, _ = inputs
    name = "progressive_splat_ddata" + ("" if route == "tiled"
                                        else "_generic")
    _COMPARED[name].add(_case(data, logits))
    got = ops._ddata_cuda(logits, new_max, d_r, route, groups)
    want = ops.reference.progressive_splat_ddata_ref(logits, new_max, d_r)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    if got.dtype != torch.float32 or not bool(
            torch.all(diff <= BWD_ATOL + BWD_RTOL * want.abs())):
        raise AssertionError(
            "d_data kernel %s (groups %s) disagrees with its plain version "
            "at %s: max abs err %.3g" % (
                name, groups, _case(data, logits), float(diff.max())))
    _note_err(name, float(diff.max()))


def _bwd_kernel_phase(ops):
    rng = torch.Generator(device="cuda").manual_seed(1)
    cases = 0
    # Odd widths (the generic kernels), then widths the vector kernels take
    # (64: whole 16-byte vectors in both types; 37 rows: ragged tiles), k =
    # 7 at such a width (only the generic kernels take it), then every shape
    # the paths give the kernels.
    for k in (3, 5, 21):
        for c, hw in ((3, (37, 53)), (3, (130, 3)), (2, (5, 7)),
                      (3, (37, 64)), (2, (13, 8))):
            for dtype in (torch.float32, torch.bfloat16):
                _compare_bwd(ops, _bwd_inputs(ops, rng, 2, c, *hw, k, dtype))
                cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        _compare_bwd(ops, _bwd_inputs(ops, rng, 2, 3, 37, 64, 7, dtype))
        cases += 1
    for bs, c, h, w, dtype in PATH_SHAPES:
        _compare_bwd(ops, _bwd_inputs(ops, rng, bs, c, h, w, 21, dtype))
        cases += 1
    # The vector d_data kernel at every group count, at every k, logit type
    # and channel count (37x64: ragged tiles; 21x40: a row narrower than a
    # tile), whatever the route would pick; the generic kernel at the same
    # shapes.
    for k in (3, 5, 21):
        for dtype in (torch.float32, torch.bfloat16):
            for c, hw in ((2, (37, 64)), (3, (37, 64)), (3, (21, 40))):
                inputs = _bwd_inputs(ops, rng, 2, c, *hw, k, dtype)
                for g in [g for g in (1, 2, 4, 8) if g <= k]:
                    _check_ddata(ops, inputs, "tiled", g)
                    cases += 1
                _check_ddata(ops, inputs, "generic")
                cases += 1
    print("backward kernel check: %d cases, max abs err d_data vector %.3g, "
          "generic %.3g, d_logits vector %.3g, generic %.3g (tolerance %.0e "
          "+ %.0e * |plain|; bf16 d_logits %.0e + 2^-7 * |plain|)" % (
              cases, _MAX_ERR["progressive_splat_ddata"],
              _MAX_ERR["progressive_splat_ddata_generic"],
              _MAX_ERR["progressive_splat_dlogits"],
              _MAX_ERR["progressive_splat_dlogits_generic"], BWD_ATOL,
              BWD_RTOL, BWD_ATOL))
    numbers = {}
    # The training path's shape (batch 4 of 128x128 tiles, k = 21) in both
    # logit types, then one full 1080x2048 tile in both, then the default
    # denoise CLI's 512x512 tile and the smoke's denoise tile (160x160, the
    # most groups); vector and generic kernels in the same run, each checked
    # first.
    for shape, dtype, iters in (((4, 3, 128, 128), torch.float32, 3),
                                ((4, 3, 128, 128), torch.bfloat16, 3),
                                ((1, 3, 1080, 2048), torch.bfloat16, 2),
                                ((1, 3, 1080, 2048), torch.float32, 2),
                                ((1, 3, 512, 512), torch.bfloat16, 2),
                                ((1, 3, 160, 160), torch.bfloat16, 3)):
        inputs = _bwd_inputs(ops, rng, *shape, 21, dtype)
        _compare_bwd(ops, inputs)
        _check_ddata(ops, inputs, "generic")
        generic = ops._dlogits_cuda(*inputs, route="generic")
        want = ops.reference.progressive_splat_dlogits_ref(*inputs)
        rt = BF16_RTOL if dtype == torch.bfloat16 else BWD_RTOL
        g, r = generic.float(), want.float()
        if not bool(torch.all((g - r).abs() <= BWD_ATOL + rt * r.abs())):
            raise AssertionError("generic d_logits kernel disagrees with its "
                                 "plain version")
        _note_err("progressive_splat_dlogits_generic",
                  float((g - r).abs().max()))
        del generic, want, g, r
        tag = "%s %s" % ("x".join(map(str, shape)),
                         str(dtype).replace("torch.", ""))
        for name, *times, extra in _time_bwd(ops, inputs, iters):
            _record_times(numbers, name, tag, *times, **extra)
        del inputs
        torch.cuda.empty_cache()
    for name in numbers:
        numbers[name]["max_abs_err"] = _MAX_ERR[name]
    return numbers


def _gradient_phase(ops, checkpoint):
    """Loss and gradients of the flagship model (float32 convs) on the card,
    through the three kernels, against the CPU's plain versions. Returns the
    card's launch counts."""
    from sbmc_tpu_torch import losses
    from sbmc_tpu_torch.models.build import build_model
    from sbmc_tpu_torch.params import load_jax_params
    from sbmc_tpu_torch.train.checkpointer import Checkpointer
    from sbmc_tpu_torch.utils.image import crop_like

    meta = Checkpointer.load_meta(checkpoint)
    tree, _ = Checkpointer(checkpoint).load_params()
    params = dict(meta["model_params"], conv_dtype=None)
    model = load_jax_params(build_model(dict(meta, model_params=params)),
                            tree)
    rng = np.random.RandomState(2)
    spp = 2
    batch = {"radiance": rng.rand(1, spp, 3, 48, 48),
             "features": rng.rand(1, spp, 93, 48, 48),
             "global_features": rng.rand(1, 3, 1, 1),
             "target_image": rng.rand(1, 3, 48, 48)}
    results = []
    launches = None
    for dev in ("cpu", "cuda"):
        model.to(dev).train()
        model.zero_grad(set_to_none=True)
        b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
        b["radiance"].requires_grad_()
        ops.reset_launch_counts()
        with _record_shapes(ops) as seen:
            out = model(b)["radiance"]
            loss = losses.tonemapped_relative_mse(
                out, crop_like(b["target_image"], out))
            loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(ops.launch_counts)
            _check_shapes("gradient", seen, [
                "progressive_splat", "progressive_splat_ddata",
                "progressive_splat_dlogits"])
        grads = {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()}
        grads["<input radiance>"] = b["radiance"].grad.detach().cpu()
        results.append((loss.item(), grads))
    if _nonzero(launches) != {"progressive_splat": spp,
                              "progressive_splat_ddata": spp,
                              "progressive_splat_dlogits": spp}:
        raise AssertionError("gradient phase launched %s, expected %d of "
                             "each kernel" % (launches, spp))
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = results
    worst, worst_name = 0.0, ""
    for name, want in cpu_g.items():
        got = gpu_g[name]
        scale = float(want.abs().max())
        diff = float((got - want).abs().max())
        if not (bool(torch.isfinite(got).all())
                and diff <= GRAD_RTOL * scale + GRAD_ATOL):
            raise AssertionError(
                "gradient of %s on the card disagrees with the CPU: max abs "
                "%.3g against max |cpu| %.3g" % (name, diff, scale))
        if scale > 0 and diff / scale > worst:
            worst, worst_name = diff / scale, name
    if abs(gpu_loss - cpu_loss) > 1e-4 * abs(cpu_loss):
        raise AssertionError("loss on the card %.8g, on the CPU %.8g"
                             % (gpu_loss, cpu_loss))
    rad = "<input radiance>"
    print("gradient: flagship float32 on 1x%dx48x48, card vs CPU: loss %.6g "
          "vs %.6g; %d gradients, worst max-abs difference %.3g of the "
          "tensor's largest (%s); input radiance %.3g (tolerance %.0e * "
          "max|cpu| + %.0e); launches %s"
          % (spp, gpu_loss, cpu_loss, len(cpu_g), worst, worst_name,
             float((gpu_g[rad] - cpu_g[rad]).abs().max())
             / float(cpu_g[rad].abs().max()), GRAD_RTOL, GRAD_ATOL,
             json.dumps(launches)))
    return launches


def _reference_phase(checkpoint):
    """The flagship model on the card (kernel) against the CPU (plain)."""
    from sbmc_tpu_torch.models.build import build_model
    from sbmc_tpu_torch.params import load_jax_params
    from sbmc_tpu_torch.train.checkpointer import Checkpointer

    meta = Checkpointer.load_meta(checkpoint)
    tree, _ = Checkpointer(checkpoint).load_params()
    rng = np.random.RandomState(1)
    batch = {"radiance": rng.rand(1, 2, 3, 48, 48),
             "features": rng.rand(1, 2, 93, 48, 48),
             "global_features": rng.rand(1, 3, 1, 1)}
    for dtype, (max_tol, mean_tol) in MODEL_TOL.items():
        params = dict(meta["model_params"], conv_dtype=dtype)
        model = load_jax_params(build_model(dict(meta, model_params=params)),
                                tree)
        outs = []
        for dev in ("cpu", "cuda"):
            b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
                 for k, v in batch.items()}
            with torch.inference_mode():
                outs.append(model.to(dev)(b)["radiance"].cpu().numpy())
        diff = np.abs(outs[0] - outs[1])
        print("reference: flagship %s convs, card vs CPU on 1x2x48x48: max "
              "abs %.3g, mean %.3g (tolerance %.0e / %.0e)"
              % (dtype, diff.max(), diff.mean(), max_tol, mean_tol))
        if not (np.isfinite(outs[1]).all() and diff.max() <= max_tol
                and diff.mean() <= mean_tol):
            raise AssertionError("flagship model on the card disagrees with "
                                 "the CPU (%s convs)" % dtype)


def _scale_phase(checkpoint, spp=4, h=1080, w=2048):
    """The flagship forward on one full 1080x2048 tile (random inputs):
    the time a frame's worth of work takes on the card at real size."""
    from sbmc_tpu_torch.denoise import load_model

    model, _, _ = load_model(checkpoint, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {
        "radiance": torch.rand(1, spp, 3, h, w, device="cuda",
                               generator=gen),
        "features": torch.rand(1, spp, 93, h, w, device="cuda",
                               generator=gen).half(),
        "global_features": torch.rand(1, 3, 1, 1, device="cuda",
                                      generator=gen)}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = _time_ms(lambda: model(batch), 1, 3)
    print("flagship forward on one %dx%d tile at %d spp (bf16 convs): "
          "%.2f ms; peak device memory %.2f GB" % (
              h, w, spp, ms, torch.cuda.max_memory_allocated() / 1e9))


def _psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _main_phase(ops, checkpoint, tmp, tile, pad):
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.data.datasets import FullImagesDataset
    from sbmc_tpu_torch.data.synthetic import generate_dataset
    from sbmc_tpu_torch.utils import exr

    size, spp = 256, 4
    data_dir = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    generate_dataset(data_dir, n_scenes=1, ts=64, tiles_per_side=4,
                     spp=spp, gt_spp=64, seed=0)
    gen_s = time.perf_counter() - t0
    out = os.path.join(tmp, "out", "frame.exr")
    argv = ["--input", data_dir, "--checkpoint", checkpoint, "--output", out,
            "--uniform_tiles", "--tile_size", str(tile), "--tile_pad",
            str(pad), "--spp", str(spp), "--device", "cuda"]
    warm = denoise.main(denoise.parse_args(argv))
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        res = denoise.main(denoise.parse_args(argv))
    launches = dict(ops.launch_counts)
    _check_shapes("denoise", seen, ["progressive_splat"])
    tiles = res[0]["tiles"]
    if launches["progressive_splat"] != tiles * spp:
        raise AssertionError("splat kernel launched %d times, expected "
                             "tiles x spp = %d" % (
                                 launches["progressive_splat"], tiles * spp))
    img = exr.read(out)
    if img.shape != (size, size, 3) or not np.isfinite(img).all():
        raise AssertionError("denoised EXR is %s, finite: %s" % (
            img.shape, bool(np.isfinite(img).all())))
    frame = FullImagesDataset(data_dir, spp=spp)[0]
    crop = 10  # (ksize - 1) / 2: the model's border
    inner = (slice(crop, -crop), slice(crop, -crop))
    gt = frame["target_image"].transpose(1, 2, 0)[inner]
    noisy = frame["low_spp"].transpose(1, 2, 0)[inner]
    print("main path: %dx%d frame, %d spp, %d uniform tiles of %d (pad %d): "
          "%.2f ms/frame (first run %.2f ms), splat launches %d; data "
          "written in %.1f s" % (size, size, spp, tiles, tile, pad,
                                 res[0]["ms"], warm[0]["ms"],
                                 launches["progressive_splat"], gen_s))
    print("quality vs the frame's ground truth (clipped to [0, 1], %d px "
          "border cropped): denoised %.2f dB, noisy input %.2f dB"
          % (crop, _psnr(img[inner], gt), _psnr(noisy, gt)))
    return launches

class _timed_steps:
    """While active, every ``train_step`` of ``owner`` (the host loader's
    ``DenoiserInterface``, or the ``DeviceReservoir`` whose step draws and
    gathers its batch on the card first) is timed on the host clock between
    two synchronisations (``ms``), and the launches made inside the steps
    are counted (``launches``): the display callback's forward at the end of
    an epoch launches forward kernels too."""

    def __init__(self, ops, owner=None):
        from sbmc_tpu_torch.train.interface import DenoiserInterface
        self.ops, self.ms, self.launches = ops, [], {}
        self.cls = owner or DenoiserInterface

    def __enter__(self):
        self.plain = plain = self.cls.train_step
        ops, ms, launches = self.ops, self.ms, self.launches

        def timed_step(*args):
            before = dict(ops.launch_counts)
            torch.cuda.synchronize()
            t = time.perf_counter()
            metrics = plain(*args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            for name, n in ops.launch_counts.items():
                launches[name] = launches.get(name, 0) + n - before[name]
            return metrics

        self.cls.train_step = timed_step
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.plain


def _run_training(ops, tag, what, argv, steps, kernels, in_steps_want,
                  display_want, arch, owner=None):
    """Run ``sbmc_tpu_torch.train`` with ``argv`` for ``steps`` steps and
    check it: the launches inside the steps (``in_steps_want``; the steps of
    ``owner``, see ``_timed_steps``) and in all (plus ``display_want`` per
    display strip), the shapes met by ``kernels``, finite losses in the CSV
    log, and the checkpoint. Prints one line and notes the median step in
    ``_STEP_MS[tag]``; returns ``(interface, launch counts)``."""
    from sbmc_tpu_torch import train_cli
    from sbmc_tpu_torch.train.checkpointer import Checkpointer

    ckpt = argv[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _timed_steps(ops, owner) as timed, _record_shapes(ops) as seen:
        iface = train_cli.main(train_cli.parse_args(
            argv + ["--max_steps", str(steps), "--log_interval", "1",
                    "--num_worker_threads", "2", "--device", "cuda"]))
    torch.cuda.synchronize()
    counts = dict(ops.launch_counts)
    _check_shapes(tag, seen, kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if iface.step != steps or Checkpointer.load_meta(ckpt)["arch"] != arch:
        raise AssertionError("%s: not %d steps of arch %s" % (tag, steps,
                                                              arch))
    if _nonzero(timed.launches) != in_steps_want:
        raise AssertionError("%s: kernel launches inside the train steps %s, "
                             "expected %s" % (tag, _nonzero(timed.launches),
                                              in_steps_want))
    viz = os.path.join(ckpt, "viz")
    epochs = len(os.listdir(viz)) if os.path.isdir(viz) else 0
    want = dict(in_steps_want)
    for name, n in display_want.items():
        want[name] = want.get(name, 0) + epochs * n
    if _nonzero(counts) != want:
        raise AssertionError("%s: kernel launches %s, expected %s"
                             % (tag, _nonzero(counts), want))
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        rows = list(csv.DictReader(f))
    loss = [float(r["loss"]) for r in rows]
    if len(rows) != steps or not all(
            np.isfinite(float(r[k])) for r in rows
            for k in ("loss", "rmse", "input_loss", "wall_time")):
        raise AssertionError("%s: train_log.csv has %d rows or a "
                             "non-finite value" % (tag, len(rows)))
    files = os.listdir(ckpt)
    if not ("final.msgpack" in files and "meta.json" in files
            and "ckpt_%09d.msgpack" % steps in files):
        raise AssertionError("%s: no checkpoint written: %s" % (tag, files))
    rest = sorted(timed.ms[1:])
    _STEP_MS[tag] = (rest[len(rest) // 2], rest[0], rest[-1])
    print("%s: %d steps of %s: first step %.2f ms, then median %.2f ms/step "
          "(min %.2f, max %.2f); peak device memory %.2f GB; loss %.5g -> "
          "%.5g (%s, input baseline %.5g); launches %s"
          % (tag, steps, what, timed.ms[0], rest[len(rest) // 2], rest[0],
             rest[-1], peak_gb, loss[0], loss[-1],
             "fell" if loss[-1] < loss[0] else "did not fall",
             float(rows[-1]["input_loss"]), json.dumps(_nonzero(counts))))
    return iface, counts


def _train_phase(ops, tmp, steps=10, spp=8, bs=4):
    """The training path at full flagship width through its entry point,
    in float32 and with ``--bf16``; then train -> checkpoint -> denoise.
    Returns the launch counts of each run."""
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.data.synthetic import generate_dataset
    from sbmc_tpu_torch.train.checkpointer import Checkpointer
    from sbmc_tpu_torch.utils import exr

    data_dir = os.path.join(tmp, "train_data")
    t0 = time.perf_counter()
    generate_dataset(data_dir, n_scenes=8, ts=128, tiles_per_side=1, spp=spp,
                     gt_spp=64, seed=0)
    print("training data: 8 tiles of 128x128 at %d spp written in %.1f s"
          % (spp, time.perf_counter() - t0))

    launches = {}
    for tag, flags in (("train", []), ("train_bf16", ["--bf16"])):
        ckpt = os.path.join(tmp, "ckpt_" + tag)
        # Every sample slot of every step launches the forward and the
        # logits-gradient kernel (masked samples too); nothing asks for the
        # gradient to the radiance, a batch input.
        iface, launches[tag] = _run_training(
            ops, tag, "the flagship architecture, batch %d x %d spp x "
            "128x128 (randomized sample counts)" % (bs, spp),
            [data_dir, ckpt, "--spp", str(spp), "--bs", str(bs), "--ksize",
             "21"] + flags, steps,
            ["progressive_splat", "progressive_splat_dlogits"],
            {"progressive_splat": steps * spp,
             "progressive_splat_dlogits": steps * spp},
            {"progressive_splat": spp}, "sbmc")
        mp = Checkpointer.load_meta(ckpt)["model_params"]
        if (mp["n_features"] != 93 or mp["ksize"] != 21
                or sum(p.numel() for p in iface.model.parameters()) < 30e6):
            raise AssertionError("the training run was not the flagship "
                                 "architecture")
        del iface

    # train -> checkpoint -> denoise: the bf16 run's checkpoint denoises the
    # tiles it trained on, one 128x128 frame per scene.
    ckpt = os.path.join(tmp, "ckpt_train_bf16")
    out = os.path.join(tmp, "trained", "frame.exr")
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        res = denoise.main(denoise.parse_args(
            ["--input", data_dir, "--checkpoint", ckpt, "--output", out,
             "--uniform_tiles", "--tile_size", "128", "--tile_pad", "32",
             "--device", "cuda"]))
    _check_shapes("trained-checkpoint denoise", seen, ["progressive_splat"])
    if len(res) != 8 or _nonzero(ops.launch_counts) != {
            "progressive_splat": 8 * spp}:
        raise AssertionError("denoising with the trained checkpoint: %d "
                             "scenes, %s launches" % (len(res),
                                                      ops.launch_counts))
    for r in res:
        img = exr.read(r["output"])
        if img.shape != (128, 128, 3) or not np.isfinite(img).all():
            raise AssertionError("trained checkpoint wrote %s, finite: %s"
                                 % (img.shape, bool(np.isfinite(img).all())))
    print("trained checkpoint (step %d, bf16 convs) denoised %d frames of "
          "128x128 at %d spp: finite EXRs, %d forward-kernel launches"
          % (steps, len(res), spp, ops.launch_counts["progressive_splat"]))
    return launches


def _kw_inputs(rng, bs, c, h, w, k, dtype, misalign=False):
    """data, weights, and the cotangents of kernel weighting, on the card;
    with ``misalign`` the weights start one element past an aligned base."""
    dev = torch.device("cuda")

    def t(a, dt=torch.float32):
        return torch.tensor(a, dtype=torch.float32).to(dt).to(dev)

    weights = t(rng.randn(bs, k * k, h, w), dtype)
    if misalign:
        buf = torch.empty(weights.numel() + 1, dtype=dtype, device=dev)
        weights = buf[1:].view(weights.shape).copy_(weights)
    return (t(rng.randn(bs, c, h, w)), weights, t(rng.randn(bs, c, h, w)),
            t(rng.randn(bs, h, w)))


def _kw_check(name, case, got, want, dtype, rtol=RTOL):
    """Raises unless ``got`` has ``want``'s shape, the type ``dtype`` and
    lies within ``ATOL + rtol * |want|``; returns the max abs error."""
    if got.dtype != dtype or got.shape != want.shape:
        raise AssertionError("%s returned %s %s at %s" % (
            name, got.dtype, tuple(got.shape), case))
    diff = (got.float() - want.float()).abs()
    if not bool(torch.all(diff <= ATOL + rtol * want.float().abs())):
        raise AssertionError(
            "%s kernel disagrees with its plain version at %s: max abs err "
            "%.3g" % (name, case, float(diff.max())))
    _note_err(name, float(diff.max()))
    return float(diff.max())


def _compare_composed(ops, inputs, groups=None):
    """Holds kernel weighting and its weight gradient (the kernels the
    route takes, at ``groups`` groups of tap rows or the route's; and the
    generic ones where the route takes the tiled ones) against their plain
    versions, within ``ATOL + RTOL * |plain|``; the gradient for bfloat16
    weights is bfloat16, within ``ATOL + 2^-7 * |plain|`` of the plain
    float32 gradient rounded once. Raises on a failure, and if
    scatter2gather is not exact."""
    data, weights, d_out, d_sw = inputs
    k = ops.reference.ksize_of(weights)
    dtype = weights.dtype
    case = _case(data, weights)
    routes = ["generic"]
    if ops.kw_route(k) == "tiled":
        routes.insert(0, "tiled")
    want_out, want_sw = ops.kernel_weighting_ref(data, weights)
    want_dw = ops.kernel_weighting_dw_ref(data, d_out, d_sw, k).to(dtype)
    rtol_dw = BF16_RTOL if dtype == torch.bfloat16 else RTOL
    for route in routes:
        suffix = "" if route == "tiled" else "_generic"
        fwd, dw = "kernel_weighting" + suffix, "kernel_weighting_dw" + suffix
        _COMPARED[fwd].add(case)
        _COMPARED[dw].add(case)
        if route == "tiled" and groups is None:
            out, sum_w = ops.kernel_weighting(data, weights)
        else:
            out, sum_w = ops._kernel_weighting_cuda(data, weights, route,
                                                    groups)
        d_w = ops._kernel_weighting_dw_cuda(data, d_out, d_sw, k, dtype,
                                            route, groups)
        torch.cuda.synchronize()
        _kw_check(fwd, case, out, want_out, torch.float32)
        _kw_check(fwd, case, sum_w, want_sw, torch.float32)
        _kw_check(dw, case, d_w, want_dw, dtype, rtol_dw)
        del out, sum_w, d_w
    _check_s2g(ops, weights)


def _check_s2g(ops, weights, v=None):
    """Raises unless scatter2gather is bit-exact: through the op (the kernel
    the route takes), and through the generic kernel where the route takes
    the vector one; with ``v``, the vector kernel at items of ``v``
    elements alone."""
    want = ops.scatter2gather_ref(weights)
    if v is not None:
        runs = [("scatter2gather", lambda: ops._scatter2gather_cuda(
            weights, "tiled", v))]
    else:
        name = ("scatter2gather" if ops.s2g_route(
            ops.reference.ksize_of(weights)) == "tiled"
            else "scatter2gather_generic")
        runs = [(name, lambda: ops.scatter2gather(weights))]
        if name == "scatter2gather":
            runs.append(("scatter2gather_generic",
                         lambda: ops._scatter2gather_cuda(weights,
                                                          "generic")))
    for name, run in runs:
        _COMPARED[name].add(_s2g_case(weights))
        got = run()
        torch.cuda.synchronize()
        if got.dtype != weights.dtype or not torch.equal(got, want):
            raise AssertionError("%s kernel is not bit-exact at %s (v %s)"
                                 % (name, _s2g_case(weights), v))


def _time_composed(ops, inputs, plain_iters, graph_iters):
    """[(kernel, ms, plain ms, bound ms, bound by, device ms, extra)] on
    these inputs: ``ms`` on the host clock (events around 20 calls through
    the wrapper), ``device_ms`` by CUDA-graph replay (``graph_iters`` calls
    a graph); for the tiled kernels ``extra`` holds the count of groups the
    route picks, the device time at every count (the best of two turns
    over the counts, taken after the other times) and a yardstick."""
    data, weights, d_out, d_sw = inputs
    bs, c, h, w = data.shape
    k2 = weights.shape[1]
    k = int(round(k2 ** 0.5))
    px = bs * h * w
    dtype = weights.dtype
    wbytes = weights.numel() * weights.element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def add(name, fn, plain, bound, extra=dict):
        times = (_time_ms(fn, 3, 20), _time_ms(plain, 1, plain_iters))
        device_ms = _graph_ms(fn, graph_iters)
        rows.append((name,) + times + bound + (device_ms, extra()))

    def by_groups(chosen, fn_of):
        return {"groups": chosen, "device_ms_by_groups": _by_groups(
            [g for g in (1, 2, 4, 8) if g <= k], fn_of, graph_iters)}

    # Forward: reads the weights and c data planes, writes c + 1 planes;
    # per tap an add to sum_w and one FMA per channel. Its yardstick of the
    # reachable read rate: torch.sum over the same weights.
    fwd_bound = _bound(wbytes + px * 4 * (2 * c + 1), px * k2 * (2 * c + 1))
    plain_fwd = lambda: ops.kernel_weighting_ref(data, weights)  # noqa: E731
    add("kernel_weighting", lambda: ops.kernel_weighting(data, weights),
        plain_fwd, fwd_bound, lambda: dict(by_groups(
            ops.kw_groups(bs, h, w, k, ops.kw_pixels(w, 2),
                          weights.element_size(), sms),
            lambda g: lambda: ops._kernel_weighting_cuda(
                data, weights, "tiled", g)),
            weights_sum_device_ms=_graph_ms(
                lambda: weights.sum(dtype=torch.float32), graph_iters)))
    add("kernel_weighting_generic",
        lambda: ops._kernel_weighting_cuda(data, weights, "generic"),
        plain_fwd, fwd_bound)
    # Weight gradient: reads 2c + 1 float32 planes, writes k2 planes in the
    # weights' type (the generic kernel: float32); per tap c FMAs and an
    # add. The plain version is the CPU path's: float32, then the cast. Its
    # yardstick of the reachable write rate: a fill of the same planes.
    plain_dw = lambda: ops.kernel_weighting_dw_ref(  # noqa: E731
        data, d_out, d_sw, k).to(dtype)
    planes = torch.empty_like(weights)
    add("kernel_weighting_dw",
        lambda: ops._kernel_weighting_dw_cuda(data, d_out, d_sw, k, dtype),
        plain_dw, _bound(px * (4 * (2 * c + 1) + k2 * weights.element_size()),
                         px * k2 * (2 * c + 1)),
        lambda: dict(by_groups(
            ops.kw_dw_groups(k),
            lambda g: lambda: ops._kernel_weighting_dw_cuda(
                data, d_out, d_sw, k, dtype, "tiled", g)),
            fill_device_ms=_graph_ms(lambda: planes.fill_(1.0),
                                     graph_iters)))
    del planes
    add("kernel_weighting_dw_generic",
        lambda: ops._kernel_weighting_dw_cuda(data, d_out, d_sw, k,
                                              route="generic"),
        plain_dw, _bound(px * 4 * (2 * c + 1 + k2), px * k2 * (2 * c + 1)),
        lambda: {"writes": "float32"})
    # Transpose: reads and writes the k2 planes; no arithmetic. Its
    # yardstick of the reachable rate: a copy_ of the same bytes.
    copy = torch.empty_like(weights)
    size = weights.element_size()
    add("scatter2gather", lambda: ops.scatter2gather(weights),
        lambda: ops.scatter2gather_ref(weights), _bound(2 * wbytes, 0),
        lambda: {"item_bytes": size * ops.s2g_pixels(
            w, size, weights.data_ptr() // size),
            "copy_device_ms": _graph_ms(lambda: copy.copy_(weights),
                                        graph_iters)})
    del copy
    add("scatter2gather_generic",
        lambda: ops._scatter2gather_cuda(weights, "generic"),
        lambda: ops.scatter2gather_ref(weights), _bound(2 * wbytes, 0))
    return rows


def _composed_kernel_phase(ops):
    """Kernel weighting and its weight gradient (tiled and generic) and
    scatter2gather against their plain versions, then their times."""
    rng = np.random.RandomState(3)
    cases = 0

    def check(inputs, groups=None):
        nonlocal cases
        _compare_composed(ops, inputs, groups)
        cases += 1

    for k in (3, 5, 21):
        for c, hw in ((3, (37, 53)), (3, (130, 3)), (2, (5, 7))):
            for dtype in (torch.float32, torch.bfloat16):
                check(_kw_inputs(rng, 2, c, *hw, k, dtype))
    # Every group count of the tiled kernels at every k, weight type and
    # channel count (a width of 64: the widest items; 37 rows: ragged
    # tiles), whichever count the route would pick; a base one element off
    # at a width of 90 (1-pixel items in the forward, 2-pixel ones in the
    # gradient); k = 7, which only the generic kernels take.
    for k in (3, 5, 21):
        for dtype in (torch.float32, torch.bfloat16):
            for c in (2, 3):
                for g in (1, 2, 4, 8):
                    if g <= k:
                        check(_kw_inputs(rng, 2, c, 37, 64, k, dtype), g)
            check(_kw_inputs(rng, 2, 3, 21, 90, k, dtype, misalign=True))
    for dtype in (torch.float32, torch.bfloat16):
        check(_kw_inputs(rng, 2, 3, 37, 53, 7, dtype))
    # The vector scatter2gather at every item width a row takes: 16-byte
    # rows (64), KPCN's 92 (8-byte bfloat16 items), widths of 2 mod 4 (30)
    # and odd (53), at every k and type.
    for k in (3, 5, 21):
        for dtype in (torch.float32, torch.bfloat16):
            for hw in ((37, 64), (13, 92), (6, 30), (7, 53)):
                weights = _kw_inputs(rng, 2, 3, *hw, k, dtype)[1]
                size = weights.element_size()
                for v in (1, 2, 4, 8):
                    if v <= ops.s2g_pixels(hw[1], size, 0):
                        _check_s2g(ops, weights, v)
                        cases += 1
    # The paths' shapes, and a ragged KPCN tile of the default denoise CLI
    # on a 1080x1920 frame (312x384 less the 36 px of the valid convs).
    for bs, c, h, w, dtype in KW_PATH_SHAPES + ((1, 3, 276, 348,
                                                  torch.bfloat16),):
        check(_kw_inputs(rng, bs, c, h, w, 21, dtype))
    print("composed kernel check: %d cases, max abs err kernel_weighting "
          "tiled %.3g, generic %.3g, kernel_weighting_dw tiled %.3g, generic "
          "%.3g (tolerance %.0e + %.0e * |plain|; bf16 d_w %.0e + 2^-7 * "
          "|plain|); scatter2gather (vector and generic) bit-exact in "
          "float32 and bfloat16"
          % (cases, _MAX_ERR["kernel_weighting"],
             _MAX_ERR["kernel_weighting_generic"],
             _MAX_ERR["kernel_weighting_dw"],
             _MAX_ERR["kernel_weighting_dw_generic"], ATOL, RTOL, ATOL))
    numbers = {}
    # KPCN's training shape first (the main path's), then one full 1080x2048
    # tile, each in both weight types; new and generic kernels in the same
    # run.
    for shape, dtype, iters, graph_iters in (
            ((4, 3, 92, 92), torch.float32, 3, 20),
            ((4, 3, 92, 92), torch.bfloat16, 3, 20),
            ((1, 3, 1080, 2048), torch.float32, 2, 5),
            ((1, 3, 1080, 2048), torch.bfloat16, 2, 5)):
        inputs = _kw_inputs(rng, *shape, 21, dtype)
        check(inputs)
        tag = "%s %s" % ("x".join(map(str, shape)),
                         str(dtype).replace("torch.", ""))
        for name, *times, extra in _time_composed(ops, inputs, iters,
                                                  graph_iters):
            _record_times(numbers, name, tag, *times, **extra)
        del inputs
        torch.cuda.empty_cache()
    for name in ("kernel_weighting", "kernel_weighting_generic",
                 "kernel_weighting_dw", "kernel_weighting_dw_generic"):
        numbers[name]["max_abs_err"] = _MAX_ERR[name]
    numbers["scatter2gather"]["max_abs_err"] = 0.0
    numbers["scatter2gather_generic"]["max_abs_err"] = 0.0
    return numbers


def _exp_inputs(gen, bs, c, h, w, k, dtype, misalign=()):
    """data, gather logits and a per-pixel shift for the exp kernels, drawn
    on the card: the shift is the logits' tap max plus a margin in [0, 1),
    so every exponent is at most 0, as in the splat step. The tensors named
    in ``misalign`` ("logits", "maxes") start one element past an aligned
    base."""
    data = torch.randn(bs, c, h, w, device="cuda", generator=gen)
    logits = (3 * torch.randn(bs, k * k, h, w, device="cuda",
                              generator=gen)).to(dtype)
    maxes = logits.float().amax(1) + torch.rand(bs, h, w, device="cuda",
                                                generator=gen)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        return buf[1:].view(t.shape).copy_(t)

    return (data, shifted(logits) if "logits" in misalign else logits,
            shifted(maxes) if "maxes" in misalign else maxes)


def _check_exp(ops, data, logits, maxes, route=None, groups=None):
    """Holds kernel weighting of exp(logits - max) against its plain version
    within ``ATOL + RTOL * |plain|``: through the op (the kernel its route
    takes), or the kernel of ``route``, the tiled one at ``groups`` groups
    of tap rows."""
    k = ops.reference.ksize_of(logits)
    name = "kernel_weighting_exp" + (
        "" if (route or ops.kw_route(k)) == "tiled" else "_generic")
    case = _case(data, logits)
    _COMPARED[name].add(case)
    if route is None:
        got = ops.kernel_weighting_exp(data, logits, maxes)
    else:
        got = ops._kernel_weighting_exp_cuda(data, logits, maxes, route,
                                             groups)
    want = ops.kernel_weighting_exp_ref(data, logits, maxes)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        _kw_check(name, (case, groups), g, r, torch.float32)


def _compare_exp(ops, data, logits, maxes):
    """Holds scatter2gather_max bit-exact (gather and tap max) and
    kernel_weighting_exp (the op) within ``ATOL + RTOL * |plain|`` against
    their plain versions."""
    case = _case(data, logits)
    _COMPARED["scatter2gather_max"].add(_s2g_case(logits))
    g, kmax = ops.scatter2gather_max(logits)
    want_g, want_kmax = ops.scatter2gather_max_ref(logits)
    torch.cuda.synchronize()
    if (g.dtype != logits.dtype or kmax.dtype != torch.float32
            or not torch.equal(g, want_g) or not torch.equal(kmax, want_kmax)):
        raise AssertionError("scatter2gather_max kernel is not bit-exact at "
                             "%s" % (case,))
    del g, want_g, kmax, want_kmax
    _check_exp(ops, data, logits, maxes)


def _time_exp(ops, data, logits, maxes, plain_iters, graph_iters):
    """[(kernel, ms, plain ms, bound ms, bound by, device ms, extra)] on
    these inputs: ``ms`` on the host clock, ``device_ms`` by CUDA-graph
    replay (``graph_iters`` calls a graph); kw_exp's ``extra`` holds the
    group count the route picks, the device time at every count (the best
    of two turns) and two yardsticks, device times: kw_fwd (the op
    ``kernel_weighting``) on the logits as weights, the same bytes less the
    max plane, and a torch.sum of the logits over their taps."""
    bs, c, h, w = data.shape
    k2 = logits.shape[1]
    k = int(round(k2 ** 0.5))
    px = bs * h * w
    lbytes = logits.numel() * logits.element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def add(name, fn, plain_ms, bound, extra=dict):
        rows.append((name, _time_ms(fn, 3, 20), plain_ms) + bound
                    + (_graph_ms(fn, graph_iters), extra()))

    def s2g_max():
        return ops.scatter2gather_max(logits)

    # Reads and writes the k2 planes, writes the float32 max plane; one
    # compare per tap.
    add("scatter2gather_max", s2g_max,
        _time_ms(lambda: ops.scatter2gather_max_ref(logits), 1, plain_iters),
        _bound(2 * lbytes + px * 4, px * k2))
    # Reads the logits, c data planes and the max plane, writes c + 1
    # planes; per tap a subtract, an exp, an add to sum_w and one FMA per
    # channel.
    plain_ms = _time_ms(lambda: ops.kernel_weighting_exp_ref(data, logits,
                                                             maxes),
                        1, plain_iters)
    bound = _bound(lbytes + px * 4 * (2 * c + 2), px * k2 * (3 + 2 * c))
    groups = ops.kw_exp_groups(bs, h, w, k, ops.kw_pixels(w, 2), sms)
    add("kernel_weighting_exp",
        lambda: ops.kernel_weighting_exp(data, logits, maxes), plain_ms,
        bound, lambda: {
            "groups": groups,
            "device_ms_by_groups": _by_groups(
                [g for g in (1, 2, 4, 8) if g <= k],
                lambda g: lambda: ops._kernel_weighting_exp_cuda(
                    data, logits, maxes, "tiled", g), graph_iters),
            "kw_fwd_device_ms": _graph_ms(
                lambda: ops.kernel_weighting(data, logits), graph_iters),
            "logits_sum_device_ms": _graph_ms(
                lambda: logits.sum(1, dtype=torch.float32), graph_iters)})
    add("kernel_weighting_exp_generic",
        lambda: ops._kernel_weighting_exp_cuda(data, logits, maxes,
                                               "generic"),
        plain_ms, bound)
    return rows


def _exp_kernel_phase(ops):
    """scatter2gather_max and kernel_weighting_exp (tiled and generic)
    against their plain versions, then their times (the composed step's
    tile first)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = 0
    for k in (3, 5, 21):
        for c, hw in ((3, (37, 53)), (3, (130, 3)), (2, (5, 7))):
            for dtype in (torch.float32, torch.bfloat16):
                inputs = _exp_inputs(gen, 2, c, *hw, k, dtype)
                _compare_exp(ops, *inputs)
                _check_exp(ops, *inputs, route="generic")
                cases += 2
    for bs, c, h, w, k, dtype in STEP_SHAPES[:-1]:
        _compare_exp(ops, *_exp_inputs(gen, bs, c, h, w, k, dtype))
        cases += 1
    # The tiled kw_exp at every group count, whichever the route would
    # pick, with 2-pixel items (a width of 64) and 1-pixel ones (53), at
    # every k, logit type and channel count (37 rows: ragged tiles); a
    # logits base one element off (1-pixel items at an even width), and a
    # maxes base one element off; the generic kernel at k = 7, which only
    # it takes.
    for k in (3, 5, 21):
        for dtype in (torch.float32, torch.bfloat16):
            for c in (2, 3):
                for hw in ((37, 64), (37, 53)):
                    inputs = _exp_inputs(gen, 2, c, *hw, k, dtype)
                    for g in (1, 2, 4, 8):
                        if g <= k:
                            _check_exp(ops, *inputs, "tiled", g)
                            cases += 1
            for misalign in (("logits",), ("maxes",)):
                _check_exp(ops, *_exp_inputs(gen, 2, 3, 21, 90, k, dtype,
                                             misalign))
                cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        _check_exp(ops, *_exp_inputs(gen, 2, 3, 37, 53, 7, dtype))
        cases += 1
    print("exp kernel check: %d cases, scatter2gather_max bit-exact (gather "
          "and tap max) in float32 and bfloat16, kernel_weighting_exp max abs "
          "err tiled %.3g, generic %.3g (tolerance %.0e + %.0e * |plain|)"
          % (cases, _MAX_ERR["kernel_weighting_exp"],
             _MAX_ERR["kernel_weighting_exp_generic"], ATOL, RTOL))
    numbers = {}
    for shape, dtype, iters, graph_iters in (
            ((1, 3, 1080, 2048), torch.bfloat16, 2, 5),
            ((1, 3, 1080, 2048), torch.float32, 2, 5),
            ((4, 3, 128, 128), torch.float32, 3, 20),
            ((4, 3, 128, 128), torch.bfloat16, 3, 20)):
        inputs = _exp_inputs(gen, *shape, 21, dtype)
        _compare_exp(ops, *inputs)
        tag = "%s %s" % ("x".join(map(str, shape)),
                         str(dtype).replace("torch.", ""))
        for name, *times, extra in _time_exp(ops, *inputs, iters,
                                             graph_iters):
            _record_times(numbers, name, tag, *times, **extra)
        del inputs
        torch.cuda.empty_cache()
    numbers["scatter2gather_max"]["max_abs_err"] = 0.0
    for name in ("kernel_weighting_exp", "kernel_weighting_exp_generic"):
        numbers[name]["max_abs_err"] = _MAX_ERR[name]
    return numbers


#: Channel counts outside the kernels' template set (ops.KERNEL_CHANNELS),
#: which the ops run in channel groups (ops.channel_groups): one channel
#: (padded with a zero one), 2 + 2 and 3 + 2.
CHANNEL_CASES = (1, 4, 5)


def _check_within(name, case, got, want, atol, rtol):
    """Raises unless ``got`` lies within ``atol + rtol * |want|``; notes
    and returns the max abs error."""
    diff = (got.float() - want.float()).abs()
    if got.shape != want.shape or not bool(
            torch.all(diff <= atol + rtol * want.float().abs())):
        raise AssertionError("%s disagrees with its plain version at %s: "
                             "max abs err %.3g" % (name, case,
                                                   float(diff.max())))
    _note_err(name, float(diff.max()))
    return float(diff.max())


def _channel_phase(ops, numbers):
    """4e: any channel count. At each count of CHANNEL_CASES the splat
    step, its two gradients, kernel weighting, its weight gradient and
    kernel weighting of exp(logits - max), each through the op's channel
    groups (every group a counted launch of the kernel its route takes),
    against their plain versions with the tolerances of phases 3 to 4c;
    then the autograd gradients of kernel weighting (c = 4) and of the
    splat step (c = 1) on the card against the CPU's."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.RandomState(5)
    cases = 0
    for c in CHANNEL_CASES:
        groups = len(ops.channel_groups(c))
        for k, hw in ((5, (37, 64)), (21, (21, 40)), (3, (13, 8)),
                      (5, (9, 7))):
            for dtype in (torch.float32, torch.bfloat16):
                args = _splat_inputs(gen, 2, c, *hw, k, dtype, False)
                ops.reset_launch_counts()
                _compare(ops, args)
                fwd = _variant(ops, "progressive_splat", args[1])
                if _nonzero(ops.launch_counts) != {fwd: groups}:
                    raise AssertionError("the splat step at %d channels "
                                         "launched %s" % (
                                             c, _nonzero(ops.launch_counts)))
                data, logits, new_max, d_r, d_w = _bwd_inputs(
                    ops, gen, 2, c, *hw, k, dtype)
                case = _case(data, logits)
                want = ops.progressive_splat_bwd_ref(data, logits, new_max,
                                                     d_r, d_w)
                for i, (name, got) in enumerate((
                        ("progressive_splat_ddata", ops.ddata_by_channels(
                            ops._ddata_cuda, logits, new_max, d_r)),
                        ("progressive_splat_dlogits",
                         ops.dlogits_by_channels(ops._dlogits_cuda, data,
                                                 logits, new_max, d_r,
                                                 d_w)))):
                    name = _variant(ops, name, logits)
                    _COMPARED[name].add(case)
                    rtol = (BF16_RTOL if i and dtype == torch.bfloat16
                            else BWD_RTOL)
                    if got.dtype != want[i].dtype:
                        raise AssertionError("%s returned %s at %s" % (
                            name, got.dtype, case))
                    _check_within(name, case, got, want[i], BWD_ATOL, rtol)
                data, weights, d_out, d_sw = _kw_inputs(rng, 2, c, *hw, k,
                                                        dtype)
                case = _case(data, weights)
                suffix = "" if ops.kw_route(k) == "tiled" else "_generic"
                for name in ("kernel_weighting", "kernel_weighting_dw"):
                    _COMPARED[name + suffix].add(case)
                out, sum_w = ops.kernel_weighting(data, weights)
                d_wts = ops.kw_dw_by_channels(ops._kernel_weighting_dw_cuda,
                                              data, d_out, d_sw, k, dtype)
                want_out, want_sw = ops.kernel_weighting_ref(data, weights)
                want_dw = ops.kernel_weighting_dw_ref(data, d_out, d_sw,
                                                      k).to(dtype)
                torch.cuda.synchronize()
                _kw_check("kernel_weighting" + suffix, case, out, want_out,
                          torch.float32)
                _kw_check("kernel_weighting" + suffix, case, sum_w, want_sw,
                          torch.float32)
                _kw_check("kernel_weighting_dw" + suffix, case, d_wts,
                          want_dw, dtype, BF16_RTOL
                          if dtype == torch.bfloat16 else RTOL)
                _check_exp(ops, *_exp_inputs(gen, 2, c, *hw, k, dtype))
                cases += 6
    # The autograd Functions on the card against the CPU (float32 on both):
    # kernel weighting's d_data (scatter2gather, then the forward kernel on
    # the cotangent) and d_weights at 4 channels, the splat step's d_data
    # and d_klogits at 1.
    for c, fn in ((4, "kernel_weighting"), (1, "progressive_splat_update")):
        k, (h, w) = 5, (21, 40)
        if fn == "kernel_weighting":
            x = [torch.tensor(rng.randn(2, c, h, w), dtype=torch.float32),
                 torch.tensor(rng.randn(2, k * k, h, w),
                              dtype=torch.float32)]
            rest = []
        else:
            x = [torch.tensor(rng.randn(2, c, h, w), dtype=torch.float32),
                 torch.tensor(3 * rng.randn(2, k * k, h, w),
                              dtype=torch.float32)]
            rest = [torch.tensor(rng.randn(2, c, h, w), dtype=torch.float32),
                    torch.tensor(np.abs(rng.randn(2, 1, h, w)),
                                 dtype=torch.float32),
                    torch.tensor(rng.randn(2, 1, h, w), dtype=torch.float32)]
        cts = [torch.tensor(rng.randn(2, c, h, w), dtype=torch.float32),
               torch.tensor(rng.randn(2, 1, h, w) if rest else
                            rng.randn(2, h, w), dtype=torch.float32)]
        grads = []
        for dev in ("cpu", "cuda"):
            leaves = [t.to(dev).requires_grad_() for t in x]
            outs = getattr(ops, fn)(*leaves, *(t.to(dev) for t in rest))
            loss = sum((o * ct.to(dev)).sum() for o, ct in zip(outs, cts))
            grads.append([g.cpu() for g in torch.autograd.grad(loss,
                                                               leaves)])
        for g, r in zip(grads[1], grads[0]):
            _check_within("%s gradient at %d channels" % (fn, c), (c, k),
                          g, r, BWD_ATOL, BWD_RTOL)
        cases += 1
    for name in numbers:
        if name in _MAX_ERR:
            numbers[name]["max_abs_err"] = _MAX_ERR[name]
    print("channels: the splat step, its gradients, kernel weighting, its "
          "weight gradient and the exp weighting at %s channels (k 3/5/21, "
          "tiled and generic widths, float32 and bfloat16), in channel "
          "groups of %s, and the autograd gradients card against CPU: %d "
          "cases within the kernel phases' tolerances"
          % (list(CHANNEL_CASES), [[b - a for a, b in ops.channel_groups(c)]
                                   for c in CHANNEL_CASES], cases))


def _composed_step(ops, data, klogits, sum_r, sum_w, max_w):
    """One splat step composed from the two exp kernels, as the unfused
    branch of ``sbmc_tpu.ops._psu_fwd`` composes it: transpose with the tap
    max, the new running max, rescale, weighting of exp(g - max),
    accumulate."""
    g, kmax = ops.scatter2gather_max(klogits)
    new_max = torch.maximum(kmax[:, None], max_w)
    scaler = torch.exp(max_w - new_max)
    r, w = ops.kernel_weighting_exp(data, g, new_max[:, 0])
    return sum_r * scaler + r, sum_w * scaler + w[:, None], new_max


def _composed_step_phase(ops):
    """The splat step through ``ops.scatter2gather_max`` and
    ``ops.kernel_weighting_exp`` against the fused kernel B1 on the same
    inputs, from the initial and from a random state, at every shape of
    STEP_SHAPES; then both timed at the last. Returns the launch counts of
    the checked steps (B1 runs there as the yardstick)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    err = 0.0
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        for bs, c, h, w, k, dtype in STEP_SHAPES:
            for init in (True, False):
                args = _splat_inputs(gen, bs, c, h, w, k, dtype, init)
                got = _composed_step(ops, *args)
                want = ops.progressive_splat_update(*args)
                torch.cuda.synchronize()
                for name, g, r in zip(("sum_r", "sum_w", "max_w"), got,
                                      want):
                    if not bool(torch.all((g - r).abs()
                                          <= ATOL + RTOL * r.abs())):
                        raise AssertionError(
                            "composed step disagrees with the fused kernel "
                            "in %s at %s: max abs err %.3g" % (
                                name, (bs, c, h, w, k, dtype, init),
                                float((g - r).abs().max())))
                    err = max(err, float((g - r).abs().max()))
                del got, want
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    _check_shapes("composed_step", seen, ["scatter2gather_max",
                                          "kernel_weighting_exp"])
    steps = 2 * len(STEP_SHAPES)
    want = {"scatter2gather_max": steps, "kernel_weighting_exp": steps}
    for bs, c, h, w, k, dtype in STEP_SHAPES:
        fused = _variant(ops, "progressive_splat",
                         torch.empty(1, k * k, 1, w, dtype=dtype))
        want[fused] = want.get(fused, 0) + 2
    if _nonzero(launches) != want:
        raise AssertionError("composed step phase launched %s, expected %s"
                             % (_nonzero(launches), want))
    composed_ms = _time_ms(lambda: _composed_step(ops, *args), 3, 20)
    fused_ms = _time_ms(lambda: ops.progressive_splat_update(*args), 3, 20)
    print("composed step: %d steps (initial and random state) against the "
          "fused kernel, max abs err %.3g (tolerance %.0e + %.0e * |fused|); "
          "at (%s), k=21, bf16 logits: composed %.4f ms, fused %.4f ms "
          "(%.2fx); launches %s"
          % (steps, err, ATOL, RTOL, "x".join(map(str, STEP_SHAPES[-1][:4])),
             composed_ms, fused_ms, composed_ms / fused_ms,
             json.dumps(_nonzero(launches))))
    del args
    torch.cuda.empty_cache()
    return launches


# KPCN gradients on the card against the CPU, float32 convs, per tensor as
# GRAD_RTOL above but wider: each of its 18 valid 5x5 convs sums 2500 terms
# per output (the flagship's 3x3 convs 1152) in another order, cuDNN picks
# other algorithms for 5x5 filters than for 3x3, and the gradients of the
# deep layers are small (max 4e-4) beside the rounding of the 441-way softmax
# they pass through; measured 3.3e-3 to 3.5e-3 of a tensor's largest.
KPCN_GRAD_RTOL = 1e-2


def _grad_against_cpu(what, run, leaves_of, rtol=GRAD_RTOL):
    """Runs ``run(device)`` -> (loss, {name: gradient}) on the CPU and on
    the card and holds the card to the CPU per tensor: ``|card - cpu| <=
    rtol * max|cpu| + GRAD_ATOL``, as the flagship gradient phase does."""
    (cpu_loss, cpu_g), (gpu_loss, gpu_g) = run("cpu"), run("cuda")
    worst, worst_name, failed = 0.0, "", []
    for name, want in cpu_g.items():
        got = gpu_g[name]
        scale = float(want.abs().max())
        diff = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("%s: gradient of %s on the card is not "
                                 "finite" % (what, name))
        if diff > rtol * scale + GRAD_ATOL:
            failed.append(name)
        if scale > 0 and diff / scale > worst:
            worst, worst_name = diff / scale, name
    print("gradient, composed: %s, card vs CPU: loss %.6g vs %.6g; %d "
          "gradients (%s), worst max-abs difference %.3g of the tensor's "
          "largest (%s) (tolerance %.0e * max|cpu| + %.0e)"
          % (what, gpu_loss, cpu_loss, len(cpu_g), leaves_of, worst,
             worst_name, rtol, GRAD_ATOL))
    if failed:
        raise AssertionError("%s: gradients of %s on the card disagree with "
                             "the CPU" % (what, failed))
    if abs(gpu_loss - cpu_loss) > 1e-4 * abs(cpu_loss):
        raise AssertionError("%s: loss on the card %.8g, on the CPU %.8g"
                             % (what, gpu_loss, cpu_loss))


def _composed_gradient_phase(ops):
    """``kernel_apply(splat=True)`` and the full-width KPCN model (float32)
    with the buffers requiring a gradient, card against CPU: the place where
    scatter2gather and kernel weighting's gradient to the data run inside a
    model. Returns the card's launch counts over both."""
    from sbmc_tpu_torch import losses
    from sbmc_tpu_torch.models import KPCN
    from sbmc_tpu_torch.nn.kernel_apply import kernel_apply
    from sbmc_tpu_torch.utils.image import crop_like

    rng = np.random.RandomState(4)
    data = rng.randn(2, 3, 37, 53)
    kernels = rng.randn(2, 441, 37, 53)
    total = {}

    def tally(seen, path, kernels_):
        torch.cuda.synchronize()
        _check_shapes(path, seen, kernels_)
        for name, n in ops.launch_counts.items():
            total[name] = total.get(name, 0) + n

    def run_apply(dev):
        d = torch.tensor(data, dtype=torch.float32, device=dev,
                         requires_grad=True)
        kn = torch.tensor(kernels, dtype=torch.float32, device=dev,
                          requires_grad=True)
        ops.reset_launch_counts()
        with _record_shapes(ops) as seen:
            out, sum_w = kernel_apply(d, kn, softmax=True, splat=True)
            loss = out.square().mean() + (sum_w * out[:, :1]).mean()
            loss.backward()
        if dev == "cuda":
            # Forward: transpose + weighting. Backward: the weight gradient,
            # transpose + weighting for the data, transpose of the cotangent.
            if _nonzero(ops.launch_counts) != {
                    "scatter2gather": 3, "kernel_weighting": 2,
                    "kernel_weighting_dw": 1}:
                raise AssertionError("kernel_apply launched %s"
                                     % _nonzero(ops.launch_counts))
            tally(seen, "gradient_composed", [
                "kernel_weighting", "kernel_weighting_dw", "scatter2gather"])
        return loss.item(), {"data": d.grad.cpu(), "kernels": kn.grad.cpu()}

    _grad_against_cpu("kernel_apply(softmax, splat) on 2x3x37x53, k=21",
                      run_apply, "data, kernels")

    torch.manual_seed(0)
    model = KPCN()  # full width: depth 9, width 100, ksize 21
    size = 64
    batch = {k: rng.rand(1, 27 if k.endswith("_in") else 3, size, size)
             for k in ("kpcn_diffuse_in", "kpcn_specular_in",
                       "kpcn_diffuse_buffer", "kpcn_specular_buffer",
                       "kpcn_albedo")}
    batch["target_image"] = rng.rand(1, 3, size, size)
    buffers = ("kpcn_diffuse_buffer", "kpcn_specular_buffer")

    def run_kpcn(dev):
        model.to(dev).train()
        model.zero_grad(set_to_none=True)
        b = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
        for k in buffers:
            b[k].requires_grad_()
        ops.reset_launch_counts()
        with _record_shapes(ops) as seen:
            out = model(b)["radiance"]
            loss = losses.tonemapped_relative_mse(
                out, crop_like(b["target_image"], out))
            loss.backward()
        if dev == "cuda":
            # Per stream: weighting forward, weight gradient, and transpose
            # + weighting for the gradient to the buffer.
            if _nonzero(ops.launch_counts) != {
                    "scatter2gather": 2, "kernel_weighting": 4,
                    "kernel_weighting_dw": 2}:
                raise AssertionError("KPCN gradient launched %s"
                                     % _nonzero(ops.launch_counts))
            tally(seen, "gradient_composed", ["kernel_weighting",
                                              "kernel_weighting_dw"])
        grads = {n: p.grad.detach().cpu()
                 for n, p in model.named_parameters()}
        for k in buffers:
            grads["<%s>" % k] = b[k].grad.cpu()
        return loss.item(), grads

    _grad_against_cpu("KPCN float32 at full width on 1x%dx%d" % (size, size),
                      run_kpcn, "parameters and both buffers", KPCN_GRAD_RTOL)
    return total


def _kpcn_phase(ops, tmp, steps=10, bs=4):
    """KPCN at its full published width through both entry points: trains
    on the 128x128 tiles in float32 and with ``--bf16``, then denoises the
    256x256 frame with each checkpoint. Returns the launch counts by
    path."""
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.utils import exr

    data_dir = os.path.join(tmp, "train_data")
    frame_dir = os.path.join(tmp, "data")
    launches = {}
    for tag, flags in (("kpcn_train", []), ("kpcn_train_bf16", ["--bf16"])):
        ckpt = os.path.join(tmp, "ckpt_" + tag)
        # Two streams: two weighting forwards and two weight gradients per
        # step; nothing asks for the gradient to the buffers (batch inputs),
        # so nothing is transposed, and KPCN writes no display strip.
        iface, launches[tag] = _run_training(
            ops, tag, "KPCN at full width (depth 9, width 100, ksize 21), "
            "batch %d x 128x128" % bs,
            [data_dir, ckpt, "--kpcn_mode", "--spp", "8", "--bs", str(bs),
             "--ksize", "21"] + flags, steps,
            ["kernel_weighting", "kernel_weighting_dw"],
            {"kernel_weighting": 2 * steps, "kernel_weighting_dw": 2 * steps},
            {}, "kpcn")
        shapes = {n: tuple(p.shape) for n, p in iface.model.named_parameters()}
        if (len(shapes) != 36
                or shapes["diffuse.layer_0.v"] != (100, 27, 5, 5)
                or shapes["specular.prediction.v"] != (441, 100, 5, 5)):
            raise AssertionError("the KPCN run was not at full width")
        del iface

        out = os.path.join(tmp, "out_" + tag, "frame.exr")
        argv = ["--input", frame_dir, "--checkpoint", ckpt, "--output", out,
                "--uniform_tiles", "--tile_size", "160", "--tile_pad", "32",
                "--spp", "4", "--device", "cuda"]
        warm = denoise.main(denoise.parse_args(argv))
        ops.reset_launch_counts()
        with _record_shapes(ops) as seen:
            res = denoise.main(denoise.parse_args(argv))
        _check_shapes(tag + " denoise", seen, ["kernel_weighting"])
        tiles = res[0]["tiles"]
        if _nonzero(ops.launch_counts) != {"kernel_weighting": 2 * tiles}:
            raise AssertionError("KPCN denoise launched %s, expected 2 x %d "
                                 "tiles of kernel_weighting"
                                 % (_nonzero(ops.launch_counts), tiles))
        img = exr.read(out)
        if img.shape != (256, 256, 3) or not np.isfinite(img).all():
            raise AssertionError("KPCN denoised EXR is %s, finite: %s" % (
                img.shape, bool(np.isfinite(img).all())))
        # The 18 px the valid convs take stay zero along the frame's border.
        if np.abs(img[:18]).max() != 0 or not np.abs(img[18:-18,
                                                         18:-18]).max() > 0:
            raise AssertionError("KPCN frame: unexpected border or empty "
                                 "interior")
        print("%s checkpoint denoised the 256x256 frame at 4 spp in %d "
              "uniform tiles of 160 (pad 32): %.2f ms/frame (first run %.2f "
              "ms), kernel_weighting launches %d"
              % (tag, tiles, res[0]["ms"], warm[0]["ms"],
                 ops.launch_counts["kernel_weighting"]))
        launches[tag.replace("train", "denoise")] = dict(ops.launch_counts)
    return launches


def _gather_phase(ops, tmp, steps=5, spp=8, bs=4):
    """The gather ablation of the flagship architecture through the train
    entry point: every sample slot goes through the composed kernel
    weighting and its weight gradient, none through the fused splat."""
    data_dir = os.path.join(tmp, "train_data")
    ckpt = os.path.join(tmp, "ckpt_gather")
    iface, counts = _run_training(
        ops, "gather_train", "the flagship architecture with gather kernels "
        "(--gather), batch %d x %d spp x 128x128 (randomized sample counts)"
        % (bs, spp),
        [data_dir, ckpt, "--gather", "--spp", str(spp), "--bs", str(bs),
         "--ksize", "21"], steps,
        ["kernel_weighting", "kernel_weighting_dw"],
        {"kernel_weighting": steps * spp, "kernel_weighting_dw": steps * spp},
        {"kernel_weighting": spp}, "sbmc")
    if iface.model.splat or sum(
            p.numel() for p in iface.model.parameters()) < 30e6:
        raise AssertionError("the gather run was not the flagship "
                             "architecture with splat=False")
    return {"gather_train": counts}


def _lbf_phase(ops, tmp, bs=4):
    """LBF at its default width and window (radius 8): two training steps
    and one denoise; it runs none of the hand-written kernels."""
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.utils import exr

    ckpt = os.path.join(tmp, "ckpt_lbf")
    _, counts = _run_training(
        ops, "lbf_train", "LBF (window radius 8), batch %d x 8 spp x 128x128"
        % bs, [os.path.join(tmp, "train_data"), ckpt, "--lbf_mode", "--spp",
               "8", "--bs", str(bs)], 2, [], {}, {}, "lbf")
    out = os.path.join(tmp, "out_lbf", "frame.exr")
    ops.reset_launch_counts()
    res = denoise.main(denoise.parse_args(
        ["--input", os.path.join(tmp, "data"), "--checkpoint", ckpt,
         "--output", out, "--uniform_tiles", "--tile_size", "160",
         "--tile_pad", "32", "--spp", "4", "--device", "cuda"]))
    img = exr.read(out)
    if img.shape != (256, 256, 3) or not np.isfinite(img).all() \
            or _nonzero(ops.launch_counts):
        raise AssertionError("LBF denoise: EXR %s, launches %s" % (
            img.shape, _nonzero(ops.launch_counts)))
    print("lbf checkpoint denoised the 256x256 frame in %d tiles: %.2f "
          "ms/frame; no hand-written kernel launched" % (res[0]["tiles"],
                                                         res[0]["ms"]))
    return {"lbf_train": counts, "lbf_denoise": dict(ops.launch_counts)}


# A baseline on the card against the same baseline on the CPU, per output
# value: the 99th percentile of |card - cpu| within BASELINE_P99. The filters
# are eager float32 tensor code on both devices; exp, the batched 8x8 solves
# and the reductions round otherwise on the card, and three places turn such
# rounding into a visible step on a few pixels: RPF's histogram bins (a
# truncation), NFOR's candidate selection (``m < mse``) and NLM's box filter
# where a zero variance makes the patch distances cancel at 1e8.
BASELINE_P99 = 1e-3


def _eval_phase(ops, tmp, checkpoint, spp=4, tile=160, pad=32):
    """The evaluation path through ``sbmc_tpu_torch.eval_suite`` on two
    synthetic 256x256 scenes: the flagship, the KPCN (bf16) and LBF
    checkpoints of phases 8b and 8d, and the four classical baselines.
    Returns the launch counts."""
    from sbmc_tpu_torch import eval_suite
    from sbmc_tpu_torch.comparisons import denoise_buffers
    from sbmc_tpu_torch.data.datasets import FullImagesDataset, TilesDataset
    from sbmc_tpu_torch.data.synthetic import generate_dataset
    from sbmc_tpu_torch.utils import exr

    size, n_scenes = 256, 2
    data_dir = os.path.join(tmp, "eval_data")
    t0 = time.perf_counter()
    generate_dataset(data_dir, n_scenes=n_scenes, ts=64, tiles_per_side=4,
                     spp=spp, gt_spp=64, seed=1)
    gen_s = time.perf_counter() - t0
    out = os.path.join(tmp, "eval")
    argv = ["--data", data_dir, "--checkpoint", checkpoint,
            "--kpcn_checkpoint", os.path.join(tmp, "ckpt_kpcn_train_bf16"),
            "--lbf_checkpoint", os.path.join(tmp, "ckpt_lbf"),
            "--output", out, "--spp", str(spp), "--tile_size", str(tile),
            "--tile_pad", str(pad), "--png", "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        res = eval_suite.main(eval_suite.parse_args(argv))
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _check_shapes("eval", seen, ["progressive_splat", "kernel_weighting"])
    methods = res["methods"]
    if methods != ["input", "ours", "nlm", "cbf", "rpf", "nfor", "lbf",
                   "kpcn"] or len(res["rows"]) != n_scenes:
        raise AssertionError("eval_suite scored %s on %d scenes"
                             % (methods, len(res["rows"])))
    tiles = res["tiles"]
    want = {"progressive_splat": n_scenes * tiles["ours"] * spp,
            "kernel_weighting": n_scenes * 2 * tiles["kpcn"]}
    if _nonzero(launches) != want:
        raise AssertionError("eval_suite launched %s, expected %s (%s tiles "
                             "per frame)" % (_nonzero(launches), want, tiles))
    scenes = [r["scene"] for r in res["rows"]]
    for d in ["gt"] + ["%dspp_%s" % (spp, m) for m in methods]:
        for scene in scenes:
            img = exr.read(os.path.join(out, d, scene + ".exr"))
            if img.shape != (size, size, 3) or not np.isfinite(img).all():
                raise AssertionError("%s/%s.exr is %s, finite: %s" % (
                    d, scene, img.shape, bool(np.isfinite(img).all())))
    with open(os.path.join(out, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    if (len(rows) != n_scenes or len(rows[0]) != 1 + 8 * len(methods)
            or not all(np.isfinite(float(v)) for r in rows
                       for k, v in r.items() if k != "scene")):
        raise AssertionError("metrics.csv: %d rows of %d columns, or a "
                             "non-finite value" % (len(rows), len(rows[0])))
    for name in ("metrics.md", os.path.join("png", scenes[0] + ".png")):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError("eval_suite wrote no %s" % name)
    # The second scene's times: the first pays for cuDNN's and the solver's
    # first calls.
    ms = {m: res["ms"][m][-1] for m in methods if m in res["ms"]}
    print("evaluation path: %d scenes of %dx%d at %d spp (data written in "
          "%.1f s), ragged tiles of %d (pad %d): %s tiles per frame; ms per "
          "frame (second scene) %s; peak device memory %.2f GB; launches %s"
          % (n_scenes, size, size, spp, gen_s, tile, pad, json.dumps(tiles),
             json.dumps({m: round(v, 2) for m, v in ms.items()}), peak_gb,
             json.dumps(_nonzero(launches))))
    print("evaluation quality (mean of %d scenes, %d px border cropped): %s"
          % (n_scenes, 21, "; ".join(
              "%s %.2f dB relMSE %.4f DSSIM %.4f" % (
                  m, *(float(np.mean([r["%s_%s" % (m, c)]
                                      for r in res["rows"]]))
                       for c in ("psnr", "relmse", "dssim")))
              for m in methods)))

    # Each baseline on the card against the same baseline on the CPU, on the
    # first scene's sample stack.
    raw = FullImagesDataset(data_dir, mode=TilesDataset.RAW_MODE, spp=spp)
    feats = raw[0]["features"]
    for m in eval_suite.BASELINES:
        t0 = time.perf_counter()
        want = denoise_buffers(feats, raw.labels, method=m, device="cpu")
        cpu_s = time.perf_counter() - t0
        got = denoise_buffers(feats, raw.labels, method=m, device="cuda")
        diff = np.abs(got - want)
        p99 = float(np.percentile(diff, 99))
        print("baseline %s, card vs CPU on %dx%d: max abs %.3g, mean %.3g, "
              "99th percentile %.3g (tolerance %.0e), share above 1e-4 %.4f%%;"
              " CPU %.2f s" % (m, size, size, diff.max(), diff.mean(), p99,
                               BASELINE_P99, 100 * float((diff > 1e-4).mean()),
                               cpu_s))
        if not (np.isfinite(got).all() and p99 <= BASELINE_P99):
            raise AssertionError("baseline %s on the card disagrees with the "
                                 "CPU" % m)
    return launches, raw.labels


def _baseline_scale_phase(labels, spp=4, h=1080, w=2048):
    """Each classical baseline on one 1080x2048 frame of random sample
    records at 4 spp, on the card: time and peak device memory."""
    from sbmc_tpu_torch.comparisons import denoise_buffers
    from sbmc_tpu_torch.eval_suite import BASELINES

    gen = torch.Generator(device="cuda").manual_seed(6)
    feats = torch.rand(spp, len(labels), h, w, device="cuda", generator=gen)
    for m in BASELINES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = denoise_buffers(feats, labels, method=m)  # ends on the host
        ms = (time.perf_counter() - t0) * 1e3
        if out.shape != (3, h, w) or not np.isfinite(out).all():
            raise AssertionError("baseline %s at %dx%d gave %s, finite: %s"
                                 % (m, h, w, out.shape,
                                    bool(np.isfinite(out).all())))
        print("baseline %s on one %dx%d frame at %d spp (%d features): %.2f "
              "ms; peak device memory %.2f GB" % (
                  m, h, w, spp, len(labels), ms,
                  torch.cuda.max_memory_allocated() / 1e9))


class _watch_reservoir:
    """While active, notes the ``DeviceReservoir`` that a training run fills
    and counts its refreshes; a refresh that moves the reservoir's device
    buffers or its pinned staging buffers fails the run."""

    def __enter__(self):
        from sbmc_tpu_torch.train.reservoir import DeviceReservoir
        self.cls = DeviceReservoir
        self.plain = fill, refresh = DeviceReservoir.fill, \
            DeviceReservoir.refresh
        self.res, self.refreshes, self.ptrs = None, 0, None
        watch = self

        def rec_fill(res, items):
            fill(res, items)
            watch.res, watch.ptrs = res, watch.pointers(res)

        def rec_refresh(res, item):
            refresh(res, item)
            watch.refreshes += 1
            if watch.pointers(res) != watch.ptrs:
                raise AssertionError("a refresh moved the reservoir's "
                                     "buffers or its staging buffers")

        DeviceReservoir.fill, DeviceReservoir.refresh = rec_fill, rec_refresh
        return self

    def __exit__(self, *exc):
        self.cls.fill, self.cls.refresh = self.plain

    @staticmethod
    def pointers(res):
        return ({k: v.data_ptr() for k, v in res.buffers.items()},
                {k: v.data_ptr() for k, v in res._staging.items()})


def _check_refresh_in_place(filelist, capacity=4):
    """Refreshes on the card, queued back to back with no synchronisation
    between them (each slot written twice through the same pinned staging
    buffers), leave every slot holding the last tile written to it."""
    from sbmc_tpu_torch.data.datasets import TilesDataset
    from sbmc_tpu_torch.models import Multisteps
    from sbmc_tpu_torch.train.interface import DenoiserInterface
    from sbmc_tpu_torch.train.reservoir import TRAIN_KEYS, DeviceReservoir

    data = TilesDataset(filelist, cache_preprocessed=True)
    iface = DenoiserInterface(Multisteps(
        data.num_features, data.num_global_features, width=8,
        embedding_width=8, ksize=3, nsteps=1), device="cuda")
    res = DeviceReservoir(iface, capacity=capacity, batch_size=2)
    res.fill([data[i] for i in range(capacity)])
    items = [data[i] for i in range(capacity, 3 * capacity)]
    for item in items:
        res.refresh(item)
    torch.cuda.synchronize()
    for slot in range(capacity):
        want = DeviceReservoir._item_arrays(items[capacity + slot])
        for k in TRAIN_KEYS:
            if not np.array_equal(res.buffers[k][slot].cpu().numpy(),
                                  want[k]):
                raise AssertionError("reservoir slot %d holds another %s "
                                     "than the last tile written to it"
                                     % (slot, k))
    print("reservoir on the card: %d refreshes queued back to back into %d "
          "slots, each slot holds its last tile (checked after a "
          "synchronize)" % (len(items), capacity))


def _reservoir_phase(ops, tmp, steps=10, spp=8, bs=4, capacity=8):
    """The training path through the device reservoir at full flagship
    width: ``sbmc_tpu_torch.train --device_reservoir 8 --refresh_every 2``
    on 12 tiles (the training phase's 8 and 4 more), so that the feeder
    thread refreshes slots, in float32 and with ``--bf16``, each against
    the host-loader steps of the training phase (same configuration);
    then refreshes on the card checked slot by slot. Returns the launch
    counts of each run."""
    from sbmc_tpu_torch.data.synthetic import generate_dataset
    from sbmc_tpu_torch.train.reservoir import DeviceReservoir

    more = os.path.join(tmp, "train_data_more")
    t0 = time.perf_counter()
    generate_dataset(more, n_scenes=4, ts=128, tiles_per_side=1, spp=spp,
                     gt_spp=64, seed=1)
    gen_s = time.perf_counter() - t0
    files = []
    for d in ("train_data", "train_data_more"):
        for scene in sorted(os.listdir(os.path.join(tmp, d))):
            for f in sorted(os.listdir(os.path.join(tmp, d, scene))):
                files.append(os.path.join(d, scene, f))
    filelist = os.path.join(tmp, "reservoir_tiles.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(files) + "\n")
    print("reservoir data: 4 more tiles of 128x128 at %d spp written in "
          "%.1f s; %d tiles in all" % (spp, gen_s, len(files)))

    launches = {}
    for tag, flags in (("reservoir", []), ("reservoir_bf16", ["--bf16"])):
        ckpt = os.path.join(tmp, "ckpt_" + tag)
        with _watch_reservoir() as watch:
            iface, launches[tag] = _run_training(
                ops, tag, "the flagship architecture from a reservoir of %d "
                "tiles on the card, batch %d x %d spp x 128x128 (randomized "
                "sample counts)" % (capacity, bs, spp),
                [filelist, ckpt, "--spp", str(spp), "--bs", str(bs),
                 "--ksize", "21", "--device_reservoir", str(capacity),
                 "--refresh_every", "2"] + flags, steps,
                ["progressive_splat", "progressive_splat_dlogits"],
                {"progressive_splat": steps * spp,
                 "progressive_splat_dlogits": steps * spp},
                {"progressive_splat": spp}, "sbmc", owner=DeviceReservoir)
        res = watch.res
        if res is None or res.capacity != capacity or watch.refreshes < 1:
            raise AssertionError("%s: reservoir %s, %d refreshes" % (
                tag, res and res.capacity, watch.refreshes))
        if any(not v.is_cuda for v in res.buffers.values()) or any(
                not v.is_pinned() for v in res._staging.values()):
            raise AssertionError("%s: buffers off the card or staging not "
                                 "pinned" % tag)
        if sum(p.numel() for p in iface.model.parameters()) < 30e6:
            raise AssertionError("the reservoir run was not the flagship "
                                 "architecture")
        gib = sum(v.numel() * v.element_size()
                  for v in res.buffers.values()) / 2 ** 30
        mine = _STEP_MS[tag]
        host = _STEP_MS[tag.replace("reservoir", "train")]
        print("%s against the host loader: %.2f ms/step median (min %.2f, "
              "max %.2f) from the reservoir, %.2f (min %.2f, max %.2f) from "
              "the host loader, same configuration; %d refreshes in %d steps, "
              "buffers and staging in place; %.3f GiB on the card"
              % (tag, *mine, *host, watch.refreshes, steps, gib))
        del iface, res, watch
    _check_refresh_in_place(filelist)
    return launches


def _decode_phase(tmp, reps=3):
    """The native ``.bin`` decoder against the pure-Python one on the
    training phase's synthetic tiles (128x128, 8 spp): it must be the one
    in use, and give the same arrays bit for bit."""
    from sbmc_tpu_torch.data import _native, bin_format

    files = []
    root = os.path.join(tmp, "train_data")
    for scene in sorted(os.listdir(root)):
        files += [os.path.join(root, scene, f)
                  for f in sorted(os.listdir(os.path.join(root, scene)))]
    mod = _native.get()
    if mod is None or os.path.dirname(mod.__file__) != _native.BUILD_DIR:
        raise AssertionError("the native .bin decoder is not in use: %s"
                             % (mod and mod.__file__))

    def read_all():
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            tiles = [bin_format.read_tile(f) for f in files]
            ms = (time.perf_counter() - t0) * 1e3 / len(files)
            best = ms if best is None else min(best, ms)
        return tiles, best

    native, native_ms = read_all()
    plain_get = _native.get
    _native.get = lambda: None
    try:
        python, python_ms = read_all()
    finally:
        _native.get = plain_get
    for a, b in zip(native, python):
        for name in ("pixel_data", "features", "p", "ld", "bt"):
            x, y = getattr(a, name), getattr(b, name)
            if x.dtype != y.dtype or x.shape != y.shape or \
                    x.tobytes() != y.tobytes():
                raise AssertionError("native and Python decoders disagree "
                                     "on %s" % name)
    size = os.path.getsize(files[0]) / 1e6
    print("decode: %d synthetic .bin tiles of 128x128 at 8 spp (%.2f MB "
          "each), best of %d: native decoder (src/fastbin.cpp, %d threads) "
          "%.2f ms/tile, pure-Python %.2f ms/tile (%.1fx); arrays equal bit "
          "for bit" % (len(files), size, reps, min(os.cpu_count() or 1, 8),
                       native_ms, python_ms, python_ms / native_ms))


#: The float32 frame from the imported checkpoint against the frame from
#: the trained weights rounded to float16 in memory: the same weights and
#: code on one card, so they agree to float32 evaluation order, bounded
#: at 2^-20 of the frame's largest |pixel|.
CKPT_EVAL_RTOL = 2.0 ** -20


def _frame_radiance(model, frame):
    with torch.inference_mode():
        return model(frame)["radiance"].float().cpu().numpy()


def _checkpoint_tools_phase(ops, tmp, spp=4):
    """Export the float32 reservoir run's checkpoint to a float16 snapshot,
    import it back, and denoise the 256x256 frame from both through the
    CLI. The imported parameters must be the trained ones rounded to
    float16, bit for bit, and the frame from them (float32, the whole frame
    as one tile) the frame from the trained model with its weights rounded
    to float16 in memory, within CKPT_EVAL_RTOL; the trained frame's
    difference from it, the rounding's effect, is printed."""
    from sbmc_tpu_torch import denoise, export_params
    from sbmc_tpu_torch.data.datasets import FullImagesDataset
    from sbmc_tpu_torch.params import flatten
    from sbmc_tpu_torch.train.checkpointer import Checkpointer
    from sbmc_tpu_torch.utils import exr

    src = os.path.join(tmp, "ckpt_reservoir")
    snap = os.path.join(tmp, "snapshot_reservoir")
    imported = os.path.join(tmp, "ckpt_imported")
    t0 = time.perf_counter()
    steps = (export_params.main(export_params.parse_args(
        ["export", src, snap])), export_params.main(
            export_params.parse_args(["import", snap, imported])))
    tools_s = time.perf_counter() - t0
    trained = flatten(Checkpointer(src).load_params()[0])
    back = flatten(Checkpointer(imported).load_params()[0])
    if sorted(trained) != sorted(back) or steps[0] != steps[1] or any(
            back[k].dtype != np.float32 or not np.array_equal(
                back[k], trained[k].astype(np.float16).astype(np.float32))
            for k in trained):
        raise AssertionError("checkpoint tools: steps %s; the imported "
                             "parameters are not the trained ones rounded "
                             "to float16" % (steps,))
    for name, ckpt in (("trained", src), ("imported", imported)):
        out = os.path.join(tmp, "out_" + name, "frame.exr")
        ops.reset_launch_counts()
        res = denoise.main(denoise.parse_args(
            ["--input", os.path.join(tmp, "data"), "--checkpoint", ckpt,
             "--output", out, "--uniform_tiles", "--tile_size", "160",
             "--tile_pad", "32", "--spp", str(spp), "--device", "cuda"]))
        want = {"progressive_splat": res[0]["tiles"] * spp}
        if _nonzero(ops.launch_counts) != want:
            raise AssertionError("denoise from the %s checkpoint launched "
                                 "%s, expected %s" % (
                                     name, _nonzero(ops.launch_counts),
                                     want))
        img = exr.read(out)
        if img.shape != (256, 256, 3) or not np.isfinite(img).all():
            raise AssertionError("denoise from the %s checkpoint wrote %s "
                                 "(finite: %s)" % (name, img.shape,
                                                   np.isfinite(img).all()))
    counts = dict(ops.launch_counts)
    device = torch.device("cuda")
    model, meta, _ = denoise.load_model(src, device)
    data_params = dict(meta["data_params"], spp=spp)
    item = FullImagesDataset(os.path.join(tmp, "data"), **data_params)[0]
    frame = {k: torch.from_numpy(np.ascontiguousarray(v[None])).to(device)
             for k, v in item.items() if isinstance(v, np.ndarray)}
    trained_frame = _frame_radiance(model, frame)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.half().float())
    rounded = _frame_radiance(model, frame)
    del model
    back_frame = _frame_radiance(denoise.load_model(imported, device)[0],
                                 frame)
    tol = CKPT_EVAL_RTOL * np.abs(rounded).max()
    err = np.abs(back_frame - rounded).max()
    if not (np.isfinite(back_frame).all() and err <= tol):
        raise AssertionError("checkpoint tools: the frame from the imported "
                             "checkpoint differs from the trained weights' "
                             "rounded to float16 by %.3g (tolerance %.3g)"
                             % (err, tol))
    diff = np.abs(back_frame - trained_frame)
    print("checkpoint tools: step-%d checkpoint exported to a float16 "
          "snapshot (%.1f MB) and imported back in %.1f s, the parameters "
          "the trained ones rounded to float16 bit for bit; the 256x256 "
          "float32 frame from the snapshot is the trained weights' rounded "
          "to float16 within %.3g (tolerance 2^-20 of max |pixel|, %.3g); "
          "the rounding moved the frame (mean |pixel| %.4g) by max %.3g, "
          "mean %.3g" % (steps[0], os.path.getsize(os.path.join(
              snap, "params_f16.msgpack")) / 1e6, tools_s, err, tol,
              np.abs(trained_frame).mean(), diff.max(), diff.mean()))
    return counts


def _trace_phase(ops, tmp, checkpoint, spp=4):
    """``sbmc_tpu_torch.denoise --trace`` on the 256x256 frame with the
    flagship: the Chrome trace must name the forward kernel ``psf_tma``."""
    from sbmc_tpu_torch import denoise

    trace_dir = os.path.join(tmp, "trace")
    ops.reset_launch_counts()
    res = denoise.main(denoise.parse_args(
        ["--input", os.path.join(tmp, "data"), "--checkpoint", checkpoint,
         "--output", os.path.join(tmp, "out_trace", "frame.exr"),
         "--uniform_tiles", "--tile_size", "160", "--tile_pad", "32",
         "--spp", str(spp), "--device", "cuda", "--trace", trace_dir]))
    path = os.path.join(trace_dir, denoise.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    psf = [e for e in events if "psf_tma" in e.get("name", "")
           and e.get("cat") == "kernel"]
    launches = ops.launch_counts["progressive_splat"]
    if launches != res[0]["tiles"] * spp or len(psf) != launches:
        raise AssertionError("trace: %d psf_tma kernel events for %d "
                             "launches" % (len(psf), launches))
    print("trace: %s (%.1f MB, %d events) names psf_tma: %d kernel events, "
          "%.4f ms on the device in all, for %d launches"
          % (path, os.path.getsize(path) / 1e6, len(events), len(psf),
             sum(e.get("dur", 0) for e in psf) / 1e3, launches))
    return dict(ops.launch_counts)


# ---------------------------------------------------------------------------
# Phase 11: the wavefront renderer (R1 tri_nearest, R2 tri_any, R3 threefry)

#: R1 and R2 against their plain versions: relative bound on t (the kernel
#: contracts the dot products into fused multiply-adds, the plain version
#: rounds every operation), scaled by the condition number of t's numerator
#: over TRI_COND where it cancels (grazing angles); and the barycentric
#: distance (float64) from an edge within which a crossing is borderline.
#: A ray may differ between the two only where its test is borderline
#: (_tri_borderline), at most 1 ray in 10^4.
TRI_T_RTOL, TRI_EDGE, TRI_COND = 1e-5, 1e-4, 8.0
#: Float32 ulps of the magnitudes u and v are summed from that widen the
#: edge margin where they exceed TRI_EDGE: for small triangles seen from
#: afar float32 rounding moves a crossing by more than TRI_EDGE
#: (tests/test_torch_render_hits.py holds the plain version within half of
#: the widened margin).
TRI_ULPS = 4.0
#: The card's render against the port's CPU render: the share of samples
#: (pixels for the pixel records) beyond 1e-3 + 1e-3 |CPU|, 0 for the camera
#: records and at most RENDER_SHARE for every other. 11b also plants faults
#: in the card's shading (_render_faults) and fails unless each one moves
#: some record past the limit.
RENDER_SHARE = 0.01
#: An origin this far out is a miss point (pathtracer._INF = 1e10 along the
#: ray): the path discards that ray's hits and shadows.
PATH_DEAD_ORG = 1e9
#: The datagen CLI's configuration: the corpus the JAX package rendered.
DATAGEN = ["--renderer", "wavefront", "--count", "2", "--width", "256",
           "--height", "256", "--tile_size", "128", "--spp", "8",
           "--gt_spp", "512"]
#: Plain versions of R1/R2 run on this many rays at a time ([rays, T]
#: intermediates of a dozen kinds must fit the card).
PLAIN_CHUNK = 1 << 16
#: 32-bit integer issue rate of one H100 SXM: each of the 132 SMs issues 64
#: INT32-pipe and 64 FMA-pipe lanes a clock (nvcc routes integer adds and
#: shifts to the FMA pipe as IMAD), at the 1.98 GHz boost clock (Hopper
#: architecture white paper): the integer counterpart of H100_F32_FLOPS.
H100_INT32_OPS = 128 * 132 * 1.98e9
#: Operations of one ray x triangle test (six 3-term dot products, the
#: division, the barycentric tests) and of one threefry value (20 rounds of
#: add, rotate and xor, 5 key injections, the float conversion).
TRI_PAIR_OPS, THREEFRY_OPS = 50, 80


def _render_scene(seed, n_meshes=2, moving=False, pools=None):
    from sbmc_tpu_torch.render import scene as rscene
    sc = rscene.random_tracer_scene(np.random.RandomState(seed),
                                    n_meshes=n_meshes, obj_prob=1.0,
                                    **(pools or {}))
    if moving:
        sc.motion = np.random.RandomState(seed + 1).normal(
            0, 0.5, sc.motion.shape)
    return sc


def _tri_rays(gen, sc, n):
    """``n`` rays around the camera: most towards the centroids of the real
    triangles (jittered), some at random, plus a NaN ray, rays parallel to
    the first triangle and through its vertex, edge and hypotenuse."""
    dev = torch.device("cuda")
    cam = torch.tensor(sc.cam_pos, dtype=torch.float32, device=dev)
    org = cam + 0.3 * torch.randn(n, 3, device=dev, generator=gen)
    real = np.abs(np.cross(sc.tri_e1, sc.tri_e2)).sum(1) > 0
    cent = (sc.tri_v0 + (sc.tri_e1 + sc.tri_e2) / 3)[real]
    if not len(cent):
        cent = sc.centers
    cent = torch.tensor(cent, dtype=torch.float32, device=dev)
    pick = torch.randint(0, len(cent), (n,), device=dev, generator=gen)
    target = cent[pick] + 0.1 * torch.randn(n, 3, device=dev, generator=gen)
    target[: n // 10] = 5 * torch.randn(n // 10, 3, device=dev,
                                        generator=gen)
    dirs = target - org
    if len(sc.tri_v0):
        v0, e1, e2 = (np.asarray(x[0], np.float64) for x in
                      (sc.tri_v0, sc.tri_e1, sc.tri_e2))
        special = [v0, v0 + 0.5 * e1, v0 + 0.5 * (e1 + e2)]
        org[-5:] = torch.tensor(np.stack([sc.cam_pos] * 4 + [
            v0 - 2.0 * np.cross(e1, e2)]), dtype=torch.float32, device=dev)
        dirs[-5] = float("nan")
        for i, p in enumerate(special):
            dirs[-4 + i] = torch.tensor(p - sc.cam_pos, device=dev)
        dirs[-1] = torch.tensor(e1, device=dev)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    time_ = torch.rand(n, device=dev, generator=gen)
    return org.contiguous(), dirs.contiguous(), time_


def _tri_f64(tris, org, dirs, time_, idx=None):
    """Ray i against triangle ``idx[i]`` (``[n]``), or against every
    triangle (``[n, T]``) where ``idx`` is None, in float64: the distance t,
    the barycentric margin min(u, v, 1 - u - v) (negative outside), the
    denominator d.n, the condition number of t = (cn + tt mn - o.n) / (d.n)
    (the sum of the numerator's terms' magnitudes over the numerator's: its
    cancellation magnifies the terms' ulps at grazing angles), and the
    margin within which float32 may put the crossing on either side of an
    edge: TRI_EDGE, or TRI_ULPS float32 ulps of the magnitudes u and v are
    summed from, t's error included, where that is more."""
    c = tris.double()
    c = c[idx.long()][:, None] if idx is not None else c[None]
    o, d = org.double()[:, None], dirs.double()[:, None]
    tt = time_.double()[:, None]

    def dot(v, a):
        return (v * c[..., a:a + 3]).sum(-1)

    def mag(v, a):
        return (v * c[..., a:a + 3]).abs().sum(-1)

    den = dot(d, 0)
    terms = (c[..., 9], tt * c[..., 12], dot(o, 0))
    num = terms[0] + terms[1] - terms[2]
    t = num / den
    u = dot(o, 3) - c[..., 10] - tt * c[..., 13] + t * dot(d, 3)
    v = dot(o, 6) - c[..., 11] - tt * c[..., 14] + t * dot(d, 6)
    cond = sum(x.abs() for x in terms) / num.abs()
    uv_mag = sum(mag(o, g) + c[..., k].abs() + (tt * c[..., m]).abs()
                 + t.abs() * mag(d, g) * (1 + cond)
                 for g, k, m in ((3, 10, 13), (6, 11, 14)))
    edge = torch.clamp_min(TRI_ULPS * 2.0 ** -24 * uv_mag, TRI_EDGE)
    out = (t, torch.minimum(torch.minimum(u, v), 1 - u - v), den, cond,
           edge)
    return tuple(x[:, 0] for x in out) if idx is not None else out


def _tri_rtol(cond):
    """TRI_T_RTOL, widened by the condition number of t over TRI_COND."""
    return TRI_T_RTOL * torch.clamp_min(cond / TRI_COND, 1.0)


def _tri_borderline(tris, org, dirs, time_, idx, t_max=None):
    """Whether ray i's test against triangle ``idx[i]`` lies within the
    rounding of a decision: its crossing within _tri_f64's edge margin of
    an edge, its t within _tri_rtol of the 1e-3 floor or of ``t_max``
    (R2's dist - 1e-3), or its denominator at the 1e-9 parallel cut."""
    t, margin, den, cond, edge = _tri_f64(tris, org, dirs, time_, idx)
    tol = _tri_rtol(cond)
    near = (margin.abs() < edge) | ((t - 1e-3).abs() <= tol * 1e-3)
    near |= (den.abs() - 1e-9).abs() <= 1e-9 * TRI_T_RTOL
    if t_max is not None:
        near |= (t - t_max).abs() <= tol * t_max.abs()
    return near


def _plain_chunks(fn, *args):
    """The plain version over the rays in chunks of PLAIN_CHUNK."""
    n = args[0].shape[0]
    outs = [fn(*(a[i:i + PLAIN_CHUNK] for a in args[:-1]), args[-1])
            for i in range(0, n, PLAIN_CHUNK)]
    return (tuple(torch.cat(parts) for parts in zip(*outs))
            if isinstance(outs[0], tuple) else torch.cat(outs))


def _tri_fault(name, what, ok, details):
    """Raises for the rays of ``details`` (one dict a differing ray) that
    are not ``ok``, or for all of them where every one is but they are too
    many."""
    bad = [d for d, good in zip(details, ok.tolist()) if not good] or details
    raise AssertionError("%s (%s): %d of %d differing rays not borderline, "
                         "at most 1 in 10^4 may differ: %s" % (
                             name, what, int((~ok).sum()), len(ok),
                             bad[:8]))


def _tri_variants(ops, name):
    """(counter, label, call) of each kernel of R1 (``name``
    "tri_nearest") or R2 ("tri_any"): the tiled kernel through the op and
    the generic kernel."""
    cuda = getattr(ops, "_%s_cuda" % name)

    def generic(*args):
        return cuda(*args, route="generic")

    return ((name, "tiled", getattr(ops, name)),
            (name + "_generic", "generic", generic))


def _check_nearest(ops, org, dirs, time_, tris, what, nan_ray=True):
    """R1's kernels (_tri_variants) against its plain version on the card.
    t must agree within _tri_rtol; a ray whose hit or index differs must be
    borderline (_tri_borderline) on the kernel's or the plain version's
    triangle, and such rays may number at most 1 in 10^4. ``nan_ray``: the
    inputs are _tri_rays', whose fifth-last ray is NaN and must miss.
    Returns {label: (max abs t error where t agrees, borderline rays)} and
    the number of rays on which the tiled kernel's t (bits), index or flag
    differ from the generic kernel's."""
    from sbmc_tpu_torch.ops import reference as ref
    pt, pidx, pback = _plain_chunks(ref.tri_nearest_ref, org, dirs, time_,
                                    tris)
    two = None
    if tris.shape[0] > 1:
        # The index and flag must agree unless the two best t are close.
        two = []
        for i in range(0, org.shape[0], PLAIN_CHUNK):
            ts, _ = ref.tri_hits_ref(org[i:i + PLAIN_CHUNK],
                                     dirs[i:i + PLAIN_CHUNK],
                                     time_[i:i + PLAIN_CHUNK], tris)
            two.append(torch.topk(ts, 2, dim=1, largest=False).values)
        two = torch.cat(two)
    results, outs = {}, {}
    for name, label, kernel in _tri_variants(ops, "tri_nearest"):
        t, idx, back = kernel(org, dirs, time_, tris)
        torch.cuda.synchronize()
        outs[label] = (t.view(torch.int32), idx, back)
        close = (t - pt).abs() <= TRI_T_RTOL * pt.abs()
        if not bool(close.all()) and tris.shape[0]:
            cond = _tri_f64(tris, org, dirs, time_, pidx)[3]
            close |= (t - pt).abs() <= _tri_rtol(cond).float() * pt.abs()
        differ = ~close
        if two is not None:
            clear = close & ((two[:, 1] - two[:, 0]) > TRI_T_RTOL * two[:, 0])
            differ |= clear & ((idx != pidx) | (back != pback))
        rows = torch.nonzero(differ)[:, 0]
        if len(rows):
            sub = (org[rows], dirs[rows], time_[rows])
            ok = ((_tri_borderline(tris, *sub, idx[rows])
                   & (t[rows] < ref.TRI_MISS))
                  | (_tri_borderline(tris, *sub, pidx[rows])
                     & (pt[rows] < ref.TRI_MISS)))
            if not bool(ok.all()) or \
                    len(rows) > max(1, org.shape[0] // 10000):
                fk = _tri_f64(tris, *sub, idx[rows])
                fp = _tri_f64(tris, *sub, pidx[rows])
                _tri_fault("%s (%s)" % (name, label), what, ok, [dict(
                    ray=int(r), t=(float(t[r]), float(pt[r])),
                    idx=(int(idx[r]), int(pidx[r])),
                    margin=(float(fk[1][j]), float(fp[1][j])),
                    edge=(float(fk[4][j]), float(fp[4][j])))
                    for j, r in enumerate(rows.tolist()[:64])])
        if nan_ray and org.shape[0] > 5 and bool(t[-5] != ref.TRI_MISS):
            raise AssertionError("%s (%s, %s): the NaN ray hit"
                                 % (name, label, what))
        err = float((t - pt)[close].abs().max()) if bool(close.any()) \
            else 0.0
        _note_err(name, err)
        results[label] = (err, len(rows))
        del t, idx, back
    a, b = outs["tiled"], outs["generic"]
    same = (a[0] == b[0]) & (a[1] == b[1]) & (a[2] == b[2])
    return results, int((~same).sum())


def _check_any(ops, org, dirs, dist, tris, what):
    """R2's kernels (_tri_variants) against its plain version on the card.
    Where one differs from it, no triangle may block the ray clearly (t
    inside (1e-3, dist - 1e-3) and the crossing inside the triangle, each
    beyond its rounding margin) and one must be borderline
    (_tri_borderline); such rays may number at most 1 in 10^4. Returns
    {label: their number} and the number of rays on which the tiled and
    generic kernels differ."""
    from sbmc_tpu_torch.ops import reference as ref
    pblocked = _plain_chunks(ref.tri_any_ref, org, dirs, dist, tris)
    results, outs = {}, {}
    for name, label, kernel in _tri_variants(ops, "tri_any"):
        blocked = kernel(org, dirs, dist, tris)
        torch.cuda.synchronize()
        outs[label] = blocked
        rows = torch.nonzero(blocked != pblocked)[:, 0]
        if len(rows):
            t_max = (dist[rows] - 1e-3).double()[:, None]
            zero = torch.zeros_like(dist[rows])
            t, margin, den, cond, edge = _tri_f64(tris, org[rows],
                                                  dirs[rows], zero)
            tol = _tri_rtol(cond)
            clear = ((den.abs() > 1e-9 * (1 + TRI_T_RTOL))
                     & (margin >= edge) & (t > 1e-3 * (1 + tol))
                     & (t < t_max - tol * t_max.abs()))
            maybe = ((den.abs() > 1e-9 * (1 - TRI_T_RTOL))
                     & (margin > -edge) & (t > 1e-3 * (1 - tol))
                     & (t < t_max + tol * t_max.abs()))
            ok = ~clear.any(1) & maybe.any(1)
            if not bool(ok.all()) or \
                    len(rows) > max(1, org.shape[0] // 10000):
                _tri_fault("%s (%s)" % (name, label), what, ok, [dict(
                    ray=int(r), blocked=(bool(blocked[r]),
                                         bool(pblocked[r])),
                    dist=float(dist[r]), clear=int(clear[j].sum()),
                    borderline=int((maybe[j] & ~clear[j]).sum()))
                    for j, r in enumerate(rows.tolist()[:64])])
        # R2's outputs are booleans: its error is 1 where a ray flipped.
        _note_err(name, float(len(rows) > 0))
        results[label] = len(rows)
    return results, int((outs["tiled"] != outs["generic"]).sum())


def _real_tris(tris):
    """One past the last triangle that is not degenerate (n != 0): the
    scene's power-of-two padding after it is never hit."""
    real = torch.nonzero((tris[:, :3] != 0).any(1))[:, 0]
    return int(real.max()) + 1 if len(real) else 0


def _tri_first_blockers(org, dirs, dist, tris, t_n=None):
    """Ray x triangle pairs R2 must test on these inputs: up to and with
    each ray's first blocker, all ``t_n`` (by default T) where none
    blocks."""
    from sbmc_tpu_torch.ops import reference as ref
    pairs = 0
    t_n = tris.shape[0] if t_n is None else t_n
    for i in range(0, org.shape[0], PLAIN_CHUNK):
        ts, _ = ref.tri_hits_ref(org[i:i + PLAIN_CHUNK],
                                 dirs[i:i + PLAIN_CHUNK],
                                 torch.zeros_like(dist[i:i + PLAIN_CHUNK]),
                                 tris)
        hit = ts < (dist[i:i + PLAIN_CHUNK] - 1e-3)[:, None]
        first = torch.where(hit.any(1), hit.int().argmax(1) + 1, t_n)
        pairs += int(first.sum())
    return pairs


def _r3_check(ops):
    """R3 bit for bit against its plain version and the host numpy keys,
    bits and floats, at several key counts and sizes (n not a multiple of
    the 256-thread block too)."""
    from sbmc_tpu_torch.ops import reference as ref
    from sbmc_tpu_torch.render import prng
    cases = 0
    for n_keys, n in ((1, 1), (3, 255), (5, 257), (35, 16384), (6, 49152),
                      (2240, 16384)):
        keys = np.stack([prng.fold_in(prng.PRNGKey(5), i)
                         for i in range(n_keys)])
        dk = torch.from_numpy(keys.view(np.int32)).cuda()
        for lo, hi in ((0.0, 1.0), (prng.NORMAL_LO, 1.0), (-2.5, 3.0)):
            got = ops.random_uniform(dk, n, lo, hi)
            want = ref.threefry_uniform_ref(dk, n, lo, hi)
            if not bool((got.view(torch.int32)
                         == want.view(torch.int32)).all()):
                raise AssertionError("threefry_uniform differs from its plain "
                                     "version at %d keys x %d in [%g, %g)"
                                     % (n_keys, n, lo, hi))
            host = got[:4].cpu().numpy()
            for i in range(min(4, n_keys)):
                if not np.array_equal(host[i].view(np.uint32), prng.uniform(
                        keys[i], n, lo, hi).view(np.uint32)):
                    raise AssertionError("threefry_uniform differs from the "
                                         "host numpy draw")
            cases += 1
        bits = ops.random_bits(dk, n)[:4].cpu().numpy().view(np.uint32)
        for i in range(min(4, n_keys)):
            if not np.array_equal(bits[i], prng.random_bits(keys[i], n)):
                raise AssertionError("threefry bits differ from the host's")
    return cases


def _render_kernel_phase(ops):
    """11a: R1-R3 against their plain versions on the card (R1 and R2: the
    tiled kernels and the generic ones), then
    timed at the renderer's path shape (a 64-pass wavefront of a 128x128
    tile: 1048576 rays) against the largest triangle bucket."""
    from sbmc_tpu_torch.ops import reference as ref
    from sbmc_tpu_torch.render import assets as rassets
    from sbmc_tpu_torch.render import pathtracer
    gen = torch.Generator(device="cuda").manual_seed(0)
    pools = {"obj_pool": rassets.ObjPool(os.path.join(ROOT, "assets",
                                                      "objs"))}
    errs, flips, apart = {}, {}, [0, 0]
    buckets = {}
    for what, sc in (("T=0", _render_scene(2, n_meshes=0)),
                     ("T=64", _render_scene(4, n_meshes=2)),
                     ("moving mesh", _render_scene(5, moving=True,
                                                   pools=pools)),
                     ("largest bucket", _largest_bucket_scene(pools)),
                     ("capacity", _largest_bucket_scene(pools, 4))):
        scn = pathtracer.prepare_scene(sc, "cuda")
        tris = scn["tris"]
        buckets[what] = tris.shape[0]
        org, dirs, time_ = _tri_rays(gen, sc, 1 << 17)
        dist = 15 * torch.rand(org.shape[0], device="cuda", generator=gen)
        dist[:2] = torch.tensor([ref.TRI_MISS, float("nan")])
        near, d_near = _check_nearest(ops, org, dirs, time_, tris, what)
        anyr, d_any = _check_any(ops, org, dirs, dist, tris, what)
        for label, (err, f) in near.items():
            errs[label] = max(errs.get(label, 0.0), err)
            flips[label] = [flips.get(label, [0, 0])[0] + f,
                            flips.get(label, [0, 0])[1] + anyr[label]]
        apart[0] += d_near
        apart[1] += d_any
    if buckets != {"T=0": 0, "T=64": 64, "moving mesh": 512,
                   "largest bucket": 1024, "capacity": ops.TRI_TILED_MAX}:
        raise AssertionError("triangle buckets %s" % buckets)
    r3_cases = _r3_check(ops)
    _note_err("threefry_uniform", 0.0)
    print("render kernels: tri_nearest and tri_any agree with their plain "
          "versions at T %s (131072 rays each: hits, misses, a NaN ray, "
          "rays parallel to a face and through a vertex and edges; a moving "
          "mesh): max |t err| %s (rel bound %g); borderline rays "
          "[tri_nearest, tri_any] %s; the tiled kernels differ from the "
          "generic ones on %d tri_nearest and %d tri_any rays; "
          "threefry_uniform bit-exact against its plain version and the "
          "host numpy draws in %d cases"
          % (sorted(buckets.values()), json.dumps(errs), TRI_T_RTOL,
             json.dumps(flips), apart[0], apart[1], r3_cases))
    return _render_kernel_times(ops, gen, pools)


def _largest_bucket_scene(pools, n_meshes=2):
    """A scene of ``n_meshes`` of the repo's largest mesh (360 faces each):
    two give 1024 triangles, the largest bucket the CLI's scenes give; four
    give 2048, the tiled hit kernels' capacity."""
    from sbmc_tpu_torch.render import scene as rscene
    pool = pools["obj_pool"]
    big = max(pool.paths, key=lambda p: len(pool._load(p)[1]))

    class _One:
        def sample(self, rng):
            return pool._load(big)

    return rscene.random_tracer_scene(np.random.RandomState(6),
                                      n_meshes=n_meshes, obj_pool=_One(),
                                      obj_prob=1.0)


def _render_kernel_times(ops, gen, pools):
    """R1-R3 timed at the renderer's path shape: ``ms`` on the host clock
    through the op, ``device_ms`` by CUDA-graph replay, the plain versions
    (R1, R2 in chunks of PLAIN_CHUNK rays) on the same inputs; the tiled R1
    and R2 and the generic ones in turns, twice; then R1 and R2 at the
    tiled kernels' capacity, 2048 triangles.
    The tiled kernels skip the degenerate padding after the last real
    triangle, so R1's bound counts n x T_real pairs and R2's the pairs up
    to each ray's first blocker, T_real where none blocks; the line gives
    the bound over all T (padding included) beside it."""
    from sbmc_tpu_torch.ops import reference as ref
    from sbmc_tpu_torch.render import pathtracer, prng
    numbers = {}
    for n_meshes in (2, 4):
        sc = _largest_bucket_scene(pools, n_meshes)
        tris = pathtracer.prepare_scene(sc, "cuda")["tris"]
        n, t_n = pathtracer._WAVEFRONT_RAYS, tris.shape[0]
        t_real = _real_tris(tris)
        org, dirs, time_ = _tri_rays(gen, sc, n)
        dist = 15 * torch.rand(n, device="cuda", generator=gen)
        what = "%d rays x %d triangles" % (n, t_n)
        near, d_near = _check_nearest(ops, org, dirs, time_, tris, what)
        anyr, d_any = _check_any(ops, org, dirs, dist, tris, what)
        print("render kernels at (%s, %d real), the ground-truth passes' "
              "wavefront: tri_nearest max |t err| and borderline rays %s; "
              "tri_any borderline rays %s; the tiled kernels differ from "
              "the generic ones on %d tri_nearest and %d tri_any rays"
              % (what, t_real, json.dumps(near), json.dumps(anyr), d_near,
                 d_any))
        blockers = {t: _tri_first_blockers(org, dirs, dist, tris, t)
                    for t in (t_n, t_real)}
        timed = {}
        for name, args in (("tri_nearest", (org, dirs, time_, tris)),
                           ("tri_any", (org, dirs, dist, tris))):
            cuda = getattr(ops, "_%s_cuda" % name)
            calls = {
                "tiled": lambda: getattr(ops, name)(*args),
                "generic": lambda: cuda(*args, route="generic")}
            # In turns: tiled, generic, generic, tiled.
            order = list(calls) + list(calls)[::-1]
            dev = {k: [] for k in calls}
            for k in order:
                dev[k].append(_graph_ms(calls[k]))
            host = {k: _time_ms(calls[k], 3, 20) for k in calls}
            pairs = (n * np.array([t_n, t_real]) if name == "tri_nearest"
                     else np.array([blockers[t_n], blockers[t_real]]))
            bounds = pairs * TRI_PAIR_OPS / H100_F32_FLOPS * 1e3
            nbytes = n * 28 + t_n * 64 + n * (9 if name == "tri_nearest"
                                              else 1)
            bound_ms = max(float(bounds[1]), nbytes / H100_BYTES_PER_S * 1e3)
            timed[name] = dict(dev=dev, host=host, bound_ms=bound_ms,
                               bound_all_ms=float(bounds[0]))
            print("%s at (%s, %d real): device ms by kernel, in turns %s; "
                  "host clock %s; bound %.4f ms over the real triangles "
                  "(%.4f ms over all %d, padding included); shares %s"
                  % (name, what, t_real, json.dumps(dev), json.dumps(host),
                     bound_ms, bounds[0], t_n, json.dumps({
                         k: "%.0f%% / %.0f%%" % (
                             100 * bound_ms / min(v),
                             100 * bounds[0] / min(v))
                         for k, v in dev.items()})))
        for name, plain, args in (
                ("tri_nearest", ref.tri_nearest_ref, (org, dirs, time_, tris)),
                ("tri_any", ref.tri_any_ref, (org, dirs, dist, tris))):
            tm = timed[name]
            for key, kernel in (("tiled", name),
                                ("generic", name + "_generic")):
                row = dict(shape=what, ms=tm["host"][key],
                           device_ms=min(tm["dev"][key]),
                           bound_ms=tm["bound_ms"], bound_by="operations",
                           bound_all_triangles_ms=tm["bound_all_ms"],
                           real_triangles=t_real)
                if n_meshes == 4:
                    numbers[kernel]["other_shapes"].append(row)
                    continue
                if key == "tiled":
                    plain_ms = _time_ms(lambda: _plain_chunks(plain, *args),
                                        1, 2)
                numbers[kernel] = dict(row, plain_ms=plain_ms,
                                       max_abs_err=_MAX_ERR[kernel],
                                       other_shapes=[])
        del org, dirs, time_, dist
        torch.cuda.empty_cache()
    keys = torch.from_numpy(np.concatenate([
        pathtracer.pass_keys(prng.fold_in(prng.PRNGKey(1), i))[0]
        for i in range(64)]).view(np.int32)).cuda()
    per_pass = 128 * 128
    kernel = lambda: ops.random_uniform(keys, per_pass)  # noqa: E731
    ms = _time_ms(kernel, 3, 20)
    device_ms = _graph_ms(kernel)
    plain_ms = _time_ms(lambda: ref.threefry_uniform_ref(keys, per_pass), 1,
                        2)
    nbytes = keys.numel() * 4 + keys.shape[0] * per_pass * 4
    by_bytes = nbytes / H100_BYTES_PER_S
    by_ops = keys.shape[0] * per_pass * THREEFRY_OPS / H100_INT32_OPS
    bound_ms = max(by_bytes, by_ops) * 1e3
    by = "bytes" if by_bytes >= by_ops else "operations"
    tag = "%d keys x %d values" % (keys.shape[0], per_pass)
    print("threefry_uniform at (%s): %.4f ms, %s, %.4f ms on the device, %s; "
          "plain version %.4f ms; bound %.4f ms (%s)"
          % (tag, ms, _share(ms, bound_ms), device_ms,
             _share(device_ms, bound_ms), plain_ms, bound_ms, by))
    numbers["threefry_uniform"] = dict(
        shape=tag, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=by,
        max_abs_err=_MAX_ERR["threefry_uniform"], other_shapes=[])
    return numbers


def _tile_share(got, want, axis):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want) > 1e-3 + 1e-3 * np.abs(want)).any(
        axis).mean())


def _render_tile_phase(ops):
    """11b: one 32x32 tile of a random scene with meshes, textures and an
    envmap, rendered on the card and with the port on the CPU (the plain
    versions of R1-R3)."""
    from sbmc_tpu_torch.render import assets as rassets
    from sbmc_tpu_torch.render import pathtracer, prng
    a = os.path.join(ROOT, "assets")
    pools = dict(obj_pool=rassets.ObjPool(os.path.join(a, "objs")),
                 tex_pool=rassets.TexturePool(os.path.join(a, "textures")),
                 env_pool=rassets.EnvmapPool(os.path.join(a, "envmaps")))
    sc = _render_scene(1, pools=pools)
    kw = dict(ts=32, spp=2, gt_spp=4, block_x=32, block_y=0,
              image_width=64, image_height=32)

    def render(device):
        return pathtracer.render_tile_wavefront(sc, prng.PRNGKey(3),
                                                device=device, **kw)

    cpu = render("cpu")
    card = render("cuda")
    shares = _render_shares(card, cpu)
    bad = {k: v for k, v in shares.items()
           if v > (0.0 if k == "camera" else RENDER_SHARE)}
    if bad or not all(np.isfinite(x).all() for x in (
            card.features, card.pixel_data, card.p, card.ld)):
        raise AssertionError("card render vs CPU render: shares %s over "
                             "their bounds" % bad)
    # The limits against faults planted in the card's shading.
    planted = {}
    for name, fn, fault in _render_faults(pathtracer):
        plain = getattr(pathtracer, fn)
        setattr(pathtracer, fn, fault(plain))
        try:
            planted[name] = _render_shares(render("cuda"), cpu)
        finally:
            setattr(pathtracer, fn, plain)
        if max(planted[name].values()) <= RENDER_SHARE:
            raise AssertionError("card render vs CPU render: a planted "
                                 "fault (%s) stays within the limits: %s"
                                 % (name, planted[name]))
    print("render tile: 32x32, 2 spp, gt 4, %d triangles, image textures "
          "and an envmap: share of samples beyond 1e-3 + 1e-3|CPU| on the "
          "card vs the port on the CPU %s (limits 0 camera, %g the rest); "
          "with a fault planted on the card %s" % (
              len(sc.tri_v0), json.dumps(_rounded(shares)), RENDER_SHARE,
              json.dumps({k: _rounded(v) for k, v in planted.items()})))


def _rounded(shares):
    return {k: round(v, 5) for k, v in shares.items() if v}


def _render_shares(card, cpu):
    """Share of samples (pixels for the pixel records) of each record
    group that differ beyond 1e-3 + 1e-3 |CPU|."""
    f, g = card.features, cpu.features
    return {"camera": _tile_share(f[:, :5], g[:, :5], 1),
            "radiance": _tile_share(f[:, 5:11], g[:, 5:11], 1),
            "geometry": _tile_share(f[:, 11:21], g[:, 11:21], 1),
            "albedo": _tile_share(f[:, 21:], g[:, 21:], 1),
            "pixels": _tile_share(card.pixel_data, cpu.pixel_data, 0),
            "p": _tile_share(card.p, cpu.p, 1),
            "ld": _tile_share(card.ld, cpu.ld, 1),
            "bt": _tile_share(card.bt, cpu.bt, 1)}


def _render_faults(pathtracer):
    """(name, function of ``pathtracer``, wrapper planting a fault): image
    textures and the envmap read one texel off, the glossy pdf 1% off, the
    checker texture's albedo 1% off."""
    from sbmc_tpu_torch.render.scene import TEX_CHECKER3D

    def texel(f):
        return lambda images, ids, u, v: f(images, ids, u,
                                           v - 1.0 / images.shape[1])

    def env_texel(f):
        return lambda flat, row, col, h, w, base, wrap_rows: f(
            flat, row, col if wrap_rows else col - 1.0, h, w, base,
            wrap_rows)

    def pdf(f):
        return lambda *args: f(*args) / 1.01

    def checker(f):
        def faulty(kind, q, phase):
            out = f(kind, q, phase)
            return out + 0.01 * torch.as_tensor(
                kind == TEX_CHECKER3D, device=out.device).to(out.dtype)
        return faulty

    return (("texture texel", "_sample_image_stack", texel),
            ("envmap texel", "_bilinear_gather", env_texel),
            ("glossy pdf", "_phong_pdf", pdf),
            ("checker", "_tex_mod", checker))


class _record_tri_inputs:
    """While active, keeps copies of the inputs the path gives R1 and R2 on
    the card at each (rays, triangles) case: the case's first call (camera
    rays, or their shadow rays) and its fourth (bounce rays). The calls
    themselves go through unchanged."""

    KEEP = (0, 3)

    def __init__(self, ops):
        self.ops = ops
        self.kept = {"tri_nearest": {}, "tri_any": {}}

    def __enter__(self):
        ops, kept = self.ops, self.kept
        self.plain = (ops.tri_nearest, ops.tri_any)
        calls = {}

        def wrap(name, fn):
            def rec(*args):
                if args[0].is_cuda:
                    case = (args[0].shape[0], args[-1].shape[0])
                    i = calls.get((name, case), 0)
                    calls[name, case] = i + 1
                    if i in self.KEEP:
                        kept[name].setdefault(case, []).append(
                            tuple(a.clone() for a in args))
                return fn(*args)
            return rec

        ops.tri_nearest = wrap("tri_nearest", self.plain[0])
        ops.tri_any = wrap("tri_any", self.plain[1])
        return kept

    def __exit__(self, *exc):
        self.ops.tri_nearest, self.ops.tri_any = self.plain


def _check_path_tri(ops, kept, numbers):
    """R1 and R2 (the tiled kernels and the generic ones) held against
    their plain versions on the inputs the path
    gave them (_record_tri_inputs), at every (rays, triangles) case it
    met; the cases go into ``numbers`` as ``path_cases``. A ray that has
    missed everything carries on from its miss point, 1e10 away
    (pathtracer._INF), and the tracer discards its hits and shadows
    (masked by ``hit``): such rays, whose float32 tests at that distance
    are noise, are left out and counted."""
    counts = {"tri_nearest": {}, "tri_any": {}}
    dead = {"tri_nearest": 0, "tri_any": 0}
    apart = {"tri_nearest": 0, "tri_any": 0}
    err = {}
    with torch.inference_mode():
        for name, check in (("tri_nearest", _check_nearest),
                            ("tri_any", _check_any)):
            for case, calls in kept[name].items():
                for org, dirs, x, tris in calls:
                    live = org.abs().amax(1) < PATH_DEAD_ORG
                    dead[name] += int((~live).sum())
                    what = "the CLI's %d rays x %d triangles" % case
                    args = (ops, org[live], dirs[live], x[live], tris, what)
                    if name == "tri_nearest":
                        res, d = check(*args, nan_ray=False)
                        for label, (e, n) in res.items():
                            err[label] = max(err.get(label, 0.0), e)
                            counts[name][label] = \
                                counts[name].get(label, 0) + n
                    else:
                        res, d = check(*args)
                        for label, n in res.items():
                            counts[name][label] = \
                                counts[name].get(label, 0) + n
                    apart[name] += d
    for name in counts:
        for kernel in (name, name + "_generic"):
            numbers[kernel]["path_cases"] = sorted(kept[name])
            numbers[kernel]["max_abs_err"] = _MAX_ERR[kernel]
    print("render path kernels: on the CLI's own inputs (first and fourth "
          "call of each case), tri_nearest at (rays, triangles) %s: max |t "
          "err| %s, borderline rays %s; tri_any at %s: borderline rays %s; "
          "the tiled kernels differ from the generic ones on %s rays; rays "
          "left out from a miss point: %s"
          % (sorted(kept["tri_nearest"]), json.dumps(err),
             json.dumps(counts["tri_nearest"]), sorted(kept["tri_any"]),
             json.dumps(counts["tri_any"]), json.dumps(apart),
             json.dumps(dead)))


def _render_path_phase(ops, tmp, numbers):
    """11c: ``python -m sbmc_tpu_torch.generate_training_data`` at the
    corpus configuration (DATAGEN, the repo's meshes, textures and
    envmaps): the files, read back, R1-R3's launches, and R1 and R2 held
    against their plain versions on the inputs the CLI gave them. Returns
    the corpus folder and the launch counts."""
    from sbmc_tpu_torch import generate_training_data as gtd
    from sbmc_tpu_torch.data import bin_format
    from sbmc_tpu_torch.data.datasets import TilesDataset
    from sbmc_tpu_torch.render import pathtracer
    a = os.path.join(ROOT, "assets")
    out = os.path.join(tmp, "rendered")
    args = gtd.parse_args(["-", "-", a, out] + DATAGEN + [
        "--obj_dir", os.path.join(a, "objs"), "--tex_dir",
        os.path.join(a, "textures"), "--env_dir",
        os.path.join(a, "envmaps"), "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _record_tri_inputs(ops) as kept:
        stats, scenes = gtd.main(args)
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    _check_path_tri(ops, kept, numbers)
    tiles_side = args.width // args.tile_size
    n = args.tile_size * args.tile_size
    batch = max(1, pathtracer._WAVEFRONT_RAYS // n)
    batches = (-(-args.gt_spp // batch) - (-args.spp // batch))
    per_scene = tiles_side * tiles_side * batches
    want = {"tri_nearest": scenes * per_scene * pathtracer.MAX_DEPTH,
            "tri_any": scenes * per_scene * 2 * pathtracer.MAX_DEPTH,
            "threefry_uniform": scenes * per_scene * 2}
    if _nonzero(launches) != want:
        raise AssertionError("datagen launched %s, expected %s"
                             % (_nonzero(launches), want))
    files = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, names in os.walk(out) for f in names)
    if len(files) != scenes * tiles_side ** 2 or scenes != 2:
        raise AssertionError("datagen wrote %s" % files)
    for f in files:
        tile = bin_format.read_tile(os.path.join(out, f))
        if tile.features.shape != (8, 27, 128, 128) or not all(
                np.isfinite(x).all() for x in (tile.features, tile.pixel_data,
                                               tile.p, tile.ld)):
            raise AssertionError("%s: %s, not finite" % (f,
                                                         tile.features.shape))
    ds = TilesDataset(out, spp=8)
    item = ds[0]
    if len(ds) != len(files) or not all(
            np.isfinite(v).all() for v in item.values()
            if isinstance(v, np.ndarray)):
        raise AssertionError("the rendered tiles do not load through "
                             "TilesDataset")
    busy = _render_busy(args)
    print("render path: %d scenes of 256x256 (%d tiles of 128, %d spp, gt "
          "%d, meshes, textures, envmaps): %.2f s/scene; split (s, both "
          "scenes): device %.3f, compile %.3f, host %.3f, write %.3f, sample "
          "%.3f; device busy %s of one tile's render wall clock; peak device "
          "memory %.2f GB; %d pass batches a tile; launches %s; the files "
          "read back through bin_format.read_tile and TilesDataset finite"
          % (scenes, len(files), args.spp, args.gt_spp,
             stats["total"] / scenes, stats["device"], stats["compile"],
             stats["host"], stats["write"], stats["sample"], busy,
             peak / 1e9, batches,
             json.dumps(_nonzero(launches))))
    return out, launches


def _render_busy(args):
    """Device busy share over one more tile of the CLI's configuration: the
    profiler's CUDA kernel time over the tile's wall clock."""
    from torch.profiler import ProfilerActivity, profile
    from sbmc_tpu_torch.render import pathtracer, prng
    from sbmc_tpu_torch.render import assets as rassets
    sc = _render_scene(0, pools={"obj_pool": rassets.ObjPool(os.path.join(
        ROOT, "assets", "objs"))})
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pathtracer.render_tile_wavefront(sc, prng.PRNGKey(0),
                                         ts=args.tile_size, spp=args.spp,
                                         gt_spp=args.gt_spp, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.self_device_time_total for e in prof.key_averages())
    if dev_us <= 0:
        return "not measured (the profiler saw no device time)"
    return "%.1f%% (%.3f s of %.3f s)" % (100 * dev_us / 1e6 / wall,
                                          dev_us / 1e6, wall)


class _plain_render_ops:
    """While active, the renderer's three ops run their plain PyTorch
    versions on the card (what R1-R3 replace)."""

    def __init__(self, ops):
        self.ops = ops

    def __enter__(self):
        ops = self.ops
        self.kept = (ops.tri_nearest, ops.tri_any, ops.random_uniform)
        ops.tri_nearest = ops.reference.tri_nearest_ref
        ops.tri_any = ops.reference.tri_any_ref
        ops.random_uniform = ops.reference.threefry_uniform_ref

    def __exit__(self, *exc):
        (self.ops.tri_nearest, self.ops.tri_any,
         self.ops.random_uniform) = self.kept


def _render_plain_phase(ops, spp=8, gt_spp=16):
    """One 128x128 tile of the CLI's first scene on the card three ways: the
    kernels at the default wavefront (64 passes), the kernels one pass a
    wavefront, and the plain versions of R1-R3 one pass a wavefront (their
    [rays, triangles] temporaries do not fit at 64 passes); then the
    kernels at 8 to 128 passes a wavefront."""
    from sbmc_tpu_torch.render import assets as rassets
    from sbmc_tpu_torch.render import pathtracer, prng, scene as rscene
    a = os.path.join(ROOT, "assets")
    sc = rscene.random_tracer_scene(
        np.random.RandomState(0),
        obj_pool=rassets.ObjPool(os.path.join(a, "objs")),
        tex_pool=rassets.TexturePool(os.path.join(a, "textures")),
        env_pool=rassets.EnvmapPool(os.path.join(a, "envmaps")))
    kw = dict(ts=128, spp=spp, gt_spp=gt_spp, device="cuda")
    full = pathtracer._WAVEFRONT_RAYS

    def tile_s(rays):
        pathtracer._WAVEFRONT_RAYS = rays
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tile = pathtracer.render_tile_wavefront(sc, prng.PRNGKey(0), **kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, tile
        finally:
            pathtracer._WAVEFRONT_RAYS = full

    tile_s(full)  # warm-up
    batched, ref_tile = tile_s(full)
    serial, _ = tile_s(128 * 128)
    with _plain_render_ops(ops):
        plain, plain_tile = tile_s(128 * 128)
    share = _tile_share(plain_tile.features[:, 11:21],
                        ref_tile.features[:, 11:21], 1)
    # The wavefront's width: the same tile at 128 ground-truth passes, 8,
    # 16, 32, 64 and 128 passes a wavefront.
    kw["gt_spp"] = 128
    sweep = {}
    for passes in (8, 16, 32, 64, 128):
        sweep[passes] = round(tile_s(passes * 128 * 128)[0], 4)
    print("plain eager renderer: one 128x128 tile (%d spp, gt %d, %d "
          "triangles) takes %.3f s with R1-R3's plain versions one pass a "
          "wavefront, %.3f s with the kernels one pass a wavefront, %.3f s "
          "with the kernels at %d passes a wavefront (g-buffer samples "
          "beyond 1e-3 between plain and kernels: %.4f)"
          % (spp, gt_spp, len(sc.tri_v0), plain, serial, batched,
             full // (128 * 128), share))
    print("wavefront width: one 128x128 tile (%d spp, gt 128) in s, by "
          "passes a wavefront: %s" % (spp, json.dumps(sweep)))


def _render_train_phase(ops, tmp, corpus, steps=4, spp=8, bs=4):
    """11d: train the flagship architecture on the rendered corpus (bf16
    convs), then denoise its frames with the checkpoint."""
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.utils import exr
    ckpt = os.path.join(tmp, "ckpt_render")
    launches = {}
    _, launches["render_train"] = _run_training(
        ops, "render_train", "the flagship architecture on the rendered "
        "corpus, batch %d x %d spp x 128x128" % (bs, spp),
        [corpus, ckpt, "--spp", str(spp), "--bs", str(bs), "--ksize", "21",
         "--bf16"], steps, ["progressive_splat", "progressive_splat_dlogits"],
        {"progressive_splat": steps * spp,
         "progressive_splat_dlogits": steps * spp},
        {"progressive_splat": spp}, "sbmc")
    out = os.path.join(tmp, "rendered_out", "frame.exr")
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        res = denoise.main(denoise.parse_args(
            ["--input", corpus, "--checkpoint", ckpt, "--output", out,
             "--uniform_tiles", "--tile_size", "160", "--tile_pad", "32",
             "--spp", str(spp), "--device", "cuda"]))
    launches["render_denoise"] = dict(ops.launch_counts)
    _check_shapes("render_denoise", seen, ["progressive_splat"])
    tiles = sum(r["tiles"] for r in res)
    if _nonzero(ops.launch_counts) != {"progressive_splat": tiles * spp}:
        raise AssertionError("denoising the rendered corpus launched %s"
                             % ops.launch_counts)
    for r in res:
        img = exr.read(r["output"])
        if img.shape != (256, 256, 3) or not np.isfinite(img).all():
            raise AssertionError("rendered-corpus denoise wrote %s"
                                 % (img.shape,))
    print("rendered corpus: trained %d steps, then denoised %d frames of "
          "256x256 (%d tiles) with the checkpoint: finite EXRs, %d forward "
          "launches" % (steps, len(res), tiles, tiles * spp))
    return launches


#: The bench's runs: its defaults (SBMC, 1080x1920 at 4 spp, bf16, the
#: uniform first-rung tile), the denoise CLI's ragged tiles, and KPCN.
BENCH_RUNS = (("bench", []), ("bench_ragged", ["--tiling", "ragged"]),
              ("bench_kpcn", ["--model", "kpcn"]))
BENCH_KEYS = ("metric", "model", "value", "unit", "vs_baseline",
              "baseline_estimate", "baseline_fps", "tile", "n_tiles",
              "resolution", "spp", "frame_seconds", "tiling", "device")


def _bench_phase(ops):
    """``python -m sbmc_tpu_torch.bench`` in-process, each run of
    BENCH_RUNS: its JSON line, and the forward kernel launched tiles x spp
    times a frame (KPCN: two kernel weightings a tile)."""
    from sbmc_tpu_torch import bench

    launches = {}
    for tag, argv in BENCH_RUNS:
        args = bench.parse_args(argv + ["--device", "cuda"])
        kernel = ("kernel_weighting" if args.model == "kpcn"
                  else "progressive_splat")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with _record_shapes(ops) as seen:
            res = bench.main(args)
        launches[tag] = dict(ops.launch_counts)
        _check_shapes(tag, seen, [kernel])
        per_frame = res["n_tiles"] * (2 if args.model == "kpcn"
                                      else res["spp"])
        frames = res["warmup"] + res["iters"]
        if _nonzero(launches[tag]) != {kernel: per_frame * frames}:
            raise AssertionError("%s launched %s, expected %d frames x %d "
                                 "of %s" % (tag, _nonzero(launches[tag]),
                                            frames, per_frame, kernel))
        missing = [k for k in BENCH_KEYS if k not in res]
        if missing or not (np.isfinite(res["value"]) and res["value"] > 0) \
                or res["resolution"] != [1080, 1920] or \
                res["n_tiles"] != {"bench": 1, "bench_ragged": 28,
                                   "bench_kpcn": 1}[tag]:
            raise AssertionError("%s: keys missing %s, or %s" % (
                tag, missing, res))
        print("%s: %.4f frames/s (median of %s ms), %d tiles of %s, %d %s "
              "launches a frame; peak device memory %.2f GB" % (
                  tag, res["value"], ", ".join("%.2f" % t for t in
                                               res["frame_ms"]),
                  res["n_tiles"], res["tile"], per_frame, kernel,
                  torch.cuda.max_memory_allocated() / 1e9))
    return launches


#: Phase 12's kernel-weighting case: the toy's batch of 4 x 4 samples of one
#: channel at 64x64, k = 3, float32 (its splat variant transposes weights of
#: the same planes).
SVG_SHAPE = (16, 1, 64, 64, 3, torch.float32)
#: The card's toy losses against the CPU's over three steps: float32 convs
#: (no TF32) and softmax sums in other orders, as tests/test_torch_figures.py
#: holds the port to the JAX script.
SVG_RTOL = 1e-4
#: The flagship's probe score on the card against the CPU: bfloat16 convs
#: round at other places in cuDNN and on the CPU (MODEL_TOL); the loss, a
#: mean over the tile, moves far less than single pixels.
PROBE_RTOL = 1e-2


def _svg_kernel_check(ops):
    """Kernel weighting, its weight gradient and scatter2gather against
    their plain versions at SVG_SHAPE (one channel: a group padded to two,
    as the op runs it)."""
    bs, c, h, w, k, dtype = SVG_SHAPE
    if ops.kw_route(k) != "tiled" or ops.s2g_route(k) != "tiled":
        raise AssertionError("k = %d does not take the tiled kernels" % k)
    data, weights, d_out, d_sw = _kw_inputs(np.random.RandomState(12), bs,
                                            c, h, w, k, dtype)
    case = _case(data, weights)
    for name in ("kernel_weighting", "kernel_weighting_dw"):
        _COMPARED[name].add(case)
    out, sum_w = ops.kernel_weighting(data, weights)
    d_wts = ops.kw_dw_by_channels(ops._kernel_weighting_dw_cuda, data, d_out,
                                  d_sw, k, dtype)
    want_out, want_sw = ops.kernel_weighting_ref(data, weights)
    want_dw = ops.kernel_weighting_dw_ref(data, d_out, d_sw, k)
    torch.cuda.synchronize()
    _kw_check("kernel_weighting", case, out, want_out, torch.float32)
    _kw_check("kernel_weighting", case, sum_w, want_sw, torch.float32)
    _kw_check("kernel_weighting_dw", case, d_wts, want_dw, dtype)
    _check_s2g(ops, weights)


def _svg_card_against_cpu(tmp):
    """Three steps of both variants of the experiment (width 8) on the card
    and on the CPU from the same weights: every loss within SVG_RTOL."""
    import contextlib
    import io
    from sbmc_tpu_torch import scatter_vs_gather as svg
    from sbmc_tpu_torch.params import export_jax_params

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        params = export_jax_params(svg.Toy(True, 8))
    res = {}
    for dev in ("cpu", "cuda"):
        with contextlib.redirect_stdout(io.StringIO()):
            res[dev] = svg.run(os.path.join(tmp, "svg_" + dev), steps=3,
                               width=8, device=dev, params=params)
    for name in ("splat", "gather"):
        got, want = np.array(res["cuda"][name]), np.array(res["cpu"][name])
        if not np.allclose(got, want, rtol=SVG_RTOL, atol=0):
            raise AssertionError("scatter_vs_gather %s losses on the card %s "
                                 "against the CPU's %s" % (name, got, want))
    return res


def _scatter_vs_gather_phase(ops, tmp):
    """12: ``python -m sbmc_tpu_torch.scatter_vs_gather`` at its defaults,
    with the launches of every step counted; returns the path's launch
    counts."""
    import contextlib
    import io
    from sbmc_tpu_torch import scatter_vs_gather as svg
    from sbmc_tpu_torch.utils.image import read_png

    _svg_kernel_check(ops)
    small = _svg_card_against_cpu(tmp)
    out = os.path.join(tmp, "scatter_vs_gather")
    per_step = {True: [], False: []}
    plain_step = svg._step

    def counted(model, *args):
        before = dict(ops.launch_counts)
        loss = plain_step(model, *args)
        per_step[model.splat].append(_nonzero(
            {n: ops.launch_counts[n] - before[n] for n in before}))
        return loss

    log = io.StringIO()
    ops.reset_launch_counts()
    svg._step = counted
    t0 = time.perf_counter()
    try:
        with _record_shapes(ops) as seen, contextlib.redirect_stdout(log):
            res = svg.main([out, "--device", "cuda"])
    finally:
        svg._step = plain_step
    secs = time.perf_counter() - t0
    launches = dict(ops.launch_counts)
    _check_shapes("scatter_vs_gather", seen, [
        "kernel_weighting", "kernel_weighting_dw", "scatter2gather"])
    steps = len(res["splat"])
    want = {True: {"scatter2gather": 2, "kernel_weighting": 1,
                   "kernel_weighting_dw": 1},
            False: {"kernel_weighting": 1, "kernel_weighting_dw": 1}}
    for splat, counts in per_step.items():
        bad = [i for i, c in enumerate(counts) if c != want[splat]]
        if len(counts) != steps or bad:
            raise AssertionError("scatter_vs_gather %s steps launched %s"
                                 % ("splat" if splat else "gather",
                                    [counts[i] for i in bad[:3]]))
    # Beside the steps: each variant's forward on its first batch.
    total = {"scatter2gather": 2 * steps + 1,
             "kernel_weighting": 2 * steps + 2,
             "kernel_weighting_dw": 2 * steps}
    if _nonzero(launches) != total:
        raise AssertionError("scatter_vs_gather launched %s, expected %s"
                             % (_nonzero(launches), total))
    with open(os.path.join(out, "losses.csv"), newline="") as f:
        rows = list(csv.reader(f))
    if rows[0] != ["step", "splat", "gather"] or len(rows) != steps + 1 \
            or not all(np.isfinite(float(v)) for r in rows[1:] for v in r):
        raise AssertionError("losses.csv: %d rows, header %s"
                             % (len(rows), rows[0]))
    for name in ("splat", "gather"):
        strip = read_png(os.path.join(out, name + ".png"))
        if strip.shape != (62, 124) or strip.dtype != np.uint8:
            raise AssertionError("%s.png is %s %s" % (name, strip.shape,
                                                      strip.dtype))
    final = [ln for ln in log.getvalue().splitlines()
             if ln.startswith("final: ")]
    if len(final) != 1:
        raise AssertionError("scatter_vs_gather printed no final line")
    print("scatter vs gather: %d steps a variant in %.1f s (batch 4 x 4 spp "
          "of 64x64, width 32); %s; per splat step %s, per gather step %s; "
          "3 steps card against CPU within %.0e (splat %.6g vs %.6g); "
          "losses.csv, splat.png, gather.png" % (
              steps, secs, final[0], json.dumps(want[True]),
              json.dumps(want[False]), SVG_RTOL, small["cuda"]["splat"][-1],
              small["cpu"]["splat"][-1]))
    return launches


def _probe_phase(ops, tmp, corpus, flagship, spp=8):
    """13: ``probe_vs_input`` on 11d's checkpoint and on the flagship (its
    first tile scored on the CPU too), then ``kernel_grids`` on 11d's
    checkpoint; returns each path's launch counts."""
    import contextlib
    import io
    from sbmc_tpu_torch import kernel_grids, probe_vs_input
    from sbmc_tpu_torch.data.datasets import TilesDataset
    from sbmc_tpu_torch.models.build import build_model
    from sbmc_tpu_torch.train.checkpointer import Checkpointer
    from sbmc_tpu_torch.utils.image import read_png

    ckpt = os.path.join(tmp, "ckpt_render")
    launches = {}
    for tag, src in (("probe_vs_input", ckpt),
                     ("probe_vs_input_flagship", flagship)):
        log = io.StringIO()
        ops.reset_launch_counts()
        with _record_shapes(ops) as seen, contextlib.redirect_stdout(log):
            res = probe_vs_input.main([corpus, src, "--spp", str(spp),
                                       "--device", "cuda"])
        launches[tag] = dict(ops.launch_counts)
        _check_shapes(tag, seen, ["progressive_splat"])
        want = {"progressive_splat": len(res["tiles"]) * spp}
        if _nonzero(launches[tag]) != want:
            raise AssertionError("%s launched %s, expected %s" % (
                tag, _nonzero(launches[tag]), want))
        scores = res["model"] + res["input"]
        if len(res["tiles"]) != 4 or not np.all(np.isfinite(scores)):
            raise AssertionError("%s scored %s" % (tag, res))
        print("%s (%s): %d tiles, %d splat launches; %s" % (
            tag, os.path.basename(src), len(res["tiles"]),
            want["progressive_splat"], log.getvalue().splitlines()[-1]))
    # The flagship's first tile on the CPU: the same score within
    # PROBE_RTOL (the input mean's to float32 rounding).
    model = build_model(Checkpointer.load_meta(flagship))
    probe_vs_input.load_params(flagship, model)
    with contextlib.redirect_stdout(io.StringIO()):
        _, cpu_m, cpu_i = probe_vs_input.score_tiles(
            model.eval(), TilesDataset(corpus, spp=spp), 1,
            torch.device("cpu"))
    if not (np.isclose(cpu_m[0], res["model"][0], rtol=PROBE_RTOL, atol=0)
            and np.isclose(cpu_i[0], res["input"][0], rtol=1e-6, atol=0)):
        raise AssertionError("flagship probe: card %s / %s, CPU %s / %s" % (
            res["model"][0], res["input"][0], cpu_m[0], cpu_i[0]))
    print("probe_vs_input_flagship tile 0 on the CPU: model %.6g (card "
          "%.6g, within %.0e), input mean %.6g (card %.6g)" % (
              cpu_m[0], res["model"][0], PROBE_RTOL, cpu_i[0],
              res["input"][0]))

    out = os.path.join(tmp, "kernel_grids")
    log = io.StringIO()
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen, contextlib.redirect_stdout(log):
        n = kernel_grids.main(["--input", corpus, "--checkpoint", ckpt,
                               "--output", out, "--device", "cuda"])
    launches["kernel_grids"] = dict(ops.launch_counts)
    _check_shapes("kernel_grids", seen, ["progressive_splat"])
    if _nonzero(launches["kernel_grids"]) != {"progressive_splat": spp}:
        raise AssertionError("kernel_grids launched %s"
                             % _nonzero(launches["kernel_grids"]))
    rad = read_png(os.path.join(out, "output.png"))
    grids = [read_png(os.path.join(out, "kernels_sample%02d.png" % s))
             for s in range(n)]
    if n != 4 or rad.shape != (44, 44, 3) or any(
            g.shape != (64 * 21, 64 * 21) or g.max() == 0 for g in grids):
        raise AssertionError("kernel_grids wrote %d grids, output %s" % (
            n, rad.shape))
    print("kernel_grids: %s; output.png %s, %d grids of %s, each with its "
          "peak at %d" % (log.getvalue().strip(), rad.shape, n,
                          grids[0].shape, max(g.max() for g in grids)))
    return launches


def _profile_phase(ops):
    """14: the op profiles (kernels, then their plain versions) and the
    stage profile in bf16 and float32, at their defaults; returns each
    kernel path's launch counts."""
    from sbmc_tpu_torch import (profile_kernel_weighting,
                                profile_model_stages, profile_scatter2gather)

    calls = 1 + 5 + 20  # the profiles' first call, warm-ups and iterations
    runs = (("profile_kernel_weighting", profile_kernel_weighting, [],
             ["kernel_weighting"],
             {"kernel_weighting": 3 * calls, "scatter2gather": calls,
              "kernel_weighting_dw": calls}),
            ("profile_scatter2gather", profile_scatter2gather, [],
             ["scatter2gather"], {"scatter2gather": 3 * calls}),
            ("profile_model_stages", profile_model_stages, [],
             ["progressive_splat"], {"progressive_splat": 2 * 6 * 4}),
            ("profile_model_stages_f32", profile_model_stages, ["--f32"],
             ["progressive_splat"], {"progressive_splat": 2 * 6 * 4}))
    launches = {}
    for tag, mod, argv, kernels, want in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with _record_shapes(ops) as seen:
            times = mod.main(argv + ["--device", "cuda"])
        launches[tag] = dict(ops.launch_counts)
        _check_shapes(tag, seen, kernels)
        if _nonzero(launches[tag]) != want or not all(
                np.isfinite(t) and t > 0 for t in times.values()):
            raise AssertionError("%s launched %s (expected %s), times %s"
                                 % (tag, _nonzero(launches[tag]), want,
                                    times))
        print("%s: launches %s, peak device memory %.2f GB" % (
            tag, json.dumps(want), torch.cuda.max_memory_allocated() / 1e9))
        if mod is not profile_model_stages:
            ops.reset_launch_counts()
            mod.main(["--backend", "plain", "--device", "cuda"])
            if any(ops.launch_counts.values()):
                raise AssertionError("%s --backend plain launched %s" % (
                    tag, _nonzero(ops.launch_counts)))
            print("%s --backend plain: no kernel launched" % tag)
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the PBRT scene generator and drivers (host work), then the card

#: pbrt_stand_ins.scene_digest of scenes 0 and 1 synthesized at the datagen
#: CLI's defaults with the obj2pbrt stand-in, normalised (uuid4 ids in order
#: of appearance, the repo's assets folder as <ASSETS>).
#: tests/test_torch_generate_data.py holds the JAX package's scenes to it.
PBRT_SCENE_DIGEST = ("6555041fa128a4461eedc5eaeacda803"
                     "3e48a3547c9b5656df6c9eef52a1bfa5")
#: Seconds a phase-15 subprocess may take.
PBRT_TIMEOUT = 300


def _check_bins(folder, n, spp, gt_spp, size):
    """``folder`` holds exactly ``n`` stand-in tiles of 128 pixels at
    ``spp`` samples, from a ``size``-pixel square crop; returns one."""
    from sbmc_tpu_torch.data import bin_format
    files = sorted(os.listdir(folder))
    if len(files) != n or not all(f.endswith(".bin") for f in files):
        raise AssertionError("%s holds %s" % (folder, files))
    tile = bin_format.read_tile(os.path.join(folder, files[-1]))
    side = size // 128 - 1
    if (tile.features.shape != (spp, 27, 128, 128)
            or (tile.gt_sample_count, tile.image_width, tile.block_x,
                tile.block_y) != (gt_spp, size, 128 * side, 128 * side)
            or not np.isfinite(tile.features).all()):
        raise AssertionError("%s: %s, gt %d, %dx%d at (%d, %d)" % (
            files[-1], tile.features.shape, tile.gt_sample_count,
            tile.image_width, tile.image_height, tile.block_x, tile.block_y))
    return tile


def _pbrt_phase(ops, tmp, steps=4, spp=8, bs=4):
    """15: the PBRT data path with the pbrt and obj2pbrt stand-ins (the
    repo does not hold the binaries): (a) scenes 0 and 1 synthesized at the
    datagen CLI's defaults, held to PBRT_SCENE_DIGEST; (b) ``python -m
    sbmc_tpu_torch.generate_training_data`` at those defaults, 2 scenes on 2
    threads, cleaned to the tiles; (c) ``render_exr`` and ``render_samples``
    on scene 0; (d) the flagship architecture trained on (b)'s output (11d's
    settings), then one scene denoised. Returns the launch counts."""
    from sbmc_tpu_torch import denoise, pbrt_stand_ins, render_exr
    from sbmc_tpu_torch import generate_training_data as gtd
    from sbmc_tpu_torch import render_samples
    from sbmc_tpu_torch.data.datasets import TilesDataset
    from sbmc_tpu_torch.utils import exr
    pbrt, obj2pbrt = pbrt_stand_ins.install(os.path.join(tmp, "bin"))
    assets = os.path.join(ROOT, "assets")
    lists = pbrt_stand_ins.write_asset_lists(os.path.join(tmp, "assets"),
                                             assets)

    # 15a: the scene generator, in this process.
    args = gtd.parse_args([pbrt, obj2pbrt, lists,
                           os.path.join(tmp, "scenes"), "--no-clean"])
    params = gtd.GeneratorParams(args)
    t0 = time.perf_counter()
    dirs = [gtd.synthesize({"idx": i, "gen_params": params,
                            "render_params": gtd.render_params(args)})
            for i in (0, 1)]
    synth_s = (time.perf_counter() - t0) / 2
    texts = []
    for d in dirs:
        with open(os.path.join(d, "scene.pbrt")) as f:
            texts.append(f.read())
    digest = pbrt_stand_ins.scene_digest(
        [pbrt_stand_ins.normalise_scene(s, [(assets, "<ASSETS>")])
         for s in texts])
    if digest != PBRT_SCENE_DIGEST:
        raise AssertionError("scenes 0 and 1 digest to %s, not the JAX "
                             "package's %s" % (digest, PBRT_SCENE_DIGEST))
    shapes = [sum(ln.startswith("Include") for ln in s.splitlines())
              for s in texts]
    print("15a pbrt scenes: scenes 0 and 1 at the CLI defaults (512x512 "
          "crops, %d/%d spp, tiles of %d) with %s objects: %.3f s/scene of "
          "synthesis; digest %s matches the JAX package's"
          % (args.spp, args.gt_spp, args.tile_size, shapes, synth_s,
             digest[:16]))

    # 15b: the datagen CLI, with cleaning.
    out = os.path.join(tmp, "pbrt_out")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sbmc_tpu_torch.generate_training_data", pbrt,
         obj2pbrt, lists, out, "--count", "2", "--threads", "2",
         "--batch_size", "2"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=PBRT_TIMEOUT)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("pbrt datagen failed: %s" % proc.stderr[-3000:])
    summary = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("pbrt datagen:")]
    scenes = sorted(os.listdir(out))
    if len(scenes) != 2 or not summary or "2 of 2 scenes" not in summary[0]:
        raise AssertionError("pbrt datagen wrote %s: %s" % (scenes,
                                                            proc.stdout))
    for s in scenes:
        _check_bins(os.path.join(out, s), 16, args.spp, args.gt_spp, 512)
    ds = TilesDataset(out, spp=spp)
    item = ds[0]
    if len(ds) != 32 or not all(np.isfinite(v).all() for v in item.values()
                                if isinstance(v, np.ndarray)):
        raise AssertionError("the pbrt tiles do not load through "
                             "TilesDataset")
    print("15b %s (command %.2f s with the interpreter's start); the "
          "stand-in pbrt writes 16 tiles of 128x128 at %d spp a scene; "
          "cleaned to the tiles, which load through TilesDataset"
          % (summary[0], wall, args.spp))

    # 15c: the two rendering drivers on scene 0, without its render block.
    body = os.path.join(dirs[0], "body.pbrt")
    with open(body, "w") as f:
        f.write(pbrt_stand_ins.scene_body(texts[0]))
    t0 = time.perf_counter()
    frame = os.path.join(tmp, "pbrt_exr", "frame.exr")
    exr_args = render_exr.main([pbrt, body, frame, "--tmp_dir",
                                os.path.join(tmp, "work_exr")])
    img = exr.read(frame)
    exr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples = os.path.join(tmp, "pbrt_samples", "scene_0")
    sample_args = render_samples.main([pbrt, body, samples, "--tmp_dir",
                                       os.path.join(tmp, "work_samples")])
    samples_s = time.perf_counter() - t0
    _check_bins(samples, 16, sample_args.spp, sample_args.gt_spp, 512)
    if (img.shape != (512, 512, 3) or not np.isfinite(img).all()
            or any(os.path.exists(a.tmp_dir)
                   for a in (exr_args, sample_args))):
        raise AssertionError("render_exr wrote %s; temporary folders left"
                             % (img.shape,))
    print("15c drivers on scene 0: render_exr %.2f s (a 512x512 EXR), "
          "render_samples %.2f s (16 tiles at %d spp, gt %d)"
          % (exr_s, samples_s, sample_args.spp, sample_args.gt_spp))

    # 15d: the card, on the pbrt branch's output.
    ckpt = os.path.join(tmp, "ckpt_pbrt")
    launches = {}
    _, launches["pbrt_train"] = _run_training(
        ops, "pbrt_train", "the flagship architecture on the pbrt branch's "
        "tiles, batch %d x %d spp x 128x128" % (bs, spp),
        [out, ckpt, "--spp", str(spp), "--bs", str(bs), "--ksize", "21",
         "--bf16"], steps, ["progressive_splat", "progressive_splat_dlogits"],
        {"progressive_splat": steps * spp,
         "progressive_splat_dlogits": steps * spp},
        {"progressive_splat": spp}, "sbmc")
    one = os.path.join(tmp, "pbrt_one")
    os.makedirs(one)
    os.symlink(os.path.join(out, scenes[0]), os.path.join(one, scenes[0]))
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        res = denoise.main(denoise.parse_args(
            ["--input", one, "--checkpoint", ckpt, "--output",
             os.path.join(tmp, "pbrt_den", "frame.exr"), "--uniform_tiles",
             "--tile_size", "160", "--tile_pad", "32", "--spp", str(spp),
             "--device", "cuda"]))
    launches["pbrt_denoise"] = dict(ops.launch_counts)
    _check_shapes("pbrt_denoise", seen, ["progressive_splat"])
    tiles = sum(r["tiles"] for r in res)
    if len(res) != 1 or _nonzero(ops.launch_counts) != {
            "progressive_splat": tiles * spp}:
        raise AssertionError("denoising a pbrt scene: %d scenes, launches "
                             "%s" % (len(res), ops.launch_counts))
    img = exr.read(res[0]["output"])
    if img.shape != (512, 512, 3) or not np.isfinite(img).all():
        raise AssertionError("pbrt-scene denoise wrote %s" % (img.shape,))
    print("15d pbrt corpus: trained %d steps, then denoised one 512x512 "
          "scene (%d tiles) with the checkpoint: a finite EXR, %d forward "
          "launches" % (steps, tiles, tiles * spp))
    return launches


def main():
    _device_phase()
    if not os.path.isdir(os.path.join(ROOT, "sbmc_tpu_torch")):
        raise SystemExit("chip_smoke: sbmc_tpu_torch/ not found beside "
                         "this script; run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    from sbmc_tpu_torch import ops
    from sbmc_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_cuda()
    print("build: %.2f s (nvcc %s)" % (time.perf_counter() - t0,
                                       " ".join(_build.NVCC_FLAGS)))

    tile, pad = 160, 32
    with torch.inference_mode():
        numbers = _kernel_phase(ops, (tile, tile))
        numbers.update(_bwd_kernel_phase(ops))
        numbers.update(_composed_kernel_phase(ops))
        numbers.update(_exp_kernel_phase(ops))
        by_path = {"composed_step": _composed_step_phase(ops)}
    _channel_phase(ops, numbers)
    checkpoint = os.path.join(ROOT, "weights", "flagship_f16")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _reference_phase(checkpoint)
    by_path["gradient"] = _gradient_phase(ops, checkpoint)
    by_path["gradient_composed"] = _composed_gradient_phase(ops)
    with tempfile.TemporaryDirectory() as tmp:
        by_path["denoise"] = _main_phase(ops, checkpoint, tmp, tile, pad)
        by_path.update(_train_phase(ops, tmp))
        by_path.update(_kpcn_phase(ops, tmp))
        by_path.update(_gather_phase(ops, tmp))
        by_path.update(_lbf_phase(ops, tmp))
        by_path["eval"], labels = _eval_phase(ops, tmp, checkpoint)
        by_path.update(_reservoir_phase(ops, tmp))
        _decode_phase(tmp)
        by_path["checkpoint_tools"] = _checkpoint_tools_phase(ops, tmp)
        by_path["trace"] = _trace_phase(ops, tmp, checkpoint)
        by_path["scatter_vs_gather"] = _scatter_vs_gather_phase(ops, tmp)
        with torch.inference_mode():
            numbers.update(_render_kernel_phase(ops))
            _render_tile_phase(ops)
        corpus, by_path["render"] = _render_path_phase(ops, tmp, numbers)
        _render_plain_phase(ops)
        by_path.update(_render_train_phase(ops, tmp, corpus))
        by_path.update(_probe_phase(ops, tmp, corpus, checkpoint))
    _scale_phase(checkpoint)
    _baseline_scale_phase(labels)
    by_path.update(_bench_phase(ops))
    by_path.update(_profile_phase(ops))
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(_pbrt_phase(ops, tmp))

    kernels = []
    for name, source, replaces in KERNELS:
        launches = {path: counts[name] for path, counts in by_path.items()}
        if name in NEVER_ON_A_PATH:
            # The composed step's odd shapes run the generic forward as the
            # yardstick, which is what it is there for.
            ran = {path: n for path, n in launches.items()
                   if n and path != "composed_step"}
            if ran:
                raise AssertionError("generic kernel %s launched on %s"
                                     % (name, ran))
        elif not any(launches.values()):
            raise AssertionError("kernel %s was launched by no phase" % name)
        for path in MUST_LAUNCH[name]:
            if launches[path] <= 0:
                raise AssertionError("kernel %s never launched on the %s "
                                     "path" % (name, path))
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launches,
                            library_ms=None, **numbers[name]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
