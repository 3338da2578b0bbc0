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
   then one scene denoised with that checkpoint; each step's share of time
   spent waiting on the host loader.
16. several ranks (after 15; ``sbmc_tpu_torch/parallel/mesh.py``), each
   rank a process of ``python -m torch.distributed.run --standalone
   chip_smoke.py --rank SPEC`` that writes its launches, the shapes its
   ops met, its step times, loader waits and writes to a file, which this
   process merges into ``by_path`` and the shape checks: (a) NCCL at world
   size 1 through the train CLI at phase 8's flagship configuration (f32,
   constant sample counts, 4 steps) against one plain run (the first
   loss equal to 1e-6), ms/step under DDP beside its; (b) two ranks on
   cuda:0 over gloo, the flagship architecture, fixed global batches of 4
   (2 a rank), 3 steps, f32 then --bf16, each step against one process's
   step on the global batch from the same state (with bf16, also what a
   skipped all-reduce would read); launches and shapes of the
   data-parallel steps alone; (c) the 2-rank CLI in gloo on
   the card (bf16, 8f's 12 tiles, 4 steps, SBMC then --kpcn_mode): only
   rank 0 wrote, the loader waits, then the checkpoint resumes in one
   process and denoises 7's frame; (d) the ragged and uniform denoise
   runners on replicas [cuda:0, cuda:0], the frame equal to one device's
   bit for bit; (e) with two cards or more only, (b) and (c) with NCCL on
   cuda:0 and 1 and the replicas on both cards; otherwise it prints
   ``multi-card: not run (1 device)``.

The composed kernels' phases and the other entry points run between these
(4b to 4e after 4, 18 to 20 after 4e, 6b after 6, 8b to 8i after 8; 12 after 8i,
13 after 11d, 14 after 10):

18. per-sample chains: (a) the per-sample chain kernel
    (``csrc/sample_chain.cu``: an embedding step, the kernel regressor)
    against its plain version on the card, in bf16 units, at steps 0 and
    >= 1, widths 8, 32 and 128, 1 to 8 samples, masked samples, odd,
    misaligned and ragged planes, 441, 25 and 9 regressor outputs, the
    logit clamp and NaN; (b) the flagship under inference_mode launches it
    3 + spp times a tile and not at all with gradients on, the fused and
    unfused frames agree, and the wrapper refuses what requires grad; (c)
    both kernels timed at the bench's frame shape (1 x 4 x 1080 x 2048) on
    the host clock and by CUDA-graph replay beside the plain version and
    the bound (bytes at 3.35 TB/s, bf16 FLOPs at 989 TFLOP/s);

19. the U-Net's channels-last kernels (``csrc/unet.cu``): (a) the
    flagship's U-Net (random weights) at every tile shape the paths give it
    (UNET_PATH_SHAPES) and odd sizes, each launch of the epilogue, the
    upsample and the layout change held to its plain version on the same
    inputs (bit for bit; the upsample within one bf16 unit where its scale
    is not 1/2), 15 + 2 + 2 launches a call, the output held to the NCHW
    U-Net's distance from the float32 U-Net; (b) each kernel timed at the
    bench's frame shape (1 x 128 x 1080 x 2048 and its levels) on the host
    clock and by CUDA-graph replay beside the plain version and the bound
    (bytes at 3.35 TB/s), and the whole U-Net against the NCHW one; (c) the
    U-Net forward and backward under gradients at every training shape
    (UNET_TRAIN_SHAPES), each launch of the five kernels held to its plain
    version (the backward's within one bf16 unit where it sums in another
    order), 15 + 2 + 2 launches forward and 15 + 2 + 2 backward, the
    gradients held to the NCHW U-Net's distance from the float32 U-Net's;
    (d) the two backward kernels timed at the train cell's levels (16 x 128
    x 128 x 128 and below) as in (b), and the U-Net's forward and backward
    there through the NCHW modules, the same modules on channels-last
    tensors (stock autograd) and the port's Function. The bf16 SBMC
    training paths (8, 8f, 11d, 15d, 16b, 16c) launch the U-Net's forward
    and backward kernels in every step (``_unet_train_launches``);

20. KPCN's channels-last kernels (``csrc/kpcn.cu``): (a) KPCN at full
    width, bf16 (random weights), at every tile shape the paths give it
    (KPCN_PATH_SHAPES) and odd sizes, each launch of the entry (bit for
    bit) and the exit (within one bf16 unit of ``torch.softmax``'s, at each
    weight's own exponent) held to its plain version, and each epilogue's
    as in 19a, 2 + 16 + 2 launches a call, the output held to the NCHW
    KPCN's distance from the float32 KPCN; (b) both kernels timed at the
    KPCN bench's tile (1 x 27 x 1160 x 2000 in, 1 x 448 x 1124 x 1964 out)
    on the host clock and by CUDA-graph replay beside the plain version
    and the bound (bytes at 3.35 TB/s), the width table (cuDNN's
    channels-last convolutions alone at the tile's shapes, at widths 104,
    112 and 128 and predictions of 448 and 512, and each whole chain), and
    the whole KPCN against the NCHW one;
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

import contextlib
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
    ("sample_chain", _CSRC + "sample_chain.cu",
     "none: XLA fused the per-sample 1x1 chains of "
     "sbmc_tpu/models/multisteps.py"),
    # The U-Net's passes around its cuDNN convolutions, channels-last: XLA
    # fused them into the convolutions' neighbours.
    ("unet_epilogue", _CSRC + "unet.cu",
     "none: XLA fused the bias, activation, pooling and concatenation of "
     "sbmc_tpu/nn/layers.py's Autoencoder"),
    ("unet_upsample", _CSRC + "unet.cu",
     "none: XLA fused the resize and concatenation of sbmc_tpu/nn/layers.py's "
     "Autoencoder"),
    ("unet_layout", _CSRC + "unet.cu",
     "none: the U-Net's layout change at its boundary (XLA picks layouts "
     "itself)"),
    # Their backward in the train step, around cuDNN's NHWC dgrad and wgrad:
    # XLA fused the backward's passes as it fused the forward's.
    ("unet_epilogue_backward", _CSRC + "unet.cu",
     "none: XLA fused the backward of the bias, activation, pooling and "
     "concatenation of sbmc_tpu/nn/layers.py's Autoencoder"),
    ("unet_upsample_backward", _CSRC + "unet.cu",
     "none: XLA fused the backward of the resize and concatenation of "
     "sbmc_tpu/nn/layers.py's Autoencoder"),
    # KPCN's chain ends around cuDNN's channels-last convolutions: XLA fused
    # them into the convolutions' neighbours.
    ("kpcn_entry", _CSRC + "kpcn.cu",
     "none: XLA fused the cast and layout of the inputs of "
     "sbmc_tpu/models/kpcn.py's conv chains"),
    ("kpcn_exit", _CSRC + "kpcn.cu",
     "none: XLA fused the prediction's bias, the softmax over the taps and "
     "the layout of sbmc_tpu/models/kpcn.py's kernels"),
)
#: Phase 16's SBMC training paths, each rank's apart.
_DP_SBMC = ("dp_world1", "dp_steps_rank0", "dp_steps_rank1",
            "dp_steps_bf16_rank0", "dp_steps_bf16_rank1", "dp_cli_rank0",
            "dp_cli_rank1")
#: The paths that run bf16 SBMC inference.
_BF16_SBMC_INFERENCE = ("denoise", "eval", "bench", "bench_ragged",
                        "render_denoise", "probe_vs_input",
                        "probe_vs_input_flagship", "kernel_grids",
                        "profile_model_stages", "pbrt_denoise",
                        "dp_cli_denoise", "dp_replicas_ragged",
                        "dp_replicas_uniform")
#: The paths that run bf16 KPCN inference.
_BF16_KPCN_INFERENCE = ("kpcn_denoise_bf16", "eval", "bench_kpcn")
#: The paths that train SBMC with bf16 convs: their U-Nets run channels-last
#: in the train steps, forward and backward.
_BF16_SBMC_TRAIN = ("train_bf16", "reservoir_bf16", "render_train",
                    "pbrt_train", "dp_steps_bf16_rank0", "dp_steps_bf16_rank1",
                    "dp_cli_rank0", "dp_cli_rank1")
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
                          "pbrt_denoise") + _DP_SBMC + (
                              "dp_cli_denoise", "dp_replicas_ragged",
                              "dp_replicas_uniform"),
    "progressive_splat_ddata": ("gradient",),
    "progressive_splat_dlogits": ("train", "train_bf16", "gradient",
                                  "reservoir", "reservoir_bf16",
                                  "render_train", "pbrt_train") + _DP_SBMC,
    "kernel_weighting": ("kpcn_train", "kpcn_train_bf16", "kpcn_denoise",
                         "gather_train", "gradient_composed", "eval",
                         "bench_kpcn", "scatter_vs_gather",
                         "profile_kernel_weighting", "dp_cli_kpcn_rank0",
                         "dp_cli_kpcn_rank1"),
    "kernel_weighting_dw": ("kpcn_train", "kpcn_train_bf16", "gather_train",
                            "gradient_composed", "scatter_vs_gather",
                            "profile_kernel_weighting", "dp_cli_kpcn_rank0",
                            "dp_cli_kpcn_rank1"),
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
    # bf16 SBMC inference; float32 checkpoints and training never take it.
    "sample_chain": _BF16_SBMC_INFERENCE,
    # The same paths run the flagship's U-Nets channels-last, and bf16
    # SBMC training too, with their backward; bf16 KPCN inference runs its
    # chains so, with the epilogue between convolutions.
    "unet_epilogue": _BF16_SBMC_INFERENCE + _BF16_SBMC_TRAIN + (
        "kpcn_denoise_bf16", "bench_kpcn"),
    "unet_upsample": _BF16_SBMC_INFERENCE + _BF16_SBMC_TRAIN,
    "unet_layout": _BF16_SBMC_INFERENCE + _BF16_SBMC_TRAIN,
    "unet_epilogue_backward": _BF16_SBMC_TRAIN,
    "unet_upsample_backward": _BF16_SBMC_TRAIN,
    "kpcn_entry": _BF16_KPCN_INFERENCE,
    "kpcn_exit": _BF16_KPCN_INFERENCE,
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
          "kernel_weighting_exp_generic": "kw_exp", "sample_chain": "chain",
          "unet_epilogue": "unet", "unet_upsample": "unet",
          "unet_layout": "unet", "unet_epilogue_backward": "unet_train",
          "unet_upsample_backward": "unet_train", "kpcn_entry": "kpcn",
          "kpcn_exit": "kpcn"}
#: The kernels any bf16 SBMC inference launches (display strips of training
#: runs too), bf16 KPCN inference's layout kernels, and the U-Net's backward
#: kernels of bf16 SBMC training, held to the cases compared with the plain
#: versions on every path (KPCN's epilogues with its chains: phase 20a checks
#: them in the same calls; the U-Net's forward under gradients with its
#: inference cases, which 19a compares at every training shape too).
_MODEL_KERNELS = ("sample_chain", "unet_epilogue", "unet_upsample",
                  "unet_layout", "kpcn_entry", "kpcn_exit",
                  "unet_epilogue_backward", "unet_upsample_backward")

#: (bs, c, h, w, logit type) the paths give the splat step, k = 21: the
#: denoise path's tile, a training batch in float32 and with --bf16 (from
#: the host loader or the reservoir), a frame denoised with the trained
#: checkpoint, the gradient phase's input, the evaluation path's ragged
#: tiles of a 256x256 frame (160 and 64 px sides), and the bench's 1080x1920
#: frame: one uniform tile of 1080x2048, or the denoise CLI's ragged tiles
#: (512 and 312 rows, 512 and 384 columns); the stage profile's 1216x768
#: strip in both logit types (phase 14). The probes' tiles and crop (phase
#: 13) are the 128x128 and 64x64 bf16 entries; a rank's half of a training
#: batch of 4, in either type, phase 16's. The kernel phases compare at
#: each; _check_shapes holds the paths (every rank's) to it.
PATH_SHAPES = (
    (1, 3, 160, 160, torch.bfloat16),
    (4, 3, 128, 128, torch.float32),
    (4, 3, 128, 128, torch.bfloat16),
    (2, 3, 128, 128, torch.float32),
    (2, 3, 128, 128, torch.bfloat16),
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
#: Phase 16's KPCN ranks take half a bf16 batch.
KW_PATH_SHAPES = (
    (4, 3, 92, 92, torch.float32),
    (4, 3, 92, 92, torch.bfloat16),
    (2, 3, 92, 92, torch.bfloat16),
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


def _chain_case(chain, feats, extra):
    """A launch of the sample chain kernel: ("embed", ...) for an embedding
    step on ``feats`` ``[bs, spp, c, h, w]``, ("regress", ...) for the
    regressor on one sample of such a tensor (its spp read from its
    stride); then bs, spp, h, w, the chain's feature and extra channels,
    whether the extra features are per pixel, its hidden width and its
    outputs."""
    if feats.dim() == 5:
        kind, (bs, spp, cx, h, w) = "embed", feats.shape
    else:
        kind, (bs, cx, h, w) = "regress", feats.shape
        spp = feats.stride(0) // (cx * h * w)
    return (kind, bs, spp, h, w, cx, extra.shape[1],
            tuple(extra.shape[-2:]) != (1, 1), chain.layer_0.v.shape[0],
            chain.prediction.v.shape[0])


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
    (``seen["s2g"]``), the two exp ops (``seen["s2g_max"]``,
    ``seen["kw_exp"]``), the sample chain's two wrappers
    (``seen["chain"]``), the channels-last U-Net (``seen["unet"]``; under
    gradients in ``seen["unet_train"]`` too) and KPCN's channels-last chains
    (``seen["kpcn"]``) on the card. The calls themselves go through
    unchanged."""

    def __init__(self, ops):
        from sbmc_tpu_torch.models.kpcn import KPCN
        from sbmc_tpu_torch.nn import sample_chain
        from sbmc_tpu_torch.nn.layers import Autoencoder
        self.ops, self.sc, self.ae, self.kpcn = (ops, sample_chain,
                                                 Autoencoder, KPCN)
        self.seen = {"splat": set(), "kw": set(), "s2g": set(),
                     "s2g_max": set(), "kw_exp": set(), "chain": set(),
                     "unet": set(), "unet_train": set(), "kpcn": set()}

    def __enter__(self):
        ops, sc, seen = self.ops, self.sc, self.seen
        self.plain = (ops.progressive_splat_update, ops.kernel_weighting,
                      ops.scatter2gather, ops.scatter2gather_max,
                      ops.kernel_weighting_exp, sc.embedding_step,
                      sc.regress, self.ae.forward_channels_last,
                      self.kpcn.forward_channels_last)
        (splat, kw, s2g, s2g_max, kw_exp, embed, regress,
         unet, kpcn) = self.plain

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

        def rec_embed(chain, feats, extra, *rest):
            if feats.is_cuda:
                seen["chain"].add(_chain_case(chain, feats, extra))
            return embed(chain, feats, extra, *rest)

        def rec_regress(chain, feats_s, propagated, *rest):
            if feats_s.is_cuda:
                seen["chain"].add(_chain_case(chain, feats_s, propagated))
            return regress(chain, feats_s, propagated, *rest)

        def rec_unet(module, x):
            if x.is_cuda:
                seen["unet"].add(_unet_case(module, x))
                if torch.is_grad_enabled():
                    seen["unet_train"].add(_unet_case(module, x))
            return unet(module, x)

        def rec_kpcn(module, data):
            if data["kpcn_diffuse_in"].is_cuda:
                seen["kpcn"].add(_kpcn_case(module, data["kpcn_diffuse_in"]))
            return kpcn(module, data)

        ops.progressive_splat_update = rec_splat
        ops.kernel_weighting = rec_kw
        ops.scatter2gather = rec_s2g
        ops.scatter2gather_max = rec_s2g_max
        ops.kernel_weighting_exp = rec_kw_exp
        sc.embedding_step = rec_embed
        sc.regress = rec_regress
        self.ae.forward_channels_last = rec_unet
        self.kpcn.forward_channels_last = rec_kpcn
        return seen

    def __exit__(self, *exc):
        (self.ops.progressive_splat_update, self.ops.kernel_weighting,
         self.ops.scatter2gather, self.ops.scatter2gather_max,
         self.ops.kernel_weighting_exp, self.sc.embedding_step,
         self.sc.regress, self.ae.forward_channels_last,
         self.kpcn.forward_channels_last) = self.plain


@contextlib.contextmanager
def _plain_path():
    """While active, every model runs its plain modules: the rule that
    engages the inference kernels (``nn.layers.kernel_path``) says no."""
    from sbmc_tpu_torch.nn import layers
    rule = layers.kernel_path
    layers.kernel_path = lambda module, x: False
    try:
        yield
    finally:
        layers.kernel_path = rule


def _check_shapes(path, seen, kernels):
    """Fails if the path did not reach the op of one of ``kernels``, or met
    a case at which that kernel, or one of ``_MODEL_KERNELS``, was not
    compared with its plain version."""
    for name in kernels:
        if not seen[_OP_OF[name]]:
            raise AssertionError("the %s path never reached the op of %s"
                                 % (path, name))
    for name in set(kernels) | set(_MODEL_KERNELS):
        missing = seen[_OP_OF[name]] - _COMPARED[name]
        if missing:
            raise AssertionError(
                "%s ran on the %s path at %s, where it was not held against "
                "its plain version" % (name, path, sorted(missing)))


def _nonzero(counts):
    return {name: n for name, n in counts.items() if n}


def _unet_launches(calls):
    """Launches of ``calls`` calls of the flagship's U-Net at inference:
    the epilogue once a convolution (15), the upsample once a level below
    the top (2), the layout change on each side (2)."""
    return {"unet_epilogue": 15 * calls, "unet_upsample": 2 * calls,
            "unet_layout": 2 * calls}


def _unet_train_launches(steps, nsteps=3):
    """Launches of ``steps`` bf16 SBMC train steps' U-Nets (``nsteps`` a
    step): each U-Net's inference launches in the forward, then the
    epilogue's backward once a convolution, the upsample's once a level
    below the top and the layout change on each side in the backward."""
    calls = steps * nsteps
    return _summed(_unet_launches(calls), {
        "unet_epilogue_backward": 15 * calls,
        "unet_upsample_backward": 2 * calls, "unet_layout": 2 * calls})


def _train_launches(steps, spp, bf16):
    """Launches inside ``steps`` SBMC train steps: the forward and
    logits-gradient splat kernels once a sample slot (masked samples too;
    nothing asks for the gradient to the radiance, a batch input), and with
    bf16 convs the U-Nets' (:func:`_unet_train_launches`)."""
    want = {"progressive_splat": steps * spp,
            "progressive_splat_dlogits": steps * spp}
    return _summed(want, _unet_train_launches(steps)) if bf16 else want


def _fused_launches(tiles, spp, nsteps=3):
    """Launches of bf16 SBMC inference's own kernels over ``tiles`` tiles:
    the per-sample chain kernel once an embedding step and once a sample's
    regressor, and each step's U-Net."""
    return {"sample_chain": tiles * (nsteps + spp),
            **_unet_launches(tiles * nsteps)}


def _kpcn_launches(tiles, depth=9):
    """Launches of bf16 KPCN inference's own kernels over ``tiles`` tiles:
    a chain's entry and exit, and its epilogues (one a convolution but the
    prediction), for each of the two chains."""
    return {"kpcn_entry": 2 * tiles, "unet_epilogue": 2 * (depth - 1) * tiles,
            "kpcn_exit": 2 * tiles}


def _summed(*counts):
    """Launch counts added kernel by kernel."""
    total = {}
    for c in counts:
        for name, n in c.items():
            total[name] = total.get(name, 0) + n
    return total


def _display_launches(spp, flags):
    """Launches of one display strip of an SBMC training run (a forward
    without gradients): the splat kernel a sample, and with ``--bf16`` the
    per-sample chain kernel and the U-Nets' kernels."""
    want = {"progressive_splat": spp}
    if "--bf16" in flags:
        want.update(_fused_launches(1, spp))
    return want


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
    _check_shapes("denoise", seen, ["progressive_splat", "sample_chain"])
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


class _timed_loader:
    """While active, every batch the host loader hands over is timed from
    the request to the hand-over (``waits``, ms, in order): the time a
    consumer waits on the loader's decode threads."""

    def __init__(self):
        from sbmc_tpu_torch.data.loader import Loader
        self.cls, self.waits = Loader, []

    def __enter__(self):
        self.plain = plain = self.cls.__iter__
        waits = self.waits

        def timed_iter(loader):
            it = plain(loader)
            try:
                while True:
                    t = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    waits.append((time.perf_counter() - t) * 1e3)
                    yield batch
            finally:
                it.close()

        self.cls.__iter__ = timed_iter
        return self

    def __exit__(self, *exc):
        self.cls.__iter__ = self.plain


def _loader_shares(waits, ms):
    """Each train step's share of time spent waiting on the host loader,
    wait / (wait + step), from the waits of the batches the steps took (the
    last ``len(ms)``: the CLI draws one batch for its display strip first)
    and the steps' times."""
    if len(waits) < len(ms):
        raise AssertionError("%d loader batches for %d steps"
                             % (len(waits), len(ms)))
    waits = waits[len(waits) - len(ms):]
    shares = [w / (w + m) for w, m in zip(waits, ms)]
    return ("waits %s ms before steps of %s ms: shares %s, median %.1f%%"
            % ([round(w, 2) for w in waits], [round(m, 2) for m in ms],
               ["%.1f%%" % (100 * x) for x in shares],
               100 * sorted(shares)[len(shares) // 2]))


def _run_training(ops, tag, what, argv, steps, kernels, in_steps_want,
                  display_want, arch, owner=None, loader_wait=False):
    """Run ``sbmc_tpu_torch.train`` with ``argv`` for ``steps`` steps and
    check it: the launches inside the steps (``in_steps_want``; the steps of
    ``owner``, see ``_timed_steps``) and in all (plus ``display_want`` per
    display strip), the shapes met by ``kernels``, finite losses in the CSV
    log, and the checkpoint. Prints one line and notes the median step in
    ``_STEP_MS[tag]``; with ``loader_wait``, a second line with each step's
    share of time spent waiting on the host loader (``_loader_shares``).
    Returns ``(interface, launch counts)``."""
    from sbmc_tpu_torch import train_cli
    from sbmc_tpu_torch.train.checkpointer import Checkpointer

    ckpt = argv[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _timed_steps(ops, owner) as timed, _record_shapes(ops) as seen, \
            _timed_loader() as loader:
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
    want = _nonzero(want)
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
    if loader_wait:
        print("%s host loader: %s" % (tag, _loader_shares(loader.waits,
                                                          timed.ms)))
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
        iface, launches[tag] = _run_training(
            ops, tag, "the flagship architecture, batch %d x %d spp x "
            "128x128 (randomized sample counts)" % (bs, spp),
            [data_dir, ckpt, "--spp", str(spp), "--bs", str(bs), "--ksize",
             "21"] + flags, steps,
            ["progressive_splat", "progressive_splat_dlogits"],
            _train_launches(steps, spp, "--bf16" in flags),
            _display_launches(spp, flags), "sbmc")
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
    _check_shapes("trained-checkpoint denoise", seen,
                  ["progressive_splat", "sample_chain"])
    if len(res) != 8 or _nonzero(ops.launch_counts) != {
            "progressive_splat": 8 * spp, **_fused_launches(8, spp)}:
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
        # A bf16 checkpoint runs the chains channels-last.
        fused = ["kpcn_entry"] if flags else []
        _check_shapes(tag + " denoise", seen, ["kernel_weighting"] + fused)
        tiles = res[0]["tiles"]
        want = {"kernel_weighting": 2 * tiles}
        if fused:
            want.update(_kpcn_launches(tiles))
        if _nonzero(ops.launch_counts) != want:
            raise AssertionError("KPCN denoise launched %s, expected %s (%d "
                                 "tiles)" % (_nonzero(ops.launch_counts),
                                             want, tiles))
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
    _check_shapes("eval", seen, ["progressive_splat", "kernel_weighting",
                                 "sample_chain", "kpcn_entry"])
    methods = res["methods"]
    if methods != ["input", "ours", "nlm", "cbf", "rpf", "nfor", "lbf",
                   "kpcn"] or len(res["rows"]) != n_scenes:
        raise AssertionError("eval_suite scored %s on %d scenes"
                             % (methods, len(res["rows"])))
    tiles = res["tiles"]
    want = _summed({"progressive_splat": n_scenes * tiles["ours"] * spp,
                    "kernel_weighting": n_scenes * 2 * tiles["kpcn"]},
                   _fused_launches(n_scenes * tiles["ours"], spp),
                   _kpcn_launches(n_scenes * tiles["kpcn"]))
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
                _train_launches(steps, spp, "--bf16" in flags),
                _display_launches(spp, flags), "sbmc", owner=DeviceReservoir)
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
        _train_launches(steps, spp, True),
        _display_launches(spp, ["--bf16"]), "sbmc", loader_wait=True)
    out = os.path.join(tmp, "rendered_out", "frame.exr")
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        res = denoise.main(denoise.parse_args(
            ["--input", corpus, "--checkpoint", ckpt, "--output", out,
             "--uniform_tiles", "--tile_size", "160", "--tile_pad", "32",
             "--spp", str(spp), "--device", "cuda"]))
    launches["render_denoise"] = dict(ops.launch_counts)
    _check_shapes("render_denoise", seen, ["progressive_splat",
                                           "sample_chain"])
    tiles = sum(r["tiles"] for r in res)
    if _nonzero(ops.launch_counts) != {
            "progressive_splat": tiles * spp, **_fused_launches(tiles, spp)}:
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
        _check_shapes(tag, seen, [kernel, "kpcn_entry"] if args.model == "kpcn"
                      else [kernel, "sample_chain"])
        per_frame = res["n_tiles"] * (2 if args.model == "kpcn"
                                      else res["spp"])
        frames = res["warmup"] + res["iters"]
        want = {kernel: per_frame * frames}
        if args.model != "kpcn":
            want.update(_fused_launches(frames * res["n_tiles"], res["spp"]))
        else:
            want.update(_kpcn_launches(frames * res["n_tiles"]))
        if _nonzero(launches[tag]) != want:
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
        _check_shapes(tag, seen, ["progressive_splat", "sample_chain"])
        want = {"progressive_splat": len(res["tiles"]) * spp,
                **_fused_launches(len(res["tiles"]), spp)}
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
    _check_shapes("kernel_grids", seen, ["progressive_splat", "sample_chain"])
    if _nonzero(launches["kernel_grids"]) != {
            "progressive_splat": spp, **_fused_launches(1, spp)}:
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
             ["progressive_splat", "sample_chain"],
             # Six model calls, and the U-Net stage's own six.
             {"progressive_splat": 2 * 6 * 4, **_fused_launches(6, 4),
              **_unet_launches(6 * 3 + 6)}),
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
        _train_launches(steps, spp, True),
        _display_launches(spp, ["--bf16"]), "sbmc", loader_wait=True)
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
    _check_shapes("pbrt_denoise", seen, ["progressive_splat", "sample_chain"])
    tiles = sum(r["tiles"] for r in res)
    if len(res) != 1 or _nonzero(ops.launch_counts) != {
            "progressive_splat": tiles * spp, **_fused_launches(tiles, spp)}:
        raise AssertionError("denoising a pbrt scene: %d scenes, launches "
                             "%s" % (len(res), ops.launch_counts))
    img = exr.read(res[0]["output"])
    if img.shape != (512, 512, 3) or not np.isfinite(img).all():
        raise AssertionError("pbrt-scene denoise wrote %s" % (img.shape,))
    print("15d pbrt corpus: trained %d steps, then denoised one 512x512 "
          "scene (%d tiles) with the checkpoint: a finite EXR, %d forward "
          "launches" % (steps, tiles, tiles * spp))
    return launches


# ---------------------------------------------------------------------------
# Phase 16: several ranks (sbmc_tpu_torch/parallel/mesh.py)

#: A rank's own deadline: a rank that hangs in a collective fails the run.
DP_TIMEOUT = 600
#: The train CLI's default learning rate, which 16b's steps use.
DP_LR = 1e-4
#: 16b, float32: tests/test_torch_train.py's tolerances for one step (loss
#: relative; gradient ``atol + rtol * |one process|``; the update, where the
#: one-process gradient exceeds UPDATE_G, within UPDATE of the learning
#: rate).
DP_LOSS, DP_G_ATOL, DP_G_RTOL, DP_UPDATE_G, DP_UPDATE = (1e-5, 1e-6, 1e-3,
                                                         1e-5, 0.02)
#: 16b with --bf16: metrics within DP_BF16_LOSS relative and each leaf's
#: gradient within DP_BF16_LEAF of its L2 norm, as
#: test_train_step_bf16_matches_jax_loosely holds them; the whole gradient
#: no farther (relative L2) from the one process's than that process's
#: bf16 gradient is from its own float32 gradient on the same state. cuDNN
#: picks its bf16 algorithms by batch size, so a rank's half of the batch
#: rounds otherwise than the whole: as tight as bf16 rounding lets two
#: computations agree (0.078 measured on the first step on an H100,
#: where the SMALL CPU model's 0.06 of that test did not hold). Each step
#: also reads the fault the bound must catch: rank 0's gradient had the
#: all-reduce been skipped (one process on rank 0's half of the batch),
#: which must lie beyond it.
DP_BF16_LOSS, DP_BF16_LEAF = 2e-2, 0.5
#: 16a: the world-1 run's first loss (one forward of the same weights on
#: the same batch) within DP_FIRST of the plain run's (relative). The later
#: losses are printed, not bounded: cuDNN's float32 backward is not
#: deterministic and Adam amplifies its noise step by step, while at world
#: size 1 the all-reduce is an identity; 16b holds the data-parallel
#: arithmetic.
DP_FIRST = 1e-6


class _counted_writes:
    """While active, counts what this process writes of a training run:
    checkpoint saves, CSV rows and display strips."""

    def __init__(self):
        from sbmc_tpu_torch.train import callbacks
        from sbmc_tpu_torch.train.checkpointer import Checkpointer
        self.targets = ((Checkpointer, "save", "checkpoints"),
                        (callbacks.ScalarLogCallback, "batch_end",
                         "csv_rows"),
                        (callbacks.DenoisingDisplayCallback, "epoch_end",
                         "strips"))
        self.counts = {name: 0 for _, _, name in self.targets}

    def __enter__(self):
        self.plain = [getattr(cls, attr) for cls, attr, _ in self.targets]
        for (cls, attr, name), plain in zip(self.targets, self.plain):
            def counted(*args, _plain=plain, _name=name, **kw):
                self.counts[_name] += 1
                return _plain(*args, **kw)
            setattr(cls, attr, counted)
        return self

    def __exit__(self, *exc):
        for (cls, attr, _), plain in zip(self.targets, self.plain):
            setattr(cls, attr, plain)


def _cli_job(ops, argv):
    """``sbmc_tpu_torch.train`` with ``argv``, in this process (a rank or
    the one process): launches in all and inside the steps, the shapes the
    ops met, each step's ms and loader wait, what this process wrote."""
    from sbmc_tpu_torch import train_cli
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with _timed_steps(ops) as timed, _record_shapes(ops) as seen, \
            _timed_loader() as loader, _counted_writes() as writes:
        iface = train_cli.main(train_cli.parse_args(argv))
    torch.cuda.synchronize()
    return {"launches": dict(ops.launch_counts), "in_steps": timed.launches,
            "seen": {op: sorted(cases) for op, cases in seen.items()},
            "ms": timed.ms, "waits": loader.waits, "writes": writes.counts,
            "step": iface.step, "device": str(iface.device)}


def _rel_l2(got, want):
    """The largest leaf's and the whole gradient's relative L2 distance."""
    diff = [float((g - w).norm()) for g, w in zip(got, want)]
    norm = [float(w.norm()) for w in want]
    return (max(d / n for d, n in zip(diff, norm) if n > 0),
            float(np.sqrt(sum(d * d for d in diff))
                  / np.sqrt(sum(n * n for n in norm))))


def _grad_stats(model, before, lr, ref, ref32=None, half=None):
    """One data-parallel step of ``model`` against ``ref``'s one-process
    step from the same state: the gradients and (float32) the updates;
    with bf16 convs, ``ref32``'s float32 step from that state gives the
    bf16 rounding's own drift, and ``half``'s step on rank 0's half of the
    batch what a skipped all-reduce would read."""
    got = [p.grad.float() for p in model.parameters()]
    want = [p.grad.float() for p in ref.parameters()]
    if ref32 is not None:
        leaf, whole = _rel_l2(got, want)
        return {"leaf": leaf, "whole": whole, "drift": _rel_l2(
            want, [p.grad for p in ref32.parameters()])[1],
            "no_allreduce": _rel_l2(
                [p.grad.float() for p in half.parameters()], want)[1]}
    g_ratio = max(float(((g - w).abs() / (DP_G_ATOL + DP_G_RTOL * w.abs()))
                        .max()) for g, w in zip(got, want))
    upd, compared = 0.0, 0
    for p, r, b, w in zip(model.parameters(), ref.parameters(), before,
                          want):
        big = w.abs() > DP_UPDATE_G
        compared += int(big.sum())
        if bool(big.any()):
            upd = max(upd, float(((p - b) - (r - b))[big].abs().max()) / lr)
    return {"g_ratio": g_ratio, "update": upd, "compared": compared}


def _steps_job(ops, job, rank, world):
    """16b on this rank: the flagship architecture from ``torch.manual_seed
    (0)`` takes one step on its contiguous share of each global batch,
    data-parallel; rank 0 first takes the one-process step on the whole
    global batch from the same state (parameters and Adam's moments copied
    in) and compares. Launches and shapes are those of the data-parallel
    steps alone: the counts are zeroed just before each and read just
    after."""
    import copy
    from sbmc_tpu_torch.models import Multisteps
    from sbmc_tpu_torch.train.interface import DenoiserInterface
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.manual_seed(0)
    model = Multisteps(n_features=93, n_global_features=3, ksize=21,
                       conv_dtype="bfloat16" if job["bf16"] else None)
    iface = DenoiserInterface(model, lr=DP_LR, device=dev, distributed=True)
    refs = []
    if rank == 0:
        # The one process on the whole batch; with bf16, also its float32
        # twin and the one process on rank 0's half.
        refs = [DenoiserInterface(copy.deepcopy(model), lr=DP_LR, device=dev)]
        if job["bf16"]:
            refs += [DenoiserInterface(
                Multisteps(n_features=93, n_global_features=3, ksize=21),
                lr=DP_LR, device=dev),
                DenoiserInterface(copy.deepcopy(model), lr=DP_LR,
                                  device=dev)]
    launches = {name: 0 for name in ops.launch_counts}
    rec = _record_shapes(ops)
    metrics, ref_metrics, stats, ms = [], [], [], []
    for path in job["batches"]:
        with np.load(path) as f:
            batch = dict(f)
        n = len(batch["target_image"]) // world
        mine = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
        if refs:
            for other in refs:
                other.model.load_state_dict(model.state_dict())
                other.optimizer.load_state_dict(
                    copy.deepcopy(iface.optimizer.state_dict()))
            before = [p.detach().clone() for p in model.parameters()]
            ref_metrics.append({k: float(v) for k, v in
                                refs[0].train_step(batch).items()})
            if job["bf16"]:
                refs[1].train_step(batch)
                ref_metrics[-1]["no_allreduce_loss"] = float(
                    refs[2].train_step(mine)["loss"])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        with rec:
            got = iface.train_step(mine)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        for name, c in ops.launch_counts.items():
            launches[name] += c
        metrics.append({k: float(v) for k, v in got.items()})
        if refs:
            stats.append(_grad_stats(model, before, DP_LR,
                                     *[r.model for r in refs]))
    digest = [float(sum(p.grad.double().sum() for p in model.parameters())),
              float(sum(p.double().sum() for p in model.parameters()))]
    return {"launches": launches, "in_steps": launches,
            "seen": {op: sorted(cases) for op, cases in rec.seen.items()},
            "ms": ms, "metrics": metrics, "ref_metrics": ref_metrics,
            "stats": stats, "digest": digest, "step": iface.step,
            "device": str(dev)}


def _rank_main(spec_path):
    """A rank of phase 16, started by torchrun (``chip_smoke.py --rank
    SPEC``): joins the group (gloo, every rank on cuda:0, or NCCL through
    the port's own ``init_distributed``), runs SPEC's jobs and writes what
    each measured to SPEC's ``out`` (``%d``: the rank)."""
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from sbmc_tpu_torch import ops
    from sbmc_tpu_torch.ops import _build
    from sbmc_tpu_torch.parallel.mesh import init_distributed, shutdown

    with open(spec_path) as f:
        spec = json.load(f)
    _build.load_cuda()  # the parent's build, from the cache
    if spec["backend"] == "gloo":
        # Two ranks on one card: NCCL refuses that, gloo reduces CUDA
        # tensors through the host. init_distributed reuses this group.
        dist.init_process_group("gloo")
        os.environ["LOCAL_RANK"] = "0"
    rank, world, dev = init_distributed("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = []
    for job in spec["jobs"]:
        if job["kind"] == "cli":
            res = _cli_job(ops, job["argv"])
        else:
            res = _steps_job(ops, job, rank, world)
        res.update(tag=job["tag"], rank=rank,
                   current_device=torch.cuda.current_device(),
                   backend=dist.get_backend())
        results.append(res)
    with open(spec["out"] % rank, "w") as f:
        json.dump(results, f)
    shutdown()


def _torchrun(tmp, name, backend, jobs, nproc):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    NPROC chip_smoke.py --rank SPEC``; raises unless every rank ends well
    within DP_TIMEOUT. Returns ``(seconds, results[rank][job])``."""
    import signal
    spec = {"backend": backend, "jobs": jobs,
            "out": os.path.join(tmp, name + "_rank%d.json")}
    path = os.path.join(tmp, name + ".json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), os.path.join(ROOT, "chip_smoke.py"),
         "--rank", path], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError("%s: the ranks did not end within %d s"
                             % (name, DP_TIMEOUT))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("%s failed (%d): %s" % (name, proc.returncode,
                                                     err[-6000:]))
    results = []
    for r in range(nproc):
        with open(spec["out"] % r) as f:
            results.append(json.load(f))
    return seconds, results


def _merge_rank(by_path, path, res, kernels):
    """A rank's launches into ``by_path`` and its shapes into the checks."""
    seen = {op: {tuple(tuple(x) if isinstance(x, list) else x for x in c)
                 for c in cases}
            for op, cases in res["seen"].items()}
    _check_shapes(path, seen, kernels)
    by_path[path] = res["launches"]


def _csv_losses(ckpt):
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _dp_world1(ops, tmp, by_path, steps=4, spp=8, bs=4):
    """16a: NCCL at world size 1 through torchrun, at phase 8's flagship
    configuration (f32) with constant sample counts, against one plain run
    in this process."""
    data_dir = os.path.join(tmp, "train_data")

    def argv(ckpt):
        # Constant sample counts: the random masks are drawn in the
        # loader's threads, whose draws race with the display strip's
        # batch, so two runs of the CLI draw different masks.
        return [data_dir, os.path.join(tmp, ckpt), "--spp", str(spp), "--bs",
                str(bs), "--ksize", "21", "--constant_spp", "--max_steps",
                str(steps), "--log_interval", "1", "--num_worker_threads",
                "2", "--device", "cuda"]

    plain = _cli_job(ops, argv("ckpt_dp_plain"))
    seconds, ranks = _torchrun(tmp, "dp_world1", "nccl", [
        {"kind": "cli", "tag": "world1", "argv": argv("ckpt_dp_world1")}], 1)
    res = ranks[0][0]
    if res["backend"] != "nccl" or res["step"] != steps:
        raise AssertionError("16a: backend %s, %d steps" % (res["backend"],
                                                             res["step"]))
    want = {"progressive_splat": steps * spp,
            "progressive_splat_dlogits": steps * spp}
    for r in (res, plain):
        if _nonzero(r["in_steps"]) != want:
            raise AssertionError("16a: launches inside the steps %s, "
                                 "expected %s" % (_nonzero(r["in_steps"]),
                                                  want))
    _merge_rank(by_path, "dp_world1", res,
                ["progressive_splat", "progressive_splat_dlogits"])
    base = _csv_losses(os.path.join(tmp, "ckpt_dp_plain"))
    got = _csv_losses(os.path.join(tmp, "ckpt_dp_world1"))
    dev = [abs(g - x) / abs(x) for x, g in zip(base, got)]
    print("16a NCCL at world size 1 (torchrun --standalone, %.1f s with the "
          "process's start): %d flagship f32 steps of %d x %d spp; losses %s, "
          "plain run %s; relative distance %s (step 1 bound %g; the later "
          "steps carry cuDNN's nondeterministic backward); median ms/step "
          "under DDP %.2f, plain %.2f; launches B1 %d, B3 %d"
          % (seconds, steps, bs, spp, got, base, ["%.3g" % d for d in dev],
             DP_FIRST, _median(res["ms"][1:]), _median(plain["ms"][1:]),
             res["in_steps"]["progressive_splat"],
             res["in_steps"]["progressive_splat_dlogits"]))
    if len(got) != steps or dev[0] > DP_FIRST:
        raise AssertionError("16a: the world-1 run's first loss is %.3g from "
                             "the plain run's (bound %g)" % (dev[0],
                                                             DP_FIRST))


def _dp_batches(tmp, spp=8, n=3, bs=4):
    """``n`` fixed global batches of ``bs`` of phase 8's tiles with fixed
    sample masks (2 to ``spp`` valid), written to ``.npz`` files."""
    from sbmc_tpu_torch.data import TilesDataset, collate
    data = TilesDataset(os.path.join(tmp, "train_data"), spp=spp)
    rng = np.random.RandomState(16)
    paths = []
    for i in range(n):
        idx = [(i * 2 + j) % len(data) for j in range(bs)]
        batch = {k: v for k, v in collate([data[j] for j in idx]).items()
                 if isinstance(v, np.ndarray)}
        ks = rng.randint(2, spp + 1, bs)
        batch["sample_mask"] = np.arange(spp)[None] < ks[:, None]
        paths.append(os.path.join(tmp, "dp_batch_%d.npz" % i))
        np.savez(paths[-1], **batch)
    return paths


def _check_dp_steps(tag, ranks, steps, spp):
    """16b's checks of one job on every rank: prints each step's numbers,
    then raises on the first that fails."""
    r0 = ranks[0]
    bf16 = tag.endswith("bf16")
    faults = []
    for s, (got, want, st) in enumerate(zip(r0["metrics"], r0["ref_metrics"],
                                            r0["stats"])):
        rel = {k: abs(got[k] - want[k]) / abs(want[k])
               for k in ("loss", "rmse", "input_loss")}
        print("16b %s step %d against one process: metrics %s, gradient %s"
              % (tag, s + 1, {k: "%.3g" % v for k, v in rel.items()},
                 {k: "%.4g" % v for k, v in st.items()}))
        if max(rel.values()) > (DP_BF16_LOSS if bf16 else DP_LOSS):
            faults.append("step %d: metrics %s" % (s + 1, rel))
        if bf16 and (st["leaf"] > DP_BF16_LEAF
                     or st["whole"] > st["drift"]):
            faults.append("step %d: gradient %s" % (s + 1, st))
        if bf16:
            # What the bounds read had rank 0 kept its own half's gradient
            # (and loss): the fault they must tell from a sound step.
            fault_loss = abs(want["no_allreduce_loss"] - want["loss"]) \
                / abs(want["loss"])
            print("16b %s step %d, a skipped all-reduce would read: whole "
                  "gradient %.4g (bound %.4g), loss %.3g (bound %g)"
                  % (tag, s + 1, st["no_allreduce"], st["drift"],
                     fault_loss, DP_BF16_LOSS))
            if st["no_allreduce"] <= st["drift"]:
                faults.append("step %d: the gradient bound %.4g does not "
                              "catch a skipped all-reduce (%.4g)"
                              % (s + 1, st["drift"], st["no_allreduce"]))
        if not bf16 and (st["g_ratio"] > 1 or st["update"] > DP_UPDATE
                         or st["compared"] < 1000):
            faults.append("step %d: gradient %s" % (s + 1, st))
    want = _train_launches(steps, spp, bf16)
    for r in ranks:
        if r["digest"] != r0["digest"] or r["metrics"] != r0["metrics"]:
            faults.append("rank %d's gradients, parameters or metrics "
                          "differ from rank 0's" % r["rank"])
        if _nonzero(r["in_steps"]) != want:
            faults.append("rank %d: launches in the steps %s, expected %s"
                          % (r["rank"], _nonzero(r["in_steps"]), want))
    if len(r0["stats"]) != steps or faults:
        raise AssertionError("%s: %s" % (tag, "; ".join(faults)))


def _dp_steps(ops, tmp, by_path, steps=3, spp=8):
    """16b: two ranks on cuda:0 over gloo, the flagship architecture, fixed
    global batches of 4 (2 a rank), f32 then --bf16, each step against one
    process's step on the global batch from the same state."""
    batches = _dp_batches(tmp, spp, steps)
    jobs = [{"kind": "steps", "tag": tag, "bf16": bf16, "batches": batches}
            for tag, bf16 in (("dp_steps", False), ("dp_steps_bf16", True))]
    seconds, ranks = _torchrun(tmp, "dp_steps", "gloo", jobs, 2)
    for j, job in enumerate(jobs):
        tag = job["tag"]
        per_rank = [r[j] for r in ranks]
        if any(r["backend"] != "gloo" or r["device"] != "cuda:0"
               for r in per_rank):
            raise AssertionError("%s: not gloo on cuda:0: %s" % (
                tag, [(r["backend"], r["device"]) for r in per_rank]))
        _check_dp_steps(tag, per_rank, steps, spp)
        for r in per_rank:
            _merge_rank(by_path, "%s_rank%d" % (tag, r["rank"]), r,
                        ["progressive_splat", "progressive_splat_dlogits"])
        print("16b %s: two ranks on cuda:0 over gloo (%.1f s for both jobs "
              "with the processes' start), %d flagship steps of a global "
              "batch of 4 (2 a rank) x %d spp, each within its tolerance of "
              "one process's step from the same state; ms/step, two ranks "
              "sharing one card: rank 0 %s, rank 1 %s (rank 0 also runs the "
              "one-process steps between them); launches a rank B1 %d, B3 %d"
              % (tag, seconds, steps, spp,
                 [round(x, 2) for x in per_rank[0]["ms"]],
                 [round(x, 2) for x in per_rank[1]["ms"]],
                 per_rank[0]["in_steps"]["progressive_splat"],
                 per_rank[0]["in_steps"]["progressive_splat_dlogits"]))


def _dp_cli(ops, tmp, by_path, steps=4, spp=8, bs=2):
    """16c: the 2-rank CLI in gloo on the one card, bf16, on phase 8f's 12
    tiles: SBMC then KPCN; only rank 0 writes; the SBMC checkpoint resumes
    in one process and denoises phase 7's frame."""
    from sbmc_tpu_torch import denoise, train_cli
    from sbmc_tpu_torch.utils import exr
    tiles = os.path.join(tmp, "reservoir_tiles.txt")
    ckpts = {m: os.path.join(tmp, "ckpt_dp_cli_" + m) for m in ("sbmc",
                                                               "kpcn")}
    model = ["--spp", str(spp), "--bs", str(bs), "--ksize", "21", "--bf16"]

    def run(n):
        return ["--max_steps", str(n), "--log_interval", "1",
                "--num_worker_threads", "2", "--device", "cuda"]

    base = model + run(steps)
    jobs = [{"kind": "cli", "tag": "dp_cli", "argv":
             [tiles, ckpts["sbmc"]] + base},
            {"kind": "cli", "tag": "dp_cli_kpcn", "argv":
             [tiles, ckpts["kpcn"], "--kpcn_mode"] + base}]
    seconds, ranks = _torchrun(tmp, "dp_cli", "gloo", jobs, 2)
    wants = {"dp_cli": _train_launches(steps, spp, True),
             "dp_cli_kpcn": {"kernel_weighting": 2 * steps,
                             "kernel_weighting_dw": 2 * steps}}
    for j, job in enumerate(jobs):
        tag, want = job["tag"], wants[job["tag"]]
        for r in (ranks[0][j], ranks[1][j]):
            w = r["writes"]
            wrote = (w["checkpoints"] > 0 and w["csv_rows"] == steps
                     and (w["strips"] > 0) == (tag == "dp_cli"))
            if r["rank"] == 0 and not wrote or r["rank"] == 1 and any(
                    w.values()):
                raise AssertionError("%s rank %d wrote %s" % (tag, r["rank"],
                                                              w))
            if _nonzero(r["in_steps"]) != want or r["step"] != steps:
                raise AssertionError("%s rank %d: %d steps, launches in the "
                                     "steps %s, expected %s" % (
                                         tag, r["rank"], r["step"],
                                         _nonzero(r["in_steps"]), want))
            _merge_rank(by_path, "%s_rank%d" % (tag, r["rank"]), r,
                        list(want))
        ckpt = ckpts["kpcn" if tag.endswith("kpcn") else "sbmc"]
        files = set(os.listdir(ckpt))
        if not {"final.msgpack", "ckpt_%09d.msgpack" % steps, "meta.json",
                "train_log.csv"} <= files or len(_csv_losses(ckpt)) != steps:
            raise AssertionError("%s: the checkpoint directory holds %s"
                                 % (tag, sorted(files)))
        for r in (ranks[0][j], ranks[1][j]):
            print("16c %s rank %d: %d steps of %d a rank x %d spp (bf16), "
                  "median ms/step %.2f (two ranks sharing one card); wrote "
                  "%s; host loader: %s"
                  % (tag, r["rank"], steps, bs, spp, _median(r["ms"][1:]),
                     r["writes"], _loader_shares(r["waits"], r["ms"])))
    print("16c: both jobs on two ranks in %.1f s with the processes' start"
          % seconds)
    # The SBMC checkpoint resumes in one process, then denoises.
    ops.reset_launch_counts()
    iface = train_cli.main(train_cli.parse_args(
        [tiles, ckpts["sbmc"]] + model + run(steps + 1)))
    if iface.step != steps + 1 or len(_csv_losses(ckpts["sbmc"])) != steps + 1:
        raise AssertionError("16c: the resumed run is at step %d"
                             % iface.step)
    del iface
    out = os.path.join(tmp, "out_dp_cli", "frame.exr")
    ops.reset_launch_counts()
    with _record_shapes(ops) as seen:
        res = denoise.main(denoise.parse_args(
            ["--input", os.path.join(tmp, "data"), "--checkpoint",
             ckpts["sbmc"], "--output", out, "--uniform_tiles", "--tile_size",
             "160", "--tile_pad", "32", "--spp", "4", "--device", "cuda"]))
    _check_shapes("dp_cli_denoise", seen, ["progressive_splat",
                                           "sample_chain"])
    img = exr.read(out)
    if (img.shape != (256, 256, 3) or not np.isfinite(img).all()
            or _nonzero(ops.launch_counts) != {
                "progressive_splat": res[0]["tiles"] * 4,
                **_fused_launches(res[0]["tiles"], 4)}):
        raise AssertionError("16c denoise: EXR %s, launches %s" % (
            img.shape, _nonzero(ops.launch_counts)))
    by_path["dp_cli_denoise"] = dict(ops.launch_counts)
    print("16c: the 2-rank checkpoint resumed in one process (step %d) and "
          "denoised the 256x256 frame: a finite EXR, %d B1 launches"
          % (steps + 1, ops.launch_counts["progressive_splat"]))


def _dp_replicas(ops, tmp, by_path, checkpoint, devices, spp=4):
    """16d (``devices`` [cuda:0, cuda:0]) and 16e (cuda:0 and cuda:1): the
    ragged and uniform runners on phase 7's frame with the flagship; the
    frame equals one device's bit for bit."""
    from sbmc_tpu_torch import denoise
    from sbmc_tpu_torch.data.datasets import FullImagesDataset
    from sbmc_tpu_torch.parallel.mesh import replicas
    item = FullImagesDataset(os.path.join(tmp, "data"), spp=spp)[0]
    batch = {k: v[None] if isinstance(v, np.ndarray) else v
             for k, v in item.items()}
    model, _, _ = denoise.load_model(checkpoint, devices[0])
    one = [devices[0]]
    tag = "dp_replicas" if len(set(devices)) == 1 else "dp_cards"
    for run, extra in ((denoise.denoise_ragged, []),
                       (denoise.denoise_uniform, ["--uniform_tiles"])):
        args = denoise.parse_args(
            ["--input", "-", "--checkpoint", checkpoint, "--output", "o.exr",
             "--tile_size", "160", "--tile_pad", "32", "--device", "cuda"]
            + extra)
        name = "%s_%s" % (tag, "uniform" if extra else "ragged")
        with torch.inference_mode():
            want, ms_one, tiles = run([model], batch, args, one)
            ops.reset_launch_counts()
            with _record_shapes(ops) as seen:
                got, ms, _ = run(replicas(model, devices), batch, args,
                                 devices)
        _check_shapes(name, seen, ["progressive_splat", "sample_chain"])
        by_path[name] = dict(ops.launch_counts)
        if _nonzero(ops.launch_counts) != {
                "progressive_splat": tiles * spp,
                **_fused_launches(tiles, spp)}:
            raise AssertionError("%s: launches %s for %d tiles" % (
                name, _nonzero(ops.launch_counts), tiles))
        diff = float(np.abs(got - want).max())
        if diff != 0:
            raise AssertionError("%s: the frame differs from one device's "
                                 "by up to %.3g" % (name, diff))
        print("16d %s on %s: %d tiles, the frame equals one device's bit for "
              "bit; %.2f ms against %.2f on one; B1 launches %d"
              % (name, [str(d) for d in devices], tiles, ms, ms_one,
                 ops.launch_counts["progressive_splat"]))


def _dp_cards(ops, tmp, by_path, checkpoint):
    """16e, on two cards or more: 16b and 16c with NCCL on cuda:0 and 1,
    and the replicas of 16d on the two cards."""
    batches = _dp_batches(tmp)
    tiles = os.path.join(tmp, "reservoir_tiles.txt")
    jobs = [{"kind": "steps", "tag": "nccl_steps", "bf16": False,
             "batches": batches},
            {"kind": "cli", "tag": "nccl_cli", "argv": [
                tiles, os.path.join(tmp, "ckpt_nccl_cli"), "--spp", "8",
                "--bs", "2", "--ksize", "21", "--bf16", "--max_steps", "4",
                "--log_interval", "1", "--num_worker_threads", "2",
                "--device", "cuda"]}]
    seconds, ranks = _torchrun(tmp, "dp_nccl", "nccl", jobs, 2)
    _check_dp_steps("nccl_steps", [r[0] for r in ranks], 3, 8)
    for j, job in enumerate(jobs):
        for r in (ranks[0][j], ranks[1][j]):
            if r["backend"] != "nccl" or r["current_device"] != r["rank"] \
                    or r["in_steps"]["progressive_splat"] <= 0:
                raise AssertionError("%s rank %d: %s on cuda:%d, launches %s"
                                     % (job["tag"], r["rank"], r["backend"],
                                        r["current_device"], r["in_steps"]))
            _merge_rank(by_path, "%s_rank%d" % (job["tag"], r["rank"]), r,
                        ["progressive_splat", "progressive_splat_dlogits"])
    if ranks[1][1]["writes"]["checkpoints"] or not ranks[0][1]["writes"][
            "checkpoints"]:
        raise AssertionError("16e: writes %s" % [r[1]["writes"]
                                                 for r in ranks])
    print("16e NCCL on cuda:0 and cuda:1 (%.1f s): the steps agree with one "
          "process; rank 1's kernels launched on cuda:1" % seconds)
    _dp_replicas(ops, tmp, by_path, checkpoint,
                 [torch.device("cuda", 0), torch.device("cuda", 1)])


#: (bs, spp, h, w) the sample chain kernel is held to its plain version at
#: with chains of several widths (18a): odd planes (element-by-element loads
#: and stores), even planes that are not a multiple of 8 pixels (16-byte
#: rows misaligned), ragged last warp tiles, 1 and 8 samples.
CHAIN_CASES = ((2, 4, 37, 53), (1, 1, 30, 27), (2, 8, 16, 40), (1, 3, 9, 8),
               (1, 4, 64, 64))
#: (bs, spp, h, w) the paths give the flagship's chains (18c), all bf16
#: SBMC inference: the denoise path's 160 px tiles at 4 spp (also the
#: two-rank checkpoint's denoise and the replicas), the evaluation path's
#: ragged tiles of a 256x256 frame (160 and 64 px sides), the trained
#: checkpoint's 128x128 frames and the probes' tiles at 8 spp, the display
#: strips of bf16 training runs (a batch of 4, and a rank's batch of 2 in
#: the two-rank CLI) at 8 spp, the rendered-corpus and pbrt-branch denoise's
#: 160 px tiles at 8 spp, kernel_grids' 64 px crop, the stage profile's
#: 1216x768 strip, the bench's ragged tiles (512 and 312 rows, 512 and 384
#: columns) and its uniform 1080x2048 tile, whose planes pass 2^31 bytes
#: (last: 18c times the kernels there).
CHAIN_PATH_SHAPES = (
    (1, 4, 160, 160), (1, 4, 160, 64), (1, 4, 64, 160), (1, 4, 64, 64),
    (1, 8, 128, 128), (4, 8, 128, 128), (2, 8, 128, 128), (1, 8, 160, 160),
    (1, 8, 64, 64), (1, 4, 1216, 768), (1, 4, 512, 512), (1, 4, 512, 384),
    (1, 4, 312, 512), (1, 4, 312, 384), (1, 4, 1080, 2048))
# Kernel against plain version on the card, in bf16 units at the larger of
# |plain| and the tensor's mean magnitude: the split first layer and the
# order of float32 sums (MMA against cuDNN) flip a rounding now and then,
# and a flipped hidden activation moves the outputs it feeds by a few units.
CHAIN_MAX_UNITS, CHAIN_MEAN_UNITS = 8.0, 0.02
H100_BF16_FLOPS = 989e12  # dense tensor cores, H100 SXM data sheet


def _bf16_units(got, want):
    want = want.float()
    scale = torch.maximum(want.abs(), want.abs().mean().expand_as(want))
    ulp = torch.pow(2.0, torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
    return (got.float() - want).abs() / ulp


def _check_chain(what, got, want):
    if isinstance(got, tuple):
        return max((_check_chain("%s %s" % (what, part), g, w_)
                    for part, g, w_ in zip(("embedded", "reduced"), got,
                                           want)), key=lambda r: r[0])
    units = _bf16_units(got, want)
    mx, mean = float(units.max()), float(units.mean())
    share = float((got != want).float().mean())
    if not (mx <= CHAIN_MAX_UNITS and mean <= CHAIN_MEAN_UNITS):
        raise AssertionError(
            "sample chain kernel disagrees with its plain version at %s: "
            "max %.3g, mean %.3g bf16 units (%.4f%% of values differ)"
            % (what, mx, mean, 100 * share))
    _MAX_ERR["sample_chain"] = max(_MAX_ERR.get("sample_chain", 0.0), mx)
    return mx, mean, share


def _chain_module(cin, cout, width, activation, seed):
    from sbmc_tpu_torch.nn.layers import ConvChain
    torch.manual_seed(seed)
    chain = ConvChain(cin, cout, ksize=1, width=width, depth=3,
                      activation=activation, dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in chain.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.3 * torch.randn_like(p))
    return chain.cuda()


def _chain_inputs(gen, bs, spp, h, w, cx, ce, per_batch, masked):
    dev = torch.device("cuda")
    feats = torch.randn(bs, spp, cx, h, w, generator=gen,
                        device=dev).to(torch.bfloat16)
    eh, ew = (1, 1) if per_batch else (h, w)
    extra = torch.randn(bs, ce, eh, ew, generator=gen,
                        device=dev).to(torch.bfloat16)
    if masked:
        mask_f = (torch.rand(bs, spp, generator=gen, device=dev)
                  < 0.6).to(torch.bfloat16)
        mask_f[0, 0] = 0
    else:
        mask_f = torch.ones(bs, spp, dtype=torch.bfloat16, device=dev)
    return feats, extra, mask_f, mask_f.sum(dim=1).clamp(min=1.0)


def _chain_checks(sc):
    """18a: both kernels against their plain versions on the card."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    worst = {}
    # (step, feature channels, extra channels, width, cout)
    steps = ((0, 93, 3, 128, 128), (1, 128, 128, 128, 128),
             (0, 13, 3, 8, 8), (1, 8, 8, 8, 8), (1, 16, 40, 32, 24))
    for step, cx, ce, width, cout in steps:
        chain = _chain_module(cx + ce, cout, width, "relu", step + width)
        for bs, spp, h, w in CHAIN_CASES:
            for masked in (False, True):
                args = _chain_inputs(gen, bs, spp, h, w, cx, ce, step == 0,
                                     masked and spp > 1)
                got = sc.embedding_step(chain, *args)
                want = sc.embedding_step_ref(chain, *args)
                what = "embed step %d %d+%d w%d %s%s" % (
                    step, cx, ce, width, (bs, spp, h, w),
                    " masked" if masked else "")
                worst[what] = _check_chain(what, got, want)
                _COMPARED["sample_chain"].add(_chain_case(chain, *args[:2]))
    for cx, ce, width, nout in ((128, 128, 128, 441), (8, 8, 8, 25),
                                (16, 40, 32, 9)):
        chain = _chain_module(cx + ce, nout, width, "leaky_relu", nout)
        weights = sc.regressor_weights(chain)
        for bs, spp, h, w in CHAIN_CASES:
            feats, prop, _, _ = _chain_inputs(gen, bs, spp, h, w, cx, ce,
                                              False, False)
            for s in range(spp):
                for dt in (None, torch.float32):
                    got = sc.regress(chain, feats[:, s], prop, dt, weights)
                    want = sc.regress_ref(chain, feats[:, s], prop, dt)
                    if got.dtype != want.dtype:
                        raise AssertionError("regressor dtype %s, plain %s"
                                             % (got.dtype, want.dtype))
                    what = "regress %d+%d w%d -> %d %s s%d %s" % (
                        cx, ce, width, nout, (bs, spp, h, w), s, dt)
                    worst[what] = _check_chain(what, got, want)
                    _COMPARED["sample_chain"].add(
                        _chain_case(chain, feats[:, s], prop))
    # Extreme logits: the clamp and NaN.
    chain = _chain_module(16, 9, 8, "leaky_relu", 3)
    with torch.no_grad():
        chain.prediction.bias[:3] = torch.tensor([1e6, -1e6, float("nan")])
    x = torch.randn(1, 8, 5, 6, device="cuda").to(torch.bfloat16)
    got = sc.regress(chain, x, x, None)
    want = sc.regress_ref(chain, x, x, None)
    if not torch.equal(got[:, :2], want[:, :2]) or \
            not bool(got[:, 2].isnan().all()):
        raise AssertionError("regressor clamp: %s against %s"
                             % (got[0, :3, 0, 0], want[0, :3, 0, 0]))
    top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:3]
    print("18a sample chain kernel against plain (%d cases): worst %s"
          % (len(worst), "; ".join("%s: max %.2f mean %.4f units, %.4f%% "
                                   "differ" % (k, v[0], v[1], 100 * v[2])
                                   for k, v in top)))


def _chain_model_checks(ops, sc):
    """18b: the model calls the kernel 3 + spp times under inference and
    never with gradients on (where only the U-Nets take their kernels), and
    the wrapper refuses what requires grad."""
    from sbmc_tpu_torch.models.multisteps import Multisteps
    torch.manual_seed(0)
    model = Multisteps(93, 3, width=128, embedding_width=128, ksize=21,
                       conv_dtype="bfloat16", kernel_dtype="bfloat16").cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    bs, spp, h, w = 1, 4, 96, 128
    x = {"radiance": torch.rand(bs, spp, 3, h, w, generator=gen,
                                device="cuda"),
         "features": torch.randn(bs, spp, 93, h, w, generator=gen,
                                 device="cuda"),
         "global_features": torch.randn(bs, 3, 1, 1, generator=gen,
                                        device="cuda")}
    ops.reset_launch_counts()
    with torch.inference_mode():
        fused = model(x)["radiance"]
    torch.cuda.synchronize()
    got = _nonzero(ops.launch_counts)
    if got != dict(_fused_launches(1, spp), progressive_splat=spp):
        raise AssertionError("inference launched %s" % got)
    ops.reset_launch_counts()
    plain = model(x)["radiance"].detach()
    torch.cuda.synchronize()
    got = _nonzero(ops.launch_counts)
    if got != {"progressive_splat": spp, **_unet_launches(3)}:
        raise AssertionError("a forward with gradients launched %s" % got)
    rel = float((fused - plain).norm() / plain.norm())
    print("18b flagship %s: inference %s launches, with gradients 0; "
          "fused against unfused output rel L2 %.3g" % (
              (bs, spp, h, w), 3 + spp, rel))
    if not rel < 2e-3:
        raise AssertionError("fused model output rel L2 %.3g" % rel)
    chain = model.embedding_01
    feats = torch.randn(1, 2, 128, 8, 8, device="cuda").to(torch.bfloat16)
    prop = torch.randn(1, 128, 8, 8, device="cuda").to(torch.bfloat16)
    ones = torch.ones(1, 2, device="cuda", dtype=torch.bfloat16)
    for what, call in (
            ("embedding with gradients on", lambda: sc.embedding_step(
                chain, feats, prop, ones, ones.sum(1))),
            ("regressor input requiring grad", lambda: sc.regress(
                model.kernel_stage.kernel_regressor,
                feats[:, 0].clone().requires_grad_(), prop, None))):
        try:
            call()
        except RuntimeError as err:
            if "no backward" not in str(err):
                raise
        else:
            raise AssertionError("the wrapper took %s" % what)


def _chain_rows(sc, chains, gen, bs, spp, h, w):
    """The flagship's chains (``chains``: step 0, a step >= 1, the
    regressor) on random inputs of one shape: (what, kernel call, plain
    call, case, bytes, FLOPs) for each embedding step and each sample's
    regressor. Bytes and FLOPs count each input and output once."""
    hw, hid = h * w, sc.HIDDEN
    masked = bs > 1  # the display strips' randomized sample counts
    rows = []
    for step, chain, cx, ce in ((0, chains[0], 93, 3),
                                (1, chains[1], 128, 128)):
        args = _chain_inputs(gen, bs, spp, h, w, cx, ce, step == 0, masked)
        rows.append((
            "embed step %d, %dx%dx%dx%d" % (step, bs, spp, h, w),
            lambda c=chain, a=args: sc.embedding_step(c, *a),
            lambda c=chain, a=args: sc.embedding_step_ref(c, *a),
            _chain_case(chain, *args[:2]),
            2 * bs * hw * (spp * cx + spp * hid + hid
                           + (0 if step == 0 else ce)),
            2 * bs * hw * (spp * (cx * hid + 2 * hid * hid)
                           + (0 if step == 0 else ce * hid))))
    chain = chains[2]
    feats, prop, _, _ = _chain_inputs(gen, bs, spp, h, w, 128, 128, False,
                                      False)
    weights = sc.regressor_weights(chain)
    for s in range(spp):
        rows.append((
            "regress s%d, %dx%dx%dx%d" % (s, bs, spp, h, w),
            lambda f=feats[:, s]: sc.regress(chain, f, prop, None, weights),
            lambda f=feats[:, s]: sc.regress_ref(chain, f, prop, None),
            _chain_case(chain, feats[:, s], prop),
            2 * bs * hw * (256 + 441),
            2 * bs * hw * (256 * hid + hid * hid + hid * 441)))
    return rows


def _chain_paths(sc, numbers):
    """18c: the flagship's chains against their plain versions at every
    shape the paths give them (CHAIN_PATH_SHAPES), then both kernels timed
    at the bench's frame shape, beside the plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    chains = (_chain_module(96, 128, 128, "relu", 0),
              _chain_module(256, 128, 128, "relu", 1),
              _chain_module(256, 441, 128, "leaky_relu", 9))
    worst = (0.0, 0.0, 0.0)
    for shape in CHAIN_PATH_SHAPES:
        rows = _chain_rows(sc, chains, gen, *shape)
        for what, fn, plain, case, _, _ in rows:
            worst = max(worst, _check_chain(what, fn(), plain()))
            _COMPARED["sample_chain"].add(case)
        torch.cuda.empty_cache()
    print("18c the flagship's chains against plain at the paths' %d shapes: "
          "worst max %.2f mean %.4f bf16 units, %.4f%% differ"
          % (len(CHAIN_PATH_SHAPES), worst[0], worst[1], 100 * worst[2]))
    # The rows of the bench's frame: both embedding steps, one regressor.
    for name, fn, plain, _, nbytes, flops in rows[:3]:
        ms = _time_ms(fn, 2, 10)
        device_ms = _graph_ms(fn, iters=3, reps=4)
        plain_ms = _time_ms(plain, 1, 3)
        by_bytes, by_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
        bound = max(by_bytes, by_ops) * 1e3
        by = "bytes" if by_bytes >= by_ops else "operations"
        _record_times(numbers, "sample_chain", name.replace(" s0", ""), ms,
                      plain_ms, bound, by, device_ms=device_ms,
                      tflops=round(flops / device_ms / 1e9, 1),
                      gbytes_s=round(nbytes / device_ms / 1e6, 1))
    del rows
    torch.cuda.empty_cache()


#: (bs, h, w) the paths give the flagship's U-Nets (bf16 SBMC inference:
#: one a step on each tile of CHAIN_PATH_SHAPES), the bench's tile last
#: (19b times the kernels there), after odd sizes no path gives.
UNET_PATH_SHAPES = ((2, 37, 53), (1, 9, 8), (1, 30, 27)) + tuple(
    sorted({(bs, h, w) for bs, _, h, w in CHAIN_PATH_SHAPES}
           - {(1, 1080, 2048)})) + ((1, 1080, 2048),)


def _unet_case(module, x):
    """A call of the channels-last U-Net: the input's shape, the first
    level's width and the levels (the kernels' shapes follow)."""
    return (("unet",) + tuple(x.shape) + (module.left_0.prediction.v.shape[0],
                                          module.num_levels))


def _unet_module(seed, dtype=torch.bfloat16):
    """The flagship's propagation U-Net on the card, random biases."""
    from sbmc_tpu_torch.nn.layers import Autoencoder
    torch.manual_seed(seed)
    ae = Autoencoder(128, 128, num_levels=3, increase_factor=2.0,
                     num_convs=3, width=128, ksize=3, output_type="leaky_relu",
                     dtype=dtype)
    with torch.no_grad():
        for name, p in ae.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.3 * torch.randn_like(p))
    return ae.cuda()


class _checked_unet_kernels:
    """While active, each launch of the U-Net's five kernels is held to
    its plain version on the same inputs: the epilogue (and its pool) and
    the layout change bit for bit, the upsample bit for bit at a scale of
    1/2 and within one bf16 unit otherwise; the epilogue's backward's dz bit
    for bit and its bias gradient within one bf16 unit at each value's own
    exponent, the upsample's backward within one bf16 unit (float32 sums in
    another order, each rounded once). Notes the launches."""

    def __enter__(self):
        from sbmc_tpu_torch.nn import unet
        self.unet, self.launched = unet, []
        self.real = (unet.epilogue, unet.upsample, unet.relayout,
                     unet.epilogue_backward, unet.upsample_backward)
        epilogue, upsample, relayout, epilogue_bwd, upsample_bwd = self.real

        def same(name, got, want):
            if not torch.equal(got, want):
                raise AssertionError("%s disagrees with its plain version at "
                                     "%s" % (name, tuple(got.shape)))

        def checked_epilogue(y, bias, act, out=None, pool=None):
            want_pool = None if pool is None else torch.empty_like(pool)
            want = unet.epilogue_ref(y.clone(), bias, act, None, want_pool)
            got = epilogue(y, bias, act, out, pool)
            same("unet_epilogue", got, want)
            if pool is not None:
                same("unet_epilogue's pool", pool, want_pool)
            self.launched.append("unet_epilogue")
            return got

        def checked_upsample(x, out):
            want = unet.upsample_ref(x, torch.empty(
                out.shape, dtype=out.dtype, device=out.device))
            got = upsample(x, out)
            if 2 * x.shape[2] == out.shape[2] and \
                    2 * x.shape[3] == out.shape[3]:
                same("unet_upsample", got, want)
            else:
                units = float(_bf16_units(got, want).max())
                _note_err("unet_upsample", units)
                if units > 1.0:
                    raise AssertionError("unet_upsample %.2f bf16 units from "
                                         "its plain version at %s"
                                         % (units, tuple(out.shape)))
            self.launched.append("unet_upsample")
            return got

        def checked_relayout(x, channels_last):
            got = relayout(x, channels_last)
            same("unet_layout", got, x)
            if got is not x:
                self.launched.append("unet_layout")
            return got

        def within_a_unit(name, got, want, units):
            err = float(units(got, want).max())
            _note_err(name, err)
            if err > 1.0:
                raise AssertionError("%s %.2f bf16 units from its plain "
                                     "version at %s" % (name, err,
                                                        tuple(got.shape)))

        def checked_epilogue_bwd(dy, out, act, dpool=None):
            want_dz, want_db = unet.epilogue_backward_ref(dy, out, act,
                                                          dpool)
            dz, db = epilogue_bwd(dy, out, act, dpool)
            same("unet_epilogue_backward", dz, want_dz)
            within_a_unit("unet_epilogue_backward", db, want_db, _own_units)
            self.launched.append("unet_epilogue_backward")
            return dz, db

        def checked_upsample_bwd(g, size):
            got = upsample_bwd(g, size)
            within_a_unit("unet_upsample_backward", got,
                          unet.upsample_backward_ref(g, size), _bf16_units)
            self.launched.append("unet_upsample_backward")
            return got

        (unet.epilogue, unet.upsample, unet.relayout, unet.epilogue_backward,
         unet.upsample_backward) = (
            checked_epilogue, checked_upsample, checked_relayout,
            checked_epilogue_bwd, checked_upsample_bwd)
        return self

    def __exit__(self, *exc):
        (self.unet.epilogue, self.unet.upsample, self.unet.relayout,
         self.unet.epilogue_backward, self.unet.upsample_backward) = self.real


def _unet_checks(ops):
    """19a: the flagship's U-Net at every path shape, each kernel launch
    against its plain version, the output against the NCHW U-Net's
    distance from the float32 one."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    worst = []
    for i, (bs, h, w) in enumerate(UNET_PATH_SHAPES):
        ae = _unet_module(i)
        x = torch.randn(bs, 128, h, w, generator=gen,
                        device="cuda").to(torch.bfloat16)
        with torch.inference_mode():
            ops.reset_launch_counts()
            with _checked_unet_kernels() as checked:
                got = ae(x)
            counts = {k: checked.launched.count(k) for k in
                      ("unet_epilogue", "unet_upsample", "unet_layout")}
            if counts != {"unet_epilogue": 15, "unet_upsample": 2,
                          "unet_layout": 2} or \
                    _nonzero(ops.launch_counts) != counts:
                raise AssertionError("U-Net at %s launched %s (counted %s)"
                                     % ((bs, h, w), checked.launched,
                                        _nonzero(ops.launch_counts)))
            with _plain_path():
                want = ae(x)
        for name in ("unet_epilogue", "unet_upsample", "unet_layout"):
            _COMPARED[name].add(_unet_case(ae, x))
        if h * w <= 512 * 512:
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            with torch.inference_mode():
                f32 = _unet_module(i, None)(x.float())
            torch.backends.cudnn.allow_tf32 = tf32
            u, un = _bf16_units(got, f32), _bf16_units(want, f32)
            worst.append(((bs, h, w), float(u.max()), float(u.mean()),
                          float(un.max()), float(un.mean())))
            if not (u.mean() <= 1.1 * un.mean() and u.max() <= 1.5 * un.max()):
                raise AssertionError(
                    "channels-last U-Net at %s: %.2f max / %.4f mean bf16 "
                    "units from float32, the NCHW one %.2f / %.4f"
                    % worst[-1])
        del ae, x, got, want
        torch.cuda.empty_cache()
    print("19a the flagship's U-Net at %d shapes: every kernel launch equal "
          "to its plain version (upsample within %.2f units), channels-last "
          "/ NCHW bf16 units from float32 (max, mean): %s" % (
              len(UNET_PATH_SHAPES), _MAX_ERR.get("unet_upsample", 0.0),
              "; ".join("%s %.2f %.4f / %.2f %.4f" % r for r in worst)))


def _unet_times(ops, numbers):
    """19b: each kernel at the bench's frame shape and its levels, and the
    whole U-Net channels-last against NCHW."""
    from sbmc_tpu_torch.nn import unet
    cl = torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(20)

    def rand(*shape, fmt=cl):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=fmt)

    def row(name, tag, fn, plain, nbytes):
        ms = _time_ms(fn, 3, 20)
        device_ms = _graph_ms(fn, iters=10, reps=3)
        _record_times(numbers, name, tag, ms, _time_ms(plain, 1, 3),
                      nbytes / H100_BYTES_PER_S * 1e3, "bytes",
                      device_ms=device_ms,
                      gbytes_s=round(nbytes / device_ms / 1e6, 1))

    levels = ((128, 1080, 2048), (256, 540, 1024), (512, 270, 512))
    for lvl, (c, h, w) in enumerate(levels):
        y, bias = rand(1, c, h, w), torch.randn(c, device="cuda")
        row("unet_epilogue", "L%d 1x%dx%dx%d" % (lvl, c, h, w),
            lambda: unet.epilogue(y, bias, "relu"),
            lambda: unet.epilogue_ref(y, bias, "relu"), 4 * y.numel())
        if lvl == 2:
            break
        c_up = 2 * c
        buf = torch.empty(1, c_up + c, h, w, dtype=torch.bfloat16,
                          device="cuda", memory_format=cl)
        pool = torch.empty(1, c, h // 2, w // 2, dtype=torch.bfloat16,
                           device="cuda", memory_format=cl)
        row("unet_epilogue", "L%d 1x%dx%dx%d + pool, into %d" % (
                lvl, c, h, w, c_up + c),
            lambda: unet.epilogue(y, bias, "relu", buf[:, c_up:], pool),
            lambda: unet.epilogue_ref(y, bias, "relu", buf[:, c_up:], pool),
            4 * y.numel() + 2 * pool.numel())
        x = rand(1, c_up, h // 2, w // 2)
        row("unet_upsample", "L%d to L%d 1x%dx%dx%d, into %d" % (
                lvl + 1, lvl, c_up, h, w, c_up + c),
            lambda: unet.upsample(x, buf[:, :c_up]),
            lambda: unet.upsample_ref(x, buf[:, :c_up]),
            2 * x.numel() + 2 * c_up * h * w)
        if lvl == 0:
            nchw = rand(1, c, h, w, fmt=torch.contiguous_format)
            for to_cl, src in ((True, nchw), (False, y)):
                row("unet_layout", "1x%dx%dx%d to %s" % (
                        c, h, w, "NHWC" if to_cl else "NCHW"),
                    lambda t=to_cl, s=src: unet.relayout(s, t),
                    lambda t=to_cl, s=src: unet.relayout_ref(s, t),
                    4 * y.numel())
            del nchw
        del buf, pool, x, y
        torch.cuda.empty_cache()
    ae = _unet_module(0)
    x = torch.randn(1, 128, 1080, 2048, generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        cl_ms = _time_ms(lambda: ae(x), 2, 5)
        with _plain_path():
            nchw_ms = _time_ms(lambda: ae(x), 2, 5)
    print("19b the flagship's U-Net at 1x128x1080x2048: channels-last %.2f "
          "ms, NCHW %.2f ms (host clock, 5 calls)" % (cl_ms, nchw_ms))
    del ae, x
    torch.cuda.empty_cache()


#: (bs, h, w) the paths give the flagship's U-Nets under gradients (bf16
#: SBMC training: batches of 4 128x128 tiles, 2 a rank in phase 16), after
#: an odd size no path gives, and the train cell's batch of 16 last (19d
#: times the kernels there).
UNET_TRAIN_SHAPES = ((2, 37, 53), (4, 128, 128), (2, 128, 128),
                     (16, 128, 128))
#: 19c: the median leaf's gradient error (against the float32 U-Net) over
#: the NCHW modules' may be at most this.
UNET_GRAD_RATIO = 2.0


def _unet_grads(ae, x, cot):
    """The input's and every parameter's gradient of ``sum(ae(x) * cot)``,
    float32."""
    x = x.detach().requires_grad_()
    params = [x] + list(ae.parameters())
    return [g.float() for g in torch.autograd.grad(
        (ae(x).float() * cot).sum(), params)]


def _unet_train_checks(ops):
    """19c: the flagship's U-Net forward and backward at every training
    shape, each kernel launch against its plain version; the gradients
    against the NCHW modules' distance from the float32 U-Net's."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for i, (bs, h, w) in enumerate(UNET_TRAIN_SHAPES):
        ae = _unet_module(i)
        x = torch.randn(bs, 128, h, w, generator=gen,
                        device="cuda").to(torch.bfloat16)
        cot = torch.randn(bs, 128, h, w, generator=gen, device="cuda")
        ops.reset_launch_counts()
        with _checked_unet_kernels() as checked:
            got = _unet_grads(ae, x, cot)
        want = _unet_train_launches(1, nsteps=1)
        counts = {k: checked.launched.count(k) for k in want}
        if counts != want or _nonzero(ops.launch_counts) != want:
            raise AssertionError("U-Net forward and backward at %s launched "
                                 "%s (counted %s)" % (
                                     (bs, h, w), counts,
                                     _nonzero(ops.launch_counts)))
        with _plain_path():
            nchw = _unet_grads(ae, x, cot)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        f32 = _unet_grads(_unet_module(i, None), x.float(), cot)
        torch.backends.cudnn.allow_tf32 = tf32

        def err(gs):
            return [float((g - r).norm() / r.norm()) for g, r in zip(gs, f32)]

        e, e_nchw = err(got), err(nchw)
        ratios = sorted(a / b for a, b in zip(e, e_nchw))
        median = ratios[len(ratios) // 2]
        rows.append(((bs, h, w), e[0], e_nchw[0], median, ratios[-1]))
        if median > UNET_GRAD_RATIO or e[0] > UNET_GRAD_RATIO * e_nchw[0]:
            raise AssertionError(
                "U-Net gradients at %s: input %.3g from float32 (NCHW "
                "%.3g), median leaf's error %.3g of the NCHW one's (largest "
                "%.3g)" % rows[-1])
        for name in ("unet_epilogue", "unet_upsample", "unet_layout",
                     "unet_epilogue_backward", "unet_upsample_backward"):
            _COMPARED[name].add(_unet_case(ae, x))
        del ae, x, cot, got, nchw, f32
        torch.cuda.empty_cache()
    print("19c the flagship's U-Net forward and backward at %d shapes: every "
          "kernel launch against its plain version (the bias gradient within "
          "%.2f units, the upsample's backward within %.2f); the input "
          "gradient's relative error from float32, channels-last / NCHW, and "
          "the leaves' error ratio (median, largest): %s" % (
              len(UNET_TRAIN_SHAPES),
              _MAX_ERR.get("unet_epilogue_backward", 0.0),
              _MAX_ERR.get("unet_upsample_backward", 0.0),
              "; ".join("%s %.3g / %.3g, %.3f %.3f" % r for r in rows)))


def _unet_train_times(ops, numbers):
    """19d: each backward kernel at the train cell's levels (batch 16,
    128x128, 64x64, 32x32), and the U-Net's forward and backward there
    three ways: the NCHW modules, the same modules on channels-last tensors
    (stock autograd, a yardstick the port never calls) and the port's
    Function."""
    import copy
    from sbmc_tpu_torch.nn import unet
    cl = torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(22)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=cl)

    def row(name, tag, fn, plain, nbytes):
        ms = _time_ms(fn, 3, 20)
        device_ms = _graph_ms(fn, iters=10, reps=3)
        _record_times(numbers, name, tag, ms, _time_ms(plain, 1, 3),
                      nbytes / H100_BYTES_PER_S * 1e3, "bytes",
                      device_ms=device_ms,
                      gbytes_s=round(nbytes / device_ms / 1e6, 1))

    bs = 16
    levels = ((128, 128, 128), (256, 64, 64), (512, 32, 32))
    with torch.no_grad():
        for lvl, (c, h, w) in enumerate(levels):
            out, dy = torch.relu(rand(bs, c, h, w)), rand(bs, c, h, w)
            n = out.numel()
            row("unet_epilogue_backward", "L%d %dx%dx%dx%d" % (
                    lvl, bs, c, h, w),
                lambda: unet.epilogue_backward(dy, out, "relu"),
                lambda: unet.epilogue_backward_ref(dy, out, "relu"), 6 * n)
            if lvl == 2:
                break
            c_cat = 3 * c
            dcat, skip = rand(bs, c_cat, h, w), rand(bs, c_cat, h, w)
            dpool = rand(bs, c, h // 2, w // 2)
            row("unet_epilogue_backward", "L%d %dx%dx%dx%d + pool, from %d" % (
                    lvl, bs, c, h, w, c_cat),
                lambda: unet.epilogue_backward(dcat[:, 2 * c:],
                                               skip[:, 2 * c:], "relu", dpool),
                lambda: unet.epilogue_backward_ref(
                    dcat[:, 2 * c:], skip[:, 2 * c:], "relu", dpool),
                6 * n + 2 * dpool.numel())
            row("unet_upsample_backward", "L%d to L%d %dx%dx%dx%d, from %d" % (
                    lvl, lvl + 1, bs, 2 * c, h, w, c_cat),
                lambda: unet.upsample_backward(dcat[:, :2 * c],
                                               (h // 2, w // 2)),
                lambda: unet.upsample_backward_ref(dcat[:, :2 * c],
                                                   (h // 2, w // 2)),
                2 * bs * 2 * c * h * w + 2 * bs * 2 * c * (h // 2) * (w // 2))
            del out, dy, dcat, skip, dpool
            torch.cuda.empty_cache()
    ae = _unet_module(0)
    stock = copy.deepcopy(ae).to(memory_format=cl)
    x = torch.randn(bs, 128, 128, 128, generator=gen,
                    device="cuda").to(torch.bfloat16).requires_grad_()
    x_cl = x.detach().contiguous(memory_format=cl).requires_grad_()
    cot = torch.randn(bs, 128, 128, 128, generator=gen,
                      device="cuda").to(torch.bfloat16)

    def step(model, inp):
        return lambda: model(inp).backward(cot)

    ops.reset_launch_counts()
    port_ms = _time_ms(step(ae, x), 2, 10)
    launched = _nonzero(ops.launch_counts)
    with _plain_path():
        nchw_ms = _time_ms(step(ae, x), 2, 10)
        stock_ms = _time_ms(step(stock, x_cl), 2, 10)
    numbers["unet_epilogue_backward"]["unet_fwd_bwd_ms"] = {
        "nchw": nchw_ms, "stock_channels_last": stock_ms, "port": port_ms}
    print("19d the flagship's U-Net forward and backward at 16x128x128x128: "
          "NCHW modules %.2f ms, stock channels-last autograd %.2f ms, the "
          "port's Function %.2f ms (host clock, 10 calls; %s launched in 12)"
          % (nchw_ms, stock_ms, port_ms, json.dumps(launched)))
    del ae, stock, x, x_cl, cot
    torch.cuda.empty_cache()


def _unet_phase(ops):
    """19: the U-Net's channels-last kernels (``csrc/unet.cu``): against
    their plain versions at the paths' shapes, and timed at the bench's.
    Returns their numbers."""
    t0 = time.perf_counter()
    numbers = {}
    _unet_checks(ops)
    with torch.inference_mode():
        _unet_times(ops, numbers)
    _unet_train_checks(ops)
    _unet_train_times(ops, numbers)
    print("phase 19: %.1f s" % (time.perf_counter() - t0))
    return numbers


#: (bs, h, w) the paths give KPCN's chains (bf16 KPCN inference, float32
#: inputs: the denoise path's 160-pixel uniform tiles, the evaluation path's
#: ragged tiles of a 256x256 frame, the KPCN bench's 1160x2000 tile, last),
#: after odd sizes no path gives.
KPCN_PATH_SHAPES = ((2, 41, 45), (1, 37, 53), (1, 64, 64), (1, 64, 160),
                    (1, 160, 64), (1, 160, 160), (1, 1160, 2000))
_KPCN_KEYS = ("kpcn_diffuse_in", "kpcn_specular_in", "kpcn_diffuse_buffer",
              "kpcn_specular_buffer", "kpcn_albedo")


def _kpcn_case(module, x):
    """A call of the channels-last KPCN: the chains' input shape and type,
    their width, the kernels' size and the depth (the kernels' shapes
    follow)."""
    return (("kpcn",) + tuple(x.shape)
            + (str(x.dtype), module.diffuse.prediction.v.shape[1],
               module.ksize, module.depth))


def _kpcn_module(seed, dtype="bfloat16"):
    """KPCN at full width on the card, random biases."""
    from sbmc_tpu_torch.models import KPCN
    torch.manual_seed(seed)
    model = KPCN(conv_dtype=dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn_like(p))
    return model.cuda()


def _own_units(got, want):
    """``|got - want|`` in bf16 units at each plain value's own exponent."""
    want = want.float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp(min=2.0 ** -126))) - 7)
    return (got.float() - want).abs() / ulp


class _checked_kpcn_kernels:
    """While active, each launch of KPCN's two layout kernels is held to its
    plain version on the same inputs: the entry bit for bit, the exit
    within one bf16 unit of each weight. Notes the launches."""

    def __enter__(self):
        from sbmc_tpu_torch.nn import kpcn_layout
        self.kl, self.launched = kpcn_layout, []
        self.real = (kpcn_layout.kpcn_entry, kpcn_layout.kpcn_exit)
        entry, exit_ = self.real

        def checked_entry(x, width, dtype=torch.bfloat16):
            got = entry(x, width, dtype)
            if not torch.equal(got, kpcn_layout.kpcn_entry_ref(x, width,
                                                               dtype)):
                raise AssertionError("kpcn_entry disagrees with its plain "
                                     "version at %s" % (tuple(x.shape),))
            self.launched.append("kpcn_entry")
            return got

        def checked_exit(y, bias, k2):
            got = exit_(y, bias, k2)
            units = float(_own_units(got, kpcn_layout.kpcn_exit_ref(
                y, bias, k2)).max())
            _note_err("kpcn_exit", units)
            if units > 1.0:
                raise AssertionError("kpcn_exit %.2f bf16 units from its "
                                     "plain version at %s"
                                     % (units, tuple(y.shape)))
            self.launched.append("kpcn_exit")
            return got

        kpcn_layout.kpcn_entry = checked_entry
        kpcn_layout.kpcn_exit = checked_exit
        return self

    def __exit__(self, *exc):
        self.kl.kpcn_entry, self.kl.kpcn_exit = self.real


def _kpcn_checks(ops):
    """20a: KPCN at full width at every path shape (float32 inputs) and at
    one odd shape in float16 and bf16, each launch of its kernels against
    its plain version, the output against the NCHW KPCN's distance from the
    float32 one."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = ([(shape, torch.float32) for shape in KPCN_PATH_SHAPES]
             + [((1, 41, 45), torch.float16), ((1, 41, 45), torch.bfloat16)])
    worst = []
    for i, ((bs, h, w), dtype) in enumerate(cases):
        model = _kpcn_module(i)
        data = {k: torch.rand(bs, 27 if k.endswith("_in") else 3, h, w,
                              generator=gen, device="cuda").to(
                                  dtype if k.endswith("_in")
                                  else torch.float32) for k in _KPCN_KEYS}
        with torch.inference_mode():
            ops.reset_launch_counts()
            with _checked_unet_kernels() as epilogues, \
                    _checked_kpcn_kernels() as ends:
                got = model(data)["radiance"]
            counts = {k: ends.launched.count(k)
                      for k in ("kpcn_entry", "kpcn_exit")}
            counts["unet_epilogue"] = epilogues.launched.count(
                "unet_epilogue")
            if counts != _kpcn_launches(1) or _nonzero(ops.launch_counts) \
                    != dict(counts, kernel_weighting=2):
                raise AssertionError("KPCN at %s launched %s (counted %s)"
                                     % ((bs, h, w), counts,
                                        _nonzero(ops.launch_counts)))
            with _plain_path():
                want = model(data)["radiance"]
        for name in ("kpcn_entry", "kpcn_exit"):
            _COMPARED[name].add(_kpcn_case(model, data["kpcn_diffuse_in"]))
        if h * w <= 512 * 512:
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            with torch.inference_mode():
                f32 = _kpcn_module(i, None)(data)["radiance"]
            torch.backends.cudnn.allow_tf32 = tf32
            err = float((got - f32).norm() / f32.norm())
            err_nchw = float((want - f32).norm() / f32.norm())
            worst.append(((bs, h, w), str(dtype)[6:], err, err_nchw))
            if not err <= 1.25 * err_nchw:
                raise AssertionError(
                    "channels-last KPCN at %s (%s inputs): %.3g relative "
                    "from float32, the NCHW one %.3g" % worst[-1])
        del model, data, got, want
        torch.cuda.empty_cache()
    print("20a KPCN at %d shapes: every entry equal to its plain version, "
          "every exit within %.2f bf16 units, every epilogue equal; "
          "channels-last / NCHW relative error from float32: %s" % (
              len(cases), _MAX_ERR.get("kpcn_exit", 0.0),
              "; ".join("%s %s %.3g / %.3g" % r for r in worst)))


def _kpcn_times(ops, numbers):
    """20b: both kernels at the KPCN bench's tile, the width table, and the
    whole KPCN channels-last against NCHW."""
    import torch.nn.functional as F
    from sbmc_tpu_torch.models import kpcn as kpcn_model
    from sbmc_tpu_torch.nn import kpcn_layout
    bf16, cl = torch.bfloat16, torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(22)

    def row(name, tag, fn, plain, nbytes):
        ms = _time_ms(fn, 3, 20)
        device_ms = _graph_ms(fn, iters=10, reps=3)
        _record_times(numbers, name, tag, ms, _time_ms(plain, 1, 3),
                      nbytes / H100_BYTES_PER_S * 1e3, "bytes",
                      device_ms=device_ms,
                      gbytes_s=round(nbytes / device_ms / 1e6, 1))

    c_in, c_out = kpcn_model.padded_width(27), kpcn_model.padded_width(441)
    for h, w in ((1160, 2000), (160, 160)):
        x = torch.rand(1, 27, h, w, generator=gen, device="cuda")
        row("kpcn_entry", "1x27x%dx%d float32 to %d channels" % (h, w, c_in),
            lambda: kpcn_layout.kpcn_entry(x, c_in),
            lambda: kpcn_layout.kpcn_entry_ref(x, c_in),
            x.numel() * 4 + h * w * c_in * 2)
        ho, wo = h - 36, w - 36
        y = (3 * torch.randn(1, c_out, ho, wo, generator=gen,
                             device="cuda")).to(bf16).contiguous(
                                 memory_format=cl)
        bias = torch.randn(441, generator=gen, device="cuda")
        row("kpcn_exit", "1x%dx%dx%d to 1x441x%dx%d" % (c_out, ho, wo, ho,
                                                        wo),
            lambda: kpcn_layout.kpcn_exit(y, bias, 441),
            lambda: kpcn_layout.kpcn_exit_ref(y, bias, 441),
            y.numel() * 2 + 441 * ho * wo * 2)
        del x, y
    torch.cuda.empty_cache()

    def conv_ms(cin, cout, h, w):
        a = torch.randn(1, cin, h, w, generator=gen, device="cuda").to(
            bf16).contiguous(memory_format=cl)
        k = (0.05 * torch.randn(cout, cin, 5, 5, generator=gen,
                                device="cuda")).to(bf16).contiguous(
                                    memory_format=cl)
        return _time_ms(lambda: F.conv2d(a, k), 2, 5)

    model = _kpcn_module(0)
    x = torch.rand(1, 27, 1160, 2000, generator=gen, device="cuda")
    rule = kpcn_model.padded_width
    for width in (104, 112, 128):
        convs = [conv_ms(32, width, 1160, 2000)] + [
            conv_ms(width, width, 1160 - 4 * d, 2000 - 4 * d)
            for d in range(1, 8)]
        preds, chains = [], []
        for pred in (448, 512):
            preds.append(conv_ms(width, pred, 1128, 1968))
            kpcn_model.padded_width = (lambda c, w=width, p=pred:
                                       {27: 32, 100: w, 441: p}[c])
            chains.append(_time_ms(lambda: model.chain_channels_last(
                model.diffuse, x), 2, 5))
        kpcn_model.padded_width = rule
        print("20b width %d: cuDNN's channels-last convs alone at the tile's "
              "shapes: layer 0 %.3f ms, layers 1-7 %s ms (sum %.3f), "
              "prediction to 448 / 512 %.3f / %.3f ms; the chain with the "
              "prediction at 448 / 512 %.3f / %.3f ms" % (
                  width, convs[0], " ".join("%.3f" % v for v in convs[1:]),
                  sum(convs[1:]), preds[0], preds[1], chains[0], chains[1]))
    data = {k: torch.rand(1, 27 if k.endswith("_in") else 3, 1160, 2000,
                          generator=gen, device="cuda") for k in _KPCN_KEYS}
    cl_ms = _time_ms(lambda: model(data), 2, 5)
    with _plain_path():
        nchw_ms = _time_ms(lambda: model(data), 2, 5)
    print("20b KPCN at 1x27x1160x2000: channels-last %.2f ms, NCHW %.2f ms "
          "(host clock, 5 calls; padded widths %s)" % (
              cl_ms, nchw_ms, [rule(c) for c in (27, 100, 441)]))
    del model, x, data
    torch.cuda.empty_cache()


def _kpcn_layout_phase(ops):
    """20: KPCN's channels-last kernels (``csrc/kpcn.cu``): against their
    plain versions at the paths' shapes, and timed at the bench's. Returns
    their numbers."""
    t0 = time.perf_counter()
    numbers = {}
    _kpcn_checks(ops)
    with torch.inference_mode():
        _kpcn_times(ops, numbers)
    print("phase 20: %.1f s" % (time.perf_counter() - t0))
    return numbers


def _sample_chain_phase(ops):
    """18: the per-sample chain kernel (``csrc/sample_chain.cu``): against
    its plain version, in the model, and timed at the bench's shapes.
    Returns its numbers."""
    from sbmc_tpu_torch.nn import sample_chain as sc
    t0 = time.perf_counter()
    numbers = {}
    with torch.inference_mode():
        _chain_checks(sc)
    _chain_model_checks(ops, sc)
    with torch.inference_mode():
        _chain_paths(sc, numbers)
    print("phase 18: %.1f s" % (time.perf_counter() - t0))
    return numbers


def _multi_rank_phase(ops, tmp, checkpoint):
    """16: several ranks. Returns the launch counts by path, every rank's
    apart."""
    by_path = {}
    t0 = time.perf_counter()
    _dp_world1(ops, tmp, by_path)
    _dp_steps(ops, tmp, by_path)
    _dp_cli(ops, tmp, by_path)
    _dp_replicas(ops, tmp, by_path, checkpoint,
                 [torch.device("cuda", 0)] * 2)
    if torch.cuda.device_count() >= 2:
        _dp_cards(ops, tmp, by_path, checkpoint)
    else:
        print("multi-card: not run (%d device)" % torch.cuda.device_count())
    print("phase 16: %.1f s" % (time.perf_counter() - t0))
    return by_path


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
    numbers.update(_sample_chain_phase(ops))
    numbers.update(_unet_phase(ops))
    numbers.update(_kpcn_layout_phase(ops))
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
        with tempfile.TemporaryDirectory() as tmp15:
            by_path.update(_pbrt_phase(ops, tmp15))
        # 16 reuses the training tiles of 8 and 8f and the frame of 7.
        by_path.update(_multi_rank_phase(ops, tmp, checkpoint))

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
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(sys.argv[2])
    else:
        main()
