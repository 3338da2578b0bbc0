"""Splat/gather operators: device dispatch between the hand-written CUDA
kernels and their plain PyTorch versions.

``kernel_weighting`` and ``scatter2gather`` are ``torch.autograd.Function``s
mirroring the ``custom_vjp``s of ``sbmc_tpu.ops``. For CUDA tensors
``kernel_weighting`` launches ``kw_fwd`` of ``csrc/kernel_weighting.cu`` (the
port of the Pallas kernel ``_kw_fwd_kernel``); its backward gives ``d_data``
as the forward kernel applied to the cotangent with the weights transposed
by ``csrc/scatter2gather.cu`` (the port of ``_s2g_kernel``), and
``d_weights`` from ``kw_dw`` (the port of ``_kw_dw_kernel``, written in the
weights' dtype), each only when its gradient is asked for. Both have two
kernels, chosen by shape (:func:`kw_route`): a tiled one for the kernel
sizes the models use, and the first port's per-pixel kernel
(``kernel_weighting_generic``, ``kernel_weighting_dw_generic``) for the
others. ``scatter2gather`` is its own adjoint: its backward is the same
kernel on the cotangent. It has two kernels too, chosen by kernel size
(:func:`s2g_route`): the vector kernel ``s2g_vec`` (work items of up to 16
bytes, :func:`s2g_pixels`) for the sizes the models use, and the first
port's per-element kernel (``scatter2gather_generic``) for the others.

``scatter2gather_max`` and ``kernel_weighting_exp`` are plain functions and
not differentiable, as in ``sbmc_tpu.ops``. For CUDA tensors they launch
``s2g_max`` of ``csrc/scatter2gather.cu`` (the port of ``_s2g_max_kernel``)
and ``kw_exp`` of ``csrc/kernel_weighting.cu`` (the port of
``_kw_exp_kernel``: ``kw_fwd``'s tiled design with the exponential formed
in registers, by :func:`kw_route` for the kernel sizes the models use, and
the first port's per-pixel kernel ``kernel_weighting_exp_generic`` for the
others); composed as ``sbmc_tpu.ops._psu_fwd``'s unfused branch they
compute the same splat step as ``progressive_splat_update``.

``progressive_splat_update`` is a ``torch.autograd.Function`` too. For CUDA
tensors its forward launches ``csrc/progressive_splat.cu`` (the port of the
Pallas kernel ``_psf_kernel``) and its backward launches the two kernels of
``csrc/progressive_splat_bwd.cu`` (the ports of ``_psb_ddata_kernel`` and
``_psb_dlogits_kernel``), each only when its gradient is asked for. The
forward and both gradients each have two kernels, chosen by shape
(:func:`splat_route`): a tiled one (TMA-fed forward, 16-byte vector
gradients) at every shape the model paths give them, and the first port's
per-pixel kernel (``progressive_splat_generic``,
``progressive_splat_ddata_generic``, ``progressive_splat_dlogits_generic``)
where TMA or 16-byte vectors cannot address the logits. For CPU tensors it
runs the plain versions (:mod:`sbmc_tpu_torch.ops.reference`). There is no
fallback: a CUDA tensor either launches a kernel or raises.

The wavefront renderer (:mod:`sbmc_tpu_torch.render`) has three kernels of
its own, with no Pallas counterpart (XLA fused their work into the JAX
renderer): ``tri_nearest`` and ``tri_any`` launch ``csrc/trace_hits.cu``
(every ray against every triangle of a scene, reduced to the nearest hit or
to whether anything blocks a shadow ray; by :func:`tri_route`, the tiled
kernels, which hold a scene's triangles in shared memory and test each pair
without a division before the exact test, or the first port's kernels
``tri_nearest_generic`` / ``tri_any_generic`` beyond their capacity) and
``random_uniform`` /
``random_bits`` launch ``csrc/threefry.cu`` (``jax.random``'s threefry2x32
draws, bit for bit). Their plain versions are ``reference.tri_nearest_ref``,
``reference.tri_any_ref`` and ``reference.threefry_uniform_ref``.

Each kernel of the splat step and of kernel weighting is built for 2 and 3
channels (:data:`KERNEL_CHANNELS`); the ops take any channel count, as the
JAX ops do, by running the kernel once a channel group
(:func:`channel_groups`: one zero channel appended to a single one, larger
counts cut into groups of 3 and 2). The terms the channels share (the
splat's ``sum_w`` and ``max_w``, kernel weighting's ``sum_w``) come from the
first group, and the gradients that sum over channels (``d_klogits``,
``d_weights``) add the groups' float32 parts and round once to the logits'
or weights' dtype (:func:`splat_by_channels` and its siblings).

The backward mirrors ``sbmc_tpu.ops._psu_bwd``: the running max is a
constant (its contributions cancel in ``sum_r / sum_w``), so ``max_w`` gets
a zero gradient and the new max is not differentiable.
"""

import functools
import math

import numpy as np
import torch

from sbmc_tpu_torch.ops import reference
from sbmc_tpu_torch.ops.reference import (kernel_weighting_dw_ref,
                                          kernel_weighting_exp_ref,
                                          kernel_weighting_ref,
                                          progressive_splat_bwd_ref,
                                          progressive_splat_update_ref,
                                          scatter2gather_max_ref,
                                          scatter2gather_ref,
                                          threefry_uniform_ref, tri_any_ref,
                                          tri_nearest_ref)

__all__ = [
    "kernel_weighting",
    "scatter2gather",
    "scatter2gather_max",
    "kernel_weighting_exp",
    "kernel_weighting_ref",
    "kernel_weighting_dw_ref",
    "scatter2gather_ref",
    "scatter2gather_max_ref",
    "kernel_weighting_exp_ref",
    "progressive_splat_update",
    "progressive_splat_update_ref",
    "progressive_splat_bwd_ref",
    "splat_route",
    "splat_tile_rows",
    "kw_route",
    "kw_pixels",
    "kw_groups",
    "kw_exp_groups",
    "kw_dw_groups",
    "dlogits_row_blocks",
    "ddata_groups",
    "s2g_route",
    "s2g_pixels",
    "KERNEL_CHANNELS",
    "channel_groups",
    "splat_by_channels",
    "ddata_by_channels",
    "dlogits_by_channels",
    "kw_by_channels",
    "kw_dw_by_channels",
    "random_uniform",
    "random_bits",
    "tri_nearest",
    "tri_any",
    "tri_route",
    "TRI_TILED_MAX",
    "threefry_uniform_ref",
    "tri_nearest_ref",
    "tri_any_ref",
    "launch_counts",
    "reset_launch_counts",
    "reference",
]

#: Kernel launches since the last reset, by kernel name. Each wrapper adds
#: one where it launches its kernel, and nowhere else.
launch_counts = {"progressive_splat": 0, "progressive_splat_generic": 0,
                 "progressive_splat_ddata": 0,
                 "progressive_splat_ddata_generic": 0,
                 "progressive_splat_dlogits": 0,
                 "progressive_splat_dlogits_generic": 0, "kernel_weighting": 0,
                 "kernel_weighting_generic": 0, "kernel_weighting_dw": 0,
                 "kernel_weighting_dw_generic": 0, "scatter2gather": 0,
                 "scatter2gather_generic": 0, "scatter2gather_max": 0,
                 "kernel_weighting_exp": 0, "kernel_weighting_exp_generic": 0,
                 "tri_nearest": 0, "tri_nearest_generic": 0, "tri_any": 0,
                 "tri_any_generic": 0, "threefry_uniform": 0,
                 "sample_chain": 0, "unet_epilogue": 0, "unet_upsample": 0,
                 "unet_layout": 0, "unet_epilogue_backward": 0,
                 "unet_upsample_backward": 0, "kpcn_entry": 0, "kpcn_exit": 0,
                 "chain_entry": 0, "chain_epilogue": 0,
                 "chain_epilogue_backward": 0, "chain_logits": 0,
                 "chain_logits_backward": 0}

#: Channel counts one launch of the splat and kernel-weighting kernels
#: takes (their template set); the ops run other counts in groups of these
#: (:func:`channel_groups`).
KERNEL_CHANNELS = (2, 3)
#: Kernel sizes the tiled splat and kernel-weighting kernels are built for:
#: the models' 21, and 3 and 5 for the tests.
TILED_KSIZES = (3, 5, 21)
#: Triangles the tiled hit kernels hold in shared memory (64 bytes each):
#: the scene's power-of-two buckets up to 2048.
TRI_TILED_MAX = 2048


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def kernel_weighting(data, weights):
    """Locally-weighted sum of ``data`` with per-pixel kernels
    (differentiable in both arguments).

    Args:
      data: ``[bs, c, h, w]`` float32 values.
      weights: ``[bs, k2, h, w]`` kernels, float32 or bfloat16; tap ``i``
        unflattens to ``(dy, dx) = divmod(i, k)`` and ``output[n, c, y, x] =
        sum_i weights[n, i, y, x] * data[n, c, y + dy - o, x + dx - o]``
        with zero outside the image.

    Returns:
      ``(output [bs, c, h, w], sum_w [bs, h, w])`` in float32; ``sum_w``
      sums every tap. The gradient to bfloat16 weights is computed in
      float32 and rounded once to bfloat16.
    """
    return _KernelWeighting.apply(data, weights)


def scatter2gather(weights):
    """Transpose splat kernels into gather kernels, and back
    (differentiable; self-adjoint).

    The weight at ``(y, x)`` for offset ``(dy, dx)`` moves to
    ``(y + dy - o, x + dx - o)`` at the flipped tap ``(k-1-dy, k-1-dx)``;
    what would come from outside the image is 0.

    Args:
      weights: ``[bs, k2, h, w]``, float32 or bfloat16.

    Returns:
      ``[bs, k2, h, w]`` transposed kernels of the same dtype.
    """
    return _Scatter2Gather.apply(weights)


def scatter2gather_max(weights):
    """``scatter2gather`` and the per-pixel max over the transposed taps,
    in one pass (not differentiable: the outputs carry no gradient).

    Args:
      weights: ``[bs, k2, h, w]``, float32 or bfloat16.

    Returns:
      ``(gather, kmax)``: the gather kernels ``[bs, k2, h, w]`` in the
      input's dtype and their tap max ``[bs, h, w]`` in float32, which
      counts the zeros of the taps that fall outside the image.
    """
    with torch.no_grad():
        return (scatter2gather_max_ref if _on_cpu(weights)
                else _scatter2gather_max_cuda)(weights)


def kernel_weighting_exp(data, logits, maxes):
    """Kernel weighting of ``exp(logits - maxes)``, the exponential formed
    inside the kernel (not differentiable: the outputs carry no gradient).

    Args:
      data: ``[bs, c, h, w]`` float32 values.
      logits: ``[bs, k2, h, w]`` gather-kernel logits, float32 or bfloat16
        (widened to float32 before the subtraction).
      maxes: ``[bs, h, w]`` float32 per-pixel shift.

    Returns:
      ``(output [bs, c, h, w], sum_w [bs, h, w])`` in float32; ``sum_w``
      sums every tap.
    """
    with torch.no_grad():
        if _on_cpu(data, logits, maxes):
            return kernel_weighting_exp_ref(data, logits, maxes)
        return kw_by_channels(_kernel_weighting_exp_cuda, data, logits,
                              maxes)


def progressive_splat_update(data, klogits, sum_r, sum_w, max_w):
    """One fused progressive online-softmax splat step (differentiable).

    Args:
      data: ``[bs, c, h, w]`` float32 sample radiance.
      klogits: ``[bs, k2, h, w]`` raw splat-kernel logits, float32 or
        bfloat16.
      sum_r, sum_w, max_w: float32 running state (``[bs, c, h, w]``,
        ``[bs, 1, h, w]``, ``[bs, 1, h, w]``).

    Returns:
      ``(sum_r', sum_w', max_w')``, new float32 tensors. ``max_w'`` carries
      no gradient.
    """
    return _ProgressiveSplat.apply(data, klogits, sum_r, sum_w, max_w)


def random_uniform(keys, n, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), minval=minval, maxval=maxval)`` for
    each key, bit for bit (partitionable threefry2x32).

    Args:
      keys: ``[b, 2]`` int32 tensor holding the uint32 words of ``b`` keys
        (``sbmc_tpu_torch.render.prng``), on the device to draw on.
      n: values per key.

    Returns:
      ``[b, n]`` float32 in ``[minval, maxval)``.
    """
    with torch.no_grad():
        if _on_cpu(keys):
            return threefry_uniform_ref(keys, n, minval, maxval)
        return _threefry_cuda(keys, n, minval, maxval, False)


def random_bits(keys, n):
    """The 32 random bits behind :func:`random_uniform`: ``[b, n]`` int32
    holding uint32 words."""
    with torch.no_grad():
        if _on_cpu(keys):
            return threefry_uniform_ref(keys, n, raw=True)
        return _threefry_cuda(keys, n, 0.0, 1.0, True)


def tri_nearest(org, dirs, time, tris):
    """Nearest triangle hit of each ray (the triangle half of the JAX
    renderer's ``_intersect``).

    Args:
      org, dirs: ``[n, 3]`` float32 ray origins and directions.
      time: ``[n]`` float32 shutter time of each ray (moves the triangles
        by their motion).
      tris: ``[t, 16]`` float32 packed triangle constants
        (``csrc/trace_hits.cuh``).

    Returns:
      ``(t [n] float32, idx [n] int32, back [n] bool)``: the distance
      (``reference.TRI_MISS`` when no triangle is hit), the first triangle
      at that distance, and whether the hit is on its back face.
    """
    with torch.no_grad():
        if _on_cpu(org, dirs, time, tris):
            return tri_nearest_ref(org, dirs, time, tris)
        return _tri_nearest_cuda(org, dirs, time, tris)


def tri_any(org, dirs, dist, tris):
    """Whether a triangle lies closer than ``dist - 1e-3`` along each ray,
    the triangles at time 0 (the triangle half of the JAX renderer's
    ``_occluded``): ``[n]`` bool."""
    with torch.no_grad():
        if _on_cpu(org, dirs, dist, tris):
            return tri_any_ref(org, dirs, dist, tris)
        return _tri_any_cuda(org, dirs, dist, tris)


def _device_of(*tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: %s"
                         % sorted(map(str, devices)))
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def _on_cpu(*tensors):
    return _device_of(*tensors).type == "cpu"


def _kw_fwd(data, weights):
    if _on_cpu(data, weights):
        return kernel_weighting_ref(data, weights)
    return kw_by_channels(_kernel_weighting_cuda, data, weights)


def _s2g(weights):
    return (scatter2gather_ref if _on_cpu(weights)
            else _scatter2gather_cuda)(weights)


class _KernelWeighting(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, weights):
        ctx.save_for_backward(data, weights)
        return _kw_fwd(data, weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_output, d_sum_w):
        data, weights = ctx.saved_tensors
        need_data, need_weights = ctx.needs_input_grad
        # Cotangents may arrive strided or as expanded zeros.
        d_output = d_output.contiguous()
        d_sum_w = d_sum_w.contiguous()
        d_data = d_weights = None
        if need_data:
            # The forward applied to the cotangent with the kernels
            # transposed to the other form.
            d_data = _kw_fwd(d_output, _s2g(weights))[0]
        if need_weights:
            k = reference.ksize_of(weights)
            if _on_cpu(data, d_output, d_sum_w):
                d_weights = kernel_weighting_dw_ref(
                    data, d_output, d_sum_w, k).to(weights.dtype)
            else:
                d_weights = kw_dw_by_channels(
                    _kernel_weighting_dw_cuda, data, d_output, d_sum_w, k,
                    weights.dtype)
        return d_data, d_weights


class _Scatter2Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, weights):
        return _s2g(weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out):
        return _s2g(d_out.contiguous())


class _ProgressiveSplat(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, klogits, sum_r, sum_w, max_w):
        args = (data, klogits, sum_r, sum_w, max_w)
        if _device_of(*args).type == "cpu":
            out = progressive_splat_update_ref(*args)
        else:
            out = splat_by_channels(_progressive_splat_cuda, *args)
        # max_w is the previous step's new max, which that step saved too.
        ctx.save_for_backward(data, klogits, max_w, out[2])
        ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_r, d_w, _d_max):
        data, klogits, max_w, new_max = ctx.saved_tensors
        need_data, need_logits, need_r, need_w, need_max = \
            ctx.needs_input_grad
        d_data = d_logits = d_sum_r = d_sum_w = d_max_w = None
        if need_r or need_w:
            scaler = torch.exp(max_w - new_max)
            d_sum_r = d_r * scaler if need_r else None
            d_sum_w = d_w * scaler if need_w else None
        if need_max:
            d_max_w = torch.zeros_like(max_w)
        if need_data or need_logits:
            # Cotangents may arrive strided or as expanded zeros.
            d_r = d_r.contiguous()
            d_w = d_w.contiguous()
            cpu = _device_of(data, klogits, new_max, d_r, d_w).type == "cpu"
            if need_data:
                d_data = (reference.progressive_splat_ddata_ref(
                    klogits, new_max, d_r) if cpu else ddata_by_channels(
                        _ddata_cuda, klogits, new_max, d_r))
            if need_logits:
                d_logits = (reference.progressive_splat_dlogits_ref(
                    data, klogits, new_max, d_r, d_w) if cpu
                    else dlogits_by_channels(_dlogits_cuda, data, klogits,
                                             new_max, d_r, d_w))
        return d_data, d_logits, d_sum_r, d_sum_w, d_max_w


def channel_groups(c):
    """The channel groups ``[(start, stop), ...]`` in which the ops run ``c``
    channels through kernels built for :data:`KERNEL_CHANNELS`: one group
    for 2 or 3; one group padded with zero channels to 2 for 0 or 1 (a zero
    data channel adds nothing to any output or gradient); groups of 3 and a
    last one or two of 2 for more (4 = 2 + 2, 5 = 3 + 2, 7 = 3 + 2 + 2),
    never of 1."""
    if c <= 3:
        return [(0, c)]
    threes = c // 3 - (1 if c % 3 == 1 else 0)
    sizes = [3] * threes + [2] * ((c - 3 * threes) // 2)
    stops = np.cumsum(sizes).tolist()
    return list(zip([0] + stops[:-1], stops))


def _planes(t, start, stop):
    """Channels ``[start, stop)`` of ``t`` as a contiguous tensor of at least
    2 channels (zero channels appended)."""
    part = t[:, start:stop]
    if stop - start < 2:
        pad = part.new_zeros((t.shape[0], 2 - (stop - start)) + t.shape[2:])
        part = torch.cat([part, pad], 1)
    return part.contiguous()


def _grouped(t):
    """The channel groups of ``t``, or None when one kernel launch takes
    it as it is."""
    if t.dim() != 4 or t.shape[1] in KERNEL_CHANNELS:
        return None
    return channel_groups(t.shape[1])


def splat_by_channels(step, data, klogits, sum_r, sum_w, max_w):
    """One splat step over any channel count: ``step`` (the kernel's
    wrapper, or anything with its arguments and results) once a channel
    group of ``data`` and ``sum_r``; ``sum_w`` and ``max_w``, which the
    channels share, from the first group."""
    groups = _grouped(data)
    if groups is None:
        return step(data, klogits, sum_r, sum_w, max_w)
    parts = []
    for a, b in groups:
        out_r, out_w, out_m = step(_planes(data, a, b), klogits,
                                   _planes(sum_r, a, b), sum_w, max_w)
        parts.append(out_r[:, :b - a])
        if len(parts) == 1:
            shared = out_w, out_m
    return (torch.cat(parts, 1),) + shared


def ddata_by_channels(fn, klogits, new_max, d_r):
    """The splat step's ``d_data`` over any channel count: ``fn`` (the
    kernel's wrapper) once a channel group of ``d_r``; each channel's
    gradient is its own."""
    groups = _grouped(d_r)
    if groups is None:
        return fn(klogits, new_max, d_r)
    return torch.cat([fn(klogits, new_max, _planes(d_r, a, b))[:, :b - a]
                      for a, b in groups], 1)


def dlogits_by_channels(fn, data, klogits, new_max, d_r, d_w):
    """The splat step's ``d_klogits`` over any channel count: ``fn`` (the
    kernel's wrapper) once a channel group of ``data`` and ``d_r``, the
    shared ``d_w`` given to the first group only (zero to the others). With
    several groups, each runs on the logits widened to float32 (exact) and
    returns float32; the parts are summed in float32 and rounded once to the
    logits' dtype, as one launch over every channel rounds."""
    groups = _grouped(data)
    if groups is None:
        return fn(data, klogits, new_max, d_r, d_w)
    if len(groups) == 1:
        (a, b), = groups
        return fn(_planes(data, a, b), klogits, new_max, _planes(d_r, a, b),
                  d_w)
    wide, total = klogits.float(), None
    for i, (a, b) in enumerate(groups):
        part = fn(_planes(data, a, b), wide, new_max, _planes(d_r, a, b),
                  d_w if i == 0 else torch.zeros_like(d_w))
        total = part if total is None else total.add_(part)
    return total.to(klogits.dtype)


def kw_by_channels(fn, data, *rest):
    """Kernel weighting (or of ``exp(logits - maxes)``) over any channel
    count: ``fn`` (the kernel's wrapper: ``fn(data, *rest) -> (output,
    sum_w)``) once a channel group of ``data``; ``sum_w``, which the channels
    share, from the first group."""
    groups = _grouped(data)
    if groups is None:
        return fn(data, *rest)
    parts = []
    for a, b in groups:
        out, sw = fn(_planes(data, a, b), *rest)
        parts.append(out[:, :b - a])
        if len(parts) == 1:
            sum_w = sw
    return torch.cat(parts, 1), sum_w


def kw_dw_by_channels(fn, data, d_output, d_sum_w, k, dtype):
    """Kernel weighting's ``d_weights`` in ``dtype`` over any channel count:
    ``fn`` (the kernel's wrapper, with ``_kernel_weighting_dw_cuda``'s
    arguments) once a channel group of ``data`` and ``d_output``, the shared
    ``d_sum_w`` given to the first group only (zero to the others). With
    several groups each part comes back in float32; they are summed in
    float32 and rounded once to ``dtype``."""
    groups = _grouped(data)
    if groups is None:
        return fn(data, d_output, d_sum_w, k, dtype)
    if len(groups) == 1:
        (a, b), = groups
        return fn(_planes(data, a, b), _planes(d_output, a, b), d_sum_w, k,
                  dtype)
    total = None
    for i, (a, b) in enumerate(groups):
        part = fn(_planes(data, a, b), _planes(d_output, a, b),
                  d_sum_w if i == 0 else torch.zeros_like(d_sum_w), k,
                  torch.float32)
        total = part if total is None else total.add_(part)
    return total.to(dtype)


def tri_route(t):
    """Which kernels ``tri_nearest`` and ``tri_any`` launch on the card for
    ``t`` triangles.

    ``"tiled"``: up to :data:`TRI_TILED_MAX`, the kernels that stage all of
    a scene's triangles in shared memory once and run four rays a thread
    (``tri_nearest``, ``tri_any``): every bucket the renderer's scenes give
    them (1024 at most with the repo's meshes).

    ``"generic"``: more triangles, the first port's kernels
    (``tri_nearest_generic``, ``tri_any_generic``), which stage them in
    chunks. This is a dispatch by shape, not a fallback: either launch
    raises if it fails.
    """
    return "tiled" if t <= TRI_TILED_MAX else "generic"


def splat_route(w, k, itemsize, aligned=True):
    """Which kernels the splat step's forward and logits gradient launch on
    the card for logits ``[bs, k*k, h, w]`` of ``itemsize`` bytes.

    ``"tiled"``: the TMA-fed forward (``progressive_splat``) and the 16-byte
    vector gradients (``progressive_splat_ddata``,
    ``progressive_splat_dlogits``). They need ``k`` in
    :data:`TILED_KSIZES`, a logits row of ``w * itemsize`` bytes that is a
    multiple of 16 (TMA's row stride; whole 16-byte vectors per row) and
    16-byte aligned logits and outputs (``aligned``). Every shape the model
    paths give the step has them (widths 2048, 512, 160, 128, 64, 48).

    ``"generic"``: otherwise (odd widths, other kernel sizes), the per-pixel
    kernels ``progressive_splat_generic``,
    ``progressive_splat_ddata_generic`` and
    ``progressive_splat_dlogits_generic``. This is a dispatch by shape, not
    a fallback: any launch raises if it fails.
    """
    if k in TILED_KSIZES and (w * itemsize) % 16 == 0 and aligned:
        return "tiled"
    return "generic"


def splat_tile_rows(bs, h, w, sms):
    """Tile height of the tiled forward, 8 or 16 rows of 32 pixels: 8 where
    its blocks take fewer than twice the waves of 16-row blocks on ``sms``
    SMs at two blocks each (a 16-row block takes about twice as long)."""
    slots = 2 * sms

    def waves(th):
        return -(-bs * -(-h // th) * -(-w // 32) // slots)
    return 8 if waves(8) < 2 * waves(16) else 16


def dlogits_row_blocks(bs, h, w, k, sms):
    """Blocks that share each 8x64 tile's tap rows in the vector logits
    gradient: 1, or enough to give three blocks per SM (``sms``), at most
    ``k``."""
    tiles = bs * -(-h // 8) * -(-w // 64)
    return min(k, max(1, -(-3 * sms // tiles)))


def _ddata_tiles(bs, h, w, itemsize, groups):
    """Tiles of the vector d_data kernel: 64 pixels wide, and as tall as
    its ``256 / groups`` items of 16 bytes make them."""
    rows = 64 // (itemsize * groups)
    return bs * -(-h // rows) * -(-w // 64)


def ddata_groups(bs, h, w, k, itemsize, sms):
    """Groups of tap rows in a block of the vector d_data kernel, whose tile
    is ``64 / (groups * itemsize)`` rows of 64 pixels: the fewest of 1, 2, 4
    and 8, at most ``k``, whose grid has at least 1.5 tiles per SM
    (``sms``); else the most. On the card that was the fastest count, or
    within 2% of it, at the training batch, at 512x512, at 160x160 and at
    1080x2048; chip_smoke.py times every count beside this one (PERF.md)."""
    allowed = _allowed_groups(k)
    for g in allowed:
        if 2 * _ddata_tiles(bs, h, w, itemsize, g) >= 3 * sms:
            return g
    return allowed[-1]


def s2g_route(k):
    """Which kernel scatter2gather launches on the card for ``k x k``
    kernels.

    ``"tiled"``: the vector kernel ``s2g_vec`` (``scatter2gather``), built
    for ``k`` in :data:`TILED_KSIZES` and any width and base
    (:func:`s2g_pixels`): every shape the model paths give it.

    ``"generic"``: other kernel sizes, the per-element kernel
    ``scatter2gather_generic``. This is a dispatch by shape, not a
    fallback: either launch raises if it fails.
    """
    return "tiled" if k in TILED_KSIZES else "generic"


def s2g_pixels(w, itemsize, *offsets):
    """Elements per work item of the vector scatter2gather: the widest ``v``
    of ``16 / itemsize``, ..., 2, 1 that divides the width ``w`` and every
    base in ``offsets`` (in elements: the input's and the output's), so that
    each item is one aligned access of 16, 8, 4 or 2 bytes on either side."""
    return kw_pixels(w, 16 // itemsize, math.gcd(*offsets))


def kw_route(k):
    """Which kernels kernel weighting and its weight gradient launch on the
    card for ``k x k`` kernels.

    ``"tiled"``: ``kw_fwd``, ``kw_dw`` and ``kw_exp``
    (``kernel_weighting``, ``kernel_weighting_dw``,
    ``kernel_weighting_exp``), built for ``k`` in :data:`TILED_KSIZES` and
    any width and base alignment: every shape the model paths and the
    composed splat step give them.

    ``"generic"``: other kernel sizes, the per-pixel kernels
    ``kernel_weighting_generic``, ``kernel_weighting_dw_generic`` and
    ``kernel_weighting_exp_generic``. This is a dispatch by shape, not a
    fallback: either launch raises if it fails.
    """
    return "tiled" if k in TILED_KSIZES else "generic"


def kw_pixels(w, widest, offset=0):
    """Pixels per work item of the tiled kernels: the widest ``v`` of
    ``widest``, ..., 2, 1 that divides the width ``w`` and the tap planes'
    base address in elements (``offset``), so that each tap is one access
    of ``v`` elements. The forward takes at most 2 (8-byte float32 or
    4-byte bfloat16 loads), the weight gradient at most 4 (16- or 8-byte
    stores)."""
    v = widest
    while v > 1 and (w % v or offset % v):
        v //= 2
    return v


def _allowed_groups(k):
    return [g for g in (1, 2, 4, 8) if g <= k]


def kw_groups(bs, h, w, k, v, itemsize, sms):
    """Groups of tap rows in a block of the tiled forward (its tile is 8 /
    groups rows of 32 work items of ``v`` pixels): the fewest of 1, 2, 4 and
    8, at most ``k``, whose grid has at least ``4 / itemsize`` blocks per SM
    (``sms``), so that as many weight bytes are in flight whatever their
    type; else the most. chip_smoke.py times every count beside this one
    (PERF.md)."""
    allowed = _allowed_groups(k)
    for g in allowed:
        if bs * -(-h // (8 // g)) * -(-w // (32 * v)) * itemsize >= 4 * sms:
            return g
    return allowed[-1]


def kw_exp_groups(bs, h, w, k, v, sms):
    """Groups of tap rows in a block of the tiled exp forward: the rule of
    :func:`kw_groups` with the logits counted as float32 whatever their
    type, i.e. the fewest groups whose grid has a block per SM. Every
    tap's exp2 keeps a bfloat16 block as busy per byte loaded as a float32
    block, so bfloat16 logits need no more blocks in flight than float32
    ones; chip_smoke.py times every count beside this one (PERF.md)."""
    return kw_groups(bs, h, w, k, v, 4, sms)


def kw_dw_groups(k):
    """Groups of tap rows in a block of the tiled weight gradient: 8
    (one-row tiles), at most ``k``. The gradient has no reduction over taps
    to pay for more groups; chip_smoke.py times every count beside this one
    (PERF.md)."""
    return _allowed_groups(k)[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _route(klogits, *outputs):
    w, k = klogits.shape[-1], reference.ksize_of(klogits)
    aligned = all(t.data_ptr() % 16 == 0 for t in (klogits,) + outputs)
    return splat_route(w, k, klogits.element_size(), aligned)


def _check(data, klogits, sum_r, sum_w, max_w):
    if data.dim() != 4 or klogits.dim() != 4:
        raise ValueError("data and klogits must be [bs, c, h, w] and "
                         "[bs, k2, h, w]")
    bs, c, h, w = data.shape
    k = reference.ksize_of(klogits)
    if klogits.shape != (bs, k * k, h, w):
        raise ValueError(f"klogits {tuple(klogits.shape)} does not match "
                         f"data {tuple(data.shape)}")
    for name, t, ch in (("sum_r", sum_r, c), ("sum_w", sum_w, 1),
                        ("max_w", max_w, 1)):
        if t.shape != (bs, ch, h, w):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(bs, ch, h, w)}")
    for name, t in (("data", data), ("sum_r", sum_r), ("sum_w", sum_w),
                    ("max_w", max_w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if klogits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"klogits must be float32 or bfloat16, got "
                        f"{klogits.dtype}")
    for name, t in (("data", data), ("klogits", klogits), ("sum_r", sum_r),
                    ("sum_w", sum_w), ("max_w", max_w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if c not in KERNEL_CHANNELS:
        raise ValueError(f"one launch of the splat kernels takes "
                         f"{KERNEL_CHANNELS} channels, got {c}: "
                         "ops.progressive_splat_update runs any count in "
                         "groups (channel_groups)")
    if bs > 65535:
        raise ValueError(f"batch {bs} exceeds the kernel's grid limit 65535")
    return bs, c, h, w, k


def _launch(name, fn, device, *args):
    """Call a kernel's C entry point on the current stream of ``device``,
    raise on a refused launch, and count the launch. The stream's handle is
    read raw, and the device made current only when it is not: a train
    step makes hundreds of launches, and the host sets its pace."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _load():
    """The kernels' CUDA build (built on first use), as every kernel binding
    reaches it."""
    from sbmc_tpu_torch.ops import _build
    return _build.load_cuda()


def _no_grad(what, *tensors):
    """Raise if one of ``tensors`` requires grad: ``what`` (a kernel
    binding, named in the message) has no backward."""
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"no backward for {what}: the inputs and weights must not "
            "require grad (run under torch.no_grad() or "
            "torch.inference_mode(), or use the plain versions)")


def _progressive_splat_cuda(data, klogits, sum_r, sum_w, max_w, route=None,
                            tile_h=None):
    """One splat step on the card: the kernel of ``route`` (by default
    :func:`splat_route`'s), the tiled one at ``tile_h`` rows (by default
    :func:`splat_tile_rows`'s)."""
    bs, c, h, w, k = _check(data, klogits, sum_r, sum_w, max_w)
    lib = _load()
    out_r = torch.empty_like(sum_r)
    out_w = torch.empty_like(sum_w)
    out_m = torch.empty_like(max_w)
    args = (data.data_ptr(), klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), sum_r.data_ptr(),
            sum_w.data_ptr(), max_w.data_ptr(), out_r.data_ptr(),
            out_w.data_ptr(), out_m.data_ptr(), bs, c, h, w, k)
    if (route or _route(klogits)) == "tiled":
        if tile_h is None:
            tile_h = splat_tile_rows(bs, h, w, _sm_count(data.device))
        _launch("progressive_splat", lib.sbmc_progressive_splat, data.device,
                *args, tile_h)
    else:
        _launch("progressive_splat_generic",
                lib.sbmc_progressive_splat_generic, data.device, *args)
    return out_r, out_w, out_m


def _ddata_cuda(klogits, new_max, d_r, route=None, groups=None):
    """``d_data`` of one splat step on the card: the kernel of ``route`` (by
    default :func:`splat_route`'s), the vector one with ``groups`` groups of
    tap rows in a block (by default :func:`ddata_groups`'). The other
    arguments are those of ``reference.progressive_splat_ddata_ref``."""
    # d_r has data's shape and type; d_w's slot checks the other plane.
    bs, c, h, w, k = _check(d_r, klogits, d_r, new_max, new_max)
    lib = _load()
    d_data = torch.empty_like(d_r)
    args = (klogits.data_ptr(), int(klogits.dtype == torch.bfloat16),
            new_max.data_ptr(), d_r.data_ptr(), d_data.data_ptr(), bs, c, h,
            w, k)
    if (route or _route(klogits, d_data)) == "tiled":
        if groups is None:
            groups = ddata_groups(bs, h, w, k, klogits.element_size(),
                                  _sm_count(klogits.device))
        _launch("progressive_splat_ddata", lib.sbmc_progressive_splat_ddata,
                klogits.device, *args, groups)
    else:
        _launch("progressive_splat_ddata_generic",
                lib.sbmc_progressive_splat_ddata_generic, klogits.device,
                *args)
    return d_data


def _dlogits_cuda(data, klogits, new_max, d_r, d_w, route=None):
    """``d_klogits`` of one splat step on the card, in the logits' dtype:
    the kernel of ``route`` (by default :func:`splat_route`'s), the vector
    one with :func:`dlogits_row_blocks`'s blocks per tile. The other
    arguments are those of ``reference.progressive_splat_dlogits_ref``."""
    bs, c, h, w, k = _check(data, klogits, d_r, d_w, new_max)
    lib = _load()
    d_logits = torch.empty_like(klogits)
    args = (data.data_ptr(), klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), new_max.data_ptr(),
            d_r.data_ptr(), d_w.data_ptr(), d_logits.data_ptr(), bs, c, h, w,
            k)
    if (route or _route(klogits, d_logits)) == "tiled":
        _launch("progressive_splat_dlogits",
                lib.sbmc_progressive_splat_dlogits, klogits.device, *args,
                dlogits_row_blocks(bs, h, w, k, _sm_count(klogits.device)))
    else:
        _launch("progressive_splat_dlogits_generic",
                lib.sbmc_progressive_splat_dlogits_generic, klogits.device,
                *args)
    return d_logits


def _check_planes(name, t, dtypes):
    if t.dtype not in dtypes:
        raise TypeError("%s must be %s, got %s" % (
            name, " or ".join(str(d).replace("torch.", "") for d in dtypes),
            t.dtype))
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_weights(weights):
    """Checks a ``[bs, k2, h, w]`` tap tensor; returns ``(bs, h, w, k)``."""
    if weights.dim() != 4:
        raise ValueError("weights must be [bs, k2, h, w], got "
                         f"{tuple(weights.shape)}")
    k = reference.ksize_of(weights)
    _check_planes("weights", weights, (torch.float32, torch.bfloat16))
    bs, _, h, w = weights.shape
    if bs > 65535:
        raise ValueError(f"batch {bs} exceeds the kernel's grid limit 65535")
    return bs, h, w, k


def _check_data(name, t, like=None):
    """Checks a float32 ``[bs, c, h, w]`` tensor of
    :data:`KERNEL_CHANNELS` channels, as one kernel launch takes it (the ops
    group other counts: :func:`channel_groups`); its batch and image sizes
    (and channels, for a 4-tuple) against ``like``."""
    if t.dim() != 4:
        raise ValueError(f"{name} must be [bs, c, h, w], got "
                         f"{tuple(t.shape)}")
    if like is not None:
        want = tuple(like) if len(like) == 4 else \
            (like[0], t.shape[1]) + tuple(like[1:])
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
    _check_planes(name, t, (torch.float32,))
    if t.shape[1] not in KERNEL_CHANNELS:
        raise ValueError(f"one launch of the kernel-weighting kernels takes "
                         f"{KERNEL_CHANNELS} channels, got {t.shape[1]}: "
                         "the ops run any count in groups (channel_groups)")


def _kernel_weighting_cuda(data, weights, route=None, groups=None):
    """Kernel weighting on the card: the kernel of ``route`` (by default
    :func:`kw_route`'s), the tiled one with ``groups`` groups of tap rows
    (by default :func:`kw_groups`') and :func:`kw_pixels`' work items. The
    arguments and results are those of ``reference.kernel_weighting_ref``."""
    _device_of(data, weights)
    bs, h, w, k = _check_weights(weights)
    _check_data("data", data, (bs, h, w))
    c = data.shape[1]
    lib = _load()
    out = torch.empty_like(data)
    sum_w = torch.empty((bs, h, w), dtype=torch.float32, device=data.device)
    args = (data.data_ptr(), weights.data_ptr(),
            int(weights.dtype == torch.bfloat16), out.data_ptr(),
            sum_w.data_ptr(), bs, c, h, w, k)
    if (route or kw_route(k)) == "tiled":
        v = kw_pixels(w, 2, weights.data_ptr() // weights.element_size())
        if groups is None:
            groups = kw_groups(bs, h, w, k, v, weights.element_size(),
                               _sm_count(data.device))
        _launch("kernel_weighting", lib.sbmc_kernel_weighting, data.device,
                *args, v, groups)
    else:
        _launch("kernel_weighting_generic", lib.sbmc_kernel_weighting_generic,
                data.device, *args)
    return out, sum_w


def _kernel_weighting_dw_cuda(data, d_output, d_sum_w, k,
                              dtype=torch.float32, route=None, groups=None):
    """Gradient of kernel weighting to its weights on the card, in ``dtype``
    (the weights', float32 or bfloat16): the kernel of ``route`` (by default
    :func:`kw_route`'s), the tiled one (``kw_dw``, which rounds its float32
    sums to bfloat16 once as it stores them) with ``groups`` groups of tap
    rows (by default :func:`kw_dw_groups`') and :func:`kw_pixels`' work
    items; the generic one writes float32, rounded afterwards. The other
    arguments are those of ``reference.kernel_weighting_dw_ref``."""
    _device_of(data, d_output, d_sum_w)
    _check_data("data", data)
    bs, c, h, w = data.shape
    _check_data("d_output", d_output, (bs, c, h, w))
    if tuple(d_sum_w.shape) != (bs, h, w):
        raise ValueError(f"d_sum_w has shape {tuple(d_sum_w.shape)}, "
                         f"expected {(bs, h, w)}")
    _check_planes("d_sum_w", d_sum_w, (torch.float32,))
    if k < 1 or k % 2 == 0:
        raise ValueError("kernel size must be odd")
    if bs > 65535:
        raise ValueError(f"batch {bs} exceeds the kernel's grid limit 65535")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"d_weights must be float32 or bfloat16, got {dtype}")
    lib = _load()
    ptrs = (data.data_ptr(), d_output.data_ptr(), d_sum_w.data_ptr())
    if (route or kw_route(k)) == "tiled":
        d_w = torch.empty((bs, k * k, h, w), dtype=dtype, device=data.device)
        _launch("kernel_weighting_dw", lib.sbmc_kernel_weighting_dw,
                data.device, *ptrs, d_w.data_ptr(),
                int(dtype == torch.bfloat16), bs, c, h, w, k,
                kw_pixels(w, 4, d_w.data_ptr() // d_w.element_size()),
                groups or kw_dw_groups(k))
        return d_w
    d_w = torch.empty((bs, k * k, h, w), dtype=torch.float32,
                      device=data.device)
    _launch("kernel_weighting_dw_generic",
            lib.sbmc_kernel_weighting_dw_generic, data.device, *ptrs,
            d_w.data_ptr(), bs, c, h, w, k)
    return d_w.to(dtype)


def _scatter2gather_cuda(weights, route=None, v=None):
    """scatter2gather on the card, in the input's dtype: the kernel of
    ``route`` (by default :func:`s2g_route`'s), the vector one with work
    items of ``v`` elements (by default :func:`s2g_pixels`')."""
    _device_of(weights)
    bs, h, w, k = _check_weights(weights)
    lib = _load()
    out = torch.empty_like(weights)
    itemsize = weights.element_size()
    args = (weights.data_ptr(), itemsize, out.data_ptr(), bs, h, w, k)
    if (route or s2g_route(k)) == "tiled":
        if v is None:
            v = s2g_pixels(w, itemsize, weights.data_ptr() // itemsize,
                           out.data_ptr() // itemsize)
        _launch("scatter2gather", lib.sbmc_scatter2gather, weights.device,
                *args, v)
    else:
        _launch("scatter2gather_generic", lib.sbmc_scatter2gather_generic,
                weights.device, *args)
    return out


def _scatter2gather_max_cuda(weights):
    """scatter2gather_max on the card (kernel ``s2g_max``): the transposed
    kernels in the input's dtype and their float32 tap max."""
    _device_of(weights)
    bs, h, w, k = _check_weights(weights)
    lib = _load()
    out = torch.empty_like(weights)
    kmax = torch.empty((bs, h, w), dtype=torch.float32, device=weights.device)
    _launch("scatter2gather_max", lib.sbmc_scatter2gather_max, weights.device,
            weights.data_ptr(), weights.element_size(), out.data_ptr(),
            kmax.data_ptr(), bs, h, w, k)
    return out, kmax


def _check_kw_exp(data, logits, maxes):
    """Checks the inputs of ``kernel_weighting_exp``'s kernel; returns
    ``(bs, c, h, w, k)``."""
    _device_of(data, logits, maxes)
    bs, h, w, k = _check_weights(logits)
    _check_data("data", data, (bs, h, w))
    if tuple(maxes.shape) != (bs, h, w):
        raise ValueError(f"maxes has shape {tuple(maxes.shape)}, expected "
                         f"{(bs, h, w)}")
    _check_planes("maxes", maxes, (torch.float32,))
    return bs, data.shape[1], h, w, k


def _kernel_weighting_exp_cuda(data, logits, maxes, route=None, groups=None):
    """Kernel weighting of ``exp(logits - maxes)`` on the card: the kernel
    of ``route`` (by default :func:`kw_route`'s), the tiled one
    (``kw_exp``) with ``groups`` groups of tap rows (by default
    :func:`kw_exp_groups`') and :func:`kw_pixels`' work items, which also
    load the maxes of their pixels at once. The arguments and results are
    those of ``reference.kernel_weighting_exp_ref``."""
    bs, c, h, w, k = _check_kw_exp(data, logits, maxes)
    lib = _load()
    out = torch.empty_like(data)
    sum_w = torch.empty((bs, h, w), dtype=torch.float32, device=data.device)
    args = (data.data_ptr(), logits.data_ptr(),
            int(logits.dtype == torch.bfloat16), maxes.data_ptr(),
            out.data_ptr(), sum_w.data_ptr(), bs, c, h, w, k)
    if (route or kw_route(k)) == "tiled":
        v = kw_pixels(w, 2, math.gcd(
            logits.data_ptr() // logits.element_size(),
            maxes.data_ptr() // maxes.element_size()))
        if groups is None:
            groups = kw_exp_groups(bs, h, w, k, v, _sm_count(data.device))
        _launch("kernel_weighting_exp", lib.sbmc_kernel_weighting_exp,
                data.device, *args, v, groups)
    else:
        _launch("kernel_weighting_exp_generic",
                lib.sbmc_kernel_weighting_exp_generic, data.device, *args)
    return out, sum_w


def _check_f32(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor, "
                             f"got {t.dtype}, contiguous {t.is_contiguous()}")


def _check_rays(org, dirs, per_ray, tris):
    """Checks the triangle kernels' inputs; returns ``(n, t)``."""
    _device_of(org, dirs, per_ray, tris)
    _check_f32(org=org, dirs=dirs, per_ray=per_ray, tris=tris)
    n = org.shape[0]
    if (org.shape != (n, 3) or dirs.shape != (n, 3)
            or per_ray.shape != (n,) or tris.dim() != 2
            or tris.shape[1] != 16):
        raise ValueError(f"rays {tuple(org.shape)}, {tuple(dirs.shape)}, "
                         f"{tuple(per_ray.shape)} and triangles "
                         f"{tuple(tris.shape)}: expected [n, 3], [n, 3], [n]"
                         " and [t, 16]")
    if tris.data_ptr() % 16:
        raise ValueError("the packed triangles must be 16-byte aligned")
    if n >= 2 ** 31 // 3:
        raise ValueError(f"{n} rays exceed the kernels' int32 indexing")
    return n, tris.shape[0]


def _tri_nearest_cuda(org, dirs, time, tris, route=None):
    """R1 on the card (``csrc/trace_hits.cu``): the kernel of ``route`` (by
    default :func:`tri_route`'s), the tiled one (``sbmc_tri_nearest``) or
    ``sbmc_tri_nearest_generic``."""
    n, t = _check_rays(org, dirs, time, tris)
    out_t = torch.full((n,), reference.TRI_MISS, device=org.device)
    out_idx = torch.zeros(n, dtype=torch.int32, device=org.device)
    out_back = torch.zeros(n, dtype=torch.bool, device=org.device)
    if n and t:
        lib = _load()
        args = (org.data_ptr(), dirs.data_ptr(), time.data_ptr(),
                tris.data_ptr(), n, t, out_t.data_ptr(), out_idx.data_ptr(),
                out_back.data_ptr())
        if (route or tri_route(t)) == "tiled":
            _launch("tri_nearest", lib.sbmc_tri_nearest, org.device, *args)
        else:
            _launch("tri_nearest_generic", lib.sbmc_tri_nearest_generic,
                    org.device, *args)
    return out_t, out_idx, out_back


def _tri_any_cuda(org, dirs, dist, tris, route=None):
    """R2 on the card (``csrc/trace_hits.cu``): the kernel of ``route`` (by
    default :func:`tri_route`'s), the tiled one (``sbmc_tri_any``, whose
    warps take their tiles from a queue that starts at 0) or
    ``sbmc_tri_any_generic``."""
    n, t = _check_rays(org, dirs, dist, tris)
    out = torch.zeros(n, dtype=torch.bool, device=org.device)
    if n and t:
        lib = _load()
        args = (org.data_ptr(), dirs.data_ptr(), dist.data_ptr(),
                tris.data_ptr(), n, t, out.data_ptr())
        if (route or tri_route(t)) == "tiled":
            queue = torch.zeros(1, dtype=torch.int32, device=org.device)
            _launch("tri_any", lib.sbmc_tri_any, org.device, *args,
                    queue.data_ptr())
        else:
            _launch("tri_any_generic", lib.sbmc_tri_any_generic, org.device,
                    *args)
    return out


def _threefry_cuda(keys, n, minval, maxval, raw):
    """R3 on the card (``sbmc_threefry_uniform`` of ``csrc/threefry.cu``):
    float32 uniforms, or the int32 bits with ``raw``."""
    _device_of(keys)
    if (keys.dtype != torch.int32 or keys.dim() != 2 or keys.shape[1] != 2
            or not keys.is_contiguous()):
        raise ValueError(f"keys must be a contiguous [b, 2] int32 tensor, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    b = keys.shape[0]
    if not (0 < b <= 65535 and 0 < n < 2 ** 31):
        raise ValueError(f"{b} keys of {n} values: the kernel takes 1-65535 "
                         "keys of 1 to 2**31 - 1 values")
    out = torch.empty((b, n), dtype=torch.int32 if raw else torch.float32,
                      device=keys.device)
    lo, hi = np.float32(minval), np.float32(maxval)
    _launch("threefry_uniform", _load().sbmc_threefry_uniform,
            keys.device, keys.data_ptr(), b, n, float(lo), float(hi - lo),
            int(raw), out.data_ptr())
    return out
