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
kernel on the cotangent.

``scatter2gather_max`` and ``kernel_weighting_exp`` are plain functions and
not differentiable, as in ``sbmc_tpu.ops``. For CUDA tensors they launch
``s2g_max`` of ``csrc/scatter2gather.cu`` (the port of ``_s2g_max_kernel``)
and ``kw_exp`` of ``csrc/kernel_weighting.cu`` (the port of
``_kw_exp_kernel``); composed as ``sbmc_tpu.ops._psu_fwd``'s unfused branch
they compute the same splat step as ``progressive_splat_update``.

``progressive_splat_update`` is a ``torch.autograd.Function`` too. For CUDA
tensors its forward launches ``csrc/progressive_splat.cu`` (the port of the
Pallas kernel ``_psf_kernel``) and its backward launches the two kernels of
``csrc/progressive_splat_bwd.cu`` (the ports of ``_psb_ddata_kernel`` and
``_psb_dlogits_kernel``), each only when its gradient is asked for. The
forward and the logits gradient each have two kernels, chosen by shape
(:func:`splat_route`): a tiled one (TMA-fed forward, 16-byte vector logits
gradient) at every shape the model paths give them, and the first port's
per-pixel kernel (``progressive_splat_generic``,
``progressive_splat_dlogits_generic``) where TMA or 16-byte vectors cannot
address the logits. For CPU tensors it runs the plain versions
(:mod:`sbmc_tpu_torch.ops.reference`). There is no fallback: a CUDA tensor
either launches a kernel or raises.

The backward mirrors ``sbmc_tpu.ops._psu_bwd``: the running max is a
constant (its contributions cancel in ``sum_r / sum_w``), so ``max_w`` gets
a zero gradient and the new max is not differentiable.
"""

import functools

import torch

from sbmc_tpu_torch.ops import reference
from sbmc_tpu_torch.ops.reference import (kernel_weighting_dw_ref,
                                          kernel_weighting_exp_ref,
                                          kernel_weighting_ref,
                                          progressive_splat_bwd_ref,
                                          progressive_splat_update_ref,
                                          scatter2gather_max_ref,
                                          scatter2gather_ref)

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
    "kw_dw_groups",
    "dlogits_row_blocks",
    "launch_counts",
    "reset_launch_counts",
    "reference",
]

#: Kernel launches since the last reset, by kernel name. Each wrapper adds
#: one where it launches its kernel, and nowhere else.
launch_counts = {"progressive_splat": 0, "progressive_splat_generic": 0,
                 "progressive_splat_ddata": 0,
                 "progressive_splat_dlogits": 0,
                 "progressive_splat_dlogits_generic": 0, "kernel_weighting": 0,
                 "kernel_weighting_generic": 0, "kernel_weighting_dw": 0,
                 "kernel_weighting_dw_generic": 0, "scatter2gather": 0,
                 "scatter2gather_max": 0, "kernel_weighting_exp": 0}

_CHANNELS = (2, 3)  # the kernels' template set
#: Kernel sizes the tiled splat and kernel-weighting kernels are built for:
#: the models' 21, and 3 and 5 for the tests.
TILED_KSIZES = (3, 5, 21)


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
      data: ``[bs, c, h, w]`` float32 values, c in (2, 3) on the card.
      logits: ``[bs, k2, h, w]`` gather-kernel logits, float32 or bfloat16
        (widened to float32 before the subtraction).
      maxes: ``[bs, h, w]`` float32 per-pixel shift.

    Returns:
      ``(output [bs, c, h, w], sum_w [bs, h, w])`` in float32; ``sum_w``
      sums every tap.
    """
    with torch.no_grad():
        return (kernel_weighting_exp_ref if _on_cpu(data, logits, maxes)
                else _kernel_weighting_exp_cuda)(data, logits, maxes)


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
    return (kernel_weighting_ref if _on_cpu(data, weights)
            else _kernel_weighting_cuda)(data, weights)


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
                d_weights = _kernel_weighting_dw_cuda(
                    data, d_output, d_sum_w, k, weights.dtype)
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
            out = _progressive_splat_cuda(*args)
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
                d_data = (reference.progressive_splat_ddata_ref if cpu
                          else _ddata_cuda)(klogits, new_max, d_r)
            if need_logits:
                d_logits = (reference.progressive_splat_dlogits_ref if cpu
                            else _dlogits_cuda)(data, klogits, new_max, d_r,
                                                d_w)
        return d_data, d_logits, d_sum_r, d_sum_w, d_max_w


def splat_route(w, k, itemsize, aligned=True):
    """Which kernels the splat step's forward and logits gradient launch on
    the card for logits ``[bs, k*k, h, w]`` of ``itemsize`` bytes.

    ``"tiled"``: the TMA-fed forward (``progressive_splat``) and the 16-byte
    vector logits gradient (``progressive_splat_dlogits``). They need ``k``
    in :data:`TILED_KSIZES`, a logits row of ``w * itemsize`` bytes that is
    a multiple of 16 (TMA's row stride; whole 16-byte vectors per row) and
    16-byte aligned logits (``aligned``). Every shape the model paths give
    the step has them (widths 2048, 512, 160, 128, 64, 48).

    ``"generic"``: otherwise (odd widths, other kernel sizes), the per-pixel
    kernels ``progressive_splat_generic`` and
    ``progressive_splat_dlogits_generic``. This is a dispatch by shape, not
    a fallback: either launch raises if it fails.
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


def kw_route(k):
    """Which kernels kernel weighting and its weight gradient launch on the
    card for ``k x k`` kernels.

    ``"tiled"``: ``kw_fwd`` and ``kw_dw`` (``kernel_weighting``,
    ``kernel_weighting_dw``), built for ``k`` in :data:`TILED_KSIZES` and
    any width: every shape the model paths give them.

    ``"generic"``: other kernel sizes, the per-pixel kernels
    ``kernel_weighting_generic`` and ``kernel_weighting_dw_generic``. This
    is a dispatch by shape, not a fallback: either launch raises if it
    fails.
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
    if c not in _CHANNELS:
        raise ValueError(f"the splat kernel takes {_CHANNELS} channels, "
                         f"got {c}")
    if bs > 65535:
        raise ValueError(f"batch {bs} exceeds the kernel's grid limit 65535")
    return bs, c, h, w, k


def _launch(name, fn, device, *args):
    """Call a kernel's C entry point on the current stream of ``device``,
    raise on a refused launch, and count the launch."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1


def _progressive_splat_cuda(data, klogits, sum_r, sum_w, max_w, route=None,
                            tile_h=None):
    """One splat step on the card: the kernel of ``route`` (by default
    :func:`splat_route`'s), the tiled one at ``tile_h`` rows (by default
    :func:`splat_tile_rows`'s)."""
    from sbmc_tpu_torch.ops import _build
    bs, c, h, w, k = _check(data, klogits, sum_r, sum_w, max_w)
    lib = _build.load_cuda()
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


def _ddata_cuda(klogits, new_max, d_r):
    """``d_data`` of one splat step on the card (kernel ``psb_ddata``); the
    arguments are those of ``reference.progressive_splat_ddata_ref``."""
    from sbmc_tpu_torch.ops import _build
    # d_r has data's shape and type; d_w's slot checks the other plane.
    bs, c, h, w, k = _check(d_r, klogits, d_r, new_max, new_max)
    lib = _build.load_cuda()
    d_data = torch.empty_like(d_r)
    _launch("progressive_splat_ddata", lib.sbmc_progressive_splat_ddata,
            klogits.device, klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), new_max.data_ptr(),
            d_r.data_ptr(), d_data.data_ptr(), bs, c, h, w, k)
    return d_data


def _dlogits_cuda(data, klogits, new_max, d_r, d_w, route=None):
    """``d_klogits`` of one splat step on the card, in the logits' dtype:
    the kernel of ``route`` (by default :func:`splat_route`'s), the vector
    one with :func:`dlogits_row_blocks`'s blocks per tile. The other
    arguments are those of ``reference.progressive_splat_dlogits_ref``."""
    from sbmc_tpu_torch.ops import _build
    bs, c, h, w, k = _check(data, klogits, d_r, d_w, new_max)
    lib = _build.load_cuda()
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
    """Checks a float32 ``[bs, c, h, w]`` tensor of 2 or 3 channels; its
    batch and image sizes (and channels, for a 4-tuple) against ``like``."""
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
    if t.shape[1] not in _CHANNELS:
        raise ValueError(f"the kernel-weighting kernels take {_CHANNELS} "
                         f"channels, got {t.shape[1]}")


def _kernel_weighting_cuda(data, weights, route=None, groups=None):
    """Kernel weighting on the card: the kernel of ``route`` (by default
    :func:`kw_route`'s), the tiled one with ``groups`` groups of tap rows
    (by default :func:`kw_groups`') and :func:`kw_pixels`' work items. The
    arguments and results are those of ``reference.kernel_weighting_ref``."""
    from sbmc_tpu_torch.ops import _build
    _device_of(data, weights)
    bs, h, w, k = _check_weights(weights)
    _check_data("data", data, (bs, h, w))
    c = data.shape[1]
    lib = _build.load_cuda()
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
    from sbmc_tpu_torch.ops import _build
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
    lib = _build.load_cuda()
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


def _scatter2gather_cuda(weights):
    """scatter2gather on the card (kernel ``s2g``), in the input's dtype."""
    from sbmc_tpu_torch.ops import _build
    _device_of(weights)
    bs, h, w, k = _check_weights(weights)
    lib = _build.load_cuda()
    out = torch.empty_like(weights)
    _launch("scatter2gather", lib.sbmc_scatter2gather, weights.device,
            weights.data_ptr(), weights.element_size(), out.data_ptr(), bs,
            h, w, k)
    return out


def _scatter2gather_max_cuda(weights):
    """scatter2gather_max on the card (kernel ``s2g_max``): the transposed
    kernels in the input's dtype and their float32 tap max."""
    from sbmc_tpu_torch.ops import _build
    _device_of(weights)
    bs, h, w, k = _check_weights(weights)
    lib = _build.load_cuda()
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


def _kernel_weighting_exp_cuda(data, logits, maxes):
    """Kernel weighting of ``exp(logits - maxes)`` on the card (kernel
    ``kw_exp``); the arguments and results are those of
    ``reference.kernel_weighting_exp_ref``."""
    from sbmc_tpu_torch.ops import _build
    bs, c, h, w, k = _check_kw_exp(data, logits, maxes)
    lib = _build.load_cuda()
    out = torch.empty_like(data)
    sum_w = torch.empty((bs, h, w), dtype=torch.float32, device=data.device)
    _launch("kernel_weighting_exp", lib.sbmc_kernel_weighting_exp,
            data.device, data.data_ptr(), logits.data_ptr(),
            int(logits.dtype == torch.bfloat16), maxes.data_ptr(),
            out.data_ptr(), sum_w.data_ptr(), bs, c, h, w, k)
    return out, sum_w
