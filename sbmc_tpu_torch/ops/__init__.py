"""Splat/gather operators: device dispatch between the hand-written CUDA
kernels and their plain PyTorch versions.

``progressive_splat_update`` is a ``torch.autograd.Function``. For CUDA
tensors its forward launches ``csrc/progressive_splat.cu`` (the port of the
Pallas kernel ``_psf_kernel``) and its backward launches the two kernels of
``csrc/progressive_splat_bwd.cu`` (the ports of ``_psb_ddata_kernel`` and
``_psb_dlogits_kernel``), each only when its gradient is asked for. For CPU
tensors it runs the plain versions (:mod:`sbmc_tpu_torch.ops.reference`).
There is no fallback: a CUDA tensor either launches a kernel or raises.

The backward mirrors ``sbmc_tpu.ops._psu_bwd``: the running max is a
constant (its contributions cancel in ``sum_r / sum_w``), so ``max_w`` gets
a zero gradient and the new max is not differentiable.
"""

import torch

from sbmc_tpu_torch.ops import reference
from sbmc_tpu_torch.ops.reference import (progressive_splat_bwd_ref,
                                          progressive_splat_update_ref)

__all__ = [
    "progressive_splat_update",
    "progressive_splat_update_ref",
    "progressive_splat_bwd_ref",
    "launch_counts",
    "reset_launch_counts",
    "reference",
]

#: Kernel launches since the last reset, by kernel name. Each wrapper adds
#: one where it launches its kernel, and nowhere else.
launch_counts = {"progressive_splat": 0, "progressive_splat_ddata": 0,
                 "progressive_splat_dlogits": 0}

_CHANNELS = (2, 3)  # the kernels' template set


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


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


def _progressive_splat_cuda(data, klogits, sum_r, sum_w, max_w):
    from sbmc_tpu_torch.ops import _build
    bs, c, h, w, k = _check(data, klogits, sum_r, sum_w, max_w)
    lib = _build.load_cuda()
    out_r = torch.empty_like(sum_r)
    out_w = torch.empty_like(sum_w)
    out_m = torch.empty_like(max_w)
    _launch("progressive_splat", lib.sbmc_progressive_splat, data.device,
            data.data_ptr(), klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), sum_r.data_ptr(),
            sum_w.data_ptr(), max_w.data_ptr(), out_r.data_ptr(),
            out_w.data_ptr(), out_m.data_ptr(), bs, c, h, w, k)
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


def _dlogits_cuda(data, klogits, new_max, d_r, d_w):
    """``d_klogits`` of one splat step on the card (kernel ``psb_dlogits``),
    in the logits' dtype; the arguments are those of
    ``reference.progressive_splat_dlogits_ref``."""
    from sbmc_tpu_torch.ops import _build
    bs, c, h, w, k = _check(data, klogits, d_r, d_w, new_max)
    lib = _build.load_cuda()
    d_logits = torch.empty_like(klogits)
    _launch("progressive_splat_dlogits", lib.sbmc_progressive_splat_dlogits,
            klogits.device, data.data_ptr(), klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), new_max.data_ptr(),
            d_r.data_ptr(), d_w.data_ptr(), d_logits.data_ptr(), bs, c, h, w,
            k)
    return d_logits
