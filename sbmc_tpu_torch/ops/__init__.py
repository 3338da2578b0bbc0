"""Splat/gather operators: device dispatch between the hand-written CUDA
kernel and its plain PyTorch version.

``progressive_splat_update`` launches the CUDA kernel
(``csrc/progressive_splat.cu``, the port of the Pallas kernel
``_psf_kernel``) for CUDA tensors and runs the plain version
(:mod:`sbmc_tpu_torch.ops.reference`) for CPU tensors. There is no fallback:
a CUDA tensor either launches the kernel or raises.

Forward only: gradients come with the backward kernels, so the op refuses
tensors that require grad (call it under ``torch.inference_mode()``).
"""

import torch

from sbmc_tpu_torch.ops import reference
from sbmc_tpu_torch.ops.reference import progressive_splat_update_ref

__all__ = [
    "progressive_splat_update",
    "progressive_splat_update_ref",
    "launch_counts",
    "reset_launch_counts",
    "reference",
]

#: Kernel launches since the last reset, by kernel name. Each wrapper adds
#: one where it launches its kernel, and nowhere else.
launch_counts = {"progressive_splat": 0}

_CHANNELS = (2, 3)  # the kernel's template set


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def progressive_splat_update(data, klogits, sum_r, sum_w, max_w):
    """One fused progressive online-softmax splat step.

    Args:
      data: ``[bs, c, h, w]`` float32 sample radiance.
      klogits: ``[bs, k2, h, w]`` raw splat-kernel logits, float32 or
        bfloat16.
      sum_r, sum_w, max_w: float32 running state (``[bs, c, h, w]``,
        ``[bs, 1, h, w]``, ``[bs, 1, h, w]``).

    Returns:
      ``(sum_r', sum_w', max_w')``, new float32 tensors.
    """
    args = (data, klogits, sum_r, sum_w, max_w)
    if any(t.requires_grad for t in args):
        raise RuntimeError(
            "progressive_splat_update is forward-only: call it under "
            "torch.inference_mode() (its backward kernels are not ported)")
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: %s"
                         % sorted(map(str, devices)))
    device = devices.pop()
    if device.type == "cpu":
        return progressive_splat_update_ref(*args)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return _progressive_splat_cuda(*args)


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


def _progressive_splat_cuda(data, klogits, sum_r, sum_w, max_w):
    from sbmc_tpu_torch.ops import _build
    bs, c, h, w, k = _check(data, klogits, sum_r, sum_w, max_w)
    lib = _build.load_cuda()
    out_r = torch.empty_like(sum_r)
    out_w = torch.empty_like(sum_w)
    out_m = torch.empty_like(max_w)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.sbmc_progressive_splat(
            data.data_ptr(), klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), sum_r.data_ptr(),
            sum_w.data_ptr(), max_w.data_ptr(), out_r.data_ptr(),
            out_w.data_ptr(), out_m.data_ptr(), bs, c, h, w, k, stream)
    if err != 0:
        raise RuntimeError(f"progressive splat kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["progressive_splat"] += 1
    return out_r, out_w, out_m
