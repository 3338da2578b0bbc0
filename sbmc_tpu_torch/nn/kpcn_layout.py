"""The passes at the two ends of KPCN's conv chains, channels-last, for
inference.

:meth:`~sbmc_tpu_torch.models.kpcn.KPCN.forward_channels_last` runs each
chain on dense channels-last tensors whose channel counts are padded with
zeros to aligned widths: each convolution is cuDNN's without its bias, the
bias and ReLU between them are :func:`sbmc_tpu_torch.nn.unet.epilogue`'s,
and these two ops are the chain's ends.

- :func:`kpcn_entry`: the chain's NCHW input as a dense channels-last
  tensor at a padded width, the pad channels zero, cast to the compute
  dtype (``x.to(bf16)`` in ``KPCN.forward``);
- :func:`kpcn_exit`: the prediction convolution's channels-last output
  (without its bias) to the normalised gather kernels ``[bs, k2, h, w]``,
  NCHW, that kernel weighting reads: ``torch.softmax(bf16(y + bias),
  dim=1)`` over the first ``k2`` channels, as ``WNConv2D.forward`` adds the
  bias and ``kernel_apply(softmax=True)`` normalises.

For CUDA tensors each is one launch of a hand-written kernel
(``ops/csrc/kpcn.cu``: ``kpcn_entry``, ``kpcn_exit``), counted in
``ops.launch_counts``; bf16 out, no gradient. For CPU tensors the plain
versions run (:func:`kpcn_entry_ref`, :func:`kpcn_exit_ref`), in any dtype.
"""

import torch
import torch.nn.functional as F

from sbmc_tpu_torch import ops

__all__ = ["MAX_EXIT_CHANNELS", "kpcn_entry", "kpcn_entry_ref", "kpcn_exit",
           "kpcn_exit_ref"]

#: The widest padded prediction the exit kernel takes (a block stages 64
#: pixels' logits in shared memory): 441 taps (k = 21) pad to 448.
MAX_EXIT_CHANNELS = 512
#: The entry kernel's input types, by their codes in the kernel: whatever a
#: KPCN input may arrive as (float16 from the host, halving the transfer).
_ENTRY_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kpcn_entry_ref(x, width, dtype=torch.bfloat16):
    """The plain entry: ``x`` ``[bs, c, h, w]`` cast to ``dtype``, zero
    channels appended up to ``width``, as a dense channels-last tensor."""
    return F.pad(x.to(dtype), (0, 0, 0, 0, 0, width - x.shape[1])).contiguous(
        memory_format=torch.channels_last)


def kpcn_exit_ref(y, bias, k2):
    """The plain exit: ``y`` ``[bs, c, h, w]`` (``c >= k2``, any layout),
    ``bias`` ``[k2]`` (float32; rounded to ``y``'s dtype first); returns
    ``torch.softmax(y[:, :k2] + bias, dim=1)`` in ``y``'s dtype, dense
    NCHW."""
    logits = y[:, :k2] + bias.to(y.dtype)[:, None, None]
    return torch.softmax(logits.contiguous(), dim=1)


def kpcn_entry(x, width, dtype=torch.bfloat16):
    """The entry (arguments and result as :func:`kpcn_entry_ref`): the
    kernel for CUDA tensors (``x`` dense NCHW, float32, bf16 or float16;
    ``dtype`` bf16; ``width`` a multiple of 8), the plain version for CPU
    ones."""
    if ops._on_cpu(x):
        return kpcn_entry_ref(x, width, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the entry kernel writes bfloat16, not {dtype}")
    if x.dtype not in _ENTRY_DTYPES:
        raise ValueError("x must be float32, bfloat16 or float16, got "
                         f"{x.dtype}")
    ops._no_grad("the KPCN layout kernels", x)
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a dense NCHW tensor [bs, c, h, w]")
    bs, c, h, w = x.shape
    if width % 8 or width < c:
        raise ValueError(f"the padded width {width} must be a multiple of 8 "
                         f"and at least the {c} channels")
    out = torch.empty(bs, width, h, w, dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    ops._launch("kpcn_entry", ops._load().sbmc_kpcn_entry, x.device,
                x.data_ptr(), _ENTRY_DTYPES[x.dtype], out.data_ptr(), bs, c,
                h, w, width, ops._sm_count(x.device))
    return out


def kpcn_exit(y, bias, k2):
    """The exit (arguments and result as :func:`kpcn_exit_ref`): the kernel
    for CUDA tensors (``y`` bf16, dense channels-last, 16-byte aligned,
    channels a multiple of 8 up to :data:`MAX_EXIT_CHANNELS`), the plain
    version for CPU ones."""
    if ops._on_cpu(y, bias):
        return kpcn_exit_ref(y, bias, k2)
    if y.dtype != torch.bfloat16:
        raise ValueError(f"y must be bfloat16, got {y.dtype}")
    ops._no_grad("the KPCN layout kernels", y)
    bs, c, h, w = y.shape
    if not y.is_contiguous(memory_format=torch.channels_last) \
            or y.data_ptr() % 16:
        raise ValueError("y must be a dense channels-last tensor, 16-byte "
                         "aligned")
    if c % 8 or c > MAX_EXIT_CHANNELS or not 0 < k2 <= c:
        raise ValueError(f"the exit kernel takes a multiple of 8 channels up "
                         f"to {MAX_EXIT_CHANNELS} and 0 < k2 <= them, got "
                         f"{c} and {k2}")
    if tuple(bias.shape) != (k2,):
        raise ValueError(f"bias has shape {tuple(bias.shape)}, expected "
                         f"{(k2,)}")
    b = bias.detach().to(torch.bfloat16).contiguous()
    out = torch.empty(bs, k2, h, w, dtype=torch.bfloat16, device=y.device)
    ops._launch("kpcn_exit", ops._load().sbmc_kpcn_exit, y.device,
                y.data_ptr(), b.data_ptr(), out.data_ptr(), bs, h, w, c, k2,
                ops._sm_count(y.device))
    return out
