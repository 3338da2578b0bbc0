"""The yardstick's numbers: the card's published peaks and the bytes the
hand-written kernels must move, as functions of their shapes.

Peaks: NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W power
limit. A roofline share is the least time the kernel could take, the
larger of its operations over the peak rate and its bytes over the memory
bandwidth, over its measured device time. The splat and kernel-weighting
kernels do a few operations a byte, so their bound is the bytes: each
input byte read once and each output byte written once.
"""

__all__ = ["PEAK_FLOPS", "HBM_BYTES_PER_S", "ITEMSIZE", "splat_bytes",
           "kw_bytes"]

#: Dense peak FLOP/s by the dtype the model's matrix work runs in.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
#: HBM3 bandwidth, bytes/s.
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, None: 4}


def splat_bytes(bs, c, h, w, k2, itemsize):
    """One launch of the fused progressive splat step (B1): reads the
    ``[bs, k2, h, w]`` logits, the sample's ``c`` float32 planes and the
    float32 state ``(sum_r, sum_w, max_w)``, writes the new state."""
    return bs * h * w * (k2 * itemsize + 4 * c + 2 * 4 * (c + 2))


def kw_bytes(bs, c, h, w, k2, itemsize):
    """One launch of kernel weighting (B4): reads the ``[bs, k2, h, w]``
    weights and ``c`` float32 data planes, writes ``c`` output planes and
    ``sum_w``."""
    return bs * h * w * (k2 * itemsize + 4 * c + 4 * c + 4)
