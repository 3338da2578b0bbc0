"""The kernel-predicting baseline (``KPCN``, Bako et al. 2017).

Inputs of a frame, drawn from the seed on the device, uniform in [0, 1) as
the port's bench draws them, float32: ``kpcn_diffuse_in`` and
``kpcn_specular_in`` ``[1, n_in, h, w]``, ``kpcn_diffuse_buffer``,
``kpcn_specular_buffer`` and ``kpcn_albedo`` ``[1, 3, h, w]``.
"""

import torch

from benchmark import work
from benchmark.arch import build
from benchmark.reference.models import leaves

PIXEL_KEYS = ("kpcn_diffuse_in", "kpcn_specular_in", "kpcn_diffuse_buffer",
              "kpcn_specular_buffer", "kpcn_albedo")


def program(cfg, params, device):
    from sbmc_tpu_torch.models import KPCN
    return build(KPCN, cfg, params, device)


def frame(cfg, gen, device, h, w, spp=None):
    n_in = cfg["model"]["n_in"]
    return {k: torch.rand(1, n_in if k.endswith("_in") else 3, h, w,
                          generator=gen, device=device)
            for k in PIXEL_KEYS}


def flops(cfg, h, w, spp=None):
    """Useful forward FLOPs of an ``h x w`` frame: each valid 5x5
    convolution's multiply-adds for every pixel of the frame, and the two
    kernel applications' weighted sums; the softmax is not counted."""
    convs = sum(2 * shape[0] * shape[1] * shape[2] * shape[3]
                for _, shape, _, kind in leaves(cfg) if kind == "w")
    k2 = cfg["model"]["ksize"] ** 2
    return (convs + 2 * 2 * k2 * (3 + 1)) * h * w


def kernel_bytes(cfg, tiles, spp=None, bs=1):
    """Bytes of the hand-written kernels' launches over ``tiles``: kernel
    weighting (B4) twice a tile, at the tile less the valid convolutions'
    border, with weights in the convolutions' dtype (the softmax keeps
    it)."""
    m = cfg["model"]
    isz = work.ITEMSIZE[m.get("conv_dtype")]
    b = 4 * m["depth"]
    return {"kw_bytes": sum(
        2 * work.kw_bytes(bs, 3, th - b, tw - b, m["ksize"] ** 2, isz)
        for th, tw in tiles)}
