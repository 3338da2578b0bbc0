"""The sample-based kernel-splatting denoiser (``Multisteps``).

Inputs of a frame, drawn from the seed on the device, uniform in [0, 1) as
the port's bench draws them: ``radiance [1, spp, 3, h, w]`` float32,
``features [1, spp, n_features, h, w]`` in the convolutions' dtype,
``global_features [1, n_global_features, 1, 1]``.
A training tile adds ``target_image [3, h, w]`` and keeps its features in
float16, as the program's reservoir holds them.
"""

import torch

from benchmark import work
from benchmark.arch import build
from benchmark.reference.models import leaves

PIXEL_KEYS = ("radiance", "features")


def program(cfg, params, device):
    from sbmc_tpu_torch.models import Multisteps
    return build(Multisteps, cfg, params, device)


def frame(cfg, gen, device, h, w, spp):
    m = cfg["model"]
    fdt = getattr(torch, m.get("conv_dtype") or "float32")

    def rand(*shape, dtype=torch.float32):
        return torch.rand(*shape, generator=gen, device=device, dtype=dtype)

    return {"radiance": rand(1, spp, 3, h, w),
            "features": rand(1, spp, m["n_features"], h, w, dtype=fdt),
            "global_features": rand(1, m["n_global_features"], 1, 1)}


def train_tiles(cfg, gen, device, n, h, w, spp):
    """``n`` training tiles, one tensor a key with a leading axis ``n``.
    Each tile's radiance and target take a brightness of its own,
    ``exp(U(-2, 2))``, as rendered tiles differ, so that every tile of a
    batch weighs differently in its loss."""
    m = cfg["model"]

    def rand(*shape, dtype=torch.float32):
        return torch.rand(*shape, generator=gen, device=device, dtype=dtype)

    scale = torch.exp(4 * rand(n, 1, 1, 1) - 2)
    return {"features": rand(n, spp, m["n_features"], h, w,
                             dtype=torch.float16),
            "radiance": rand(n, spp, 3, h, w) * scale[:, None],
            "global_features": rand(n, m["n_global_features"], 1, 1),
            "target_image": rand(n, 3, h, w) * scale}


def _levels(h, w):
    return [(h >> lvl, w >> lvl) for lvl in range(3)]


def _conv_flops(cfg, h, w, spp):
    """Forward FLOPs of the convolutions, and of the first one alone."""
    total = first = 0
    for name, shape, _, kind in leaves(cfg):
        if kind != "w":
            continue
        macs = shape[0] * shape[1] * shape[2] * shape[3]
        if name.startswith("unet"):
            lvl = int(name.split(".")[1][-1])
            ph, pw = _levels(h, w)[lvl]
            f = 2 * macs * ph * pw
        else:
            f = 2 * macs * h * w * spp
        total += f
        if name == "embed0.conv0.w":
            first = f
    return total, first


def _splat_flops(cfg, h, w, spp, c=3):
    return 2 * cfg["model"]["ksize"] ** 2 * (c + 1) * h * w * spp


def flops(cfg, h, w, spp):
    """Useful forward FLOPs of an ``h x w`` frame: every convolution's
    multiply-adds at its resolution (per sample for the embeddings and the
    regressor, at 1, 1/4 and 1/16 of the pixels for the U-Net's levels)
    and the splat's weighted sums; pooling, upsampling and elementwise
    work are not counted."""
    return _conv_flops(cfg, h, w, spp)[0] + _splat_flops(cfg, h, w, spp)


def train_flops(cfg, bs, h, w, spp):
    """Forward and backward FLOPs of a batch: the convolutions three times
    (forward, data and weight gradients) less the data gradient of the
    first, whose input needs none; the splat twice (forward, logits
    gradient; the radiance needs no gradient)."""
    conv, first = _conv_flops(cfg, h, w, spp)
    return bs * (3 * conv - first + 2 * _splat_flops(cfg, h, w, spp))


def kernel_bytes(cfg, tiles, spp, bs=1):
    """Bytes of the hand-written kernels' launches over ``tiles`` (a list
    of ``(h, w)``): one splat step (B1) a sample a tile."""
    m = cfg["model"]
    isz = work.ITEMSIZE[m.get("kernel_dtype")]
    return {"splat_bytes": sum(
        spp * work.splat_bytes(bs, 3, th, tw, m["ksize"] ** 2, isz)
        for th, tw in tiles)}
