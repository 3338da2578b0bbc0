"""The passes around the U-Net's convolutions, channels-last, and their
backward.

:meth:`~sbmc_tpu_torch.nn.layers.Autoencoder.forward_channels_last` runs
the U-Net in channels-last (NHWC) tensors: each convolution is cuDNN's,
without its bias, and these ops do the rest.

- :func:`epilogue`: the bias and the activation of one convolution's output
  (``act(bf16(y + b))``, rounded as ``WNConv2D.forward`` and ``ConvChain``
  round them), in place or into a channel slot of a wider tensor (the
  skip's slot of the concatenation buffer), with the 2x2 max-pool of the
  result (``F.max_pool2d(x, 2)``) if asked, in the same pass;
- :func:`upsample`: ``F.interpolate(x, size, mode="bilinear",
  align_corners=False)`` written into a channel slot (the upsampled slot of
  the concatenation buffer);
- :func:`relayout`: the U-Net's input from NCHW to channels-last, and its
  output back.

The train step's backward of the U-Net (``Autoencoder.forward_channels_last``
under gradients) runs their backward around cuDNN's NHWC dgrad and wgrad:

- :func:`epilogue_backward`: from the gradient of one epilogue's output and
  the saved output, the gradient of the convolution's output and of the
  bias; with the pool's gradient routed to each 2x2 window's argmax first
  (recomputed from the saved output) for each level's last left
  convolution;
- :func:`upsample_backward`: the transpose of :func:`upsample`, from the
  gradient of the upsampled slot to the coarse tensor.

For CUDA tensors each is one launch of a hand-written kernel
(``ops/csrc/unet.cu``: ``unet_epilogue``, ``unet_upsample``,
``unet_layout``, ``unet_epilogue_backward``, ``unet_upsample_backward``),
counted in ``ops.launch_counts``; bf16 only, channel counts a multiple of 8,
no autograd of their own (the tensors must not require grad). For CPU
tensors the plain versions run (:func:`epilogue_ref`, :func:`upsample_ref`,
:func:`relayout_ref`, :func:`epilogue_backward_ref`,
:func:`upsample_backward_ref`), in any dtype and layout.

A slot is a view ``buffer[:, lo:hi]`` of a channels-last tensor: its values
of one pixel are contiguous, and its pixels lie ``buffer.shape[1]``
channels apart.
"""

import torch
import torch.nn.functional as F

from sbmc_tpu_torch import ops

__all__ = ["ACTIVATIONS", "activate", "activation_grad", "epilogue",
           "epilogue_ref", "upsample", "upsample_ref", "relayout",
           "relayout_ref", "epilogue_backward", "epilogue_backward_ref",
           "upsample_backward", "upsample_backward_ref"]

#: The activations the epilogue applies, by ``ConvChain`` name, and their
#: codes in the kernel.
ACTIVATIONS = {"linear": 0, "relu": 1, "leaky_relu": 2}


def activate(act, x):
    """``act`` (an :data:`ACTIVATIONS` name) applied to ``x``."""
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return F.leaky_relu(x, 0.01)
    if act == "linear":
        return x
    raise ValueError(f"the U-Net epilogue has no activation {act!r}")


def epilogue_ref(y, bias, act, out=None, pool=None):
    """The plain epilogue: ``act(y + bias)`` in ``y``'s dtype, as
    ``WNConv2D.forward`` and ``ConvChain`` compute it, written into ``out``
    (``y`` itself if None), and with ``pool`` given its 2x2 max-pool into
    ``pool``. ``y`` ``[bs, c, h, w]``, ``bias`` ``[c]`` (float32; rounded to
    ``y``'s dtype first), ``out`` of ``y``'s shape, ``pool`` ``[bs, c, h //
    2, w // 2]``. Returns ``out``."""
    r = activate(act, y + bias.to(y.dtype)[:, None, None])
    if pool is not None:
        pool.copy_(F.max_pool2d(r, 2))
    out = y if out is None else out
    return out.copy_(r)


def upsample_ref(x, out):
    """The plain upsample: ``F.interpolate(x, size=out.shape[-2:],
    mode="bilinear", align_corners=False)`` written into ``out``. Returns
    ``out``."""
    return out.copy_(F.interpolate(x, size=tuple(out.shape[-2:]),
                                   mode="bilinear", align_corners=False))


def relayout_ref(x, channels_last):
    """The plain layout change: ``x`` ``[bs, c, h, w]`` as a dense
    channels-last tensor (``channels_last`` True) or a dense NCHW one."""
    return x.contiguous(memory_format=torch.channels_last if channels_last
                        else torch.contiguous_format)


def epilogue_backward_ref(dy, out, act, dpool=None):
    """The plain backward of :func:`epilogue_ref` for one convolution, as
    PyTorch's autograd computes it through ``WNConv2D.forward``, the
    activation and ``F.max_pool2d``: ``dy`` (the gradient of the epilogue's
    output ``out``, both ``[bs, c, h, w]``) plus, with ``dpool`` (``[bs, c,
    h // 2, w // 2]``) given, the pool's gradient at each window's argmax
    (one rounding to ``out``'s dtype), through the activation's derivative
    read from ``out``'s sign. Returns ``(dz, dbias)``: the gradient of the
    convolution's output, channels-last in ``out``'s dtype, and of the bias,
    float32 (the sum in float32, rounded once to ``out``'s dtype)."""
    g = dy
    if dpool is not None:
        bs, c, h, w = out.shape
        _, idx = F.max_pool2d(out, 2, return_indices=True)
        routed = torch.zeros(bs, c, h * w, dtype=dy.dtype, device=dy.device)
        routed.scatter_(2, idx.flatten(2), dpool.flatten(2).to(dy.dtype))
        g = dy + routed.view(bs, c, h, w)
    dz = activation_grad(g, out, act).contiguous(
        memory_format=torch.channels_last)
    dbias = dz.float().sum((0, 2, 3)).to(dz.dtype).float()
    return dz, dbias


def activation_grad(g, out, act):
    """The gradient through ``act`` from the gradient ``g`` of its output
    ``out`` (read for its sign alone), as autograd computes it in ``g``'s
    dtype: the ReLU's zero where ``out <= 0``, the leaky ReLU's ``g * 0.01``
    where ``out`` is not positive."""
    if act == "relu":
        return torch.where(out <= 0, torch.zeros_like(g), g)
    if act == "leaky_relu":
        return torch.where(out > 0, g, g * 0.01)
    if act == "linear":
        return g
    raise ValueError(f"the U-Net epilogue has no activation {act!r}")


def _interpolation(n_in, n_out, device):
    """``[n_out, n_in]`` float32 weights of ``upsample_bilinear2d``
    (``align_corners=False``, the scale from the sizes) along one side."""
    scale = (torch.tensor(n_in, dtype=torch.float32)
             / torch.tensor(n_out, dtype=torch.float32))
    dst = torch.arange(n_out, dtype=torch.float32)
    r = (scale * (dst + 0.5) - 0.5).clamp(min=0.0)
    i0 = r.long()
    i1 = i0 + (i0 < n_in - 1).long()
    l1 = r - i0.float()
    m = torch.zeros(n_out, n_in)
    rows = torch.arange(n_out)
    m.index_put_((rows, i0), 1.0 - l1, accumulate=True)
    m.index_put_((rows, i1), l1, accumulate=True)
    return m.to(device)


def upsample_backward_ref(g, size):
    """The plain backward of :func:`upsample_ref`: ``g`` (the gradient of
    the upsampled ``[bs, c, ho, wo]``) to the gradient of the ``[bs, c] +
    size`` input, summed in float32 and rounded once to ``g``'s dtype,
    channels-last."""
    hi, wi = size
    my = _interpolation(hi, g.shape[2], g.device)
    mx = _interpolation(wi, g.shape[3], g.device)
    dx = my.t() @ g.float() @ mx
    return dx.to(g.dtype).contiguous(memory_format=torch.channels_last)


def _is_slot(t):
    """Whether ``t`` ``[bs, c, h, w]`` lies as a channels-last tensor or a
    channel slot of one: each pixel's channels contiguous, the pixels at
    one stride (``t.stride(3)``) in row-major order."""
    bs, c, h, w = t.shape
    ld = t.stride(3)
    return (t.stride(1) == 1 and ld >= c
            and (h == 1 or t.stride(2) == w * ld)
            and (bs == 1 or t.stride(0) == h * w * ld))


def _check(name, t, shape=None):
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    ops._no_grad("the U-Net kernels", t)
    if t.shape[1] % 8 or t.stride(3) % 8 or t.data_ptr() % 16 \
            or not _is_slot(t):
        raise ValueError(
            f"{name} must be channels-last with a multiple of 8 channels "
            "(a channels-last tensor or a channel slot of one, 16-byte "
            "aligned)")


def epilogue(y, bias, act, out=None, pool=None):
    """The epilogue of one convolution (arguments and result as
    :func:`epilogue_ref`): the kernel for CUDA tensors (``y`` dense
    channels-last; ``out`` a channels-last tensor or slot; ``pool`` dense
    channels-last), the plain version for CPU ones."""
    if ops._on_cpu(y, bias):
        return epilogue_ref(y, bias, act, out, pool)
    bs, c, h, w = y.shape
    _check("y", y)
    if y.stride(3) != c:
        raise ValueError("y must be a dense channels-last tensor")
    if out is None:
        out = y
    else:
        _check("out", out, y.shape)
    if pool is not None:
        _check("pool", pool, (bs, c, h // 2, w // 2))
        if pool.stride(3) != c:
            raise ValueError("pool must be a dense channels-last tensor")
    if act not in ACTIVATIONS:
        raise ValueError(f"the U-Net epilogue has no activation {act!r}")
    b = bias.detach().to(torch.bfloat16).contiguous()
    ops._launch("unet_epilogue", ops._load().sbmc_unet_epilogue, y.device,
                y.data_ptr(), b.data_ptr(), out.data_ptr(), out.stride(3),
                None if pool is None else pool.data_ptr(), ACTIVATIONS[act],
                bs, h, w, c, ops._sm_count(y.device))
    return out


def upsample(x, out):
    """The bilinear upsample (arguments and result as
    :func:`upsample_ref`): the kernel for CUDA tensors (``x`` dense
    channels-last, ``out`` a channels-last tensor or slot at least twice its
    height and width, as the U-Net's skips are), the plain version for CPU
    ones."""
    if ops._on_cpu(x, out):
        return upsample_ref(x, out)
    bs, c, hi, wi = x.shape
    ho, wo = out.shape[-2:]
    _check("x", x)
    if x.stride(3) != c:
        raise ValueError("x must be a dense channels-last tensor")
    _check("out", out, (bs, c, ho, wo))
    if 2 * hi > ho or 2 * wi > wo:
        raise ValueError(f"the upsample kernel at least doubles: {hi}x{wi} "
                         f"to {ho}x{wo}")
    ops._launch("unet_upsample", ops._load().sbmc_unet_upsample, x.device,
                x.data_ptr(), out.data_ptr(), out.stride(3), bs, hi, wi, ho,
                wo, c)
    return out


def relayout(x, channels_last):
    """The layout change (arguments and result as :func:`relayout_ref`):
    ``x`` returned as it is if it already lies so, else the kernel for CUDA
    tensors (``x`` dense in the other layout), the plain version for CPU
    ones."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    if x.is_contiguous(memory_format=fmt):
        return x
    if ops._on_cpu(x):
        return relayout_ref(x, channels_last)
    ops._no_grad("the U-Net kernels", x)
    other = torch.contiguous_format if channels_last else torch.channels_last
    if x.dtype != torch.bfloat16 or x.shape[1] % 8 or x.data_ptr() % 16 \
            or not x.is_contiguous(memory_format=other):
        raise ValueError("the layout kernel takes a dense bf16 tensor with a "
                         "multiple of 8 channels, NCHW or channels-last, "
                         "16-byte aligned")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    bs, c, h, w = x.shape
    ops._launch("unet_layout", ops._load().sbmc_unet_layout, x.device,
                x.data_ptr(), out.data_ptr(), int(channels_last), bs, c, h, w,
                ops._sm_count(x.device))
    return out


def epilogue_backward(dy, out, act, dpool=None):
    """The epilogue's backward for one convolution (arguments and result as
    :func:`epilogue_backward_ref`): the kernel for CUDA tensors (``dy`` and
    ``out`` channels-last tensors or slots, ``dpool`` dense channels-last;
    ``dz`` dense channels-last), the plain version for CPU ones."""
    if ops._on_cpu(dy, out):
        return epilogue_backward_ref(dy, out, act, dpool)
    bs, c, h, w = out.shape
    _check("out", out)
    _check("dy", dy, out.shape)
    if dpool is not None:
        _check("dpool", dpool, (bs, c, h // 2, w // 2))
        if dpool.stride(3) != c:
            raise ValueError("dpool must be a dense channels-last tensor")
    if act not in ACTIVATIONS:
        raise ValueError(f"the U-Net epilogue has no activation {act!r}")
    sms = ops._sm_count(out.device)
    dz = torch.empty(out.shape, dtype=out.dtype, device=out.device,
                     memory_format=torch.channels_last)
    # A row of bias sums a block: the kernel's grid takes at most 8 blocks
    # an SM.
    partials = torch.empty(8 * sms, c, dtype=torch.float32,
                           device=out.device)
    dbias = torch.empty(c, dtype=torch.float32, device=out.device)
    ops._launch("unet_epilogue_backward",
                ops._load().sbmc_unet_epilogue_backward, out.device,
                dy.data_ptr(), dy.stride(3), out.data_ptr(), out.stride(3),
                None if dpool is None else dpool.data_ptr(), ACTIVATIONS[act],
                dz.data_ptr(), partials.data_ptr(), partials.shape[0],
                dbias.data_ptr(), bs, h, w, c, sms)
    return dz, dbias


def upsample_backward(g, size):
    """The upsample's backward (arguments and result as
    :func:`upsample_backward_ref`): the kernel for CUDA tensors (``g`` a
    channels-last tensor or slot at least twice ``size``, as the U-Net's
    skips are; the result dense channels-last), the plain version for CPU
    ones."""
    if ops._on_cpu(g):
        return upsample_backward_ref(g, size)
    bs, c, ho, wo = g.shape
    hi, wi = size
    _check("g", g)
    if 2 * hi > ho or 2 * wi > wo:
        raise ValueError(f"the upsample kernel at least doubles: {hi}x{wi} "
                         f"to {ho}x{wo}")
    dx = torch.empty(bs, c, hi, wi, dtype=g.dtype, device=g.device,
                     memory_format=torch.channels_last)
    ops._launch("unet_upsample_backward",
                ops._load().sbmc_unet_upsample_backward, g.device,
                g.data_ptr(), g.stride(3), dx.data_ptr(), bs, hi, wi, ho, wo,
                c)
    return dx
