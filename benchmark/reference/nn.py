"""Layers of the reference: weight-normalised convolutions, conv chains,
the U-Net, kernel application and the progressive splat, in float32.

Conventions follow the published models (Gharbi et al. 2019, Bako et al.
2017) as the JAX system defines them:

- a weight-normalised convolution's kernel is ``w = v * g / (||v|| +
  1e-12)``, the norm over each output channel;
- a chain is ``depth - 1`` convolutions each followed by its activation,
  then an output convolution and the output activation (none for
  ``linear``);
- kernels are ``k * k`` taps, tap ``i`` at offset ``(i // k - o, i % k -
  o)`` with ``o = (k - 1) // 2``; a gather kernel at pixel ``p`` weighs
  ``data[p + offset]``, zero outside the image; a splat kernel at ``p``
  sends ``data[p]`` to ``p + offset``, and its gather form at ``q`` reads
  the logit of source ``q - offset`` at that tap, 0 where the source lies
  outside the image (the logit counts in the softmax, its data is 0).
"""

import math

import torch
import torch.nn.functional as F

__all__ = ["fp8", "bf16", "chain_leaves", "conv", "chain", "unet",
           "gather_apply", "splat_frame"]

_GAIN = {"relu": math.sqrt(2.0), "leaky_relu": math.sqrt(2.0 / 1.0001),
         "linear": 1.0}

_FP8_MAX = 448.0


def _round(x, dtype, fmax=None):
    """``x`` in ``dtype`` and back; with ``fmax``, scaled first so that its
    absolute maximum maps to ``fmax`` (one scale for the tensor)."""
    if fmax is None:
        return x.to(dtype).float()
    s = x.abs().amax().clamp(min=1e-30) / fmax
    return (x / s).to(dtype).float() * s


class _Rounded(torch.autograd.Function):
    """Rounds a value on the way in and its gradient on the way back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def fp8(x):
    """``x`` in float8 e4m3, its gradient in float8 e5m2, each with one
    scale for the tensor (the formats' largest values, 448 and 57344, at
    its absolute maximum), as float8 training rounds them."""
    return _Rounded.apply(
        x.float(), lambda t: _round(t, torch.float8_e4m3fn, _FP8_MAX),
        lambda t: _round(t, torch.float8_e5m2, 57344.0))


def bf16(x):
    """``x`` and its gradient rounded to bfloat16: the configuration's own
    rounding, emulated."""
    return _Rounded.apply(x.float(), _BF16, _BF16)


def _BF16(t):
    return _round(t, torch.bfloat16)


def _id(x):
    return x.float()


def chain_leaves(name, cin, cout, width, depth, k, act, out_act,
                 weight_norm=True):
    """The leaves ``(name, shape, gain, kind)`` of a chain of ``depth``
    ``k x k`` convolutions (:func:`chain`), ``width`` wide inside."""
    out = []
    for d in range(depth):
        last = d == depth - 1
        lname = "%s.%s" % (name, "out" if last else "conv%d" % d)
        co = cout if last else width
        out.append((lname + ".w", (co, cin, k, k),
                    _GAIN[out_act if last else act], "w"))
        if weight_norm:
            out.append((lname + ".g", (co,), 1.0, "g"))
        out.append((lname + ".b", (co,), 1.0, "b"))
        cin = co
    return out


def weight(p, name, weight_norm=True):
    """The convolution kernel of layer ``name``."""
    v = p[name + ".w"]
    if not weight_norm:
        return v
    norm = v.flatten(1).norm(dim=1) + 1e-12
    return v * (p[name + ".g"] / norm)[:, None, None, None]


def conv(x, p, name, same=True, weight_norm=True, q=None):
    """Stride-1 convolution, ``same`` zero padding or valid."""
    q = q or _id
    w = weight(p, name, weight_norm)
    k = w.shape[-1]
    y = F.conv2d(q(x), q(w), padding=(k - 1) // 2 if same else 0)
    return y + p[name + ".b"][:, None, None]


ACTIVATIONS = {
    "relu": torch.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "linear": lambda x: x,
}


def chain(x, p, name, depth, act="relu", out_act="linear", same=True,
          weight_norm=True, q=None):
    """``depth`` convolutions ``name.conv0 ... name.out``."""
    for d in range(depth - 1):
        x = ACTIVATIONS[act](conv(x, p, "%s.conv%d" % (name, d), same,
                                  weight_norm, q))
    return ACTIVATIONS[out_act](conv(x, p, name + ".out", same, weight_norm,
                                     q))


def unet(x, p, name, levels, convs, out_act, q=None):
    """U-Net: a chain a level, 2x2 max pooling (floor) between levels,
    bilinear upsampling (half-pixel centres) back to the skip's size and
    ``[upsampled, skip]`` concatenated before each upward chain."""
    skips = []
    for lvl in range(levels):
        x = chain(x, p, "%s.down%d" % (name, lvl), convs, "relu", "relu",
                  q=q)
        if lvl < levels - 1:
            skips.append(x)
            x = F.max_pool2d(x, 2)
    for lvl in range(levels - 2, -1, -1):
        up = F.interpolate(x, size=skips[lvl].shape[-2:], mode="bilinear",
                           align_corners=False)
        x = chain(torch.cat([up, skips[lvl]], 1), p, "%s.up%d" % (name, lvl),
                  convs, "relu", out_act if lvl == 0 else "relu", q=q)
    return x


def _shifted(t, k):
    """Yield ``(i, view)``: ``t`` zero-padded by ``o`` and cut at tap ``i``'s
    offset, so ``view[..., y, x] = t[..., y + dy - o, x + dx - o]``."""
    h, w = t.shape[-2:]
    o = (k - 1) // 2
    tp = F.pad(t, (o, o, o, o))
    for i in range(k * k):
        dy, dx = divmod(i, k)
        yield i, tp[..., dy:dy + h, dx:dx + w]


def _weigh(data, weights, k):
    """``sum_i weights[:, i] * data shifted by tap i``."""
    out = torch.zeros_like(data)
    for i, d in _shifted(data, k):
        out = torch.addcmul(out, weights[:, i:i + 1], d)
    return out


def gather_apply(data, logits, k):
    """Softmax over the taps of gather logits, then the weighted sum of the
    shifted data: ``[bs, c, h, w]``."""
    return _weigh(data, torch.softmax(logits, dim=1), k)


def _gather_form(logits, k):
    """Splat logits ``[bs, k*k, h, w]`` in gather form: tap ``i`` at ``q``
    reads tap ``k*k - 1 - i`` of the source ``q + offset_i``."""
    flipped = logits.flip(1)
    return torch.stack([v[:, i] for i, v in _shifted(flipped, k)], dim=1)


def splat_frame(data, logits, k, valid=None, eps=1e-8):
    """Sample-based splatting: every valid sample's kernels over every tap,
    normalised by one softmax per output pixel over all of them.

    Args:
      data: ``[bs, spp, c, h, w]`` radiance.
      logits: list of ``spp`` tensors ``[bs, k*k, h, w]``, splat logits.
      valid: optional ``[bs, spp]`` bool; an invalid sample takes no part.

    Returns ``sum_r / (sum_w + eps)``, ``[bs, c, h, w]``.
    """
    gathered = [_gather_form(l.float(), k) for l in logits]
    neg = torch.finfo(torch.float32).min
    m = None
    for s, g in enumerate(gathered):
        gm = g.amax(dim=1, keepdim=True)
        if valid is not None:
            gm = torch.where(valid[:, s, None, None, None], gm, neg)
        m = gm if m is None else torch.maximum(m, gm)
    sum_r = torch.zeros_like(data[:, 0])
    sum_w = torch.zeros_like(m)
    for s, g in enumerate(gathered):
        e = torch.exp(g - m)
        if valid is not None:
            e = e * valid[:, s, None, None, None]
        sum_w = sum_w + e.sum(dim=1, keepdim=True)
        sum_r = sum_r + _weigh(data[:, s], e, k)
    return sum_r / (sum_w + eps)
