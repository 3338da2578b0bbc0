"""Core NN building blocks (counterpart of ``sbmc_tpu/nn/layers.py``).

NCHW ``nn.Module``s whose parameters and names follow the flax modules, so
a JAX checkpoint maps onto them leaf by leaf (see
:mod:`sbmc_tpu_torch.params`):

- weight normalisation is the JAX package's own formula
  ``w = v * g / (||v|| + 1e-12)``, the norm taken per output channel
  (``torch.nn.utils.weight_norm`` has no epsilon);
- with ``dtype=torch.bfloat16`` the convolution runs in bf16 and the
  activations stay bf16 across the chain; the bias is added after the
  product is rounded to the compute dtype, as in the JAX package;
- initialisation reproduces torch's ``xavier_uniform_`` with
  ``calculate_gain`` (the weights are overwritten when a checkpoint loads).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["WNConv2D", "ConvChain", "Autoencoder"]


def _gain(nonlinearity):
    """torch.nn.init.calculate_gain, as the JAX package reproduces it."""
    if nonlinearity in ("linear", "sigmoid", "softplus"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3.0
    if nonlinearity in ("relu", "elu"):
        # The reference initialises elu layers with the relu gain.
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1.0 + 0.01 ** 2))
    raise ValueError(f"no gain for nonlinearity {nonlinearity!r}")


def _activation(name):
    if name == "relu":
        return F.relu
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, 0.01)
    if name == "tanh":
        return torch.tanh
    if name == "elu":
        return F.elu
    if name == "sigmoid":
        return torch.sigmoid
    if name == "softplus":
        return F.softplus
    raise ValueError(f"unknown activation {name!r}")


class WNConv2D(nn.Module):
    """Weight-normalised 2D convolution with stride 1 and "same" padding
    (the only geometry the SBMC model uses), NCHW.

    Parameters: ``v`` ``[out, in, k, k]``, ``g`` ``[out]`` and ``bias``
    ``[out]``, all float32. ``dtype`` is the compute dtype (None: the
    input's).
    """

    def __init__(self, in_features, features, ksize,
                 init_gain_nonlinearity="linear", dtype=None):
        super().__init__()
        self.ksize = ksize
        self.dtype = dtype
        v = torch.empty(features, in_features, ksize, ksize)
        nn.init.xavier_uniform_(v, gain=_gain(init_gain_nonlinearity))
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(v.flatten(1).norm(dim=1))
        self.bias = nn.Parameter(torch.zeros(features))

    def weight(self):
        norm = self.v.flatten(1).norm(dim=1) + 1e-12
        return self.v * (self.g / norm)[:, None, None, None]

    def forward(self, x):
        kernel = self.weight()
        if self.dtype is not None:
            x = x.to(self.dtype)
            kernel = kernel.to(self.dtype)
        y = F.conv2d(x, kernel, padding=(self.ksize - 1) // 2)
        return y + self.bias.to(y.dtype)[:, None, None]


class ConvChain(nn.Module):
    """``depth - 1`` conv + activation blocks at ``width`` channels, then a
    prediction conv to ``noutputs`` channels with ``output_type`` applied
    unless it is linear. Module names follow the flax keys (``layer_0``,
    ..., ``prediction``)."""

    def __init__(self, in_features, noutputs, ksize=3, width=64, depth=3,
                 output_type="linear", activation="relu", dtype=None):
        super().__init__()
        if depth <= 0:
            raise ValueError("negative network depth.")
        if activation not in ("relu", "leaky_relu", "tanh", "elu"):
            raise ValueError("activation should be one of: "
                             "relu, leaky_relu, tanh, elu")
        self.depth = depth
        self.act = _activation(activation)
        self.out_act = (None if output_type == "linear"
                        else _activation(output_type))
        cin = in_features
        for d in range(depth - 1):
            self.add_module(f"layer_{d}", WNConv2D(
                cin, width, ksize, init_gain_nonlinearity=activation,
                dtype=dtype))
            cin = width
        out_gain = "relu" if output_type in ("elu", "softplus") \
            else output_type
        self.prediction = WNConv2D(
            cin, noutputs, ksize, init_gain_nonlinearity=out_gain,
            dtype=dtype)

    def forward(self, x):
        for d in range(self.depth - 1):
            x = self.act(getattr(self, f"layer_{d}")(x))
        x = self.prediction(x)
        return x if self.out_act is None else self.out_act(x)


class Autoencoder(nn.Module):
    """U-Net style autoencoder, NCHW, with max pooling.

    ``num_levels`` scales; each level runs a left ``ConvChain``, max-pools
    by 2 (odd sizes floor), recurses, bilinearly upsamples the coarse result
    to the skip's exact size, concatenates ``[upsampled, skip]`` and runs a
    right ``ConvChain``. Width grows by ``increase_factor`` per level,
    capped at ``max_width``.
    """

    def __init__(self, in_features, noutputs, ksize=3, width=64,
                 num_levels=3, num_convs=2, max_width=512,
                 increase_factor=1.0, output_type="linear",
                 activation="relu", dtype=None):
        super().__init__()
        self.num_levels = num_levels

        def width_of(lvl):
            return min(int(width * increase_factor ** lvl), max_width)

        def chain(cin, n_out, w, o_type):
            return ConvChain(cin, n_out, ksize=ksize, width=w,
                             depth=num_convs, output_type=o_type,
                             activation=activation, dtype=dtype)

        cin = in_features
        for lvl in range(num_levels):
            w = width_of(lvl)
            last = lvl == num_levels - 1 and lvl == 0
            self.add_module(f"left_{lvl}", chain(
                cin, noutputs if last else w, w,
                output_type if last else activation))
            cin = noutputs if last else w
        for lvl in range(num_levels - 2, -1, -1):
            w = width_of(lvl)
            self.add_module(f"right_{lvl}", chain(
                cin + w, noutputs if lvl == 0 else w, w,
                output_type if lvl == 0 else activation))
            cin = noutputs if lvl == 0 else w

    def forward(self, x):
        skips = []
        for lvl in range(self.num_levels):
            x = getattr(self, f"left_{lvl}")(x)
            if lvl < self.num_levels - 1:
                skips.append(x)
                x = F.max_pool2d(x, 2)
        for lvl in range(self.num_levels - 2, -1, -1):
            left = skips[lvl]
            us = F.interpolate(x, size=left.shape[-2:], mode="bilinear",
                               align_corners=False)
            x = getattr(self, f"right_{lvl}")(torch.cat([us, left], dim=1))
        return x
