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

On the card a model takes its hand-written kernels where
:func:`kernel_path` says so, on :class:`WNConv2D`'s ``inference_weight``
and ``inference_bias``: at inference, and for an ``Autoencoder``, whose
kernels have a backward, in training too. An ``Autoencoder`` then runs
channels-last (:meth:`Autoencoder.forward_channels_last`): cuDNN's
convolutions without their bias, and the hand-written epilogue, upsample
and layout kernels of :mod:`sbmc_tpu_torch.nn.unet` around them, with the
NCHW rounding; under gradients inside one autograd Function whose backward
runs the kernels' backward around cuDNN's NHWC dgrad and wgrad.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from sbmc_tpu_torch.nn import unet

__all__ = ["WNConv2D", "ConvChain", "Autoencoder", "dtype_of",
           "kernel_path"]


def dtype_of(name):
    """Resolve an optional dtype name ("bfloat16", "float32", ...) or
    ``torch.dtype`` to a ``torch.dtype`` (None stays None)."""
    if name is None or isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def kernel_path(module, x):
    """Whether ``module``'s forward on ``x`` takes its hand-written kernels:
    gradients off, or kernels that have a backward
    (``module.kernels_backward``); ``x`` on the card; bf16 convs
    (``module.conv_dtype``); and an architecture the kernels hold
    (``module.kernels_fit``, read last: ``Multisteps`` asks the kernels'
    CUDA build). Otherwise the plain modules run."""
    return ((not torch.is_grad_enabled() or module.kernels_backward)
            and x.is_cuda and module.conv_dtype == torch.bfloat16
            and module.kernels_fit)


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


def _padded(t, dtype, sizes, memory_format=torch.contiguous_format):
    """``t`` rounded to ``dtype``, zeros appended to its leading dimensions
    up to ``sizes`` (None: none)."""
    lead = t.shape[:len(sizes)]
    out = torch.empty(tuple(n or m for n, m in zip(sizes, lead))
                      + t.shape[len(sizes):], dtype=dtype, device=t.device,
                      memory_format=memory_format)
    if out.shape != t.shape:
        out.zero_()
    out[tuple(slice(m) for m in lead)] = t
    return out


class WNConv2D(nn.Module):
    """2D convolution with optional weight normalisation, stride 1, NCHW;
    "same" padding with ``pad``, else a valid convolution that shrinks the
    image by ``ksize - 1``.

    Parameters: ``v`` ``[out, in, k, k]``, ``g`` ``[out]`` (only with
    ``weight_norm``) and ``bias`` ``[out]``, all float32; without weight
    normalisation ``v`` is the kernel itself. ``dtype`` is the compute
    dtype (None: the input's).
    """

    def __init__(self, in_features, features, ksize,
                 init_gain_nonlinearity="linear", dtype=None, pad=True,
                 weight_norm=True):
        super().__init__()
        self.ksize = ksize
        self.dtype = dtype
        self.pad = pad
        self.weight_norm = weight_norm
        v = torch.empty(features, in_features, ksize, ksize)
        nn.init.xavier_uniform_(v, gain=_gain(init_gain_nonlinearity))
        self.v = nn.Parameter(v)
        if weight_norm:
            self.g = nn.Parameter(v.flatten(1).norm(dim=1))
        self.bias = nn.Parameter(torch.zeros(features))

    def weight(self):
        if not self.weight_norm:
            return self.v
        norm = self.v.flatten(1).norm(dim=1) + 1e-12
        return self.v * (self.g / norm)[:, None, None, None]

    def forward(self, x):
        kernel = self.weight()
        if self.dtype is not None:
            x = x.to(self.dtype)
            kernel = kernel.to(self.dtype)
        y = F.conv2d(x, kernel, padding=self.padding)
        return y + self.bias.to(y.dtype)[:, None, None]

    def inference_weight(self, dtype, cin=None, cout=None,
                         memory_format=torch.contiguous_format):
        """The normalised weight for the inference kernels, made each call
        (so it always follows the parameters): rounded to ``dtype``, with
        zero output channels up to ``cout`` and zero input channels up to
        ``cin`` (None: none added), in ``memory_format``."""
        return _padded(self.weight(), dtype, (cout, cin), memory_format)

    def inference_bias(self, dtype, cout):
        """The bias as :meth:`inference_weight` makes the weight, with zero
        channels up to ``cout``."""
        return _padded(self.bias, dtype, (cout,))

    @property
    def padding(self):
        """The convolution's padding: "same" with ``pad``, else none."""
        return (self.ksize - 1) // 2 if self.pad else 0

    def conv_channels_last(self, x, cin, cout, kernel=None):
        """The convolution without its bias on a channels-last ``x`` of
        ``cin`` channels already in the compute dtype, to ``cout`` output
        channels (the zero ones beyond the layer's on either side), the
        weight laid out channels-last too (so cuDNN runs its NHWC kernels
        with no layout change around them; ``kernel``: that weight, made
        here if None); the product is rounded to ``x``'s dtype, as in
        :meth:`forward`. An ``x`` of another width is refused by the
        convolution."""
        if kernel is None:
            kernel = self.inference_weight(x.dtype, cin, cout,
                                           torch.channels_last)
        return F.conv2d(x, kernel, padding=self.padding)

    def forward_channels_last(self, x, act, cin, cout, out=None,
                              pool=None, kernel=None, bias=None):
        """One layer of a chain without autograd, channels-last:
        :meth:`conv_channels_last`, then its bias and activation ``act``
        (:func:`sbmc_tpu_torch.nn.unet.epilogue`, in place, or into ``out``
        with the 2x2 max-pool into ``pool`` if given). ``kernel`` and
        ``bias``: the weight and bias to use (made here if None). Returns
        the output."""
        if bias is None:
            bias = self.inference_bias(x.dtype, cout)
        return unet.epilogue(self.conv_channels_last(x, cin, cout, kernel),
                             bias, act, out, pool)


class ConvChain(nn.Module):
    """``depth - 1`` conv + activation blocks at ``width`` channels, then a
    prediction conv to ``noutputs`` channels with ``output_type`` applied
    unless it is linear; all layers share ``ksize``, ``pad`` and
    ``weight_norm``. Module names follow the flax keys (``layer_0``, ...,
    ``prediction``)."""

    def __init__(self, in_features, noutputs, ksize=3, width=64, depth=3,
                 output_type="linear", activation="relu", dtype=None,
                 pad=True, weight_norm=True):
        super().__init__()
        if depth <= 0:
            raise ValueError("negative network depth.")
        if activation not in ("relu", "leaky_relu", "tanh", "elu"):
            raise ValueError("activation should be one of: "
                             "relu, leaky_relu, tanh, elu")
        self.depth = depth
        self.activation = activation
        self.output_type = output_type
        self.act = _activation(activation)
        self.out_act = (None if output_type == "linear"
                        else _activation(output_type))
        cin = in_features
        for d in range(depth - 1):
            self.add_module(f"layer_{d}", WNConv2D(
                cin, width, ksize, init_gain_nonlinearity=activation,
                dtype=dtype, pad=pad, weight_norm=weight_norm))
            cin = width
        out_gain = "relu" if output_type in ("elu", "softplus") \
            else output_type
        self.prediction = WNConv2D(
            cin, noutputs, ksize, init_gain_nonlinearity=out_gain,
            dtype=dtype, pad=pad, weight_norm=weight_norm)

    def forward(self, x):
        for d in range(self.depth - 1):
            x = self.act(getattr(self, f"layer_{d}")(x))
        x = self.prediction(x)
        return x if self.out_act is None else self.out_act(x)

    def layers(self):
        """The convolutions in order: ``layer_0``, ..., ``prediction``."""
        return ([getattr(self, f"layer_{d}") for d in range(self.depth - 1)]
                + [self.prediction])

    def activations(self):
        """Each convolution's activation, in order."""
        return [self.activation] * (self.depth - 1) + [self.output_type]

    def forward_channels_last(self, x, out=None, pool=None, params=None,
                              saved=None):
        """The chain without autograd on a channels-last ``x`` in the
        compute dtype, one :meth:`WNConv2D.forward_channels_last` a layer;
        the last writes into ``out`` (a channels-last tensor or channel
        slot) if given, and its 2x2 max-pool into ``pool`` if given.
        ``params``: each layer's ``(kernel, bias)`` in order (made by the
        layers if None); ``saved``: a list to which each layer's input and
        output are appended. Returns the output."""
        layers = self.layers()
        for i, (layer, act) in enumerate(zip(layers, self.activations())):
            last = i == len(layers) - 1
            kernel, bias = (None, None) if params is None else params[i]
            y = layer.forward_channels_last(
                x, act, layer.v.shape[1], layer.v.shape[0],
                out if last else None, pool if last else None, kernel, bias)
            if saved is not None:
                saved += [x, y]
            x = y
        return x


class Autoencoder(nn.Module):
    """U-Net style autoencoder, NCHW, with max pooling.

    ``num_levels`` scales; each level runs a left ``ConvChain``, max-pools
    by 2 (odd sizes floor), recurses, bilinearly upsamples the coarse result
    to the skip's exact size, concatenates ``[upsampled, skip]`` and runs a
    right ``ConvChain``. Width grows by ``increase_factor`` per level,
    capped at ``max_width``.

    Where :func:`kernel_path` says so (``kernels_fit``: every channel count
    a multiple of 8, activations the epilogue applies; with or without
    gradients: ``kernels_backward``), :meth:`forward` runs
    :meth:`forward_channels_last`, which launches the epilogue kernel once a
    convolution, the upsample kernel once a level below the top and the
    layout kernel on each side; its backward launches the epilogue's and
    the upsample's backward as often, and the layout kernel on each side.
    """

    #: The channels-last kernels have a backward (:class:`_ChannelsLastUNet`).
    kernels_backward = True

    def __init__(self, in_features, noutputs, ksize=3, width=64,
                 num_levels=3, num_convs=2, max_width=512,
                 increase_factor=1.0, output_type="linear",
                 activation="relu", dtype=None):
        super().__init__()
        self.num_levels = num_levels
        self.conv_dtype = dtype

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
        convs = [m for m in self.modules() if isinstance(m, WNConv2D)]
        chains = [m for m in self.modules() if isinstance(m, ConvChain)]
        self.kernels_fit = (
            all(c.pad and c.v.shape[0] % 8 == 0 and c.v.shape[1] % 8 == 0
                for c in convs)
            and all(c.activation in unet.ACTIVATIONS
                    and c.output_type in unet.ACTIVATIONS for c in chains))

    def forward(self, x):
        if kernel_path(self, x):
            return self.forward_channels_last(x)
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

    def chains(self):
        """The chains in the order :meth:`forward` runs them: ``left_0``,
        ..., then ``right_{num_levels - 2}``, ..., ``right_0``."""
        return ([getattr(self, f"left_{lvl}")
                 for lvl in range(self.num_levels)]
                + [getattr(self, f"right_{lvl}")
                   for lvl in range(self.num_levels - 2, -1, -1)])

    def forward_channels_last(self, x):
        """:meth:`forward` channels-last inside: the input ``[bs, c, h, w]``
        is laid out channels-last once, each level's last left convolution
        writes its skip into the channel slot ``[c_up:]`` of a channels-last
        concatenation buffer and its max-pool as the next level's input, the
        coarse result is upsampled into the slot ``[:c_up]``, and the right
        chain reads the buffer whole. The output is laid out NCHW once. The
        same arithmetic and roundings as :meth:`forward`, up to the order of
        the convolutions' sums.

        Under gradients it runs inside one autograd Function
        (:class:`_ChannelsLastUNet`) on the weights made here in stock
        autograd (``WNConv2D.inference_weight``: normalised, cast and laid
        out channels-last) and the float32 biases, so gradients reach ``v``,
        ``g`` and ``bias`` as through :meth:`forward`."""
        x = x.to(self.conv_dtype or x.dtype)
        if not torch.is_grad_enabled():
            return self._channels_last(x)
        convs = [layer for chain in self.chains() for layer in chain.layers()]
        kernels = [layer.inference_weight(x.dtype,
                                          memory_format=torch.channels_last)
                   for layer in convs]
        return _ChannelsLastUNet.apply(self, x, *kernels,
                                       *[layer.bias for layer in convs])

    def _channels_last(self, x, params=None, saved=None):
        """:meth:`forward_channels_last`'s dataflow on ``x`` in the compute
        dtype, without autograd. ``params``: each convolution's ``(kernel,
        bias)`` in :meth:`chains` order (made by the layers if None);
        ``saved``: a list to which each convolution's input and output
        (channels-last; a skip is its slot of the concatenation buffer) are
        appended in that order."""
        cl = torch.channels_last
        params = None if params is None else iter(params)

        def run(chain, x, out=None, pool=None):
            p = None if params is None else [next(params)
                                             for _ in chain.layers()]
            return chain.forward_channels_last(x, out, pool, p, saved)

        x = unet.relayout(x, channels_last=True)
        cats = []
        for lvl in range(self.num_levels):
            left = getattr(self, f"left_{lvl}")
            if lvl == self.num_levels - 1:
                x = run(left, x)
                break
            bs, _, h, w = x.shape
            c_skip = left.prediction.v.shape[0]
            c_cat = getattr(self, f"right_{lvl}").layer_0.v.shape[1]
            cats.append(torch.empty(bs, c_cat, h, w, dtype=x.dtype,
                                    device=x.device, memory_format=cl))
            pooled = torch.empty(bs, c_skip, h // 2, w // 2, dtype=x.dtype,
                                 device=x.device, memory_format=cl)
            run(left, x, cats[-1][:, c_cat - c_skip:], pooled)
            x = pooled
        for lvl in range(self.num_levels - 2, -1, -1):
            unet.upsample(x, cats[-1][:, :x.shape[1]])
            x = run(getattr(self, f"right_{lvl}"), cats.pop())
        return unet.relayout(x, channels_last=False)

    def _backward_channels_last(self, dout, kernels, io, needs):
        """The backward of :meth:`_channels_last` from the output's gradient
        ``dout`` (NCHW): ``kernels`` and ``io`` (each convolution's input
        and output, as ``saved`` holds them) in :meth:`chains` order;
        ``needs``: whether the input, each kernel and each bias want a
        gradient. Each convolution from the last: the epilogue's backward
        (``unet.epilogue_backward``; a level's last left convolution with
        its pool's gradient), then cuDNN's dgrad and wgrad on the
        channels-last tensors; a right chain's input gradient is the
        concatenation buffer's, whose upsampled slot goes through
        ``unet.upsample_backward`` to the chain below and whose skip slot
        waits for the left chain. Returns the input's gradient (NCHW, None
        if not wanted) and each kernel's and bias's."""
        n = len(kernels)
        need_x, need_k = needs[0], needs[1:1 + n]
        dk, db = [None] * n, [None] * n
        k = n

        def chain_backward(chain, g, dpool=None):
            nonlocal k
            layers, acts = chain.layers(), chain.activations()
            for i in range(len(layers) - 1, -1, -1):
                k -= 1
                x, y = io[2 * k], io[2 * k + 1]
                dz, db[k] = unet.epilogue_backward(
                    g, y, acts[i], dpool if i == len(layers) - 1 else None)
                p = layers[i].padding
                g, dk[k], _ = torch.ops.aten.convolution_backward(
                    dz, x, kernels[k], None, [1, 1], [p, p], [1, 1], False,
                    [0, 0], 1, [k > 0 or need_x, need_k[k], False])
            return g

        g = unet.relayout(dout.contiguous(), channels_last=True)
        dcats = []
        for lvl in range(self.num_levels - 1):
            dcat = chain_backward(getattr(self, f"right_{lvl}"), g)
            dcats.append(dcat)
            c_skip = getattr(self, f"left_{lvl}").prediction.v.shape[0]
            g = unet.upsample_backward(
                dcat[:, :dcat.shape[1] - c_skip],
                (dcat.shape[2] // 2, dcat.shape[3] // 2))
        g = chain_backward(getattr(self, f"left_{self.num_levels - 1}"), g)
        for lvl in range(self.num_levels - 2, -1, -1):
            dcat = dcats.pop()
            c_skip = getattr(self, f"left_{lvl}").prediction.v.shape[0]
            g = chain_backward(getattr(self, f"left_{lvl}"),
                               dcat[:, dcat.shape[1] - c_skip:], dpool=g)
        dx = unet.relayout(g, channels_last=False) if need_x else None
        return dx, dk, db


class _ChannelsLastUNet(torch.autograd.Function):
    """:meth:`Autoencoder.forward_channels_last` under gradients: ``apply(ae,
    x, *kernels, *biases)`` (one kernel and bias a convolution, in
    ``ae.chains()`` order). The forward runs ``ae._channels_last`` and saves
    each convolution's input and output, nothing else: the activations'
    derivatives follow from the outputs' signs and each max-pool's argmax
    is recomputed from its saved skip. The backward is
    ``ae._backward_channels_last``."""

    @staticmethod
    def forward(ctx, ae, x, *params):
        n = len(params) // 2
        kernels = [k.detach() for k in params[:n]]
        saved = [] if any(ctx.needs_input_grad) else None
        out = ae._channels_last(
            x.detach(), list(zip(kernels, (b.detach() for b in params[n:]))),
            saved)
        if saved is not None:
            ctx.ae = ae
            ctx.save_for_backward(*kernels, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        tensors = ctx.saved_tensors
        n = (len(ctx.needs_input_grad) - 2) // 2
        dx, dk, db = ctx.ae._backward_channels_last(
            dout, tensors[:n], tensors[n:], ctx.needs_input_grad[1:])
        return (None, dx, *dk, *db)
