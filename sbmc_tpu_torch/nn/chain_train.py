"""SBMC's per-sample 1x1 chains in the train step, on pixel-major matrices.

Under gradients, on the card, with bf16 convs
(:func:`~sbmc_tpu_torch.nn.layers.kernel_path`),
:class:`~sbmc_tpu_torch.models.multisteps.Multisteps` runs its embedding
steps and its kernel regressor on matrices with a row a sample and pixel,
``[spp, bs, h * w, channels]``, instead of NCHW tensors:

- :func:`entry` lays the features out so once a call: cast to bf16, the
  global features appended to every row (the first product's input, as
  ``cat([features, global features])`` rounds it), zeros up to a multiple
  of 8 channels;
- each 1x1 layer is one cuBLAS product on the matrices; after it one
  epilogue pass applies the bias and the activation: :func:`epilogue` (the
  per-sample epilogue, for a layer with a per-pixel term or the masked
  mean over the samples) or :func:`sbmc_tpu_torch.nn.unet.epilogue` (the
  U-Net's, on the matrix as a channels-last tensor) for the others;
- the first layer of an embedding step after the first, and of the
  regressor, reads ``cat([feats, extra])`` where ``extra`` (the U-Net's
  output) is the same for every sample of a pixel: its product splits as
  ``W_f . feats + W_e . extra``, the second computed once a pixel, both in
  float32, and added in the epilogue before the one rounding the
  convolution makes;
- the regressor runs over all samples at once; cuBLAS writes its last
  product as each sample's ``[bs, k2, h, w]`` logits, the layout the splat
  reads, and :func:`logits` adds the bias and the ±3e4 clamp in place.

Each embedding step and the regressor is one ``torch.autograd.Function``
(:class:`_EmbeddingStep`, :class:`_Regressor`). Their backward is cuBLAS's
products for the inputs' and weights' gradients around the epilogues'
backward (:func:`epilogue_backward`, :func:`logits_backward`,
``unet.epilogue_backward``): the activation's derivative from the saved
output, the bias gradient as float32 partial sums in a fixed order, the
mean's gradient broadcast back to every sample, and the split layer's
per-pixel gradient summed over the samples in float32 and rounded once
before its two products (where the NCHW modules round each sample's
product of ``W_e`` first). The weights are made once a call in stock
autograd outside the Functions (``WNConv2D.inference_weight``: normalised
and rounded to the compute dtype), so the gradients reach ``v``, ``g`` and
``bias`` as through the NCHW modules.

For CUDA tensors each pass is one launch of a hand-written kernel
(``ops/csrc/chain_train.cu``: ``chain_entry``, ``chain_epilogue``,
``chain_epilogue_backward``, ``chain_logits``, ``chain_logits_backward``),
counted in ``ops.launch_counts``: bf16 only, channel counts a multiple of
8, no autograd of their own. For CPU tensors the plain versions run
(:func:`entry_ref`, :func:`epilogue_ref`, :func:`epilogue_backward_ref`,
:func:`logits_ref`, :func:`logits_backward_ref`), in any dtype, so the
Functions' dataflow runs on the CPU too.
"""

import torch

from sbmc_tpu_torch import ops
from sbmc_tpu_torch.nn import unet

__all__ = ["CLAMP", "MAX_ENTRY", "pad8", "entry", "entry_ref", "epilogue",
           "epilogue_ref", "epilogue_backward", "epilogue_backward_ref",
           "logits", "logits_ref", "logits_backward", "logits_backward_ref",
           "embedding_step", "regress"]

#: The regressor's logit clamp (``sample_chain.regress_ref``).
CLAMP = 3e4
#: The widest row (features and global features, padded) the entry lays
#: out.
MAX_ENTRY = 256
_BF16 = torch.bfloat16
_ENTRY_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def pad8(n):
    """``n`` rounded up to a multiple of 8."""
    return -(-n // 8) * 8


def _limit(dtype, lim=CLAMP):
    """The clamp's bound as ``Tensor.clamp`` applies it to ``dtype``."""
    return float(torch.tensor(lim, dtype=dtype))


# --- Plain versions ----------------------------------------------------------


def entry_ref(features, gf, k, dtype):
    """The plain entry: ``features`` ``[bs, spp, cf, h, w]`` and the global
    features ``gf`` ``[bs, cg]`` (None: none) as the pixel-major matrix
    ``[spp, bs, h * w, k]`` in ``dtype``: each row the pixel's features,
    then its batch item's global features, then zeros."""
    bs, spp, cf, h, w = features.shape
    x = features.to(dtype).permute(1, 0, 3, 4, 2).reshape(spp, bs, h * w, cf)
    out = x.new_zeros(spp, bs, h * w, k)
    out[..., :cf] = x
    if gf is not None:
        out[..., cf:cf + gf.shape[1]] = gf.to(dtype)[None, :, None, :]
    return out


def epilogue_ref(z, bias, act, dtype, e=None, mask=None, nvalid=None):
    """The plain per-sample epilogue of one layer's product ``z`` ``[spp,
    bs, hw, c]`` (in ``dtype``, or float32 with ``e``): ``act(y + bias)``
    with ``y = z + e`` rounded once to ``dtype`` (``e`` ``[bs, hw, c]``
    float32, the per-pixel term of a split layer, or None), as
    ``WNConv2D.forward`` and ``ConvChain`` round it. With ``mask`` (``[bs,
    spp]`` sample validity) and ``nvalid`` (``[bs]``, at least 1) also the
    masked mean over the samples, as ``embedding_step_ref`` rounds it.
    Returns ``(out, reduced)`` (``reduced`` ``[bs, hw, c]`` or None)."""
    y = (z if e is None else z + e).to(dtype)
    out = unet.activate(act, y + bias.to(dtype))
    reduced = None
    if mask is not None:
        m = mask.to(dtype).t()[:, :, None, None]
        reduced = (out * m).sum(0) / nvalid.to(dtype)[:, None, None]
    return out, reduced


def epilogue_backward_ref(dy, out, act, dred=None, mask=None, nvalid=None,
                          sum_samples=False):
    """The plain backward of :func:`epilogue_ref`, as autograd computes it:
    from ``dy`` (the gradient of ``out``, ``[spp, bs, hw, c]``) and, with
    ``dred`` (``[bs, hw, c]``), the mean's gradient joined to each sample's
    (``mask`` and ``nvalid`` as the forward's), through the activation's
    derivative read from ``out``'s sign (None for "linear"). Returns ``(dz,
    dbias, dsum)``: the product's gradient in ``dy``'s dtype, the bias's
    (float32, the sum in float32 rounded once to ``dy``'s dtype) and, with
    ``sum_samples``, ``dz``'s sum over the samples (float32, rounded once;
    the per-pixel term's gradient), else None."""
    g = dy
    if dred is not None:
        dt = dy.dtype
        share = dred.to(dt) / nvalid.to(dt)[:, None, None]
        g = g + share[None] * mask.to(dt).t()[:, :, None, None]
    dz = unet.activation_grad(g, out, act)
    dbias = dz.float().sum((0, 1, 2)).to(dz.dtype).float()
    dsum = dz.float().sum(0).to(dz.dtype) if sum_samples else None
    return dz, dbias, dsum


def logits_ref(z, bias, lim=CLAMP):
    """The plain logits epilogue: ``clamp(z + bias, -lim, lim)`` of ``z``
    ``[n, k2, hw]`` in its dtype (``bias`` ``[k2]`` rounded to it first), as
    ``regress_ref`` computes it."""
    return (z + bias.to(z.dtype)[:, None]).clamp(-lim, lim)


def logits_backward_ref(g, out, lim=CLAMP):
    """The plain backward of :func:`logits_ref` from the gradient ``g`` of
    its output ``out`` (both ``[n, k2, hw]``): ``g`` where ``|out|`` is below
    the clamp's bound in ``out``'s dtype, else 0 (also where ``out`` is NaN,
    as autograd's clamp gives; a logit whose sum lands exactly on the bound
    is taken as clamped, where autograd passes its gradient). Returns
    ``(dz, dbias)``, ``dbias`` as :func:`epilogue_backward_ref` sums it."""
    keep = out.float().abs() < _limit(out.dtype, lim)
    dz = torch.where(keep, g, torch.zeros_like(g))
    return dz, dz.float().sum((0, 2)).to(dz.dtype).float()


# --- Kernel bindings ---------------------------------------------------------


def _check(name, t, shape=None, dtype=_BF16, aligned=True):
    """Raise unless ``t`` is contiguous, in ``dtype``, of ``shape`` (if
    given), needs no gradient and (with ``aligned``) starts on 16 bytes.
    The logits' kernels take any start (they fall back to a value a
    thread)."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    ops._no_grad("the chain kernels", t)
    if not t.is_contiguous() or aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def entry(features, gf, k, dtype):
    """The entry (arguments and result as :func:`entry_ref`): the kernel for
    CUDA tensors (``dtype`` bf16; ``features`` float32, float16 or bf16,
    each sample's planes contiguous; ``k`` a multiple of 8 up to
    :data:`MAX_ENTRY`), the plain version for CPU ones."""
    if ops._on_cpu(features):
        return entry_ref(features, gf, k, dtype)
    bs, spp, cf, h, w = features.shape
    if dtype != _BF16:
        raise ValueError(f"the chain kernels compute in bf16, not {dtype}")
    ops._no_grad("the chain kernels", features)
    if features.dtype not in _ENTRY_DTYPES:
        raise ValueError(f"the entry reads float32, float16 or bf16 "
                         f"features, got {features.dtype}")
    if features.stride()[2:] != (h * w, w, 1):
        raise ValueError("each sample's feature planes must be contiguous")
    cg = 0 if gf is None else gf.shape[1]
    if k % 8 or k < cf + cg or k > MAX_ENTRY:
        raise ValueError(f"the entry's rows take a multiple of 8 channels "
                         f"from {cf + cg} to {MAX_ENTRY}, got {k}")
    g = None if gf is None else gf.detach().float().contiguous()
    out = torch.empty(spp, bs, h * w, k, dtype=_BF16, device=features.device)
    ops._launch("chain_entry", ops._load().sbmc_chain_entry, features.device,
                features.data_ptr(), _ENTRY_DTYPES[features.dtype],
                features.stride(0), features.stride(1), cf, _ptr(g), cg,
                out.data_ptr(), k, bs, spp, h * w,
                ops._sm_count(features.device))
    return out


def _act(act):
    if act not in unet.ACTIVATIONS:
        raise ValueError(f"the chain epilogue has no activation {act!r}")
    return unet.ACTIVATIONS[act]


def _float(t):
    return None if t is None else t.detach().float().contiguous()


def epilogue(z, bias, act, dtype, e=None, mask=None, nvalid=None):
    """The per-sample epilogue (arguments and result as
    :func:`epilogue_ref`): the kernel for CUDA tensors (``dtype`` bf16;
    ``z`` bf16, in place, or float32 with ``e``), the plain version for CPU
    ones."""
    if ops._on_cpu(z, bias):
        return epilogue_ref(z, bias, act, dtype, e, mask, nvalid)
    spp, bs, hw, c = z.shape
    if dtype != _BF16:
        raise ValueError(f"the chain kernels compute in bf16, not {dtype}")
    _check("z", z, dtype=torch.float32 if z.dtype == torch.float32 else _BF16)
    if c % 8:
        raise ValueError(f"the chain epilogue takes a multiple of 8 "
                         f"channels, got {c}")
    if e is not None:
        _check("e", e, (bs, hw, c), torch.float32)
    out = z if z.dtype == _BF16 else torch.empty(z.shape, dtype=_BF16,
                                                 device=z.device)
    reduced = None
    if mask is not None:
        reduced = torch.empty(bs, hw, c, dtype=_BF16, device=z.device)
    b = bias.detach().to(_BF16).contiguous()
    m, nv = _float(mask), _float(nvalid)
    ops._launch("chain_epilogue", ops._load().sbmc_chain_epilogue, z.device,
                z.data_ptr(), int(z.dtype == torch.float32), _ptr(e),
                b.data_ptr(), _act(act), out.data_ptr(), _ptr(m), _ptr(nv),
                _ptr(reduced), bs, spp, hw, c, ops._sm_count(z.device))
    return out, reduced


def epilogue_backward(dy, out, act, dred=None, mask=None, nvalid=None,
                      sum_samples=False):
    """The per-sample epilogue's backward (arguments and result as
    :func:`epilogue_backward_ref`): the kernel for CUDA tensors (bf16,
    contiguous), the plain version for CPU ones."""
    if ops._on_cpu(dy):
        return epilogue_backward_ref(dy, out, act, dred, mask, nvalid,
                                     sum_samples)
    spp, bs, hw, c = dy.shape
    _check("dy", dy)
    if c % 8:
        raise ValueError(f"the chain epilogue takes a multiple of 8 "
                         f"channels, got {c}")
    if out is not None:
        _check("out", out, dy.shape)
    elif act != "linear":
        raise ValueError(f"the {act} derivative reads the saved output")
    if dred is not None:
        _check("dred", dred, (bs, hw, c))
    sms = ops._sm_count(dy.device)
    dz = torch.empty_like(dy)
    dsum = (torch.empty(bs, hw, c, dtype=_BF16, device=dy.device)
            if sum_samples else None)
    # A row of bias sums a block: the grid takes at most 8 blocks an SM.
    partials = torch.empty(8 * sms, c, dtype=torch.float32, device=dy.device)
    dbias = torch.empty(c, dtype=torch.float32, device=dy.device)
    m, nv = _float(mask), _float(nvalid)
    ops._launch("chain_epilogue_backward",
                ops._load().sbmc_chain_epilogue_backward, dy.device,
                dy.data_ptr(), _ptr(out), _act(act), _ptr(dred), _ptr(m),
                _ptr(nv), dz.data_ptr(), _ptr(dsum), partials.data_ptr(),
                partials.shape[0], dbias.data_ptr(), bs, spp, hw, c, sms)
    return dz, dbias, dsum


def logits(z, bias):
    """The logits epilogue (as :func:`logits_ref`), in place on ``z`` ``[n,
    k2, hw]``: the kernel for CUDA tensors (bf16, contiguous), the plain
    version for CPU ones. Returns ``z``."""
    if ops._on_cpu(z, bias):
        return z.copy_(logits_ref(z, bias))
    n, k2, hw = z.shape
    _check("z", z, aligned=False)
    b = bias.detach().to(_BF16).contiguous()
    ops._launch("chain_logits", ops._load().sbmc_chain_logits, z.device,
                z.data_ptr(), b.data_ptr(), _limit(_BF16), n, k2, hw,
                ops._sm_count(z.device))
    return z


def logits_backward(g, out, partials, row0, dbias=None):
    """One sample's part of :func:`logits_backward_ref`: from its logits'
    gradient ``g`` ``[bs, k2, h, w]`` and its saved logits ``out`` ``[bs,
    k2, hw]``, ``dz`` (returned, ``[bs, k2, hw]``) and each row's float32
    sum of ``dz`` into the rows ``row0``, ... of ``partials`` (``[n, k2]``
    float32, every sample's rows); with ``dbias`` (``[k2]`` float32, the
    last sample's call) the rows of ``partials`` are then summed into it
    and rounded once to ``out``'s dtype. The kernel for CUDA tensors (bf16,
    contiguous), the plain version for CPU ones."""
    bs, k2, hw = out.shape
    if ops._on_cpu(out):
        dz, _ = logits_backward_ref(g.reshape(bs, k2, hw), out)
        partials[row0:row0 + bs] = dz.float().sum(2)
        if dbias is not None:
            dbias.copy_(partials.sum(0).to(out.dtype).float())
        return dz
    _check("out", out, aligned=False)
    if g.shape[:2] != (bs, k2) or g.numel() != out.numel():
        raise ValueError(f"the logits' gradient has shape {tuple(g.shape)}, "
                         f"the logits {tuple(out.shape)}")
    g = g.contiguous()
    _check("the logits' gradient", g, aligned=False)
    dz = torch.empty_like(out)
    ops._launch("chain_logits_backward",
                ops._load().sbmc_chain_logits_backward, out.device,
                g.data_ptr(), out.data_ptr(), dz.data_ptr(),
                partials.data_ptr(), row0, bs, partials.shape[0],
                _ptr(dbias), _limit(_BF16), k2, hw,
                ops._sm_count(out.device))
    return dz


# --- The chains --------------------------------------------------------------


def _mm(a, b, f32=False):
    """``a @ b`` of 2-D (or batched 3-D) operands in their dtype; with
    ``f32`` the float32 product of bf16 operands (cuBLAS's, with
    ``out_dtype``, on the card)."""
    mm = torch.bmm if a.dim() == 3 else torch.mm
    if f32 and a.dtype != torch.float32:
        if a.device.type == "cuda":
            return mm(a, b, out_dtype=torch.float32)
        return mm(a.float(), b.float())
    return mm(a, b)


def _rows(t):
    """``t`` as a matrix of its last dimension's rows (a view)."""
    return t.reshape(-1, t.shape[-1])


def _nhwc(m):
    """A dense ``[rows, c]`` matrix as the channels-last ``[1, c, rows, 1]``
    tensor the U-Net's epilogue kernels take (a view)."""
    return m.view(1, m.shape[0], 1, m.shape[1]).permute(0, 3, 1, 2)


def _dense(z, bias, act):
    """``unet.epilogue`` of the matrix ``z`` in place (a layer with neither
    a per-pixel term nor a mean). Returns ``z``."""
    unet.epilogue(_nhwc(z), bias, act)
    return z


def _dense_backward(dy, out, act):
    """``unet.epilogue_backward`` of matrices: ``(dz, dbias)``."""
    dz, dbias = unet.epilogue_backward(_nhwc(dy), _nhwc(out), act)
    return _rows(dz.permute(0, 2, 3, 1)), dbias


def _first_layer(x, e, wf, we, bias, act):
    """The first layer on the pixel-major ``x`` ``[spp, bs, hw, cx]``: the
    product with ``wf`` and the epilogue; with the per-pixel input ``e``
    ``[bs, hw, ce]``, the split product (``wf`` on ``x``, ``we`` on ``e``
    once a pixel, both float32) summed in the epilogue."""
    spp, bs, hw, _ = x.shape
    if e is None:
        return _dense(_mm(_rows(x), wf.t()), bias, act).view(spp, bs, hw, -1)
    z = _mm(_rows(x), wf.t(), f32=True).view(spp, bs, hw, -1)
    ez = _mm(_rows(e), we.t(), f32=True).view(bs, hw, -1)
    return epilogue(z, bias, act, x.dtype, e=ez)[0]


def _first_layer_backward(da, a, x, e, wf, we, act, needs):
    """The first layer's backward from the gradient ``da`` (a matrix) of its
    output ``a``: the epilogue's backward (with the sum over the samples of
    a split layer), then the products'. Returns the gradients of ``x``,
    ``e``, ``wf``, ``we`` (None where ``needs`` says no) and of the bias."""
    if e is None:
        dz, db = _dense_backward(da, _rows(a), act)
        dsum = None
    else:
        dz, db, dsum = epilogue_backward(da.view(a.shape), a, act,
                                         sum_samples=True)
        dz = _rows(dz)
    del da
    dx = _mm(dz, wf).view(x.shape) if needs[0] else None
    dwf = _wgrad(dz, x, wf.dtype) if needs[2] else None
    de = dwe = None
    if e is not None:
        ds = _rows(dsum)
        de = _mm(ds, we).view(e.shape) if needs[1] else None
        dwe = _wgrad(ds, e, we.dtype) if needs[3] else None
    return dx, de, dwf, dwe, db


def _layer(a, w, bias, act):
    """A middle layer: the product and ``unet.epilogue``."""
    return _dense(_mm(_rows(a), w.t()), bias, act).view(*a.shape[:-1], -1)


def _wgrad(dz, a, dtype):
    """A weight's gradient ``dz^T . a`` over every row (``dz`` a matrix,
    ``a`` the layer's input), summed in float32 and rounded once to
    ``dtype``, as the convolution's weight gradient rounds it (cuBLAS's
    bf16 output could reduce its split sums in bf16)."""
    return _mm(dz.t(), _rows(a), f32=True).to(dtype)


def _layer_backward(dz, a, w):
    """A layer's products backward from its product's gradient ``dz`` (a
    matrix) and its input ``a``: ``(da, dw)``, ``da`` a matrix."""
    return _mm(dz, w), _wgrad(dz, a, w.dtype)


class _EmbeddingStep(torch.autograd.Function):
    """One embedding step: ``apply(acts, x, e, mask, nvalid, wf, we, w1,
    w2, b0, b1, b2)``: the 1x1 chain (activations ``acts``, the last
    linear) on the pixel-major ``x`` (and the per-pixel ``e``, or None),
    with its masked mean over the samples in the last layer's epilogue.
    Returns ``(embedded, reduced)``. Saves the input, the per-pixel input,
    the weights and the two hidden layers' outputs (the activations'
    derivatives follow from their signs)."""

    @staticmethod
    def forward(ctx, acts, x, e, mask, nvalid, wf, we, w1, w2, b0, b1, b2):
        a0 = _first_layer(x, e, wf, we, b0, acts[0])
        a1 = _layer(a0, w1, b1, acts[1])
        z2 = _mm(_rows(a1), w2.t()).view(*a1.shape[:-1], -1)
        out, reduced = epilogue(z2, b2, "linear", x.dtype, mask=mask,
                                nvalid=nvalid)
        ctx.acts = acts
        ctx.save_for_backward(x, e, mask, nvalid, wf, we, w1, w2, a0, a1)
        return out, reduced

    @staticmethod
    def backward(ctx, dout, dred):
        x, e, mask, nvalid, wf, we, w1, w2, a0, a1 = ctx.saved_tensors
        acts, needs = ctx.acts, ctx.needs_input_grad
        # Each gradient is released once the next is made.
        g, db2, _ = epilogue_backward(dout.contiguous(), None, "linear",
                                      dred.contiguous(), mask, nvalid)
        g, dw2 = _layer_backward(_rows(g), a1, w2)
        g, db1 = _dense_backward(g, _rows(a1), acts[1])
        g, dw1 = _layer_backward(g, a0, w1)
        dx, de, dwf, dwe, db0 = _first_layer_backward(
            g, a0, x, e, wf, we, acts[0], needs[1:3] + needs[5:7])
        return (None, dx, de, None, None, dwf, dwe, dw1, dw2, db0, db1, db2)


class _Regressor(torch.autograd.Function):
    """The kernel regressor over every sample: ``apply(acts, size, f, e,
    wf, we, w1, w2, b0, b1, b2)``: the 1x1 chain (activations ``acts``, the
    last linear) on the pixel-major embedding ``f`` and the per-pixel ``e``,
    its last product written as ``[spp * bs, k2, hw]`` logits (one batched
    product, the weight shared), then :func:`logits`. Returns each sample's
    ``[bs, k2, h, w]`` logits (``size``: ``(h, w)``), views of one tensor.
    Saves as :class:`_EmbeddingStep` does, and the logits (the clamp's
    derivative)."""

    @staticmethod
    def forward(ctx, acts, size, f, e, wf, we, w1, w2, b0, b1, b2):
        spp, bs, hw, _ = f.shape
        a0 = _first_layer(f, e, wf, we, b0, acts[0])
        a1 = _layer(a0, w1, b1, acts[1])
        n = spp * bs
        z = logits(_mm(w2.expand(n, *w2.shape),
                       a1.view(n, hw, -1).transpose(1, 2)), b2)
        ctx.acts = acts
        ctx.save_for_backward(f, e, wf, we, w1, w2, a0, a1, z)
        return tuple(z.view(spp, bs, -1, *size).unbind(0))

    @staticmethod
    def backward(ctx, *grads):
        f, e, wf, we, w1, w2, a0, a1, z = ctx.saved_tensors
        acts, needs = ctx.acts, ctx.needs_input_grad
        spp, bs, hw, width = a1.shape
        k2 = z.shape[1]
        # A sample at a time: its logits' gradient, its rows of the last
        # product's input gradient and its share of the weight gradient
        # (float32, summed in sample order), so no gradient of every
        # sample's logits is held at once.
        g = torch.empty_like(a1)
        dw2 = torch.zeros(k2, width, dtype=torch.float32, device=z.device)
        partials = torch.empty(spp * bs, k2, dtype=torch.float32,
                               device=z.device)
        db2 = torch.empty(k2, dtype=torch.float32, device=z.device)
        w2b = w2.expand(bs, k2, width)
        for s, dlogits in enumerate(grads):
            rows = slice(s * bs, (s + 1) * bs)
            dz = logits_backward(dlogits, z[rows], partials, s * bs,
                                 db2 if s == spp - 1 else None)
            torch.bmm(dz.transpose(1, 2), w2b, out=g[s])
            dw2 += _mm(dz, a1[s], f32=True).sum(0)
        dw2 = dw2.to(w2.dtype)
        g, db1 = _dense_backward(_rows(g), _rows(a1), acts[1])
        g, dw1 = _layer_backward(g, a0, w1)
        df, de, dwf, dwe, db0 = _first_layer_backward(
            g, a0, f, e, wf, we, acts[0], needs[2:6])
        return (None, None, df, de, dwf, dwe, dw1, dw2, db0, db1, db2)


def _weights(chain, dtype, cin=None):
    """Each layer's weight as a ``[cout, cin]`` matrix rounded to
    ``dtype``, made in stock autograd (the first's input channels padded
    with zeros to ``cin`` if given), and its float32 bias."""
    layers = chain.layers()
    return ([layer.inference_weight(dtype, cin if i == 0 else None).flatten(1)
             for i, layer in enumerate(layers)],
            [layer.bias for layer in layers])


def _split(w0, cx, e):
    """The first layer's weight split into the columns of ``x``'s ``cx``
    channels and those of ``e`` (None without ``e``)."""
    return (w0, None) if e is None else (w0[:, :cx], w0[:, cx:])


def embedding_step(chain, x, e, mask, nvalid):
    """One embedding step of ``chain`` on the pixel-major ``x`` ``[spp, bs,
    hw, cx]`` (the entry's output in step 0, the previous step's embedding
    after it) and the per-pixel ``e`` ``[bs, hw, ce]`` (the previous step's
    U-Net output; None in step 0, whose global features the entry wrote
    into ``x``); ``mask`` ``[bs, spp]`` and ``nvalid`` ``[bs]`` as
    ``sample_chain.embedding_step_ref`` takes them. Returns ``(embedded
    [spp, bs, hw, cout], reduced [bs, hw, cout])``."""
    ws, biases = _weights(chain, x.dtype, x.shape[-1] if e is None else None)
    wf, we = _split(ws[0], x.shape[-1], e)
    return _EmbeddingStep.apply(tuple(chain.activations()), x, e, mask,
                                nvalid, wf, we, ws[1], ws[2], *biases)


def regress(chain, f, e, size):
    """The kernel regressor ``chain`` on every sample of the pixel-major
    embedding ``f`` ``[spp, bs, hw, ce]`` and the per-pixel ``e`` ``[bs, hw,
    cp]``: each sample's ``[bs, k2, h, w]`` logits (``size``: ``(h, w)``),
    clamped to ±3e4, in ``f``'s dtype, as ``sample_chain.regress_ref``
    gives them."""
    ws, biases = _weights(chain, f.dtype)
    wf, we = _split(ws[0], f.shape[-1], e)
    return _Regressor.apply(tuple(chain.activations()), tuple(size), f, e,
                            wf, we, ws[1], ws[2], *biases)
