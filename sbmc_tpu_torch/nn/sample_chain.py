"""SBMC's per-sample 1x1 chains, for inference.

Two stages of :class:`~sbmc_tpu_torch.models.multisteps.Multisteps` run a
``ConvChain`` of depth 3 with ``ksize=1`` on every sample:

- an embedding step (:func:`embedding_step`): the chain on
  ``cat([feats, extra])`` for every sample, then the masked mean of the
  result over the samples;
- the kernel regressor (:func:`regress`): the chain on
  ``cat([feats[:, s], propagated])`` for one sample, then the ±3e4 logit
  clamp and the cast to the kernel dtype.

For CUDA tensors each is one launch of a hand-written kernel
(``ops/csrc/sample_chain.cu``: ``sample_embed``, ``sample_regress``), which
keeps the cat, the intermediates and the mean out of device memory; it is
counted in ``ops.launch_counts["sample_chain"]``. The kernel has no
backward: the wrapper raises if an input or a weight requires grad, and
:class:`Multisteps` takes this path only with gradients off, CUDA input,
bf16 convs and chains the kernel holds (:func:`embedding_fits`,
:func:`regress_fits`: the kernel's entry points decide). For CPU tensors the
plain versions run (:func:`embedding_step_ref`, :func:`regress_ref`): the
unfused code, which ``Multisteps`` also runs whenever it does not take the
kernel.

The weights and biases are ``WNConv2D.inference_weight`` and
``inference_bias``'s in bf16 (rounded as the bf16 convs round them), made
once a call; the wrapper zero-pads the hidden width to :data:`HIDDEN` and
the input channels to a multiple of 64, and lays each matrix out for the
kernel (:func:`kernel_layout`). The
first layer's product is split as ``W_f . feats + W_e . extra``; in step 0
``extra`` is the batch's global features and ``W_e . extra`` a float32
vector a batch item, computed here.
"""

import torch

from sbmc_tpu_torch import ops

__all__ = ["HIDDEN", "CHUNK", "embedding_step", "embedding_step_ref",
           "embedding_weights", "embedding_fits", "regress", "regress_ref",
           "regressor_weights", "regress_fits", "kernel_layout"]

#: Hidden and embedding width the kernel holds (narrower chains are padded).
HIDDEN = 128
#: Regressor outputs per slot of the kernel's weight ring.
CHUNK = 64
_WARPS = 8


def _pad64(n):
    return -(-n // 64) * 64


def embedding_step_ref(chain, feats, extra, mask_f, n_valid, run=None):
    """The plain embedding step (the unfused code).

    Args:
      chain: the step's ``ConvChain``.
      feats: ``[bs, spp, cx, h, w]``.
      extra: ``[bs, ce, h, w]`` per pixel, or ``[bs, ce, 1, 1]`` per batch
        item (the global features).
      mask_f: ``[bs, spp]`` sample validity (0 or 1) in ``feats``' dtype.
      n_valid: ``[bs]`` valid samples, at least 1.
      run: calls the chain (default ``chain``), e.g. under checkpointing.

    Returns:
      ``(embedded [bs, spp, cout, h, w], reduced [bs, cout, h, w])``, the
      masked mean over samples.
    """
    bs, spp, _, h, w = feats.shape
    extra = extra[:, None].expand(bs, spp, extra.shape[1], h, w)
    flat = torch.cat([feats, extra], dim=2)
    flat = (run or chain)(flat.reshape(bs * spp, -1, h, w))
    feats = flat.reshape(bs, spp, -1, h, w)
    # Permutation-invariant masked mean over samples.
    reduced = ((feats * mask_f[:, :, None, None, None]).sum(dim=1)
               / n_valid[:, None, None, None])
    return feats, reduced


def regress_ref(chain, feats_s, propagated, kernel_dtype):
    """The plain kernel regressor on one sample (the unfused code): logits
    ``[bs, k2, h, w]`` of ``chain(cat([feats_s, propagated]))``, clamped to
    ±3e4 and cast to ``kernel_dtype`` (None keeps the conv dtype)."""
    kernels = chain(torch.cat([feats_s, propagated], dim=1))
    # Logit safety clamp: the online softmax is shift-invariant, so this
    # only turns a float32 overflow into a saturating kernel.
    kernels = kernels.clamp(-3e4, 3e4)
    if kernel_dtype is not None:
        kernels = kernels.to(kernel_dtype)
    return kernels.contiguous()


def _is_1x1_chain(chain, k_in):
    layers = chain.layers()
    return (chain.depth == 3 and all(l.ksize == 1 for l in layers)
            and layers[0].v.shape[1] == k_in)


def _hidden(chain):
    return max(l.v.shape[0] for l in chain.layers()[:-1])


def embedding_fits(chain, cx, ce, per_pixel):
    """Whether the kernel holds an embedding step of ``chain`` on ``cx``
    feature channels and ``ce`` extra channels, per pixel or (``per_pixel``
    False) a vector a batch item. The kernel's entry point decides; CUDA
    builds only."""
    return _is_1x1_chain(chain, cx + ce) and bool(
        ops._load().sbmc_sample_embed_fits(cx, ce if per_pixel else 0,
                                       _hidden(chain),
                                       chain.prediction.v.shape[0]))


def regress_fits(chain, k_in):
    """Whether the kernel holds the regressor ``chain`` on ``k_in`` input
    channels (as :func:`embedding_fits`)."""
    return _is_1x1_chain(chain, k_in) and bool(
        ops._load().sbmc_sample_regress_fits(k_in, _hidden(chain),
                                             chain.prediction.v.shape[0]))


def kernel_layout(w, rows, cols):
    """``w`` ``[n, k]`` as the kernel's warpgroup MMAs read it: bf16,
    zero-padded to ``[rows, cols]`` (``cols`` a multiple of 64), cut into
    ``cols // 64`` blocks of 64 columns, each ``[rows, 64]`` (128-byte rows)
    with the eight 16-byte chunks of row ``n`` permuted so that chunk ``j``
    lies at ``j ^ (n & 7)`` (the 128-byte swizzle); shape ``[cols // 64,
    rows, 64]``."""
    out = torch.zeros(rows, cols, dtype=torch.bfloat16, device=w.device)
    out[:w.shape[0], :w.shape[1]] = w
    blocks = out.view(rows, cols // 64, 8, 8).permute(1, 0, 2, 3)
    n = torch.arange(rows, device=w.device)[None, :, None]
    j = torch.arange(8, device=w.device)[None, None, :]
    src = (j ^ (n & 7)).expand(cols // 64, rows, 8)
    return blocks.gather(2, src[..., None].expand(cols // 64, rows, 8, 8)
                         ).reshape(cols // 64, rows, 64).contiguous()


def _check_input(name, t):
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
    if not t[(0,) * (t.dim() - 3)].is_contiguous():
        raise ValueError(f"{name}: each batch item's [c, h, w] planes must "
                         "be contiguous")


def _grid(device, warp_tiles):
    return max(1, min(ops._sm_count(device), -(-warp_tiles // _WARPS)))


def embedding_weights(chain, cx, extra):
    """An embedding step's operands laid out for the kernel: ``wx``,
    ``w1``, ``w2`` (and ``we`` for per-pixel ``extra``, else ``ebias``, the
    float32 ``W_e . extra`` of each batch item, ``[bs, HIDDEN]``), the three
    biases in one bf16 vector, and the padded channel counts ``kx``,
    ``ke``."""
    layers = chain.layers()
    w0, w1, w2 = (l.inference_weight(torch.bfloat16)[:, :, 0, 0]
                  for l in layers)
    ops._no_grad("the sample chain kernel (embedding)", extra, w0, w1, w2)
    kx = _pad64(cx)
    wts = {"wx": kernel_layout(w0[:, :cx], HIDDEN, kx),
           "w1": kernel_layout(w1, HIDDEN, HIDDEN),
           "w2": kernel_layout(w2, HIDDEN, HIDDEN),
           "bias": torch.cat([l.inference_bias(torch.bfloat16, HIDDEN)
                              for l in layers]),
           "kx": kx, "cout": w2.shape[0], "we": None, "ebias": None}
    we = w0[:, cx:]
    if tuple(extra.shape[-2:]) == (1, 1):
        # Per batch item (the global features), in float32 as the bf16
        # conv sums it.
        ebias = torch.zeros(extra.shape[0], HIDDEN, dtype=torch.float32,
                            device=extra.device)
        ebias[:, :we.shape[0]] = (we.float()[None]
                                  * extra.reshape(extra.shape[0], -1).float()
                                  [:, None, :]).sum(-1)
        wts.update(ebias=ebias, ke=0)
    else:
        wts.update(ke=_pad64(we.shape[1]))
        wts["we"] = kernel_layout(we, HIDDEN, wts["ke"])
    return wts


def embedding_step(chain, feats, extra, mask_f, n_valid):
    """One embedding step (arguments and result as
    :func:`embedding_step_ref`): the kernel for CUDA tensors (bf16 only;
    no gradient), the plain version for CPU ones."""
    if ops._on_cpu(feats, extra, mask_f, n_valid):
        return embedding_step_ref(chain, feats, extra, mask_f, n_valid)
    bs, spp, cx, h, w = feats.shape
    ops._no_grad("the sample chain kernel (embedding)", feats, mask_f,
                 n_valid)
    _check_input("feats", feats)
    per_pixel = tuple(extra.shape[-2:]) != (1, 1)
    if (extra.shape[0] != bs
            or per_pixel and tuple(extra.shape[-2:]) != (h, w)
            or not embedding_fits(chain, cx, extra.shape[1], per_pixel)):
        raise ValueError("the embedding chain or the extra features do not "
                         "fit the sample chain kernel")
    wts = embedding_weights(chain, cx, extra)
    e = None
    if per_pixel:
        e = extra.contiguous()
        _check_input("extra", e)
    cout = wts["cout"]
    out = torch.empty(bs, spp, cout, h, w, dtype=torch.bfloat16,
                      device=feats.device)
    reduced = torch.empty(bs, cout, h, w, dtype=torch.bfloat16,
                          device=feats.device)
    mask = mask_f.float().contiguous()
    nvalid = n_valid.float().contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    ops._launch("sample_chain", ops._load().sbmc_sample_embed, feats.device,
                feats.data_ptr(), feats.stride(0), feats.stride(1), cx,
                wts["kx"], ptr(e), 0 if e is None else e.shape[1], wts["ke"],
                ptr(wts["ebias"]), wts["wx"].data_ptr(), ptr(wts["we"]),
                wts["w1"].data_ptr(), wts["w2"].data_ptr(),
                wts["bias"].data_ptr(), mask.data_ptr(), nvalid.data_ptr(),
                out.data_ptr(), reduced.data_ptr(), cout, bs, spp, h * w,
                _grid(feats.device, bs * -(-(h * w) // 16)))
    return out, reduced


def regressor_weights(chain):
    """The regressor's weights and biases laid out for the kernel (once a
    forward: every sample's launch reads them)."""
    layers = chain.layers()
    w0, w1, w2 = (l.inference_weight(torch.bfloat16)[:, :, 0, 0]
                  for l in layers)
    ops._no_grad("the sample chain kernel (regressor)", w0, w1, w2)
    k0 = _pad64(w0.shape[1])
    nout = w2.shape[0]
    nchunks = -(-nout // CHUNK)
    return {"w0": kernel_layout(w0, HIDDEN, k0),
            "w1": kernel_layout(w1, HIDDEN, HIDDEN),
            # One block of CHUNK outputs a slot of the kernel's ring.
            "w2": torch.stack([kernel_layout(w2[c * CHUNK:(c + 1) * CHUNK],
                                             CHUNK, HIDDEN)
                               for c in range(nchunks)]),
            "bias": torch.cat([l.inference_bias(torch.bfloat16, n)
                               for l, n in zip(layers, (HIDDEN, HIDDEN,
                                                        nchunks * CHUNK))]),
            "k_in": w0.shape[1], "k0": k0, "nout": nout}


def regress(chain, feats_s, propagated, kernel_dtype, weights=None):
    """The kernel regressor on one sample (arguments and result as
    :func:`regress_ref`; ``weights`` from :func:`regressor_weights`, made
    here if None): the kernel for CUDA tensors (bf16 only; no gradient), the
    plain version for CPU ones."""
    if ops._on_cpu(feats_s, propagated):
        return regress_ref(chain, feats_s, propagated, kernel_dtype)
    if weights is None:
        weights = regressor_weights(chain)
    ops._no_grad("the sample chain kernel (regressor)", feats_s,
                 propagated)
    propagated = propagated.contiguous()
    _check_input("feats", feats_s)
    _check_input("propagated", propagated)
    bs, cx, h, w = feats_s.shape
    ce = propagated.shape[1]
    if (propagated.shape[0] != bs or tuple(propagated.shape[-2:]) != (h, w)
            or not regress_fits(chain, cx + ce)):
        raise ValueError("the regressor chain or its inputs do not fit the "
                         "sample chain kernel")
    hw = h * w
    out = torch.empty(bs, weights["nout"], h, w, dtype=torch.bfloat16,
                      device=feats_s.device)
    ops._launch("sample_chain", ops._load().sbmc_sample_regress,
                feats_s.device, feats_s.data_ptr(), feats_s.stride(0), cx,
                propagated.data_ptr(), ce, weights["k0"],
                weights["w0"].data_ptr(), weights["w1"].data_ptr(),
                weights["w2"].data_ptr(), weights["bias"].data_ptr(),
                out.data_ptr(), weights["nout"], bs, hw,
                _grid(feats_s.device, bs * -(-hw // 16)))
    if kernel_dtype is not None and kernel_dtype != torch.bfloat16:
        out = out.to(kernel_dtype)
    return out
