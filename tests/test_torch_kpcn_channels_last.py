"""KPCN's conv chains in channels-last at inference (``KPCN.
forward_channels_last`` and ``sbmc_tpu_torch.nn.kpcn_layout``) on the CPU.

On CPU tensors the entry, epilogue and exit ops run their plain versions,
so these tests hold the channels-last dataflow (the padded widths and
weights, the pad channels' zeros, the bias and softmax in the exit) to the
NCHW ``KPCN.forward`` on the same weights and inputs, and the plain versions
to the expressions they replace. The kernels' own arguments are checked by
running the wrappers' CUDA branch on CPU tensors with the launch recorded in
place of the call (the ``fake_card`` fixture); the kernels themselves are
held to the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerances (as ``tests/test_torch_unet_fused.py``'s):

- float32: ``|channels-last - NCHW| <= 1e-5 * max |NCHW|``. Only the
  convolutions' float32 sums differ (oneDNN sums a channels-last
  convolution over its padded channels in another order).
- bf16: held to the float32 KPCN on the same weights and inputs in units
  of the NCHW path's own error (``_rounding_ratios``, ``ROUNDING_L2`` and
  ``ROUNDING_MAX`` of ``tests/test_torch_unet_fused.py``, which says why):
  oneDNN's bf16 convolutions sum in another order by layout and by the
  CPU's instruction set.
"""

import pytest
import torch
import torch.nn.functional as F

from sbmc_tpu_torch.models import KPCN
from sbmc_tpu_torch.models import kpcn as kpcn_module
from sbmc_tpu_torch.nn import kpcn_layout, layers, sample_chain, unet
from sbmc_tpu_torch.nn.layers import Autoencoder, ConvChain, dtype_of
from tests.test_torch_kernel_paths import fake_card  # noqa: F401
from tests.test_torch_unet_fused import (ROUNDING_L2, ROUNDING_MAX,
                                         _rounding_ratios)

BF16 = torch.bfloat16
CL = torch.channels_last
F32_REL = 1e-5
KEYS = ("kpcn_diffuse_in", "kpcn_specular_in", "kpcn_diffuse_buffer",
        "kpcn_specular_buffer", "kpcn_albedo")
#: The published architecture (27 inputs, width 100, 441 taps) and a tiny
#: one whose widths are padded too (5, 12 and 9 to 32).
FULL = dict(n_in=27, ksize=21, depth=9, width=100)
TINY = dict(n_in=5, ksize=3, depth=3, width=12)


def _kpcn(arch, conv_dtype, seed=0):
    """KPCN with random biases, so that every ReLU sees both signs."""
    torch.manual_seed(seed)
    model = KPCN(conv_dtype=conv_dtype, **arch)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn_like(p))
    return model


def _inputs(arch, bs, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand(bs, arch["n_in"] if k.endswith("_in") else 3, h, w,
                          generator=g) for k in KEYS}


def _close(got, want, dtype, f32=None):
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype is None:
        err = float((got - want).abs().max())
        assert err <= F32_REL * float(want.abs().max())
    else:
        l2, mx = _rounding_ratios(got, want, f32)
        assert l2 <= ROUNDING_L2 and mx <= ROUNDING_MAX


@pytest.mark.parametrize("arch", [FULL, TINY], ids=["full", "tiny"])
@pytest.mark.parametrize("bs,dh,dw", [(1, 8, 10), (2, 5, 7), (1, 1, 17)],
                         ids=["even", "odd", "ragged"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_channels_last_matches_forward(arch, bs, dh, dw, dtype):
    """Even, odd and ragged tiles (``dh x dw`` valid pixels), batch 1 and 2,
    float32 and bf16 convs."""
    model = _kpcn(arch, dtype, seed=dh)
    shrink = 4 * arch["depth"]
    x = _inputs(arch, bs, shrink + dh, shrink + dw, seed=dw)
    with torch.no_grad():
        want = model(x)
        got = model.forward_channels_last(x)
        f32 = _kpcn(arch, None, seed=dh)(x) if dtype else want
    for key in ("radiance", "diffuse", "specular"):
        assert got[key].shape == (bs, 3, dh, dw)
        _close(got[key], want[key], dtype, f32[key])


# The expressions each inference path built its operands with before
# ``WNConv2D.inference_weight`` and ``inference_bias``: the bias as the
# epilogue kernel reads it, rounded to the compute dtype.

def _parent_kpcn(model, dt):
    weights, biases = [], []
    for chain in (model.diffuse, model.specular):
        cin = kpcn_module.padded_width(chain.layer_0.v.shape[1])
        for layer in chain.layers():
            v, cout = layer.weight(), layer.v.shape[0]
            w = torch.empty((kpcn_module.padded_width(cout), cin)
                            + tuple(v.shape[2:]), dtype=dt,
                            memory_format=CL)
            w.zero_()[:v.shape[0], :v.shape[1]] = v
            weights.append(w)
            cin = w.shape[0]
            if layer is not chain.prediction:
                biases.append(F.pad(layer.bias, (0, cin - cout)).to(dt))
    return weights, biases


def _parent_unet(ae, dt):
    convs = [c for name in ("left_0", "left_1", "left_2", "right_1",
                            "right_0") for c in getattr(ae, name).layers()]
    return ([c.weight().to(dt).contiguous(memory_format=CL) for c in convs],
            [c.bias.to(dt) for c in convs])


def _parent_bias(conv, n):
    out = torch.zeros(n, dtype=BF16)
    out[:conv.bias.shape[0]] = conv.bias.to(BF16)
    return out


def _parent_embedding_weights(chain, cx, extra):
    l0, l1, l2 = chain.layers()
    w0, w1, w2 = (l.weight()[:, :, 0, 0] for l in (l0, l1, l2))
    hid, kx = sample_chain.HIDDEN, -(-cx // 64) * 64
    out = {"wx": sample_chain.kernel_layout(w0[:, :cx], hid, kx),
           "w1": sample_chain.kernel_layout(w1, hid, hid),
           "w2": sample_chain.kernel_layout(w2, hid, hid),
           "bias": torch.cat([_parent_bias(l0, hid), _parent_bias(l1, hid),
                              _parent_bias(l2, hid)]),
           "kx": kx, "cout": w2.shape[0], "we": None, "ebias": None}
    we = w0[:, cx:]
    if tuple(extra.shape[-2:]) == (1, 1):
        ebias = torch.zeros(extra.shape[0], hid, dtype=torch.float32)
        ebias[:, :we.shape[0]] = (we.to(BF16).float()[None]
                                  * extra.reshape(extra.shape[0], -1).float()
                                  [:, None, :]).sum(-1)
        out.update(ebias=ebias, ke=0)
    else:
        out.update(ke=-(-we.shape[1] // 64) * 64)
        out["we"] = sample_chain.kernel_layout(we, hid, out["ke"])
    return out


def _parent_regressor_weights(chain):
    l0, l1, l2 = chain.layers()
    w0, w1, w2 = (l.weight()[:, :, 0, 0] for l in (l0, l1, l2))
    hid, chunk = sample_chain.HIDDEN, sample_chain.CHUNK
    k0, nout = -(-w0.shape[1] // 64) * 64, w2.shape[0]
    nchunks = -(-nout // chunk)
    return {"w0": sample_chain.kernel_layout(w0, hid, k0),
            "w1": sample_chain.kernel_layout(w1, hid, hid),
            "w2": torch.stack([sample_chain.kernel_layout(
                w2[c * chunk:(c + 1) * chunk], chunk, hid)
                for c in range(nchunks)]),
            "bias": torch.cat([_parent_bias(l0, hid), _parent_bias(l1, hid),
                               _parent_bias(l2, nchunks * chunk)]),
            "k_in": w0.shape[1], "k0": k0, "nout": nout}


def _handed(monkeypatch, run):
    """The weights a channels-last run hands to the convolutions and the
    biases it hands to the epilogue, in order."""
    weights, biases = [], []
    conv2d, epilogue = F.conv2d, unet.epilogue

    def conv(x, w, *args, **kw):
        weights.append(w)
        return conv2d(x, w, *args, **kw)

    def epi(y, bias, *args):
        biases.append(bias)
        return epilogue(y, bias, *args)

    with monkeypatch.context() as m:
        m.setattr(F, "conv2d", conv)
        m.setattr(unet, "epilogue", epi)
        run()
    return weights, biases


def _same(got, want):
    """Bit for bit, in the same dtype and memory layout."""
    if isinstance(want, torch.Tensor):
        return (got.dtype == want.dtype and got.stride() == want.stride()
                and torch.equal(got, want))
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(_same(got[k], want[k])
                                                 for k in want)
    if isinstance(want, (list, tuple)):
        return len(got) == len(want) and all(map(_same, got, want))
    return got == want


def _sample_chain_operands(chains, extras):
    (c0, c1, reg), (gf, prop) = chains, extras
    new = [sample_chain.embedding_weights(c0, 93, gf),
           sample_chain.embedding_weights(c1, 128, prop),
           sample_chain.regressor_weights(reg)]
    old = [_parent_embedding_weights(c0, 93, gf),
           _parent_embedding_weights(c1, 128, prop),
           _parent_regressor_weights(reg)]
    return new, old


@pytest.mark.parametrize("user,dtype", [
    ("kpcn", None), ("kpcn", "bfloat16"), ("unet", None), ("unet", "bfloat16"),
    ("sample_chain", "bfloat16")])
def test_padded_weights_follow_the_parameters(monkeypatch, user, dtype):
    """The weights and biases each inference path hands to cuDNN and the
    kernels (KPCN's padded chains at the published widths, the flagship's
    U-Net, its per-sample chains) are bit for bit the expressions the path
    wrote before, in dtype and layout too; made each call, they follow an
    update of the parameters. KPCN's output follows it as well."""
    dt = dtype_of(dtype) or torch.float32
    if user == "kpcn":
        model = _kpcn(FULL, dtype)
        x = _inputs(FULL, 1, 40, 41)
        updated = (model.diffuse.layer_1.v, model.specular.prediction.bias)

        def operands():
            got = _handed(monkeypatch,
                          lambda: model.forward_channels_last(x))
            return got, _parent_kpcn(model, dt)
    elif user == "unet":
        torch.manual_seed(0)
        model = Autoencoder(128, 128, num_levels=3, increase_factor=2.0,
                            num_convs=3, width=128, ksize=3,
                            output_type="leaky_relu", dtype=dtype_of(dtype))
        x = torch.randn(1, 128, 8, 10)
        updated = (model.left_1.layer_0.g, model.right_0.prediction.bias)

        def operands():
            got = _handed(monkeypatch,
                          lambda: model.forward_channels_last(x))
            return got, _parent_unet(model, dt)
    else:
        torch.manual_seed(0)
        chains = (ConvChain(96, 128, ksize=1, width=128, depth=3, dtype=BF16),
                  ConvChain(256, 128, ksize=1, width=128, depth=3,
                            dtype=BF16),
                  ConvChain(256, 441, ksize=1, width=128, depth=3,
                            activation="leaky_relu", dtype=BF16))
        model = torch.nn.ModuleList(chains)
        updated = (chains[0].layer_1.g, chains[2].prediction.bias)
        g = torch.Generator().manual_seed(3)
        extras = (torch.randn(2, 3, 1, 1, generator=g).to(BF16),
                  torch.randn(2, 128, 5, 7, generator=g).to(BF16))

        def operands():
            return _sample_chain_operands(chains, extras)
    with torch.no_grad():
        if user != "kpcn":
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.copy_(0.3 * torch.randn_like(p))
        before, want = operands()
        assert _same(before, want)
        out = model.forward_channels_last(x) if user == "kpcn" else None
        updated[0].mul_(1.5)
        updated[1].add_(0.2)
        got, want = operands()
        assert _same(got, want) and not _same(got, before)
        if user == "kpcn":
            new = model.forward_channels_last(x)["radiance"]
            assert not torch.equal(new, out["radiance"])
            f32 = _kpcn(FULL, None)
            f32.load_state_dict(model.state_dict())
            _close(new, model(x)["radiance"], dtype, f32(x)["radiance"])


@pytest.mark.parametrize("arch", [FULL, TINY], ids=["full", "tiny"])
def test_pad_channels_hold_exact_zeros(monkeypatch, arch):
    """The entry's pad channels, every epilogue's output beyond the layer's
    channels and the prediction's beyond its taps are exactly zero."""
    model = _kpcn(arch, "bfloat16")
    seen = []
    epilogue, exit_ = unet.epilogue, kpcn_layout.kpcn_exit

    def checked_epilogue(y, bias, act, out=None, pool=None):
        assert tuple(bias.shape) == (y.shape[1],)
        got = epilogue(y, bias, act, out, pool)
        seen.append(("epilogue", got.shape[1]))
        cout = arch["width"]
        assert bool((got[:, cout:] == 0).all())
        assert bool((got[:, :cout] != 0).any())
        return got

    def checked_exit(y, bias, k2):
        seen.append(("exit", y.shape[1], k2))
        assert bool((y[:, k2:] == 0).all())
        return exit_(y, bias, k2)

    monkeypatch.setattr(unet, "epilogue", checked_epilogue)
    monkeypatch.setattr(kpcn_layout, "kpcn_exit", checked_exit)
    shrink = 4 * arch["depth"]
    x = _inputs(arch, 1, shrink + 3, shrink + 4)
    with torch.no_grad():
        entry = kpcn_layout.kpcn_entry(x["kpcn_diffuse_in"],
                                       kpcn_module.padded_width(arch["n_in"]))
        model.forward_channels_last(x)
    assert bool((entry[:, arch["n_in"]:] == 0).all())
    assert entry.shape[1] % 8 == 0 and entry.is_contiguous(memory_format=CL)
    width = kpcn_module.padded_width(arch["width"])
    k2 = arch["ksize"] ** 2
    assert seen == 2 * ([("epilogue", width)] * (arch["depth"] - 1)
                        + [("exit", kpcn_module.padded_width(k2), k2)])


def test_padded_widths():
    """The next multiple of 32: the published widths 27, 100 and 441 pad to
    32, 128 and 448; a multiple of 32 stays."""
    assert [kpcn_module.padded_width(c) for c in (27, 100, 441, 1, 32, 33)] \
        == [32, 128, 448, 32, 32, 64]


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("c,k2", [(448, 441), (16, 9), (8, 8)])
def test_plain_exit_is_bias_and_softmax(dtype, c, k2):
    """Bit for bit ``torch.softmax`` of the first ``k2`` channels plus the
    bias (rounded to the logits' dtype), as ``WNConv2D.forward`` adds it
    and ``kernel_apply(softmax=True)`` normalises it, dense NCHW; whatever
    lies in the pad channels is ignored."""
    g = torch.Generator().manual_seed(c)
    y = (3 * torch.randn(2, c, 5, 7, generator=g)).to(dtype).contiguous(
        memory_format=CL)
    bias = torch.randn(k2, generator=g)
    got = kpcn_layout.kpcn_exit_ref(y, bias, k2)
    nchw = y.contiguous()[:, :k2] + bias.to(dtype)[:, None, None]
    want = torch.softmax(nchw.contiguous(), dim=1)
    assert got.is_contiguous() and got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(kpcn_layout.kpcn_exit(y, bias, k2), want)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
@pytest.mark.parametrize("src", [torch.float32, torch.float16, BF16])
def test_plain_entry_is_cast_and_pad(dtype, src):
    x = torch.randn(2, 27, 5, 6).to(src)
    got = kpcn_layout.kpcn_entry_ref(x, 32, dtype)
    assert got.is_contiguous(memory_format=CL) and got.dtype == dtype
    assert torch.equal(got[:, :27], x.to(dtype))
    assert bool((got[:, 27:] == 0).all())


def _record_gathers(monkeypatch, launches):
    """``kernel_apply`` returns zeros after noting in ``launches`` whether
    it normalised."""

    def apply(data, kernels, softmax, splat):
        launches.append(("kernel_apply", softmax, tuple(kernels.shape)))
        return torch.zeros_like(data), None

    monkeypatch.setattr(kpcn_module, "kernel_apply", apply)


@pytest.mark.parametrize("src,code", [(torch.float32, 0), (BF16, 1),
                                      (torch.float16, 2)])
def test_entry_launch_arguments(fake_card, src, code):
    launches = fake_card.launches
    x = torch.randn(2, 27, 5, 7).to(src)
    with torch.no_grad():
        out = kpcn_layout.kpcn_entry(x, 32)
    assert out.shape == (2, 32, 5, 7) and out.dtype == BF16
    assert out.is_contiguous(memory_format=CL)
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("kpcn_entry", "sbmc_kpcn_entry",
                                     fake_card.declared(fn))
    assert args == (x.data_ptr(), code, out.data_ptr(), 2, 27, 5, 7, 32, 132)


def test_exit_launch_arguments(fake_card):
    launches = fake_card.launches
    y = torch.randn(2, 448, 5, 7).to(BF16).contiguous(memory_format=CL)
    bias = torch.nn.Parameter(torch.randn(441))
    with torch.no_grad():
        out = kpcn_layout.kpcn_exit(y, bias, 441)
    assert out.shape == (2, 441, 5, 7) and out.dtype == BF16
    assert out.is_contiguous()
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("kpcn_exit", "sbmc_kpcn_exit",
                                     fake_card.declared(fn))
    assert (args[0], args[2:]) == (y.data_ptr(), (out.data_ptr(), 2, 5, 7,
                                                  448, 441, 132))


def test_wrappers_refuse_what_the_kernels_do_not_take(fake_card):
    x = torch.randn(1, 27, 4, 4)
    y = torch.randn(1, 448, 4, 4).to(BF16).contiguous(memory_format=CL)
    flat = torch.empty(1 + y.numel(), dtype=BF16)
    misaligned = flat[1:].view(1, 4, 4, 448).permute(0, 3, 1, 2)
    assert misaligned.is_contiguous(memory_format=CL)
    bias = torch.zeros(441)
    with torch.no_grad():
        for bad, width, match in (
                (x.double(), 32, "float32, bfloat16 or float16"),
                (x.contiguous(memory_format=CL), 32, "dense NCHW"),
                (x, 30, "multiple of 8"), (x, 24, "at least")):
            with pytest.raises(ValueError, match=match):
                kpcn_layout.kpcn_entry(bad, width)
        with pytest.raises(ValueError, match="writes bfloat16"):
            kpcn_layout.kpcn_entry(x, 32, torch.float32)
        for bad, k2, match in (
                (y.float(), 441, "bfloat16"),
                (y.contiguous(), 441, "channels-last"),
                (misaligned, 441, "16-byte aligned"),
                (torch.randn(1, 12, 4, 4).to(BF16).contiguous(
                    memory_format=CL), 9, "multiple of 8"),
                (torch.randn(1, 520, 2, 2).to(BF16).contiguous(
                    memory_format=CL), 441, "up to 512"),
                (y, 449, "k2")):
            with pytest.raises(ValueError, match=match):
                kpcn_layout.kpcn_exit(bad, bias[:min(k2, 441)], k2)
        with pytest.raises(ValueError, match="bias has shape"):
            kpcn_layout.kpcn_exit(y, torch.zeros(448), 441)
    with pytest.raises(RuntimeError, match="no backward"):
        kpcn_layout.kpcn_entry(x.clone().requires_grad_(), 32)
    with pytest.raises(RuntimeError, match="no backward"):
        kpcn_layout.kpcn_exit(y.clone().requires_grad_(), bias, 441)


@pytest.mark.parametrize("arch", [FULL, TINY], ids=["full", "tiny"])
def test_channels_last_launches_per_tile(monkeypatch, fake_card, arch):
    """A chain: one entry (to the padded input width), one epilogue a
    convolution but the prediction (ReLU, in place, at the padded width, on
    each valid convolution's shrinking size) and one exit (the padded taps
    to the taps); the gathers take the exit's kernels unnormalised. 2 / 16
    / 2 a tile at the published depth."""
    launches = fake_card.launches
    _record_gathers(monkeypatch, launches)
    model = _kpcn(arch, "bfloat16")
    shrink = 4 * arch["depth"]
    h, w = shrink + 3, shrink + 5
    x = {k: fake_card.on_card(v) for k, v in _inputs(arch, 1, h, w).items()}
    with torch.no_grad():
        model(x)
    names = [entry[0] for entry in launches]
    depth = arch["depth"]
    assert (names.count("kpcn_entry"), names.count("unet_epilogue"),
            names.count("kpcn_exit")) == (2, 2 * (depth - 1), 2)
    assert names == 2 * (["kpcn_entry"] + ["unet_epilogue"] * (depth - 1)
                         + ["kpcn_exit"]) + ["kernel_apply"] * 2
    cin = kpcn_module.padded_width(arch["n_in"])
    width = kpcn_module.padded_width(arch["width"])
    k2 = arch["ksize"] ** 2
    assert launches[0][2][3:8] == (1, arch["n_in"], h, w, cin)
    # (ldo, pool, act, bs, h, w, c) of each epilogue of the first chain.
    assert [args[3:10] for _, _, args in launches[1:depth]] == [
        (width, None, unet.ACTIVATIONS["relu"], 1, h - 4 * (d + 1),
         w - 4 * (d + 1), width) for d in range(depth - 1)]
    assert launches[depth][2][3:8] == (1, h - shrink, w - shrink,
                                       kpcn_module.padded_width(k2), k2)
    assert launches[-1] == ("kernel_apply", False, (1, k2, 3, 5))


@pytest.mark.parametrize("kw,takes", [
    ({}, True), ({"ksize": 23}, False), ({"conv_dtype": None}, False)])
def test_channels_last_takes_what_the_kernels_hold(fake_card, kw, takes):
    """Fixed at construction: bf16 convs and a padded prediction the exit
    kernel holds (441 taps pad to 448; 529 to 536, beyond 512); the rule
    asked without gradients of an input on a faked card."""
    args = dict(conv_dtype="bfloat16", depth=2, width=8)
    args.update(kw)
    x = fake_card.on_card(torch.zeros(1, 27, 20, 20))
    with torch.no_grad():
        assert layers.kernel_path(KPCN(**args), x) is takes
