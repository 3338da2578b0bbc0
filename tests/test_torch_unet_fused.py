"""SBMC's U-Net in channels-last at inference (``Autoencoder.
forward_channels_last`` and ``sbmc_tpu_torch.nn.unet``) on the CPU.

On CPU tensors the epilogue and upsample ops run their plain versions, so
these tests hold the channels-last dataflow (the concatenation buffer and
its slots, the pooled epilogue, the layout changes at the boundary) to the
NCHW ``Autoencoder.forward`` on the same weights and input, and the plain
versions to the expressions they replace. The kernels' own arguments are
checked by running the wrappers' CUDA branch on CPU tensors with the launch
recorded in place of the call (the ``fake_card`` fixture); the kernels
themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:

- float32: ``|channels-last - NCHW| <= 1e-5 * max |NCHW|``. Only the
  convolutions' float32 sums differ (oneDNN blocks a channels-last
  convolution's up to 9 x 768 products in another order), a few ulps a
  layer over 15 layers; the largest difference measured is 1.5e-6 of the
  output's largest value.
- bf16: both paths round in the same places, but oneDNN's bf16
  convolutions sum their products in another order by layout and by the
  CPU's instruction set (with ``ONEDNN_MAX_CPU_ISA=AVX512_CORE`` the two
  layouts agree bit for bit; with AVX2 or AVX512-BF16 a sum's rounding
  flips here and there, which later layers carry up to 8-10 bf16 units).
  So each path is held to the float32 U-Net on the same weights and input
  in units of the NCHW path's own error (:func:`_rounding_ratios`): at
  most ``ROUNDING_L2`` (2.0) in L2 and ``ROUNDING_MAX`` (3.0) at the
  largest element. Read on three instruction sets of an AMD EPYC
  (AVX512-BF16, AVX512_CORE, AVX2) over these tests and those of
  ``test_torch_kpcn_channels_last.py``, ``test_torch_unet_train.py`` and
  ``test_torch_chain_train.py``: at most 1.36 and 1.54. A dropped bias or
  a pool read one pixel off fails every case on each.
"""

import pytest
import torch
import torch.nn.functional as F

from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.nn import layers, unet
from sbmc_tpu_torch.nn.layers import Autoencoder, ConvChain
from tests.test_torch_kernel_paths import fake_card  # noqa: F401

BF16 = torch.bfloat16
CL = torch.channels_last
F32_REL = 1e-5
#: A bf16 path's error against the float32 model on the same weights and
#: input, over the plain (NCHW) bf16 path's own error: the relative L2
#: norms' ratio and the largest elements' ratio (:func:`_rounding_ratios`).
ROUNDING_L2, ROUNDING_MAX = 2.0, 3.0


def _unet(width, dtype, seed=0, **kw):
    """The SBMC propagation U-Net at ``width`` (as ``Multisteps`` builds
    it), with random biases so that every activation sees both signs."""
    args = dict(num_levels=3, increase_factor=2.0, num_convs=3, width=width,
                ksize=3, output_type="leaky_relu", dtype=dtype)
    args.update(kw)
    torch.manual_seed(seed)
    ae = Autoencoder(width, width, **args)
    with torch.no_grad():
        for name, p in ae.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.3 * torch.randn_like(p))
    return ae


def _rounding_ratios(got, plain, f32):
    """``got``'s error against the float32 result ``f32`` in units of the
    plain bf16 path's (``plain``): the ratio of their L2 norms and of their
    largest elements. Both paths round to bf16 in the same places but sum
    in other orders (oneDNN's convolutions block their products by layout
    and by the CPU's instruction set), so their elementwise difference
    grows through the layers while their distances from ``f32`` stay
    alike."""
    f32 = f32.float()
    err, own = got.float() - f32, plain.float() - f32
    return (float(err.norm() / own.norm()),
            float(err.abs().max() / own.abs().max()))


@pytest.mark.parametrize("width", [8, 128])
@pytest.mark.parametrize("bs,h,w", [(1, 16, 20), (2, 17, 23), (1, 9, 10),
                                    (2, 12, 7)])
@pytest.mark.parametrize("dtype", [None, BF16])
def test_channels_last_matches_forward(width, bs, h, w, dtype):
    """Even and odd sizes (the pools floor, the upsamples go to the skips'
    exact sizes), batch 1 and 2, widths 8 and 128 (the flagship's: 128,
    256 and 512 channels by level), float32 and bf16 convs."""
    ae = _unet(width, dtype, seed=width + h)
    x = torch.randn(bs, width, h, w, generator=torch.Generator()
                    .manual_seed(h * w))
    with torch.no_grad():
        want = ae(x)
        got = ae.forward_channels_last(x)
        f32 = _unet(width, None, seed=width + h)(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    if dtype is None:
        err = float((got - want).abs().max())
        assert err <= F32_REL * float(want.abs().max())
    else:
        l2, mx = _rounding_ratios(got, want, f32)
        assert l2 <= ROUNDING_L2 and mx <= ROUNDING_MAX


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "linear"])
@pytest.mark.parametrize("h,w", [(6, 8), (7, 9), (3, 2)])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plain_epilogue_is_the_unfused_expression(act, h, w, dtype):
    """Into a channel slot of a channels-last buffer, with the pool: the
    slot holds ``act(y + b)`` and the pool ``F.max_pool2d`` of it, bit for
    bit; the rest of the buffer is untouched. In place without a slot."""
    g = torch.Generator().manual_seed(h * w)
    y = torch.randn(2, 16, h, w, generator=g).to(dtype).contiguous(
        memory_format=CL)
    bias = torch.randn(16, generator=g)
    r = y + bias.to(dtype)[:, None, None]
    want = {"relu": F.relu, "linear": lambda t: t,
            "leaky_relu": lambda t: F.leaky_relu(t, 0.01)}[act](r)
    buf = torch.full((2, 40, h, w), 7.0, dtype=dtype).contiguous(
        memory_format=CL)
    pool = torch.empty(2, 16, h // 2, w // 2, dtype=dtype).contiguous(
        memory_format=CL)
    out = unet.epilogue_ref(y, bias, act, buf[:, 24:], pool)
    assert out.data_ptr() == buf[:, 24:].data_ptr()
    assert torch.equal(buf[:, 24:], want)
    assert bool((buf[:, :24] == 7).all())
    assert torch.equal(pool, F.max_pool2d(want, 2))
    assert unet.epilogue(y, bias, act) is y
    assert torch.equal(y, want)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plain_relayout_is_contiguous(channels_last, dtype):
    """Dense in the asked layout, the same values; a tensor that already
    lies so comes back as it is."""
    x = torch.randn(2, 16, 5, 7).to(dtype)
    if not channels_last:
        x = x.contiguous(memory_format=CL)
    fmt = CL if channels_last else torch.contiguous_format
    got = unet.relayout(x, channels_last)
    assert got.is_contiguous(memory_format=fmt) and torch.equal(got, x)
    assert unet.relayout(got, channels_last) is got
    assert torch.equal(unet.relayout_ref(x, channels_last), x)


@pytest.mark.parametrize("hi,wi,ho,wo", [(4, 5, 8, 10), (4, 5, 9, 11),
                                         (8, 3, 17, 7), (1, 1, 3, 2),
                                         (5, 6, 5, 6)])
@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_plain_upsample_is_interpolate(hi, wi, ho, wo, dtype):
    """Into the leading channel slot of a channels-last buffer, bit for bit
    ``F.interpolate(bilinear, align_corners=False)`` at the slot's size,
    the rest of the buffer untouched."""
    g = torch.Generator().manual_seed(hi * wi + ho)
    x = torch.randn(2, 16, hi, wi, generator=g).to(dtype).contiguous(
        memory_format=CL)
    buf = torch.full((2, 24, ho, wo), 7.0, dtype=dtype).contiguous(
        memory_format=CL)
    unet.upsample(x, buf[:, :16])
    want = F.interpolate(x, size=(ho, wo), mode="bilinear",
                         align_corners=False)
    assert torch.equal(buf[:, :16], want)
    assert bool((buf[:, 16:] == 7).all())


def _samples(bs, spp, nf, ngf, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"radiance": torch.rand(bs, spp, 3, h, w, generator=g),
            "features": torch.randn(bs, spp, nf, h, w, generator=g),
            "global_features": torch.randn(bs, ngf, 1, 1, generator=g)}


@pytest.mark.parametrize("kw", [{}, {"pixel": True}, {"splat": False}])
def test_multisteps_no_grad_matches_grad_end_to_end(monkeypatch, kw):
    """The flagship's architecture at width 8: a call without gradients
    whose U-Nets run channels-last (as they do on the card; here
    ``Autoencoder.forward`` is pointed at the channels-last path whenever
    gradients are off) against the same call with gradients on, which runs
    the NCHW modules. Equal: bf16 on the CPU rounds the same in both
    layouts."""
    args = dict(n_features=5, n_global_features=3, width=8,
                embedding_width=8, ksize=3, nsteps=2,
                conv_dtype="bfloat16", return_kernels=True)
    args.update(kw)
    torch.manual_seed(0)
    model = Multisteps(**args)
    x = _samples(2, 4, 5, 3, 9, 11)
    calls = []
    forward = Autoencoder.forward

    def on_the_card(self, inp):
        if not torch.is_grad_enabled():
            calls.append(tuple(inp.shape))
            return self.forward_channels_last(inp)
        return forward(self, inp)

    monkeypatch.setattr(Autoencoder, "forward", on_the_card)
    with torch.no_grad():
        off = model(x)
    assert len(calls) == 2
    on = model(x)
    assert len(calls) == 2 and on["radiance"].requires_grad
    for key in ("radiance", "kernels"):
        assert torch.equal(off[key], on[key].detach())


@pytest.mark.parametrize("kw,takes", [
    ({}, True), ({"width": 8}, True), ({"dtype": None}, False),
    ({"width": 12}, False), ({"activation": "tanh"}, False),
    ({"output_type": "elu"}, False)])
def test_channels_last_takes_what_the_kernels_hold(monkeypatch, fake_card,
                                                   kw, takes):
    """The path is fixed by the architecture: bf16 convs, every channel
    count a multiple of 8, activations the epilogue applies (the rule asked
    without gradients of an input on a faked card). On the CPU ``forward``
    never takes it, with or without gradients."""
    args = dict(width=128, dtype=BF16)
    args.update(kw)
    width = args.pop("width")
    ae = _unet(width, **args)
    x = torch.randn(1, width, 6, 6)
    with torch.no_grad():
        assert layers.kernel_path(ae, fake_card.on_card(x)) is takes
    monkeypatch.setattr(Autoencoder, "forward_channels_last",
                        lambda self, x: pytest.fail("took channels-last"))
    with torch.no_grad():
        ae(x)
    ae(x)
    assert fake_card.launches == []


def test_flagship_unets_take_channels_last(fake_card):
    model = Multisteps(93, 3, width=128, embedding_width=128, ksize=21,
                       conv_dtype="bfloat16")
    x = fake_card.on_card(torch.zeros(1, 128, 4, 4))
    with torch.no_grad():
        assert all(layers.kernel_path(getattr(model, f"propagation_{s:02d}"),
                                      x) for s in range(3))
        assert not layers.kernel_path(
            Multisteps(93, 3, width=8, embedding_width=8, ksize=3,
                       nsteps=1).propagation_00, x)


def test_epilogue_launch_arguments(fake_card):
    launches = fake_card.launches
    y = torch.randn(2, 16, 7, 9).to(BF16).contiguous(memory_format=CL)
    bias = torch.randn(16)
    buf = torch.empty(2, 40, 7, 9, dtype=BF16, memory_format=CL)
    pool = torch.empty(2, 16, 3, 4, dtype=BF16, memory_format=CL)
    with torch.no_grad():
        assert unet.epilogue(y, bias, "leaky_relu") is y
        slot = unet.epilogue(y, bias, "relu", buf[:, 24:], pool)
    assert slot.data_ptr() == buf.data_ptr() + 24 * 2
    (n0, f0, a0), (n1, f1, a1) = launches
    assert (n0, f0, len(a0)) == ("unet_epilogue", "sbmc_unet_epilogue",
                                 fake_card.declared(f0))
    assert (a0[0], a0[2:]) == (y.data_ptr(), (y.data_ptr(), 16, None, 2, 2,
                                              7, 9, 16, 132))
    assert a1[2:] == (buf.data_ptr() + 48, 40, pool.data_ptr(), 1, 2, 7, 9,
                      16, 132)


def test_upsample_launch_arguments(fake_card):
    launches = fake_card.launches
    x = torch.randn(2, 16, 4, 5).to(BF16).contiguous(memory_format=CL)
    buf = torch.empty(2, 24, 9, 11, dtype=BF16, memory_format=CL)
    with torch.no_grad():
        unet.upsample(x, buf[:, :16])
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("unet_upsample", "sbmc_unet_upsample",
                                     fake_card.declared(fn))
    assert args == (x.data_ptr(), buf.data_ptr(), 24, 2, 4, 5, 9, 11, 16)


@pytest.mark.parametrize("channels_last", [True, False])
def test_relayout_launch_arguments(fake_card, channels_last):
    launches = fake_card.launches
    x = torch.randn(2, 16, 5, 7).to(BF16)
    if not channels_last:
        x = x.contiguous(memory_format=CL)
    with torch.no_grad():
        out = unet.relayout(x, channels_last)
    fmt = CL if channels_last else torch.contiguous_format
    assert out.is_contiguous(memory_format=fmt) and out.shape == x.shape
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("unet_layout", "sbmc_unet_layout",
                                     fake_card.declared(fn))
    assert args == (x.data_ptr(), out.data_ptr(), int(channels_last), 2, 16,
                    5, 7, 132)


def test_wrappers_refuse_what_the_kernels_do_not_take(fake_card):
    y = torch.randn(1, 16, 4, 4).to(BF16)
    bias = torch.zeros(16)
    with torch.no_grad():
        for bad, match in ((y, "channels-last"),
                           (y.float().contiguous(memory_format=CL),
                            "bfloat16"),
                           (torch.randn(1, 12, 4, 4).to(BF16).contiguous(
                               memory_format=CL), "multiple of 8")):
            with pytest.raises(ValueError, match=match):
                unet.epilogue(bad, bias[:bad.shape[1]], "relu")
        with pytest.raises(ValueError, match="activation"):
            unet.epilogue(y.contiguous(memory_format=CL), bias, "tanh")
        with pytest.raises(ValueError, match="shape"):
            unet.upsample(y.contiguous(memory_format=CL),
                          torch.empty(1, 24, 8, 8, dtype=BF16,
                                      memory_format=CL))
        with pytest.raises(ValueError, match="at least doubles"):
            unet.upsample(y.contiguous(memory_format=CL),
                          torch.empty(1, 16, 8, 7, dtype=BF16,
                                      memory_format=CL))
        with pytest.raises(ValueError, match="layout kernel"):
            unet.relayout(torch.randn(1, 12, 4, 4).to(BF16), True)
        with pytest.raises(ValueError, match="layout kernel"):
            unet.relayout(y.float(), True)
    grad = torch.randn(1, 16, 4, 4).to(BF16).contiguous(
        memory_format=CL).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        unet.epilogue(grad, bias, "relu")


@pytest.mark.parametrize("width,levels", [(8, 3), (16, 2)])
def test_channels_last_launches_per_unet(fake_card, width, levels):
    """One epilogue a convolution (15 in the flagship's U-Net), the last of
    each left level's into its concatenation buffer's skip slot with the
    pool; one upsample a level below the top (2), into the leading slot;
    one layout change on each side."""
    launches = fake_card.launches
    ae = _unet(width, BF16, num_levels=levels)
    x = torch.randn(1, width, 9, 10)
    with torch.no_grad():
        ae.forward_channels_last(x)
    names = [name for name, _, _ in launches]
    assert names.count("unet_epilogue") == 3 * (2 * levels - 1)
    assert names.count("unet_upsample") == levels - 1
    assert (names[0], names[-1], names.count("unet_layout")) == (
        "unet_layout", "unet_layout", 2)
    assert (launches[0][2][2], launches[-1][2][2]) == (1, 0)
    pooled = [args for name, _, args in launches
              if name == "unet_epilogue" and args[4] is not None]
    # (act, bs, h, w, c) of each pooled epilogue: the left levels' last
    # convolutions, ReLU, at 9x10, then 4x5.
    assert [args[5:10] for args in pooled] == [
        (1, 1, 9 // 2 ** lvl, 10 // 2 ** lvl, width * 2 ** lvl)
        for lvl in range(levels - 1)]
    ups = [args for name, _, args in launches if name == "unet_upsample"]
    # Each into a buffer of the coarse channels plus the skip's.
    assert [args[2:] for args in ups] == [
        (3 * width * 2 ** lvl, 1, 9 // 2 ** (lvl + 1), 10 // 2 ** (lvl + 1),
         9 // 2 ** lvl, 10 // 2 ** lvl, 2 * width * 2 ** lvl)
        for lvl in range(levels - 2, -1, -1)]
    # The last epilogue applies the output's leaky ReLU in place, and the
    # output's layout change reads it.
    last = launches[-2][2]
    assert last[5] == unet.ACTIVATIONS["leaky_relu"]
    assert last[2] == last[0] == launches[-1][2][0]


def test_conv_chain_keeps_its_activation_names():
    chain = ConvChain(8, 4, width=8, depth=3, activation="leaky_relu",
                      output_type="relu")
    assert (chain.activation, chain.output_type) == ("leaky_relu", "relu")
    assert [type(l).__name__ for l in chain.layers()] == ["WNConv2D"] * 3
    assert chain.layers()[-1] is chain.prediction


@pytest.mark.parametrize("cin", [8, 16])
def test_channels_last_chain_refuses_an_input_of_another_width(cin):
    """The chain's channels-last weights keep each layer's own input width,
    so an input wider or narrower than the first layer takes (a miswired
    concatenation buffer) is refused, not met by zero weights."""
    chain = ConvChain(12, 8, width=8, depth=2)
    x = torch.randn(1, cin, 6, 6).contiguous(memory_format=CL)
    with torch.no_grad(), pytest.raises(RuntimeError):
        chain.forward_channels_last(x)
