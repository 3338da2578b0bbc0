"""SBMC's U-Net channels-last in the train step (the backward of
``Autoencoder.forward_channels_last`` and of ``sbmc_tpu_torch.nn.unet``'s
epilogue and upsample) on the CPU.

On CPU tensors the backward ops run their plain versions, so these tests
hold the plain versions to PyTorch's autograd through the forward ops'
plain versions, and the autograd Function's dataflow (each convolution's
input and output saved, the concatenation buffer's gradient split into its
slots, cuDNN's part done by ``aten.convolution_backward``) to the NCHW
``Autoencoder.forward``'s autograd on the same weights and input, also
under ``torch.utils.checkpoint`` (``remat``). The kernels' own arguments and
the launches a train step makes are checked on the ``fake_card`` fixture;
the kernels themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:

- the plain backward ops against autograd in float32:
  ``|plain - autograd| <= 1e-5 * max |autograd|`` (sums of the same
  products in another order; the upsample's as two products of
  interpolation matrices);
- the Function's gradients against the NCHW autograd in float32: the same
  bound, each parameter's and the input's (measured: up to 1.3e-6);
- in bf16 the input's gradient and the biases' within the forward's bf16
  bound (``test_torch_unet_fused.py``: 4 units at most, 0.02 on average;
  measured: equal), the float32 ``v`` and ``g`` within 1e-5 of their
  largest (the weight norm's float32 sums read a channels-last weight
  gradient in another order; measured 2.4e-7).
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sbmc_tpu_torch.models import KPCN, Multisteps
from sbmc_tpu_torch.nn import layers, unet
from sbmc_tpu_torch.nn.layers import Autoencoder
from tests.test_torch_kernel_paths import fake_card  # noqa: F401
from tests.test_torch_unet_fused import (BF16_MAX_UNITS, BF16_MEAN_UNITS,
                                         _bf16_units, _unet)

BF16 = torch.bfloat16
CL = torch.channels_last
F32_REL = 1e-5


def _close(got, want, rel=F32_REL):
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def _slot(bs, c, h, w, extra, dtype, gen, lead):
    """A ``[bs, c, h, w]`` channel slot of a channels-last buffer with
    ``extra`` more channels (after it if ``lead``, else before), filled with
    random values."""
    buf = torch.randn(bs, c + extra, h, w, generator=gen).to(dtype)
    buf = buf.contiguous(memory_format=CL)
    return buf[:, :c] if lead else buf[:, extra:]


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "linear"])
@pytest.mark.parametrize("h,w", [(6, 8), (7, 9), (3, 2), (2, 5)])
@pytest.mark.parametrize("pooled", [False, True])
def test_plain_epilogue_backward_is_autograd(act, h, w, pooled):
    """float32, the gradient and the saved output as channel slots of wider
    buffers (as the skip's are), odd sizes (the last row and column get no
    pool gradient): ``dz`` and the bias gradient equal autograd's through
    :func:`unet.epilogue_ref`, which writes into a slot and pools."""
    gen = torch.Generator().manual_seed(h * w + pooled)
    y_leaf = torch.randn(2, 16, h, w, generator=gen).contiguous(
        memory_format=CL).requires_grad_()
    bias = torch.randn(16, generator=gen).requires_grad_()
    buf = torch.zeros(2, 40, h, w).contiguous(memory_format=CL)
    pool = (torch.zeros(2, 16, h // 2, w // 2).contiguous(memory_format=CL)
            if pooled else None)
    out = unet.epilogue_ref(y_leaf.clone(), bias, act, buf[:, 24:], pool)
    dy = _slot(2, 16, h, w, 8, torch.float32, gen, lead=False)
    loss = (out * dy).sum()
    dpool = None
    if pooled:
        dpool = torch.randn(pool.shape, generator=gen).contiguous(
            memory_format=CL)
        loss = loss + (pool * dpool).sum()
    want_dz, want_db = torch.autograd.grad(loss, (y_leaf, bias))
    dz, db = unet.epilogue_backward_ref(dy, out.detach(), act, dpool)
    assert dz.is_contiguous(memory_format=CL) and db.dtype == torch.float32
    assert _close(dz, want_dz) and _close(db, want_db)
    if not pooled:
        assert torch.equal(dz, want_dz)


def test_plain_epilogue_backward_routes_ties_to_the_first():
    """A 2x2 window of equal values gives its pool gradient to its first
    pixel in row-major order (as ``F.max_pool2d`` picks it), a NaN takes it
    from any number; the gradient joins the skip slot's with one rounding,
    then the ReLU's derivative (zero where the output is not positive)."""
    out = torch.tensor([[1.0, 1.0, 0.0, 2.0], [1.0, 1.0, float("nan"), 2.0],
                        [0.0, 0.0, 3.0, 3.0]]).to(BF16)[None, None]
    out = out.expand(1, 8, 3, 4).contiguous(memory_format=CL)
    dy = torch.full((1, 8, 3, 4), 0.5).to(BF16).contiguous(memory_format=CL)
    dpool = torch.tensor([[2.0, 4.0]]).to(BF16)[None, None].expand(
        1, 8, 1, 2).contiguous(memory_format=CL)
    dz, db = unet.epilogue_backward_ref(dy, out, "relu", dpool)
    want = torch.tensor([[2.5, 0.5, 0.0, 0.5], [0.5, 0.5, 4.5, 0.5],
                         [0.0, 0.0, 0.5, 0.5]])
    assert torch.equal(dz[0, 3].float(), want)
    assert torch.equal(db, torch.full((8,), float(want.sum())))


@pytest.mark.parametrize("hi,wi,ho,wo", [(4, 5, 8, 10), (4, 5, 9, 11),
                                         (8, 3, 17, 7), (1, 1, 3, 2),
                                         (2, 2, 9, 13)])
def test_plain_upsample_backward_is_autograd(hi, wi, ho, wo):
    """float32, the gradient read from the upsampled slot of a wider
    buffer: equal to autograd's through :func:`unet.upsample_ref`, at
    doublings, odd sizes and more than a doubling."""
    gen = torch.Generator().manual_seed(hi * wi + ho)
    x = torch.randn(2, 16, hi, wi, generator=gen).contiguous(
        memory_format=CL).requires_grad_()
    up = unet.upsample_ref(x, torch.empty(2, 16, ho, wo))
    g = _slot(2, 16, ho, wo, 8, torch.float32, gen, lead=True)
    want, = torch.autograd.grad((up * g).sum(), x)
    got = unet.upsample_backward_ref(g, (hi, wi))
    assert got.shape == x.shape and got.is_contiguous(memory_format=CL)
    assert _close(got, want)


def _grads(fn, ae, x, cot):
    params = [x] + list(ae.parameters())
    return torch.autograd.grad((fn(x).float() * cot).sum(), params)


@pytest.mark.parametrize("levels,bs,h,w", [(3, 2, 17, 23), (3, 1, 16, 20),
                                           (2, 1, 9, 10), (1, 1, 6, 7)])
@pytest.mark.parametrize("remat", [False, True])
def test_channels_last_gradients_match_forward(levels, bs, h, w, remat):
    """float32 at width 8: the gradients of the input and of every ``v``,
    ``g`` and ``bias`` through the channels-last Function equal the NCHW
    modules' to rounding; also recomputed under
    ``torch.utils.checkpoint``, as ``Multisteps(remat=True)`` runs it."""
    ae = _unet(8, None, seed=h, num_levels=levels)
    gen = torch.Generator().manual_seed(w)
    x = torch.randn(bs, 8, h, w, generator=gen).requires_grad_()
    cot = torch.randn(bs, 8, h, w, generator=gen)
    fn = ae.forward_channels_last
    if remat:
        def fn(t):
            return checkpoint(ae.forward_channels_last, t,
                              use_reentrant=False)
    got = _grads(fn, ae, x, cot)
    want = _grads(ae, ae, x, cot)
    names = ["input"] + [n for n, _ in ae.named_parameters()]
    assert len(got) == len(want) == 1 + 3 * 3 * (2 * levels - 1)
    for name, g, w_ in zip(names, got, want):
        assert g.shape == w_.shape and _close(g, w_), name


def test_channels_last_gradients_match_forward_bf16():
    """bf16 convs at width 16: the same forward bit for bit on the CPU, the
    input's and biases' gradients within the forward's bf16 bound of the
    NCHW modules', ``v`` and ``g`` to float32 rounding."""
    ae = _unet(16, BF16, seed=3)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 16, 17, 23, generator=gen).to(BF16).requires_grad_()
    cot = torch.randn(2, 16, 17, 23, generator=gen)
    with torch.no_grad():
        assert torch.equal(ae.forward_channels_last(x), ae(x))
    got = _grads(ae.forward_channels_last, ae, x, cot)
    want = _grads(ae, ae, x, cot)
    names = ["input"] + [n for n, _ in ae.named_parameters()]
    for name, g, w_ in zip(names, got, want):
        assert g.dtype == w_.dtype, name
        if name == "input" or name.endswith("bias"):
            mx, mean = _bf16_units(g, w_)
            assert mx <= BF16_MAX_UNITS and mean <= BF16_MEAN_UNITS, name
        else:
            assert _close(g, w_), name


def test_kernel_path_with_gradients(fake_card):
    """With gradients on, the U-Net takes its kernels on the card for bf16
    convs (its kernels have a backward), not for float32 convs or on the
    CPU; the per-sample chain kernel and KPCN's kernels, which have none,
    are refused."""
    x = torch.randn(1, 8, 6, 6)
    on_card = fake_card.on_card(x)
    assert layers.kernel_path(_unet(8, BF16), on_card)
    assert not layers.kernel_path(_unet(8, None), on_card)
    assert not layers.kernel_path(_unet(8, BF16), x)
    ms = Multisteps(5, 3, width=8, embedding_width=8, ksize=3, nsteps=1,
                    conv_dtype="bfloat16")
    kp = KPCN(n_in=5, ksize=3, depth=3, width=12, conv_dtype="bfloat16")
    for model in (ms, kp):
        assert not model.kernels_backward
        assert not layers.kernel_path(model, on_card)
    assert fake_card.asked == []
    with torch.no_grad():
        assert layers.kernel_path(kp, on_card)


def test_epilogue_backward_launch_arguments(fake_card):
    launches = fake_card.launches
    out_buf = torch.empty(2, 40, 7, 9, dtype=BF16, memory_format=CL)
    dy_buf = torch.empty(2, 24, 7, 9, dtype=BF16, memory_format=CL)
    dpool = torch.empty(2, 16, 3, 4, dtype=BF16, memory_format=CL)
    y = torch.empty(2, 16, 7, 9, dtype=BF16, memory_format=CL)
    dz, db = unet.epilogue_backward(dy_buf[:, 8:], out_buf[:, 24:], "relu",
                                    dpool)
    dz2, _ = unet.epilogue_backward(y, y, "leaky_relu")
    assert dz.shape == (2, 16, 7, 9) and dz.is_contiguous(memory_format=CL)
    assert db.shape == (16,) and db.dtype == torch.float32
    (n0, f0, a0), (_, _, a1) = launches
    assert (n0, f0, len(a0)) == ("unet_epilogue_backward",
                                 "sbmc_unet_epilogue_backward",
                                 fake_card.declared(f0))
    # dy, ldy, out, ldo, dpool, act, dz, partials, nparts, dbias, bs, h, w,
    # c, sms: a row of bias sums for each of up to 8 blocks an SM.
    assert a0[:7] == (dy_buf.data_ptr() + 16, 24, out_buf.data_ptr() + 48,
                      40, dpool.data_ptr(), 1, dz.data_ptr())
    assert (a0[8], a0[9]) == (8 * 132, db.data_ptr())
    assert a0[10:] == (2, 7, 9, 16, 132)
    assert a1[:6] == (y.data_ptr(), 16, y.data_ptr(), 16, None, 2)


def test_upsample_backward_launch_arguments(fake_card):
    launches = fake_card.launches
    buf = torch.empty(2, 24, 9, 11, dtype=BF16, memory_format=CL)
    dx = unet.upsample_backward(buf[:, :16], (4, 5))
    assert dx.shape == (2, 16, 4, 5) and dx.is_contiguous(memory_format=CL)
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("unet_upsample_backward",
                                     "sbmc_unet_upsample_backward",
                                     fake_card.declared(fn))
    assert args == (buf.data_ptr(), 24, dx.data_ptr(), 2, 4, 5, 9, 11, 16)


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(fake_card):
    y = torch.empty(1, 16, 4, 4, dtype=BF16, memory_format=CL)
    for dy, match in ((y.contiguous(), "channels-last"),
                      (y.float(), "bfloat16"),
                      (torch.empty(1, 16, 4, 5, dtype=BF16,
                                   memory_format=CL), "shape")):
        with pytest.raises(ValueError, match=match):
            unet.epilogue_backward(dy, y, "relu")
    with pytest.raises(ValueError, match="activation"):
        unet.epilogue_backward(y, y, "tanh")
    with pytest.raises(ValueError, match="dense"):
        unet.epilogue_backward(y, y, "relu", torch.empty(
            1, 24, 2, 2, dtype=BF16, memory_format=CL)[:, :16])
    with pytest.raises(ValueError, match="at least doubles"):
        unet.upsample_backward(y, (3, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        unet.epilogue_backward(y.clone().requires_grad_(), y, "relu")


@pytest.mark.parametrize("remat", [False, True])
def test_train_launches_per_unet(fake_card, remat):
    """The flagship's U-Net structure at width 8 under gradients on a faked
    card: the forward's 15 epilogues, 2 upsamples and 2 layout changes, then
    the backward's 15 epilogue backwards (the left levels' last with the
    pool's gradient), 2 upsample backwards (each from the upsampled slot of
    the concatenation buffer's gradient) and 2 layout changes; under
    ``remat`` the forward runs again in the backward."""
    launches = fake_card.launches
    ae = _unet(8, BF16)
    x = fake_card.on_card(torch.randn(1, 8, 9, 10)).requires_grad_()
    fn = ae.forward_channels_last
    if remat:
        def fn(t):
            return checkpoint(ae.forward_channels_last, t,
                              use_reentrant=False)
    out = fn(x)
    names = [name for name, _, _ in launches]
    forward = {"unet_epilogue": 15, "unet_upsample": 2, "unet_layout": 2}
    assert {n: names.count(n) for n in names} == forward
    del launches[:]
    dx, = torch.autograd.grad(out.float().sum(), x)
    assert dx.shape == x.shape
    names = [name for name, _, args in launches]
    want = {"unet_epilogue_backward": 15, "unet_upsample_backward": 2,
            "unet_layout": 2}
    if remat:
        want = {**forward, **want, "unet_layout": 4}
    assert {n: names.count(n) for n in names} == want
    bwd = [args for name, _, args in launches
           if name == "unet_epilogue_backward"]
    # (ldy, act, h, w, c) from the output backwards: right_0 (the output's
    # leaky ReLU first), right_1, the bottom, then left_1 and left_0, whose
    # last convolutions read the skip slots (ldy 48 and 24) with a pool.
    assert [(a[1], a[4] is not None, a[5], a[11], a[12], a[13])
            for a in bwd] == [
        (8, False, 2, 9, 10, 8), (8, False, 1, 9, 10, 8),
        (8, False, 1, 9, 10, 8), (16, False, 1, 4, 5, 16),
        (16, False, 1, 4, 5, 16), (16, False, 1, 4, 5, 16),
        (32, False, 1, 2, 2, 32), (32, False, 1, 2, 2, 32),
        (32, False, 1, 2, 2, 32), (48, True, 1, 4, 5, 16),
        (16, False, 1, 4, 5, 16), (16, False, 1, 4, 5, 16),
        (24, True, 1, 9, 10, 8), (8, False, 1, 9, 10, 8),
        (8, False, 1, 9, 10, 8)]
    ups = [args for name, _, args in launches
           if name == "unet_upsample_backward"]
    # (ldg, bs, hi, wi, ho, wo, c): from the 24-channel buffer of level 0,
    # then the 48-channel one of level 1.
    assert [a[1:2] + a[3:] for a in ups] == [(24, 1, 4, 5, 9, 10, 16),
                                            (48, 1, 2, 2, 4, 5, 32)]
