"""The per-sample 1x1 chains of SBMC (``sbmc_tpu_torch.nn.sample_chain``)
on the CPU.

- The plain versions (``embedding_step_ref``, ``regress_ref``) are held bit
  for bit to the unfused code ``Multisteps`` ran before the kernel
  (``_unfused_embedding``, ``_unfused_regress`` below), at step 0 (the
  global features), steps >= 1 and the regressor; 1, 4 and 8 samples, with
  and without a sample mask, odd image sizes, hidden widths 8 and 128, in
  float32 and bfloat16.
- The kernel's arithmetic, emulated in float32 from the operands the
  wrapper lays out for it (``embedding_weights``, ``regressor_weights``,
  read back through the kernel's chunk swizzle): the split first layer
  ``W_f . feats + W_e . extra``, each layer's product rounded to bf16, the
  bias added and rounded again, the activation, the masked mean's two
  roundings, the logit clamp. It differs from the plain version only by
  the order of float32 sums, so it agrees with it to a rounding flip that
  propagates (bounds below).
- ``Multisteps`` under ``torch.no_grad()`` against the same call with
  gradients on, with ``pixel=True`` and ``splat=False``: on the CPU both run
  the plain versions.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from sbmc_tpu_torch.models.multisteps import Multisteps
from sbmc_tpu_torch.nn import sample_chain
from sbmc_tpu_torch.nn.layers import ConvChain
from tests.test_torch_kernel_paths import fake_card  # noqa: F401

BF16 = torch.bfloat16


def _unfused_embedding(chain, feats, extra, mask_f, n_valid):
    """Multisteps' embedding step and masked mean as written before the
    kernel."""
    bs, spp, _, h, w = feats.shape
    extra = extra[:, None].expand(bs, spp, extra.shape[1], h, w)
    flat = torch.cat([feats, extra], dim=2)
    flat = chain(flat.reshape(bs * spp, -1, h, w))
    feats = flat.reshape(bs, spp, -1, h, w)
    reduced = ((feats * mask_f[:, :, None, None, None]).sum(dim=1)
               / n_valid[:, None, None, None])
    return feats, reduced


def _unfused_regress(chain, feats_s, propagated, kernel_dtype):
    kernels = chain(torch.cat([feats_s, propagated], dim=1))
    kernels = kernels.clamp(-3e4, 3e4)
    if kernel_dtype is not None:
        kernels = kernels.to(kernel_dtype)
    return kernels.contiguous()


def _chain(cin, cout, width, dtype, activation="relu", seed=0):
    torch.manual_seed(seed)
    chain = ConvChain(cin, cout, ksize=1, width=width, depth=3,
                      activation=activation, dtype=dtype)
    with torch.no_grad():
        for name, p in chain.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.3 * torch.randn_like(p))
    return chain


def _mask(bs, spp, masked, dtype):
    if not masked:
        mask_f = torch.ones(bs, spp, dtype=dtype)
    else:
        g = torch.Generator().manual_seed(7)
        mask_f = (torch.rand(bs, spp, generator=g) < 0.6).to(dtype)
        mask_f[0, 0] = 0  # at least one invalid sample
    return mask_f, mask_f.sum(dim=1).clamp(min=1.0)


def _step_inputs(step, bs, spp, h, w, cx, ce, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(bs, spp, cx, h, w, generator=g).to(dtype)
    if step == 0:
        extra = torch.randn(bs, ce, 1, 1, generator=g).to(dtype)
    else:
        extra = torch.randn(bs, ce, h, w, generator=g).to(dtype)
    return feats, extra


STEPS = [(0, 13, 3), (1, 16, 8)]  # (step, feature channels, extra channels)


@pytest.mark.parametrize("step,cx,ce", STEPS)
@pytest.mark.parametrize("spp,masked", [(1, False), (4, False), (4, True),
                                        (8, True)])
@pytest.mark.parametrize("width", [8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_embedding_step_is_the_unfused_code(step, cx, ce, spp, masked,
                                                  width, dtype):
    chain = _chain(cx + ce, 16, width, None if dtype == torch.float32
                   else dtype)
    feats, extra = _step_inputs(step, 2, spp, 5, 7, cx, ce, dtype)
    mask_f, n_valid = _mask(2, spp, masked, dtype)
    with torch.no_grad():
        got = sample_chain.embedding_step_ref(chain, feats, extra, mask_f,
                                              n_valid)
        want = _unfused_embedding(chain, feats, extra, mask_f, n_valid)
        # The dispatching op runs the plain version for CPU tensors.
        op = sample_chain.embedding_step(chain, feats, extra, mask_f,
                                         n_valid)
    for g, o, want_ in zip(got, op, want):
        assert g.dtype == want_.dtype and g.shape == want_.shape
        assert torch.equal(g, want_) and torch.equal(o, want_)


@pytest.mark.parametrize("kernel_dtype", [None, BF16, torch.float32])
@pytest.mark.parametrize("width", [8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_regress_is_the_unfused_code(kernel_dtype, width, dtype):
    chain = _chain(16 + 8, 25, width,
                   None if dtype == torch.float32 else dtype,
                   activation="leaky_relu")
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(2, 4, 16, 5, 7, generator=g).to(dtype)
    prop = torch.randn(2, 8, 5, 7, generator=g).to(dtype)
    with torch.no_grad():
        for s in range(4):
            got = sample_chain.regress_ref(chain, feats[:, s], prop,
                                           kernel_dtype)
            op = sample_chain.regress(chain, feats[:, s], prop, kernel_dtype)
            want = _unfused_regress(chain, feats[:, s], prop, kernel_dtype)
            assert got.dtype == want.dtype and got.is_contiguous()
            assert torch.equal(got, want) and torch.equal(op, want)


def test_plain_regress_clamps_overflowing_logits():
    chain = _chain(4, 9, 8, BF16, activation="leaky_relu")
    with torch.no_grad():
        chain.prediction.bias.fill_(1e6)
        x = torch.ones(1, 2, 3, 3, dtype=BF16)
        got = sample_chain.regress_ref(chain, x, x, None)
    assert float(got.float().max()) == float(torch.tensor(3e4).to(BF16))


# The kernel's arithmetic, emulated.

def _rbf(x):
    return x.to(BF16).float()


def _unswizzle(t):
    """A matrix laid out by ``kernel_layout`` (``[k // 64, rows, 64]``),
    read back as the kernel's descriptors address it: chunk j of row n of a
    block at j ^ (n & 7)."""
    nb, rows, _ = t.shape
    n = torch.arange(rows)[None, :, None]
    j = torch.arange(8)[None, None, :]
    pos = (j ^ (n & 7)).expand(nb, rows, 8)
    back = t.view(nb, rows, 8, 8).gather(
        2, pos[..., None].expand(nb, rows, 8, 8))
    return back.permute(1, 0, 2, 3).reshape(rows, nb * 64).float()


def _hidden(acc, bias, leaky):
    z = _rbf(_rbf(acc) + bias)
    if leaky:
        return torch.where(z > 0, z, _rbf(z * 0.01))
    return torch.where(z < 0, torch.zeros_like(z), z)


def _emulate_embedding(chain, feats, extra, mask_f, n_valid):
    bs, spp, cx, h, w = feats.shape
    ops = sample_chain.embedding_weights(chain, cx, extra)
    bias = ops["bias"].float().view(3, sample_chain.HIDDEN)
    x = feats.float().permute(0, 1, 3, 4, 2)
    if ops["ebias"] is not None:
        e = ops["ebias"][:, None, None, None, :]
    else:
        we = _unswizzle(ops["we"])[:, :extra.shape[1]]
        e = (extra.float().permute(0, 2, 3, 1) @ we.T)[:, None]
    acc = e + x @ _unswizzle(ops["wx"])[:, :cx].T
    a = _hidden(acc, bias[0], False)
    a = _hidden(a @ _unswizzle(ops["w1"]).T, bias[1], False)
    out = _rbf(_rbf(a @ _unswizzle(ops["w2"]).T) + bias[2])
    m = mask_f.float()[:, :, None, None, None]
    red = _rbf(_rbf((out * m).sum(1)) / n_valid.float()[:, None, None, None])
    cout = ops["cout"]
    return (out[..., :cout].permute(0, 1, 4, 2, 3).to(BF16),
            red[..., :cout].permute(0, 3, 1, 2).to(BF16))


def _emulate_regress(chain, feats_s, prop):
    ops = sample_chain.regressor_weights(chain)
    hid = sample_chain.HIDDEN
    bias = ops["bias"].float()
    x = torch.cat([feats_s, prop], 1).float().permute(0, 2, 3, 1)
    a = _hidden(x @ _unswizzle(ops["w0"])[:, :ops["k_in"]].T, bias[:hid],
                True)
    a = _hidden(a @ _unswizzle(ops["w1"]).T, bias[hid:2 * hid], True)
    w2 = torch.cat([_unswizzle(c) for c in ops["w2"]])
    z = _rbf(_rbf(a @ w2.T) + bias[2 * hid:])
    z = _rbf(z.clamp(-3e4, 3e4))
    return z[..., :ops["nout"]].permute(0, 3, 1, 2).to(BF16)


def _bf16_units(got, want):
    """|got - want| over the bf16 spacing at the larger of |want| and the
    tensor's mean magnitude (a rounding flip deep in the chain moves small
    outputs by the spacing of its own scale)."""
    want = want.float()
    scale = torch.maximum(want.abs(), want.abs().mean().expand_as(want))
    ulp = torch.pow(2.0, torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
    return (got.float() - want).abs() / ulp


# A rounding flip of one hidden activation (one bf16 unit) propagates into
# the outputs it feeds: up to 3 units in 0.35% of the outputs at most, at
# these shapes (mean 0.002 units), against the bounds below.
MAX_UNITS, MEAN_UNITS = 4.0, 0.01


@pytest.mark.parametrize("step,cx,ce", [(0, 93, 3), (1, 128, 128),
                                        (1, 16, 8)])
@pytest.mark.parametrize("spp,masked", [(1, False), (4, True), (8, False)])
@pytest.mark.parametrize("width", [8, 128])
def test_emulated_kernel_embedding_matches_plain(step, cx, ce, spp, masked,
                                                 width):
    cout = 128 if cx == 128 else 16
    chain = _chain(cx + ce, cout, width, BF16)
    feats, extra = _step_inputs(step, 2, spp, 5, 7, cx, ce, BF16)
    mask_f, n_valid = _mask(2, spp, masked, BF16)
    with torch.no_grad():
        got = _emulate_embedding(chain, feats, extra, mask_f, n_valid)
        want = sample_chain.embedding_step_ref(chain, feats, extra, mask_f,
                                               n_valid)
    for g, w_ in zip(got, want):
        units = _bf16_units(g, w_)
        assert float(units.max()) <= MAX_UNITS
        assert float(units.mean()) <= MEAN_UNITS


@pytest.mark.parametrize("width,cx,ce,nout", [(128, 128, 128, 441),
                                              (8, 16, 8, 25)])
def test_emulated_kernel_regress_matches_plain(width, cx, ce, nout):
    chain = _chain(cx + ce, nout, width, BF16, activation="leaky_relu")
    g = torch.Generator().manual_seed(5)
    feats = torch.randn(2, 3, cx, 5, 7, generator=g).to(BF16)
    prop = torch.randn(2, ce, 5, 7, generator=g).to(BF16)
    with torch.no_grad():
        for s in range(3):
            got = _emulate_regress(chain, feats[:, s], prop)
            want = sample_chain.regress_ref(chain, feats[:, s], prop, None)
            units = _bf16_units(got, want)
            assert float(units.max()) <= MAX_UNITS
            assert float(units.mean()) <= MEAN_UNITS


def test_kernel_layout_reads_back():
    w = torch.randn(100, 93)
    lay = sample_chain.kernel_layout(w, 128, 128)
    assert lay.shape == (2, 128, 64) and lay.dtype == BF16
    back = _unswizzle(lay)
    assert torch.equal(back[:100, :93], w.to(BF16).float())
    assert not back[100:].any() and not back[:, 93:].any()


def _flagship(**kw):
    args = dict(n_features=93, n_global_features=3, width=128,
                embedding_width=128, ksize=21, conv_dtype="bfloat16")
    args.update(kw)
    return Multisteps(**args)


@pytest.mark.parametrize("kw,asked", [
    ({}, [("embed", 93, 0, 128, 128), ("embed", 128, 128, 128, 128),
          ("embed", 128, 128, 128, 128), ("regress", 256, 128, 441)]),
    ({"width": 8, "embedding_width": 8, "nsteps": 2},
     [("embed", 93, 0, 8, 8), ("embed", 8, 8, 8, 8), ("regress", 16, 8, 441)]),
    ({"width": 256, "nsteps": 1},
     [("embed", 93, 0, 256, 128), ("regress", 384, 256, 441)]),
    ({"embedding_width": 192, "ksize": 5, "nsteps": 1},
     [("embed", 93, 0, 128, 192), ("regress", 320, 128, 25)])])
def test_chains_fit_asks_the_kernel_for_every_chain(fake_card, kw, asked):
    """``Multisteps.kernels_fit`` asks the kernel's build about each chain
    with the channels the chain takes (step 0's global features a vector a
    batch item, later steps' propagated features per pixel)."""
    assert _flagship(**kw).kernels_fit is True
    assert fake_card.asked == asked


def test_chains_fit_takes_the_kernels_no(fake_card):
    fake_card.answer = 0
    assert _flagship().kernels_fit is False
    assert fake_card.asked == [("embed", 93, 0, 128, 128)]


@pytest.mark.parametrize("ksize,depth,k_in", [(3, 3, 16), (1, 2, 16),
                                              (1, 3, 17)])
def test_fits_refuses_other_chains_without_asking(fake_card, ksize, depth,
                                                  k_in):
    """A chain that is not three 1x1 convs on the given channels is refused
    before the kernel's build is asked."""
    chain = ConvChain(16, 8, ksize=ksize, width=8, depth=depth)
    assert sample_chain.regress_fits(chain, k_in) is False
    assert sample_chain.embedding_fits(chain, k_in - 8, 8, True) is False
    assert fake_card.asked == []


@pytest.mark.parametrize("step", [0, 1])
def test_embedding_step_launch_arguments(fake_card, step):
    launches = fake_card.launches
    cx, ce = (93, 3) if step == 0 else (128, 128)
    chain = ConvChain(cx + ce, 128, ksize=1, width=128, depth=3, dtype=BF16)
    feats = torch.randn(2, 4, cx, 9, 11).to(BF16)
    extra = torch.randn(2, ce, *((1, 1) if step == 0 else (9, 11))).to(BF16)
    mask_f = torch.ones(2, 4, dtype=BF16)
    with torch.no_grad():
        out, reduced = sample_chain.embedding_step(chain, feats, extra,
                                                   mask_f, mask_f.sum(1))
    assert out.shape == (2, 4, 128, 9, 11) and reduced.shape == (2, 128, 9,
                                                                 11)
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("sample_chain", "sbmc_sample_embed",
                                     fake_card.declared(fn))
    assert args[:5] == (feats.data_ptr(), feats.stride(0), feats.stride(1),
                        cx, 128)
    if step == 0:
        assert args[5] is None and args[6:8] == (0, 0) and args[8]
    else:
        assert args[5] and args[6:8] == (128, 128) and args[8] is None
    assert args[16:18] == (out.data_ptr(), reduced.data_ptr())
    # cout, bs, spp, h * w, and the grid: 14 warp tiles of 16 pixels, 8 a
    # block.
    assert args[18:] == (128, 2, 4, 99, 2)


def test_regress_launch_arguments(fake_card):
    launches = fake_card.launches
    chain = ConvChain(256, 441, ksize=1, width=128, depth=3,
                      activation="leaky_relu", output_type="linear",
                      dtype=BF16)
    feats = torch.randn(2, 4, 128, 9, 11).to(BF16)
    prop = torch.randn(2, 128, 9, 11).to(BF16)
    with torch.no_grad():
        got = sample_chain.regress(chain, feats[:, 1], prop, torch.float32)
    assert got.shape == (2, 441, 9, 11) and got.dtype == torch.float32
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("sample_chain", "sbmc_sample_regress",
                                     fake_card.declared(fn))
    assert args[:6] == (feats[:, 1].data_ptr(), 4 * 128 * 99, 128,
                        prop.data_ptr(), 128, 256)
    assert args[11:] == (441, 2, 99, 2)


def test_wrappers_refuse_what_the_kernel_does_not_hold(fake_card):
    fake_card.answer = 0
    chain = ConvChain(256, 128, ksize=1, width=128, depth=3, dtype=BF16)
    feats = torch.randn(1, 2, 128, 4, 4).to(BF16)
    ones = torch.ones(1, 2, dtype=BF16)
    with torch.no_grad(), pytest.raises(ValueError, match="do not fit"):
        sample_chain.embedding_step(chain, feats, feats[:, 0], ones,
                                    ones.sum(1))
    with torch.no_grad(), pytest.raises(ValueError, match="do not fit"):
        sample_chain.regress(chain, feats[:, 0], feats[:, 1], None)


def _samples(bs, spp, nf, ngf, h, w, masked=False, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {"radiance": torch.rand(bs, spp, 3, h, w, generator=g),
           "features": torch.randn(bs, spp, nf, h, w, generator=g),
           "global_features": torch.randn(bs, ngf, 1, 1, generator=g)}
    if masked:
        out["sample_mask"] = torch.rand(bs, spp, generator=g) < 0.7
    return out


@pytest.mark.parametrize("kw", [{}, {"pixel": True}, {"splat": False},
                                {"conv_dtype": None}])
@pytest.mark.parametrize("masked", [False, True])
def test_multisteps_no_grad_matches_grad(kw, masked):
    args = dict(n_features=5, n_global_features=3, width=8,
                embedding_width=8, ksize=3, nsteps=2,
                conv_dtype="bfloat16", return_kernels=True)
    args.update(kw)
    torch.manual_seed(0)
    model = Multisteps(**args)
    x = _samples(2, 4, 5, 3, 9, 11, masked=masked)
    with torch.no_grad():
        off = model(x)
    on = model(x)
    assert on["radiance"].requires_grad
    for key in ("radiance", "kernels"):
        assert torch.equal(off[key], on[key].detach())
