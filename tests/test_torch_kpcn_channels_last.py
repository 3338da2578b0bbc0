"""KPCN's conv chains in channels-last at inference (``KPCN.
forward_channels_last`` and ``sbmc_tpu_torch.nn.kpcn_layout``) on the CPU.

On CPU tensors the entry, epilogue and exit ops run their plain versions,
so these tests hold the channels-last dataflow (the padded widths and
weights, the pad channels' zeros, the bias and softmax in the exit) to the
NCHW ``KPCN.forward`` on the same weights and inputs, and the plain versions
to the expressions they replace. The kernels' own arguments are checked by
running the wrappers' CUDA branch on CPU tensors with the launch recorded in
place of the call; the kernels themselves are held to the plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances (as ``tests/test_torch_unet_fused.py``'s):

- float32: ``|channels-last - NCHW| <= 1e-5 * max |NCHW|``. Only the
  convolutions' float32 sums differ (oneDNN sums a channels-last
  convolution over its padded channels in another order).
- bf16: at most 4 bf16 units at the larger of ``|NCHW|`` and the output's
  mean magnitude, 0.02 units on average. A sum taken in another order can
  flip one product's rounding to bf16, which moves the values it feeds in
  later layers by a unit or two; on the CPU (oneDNN) the two agree bit for
  bit.
"""

import pytest
import torch

from sbmc_tpu_torch import ops
from sbmc_tpu_torch.models import KPCN
from sbmc_tpu_torch.models import kpcn as kpcn_module
from sbmc_tpu_torch.nn import kpcn_layout, unet
from sbmc_tpu_torch.ops import _build

BF16 = torch.bfloat16
CL = torch.channels_last
F32_REL = 1e-5
BF16_MAX_UNITS, BF16_MEAN_UNITS = 4.0, 0.02
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


def _bf16_units(got, want):
    want = want.float()
    scale = torch.maximum(want.abs(), want.abs().mean().expand_as(want))
    ulp = torch.pow(2.0, torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
    units = (got.float() - want).abs() / ulp
    return float(units.max()), float(units.mean())


def _close(got, want, dtype):
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype is None:
        err = float((got - want).abs().max())
        assert err <= F32_REL * float(want.abs().max())
    else:
        mx, mean = _bf16_units(got, want)
        assert mx <= BF16_MAX_UNITS and mean <= BF16_MEAN_UNITS


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
    for key in ("radiance", "diffuse", "specular"):
        assert got[key].shape == (bs, 3, dh, dw)
        _close(got[key], want[key], dtype)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_padded_weights_follow_the_parameters(dtype):
    """The padded weights are made each call: after an update of the
    parameters the channels-last path follows it."""
    model = _kpcn(TINY, dtype)
    x = _inputs(TINY, 1, 20, 21)
    with torch.no_grad():
        before = model.forward_channels_last(x)["radiance"]
        model.diffuse.layer_1.v.mul_(1.5)
        model.specular.prediction.bias.add_(0.2)
        got = model.forward_channels_last(x)["radiance"]
        want = model(x)["radiance"]
    assert not torch.equal(got, before)
    _close(got, want, dtype)


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


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that ``forward``'s
    choice of path can be watched here."""

    @property
    def is_cuda(self):
        return True


def _fake_card(monkeypatch):
    """Runs the wrappers' CUDA branch on CPU tensors: each launch's
    arguments are recorded in place of the call (the epilogue's too), and
    ``kernel_apply`` returns zeros after noting whether it normalised."""
    names = list(_build._CUDA["kpcn.cu"]) + list(_build._CUDA["unet.cu"])
    lib = type("Lib", (), {name: name for name in names})()
    launches = []
    monkeypatch.setattr(kpcn_layout, "_load", lambda: lib)
    monkeypatch.setattr(unet, "_load", lambda: lib)
    monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ops, "_launch", lambda name, fn, device, *args:
                        launches.append((name, fn, args)))

    def apply(data, kernels, softmax, splat):
        launches.append(("kernel_apply", softmax, tuple(kernels.shape)))
        return torch.zeros_like(data), None

    monkeypatch.setattr(kpcn_module, "kernel_apply", apply)
    return launches


def _declared(fn):
    """The argument count the ctypes binding declares, the stream left
    out."""
    return len(_build._CUDA["kpcn.cu"][fn]) - 1


@pytest.mark.parametrize("src,code", [(torch.float32, 0), (BF16, 1),
                                      (torch.float16, 2)])
def test_entry_launch_arguments(monkeypatch, src, code):
    launches = _fake_card(monkeypatch)
    x = torch.randn(2, 27, 5, 7).to(src)
    with torch.no_grad():
        out = kpcn_layout.kpcn_entry(x, 32)
    assert out.shape == (2, 32, 5, 7) and out.dtype == BF16
    assert out.is_contiguous(memory_format=CL)
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("kpcn_entry", "sbmc_kpcn_entry",
                                     _declared(fn))
    assert args == (x.data_ptr(), code, out.data_ptr(), 2, 27, 5, 7, 32, 132)


def test_exit_launch_arguments(monkeypatch):
    launches = _fake_card(monkeypatch)
    y = torch.randn(2, 448, 5, 7).to(BF16).contiguous(memory_format=CL)
    bias = torch.nn.Parameter(torch.randn(441))
    with torch.no_grad():
        out = kpcn_layout.kpcn_exit(y, bias, 441)
    assert out.shape == (2, 441, 5, 7) and out.dtype == BF16
    assert out.is_contiguous()
    [(name, fn, args)] = launches
    assert (name, fn, len(args)) == ("kpcn_exit", "sbmc_kpcn_exit",
                                     _declared(fn))
    assert (args[0], args[2:]) == (y.data_ptr(), (out.data_ptr(), 2, 5, 7,
                                                  448, 441, 132))


def test_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    _fake_card(monkeypatch)
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
def test_channels_last_launches_per_tile(monkeypatch, arch):
    """A chain: one entry (to the padded input width), one epilogue a
    convolution but the prediction (ReLU, in place, at the padded width, on
    each valid convolution's shrinking size) and one exit (the padded taps
    to the taps); the gathers take the exit's kernels unnormalised. 2 / 16
    / 2 a tile at the published depth."""
    launches = _fake_card(monkeypatch)
    model = _kpcn(arch, "bfloat16")
    shrink = 4 * arch["depth"]
    h, w = shrink + 3, shrink + 5
    x = {k: v.as_subclass(_OnCard) for k, v in
         _inputs(arch, 1, h, w).items()}
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


@pytest.mark.parametrize("conv_dtype,grad,on_card,takes", [
    ("bfloat16", False, True, True), ("bfloat16", True, True, False),
    (None, False, True, False), ("float32", False, True, False),
    ("bfloat16", False, False, False)])
def test_channels_last_taken_only_without_grad_on_card_bf16(
        monkeypatch, conv_dtype, grad, on_card, takes):
    """Recorded launches: the layout kernels and the epilogue launch only
    for bf16 convs without gradients on the card; otherwise the NCHW
    modules run and the gathers normalise."""
    launches = _fake_card(monkeypatch)
    if not on_card:
        monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: True)
    model = _kpcn(TINY, conv_dtype)
    assert model._channels_last is (conv_dtype == "bfloat16")
    x = _inputs(TINY, 1, 17, 18)
    if on_card:
        x = {k: v.as_subclass(_OnCard) for k, v in x.items()}
    with torch.set_grad_enabled(grad):
        model(x)
    names = [entry[0] for entry in launches]
    if takes:
        assert names.count("kpcn_entry") == names.count("kpcn_exit") == 2
        assert names.count("unet_epilogue") == 4
    else:
        assert set(names) <= {"kernel_apply"}
    assert [entry[1] for entry in launches
            if entry[0] == "kernel_apply"] == [not takes] * 2


@pytest.mark.parametrize("kw,takes", [
    ({}, True), ({"ksize": 23}, False), ({"conv_dtype": None}, False)])
def test_channels_last_takes_what_the_kernels_hold(kw, takes):
    """Fixed at construction: bf16 convs and a padded prediction the exit
    kernel holds (441 taps pad to 448; 529 to 536, beyond 512)."""
    args = dict(conv_dtype="bfloat16", depth=2, width=8)
    args.update(kw)
    assert KPCN(**args)._channels_last is takes
