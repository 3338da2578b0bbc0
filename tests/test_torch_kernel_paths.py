"""When each model's forward takes its hand-written kernels
(``sbmc_tpu_torch.nn.layers.kernel_path``), on the CPU.

One rule decides it for ``Multisteps`` (the per-sample chain kernel),
``Autoencoder`` (the channels-last U-Net) and ``KPCN`` (the channels-last
chains): gradients off, or kernels that have a backward (the U-Net's
alone), input on the card, bf16 convs and an architecture the kernels
hold. The ``fake_card`` fixture runs the kernel bindings' CUDA
branch on CPU tensors with each launch recorded in place of the call, and
inputs that say they lie on the card stand for CUDA input. The splat and
the gathers, which every path runs, return their input state or zeros.
"""

import pytest
import torch

from sbmc_tpu_torch.models import KPCN, Multisteps
from sbmc_tpu_torch.models import kpcn as kpcn_module
from sbmc_tpu_torch.models import multisteps as multisteps_module
from sbmc_tpu_torch.nn.layers import Autoencoder, dtype_of

NSTEPS, SPP = 2, 3


class FakeCard:
    """The kernels' CUDA build as the kernel bindings see it on a faked card
    (the ``fake_card`` fixture): each entry point of ``_build._CUDA`` is its
    own name, but the sample chain's ``*_fits`` queries, which note what
    they are asked in ``asked`` and answer ``answer``. ``launches`` holds
    each launch's ``(name, entry point, arguments)`` in place of the call."""

    def __init__(self, cuda):
        self._cuda = cuda
        for table in cuda.values():
            for fn in table:
                if not fn.endswith("_fits"):
                    setattr(self, fn, fn)
        self.launches, self.asked, self.answer = [], [], 1

    def sbmc_sample_embed_fits(self, *args):
        self.asked.append(("embed",) + args)
        return self.answer

    def sbmc_sample_regress_fits(self, *args):
        self.asked.append(("regress",) + args)
        return self.answer

    def declared(self, fn):
        """The argument count the ctypes binding of ``fn`` declares, the
        stream left out."""
        [n] = [len(table[fn]) - 1 for table in self._cuda.values()
               if fn in table]
        return n

    @staticmethod
    def on_card(t):
        """``t``, a CPU tensor, saying it lies on the card: a model's choice
        of path can be watched here."""
        return t.as_subclass(_OnCard)


class _OnCard(torch.Tensor):

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def fake_card(monkeypatch):
    """Runs the kernel bindings' CUDA branch on CPU tensors: ``ops._load``
    returns a :class:`FakeCard`, ``ops._on_cpu`` says no, ``ops._sm_count``
    132, and ``ops._launch`` records each launch in place of the call.
    Returns the FakeCard. The port's other test modules import it from
    here."""
    from sbmc_tpu_torch import ops
    from sbmc_tpu_torch.ops import _build
    card = FakeCard(_build._CUDA)
    monkeypatch.setattr(ops, "_load", lambda: card)
    monkeypatch.setattr(ops, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ops, "_sm_count", lambda device: 132)
    monkeypatch.setattr(ops, "_launch", lambda name, fn, device, *args:
                        card.launches.append((name, fn, args)))
    return card
KPCN_DEPTH = 3


def _model(name, conv_dtype):
    torch.manual_seed(0)
    if name == "multisteps":
        return Multisteps(5, 3, width=8, embedding_width=8, ksize=3,
                          nsteps=NSTEPS, conv_dtype=conv_dtype)
    if name == "autoencoder":
        return Autoencoder(8, 8, num_levels=3, increase_factor=2.0,
                           num_convs=3, width=8, ksize=3,
                           output_type="leaky_relu",
                           dtype=dtype_of(conv_dtype))
    return KPCN(n_in=5, ksize=3, depth=KPCN_DEPTH, width=12,
                conv_dtype=conv_dtype)


def _inputs(name, h=17, w=18):
    g = torch.Generator().manual_seed(1)
    if name == "multisteps":
        return {"radiance": torch.rand(1, SPP, 3, h, w, generator=g),
                "features": torch.randn(1, SPP, 5, h, w, generator=g),
                "global_features": torch.randn(1, 3, 1, 1, generator=g)}
    if name == "autoencoder":
        return torch.randn(1, 8, h, w, generator=g)
    return {k: torch.rand(1, 5 if k.endswith("_in") else 3, h, w,
                          generator=g)
            for k in ("kpcn_diffuse_in", "kpcn_specular_in",
                      "kpcn_diffuse_buffer", "kpcn_specular_buffer",
                      "kpcn_albedo")}


#: The launches each model's kernel path makes a call: the chain kernel once
#: an embedding step and once a sample (the U-Nets inside see the faked
#: launches' outputs, plain CPU tensors, and run NCHW here: their own cases
#: are the Autoencoder's), the U-Net's 15 epilogues, 2 upsamples and 2
#: layout changes, KPCN's entry and exit a chain and an epilogue a hidden
#: layer.
TAKEN = {"multisteps": {"sample_chain": NSTEPS + SPP},
         "autoencoder": {"unet_epilogue": 15, "unet_upsample": 2,
                         "unet_layout": 2},
         "kpcn": {"kpcn_entry": 2, "unet_epilogue": 2 * (KPCN_DEPTH - 1),
                  "kpcn_exit": 2}}
#: The forward's launches under gradients: only the U-Net's kernels have a
#: backward, so the Autoencoder and Multisteps' U-Nets (one a step, on the
#: plain chains' outputs) take theirs, KPCN none.
TAKEN_WITH_GRAD = {"multisteps": {"unet_epilogue": 15 * NSTEPS,
                                  "unet_upsample": 2 * NSTEPS,
                                  "unet_layout": 2 * NSTEPS},
                   "autoencoder": TAKEN["autoencoder"], "kpcn": {}}


@pytest.mark.parametrize("device", ["card", "cpu"])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("conv_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["multisteps", "autoencoder", "kpcn"])
def test_kernels_taken_only_without_grad_on_card_bf16(
        monkeypatch, fake_card, name, conv_dtype, grad, device):
    """The inference kernels launch only for bf16 convs without gradients
    on the card, each as many times as the path makes them; with gradients
    on only the U-Net's (which have a backward); otherwise the plain
    modules run, no kernel launches, KPCN's gathers normalise, and the
    chain kernel's build is never asked what it holds."""
    gathers = []

    def kernel_apply(data, kernels, softmax, splat):
        gathers.append(softmax)
        return torch.zeros_like(data), None

    monkeypatch.setattr(kpcn_module, "kernel_apply", kernel_apply)
    monkeypatch.setattr(multisteps_module, "progressive_kernel_apply",
                        lambda data, kernels, state, **kw: state)
    model = _model(name, conv_dtype)
    x = _inputs(name)
    if device == "card":
        x = (fake_card.on_card(x) if name == "autoencoder"
             else {k: fake_card.on_card(v) for k, v in x.items()})
    with torch.set_grad_enabled(grad):
        model(x)
    on_card_bf16 = conv_dtype == "bfloat16" and device == "card"
    takes = on_card_bf16 and not grad
    names = [launch[0] for launch in fake_card.launches]
    assert {n: names.count(n) for n in names} == (
        TAKEN[name] if takes else TAKEN_WITH_GRAD[name] if on_card_bf16
        else {})
    if name == "kpcn":
        assert gathers == [not takes] * 2
    if name == "multisteps":
        assert bool(fake_card.asked) is takes
