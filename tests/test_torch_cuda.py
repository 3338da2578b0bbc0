"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip on a machine without a CUDA device and run on the
GPU with ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the GPU machine
need not have; this file imports nothing of it).

Tolerance of the forward: ``|kernel - plain| <= 2e-4 + 2e-5 * |plain|``. The
absolute part is the JAX package's own bound for its fused splat kernel
against the composed version (``test_fused_full_update_matches_oracle`` in
tests/test_ops.py); the relative part covers float32 sums over up to 441
taps taken in another order (sum_w reaches tens at k = 21). The backward
kernels: ``3e-4 + 2e-5 * |plain|`` (the JAX package's bound for its fused
backward); a bfloat16 ``d_klogits`` may also sit on the neighbouring
bfloat16 value, ``2**-7`` relative. Kernel weighting and its weight gradient:
the forward's bound (sums over up to 441 taps, or over the channels, in
another order); scatter2gather only moves values: bit-exact. The exp
kernels: scatter2gather_max bit-exact (moves and a max), kernel weighting
of exp(logits - max) the forward's bound; the weight gradient written for
bfloat16 weights within ``2e-4 + 2**-7 * |plain|`` of the plain float32
gradient rounded once, and bit for bit the tiled kernel's own float32
gradient rounded once; the splat step composed from them
against the fused kernel, the forward's bound too (the fused kernel keeps a
running max per tap, so it rounds its exponentials otherwise).
"""

import numpy as np
import pytest
import torch

from sbmc_tpu_torch import ops

ATOL, RTOL = 2e-4, 2e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counts():
    """The kernels launched since the last reset, with their counts."""
    return {name: n for name, n in ops.launch_counts.items() if n}


def _variant(name, logits):
    """The counter of the splat kernel ``name`` (``progressive_splat`` or
    ``progressive_splat_dlogits``) that ``logits`` are dispatched to: the
    tiled kernel's own, or its generic variant's."""
    route = ops.splat_route(logits.shape[-1],
                            ops.reference.ksize_of(logits),
                            logits.element_size())
    return name if route == "tiled" else name + "_generic"


#: (channels, (h, w), k) the splat kernels are checked at: odd widths that
#: take the generic kernels, then widths whose logits rows are a multiple of
#: 16 bytes in both types, which take the tiled ones (ragged 16- and 8-row
#: tiles, 32-wide and 64-wide tiles, image smaller than the halo).
SPLAT_CASES = [(3, (37, 53), 3), (3, (130, 3), 5), (2, (5, 7), 21),
               (3, (37, 53), 21), (3, (37, 72), 3), (2, (21, 40), 5),
               (3, (45, 136), 21), (2, (5, 8), 21)]


def _inputs(rng, bs, c, h, w, k, dtype, init, device):
    data = torch.tensor(rng.randn(bs, c, h, w), dtype=torch.float32)
    logits = torch.tensor(3 * rng.randn(bs, k * k, h, w),
                          dtype=torch.float32).to(dtype)
    if init:
        state = (torch.zeros(bs, c, h, w), torch.zeros(bs, 1, h, w),
                 torch.full((bs, 1, h, w), -1e30))
    else:
        state = (torch.tensor(rng.randn(bs, c, h, w), dtype=torch.float32),
                 torch.tensor(np.abs(rng.randn(bs, 1, h, w)),
                              dtype=torch.float32),
                 torch.tensor(rng.randn(bs, 1, h, w), dtype=torch.float32))
    return [t.to(device) for t in (data, logits) + state]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("c,hw,k", SPLAT_CASES)
def test_splat_kernel_matches_plain(device, c, hw, k, dtype, init):
    rng = np.random.RandomState(k * 100 + hw[0])
    args = _inputs(rng, 2, c, *hw, k, dtype, init, device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = ops.progressive_splat_update(*args)
        assert _counts() == {_variant("progressive_splat", args[1]): 1}
        want = ops.progressive_splat_update_ref(*args)
        torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert torch.all((g - r).abs() <= ATOL + RTOL * r.abs()), \
            float((g - r).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tile_h", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 3])
@pytest.mark.parametrize("k", [3, 5, 21])
def test_tiled_splat_kernel_at_each_tile_height(device, tile_h, dtype, c, k):
    """Both tile heights of the tiled kernel, whichever one
    ``ops.splat_tile_rows`` would pick at this shape (float32 16-row tiles
    run with the fewest stages, one block per SM)."""
    rng = np.random.RandomState(k * 10 + c)
    args = _inputs(rng, 2, c, 37, 64, k, dtype, False, device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = ops._progressive_splat_cuda(*args, route="tiled",
                                          tile_h=tile_h)
        assert _counts() == {"progressive_splat": 1}
        want = ops.progressive_splat_update_ref(*args)
        torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert torch.all((g - r).abs() <= ATOL + RTOL * r.abs()), \
            float((g - r).abs().max())


@pytest.mark.cuda
def test_splat_kernel_rejects_bad_inputs(device):
    rng = np.random.RandomState(0)
    data, logits, sr, sw, mw = _inputs(rng, 1, 3, 8, 9, 3, torch.float32,
                                       True, device)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            ops.progressive_splat_update(data.half(), logits, sr, sw, mw)
        with pytest.raises(ValueError):
            ops.progressive_splat_update(
                data, logits.transpose(2, 3).contiguous().transpose(2, 3),
                sr, sw, mw)
        with pytest.raises(ValueError):
            d5, l5, r5, w5, m5 = _inputs(rng, 1, 5, 8, 9, 3, torch.float32,
                                         True, device)
            ops.progressive_splat_update(d5, l5, r5, w5, m5)
    # Tensors that require grad are taken: the op is differentiable, and a
    # CUDA tensor launches the backward kernels.
    ops.reset_launch_counts()
    out = ops.progressive_splat_update(data.requires_grad_(), logits, sr, sw,
                                       mw)
    out[0].sum().backward()
    assert data.grad.shape == data.shape
    assert _counts() == {_variant("progressive_splat", logits): 1,
                         "progressive_splat_ddata": 1}


BWD_ATOL, BWD_RTOL = 3e-4, 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw,k", SPLAT_CASES)
def test_backward_kernels_match_plain(device, c, hw, k, dtype):
    rng = np.random.RandomState(k * 100 + hw[0] + 1)
    data, logits, sr, sw, mw = _inputs(rng, 2, c, *hw, k, dtype, False,
                                       device)
    d_r = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32,
                       device=device)
    d_w = torch.tensor(rng.randn(2, 1, *hw), dtype=torch.float32,
                       device=device)
    with torch.inference_mode():
        new_max = ops.progressive_splat_update(data, logits, sr, sw, mw)[2]
        ops.reset_launch_counts()
        got_data = ops._ddata_cuda(logits, new_max, d_r)
        got_logits = ops._dlogits_cuda(data, logits, new_max, d_r, d_w)
        assert _counts() == {"progressive_splat_ddata": 1,
                             _variant("progressive_splat_dlogits", logits): 1}
        want_data, want_logits = ops.progressive_splat_bwd_ref(
            data, logits, new_max, d_r, d_w)
        torch.cuda.synchronize()
    assert got_data.dtype == torch.float32 and got_logits.dtype == dtype
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else BWD_RTOL
    for g, r, rt in ((got_data, want_data, BWD_RTOL),
                     (got_logits.float(), want_logits.float(), rtol)):
        assert torch.all((g - r).abs() <= BWD_ATOL + rt * r.abs()), \
            float((g - r).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_on_the_card_matches_cpu(device, dtype):
    """The autograd.Function end to end: gradients through two chained
    steps and the normalisation, kernels on the card against the plain
    versions on the CPU."""
    from sbmc_tpu_torch.nn.kernel_apply import (progressive_init,
                                                progressive_kernel_apply)
    rng = np.random.RandomState(3)
    bs, k, h, w = 2, 5, 21, 34
    data = rng.randn(2, bs, 3, h, w)
    logits = 3 * rng.randn(2, bs, k * k, h, w)
    valid = torch.tensor([[True, True], [False, True]])
    grads = []
    for dev in (torch.device("cpu"), device):
        leaves = []
        state = progressive_init(bs, 3, h, w, dev)
        for s in range(2):
            d = torch.tensor(data[s], dtype=torch.float32, device=dev,
                             requires_grad=True)
            lg = torch.tensor(logits[s], dtype=torch.float32).to(dtype).to(
                dev).requires_grad_()
            leaves += [d, lg]
            state = progressive_kernel_apply(d, lg, state,
                                             valid=valid[s].to(dev))
        ops.reset_launch_counts()
        (state.sum_r / (state.sum_w + 1e-8)).square().sum().backward()
        if dev.type == "cuda":
            assert _counts() == {"progressive_splat_ddata": 2,
                                 _variant("progressive_splat_dlogits",
                                          lg): 2}
        grads.append([t.grad.float().cpu() for t in leaves])
    for i, (g, r) in enumerate(zip(grads[1], grads[0])):
        rt = 2.0 ** -7 if (dtype == torch.bfloat16 and i % 2) else 1e-4
        assert torch.all((g - r).abs() <= BWD_ATOL + rt * r.abs()), \
            (i, float((g - r).abs().max()))


COMPOSED = [(3, (37, 53), 3), (3, (130, 3), 5), (2, (5, 7), 21),
            (3, (37, 53), 21)]


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.all((got - want).abs() <= ATOL + RTOL * want.abs()), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw,k", COMPOSED)
def test_kernel_weighting_kernels_match_plain(device, c, hw, k, dtype):
    rng = np.random.RandomState(k * 100 + hw[0] + 2)
    data = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32,
                        device=device)
    weights = torch.tensor(rng.randn(2, k * k, *hw),
                           dtype=torch.float32).to(dtype).to(device)
    d_out = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32,
                         device=device)
    d_sw = torch.tensor(rng.randn(2, *hw), dtype=torch.float32,
                        device=device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out, sum_w = ops.kernel_weighting(data, weights)
        d_w = ops._kernel_weighting_dw_cuda(data, d_out, d_sw, k)
        assert _counts() == {"kernel_weighting": 1, "kernel_weighting_dw": 1}
        want_out, want_sw = ops.kernel_weighting_ref(data, weights)
        want_dw = ops.kernel_weighting_dw_ref(data, d_out, d_sw, k)
        torch.cuda.synchronize()
    _close(out, want_out)
    _close(sum_w, want_sw)
    _close(d_w, want_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,hw,k", [(2, (37, 53), 3), (1, (130, 3), 5),
                                     (3, (5, 7), 21), (2, (37, 53), 21)])
def test_scatter2gather_kernel_is_exact(device, bs, hw, k, dtype):
    rng = np.random.RandomState(k * 100 + hw[0] + 3)
    weights = torch.tensor(rng.randn(bs, k * k, *hw),
                           dtype=torch.float32).to(dtype).to(device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = ops.scatter2gather(weights)
        assert _counts() == {"scatter2gather": 1}
        want = ops.scatter2gather_ref(weights)
        assert got.dtype == dtype and torch.equal(got, want)
        # Applied twice it gives back what stays inside the image.
        assert torch.equal(ops.scatter2gather(got),
                           ops.scatter2gather_ref(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_composed_functions_on_the_card_match_cpu(device, dtype):
    """``kernel_apply(splat=True)`` end to end: scatter2gather, softmax,
    kernel weighting and their backward (d_data through B5 + B4, d_weights
    through B6, then B5 on the cotangent), card against CPU. The bfloat16
    case leaves the softmax out: PyTorch's bfloat16 softmax rounds at other
    places on the card than on the CPU, which is not the kernels' doing."""
    from sbmc_tpu_torch.nn.kernel_apply import kernel_apply
    rng = np.random.RandomState(4)
    bs, k, h, w = 2, 5, 21, 34
    data = rng.randn(bs, 3, h, w)
    kernels = rng.randn(bs, k * k, h, w)
    grads = []
    for dev in (torch.device("cpu"), device):
        d = torch.tensor(data, dtype=torch.float32, device=dev,
                         requires_grad=True)
        kn = torch.tensor(kernels, dtype=torch.float32).to(dtype).to(
            dev).requires_grad_()
        ops.reset_launch_counts()
        out, sum_w = kernel_apply(d, kn, softmax=dtype == torch.float32,
                                  splat=True)
        (out.square().sum() + (sum_w * out[:, :1]).sum()).backward()
        if dev.type == "cuda":
            assert _counts() == {"scatter2gather": 3, "kernel_weighting": 2,
                                 "kernel_weighting_dw": 1}
        grads.append([d.grad.cpu(), kn.grad.float().cpu()])
    for i, (g, r) in enumerate(zip(grads[1], grads[0])):
        rt = 2.0 ** -7 if (dtype == torch.bfloat16 and i) else 1e-4
        assert torch.all((g - r).abs() <= BWD_ATOL + rt * r.abs()), \
            (i, float((g - r).abs().max()))


@pytest.mark.cuda
def test_composed_kernels_reject_bad_inputs(device):
    data = torch.zeros(1, 3, 8, 9, device=device)
    weights = torch.zeros(1, 9, 8, 9, device=device)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            ops.kernel_weighting(data.half(), weights)
        with pytest.raises(TypeError):
            ops.kernel_weighting(data, weights.half())
        with pytest.raises(TypeError):
            ops.scatter2gather(weights.double())
        with pytest.raises(ValueError, match="contiguous"):
            ops.scatter2gather(
                weights.transpose(2, 3).contiguous().transpose(2, 3))
        with pytest.raises(ValueError, match="channels"):
            ops.kernel_weighting(torch.zeros(1, 5, 8, 9, device=device),
                                 weights)
        with pytest.raises(ValueError, match="expected"):
            ops.kernel_weighting(torch.zeros(1, 3, 8, 8, device=device),
                                 weights)
        with pytest.raises(ValueError, match="square"):
            ops.scatter2gather(torch.zeros(1, 8, 8, 9, device=device))
        with pytest.raises(ValueError, match="several devices"):
            ops.kernel_weighting(data.cpu(), weights)
        with pytest.raises(ValueError, match="d_sum_w"):
            ops._kernel_weighting_dw_cuda(data, data, torch.zeros(
                1, 1, 8, 9, device=device), 3)


def _exp_inputs(rng, bs, c, hw, k, dtype, device):
    data = torch.tensor(rng.randn(bs, c, *hw), dtype=torch.float32)
    logits = torch.tensor(3 * rng.randn(bs, k * k, *hw),
                          dtype=torch.float32).to(dtype)
    maxes = logits.float().amax(1) + torch.tensor(rng.rand(bs, *hw),
                                                  dtype=torch.float32)
    return [t.to(device) for t in (data, logits, maxes)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw,k", COMPOSED)
def test_exp_kernels_match_plain(device, c, hw, k, dtype):
    rng = np.random.RandomState(k * 100 + hw[0] + 5)
    data, logits, maxes = _exp_inputs(rng, 2, c, hw, k, dtype, device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        g, kmax = ops.scatter2gather_max(logits)
        out, sum_w = ops.kernel_weighting_exp(data, logits, maxes)
        assert _counts() == {"scatter2gather_max": 1,
                             "kernel_weighting_exp": 1}
        want_g, want_kmax = ops.scatter2gather_max_ref(logits)
        want_out, want_sw = ops.kernel_weighting_exp_ref(data, logits, maxes)
        torch.cuda.synchronize()
    assert g.dtype == dtype and kmax.dtype == torch.float32
    assert torch.equal(g, want_g) and torch.equal(kmax, want_kmax)
    _close(out, want_out)
    _close(sum_w, want_sw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("c,hw,k", [(3, (37, 53), 3), (2, (5, 7), 21),
                                    (3, (37, 53), 21)])
def test_composed_step_matches_fused_kernel(device, c, hw, k, dtype, init):
    """The splat step composed from the two exp kernels, as the JAX
    package's unfused branch composes it, against the fused kernel B1; the
    outputs carry no gradient."""
    rng = np.random.RandomState(k * 100 + hw[0] + 6)
    data, logits, sum_r, sum_w, max_w = _inputs(rng, 2, c, *hw, k, dtype,
                                                init, device)
    logits.requires_grad_()
    ops.reset_launch_counts()
    g, kmax = ops.scatter2gather_max(logits)
    new_max = torch.maximum(kmax[:, None], max_w)
    scaler = torch.exp(max_w - new_max)
    r, w = ops.kernel_weighting_exp(data, g, new_max[:, 0])
    got = (sum_r * scaler + r, sum_w * scaler + w[:, None], new_max)
    assert not (g.requires_grad or r.requires_grad or w.requires_grad)
    with torch.inference_mode():
        want = ops.progressive_splat_update(data, logits.detach(), sum_r,
                                            sum_w, max_w)
        torch.cuda.synchronize()
    assert _counts() == {"scatter2gather_max": 1, "kernel_weighting_exp": 1,
                         _variant("progressive_splat", logits): 1}
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.cuda
def test_exp_kernels_reject_bad_inputs(device):
    data = torch.zeros(1, 3, 8, 9, device=device)
    logits = torch.zeros(1, 9, 8, 9, device=device)
    maxes = torch.zeros(1, 8, 9, device=device)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            ops.scatter2gather_max(logits.half())
        with pytest.raises(ValueError, match="square"):
            ops.scatter2gather_max(torch.zeros(1, 8, 8, 9, device=device))
        with pytest.raises(TypeError, match="maxes"):
            ops.kernel_weighting_exp(data, logits, maxes.double())
        with pytest.raises(ValueError, match="maxes has shape"):
            ops.kernel_weighting_exp(data, logits, maxes[:, :4])
        with pytest.raises(ValueError, match="channels"):
            ops.kernel_weighting_exp(torch.zeros(1, 4, 8, 9, device=device),
                                     logits, maxes)
        with pytest.raises(ValueError, match="several devices"):
            ops.kernel_weighting_exp(data, logits, maxes.cpu())


def _kw_case(rng, c, hw, k, dtype, device):
    data = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32)
    weights = torch.tensor(rng.randn(2, k * k, *hw),
                           dtype=torch.float32).to(dtype)
    d_out = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32)
    d_sw = torch.tensor(rng.randn(2, *hw), dtype=torch.float32)
    return [t.to(device) for t in (data, weights, d_out, d_sw)]


def _close_dw(got, want_f32, dtype):
    """The weight gradient in the weights' type against the plain float32
    one rounded once to it."""
    want = want_f32.to(dtype)
    assert got.dtype == dtype and got.shape == want.shape
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else RTOL
    g, r = got.float(), want.float()
    assert torch.all((g - r).abs() <= ATOL + rtol * r.abs()), \
        float((g - r).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw,k", [(3, (37, 64), 3), (2, (21, 90), 5),
                                    (3, (37, 53), 21), (2, (9, 124), 21)])
def test_tiled_kernel_weighting_at_each_group_count(device, c, hw, k,
                                                    dtype):
    """Both tiled kernels at every group count (2-pixel items at even
    widths, 1-pixel ones at 53), and the generic kernels at the same
    shapes."""
    rng = np.random.RandomState(k * 10 + hw[1])
    data, weights, d_out, d_sw = _kw_case(rng, c, hw, k, dtype, device)
    with torch.inference_mode():
        want_out, want_sw = ops.kernel_weighting_ref(data, weights)
        want_dw = ops.kernel_weighting_dw_ref(data, d_out, d_sw, k)
        runs = [("tiled", g) for g in (1, 2, 4, 8) if g <= k]
        for route, groups in runs + [("generic", None)]:
            ops.reset_launch_counts()
            out, sum_w = ops._kernel_weighting_cuda(data, weights, route,
                                                    groups)
            d_w = ops._kernel_weighting_dw_cuda(data, d_out, d_sw, k, dtype,
                                                route, groups)
            suffix = "" if route == "tiled" else "_generic"
            assert _counts() == {"kernel_weighting" + suffix: 1,
                                 "kernel_weighting_dw" + suffix: 1}
            torch.cuda.synchronize()
            _close(out, want_out)
            _close(sum_w, want_sw)
            _close_dw(d_w, want_dw, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weighting_routes(device, dtype):
    """k = 7 takes the generic kernels; weights one element past an aligned
    base take the tiled kernels with 1-pixel items; an odd group count is
    refused."""
    rng = np.random.RandomState(7)
    data, weights, d_out, d_sw = _kw_case(rng, 3, (13, 40), 7, dtype,
                                          device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out, sum_w = ops.kernel_weighting(data, weights)
        d_w = ops._kernel_weighting_dw_cuda(data, d_out, d_sw, 7, dtype)
        assert _counts() == {"kernel_weighting_generic": 1,
                             "kernel_weighting_dw_generic": 1}
        torch.cuda.synchronize()
        _close(out, ops.kernel_weighting_ref(data, weights)[0])
        _close_dw(d_w, ops.kernel_weighting_dw_ref(data, d_out, d_sw, 7),
                  dtype)
        data, weights = _kw_case(rng, 3, (13, 40), 5, dtype, device)[:2]
        buf = torch.empty(weights.numel() + 1, dtype=dtype, device=device)
        shifted = buf[1:].view(weights.shape).copy_(weights)
        assert ops.kw_pixels(
            40, 2, shifted.data_ptr() // shifted.element_size()) == 1
        ops.reset_launch_counts()
        got = ops.kernel_weighting(data, shifted)
        assert _counts() == {"kernel_weighting": 1}
        torch.cuda.synchronize()
        for g, r in zip(got, ops.kernel_weighting_ref(data, weights)):
            _close(g, r)
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._kernel_weighting_cuda(data, weights, "tiled", 3)


@pytest.mark.cuda
def test_bf16_weight_gradient_on_the_card_is_the_rounded_float32_one(
        device):
    """The tiled kernel's bfloat16 gradient is its float32 one rounded once
    to nearest even, bit for bit, and the Function hands it back in the
    weights' type."""
    rng = np.random.RandomState(8)
    data, weights, d_out, d_sw = _kw_case(rng, 3, (23, 92), 21,
                                          torch.bfloat16, device)
    with torch.inference_mode():
        full = ops._kernel_weighting_dw_cuda(data, d_out, d_sw, 21)
        half = ops._kernel_weighting_dw_cuda(data, d_out, d_sw, 21,
                                             torch.bfloat16)
        torch.cuda.synchronize()
    assert full.dtype == torch.float32 and half.dtype == torch.bfloat16
    assert torch.equal(half, full.to(torch.bfloat16))
    w = weights.clone().requires_grad_()
    out, sum_w = ops.kernel_weighting(data, w)
    ops.reset_launch_counts()
    ((out * d_out).sum() + (sum_w * d_sw).sum()).backward()
    assert _counts() == {"kernel_weighting_dw": 1}
    assert w.grad.dtype == torch.bfloat16 and torch.equal(w.grad, half)
