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
    """The counter of the splat kernel ``name`` (``progressive_splat``,
    ``progressive_splat_ddata`` or ``progressive_splat_dlogits``) that
    ``logits`` are dispatched to: the tiled kernel's own, or its generic
    variant's."""
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
        # Five channels are no longer refused: the op runs them in the
        # channel groups 3 + 2, one launch each.
        five = _inputs(rng, 1, 5, 8, 9, 3, torch.float32, True, device)
        ops.reset_launch_counts()
        got = ops.progressive_splat_update(*five)
        assert _counts() == {_variant("progressive_splat", five[1]): 2}
        for g, r in zip(got, ops.progressive_splat_update_ref(*five)):
            assert torch.all((g - r).abs() <= ATOL + RTOL * r.abs())
    # Tensors that require grad are taken: the op is differentiable, and a
    # CUDA tensor launches the backward kernels.
    ops.reset_launch_counts()
    out = ops.progressive_splat_update(data.requires_grad_(), logits, sr, sw,
                                       mw)
    out[0].sum().backward()
    assert data.grad.shape == data.shape
    assert _counts() == {_variant("progressive_splat", logits): 1,
                         _variant("progressive_splat_ddata", logits): 1}


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
        assert _counts() == {_variant("progressive_splat_ddata", logits): 1,
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
            assert _counts() == {_variant("progressive_splat_ddata", lg): 2,
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
        # Five channels run in the channel groups 3 + 2.
        five = torch.randn(1, 5, 8, 9, device=device)
        out, sum_w = ops.kernel_weighting(five, weights + 1)
        want = ops.kernel_weighting_ref(five, weights + 1)
        assert torch.all((out - want[0]).abs() <= ATOL + RTOL
                         * want[0].abs())
        assert torch.equal(sum_w, want[1])
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
        # Four channels run in the channel groups 2 + 2.
        four = torch.randn(1, 4, 8, 9, device=device)
        got = ops.kernel_weighting_exp(four, logits, maxes)
        want = ops.kernel_weighting_exp_ref(four, logits, maxes)
        for g, r in zip(got, want):
            assert torch.all((g - r).abs() <= ATOL + RTOL * r.abs())
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


#: (channels, (h, w), k) at which the vector d_data kernel is checked: rows
#: of whole 16-byte vectors in both types, ragged tiles (37, 45 rows; 40 and
#: 136 columns), an image smaller than the halo.
DDATA_CASES = [(3, (37, 64), 3), (2, (21, 40), 5), (3, (45, 136), 21),
               (2, (5, 8), 21)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw,k", DDATA_CASES)
def test_vector_ddata_kernel_at_each_group_count(device, c, hw, k, dtype):
    """The vector d_data kernel at every group count, and the generic kernel
    at the same shapes, against the plain version."""
    rng = np.random.RandomState(k * 10 + hw[1] + 5)
    data, logits, sr, sw, mw = _inputs(rng, 2, c, *hw, k, dtype, False,
                                       device)
    d_r = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32,
                       device=device)
    with torch.inference_mode():
        new_max = ops.progressive_splat_update(data, logits, sr, sw, mw)[2]
        want = ops.reference.progressive_splat_ddata_ref(logits, new_max,
                                                         d_r)
        runs = [("tiled", g) for g in (1, 2, 4, 8) if g <= k]
        for route, groups in runs + [("generic", None)]:
            ops.reset_launch_counts()
            got = ops._ddata_cuda(logits, new_max, d_r, route, groups)
            suffix = "" if route == "tiled" else "_generic"
            assert _counts() == {"progressive_splat_ddata" + suffix: 1}
            torch.cuda.synchronize()
            assert got.dtype == torch.float32
            assert torch.all((got - want).abs()
                             <= BWD_ATOL + BWD_RTOL * want.abs()), \
                (route, groups, float((got - want).abs().max()))
        # The route's own choice; three groups are refused.
        ops.reset_launch_counts()
        got = ops._ddata_cuda(logits, new_max, d_r)
        assert _counts() == {"progressive_splat_ddata": 1}
        torch.cuda.synchronize()
        assert torch.all((got - want).abs()
                         <= BWD_ATOL + BWD_RTOL * want.abs())
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._ddata_cuda(logits, new_max, d_r, "tiled", 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,hw,k", [(2, (37, 53), 3), (1, (13, 92), 5),
                                     (2, (9, 64), 21), (1, (6, 30), 21),
                                     (3, (5, 7), 21)])
def test_vector_scatter2gather_at_each_item_width(device, bs, hw, k, dtype):
    """The vector kernel bit-exact at every item width the row takes, on a
    base one element past an aligned one, and the generic kernel at k = 7."""
    rng = np.random.RandomState(k * 10 + hw[1] + 6)
    weights = torch.tensor(rng.randn(bs, k * k, *hw),
                           dtype=torch.float32).to(dtype).to(device)
    size = weights.element_size()
    with torch.inference_mode():
        want = ops.scatter2gather_ref(weights)
        widest = ops.s2g_pixels(hw[1], size, 0)
        for v in (1, 2, 4, 8):
            if v <= widest:
                ops.reset_launch_counts()
                got = ops._scatter2gather_cuda(weights, "tiled", v)
                assert _counts() == {"scatter2gather": 1}
                assert got.dtype == dtype and torch.equal(got, want), v
        buf = torch.empty(weights.numel() + 1, dtype=dtype, device=device)
        shifted = buf[1:].view(weights.shape).copy_(weights)
        assert torch.equal(ops.scatter2gather(shifted), want)
        if widest > 1:
            with pytest.raises(RuntimeError, match="launch failed"):
                ops._scatter2gather_cuda(shifted, "tiled", widest)
        seven = torch.tensor(rng.randn(bs, 49, *hw),
                             dtype=torch.float32).to(dtype).to(device)
        ops.reset_launch_counts()
        got = ops.scatter2gather(seven)
        assert _counts() == {"scatter2gather_generic": 1}
        assert torch.equal(got, ops.scatter2gather_ref(seven))
        ops.reset_launch_counts()
        got = ops._scatter2gather_cuda(weights, "generic")
        assert _counts() == {"scatter2gather_generic": 1}
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hw,k", [(3, (37, 64), 3), (2, (21, 90), 5),
                                    (3, (37, 53), 21), (2, (9, 124), 21),
                                    (3, (5, 7), 21)])
def test_tiled_exp_kernel_at_each_group_count(device, c, hw, k, dtype):
    """kw_exp at every group count (2-pixel items at even widths, 1-pixel
    ones at odd widths, an image smaller than the halo) and the generic
    kernel at the same shapes, against the plain version; the op takes the
    tiled kernel."""
    rng = np.random.RandomState(k * 10 + hw[1] + 3)
    data, logits, maxes = _exp_inputs(rng, 2, c, hw, k, dtype, device)
    with torch.inference_mode():
        want = ops.kernel_weighting_exp_ref(data, logits, maxes)
        ops.reset_launch_counts()
        ops.kernel_weighting_exp(data, logits, maxes)
        assert _counts() == {"kernel_weighting_exp": 1}
        runs = [("tiled", g) for g in (1, 2, 4, 8) if g <= k]
        for route, groups in runs + [("generic", None)]:
            ops.reset_launch_counts()
            got = ops._kernel_weighting_exp_cuda(data, logits, maxes, route,
                                                 groups)
            suffix = "" if route == "tiled" else "_generic"
            assert _counts() == {"kernel_weighting_exp" + suffix: 1}
            torch.cuda.synchronize()
            for g, r in zip(got, want):
                _close(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exp_kernel_routes(device, dtype):
    """k = 7 takes the generic exp kernel; a logits or maxes base one
    element past an aligned one takes the tiled kernel with 1-pixel items;
    an odd group count is refused."""
    rng = np.random.RandomState(9)
    data, logits, maxes = _exp_inputs(rng, 2, 3, (13, 40), 7, dtype, device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = ops.kernel_weighting_exp(data, logits, maxes)
        assert _counts() == {"kernel_weighting_exp_generic": 1}
        torch.cuda.synchronize()
        for g, r in zip(got, ops.kernel_weighting_exp_ref(data, logits,
                                                          maxes)):
            _close(g, r)
        data, logits, maxes = _exp_inputs(rng, 2, 3, (13, 40), 5, dtype,
                                          device)
        want = ops.kernel_weighting_exp_ref(data, logits, maxes)
        for t in (logits, maxes):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
            shifted = buf[1:].view(t.shape).copy_(t)
            args = ((data, shifted, maxes) if t is logits
                    else (data, logits, shifted))
            ops.reset_launch_counts()
            got = ops.kernel_weighting_exp(*args)
            assert _counts() == {"kernel_weighting_exp": 1}
            torch.cuda.synchronize()
            for g, r in zip(got, want):
                _close(g, r)
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._kernel_weighting_exp_cuda(data, logits, maxes, "tiled", 3)


@pytest.mark.cuda
def test_exp_kernels_at_extreme_logits(device):
    """A logit of -inf weighs 0 and one far above its shift weighs inf, in
    both kernels exactly where the plain version's exp puts them."""
    rng = np.random.RandomState(10)
    data, logits, maxes = _exp_inputs(rng, 1, 3, (9, 12), 5, torch.float32,
                                      device)
    logits[0, :, 2, 3] = -float("inf")
    logits[0, 12, 6, 8] = maxes[0, 6, 8] + 200
    logits[0, 0, 0, 0] = maxes[0, 0, 0] + 300
    with torch.inference_mode():
        want = ops.kernel_weighting_exp_ref(data, logits, maxes)
        for route in ("tiled", "generic"):
            got = ops._kernel_weighting_exp_cuda(data, logits, maxes, route)
            torch.cuda.synchronize()
            for g, r in zip(got, want):
                assert torch.equal(torch.isnan(g), torch.isnan(r))
                assert torch.equal(torch.isinf(g), torch.isinf(r))
                assert torch.equal(g[torch.isinf(g)], r[torch.isinf(r)])
                fin = torch.isfinite(r)
                _close(g[fin], r[fin])
    assert float(want[1][0, 2, 3]) == 0.0 and torch.isinf(want[1][0, 6, 8])


#: Channel counts outside the kernels' template set (ops.KERNEL_CHANNELS),
#: which the ops run in channel groups (ops.channel_groups).
CHANNEL_CASES = [1, 4, 5]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", CHANNEL_CASES)
@pytest.mark.parametrize("hw,k", [((21, 40), 5), ((9, 7), 3)])
def test_any_channel_count_matches_plain(device, c, hw, k, dtype):
    """The splat step and its gradients, kernel weighting and its gradients,
    and the exp weighting at 1, 4 and 5 channels on the card, one launch
    of each kernel a channel group, against their plain versions with the
    tolerances above (bfloat16 gradients to the logits or weights: the
    plain float32 gradient rounded once, within 2**-7)."""
    rng = np.random.RandomState(70 + c + k)
    groups = len(ops.channel_groups(c))
    data, logits, sr, sw, mw = _inputs(rng, 2, c, *hw, k, dtype, False,
                                       device)
    d_r = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32).to(device)
    d_w = torch.tensor(rng.randn(2, 1, *hw), dtype=torch.float32).to(device)
    x = [data.clone().requires_grad_(), logits.clone().requires_grad_()]
    ops.reset_launch_counts()
    out = ops.progressive_splat_update(*x, sr, sw, mw)
    assert _counts() == {_variant("progressive_splat", logits): groups}
    got = list(out) + list(torch.autograd.grad(
        (out[0] * d_r).sum() + (out[1] * d_w).sum(), x))
    want = ops.progressive_splat_update_ref(data, logits, sr, sw, mw)
    want = list(want) + list(ops.progressive_splat_bwd_ref(
        data, logits, want[2], d_r, d_w))
    for i, (g, r) in enumerate(zip(got, want)):
        rtol = 2.0 ** -7 if (i == 4 and dtype == torch.bfloat16) else RTOL
        atol = ATOL if i < 3 else BWD_ATOL
        assert g.dtype == r.dtype
        assert torch.all((g.float() - r.float()).abs()
                         <= atol + rtol * r.float().abs()), i

    weights = torch.tensor(rng.randn(2, k * k, *hw),
                           dtype=torch.float32).to(dtype).to(device)
    d_out = torch.tensor(rng.randn(2, c, *hw), dtype=torch.float32).to(device)
    d_sw = torch.tensor(rng.randn(2, *hw), dtype=torch.float32).to(device)
    x = [data.clone().requires_grad_(), weights.clone().requires_grad_()]
    out, sum_w = ops.kernel_weighting(*x)
    d_data, d_wts = torch.autograd.grad((out * d_out).sum()
                                        + (sum_w * d_sw).sum(), x)
    want_out, want_sw = ops.kernel_weighting_ref(data, weights)
    want_dw = ops.kernel_weighting_dw_ref(data, d_out, d_sw, k)
    want_dd = ops.kernel_weighting_ref(d_out, ops.scatter2gather_ref(
        weights))[0]
    for g, r in ((out, want_out), (sum_w, want_sw), (d_data, want_dd)):
        assert torch.all((g - r).abs() <= ATOL + RTOL * r.abs())
    _close_dw(d_wts, want_dw, dtype)

    exp_in = _exp_inputs(rng, 2, c, hw, k, dtype, device)
    for g, r in zip(ops.kernel_weighting_exp(*exp_in),
                    ops.kernel_weighting_exp_ref(*exp_in)):
        assert torch.all((g - r).abs() <= ATOL + RTOL * r.abs())


@pytest.mark.cuda
def test_model_spans_on_the_card(device):
    """While a profiler records, the flagship's spans time the card: the
    call launches the tiled splat kernel once a ``sbmc.splat`` at 3 channels
    (16-byte logits rows; ``ops.launch_counts`` before and after), every
    recorded call has a positive device ms, and the ``sbmc.forward`` call's
    device ms is at least the sum of its children's (their events lie inside
    its two on the same stream; 1e-4 ms of slack for the float sums)."""
    from sbmc_tpu_torch import tracing
    from sbmc_tpu_torch.models import Multisteps
    torch.manual_seed(0)
    net = Multisteps(n_features=8, n_global_features=3, width=16,
                     embedding_width=16, ksize=5, nsteps=2).to(device).eval()
    spp = 3
    x = {"radiance": torch.rand(1, spp, 3, 40, 64, device=device),
         "features": torch.rand(1, spp, 8, 40, 64, device=device),
         "global_features": torch.rand(1, 3, 1, 1, device=device)}
    P = torch.profiler.ProfilerActivity
    with torch.inference_mode():
        want = net(x)["radiance"]
        tracing.reset()
        before = dict(ops.launch_counts)
        with torch.profiler.profile(activities=[P.CPU, P.CUDA]):
            got = net(x)["radiance"]
    assert torch.equal(got, want)
    launched = {k: n - before[k] for k, n in ops.launch_counts.items()
                if n != before[k]}
    assert launched == {"progressive_splat": spp}
    call, = tracing.calls("sbmc.forward")
    assert len(tracing.calls("sbmc.splat")) == spp
    assert call.counters == {}
    assert all(c.device_ms > 0 for c in call.walk())
    assert call.device_ms >= sum(c.device_ms for c in call.children) - 1e-4
    tracing.reset()


# The per-sample chain kernel (csrc/sample_chain.cu) against its plain
# version, in bf16 units at the larger of |plain| and the tensor's mean
# magnitude: the split first layer and the order of float32 sums (MMA
# against cuDNN) flip a rounding now and then, and a flipped hidden
# activation moves the outputs it feeds by a few units.
CHAIN_MAX_UNITS, CHAIN_MEAN_UNITS = 8.0, 0.02


def _chain_units(got, want):
    want = want.float()
    scale = torch.maximum(want.abs(), want.abs().mean().expand_as(want))
    ulp = torch.pow(2.0, torch.floor(torch.log2(scale.clamp(min=1e-30))) - 7)
    units = (got.float() - want).abs() / ulp
    return float(units.max()), float(units.mean())


def _chain(cin, cout, width, activation, device, seed=0):
    from sbmc_tpu_torch.nn.layers import ConvChain
    torch.manual_seed(seed)
    chain = ConvChain(cin, cout, ksize=1, width=width, depth=3,
                      activation=activation, dtype=torch.bfloat16)
    with torch.no_grad():
        for name, p in chain.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.3 * torch.randn_like(p))
    return chain.to(device)


def _bf16(gen, *shape):
    return torch.tensor(gen.randn(*shape), dtype=torch.float32).to(
        torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("step,cx,ce,width,cout", [
    (0, 93, 3, 128, 128), (1, 128, 128, 128, 128), (0, 13, 3, 8, 8),
    (1, 8, 8, 8, 8), (1, 16, 40, 32, 24)])
@pytest.mark.parametrize("bs,spp,hw", [(2, 4, (37, 53)), (1, 1, (30, 27)),
                                       (2, 8, (16, 40)), (1, 3, (9, 8))])
@pytest.mark.parametrize("masked", [False, True])
def test_sample_chain_embedding_matches_plain(device, step, cx, ce, width,
                                              cout, bs, spp, hw, masked):
    from sbmc_tpu_torch.nn import sample_chain
    rng = np.random.RandomState(step * 100 + spp)
    h, w = hw
    chain = _chain(cx + ce, cout, width, "relu", device)
    feats = _bf16(rng, bs, spp, cx, h, w).to(device)
    extra = _bf16(rng, bs, ce, *((1, 1) if step == 0 else hw)).to(device)
    mask_f = torch.ones(bs, spp, dtype=torch.bfloat16)
    if masked:
        mask_f = torch.tensor(rng.rand(bs, spp) < 0.6).to(torch.bfloat16)
        mask_f[0, 0] = 0
    mask_f = mask_f.to(device)
    n_valid = mask_f.sum(dim=1).clamp(min=1.0)
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = sample_chain.embedding_step(chain, feats, extra, mask_f,
                                          n_valid)
        assert _counts() == {"sample_chain": 1}
        want = sample_chain.embedding_step_ref(chain, feats, extra, mask_f,
                                               n_valid)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
        mx, mean = _chain_units(g, r)
        assert mx <= CHAIN_MAX_UNITS and mean <= CHAIN_MEAN_UNITS


@pytest.mark.cuda
@pytest.mark.parametrize("cx,ce,width,nout", [(128, 128, 128, 441),
                                              (8, 8, 8, 25), (16, 40, 32, 9)])
@pytest.mark.parametrize("bs,spp,hw", [(2, 3, (37, 53)), (1, 1, (30, 27)),
                                       (1, 2, (64, 64))])
@pytest.mark.parametrize("kernel_dtype", [None, torch.float32])
def test_sample_chain_regress_matches_plain(device, cx, ce, width, nout, bs,
                                            spp, hw, kernel_dtype):
    from sbmc_tpu_torch.nn import sample_chain
    rng = np.random.RandomState(nout + spp)
    chain = _chain(cx + ce, nout, width, "leaky_relu", device)
    feats = _bf16(rng, bs, spp, cx, *hw).to(device)
    prop = _bf16(rng, bs, ce, *hw).to(device)
    with torch.inference_mode():
        weights = sample_chain.regressor_weights(chain)
        for s in range(spp):
            got = sample_chain.regress(chain, feats[:, s], prop, kernel_dtype,
                                       weights)
            want = sample_chain.regress_ref(chain, feats[:, s], prop,
                                            kernel_dtype)
            assert got.dtype == want.dtype and got.is_contiguous()
            mx, mean = _chain_units(got, want)
            assert mx <= CHAIN_MAX_UNITS and mean <= CHAIN_MEAN_UNITS


@pytest.mark.cuda
def test_sample_chain_regress_clamps_logits(device):
    """The clamp folded into the kernel's epilogue: ±3e4 as torch.clamp
    gives it in bf16 (29952), NaN kept."""
    from sbmc_tpu_torch.nn import sample_chain
    chain = _chain(16, 9, 8, "leaky_relu", device, seed=3)
    with torch.no_grad():
        chain.prediction.bias[:3] = torch.tensor([1e6, -1e6, float("nan")])
    x = torch.randn(1, 8, 5, 6, device=device).to(torch.bfloat16)
    with torch.inference_mode():
        got = sample_chain.regress(chain, x, x, None)
        want = sample_chain.regress_ref(chain, x, x, None)
    assert torch.equal(got[:, :2], want[:, :2])
    assert float(got[:, 0].float().max()) == 29952.0
    assert bool(got[:, 2].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("spp", [1, 4])
def test_sample_chain_launches_per_tile(device, spp):
    """3 + spp launches a tile under inference_mode (three embedding steps,
    one regressor a sample), and the three U-Nets' 45 epilogues, 6
    upsamples and 6 layout changes; with gradients on none of the chain
    kernel (it has no backward): the training path's kernels (the entry,
    6 per-sample epilogues, 5 U-Net epilogues between the products, the
    logits' epilogue) and the U-Nets' without layout changes; the fused and
    unfused frames agree to bf16 rounding."""
    from sbmc_tpu_torch.models import Multisteps
    torch.manual_seed(0)
    net = Multisteps(n_features=93, n_global_features=3, width=128,
                     embedding_width=128, ksize=21,
                     conv_dtype="bfloat16").to(device)
    g = torch.Generator(device=device).manual_seed(1)
    x = {"radiance": torch.rand(1, spp, 3, 48, 64, generator=g,
                                device=device),
         "features": torch.randn(1, spp, 93, 48, 64, generator=g,
                                 device=device),
         "global_features": torch.randn(1, 3, 1, 1, generator=g,
                                        device=device)}
    ops.reset_launch_counts()
    with torch.inference_mode():
        fused = net(x)["radiance"]
    assert _counts() == {"sample_chain": 3 + spp, "progressive_splat": spp,
                         "unet_epilogue": 45, "unet_upsample": 6,
                         "unet_layout": 6}
    ops.reset_launch_counts()
    plain = net(x)["radiance"].detach()
    assert _counts() == {"progressive_splat": spp, "chain_entry": 1,
                         "chain_epilogue": 6, "chain_logits": 1,
                         "unet_epilogue": 45 + 5, "unet_upsample": 6}
    assert float((fused - plain).norm() / plain.norm()) < 2e-3


@pytest.mark.cuda
def test_sbmc_frame_is_the_inference_dataflow(device):
    """A bf16 SBMC frame under inference_mode (float16 features, one sample
    masked) is, bit for bit and launch for launch, the inference dataflow
    spelled out: each embedding step one chain kernel on the features and
    the global features or the last U-Net's output, the U-Net on the mean,
    each sample's regressor one chain kernel on the regressor's weights made
    once, then its splat. The train step's path leaves inference alone."""
    from sbmc_tpu_torch.models import Multisteps
    from sbmc_tpu_torch.nn import sample_chain
    from sbmc_tpu_torch.nn.kernel_apply import (progressive_init,
                                                progressive_kernel_apply)
    from sbmc_tpu_torch.utils.image import crop_like
    torch.manual_seed(0)
    net = Multisteps(n_features=93, n_global_features=3, width=128,
                     embedding_width=128, ksize=21,
                     conv_dtype="bfloat16").to(device)
    g = torch.Generator(device=device).manual_seed(2)
    bs, spp, h, w = 2, 4, 48, 64
    mask = torch.ones(bs, spp, dtype=torch.bool, device=device)
    mask[1, 3] = False
    x = {"radiance": torch.rand(bs, spp, 3, h, w, generator=g,
                                device=device),
         "features": torch.randn(bs, spp, 93, h, w, generator=g,
                                 device=device).half(),
         "global_features": torch.randn(bs, 3, 1, 1, generator=g,
                                        device=device),
         "sample_mask": mask}
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = net(x)["radiance"]
    launched = _counts()
    ops.reset_launch_counts()
    with torch.inference_mode():
        feats = x["features"].to(torch.bfloat16)
        mask_f = mask.to(torch.bfloat16)
        n_valid = mask_f.sum(dim=1).clamp(min=1.0)
        extra = x["global_features"].reshape(bs, -1, 1, 1).to(torch.bfloat16)
        for step in range(3):
            feats, reduced = sample_chain.embedding_step(
                getattr(net, f"embedding_{step:02d}"), feats, extra, mask_f,
                n_valid)
            extra = getattr(net, f"propagation_{step:02d}")(reduced)
        regressor = net.kernel_stage.kernel_regressor
        weights = sample_chain.regressor_weights(regressor)
        state = progressive_init(bs, 3, h, w, device)
        for s in range(spp):
            kernels = sample_chain.regress(regressor, feats[:, s], extra,
                                           net.kernel_dtype, weights)
            data = crop_like(x["radiance"][:, s], kernels).contiguous()
            state = progressive_kernel_apply(data, kernels, state,
                                             splat=True, valid=mask[:, s])
        crop = (net.ksize - 1) // 2
        want = (state.sum_r / (state.sum_w + net.eps))[
            ..., crop:-crop, crop:-crop]
    assert launched == _counts() == {
        "sample_chain": 3 + spp, "progressive_splat": spp,
        "unet_epilogue": 45, "unet_upsample": 6, "unet_layout": 6}
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sample_chain_rejects_grad(device):
    from sbmc_tpu_torch.nn import sample_chain
    chain = _chain(256, 128, 128, "relu", device)
    feats = torch.randn(1, 2, 128, 8, 8, device=device).to(torch.bfloat16)
    prop = torch.randn(1, 128, 8, 8, device=device).to(torch.bfloat16)
    ones = torch.ones(1, 2, device=device, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no backward"):
        sample_chain.embedding_step(chain, feats, prop, ones, ones.sum(1))
    reg = _chain(256, 441, 128, "leaky_relu", device)
    with torch.no_grad():
        weights = sample_chain.regressor_weights(reg)
    with torch.no_grad(), pytest.raises(RuntimeError, match="no backward"):
        sample_chain.regress(reg, feats[:, 0].clone().requires_grad_(), prop,
                             None, weights)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,fits", [
    ({}, True), ({"width": 8, "embedding_width": 8}, True),
    ({"width": 256}, False), ({"embedding_width": 192}, False)])
def test_sample_chain_kernel_decides_what_fits(device, kw, fits):
    """The kernel's build holds the flagship's and the tiny config's chains,
    and refuses a hidden width or an embedding wider than 128."""
    from sbmc_tpu_torch.models import Multisteps
    args = dict(n_features=93, n_global_features=3, width=128,
                embedding_width=128, ksize=21, conv_dtype="bfloat16")
    args.update(kw)
    assert Multisteps(**args).kernels_fit is fits


# The U-Net's channels-last kernels (csrc/unet.cu) against their plain
# versions. The epilogue rounds as the plain version does (bf16(y + b), the
# activation in float32, one rounding; the max of bf16 values): bit for bit.
# The upsample computes upsample_bilinear2d's float32 expression: bit for
# bit where the scale is 1/2 (every product and sum exact, as at the
# flagship's levels); elsewhere the compilers may contract other products
# into fused multiply-adds, at most one bf16 unit (at the larger of |plain|
# and its mean magnitude). The layout change moves values: bit for bit.
UNET_SHAPES = [(1, 128, 1080, 2048), (2, 24, 37, 53), (1, 8, 5, 1)]


def _cl_bf16(gen, *shape, device):
    return (torch.randn(*shape, generator=gen, device=device)
            .to(torch.bfloat16).contiguous(memory_format=torch.channels_last))


@pytest.mark.cuda
@pytest.mark.parametrize("bs,c,h,w", UNET_SHAPES)
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "linear"])
def test_unet_epilogue_matches_plain(device, bs, c, h, w, act):
    """In place, and into the skip slot of a wider buffer with the pool
    (where the size allows one)."""
    from sbmc_tpu_torch.nn import unet
    cl = torch.channels_last
    gen = torch.Generator(device=device).manual_seed(c + h)
    y = _cl_bf16(gen, bs, c, h, w, device=device)
    y[0, 0, 0, 0] = float("nan")
    bias = 0.3 * torch.randn(c, generator=gen, device=device)
    with torch.inference_mode():
        want = unet.epilogue_ref(y.clone(), bias, act)
        ops.reset_launch_counts()
        got = unet.epilogue(y.clone(), bias, act)
        assert _counts() == {"unet_epilogue": 1}
        assert torch.equal(got[~want.isnan()], want[~want.isnan()])
        assert bool(got[0, 0, 0, 0].isnan())
        if h < 2 or w < 2:
            return
        buf = torch.full((bs, c + 16, h, w), 7.0, dtype=torch.bfloat16,
                         device=device).contiguous(memory_format=cl)
        pool = torch.empty(bs, c, h // 2, w // 2, dtype=torch.bfloat16,
                           device=device, memory_format=cl)
        want_pool = torch.empty_like(pool)
        unet.epilogue_ref(y.clone(), bias, act, None, want_pool)
        unet.epilogue(y, bias, act, buf[:, 16:], pool)
    assert torch.equal(buf[:, 16:][~want.isnan()], want[~want.isnan()])
    assert bool((buf[:, :16] == 7).all())
    assert torch.equal(pool[~want_pool.isnan()],
                       want_pool[~want_pool.isnan()])
    assert bool(pool[0, 0, 0, 0].isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("bs,c,hi,wi,ho,wo", [
    (1, 256, 540, 1024, 1080, 2048), (1, 512, 270, 512, 540, 1024),
    (2, 24, 18, 26, 37, 53), (1, 8, 2, 1, 5, 3), (1, 16, 3, 4, 7, 9),
    (1, 16, 2, 2, 9, 13)])
def test_unet_upsample_matches_plain(device, bs, c, hi, wi, ho, wo):
    """Into the leading slot of a buffer with channels beside it: the
    flagship's two upsamples of a 1080x2048 tile, odd sizes (the pooled
    sizes floor), more than a doubling."""
    from sbmc_tpu_torch.nn import unet
    cl = torch.channels_last
    gen = torch.Generator(device=device).manual_seed(c + ho)
    x = _cl_bf16(gen, bs, c, hi, wi, device=device)
    buf = torch.full((bs, c + 8, ho, wo), 7.0, dtype=torch.bfloat16,
                     device=device).contiguous(memory_format=cl)
    with torch.inference_mode():
        want = unet.upsample_ref(x, torch.empty(bs, c, ho, wo,
                                                dtype=torch.bfloat16,
                                                device=device))
        ops.reset_launch_counts()
        unet.upsample(x, buf[:, :c])
        assert _counts() == {"unet_upsample": 1}
    got = buf[:, :c]
    assert bool((buf[:, c:] == 7).all())
    if 2 * hi == ho and 2 * wi == wo:
        assert torch.equal(got, want)
    else:
        assert _chain_units(got, want)[0] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bs,c,h,w", [(1, 128, 1080, 2048), (2, 24, 37, 53),
                                      (1, 16, 4, 4), (3, 8, 16, 5),
                                      (2, 72, 3, 8)])
def test_unet_layout_matches_plain(device, bs, c, h, w):
    """Both directions, bit for bit: pixels a multiple of 16 (the vector
    kernels), of 8 only (the vector kernel back to NCHW) and neither (a
    value a thread)."""
    from sbmc_tpu_torch.nn import unet
    gen = torch.Generator(device=device).manual_seed(c + h)
    x = torch.randn(bs, c, h, w, generator=gen, device=device).to(
        torch.bfloat16)
    with torch.inference_mode():
        ops.reset_launch_counts()
        cl = unet.relayout(x, True)
        back = unet.relayout(cl, False)
        assert _counts() == {"unet_layout": 2}
    assert cl.is_contiguous(memory_format=torch.channels_last)
    assert back.is_contiguous()
    assert torch.equal(cl, x) and torch.equal(back, x)


# The channels-last U-Net against the NCHW modules: cuDNN picks other
# algorithms for the two layouts at some shapes, which sum a convolution's
# products in another order and flip roundings to bf16, and 15 layers carry
# them on (up to 18 bf16 units apart, 0.74 on average). So both are held to
# the float32 U-Net on the same weights (TF32 off): the channels-last
# path's error is the NCHW path's, within a tenth on average and half at
# the largest (measured: within 2%).
def _unet_of(dtype, device):
    """The flagship's propagation U-Net, random biases."""
    from sbmc_tpu_torch.nn.layers import Autoencoder
    torch.manual_seed(0)
    ae = Autoencoder(128, 128, num_levels=3, increase_factor=2.0,
                     num_convs=3, width=128, ksize=3,
                     output_type="leaky_relu", dtype=dtype).to(device)
    with torch.no_grad():
        for name, p in ae.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.3 * torch.randn_like(p))
    return ae


@pytest.fixture
def plain_path(monkeypatch):
    """A function that runs its argument with every model on its plain
    modules (the kernels' rule says no)."""
    from sbmc_tpu_torch.nn import layers

    def run(fn):
        with monkeypatch.context() as m:
            m.setattr(layers, "kernel_path", lambda module, x: False)
            return fn()
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("bs,h,w", [(1, 96, 128), (2, 37, 53),
                                    (1, 160, 160)])
def test_unet_channels_last_matches_forward(device, plain_path, bs, h, w):
    """The flagship's U-Net: 15 epilogue, 2 upsample and 2 layout launches
    under inference_mode and (its kernels have a backward) with gradients
    on, and the channels-last and NCHW outputs as close to the float32
    U-Net."""
    ae = _unet_of(torch.bfloat16, device)
    x = torch.randn(bs, 128, h, w, device=device).to(torch.bfloat16)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = ae(x)
    assert _counts() == {"unet_epilogue": 15, "unet_upsample": 2,
                         "unet_layout": 2}
    assert got.is_contiguous() and got.dtype == torch.bfloat16
    ops.reset_launch_counts()
    assert torch.equal(ae(x).detach(), got)
    assert _counts() == {"unet_epilogue": 15, "unet_upsample": 2,
                         "unet_layout": 2}
    ops.reset_launch_counts()
    want = plain_path(lambda: ae(x).detach())
    assert _counts() == {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            f32 = _unet_of(None, device)(x.float())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    mx, mean = _chain_units(got, f32)
    mx_nchw, mean_nchw = _chain_units(want, f32)
    assert mean <= 1.1 * mean_nchw and mx <= 1.5 * mx_nchw


# The backward of the U-Net's passes in the train step, against their
# plain versions at the train cell's shapes (batch 16, levels of 128x128,
# 64x64 and 32x32 at 128, 256 and 512 channels, concatenation buffers of 384
# and 768) and odd ones. The epilogue's dz rounds as the plain version
# does: bit for bit (a NaN output passes ReLU's gradient and wins its
# pooling window in both). Its bias gradient and the upsample's backward
# sum in float32 in another order than the plain versions and round once:
# within one bf16 unit (the bias at |plain|, the upsample at the larger of
# |plain| and its mean magnitude).
UNET_TRAIN_LEVELS = [(16, 128, 128, 128, 384), (16, 256, 64, 64, 768),
                     (16, 512, 32, 32, None), (2, 24, 37, 53, 40),
                     (1, 8, 5, 3, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("bs,c,h,w,c_cat", UNET_TRAIN_LEVELS)
@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_unet_epilogue_backward_matches_plain(device, bs, c, h, w, c_cat,
                                              act):
    """Dense, and (where the level has a concatenation buffer) from the
    skip slot of the buffer's gradient with the saved skip a slot too and
    the pool's gradient."""
    from sbmc_tpu_torch.nn import unet
    cl = torch.channels_last
    gen = torch.Generator(device=device).manual_seed(c + h)
    out = torch.relu(_cl_bf16(gen, bs, c, h, w, device=device)) if \
        act == "relu" else _cl_bf16(gen, bs, c, h, w, device=device)
    out[0, 0, 0, 0] = float("nan")
    dy = _cl_bf16(gen, bs, c, h, w, device=device)
    cases = [(dy, out, None)]
    if c_cat is not None:
        dcat = _cl_bf16(gen, bs, c_cat, h, w, device=device)
        skip = torch.empty(bs, c_cat, h, w, dtype=torch.bfloat16,
                           device=device, memory_format=cl)[:, c_cat - c:]
        skip.copy_(out)
        dpool = _cl_bf16(gen, bs, c, h // 2, w // 2, device=device)
        cases.append((dcat[:, c_cat - c:], skip, dpool))
    for dy_, out_, dpool in cases:
        ops.reset_launch_counts()
        dz, db = unet.epilogue_backward(dy_, out_, act, dpool)
        assert _counts() == {"unet_epilogue_backward": 1}
        want_dz, want_db = unet.epilogue_backward_ref(dy_, out_, act, dpool)
        assert dz.is_contiguous(memory_format=cl)
        assert torch.equal(dz, want_dz)
        ulp = torch.pow(2.0, torch.floor(torch.log2(
            want_db.abs().clamp(min=1e-30))) - 7)
        assert bool(((db - want_db).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("bs,c,hi,wi,ho,wo,c_cat", [
    (16, 256, 64, 64, 128, 128, 384), (16, 512, 32, 32, 64, 64, 768),
    (2, 24, 18, 26, 37, 53, 40), (1, 8, 2, 1, 5, 3, 16),
    (1, 16, 2, 2, 9, 13, 24)])
def test_unet_upsample_backward_matches_plain(device, bs, c, hi, wi, ho, wo,
                                              c_cat):
    """From the upsampled slot of a concatenation buffer's gradient: the
    train cell's two levels, odd sizes (the pooled sizes floor), more than
    a doubling."""
    from sbmc_tpu_torch.nn import unet
    gen = torch.Generator(device=device).manual_seed(c + ho)
    g = _cl_bf16(gen, bs, c_cat, ho, wo, device=device)[:, :c]
    ops.reset_launch_counts()
    got = unet.upsample_backward(g, (hi, wi))
    assert _counts() == {"unet_upsample_backward": 1}
    want = unet.upsample_backward_ref(g, (hi, wi))
    assert got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _chain_units(got, want)[0] <= 1.0


def _train_step(model, x, target):
    """One forward and backward of ``model`` on ``x``: the loss and the
    parameters' gradients (float32)."""
    model.zero_grad(set_to_none=True)
    loss = ((model(x)["radiance"].float() - target) ** 2).mean()
    loss.backward()
    return float(loss.detach()), {n: p.grad.float().clone()
                         for n, p in model.named_parameters()}


@pytest.mark.cuda
def test_sbmc_train_step_unets_channels_last(device, plain_path):
    """One bf16 train step of the flagship (batch 2 x 8 spp x 128x128, float32
    features, no mask): the U-Nets' kernels launch 45 + 6 times in the forward
    and 45 epilogue and 6 upsample backwards in the backward, with no layout
    change (they read and write the per-sample chains' channels-last layout,
    whose kernels launch as in
    :func:`test_sbmc_train_step_chains_pixel_major`); the loss and gradients
    are as close to the float32 model's (TF32 off) as the NCHW modules' within
    the train cell's limits: the loss within its ``loss_gap.1`` limit (5e-3,
    relative) of the NCHW step's, and the median leaf's gradient error within
    its ``grad_dir.median.rounding`` limit (4 times the NCHW step's error)."""
    from sbmc_tpu_torch.models import Multisteps

    def model_of(dtype):
        torch.manual_seed(0)
        return Multisteps(93, 3, width=128, embedding_width=128, ksize=21,
                          nsteps=3, conv_dtype=dtype).to(device)

    gen = torch.Generator(device=device).manual_seed(5)
    x = {"radiance": torch.rand(2, 8, 3, 128, 128, generator=gen,
                                device=device),
         "features": torch.randn(2, 8, 93, 128, 128, generator=gen,
                                 device=device),
         "global_features": torch.randn(2, 3, 1, 1, generator=gen,
                                        device=device)}
    target = torch.rand(2, 3, 108, 108, generator=gen, device=device)
    model = model_of("bfloat16")
    ops.reset_launch_counts()
    loss, grads = _train_step(model, x, target)
    assert _counts() == {"progressive_splat": 8,
                         "progressive_splat_dlogits": 8,
                         "chain_entry": 1, "chain_epilogue": 6,
                         "chain_logits": 1, "chain_epilogue_backward": 6,
                         "chain_logits_backward": 8,
                         "unet_epilogue": 45 + 5, "unet_upsample": 6,
                         "unet_epilogue_backward": 45 + 5,
                         "unet_upsample_backward": 6}
    loss_nchw, grads_nchw = plain_path(lambda: _train_step(model, x, target))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss_f32, grads_f32 = _train_step(model_of(None), x, target)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert abs(loss - loss_nchw) <= 5e-3 * abs(loss_nchw)

    def err(g):
        return {n: float((g[n] - w).norm() / w.norm())
                for n, w in grads_f32.items()}

    e, e_nchw = err(grads), err(grads_nchw)
    ratios = sorted(e[n] / e_nchw[n] for n in e)
    assert ratios[len(ratios) // 2] <= 4.0


# KPCN's channels-last kernels (csrc/kpcn.cu) against their plain versions.
# The entry casts and moves values: bit for bit. The exit adds the bias as
# the plain version rounds it and takes the softmax with the hardware's exp2
# and 1 / sum, its sum in another order: each weight within one bf16 unit
# of torch.softmax's, at the weight's own exponent.
def _own_units(got, want):
    want = want.float()
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        want.abs().clamp(min=2.0 ** -126))) - 7)
    return float(((got.float() - want).abs() / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("bs,c,h,w,dtype,width", [
    (1, 27, 1160, 2000, torch.float32, 32), (2, 27, 37, 53, torch.bfloat16, 32),
    (1, 5, 3, 7, torch.float16, 32), (1, 100, 9, 10, torch.bfloat16, 128)])
def test_kpcn_entry_matches_plain(device, bs, c, h, w, dtype, width):
    from sbmc_tpu_torch.nn import kpcn_layout
    gen = torch.Generator(device=device).manual_seed(c + h)
    x = torch.randn(bs, c, h, w, generator=gen, device=device).to(dtype)
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = kpcn_layout.kpcn_entry(x, width)
        assert _counts() == {"kpcn_entry": 1}
        want = kpcn_layout.kpcn_entry_ref(x, width)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,c,k2,h,w", [
    (1, 448, 441, 1124, 1964), (2, 448, 441, 37, 53), (1, 32, 9, 5, 7),
    (1, 512, 512, 3, 33), (2, 448, 441, 1, 1), (3, 64, 49, 30, 31)])
def test_kpcn_exit_matches_plain(device, bs, c, k2, h, w):
    from sbmc_tpu_torch.nn import kpcn_layout
    gen = torch.Generator(device=device).manual_seed(c + h)
    y = (3 * torch.randn(bs, c, h, w, generator=gen, device=device)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bias = torch.randn(k2, generator=gen, device=device)
    with torch.inference_mode():
        ops.reset_launch_counts()
        got = kpcn_layout.kpcn_exit(y, bias, k2)
        assert _counts() == {"kpcn_exit": 1}
        want = kpcn_layout.kpcn_exit_ref(y, bias, k2)
    assert got.is_contiguous() and got.shape == (bs, k2, h, w)
    assert _own_units(got, want) <= 1.0


@pytest.mark.cuda
def test_kpcn_kernels_reject_grad(device):
    from sbmc_tpu_torch.nn import kpcn_layout
    x = torch.rand(1, 27, 8, 8, device=device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kpcn_layout.kpcn_entry(x, 32)
    y = torch.randn(1, 448, 4, 4, device=device).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        kpcn_layout.kpcn_exit(y, torch.zeros(441, device=device), 441)


# Bf16 KPCN channels-last against the NCHW modules: cuDNN sums the padded
# convolutions in another order, which flips roundings to bf16 (as for the
# U-Net above), so both are held to the float32 KPCN on the same weights
# (TF32 off): the channels-last path's relative error within a quarter
# more than the NCHW path's.
@pytest.mark.cuda
@pytest.mark.parametrize("bs,h,w", [(1, 96, 128), (2, 41, 45)])
def test_kpcn_channels_last_matches_forward(device, bs, h, w):
    """2 entry, 16 epilogue and 2 exit launches under inference_mode, none
    with gradients on."""
    from sbmc_tpu_torch.models import KPCN

    def kpcn_of(dtype):
        torch.manual_seed(0)
        model = KPCN(conv_dtype=dtype).to(device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if name.endswith("bias"):
                    p.copy_(0.1 * torch.randn_like(p))
        return model

    model = kpcn_of("bfloat16")
    gen = torch.Generator(device=device).manual_seed(h)
    x = {k: torch.rand(bs, 27 if k.endswith("_in") else 3, h, w,
                       generator=gen, device=device)
         for k in ("kpcn_diffuse_in", "kpcn_specular_in",
                   "kpcn_diffuse_buffer", "kpcn_specular_buffer",
                   "kpcn_albedo")}
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = model(x)["radiance"]
    assert _counts() == {"kpcn_entry": 2, "unet_epilogue": 16,
                         "kpcn_exit": 2, "kernel_weighting": 2}
    ops.reset_launch_counts()
    want = model(x)["radiance"].detach()
    assert _counts() == {"kernel_weighting": 2}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            f32 = kpcn_of(None)(x)["radiance"]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = float((got - f32).norm() / f32.norm())
    err_nchw = float((want - f32).norm() / f32.norm())
    assert err <= 1.25 * err_nchw


# The per-sample chains' kernels of the train step (csrc/chain_train.cu)
# against their plain versions (nn/chain_train.py), at the train cell's
# shapes (16 x 8 spp x 128x128, 93 features and 3 global ones, widths 128,
# 441 logits) and odd ones. The entry casts and moves values, the epilogues
# round as the plain versions do: bit for bit. The sums in float32 in
# another order than PyTorch's, each rounded once (the masked mean, the
# bias gradients, the sum over the samples): within one bf16 unit at the
# larger of the value and the tensor's mean magnitude.
CHAIN_TRAIN_SHAPES = [(8, 16, 128, 128, 128), (3, 2, 37, 53, 24),
                      (1, 1, 5, 3, 8)]


def _mask_of(spp, bs, device):
    mask = torch.ones(bs, spp, device=device, dtype=torch.bfloat16)
    if spp > 1:
        mask[-1, 1] = 0
    return mask, mask.sum(1).clamp(min=1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("bs,spp,cf,cg,h,w,dtype", [
    (16, 8, 93, 3, 128, 128, torch.float16),
    (2, 3, 5, 3, 37, 53, torch.float32),
    (1, 2, 13, 0, 9, 7, torch.bfloat16)])
def test_chain_entry_matches_plain(device, bs, spp, cf, cg, h, w, dtype):
    from sbmc_tpu_torch.nn import chain_train as ct
    gen = torch.Generator(device=device).manual_seed(cf)
    x = torch.randn(bs, spp, cf, h, w, generator=gen, device=device).to(dtype)
    gf = torch.randn(bs, cg, generator=gen, device=device) if cg else None
    k = ct.pad8(cf + cg)
    ops.reset_launch_counts()
    got = ct.entry(x, gf, k, torch.bfloat16)
    assert _counts() == {"chain_entry": 1}
    assert torch.equal(got, ct.entry_ref(x, gf, k, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("spp,bs,h,w,c", CHAIN_TRAIN_SHAPES)
@pytest.mark.parametrize("act,split,mean", [
    ("relu", True, False), ("leaky_relu", True, False),
    ("linear", False, True), ("relu", False, True)])
def test_chain_epilogue_matches_plain(device, spp, bs, h, w, c, act, split,
                                      mean):
    """A split first layer's float32 product and per-pixel term, or a bf16
    product with the masked mean (one sample of the last batch item
    masked)."""
    from sbmc_tpu_torch.nn import chain_train as ct
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(c + h)
    z = torch.randn(spp, bs, h * w, c, generator=gen, device=device)
    e = (torch.randn(bs, h * w, c, generator=gen, device=device)
         if split else None)
    if not split:
        z = z.to(bf16)
    z[0, 0, 0, 0] = float("nan")
    bias = torch.randn(c, generator=gen, device=device)
    mask, nvalid = _mask_of(spp, bs, device) if mean else (None, None)
    want, want_red = ct.epilogue_ref(z, bias, act, bf16, e, mask, nvalid)
    ops.reset_launch_counts()
    got, red = ct.epilogue(z.clone(), bias, act, bf16, e, mask, nvalid)
    assert _counts() == {"chain_epilogue": 1}
    assert torch.allclose(got, want, rtol=0, atol=0, equal_nan=True)
    if mean:
        assert bool(red[0, 0, 0].isnan())
        assert _chain_units(red.flatten()[1:], want_red.flatten()[1:])[0] \
            <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("spp,bs,h,w,c", CHAIN_TRAIN_SHAPES)
@pytest.mark.parametrize("act,mean,sum_samples", [
    ("relu", False, True), ("leaky_relu", False, True),
    ("linear", True, False)])
def test_chain_epilogue_backward_matches_plain(device, spp, bs, h, w, c, act,
                                               mean, sum_samples):
    from sbmc_tpu_torch.nn import chain_train as ct
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(c + w)
    dy = torch.randn(spp, bs, h * w, c, generator=gen, device=device).to(bf16)
    out = torch.randn(spp, bs, h * w, c, generator=gen, device=device).to(bf16)
    if act == "relu":
        out = out.relu()
    mask, nvalid = _mask_of(spp, bs, device) if mean else (None, None)
    dred = (torch.randn(bs, h * w, c, generator=gen, device=device).to(bf16)
            if mean else None)
    saved = None if act == "linear" else out
    want = ct.epilogue_backward_ref(dy, saved, act, dred, mask, nvalid,
                                    sum_samples)
    ops.reset_launch_counts()
    got = ct.epilogue_backward(dy, saved, act, dred, mask, nvalid,
                               sum_samples)
    assert _counts() == {"chain_epilogue_backward": 1}
    assert torch.equal(got[0], want[0])
    assert _chain_units(got[1], want[1])[0] <= 1.0
    if sum_samples:
        assert _chain_units(got[2], want[2])[0] <= 1.0
    else:
        assert got[2] is None


@pytest.mark.cuda
@pytest.mark.parametrize("spp,bs,k2,h,w", [(8, 16, 441, 128, 128),
                                           (3, 2, 25, 37, 53),
                                           (2, 1, 9, 5, 3)])
def test_chain_logits_matches_plain(device, spp, bs, k2, h, w):
    """The bias and the clamp in place (logits beyond the clamp, a NaN),
    then the backward from each sample's gradient: dz bit for bit (zero at
    the clamp and the NaN), the bias gradient within one unit."""
    from sbmc_tpu_torch.nn import chain_train as ct
    bf16 = torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(k2 + h)
    z = torch.randn(spp * bs, k2, h * w, generator=gen, device=device)
    z[0, 0, :3] = torch.tensor([4e4, -5e4, float("nan")])
    z = z.to(bf16)
    bias = torch.randn(k2, generator=gen, device=device)
    want = ct.logits_ref(z, bias)
    ops.reset_launch_counts()
    got = ct.logits(z.clone(), bias)
    assert _counts() == {"chain_logits": 1}
    assert torch.allclose(got, want, rtol=0, atol=0, equal_nan=True)
    grads = [torch.randn(bs, k2, h, w, generator=gen, device=device).to(bf16)
             for _ in range(spp)]
    want_dz, want_db = ct.logits_backward_ref(
        torch.stack(grads).reshape(spp * bs, k2, h * w), want)
    partials = torch.empty(spp * bs, k2, device=device)
    db = torch.empty(k2, device=device)
    ops.reset_launch_counts()
    dz = torch.cat([ct.logits_backward(g, got[s * bs:(s + 1) * bs], partials,
                                       s * bs, db if s == spp - 1 else None)
                    for s, g in enumerate(grads)])
    assert _counts() == {"chain_logits_backward": spp}
    assert torch.equal(dz, want_dz)
    assert float(dz[0, 0, :3].abs().sum()) == 0.0
    assert _chain_units(db, want_db)[0] <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_sbmc_train_step_chains_pixel_major(device, plain_path, remat):
    """One bf16 train step of the flagship (batch 2 x 8 spp x 128x128,
    float16 features as the reservoir holds them, one sample masked): the
    chains' kernels launch once an embedding step's epilogue with a
    per-pixel term or a mean and once a sample in the logits' backward, the
    U-Nets' without layout changes; under ``remat`` the embedding steps and
    the U-Nets run their forward again in the backward pass. The loss and
    gradients are as close to the float32 model's (TF32 off) as the NCHW
    modules' within the train cell's limits (the loss within
    ``loss_gap.1``'s 5e-3, the median leaf's gradient error within
    ``grad_dir.median.rounding``'s 4 times the NCHW step's)."""
    from sbmc_tpu_torch.models import Multisteps

    def model_of(dtype):
        torch.manual_seed(0)
        return Multisteps(93, 3, width=128, embedding_width=128, ksize=21,
                          nsteps=3, conv_dtype=dtype, kernel_dtype=dtype,
                          remat=remat).to(device)

    gen = torch.Generator(device=device).manual_seed(5)
    x = {"radiance": torch.rand(2, 8, 3, 128, 128, generator=gen,
                                device=device),
         "features": torch.randn(2, 8, 93, 128, 128, generator=gen,
                                 device=device).half(),
         "global_features": torch.randn(2, 3, 1, 1, generator=gen,
                                        device=device)}
    x["sample_mask"] = torch.ones(2, 8, dtype=torch.bool, device=device)
    x["sample_mask"][1, 3] = False
    target = torch.rand(2, 3, 108, 108, generator=gen, device=device)
    model = model_of("bfloat16")
    ops.reset_launch_counts()
    loss, grads = _train_step(model, x, target)
    # Recomputed under remat: the embedding steps' epilogues (1 + 2 + 2
    # per-sample, 2 + 1 + 1 of the U-Net's) and the three U-Nets'.
    again = 45 + 4 if remat else 0
    assert _counts() == {"progressive_splat": 8,
                         "progressive_splat_dlogits": 8,
                         "chain_entry": 1,
                         "chain_epilogue": 6 + (5 if remat else 0),
                         "chain_logits": 1, "chain_epilogue_backward": 6,
                         "chain_logits_backward": 8,
                         "unet_epilogue": 45 + 5 + again,
                         "unet_upsample": 6 + (6 if remat else 0),
                         "unet_epilogue_backward": 45 + 5,
                         "unet_upsample_backward": 6}
    loss_nchw, grads_nchw = plain_path(lambda: _train_step(model, x, target))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        loss_f32, grads_f32 = _train_step(model_of(None), x, target)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert abs(loss - loss_nchw) <= 5e-3 * abs(loss_nchw)

    def err(g):
        return {n: float((g[n] - w).norm() / w.norm())
                for n, w in grads_f32.items()}

    e, e_nchw = err(grads), err(grads_nchw)
    ratios = sorted(e[n] / e_nchw[n] for n in e)
    print("chain train step: loss", loss, loss_nchw, loss_f32,
          "ratios median", ratios[len(ratios) // 2], "max", ratios[-1])
    assert ratios[len(ratios) // 2] <= 4.0
