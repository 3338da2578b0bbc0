"""Any channel count through the CUDA ops' channel groups.

The splat and kernel-weighting kernels are built for 2 and 3 channels
(``ops.KERNEL_CHANNELS``); on the card the ops run any other count in
channel groups (``ops.channel_groups``: one zero channel appended to a
single channel, groups of 3 and 2 above 3). The grouping lives in
``ops.splat_by_channels``, ``ddata_by_channels``, ``dlogits_by_channels``,
``kw_by_channels`` and ``kw_dw_by_channels``, which take the per-group
function as an argument. Here that function is the g++ host build of the
kernels' arithmetic (``_build.load_host``), which refuses any count but 2
and 3, and the result is held against the JAX package's ops with
``backend="xla"`` at c in {1, 4, 5}, with the tolerances the kernels'
host builds are held to elsewhere:

- forward outputs (B1, B4, B8): ``2e-4 + 2e-5 * |jax|`` (float32 sums over
  up to 441 taps in another order);
- the splat step's gradients (B2, B3): ``3e-4 + 2e-5 * |jax|``, the JAX
  package's bound for its fused backward; bfloat16 ``d_klogits`` may sit on
  the neighbouring bfloat16 value, ``2**-7`` relative;
- the weight gradient (B6): the forward's bound in float32, ``2e-4 + 2**-7
  * |jax|`` in bfloat16.

With several groups a bfloat16 gradient is the groups' float32 parts
summed and rounded once: bit for bit, and not the sum of rounded parts.
Inputs are made from a seed with numpy.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu import ops as jops
from sbmc_tpu_torch import ops
from sbmc_tpu_torch.ops import _build, reference

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ATOL, RTOL, BWD_ATOL, BF16_RTOL = 2e-4, 2e-5, 3e-4, 2.0 ** -7
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
#: (c, (h, w), k): one channel, 2 + 2 and 3 + 2.
CASES = [(1, (9, 12), 5), (4, (7, 10), 3), (5, (6, 9), 21)]


class _Host:
    """The host builds as per-group functions with the CUDA wrappers'
    arguments and results; ``calls`` counts the channels of each call."""

    def __init__(self):
        self.lib = _build.load_host()
        self.calls = []

    def _note(self, c):
        self.calls.append(c)

    def splat(self, data, klogits, sum_r, sum_w, max_w):
        bs, c, h, w = data.shape
        self._note(c)
        out = (torch.empty_like(sum_r), torch.empty_like(sum_w),
               torch.empty_like(max_w))
        assert self.lib.sbmc_progressive_splat_host(
            data.data_ptr(), klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), sum_r.data_ptr(),
            sum_w.data_ptr(), max_w.data_ptr(), *(o.data_ptr() for o in out),
            bs, c, h, w, reference.ksize_of(klogits)) == 0
        return out

    def ddata(self, klogits, new_max, d_r):
        bs, c, h, w = d_r.shape
        self._note(c)
        d_data = torch.empty_like(d_r)
        assert self.lib.sbmc_progressive_splat_ddata_host(
            klogits.data_ptr(), int(klogits.dtype == torch.bfloat16),
            new_max.data_ptr(), d_r.data_ptr(), d_data.data_ptr(), bs, c, h,
            w, reference.ksize_of(klogits)) == 0
        return d_data

    def dlogits(self, data, klogits, new_max, d_r, d_w):
        bs, c, h, w = data.shape
        self._note(c)
        d_logits = torch.empty_like(klogits)
        assert self.lib.sbmc_progressive_splat_dlogits_host(
            data.data_ptr(), klogits.data_ptr(),
            int(klogits.dtype == torch.bfloat16), new_max.data_ptr(),
            d_r.data_ptr(), d_w.data_ptr(), d_logits.data_ptr(), bs, c, h, w,
            reference.ksize_of(klogits)) == 0
        return d_logits

    def kw(self, data, weights):
        bs, c, h, w = data.shape
        self._note(c)
        out = torch.empty_like(data)
        sum_w = torch.empty(bs, h, w)
        assert self.lib.sbmc_kernel_weighting_host(
            data.data_ptr(), weights.data_ptr(),
            int(weights.dtype == torch.bfloat16), out.data_ptr(),
            sum_w.data_ptr(), bs, c, h, w, reference.ksize_of(weights)) == 0
        return out, sum_w

    def kw_exp(self, data, logits, maxes):
        bs, c, h, w = data.shape
        self._note(c)
        out = torch.empty_like(data)
        sum_w = torch.empty(bs, h, w)
        assert self.lib.sbmc_kernel_weighting_exp_host(
            data.data_ptr(), logits.data_ptr(),
            int(logits.dtype == torch.bfloat16), maxes.data_ptr(),
            out.data_ptr(), sum_w.data_ptr(), bs, c, h, w,
            reference.ksize_of(logits)) == 0
        return out, sum_w

    def kw_dw(self, data, d_output, d_sum_w, k, dtype=torch.float32):
        """The tiled gradient (``kw_dw``), which rounds its float32 sums
        to bfloat16 once as it stores them."""
        bs, c, h, w = data.shape
        self._note(c)
        d_w = torch.empty((bs, k * k, h, w), dtype=dtype)
        assert self.lib.sbmc_kernel_weighting_dw_tiles_host(
            data.data_ptr(), d_output.data_ptr(), d_sum_w.data_ptr(),
            d_w.data_ptr(), int(dtype == torch.bfloat16), bs, c, h, w, k, 1,
            1) == 0
        return d_w


def _groups_called(host, c):
    """Each call took 2 or 3 channels, one per group."""
    want = [max(2, b - a) for a, b in ops.channel_groups(c)]
    assert host.calls == want and set(want) <= set(ops.KERNEL_CHANNELS)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.float()
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    assert got.shape == want.shape, (got.shape, want.shape)
    assert torch.all((got - want).abs() <= atol + rtol * want.abs()), \
        float((got - want).abs().max())


def _np(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def test_channel_groups_cover_every_count_in_kernel_sizes():
    for c in range(0, 40):
        groups = ops.channel_groups(c)
        assert groups[0][0] == 0 and groups[-1][1] == c
        assert all(a < b or c == 0 for a, b in groups)
        assert all(b == a2 for (_, b), (a2, _) in zip(groups, groups[1:]))
        sizes = [b - a for a, b in groups]
        if c >= 2:
            assert set(sizes) <= set(ops.KERNEL_CHANNELS)
    assert ops.channel_groups(4) == [(0, 2), (2, 4)]
    assert ops.channel_groups(5) == [(0, 3), (3, 5)]
    assert ops.channel_groups(1) == [(0, 1)]


@pytest.mark.parametrize("c,shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("init", [True, False])
def test_splat_step_by_channels_matches_jax(c, shape, k, tdt, jdt, init):
    rng = np.random.RandomState(10 + c + k)
    bs, (h, w) = 2, shape
    data, logits = _np(rng, bs, c, h, w), _np(rng, bs, k * k, h, w, scale=3)
    if init:
        state = (np.zeros((bs, c, h, w), np.float32),
                 np.zeros((bs, 1, h, w), np.float32),
                 np.full((bs, 1, h, w), -1e30, np.float32))
    else:
        state = (_np(rng, bs, c, h, w),
                 np.abs(_np(rng, bs, 1, h, w)), _np(rng, bs, 1, h, w))
    host = _Host()
    t_logits = torch.from_numpy(logits).to(tdt)
    got = ops.splat_by_channels(host.splat, torch.from_numpy(data), t_logits,
                                *map(torch.from_numpy, state))
    _groups_called(host, c)
    want = jops.progressive_splat_update(
        jnp.asarray(data), jnp.asarray(logits).astype(jdt),
        *map(jnp.asarray, state), backend="xla")
    for g, r in zip(got, want):
        _close(g, r)


def _splat_grads_jax(data, logits, state, d_r, d_w, jdt):
    def scalar(d, lg):
        out = jops.progressive_splat_update(d, lg, *map(jnp.asarray, state),
                                            backend="xla")
        return jnp.sum(out[0] * d_r) + jnp.sum(out[1] * d_w)
    return jax.grad(scalar, argnums=(0, 1))(
        jnp.asarray(data), jnp.asarray(logits).astype(jdt))


@pytest.mark.parametrize("c,shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_splat_gradients_by_channels_match_jax(c, shape, k, tdt, jdt):
    rng = np.random.RandomState(20 + c + k)
    bs, (h, w) = 2, shape
    data, logits = _np(rng, bs, c, h, w), _np(rng, bs, k * k, h, w, scale=3)
    state = (_np(rng, bs, c, h, w), np.abs(_np(rng, bs, 1, h, w)),
             _np(rng, bs, 1, h, w))
    d_r, d_w = _np(rng, bs, c, h, w), _np(rng, bs, 1, h, w)
    t_data, t_logits = torch.from_numpy(data), torch.from_numpy(logits).to(tdt)
    new_max = reference.progressive_splat_update_ref(
        t_data, t_logits, *map(torch.from_numpy, state))[2]
    host = _Host()
    d_data = ops.ddata_by_channels(host.ddata, t_logits, new_max,
                                   torch.from_numpy(d_r))
    _groups_called(host, c)
    host.calls.clear()
    d_logits = ops.dlogits_by_channels(host.dlogits, t_data, t_logits,
                                       new_max, torch.from_numpy(d_r),
                                       torch.from_numpy(d_w))
    _groups_called(host, c)
    assert d_logits.dtype == tdt
    want_data, want_logits = _splat_grads_jax(data, logits, state, d_r, d_w,
                                              jdt)
    _close(d_data, want_data, BWD_ATOL)
    _close(d_logits, want_logits, BWD_ATOL,
           BF16_RTOL if tdt == torch.bfloat16 else RTOL)


@pytest.mark.parametrize("c,shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_kernel_weighting_by_channels_matches_jax(c, shape, k, tdt, jdt):
    """Forward and weight gradient. JAX returns ``sum_w`` in bfloat16 for
    bfloat16 weights (a divergence ROADMAP.md records): the port's float32
    ``sum_w`` is held against JAX's sum of the widened weights."""
    rng = np.random.RandomState(30 + c + k)
    bs, (h, w) = 2, shape
    data, wts = _np(rng, bs, c, h, w), _np(rng, bs, k * k, h, w)
    d_out, d_sw = _np(rng, bs, c, h, w), _np(rng, bs, h, w)
    t_data, t_wts = torch.from_numpy(data), torch.from_numpy(wts).to(tdt)
    host = _Host()
    out, sum_w = ops.kw_by_channels(host.kw, t_data, t_wts)
    _groups_called(host, c)
    jw = jnp.asarray(wts).astype(jdt)
    want_out, _ = jops.kernel_weighting(jnp.asarray(data), jw, backend="xla")
    _, want_sw = jops.kernel_weighting(jnp.asarray(data),
                                       jw.astype(jnp.float32), backend="xla")
    _close(out, want_out)
    _close(sum_w, want_sw)

    host.calls.clear()
    d_w = ops.kw_dw_by_channels(host.kw_dw, t_data, torch.from_numpy(d_out),
                                torch.from_numpy(d_sw), k, tdt)
    _groups_called(host, c)
    assert d_w.dtype == tdt

    def scalar(wf):
        o, s = jops.kernel_weighting(jnp.asarray(data), wf, backend="xla")
        return jnp.sum(o * d_out) + jnp.sum(s * d_sw)
    want_dw = jax.grad(scalar)(jnp.asarray(t_wts.float().numpy()))
    _close(d_w, want_dw, ATOL, BF16_RTOL if tdt == torch.bfloat16 else RTOL)


@pytest.mark.parametrize("c,shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_kernel_weighting_exp_by_channels_matches_jax(c, shape, k, tdt, jdt):
    rng = np.random.RandomState(40 + c + k)
    bs, (h, w) = 2, shape
    data, logits = _np(rng, bs, c, h, w), _np(rng, bs, k * k, h, w, scale=3)
    t_logits = torch.from_numpy(logits).to(tdt)
    maxes = (t_logits.float().amax(1)
             + torch.from_numpy(rng.rand(bs, h, w).astype(np.float32)))
    host = _Host()
    out, sum_w = ops.kw_by_channels(host.kw_exp, torch.from_numpy(data),
                                    t_logits, maxes)
    _groups_called(host, c)
    want = jops.kernel_weighting_exp(
        jnp.asarray(data), jnp.asarray(logits).astype(jdt),
        jnp.asarray(maxes.numpy()), backend="xla")
    _close(out, want[0])
    _close(sum_w, want[1])


def _bf16_bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("c", [4, 5])
def test_bf16_gradients_over_groups_round_once(c):
    """Over several groups, the bfloat16 ``d_klogits`` and ``d_weights`` are
    the float32 parts (each group run on float32 logits or into float32
    weights) summed and rounded once, bit for bit; rounding each part first
    gives other values, so the test tells the two apart."""
    rng = np.random.RandomState(50 + c)
    bs, h, w, k = 2, 8, 11, 5
    data = torch.from_numpy(_np(rng, bs, c, h, w))
    logits = torch.from_numpy(_np(rng, bs, k * k, h, w, scale=3)).to(
        torch.bfloat16)
    state = (torch.from_numpy(_np(rng, bs, c, h, w)),
             torch.from_numpy(np.abs(_np(rng, bs, 1, h, w))),
             torch.from_numpy(_np(rng, bs, 1, h, w)))
    d_r = torch.from_numpy(_np(rng, bs, c, h, w))
    d_w = torch.from_numpy(_np(rng, bs, 1, h, w))
    new_max = reference.progressive_splat_update_ref(data, logits,
                                                     *state)[2]
    host = _Host()
    got = ops.dlogits_by_channels(host.dlogits, data, logits, new_max, d_r,
                                  d_w)
    parts32, parts16 = [], []
    for i, (a, b) in enumerate(ops.channel_groups(c)):
        dw_i = d_w if i == 0 else torch.zeros_like(d_w)
        args = (data[:, a:b].contiguous(), new_max,
                d_r[:, a:b].contiguous(), dw_i)
        parts32.append(host.dlogits(args[0], logits.float(), *args[1:]))
        parts16.append(host.dlogits(args[0], logits, *args[1:]))
    once = (parts32[0] + parts32[1]).to(torch.bfloat16)
    assert torch.equal(_bf16_bits(got), _bf16_bits(once))
    twice = (parts16[0].float() + parts16[1].float()).to(torch.bfloat16)
    assert not torch.equal(_bf16_bits(got), _bf16_bits(twice))

    d_out = torch.from_numpy(_np(rng, bs, c, h, w))
    d_sw = torch.from_numpy(_np(rng, bs, h, w))
    got = ops.kw_dw_by_channels(host.kw_dw, data, d_out, d_sw, k,
                                torch.bfloat16)
    parts32, parts16 = [], []
    for i, (a, b) in enumerate(ops.channel_groups(c)):
        args = (data[:, a:b].contiguous(), d_out[:, a:b].contiguous(),
                d_sw if i == 0 else torch.zeros_like(d_sw), k)
        parts32.append(host.kw_dw(*args))
        parts16.append(host.kw_dw(*args, torch.bfloat16))
    once = (parts32[0] + parts32[1]).to(torch.bfloat16)
    assert torch.equal(_bf16_bits(got), _bf16_bits(once))
    twice = (parts16[0].float() + parts16[1].float()).to(torch.bfloat16)
    assert not torch.equal(_bf16_bits(got), _bf16_bits(twice))


def test_one_launch_refuses_other_channel_counts():
    """A kernel's own wrapper takes 2 or 3 channels and names the grouping
    ops; it checks before it builds or launches anything."""
    bs, h, w, k = 1, 6, 8, 3
    logits = torch.zeros(bs, k * k, h, w)
    plane = torch.zeros(bs, 1, h, w)
    with pytest.raises(ValueError, match="channel_groups"):
        ops._progressive_splat_cuda(torch.zeros(bs, 4, h, w), logits,
                                    torch.zeros(bs, 4, h, w), plane, plane)
    with pytest.raises(ValueError, match="channel_groups"):
        ops._kernel_weighting_cuda(torch.zeros(bs, 1, h, w), logits)
    with pytest.raises(ValueError, match="channel_groups"):
        ops._kernel_weighting_exp_cuda(torch.zeros(bs, 5, h, w), logits,
                                       torch.zeros(bs, h, w))
