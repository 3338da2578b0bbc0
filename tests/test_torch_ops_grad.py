"""Gradients of the port's progressive splat against ``sbmc_tpu.ops``.

Inputs and cotangents are made from a seed with numpy and fed to both.
Tolerances:

- float32 gradients against ``jax.grad`` of the ``xla`` backend:
  ``|port - jax| <= 1e-5 + 1e-5 * |jax|`` (the same composition; sums over
  up to 441 taps in other orders).
- bfloat16 logits: ``d_klogits`` comes back in bfloat16 from both, each
  rounded from a float32 value that differs in the last bits, so results may
  sit on neighbouring bfloat16 values: ``1e-5 + 2**-7 * |jax|``.
- against the Pallas backward kernels in interpret mode: the JAX package's
  own 3e-4 for its fused backward (tests/test_ops.py) plus the relative
  term above.
- the CUDA kernels' per-pixel functions, built for the host with g++,
  against the plain version: ``3e-4 + 2e-5 * |plain|``, the bound
  chip_smoke.py holds the kernels to (bfloat16 outputs: plus ``2**-7``
  relative).
- two chained steps of the op against plain autograd through
  ``progressive_splat_update_ref``: the op drops the running max's
  gradient, which cancels only in ``sum_r / (sum_w + eps)``, up to eps:
  ``1e-5 + 1e-4 * |autograd|``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbmc_tpu import ops as jops
from sbmc_tpu_torch import ops
from sbmc_tpu_torch.nn.kernel_apply import (progressive_init,
                                            progressive_kernel_apply)
from sbmc_tpu_torch.ops import _build, reference

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# (shape, k): k = 21 only on tiny tiles.
CASES = [((9, 12), 3), ((11, 8), 5), ((6, 9), 21)]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
NAMES = ("data", "klogits", "sum_r", "sum_w", "max_w")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _inputs(rng, bs, c, h, w, k, init):
    data = rng.randn(bs, c, h, w).astype(np.float32)
    logits = (3 * rng.randn(bs, k * k, h, w)).astype(np.float32)
    if init:
        st = (np.zeros((bs, c, h, w), np.float32),
              np.zeros((bs, 1, h, w), np.float32),
              np.full((bs, 1, h, w), -1e30, np.float32))
    else:
        st = (rng.randn(bs, c, h, w).astype(np.float32),
              np.abs(rng.randn(bs, 1, h, w)).astype(np.float32),
              rng.randn(bs, 1, h, w).astype(np.float32))
    cts = (rng.randn(bs, c, h, w).astype(np.float32),
           rng.randn(bs, 1, h, w).astype(np.float32),
           rng.randn(bs, 1, h, w).astype(np.float32))
    return (data, logits) + st, cts


def _jax_grads(args, cts, jdt, backend):
    jargs = [jnp.asarray(a) for a in args]
    jargs[1] = jargs[1].astype(jdt)

    def scalar(*a):
        outs = jops.progressive_splat_update(*a, backend=backend)
        return sum(jnp.sum(o * jnp.asarray(ct)) for o, ct in zip(outs, cts))
    return jax.grad(scalar, argnums=(0, 1, 2, 3, 4))(*jargs)


def _torch_grads(args, cts, tdt):
    targs = [torch.from_numpy(a) for a in args]
    targs[1] = targs[1].to(tdt)
    targs = [t.requires_grad_() for t in targs]
    outs = ops.progressive_splat_update(*targs)
    assert not outs[2].requires_grad  # the new max carries no gradient
    loss = sum((o * torch.from_numpy(ct)).sum() for o, ct in zip(outs, cts))
    return targs, outs, torch.autograd.grad(loss, targs)


def _assert_grads(got, want, tdt, atol=1e-5):
    for name, g, r in zip(NAMES, got, want):
        rtol = 2.0 ** -7 if (name == "klogits"
                             and tdt == torch.bfloat16) else 1e-5
        np.testing.assert_allclose(_np(g), _np(r), atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("shape,k", CASES)
@pytest.mark.parametrize("tdt,jdt", DTYPES)
@pytest.mark.parametrize("init", [True, False])
def test_function_gradients_match_jax(shape, k, tdt, jdt, init):
    """All five input gradients of the autograd.Function, with random
    cotangents on all three outputs, against jax.grad (xla backend); and
    the plain backward on its own against the same."""
    rng = np.random.RandomState(40 + k)
    args, cts = _inputs(rng, 2, 3, *shape, k, init)
    want = _jax_grads(args, cts, jdt, "xla")
    targs, outs, got = _torch_grads(args, cts, tdt)
    assert got[1].dtype == tdt and got[0].dtype == torch.float32
    _assert_grads(got, want, tdt)
    assert torch.count_nonzero(got[4]) == 0  # d_max_w == 0
    d_data, d_logits = reference.progressive_splat_bwd_ref(
        targs[0].detach(), targs[1].detach(), outs[2],
        torch.from_numpy(cts[0]), torch.from_numpy(cts[1]))
    _assert_grads((d_data, d_logits), want[:2], tdt)


@pytest.mark.parametrize("shape,k,tdt,jdt", [
    ((10, 140), 3, torch.float32, jnp.float32),
    ((33, 70), 5, torch.bfloat16, jnp.bfloat16)])
def test_function_gradients_match_pallas_interpret(shape, k, tdt, jdt):
    """Against the Pallas backward kernels themselves (interpret mode)."""
    rng = np.random.RandomState(1)
    args, cts = _inputs(rng, 1, 3, *shape, k, False)
    want = _jax_grads(args, cts, jdt, "pallas_interpret")
    _, _, got = _torch_grads(args, cts, tdt)
    _assert_grads(got, want, tdt, atol=3e-4)


@pytest.mark.parametrize("c,shape,k", [(3, (9, 12), 3), (2, (13, 7), 5),
                                       (3, (23, 25), 21), (2, (5, 4), 21)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_backward_pixel_math_matches_plain(c, shape, k, tdt):
    """The two backward kernels' per-pixel functions (p + d_t indexing,
    image bounds, bfloat16 rounding), run on the host, with the running max
    of a real forward."""
    lib = _build.load_host()
    rng = np.random.RandomState(50 + k + c)
    bs = 2
    args, cts = _inputs(rng, bs, c, *shape, k, False)
    data, logits = torch.from_numpy(args[0]), \
        torch.from_numpy(args[1]).to(tdt)
    new_max = reference.progressive_splat_update_ref(
        data, logits, *(torch.from_numpy(a) for a in args[2:]))[2]
    d_r, d_w = torch.from_numpy(cts[0]), torch.from_numpy(cts[1])
    want_data, want_logits = reference.progressive_splat_bwd_ref(
        data, logits, new_max, d_r, d_w)
    bf16 = int(tdt == torch.bfloat16)
    got_data = torch.full_like(d_r, float("nan"))
    got_logits = torch.full_like(logits, float("nan"))
    assert lib.sbmc_progressive_splat_ddata_host(
        logits.data_ptr(), bf16, new_max.data_ptr(), d_r.data_ptr(),
        got_data.data_ptr(), bs, c, *shape, k) == 0
    assert lib.sbmc_progressive_splat_dlogits_host(
        data.data_ptr(), logits.data_ptr(), bf16, new_max.data_ptr(),
        d_r.data_ptr(), d_w.data_ptr(), got_logits.data_ptr(), bs, c, *shape,
        k) == 0
    for g, r, rtol in ((got_data, want_data, 2e-5),
                       (got_logits.float(), want_logits.float(),
                        2.0 ** -7 if bf16 else 2e-5)):
        assert torch.all((g - r).abs() <= 3e-4 + rtol * r.abs()), \
            float((g - r).abs().max())
    assert lib.sbmc_progressive_splat_ddata_host(
        logits.data_ptr(), bf16, new_max.data_ptr(), d_r.data_ptr(),
        got_data.data_ptr(), bs, 5, *shape, k) == 1


def _normalised(update, data, logits):
    bs, c, h, w = data[0].shape
    state = progressive_init(bs, c, h, w)
    for d, lg in zip(data, logits):
        state = update(d, lg, *state)
    return state[0] / (state[1] + 1e-8)


@pytest.mark.parametrize("k,shape", [(3, (8, 9)), (5, (7, 6))])
def test_chained_steps_match_plain_autograd(k, shape):
    """The op alone drops the running max's gradient, so it would fail a
    gradcheck; through ``sum_r / (sum_w + eps)`` over two chained steps its
    gradients equal plain autograd through the plain forward, which is
    shift-invariant."""
    rng = np.random.RandomState(k)
    ct = torch.from_numpy(rng.randn(2, 3, *shape).astype(np.float32))
    grads = []
    for update in (ops.progressive_splat_update,
                   reference.progressive_splat_update_ref):
        r = np.random.RandomState(60 + k)
        data = [torch.tensor(r.randn(2, 3, *shape), dtype=torch.float32,
                             requires_grad=True) for _ in range(2)]
        logits = [torch.tensor(3 * r.randn(2, k * k, *shape),
                               dtype=torch.float32, requires_grad=True)
                  for _ in range(2)]
        out = _normalised(update, data, logits)
        grads.append(torch.autograd.grad((out * ct).sum(), data + logits))
    for g, r in zip(*grads):
        np.testing.assert_allclose(_np(g), _np(r), atol=1e-5, rtol=1e-4)


def test_backward_computes_only_what_is_asked(monkeypatch):
    """``needs_input_grad`` decides which backward kernel runs: training
    asks for ``d_klogits`` only, so the ``d_data`` kernel is skipped."""
    calls = {"ddata": 0, "dlogits": 0}
    real_ddata = reference.progressive_splat_ddata_ref
    real_dlogits = reference.progressive_splat_dlogits_ref

    def ddata(*a):
        calls["ddata"] += 1
        return real_ddata(*a)

    def dlogits(*a):
        calls["dlogits"] += 1
        return real_dlogits(*a)

    monkeypatch.setattr(reference, "progressive_splat_ddata_ref", ddata)
    monkeypatch.setattr(reference, "progressive_splat_dlogits_ref", dlogits)
    rng = np.random.RandomState(7)
    args, _ = _inputs(rng, 1, 3, 6, 7, 3, True)
    for needs, want in (((False, True), {"ddata": 0, "dlogits": 1}),
                        ((True, False), {"ddata": 1, "dlogits": 1}),
                        ((True, True), {"ddata": 2, "dlogits": 2})):
        targs = [torch.from_numpy(a) for a in args]
        targs[0].requires_grad_(needs[0])
        targs[1].requires_grad_(needs[1])
        ops.reset_launch_counts()
        out = ops.progressive_splat_update(*targs)
        (out[0].sum() + out[1].sum()).backward()
        assert calls == want
        assert (targs[0].grad is not None) == needs[0]
        assert (targs[1].grad is not None) == needs[1]
        # CPU tensors take the plain versions: no kernel launch is counted.
        assert set(ops.launch_counts.values()) == {0}
    # State gradients alone need neither.
    targs = [torch.from_numpy(a) for a in args]
    targs[2].requires_grad_()
    out = ops.progressive_splat_update(*targs)
    out[0].sum().backward()
    assert calls == {"ddata": 2, "dlogits": 2}
    assert targs[2].grad is not None


def test_masked_sample_gets_exactly_zero_gradient():
    rng = np.random.RandomState(8)
    bs, k, h, w = 2, 3, 6, 7
    state = progressive_init(bs, 3, h, w)
    leaves = []
    valid = torch.tensor([[True, True], [False, True]])  # [sample, batch]
    for s in range(2):
        data = torch.tensor(rng.randn(bs, 3, h, w), dtype=torch.float32,
                            requires_grad=True)
        logits = torch.tensor(rng.randn(bs, k * k, h, w),
                              dtype=torch.float32, requires_grad=True)
        leaves.append((data, logits))
        state = progressive_kernel_apply(data, logits, state, valid=valid[s])
    (state.sum_r / (state.sum_w + 1e-8)).square().sum().backward()
    data1, logits1 = leaves[1]
    assert torch.count_nonzero(data1.grad[0]) == 0
    assert torch.count_nonzero(logits1.grad[0]) == 0
    assert torch.count_nonzero(logits1.grad[1]) > 0
    assert torch.count_nonzero(leaves[0][1].grad[0]) > 0


def test_usable_without_grad_and_with_strided_cotangents():
    rng = np.random.RandomState(9)
    args, _ = _inputs(rng, 1, 3, 6, 7, 3, True)
    targs = [torch.from_numpy(a) for a in args]
    with torch.inference_mode():
        got = ops.progressive_splat_update(*targs)
    want = reference.progressive_splat_update_ref(*targs)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    # sum() hands the backward an expanded (stride-0) cotangent.
    targs[1].requires_grad_()
    out = ops.progressive_splat_update(*targs)
    out[0].sum().backward()
    d_logits = reference.progressive_splat_dlogits_ref(
        targs[0], targs[1].detach(), out[2], torch.ones_like(out[0]),
        torch.zeros_like(out[1]))
    assert torch.equal(targs[1].grad, d_logits)
