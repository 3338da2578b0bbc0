"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip on a machine without a CUDA device and run on the
GPU with ``python -m pytest --noconftest tests/test_torch_cuda.py -m cuda``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the GPU machine
need not have; this file imports nothing of it).

Tolerance: ``|kernel - plain| <= 2e-4 + 2e-5 * |plain|``. The absolute part
is the JAX package's own bound for its fused splat kernel against the
composed version (``test_fused_full_update_matches_oracle`` in
tests/test_ops.py); the relative part covers float32 sums over up to 441
taps taken in another order (sum_w reaches tens at k = 21).
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
@pytest.mark.parametrize("c,hw,k", [(3, (37, 53), 3), (3, (130, 3), 5),
                                    (2, (5, 7), 21), (3, (37, 53), 21)])
def test_splat_kernel_matches_plain(device, c, hw, k, dtype, init):
    rng = np.random.RandomState(k * 100 + hw[0])
    args = _inputs(rng, 2, c, *hw, k, dtype, init, device)
    with torch.inference_mode():
        before = ops.launch_counts["progressive_splat"]
        got = ops.progressive_splat_update(*args)
        assert ops.launch_counts["progressive_splat"] == before + 1
        want = ops.progressive_splat_update_ref(*args)
        torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == r.shape
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
    with pytest.raises(RuntimeError):
        ops.progressive_splat_update(data.requires_grad_(), logits, sr, sw,
                                     mw)
