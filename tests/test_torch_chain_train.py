"""SBMC's per-sample 1x1 chains in the train step, on pixel-major matrices
(``sbmc_tpu_torch.nn.chain_train``), on the CPU.

On CPU tensors the chain kernels' plain versions run, so these tests hold

- each plain version to the unfused expression it replaces (the entry to
  ``torch.cat`` of the features and the global features, the epilogue to
  ``WNConv2D.forward`` and ``ConvChain``'s rounding and the plain embedding
  step's masked mean) and each backward to PyTorch's autograd through the
  forward;
- the autograd Functions (an embedding step, the regressor) to autograd
  through ``sample_chain.embedding_step_ref`` / ``regress_ref`` on the same
  weights and inputs: step 0 (the global features, a vector a batch item,
  written into the entry's rows), steps >= 1 and the regressor (the
  per-pixel input, split out of the first product), batch 2 of 3 samples
  with one invalid, odd image sizes, widths 8 and 128; the outputs, the
  mean, the logits and the gradients of the inputs and of every ``v``,
  ``g`` and ``bias``;
- ``Multisteps`` on this path (the kernel rule patched to say yes) to its
  plain modules, also under ``remat`` and under DDP's ``no_sync``.

The kernels' own arguments and the launches a train step makes are checked
on the ``fake_card`` fixture; the kernels themselves are held to the plain
versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances:

- the plain versions: bit for bit (the same operations in the same
  dtype), but where noted;
- float32: ``|path - plain| <= 1e-5 * max |plain|`` (the split product and
  the products' sums in another order);
- bf16: the two paths round in the same places but sum in other orders, so
  each is held to the float32 model on the same weights and inputs in units
  of the plain path's own error (``_rounding_ratios`` of
  ``tests/test_torch_unet_fused.py``): at most ``ROUNDING_L2`` in L2 and
  ``ROUNDING_MAX`` at the largest element, tensor by tensor.
"""

import os
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from sbmc_tpu_torch.models import Multisteps
from sbmc_tpu_torch.nn import chain_train, layers, sample_chain
from tests.test_torch_kernel_paths import fake_card  # noqa: F401
from tests.test_torch_sample_chain import _chain, _mask
from tests.test_torch_unet_fused import (ROUNDING_L2, ROUNDING_MAX,
                                         _rounding_ratios)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = torch.bfloat16
F32_REL = 1e-5
BS, SPP, H, W = 2, 3, 5, 7


def _close(got, want, dtype, f32=None, what=""):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= F32_REL * float(want.abs().max()), what
    else:
        l2, mx = _rounding_ratios(got, want, f32)
        assert l2 <= ROUNDING_L2 and mx <= ROUNDING_MAX, (what, l2, mx)


# --- The plain versions ------------------------------------------------------


@pytest.mark.parametrize("src", [torch.float16, torch.float32, BF16])
@pytest.mark.parametrize("cg,k", [(3, 16), (0, 16), (3, 24)])
def test_plain_entry_is_the_cat(src, cg, k):
    """The rows are ``cat([features, global features])`` as the plain
    embedding step builds it, rounded to bf16 once, zeros beyond."""
    g = torch.Generator().manual_seed(cg + k)
    feats = torch.randn(BS, SPP, 13, H, W, generator=g).to(src)
    gf = torch.randn(BS, cg, generator=g) if cg else None
    got = chain_train.entry_ref(feats, gf, k, BF16)
    parts = [feats.to(BF16)]
    if cg:
        parts.append(gf.to(BF16)[:, None, :, None, None].expand(
            BS, SPP, cg, H, W))
    want = F.pad(torch.cat(parts, 2), (0, 0, 0, 0, 0, k - 13 - cg))
    assert torch.equal(got, want.permute(1, 0, 3, 4, 2).reshape(
        SPP, BS, H * W, k))


def _rows(t):
    """``[bs, spp, c, h, w]`` as pixel-major ``[spp, bs, h * w, c]``."""
    bs, spp, c, h, w = t.shape
    return t.permute(1, 0, 3, 4, 2).reshape(spp, bs, h * w, c)


def _pixels(t):
    """``[bs, c, h, w]`` as ``[bs, h * w, c]``."""
    return t.flatten(2).transpose(1, 2)


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "linear"])
@pytest.mark.parametrize("split,mean", [(True, False), (False, True),
                                        (False, False)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_epilogue_is_the_unfused_expression(act, split, mean, dtype):
    """``act(bf16(z + e) + bias)`` as a convolution on ``cat([feats,
    extra])`` rounds its one sum and ``ConvChain`` its bias and activation,
    and the masked mean as the plain embedding step takes it."""
    g = torch.Generator().manual_seed(3)
    z = torch.randn(SPP, BS, H * W, 16, generator=g)
    e = torch.randn(BS, H * W, 16, generator=g) if split else None
    if not split:
        z = z.to(dtype)
    bias = torch.randn(16, generator=g)
    mask_f, n_valid = _mask(BS, SPP, True, dtype)
    out, red = chain_train.epilogue_ref(
        z, bias, act, dtype, e, mask_f if mean else None, n_valid)
    y = (z + e).to(dtype) if split else z
    want = {"relu": F.relu, "leaky_relu": lambda t: F.leaky_relu(t, 0.01),
            "linear": lambda t: t}[act](y + bias.to(dtype))
    assert torch.equal(out, want)
    if mean:
        nchw = want.reshape(SPP, BS, H, W, 16).permute(1, 0, 4, 2, 3)
        red_want = ((nchw * mask_f[:, :, None, None, None]).sum(dim=1)
                    / n_valid[:, None, None, None])
        assert torch.equal(red, _pixels(red_want))
    else:
        assert red is None


@pytest.mark.parametrize("act", ["relu", "leaky_relu", "linear"])
@pytest.mark.parametrize("split,mean", [(True, False), (False, True)])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_epilogue_backward_is_autograd(act, split, mean, dtype):
    """From the gradients of the output and of the mean: the product's, the
    per-pixel term's (its sum over the samples, rounded once) and the
    bias's, as autograd gives them through :func:`epilogue_ref`."""
    g = torch.Generator().manual_seed(5)
    z = torch.randn(SPP, BS, H * W, 16, generator=g)
    if not split:
        z = z.to(dtype)
    z.requires_grad_()
    e = (torch.randn(BS, H * W, 16, generator=g).requires_grad_()
         if split else None)
    bias = torch.randn(16, generator=g).requires_grad_()
    mask_f, n_valid = _mask(BS, SPP, True, dtype)
    out, red = chain_train.epilogue_ref(
        z, bias, act, dtype, e, mask_f if mean else None, n_valid)
    dy = torch.randn(out.shape, generator=g).to(dtype)
    loss = (out * dy).sum()
    dred = None
    if mean:
        dred = torch.randn(red.shape, generator=g).to(dtype)
        loss = loss + (red * dred).sum()
    leaves = [z, bias] + ([e] if split else [])
    want = torch.autograd.grad(loss, leaves)
    dz, dbias, dsum = chain_train.epilogue_backward_ref(
        dy, out.detach(), act, dred, mask_f if mean else None, n_valid,
        sum_samples=split)
    assert dz.dtype == dtype and dbias.dtype == torch.float32
    assert torch.equal(dz, want[0].to(dtype))
    assert torch.equal(dbias, want[1])
    if split:
        assert torch.equal(dsum, want[2].to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_plain_logits_backward_is_autograd(dtype):
    """The bias and the clamp (logits beyond it on both sides, a NaN), and
    the backward: zero beyond the clamp and at the NaN, as autograd
    gives it."""
    g = torch.Generator().manual_seed(7)
    z = torch.randn(BS * SPP, 9, H * W, generator=g)
    z[0, 0, :3] = torch.tensor([4e4, -5e4, float("nan")])
    z = z.to(dtype).requires_grad_()
    bias = torch.randn(9, generator=g).requires_grad_()
    out = chain_train.logits_ref(z, bias)
    want_out = (z + bias.to(dtype)[:, None]).clamp(-3e4, 3e4)
    assert torch.allclose(out, want_out, rtol=0, atol=0, equal_nan=True)
    dy = torch.randn(out.shape, generator=g).to(dtype)
    want = torch.autograd.grad((out * dy).nansum(), [z, bias])
    dz, dbias = chain_train.logits_backward_ref(dy, out.detach())
    assert torch.equal(dz, want[0])
    assert float(dz[0, 0, :3].abs().sum()) == 0.0
    assert torch.equal(dbias, want[1])


def test_plain_logits_backward_at_the_bound():
    """A logit whose sum lands exactly on the clamp's bound in bf16
    (29952) is taken as clamped: no gradient, where autograd passes it.
    Documented, not hidden: the saved logit cannot tell the two apart."""
    out = torch.tensor([[[29952.0, 29824.0, -29952.0]]]).to(BF16)
    dz, _ = chain_train.logits_backward_ref(torch.ones_like(out), out)
    assert dz.float().tolist() == [[[0.0, 1.0, 0.0]]]


# --- The autograd Functions --------------------------------------------------


def _twin(chain):
    """``chain`` computing in float32: the reference of a bf16 chain."""
    twin = _chain(chain.layer_0.v.shape[1], chain.prediction.v.shape[0],
                  chain.layer_0.v.shape[0], None, chain.activation)
    twin.load_state_dict(chain.state_dict())
    return twin


def _leaves(chain):
    return [p for _, p in chain.named_parameters()]


def _case(kind, width, dtype, chain=None, seed=0):
    """A chain and its inputs: ``(chain, inputs)``; the inputs' tensors in
    ``dtype`` (``requires_grad`` where the path gives them a gradient)."""
    g = torch.Generator().manual_seed(seed + width)
    if kind == "step0":
        cf, cg = 10, 3
        chain = chain or _chain(cf + cg, width, width, dtype, seed=seed)
        return chain, {
            "features": torch.randn(BS, SPP, cf, H, W, generator=g).half(),
            "gf": torch.randn(BS, cg, generator=g)}
    act = "leaky_relu" if kind == "regress" else "relu"
    cout = 25 if kind == "regress" else width
    chain = chain or _chain(2 * width, cout, width, dtype, act, seed=seed)
    return chain, {
        "x": torch.randn(SPP, BS, H * W, width, generator=g).to(dtype),
        "e": torch.randn(BS, H * W, width, generator=g).to(dtype)}


def _run(kind, chain, inputs, dtype, path):
    """One step (``kind``) on the pixel-major path (``path``) or through the
    plain versions; returns the outputs as the path lays them out and the
    gradients of the inputs and the chain's parameters from fixed
    cotangents."""
    mask_f, n_valid = _mask(BS, SPP, True, dtype)
    mask_f[1] = 1
    mask_f[0, 1] = 0
    n_valid = mask_f.sum(1).clamp(min=1.0)
    ins = {k: v.detach().clone().requires_grad_(k in ("x", "e"))
           for k, v in inputs.items()}
    if kind == "step0":
        gf = ins["gf"].to(dtype)
        if path:
            x = chain_train.entry(ins["features"], gf, 16, dtype)
            out = chain_train.embedding_step(chain, x, None, mask_f, n_valid)
        else:
            out = sample_chain.embedding_step_ref(
                chain, ins["features"].to(dtype), gf[:, :, None, None],
                mask_f, n_valid)
            out = (_rows(out[0]), _pixels(out[1]))
    elif kind == "step1":
        if path:
            out = chain_train.embedding_step(chain, ins["x"], ins["e"],
                                             mask_f, n_valid)
        else:
            feats = ins["x"].reshape(SPP, BS, H, W, -1).permute(1, 0, 4, 2, 3)
            extra = ins["e"].reshape(BS, H, W, -1).permute(0, 3, 1, 2)
            out = sample_chain.embedding_step_ref(chain, feats, extra,
                                                  mask_f, n_valid)
            out = (_rows(out[0]), _pixels(out[1]))
    else:
        if path:
            out = chain_train.regress(chain, ins["x"], ins["e"], (H, W))
        else:
            feats = ins["x"].reshape(SPP, BS, H, W, -1).permute(1, 0, 4, 2, 3)
            extra = ins["e"].reshape(BS, H, W, -1).permute(0, 3, 1, 2)
            out = [sample_chain.regress_ref(chain, feats[:, s], extra, None)
                   for s in range(SPP)]
    g = torch.Generator().manual_seed(11)
    loss = sum((o.float() * torch.randn(o.shape, generator=g)).sum()
               for o in out)
    wanted = [ins[k] for k in ("x", "e") if k in ins] + _leaves(chain)
    grads = torch.autograd.grad(loss, wanted)
    return [o.detach() for o in out], list(grads)


@pytest.mark.parametrize("kind", ["step0", "step1", "regress"])
@pytest.mark.parametrize("width", [8, 128])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_function_matches_the_plain_step(kind, width, dtype):
    """An embedding step (step 0 from the entry's rows, or a later step with
    the per-pixel input split out of the first product) or the regressor
    over every sample, against autograd through the plain step on the same
    weights and inputs: the outputs (the embedding and its mean, or each
    sample's logits) and the gradients of the inputs and of every ``v``,
    ``g`` and ``bias``."""
    chain, inputs = _case(kind, width, dtype)
    got_out, got_grads = _run(kind, chain, inputs, dtype, True)
    want_out, want_grads = _run(kind, chain, inputs, dtype, False)
    ref_out = ref_grads = [None] * 64
    if dtype != torch.float32:
        ref_out, ref_grads = _run(kind, _twin(chain), {
            k: v.float() if k in ("x", "e") else v
            for k, v in inputs.items()}, torch.float32, False)
    names = ([k for k in ("x", "e") if k in inputs]
             + [n for n, _ in chain.named_parameters()])
    assert len(got_grads) == len(names) == len(want_grads)
    for i, (got, want) in enumerate(zip(got_out, want_out)):
        _close(got, want, dtype, ref_out[i], "%s out %d" % (kind, i))
    for name, got, want, ref in zip(names, got_grads, want_grads,
                                    ref_grads):
        _close(got, want, dtype, ref, "%s %s" % (kind, name))


# --- Multisteps on the training path -----------------------------------------


def _multisteps(dtype, seed=0, **kw):
    torch.manual_seed(seed)
    args = dict(n_features=10, n_global_features=3, width=16,
                embedding_width=16, ksize=3, nsteps=2, conv_dtype=dtype,
                kernel_dtype=dtype)
    args.update(kw)
    model = Multisteps(**args)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.3 * torch.randn_like(p))
    return model


def _samples(seed=0, h=12, w=12):
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(BS, SPP, dtype=torch.bool)
    mask[1, 2] = False
    return {"radiance": torch.rand(BS, SPP, 3, h, w, generator=g),
            "features": torch.randn(BS, SPP, 10, h, w, generator=g).half(),
            "global_features": torch.randn(BS, 3, 1, 1, generator=g),
            "sample_mask": mask}


def _step(model, x, rule, monkeypatch):
    """Output and every parameter's gradient of one forward and backward,
    the kernels' rule answering ``rule`` (True: this path on the CPU)."""
    with monkeypatch.context() as m:
        m.setattr(layers, "kernel_path", lambda module, t: rule)
        out = model(x)["radiance"]
        g = torch.Generator().manual_seed(9)
        loss = (out * torch.randn(out.shape, generator=g)).sum()
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return out.detach(), dict(zip(names, grads))


@pytest.mark.parametrize("kw", [{}, {"remat": True}, {"pixel": True},
                                {"splat": False}, {"kernel_dtype": None}])
def test_multisteps_float32_matches_the_plain_modules(monkeypatch, kw):
    """float32 (the dataflow; the card takes this path for bf16 alone): the
    output and every gradient equal the plain modules' to float32 rounding,
    also recomputed under ``remat``, with ``pixel``, ``splat=False``."""
    model = _multisteps(None, **kw)
    x = _samples()
    got, got_g = _step(model, x, True, monkeypatch)
    want, want_g = _step(model, x, False, monkeypatch)
    _close(got, want, torch.float32, what="radiance")
    for name in want_g:
        _close(got_g[name], want_g[name], torch.float32, what=name)


#: bf16 Multisteps: the median leaf's gradient error against the float32
#: model, over the plain modules' (``leaf_dir`` of ``benchmark/compare.py``
#: with ``reduce="median"``), and the output's L2 error over theirs.
MULTISTEPS_GRAD = MULTISTEPS_OUT = ROUNDING_L2


def _leaf_dir_median(grads, ref):
    norms = {k: float(r.double().norm()) for k, r in ref.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return float(torch.tensor([
        float((grads[k].double() - r.double()).norm()) / max(norms[k], med)
        for k, r in ref.items()]).median())


@pytest.mark.parametrize("remat", [False, True])
def test_multisteps_bf16_is_as_close_to_float32(monkeypatch, remat):
    """bf16 with ``remat`` or not: the output and the gradients as close to
    the float32 model's as the plain modules', in the train cell's own
    measure (the median leaf)."""
    model = _multisteps("bfloat16", remat=remat)
    x = _samples(seed=1)
    got, got_g = _step(model, x, True, monkeypatch)
    want, want_g = _step(model, x, False, monkeypatch)
    twin = _multisteps(None)
    twin.load_state_dict(model.state_dict())
    ref, ref_g = _step(twin, x, False, monkeypatch)
    out = _rounding_ratios(got, want, ref)[0]
    grad = _leaf_dir_median(got_g, ref_g) / _leaf_dir_median(want_g, ref_g)
    assert out <= MULTISTEPS_OUT and grad <= MULTISTEPS_GRAD


def test_remat_recomputes_bit_for_bit(monkeypatch):
    """Under ``remat`` each embedding step runs again in the backward pass
    and gives the same gradients bit for bit."""
    x = _samples(seed=2)
    got = _step(_multisteps("bfloat16", remat=True), x, True, monkeypatch)
    want = _step(_multisteps("bfloat16"), x, True, monkeypatch)
    assert torch.equal(got[0], want[0])
    for name in want[1]:
        assert torch.equal(got[1][name], want[1][name]), name


def _ddp_no_sync_mismatches(store):
    """The body of :func:`test_ddp_no_sync_accumulates_as_one_process`, in
    the rank's own process: joins a gloo group of one rank through the
    ``FileStore`` at ``store``, runs two micro-steps (the first under
    ``no_sync``) through DDP and through the bare model, and returns the
    names of the parameters whose gradients differ."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel as DDP
    torch.set_num_threads(1)
    layers.kernel_path = lambda module, t: True
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    try:
        bare, wrapped = _multisteps("bfloat16"), _multisteps("bfloat16")
        ddp = DDP(wrapped)
        for seed, sync in ((3, False), (4, True)):
            x = _samples(seed=seed)
            bare(x)["radiance"].float().square().sum().backward()
            if sync:
                ddp(x)["radiance"].float().square().sum().backward()
            else:
                with ddp.no_sync():
                    ddp(x)["radiance"].float().square().sum().backward()
        return [name for (name, p), q in zip(bare.named_parameters(),
                                             wrapped.parameters())
                if not torch.equal(p.grad, q.grad)]
    finally:
        dist.destroy_process_group()


def test_ddp_no_sync_accumulates_as_one_process(tmp_path):
    """Under DistributedDataParallel (gloo, one rank on the CPU) the
    weights made outside the Functions feed DDP's gradient hooks: two
    micro-steps, the first under ``no_sync``, accumulate the same gradients
    as the bare model, bit for bit. The rank runs in a process of its own
    with one thread, as ``tests/torch_rank_worker.py``'s ranks do, so no
    process group outlives it in the test process."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tests import test_torch_chain_train as t\n"
            "print('mismatches', t._ddp_no_sync_mismatches(%r))"
            % (ROOT, str(tmp_path / "store")))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        pytest.fail("the rank did not end within 240 s")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "mismatches []"


# --- The kernel bindings on a faked card -------------------------------------


def test_entry_launch_arguments(fake_card):
    feats = torch.empty(BS, SPP, 10, H, W, dtype=torch.float16)
    gf = torch.randn(BS, 3)
    out = chain_train.entry(feats, gf, 16, BF16)
    assert out.shape == (SPP, BS, H * W, 16) and out.dtype == BF16
    [(name, fn, args)] = fake_card.launches
    assert (name, fn, len(args)) == ("chain_entry", "sbmc_chain_entry",
                                     fake_card.declared(fn))
    # x, dtype, x_bs, x_ss, cf, gf, cg, out, k, bs, spp, hw, sms
    assert args[:5] == (feats.data_ptr(), 1, SPP * 10 * H * W, 10 * H * W,
                        10)
    assert args[6:] == (3, out.data_ptr(), 16, BS, SPP, H * W, 132)


def test_epilogue_launch_arguments(fake_card):
    launches = fake_card.launches
    z = torch.empty(SPP, BS, H * W, 16)
    e = torch.empty(BS, H * W, 16)
    zb = torch.empty(SPP, BS, H * W, 16, dtype=BF16)
    mask_f, n_valid = _mask(BS, SPP, True, BF16)
    out, red = chain_train.epilogue(z, torch.zeros(16), "relu", BF16, e=e)
    out2, red2 = chain_train.epilogue(zb, torch.zeros(16), "linear", BF16,
                                      mask=mask_f, nvalid=n_valid)
    assert out.dtype == BF16 and red is None
    assert out2.data_ptr() == zb.data_ptr() and red2.shape == (BS, H * W, 16)
    (n0, f0, a0), (_, _, a1) = launches
    assert (n0, f0, len(a0)) == ("chain_epilogue", "sbmc_chain_epilogue",
                                 fake_card.declared(f0))
    # z, z_f32, e, bias, act, out, mask, nvalid, reduced, bs, spp, hw, c,
    # sms
    assert a0[:3] == (z.data_ptr(), 1, e.data_ptr())
    assert (a0[4], a0[5], a0[6], a0[8]) == (1, out.data_ptr(), None, None)
    assert a0[9:] == (BS, SPP, H * W, 16, 132)
    assert (a1[1], a1[2], a1[4], a1[8]) == (0, None, 0, red2.data_ptr())


def test_epilogue_backward_launch_arguments(fake_card):
    dy = torch.empty(SPP, BS, H * W, 16, dtype=BF16)
    dred = torch.empty(BS, H * W, 16, dtype=BF16)
    mask_f, n_valid = _mask(BS, SPP, True, BF16)
    dz, db, dsum = chain_train.epilogue_backward(dy, dy, "leaky_relu",
                                                 sum_samples=True)
    chain_train.epilogue_backward(dy, None, "linear", dred, mask_f, n_valid)
    (n0, f0, a0), (_, _, a1) = fake_card.launches
    assert (n0, f0, len(a0)) == ("chain_epilogue_backward",
                                 "sbmc_chain_epilogue_backward",
                                 fake_card.declared(f0))
    # dy, out, act, dred, mask, nvalid, dz, dsum, partials, nparts, dbias,
    # bs, spp, hw, c, sms: a row of bias sums for each of up to 8 blocks an
    # SM.
    assert a0[:4] == (dy.data_ptr(), dy.data_ptr(), 2, None)
    assert (a0[6], a0[7], a0[9], a0[10]) == (dz.data_ptr(), dsum.data_ptr(),
                                             8 * 132, db.data_ptr())
    assert a0[11:] == (BS, SPP, H * W, 16, 132)
    assert (a1[1], a1[2], a1[3], a1[7]) == (None, 0, dred.data_ptr(), None)


def test_logits_launch_arguments(fake_card):
    z = torch.empty(BS * SPP, 9, H * W, dtype=BF16)
    assert chain_train.logits(z, torch.zeros(9)) is z
    partials = torch.empty(BS * SPP, 9)
    dbias = torch.empty(9)
    g = torch.empty(BS, 9, H, W, dtype=BF16)
    dz = chain_train.logits_backward(g, z[BS:2 * BS], partials, BS, dbias)
    (n0, f0, a0), (n1, f1, a1) = fake_card.launches
    assert (n0, f0, len(a0)) == ("chain_logits", "sbmc_chain_logits",
                                 fake_card.declared(f0))
    assert (n1, f1, len(a1)) == ("chain_logits_backward",
                                 "sbmc_chain_logits_backward",
                                 fake_card.declared(f1))
    # z, bias, lim, n, k2, hw, sms: the clamp's bound in bf16
    assert (a0[0], a0[2]) + a0[3:] == (z.data_ptr(), 29952.0, BS * SPP, 9,
                                       H * W, 132)
    # g, out, dz, partials, row0, n, nparts, dbias, lim, k2, hw, sms
    assert a1 == (g.data_ptr(), z[BS].data_ptr(), dz.data_ptr(),
                  partials.data_ptr(), BS, BS, BS * SPP, dbias.data_ptr(),
                  29952.0, 9, H * W, 132)


def test_wrappers_refuse_what_the_kernels_do_not_take(fake_card):
    z = torch.empty(SPP, BS, H * W, 16, dtype=BF16)
    feats = torch.empty(BS, SPP, 10, H, W, dtype=torch.float16)
    for call, match in (
            (lambda: chain_train.epilogue(z[..., :12], torch.zeros(12),
                                          "relu", BF16), "contiguous"),
            (lambda: chain_train.epilogue(z, torch.zeros(16), "tanh", BF16),
             "activation"),
            (lambda: chain_train.epilogue(z, torch.zeros(16), "relu",
                                          torch.float32), "bf16"),
            (lambda: chain_train.epilogue(z.half(), torch.zeros(16), "relu",
                                          BF16), "bfloat16"),
            (lambda: chain_train.epilogue_backward(z, None, "relu"),
             "saved output"),
            (lambda: chain_train.epilogue_backward(z, z[:1], "relu"),
             "shape"),
            (lambda: chain_train.entry(feats.double(), None, 16, BF16),
             "float32, float16 or bf16"),
            (lambda: chain_train.entry(feats[..., :5], None, 16, BF16),
             "planes"),
            (lambda: chain_train.entry(feats, None, 8, BF16), "multiple"),
            (lambda: chain_train.entry(feats, torch.zeros(BS, 300), 312,
                                       BF16), "multiple")):
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(RuntimeError, match="no backward"):
        chain_train.epilogue(z.float().requires_grad_(), torch.zeros(16),
                             "relu", BF16, e=torch.empty(BS, H * W, 16))
    assert fake_card.launches == []


def _splat_stub(data, kernels, state, **kw):
    """A differentiable stand-in for the splat on the faked card."""
    return state._replace(sum_r=state.sum_r + kernels.float().mean(
        1, keepdim=True))


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_launches(monkeypatch, fake_card, remat):
    """A train step of a 2-step Multisteps on the faked card: the entry
    once, a per-sample epilogue for each layer with a per-pixel term or a
    mean (1 in step 0, 2 in a later step, 1 in the regressor) and the
    U-Net's for the others (2, 1, 1), the logits' once; in the backward
    each one's backward, the logits' once a sample; under ``remat`` the
    embedding steps' forward launches again in the backward pass."""
    from sbmc_tpu_torch.models import multisteps as multisteps_module
    monkeypatch.setattr(multisteps_module, "progressive_kernel_apply",
                        _splat_stub)
    model = _multisteps("bfloat16", remat=remat)
    x = {k: fake_card.on_card(v) for k, v in _samples().items()}
    out = model(x)["radiance"]
    names = [n for n, _, _ in fake_card.launches]
    forward = {"chain_entry": 1, "chain_epilogue": 4, "chain_logits": 1,
               "unet_epilogue": 4}
    assert {n: names.count(n) for n in names} == forward
    del fake_card.launches[:]
    out.float().sum().backward()
    names = [n for n, _, _ in fake_card.launches]
    want = {"chain_epilogue_backward": 4, "chain_logits_backward": SPP,
            "unet_epilogue_backward": 4}
    if remat:
        want.update(chain_epilogue=3, unet_epilogue=3)
    assert {n: names.count(n) for n in names} == want
