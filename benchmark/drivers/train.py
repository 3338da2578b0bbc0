"""Traffic kind ``train``: optimisation steps one after another, the host
reading each step's metrics a step late, as the train command line does.

Traffic keys: ``batch`` tiles of ``tile x tile`` pixels at ``spp`` samples
(all of them used: no sample-count range); ``reservoir_tiles`` tiles made
from the seed and held on the card by the program's ``DeviceReservoir``,
which draws each step's batch there; ``lr``, ``loss`` and ``grad_clip`` of
the program's ``DenoiserInterface``; ``checked``, the first steps that the
reference follows; ``traced``, the steps of a traced run.

Set-up builds the one interface and reservoir that the window uses and
drives them from the seed through the checked steps, which are also the
warm-up; it keeps each step's loss, the first step's output (read by a
forward hook on the model) and clipped gradient (from Adam's first moment
after one step, ``m = (1 - b1) g``, copied to the host) and the
parameters' change after the last checked step. The comparison reruns
those steps in the float32 reference from the same weights and tiles.
"""

import gc

import torch

from benchmark import arch as arches
from benchmark import compare, weights
from benchmark.reference import train as rtrain
from benchmark.reference.names import program_name
from benchmark.reference.nn import bf16, fp8

__all__ = ["setup", "unit", "e2e", "work", "check", "VARIANTS",
           "reference_steps"]

#: The stand-ins for the program that :func:`check` can also read.
VARIANTS = ("control", "half_batch", "flipped_grad")


def setup(cell):
    from sbmc_tpu_torch.train.interface import DenoiserInterface
    from sbmc_tpu_torch.train.reservoir import DeviceReservoir

    cfg, t, dev = cell.config, cell.traffic, cell.device
    arch = arches.load(cfg["arch"])
    params = weights.make(cfg, cell.seed_of("weights"), dev)
    net = arch.program(cfg, params, dev)
    iface = DenoiserInterface(net, lr=t["lr"], loss=t["loss"],
                              grad_clip=t["grad_clip"], device=dev)
    res = DeviceReservoir(iface, t["reservoir_tiles"], t["batch"],
                          seed=cell.seed_of("draw"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.seed_of("inputs"))
    tiles = {k: v.cpu().numpy() for k, v in arch.train_tiles(
        cfg, gen, dev, t["reservoir_tiles"], t["tile"], t["tile"],
        t["spp"]).items()}
    res.fill([{k: v[i] for k, v in tiles.items()}
              for i in range(t["reservoir_tiles"])])
    named = dict(net.named_parameters())
    leaf = {k: named[program_name(k)] for k in params}
    b1 = iface.optimizer.param_groups[0]["betas"][0]
    prog = {"losses": [], "idx": []}
    images = []
    hook = net.register_forward_hook(
        lambda mod, args, out: images.append(out["radiance"].detach().float()))
    for s in range(t["checked"]):
        idx, ks = res.draw()
        metrics = res.step_on(idx, ks)
        if s == 0:
            hook.remove()
            prog["image"] = images[0]
        prog["idx"].append(idx.cpu().numpy())
        prog["losses"].append(float(metrics["loss"]))
        if s == 0:
            prog["grads"] = {k: iface.optimizer.state[p]["exp_avg"].cpu()
                             / (1 - b1) for k, p in leaf.items()}
            prog["grad"] = {k: float(g.norm())
                            for k, g in prog["grads"].items()}
    with torch.no_grad():
        prog["update"] = {k: float((p - params[k]).norm())
                          for k, p in leaf.items()}
    return _State(cell, arch, params, tiles, iface, res, prog)


class _State:
    def __init__(self, cell, arch, params, tiles, iface, res, prog):
        self.cell, self.arch, self.params = cell, arch, params
        self.tiles, self.iface, self.res, self.prog = tiles, iface, res, prog
        self.prev = None


def unit(state, i):
    metrics = state.res.train_step()
    if state.prev is not None:
        state.iface.check_finite(state.prev)
    state.prev = metrics
    return {}


def e2e(state, records, window_s):
    return {"train_step_ms": window_s * 1e3 / len(records)}


def work(state):
    """Counters of one step: the batch's forward and backward FLOPs and
    the bytes the hand-written forward kernels move."""
    t, cfg = state.cell.traffic, state.cell.config
    out = {"model_flops": state.arch.train_flops(
               cfg, t["batch"], t["tile"], t["tile"], t["spp"]),
           "flops_dtype": cfg["model"].get("conv_dtype") or "float32"}
    out.update(state.arch.kernel_bytes(cfg, [(t["tile"], t["tile"])],
                                       t["spp"], bs=t["batch"]))
    return out


def reference_steps(cfg, t, params, tiles, idxs, device, q=None, rows=None,
                    sign=1.0):
    """The reference's checked steps from ``params`` on ``tiles[idx]``
    (``rows`` keeps only the first rows of each batch; ``sign`` multiplies
    the gradients the optimizer gets): ``{"losses", "image", "grads",
    "grad", "update"}``."""
    p = {k: v.clone() for k, v in params.items()}
    opt = rtrain.Adam(p, lr=t["lr"])
    out = {"losses": []}
    for s, idx in enumerate(idxs):
        idx = idx[:rows]
        batch = {k: torch.from_numpy(v[idx]).to(device)
                 for k, v in tiles.items()}
        batch["sample_mask"] = torch.ones(len(idx), t["spp"],
                                          dtype=torch.bool, device=device)
        loss, grads, image = rtrain.step(cfg, p, opt, batch, t["grad_clip"],
                                         q, sign)
        out["losses"].append(loss)
        if s == 0:
            out["grads"] = {k: g.cpu() for k, g in grads.items()}
            out["grad"] = {k: float(g.norm()) for k, g in grads.items()}
            out["image"] = image
    out["update"] = {k: float((p[k] - params[k]).norm()) for k in p}
    return out


def check(state, variants=()):
    """Free the program, then follow its checked steps in the reference,
    in float32 and with bfloat16 rounding emulated (the unit of the
    ``.rounding`` numbers): ``{"program": numbers}``. Variants add the same
    numbers of the reference against itself computed in float8
    (``control``), on the first half of each batch (``half_batch``) or
    with its gradients' signs flipped (``flipped_grad``)."""
    prog, cfg, t = state.prog, state.cell.config, state.cell.traffic
    state.iface = state.res = state.prev = None
    gc.collect()
    if state.cell.device.type == "cuda":
        torch.cuda.empty_cache()

    def steps(**kw):
        return reference_steps(cfg, t, state.params, state.tiles,
                               prog["idx"], state.cell.device, **kw)

    ref = steps()
    unit = compare.train_numbers(steps(q=bf16), ref)
    out = {"program": compare.train_numbers(prog, ref, unit)}
    kinds = {"control": {"q": fp8}, "half_batch": {"rows": t["batch"] // 2},
             "flipped_grad": {"sign": -1.0}}
    for v in variants:
        out[v] = compare.train_numbers(steps(**kinds[v]), ref, unit)
    return out
