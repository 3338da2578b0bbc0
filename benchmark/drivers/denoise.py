"""Traffic kind ``denoise``: frames denoised one after another, a closed
loop (the next frame starts when the previous one is done).

Traffic keys: ``height``, ``width`` and ``spp`` of a frame, whose tensors
are already on the card; ``tile`` and ``pad``, the uniform tiles that
set-up cuts the frame into, as the denoise command line's
``--uniform_tiles --tile_size --tile_pad`` does; ``frames``, the distinct
frames made in set-up and cycled; ``checked``, how many frames among the
first ``check_span`` are kept for the comparison (drawn from the seed among
those of one frame of the set, also drawn from the seed; that frame's last
run in the window is always kept); ``traced``, the frames of a traced run.

The window runs the program's model over each frame's tiles, as its bench
does, outputs left on the card, each frame fenced by a synchronisation.
Set-up makes the weights and frames from the seed and runs every distinct
frame once (kernel builds, cuDNN's first plans). The comparison runs the
reference over the checked frame's tiles, in float32 and with bfloat16
rounding emulated (the unit of the ``.rounding`` numbers), once the
program is freed.
"""

import gc
import random
import time
import types

import numpy as np
import torch

from benchmark import arch as arches
from benchmark import compare, weights
from benchmark.cell import sync
from benchmark.reference import tiles as rtiles
from benchmark.reference.models import forward
from benchmark.reference.nn import bf16, fp8

__all__ = ["setup", "unit", "e2e", "work", "check", "VARIANTS"]

#: The stand-ins for the program that :func:`check` can also read.
VARIANTS = ("control",)


def _tiles(arch, traffic, frame):
    """A frame's tiles: a list of input dicts, batch axis 1."""
    shared = {k: v for k, v in frame.items() if k not in arch.PIXEL_KEYS}
    cut = {k: rtiles.uniform_cut(frame[k], traffic["tile"], traffic["pad"])
           for k in arch.PIXEL_KEYS}
    n = len(next(iter(cut.values())))
    return [dict(shared, **{k: v[i:i + 1] for k, v in cut.items()})
            for i in range(n)]


def setup(cell):
    cfg, t, dev = cell.config, cell.traffic, cell.device
    arch = arches.load(cfg["arch"])
    params = weights.make(cfg, cell.seed_of("weights"), dev)
    net = arch.program(cfg, params, dev).eval()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cell.seed_of("inputs"))
    pool = []
    for _ in range(t["frames"]):
        frame = arch.frame(cfg, gen, dev, t["height"], t["width"],
                           t.get("spp"))
        pool.append(_tiles(arch, t, frame))
        del frame
    draw = random.Random(cell.seed_of("check"))
    slot = draw.randrange(len(pool))
    mine = [i for i in range(t["check_span"]) if i % len(pool) == slot]
    state = types.SimpleNamespace(
        cell=cell, arch=arch, params=params, net=net, pool=pool, kept={},
        last={}, slot=slot,
        keep=set(draw.sample(mine, min(t["checked"], len(mine)))))
    for j in range(len(pool)):
        _frame(state, j)
    return state


def _frame(state, i):
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = [state.net(x)["radiance"]
               for x in state.pool[i % len(state.pool)]]
        sync(state.cell.device)
    return {"ms": (time.perf_counter() - t0) * 1e3}, out


def unit(state, i):
    rec, out = _frame(state, i)
    if i in state.keep:
        state.kept[i] = out
    state.last[i % len(state.pool)] = (i, out)
    return rec


def e2e(state, records, window_s):
    ms = [r["ms"] for r in records]
    return {"frames_per_s": len(records) / window_s,
            "frame_ms_p95": float(np.percentile(ms, 95))}


def work(state):
    """Counters of one frame: its useful model FLOPs and the bytes the
    hand-written kernels move."""
    t, cfg = state.cell.traffic, state.cell.config
    ny, nx, tile, _, _ = rtiles.uniform_grid(t["height"], t["width"],
                                             t["tile"], t["pad"])
    out = {"model_flops": state.arch.flops(cfg, t["height"], t["width"],
                                           t.get("spp")),
           "flops_dtype": cfg["model"].get("conv_dtype") or "float32"}
    out.update(state.arch.kernel_bytes(cfg, [tile] * (ny * nx),
                                       t.get("spp")))
    return out


def _reference_frame(state, q=None):
    return [forward(state.cell.config, state.params, x, q)
            for x in state.pool[state.slot]]


def _numbers(out, ref, rounding):
    return [compare.image_numbers(o.float(), r.float(), rounding)
            for o, r in zip(out, ref, strict=True)]


def check(state, variants=()):
    """Free the program, then compare every kept frame with the
    reference's frame of the same inputs: ``{"program": numbers}``. A
    variant ``control`` adds the same numbers of the reference computed in
    float8 (:func:`benchmark.reference.nn.fp8`) against the reference.
    A window too short to reach the drawn frame of the set is judged on
    its last frame."""
    if state.slot not in state.last:
        state.slot = max(state.last, key=lambda j: state.last[j][0])
    kept = dict(state.kept)
    kept[state.last[state.slot][0]] = state.last[state.slot][1]
    state.net = state.kept = state.last = None
    state.pool = [p if j == state.slot else None
                  for j, p in enumerate(state.pool)]
    gc.collect()
    if state.cell.device.type == "cuda":
        torch.cuda.empty_cache()
    with torch.no_grad():
        ref = _reference_frame(state)
        emu = _reference_frame(state, q=bf16)
        unit = compare.merge_numbers(_numbers(emu, ref, None))["rel_l2"]
        del emu
        out = {"program": compare.merge_numbers(
            [n for o in kept.values() for n in _numbers(o, ref, unit)])}
        if "control" in variants:
            ctl = _reference_frame(state, q=fp8)
            out["control"] = compare.merge_numbers(_numbers(ctl, ref, unit))
    out["program"]["rounding"] = unit
    return out
