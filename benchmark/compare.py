"""The numbers that decide ``correct``, and the judgement against the
cell's limits (``benchmark/limits/<workload>.json``).

Denoised images (the program's output against the reference's, over the
same pixels):

- ``rel_l2``: ``||out - ref|| / ||ref||`` over the whole output;
- ``worst_block``: the largest root-mean-square difference in a block of
  ``BLOCK x BLOCK`` pixels (all channels), over the reference's root mean
  square; it sees a small region gone wrong that ``rel_l2`` averages
  away;
- ``rel_l2.rounding`` and ``worst_block.rounding``: the same, in units of
  the ``rel_l2`` by which the configuration's own rounding (bfloat16,
  emulated in the reference) moves this seed's answer. Random weights
  differ from seed to seed in how much any rounding moves their output
  (sixfold over six seeds), and the program and the float8 control move
  with them; these two numbers are steady from seed to seed.

Training (the program's first steps against the reference's from the same
weights and batches); leaf norms are compared as gaps, ``| |prog| - |ref|
| / max(|ref|, median leaf |ref|)``, of the worst leaf, or of the median
leaf where the name ends in ``.median``:

- ``loss_gap.1`` and ``loss_gap``: the relative gap of the first step's
  loss, and the largest of the checked steps';
- ``grad_gap``: the first step's clipped gradient, as the optimizer got it;
- ``grad_dir``: the same gradient compared element by element, ``||g_prog
  - g_ref|| / max(|g_ref|, median leaf |g_ref|)`` a leaf: a norm misses a
  gradient that points the wrong way, and Adam's first steps move every
  element by about lr whatever its gradient's size, so the parameters'
  change misses it too;
- ``update_gap``: the parameters' change after the checked steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (the others move by round-off alone under Adam);
- ``out_l2``: ``rel_l2`` of the first step's output, the denoised batch;
- ``.rounding``: ``out_l2`` and the gradient numbers in units of the same
  numbers of the reference with bfloat16 rounding emulated (forward and
  backward) from the same seed.

A number that is not finite reads ``FAR`` (1e300), beyond any limit.
"""

import json
import math
import os

import torch
import torch.nn.functional as F

__all__ = ["BLOCK", "image_numbers", "merge_numbers", "leaf_gap",
           "leaf_dir", "train_numbers", "load_limits", "judge"]

BLOCK = 32
FAR = 1e300
LIMITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits")


def _finite(x):
    x = float(x)
    return x if math.isfinite(x) else FAR


def image_numbers(out, ref, rounding=None):
    """The image numbers of ``out`` against ``ref`` (tensors of one shape,
    ``[..., h, w]``); with ``rounding``, the ``rel_l2`` of the emulated
    rounding of the same seed, also the ``.rounding`` numbers."""
    out, ref = out.double(), ref.double()
    d2 = (out - ref) ** 2
    scale = ref.pow(2).mean().sqrt()
    h, w = d2.shape[-2:]
    blocks = F.avg_pool2d(d2.reshape(-1, 1, h, w), BLOCK, ceil_mode=True)
    blocks = blocks.reshape(-1, *blocks.shape[-2:]).mean(0)
    nums = {"rel_l2": _finite(d2.sum().sqrt() / ref.pow(2).sum().sqrt()),
            "worst_block": _finite(blocks.amax().sqrt() / scale)}
    if rounding is not None:
        for k in ("rel_l2", "worst_block"):
            nums[k + ".rounding"] = _finite(nums[k] / rounding)
    return nums


def merge_numbers(readings):
    """The worst of each number over several readings."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def leaf_gap(prog, ref, keep=None, reduce="max"):
    """``| |p| - |r| | / max(|r|, median |r|)`` of the worst leaf, or of
    the median leaf with ``reduce="median"`` (``{name: norm}`` each;
    ``keep`` limits the names)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(torch.tensor([ref[k] for k in names]).median())
    gaps = torch.tensor([abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                         for k in names], dtype=torch.float64)
    return _finite(gaps.max() if reduce == "max" else gaps.median())


def leaf_dir(prog, ref, reduce="max"):
    """``||p - r|| / max(|r|, median |r|)`` of the worst leaf, or of the
    median leaf with ``reduce="median"`` (``{name: tensor}`` each)."""
    norms = {k: float(r.double().norm()) for k, r in ref.items()}
    med = float(torch.tensor(list(norms.values())).median())
    gaps = torch.tensor([float((prog[k].double() - r.double()).norm())
                         / max(norms[k], med, 1e-30)
                         for k, r in ref.items()], dtype=torch.float64)
    return _finite(gaps.max() if reduce == "max" else gaps.median())


def train_numbers(prog, ref, rounding=None):
    """Numbers of a training cell; ``prog`` and ``ref`` each hold
    ``losses`` (a list), ``grads`` (``{leaf: tensor}``), ``grad`` and
    ``update`` (``{leaf: norm}``). With
    ``rounding`` (the numbers of the reference with the configuration's
    rounding emulated), also the ``.rounding`` numbers in its units."""
    med = float(torch.tensor(list(ref["grad"].values())).median())
    moved = {k for k, v in ref["grad"].items() if v >= 1e-3 * med}
    gaps = [abs(p - r) / abs(r) for p, r in zip(
        prog["losses"], ref["losses"], strict=True)]
    nums = {"loss_gap.1": _finite(gaps[0]),
            "loss_gap": _finite(max(gaps)),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"]),
            "grad_gap.median": leaf_gap(prog["grad"], ref["grad"],
                                        reduce="median"),
            "grad_dir": leaf_dir(prog["grads"], ref["grads"]),
            "grad_dir.median": leaf_dir(prog["grads"], ref["grads"],
                                        "median"),
            "update_gap": leaf_gap(prog["update"], ref["update"], moved),
            "update_gap.median": leaf_gap(prog["update"], ref["update"],
                                          moved, reduce="median")}
    a, b = prog["image"].double(), ref["image"].double()
    if a.shape == b.shape:
        nums["out_l2"] = _finite((a - b).norm() / b.norm())
    else:  # a batch cut short answers for fewer tiles
        nums["out_l2"] = FAR
    if rounding is not None:
        for k in ("out_l2", "grad_gap", "grad_gap.median", "grad_dir",
                  "grad_dir.median"):
            nums[k + ".rounding"] = _finite(nums[k] / rounding[k])
    return nums


def load_limits(workload):
    with open(os.path.join(LIMITS, workload + ".json")) as f:
        return json.load(f)["limits"]


def judge(numbers, limits):
    """``(correct, check)``: correct when every number that has a limit is
    within it (a limit without its number fails); the check maps each
    name to its number and limit (None: read, not compared)."""
    check = {k: {"value": numbers.get(k), "limit": limits.get(k)}
             for k in sorted(set(numbers) | set(limits))}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in check.values() if c["limit"] is not None)
    return ok, check
