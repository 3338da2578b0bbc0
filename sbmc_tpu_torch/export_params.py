"""Export and import float16 parameter snapshots (counterpart of
``scripts/export_params.py``).

    python -m sbmc_tpu_torch.export_params export CKPT_DIR OUT_DIR [--tag T]
    python -m sbmc_tpu_torch.export_params import SNAPSHOT_DIR CKPT_DIR

A training checkpoint (float32 parameters and Adam's moments) of the
flagship model takes about 420 MB. ``export`` writes its parameters alone
as float16 (``params_f16.msgpack``, about 70 MB, the layout of
``weights/flagship_f16``), with the checkpoint's ``meta.json`` and a
``snapshot.json`` that records the step. ``import`` turns such a snapshot
back into a checkpoint directory: float32 parameters, fresh Adam state and
the snapshot's step, saved as ``final``, which the denoise and train entry
points of both packages read. Both sides check every leaf against the model
that the meta describes. Runs on the CPU: nothing here computes.
"""

import argparse
import json
import os
import shutil

import numpy as np

from sbmc_tpu_torch.models.build import build_model
from sbmc_tpu_torch.params import (flatten, load_jax_params, pack_msgpack,
                                   read_msgpack, unflatten)
from sbmc_tpu_torch.train.checkpointer import Checkpointer
from sbmc_tpu_torch.train.interface import DenoiserInterface

__all__ = ["export", "import_", "main", "parse_args"]

SNAP_FILE = Checkpointer.SNAPSHOT_FILE
INFO_FILE = "snapshot.json"


def _interface(meta):
    return DenoiserInterface(build_model(meta), device="cpu")


def export(src, dst, tag=None):
    """Write the float16 snapshot of checkpoint directory ``src`` (the
    ``tag`` checkpoint if given and present, else the latest numbered one)
    to ``dst``; returns its step."""
    meta = Checkpointer.load_meta(src)
    template = _interface(meta).state_tree()
    ckpt = Checkpointer(src)
    state, found = None, None
    if tag is not None:
        state, found = ckpt.load_tag(template, tag)
    if found is None:
        state, found = ckpt.load_latest(template)
    if found is None:
        raise SystemExit("no checkpoint found in %s" % src)
    step = int(np.asarray(state["step"]))
    f16 = unflatten({k: np.asarray(v).astype(np.float16)
                     for k, v in flatten(state["params"]).items()})
    os.makedirs(dst, exist_ok=True)
    blob = pack_msgpack(f16)
    with open(os.path.join(dst, SNAP_FILE), "wb") as f:
        f.write(blob)
    shutil.copy(os.path.join(src, Checkpointer.META_FILE),
                os.path.join(dst, Checkpointer.META_FILE))
    with open(os.path.join(dst, INFO_FILE), "w") as f:
        json.dump({"step": step, "dtype": "float16"}, f)
    print("exported step %d -> %s (%.1f MB)" % (step, dst, len(blob) / 1e6))
    return step


def import_(src, dst):
    """Write snapshot directory ``src`` as a checkpoint directory ``dst``
    (float32 parameters, fresh Adam state, tag ``final``); returns its
    step."""
    meta = Checkpointer.load_meta(src)
    iface = _interface(meta)
    load_jax_params(iface.model, read_msgpack(os.path.join(src, SNAP_FILE)))
    with open(os.path.join(src, INFO_FILE)) as f:
        iface.step = int(json.load(f)["step"])
    Checkpointer(dst, meta=meta).save(iface.state_tree(), iface.step,
                                      tag="final")
    print("imported snapshot (step %d) -> %s" % (iface.step, dst))
    return iface.step


def main(args):
    if args.cmd == "export":
        return export(args.src, args.dst, args.tag)
    return import_(args.src, args.dst)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("export", help="checkpoint -> float16 snapshot")
    pe.add_argument("src", help="checkpoint directory")
    pe.add_argument("dst", help="snapshot output directory")
    pe.add_argument("--tag", default=None,
                    help="prefer this tagged checkpoint (e.g. 'final'); "
                    "default: the latest numbered step checkpoint.")
    pi = sub.add_parser("import", help="float16 snapshot -> checkpoint")
    pi.add_argument("src", help="snapshot directory")
    pi.add_argument("dst", help="checkpoint directory to create")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
