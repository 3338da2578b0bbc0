"""Checkpoint loading (counterpart of the load side of
``sbmc_tpu/train/checkpointer.py``).

A checkpoint directory holds ``meta.json`` (model and data parameters) and
one of: rolling training checkpoints ``ckpt_<step>.msgpack``, a tagged
``final.msgpack``, or a params-only snapshot ``params_f16.msgpack`` with its
``snapshot.json``. They are read in that order of preference. A directory
with none of them raises: inference never runs on random weights.
"""

import json
import os
import re

from sbmc_tpu_torch.params import read_msgpack

__all__ = ["Checkpointer"]

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")


class Checkpointer:
    """Reads checkpoints written by the JAX package's ``Checkpointer`` and
    by ``scripts/export_params.py``."""

    META_FILE = "meta.json"
    SNAPSHOT_FILE = "params_f16.msgpack"

    def __init__(self, root):
        self.root = root

    @staticmethod
    def load_meta(root):
        with open(os.path.join(root, Checkpointer.META_FILE)) as f:
            return json.load(f)

    def _checkpoints(self):
        if not os.path.isdir(self.root):
            return []
        found = []
        for f in os.listdir(self.root):
            m = _CKPT_RE.match(f)
            if m:
                found.append((int(m.group(1)), os.path.join(self.root, f)))
        return sorted(found)

    def find(self):
        """``(path, step, is_training_checkpoint)`` of the checkpoint to
        load, or None when the directory holds none."""
        ckpts = self._checkpoints()
        if ckpts:
            step, path = ckpts[-1]
            return path, step, True
        final = os.path.join(self.root, "final.msgpack")
        if os.path.exists(final):
            return final, "final", True
        snap = os.path.join(self.root, self.SNAPSHOT_FILE)
        if os.path.exists(snap):
            step = None
            info = os.path.join(self.root, "snapshot.json")
            if os.path.exists(info):
                with open(info) as f:
                    step = json.load(f).get("step")
            return snap, step, False
        return None

    def load_params(self):
        """Return ``(flax variables dict, step)``; raises
        ``FileNotFoundError`` when the directory holds no checkpoint."""
        found = self.find()
        if found is None:
            raise FileNotFoundError(
                "no checkpoint (ckpt_*.msgpack, final.msgpack or %s) in %s"
                % (self.SNAPSHOT_FILE, self.root))
        path, step, training = found
        tree = read_msgpack(path)
        if training:
            tree = tree["params"]  # the TrainState's params subtree
        return tree, step
