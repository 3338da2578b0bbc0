"""Checkpoint save/restore with a JSON meta blob (counterpart of
``sbmc_tpu/train/checkpointer.py``).

A checkpoint directory holds ``meta.json`` (model and data parameters) and
one of: rolling training checkpoints ``ckpt_<step>.msgpack``, a tagged
``final.msgpack``, or a params-only snapshot ``params_f16.msgpack`` with its
``snapshot.json``. Inference reads them in that order of preference, and a
directory with none of them raises: inference never runs on random weights.

Training checkpoints are written in the JAX package's own format: the flax
msgpack of ``{"params": {"params": ...}, "opt_state": ..., "step"}`` (see
:mod:`sbmc_tpu_torch.params`), so a checkpoint written by either package
resumes in the other. The state handed to ``save`` and returned by
``load_latest`` is that tree, as nested dicts of numpy arrays.
"""

import json
import os
import re

import numpy as np

from sbmc_tpu_torch.params import pack_msgpack, read_msgpack

__all__ = ["Checkpointer"]

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")


class Checkpointer:
    """Saves/loads state trees under a directory, keeping the latest N.

    Args:
      root: checkpoint directory (created on first save).
      meta: optional JSON-serializable dict persisted alongside checkpoints.
      max_files: number of rolling checkpoints to keep (tagged saves are
        never deleted).
    """

    META_FILE = "meta.json"
    SNAPSHOT_FILE = "params_f16.msgpack"

    def __init__(self, root, meta=None, max_files=3):
        self.root = root
        self.max_files = max_files
        if meta is not None:
            os.makedirs(root, exist_ok=True)
            with open(os.path.join(root, self.META_FILE), "w") as f:
                json.dump(meta, f, indent=2, default=str)

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

    def save(self, state, step, tag=None):
        """Serialize ``state`` (a tree of numpy arrays) at ``step``.

        Args:
          tag: if given, also write an untracked named copy (e.g. "final").
        """
        os.makedirs(self.root, exist_ok=True)
        blob = pack_msgpack(state)
        path = os.path.join(self.root, f"ckpt_{step:09d}.msgpack")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        if tag is not None:
            with open(os.path.join(self.root, f"{tag}.msgpack"), "wb") as f:
                f.write(blob)
        ckpts = self._checkpoints()
        while len(ckpts) > self.max_files:
            _, old = ckpts.pop(0)
            os.remove(old)
        return path

    @staticmethod
    def _check_compat(target, restored, path=()):
        """Enforce exact agreement of structure and shapes between the
        target tree and a restored one."""
        if isinstance(target, dict) or isinstance(restored, dict):
            t_keys = set(target) if isinstance(target, dict) else set()
            r_keys = set(restored) if isinstance(restored, dict) else set()
            if t_keys != r_keys:
                raise ValueError(
                    "checkpoint does not match the model at %s: "
                    "missing %s, unexpected %s" %
                    ("/".join(path) or "<root>", sorted(t_keys - r_keys),
                     sorted(r_keys - t_keys)))
            for k in t_keys:
                Checkpointer._check_compat(target[k], restored[k],
                                           path + (k,))
        elif np.shape(target) != np.shape(restored):
            raise ValueError(
                "checkpoint shape mismatch at %s: model %s vs checkpoint %s"
                % ("/".join(path), np.shape(target), np.shape(restored)))

    def _load(self, target, path):
        restored = read_msgpack(path)
        self._check_compat(target, restored)
        return restored

    def load_latest(self, target):
        """Restore the newest training checkpoint.

        Args:
          target: a template tree (the state about to be replaced).

        Raises ``ValueError`` if the stored tree does not exactly match the
        target's structure and shapes.

        Returns:
          ``(state, step)`` or ``(target, None)`` if nothing to restore.
        """
        ckpts = self._checkpoints()
        if not ckpts:
            return target, None
        step, path = ckpts[-1]
        return self._load(target, path), step

    def load_tag(self, target, tag):
        path = os.path.join(self.root, f"{tag}.msgpack")
        if not os.path.exists(path):
            return target, None
        return self._load(target, path), tag

    def find(self):
        """``(path, step, is_training_checkpoint)`` of the checkpoint
        inference should load, or None when the directory holds none."""
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
            tree = tree["params"]  # the train state's params subtree
        return tree, step
