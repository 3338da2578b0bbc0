"""Training callbacks: progress reporting, checkpointing, scalar logging
and image strips (counterpart of ``sbmc_tpu/train/callbacks.py``)."""

import csv
import os
import time

import numpy as np
import torch

from sbmc_tpu_torch.parallel.mesh import barrier, is_main
from sbmc_tpu_torch.utils.image import write_png
from sbmc_tpu_torch.utils.logging import get_logger

LOG = get_logger(__name__)

__all__ = ["Callback", "ProgressCallback", "CheckpointingCallback",
           "ScalarLogCallback", "DenoisingDisplayCallback"]


class Callback:
    def training_start(self, trainer):
        pass

    def epoch_start(self, epoch):
        pass

    def batch_end(self, step, metrics):
        pass

    def epoch_end(self, epoch):
        pass

    def validation_end(self, epoch, metrics):
        pass

    def training_end(self):
        pass


class ProgressCallback(Callback):
    """Periodic stdout progress with smoothed metrics and step rate."""

    def __init__(self, interval=100):
        self.interval = interval
        # A loop may emit batch_end without ever emitting epoch_start, so
        # every field is live from __init__.
        self.epoch = 0
        self._t0 = None
        self._n0 = None
        self._smooth = {}

    def epoch_start(self, epoch):
        self.epoch = epoch
        self._t0 = time.time()
        self._n0 = None

    def batch_end(self, step, metrics):
        for k, v in metrics.items():
            v = float(v)
            self._smooth[k] = v if k not in self._smooth else \
                0.99 * self._smooth[k] + 0.01 * v
        if self._t0 is None:
            self._t0 = time.time()
        if self._n0 is None:
            self._n0 = step
        if step % self.interval == 0:
            dt = time.time() - self._t0
            # dt ~ 0 on the very first batch (when _t0 was set above).
            rate = (step - self._n0) / dt if dt > 1e-3 else float("nan")
            msg = " ".join(f"{k}={v:.5g}" for k, v in self._smooth.items())
            LOG.info("epoch %d step %d | %s | %.2f steps/s",
                     self.epoch, step, msg, rate)

    def validation_end(self, epoch, metrics):
        msg = " ".join(f"{k}={float(v):.5g}" for k, v in metrics.items())
        LOG.info("epoch %d validation | %s", epoch, msg)


class CheckpointingCallback(Callback):
    """Periodic + end-of-epoch checkpointing of an interface's state.

    Refuses to persist non-finite parameters: a diverging step can poison
    the params one step before the (lagged) NaN-loss guard fires, and a
    poisoned checkpoint would shadow the last good one.

    Data-parallel, every rank holds one: rank 0 writes, and every rank
    waits for it at a barrier, so no rank runs ahead of a checkpoint that
    a restart would resume from.
    """

    def __init__(self, checkpointer, interface, interval_steps=1000):
        self.checkpointer = checkpointer
        self.interface = interface
        self.interval_steps = interval_steps

    def _save(self, tag=None):
        iface = self.interface
        finite = all(bool(torch.isfinite(p).all())
                     for p in iface.model.parameters())
        if not finite:
            LOG.warning("refusing to checkpoint non-finite parameters at "
                        "step %s", iface.step)
            return
        if is_main():
            self.checkpointer.save(iface.state_tree(), iface.step, tag=tag)
        barrier()

    def batch_end(self, step, metrics):
        if step > 0 and step % self.interval_steps == 0:
            self._save()

    def epoch_end(self, epoch):
        self._save()

    def training_end(self):
        self._save(tag="final")


class ScalarLogCallback(Callback):
    """Appends scalar metrics to a CSV file every ``interval`` steps."""

    def __init__(self, path, interval=100):
        self.path = path
        self.interval = interval
        self._keys = None

    def batch_end(self, step, metrics):
        if step % self.interval != 0:
            return
        row = {"step": step}
        row.update({k: float(v) for k, v in metrics.items()})
        # Wall-clock stamp so committed train logs carry steady-state
        # step/s evidence (epoch seconds; consumers diff consecutive rows).
        row["wall_time"] = time.time()
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        new = not os.path.exists(self.path) \
            or os.path.getsize(self.path) == 0
        if new:
            keys = list(row.keys())
        elif self._keys is not None:
            keys = self._keys
        else:
            # Resuming an existing CSV (e.g. a warm-started checkpoint's
            # log from an older build): keep its row order, but extend the
            # header with any new columns by rewriting the file once (old
            # rows pad with ""), so new evidence columns (wall_time,
            # input_loss) are not silently dropped on warm starts.
            with open(self.path, newline="") as f:
                reader = csv.DictReader(f)
                old_keys = list(reader.fieldnames or [])
                missing = [k for k in row if k not in old_keys]
                if old_keys and missing:
                    old_rows = list(reader)
            keys = (old_keys + missing) if old_keys \
                else list(row.keys())
            if old_keys and missing:
                with open(self.path, "w", newline="") as f:
                    writer = csv.DictWriter(f, fieldnames=keys, restval="")
                    writer.writeheader()
                    writer.writerows(old_rows)
        self._keys = keys
        with open(self.path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys, restval="",
                                    extrasaction="ignore")
            if new:
                writer.writeheader()
            writer.writerow(row)


class DenoisingDisplayCallback(Callback):
    """Dumps [low-spp input | output | target | error] image strips as PNG
    files."""

    def __init__(self, interface, batch_fn, outdir, interval_epochs=1):
        self.interface = interface
        self.batch_fn = batch_fn
        self.outdir = outdir
        self.interval_epochs = interval_epochs

    @staticmethod
    def _tonemap(im):
        im = np.maximum(im, 0)
        return (im / (1 + im)) ** (1.0 / 2.2)

    def epoch_end(self, epoch):
        if epoch % self.interval_epochs != 0:
            return
        batch = self.batch_fn()
        iface = self.interface
        iface.model.eval()
        with torch.no_grad():
            out = iface.model(iface._to_device(batch))
        rad = out["radiance"].float().cpu().numpy()[0].transpose(1, 2, 0)
        tgt = np.asarray(batch["target_image"])[0].transpose(1, 2, 0)
        if "low_spp" in batch:
            low = np.asarray(batch["low_spp"])[0]
        else:
            low = np.asarray(batch["radiance"])[0].mean(axis=0)
        low = low.transpose(1, 2, 0)

        def center_crop(x, ref):
            dy = (x.shape[0] - ref.shape[0]) // 2
            dx = (x.shape[1] - ref.shape[1]) // 2
            return x[dy:dy + ref.shape[0], dx:dx + ref.shape[1]]

        tgt = center_crop(tgt, rad)
        low = center_crop(low, rad)
        diff = np.abs(rad - tgt)
        strip = np.concatenate(
            [self._tonemap(low), self._tonemap(rad), self._tonemap(tgt),
             self._tonemap(diff)], axis=0)
        os.makedirs(self.outdir, exist_ok=True)
        path = os.path.join(self.outdir, f"epoch_{epoch:04d}.png")
        write_png(path, (np.clip(strip, 0, 1) * 255).astype(np.uint8))
        LOG.info("wrote display strip %s", path)
