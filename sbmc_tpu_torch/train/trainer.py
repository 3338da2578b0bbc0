"""Generic training loop (counterpart of ``sbmc_tpu/train/trainer.py``)."""

import gc

from sbmc_tpu_torch.utils.logging import get_logger

LOG = get_logger(__name__)

__all__ = ["Trainer"]


class Trainer:
    """Drives epochs of train steps with callbacks and validation.

    The NaN/Inf loss guard and the callbacks read a step's metrics one step
    late, so fetching them overlaps the next step's work on the device
    instead of making the host wait on every step.
    """

    def __init__(self, interface, callbacks=()):
        self.interface = interface
        self.callbacks = list(callbacks)

    def _emit(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def train(self, dataloader, num_epochs=None, val_dataloader=None,
              max_steps=None):
        """Run training from the interface's current step."""
        iface = self.interface
        self._emit("training_start", self)
        epoch = 0
        prev_metrics = None
        try:
            while (num_epochs is None or epoch < num_epochs) and \
                    (max_steps is None or iface.step < max_steps):
                self._emit("epoch_start", epoch)
                for batch in dataloader:
                    metrics = iface.train_step(batch)
                    if prev_metrics is not None:
                        iface.check_finite(prev_metrics)
                        self._emit("batch_end", iface.step - 1, prev_metrics)
                    prev_metrics = metrics
                    if iface.step % 100 == 0:
                        # Long-haul hygiene: dropped host batch buffers can
                        # linger in reference cycles.
                        gc.collect()
                    if max_steps is not None and iface.step >= max_steps:
                        break
                if prev_metrics is not None:
                    iface.check_finite(prev_metrics)
                    self._emit("batch_end", iface.step, prev_metrics)
                    prev_metrics = None
                if val_dataloader is not None:
                    val = self.validate(val_dataloader)
                    self._emit("validation_end", epoch, val)
                self._emit("epoch_end", epoch)
                epoch += 1
        except KeyboardInterrupt:
            LOG.info("training interrupted")
            self._emit("training_end")
        else:
            # On hard failures (e.g. the NaN-loss guard) the end-of-training
            # hooks do not run: a final checkpoint of corrupted state would
            # shadow the last good one.
            self._emit("training_end")

    def validate(self, dataloader):
        """Running-mean validation."""
        running = {"loss": 0.0, "rmse": 0.0}
        n = 0
        for batch in dataloader:
            metrics = self.interface.eval_step(batch)
            b = batch["target_image"].shape[0]
            n += b
            for k in running:
                running[k] -= (1.0 / n) * (running[k]
                                           - b * float(metrics[k]))
        running["n"] = n
        return running
