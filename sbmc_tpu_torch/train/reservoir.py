"""Device-resident tile reservoir (counterpart of
``sbmc_tpu/train/reservoir.py``).

A host-loader step stacks a batch of decoded tiles on the host and copies
it to the device every step. With ``--bf16`` the flagship step is short
enough that this host work decides its time. The reservoir moves the
shuffle buffer onto the device instead:

- ``capacity`` preprocessed tiles live on the device as one tensor per
  batch key (features float16, ``[capacity, spp, F, h, w]``), uploaded
  once by :meth:`DeviceReservoir.fill`.
- Each step draws ``batch_size`` distinct slots and, with a sample-count
  range, a valid sample count per item, from a ``torch.Generator`` on the
  device; gathers the batch with ``index_select``; and runs the interface's
  train step on it. No host bytes move on the step's path.
- A background thread (:class:`ReservoirFeeder`) keeps decoding tiles;
  :meth:`DeviceReservoir.refresh` overwrites one slot in place with a fresh
  one, round-robin, through one pinned staging buffer per key that is
  allocated once and reused.

Sampling is a sliding shuffle buffer (draws from the newest ``capacity``
tiles) instead of epochs, the trade tf.data's ``shuffle(buffer_size)``
makes. A randomized sample count masks the samples past ``k`` out of
``sample_mask``, which is the same as training on ``k`` samples (masked
samples contribute exactly zero).

Single device by design, as in the JAX package.
"""

import queue
import threading

import numpy as np
import torch

from sbmc_tpu_torch.utils.logging import get_logger

LOG = get_logger(__name__)

__all__ = ["DeviceReservoir", "ReservoirFeeder", "TRAIN_KEYS"]

#: The keys the SBMC and LBF train steps consume; the rest of a dataset
#: item (pixel statistics, paths, block offsets) never goes to the device.
TRAIN_KEYS = ("features", "radiance", "global_features", "target_image")


class DeviceReservoir:
    """Tiles held on the device, and the train step that samples them.

    Args:
      interface: a ``DenoiserInterface``; the buffers live on its device.
      capacity: number of tiles held.
      batch_size: tiles per training batch (at most ``capacity``).
      spp_mask_range: optional ``(lo, hi)``: each item trains on ``k ~
        U{lo..hi}`` of its samples; None trains on all of them.
      seed: seed of the generator that draws slots and sample counts.
    """

    def __init__(self, interface, capacity, batch_size, spp_mask_range=None,
                 seed=0):
        self.interface = interface
        self.device = interface.device
        self.capacity = int(capacity)
        self.batch_size = int(batch_size)
        if not 0 < self.batch_size <= self.capacity:
            raise ValueError("batch size %d must be in 1..capacity (%d)"
                             % (self.batch_size, self.capacity))
        self.spp_mask_range = spp_mask_range
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._bufs = None
        self._staging = None
        self._copied = None
        self._next_slot = 0

    @staticmethod
    def _item_arrays(item):
        out = {}
        for k in TRAIN_KEYS:
            v = np.asarray(item[k])
            if k == "features" and v.dtype == np.float32:
                v = v.astype(np.float16)
            out[k] = np.ascontiguousarray(v)
        return out

    def fill(self, items):
        """Upload the first ``capacity`` items, once."""
        if len(items) < self.capacity:
            raise ValueError(
                "need %d tiles to fill the reservoir, got %d; lower "
                "--device_reservoir" % (self.capacity, len(items)))
        arrays = [self._item_arrays(it) for it in items[:self.capacity]]
        self._bufs, self._staging = {}, {}
        for k in TRAIN_KEYS:
            shapes = {a[k].shape for a in arrays}
            if len(shapes) != 1:
                raise ValueError("reservoir items disagree in %r: shapes %s"
                                 % (k, sorted(shapes)))
            stacked = torch.from_numpy(np.stack([a[k] for a in arrays]))
            self._bufs[k] = stacked.to(self.device)
            self._staging[k] = torch.empty(
                stacked.shape[1:], dtype=stacked.dtype,
                pin_memory=self.device.type == "cuda")
        nbytes = sum(v.numel() * v.element_size()
                     for v in self._bufs.values())
        LOG.info("reservoir filled: %d tiles, %.2f GiB on %s",
                 self.capacity, nbytes / 2 ** 30, self.device)

    @property
    def buffers(self):
        """The device tensors, by key (``[capacity, ...]`` each)."""
        return self._bufs

    def refresh(self, item):
        """Overwrite the next slot (round-robin) in place with ``item``.

        The copy to the device is queued behind the steps already queued and
        does not wait for them; the host waits only before it rewrites a
        staging buffer that the previous refresh's copy may still be
        reading."""
        slot = self._next_slot
        arrays = self._item_arrays(item)
        for k, stage in self._staging.items():
            if arrays[k].shape != tuple(stage.shape):
                raise ValueError("refresh item %r has shape %s, the "
                                 "reservoir holds %s" % (
                                     k, arrays[k].shape, tuple(stage.shape)))
        if self._copied is not None:
            self._copied.synchronize()
        for k, stage in self._staging.items():
            stage.copy_(torch.from_numpy(arrays[k]))
            self._bufs[k][slot].copy_(stage, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record()
        self._next_slot = (slot + 1) % self.capacity

    def draw(self):
        """``(idx, ks)``: ``batch_size`` distinct slots, and each item's
        valid sample count (None without a sample-count range), drawn on the
        device."""
        g, dev = self.generator, self.device
        idx = torch.randperm(self.capacity, generator=g,
                             device=dev)[:self.batch_size]
        ks = None
        if self.spp_mask_range is not None:
            lo, hi = self.spp_mask_range
            ks = torch.randint(lo, hi + 1, (self.batch_size,), generator=g,
                               device=dev)
        return idx, ks

    def batch(self, idx, ks=None):
        """The batch of slots ``idx``, gathered on the device, with the
        ``sample_mask`` of sample counts ``ks`` (all samples when None)."""
        out = {k: v.index_select(0, idx) for k, v in self._bufs.items()}
        spp = out["radiance"].shape[1]
        if ks is None:
            out["sample_mask"] = torch.ones((idx.shape[0], spp),
                                            dtype=torch.bool,
                                            device=self.device)
        else:
            out["sample_mask"] = (torch.arange(spp, device=self.device)[None]
                                  < ks[:, None])
        return out

    def step_on(self, idx, ks=None):
        """One train step on the batch of :meth:`batch`; returns the
        interface's metrics."""
        return self.interface.train_step(self.batch(idx, ks))

    def train_step(self):
        """One train step on a batch drawn from the reservoir."""
        return self.step_on(*self.draw())


class ReservoirFeeder:
    """Background decode thread: iterates the dataset in shuffled epochs
    and keeps at most ``depth`` decoded tiles ready for :meth:`poll`."""

    def __init__(self, dataset, depth=2, seed=1):
        self.dataset = dataset
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._rng = np.random.RandomState(seed)
        self._error = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        try:
            self._feed()
        except BaseException as e:  # re-raised by poll() in the trainer
            self._error = e

    def _feed(self):
        n = len(self.dataset)
        while not self._stop.is_set():
            for i in self._rng.permutation(n):
                item = self.dataset[int(i)]
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return

    def poll(self):
        """A decoded tile if one is ready, else None (never blocks).
        Raises if the thread failed to decode a tile."""
        if self._error is not None:
            raise RuntimeError("the reservoir feeder failed") from self._error
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def stop(self, timeout=30.0):
        """Stop the thread and wait for it (up to ``timeout`` seconds: it
        finishes the tile it is decoding first)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout)
