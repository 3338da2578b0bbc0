"""Batching, padded collation, and a prefetching loader (counterpart of
``sbmc_tpu/data/loader.py``; pure numpy, device placement is the caller's).

The decode work (LZ4 + numpy) releases the GIL, so a thread pool prepares
batches ahead of the training step without process-spawn costs.
Variable-spp items are padded to ``max_spp`` with a ``sample_mask``, so
every batch has one shape whatever its sample counts.
"""

import queue
import threading

import numpy as np

__all__ = ["collate", "Loader"]


def collate(items, pad_spp=None, half_features=True):
    """Stack a list of item dicts into a batch dict.

    Args:
      items: list of dicts of numpy arrays / scalars.
      pad_spp: if set, pad the sample axis of "features"/"radiance" to this
        count and add a "sample_mask" [bs, pad_spp] of validity flags.
      half_features: ship the "features" stack as float16 — it is 94% of
        the batch bytes and only feeds the conv stacks (which cast to their
        compute dtype on device), so halving the host->device transfer is
        free accuracy-wise; the splat "radiance"/target paths stay float32.

    Returns:
      dict of stacked numpy arrays.
    """
    out = {}
    keys = items[0].keys()
    for k in keys:
        vals = [it[k] for it in items]
        if k in ("features", "radiance") and pad_spp is not None:
            padded, masks = [], []
            for v in vals:
                spp = v.shape[0]
                if spp > pad_spp:
                    raise ValueError(f"item spp {spp} > pad_spp {pad_spp}")
                if spp < pad_spp:
                    pad = np.zeros((pad_spp - spp,) + v.shape[1:], v.dtype)
                    v = np.concatenate([v, pad], 0)
                padded.append(v)
                m = np.zeros(pad_spp, bool)
                m[:spp] = True
                masks.append(m)
            out[k] = np.stack(padded)
            out["sample_mask"] = np.stack(masks)
        elif isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.array(vals)
        else:
            out[k] = vals  # e.g. paths
    if half_features and "features" in out \
            and out["features"].dtype == np.float32:
        out["features"] = out["features"].astype(np.float16)
    return out


class Loader:
    """Shuffling, prefetching batch loader over an indexable dataset.

    Args:
      dataset: indexable dataset returning item dicts.
      batch_size: items per batch.
      shuffle: reshuffle indices each epoch.
      pad_spp: see :func:`collate`.
      num_threads: decode worker threads.
      prefetch: max prepared batches in flight.
      drop_last: drop the trailing partial batch.
      seed: shuffle seed.
      shard_id, num_shards: this process reads items
        ``shard_id::num_shards``, the first ``len(dataset) // num_shards``
        of them, so that every shard has as many items and every process
        takes as many steps an epoch. (The JAX loader keeps the strided
        shards whole, one item longer on some when ``num_shards`` does not
        divide the count: a process whose epoch ends a batch early leaves
        the others waiting in the gradient all-reduce.)
      random_mask_spp: ``(lo, hi)``; draw a valid sample count per item and
        mask the rest (the draw uses numpy's global generator, as the JAX
        package's loader does, so ``np.random.seed`` fixes it).
    """

    def __init__(self, dataset, batch_size=1, shuffle=False, pad_spp=None,
                 num_threads=4, prefetch=4, drop_last=True, seed=0,
                 shard_id=0, num_shards=1, random_mask_spp=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_spp = pad_spp
        # (lo, hi): per item draw k ~ U{lo..hi} and mark samples >= k
        # invalid in "sample_mask". Equivalent to randomized-spp training
        # on MultiSampleCountDataset, but at a single batch shape and
        # without re-slicing the cached feature arrays: masked samples
        # contribute exactly zero.
        self.random_mask_spp = random_mask_spp
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._rng = np.random.RandomState(seed)
        # Input sharding across processes: each reads a strided subset.
        self.shard_id = shard_id
        self.num_shards = num_shards

    def _indices(self):
        n = len(self.dataset)
        return np.arange(n)[self.shard_id::self.num_shards][
            :n // self.num_shards]

    def __len__(self):
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = self._indices()
        if self.shuffle:
            self._rng.shuffle(idx)
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def __iter__(self):
        work_q = queue.Queue()
        done_q = queue.Queue(maxsize=self.prefetch)
        batches = list(self._index_batches())
        for i, b in enumerate(batches):
            work_q.put((i, b))
        n_batches = len(batches)
        stop = threading.Event()

        def worker():
            while not stop.is_set():
                try:
                    i, b = work_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    items = [self.dataset[int(j)] for j in b]
                    batch = collate(items, self.pad_spp)
                    if self.random_mask_spp is not None:
                        lo, hi = self.random_mask_spp
                        spp = batch["features"].shape[1]
                        ks = np.random.randint(lo, hi + 1,
                                               batch["features"].shape[0])
                        mask = (np.arange(spp)[None] < ks[:, None])
                        prev = batch.get("sample_mask")
                        batch["sample_mask"] = (mask if prev is None
                                                else mask & prev)
                    done_q.put((i, batch))
                except Exception as e:  # surface errors to the consumer
                    done_q.put((i, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            pending = {}
            next_i = 0
            while next_i < n_batches:
                while next_i not in pending:
                    i, payload = done_q.get()
                    pending[i] = payload
                payload = pending.pop(next_i)
                if isinstance(payload, Exception):
                    raise payload
                yield payload
                next_i += 1
        finally:
            stop.set()
