"""Batch assembly + background prefetch (port of
``dal3d_tpu/data/loader.py``).

Replaces det3d/datasets/loader/build_loader.py:23 + torchie collate_kitti
(parallel/collate.py:90): examples are already fixed-shape dicts
(ReformatFixedShape), so collation is a plain stack of numpy arrays (or of
tensors, for bf16 voxel features); background threads overlap host data prep
(IO, host voxelization) with device steps, and batches come out in the same
order at any worker count.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch


def collate(examples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack fixed-shape examples into a batch dict."""
    out: Dict[str, Any] = {}
    first = examples[0]
    for k, v in first.items():
        if k == "metadata":
            out[k] = [e[k] for e in examples]
        elif isinstance(v, list):  # per-task lists
            out[k] = [np.stack([e[k][t] for e in examples]) for t in range(len(v))]
        elif isinstance(v, np.ndarray):
            out[k] = np.stack([e[k] for e in examples])
        elif isinstance(v, torch.Tensor):
            out[k] = torch.stack([e[k] for e in examples])
        else:
            out[k] = [e[k] for e in examples]
    return out


class DataLoader:
    """Shuffling, epoch-based loader with optional thread prefetch.

    Drops the last partial batch in train mode (fixed shapes); in test mode
    the final batch is padded by repeating the last example and marked with
    ``batch_valid``.

    Rank ``rank`` of a world of ``world`` ranks (``parallel``): every rank
    draws the same permutation and builds the same global batches of
    ``batch_size`` frames (padded as above), then loads only its rows of
    each, ``batch_size // world`` frames; the ranks' rows in rank order are
    the global batch. ``batch_size`` must divide by ``world``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        prefetch: int = 2,
        seed: Optional[int] = None,
        num_workers: int = 1,
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"a global batch of {batch_size} frames does not split over "
                             f"{world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        # >1 worker threads overlap per-batch host prep (IO, host
        # voxelization) the way the reference's 4 loader subprocesses per
        # GPU did (torchie/apis/train.py:259-264); batches
        # are re-ordered so iteration order is identical at any worker count
        self.num_workers = max(1, int(num_workers))
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        batches = []
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i : i + self.batch_size]
            if len(chunk) < self.batch_size:
                if self.drop_last:
                    break
                chunk = np.concatenate([chunk, np.full(self.batch_size - len(chunk), idx[-1])])
            batches.append(chunk)
        if self.world > 1:
            b = self.batch_size // self.world
            batches = [chunk[self.rank * b:(self.rank + 1) * b] for chunk in batches]
        return batches

    def _produce(self, batches, q: queue.Queue):
        try:
            for chunk in batches:
                examples = [self.dataset[int(i)] for i in chunk]
                examples = [e[0] if isinstance(e, tuple) else e for e in examples]
                q.put(collate(examples))
        except Exception as e:  # surface worker errors
            q.put(e)
        q.put(None)

    def _produce_pool(self, batches, q: queue.Queue, n_workers: int,
                      window: threading.Semaphore):
        """N worker threads over a shared work queue; results carry their
        sequence number so the consumer can restore iteration order. The
        window semaphore (released by the consumer per yield) bounds how far
        workers run ahead, capping the reorder buffer's memory."""
        work: queue.Queue = queue.Queue()
        for item in enumerate(batches):
            work.put(item)

        def worker():
            while True:
                window.acquire()
                try:
                    seq, chunk = work.get_nowait()
                except queue.Empty:
                    window.release()
                    q.put((None, None))  # worker drained
                    return
                try:
                    examples = [self.dataset[int(i)] for i in chunk]
                    examples = [e[0] if isinstance(e, tuple) else e for e in examples]
                    q.put((seq, collate(examples)))
                except Exception as e:  # surface worker errors
                    q.put((seq, e))
                    return

        for _ in range(n_workers):
            threading.Thread(target=worker, daemon=True).start()

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._index_batches()
        if self.prefetch <= 0:
            for chunk in batches:
                examples = [self.dataset[int(i)] for i in chunk]
                examples = [e[0] if isinstance(e, tuple) else e for e in examples]
                yield collate(examples)
            return
        if self.num_workers <= 1:
            q: queue.Queue = queue.Queue(maxsize=self.prefetch)
            t = threading.Thread(target=self._produce, args=(batches, q), daemon=True)
            t.start()
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
            return
        # multi-worker: bounded queue (workers block when the consumer lags),
        # reorder buffer keyed by sequence number keeps the yield order
        # identical to the single-worker path
        n_workers = min(self.num_workers, max(len(batches), 1))
        n_ahead = n_workers + max(self.prefetch, 1)
        q = queue.Queue()
        window = threading.Semaphore(n_ahead)
        self._produce_pool(batches, q, n_workers, window)
        pending: Dict[int, Any] = {}
        next_seq, done_workers = 0, 0
        while next_seq < len(batches):
            if next_seq in pending:
                item = pending.pop(next_seq)
                if isinstance(item, Exception):
                    raise item
                yield item
                window.release()
                next_seq += 1
                continue
            seq, item = q.get()
            if seq is None:
                done_workers += 1
                if done_workers >= n_workers and next_seq not in pending:
                    raise RuntimeError("loader workers exited before finishing")
                continue
            pending[seq] = item
