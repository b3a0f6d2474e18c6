"""Data sharding across the (local rank x replica group) grid, plus the
storage-backed stateful input pipeline (the JAX package's
``torchft_tpu/data.py`` :44-330, which is numpy only).

* :class:`DistributedSampler` — deterministic, shuffled index batches over
  the flattened ``global_rank = rank + num_replicas * replica_group`` grid,
  with ``state_dict``/``load_state_dict`` for exact resume;
* :class:`MemmapDataset` / :class:`TokenFileDataset` — memory-mapped
  ``.npy`` storage; batches are gathered straight off the page cache;
* :class:`StatefulLoader` — sampler-driven iterator with background
  prefetch; each batch carries the sampler state as of after that batch.

Batches are numpy dicts; the trainer moves them to its device. The
membership-elastic sampler and loader are not ported yet.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np


class DistributedSampler:
    """Deterministic, shuffled, 2D-sharded index batches.

    Args:
        dataset_size: number of examples.
        replica_group: this replica group's index (0-based).
        num_replica_groups: total replica groups.
        rank / num_replicas: local rank / local world size within the group.
        batch_size: per-rank batch size (the *local* batch; the effective
            global batch is ``batch_size * num_replicas * num_participants``).
        shuffle: reshuffle each epoch with a seed derived from (seed, epoch).
        drop_last: drop the trailing partial batch.
    """

    def __init__(
        self,
        dataset_size: int,
        replica_group: int,
        num_replica_groups: int,
        rank: int = 0,
        num_replicas: int = 1,
        batch_size: int = 1,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
    ) -> None:
        if not 0 <= replica_group < num_replica_groups:
            raise ValueError("replica_group out of range")
        if not 0 <= rank < num_replicas:
            raise ValueError("rank out of range")
        self.dataset_size = dataset_size
        # The flattened grid (reference data.py:68-77).
        self.global_rank = rank + num_replicas * replica_group
        self.global_world_size = num_replicas * num_replica_groups
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self._batch_idx = 0  # position within the epoch, for resume

    # ------------------------------------------------------------- epoch API

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._batch_idx = 0

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(self.dataset_size, dtype=np.int64)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        # Contiguous stride-sharding over the flattened grid.
        shard = idx[self.global_rank::self.global_world_size]
        per_rank = len(shard)
        n_batches = (per_rank // self.batch_size if self.drop_last
                     else -(-per_rank // self.batch_size))
        if self.drop_last:
            shard = shard[: n_batches * self.batch_size]
        return shard, n_batches

    def __len__(self) -> int:
        per_rank = len(
            range(self.global_rank, self.dataset_size, self.global_world_size)
        )
        return (per_rank // self.batch_size if self.drop_last
                else -(-per_rank // self.batch_size))

    def __iter__(self) -> Iterator[np.ndarray]:
        shard, n_batches = self._epoch_indices()
        for b in range(self._batch_idx, n_batches):
            self._batch_idx = b + 1
            yield shard[b * self.batch_size:(b + 1) * self.batch_size]

    # --------------------------------------------------- resume (stateful)

    def state_dict(self) -> Dict[str, int]:
        """Exact-position resume state (the StatefulDataLoader role)."""
        return {"epoch": self.epoch, "batch_idx": self._batch_idx,
                "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self._batch_idx = int(state["batch_idx"])
        self.seed = int(state["seed"])


class MemmapDataset:
    """A directory of ``.npy`` field files, memory-mapped read-only.

    ``write()`` materializes in-memory arrays once; training processes open
    the same directory with zero host-RAM cost beyond the touched pages.
    Indexing with a batch of row indices gathers those rows into fresh
    arrays (the copy is the batch, not the corpus).
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self.arrays: Dict[str, np.ndarray] = {}
        n = None
        for fn in sorted(os.listdir(path)):
            if not fn.endswith(".npy"):
                continue
            arr = np.load(os.path.join(path, fn), mmap_mode="r")
            self.arrays[fn[:-4]] = arr
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"field {fn}: {len(arr)} rows, expected {n}")
        if not self.arrays:
            raise ValueError(f"no .npy fields under {path}")
        self._n = int(n)  # type: ignore[arg-type]

    @staticmethod
    def write(path: str, arrays: Dict[str, np.ndarray]) -> "MemmapDataset":
        os.makedirs(path, exist_ok=True)
        for name, arr in arrays.items():
            np.save(os.path.join(path, f"{name}.npy"), np.asarray(arr))
        return MemmapDataset(path)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v[idx]) for k, v in self.arrays.items()}


class TokenFileDataset:
    """Fixed-length windows over a flat token file (LM pretraining shape).

    ``tokens_path`` is a 1-D integer ``.npy`` (any integer dtype; windows
    are returned as int32, the embedding-lookup dtype). Row ``i`` is the
    non-overlapping window ``tokens[i*seq_len : (i+1)*seq_len]``.
    """

    def __init__(self, tokens_path: str, seq_len: int) -> None:
        self.tokens = np.load(tokens_path, mmap_mode="r")
        if self.tokens.ndim != 1:
            raise ValueError("token file must be 1-D")
        self.seq_len = seq_len
        self._n = len(self.tokens) // seq_len

    @staticmethod
    def write(tokens_path: str, tokens: np.ndarray) -> None:
        os.makedirs(os.path.dirname(tokens_path) or ".", exist_ok=True)
        np.save(tokens_path, np.asarray(tokens))

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: np.ndarray) -> Dict[str, np.ndarray]:
        gather = (np.asarray(idx, np.int64)[:, None] * self.seq_len
                  + np.arange(self.seq_len, dtype=np.int64)[None, :])
        return {"tokens": np.asarray(self.tokens[gather], np.int32)}


class StatefulLoader:
    """Background-prefetching batch stream with exact-position resume.

    Args:
        dataset: anything with ``__len__`` and ``__getitem__(index_batch)
            -> batch`` (:class:`MemmapDataset`, :class:`TokenFileDataset`,
            or your own).
        sampler: the 2D-sharded :class:`DistributedSampler`; epochs
            auto-advance.
        prefetch: batches read ahead on a daemon thread (storage latency
            hides behind device compute). 0 disables the thread.

    ``state_dict()`` describes the position *after the last batch this
    loader yielded* — save it alongside the model at commit time and
    ``load_state_dict()`` resumes the stream from exactly there. A crash
    after the checkpoint re-consumes the since-then tail: the reference's
    lossy-rejoin semantics (torchft/data.py:33-36), made
    exact at every checkpoint boundary.
    """

    def __init__(self, dataset: Any, sampler: DistributedSampler,
                 prefetch: int = 2) -> None:
        self.dataset = dataset
        self.sampler = sampler
        self.prefetch = prefetch
        if len(sampler) == 0:
            raise ValueError(
                "sampler yields no batches (dataset shard smaller than the "
                "batch size); epochs would spin forever")
        self._last_state = sampler.state_dict()
        self._it: Optional[Iterator[np.ndarray]] = None
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- iteration

    def __iter__(self) -> "StatefulLoader":
        return self

    def _next_indices(self):
        """Next index batch, auto-advancing epochs; plus the sampler state
        capturing the position AFTER this batch. Holds ONE live iterator
        per epoch — the sampler's ``__iter__`` shuffles the whole index
        space, which must happen once per epoch, not once per batch."""
        while True:
            if self._it is None:
                self._it = iter(self.sampler)
            got = next(self._it, None)
            if got is not None:
                return got, self.sampler.state_dict()
            self.sampler.set_epoch(self.sampler.epoch + 1)
            self._it = None

    def _prefetch_loop(self) -> None:
        assert self._q is not None
        while not self._stop.is_set():
            try:
                idx, state = self._next_indices()
                item = (self.dataset[idx], state)
            except Exception as e:  # noqa: BLE001
                # Surface storage/sampler failures to the consumer — a
                # silently dead prefetcher would leave __next__ parked on
                # the queue forever.
                item = e
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def __next__(self) -> Any:
        if self.prefetch <= 0:
            idx, state = self._next_indices()
            self._last_state = state
            return self.dataset[idx]
        if self._thread is None:
            self._stop.clear()
            self._q = queue.Queue(maxsize=self.prefetch)
            self._thread = threading.Thread(
                target=self._prefetch_loop, daemon=True,
                name="stateful-loader")
            self._thread.start()
        item = self._q.get()
        if isinstance(item, Exception):
            self._thread = None  # the loop exited; allow a fresh start
            raise item
        batch, state = item
        self._last_state = state
        return batch

    # --------------------------------------------------------------- resume

    def state_dict(self) -> Dict[str, int]:
        return dict(self._last_state)

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._halt()
        self.sampler.load_state_dict(state)
        self._last_state = self.sampler.state_dict()
        self._it = None  # the live epoch iterator predates the new position

    def shutdown(self) -> None:
        self._halt()

    def _halt(self) -> None:
        """Stop the prefetcher and discard read-ahead (its batches belong
        to the superseded stream position).

        A prefetch thread that outlives its join timeout (a storage read
        wedged past 5s) is an ERROR, not a shrug: proceeding would let the
        zombie keep advancing the very sampler a load_state_dict is about
        to rewrite — and a restarted thread would then race it, silently
        corrupting the resumed position. Refuse instead; the caller can
        retry the halt once storage unwedges."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                raise RuntimeError(
                    "StatefulLoader: prefetch thread did not stop within "
                    "5s (storage read wedged?); refusing to mutate the "
                    "sampler under a live reader — retry shutdown/"
                    "load_state_dict once the read completes")
            self._thread = None
        self._q = None
