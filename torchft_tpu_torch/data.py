"""Data sharding across the (local rank x replica group) grid, plus the
storage-backed stateful input pipeline (the JAX package's
``torchft_tpu/data.py`` :44-330, which is numpy only).

* :class:`DistributedSampler` — deterministic, shuffled index batches over
  the flattened ``global_rank = rank + num_replicas * replica_group`` grid,
  with ``state_dict``/``load_state_dict`` for exact resume;
* :class:`MemmapDataset` / :class:`TokenFileDataset` — memory-mapped
  ``.npy`` storage; batches are gathered straight off the page cache;
* :class:`StatefulLoader` — sampler-driven iterator with background
  prefetch; each batch carries the sampler state as of after that batch;
* :class:`ElasticSampler` / :class:`ElasticLoader` (the JAX module's
  :332-683) — the membership-elastic stream: each participating group
  draws one slot of a single global batch stream, sized by its capacity
  and rebalance fractions, so a dead group's shard is not lost and
  resume needs no loader state; the loader prefetches the slots a commit
  predicts and places each batch on the trainer's device;
* :class:`ElasticBatchIterator` / :class:`BatchIterator` — the same two
  samplers over in-memory arrays.

Batches are numpy dicts unless a loader is given a device. Index draws
are numpy's, from ``default_rng((seed, epoch))``, so they equal the JAX
package's draws for the same seed, slots and fractions.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from torchft_tpu_torch.utils import tree_flatten, tree_unflatten


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


def _reports_samples(manager: Any, fraction: float = 1.0) -> bool:
    """True when a draw reports its sample count as the fold weight: the
    manager takes reports, and it runs degraded mode or the draw was
    taken at a fraction other than 1 (a rebalance resizes the draw with
    degraded mode off, shrunken and boosted groups alike, and the fold
    weight must follow). A test double with ``set_step_samples`` but no
    ``degraded_mode`` probe always reports."""
    if getattr(manager, "set_step_samples", None) is None:
        return False
    if abs(fraction - 1.0) > 1e-9:
        return True
    dm = getattr(manager, "degraded_mode", None)
    return dm is None or bool(dm())


class ElasticSampler:
    """Index batches that follow the quorum instead of a fixed group count.

    Each participating group draws one **slot** of a single global batch
    stream::

        slot = manager.batches_committed() + manager.participant_rank()

    ``batches_committed`` advances by ``num_participants`` exactly when a
    step commits (it is part of the manager state a healer restores), and
    the participant ranks partition ``[0, n)``, so every world size
    partitions the stream with no static setting; an aborted step redraws
    the same slots; a membership change re-partitions from the next step
    on; a healing or benched group (rank ``None``) draws a throwaway
    batch, whose gradients are zeroed anyway. The epoch's permutation
    comes from ``default_rng((seed, epoch))``, the same on every group.

    Call :meth:`next_indices` once per step AFTER ``manager.step()``,
    which advances ``batches_committed``; with
    :class:`~torchft_tpu_torch.parallel.step.FTTrainer`, pass a zero-arg
    callable (an :class:`ElasticLoader`) as the batch and the trainer
    draws at that point.
    """

    def __init__(self, dataset_size: int, manager: Any,
                 batch_size: int = 1, shuffle: bool = True,
                 seed: int = 0) -> None:
        if dataset_size < batch_size:
            raise ValueError("dataset smaller than one batch")
        self.dataset_size = dataset_size
        self.manager = manager
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.batches_per_epoch = dataset_size // batch_size
        self._perm_cache: Dict[int, np.ndarray] = {}

    def _perm(self, epoch: int) -> np.ndarray:
        perm = self._perm_cache.get(epoch)
        if perm is None:
            if self.shuffle:
                perm = np.random.default_rng(
                    (self.seed, epoch)).permutation(self.dataset_size)
            else:
                perm = np.arange(self.dataset_size)
            # This epoch and its predecessor (draws around a wrap) only.
            self._perm_cache = {e: p for e, p in self._perm_cache.items()
                                if e == epoch - 1}
            self._perm_cache[epoch] = perm
        return perm

    def _snapshot(self) -> tuple:
        """``(rank, batches_committed, fraction)`` from one atomic
        ``Manager.participant_slot`` read, which also joins the step's
        in-flight quorum. A test double may return a 2-tuple (fraction
        1.0) or lack the call (two separate reads)."""
        snap = getattr(self.manager, "participant_slot", None)
        if snap is not None:
            got = snap()
            if len(got) >= 3:
                return got[0], got[1], float(got[2])
            return got[0], got[1], 1.0
        return (self.manager.participant_rank(),
                self.manager.batches_committed(), 1.0)

    def current_slot(self) -> int:
        """This group's slot of the current step."""
        rank, committed, _frac = self._snapshot()
        return int(committed) + (rank or 0)

    def indices_for_slot(self, slot: int,
                         capacity_fraction: float = 1.0) -> np.ndarray:
        """The index batch of any slot of the stream. A fraction below 1
        (degraded or rebalance-shrunken) draws the first
        ``round(batch_size * fraction)`` indices of the slot; above 1 (a
        rebalance boost) it draws on into the next slot's prefix, so the
        fleet's sample total is kept; the draw stops at the epoch's edge
        (the permutation never wraps)."""
        epoch, pos = divmod(int(slot), self.batches_per_epoch)
        perm = self._perm(int(epoch))
        lo = pos * self.batch_size
        k = self.batch_size
        if abs(capacity_fraction - 1.0) > 1e-9:
            k = max(1, int(round(self.batch_size * capacity_fraction)))
        return perm[lo:lo + k]

    def next_indices(self) -> np.ndarray:
        """This group's index batch for the current step, sized by the
        effective fraction of the same snapshot; its size is reported to
        the manager as the fold weight whenever the weight is read."""
        rank, committed, frac = self._snapshot()
        idx = self.indices_for_slot(int(committed) + (rank or 0), frac)
        if _reports_samples(self.manager, frac):
            self.manager.set_step_samples(len(idx))
        return idx

    def epoch(self) -> int:
        return int(self.manager.batches_committed()
                   // self.batches_per_epoch)


def _tree_index(arrays: Any, idx: np.ndarray) -> Any:
    leaves, treedef = tree_flatten(arrays)
    return tree_unflatten(treedef, [a[idx] for a in leaves])


def _place(batch: Any, device: Any) -> Any:
    """Each leaf of ``batch`` as a tensor on ``device``."""
    import torch

    leaves, treedef = tree_flatten(batch)
    return tree_unflatten(treedef, [
        torch.as_tensor(np.asarray(a)).to(device) for a in leaves])


class ElasticBatchIterator:
    """Batches of in-memory arrays drawn by an :class:`ElasticSampler`,
    one draw per training step."""

    def __init__(self, arrays: Any, sampler: ElasticSampler) -> None:
        self.arrays = arrays
        self.sampler = sampler

    def __iter__(self) -> "ElasticBatchIterator":
        return self

    def __next__(self) -> Any:
        return _tree_index(self.arrays, self.sampler.next_indices())


class ElasticLoader:
    """The elastic stream over a storage dataset, with prefetch.

    Composes :class:`ElasticSampler` with a dataset (anything with
    ``__getitem__(index_batch)``) and a background thread. Pass the
    loader itself as ``FTTrainer.train_step``'s batch: it is a zero-arg
    callable, drawn after ``manager.step()``, when the step's slot is
    known.

    Prefetch predicts the next slots — a commit advances the stream by
    ``num_participants``, an abort redraws the same slot — and keeps the
    current slot's batch for the abort case; a misprediction (membership
    or fraction change) costs one synchronous read. The served slot is
    always recomputed from the live counters, and batches are keyed by
    ``(slot, fraction)``, so a stale prediction is never served. Exact
    resume is free: the stream position is
    ``manager.batches_committed()``, which rides the manager state.

    ``device``: when given, each served batch's leaves are tensors on it
    (the cache keeps the host copies).
    """

    def __init__(self, dataset: Any, sampler: ElasticSampler,
                 prefetch: int = 2, device: Any = None) -> None:
        self.dataset = dataset
        self.sampler = sampler
        self.prefetch = max(int(prefetch), 0)
        self.device = device
        # (slot, fraction) -> batch, oldest first.
        self._cache: Dict[tuple, Any] = {}
        self._cache_cap = 2 * self.prefetch + 2
        self._lock = threading.Lock()
        self._inflight: set = set()
        self._req: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.prefetch_hits = 0
        self.prefetch_misses = 0

    def _ensure_thread(self) -> None:
        if self._thread is None and self.prefetch > 0:
            # A restart after shutdown: clear the stop flag, the markers
            # the previous thread orphaned (one would suppress its slot's
            # prefetch forever) and a leftover None sentinel.
            self._stop.clear()
            with self._lock:
                self._inflight.clear()
            while True:
                try:
                    self._req.get_nowait()
                except queue.Empty:
                    break
            self._thread = threading.Thread(
                target=self._prefetch_loop, daemon=True,
                name="elastic-loader")
            self._thread.start()

    def _prefetch_loop(self) -> None:
        while True:
            key = self._req.get()
            # The stop flag before every read: shutdown must not wait
            # behind a queue of reads.
            if key is None or self._stop.is_set():
                return
            slot, frac = key
            try:
                batch = self.dataset[
                    self.sampler.indices_for_slot(slot, frac)]
            except Exception:  # noqa: BLE001 — dropped; the draw re-reads
                with self._lock:
                    self._inflight.discard(key)
                continue
            with self._lock:
                self._inflight.discard(key)
                self._store(key, batch)

    def _store(self, key: tuple, batch: Any) -> None:
        self._cache[key] = batch
        while len(self._cache) > self._cache_cap:
            self._cache.pop(next(iter(self._cache)))

    def __call__(self) -> Any:
        """The current step's batch (call after ``manager.step()``). Its
        size is reported as the fold weight whenever the weight is read
        (degraded mode, or a fraction other than 1)."""
        rank, committed, frac = self.sampler._snapshot()
        slot = int(committed) + (rank or 0)
        key = (slot, frac)
        with self._lock:
            batch = self._cache.get(key)
        if batch is None:
            self.prefetch_misses += 1
            batch = self.dataset[self.sampler.indices_for_slot(slot, frac)]
            with self._lock:
                self._store(key, batch)  # kept: an abort redraws it
        else:
            self.prefetch_hits += 1
        if _reports_samples(self.sampler.manager, frac):
            leaves = tree_flatten(batch)[0]
            if leaves:
                # Rows of the first leaf: a tuple batch's len() would be
                # its field count.
                self.sampler.manager.set_step_samples(len(leaves[0]))
        if self.prefetch > 0:
            self._ensure_thread()
            n = max(int(getattr(self.sampler.manager, "num_participants",
                                lambda: 1)() or 1), 1)
            with self._lock:
                for ahead in range(1, self.prefetch + 1):
                    k = (slot + ahead * n, frac)
                    if k not in self._cache and k not in self._inflight:
                        self._inflight.add(k)
                        self._req.put(k)
        return batch if self.device is None else _place(batch, self.device)

    def shutdown(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._req.put(None)
            self._thread.join(timeout=5)
            if self._thread.is_alive():
                # A live reader would keep touching the dataset after the
                # caller tears it down.
                raise RuntimeError(
                    "ElasticLoader: prefetch thread did not stop within "
                    "5s (storage read wedged?); retry shutdown once the "
                    "read completes")
            self._thread = None


class BatchIterator:
    """Endless batches of in-memory arrays from a
    :class:`DistributedSampler`, advancing epochs."""

    def __init__(self, arrays: Any, sampler: DistributedSampler) -> None:
        self.arrays = arrays
        self.sampler = sampler
        self._it: Optional[Iterator[np.ndarray]] = None

    def __iter__(self) -> "BatchIterator":
        return self

    def __next__(self) -> Any:
        while True:
            if self._it is None:
                self._it = iter(self.sampler)
            try:
                idx = next(self._it)
                break
            except StopIteration:
                self.sampler.set_epoch(self.sampler.epoch + 1)
                self._it = None
        return _tree_index(self.arrays, idx)
