"""Checkpointable epoch batch iterators with background prefetch.

The port's own copy of ``espresso_tpu/data/iterators.py``: fairseq/data/
iterators.py semantics (CountingIterator:28, EpochBatchIterator:264 incl.
state_dict resume :441, GroupedIterator:573 for update_freq,
ShardedIterator:623, BufferedIterator:691) as a small thread-based pipeline,
with ordered parallel collation in spawn processes or threads. Batches stay
numpy on the host; ``cli/train.py::put_batch`` copies them to the card.
"""

from __future__ import annotations

import logging
import pickle
import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class CountingIterator:
    """Iterator wrapper counting elements consumed (fairseq iterators.py:28)."""

    def __init__(self, iterable: Iterable, start: int = 0, total: Optional[int] = None):
        self._itr = iter(iterable)
        self.n = start
        self.total = total if total is not None else start + _maybe_len(iterable)

    def __len__(self) -> int:
        return self.total

    def __iter__(self):
        return self

    def __next__(self):
        if self.n >= self.total:
            raise StopIteration
        try:
            x = next(self._itr)
        except StopIteration:
            raise IndexError(
                f"iterator expected {self.total} items but ran out at {self.n}"
            )
        self.n += 1
        return x

    def has_next(self) -> bool:
        return self.n < self.total

    def skip(self, n: int) -> "CountingIterator":
        for _ in range(n):
            next(self)
        return self


def _maybe_len(x) -> int:
    try:
        return len(x)
    except TypeError:
        return 0


class GroupedIterator(CountingIterator):
    """Yields lists of ``chunk_size`` elements (update_freq microbatching)."""

    def __init__(self, iterable, chunk_size: int, skip_remainder_batch: bool = False):
        self.chunk_size = chunk_size
        inner_len = _maybe_len(iterable)
        if skip_remainder_batch:
            total = inner_len // chunk_size
        else:
            total = -(-inner_len // chunk_size)
        self._inner = iter(iterable)
        self.n = 0
        self.total = total
        self.skip_remainder_batch = skip_remainder_batch

    def __next__(self):
        if self.n >= self.total:
            raise StopIteration
        chunk = []
        for _ in range(self.chunk_size):
            try:
                chunk.append(next(self._inner))
            except StopIteration:
                break
        if not chunk:
            raise StopIteration
        self.n += 1
        return chunk


class BufferedIterator:
    """Background-thread prefetch (fairseq iterators.py:691, data_buffer_size)."""

    _SENTINEL = object()

    def __init__(self, iterable, buffer_size: int = 4):
        self._len = _maybe_len(iterable)
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._exc: Optional[BaseException] = None

        def worker():
            try:
                for item in iterable:
                    self._queue.put(item)
            except BaseException as e:  # propagate into consumer
                self._exc = e
            finally:
                self._queue.put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __len__(self):
        return self._len

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item


# -- parallel collate workers -------------------------------------------------
# Multi-worker batch materialization (reference fairseq uses torch DataLoader
# worker processes, fairseq/data/iterators.py:481-532; espresso's stochastic
# transforms stay deterministic because every transform keys its RNG on
# (transforms_seed, epoch, utt_index) — feat_text_dataset.py:151-153 — so a
# batch's contents are a pure function of (batch_spec, epoch) regardless of
# which worker materializes it or in what order workers finish).

_WORKER_COLLATE: Optional[Callable[[Any, int], Any]] = None


def _proc_worker_init(payload: bytes) -> None:
    # workers collate numpy on the host and never touch the card
    global _WORKER_COLLATE
    _WORKER_COLLATE = pickle.loads(payload)


def _proc_worker_run(spec: Any, epoch: int) -> Any:
    assert _WORKER_COLLATE is not None
    return _WORKER_COLLATE(spec, epoch)


def parallel_collate_iter(
    collate: Callable[[Any, int], Any],
    specs: Sequence[Any],
    epoch: int,
    num_workers: int,
    backend: str = "process",
    window: Optional[int] = None,
) -> Iterator[Any]:
    """Ordered parallel map of ``collate`` over ``specs``.

    Yields batches in spec order with at most ``window`` collations in
    flight. ``backend='process'`` runs spawn-based worker processes (each
    gets one pickled copy of the collate closure — the GIL never serializes
    feature loading); ``backend='thread'`` shares the dataset in-process
    (ark reads + numpy release the GIL for most of the work). Falls back to
    threads if the collate closure is not picklable.
    """
    from concurrent.futures import Executor, ProcessPoolExecutor, ThreadPoolExecutor

    window = window if window is not None else 2 * num_workers
    pool: Executor
    if backend == "process":
        try:
            payload = pickle.dumps(collate)
            if len(payload) > 1 << 30:
                # e.g. an mmap-backed dataset would materialize in the pickle
                raise ValueError(f"collate closure pickles to {len(payload)} B")
            pool = ProcessPoolExecutor(
                max_workers=num_workers,
                mp_context=__import__("multiprocessing").get_context("spawn"),
                initializer=_proc_worker_init,
                initargs=(payload,),
            )
            fn: Callable[[Any, int], Any] = _proc_worker_run
        except Exception as e:  # unpicklable dataset/tokenizer etc.
            logger.warning(
                "process workers unavailable (%s); falling back to threads", e
            )
            backend = "thread"
    if backend != "process":
        pool = ThreadPoolExecutor(max_workers=num_workers)
        fn = collate

    def gen() -> Iterator[Any]:
        try:
            pending: "queue.deque[Any]" = __import__("collections").deque()
            it = iter(specs)
            exhausted = False
            while True:
                while not exhausted and len(pending) < window:
                    try:
                        spec = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(fn, spec, epoch))
                if not pending:
                    break
                yield pending.popleft().result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    return gen()


class EpochBatchIterator:
    """Epoch-aware, shardable, checkpointable batch iterator.

    Parameters
    ----------
    make_batches:
        ``fn(epoch: int) -> List[batch_spec]`` — (re)computes the batch list
        for an epoch (bucketed fixed-shape specs from batching.bucket_batches).
        Recomputed per epoch so shuffling/transform seeds follow the epoch
        (reference iterators.py:264 + espresso per-epoch seeding).
    collate:
        ``fn(batch_spec, epoch: int) -> pytree`` — materializes one batch.
    """

    def __init__(
        self,
        make_batches: Callable[[int], List[Any]],
        collate: Callable[[Any, int], Any],
        seed: int = 1,
        num_shards: int = 1,
        shard_id: int = 0,
        buffer_size: int = 4,
        shuffle: bool = True,
        epoch: int = 1,
        num_workers: int = 0,
        worker_backend: str = "process",
    ):
        self.make_batches = make_batches
        self.collate = collate
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.buffer_size = buffer_size
        self.num_workers = num_workers
        self.worker_backend = worker_backend
        self.shuffle = shuffle
        self.epoch = max(epoch, 1)
        self._cur_iterator: Optional[CountingIterator] = None
        self._iterations_consumed_on_load = 0
        self._started = False

    # -- epoch control ------------------------------------------------------
    @property
    def next_epoch_idx(self) -> int:
        if self._iterations_consumed_on_load > 0:
            return self.epoch  # mid-epoch resume stays on the loaded epoch
        if self._cur_iterator is not None and not self._cur_iterator.has_next():
            return self.epoch + 1
        if self._cur_iterator is None and self._started:
            return self.epoch + 1
        return self.epoch

    def next_epoch_itr(self, shuffle: Optional[bool] = None) -> CountingIterator:
        self.epoch = self.next_epoch_idx
        self._started = True
        if shuffle is not None:
            self.shuffle = shuffle
        batches = self._sharded_batches(self.epoch)
        skip = self._iterations_consumed_on_load
        self._iterations_consumed_on_load = 0
        epoch = self.epoch

        total = len(batches)
        if self.num_workers > 0:
            inner: Iterable = parallel_collate_iter(
                self.collate,
                batches[skip:],
                epoch,
                num_workers=self.num_workers,
                backend=self.worker_backend,
                window=max(2 * self.num_workers, self.buffer_size),
            )
        else:

            def gen() -> Iterator[Any]:
                for i, spec in enumerate(batches):
                    if i < skip:
                        continue
                    yield self.collate(spec, epoch)

            inner = gen()
        if self.buffer_size > 0:
            inner = BufferedIterator(inner, self.buffer_size)
        self._cur_iterator = CountingIterator(inner, start=skip, total=total)
        return self._cur_iterator

    def _sharded_batches(self, epoch: int) -> List[Any]:
        batches = self.make_batches(epoch)
        if self.shuffle:
            rng = np.random.default_rng([self.seed, epoch])
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        # shard across hosts, padding so every shard sees the same count
        n = len(batches)
        per = -(-n // self.num_shards)
        sharded = [
            batches[(i * self.num_shards + self.shard_id) % n]
            for i in range(per)
        ]
        return sharded

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        if self._cur_iterator is not None and self._cur_iterator.has_next():
            return {
                "epoch": self.epoch,
                "iterations_in_epoch": self._cur_iterator.n,
                "shuffle": self.shuffle,
            }
        return {
            "epoch": self.next_epoch_idx,
            "iterations_in_epoch": 0,
            "shuffle": self.shuffle,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore position: next_epoch_itr() resumes the saved epoch, skipping
        the already-consumed batches (reference iterators.py:441 semantics)."""
        self.epoch = int(state.get("epoch", 1))
        self.shuffle = bool(state.get("shuffle", True))
        self._iterations_consumed_on_load = int(state.get("iterations_in_epoch", 0))
        self._cur_iterator = None
        self._started = False

    @property
    def iterations_in_epoch(self) -> int:
        return self._cur_iterator.n if self._cur_iterator is not None else 0
