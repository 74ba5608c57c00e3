"""Fixed-shape host loader with background workers, and the copy ahead to the
card (the port's copy of ``climb_tpu/data/loader.py``'s ``DataLoader`` and
``device_prefetch``, without bucketing and host sharding).

Batches are numpy dicts of static shape; the last partial batch is
zero-padded and a ``valid`` {0,1} vector marks its real rows (``pad_batch``),
so an epoch has ``len(loader)`` steps. With ``shuffle`` the order is
``np.random.RandomState(seed + epoch)``'s permutation (``set_epoch`` before
each epoch), the JAX loader's, so the batches are the JAX loader's epoch by
epoch.

A producer thread keeps at most ``num_workers + prefetch`` batches in flight
and ``prefetch`` finished ones queued; a worker's exception reaches the
consumer instead of hanging it. Workers are threads (``worker_mode
"thread"``: libjpeg decode, the C++ resample and numpy release the GIL) or
forked processes (``"process"``, for GIL-bound Python work such as the
Python tokenizer). A forked child inherits the dataset and must stay
numpy-only: the parent may run CUDA and many threads, and only the index
lists go in and numpy batches come out. The pool comes up under a deadline,
and the loader falls back to threads if it does not. With ``pin_memory`` the
producer thread copies each batch into page-locked host memory, so that
``device_prefetch`` only enqueues copies.

``device_prefetch`` copies batches ahead to the card on a side stream, which
the compute stream waits on for each batch before it uses it.
"""

import logging
import multiprocessing
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

# State inherited by fork()ed pool workers; guarded by _FORK_LOCK while a pool
# comes up (workers fork when the Pool is made, so the global only needs to
# be stable until the constructor returns).
_FORK_STATE = None
_FORK_LOCK = threading.Lock()


def _process_worker_ping():
    return True


def _try_create_fork_pool(state, num_workers, deadline=10.0):
    """A fork Pool that answered a ping within ``deadline``, or None.

    fork() in a process that already runs other threads can wedge either side
    on a lock some thread held at fork time. Construction and the ping run on
    a disposable daemon thread; past the deadline the caller degrades to
    thread workers (a leaked wedged child is bounded damage, a silent
    epoch-long hang is not)."""
    if not _FORK_LOCK.acquire(timeout=deadline):
        return None
    result = {}

    def build():
        global _FORK_STATE
        pool = None
        try:
            _FORK_STATE = state
            pool = multiprocessing.get_context("fork").Pool(num_workers)
            pool.apply_async(_process_worker_ping).get(timeout=deadline)
            result["pool"] = pool
        except Exception:
            if pool is not None:
                threading.Thread(target=pool.terminate, daemon=True).start()

    t = threading.Thread(target=build, daemon=True)
    t.start()
    t.join(deadline * 2)
    _FORK_LOCK.release()
    return result.get("pool")


def _make_batch(dataset, collate_fn, batch_size, indices) -> dict:
    return pad_batch(collate_fn([dataset[int(i)] for i in indices]), batch_size)


def _process_worker_make_batch(indices):
    return _make_batch(*_FORK_STATE, indices)


def pad_batch(batch: dict, target_bs: int) -> dict:
    """Pad every leaf's leading dim to target_bs and add the 'valid' mask."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        n = v.shape[0]
        if n < target_bs:
            v = np.pad(v, [(0, target_bs - n)] + [(0, 0)] * (v.ndim - 1))
        out[k] = v
    out["valid"] = (np.arange(target_bs) < n).astype(np.float32)
    return out


def pin_batch(batch: dict) -> dict:
    """The batch as page-locked torch tensors (host memory the card can copy
    from asynchronously)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in batch.items()}


class DataLoader:
    """Iterates ``dataset``, ``batch_size`` examples per batch, in order or in
    the (seed + epoch)-shuffled order.

    dataset: indexable with __len__ / __getitem__ -> example dict of numpy
    collate_fn: list[example] -> batch dict (numpy)
    """

    def __init__(self, dataset, batch_size: int, collate_fn: Callable, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 4,
                 prefetch: int = 2, epoch: int = 0, worker_mode: str = "thread",
                 pin_memory: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', got {worker_mode!r}")
        if worker_mode == "process" and "fork" not in multiprocessing.get_all_start_methods():
            worker_mode = "thread"
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = epoch
        self.worker_mode = worker_mode
        self.pin_memory = pin_memory
        self.skip = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_skip(self, n_batches: int):
        """Skip the first n batches of the NEXT iteration only, at the index
        level (skipped examples are never loaded): shuffling is a function of
        (seed, epoch), so skipping the consumed prefix replays the rest of an
        epoch."""
        self.skip = int(n_batches)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> list:
        """This epoch's index lists, one per batch."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [idx[i:i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()[self.skip:]
        self.skip = 0
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop_evt = threading.Event()
        state = (self.dataset, self.collate_fn, self.batch_size)

        def producer():
            inflight, todo = deque(), iter(batches)
            mode = self.worker_mode
            if mode == "process":
                pool = _try_create_fork_pool(state, self.num_workers)
                if pool is None:
                    logger.warning("fork worker pool failed to come up (fork after "
                                   "threads?); falling back to thread workers")
                    mode = "thread"
            if mode == "process":
                submit = lambda b: pool.apply_async(_process_worker_make_batch, (b,))
                fetch = lambda f: f.get()
            else:
                pool = ThreadPoolExecutor(self.num_workers)
                submit = lambda b: pool.submit(_make_batch, *state, b)
                fetch = lambda f: f.result()

            def top_up():
                # bounded readahead: a slow consumer throttles the workers
                while len(inflight) < self.num_workers + self.prefetch:
                    try:
                        inflight.append(submit(next(todo)))
                    except StopIteration:
                        return

            err = None
            try:
                top_up()
                while inflight and not stop_evt.is_set():
                    batch = fetch(inflight.popleft())
                    q.put(pin_batch(batch) if self.pin_memory else batch)
                    top_up()
            except BaseException as e:  # a worker's failure reaches the consumer
                err = e
            finally:
                if mode == "process":
                    # terminate on a daemon thread: joining a pool whose handler
                    # threads are wedged must not hang the epoch
                    threading.Thread(target=pool.terminate, daemon=True).start()
                else:
                    pool.shutdown(wait=False, cancel_futures=True)
                # the end-of-stream sentinel (or the error) must arrive, or the
                # consumer blocks forever; a full queue only means the consumer
                # is busy, so retry until it is taken or the consumer has left
                while True:
                    try:
                        q.put(("__done__", err), timeout=1)
                        break
                    except queue.Full:
                        if stop_evt.is_set():
                            break

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, tuple) and len(item) == 2 and item[0] == "__done__":
                    if item[1] is not None:
                        raise item[1]
                    break
                yield item
        finally:
            stop_evt.set()
            while t.is_alive():  # drain so that the producer can end
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def _as_tensor(v) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def device_prefetch(batch_iter, device, size: int = 2, timings: Optional[list] = None):
    """Yield the batches of ``batch_iter`` on ``device``, ``size`` batches
    copied ahead of the consumer.

    On the card each batch is copied with ``non_blocking`` copies on a side
    stream, and an event marks the copy's end. The copy is asynchronous when
    the batch is page-locked (``DataLoader(pin_memory=True)`` pins it in the
    producer thread); from pageable memory it returns only once the source has
    been read. Before a batch is handed over, the consumer's current stream waits on
    that event, and each tensor is recorded on that stream, so the caching
    allocator does not hand its memory to the side stream while the consumer's
    work still reads it. The page-locked source stays referenced until then
    (and PyTorch's host allocator keeps a freed block until its copy ends).
    On the CPU the numpy arrays become tensors without a copy, one at a time.

    ``timings``, where given, gets one entry a batch handed over: the ms this
    call waited on ``batch_iter`` and the ms it spent enqueueing copies and
    handing over, since the previous hand-over."""
    device = torch.device(device)
    if device.type != "cuda":
        it = iter(batch_iter)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            batch = {k: _as_tensor(v).to(device) for k, v in batch.items()}
            if timings is not None:
                timings.append({"loader_wait_ms": 1e3 * (t1 - t),
                                "copy_ms": 1e3 * (time.perf_counter() - t1)})
            yield batch
    side = torch.cuda.Stream(device)
    ahead = deque()
    wait_ms = copy_ms = 0.0

    def hand_over():
        nonlocal wait_ms, copy_ms
        t = time.perf_counter()
        dev, _, event = ahead.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in dev.values():
            v.record_stream(current)
        copy_ms += 1e3 * (time.perf_counter() - t)
        if timings is not None:
            timings.append({"loader_wait_ms": wait_ms, "copy_ms": copy_ms})
        wait_ms = copy_ms = 0.0
        return dev

    it = iter(batch_iter)
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            break
        t1 = time.perf_counter()
        wait_ms += 1e3 * (t1 - t)
        host = {k: _as_tensor(v) for k, v in batch.items()}
        with torch.cuda.stream(side):
            dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(side)
        ahead.append((dev, host, event))
        copy_ms += 1e3 * (time.perf_counter() - t1)
        if len(ahead) > size:
            yield hand_over()
    while ahead:
        yield hand_over()


def collate_from_indices(dataset, indices: Sequence[int], collate_fn: Callable,
                         batch_size: Optional[int] = None) -> dict:
    """One fixed-shape batch of the examples at ``indices`` (the experience
    replay buffer's batches, reference experience_replay.py:53-67)."""
    examples = [dataset[int(i)] for i in indices]
    return pad_batch(collate_fn(examples), batch_size or len(examples))
