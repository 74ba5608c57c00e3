"""Fixed-shape host loader with background workers, and the copy ahead to the
card (the port's copy of ``climb_tpu/data/loader.py``'s ``DataLoader`` and
``device_prefetch``, with its aspect and text buckets, without host sharding).

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

With ``bucket_widths`` (``--aspect_buckets``) and ``text_bucket_lens``
(``--text_buckets``) each batch holds only examples whose needed canvas width
and real token count fit one bucket (the cross product of both), and its
canvas and text arrays are cropped to that bucket: 4:3 photos stop paying for
the 640-pixel canvas and short questions for the 40-token pad. The walk that
forms the batches is the JAX loader's (``climb_tpu/data/loader.py:283-396``):
the same shuffle, a batch emitted where its bucket fills, the partial
buckets last in sorted key order, so the batches are JAX's bit for bit and
``set_skip`` replays an epoch's suffix.

``device_prefetch`` copies batches ahead to the card on a side stream, which
the compute stream waits on for each batch before it uses it.
"""

import logging
import multiprocessing
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from climb_tpu_torch.utils.tracing import span

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


def _make_batch(dataset, collate_fn, batch_size, task) -> dict:
    indices, bucket_w, text_len = task[:3]
    examples = [dataset[int(i)] for i in indices]
    examples = crop_examples_to_bucket(examples, bucket_w)
    examples = crop_examples_to_text_len(examples, text_len)
    batch = pad_batch(collate_fn(examples), batch_size)
    if len(task) > 3:  # a data rank's share that holds only padding
        batch["valid"][:] = 0
    return batch


def _process_worker_make_batch(task):
    return _make_batch(*_FORK_STATE, task)


def crop_examples_to_bucket(examples, bucket_w, patch_size: int = 32):
    """Each example's pixel canvas cropped to ``bucket_w`` columns.

    The canvas is anchored top-left, so the columns past every example's
    valid patch width are padding, masked out of attention: dropping them
    loses nothing. If an example needs more width than its bucket (a corrupt
    image replaced by a full black canvas, say), the crop widens to the
    width it needs instead of cutting valid pixels."""
    if bucket_w is None:
        return examples
    needed = max(int(np.max(np.asarray(ex["patch_hw"])[..., 1])) * patch_size
                 for ex in examples)
    w = max(bucket_w, needed)
    out = []
    for ex in examples:
        pv = np.asarray(ex["pixel_values"])
        if pv.shape[-2] > w:
            ex = dict(ex, pixel_values=np.ascontiguousarray(pv[..., :w, :]))
        out.append(ex)
    return out


TEXT_KEYS = ("input_ids", "text_mask", "token_type_ids")


def crop_examples_to_text_len(examples, text_len):
    """Each example's text arrays cut to ``text_len`` tokens (the last axis).

    Text is right-padded and the padding is masked out of attention, so the
    cut loses nothing (the model slices its position table by the length it
    is given). If an example holds more real tokens than its bucket, the cut
    widens to that count rounded up to a multiple of 8 instead of cutting
    live tokens."""
    if text_len is None:
        return examples
    needed = max(int(np.asarray(ex["text_mask"]).sum(axis=-1).max()) for ex in examples)
    needed = -(-needed // 8) * 8
    full = int(np.asarray(examples[0]["input_ids"]).shape[-1])
    length = min(max(text_len, needed), full)
    if length == full:
        return examples
    out = []
    for ex in examples:
        ex = dict(ex)
        for k in TEXT_KEYS:
            if k in ex:
                ex[k] = np.ascontiguousarray(np.asarray(ex[k])[..., :length])
        out.append(ex)
    return out


def parse_text_buckets(value, max_text_len: int = 40):
    """A ``--text_buckets`` value (None, 'auto', 'l1,l2,...' or a sequence of
    ints) as an ascending tuple of token lengths capped at ``max_text_len``
    and holding it, or None. 'auto' is {16, 24, max_text_len}."""
    if value is None:
        return None
    if isinstance(value, str):
        if value.strip() == "auto":
            return tuple(sorted({n for n in (16, 24) if n < max_text_len} | {max_text_len}))
        lens = tuple(int(n) for n in value.split(",") if n.strip())
    else:
        lens = tuple(int(n) for n in value)
    if not lens:
        return None
    return tuple(sorted({min(n, max_text_len) for n in lens} | {max_text_len}))


def parse_bucket_widths(value, canvas_width: int = 640, patch_size: int = 32):
    """An ``--aspect_buckets`` value (None, 'auto', 'w1,w2,...' or a sequence
    of ints) as a tuple of widths, or None. 'auto' is half, three quarters
    and all of the canvas width, patch-aligned."""
    if value is None:
        return None
    if isinstance(value, str):
        if value.strip() == "auto":
            p = patch_size
            return tuple(sorted({max(p, canvas_width // 2 // p * p),
                                 max(p, 3 * canvas_width // 4 // p * p), canvas_width}))
        return tuple(int(w) for w in value.split(",") if w.strip()) or None
    return tuple(int(w) for w in value) or None


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
                 pin_memory: bool = False, bucket_widths: Optional[Sequence[int]] = None,
                 text_bucket_lens: Optional[Sequence[int]] = None, host_id: int = 0,
                 host_count: int = 1, shard: Tuple[int, int] = (0, 1)):
        """host_id/host_count: each node iterates a disjoint stripe
        (``idx[host_id::host_count]``) of the (seed + epoch)-shuffled index
        stream, as a JAX process does (``climb_tpu/data/loader.py:216-270``):
        a JAX process drives one node's chips, so the port stripes by node.
        shard = (i, n): this rank yields rows [i*B/n, (i+1)*B/n) of every
        node batch of B rows (its data rank's share; the rest of the batch
        is never loaded), so ranks with the same data coordinate get the same
        rows and one node's ranks together train on the node's batch."""
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
        self.host_id, self.host_count = int(host_id or 0), max(1, int(host_count or 1))
        self.shard = (int(shard[0]), int(shard[1]))
        if batch_size % self.shard[1]:
            raise ValueError(f"batch_size {batch_size} does not split over {self.shard[1]} "
                             "data ranks")
        self._len_cache = (None, 0)  # (epoch, bucketed batch count)
        # each example goes to the smallest bucket that holds it (one wider or
        # longer than the largest to the largest: the crops widen for it)
        self.bucket_widths, self._bucket_ids = self._setup_buckets(
            bucket_widths, "canvas_widths", "aspect bucketing")
        self.text_bucket_lens, self._text_bucket_ids = self._setup_buckets(
            text_bucket_lens, "text_lengths", "text-length bucketing")

    def _setup_buckets(self, bounds, hint_attr: str, what: str):
        if not bounds:
            return None, None
        bounds = tuple(sorted(int(b) for b in bounds))
        get_hint = getattr(self.dataset, hint_attr, None)
        need = None
        if get_hint is not None:
            try:
                need = np.asarray(get_hint())
            except (AttributeError, NotImplementedError):
                need = None
        if need is None:
            logger.warning("%s requested but %s provides no %s(); running unbucketed",
                           what, type(self.dataset).__name__, hint_attr)
            return None, None
        ids = np.searchsorted(np.asarray(bounds), np.minimum(need, bounds[-1])).astype(np.int64)
        return bounds, ids

    @property
    def is_bucketed(self) -> bool:
        return self.bucket_widths is not None or self.text_bucket_lens is not None

    def example_order(self) -> np.ndarray:
        """The dataset indices in the order this epoch's batches hold them
        (valid rows only): bucketing permutes the stream, and a consumer that
        must give per-example outputs in dataset order (predict) inverts it."""
        if not len(self.dataset):
            return np.zeros((0,), np.int64)
        return np.concatenate([inds for inds, _, _ in self._index_batches()])

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_skip(self, n_batches: int):
        """Skip the first n batches of the NEXT iteration only, at the index
        level (skipped examples are never loaded): shuffling is a function of
        (seed, epoch), so skipping the consumed prefix replays the rest of an
        epoch."""
        self.skip = int(n_batches)

    def __len__(self):
        if self.is_bucketed:
            # without drop_last the count varies by epoch (the partial buckets
            # depend on the shuffle); the walk is index arithmetic, kept per epoch
            if self._len_cache[0] != self.epoch:
                self._len_cache = (self.epoch, len(self._index_batches()))
            return self._len_cache[1]
        n = len(self.dataset)
        if self.host_count > 1:
            n = len(range(self.host_id, n, self.host_count))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> list:
        """This epoch's batches: (indices, bucket width, text length), the
        last two None without that bucketing."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        if self.host_count > 1:
            idx = idx[self.host_id::self.host_count]
            n = len(idx)
        if not self.is_bucketed:
            stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
            return [(idx[i:i + self.batch_size], None, None)
                    for i in range(0, stop, self.batch_size)]

        def bounds(key):
            wb, tb = key
            w = None if self.bucket_widths is None else self.bucket_widths[wb]
            t = None if self.text_bucket_lens is None else self.text_bucket_lens[tb]
            return w, t

        # walk the shuffled stream; a batch is emitted where its bucket fills
        pending, batches = {}, []
        for i in idx:
            key = (0 if self._bucket_ids is None else int(self._bucket_ids[i]),
                   0 if self._text_bucket_ids is None else int(self._text_bucket_ids[i]))
            pending.setdefault(key, []).append(i)
            if len(pending[key]) == self.batch_size:
                batches.append((np.asarray(pending[key]),) + bounds(key))
                pending[key] = []
        if not self.drop_last:
            for key in sorted(pending):
                if pending[key]:
                    batches.append((np.asarray(pending[key]),) + bounds(key))
        return batches

    def _share(self, task):
        """This rank's rows of a batch task: (indices, width, text length,
        rows of padding to add)."""
        inds, w, t = task
        i, n = self.shard
        if n == 1:
            return task
        k = self.batch_size // n
        mine = inds[i * k:(i + 1) * k]
        if len(mine) == 0:  # all padding: one real example keeps the shapes, masked out
            return inds[:1], w, t, k
        return mine, w, t

    def __iter__(self) -> Iterator[dict]:
        batches = [self._share(b) for b in self._index_batches()[self.skip:]]
        self.skip = 0
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop_evt = threading.Event()
        state = (self.dataset, self.collate_fn, self.batch_size // self.shard[1])

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


def device_prefetch(batch_iter, device, size: int = 2):
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

    Under a profiler the wait on ``batch_iter`` is the span
    ``climb.data_wait``, and enqueueing the copies and handing a batch over
    is ``climb.h2d_copy`` (``utils/tracing.py``)."""
    device = torch.device(device)
    it = iter(batch_iter)

    def wait():
        with span("climb.data_wait"):
            return next(it, None)

    if device.type != "cuda":
        while (batch := wait()) is not None:
            with span("climb.h2d_copy"):
                batch = {k: _as_tensor(v).to(device) for k, v in batch.items()}
            yield batch
        return
    side = torch.cuda.Stream(device)
    ahead = deque()

    def hand_over():
        dev, _, event = ahead.popleft()
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for v in dev.values():
            v.record_stream(current)
        return dev

    while (batch := wait()) is not None:
        with span("climb.h2d_copy"):
            host = {k: _as_tensor(v) for k, v in batch.items()}
            with torch.cuda.stream(side):
                dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
                event = torch.cuda.Event()
                event.record(side)
            ahead.append((dev, host, event))
            ready = hand_over() if len(ahead) > size else None
        if ready is not None:
            yield ready
    while ahead:
        with span("climb.h2d_copy"):
            ready = hand_over()
        yield ready


def collate_from_indices(dataset, indices: Sequence[int], collate_fn: Callable,
                         batch_size: Optional[int] = None) -> dict:
    """One fixed-shape batch of the examples at ``indices`` (the experience
    replay buffer's batches, reference experience_replay.py:53-67)."""
    examples = [dataset[int(i)] for i in indices]
    return pad_batch(collate_fn(examples), batch_size or len(examples))
