"""Samplers and batched data loaders (counterpart of
``u2seg_tpu/data/loader.py``; detectron2's ``data/build.py``,
``samplers/distributed_sampler.py`` and ``common.py``).

Training: the sampler shards an endless shuffled index stream by rank; the
mapper makes bucket-padded fixed-size examples; batches group examples of
one bucket (the static-shape form of aspect-ratio grouping). With
``num_workers > 0`` worker processes, forked when the loader is made, map
ahead of the consumer from its first ``next()`` on, on one torch thread
each, so that mapping takes neither the interpreter lock nor the cores
from the thread that dispatches the step. Each example gets its own
``RandomState``, drawn in the trainer's process in submission order, and
examples are batched in that order, so the batch stream depends on the
seed, the rank and whether there are workers, and not on their number or
timing: the JAX package's stream (a thread pool there), example for
example.

Test: ``InferenceSampler`` splits one pass into contiguous, balanced shards,
one per process. No evaluator gathers the shards again: each process scores
its own images, as in the JAX package.
"""
from __future__ import annotations

import gc
import itertools
import logging
import multiprocessing
import pickle
import queue
import select
import signal
import socket
import struct
import threading
import time
import traceback
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, Iterable, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class TrainingSampler:
    """Endless shuffled index stream; process ``rank`` of ``world_size``
    takes every ``world_size``-th index of each epoch's permutation."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        if size <= 0:
            raise ValueError(f"TrainingSampler needs a non-empty dataset, got {size}")
        self.size = size
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            order = g.permutation(self.size) if self.shuffle else np.arange(self.size)
            yield from order[self.rank::self.world_size].tolist()


class RepeatFactorTrainingSampler(TrainingSampler):
    """Class-balanced resampling: an image repeats ``max(1, sqrt(t / f_c))``
    times for its rarest category c of frequency f_c (stochastic rounding
    per epoch)."""

    def __init__(self, dataset_dicts: List[dict], repeat_thresh: float,
                 shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1):
        freq: Dict[int, int] = defaultdict(int)
        n = len(dataset_dicts)
        for d in dataset_dicts:
            for cid in {a["category_id"] for a in d.get("annotations", [])}:
                freq[cid] += 1
        cat_repeat = {cid: max(1.0, np.sqrt(repeat_thresh / (c / n)))
                      for cid, c in freq.items()}
        self._repeats = []
        for d in dataset_dicts:
            cats = {a["category_id"] for a in d.get("annotations", [])}
            self._repeats.append(max([cat_repeat.get(c, 1.0) for c in cats], default=1.0))
        super().__init__(n, shuffle, seed, rank, world_size)

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self.seed)
        while True:
            rands = g.rand(self.size)
            indices = []
            for i, rf in enumerate(self._repeats):
                rep = int(rf) + (1 if rands[i] < (rf - int(rf)) else 0)
                indices.extend([i] * rep)
            order = g.permutation(len(indices)) if self.shuffle else np.arange(len(indices))
            sel = [indices[j] for j in order]
            yield from sel[self.rank::self.world_size]


def _stack_batch(examples: List[dict]) -> dict:
    """Examples of one bucket -> one dict of stacked arrays (``bucket``
    dropped)."""
    out = {}
    for k in examples[0]:
        if k == "bucket":
            continue
        vals = [e[k] for e in examples]
        out[k] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


class _Batcher:
    """Group examples by bucket; a batch is ready when a bucket holds
    ``batch_size`` examples."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.buffers: Dict[tuple, List[dict]] = defaultdict(list)

    def add(self, ex: Optional[dict]) -> Optional[dict]:
        if ex is None:                  # no instance survived: draw another image
            return None
        b = self.buffers[ex["bucket"]]
        b.append(ex)
        if len(b) < self.batch_size:
            return None
        self.buffers[ex["bucket"]] = []
        return _stack_batch(b)


def build_detection_train_loader(
    dataset_dicts: List[dict],
    mapper: Callable[[dict, np.random.RandomState], Optional[dict]],
    total_batch_size: int,
    seed: int = 0,
    rank: int = 0,
    world_size: int = 1,
    sampler: Optional[Iterable[int]] = None,
    prefetch: int = 2,
    num_workers: int = 4,
) -> Iterator[dict]:
    """Endless stream of batches of ``total_batch_size`` examples of one
    bucket, for process ``rank`` of ``world_size``.

    ``num_workers <= 0``: examples are mapped on the consumer's thread, all
    with one ``RandomState(seed * 1000 + rank)``. Otherwise a producer
    thread keeps ``2 * num_workers`` mapper calls in flight on
    ``num_workers`` worker processes, each with its own ``RandomState``
    drawn from that one in submission order, and hands batches over through
    a queue of ``prefetch`` (``PrefetchLoader``); the returned iterator's
    ``close()`` (also run when it is garbage-collected) stops the thread
    and the workers. Both count their work in ``COUNTS``.
    """
    if sampler is None:
        sampler = TrainingSampler(len(dataset_dicts), seed=seed, rank=rank,
                                  world_size=world_size)
    rng = np.random.RandomState(seed * 1000 + rank)   # refuses a seed of 2**32 or more
    if num_workers <= 0:
        def generate() -> Iterator[dict]:
            batcher = _Batcher(total_batch_size)
            for idx in sampler:
                COUNTS.add(in_thread=1)
                batch = batcher.add(mapper(dataset_dicts[idx], rng))
                if batch is not None:
                    yield batch
        return generate()
    return PrefetchLoader(dataset_dicts, mapper, sampler, total_batch_size, rng,
                          num_workers, max(prefetch, 1))


_DONE = object()
_STOPPED = object()
_POLL_S = 0.1            # the producer looks at its stop flag and its workers this often
_STOP_S = 2.0            # what closing gives workers before it kills them
_LENGTH = struct.Struct("<Q")


class LoaderCounts:
    """What the train loaders of this process did: the examples mapped in
    worker processes (``in_workers``) and on the consumer's thread
    (``in_thread``), and of the ``calls`` of a worker loader's ``next()``,
    those that found a batch ready in its queue (``ready``). One object per
    process, ``COUNTS``, so that the trainer's ``u2s.data`` span carries
    ``args()`` whatever wraps the loader it was given."""

    def __init__(self):
        self._lock = threading.Lock()
        self.in_workers = self.in_thread = self.ready = self.calls = 0

    def add(self, in_workers: int = 0, in_thread: int = 0, ready: int = 0,
            calls: int = 0) -> None:
        with self._lock:
            self.in_workers += in_workers
            self.in_thread += in_thread
            self.ready += ready
            self.calls += calls

    def args(self) -> tuple:
        """``(in_workers, in_thread, ready, calls)``."""
        return self.in_workers, self.in_thread, self.ready, self.calls


COUNTS = LoaderCounts()


def _put(q: "queue.Queue", stop: threading.Event, item) -> bool:
    """Put ``item`` unless ``stop`` is set first (checked every 0.1 s)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            pass
    return False


class _Serialized:
    """A list of dicts kept as one byte array of their pickles (as
    detectron2's ``DatasetFromList(serialize=True)``): a worker forked from
    the trainer reads an item without writing to the pages it shares with
    the trainer. Reading the live dicts would write their reference counts,
    and so copy every page of them into every worker over a run."""

    def __init__(self, items: List[dict]):
        blobs = [pickle.dumps(d, pickle.HIGHEST_PROTOCOL) for d in items]
        self._ends = np.cumsum([len(b) for b in blobs], dtype=np.int64)
        self._bytes = np.frombuffer(b"".join(blobs), np.uint8)

    def __len__(self) -> int:
        return len(self._ends)

    def __getitem__(self, i: int) -> dict:
        return pickle.loads(self._bytes[int(self._ends[i - 1]) if i else 0:int(self._ends[i])])


# -- frames between the loader and its workers ------------------------------
# A frame is a pickled header after its length, then the bytes of each array
# the header lays out, which the loader reads straight into new arrays
# without the interpreter lock. Pickled whole through a process pool's
# queue, 800x1344 examples cost the receiving thread ~5x the CPU, mostly
# under the lock, and halved the loader's rate on an H100 host's 8 cores
# (PERF.md, section 6).

def _send(sock: socket.socket, header, arrays=()) -> None:
    head = pickle.dumps(header, pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LENGTH.pack(len(head)) + head)
    for a in arrays:
        if a.nbytes:
            sock.sendall(a.reshape(-1).view(np.uint8))


def _recv_into(sock: socket.socket, buf) -> None:
    view = memoryview(buf).cast("B")
    while view.nbytes:
        n = sock.recv_into(view, view.nbytes, socket.MSG_WAITALL)
        if n == 0:
            raise EOFError("the other end of the train loader's socket closed")
        view = view[n:]


def _recv(sock: socket.socket):
    """The header of the next frame (its arrays are still to be read)."""
    length = bytearray(_LENGTH.size)
    _recv_into(sock, length)
    head = bytearray(_LENGTH.unpack(length)[0])
    _recv_into(sock, head)
    return pickle.loads(head)


def _frame(result):
    """A mapper's result (an example, ``None`` or the exception it raised)
    as a frame's header and arrays. An example's header holds its keys in
    order, the values that are no arrays, and each array's dtype and shape;
    an exception's, its pickle (``None`` where it will not pickle) and its
    traceback."""
    if isinstance(result, Exception):
        try:
            pickled = pickle.dumps(result, pickle.HIGHEST_PROTOCOL)
        except Exception:
            pickled = None
        return ("error", pickled, "".join(traceback.format_exception(result))), ()
    if result is None:
        return ("none",), ()
    values, layout, arrays = {}, [], []
    for k, v in result.items():
        if isinstance(v, np.ndarray) and not v.dtype.hasobject:
            if not v.flags.c_contiguous:
                v = v.copy()
            layout.append((k, v.dtype, v.shape))
            arrays.append(v)
        else:
            values[k] = v
    return ("example", list(result), values, layout), arrays


def _work(sock: socket.socket, inherited, dicts: _Serialized, mapper) -> None:
    """A worker process: map each ``(index, seed)`` the loader sends, on one
    torch thread, and send back the result until the loader closes its end
    (as it does when the trainer's process ends, even killed)."""
    import torch

    signal.signal(signal.SIGINT, signal.SIG_IGN)      # the trainer handles ^C
    for s in inherited:                 # so that only the loader holds its ends
        s.close()
    gc.freeze()          # the collector leaves the trainer's inherited objects unwritten
    torch.set_num_threads(1)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:                # the trainer had sized its pool already
        pass
    try:
        while True:
            idx, seed = _recv(sock)
            try:
                result = mapper(dicts[idx], np.random.RandomState(seed))
            except Exception as e:      # raised again at the consumer's next()
                result = e
            _send(sock, *_frame(result))
    except (EOFError, OSError):         # the loader closed its end
        pass


class _Worker:
    """A mapping process, forked when it is made, and the loader's end of
    the socket pair it works through: ``sent`` calls whose results are still
    to be read, and ``results`` read but not yet taken, in the order sent.
    ``earlier``: the workers forked before it, whose ends it closes."""

    def __init__(self, number: int, dicts: _Serialized, mapper, earlier: List["_Worker"]):
        self.number = number
        self.sent = 0
        self.results: Deque = deque()
        self.sock, theirs = socket.socketpair()
        try:
            self.proc = multiprocessing.get_context("fork").Process(
                target=_work, name=f"train-loader-{number}", daemon=True,
                args=(theirs, [self.sock] + [w.sock for w in earlier], dicts, mapper))
            self.proc.start()
        finally:
            theirs.close()

    def send(self, idx: int, seed: int) -> None:
        try:
            _send(self.sock, (idx, seed))
        except OSError:
            raise self.ended() from None
        self.sent += 1

    def read(self) -> None:
        """Read the next result into ``results``: an example, ``None`` where
        the mapper dropped the image, or the mapper's exception."""
        try:
            header = _recv(self.sock)
            if header[0] == "example":
                _, keys, values, layout = header
                for k, dtype, shape in layout:
                    a = np.empty(shape, dtype)
                    if a.nbytes:
                        _recv_into(self.sock, a.reshape(-1).view(np.uint8))
                    values[k] = a
        except (EOFError, OSError):
            raise self.ended() from None
        self.sent -= 1
        if header[0] == "example":
            self.results.append({k: values[k] for k in keys})
        elif header[0] == "none":
            self.results.append(None)
        else:
            self.results.append(self._mapper_error(*header[1:]))

    def _mapper_error(self, pickled: Optional[bytes], text: str) -> Exception:
        """The mapper's exception, with the worker's traceback as a note;
        a ``RuntimeError`` holding that text where it will not unpickle."""
        where = f"in train loader worker {self.number} (pid {self.proc.pid}):\n{text}"
        try:
            e = pickle.loads(pickled) if pickled is not None else None
        except Exception:
            e = None
        if not isinstance(e, Exception):
            return RuntimeError(f"the mapper raised {where}")
        e.add_note(f"raised {where}")
        return e

    def ended(self) -> RuntimeError:
        self.proc.join(_STOP_S)
        code = self.proc.exitcode
        how = f"exit code {code}"
        if code is not None and code < 0:
            how += f" ({signal.strsignal(-code)})"
        return RuntimeError(
            f"train loader worker {self.number} (pid {self.proc.pid}) ended with {how}")


def _take(w: _Worker, workers: List[_Worker], stop: threading.Event):
    """``w``'s next result, ``_STOPPED`` once ``stop`` is set while it
    waits. Meanwhile it reads whatever any worker has sent, so that no
    worker waits on its send for its turn."""
    while not w.results:
        busy = [x for x in workers if x.sent]
        ready = select.select([x.sock for x in busy], [], [], _POLL_S)[0]
        if stop.is_set():
            return _STOPPED
        for x in busy:
            if x.sock in ready:
                x.read()
            elif x.proc.exitcode is not None:
                raise x.ended()
    result = w.results.popleft()
    if isinstance(result, Exception):
        raise result
    return result


def _stop_workers(workers: List[_Worker]) -> None:
    """Close the loader's ends: a worker waiting for work ends at once, one
    that is mapping when it sends. Join them; kill those alive after
    ``_STOP_S``."""
    for w in workers:
        w.sock.close()
    deadline = time.monotonic() + _STOP_S
    for w in workers:
        w.proc.join(max(0.0, deadline - time.monotonic()))
        if w.proc.exitcode is None:
            w.proc.kill()
            w.proc.join()


def _produce(q, stop, go, workers, sampler, batch_size, rng_global):
    """The producer thread of ``PrefetchLoader``: it holds no reference to
    the loader, so dropping the loader closes it. It sends no work before
    ``go`` is set. Call ``j`` goes to worker ``j mod len(workers)``, and
    results are taken in the order sent."""
    try:
        while not go.wait(_POLL_S):
            if stop.is_set():
                return
        batcher = _Batcher(batch_size)
        it = iter(sampler)
        turn = itertools.cycle(workers)
        inflight: Deque[_Worker] = deque()

        def submit():
            idx = next(it)
            w = next(turn)
            w.send(idx, int(rng_global.randint(2 ** 31)))
            inflight.append(w)

        for _ in range(len(workers) * 2):         # a window of calls in flight
            submit()
        while not stop.is_set():
            w = inflight.popleft()
            submit()
            ex = _take(w, workers, stop)
            if ex is _STOPPED:
                break
            COUNTS.add(in_workers=1)
            batch = batcher.add(ex)
            if batch is not None and not _put(q, stop, batch):
                break
    except StopIteration:                         # a finite sampler ran out
        pass
    except BaseException as e:                    # handed to the consumer
        _put(q, stop, e)
    finally:
        _stop_workers(workers)
        _put(q, stop, _DONE)


class PrefetchLoader:
    """The train loader with workers: ``num_workers`` processes, forked
    here (``processes``), map examples; a producer thread (``thread``)
    sends them their work from the first ``next()`` on (so that they do not
    compete with what the trainer builds before it asks), each example's
    seed drawn from ``rng``, batches what they send back and puts batches
    in a queue of ``prefetch``. The workers read the dataset dicts (as one
    byte array of their pickles) and the mapper as they were when the
    loader was made. A mapper error
    is raised at the consumer's ``next()`` with the worker's traceback as a
    note, and a worker that ends makes ``next()`` raise with its exit code.
    ``close()`` stops the producer and returns once it and the workers have
    ended; dropping the loader stops them too, and so does the
    interpreter's exit (the workers are daemons). The producer never waits
    for longer than 0.1 s at a time without looking."""

    def __init__(self, dataset_dicts, mapper, sampler, batch_size: int,
                 rng: np.random.RandomState, num_workers: int, prefetch: int):
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._empty = queue.Empty          # still bound when __del__ runs at exit
        self._stop = threading.Event()
        self._go = threading.Event()
        self._finished = False
        workers: List[_Worker] = []
        dicts = _Serialized(dataset_dicts)
        try:
            for k in range(num_workers):
                workers.append(_Worker(k, dicts, mapper, workers))
        except BaseException:
            _stop_workers(workers)
            raise
        self.processes = [w.proc for w in workers]
        self.thread = threading.Thread(
            target=_produce, daemon=True, name="train-loader",
            args=(self._queue, self._stop, self._go, workers, sampler, batch_size, rng))
        self.thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        if self._finished:
            raise StopIteration
        self._go.set()
        COUNTS.add(ready=int(not self._queue.empty()), calls=1)
        item = self._queue.get()
        if item is _DONE or isinstance(item, BaseException):
            self._finished = True
            self._stop_producer()
            if item is _DONE:
                raise StopIteration
            raise item
        return item

    def _stop_producer(self) -> None:
        self._stop.set()
        while True:                       # drop what it queued
            try:
                self._queue.get_nowait()
            except self._empty:
                break

    def close(self, timeout: float = 60.0) -> None:
        """Stop the producer; wait for it and its workers to end."""
        self._stop_producer()
        self.thread.join(timeout)

    def __del__(self):
        self._stop_producer()


class InferenceSampler:
    """Balanced one-pass shards (ref distributed_sampler.py:129)."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        self.size = size
        shard_sizes = [
            size // world_size + int(r < size % world_size)
            for r in range(world_size)
        ]
        begin = sum(shard_sizes[:rank])
        self._local = list(range(begin, begin + shard_sizes[rank]))

    def __iter__(self):
        return iter(self._local)

    def __len__(self):
        return len(self._local)


def build_detection_test_loader(
    dataset_dicts: List[dict],
    mapper: Callable,
    batch_size: int = 1,
    rank: int = 0,
    world_size: int = 1,
) -> Iterator[List[dict]]:
    """One pass, in order, padding the final partial batch by repeating the
    last example (flagged with ``is_padding``) so shapes stay static."""
    sampler = InferenceSampler(len(dataset_dicts), rank, world_size)
    rng = np.random.RandomState(0)
    batch: List[dict] = []
    for idx in sampler:
        ex = mapper(dataset_dicts[idx], rng)
        if ex is None:
            continue
        ex["is_padding"] = False
        batch.append(ex)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        while len(batch) < batch_size:
            pad = dict(batch[-1])
            pad["is_padding"] = True
            batch.append(pad)
        yield batch


def filter_images_with_only_crowd_annotations(dataset_dicts: List[dict]) -> List[dict]:
    """ref data/build.py:46."""
    def ok(d):
        return any(a.get("iscrowd", 0) == 0 for a in d.get("annotations", []))

    out = [d for d in dataset_dicts if ok(d)]
    logger.info(
        "Removed %d images with no usable annotations. %d images left.",
        len(dataset_dicts) - len(out), len(out),
    )
    return out
