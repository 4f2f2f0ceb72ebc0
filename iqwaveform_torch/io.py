"""Reading raw IQ captures from disk for the port's streaming paths.

The host half of iqwaveform_tpu/io.py (:303-643): ``read_iq_data`` and
``read_iq_planes`` load a span of a raw interleaved SigMF payload
(``ci16_le`` int16 pairs or ``cf32_le`` complex64), ``iter_capture_chunks``
walks a capture in fixed chunks, and ``CapturePrefetcher`` reads the next
chunk on a background thread while the card works on the current one
(``WidebandMonitor.accumulate_step``, ``persistence_apd_fold``). Numpy
reads through ``np.memmap`` and converts on a few threads; the JAX
package's optional native loader (``native/iqio.c``) and the SigMF
metadata half are not part of the port.
Everything here runs on the host and returns numpy arrays.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = [
    'CapturePrefetcher',
    'iter_capture_chunks',
    'read_iq_data',
    'read_iq_planes',
]

# bytes of one complex sample of each raw format
_ITEMSIZE = {'ci16': 4, 'cf32': 8}
# the fewest samples a converting thread of read_iq_planes takes
_MIN_SAMPLES_A_THREAD = 1 << 20


def _format(sample_format: str) -> str:
    fmt = sample_format.replace('_le', '')
    if fmt not in _ITEMSIZE:
        raise ValueError(f'unsupported sample_format {sample_format!r}')
    return fmt


def _span(path: str, fmt: str, offset_samples: int, num_samples: int) -> int:
    """the number of samples to read; a request past the end of the file
    raises, as the JAX package's loaders do, rather than coming back
    short."""
    total = os.stat(path).st_size // _ITEMSIZE[fmt]
    n = total - offset_samples if num_samples < 0 else num_samples
    if offset_samples < 0 or n < 0 or offset_samples + n > total:
        raise ValueError(
            f'requested {num_samples} samples at offset {offset_samples} '
            f'exceeds the {total}-sample file'
        )
    return n


def read_iq_planes(
    path,
    sample_format: str = 'ci16_le',
    offset_samples: int = 0,
    num_samples: int = -1,
    scale: float = None,
    threads: int = 8,
    out: np.ndarray = None,
) -> np.ndarray:
    """load a span of a raw interleaved-IQ payload as (2, n) float32 planes:
    row 0 the real plane, row 1 the imaginary plane (the layout of
    ``WidebandMonitor.step_planes``; ``utils.unpack_iq`` makes complex
    samples of them on the card).

    Args:
        path: .sigmf-data file path
        sample_format: 'ci16_le' or 'cf32_le'
        offset_samples / num_samples: complex-sample span (-1 = to EOF)
        scale: per-sample scale (ci16 default 1/32768, cf32 default 1);
            each value is float32(sample) * float32(scale)
        threads: threads that convert slices of the span at once (numpy
            releases the interpreter lock in its loops); spans below
            2**20 samples a thread use fewer
        out: optional C-contiguous (2, n) float32 buffer, filled and
            returned
    """
    path = str(path)
    fmt = _format(sample_format)
    if fmt == 'ci16' and scale is None:
        scale = 1.0 / 32768.0
    n = _span(path, fmt, offset_samples, num_samples)
    if out is None:
        out = np.empty((2, n), np.float32)
    elif out.shape != (2, n) or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f'out must be a C-contiguous (2, {n}) float32 array')
    if n == 0:
        return out
    raw = np.memmap(path, dtype=np.int16 if fmt == 'ci16' else np.float32, mode='r')
    pairs = raw[2 * offset_samples : 2 * (offset_samples + n)].reshape(n, 2)
    scale = None if scale is None or scale == 1.0 else np.float32(scale)

    def convert(lo, hi):
        # one pass a plane: the deinterleave, the conversion to float32
        # and the scale (float32(sample) * float32(scale), as a cast and
        # a multiply in turn give)
        for row in (0, 1):
            if scale is None:
                out[row, lo:hi] = pairs[lo:hi, row]
            else:
                np.multiply(pairs[lo:hi, row], scale, out=out[row, lo:hi], casting='unsafe')

    workers = max(1, min(int(threads), n // _MIN_SAMPLES_A_THREAD))
    if workers == 1:
        convert(0, n)
        return out
    bounds = np.linspace(0, n, workers + 1).astype(int)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for done in [pool.submit(convert, lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])]:
            done.result()
    return out


def read_iq_data(
    path,
    sample_format: str = 'ci16_le',
    offset_samples: int = 0,
    num_samples: int = -1,
    scale: float = None,
    threads: int = 8,
) -> np.ndarray:
    """load a span of a raw interleaved-IQ payload as complex64 (arguments
    as for :func:`read_iq_planes`)."""
    planes = read_iq_planes(
        path, sample_format, offset_samples=offset_samples, num_samples=num_samples,
        scale=scale, threads=threads,
    )
    z = np.empty(planes.shape[1], np.complex64)
    z.real = planes[0]
    z.imag = planes[1]
    return z


class CapturePrefetcher:
    """background-thread chunk feeder for long-capture streaming.

    Reads (and deinterleaves) chunk k + 1 from disk while chunk k computes
    on the card. In plane mode the chunks are (2, chunk_samples) float32
    buffers from a fixed rotation of depth + 3 buffers, so the memory used
    does not grow with the capture. A yielded buffer is intact only until
    ONE further chunk has been consumed: move it to the card
    (``torch.from_numpy(planes).to('cuda')`` copies it) or copy it before
    advancing further.

    Usage:

        with CapturePrefetcher(path, 2**24, 'ci16_le') as chunks:
            for planes in chunks:           # (2, 2**24) float32
                x = unpack_iq(torch.from_numpy(planes).to('cuda'))
                carry = mon.accumulate_step(carry, x)

    The port of iqwaveform_tpu/io.py:433 on its numpy read.
    """

    def __init__(
        self,
        path,
        chunk_samples: int,
        sample_format: str = 'ci16_le',
        *,
        scale: float = None,
        planes: bool = True,
        depth: int = 2,
        drop_last: bool = True,
        threads: int = 4,
    ):
        self.path = str(path)
        self.chunk_samples = int(chunk_samples)
        self.sample_format = sample_format
        self.scale = scale
        self.planes = planes
        self.depth = max(1, int(depth))
        self.drop_last = drop_last
        self.threads = threads

        total = os.stat(self.path).st_size // _ITEMSIZE[_format(sample_format)]
        self.n_chunks = total // self.chunk_samples
        self._tail = total - self.n_chunks * self.chunk_samples
        self._thread = None
        self._finished = False
        self._queue = None
        self._stop = None

    def __len__(self):
        return self.n_chunks + (1 if self._tail and not self.drop_last else 0)

    def _load(self, offset, n, out=None):
        kw = dict(sample_format=self.sample_format, offset_samples=offset, num_samples=n,
                  scale=self.scale, threads=self.threads)
        if self.planes:
            return read_iq_planes(self.path, out=out, **kw)
        return read_iq_data(self.path, **kw)

    def _put(self, item) -> bool:
        """queue.put that gives up promptly when the consumer has left."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self):
        try:
            # depth + 3 buffers: the producer runs at most depth + 2 chunks
            # past the oldest buffer a conforming consumer may still hold
            # (the current one and one before it), so the rotation never
            # overwrites it
            buffers = [
                np.empty((2, self.chunk_samples), np.float32) for _ in range(self.depth + 3)
            ] if self.planes else None
            for k in range(self.n_chunks):
                if self._stop.is_set():
                    return
                out = buffers[k % len(buffers)] if buffers is not None else None
                chunk = self._load(k * self.chunk_samples, self.chunk_samples, out)
                if not self._put(('chunk', chunk)):
                    return
            if self._tail and not self.drop_last and not self._stop.is_set():
                chunk = self._load(self.n_chunks * self.chunk_samples, self._tail)
                if not self._put(('chunk', chunk)):
                    return
            self._put(('done', None))
        except Exception as exc:  # re-raised on the consumer's side
            self._put(('error', exc))

    def __enter__(self):
        self._queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._finished = False
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc_info):
        # tell the producer to abandon the chunks left, drain, then join
        if self._queue is not None:
            self._stop.set()
            while self._thread.is_alive():
                try:
                    self._queue.get(timeout=0.002)
                except queue.Empty:
                    continue
            self._thread.join()
        # iterating after the context exits raises instead of waiting on
        # a drained queue whose producer is gone
        self._queue = None
        return False

    def __iter__(self):
        if self._queue is None:
            raise RuntimeError('iterate inside the context: with CapturePrefetcher(...) as c')
        if self._finished:
            # the producer delivered its end already: an exhausted iterator
            return
        while True:
            kind, payload = self._queue.get()
            if kind == 'chunk':
                yield payload
            elif kind == 'error':
                self._finished = True
                raise payload
            else:
                self._finished = True
                return


def iter_capture_chunks(
    path,
    chunk_samples: int,
    sample_format: str = 'ci16_le',
    scale: float = None,
    drop_last: bool = True,
    *,
    planes: bool = False,
):
    """iterate the chunk_samples-sized chunks of a raw capture, read in
    turn on the calling thread: complex64, or (2, n) float32 planes with
    ``planes=True``; the last, shorter chunk too unless ``drop_last``.
    :class:`CapturePrefetcher` overlaps the reads with the card's work."""
    path = str(path)
    total = os.stat(path).st_size // _ITEMSIZE[_format(sample_format)]
    n_chunks = total // chunk_samples
    load = read_iq_planes if planes else read_iq_data
    spans = [(k * chunk_samples, chunk_samples) for k in range(n_chunks)]
    tail = total - n_chunks * chunk_samples
    if tail and not drop_last:
        spans.append((n_chunks * chunk_samples, tail))
    for offset, n in spans:
        yield load(path, sample_format=sample_format, offset_samples=offset, num_samples=n,
                   scale=scale)
