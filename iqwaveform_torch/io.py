"""Reading and writing spectrum-monitoring captures for the port.

The port of iqwaveform_tpu/io.py (reference io.py:1-152). Everything here
runs on the host and returns numpy arrays (or pandas objects).

* SigMF recordings: ``read_sigmf_metadata`` / ``read_sigmf`` (npy payloads,
  cut at the captures' sorted starts, scaled to volts from an NTIA
  calibration annotation), ``read_sigmf_to_df``, ``waveform_to_frame``,
  ``resample_iq`` and ``write_sigmf`` (cf32_le, ci16_le or npy payloads; a
  tensor on the card is copied to the host). The JSON is read and written
  directly, with no ``sigmf`` package, in the JAX package's layout, so a
  recording written by either package reads in the other.
* Raw payload streams: ``read_iq_data`` and ``read_iq_planes`` load a span
  of a raw interleaved SigMF payload (``ci16_le`` int16 pairs or
  ``cf32_le`` complex64), ``iter_capture_chunks`` walks a capture in fixed
  chunks, and ``CapturePrefetcher`` reads the next chunk on a background
  thread while the card works on the current one
  (``WidebandMonitor.accumulate_step``, ``persistence_apd_fold``). Numpy
  reads through ``np.memmap`` and converts on a few threads; the JAX
  package's optional native loader (``native/iqio.c``) is not part of the
  port.

pandas and scipy.signal are imported at first use (the machine with the
card has no pandas).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .utils import to_host

__all__ = [
    'CapturePrefetcher',
    'extract_ntia_calibration_metadata',
    'iter_capture_chunks',
    'read_iq_data',
    'read_iq_planes',
    'read_sigmf',
    'read_sigmf_metadata',
    'read_sigmf_to_df',
    'resample_iq',
    'waveform_to_frame',
    'write_sigmf',
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


# ---- SigMF recordings (iqwaveform_tpu/io.py:43-300)

# NTIA sensor annotation fields -> (output key, value transform)
_NTIA_CAL_FIELDS = {
    'ntia-sensor:temperature': ('ambient temperature (K)', lambda c: c + 273.15),
    'ntia-sensor:noise_figure_sensor': ('noise figure (dB)', lambda v: v),
    'ntia-sensor:gain_preselector': ('gain (dB)', lambda v: v),
}


def extract_ntia_calibration_metadata(metadata: dict) -> dict:
    """pull calibration values from an NTIA CalibrationAnnotation
    (reference io.py:13-32)."""
    cal = {key: None for key, _ in _NTIA_CAL_FIELDS.values()}

    annotations = (
        a
        for a in metadata['annotations']
        if a['ntia-core:annotation_type'] == 'CalibrationAnnotation'
    )
    for annotation in annotations:
        for field, (key, convert) in _NTIA_CAL_FIELDS.items():
            cal[key] = convert(annotation[field])
        break

    return cal


def read_sigmf_metadata(metadata_fn, ntia=False):
    """read capture table + sample rate (+ NTIA calibration) from SigMF
    metadata (reference io.py:35-55)."""
    metadata = json.loads(Path(metadata_fn).read_text())

    # {sample_start: value} maps for each capture field
    def by_start(field):
        return {c['core:sample_start']: c[f'core:{field}'] for c in metadata['captures']}

    cal = extract_ntia_calibration_metadata(metadata) if ntia else {}

    return (
        by_start('frequency'),
        by_start('datetime'),
        metadata['global']['core:sample_rate'],
        cal,
    )


def _load_sigmf_payload(metadata_path: Path, data_ext: str) -> np.ndarray:
    """load the raw sample payload stored next to a .sigmf-meta file."""
    if data_ext != '.npy':
        raise TypeError(f'SIGMF data extension {data_ext} not supported')
    return np.load(metadata_path.with_suffix('.sigmf-data.npy'))


def _cut_at_capture_starts(x: np.ndarray, capture_starts, stack: bool):
    """cut the flat payload at each capture's sample_start offset; with
    ``stack`` the per-capture segments become columns of one 2-D array."""
    interior_cuts = sorted(capture_starts)[1:]
    segments = np.array_split(x, interior_cuts)
    return np.vstack(segments).T if stack else segments


def _voltage_scale_from_cal(cal: dict, require: bool, z0: float):
    """multiplicative raw-sample -> volts factor from the calibrated
    front-end gain (1/sqrt(2*G/z0)), or None when uncalibrated."""
    gain_dB = cal.get('gain (dB)', None)
    if gain_dB is None:
        if require:
            raise LookupError('no calibration data is available in NTIA extensions')
        return None
    return 1.0 / np.sqrt(2.0 * 10.0 ** (gain_dB / 10.0) / z0)


def read_sigmf(
    metadata_path: str, force_sample_rate: float = None, sigmf_data_ext='.npy',
    stack=False, ntia_extensions=False, z0=50,
):
    """load a SigMF capture stored in npy format, split by capture start,
    with optional gain de-embedding to volts.

    Behavior parity with reference io.py:58-96 (return contract:
    ``(captures, center_frequencies, Ts, calibration)``, numpy arrays);
    ``utils.to_device_array`` moves the captures to the card.
    """
    metadata_path = Path(metadata_path)
    center_freqs, _timestamps, sample_rate, cal = read_sigmf_metadata(
        metadata_path, ntia=ntia_extensions
    )
    Ts = 1.0 / (force_sample_rate if force_sample_rate is not None else sample_rate)

    payload = _load_sigmf_payload(metadata_path, sigmf_data_ext)
    # segments follow sorted capture starts; sort the start -> frequency
    # pairs together so out-of-order capture metadata cannot misassign a
    # frequency to another segment (the JAX package's fix, docs/PARITY.md)
    starts = sorted(center_freqs)
    freqs = np.array([center_freqs[s] for s in starts])
    captures = _cut_at_capture_starts(payload, starts, stack)

    scale = _voltage_scale_from_cal(cal, require=ntia_extensions, z0=z0)
    if scale is not None and (stack or len({c.shape[0] for c in captures}) == 1):
        captures = np.multiply(captures, scale)
    elif scale is not None:
        # captures of different lengths are scaled one by one (the JAX
        # package's np.multiply of the ragged list raises ValueError)
        captures = [c * scale for c in captures]

    return captures, freqs, Ts, cal


def read_sigmf_to_df(metadata_path: str, force_sample_rate: float = None, sigmf_data_ext='.npy'):
    """(reference io.py:99-106; stacking enabled so the captures become
    DataFrame columns, labelled 'Frequency (GHz)', as the JAX package
    does, docs/PARITY.md)"""
    import pandas as pd

    x_split, center_freqs, Ts, cal = read_sigmf(
        metadata_path,
        force_sample_rate=force_sample_rate,
        sigmf_data_ext=sigmf_data_ext,
        stack=True,
    )
    return waveform_to_frame(
        x_split, Ts, columns=pd.Index(center_freqs / 1e9), column_name='Frequency (GHz)',
    )


def waveform_to_frame(waveform, Ts: float, columns=None, column_name=None):
    """pack IQ data (numpy, or a tensor, copied to the host) into a pandas
    Series or DataFrame with a time index (reference io.py:109-147)."""
    import pandas as pd

    waveform = to_host(waveform)
    if waveform.ndim not in (1, 2):
        raise TypeError('iq must have 1 or 2 dimensions')

    n = waveform.shape[0]
    index = pd.Index(np.linspace(0.0, n * Ts, n, endpoint=False), name='Time elapsed (s)')

    if waveform.ndim == 1:
        return pd.Series(waveform, index=index)

    if columns is None:
        columns = np.arange(waveform.shape[1])
    frame = pd.DataFrame(waveform, index=index, columns=columns)
    if column_name is not None:
        frame.columns.name = column_name
    return frame


def resample_iq(iq, Ts, scale, axis=0):
    """Fourier resampling of ``iq`` (numpy, or a tensor, copied to the
    host) by ``scale`` on the host with scipy (reference io.py:150-152)."""
    from scipy import signal

    iq = to_host(iq)
    N = int(np.round(iq.shape[0] * scale))
    return signal.resample(iq, num=N, axis=axis), Ts / scale


def write_sigmf(
    path_stem,
    iq,
    sample_rate: float,
    *,
    center_frequency=0.0,
    datatype: str = 'cf32_le',
    timestamps=None,
    scale: float = None,
    annotations=(),
    global_fields: dict = None,
):
    """persist captured IQ + metadata as a SigMF recording, as
    iqwaveform_tpu.io.write_sigmf does (the same data file byte for byte,
    the same JSON); it reads back through ``read_sigmf`` (npy) and
    ``read_iq_data`` (cf32_le, ci16_le) of either package.

    Args:
        path_stem: output path; '.sigmf-meta'/'.sigmf-data' suffixes are
            added (or replaced)
        iq: one 1-D complex waveform, or a list of per-capture waveforms:
            numpy arrays or tensors (a tensor on the card is copied to the
            host)
        sample_rate: samples/s, stored as core:sample_rate
        center_frequency: scalar, or one value per capture
        datatype: payload encoding: 'cf32_le' (complex64), 'ci16_le'
            (scaled int16), or 'npy' (numpy format, read_sigmf compatible)
        timestamps: ISO-8601 string(s) per capture (default: now, UTC)
        scale: full-scale amplitude for ci16_le quantization
            (default 32768, matching read_iq_data's 1/32768)
        annotations: SigMF annotation dicts, stored verbatim
        global_fields: extra keys merged into the global object

    Returns:
        (data_path, meta_path) as Paths
    """
    import datetime as _dt

    stem = Path(path_stem)
    while stem.suffix in ('.sigmf-meta', '.sigmf-data', '.npy'):
        stem = stem.with_suffix('')

    caps = list(iq) if isinstance(iq, (list, tuple)) else [iq]
    caps = [np.ascontiguousarray(to_host(c).reshape(-1)) for c in caps]
    freqs = np.broadcast_to(np.asarray(center_frequency, float), (len(caps),))
    if timestamps is None:
        now = _dt.datetime.now(_dt.timezone.utc).isoformat()
        timestamps = [now] * len(caps)
    elif isinstance(timestamps, str):
        timestamps = [timestamps] * len(caps)

    starts = np.concatenate([[0], np.cumsum([c.shape[0] for c in caps])[:-1]])
    data = np.concatenate(caps) if len(caps) > 1 else caps[0]

    meta = {
        'global': {
            'core:datatype': datatype,
            'core:sample_rate': float(sample_rate),
            'core:version': '1.0.0',
            **(global_fields or {}),
        },
        'captures': [
            {
                'core:sample_start': int(s),
                'core:frequency': float(f),
                'core:datetime': t,
            }
            for s, f, t in zip(starts, freqs, timestamps)
        ],
        'annotations': list(annotations),
    }

    # append (never with_suffix-replace) so stems containing dots keep
    # their full name and the data/meta pair stays consistent
    if datatype == 'cf32_le':
        data_path = Path(str(stem) + '.sigmf-data')
        data.astype('<c8').tofile(data_path)
    elif datatype == 'ci16_le':
        data_path = Path(str(stem) + '.sigmf-data')
        full_scale = 32768.0 if scale is None else float(scale)
        planes = np.stack([data.real, data.imag], axis=-1) * full_scale
        quantized = np.clip(np.round(planes), -32768, 32767).astype('<i2')
        quantized.tofile(data_path)
    elif datatype == 'npy':
        data_path = Path(str(stem) + '.sigmf-data.npy')
        np.save(data_path, data.astype('complex64'))
    else:
        raise ValueError(f"datatype must be 'cf32_le', 'ci16_le', or 'npy', not {datatype!r}")

    meta_path = Path(str(stem) + '.sigmf-meta')
    meta_path.write_text(json.dumps(meta, indent=1))
    return data_path, meta_path
