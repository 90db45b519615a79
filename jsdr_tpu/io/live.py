"""Live ingest and real-time audio output.

The reference is an *application*: it captures from a sound device in
real time (JavaAudio.java:347-367), paces file replay to ~100 ms/block
(JavaAudio.java:231-233), and plays demodulated audio through a speaker
via a dedicated writer thread (demod.java:489-506). A server host has
no sound card, but the same capabilities map onto OS pipes and
subprocesses:

- :class:`StreamSource` — blocking reads of S16LE I/Q from stdin, a
  FIFO, or a capture subprocess (``arecord``-style); the producer's
  pacing *is* the real-time clock, exactly like a sound-device read.
- :class:`PacedSource` — wraps any block iterator and sleeps to the
  reference's real-time cadence, for replaying recorded files as if
  they were live.
- :class:`AudioSink` — a bounded-queue writer thread draining S16LE
  stereo audio to a playback subprocess (``aplay``-style), a FIFO, or a
  file; overruns drop the oldest block and are counted, mirroring the
  real-time discard behavior of a saturated SourceDataLine.
"""

from __future__ import annotations

import queue
import shlex
import subprocess
import sys
import threading
import time
from typing import IO, Iterator, Optional

import numpy as np

from .convert import s16le_to_complex


class StreamSource:
    """Stream complex64 IQ chunks from a live byte stream.

    ``spec`` selects the stream (the CLI's source-name grammar):

    - ``pipe:-``       read S16LE bytes from stdin
    - ``pipe:<path>``  read from a file/FIFO at ``path``
    - ``capture:<cmd>`` spawn ``cmd`` and read its stdout (the analog of
      opening the FUNcube's USB audio device, JavaAudio.java:347-367 —
      e.g. ``capture:arecord -f S16_LE -r 96000 -c 2 -t raw``)

    Reads block until data arrives, so a real-time producer paces the
    whole pipeline — the equivalent of the reference's blocking
    sound-device read (JavaAudio.java:242-251).
    """

    def __init__(self, spec: str, rate: int = 96000, channels: int = 2,
                 i_corr: int = 0, q_corr: int = 0,
                 chunk_samples: int = 9600, raw: bool = False):
        self.rate = rate
        self.channels = channels
        self.i_corr = i_corr
        self.q_corr = q_corr
        self.chunk_samples = chunk_samples
        # raw mode: yield int16 interleaved chunks unconverted — the
        # Session converts ON DEVICE and raw taps (recorder) see the
        # capture bytes verbatim (JavaAudio.java:261-265)
        self.raw = raw
        self._proc: Optional[subprocess.Popen] = None
        self._own_fh = False
        if spec.startswith("capture:"):
            cmd = spec[len("capture:"):]
            self._proc = subprocess.Popen(
                shlex.split(cmd), stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL)
            self._fh: IO[bytes] = self._proc.stdout  # type: ignore[assignment]
        elif spec in ("pipe:-", "-"):
            self._fh = sys.stdin.buffer
        elif spec.startswith("pipe:"):
            self._fh = open(spec[len("pipe:"):], "rb")
            self._own_fh = True
        else:
            raise ValueError(f"unknown live source {spec!r}")

    def blocks(self) -> Iterator[np.ndarray]:
        """Yield complex64 chunks as bytes arrive; ends at EOF."""
        frame = 2 * self.channels                  # bytes per IQ sample
        want = self.chunk_samples * frame
        buf = b""
        while True:
            data = self._fh.read(want - len(buf))
            if not data:                            # EOF / producer gone
                break
            buf += data
            n = (len(buf) // frame) * frame
            if n:
                chunk, buf = buf[:n], buf[n:]
                if self.raw:
                    yield np.frombuffer(chunk, dtype="<i2")
                else:
                    yield s16le_to_complex(chunk, self.channels,
                                           self.i_corr, self.q_corr)
        self.close()

    __iter__ = blocks

    def close(self):
        if self._proc is not None:
            self._proc.terminate()
            self._proc.wait(timeout=5)
            self._proc = None
        if self._own_fh:
            self._fh.close()
            self._own_fh = False


class PacedSource:
    """Pace an iterator of IQ chunks to real time.

    The reference sleeps file replay to ~100 ms per block so downstream
    behaves as if the data were live (JavaAudio.java:231-233). Pacing is
    deadline-based (t0 + n/rate), so jitter never accumulates.
    """

    def __init__(self, inner, rate: int, clock=time.monotonic,
                 sleep=time.sleep):
        self.inner = inner
        self.rate = rate
        self._clock = clock
        self._sleep = sleep

    def __iter__(self) -> Iterator[np.ndarray]:
        t0 = self._clock()
        sent = 0
        for chunk in self.inner:
            # raw int16 chunks interleave 2 values per IQ sample
            vals = 2 if np.asarray(chunk).dtype == np.int16 else 1
            sent += len(chunk) // vals
            deadline = t0 + sent / self.rate
            delay = deadline - self._clock()
            if delay > 0:
                self._sleep(delay)
            yield chunk


class AudioSink:
    """Real-time audio output: a writer thread draining a bounded queue.

    The analog of demod.java's output pump (:489-506): the demod path
    enqueues S16LE stereo blocks without blocking; a dedicated thread
    writes them to the destination at the destination's own pace. When
    the queue is full (consumer slower than real time) the oldest block
    is dropped and counted — the behavior of a saturated audio line.

    ``dest``:
    - ``cmd:<command>`` — spawn e.g. ``cmd:aplay -f S16_LE -r 9600 -c 2
      -t raw`` and stream to its stdin
    - ``-``            — stream to stdout
    - anything else    — a file or FIFO path (appended)
    """

    def __init__(self, dest: str, max_blocks: int = 8):
        self._proc: Optional[subprocess.Popen] = None
        self._own_fh = False
        if dest.startswith("cmd:"):
            self._proc = subprocess.Popen(
                shlex.split(dest[4:]), stdin=subprocess.PIPE,
                stderr=subprocess.DEVNULL)
            self._fh: IO[bytes] = self._proc.stdin  # type: ignore[assignment]
        elif dest == "-":
            self._fh = sys.stdout.buffer
        else:
            self._fh = open(dest, "wb")
            self._own_fh = True
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(max_blocks)
        self.overruns = 0
        self.blocks_written = 0
        self._err: Optional[BaseException] = None
        self._thr = threading.Thread(target=self._pump, daemon=True)
        self._thr.start()

    def _pump(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            try:
                self._fh.write(item)
                self._fh.flush()
                self.blocks_written += 1
            except BaseException as e:  # noqa: BLE001 - surfaced on close()
                self._err = e
                break

    def write(self, audio) -> None:
        """Enqueue one block of audio (float [-1,1] mono/stereo or
        ready int16); never blocks the DSP thread."""
        a = np.asarray(audio)
        if a.dtype != np.int16:
            a = np.clip(np.round(a * 32767.0), -32768, 32767).astype("<i2")
        if a.ndim == 1:                       # mono -> dup to stereo, like
            a = np.stack([a, a], axis=-1)     # demod.java:475-477
        data = a.astype("<i2").tobytes()
        while True:
            try:
                self._q.put_nowait(data)
                return
            except queue.Full:
                try:                           # drop oldest, keep newest
                    self._q.get_nowait()
                    self.overruns += 1
                except queue.Empty:
                    pass

    def close(self):
        self._q.put(None)
        self._thr.join(timeout=10)
        if self._proc is not None:
            self._fh.close()
            self._proc.wait(timeout=10)
            self._proc = None
        elif self._own_fh:
            self._fh.close()
            self._own_fh = False
        if self._err is not None:
            raise self._err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
