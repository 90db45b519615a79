"""Block framing: slice a sample stream into fixed-size device blocks.

The reference frames at 10 blocks/s (JavaAudio.java:58-59) because Swing
needs display cadence; this framework frames at whatever block size
amortizes dispatch best (typically >= 1 s of samples) — block size is a
throughput knob, not a latency contract. A compat helper gives the
0.1 s cadence for display-parity tests.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np


class BlockFramer:
    """Accumulate arbitrary-size chunks, emit fixed-size blocks."""

    def __init__(self, block_samples: int):
        self.block = block_samples
        self._buf = np.zeros(0, np.complex64)

    def push(self, chunk: np.ndarray) -> Iterator[np.ndarray]:
        self._buf = np.concatenate([self._buf, chunk.astype(np.complex64)])
        while len(self._buf) >= self.block:
            out, self._buf = self._buf[:self.block], self._buf[self.block:]
            yield out

    def flush(self, pad: bool = False) -> Optional[np.ndarray]:
        """Remaining samples, zero-padded to a full block if ``pad``."""
        if len(self._buf) == 0:
            return None
        out = self._buf
        self._buf = np.zeros(0, np.complex64)
        if pad and len(out) < self.block:
            out = np.concatenate([out, np.zeros(self.block - len(out), np.complex64)])
        return out


class RawBlockFramer:
    """Frame a raw interleaved-int16 stream into fixed-size blocks.

    The raw-mode analog of :class:`BlockFramer`: blocks keep the exact
    capture values so pre-conversion taps (recorder.java:66-74) see the
    device bytes verbatim, and conversion can happen on the device
    (io.convert_device.s16_to_cf)."""

    def __init__(self, block_samples: int, channels: int = 2):
        self.block = block_samples * channels      # int16 values per block
        self._buf = np.zeros(0, np.int16)

    def push(self, chunk: np.ndarray) -> Iterator[np.ndarray]:
        chunk = np.asarray(chunk)
        assert chunk.dtype == np.int16, "raw framer wants int16 chunks"
        self._buf = np.concatenate([self._buf, chunk])
        while len(self._buf) >= self.block:
            out, self._buf = self._buf[:self.block], self._buf[self.block:]
            yield out

    def flush(self, pad: bool = False) -> Optional[np.ndarray]:
        if len(self._buf) == 0:
            return None
        out = self._buf
        self._buf = np.zeros(0, np.int16)
        if pad and len(out) < self.block:
            out = np.concatenate([out, np.zeros(self.block - len(out),
                                                np.int16)])
        return out


def compat_block_len(rate: int) -> int:
    """The reference's block size in samples: rate/10 (JavaAudio.java:58)."""
    return rate // 10
