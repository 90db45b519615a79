"""Device-side sample conversion: upload raw int16 and convert on the
device.

Shipping the raw S16LE bytes to the device halves the transfer size vs
a float32 planar pair AND moves the convert loop off the host. Semantics identical to
``io.convert.s16le_to_complex`` (wrapping 16-bit DC correction then
1/32767 scale, JavaAudio.java:275-293).

Output is a planar :class:`~jsdr_tpu.ops.cplx.CF` pair, the
framework's native layout (ops/cplx.py), so the converted block feeds
the spectrum / demod chains with no further relayout. Checked against
the host converter by ``bench.py``'s ingest phase and
``tests/test_io_runtime.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.cplx import CF


@functools.partial(jax.jit, static_argnames=("channels",))
def s16_to_cf(samples: jnp.ndarray, i_corr: jnp.ndarray, q_corr: jnp.ndarray,
              channels: int = 2) -> CF:
    """Interleaved int16 I/Q on device -> planar CF float32.

    ``samples``: [2N] (channels=2) or [N] (mono -> Q=0) int16. The DC
    correction is added with Java ``short`` wrap-around semantics
    (JavaAudio.java:275-293): compute in int32, wrap to [-32768, 32767].
    """
    s = samples.astype(jnp.int32)
    if channels == 2:
        s = s.reshape(-1, 2)
        i, q = s[:, 0], s[:, 1]
    else:
        i, q = s, jnp.zeros_like(s)

    def wrap16(x):
        return ((x + 32768) & 0xFFFF) - 32768

    i = wrap16(i + i_corr.astype(jnp.int32))
    q = wrap16(q + q_corr.astype(jnp.int32))
    scale = jnp.float32(1.0 / 32767.0)
    return CF(i.astype(jnp.float32) * scale, q.astype(jnp.float32) * scale)


def upload_raw(raw: bytes | np.ndarray) -> jnp.ndarray:
    """Host bytes -> device int16 array (half the bytes of a float pair)."""
    s = np.frombuffer(raw, dtype="<i2") if not isinstance(raw, np.ndarray) else raw
    return jnp.asarray(s)
