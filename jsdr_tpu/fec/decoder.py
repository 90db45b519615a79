"""Full AO-40 frame decode: the batched equivalent of
``FECDecoder.FECDecode`` (FECDecoder.java:703-852).

Pipeline (all fixed-shape, jit/vmap friendly):

1. de-interleave 5200 soft symbols -> 5132 (static gather)
2. Viterbi k=7 r=1/2 -> 320 bytes (:mod:`jsdr_tpu.fec.viterbi`)
3. descramble + demux -> 2x shortened RS(255,223) (static reshape + XOR)
4. RS decode both codewords (:mod:`jsdr_tpu.fec.rs`)
5. re-encode the payload and count channel symbol errors
   (:mod:`jsdr_tpu.fec.encode`)

Returns, per frame: payload[256], ok flag, per-codeword RS correction
counts, and the reference-compatible return code (channel errors, or -1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import encode as jenc
from . import rs as jrs
from . import viterbi as jvit
from .tables import (
    BLOCKSIZE, COLUMNS, KK, NBITS, NN, ROWS, RSBLOCKS, RSPAD, SCRAMBLER,
    SYMPBLOCK,
)

# de-interleave gather: symbols[(col-1)*65 + row] = raw[row*80 + col]
_COL = np.arange(1, ROWS).repeat(COLUMNS)                 # 5135 entries
_ROW = np.tile(np.arange(COLUMNS), ROWS - 1)
_DEINT_IDX = np.asarray((_ROW * ROWS + _COL)[: 2 * NBITS], dtype=np.int32)

_SCRAM320 = np.asarray(SCRAMBLER[:320], dtype=np.uint8)


class FecResult(NamedTuple):
    payload: jnp.ndarray    # [..., 256] uint8 (zeros when not ok)
    ok: jnp.ndarray         # [...] bool
    rs_errors: jnp.ndarray  # [..., 2] int32, -1 per failed codeword
    rc: jnp.ndarray         # [...] int32: channel symbol errors, or -1


def deinterleave(raw: jnp.ndarray) -> jnp.ndarray:
    """[..., 5200] soft symbols -> [..., 5132] Viterbi input."""
    return raw[..., _DEINT_IDX]


def descramble_demux(vitdec: jnp.ndarray) -> jnp.ndarray:
    """[..., 320] bytes -> [..., 2, 255] zero-padded RS codewords."""
    un = vitdec ^ jnp.asarray(_SCRAM320)
    cols = jnp.swapaxes(un.reshape(*un.shape[:-1], NN - RSPAD, RSBLOCKS), -1, -2)
    pad = jnp.zeros((*un.shape[:-1], RSBLOCKS, RSPAD), jnp.uint8)
    return jnp.concatenate([pad, cols], axis=-1)


def _decode_one(raw: jnp.ndarray) -> FecResult:
    symbols = deinterleave(raw)
    vitdec = jvit.bits_to_bytes(jvit.viterbi27_bits(symbols))
    rsblocks = descramble_demux(vitdec)
    corrected, nerr = jax.vmap(jrs.decode_rs_codeword)(rsblocks)
    ok = jnp.all(nerr >= 0)
    payload = jnp.swapaxes(corrected[:, RSPAD:KK], -1, -2).reshape(-1)
    payload = jnp.where(ok, payload, 0).astype(jnp.uint8)
    reenc = jenc.encode_frame_affine(payload)
    errors = jnp.sum((reenc != (raw >> 7)).astype(jnp.int32))
    rc = jnp.where(ok, errors, -1)
    return FecResult(payload, ok, nerr, rc)


@jax.jit
def fec_decode(raw: jnp.ndarray) -> FecResult:
    """Batched frame decode: [..., 5200] soft symbol bytes -> FecResult.

    Soft convention matches the demodulator: >=0x80 means symbol 1
    (0xc0/0x40 hard mapping, FUNcubeBPSKDemod.java:562-564); the Viterbi
    metric table consumes the full 8-bit soft value.
    """
    fn = _decode_one
    for _ in range(raw.ndim - 1):
        fn = jax.vmap(fn)
    with jax.named_scope("fec"):
        return fn(raw)
