"""Batched JAX AO-40 encoder (re-encode verifier + synthetic-frame source).

Batched re-design of the reference encoder (FECDecoder.java:538-688):

- RS parity via a 128-step ``lax.scan`` LFSR per codeword (vmapped)
- scrambling as a vectorized XOR with the CCSDS sequence
- convolutional encoding WITHOUT a sequential shift register: the encoder
  state after bit t is just the last 7 bits, so all 2566 states are a
  sliding-window dot product — fully parallel, unlike the scalar loop at
  FECDecoder.java:559-566
- interleaving as a static scatter
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .tables import (
    A0, ALPHA_TO, BLOCKSIZE, COLUMNS, CPOLYA, CPOLYB, INDEX_OF, NBITS,
    NROOTS, PARTAB, ROWS, RS_POLY, SCRAMBLER, SYMPBLOCK, SYNC_BITS,
)

# Host-side numpy tables, converted to jnp at trace time (see viterbi.py)
_ALPHA_NP = np.asarray(ALPHA_TO, dtype=np.int32)
_INDEX_NP = np.asarray(INDEX_OF, dtype=np.int32)
_PARTAB_NP = np.asarray(PARTAB, dtype=np.int32)
_SCRAM320 = np.asarray(SCRAMBLER[:320], dtype=np.uint8)


def _alpha(i):
    return jnp.asarray(_ALPHA_NP)[i]


def _index(i):
    return jnp.asarray(_INDEX_NP)[i]


def _partab(i):
    return jnp.asarray(_PARTAB_NP)[i]

# full generator coefficient vector g[1..32] in log form, palindromic
# (FECDecoder.java:544-546, 634-641); g[32] (unity) handled separately.
_GPOLY = np.zeros(NROOTS + 1, dtype=np.int64)
_GPOLY[1:16] = RS_POLY[:15]
_GPOLY[16] = RS_POLY[15]
_GPOLY[17:32] = RS_POLY[14::-1][:15]
_GLOG = np.asarray(_GPOLY, dtype=np.int32)

# interleaver scatter: channel-symbol index for encoder output t
_BINDEX = np.arange(2 * NBITS) + COLUMNS
_INTERLEAVE_POS = np.asarray(
    (_BINDEX % COLUMNS) * ROWS + (_BINDEX // COLUMNS), dtype=np.int32
)
_SYNC_POS = np.asarray(np.arange(COLUMNS) * ROWS, dtype=np.int32)
_SYNC_BITS = np.asarray(SYNC_BITS, dtype=np.uint8)


def _gfmul_log(log_a, log_b):
    zero = (log_a == A0) | (log_b == A0)
    return jnp.where(zero, 0, _alpha((log_a + log_b) % 255))


def rs_parity(payload: jnp.ndarray) -> jnp.ndarray:
    """[256] payload bytes -> [2, 32] RS parity (FECDecoder.java:614-655)."""
    data = payload.astype(jnp.int32).reshape(BLOCKSIZE // 2, 2).T  # [2, 128]

    def step(reg, c):
        feedback = _index(c ^ reg[..., 0])
        fb = feedback[..., None]
        # t_j = gfmul(feedback, g[j]) for j = 1..31; XOR in, shift down,
        # append alpha^feedback (reg[0] is discarded by the shift)
        t = _gfmul_log(fb, _GLOG)                      # [2, 33]
        new = reg ^ t[..., : NROOTS]
        shifted = jnp.concatenate(
            [new[..., 1:], jnp.where(feedback == A0, 0, _alpha(feedback % 255))[..., None]],
            axis=-1,
        )
        return shifted, None

    init = jnp.zeros((2, NROOTS), jnp.int32)
    reg, _ = lax.scan(step, init, data.T)  # scan over the 128 byte pairs
    return reg.astype(jnp.uint8)


def conv_encode(bits: jnp.ndarray) -> jnp.ndarray:
    """[NBITS] input bits -> [2*NBITS] channel symbols, fully parallel.

    State after bit t is the window bits[t-6..t] packed MSB-oldest
    (equivalent to the shift register at FECDecoder.java:561-565).
    """
    padded = jnp.concatenate([jnp.zeros(6, bits.dtype), bits]).astype(jnp.int32)
    weights = (1 << jnp.arange(6, -1, -1)).astype(jnp.int32)
    idx = jnp.arange(NBITS)[:, None] + jnp.arange(7)[None, :]
    states = (padded[idx] * weights).sum(axis=-1)      # [NBITS] 7-bit states
    sym_a = _partab(states & CPOLYA)
    sym_b = 1 - _partab(states & CPOLYB)
    return jnp.stack([sym_a, sym_b], axis=-1).reshape(-1).astype(jnp.uint8)


def _bytes_to_bits(b: jnp.ndarray) -> jnp.ndarray:
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    return ((b[..., None] >> shifts) & 1).reshape(*b.shape[:-1], -1)


def encode_frame(payload: jnp.ndarray) -> jnp.ndarray:
    """[256] payload bytes -> [5200] hard channel symbols (0/1 uint8)."""
    parity = rs_parity(payload)                        # [2, 32]
    seq = jnp.concatenate(
        [payload.astype(jnp.uint8), parity.T.reshape(-1)]
    )                                                  # [320]
    scrambled = seq ^ jnp.asarray(_SCRAM320)
    bits = _bytes_to_bits(scrambled)
    bits = jnp.concatenate([bits, jnp.zeros(6, bits.dtype)])  # flush
    syms = conv_encode(bits)
    frame = jnp.zeros(SYMPBLOCK, jnp.uint8)
    frame = frame.at[jnp.asarray(_SYNC_POS)].set(jnp.asarray(_SYNC_BITS))
    frame = frame.at[jnp.asarray(_INTERLEAVE_POS)].set(syms)
    return frame


@jax.jit
def encode_fec40(payload: jnp.ndarray) -> jnp.ndarray:
    """Batched encode: [..., 256] payload -> [..., 5200] symbols."""
    fn = encode_frame
    for _ in range(payload.ndim - 1):
        fn = jax.vmap(fn)
    return fn(payload)


# --- affine (single bit-matmul) form ---------------------------------------
#
# Every stage of the encoder — RS parity, scrambler XOR, convolution,
# interleave, sync column — is affine over GF(2), so the WHOLE encoder is
# e(p) = p_bits @ A ^ e(0) for a fixed 2048 x 5200 bit matrix. The
# decoder's re-encode verification (FECDecoder.java:831-847) uses this
# form: one 0/1 matmul (exact in bf16) instead of the scan/scatter
# pipeline, bit-identical output.

_AFFINE_CACHE: dict = {}


def _encoder_affine_np():
    """(A [2048, 5200], e0 [5200]) uint8 with e(p) = p_bits @ A ^ e0 over
    GF(2), payload bits LSB-first per byte. Built once per process from
    2049 reference encodes (~5 s of host numpy, amortized; cached)."""
    if "A" not in _AFFINE_CACHE:
        from .ref_numpy import encode_fec40 as enc_np
        e0 = enc_np(np.zeros(256, np.uint8)).astype(np.uint8)
        a = np.empty((2048, SYMPBLOCK), np.uint8)
        p = np.zeros(256, np.uint8)
        for j in range(256):
            for b in range(8):
                p[j] = 1 << b
                a[j * 8 + b] = enc_np(p) ^ e0
                p[j] = 0
        _AFFINE_CACHE["A"] = a
        _AFFINE_CACHE["e0"] = e0
    return _AFFINE_CACHE["A"], _AFFINE_CACHE["e0"]


def encode_frame_affine(payload: jnp.ndarray) -> jnp.ndarray:
    """[..., 256] payload bytes -> [..., 5200] symbols, one bit-matmul.

    Bit-identical to :func:`encode_frame` (tested); preferred on the
    re-encode verify path where frames are batched."""
    a, e0 = _encoder_affine_np()
    bits = (payload[..., None].astype(jnp.int32) >> jnp.arange(8)) & 1
    bits = bits.reshape(*payload.shape[:-1], -1).astype(jnp.bfloat16)
    r = lax.dot_general(bits, jnp.asarray(a, jnp.bfloat16),
                        (((bits.ndim - 1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)
    return ((r.astype(jnp.int32) & 1)
            ^ jnp.asarray(e0, jnp.int32)).astype(jnp.uint8)
