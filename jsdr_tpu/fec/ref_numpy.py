"""Host-side (numpy) AO-40 FEC codec: the framework's verification oracle.

Implements, with semantics matching the reference implementation
(FECDecoder.java), the full AO-40 telemetry codec:

- ``encode_fec40``: 256-byte payload -> 5200 channel symbols
  (FECDecoder.java:677-688 pipeline: RS parity, scramble, convolutional
  encode, block interleave, sync column)
- ``fec_decode``: 5200 soft symbols -> payload + channel-error count
  (FECDecoder.java:703-852: de-interleave, Viterbi, descramble, 2x RS,
  re-encode check)

This module is the *oracle and test-vector generator*; the device compute
path lives in :mod:`jsdr_tpu.fec.viterbi`, :mod:`jsdr_tpu.fec.rs` and
:mod:`jsdr_tpu.fec.decoder` as batched JAX kernels validated against it.
"""

from __future__ import annotations

import numpy as np

from .tables import (
    A0, ALPHA_TO, BLOCKSIZE, COLUMNS, CPOLYA, CPOLYB, FCR, INDEX_OF, IPRIM,
    KK, METTAB, NBITS, NN, NROOTS, PARTAB, PRIM, ROWS, RSBLOCKS, RSPAD,
    RS_POLY, SCRAMBLER, SYMPBLOCK, SYMS, SYNC_BITS,
)

# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

K_FLUSH = 6  # convolutional tail bits


def _gf_mul_log(log_a: int, log_b: int) -> int:
    """Multiply two GF(256) elements given in log form; A0 marks zero."""
    if log_a == A0 or log_b == A0:
        return 0
    return int(ALPHA_TO[(log_a + log_b) % 255])


def rs_parity(payload: np.ndarray) -> np.ndarray:
    """RS(255,223) parity for the two interleaved codewords.

    Returns shape [RSBLOCKS, NROOTS]. Byte i of the payload feeds
    codeword i & 1 (FECDecoder.java:614-655).
    """
    payload = np.asarray(payload, dtype=np.uint8)
    assert payload.shape == (BLOCKSIZE,)
    blocks = np.zeros((RSBLOCKS, NROOTS), dtype=np.int64)
    for n, c in enumerate(payload):
        rsi = n & 1
        reg = blocks[rsi]
        feedback = int(INDEX_OF[int(c) ^ int(reg[0])])
        if feedback != A0:
            # palindromic generator: taps j+1 and 31-j share a coefficient
            for j in range(15):
                t = _gf_mul_log(feedback, int(RS_POLY[j]))
                reg[j + 1] ^= t
                reg[31 - j] ^= t
            reg[16] ^= _gf_mul_log(feedback, int(RS_POLY[15]))
        reg[:31] = reg[1:]
        reg[31] = ALPHA_TO[feedback] if feedback != A0 else 0
    return blocks.astype(np.uint8)


def frame_bytes(payload: np.ndarray) -> np.ndarray:
    """The 320-byte scrambler-input sequence: payload then interleaved parity."""
    parity = rs_parity(payload)
    out = np.zeros(320, dtype=np.uint8)
    out[:BLOCKSIZE] = payload
    for n in range(BLOCKSIZE, 320):
        out[n] = parity[n & 1][(n - BLOCKSIZE) >> 1]
    return out


def encode_fec40(payload: np.ndarray) -> np.ndarray:
    """Encode a 256-byte payload into 5200 hard channel symbols (0/1).

    Symbol i is transmitted i-th; layout raw[row*80 + col] with the sync
    vector in column 0 (FECDecoder.java:549-605).
    """
    scrambled = frame_bytes(payload) ^ SCRAMBLER[:320].astype(np.uint8)
    # bits MSB-first, plus 6 flush zeros -> NBITS convolutional steps
    bits = np.unpackbits(scrambled)
    bits = np.concatenate([bits, np.zeros(K_FLUSH, dtype=np.uint8)])
    assert bits.shape == (NBITS,)
    # convolutional encode: shift register state after consuming bit t
    sr = 0
    syms = np.zeros(2 * NBITS, dtype=np.uint8)
    for t, b in enumerate(bits):
        sr = ((sr << 1) | int(b)) & 0x7F
        syms[2 * t] = PARTAB[sr & CPOLYA]
        syms[2 * t + 1] = 1 - PARTAB[sr & CPOLYB]
    # interleave: symbol stream fills columns 1.. of the 65x80 frame
    frame = np.zeros((COLUMNS, ROWS), dtype=np.uint8)
    frame[:, 0] = SYNC_BITS
    bindex = np.arange(2 * NBITS) + COLUMNS
    frame[bindex % COLUMNS, bindex // COLUMNS] = syms
    return frame.reshape(-1)


def symbols_to_soft(symbols: np.ndarray, one: int = 0xC0, zero: int = 0x40) -> np.ndarray:
    """Map hard symbols to the soft-byte convention used by the demodulator
    (FUNcubeBPSKDemod.java:562-564)."""
    return np.where(symbols > 0, one, zero).astype(np.uint8)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def deinterleave(raw: np.ndarray) -> np.ndarray:
    """5200 soft symbols -> 5132 de-interleaved symbols, sync column skipped
    (FECDecoder.java:707-723)."""
    raw = np.asarray(raw, dtype=np.uint8).reshape(COLUMNS, ROWS)
    # symbols[(col-1)*65 + row] = raw[row, col]  for col in 1..79
    return raw[:, 1:].T.reshape(-1)[: 2 * NBITS]


def viterbi27(symbols: np.ndarray) -> np.ndarray:
    """Soft-decision Viterbi decode, k=7 r=1/2 (FECDecoder.java:203-278).

    Input: 2*NBITS soft symbol bytes. Output: (NBITS-6)//8 = 320 bytes.
    State metrics are vectorized over the 64 states; the 2566 bit steps
    run as a host loop (the JAX path uses lax.scan instead).
    """
    symbols = np.asarray(symbols, dtype=np.uint8)
    n_even = np.arange(0, 64, 2)
    sym_a = SYMS[n_even]        # symbol pair for even new state (shift-in 0 path)
    sym_b = SYMS[n_even + 1]    # symbol pair for odd new state
    cmetric = np.full(64, -999999, dtype=np.int64)
    cmetric[0] = 0
    decisions = np.zeros((NBITS, 64), dtype=bool)
    for t in range(NBITS):
        s0 = int(symbols[2 * t])
        s1 = int(symbols[2 * t + 1])
        mets = METTAB[[0, 0, 1, 1], s0] + METTAB[[0, 1, 0, 1], s1]
        b1 = mets[sym_a]
        b2 = mets[sym_b]
        m_lo = cmetric[:32]
        m_hi = cmetric[32:]
        even_a = m_lo + b1
        even_b = m_hi + b2
        odd_a = m_lo + b2
        odd_b = m_hi + b1
        nmetric = np.empty(64, dtype=np.int64)
        nmetric[0::2] = np.maximum(even_a, even_b)
        nmetric[1::2] = np.maximum(odd_a, odd_b)
        decisions[t, 0::2] = even_b > even_a
        decisions[t, 1::2] = odd_b > odd_a
        cmetric = nmetric
    # chain-back from state 0 (FECDecoder.java:264-277)
    out_bits = np.zeros(NBITS, dtype=np.uint8)
    state = 0
    for i in range(NBITS - 7, -1, -1):
        dec = decisions[i + 6, state]
        if dec:
            out_bits[i] = 1
        state = (state >> 1) | (0x20 if dec else 0)
    return np.packbits(out_bits[: NBITS - K_FLUSH])


def descramble_demux(vitdec: np.ndarray) -> np.ndarray:
    """320 Viterbi-decoded bytes -> [2, 255] padded RS codewords
    (FECDecoder.java:763-771)."""
    vitdec = np.asarray(vitdec, dtype=np.uint8)
    rsblocks = np.zeros((RSBLOCKS, NN), dtype=np.uint8)
    unscrambled = vitdec ^ SCRAMBLER[:320].astype(np.uint8)
    rsblocks[:, RSPAD:] = unscrambled.reshape(NN - RSPAD, RSBLOCKS).T
    return rsblocks


def _mod255(x: int) -> int:
    return x % 255


def decode_rs_8(data: np.ndarray) -> tuple[np.ndarray, int]:
    """Decode one RS(255,223) codeword in place-sematics (returns corrected
    copy + error count, or -1 on failure). Berlekamp-Massey + Chien +
    Forney, no erasures (FECDecoder.java:325-519)."""
    data = np.asarray(data, dtype=np.uint8).copy()
    # syndromes: s_i = data(alpha^((FCR+i)*PRIM)) via Horner
    s = np.zeros(NROOTS, dtype=np.int64)
    for i in range(NROOTS):
        acc = int(data[0])
        mul = (FCR + i) * PRIM % 255
        for j in range(1, NN):
            if acc == 0:
                acc = int(data[j])
            else:
                acc = int(data[j]) ^ int(ALPHA_TO[(int(INDEX_OF[acc]) + mul) % 255])
        s[i] = acc
    if not s.any():
        return data, 0
    s_log = INDEX_OF[s]

    lam = np.zeros(NROOTS + 1, dtype=np.int64)
    lam[0] = 1
    b = INDEX_OF[lam].copy()
    el = 0
    for r in range(1, NROOTS + 1):
        discr = 0
        for i in range(r):
            if lam[i] != 0 and s_log[r - i - 1] != A0:
                discr ^= int(ALPHA_TO[(int(INDEX_OF[lam[i]]) + int(s_log[r - i - 1])) % 255])
        discr_log = int(INDEX_OF[discr])
        if discr_log == A0:
            b[1:] = b[:-1].copy()
            b[0] = A0
        else:
            t = np.zeros(NROOTS + 1, dtype=np.int64)
            t[0] = lam[0]
            for i in range(NROOTS):
                if b[i] != A0:
                    t[i + 1] = lam[i + 1] ^ int(ALPHA_TO[(discr_log + int(b[i])) % 255])
                else:
                    t[i + 1] = lam[i + 1]
            if 2 * el <= r - 1:
                el = r - el
                b = np.where(lam == 0, A0, (INDEX_OF[lam] - discr_log + NN) % 255)
            else:
                b[1:] = b[:-1].copy()
                b[0] = A0
            lam = t
    lam_log = INDEX_OF[lam]
    deg_lambda = int(np.max(np.nonzero(lam_log != A0)[0])) if (lam_log != A0).any() else 0

    # Chien search
    reg = lam_log.copy()
    roots, locs = [], []
    k = IPRIM - 1
    for i in range(1, NN + 1):
        q = 1
        for j in range(deg_lambda, 0, -1):
            if reg[j] != A0:
                reg[j] = (reg[j] + j) % 255
                q ^= int(ALPHA_TO[reg[j]])
        if q == 0:
            roots.append(i)
            locs.append(k)
            if len(roots) == deg_lambda:
                break
        k = (k + IPRIM) % 255
    if deg_lambda != len(roots):
        return data, -1

    # omega(x) = s(x)*lambda(x) mod x^NROOTS
    omega_log = np.full(NROOTS + 1, A0, dtype=np.int64)
    deg_omega = 0
    for i in range(NROOTS):
        tmp = 0
        for j in range(min(deg_lambda, i), -1, -1):
            if s_log[i - j] != A0 and lam_log[j] != A0:
                tmp ^= int(ALPHA_TO[(int(s_log[i - j]) + int(lam_log[j])) % 255])
        if tmp != 0:
            deg_omega = i
        omega_log[i] = INDEX_OF[tmp]

    # Forney error values
    for j in range(len(roots) - 1, -1, -1):
        num1 = 0
        for i in range(deg_omega, -1, -1):
            if omega_log[i] != A0:
                num1 ^= int(ALPHA_TO[(int(omega_log[i]) + i * roots[j]) % 255])
        num2 = int(ALPHA_TO[(roots[j] * (FCR - 1) + NN) % 255])
        den = 0
        for i in range(min(deg_lambda, NROOTS - 1) & ~1, -1, -2):
            if lam_log[i + 1] != A0:
                den ^= int(ALPHA_TO[(int(lam_log[i + 1]) + i * roots[j]) % 255])
        if den == 0:
            return data, -1
        if num1 != 0:
            data[locs[j]] ^= ALPHA_TO[
                (int(INDEX_OF[num1]) + int(INDEX_OF[num2]) + NN - int(INDEX_OF[den])) % 255
            ]
    return data, len(roots)


def fec_decode(raw: np.ndarray) -> tuple[np.ndarray, int]:
    """Full AO-40 frame decode (FECDecoder.java:703-852).

    Input: 5200 soft symbol bytes. Returns (payload[256], rc) where rc is
    the re-encoded channel-symbol error count on success or -1 on failure.
    """
    raw = np.asarray(raw, dtype=np.uint8)
    symbols = deinterleave(raw)
    vitdec = viterbi27(symbols)
    rsblocks = descramble_demux(vitdec)
    payload = np.zeros(BLOCKSIZE, dtype=np.uint8)
    ok = True
    corrected = []
    for row in range(RSBLOCKS):
        fixed, errs = decode_rs_8(rsblocks[row])
        corrected.append(fixed)
        if errs < 0:
            ok = False
    if not ok:
        return payload, -1
    payload = np.stack(corrected)[:, RSPAD:KK].T.reshape(-1)
    reenc = encode_fec40(payload)
    errors = int(np.count_nonzero(reenc != (raw >> 7)))
    return payload, errors
