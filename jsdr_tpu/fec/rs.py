"""Batched JAX decoder for the AO-40 shortened RS(255,223) code.

Re-design of the scalar decoder at FECDecoder.java:325-519 into fixed-shape,
branchless array code so it jits and vmaps over codewords and frames:

- syndromes and the Chien sweep as **bit-matmuls**: multiplying a
  GF(256) element by a CONSTANT is linear over GF(2), so evaluating the
  received word (or the error locator) at fixed field points is one 0/1
  matrix product — [.., 2040 data bits] @ [2040, 256 syndrome bits] and
  [.., 264 lambda bits] @ [264, 2040 eval bits] — exact as one bf16
  product (0/1 operands, f32 accumulation) and reduced mod 2. It
  replaces log-add-antilog gathers of 4.2M/4.3M elements per frame;
  whether the gather form is faster on the GPU is ROADMAP D3.
- Berlekamp-Massey as a 32-step ``fori_loop`` with masked updates
  (data-dependent in both operands — not constant-linear, stays gathers)
- Forney evaluation vectorized over the (up to 32) roots

GF(256) elements are carried as int32; A0 (=255) marks log(0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .tables import A0, ALPHA_TO, FCR, INDEX_OF, IPRIM, NN, NROOTS, PRIM

# Host-side numpy tables; jnp.asarray at use sites bakes them in at trace
# time (no eager device arrays at import — see viterbi.py note).
_ALPHA_NP = np.asarray(ALPHA_TO, dtype=np.int32)   # [256], entry 255 unused->0
_INDEX_NP = np.asarray(INDEX_OF, dtype=np.int32)   # [256], log(0) = A0

# 256-entry lookups as [16]x[16] nibble bilinear forms (one-hot(hi) @
# TABLE + a 16-lane masked reduce) instead of dynamic gathers (whether
# the gather is faster on the GPU is ROADMAP D3). Every entry of both
# tables is an 8-bit value (<= 255) and each output sums ONE nonzero
# product, so the DEFAULT-precision dot is EXACT whether the backend
# rounds its f32 operands to bf16 (8 significant bits) or to TF32 (11)
# or keeps them (unlike METTAB in viterbi.py, whose 9-significant-bit
# entries force HIGHEST there); an exhaustive all-256-inputs test pins
# this.
_ALPHA_SQ = _ALPHA_NP.reshape(16, 16).astype(np.float32)
_INDEX_SQ = _INDEX_NP.reshape(16, 16).astype(np.float32)


def _lookup256(table_sq: np.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    oh_hi = (((x >> 4) & 15)[..., None] == jnp.arange(16)
             ).astype(jnp.float32)
    rows = jnp.dot(oh_hi, jnp.asarray(table_sq),
                   preferred_element_type=jnp.float32)
    oh_lo = (x & 15)[..., None] == jnp.arange(16)
    return jnp.sum(jnp.where(oh_lo, rows, 0.0), axis=-1).astype(jnp.int32)


def _alpha(i):
    return _lookup256(_ALPHA_SQ, i)


def _index(i):
    return _lookup256(_INDEX_SQ, i)

# Syndrome power matrix: P[i, j] = ((FCR+i)*PRIM * (NN-1-j)) % 255 so that
# s_i = XOR_j gfmul(data[j], alpha^P[i,j])  (Horner form at FECDecoder.java:336-347)
_SYND_POW = np.asarray(
    (np.outer((FCR + np.arange(NROOTS)) * PRIM, NN - 1 - np.arange(NN))) % 255,
    dtype=np.int32,
)


def _gfmul_log(log_a: jnp.ndarray, log_b: jnp.ndarray) -> jnp.ndarray:
    """alpha^log_a * alpha^log_b with A0 marking zero operands."""
    zero = (log_a == A0) | (log_b == A0)
    return jnp.where(zero, 0, _alpha((log_a + log_b) % 255))


# --- GF(2) bit-matmul machinery (see module docstring) ---------------------

def _gf_constmul_bits(consts: np.ndarray) -> np.ndarray:
    """Bit matrix of y_i = XOR_j gfmul(x_j, consts[j, i]).

    consts: [J, I] nonzero GF elements. Returns [8J, 8I] uint8 whose
    (j, i) 8x8 block is the GF(2) matrix of multiplication by
    consts[j, i] (bits LSB-first)."""
    blog = np.asarray(INDEX_OF)[1 << np.arange(8)]         # [8]
    prod = _ALPHA_NP[(blog[:, None, None]
                      + np.asarray(INDEX_OF)[consts][None]) % 255]
    bits = (prod[..., None] >> np.arange(8)) & 1           # [8, J, I, 8]
    J, I = consts.shape
    return bits.transpose(1, 0, 2, 3).reshape(8 * J, 8 * I).astype(np.uint8)


_M_SYND = _gf_constmul_bits(_ALPHA_NP[_SYND_POW.T])        # [2040, 256]
_M_CHIEN = _gf_constmul_bits(_ALPHA_NP[
    (np.arange(1, NN + 1)[:, None]
     * np.arange(NROOTS + 1)[None, :]).T % 255])           # [264, 2040]


def _bytes_to_bits(x: jnp.ndarray) -> jnp.ndarray:
    """[..., N] bytes -> [..., 8N] f32 bits, LSB-first per byte."""
    b = (x[..., None].astype(jnp.int32) >> jnp.arange(8)) & 1
    return b.reshape(*x.shape[:-1], -1).astype(jnp.float32)


def _bits_to_bytes(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., 8N] int bits -> [..., N] int32 bytes (LSB-first)."""
    b = bits.reshape(*bits.shape[:-1], -1, 8).astype(jnp.int32)
    return (b << jnp.arange(8)).sum(-1)


def _bitmat(x_bits: jnp.ndarray, m_np: np.ndarray) -> jnp.ndarray:
    """0/1 matmul reduced mod 2 — one bf16 product, exact (0/1 operands
    multiply exactly in bf16; accumulation is f32)."""
    r = lax.dot_general(
        x_bits.astype(jnp.bfloat16), jnp.asarray(m_np, jnp.bfloat16),
        (((x_bits.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return r.astype(jnp.int32) & 1


def syndromes(data: jnp.ndarray) -> jnp.ndarray:
    """[..., 255] codeword bytes -> [..., 32] syndromes (poly form)."""
    return _bits_to_bytes(_bitmat(_bytes_to_bits(data), _M_SYND))


def _berlekamp_massey(s_log: jnp.ndarray) -> jnp.ndarray:
    """Error locator polynomial from syndromes (log form input).

    s_log: [32] syndromes in log form. Returns lambda in poly form [33].
    Mirrors FECDecoder.java:385-427 with no erasures.
    """
    lam0 = jnp.zeros(NROOTS + 1, jnp.int32).at[0].set(1)
    b0 = jnp.full(NROOTS + 1, A0, jnp.int32).at[0].set(0)  # log form of lambda
    idx = jnp.arange(NROOTS + 1)

    def body(r, carry):
        lam, b, el = carry
        # discrepancy: XOR_{i<r} gfmul(lam[i], s[r-1-i])
        s_idx = jnp.clip(r - 1 - idx, 0, NROOTS - 1)
        terms = _gfmul_log(_index(lam), s_log[s_idx])
        terms = jnp.where(idx < r, terms, 0)
        discr = lax.reduce(terms, jnp.int32(0), lax.bitwise_xor, (0,))
        discr_log = _index(discr)
        no_update = discr_log == A0

        # t(x) = lambda(x) - discr * x * b(x)
        xb = jnp.concatenate([jnp.full((1,), A0, jnp.int32), b[:-1]])
        t = lam ^ _gfmul_log(jnp.full_like(xb, discr_log), xb)

        grow = (2 * el) <= (r - 1)
        new_el = jnp.where(no_update, el, jnp.where(grow, r - el, el))
        # b <- inv(discr)*lambda (log form) when growing, else x*b(x)
        b_shift = jnp.concatenate([jnp.full((1,), A0, jnp.int32), b[:-1]])
        b_scaled = jnp.where(lam == 0, A0, (_index(lam) - discr_log + NN) % 255)
        new_b = jnp.where(no_update, b_shift, jnp.where(grow, b_scaled, b_shift))
        new_lam = jnp.where(no_update, lam, t)
        return new_lam, new_b, new_el

    lam, _, _ = lax.fori_loop(1, NROOTS + 1, body, (lam0, b0, jnp.int32(0)))
    return lam


def _chien_forney(lam: jnp.ndarray, s_log: jnp.ndarray):
    """Find error locations and values; returns (err_xor[255], count, fail)."""
    lam_log = _index(lam)                             # [33]
    j_idx = jnp.arange(NROOTS + 1)
    present = lam_log != A0
    deg_lambda = jnp.max(jnp.where(present, j_idx, 0))

    # Chien: evaluate lambda at alpha^i for i = 1..255 — the points are
    # constants, so the sweep is one GF(2) bit-matmul (module docstring)
    q = _bits_to_bytes(_bitmat(_bytes_to_bits(lam), _M_CHIEN))   # [255]
    is_root = q == 0
    count = jnp.sum(is_root.astype(jnp.int32))
    # Java aborts the sweep once deg_lambda roots are found; a degree-d poly
    # cannot have more than d roots, so the full sweep gives the same set.
    fail = count != deg_lambda

    # gather up to NROOTS roots into fixed slots (jit-safe sized nonzero)
    (root_pos,) = jnp.nonzero(is_root, size=NROOTS, fill_value=-1)
    valid = root_pos >= 0
    roots = jnp.where(valid, root_pos + 1, 0).astype(jnp.int32)
    locs = (IPRIM - 1 + (roots - 1) * IPRIM) % 255

    # omega(x) = s(x) * lambda(x) mod x^NROOTS, in log form
    i_o = jnp.arange(NROOTS)[:, None]
    j_o = jnp.arange(NROOTS + 1)[None, :]
    terms = _gfmul_log(s_log[jnp.clip(i_o - j_o, 0, NROOTS - 1)], lam_log)
    terms = jnp.where(j_o <= i_o, terms, 0)
    omega = lax.reduce(terms, jnp.int32(0), lax.bitwise_xor, (1,))   # [32] poly
    omega_log = _index(omega)

    # Forney: error value at each root
    r = roots[:, None]                                            # [32, 1]
    num_t = _gfmul_log(omega_log[None, :], (jnp.arange(NROOTS)[None, :] * r) % 255)
    num1 = lax.reduce(num_t, jnp.int32(0), lax.bitwise_xor, (1,))  # [32]
    num2 = _alpha((roots * (FCR - 1) + NN) % 255)
    # formal derivative: odd coefficients of lambda
    d_j = jnp.arange(0, NROOTS, 2)[None, :]                       # even i
    den_t = _gfmul_log(lam_log[None, 1::2][:, : d_j.shape[1]], (d_j * r) % 255)
    den = lax.reduce(den_t, jnp.int32(0), lax.bitwise_xor, (1,))  # [32]
    den_fail = jnp.any(valid & (den == 0))

    mag_log = (_index(num1) + _index(num2) + NN - _index(den)) % 255
    mag = jnp.where(valid & (num1 != 0) & (den != 0), _alpha(mag_log), 0)

    # invalid slots are redirected out of bounds and dropped by the scatter
    err = jnp.zeros(NN, jnp.int32)
    err = err.at[jnp.where(valid, locs, NN)].set(mag, mode="drop")
    return err, count, fail | den_fail


def decode_rs_codeword(data: jnp.ndarray):
    """Decode one 255-byte codeword.

    Returns (corrected[255] uint8, n_errors int32) with n_errors = -1 on
    uncorrectable error, matching decode_rs_8 (FECDecoder.java:325-519).
    """
    s = syndromes(data)
    clean = ~jnp.any(s != 0)
    s_log = _index(s)
    lam = _berlekamp_massey(s_log)
    err, count, fail = _chien_forney(lam, s_log)
    corrected = (data.astype(jnp.int32) ^ err).astype(jnp.uint8)
    n_err = jnp.where(clean, 0, jnp.where(fail, -1, count))
    corrected = jnp.where(clean | fail, data.astype(jnp.uint8), corrected)
    return corrected, n_err


@jax.jit
def decode_rs(data: jnp.ndarray):
    """Batched RS decode: [..., 255] -> (corrected [..., 255], n_errors [...])."""
    fn = decode_rs_codeword
    for _ in range(data.ndim - 1):
        fn = jax.vmap(fn)
    return fn(data)
