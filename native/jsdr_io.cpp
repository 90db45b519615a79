// jsdr_tpu native IO kernels — the host-side data-loader hot path.
//
// The reference converts S16LE interleaved I/Q to normalized floats in a
// per-sample Java loop on the capture thread (JavaAudio.java:275-293,
// including the wrapping 16-bit DC correction). Feeding an accelerator at
// hundreds of MS/s makes this host loop a real bottleneck, so it lives here as
// vectorizable C++ (the compiler auto-vectorizes these simple loops).
//
// Build: make -C native   (produces libjsdr_io.so, loaded via ctypes;
// io/native.py runs this at first use)

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// Interleaved S16LE I/Q frames -> interleaved float32 (i, q) pairs,
// DC correction added as a wrapping int16 BEFORE the 1/32767 scale
// (JavaAudio.java:281-289 semantics).
void jsdr_s16le_iq_to_f32(const int16_t* in, size_t n_frames,
                          int16_t icorr, int16_t qcorr, float* out) {
    const float scale = 1.0f / 32767.0f;
    for (size_t n = 0; n < n_frames; ++n) {
        int16_t i = (int16_t)(in[2 * n] + icorr);      // wrapping add
        int16_t q = (int16_t)(in[2 * n + 1] + qcorr);
        out[2 * n] = (float)i * scale;
        out[2 * n + 1] = (float)q * scale;
    }
}

// Mono S16LE -> float32 pairs with Q = 0 (JavaAudio.java:285-291).
void jsdr_s16le_mono_to_f32(const int16_t* in, size_t n_frames,
                            int16_t icorr, float* out) {
    const float scale = 1.0f / 32767.0f;
    for (size_t n = 0; n < n_frames; ++n) {
        int16_t i = (int16_t)(in[n] + icorr);
        out[2 * n] = (float)i * scale;
        out[2 * n + 1] = 0.0f;
    }
}

// float32 (i, q) pairs -> S16LE frames with round-half-away + clamp
// (recorder / audio output path, demod.java:473-477).
void jsdr_f32_to_s16le(const float* in, size_t n_frames, int16_t* out) {
    for (size_t n = 0; n < 2 * n_frames; ++n) {
        float v = in[n] * 32767.0f;
        v = v < -32768.0f ? -32768.0f : (v > 32767.0f ? 32767.0f : v);
        out[n] = (int16_t)(v >= 0.0f ? v + 0.5f : v - 0.5f);
    }
}

// AO-40 de-interleave of one 5200-symbol frame into the 5132-symbol
// Viterbi input order (FECDecoder.java:707-723) — used by the host-side
// oracle path and fixture tools.
void jsdr_deinterleave_frame(const uint8_t* raw, uint8_t* symbols) {
    size_t k = 0;
    for (int col = 1; col < 80; ++col)
        for (int row = 0; row < 65; ++row) {
            if (k >= 5132) return;
            symbols[k++] = raw[(size_t)row * 80 + col];
        }
}

}  // extern "C"
