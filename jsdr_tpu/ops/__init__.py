"""Compute kernels: windows, FFT/PSD spectrum, FIR design & application,
NCO/mixers. These replace the reference's JTransforms calls and per-sample
Java loops (fft.java, demod.java, FUNcubeBPSKDemod.java, fir.java) with
batched XLA ops."""

from .windows import hamming  # noqa: F401
from .fir import (  # noqa: F401
    bandpass_weights, fir_apply, fir_apply_streaming, polyphase_decimate,
)
from .nco import SINCOS_SIZE, quantized_cos_sin, phase_ramp  # noqa: F401
from .spectrum import psd_dbfs, spectrum_block, SpectrumResult  # noqa: F401
