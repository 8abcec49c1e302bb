"""Channel simulator: AWGN, delay, carrier offset, multipath — jax-native.

Replaces the reference's Box-Muller AWGN harness (awgn.cc) for BER testing;
exact noise-sample parity is not required (SURVEY §7.6), only calibrated
statistics. Batched: every frame in the batch gets independent noise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def awgn_passband(key, frame: jnp.ndarray, sigma: float, delay: int,
                  buffer_len: int, fill: str = "noise") -> jnp.ndarray:
    """Place a passband frame into a capture buffer at `delay` and add white
    noise of std `sigma` (matching the reference's apply_with_delay semantics:
    noise everywhere, frame superimposed from `delay`).

    frame: [B, n]; returns [B, buffer_len].
    """
    b, n = frame.shape
    noise = sigma * jax.random.normal(key, (b, buffer_len), dtype=frame.dtype)
    buf = noise
    if fill == "signal":  # reference pads the delay region with random signal samples
        k2 = jax.random.fold_in(key, 1)
        idx = jax.random.randint(k2, (b, delay), 0, n)
        buf = buf.at[:, :delay].add(jnp.take_along_axis(frame, idx, axis=1))
    return buf.at[:, delay:delay + n].add(frame)


def shift_carrier(pb: jnp.ndarray, fs: float, offset_hz) -> jnp.ndarray:
    """Real passband [B, n] with every row's spectrum moved by offset_hz[b]
    (a carrier offset): the analytic signal times e^{j*2*pi*f*t}, real
    part. Exact for any offset, unlike apply_cfo's whole-bin roll."""
    n = pb.shape[-1]
    h = np.zeros(n)
    h[0] = 1.0
    h[1: (n + 1) // 2] = 2.0
    if n % 2 == 0:
        h[n // 2] = 1.0
    xa = jnp.fft.ifft(jnp.fft.fft(pb, axis=-1) * h, axis=-1)
    t = jnp.arange(n, dtype=pb.dtype) / fs
    f = jnp.asarray(offset_hz, pb.dtype).reshape(-1, 1)
    return jnp.real(xa * jnp.exp(2j * np.pi * f * t)).astype(pb.dtype)


def capture_batch(key, frames: jnp.ndarray, delays, buffer_len: int,
                  sigma: float, fs: float = 48000.0,
                  cfo_hz=None) -> jnp.ndarray:
    """Capture windows [B, buffer_len]: frame b placed at delays[b] in
    silence, optionally shifted by a carrier offset cfo_hz[b]
    (shift_carrier), plus white noise of std sigma everywhere — the
    per-row generalization of awgn_passband."""
    frames = jnp.asarray(frames)
    b, n = frames.shape
    zero = jnp.zeros((buffer_len,), frames.dtype)
    buf = jax.vmap(lambda f, d: jax.lax.dynamic_update_slice(zero, f, (d,)))(
        frames, jnp.asarray(delays, jnp.int32))
    if cfo_hz is not None:
        buf = shift_carrier(buf, fs, cfo_hz)
    return buf + sigma * jax.random.normal(key, (b, buffer_len), frames.dtype)


def sigma_for_esn0(esn0_db: float) -> float:
    """OFDM convention (reference passband_test_EsN0): sigma = 10^(-EsN0/20).
    The reference adds noise with amplitude sigma/sqrt(2) per real sample."""
    return 10 ** (-esn0_db / 20.0) / np.sqrt(2.0)


def sigma_for_channel_snr(frame: np.ndarray, snr_db: float, fs: float,
                          bandwidth: float) -> float:
    """MFSK convention (reference: telecom_system.cc:271-288): calibrate noise
    so that in-band SNR = P_signal / (P_noise_total * BW/f_nyquist)."""
    p_sig = float(np.mean(np.asarray(frame) ** 2))
    f_nyq = fs / 2.0
    sigma = np.sqrt(2.0 * p_sig * f_nyq / (10 ** (snr_db / 10.0) * bandwidth))
    return sigma / np.sqrt(2.0)


def apply_cfo(pb: jnp.ndarray, fs: float, fc: float, offset_hz: float) -> jnp.ndarray:
    """Shift the carrier of a real passband signal by mixing down at fc and
    up at fc+offset (test-harness equivalent of the reference's -f flag)."""
    n = pb.shape[-1]
    x = jnp.fft.fft(pb, axis=-1)
    freqs = jnp.fft.fftfreq(n, 1 / fs)
    # frequency-domain shift: positive-frequency content moves by +offset,
    # negative by -offset (keeps the signal real)
    k = int(round(offset_hz * n / fs))
    pos = freqs > 0
    xs = jnp.where(pos, jnp.roll(x, k, axis=-1), jnp.roll(x, -k, axis=-1))
    return jnp.real(jnp.fft.ifft(xs, axis=-1))


def multipath(pb: jnp.ndarray, taps_delay_samples, taps_gain) -> jnp.ndarray:
    """Static multipath: sum of delayed/scaled copies."""
    out = jnp.zeros_like(pb)
    for d, a in zip(taps_delay_samples, taps_gain):
        out = out + a * jnp.pad(pb, [(0, 0)] * (pb.ndim - 1) + [(d, 0)])[..., : pb.shape[-1]]
    return out


def _hilbert(x: np.ndarray) -> np.ndarray:
    """Analytic signal via FFT (host)."""
    n = x.shape[-1]
    xf = np.fft.fft(x, axis=-1)
    h = np.zeros(n)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1: n // 2] = 2
    else:
        h[1: (n + 1) // 2] = 2
    return np.fft.ifft(xf * h, axis=-1)


def _fading_process(n: int, fs: float, doppler_hz: float,
                    rng: np.random.Generator) -> np.ndarray:
    """Complex Gaussian fading gain with a Gaussian Doppler spectrum of
    std `doppler_hz` (the Watterson model's magnetoionic-component shape),
    unit mean power."""
    # synthesize at a low rate then interpolate to the sample rate
    fs_low = max(doppler_hz * 64.0, 8.0)
    n_low = int(np.ceil(n * fs_low / fs)) + 2
    spec_f = np.fft.fftfreq(4 * n_low, 1 / fs_low)
    shape = np.exp(-0.5 * (spec_f / max(doppler_hz, 1e-3)) ** 2)
    noise = (rng.standard_normal(4 * n_low) + 1j * rng.standard_normal(4 * n_low))
    proc = np.fft.ifft(np.fft.fft(noise) * shape)
    proc = proc[n_low: 2 * n_low]
    proc /= np.sqrt(np.mean(np.abs(proc) ** 2))
    t_low = np.arange(n_low) / fs_low
    t = np.arange(n) / fs
    return (np.interp(t, t_low, proc.real) + 1j * np.interp(t, t_low, proc.imag))


def watterson(pb: np.ndarray, fs: float = 48000.0, delay_ms: float = 1.0,
              doppler_hz: float = 0.5, seed: int = 0) -> np.ndarray:
    """Watterson HF ionospheric channel: two independent Rayleigh-fading
    paths (Gaussian Doppler spectra) separated by `delay_ms`, equal mean
    power, applied to a real passband signal via its analytic representation.

    CCIR 520 presets: good=(0.5 ms, 0.1 Hz), moderate=(1 ms, 0.5 Hz),
    poor=(2 ms, 1 Hz). Host-side numpy (fading synthesis is trivial next to
    the demod); batched over leading axes.
    """
    pb = np.asarray(pb, dtype=np.float64)
    squeeze = pb.ndim == 1
    if squeeze:
        pb = pb[None]
    b, n = pb.shape
    d = int(round(delay_ms * 1e-3 * fs))
    out = np.empty_like(pb)
    for i in range(b):
        rng = np.random.default_rng(seed + 7919 * i)
        xa = _hilbert(pb[i])
        h0 = _fading_process(n, fs, doppler_hz, rng) / np.sqrt(2.0)
        h1 = _fading_process(n, fs, doppler_hz, rng) / np.sqrt(2.0)
        delayed = np.concatenate([np.zeros(d, complex), xa[: n - d]])
        out[i] = np.real(h0 * xa + h1 * delayed)
    return out[0] if squeeze else out


WATTERSON_PRESETS = {
    "good": dict(delay_ms=0.5, doppler_hz=0.1),
    "moderate": dict(delay_ms=1.0, doppler_hz=0.5),
    "poor": dict(delay_ms=2.0, doppler_hz=1.0),
}
