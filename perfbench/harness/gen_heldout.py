"""Held-out evaluation domain: speech synthesis the models NEVER trained on
(numpy and scipy only; the same draws as the JAX package's
``train/heldout.py`` for the same ``rng`` state).

Every shipped weight (VAD, encoders, segmentation) was trained on
``train/synthetic.py``'s family — additive harmonic stacks with gaussian
formant envelopes and sinusoidal AM.  Scoring on that same family is
circular: it cannot reveal overfitting to the generator's idiosyncrasies.
This module synthesizes speech by a structurally different route, and it is
the only generator here with overlapped speech, which the overlap rescue
needs to be exercised at all:

* **source-filter (LPC-style) synthesis** — a glottal-pulse-train + noise
  excitation passed through a cascade of time-varying second-order formant
  resonators (true IIR filtering, not additive sinusoids), with jitter,
  shimmer, unvoiced fricative segments and plosive-like bursts;
* **room acoustics** — convolution with a synthetic exponentially-decaying
  room impulse response (configurable RT60);
* **additive noise** — white / pink / babble (a sum of many background
  source-filter voices) at a configurable SNR;
* **overlapping turns** — a configurable fraction of turn onsets start
  before the previous turn ends, for overlap-aware scoring.
"""
from __future__ import annotations

import numpy as np

from scipy.signal import lfilter


# ---------------------------------------------------------------------------
# source-filter voice synthesis
# ---------------------------------------------------------------------------

#: vowel-ish formant targets (F1, F2, F3) in Hz the filter glides between
_VOWEL_FORMANTS = np.array([
    [730.0, 1090.0, 2440.0],   # /a/
    [270.0, 2290.0, 3010.0],   # /i/
    [300.0, 870.0, 2240.0],    # /u/
    [530.0, 1840.0, 2480.0],   # /e/
    [570.0, 840.0, 2410.0],    # /o/
    [660.0, 1720.0, 2410.0],   # /ae/
])


def _glottal_pulse_train(
    rng: np.random.Generator, n: int, sr: int, f0: float,
    jitter: float = 0.02, shimmer: float = 0.1,
) -> np.ndarray:
    """Impulse-train excitation with per-period jitter (F0 perturbation) and
    shimmer (amplitude perturbation), lightly lowpassed into a glottal-ish
    pulse shape."""
    out = np.zeros(n, np.float64)
    pos = 0.0
    while pos < n:
        i = int(pos)
        if i < n:
            out[i] = 1.0 + shimmer * rng.standard_normal()
        period = sr / (f0 * (1.0 + jitter * rng.standard_normal()))
        pos += max(period, sr / 600.0)
    # differentiated-glottal-flow-ish shaping: leaky integrate then tilt
    out = lfilter([1.0], [1.0, -0.96], out)
    out = np.diff(out, prepend=0.0)
    return out


def _formant_filter(
    x: np.ndarray, sr: int, formants: np.ndarray, bandwidths: np.ndarray,
) -> np.ndarray:
    """Cascade of 2nd-order resonators at the given (static) formants."""
    y = x
    for fm, bw in zip(formants, bandwidths):
        r = np.exp(-np.pi * bw / sr)
        theta = 2.0 * np.pi * fm / sr
        a = [1.0, -2.0 * r * np.cos(theta), r * r]
        y = lfilter([1.0 - r], a, y)
    return y


def synth_voice_lpc(
    rng: np.random.Generator,
    dur_s: float,
    sr: int = 16000,
    f0: float | None = None,
    formant_shift: float | None = None,
    amp: float = 0.3,
) -> np.ndarray:
    """One speaker turn by source-filter synthesis: alternating voiced
    (glottal pulses through formant resonators gliding between vowel
    targets) and unvoiced (filtered-noise fricative) phones.

    ``formant_shift`` scales the vowel formant targets — the per-speaker
    vocal-tract-length cue (alongside ``f0``)."""
    n = int(dur_s * sr)
    f0 = f0 if f0 is not None else float(rng.uniform(85.0, 280.0))
    shift = formant_shift if formant_shift is not None else float(rng.uniform(0.85, 1.2))

    sig = np.zeros(n, np.float64)
    pos = 0
    while pos < n:
        phone_s = float(rng.uniform(0.06, 0.25))
        pn = min(int(phone_s * sr), n - pos)
        if pn <= 0:
            break
        voiced = rng.uniform() < 0.75
        if voiced:
            vowel = _VOWEL_FORMANTS[rng.integers(0, len(_VOWEL_FORMANTS))]
            formants = vowel * shift * rng.uniform(0.95, 1.05, size=3)
            bws = np.array([60.0, 90.0, 140.0]) * rng.uniform(0.8, 1.3)
            exc = _glottal_pulse_train(
                rng, pn, sr, f0 * float(rng.uniform(0.92, 1.08)))
            # breathiness: a little aspiration noise in the excitation
            exc = exc + 0.05 * rng.standard_normal(pn)
            phone = _formant_filter(exc, sr, formants, bws)
        else:
            # fricative: shaped noise high-passed around a random locus
            noise = rng.standard_normal(pn)
            locus = float(rng.uniform(2500.0, 6000.0))
            phone = _formant_filter(
                noise, sr, np.array([locus]), np.array([800.0]))
            if rng.uniform() < 0.3 and pn > 64:  # plosive-like onset burst
                phone[: 64] *= np.linspace(3.0, 1.0, 64)
            phone *= 0.35
        # Normalize each phone to a target RMS before the envelope: the
        # formant resonators' gain swings ~40 dB phone-to-phone depending on
        # whether an f0 harmonic lands on a narrow (60 Hz bw) formant peak,
        # and turn-level peak normalization then crushed everything but the
        # lucky phones to -70..-80 dBFS (measured: median speech frame
        # -74 dB, i.e. most labeled "speech" was effectively silence).  Real
        # speech varies ~6-10 dB phone to phone.
        rms = float(np.sqrt(np.mean(phone**2))) + 1e-9
        target_db = (rng.uniform(-22.0, -14.0) if voiced
                     else rng.uniform(-30.0, -22.0))
        phone = phone * (10.0 ** (target_db / 20.0) / rms)
        # phone-level amplitude envelope (attack/decay)
        ramp = min(pn // 4, int(0.02 * sr)) or 1
        env = np.ones(pn)
        env[:ramp] = np.linspace(0.0, 1.0, ramp)
        env[-ramp:] = np.linspace(1.0, 0.0, ramp)
        sig[pos : pos + pn] += phone * env
        pos += pn
    peak = np.abs(sig).max() + 1e-9
    return (sig / peak * amp).astype(np.float32)


# ---------------------------------------------------------------------------
# acoustics: reverb + noise
# ---------------------------------------------------------------------------

def synth_rir(
    rng: np.random.Generator, sr: int = 16000, rt60_s: float = 0.4,
    direct_ratio: float = 0.7,
) -> np.ndarray:
    """Synthetic room impulse response: unit direct path + exponentially
    decaying gaussian tail (the statistical late-reverb model)."""
    n = max(int(rt60_s * sr), 1)
    t = np.arange(n) / sr
    decay = np.exp(-6.908 * t / max(rt60_s, 1e-3))  # -60 dB at rt60
    tail = rng.standard_normal(n) * decay
    tail[0] = 0.0
    tail = tail / (np.abs(tail).sum() + 1e-9) * (1.0 - direct_ratio) * 8.0
    rir = np.zeros(n, np.float64)
    rir[0] = direct_ratio
    rir += tail
    return rir.astype(np.float32)


def apply_reverb(wave: np.ndarray, rir: np.ndarray) -> np.ndarray:
    from scipy.signal import fftconvolve

    n = len(wave)
    out = fftconvolve(wave.astype(np.float64), rir.astype(np.float64))[:n]
    peak_in = np.abs(wave).max() + 1e-9
    peak_out = np.abs(out).max() + 1e-9
    return (out * (peak_in / peak_out)).astype(np.float32)


def synth_babble(
    rng: np.random.Generator, dur_s: float, sr: int = 16000, n_voices: int = 6,
) -> np.ndarray:
    """Babble: many overlapping background voices from the same source-filter
    family, summed into a speech-shaped but unintelligible bed."""
    n = int(dur_s * sr)
    mix = np.zeros(n, np.float64)
    for _ in range(n_voices):
        v = np.zeros(n, np.float64)
        pos = int(rng.uniform(0, sr * 0.5))
        while pos < n:
            turn = synth_voice_lpc(rng, float(rng.uniform(0.5, 2.0)), sr)
            end = min(pos + len(turn), n)
            v[pos:end] += turn[: end - pos]
            pos = end + int(rng.uniform(0.0, 0.6) * sr)
        mix += v
    mix = mix / (np.abs(mix).max() + 1e-9)
    return mix.astype(np.float32)


def add_noise_at_snr(
    rng: np.random.Generator, wave: np.ndarray, noise: np.ndarray, snr_db: float,
) -> np.ndarray:
    """Mix ``noise`` under ``wave`` at the given active-speech SNR."""
    n = len(wave)
    if len(noise) < n:
        noise = np.tile(noise, -(-n // len(noise)))
    noise = noise[:n].astype(np.float64)
    # active-speech power (ignore silence so SNR refers to speech level)
    frame = 400
    nf = n // frame
    if nf > 0:
        p = (wave[: nf * frame].astype(np.float64) ** 2).reshape(nf, frame).mean(1)
        active = p[p > 0.1 * (p.max() + 1e-12)]
        sig_pow = float(active.mean()) if len(active) else float(p.mean() + 1e-12)
    else:
        sig_pow = float(np.mean(wave.astype(np.float64) ** 2) + 1e-12)
    noise_pow = float(np.mean(noise ** 2) + 1e-12)
    gain = np.sqrt(sig_pow / (noise_pow * 10.0 ** (snr_db / 10.0)))
    out = wave.astype(np.float64) + gain * noise
    peak = np.abs(out).max()
    if peak > 0.99:
        out *= 0.99 / peak
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# conversations
# ---------------------------------------------------------------------------

def make_heldout_speaker_bank(rng: np.random.Generator, n_speakers: int):
    """Per-speaker (f0, vocal-tract formant shift) profiles, spaced apart so
    speaker identity is physically present in the signal (as in any real
    meeting — distinguishing them is the encoder's job)."""
    f0s = rng.permutation(np.linspace(95.0, 260.0, n_speakers))
    shifts = rng.permutation(np.linspace(0.88, 1.18, n_speakers))
    return [
        {"f0": float(f0s[k] * rng.uniform(0.98, 1.02)),
         "shift": float(shifts[k] * rng.uniform(0.99, 1.01))}
        for k in range(n_speakers)
    ]


def make_conversation_heldout(
    rng: np.random.Generator,
    duration_s: float,
    n_speakers: int = 3,
    sr: int = 16000,
    turn_s: tuple[float, float] = (2.0, 6.0),
    gap_s: tuple[float, float] = (0.3, 0.8),
    rt60_s: float | None = None,
    snr_db: float | None = None,
    noise_kind: str = "babble",
    overlap_frac: float = 0.0,
    overlap_s: tuple[float, float] = (0.3, 1.5),
):
    """Ground-truthed conversation in the held-out domain.

    ``rt60_s``: convolve the dry mixture with a synthetic RIR.
    ``snr_db``: add ``noise_kind`` ('babble' | 'white' | 'pink') at that SNR.
    ``overlap_frac``: this fraction of turns starts before the previous turn
    ends (by ``overlap_s`` seconds), producing genuine overlapping speech in
    both signal and truth.

    Returns ``(wave [T], (starts, ends, spks))`` like
    :func:`~.synthetic.make_conversation`.
    """
    bank = make_heldout_speaker_bank(rng, n_speakers)
    n = int(duration_s * sr)
    wave = np.zeros(n, np.float64)
    starts, ends, spks = [], [], []
    t0 = 0.0
    prev = -1
    while t0 < duration_s - 0.5:
        overlap = bool(starts) and rng.uniform() < overlap_frac
        if overlap:
            t_start = max(ends[-1] - float(rng.uniform(*overlap_s)), starts[-1])
        else:
            t_start = t0 + float(rng.uniform(*gap_s))
        if t_start >= duration_s - 0.5:
            break
        spk = int(rng.integers(0, n_speakers))
        if n_speakers > 1 and spk == prev:
            spk = (spk + 1) % n_speakers
        prev = spk
        dur = min(float(rng.uniform(*turn_s)), duration_s - t_start)
        if dur < 0.5:
            break
        prof = bank[spk]
        turn = synth_voice_lpc(rng, dur, sr, f0=prof["f0"],
                               formant_shift=prof["shift"])
        i0 = int(t_start * sr)
        i1 = min(i0 + len(turn), n)
        wave[i0:i1] += turn[: i1 - i0]
        starts.append(t_start)
        ends.append(t_start + (i1 - i0) / sr)
        spks.append(spk)
        t0 = max(t0, ends[-1])

    peak = np.abs(wave).max() + 1e-9
    wave = (wave / peak * 0.4).astype(np.float32)

    if rt60_s is not None and rt60_s > 0:
        wave = apply_reverb(wave, synth_rir(rng, sr, rt60_s))
    if snr_db is not None:
        if noise_kind == "babble":
            noise = synth_babble(rng, min(duration_s, 20.0), sr)
        elif noise_kind == "pink":
            w = rng.standard_normal(n)
            noise = lfilter([1.0], [1.0, -0.9], w).astype(np.float32)
        else:
            noise = rng.standard_normal(n).astype(np.float32)
        wave = add_noise_at_snr(rng, wave, noise, snr_db)
    else:
        wave = wave + (1e-4 * rng.standard_normal(n)).astype(np.float32)

    return wave.astype(np.float32), (
        np.asarray(starts, np.float64),
        np.asarray(ends, np.float64),
        np.asarray(spks, np.int32),
    )


# The domains of the JAX package's ``scripts/eval_heldout.py``, in its order:
# the in-domain generator for contrast, then the held-out synthesis dry, in
# two rooms, under babble at 15 and 5 dB and white noise at 10 dB, and with
# 30 % of the turns overlapping the previous one.
HELDOUT_DOMAINS = {
    "indomain": None,
    "heldout-dry": {},
    "heldout-reverb3": {"rt60_s": 0.3},
    "heldout-reverb6": {"rt60_s": 0.6},
    "heldout-babble15": {"snr_db": 15.0, "noise_kind": "babble"},
    "heldout-babble5": {"snr_db": 5.0, "noise_kind": "babble"},
    "heldout-white10": {"snr_db": 10.0, "noise_kind": "white"},
    "heldout-overlap": {"overlap_frac": 0.3},
}


def make_domain_file(domain: str, index: int, dur_s: float = 60.0,
                     n_speakers: int = 3, sr: int = 16000):
    """File ``index`` of a held-out table domain, drawn from
    ``default_rng(1000 + index)`` as ``eval_heldout.py::make_file`` draws
    it -> ``(wave, (starts, ends, spks))``."""
    rng = np.random.default_rng(1000 + index)
    kw = HELDOUT_DOMAINS[domain]
    if kw is None:
        from .gen_synthetic import make_conversation

        return make_conversation(rng, dur_s, n_speakers=n_speakers, sr=sr)
    return make_conversation_heldout(rng, dur_s, n_speakers=n_speakers, sr=sr,
                                     **kw)
