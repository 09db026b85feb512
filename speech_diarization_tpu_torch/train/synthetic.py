"""Synthetic ground-truthed conversations (numpy), the generator the
shipped weights were trained on and the bench draws its files from.

"Speech-like" signals are harmonic stacks with a drifting F0, formant-shaped
spectral envelopes and 2–8 Hz syllabic amplitude modulation; each synthetic
speaker has its own F0/formant profile.  Same draws as the JAX package's
``train/synthetic.py`` for the same ``rng`` state.
"""
from __future__ import annotations

import numpy as np


def synth_speech_like(
    rng: np.random.Generator,
    dur_s: float,
    sr: int = 16000,
    f0: float | None = None,
    formants: np.ndarray | None = None,
    amp: float = 0.3,
) -> np.ndarray:
    n = int(dur_s * sr)
    t = np.arange(n) / sr
    f0 = f0 if f0 is not None else rng.uniform(90.0, 300.0)
    # slow pitch drift +-15%
    drift = 1.0 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.2, 0.7) * t + rng.uniform(0, 6))
    phase = 2 * np.pi * np.cumsum(f0 * drift) / sr
    if formants is None:
        formants = rng.uniform([300, 900, 2200], [900, 2300, 3500])
    sig = np.zeros(n)
    n_harm = int((sr / 2 - 200) // f0)
    for h in range(1, min(n_harm, 40) + 1):
        fh = f0 * h
        # formant-shaped envelope: sum of gaussian resonances + tilt
        env = sum(np.exp(-0.5 * ((fh - fm) / 250.0) ** 2) for fm in formants)
        env = (0.1 + env) * (1.0 / h ** 0.5)
        sig += env * np.sin(h * phase + rng.uniform(0, 6.28))
    # syllabic amplitude modulation with pauses
    mod = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.0, 8.0) * t + rng.uniform(0, 6))
    sig = sig * mod
    sig = sig / (np.abs(sig).max() + 1e-9) * amp
    return sig.astype(np.float32)


def make_conversation(
    rng: np.random.Generator,
    duration_s: float,
    n_speakers: int = 3,
    sr: int = 16000,
    turn_s: tuple[float, float] = (2.0, 6.0),
    gap_s: tuple[float, float] = (0.3, 0.8),
    noise_amp: float = 0.01,
):
    """Ground-truthed multi-speaker conversation of speech-like turns.

    Alternating speakers from a fixed (f0, formant) bank with silence gaps —
    the speech-like analog of the tone conversations in
    scripts/eval_synthetic.py, suitable for the *neural* VAD (which is
    trained on synth_speech_like positives, not tones).

    Returns ``(wave [T], (starts, ends, spks) float/int arrays)``.
    """
    bank = make_speaker_bank(rng, n_speakers)
    parts, starts, ends, spks = [], [], [], []
    t0 = 0.0
    prev = -1
    floor = float(rng.uniform(1e-4, 3e-3))  # sensor-noise floor in the gaps
    while t0 < duration_s:
        gap = float(rng.uniform(*gap_s))
        parts.append((floor * rng.standard_normal(int(gap * sr))).astype(np.float32))
        t0 += gap
        if t0 >= duration_s:
            break
        spk = int(rng.integers(0, n_speakers))
        if n_speakers > 1 and spk == prev:
            spk = (spk + 1) % n_speakers
        prev = spk
        dur = min(float(rng.uniform(*turn_s)), duration_s - t0)
        if dur < 0.5:
            break
        prof = bank[spk]
        w = synth_speech_like(
            rng, dur, sr,
            f0=prof["f0"] * float(rng.uniform(0.97, 1.03)),
            formants=prof["formants"],
        )
        w = w + noise_amp * rng.standard_normal(len(w)).astype(np.float32)
        parts.append(w.astype(np.float32))
        starts.append(t0)
        ends.append(t0 + len(w) / sr)
        spks.append(spk)
        t0 += len(w) / sr
    wave = np.concatenate(parts) if parts else np.zeros(int(duration_s * sr), np.float32)
    n = int(duration_s * sr)
    wave = np.pad(wave[:n], (0, max(0, n - len(wave))))
    return wave, (
        np.asarray(starts, np.float64),
        np.asarray(ends, np.float64),
        np.asarray(spks, np.int32),
    )


def make_speaker_bank(rng: np.random.Generator, n_speakers: int):
    """Fixed per-speaker (f0, formants) profiles for speaker-ID training."""
    return [
        {
            "f0": float(rng.uniform(90, 300)),
            "formants": rng.uniform([300, 900, 2200], [900, 2300, 3500]),
        }
        for _ in range(n_speakers)
    ]
