"""Synthetic ground-truthed conversations (numpy), the generator the
shipped weights were trained on and the bench draws its files from.

"Speech-like" signals are harmonic stacks with a drifting F0, formant-shaped
spectral envelopes and 2–8 Hz syllabic amplitude modulation; each synthetic
speaker has its own F0/formant profile.  Same draws as the JAX package's
``train/synthetic.py`` for the same ``rng`` state.

The training examples of the recipes (``train/recipes.py``) come from here
too: VAD spans of speech and noise, overlapping segmentation chunks,
speaker batches and stereo demix mixtures.
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


def make_tone_conversation(seed: int, n_speakers: int = 3, turns: int = 8,
                           sr: int = 16000):
    """Ground-truthed tone conversation: alternating AM-modulated sines at
    speaker-distinct carriers with silence gaps, drawn in the JAX package's
    order (per turn: the speaker, the gap, the duration, then the noise), so
    a seed gives the same wave and truth in both packages.

    Returns ``(wave [T], (starts, ends, spks))``.
    """
    g = np.random.default_rng(seed)
    freqs = [180.0, 850.0, 2400.0, 420.0][:n_speakers]
    parts, starts, ends, spks = [], [], [], []
    t0 = 0.0
    for _ in range(turns):
        spk = int(g.integers(0, n_speakers))
        gap = g.uniform(0.4, 0.8)
        parts.append(np.zeros(int(gap * sr), np.float32))
        t0 += gap
        dur = g.uniform(2.0, 4.0)
        t = np.arange(int(dur * sr)) / sr
        sig = 0.3 * np.sin(2 * np.pi * freqs[spk] * t) * (
            1 + 0.2 * np.sin(2 * np.pi * 2.3 * t))
        parts.append((sig + 0.01 * g.standard_normal(len(t))).astype(np.float32))
        starts.append(t0)
        ends.append(t0 + dur)
        spks.append(spk)
        t0 += dur
    parts.append(np.zeros(int(0.5 * sr), np.float32))
    return np.concatenate(parts), (
        np.asarray(starts, np.float64),
        np.asarray(ends, np.float64),
        np.asarray(spks, np.int32),
    )


def spectral_probe_encoder(wavs):
    """Deterministic 16-band spectral-signature encoder for tone files
    (numpy): [B, T] -> [B, 16] unit rows, the checkpoint-free stand-in for
    cluster-quality checks."""
    w = np.asarray(wavs)
    spec = np.abs(np.fft.rfft(w, axis=1))
    bands = np.array_split(np.arange(spec.shape[1]), 16)
    feats = np.stack([spec[:, b].mean(axis=1) for b in bands], axis=1)
    feats = feats / (np.linalg.norm(feats, axis=1, keepdims=True) + 1e-8)
    return feats.astype(np.float32)


def make_speaker_bank(rng: np.random.Generator, n_speakers: int):
    """Fixed per-speaker (f0, formants) profiles for speaker-ID training."""
    return [
        {
            "f0": float(rng.uniform(90, 300)),
            "formants": rng.uniform([300, 900, 2200], [900, 2300, 3500]),
        }
        for _ in range(n_speakers)
    ]


def synth_negative(rng: np.random.Generator, dur_s: float, sr: int = 16000) -> np.ndarray:
    n = int(dur_s * sr)
    kind = rng.integers(0, 5)
    if kind == 0:  # silence with tiny sensor noise
        return (1e-4 * rng.standard_normal(n)).astype(np.float32)
    if kind == 4:  # pure digital silence (zero-padded regions, edited audio)
        return np.zeros(n, np.float32)
    if kind == 1:  # white noise
        return (rng.uniform(0.02, 0.15) * rng.standard_normal(n)).astype(np.float32)
    if kind == 2:  # pink-ish noise (cumulative-filtered)
        w = rng.standard_normal(n)
        b = np.convolve(w, np.ones(16) / 16.0, mode="same")
        return (rng.uniform(0.05, 0.2) * b / (np.abs(b).max() + 1e-9)).astype(np.float32)
    # stationary hum + noise
    t = np.arange(n) / sr
    hum = np.sin(2 * np.pi * rng.uniform(50, 120) * t)
    return (0.05 * hum + 0.02 * rng.standard_normal(n)).astype(np.float32)


def make_vad_example(
    rng: np.random.Generator, dur_s: float = 4.0, sr: int = 16000,
    hop_ms: float = 10.0, preprocess_aug: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Random concatenation of speech-like and negative spans -> (wave [T],
    frame labels [n_frames] at hop_ms).

    ``preprocess_aug`` randomly applies the pipeline's preprocessing
    (pre-emphasis 0.97, gain changes from loudness normalization) so the VAD
    is robust to both raw and preprocessed inputs — without it the trained
    net loses ~30% recall behind the pipeline's pre-emphasis stage."""
    n = int(dur_s * sr)
    wave = np.zeros(n, np.float32)
    n_frames = n // int(sr * hop_ms / 1000.0) + 1
    hop = int(sr * hop_ms / 1000.0)
    labels = np.zeros(n_frames, np.float32)
    pos = 0
    while pos < n:
        span = int(rng.uniform(0.3, 1.5) * sr)
        span = min(span, n - pos)
        speech = rng.uniform() < 0.5
        seg = (synth_speech_like(rng, span / sr, sr) if speech
               else synth_negative(rng, span / sr, sr))
        span = min(span, len(seg))  # float-duration rounding guard
        noise = 0.01 * rng.standard_normal(span).astype(np.float32)
        wave[pos : pos + span] = seg[:span] + noise
        if speech:
            f0, f1 = pos // hop, min((pos + span) // hop, n_frames)
            labels[f0:f1] = 1.0
        pos += span
    if preprocess_aug:
        if rng.uniform() < 0.5:  # pre-emphasis (dsp/preprocess.py default)
            wave = np.concatenate([wave[:1], wave[1:] - 0.97 * wave[:-1]])
        gain = 10.0 ** (rng.uniform(-12.0, 6.0) / 20.0)  # loudness-norm gains
        wave = np.clip(wave * gain, -0.99, 0.99).astype(np.float32)
    return wave, labels


def make_segmentation_example(
    rng: np.random.Generator,
    dur_s: float = 5.0,
    sr: int = 16000,
    max_speakers: int = 3,
    hop_ms: float = 10.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Chunk with up to ``max_speakers`` local speakers whose turns MAY
    overlap -> (wave [T], activities [n_frames, K]).

    The training data for the PyanNet-class segmentation model
    (models/segmentation.py): unlike :func:`make_vad_example`, turns of
    different speakers are placed independently, so simultaneous speech
    occurs and each speaker slot carries its own activity channel."""
    bank = make_speaker_bank(rng, max_speakers)
    n = int(dur_s * sr)
    hop = int(sr * hop_ms / 1000.0)
    n_frames = n // hop + 1
    wave = (1e-4 * rng.standard_normal(n)).astype(np.float64)
    labels = np.zeros((n_frames, max_speakers), np.float32)
    n_spk = int(rng.integers(1, max_speakers + 1))
    for k in range(n_spk):
        prof = bank[k]
        for _ in range(int(rng.integers(1, 3))):
            dur = float(rng.uniform(0.8, 2.5))
            start = float(rng.uniform(0.0, max(dur_s - dur, 0.01)))
            i0 = int(start * sr)
            seg = synth_speech_like(
                rng, dur, sr,
                f0=prof["f0"] * float(rng.uniform(0.97, 1.03)),
                formants=prof["formants"],
            )
            i1 = min(i0 + len(seg), n)
            wave[i0:i1] += seg[: i1 - i0]
            labels[i0 // hop : min(i1 // hop, n_frames), k] = 1.0
    peak = max(np.abs(wave).max(), 1e-6)
    wave = wave / peak * min(0.6, peak)  # keep quiet chunks quiet
    wave = wave + 0.005 * rng.standard_normal(n)
    return wave.astype(np.float32), labels


def synth_music_like(rng: np.random.Generator, dur_s: float, sr: int) -> np.ndarray:
    """Chord-progression stand-in for the music stem: stacked harmonic notes
    with slow envelopes and a root progression."""
    n = int(dur_s * sr)
    t = np.arange(n) / sr
    sig = np.zeros(n)
    root = rng.uniform(110.0, 220.0)
    for step in range(max(1, int(dur_s / 0.5))):
        i0 = int(step * 0.5 * sr)
        i1 = min(int((step + 1) * 0.5 * sr), n)
        if i0 >= n:
            break
        chord = root * 2.0 ** (rng.integers(0, 12) / 12.0)
        seg_t = t[i0:i1]
        env = np.minimum(1.0, (seg_t - seg_t[0]) * 20.0) * np.exp(
            -(seg_t - seg_t[0]) * rng.uniform(0.5, 2.0))
        for ratio in (1.0, 1.25, 1.5, 2.0):
            for h in (1, 2, 3):
                sig[i0:i1] += (env / h) * np.sin(
                    2 * np.pi * chord * ratio * h * seg_t + rng.uniform(0, 6.28))
    sig = sig / (np.abs(sig).max() + 1e-9) * rng.uniform(0.2, 0.5)
    return sig.astype(np.float32)


def synth_effect_like(rng: np.random.Generator, dur_s: float, sr: int) -> np.ndarray:
    """Effect-stem stand-in: broadband bursts/whooshes (enveloped shaped noise)."""
    n = int(dur_s * sr)
    sig = np.zeros(n, np.float64)
    for _ in range(int(rng.integers(1, 4))):
        b_dur = rng.uniform(0.1, min(0.8, dur_s))
        i0 = int(rng.uniform(0, max(dur_s - b_dur, 1e-3)) * sr)
        bn = int(b_dur * sr)
        burst = rng.standard_normal(bn)
        k = int(rng.integers(4, 64))
        burst = np.convolve(burst, np.ones(k) / k, mode="same")  # lowpass shade
        env = np.hanning(bn)
        sig[i0 : i0 + bn] += burst * env
    sig = sig / (np.abs(sig).max() + 1e-9) * rng.uniform(0.2, 0.6)
    return sig.astype(np.float32)


def make_demix_example(
    rng: np.random.Generator, dur_s: float = 1.0, sr: int = 44100,
) -> tuple[np.ndarray, np.ndarray]:
    """Stereo 3-stem mixture -> (mix [2, T], stems [3, 2, T]) in the demixer's
    music/effect/dialog order (``dialog-demix.py:113-119`` tree order)."""
    n = int(dur_s * sr)

    def stereo(x, width):
        pan = rng.uniform(0.5 - width, 0.5 + width)
        return np.stack([x * (1.0 - pan), x * pan])

    music = stereo(synth_music_like(rng, dur_s, sr), 0.3)
    effect = stereo(synth_effect_like(rng, dur_s, sr), 0.4)
    dialog = stereo(synth_speech_like(rng, dur_s, sr, amp=0.4), 0.1)
    stems = np.stack([music, effect, dialog])[:, :, :n].astype(np.float32)
    mix = stems.sum(axis=0)
    peak = max(np.abs(mix).max(), 1.0)
    return (mix / peak).astype(np.float32), (stems / peak).astype(np.float32)


def make_speaker_batch(
    rng: np.random.Generator, bank, batch: int, dur_s: float = 2.0,
    sr: int = 16000, preprocess_aug: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    wavs, labels = [], []
    for _ in range(batch):
        spk = int(rng.integers(0, len(bank)))
        prof = bank[spk]
        w = synth_speech_like(rng, dur_s, sr, f0=prof["f0"] * rng.uniform(0.95, 1.05),
                              formants=prof["formants"])
        w = w + 0.01 * rng.standard_normal(len(w)).astype(np.float32)
        if preprocess_aug:  # match the pipeline's preprocessed domain
            if rng.uniform() < 0.5:
                w = np.concatenate([w[:1], w[1:] - 0.97 * w[:-1]])
            gain = 10.0 ** (rng.uniform(-12.0, 6.0) / 20.0)
            w = np.clip(w * gain, -0.99, 0.99).astype(np.float32)
        wavs.append(w.astype(np.float32))
        labels.append(spk)
    return np.stack(wavs), np.array(labels)
