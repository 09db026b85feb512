"""The PyTorch port's DSP front against the JAX package.

The host-side pieces of kernel K2 (even/odd fold, TF32 split, fragment
order of the basis, mel bin ranges) are held against the plain version
here: folded log-mel 1e-5 against ``_log_mel_1d``; the three-product TF32
scheme inside the card tolerance (1e-4 of the largest magnitude) on a
loud-plus-quiet signal where a single TF32 pass is outside it.

Inputs come from numpy seeds.  Bars: log-mel atol 2e-3 (the fused-fbank bar
of tests/test_pallas_fbank.py); framing and pre-emphasis 1e-6; loudness
0.01 LU against the exact IIR meter of the JAX package (the port's FIR
K-weighting truncates the impulse response at 2048 taps).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.dsp.framing import frame_signal as jframe
from speech_diarization_tpu.dsp.framing import num_frames as jnum_frames
from speech_diarization_tpu.dsp.loudness import integrated_loudness as jlufs
from speech_diarization_tpu.dsp.mel import _mel_filterbank_np as jfb
from speech_diarization_tpu.dsp.mel import log_mel_spectrogram as jlog_mel
from speech_diarization_tpu.dsp.preprocess import preemphasis as jpreemph
from speech_diarization_tpu.ops.pallas.fused_fbank import fused_log_mel as jfused
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu_torch.dsp.framing import frame_signal, num_frames
from speech_diarization_tpu_torch.dsp.loudness import integrated_loudness
from speech_diarization_tpu_torch.dsp.mel import (
    _basis_fragments,
    _folded_basis,
    _log_mel_1d,
    _log_mel_batched,
    _mel_filterbank_np,
    _mel_sparse,
    _reflect_pad,
    _tf32_split,
    fused_log_mel,
    log_mel_spectrogram,
)
from speech_diarization_tpu_torch.dsp.preprocess import preemphasis

torch.set_num_threads(2)
SR = 16000


def _speech(dur_s: float, seed: int) -> np.ndarray:
    w, _ = make_conversation(np.random.default_rng(seed), dur_s, n_speakers=2, sr=SR)
    return w.astype(np.float32)


@pytest.mark.parametrize("n_samples,n_mels", [(16000, 40), (48000, 40),
                                              (40123, 80), (3 * 16000 + 7, 40)])
def test_log_mel_matches_jax_single_waveform_path(n_samples, n_mels):
    y = (0.3 * np.random.default_rng(n_samples).standard_normal(n_samples)
         ).astype(np.float32)
    ref = np.asarray(jlog_mel(jnp.asarray(y)[None], sample_rate=SR,
                              n_mels=n_mels))[0]
    out = fused_log_mel(torch.from_numpy(y), sample_rate=SR, n_mels=n_mels).numpy()
    assert out.shape == ref.shape == (n_samples // 160 + 1, n_mels)
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_log_mel_matches_pallas_fused_kernel_interpret(seed):
    y = _speech(3.0, seed)
    ref = np.asarray(jfused(jnp.asarray(y), sample_rate=SR, n_mels=40,
                            tile_n=64, interpret=True))
    out = _log_mel_1d(torch.from_numpy(y), sample_rate=SR, n_mels=40).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("b,n_samples,n_mels", [(2, 16000, 40), (5, 8037, 40),
                                                (3, 80000, 40), (4, 12345, 80)])
def test_batched_log_mel_matches_jax_batched_path(b, n_samples, n_mels):
    """The wrapper on a CPU batch (the plain batched version) against the
    JAX function's B > 1 branch; atol 2e-3."""
    y = (0.3 * np.random.default_rng(n_samples + b).standard_normal((b, n_samples))
         ).astype(np.float32)
    ref = np.asarray(jlog_mel(jnp.asarray(y), sample_rate=SR, n_mels=n_mels))
    out = fused_log_mel(torch.from_numpy(y), sample_rate=SR, n_mels=n_mels).numpy()
    assert out.shape == ref.shape == (b, n_samples // 160 + 1, n_mels)
    np.testing.assert_allclose(out, ref, atol=2e-3)
    again = log_mel_spectrogram(torch.from_numpy(y), sample_rate=SR,
                                n_mels=n_mels).numpy()
    np.testing.assert_array_equal(again, out)


def test_batched_log_mel_matches_pallas_fused_kernel_interpret():
    """Against the Pallas kernel on a batch, run in interpret mode as the
    JAX package's own CPU tests run it; atol 2e-3."""
    y = (0.3 * np.random.default_rng(5).standard_normal((3, 4000))).astype(np.float32)
    ref = np.asarray(jfused(jnp.asarray(y), sample_rate=SR, n_mels=40,
                            interpret=True))
    out = fused_log_mel(torch.from_numpy(y), sample_rate=SR, n_mels=40).numpy()
    assert out.shape == ref.shape == (3, 26, 40)
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("stride", [40000, 3001])
def test_batched_log_mel_reads_overlapping_windows_in_place(stride):
    """Windows cut from one signal as a view (the detector's framing) give
    what the same windows give as separate waveforms; 1e-4 (two plain
    forms: framed for the batch, blocked for one waveform)."""
    win = 80000 if stride == 40000 else 8037
    y = torch.from_numpy(_speech(3 * stride / SR + win / SR, 11))
    wins = y[:3 * stride + win].unfold(0, win, stride)
    assert not wins.is_contiguous() and wins.shape == (4, win)
    out = fused_log_mel(wins, n_mels=40)
    rows = torch.stack([_log_mel_1d(w.contiguous(), n_mels=40) for w in wins])
    np.testing.assert_allclose(out.numpy(), rows.numpy(), atol=1e-4)
    np.testing.assert_array_equal(
        out.numpy(), _log_mel_batched(wins.contiguous(), n_mels=40).numpy())


def test_log_mel_of_one_row_batch_takes_the_single_waveform_form():
    y = torch.from_numpy(_speech(1.0, 4))
    np.testing.assert_array_equal(fused_log_mel(y[None], n_mels=40)[0].numpy(),
                                  fused_log_mel(y, n_mels=40).numpy())


def test_log_mel_refuses_other_ranks():
    with pytest.raises(ValueError, match=r"\[T\] or \[B, T\]"):
        fused_log_mel(torch.zeros(2, 3, 4000))


@pytest.mark.parametrize("t", [10, 200])
def test_log_mel_refuses_inputs_too_short_for_the_reflect_pad(t):
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(t), n_mels=40)


@pytest.mark.parametrize("n_mels,f_max", [(40, 7900.0), (80, 7900.0), (64, 8000.0)])
def test_mel_filterbank_equal(n_mels, f_max):
    np.testing.assert_array_equal(_mel_filterbank_np(201, 20.0, f_max, n_mels, SR),
                                  jfb(201, 20.0, f_max, n_mels, SR))


@pytest.mark.parametrize("coef", [0.97, 0.5])
def test_preemphasis_matches_jax(coef):
    y = np.random.default_rng(5).standard_normal(4001).astype(np.float32)
    ref = np.asarray(jpreemph(jnp.asarray(y), coef))
    out = preemphasis(torch.from_numpy(y), coef).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("t,win,hop,pad_tail", [
    (1000, 400, 160, True), (1000, 400, 160, False), (80000, 5 * SR // 2, 800, False),
    (300, 400, 160, True), (160 * 20, 160, 160, True)])
def test_frame_signal_matches_jax(t, win, hop, pad_tail):
    y = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    ref = np.asarray(jframe(jnp.asarray(y), win, hop, pad_tail=pad_tail))
    out = frame_signal(torch.from_numpy(y), win, hop, pad_tail=pad_tail).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert num_frames(t, win, hop, pad_tail) == jnum_frames(t, win, hop, pad_tail)


@pytest.mark.parametrize("case", ["speech", "quiet", "silence", "short"])
def test_chunk_loudness_matches_jax(case):
    if case == "silence":
        y = np.zeros(SR * 2, np.float32)
    elif case == "short":
        y = (0.1 * np.random.default_rng(2).standard_normal(SR // 4)).astype(np.float32)
    else:
        y = _speech(6.0, 7) * (0.01 if case == "quiet" else 1.0)
    ref = float(jlufs(jnp.asarray(y), SR))
    out = float(integrated_loudness(torch.from_numpy(y), SR))
    if case == "silence":
        assert out == ref == -200.0
    else:
        assert abs(out - ref) < 0.01, (out, ref)


def _log_mel_folded(y: torch.Tensor, n_mels: int, split: str = "none") -> torch.Tensor:
    """K2's arithmetic (csrc/fused_fbank.cu) in plain float32 PyTorch at the
    main path's geometry: frames folded about tap ``n_fft//2``, contracted
    against ``_folded_basis``.  ``split``: ``"none"`` float32 products;
    ``"tf32"`` one pass with both operands rounded to TF32; ``"3xtf32"`` the
    kernel's scheme, ``lo*hi + hi*lo + hi*hi`` with float32 accumulation."""
    n_fft, hop, half = 400, 160, 200
    frames = _reflect_pad(y.float(), half).unfold(0, n_fft, hop)    # [N, n_fft]
    head, tail = frames[:, 1:half], frames[:, half + 1:].flip(1)
    mid = frames[:, half:half + 1]
    e = torch.cat([head + tail, mid], 1)                            # [N, half]
    o = torch.cat([head - tail, torch.zeros_like(mid)], 1)

    def product(a: torch.Tensor, b: np.ndarray) -> torch.Tensor:
        if split == "none":
            return a @ torch.from_numpy(b)
        a_hi, a_lo = (torch.from_numpy(p) for p in _tf32_split(a.numpy()))
        b_hi, b_lo = (torch.from_numpy(p) for p in _tf32_split(b))
        if split == "tf32":
            return a_hi @ b_hi
        assert split == "3xtf32", split
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    ce, so = _folded_basis(n_fft)
    real, imag = product(e, ce), product(o, so)
    fb = torch.from_numpy(_mel_filterbank_np(half + 1, 20.0, SR / 2 - 100.0,
                                             n_mels, SR))
    return torch.log((real * real + imag * imag) @ fb + 1e-6)


@pytest.mark.parametrize("n_samples", [16000, 63 * 160, 80000, 201])
def test_folded_log_mel_matches_plain_and_jax(n_samples):
    """The even/odd fold is exact in real arithmetic.  In float32, at the
    main path's 40 mels on white noise, it agrees with the blocked DFT to
    1e-5 and with the JAX package to its 2e-3."""
    y = (0.3 * np.random.default_rng(n_samples).standard_normal(n_samples)
         ).astype(np.float32)
    out = _log_mel_folded(torch.from_numpy(y), n_mels=40).numpy()
    plain = _log_mel_1d(torch.from_numpy(y), n_mels=40).numpy()
    assert out.shape == plain.shape == (n_samples // 160 + 1, 40)
    np.testing.assert_allclose(out, plain, atol=1e-5)
    ref = np.asarray(jlog_mel(jnp.asarray(y)[None], sample_rate=SR, n_mels=40))[0]
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("seed,n_mels", [(0, 40), (1, 40), (0, 80), (2, 80)])
def test_folded_log_mel_on_speech_within_the_card_tolerance(seed, n_mels):
    """Speech has quiet bands next to loud ones, where two float32
    summation orders differ by more than 1e-5 in the log; the fold stays
    inside the kernel's tolerance on the card (1e-4 of the largest
    magnitude) with room to spare, and inside the JAX bar."""
    y = _speech(3.0, seed)
    out = _log_mel_folded(torch.from_numpy(y), n_mels=n_mels).numpy()
    plain = _log_mel_1d(torch.from_numpy(y), n_mels=n_mels).numpy()
    assert np.abs(out - plain).max() <= 0.3 * 1e-4 * np.abs(plain).max()
    ref = np.asarray(jlog_mel(jnp.asarray(y)[None], sample_rate=SR,
                              n_mels=n_mels))[0]
    np.testing.assert_allclose(out, ref, atol=2e-3)


def _loud_plus_quiet(seed: int, tone_hz: float) -> np.ndarray:
    """A loud tone over noise 36 dB below it: most mel bands sit far under
    the tone's bins and see their rounding error.  (At 60 dB two float32
    evaluations already differ by more than the card tolerance.)"""
    n = np.arange(2 * SR)
    rng = np.random.default_rng(seed)
    return (0.6 * np.sin(2 * np.pi * tone_hz / SR * n)
            + 1e-2 * rng.standard_normal(n.size)).astype(np.float32)


@pytest.mark.parametrize("seed,tone_hz", [(0, 440.0), (1, 173.0), (2, 1000.0),
                                          (3, 3000.0), (4, 60.0)])
def test_three_tf32_products_hold_the_card_tolerance_one_pass_does_not(
        seed, tone_hz):
    y = torch.from_numpy(_loud_plus_quiet(seed, tone_hz))
    plain = _log_mel_1d(y, n_mels=40)
    tol = 1e-4 * plain.abs().max().item()
    err3 = (_log_mel_folded(y, n_mels=40, split="3xtf32") - plain).abs().max().item()
    err1 = (_log_mel_folded(y, n_mels=40, split="tf32") - plain).abs().max().item()
    assert err3 <= tol, (err3, tol)
    assert err1 > 10 * tol, (err1, tol)
    # and the scheme computes what the JAX package computes, at its bar
    ref = np.asarray(jlog_mel(jnp.asarray(y.numpy())[None], sample_rate=SR,
                              n_mels=40))[0]
    out3 = _log_mel_folded(y, n_mels=40, split="3xtf32").numpy()
    np.testing.assert_allclose(out3, ref, atol=2e-3)


@pytest.mark.parametrize("scale", [1.0, 1e-4, 37.5])
def test_tf32_split_parts(scale):
    a = (scale * np.random.default_rng(3).standard_normal(4096)).astype(np.float32)
    hi, lo = _tf32_split(a)
    for part in (hi, lo):       # TF32: the low 13 mantissa bits are zero
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert np.abs(hi - a).max() <= 2.0 ** -11 * np.abs(a).max()
    assert np.abs(hi.astype(np.float64) + lo - a).max() <= 2.0 ** -21 * np.abs(a).max()


@pytest.mark.parametrize("n_fft", [400, 200])
def test_basis_fragments_follow_the_mma_b_fragment_order(n_fft):
    """Walking the packed basis the way the kernel's matrix descriptors do
    (K-major, no swizzle: 128-byte core matrices of 8 bins x 4 taps, 128
    bytes on to the next 8 bins, 26 * 128 bytes on to the next 4 taps)
    gives back the split folded basis, zero-padded in taps and bins."""
    frag = _basis_fragments(n_fft)
    n_ks = -(-(n_fft // 2) // 8)
    assert frag.shape == (n_ks, 2 * 2 * 2 * 26 * 32) and frag.dtype == np.float32
    flat = frag.reshape(-1)
    stage, sbo, lbo = frag.shape[1], 32, 26 * 32          # in floats
    for part, mat in enumerate(_folded_basis(n_fft)):
        half, n_bins = mat.shape
        for j, piece in enumerate(_tf32_split(mat)):
            want = np.pad(piece, ((0, n_ks * 8 - half), (0, 208 - n_bins)))
            k, n = np.meshgrid(np.arange(n_ks * 8), np.arange(208), indexing="ij")
            at = ((k // 8) * stage + (part * 2 + j) * (stage // 4)
                  + (k % 8 // 4) * lbo + (n // 8) * sbo + (n % 8) * 4 + k % 4)
            np.testing.assert_array_equal(flat[at], want)
    assert len(np.unique(at)) == at.size            # no two entries share a slot


@pytest.mark.parametrize("n_mels,f_max", [(40, 7900.0), (80, 7900.0), (64, 8000.0)])
def test_packed_mel_filterbank_keeps_every_nonzero_weight(n_mels, f_max):
    fb = _mel_filterbank_np(201, 20.0, f_max, n_mels, SR)
    idx, w = _mel_sparse(fb)
    assert idx.dtype == np.int32 and idx.shape == (3, n_mels)
    assert w.dtype == np.float32 and w.shape == ((idx[1] - idx[0]).sum(),)
    dense = np.zeros_like(fb)
    for m, (lo, hi, off) in enumerate(idx.T):
        dense[lo:hi, m] = w[off:off + hi - lo]
    np.testing.assert_array_equal(dense, fb)
    # the walk the kernel makes over a power row gives the dense product
    power = np.random.default_rng(0).random((5, 201)).astype(np.float32)
    sparse = np.stack([power[:, lo:hi] @ w[off:off + hi - lo]
                       for lo, hi, off in idx.T], 1)
    np.testing.assert_allclose(sparse, power @ fb, rtol=1e-6)
