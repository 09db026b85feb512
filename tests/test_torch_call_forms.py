"""The JAX package's call forms on the port (ROADMAP F27, F28): each JAX
parameter that the port now takes, at its JAX default and at another value,
against the JAX function on the same numpy-seeded inputs.

Bars: exact for the value types, ``receptive_field``, ``param_count``,
``sfe`` (data movement) and the loaders' identity; 1e-7 for
``ola_normalization``; 1e-6 elementwise for ``l2_normalize`` and the float32
windows, one ulp of the dtype for the float16 / bfloat16 ones; 2e-3 for the
uncentred log-mel (the log-mel bar of ``tests/test_torch_dsp.py``); 1e-6 for
``chunked_framewise`` with a cheap framewise function.  The loaders' modules
are held to the JAX ``(model, params)`` pairs at the bars of the tests of
those nets.  ``embed_windows_streaming(margin_s=)`` and ``GtcrnEnhancer``'s
parameters are held beside the tests of those paths
(``test_torch_legacy.py``, ``test_torch_gtcrn.py``).
"""
from __future__ import annotations

import importlib
import typing
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.models.gtcrn as jgtcrn
import speech_diarization_tpu.models.zipenhancer_ref as jzr
import speech_diarization_tpu.train.recipes as jrecipes
import speech_diarization_tpu_torch.models.port as tport
import speech_diarization_tpu_torch.models.zipenhancer_ref as tzr
import speech_diarization_tpu_torch.train.recipes as trecipes
from speech_diarization_tpu.cluster.affinity import l2_normalize as jl2
from speech_diarization_tpu.dsp.mel import log_mel_spectrogram as jlog_mel
from speech_diarization_tpu.dsp.ola import ola_normalization as jola_norm
from speech_diarization_tpu.models.vad import VadConvNet as JVadConvNet
from speech_diarization_tpu.models.zipenhancer import ZipEnhancerModel as JZip
from speech_diarization_tpu.models.port_zipenhancer import (
    zipenhancer_manifest as jzip_manifest,
)
from speech_diarization_tpu.pipelines.chunking import chunked_framewise as jchunked
from speech_diarization_tpu.segment import embed as jembed
from speech_diarization_tpu.segment.overlap import (
    detect_overlap_regions as jdetect_overlap_regions,
)
from speech_diarization_tpu.types import Segment as JSegment
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.cluster.affinity import l2_normalize
from speech_diarization_tpu_torch.dsp.mel import log_mel_spectrogram
from speech_diarization_tpu_torch.dsp.ola import ola_normalization
from speech_diarization_tpu_torch.models.gtcrn import GTCRN, sfe
from speech_diarization_tpu_torch.models.registry import seeded_state_dict
from speech_diarization_tpu_torch.models.vad import VadConvNet
from speech_diarization_tpu_torch.models.zipenhancer import ZipEnhancerModel
from speech_diarization_tpu_torch.pipelines.chunking import chunked_framewise
from speech_diarization_tpu_torch.segment import embed as tembed
from speech_diarization_tpu_torch.segment.overlap import detect_overlap_regions
from speech_diarization_tpu_torch.types import Segment, SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
jstft = importlib.import_module("speech_diarization_tpu.dsp.stft")
tstft = importlib.import_module("speech_diarization_tpu_torch.dsp.stft")


def _wave(shape, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


# ------------------------------------------------- 1. the value types ----
def test_segment_with_spk_and_from_segments_match():
    rng = np.random.default_rng(0)
    starts = np.round(rng.uniform(0, 50, 6), 3)
    spks = [2, None, 0, -1, 5, None]
    segs = [Segment(float(s), float(s) + 1.5, k) for s, k in zip(starts, spks)]
    jsegs = [JSegment(float(s), float(s) + 1.5, k) for s, k in zip(starts, spks)]
    assert segs[1].with_spk(7) == Segment(segs[1].start, segs[1].end, 7)
    assert segs[1].spk is None                   # a copy, as dataclasses.replace
    assert vars(segs[3].with_spk(4)) == vars(jsegs[3].with_spk(4))
    arr, jarr = SegmentArray.from_segments(segs), JSegmentArray.from_segments(jsegs)
    for name in ("starts", "ends", "spks"):
        a, b = getattr(arr, name), getattr(jarr, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(arr.spks, [2, -1, 0, -1, 5, -1])
    assert len(SegmentArray.from_segments(iter([]))) == 0


# ------------------------------------------------ 2. ola_normalization ----
@pytest.mark.parametrize("n,win,hop,windowed", [(10, 128, 64, False),
                                                (6, 400, 100, True),
                                                (4, 90, 37, False)])
def test_ola_normalization_takes_the_jax_signature(n, win, hop, windowed):
    """``ola_normalization(n, win, hop)`` folds ones (the JAX call of
    ``tests/test_dsp.py``); with a window, that window."""
    if windowed:
        out = ola_normalization(n, win, hop, tstft.sqrt_hann_window(win, periodic=False))
        ref = jola_norm(n, win, hop, jstft.sqrt_hann_window(win, periodic=False))
    else:
        out, ref = ola_normalization(n, win, hop), jola_norm(n, win, hop)
    assert out.shape == ((n - 1) * hop + win,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)


# ---------------------------------------------------- 3. l2_normalize ----
@pytest.mark.parametrize("kw", [{}, {"axis": 0}, {"axis": 1, "eps": 1e-3},
                                {"axis": -2}])
def test_l2_normalize_takes_axis(kw):
    x = _wave((5, 7, 3), 1)
    ref = np.asarray(jl2(jnp.asarray(x), **kw))
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(x), **kw).numpy(),
                               ref, atol=1e-6, rtol=0)
    if "axis" in kw:
        dim_kw = {k: v for k, v in kw.items() if k != "axis"}
        np.testing.assert_allclose(
            l2_normalize(torch.from_numpy(x), dim=kw["axis"], **dim_kw).numpy(),
            ref, atol=1e-6, rtol=0)


def test_l2_normalize_refuses_axis_and_dim_together():
    with pytest.raises(TypeError, match="not both"):
        l2_normalize(torch.ones(2, 3), axis=0, dim=0)


# ------------------------------------------------------ 4. the windows ----
_DTYPES = {"float32": (torch.float32, jnp.float32),
           "float16": (torch.float16, jnp.float16),
           "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", list(_DTYPES))
@pytest.mark.parametrize("name", ["hann_window", "sqrt_hann_window"])
@pytest.mark.parametrize("n,periodic", [(400, True), (513, False)])
def test_windows_take_dtype(dtype, name, n, periodic):
    tdt, jdt = _DTYPES[dtype]
    out = getattr(tstft, name)(n, periodic, dtype=tdt)
    ref = getattr(jstft, name)(n, periodic, dtype=jdt)
    assert out.dtype == tdt and ref.dtype == jdt
    out, ref = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
        return
    # one ulp of the dtype at the reference's value
    eps = torch.finfo(tdt).eps
    tiny = torch.finfo(tdt).tiny
    ulp = eps * 2.0 ** np.floor(np.log2(np.maximum(np.abs(ref), tiny)))
    assert (np.abs(out - ref) <= ulp).all(), np.abs(out - ref).max()


def test_windows_are_cached_per_dtype():
    a = tstft.hann_window(64, dtype=torch.float16)
    b = tstft.hann_window(64)
    assert a.dtype == torch.float16 and b.dtype == torch.float32
    assert tstft.hann_window(64, dtype=torch.float16) is a


# ------------------------------------------ 5. log-mel, center=False ----
@pytest.mark.parametrize("shape,n_mels", [((1, 8000), 80), ((3, 4321), 40),
                                          ((4000,), 80)])
def test_log_mel_uncentred_matches(shape, n_mels):
    y = _wave(shape, 2)
    ref = np.asarray(jlog_mel(jnp.asarray(y), n_mels=n_mels, center=False))
    out = log_mel_spectrogram(torch.from_numpy(y), n_mels=n_mels, center=False).numpy()
    t = shape[-1]
    assert out.shape == ref.shape == (1 if len(shape) == 1 else shape[0],
                                      (t - 400) // 160 + 1, n_mels)
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_log_mel_uncentred_refuses_a_short_row():
    with pytest.raises(ValueError, match="center=False"):
        log_mel_spectrogram(torch.zeros(2, 399), center=False)


# ---------------------------------------------- 6. chunked_framewise ----
def _running_ms(rows, hop: int, extra: int, xp):
    """A framewise function whose frames depend on the chunk: the running
    mean from the chunk's start of each frame's mean square, ``extra``
    copies of the last frame appended (a centred model's count)."""
    g, t = rows.shape
    ms = (rows[:, :t // hop * hop].reshape(g, t // hop, hop) ** 2).mean(-1)
    run = xp.cumsum(ms, 1) / xp.arange(1, t // hop + 1, dtype=ms.dtype)
    if extra:
        run = xp.concatenate([run] + [run[:, -1:]] * extra, 1)
    return run


_CHUNKING = {
    "defaults": {},
    "chunk 10 s, overlap 0.5 s, group 2": dict(chunk_s=10.0, overlap_s=0.5, group=2),
    "no extra frame": dict(frames_per_chunk_extra=0),
    "two extra frames, margin 5": dict(frames_per_chunk_extra=2, edge_margin_frames=5),
}


@pytest.mark.parametrize("case", list(_CHUNKING))
def test_chunked_framewise_takes_the_jax_parameters(case):
    kw = _CHUNKING[case]
    extra = kw.get("frames_per_chunk_extra", 1)
    y = _wave(int(37.3 * SR), 3)
    ref = jchunked(jax.jit(partial(_running_ms, hop=160, extra=extra, xp=jnp)),
                   y, SR, frame_hop=160, **kw)
    out = chunked_framewise(partial(_running_ms, hop=160, extra=extra, xp=torch),
                            torch.from_numpy(y), SR, frame_hop=160, **kw).numpy()
    assert out.shape == ref.shape == (len(y) // 160 + extra,)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_chunked_framewise_group_changes_no_result():
    y = torch.from_numpy(_wave(int(50.0 * SR), 4))
    calls = []

    def fn(rows):
        calls.append(rows.shape[0])
        return _running_ms(rows, 160, 1, torch)

    one = chunked_framewise(fn, y, SR, 160, group=1)
    n_chunks = len(calls)
    assert calls == [1] * n_chunks
    calls.clear()
    assert torch.equal(chunked_framewise(fn, y, SR, 160, group=3), one)
    assert calls == [3] * (n_chunks // 3) + [n_chunks % 3] * (n_chunks % 3 > 0)


# ------------------------------------- 8. detect_overlap_regions(seg_fn=) ----
def test_detect_overlap_regions_takes_seg_fn_by_name():
    """The stub scorer of ``tests/test_torch_overlap.py``: two speakers
    over 4.0-5.5 s, passed as ``seg_fn=``."""
    sr = 1000
    mask = np.zeros(10 * 100 + 1, np.float32)
    mask[400:550] = 1.0

    def seg_fn(chunks):
        acts = np.zeros((chunks.shape[0], 501, 2), np.float32)
        acts[:, :, 0] = 1.0
        for c in range(chunks.shape[0]):
            acts[c, :, 1] = mask[np.clip(np.arange(c * 250, c * 250 + 501), 0, 1000)]
        return acts

    seg_fn.dual = False
    y = np.zeros(10 * sr, np.float32)
    out = detect_overlap_regions(y, sr, seg_fn=seg_fn, device="cpu")
    ref = jdetect_overlap_regions(y, sr, seg_fn=seg_fn)
    assert len(out) == len(ref) == 1
    np.testing.assert_array_equal(out.starts, ref.starts)
    np.testing.assert_array_equal(out.ends, ref.ends)


# ------------------------------------------ 9. train.recipes loaders ----
_LOADERS = {
    # name: (checkpoint, input shape, JAX call, port call, bar)
    "load_vad": ("vad_conv_mc.npz", (2, 16000),
                 lambda m, p, y: m.probs(p, y), lambda net, y: net.probs(y),
                 ("atol", 1e-4)),
    "load_speaker_encoder": ("ecapa_synthetic.npz", (2, 16000),
                             lambda m, p, y: m.encode_batch(p, y),
                             lambda net, y: net.encode_batch(y), ("rel", 1e-5)),
    "load_segmentation": ("segmentation_conv.npz", (1, 80000),
                          lambda m, p, y: m.head_logits(p, y),
                          lambda net, y: net.head_logits(y), ("atol", 1e-3)),
    "load_demixer": ("demix_synthetic.npz", (1, 2, 44100),
                     lambda m, p, y: m.apply(p, y), lambda net, y: net(y),
                     ("rel", 1e-5)),
}


@pytest.mark.parametrize("name", list(_LOADERS))
def test_recipes_loaders_are_the_port_loaders_and_match(name):
    """``train.recipes.load_*`` are ``models/port.py``'s loaders; the
    module computes what the JAX ``(model, params)`` pair computes."""
    npz, shape, jcall, tcall, (kind, bar) = _LOADERS[name]
    assert getattr(trecipes, name) is getattr(tport, name)
    jm, jp = getattr(jrecipes, name)(WEIGHTS / npz)
    net = getattr(trecipes, name)(WEIGHTS / npz)
    y = _wave(shape, 5, scale=0.1)
    ref = np.asarray(jcall(jm, jp, jnp.asarray(y)))
    with torch.inference_mode():
        out = tcall(net, torch.from_numpy(y)).numpy()
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    if kind == "rel":
        err /= np.abs(ref).max()
    assert err <= bar, err


# --------------------------------- 10, 13, 14: constructors and helpers ----
@pytest.mark.parametrize("kw", [{}, dict(dilations=(1, 3, 9), kernel=5)])
def test_vad_receptive_field_matches(kw):
    assert VadConvNet(**kw).receptive_field == JVadConvNet(**kw).receptive_field


@pytest.mark.parametrize("sr", [16000, 8000])
def test_zipenhancer_model_takes_sample_rate(sr):
    kw = {} if sr == 16000 else dict(sample_rate=sr, channels=8, blocks=1)
    assert ZipEnhancerModel(**kw).sample_rate == JZip(**kw).sample_rate == sr


def test_gtcrn_takes_low_bins_65_and_refuses_another():
    assert GTCRN(low_bins=65).low_bins == jgtcrn.GTCRN(low_bins=65).low_bins
    with pytest.raises(ValueError, match="low_bins"):
        GTCRN(low_bins=64)


@pytest.mark.parametrize("kernel", [3, 5])
def test_sfe_takes_kernel(kernel):
    x = _wave((2, 3, 4, 17), 6)
    ref = np.asarray(jgtcrn.sfe(jnp.asarray(x), kernel=kernel))
    out = sfe(torch.from_numpy(x), kernel=kernel).numpy()
    assert out.shape == (2, 3 * kernel, 4, 17)
    np.testing.assert_array_equal(out, ref)


# -------------------------------------- 11. ZipEnhancerRef.param_count ----
TINY = dict(n_fft=400, hop=100, dense_channel=16, num_tsblocks=1, num_layers=1,
            heads=2, query_head_dim=8, pos_head_dim=4, value_head_dim=8,
            pos_dim=16, feedforward_dim=48, conv_kernel=7)


@pytest.mark.parametrize("cfg", ["tiny", "published"])
def test_zipenhancer_ref_param_count_matches(cfg):
    """On the same carried weights (a seeded draw of the JAX manifest):
    JAX's count of its params, the port's of its own state dict and of the
    same dict."""
    kw = TINY if cfg == "tiny" else {}
    jm = jzr.ZipEnhancerRef(**kw)
    p = seeded_state_dict(jzip_manifest(jm), 0)
    net = tzr.ZipEnhancerRef(**kw)
    net.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in p.items()}, strict=True)
    want = jm.param_count({k: jnp.asarray(v) for k, v in p.items()})
    assert net.param_count() == net.param_count(net.state_dict()) == want
    assert net.param_count(p) == want
    if not kw:
        assert want == 3_495_276


# ------------------------------------------ 15. EncodeFn, the DFT mode ----
def test_encode_fn_is_a_one_tensor_callable():
    jargs = typing.get_args(jembed.EncodeFn)
    targs = typing.get_args(tembed.EncodeFn)
    assert typing.get_origin(tembed.EncodeFn) is typing.get_origin(jembed.EncodeFn)
    assert len(targs[0]) == len(jargs[0]) == 1
    assert targs == ([torch.Tensor], torch.Tensor)


def test_stft_defaults_to_the_jax_default_dft_mode():
    """``DEFAULT_DFT_MODE`` is JAX-only; the port's default (``matmul=None``)
    is the products, the JAX default mode."""
    assert jstft.DEFAULT_DFT_MODE == "matmul"
    y = torch.from_numpy(_wave((2, 3000), 7))
    assert torch.equal(tstft.stft(y), tstft.stft(y, matmul=True))
    spec = tstft.stft(y)
    assert torch.equal(tstft.istft(spec, length=3000),
                       tstft.istft(spec, length=3000, matmul=True))
