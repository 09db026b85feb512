"""The port's GTCRN and its enhancer against the JAX package's
``models/gtcrn.py`` and ``pipelines/enhance.py``, on the shipped
``weights/gtcrn_mc.npz`` (full width: 16 channels, 33 bins after the
encoder, two DPGRNNs) and on JAX-initialised random weights.

Bars: the GTCRN output (a 4 s spectrum) and the enhanced waveforms within
1e-4 of the output's peak; measured on the CPU at 1.3e-7 (GTCRN, 4 s) and
3.9e-7 (chunked OLA, 10 s) of it.  The GRUs alone: within 1e-6 (float32,
250 steps).  Leaving the enhancer's zero padding rows out changes its
output by no more than 1e-6 of the peak.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.models.gtcrn import GTCRN as JGTCRN
from speech_diarization_tpu.models.gtcrn import gtcrn_init_params
from speech_diarization_tpu.models.layers import GRUParams, gru_sequence
from speech_diarization_tpu.models.layers import layer_norm_apply as jlayer_norm
from speech_diarization_tpu.models.layers import prelu as jprelu
from speech_diarization_tpu.models.port import load_params_npz as jload_npz
from speech_diarization_tpu.dsp.stft import stft_ri as jstft_ri
from speech_diarization_tpu.pipelines.enhance import GtcrnEnhancer as JEnhancer
from speech_diarization_tpu.pipelines.enhance import (
    default_weights_path as jdefault_weights_path,
)
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu_torch.models.layers import layer_norm_apply
from speech_diarization_tpu_torch.models.port import load_gtcrn
from speech_diarization_tpu_torch.pipelines.enhance import (
    GtcrnEnhancer,
    default_weights_path,
    make_enhance_fn,
)

torch.set_num_threads(2)
SR = 16000
NPZ = Path(__file__).resolve().parents[1] / "weights" / "gtcrn_mc.npz"
BAR = 1e-4


def _wave(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def noisy():
    """A held-out conversation in white noise at 10 dB: 10 s."""
    w, _ = make_conversation_heldout(np.random.default_rng(5), 10.0, n_speakers=2,
                                     sr=SR, snr_db=10.0, noise_kind="white")
    return w.astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jload_npz(str(NPZ))


@pytest.fixture(scope="module")
def net():
    return load_gtcrn(NPZ)


def test_state_dict_keys_are_the_npz_keys(net):
    with np.load(NPZ) as z:
        keys = set(z.files) - {"__meta__"}
    assert set(net.state_dict()) == keys
    assert len(keys) == 249
    assert sum(p.numel() for p in net.state_dict().values()) == sum(
        np.load(NPZ)[k].size for k in keys)


def test_load_refuses_a_missing_key():
    flat = jload_npz(str(NPZ))
    flat.pop("dpgrnn1.intra_ln.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_gtcrn(flat)


def test_weights_are_float32_after_the_float16_checkpoint(net):
    assert all(v.dtype == torch.float32 for v in net.state_dict().values())


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_full_width_forward_matches_on_4s(noisy, jparams, net):
    spec = np.array(jstft_ri(jnp.asarray(noisy[:4 * SR])[None]))    # [1,257,251,2]
    ref = np.asarray(jax.jit(JGTCRN().apply)(jparams, jnp.asarray(spec)))
    with torch.inference_mode():
        out = net(torch.from_numpy(spec)).numpy()
    assert out.shape == ref.shape == (1, 257, 251, 2)
    assert _rel_err(out, ref) <= BAR, _rel_err(out, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_initialised_params_load_and_match(seed):
    """A JAX params dict (random init) converted to numpy loads as it is."""
    p = gtcrn_init_params(jax.random.PRNGKey(seed))
    tnet = load_gtcrn({k: np.asarray(v) for k, v in p.items()})
    spec = (0.5 * np.random.default_rng(seed).standard_normal((2, 257, 40, 2))
            ).astype(np.float32)
    ref = np.asarray(JGTCRN().apply(p, jnp.asarray(spec)))
    with torch.inference_mode():
        out = tnet(torch.from_numpy(spec)).numpy()
    assert _rel_err(out, ref) <= BAR, _rel_err(out, ref)


def test_enhancer_single_chunk_matches(noisy, jparams, net):
    ref = JEnhancer(jparams)(noisy[:4 * SR])
    out = GtcrnEnhancer(net)(torch.from_numpy(noisy[:4 * SR])).numpy()
    assert out.shape == ref.shape == (4 * SR,)
    assert _rel_err(out, ref) <= BAR, _rel_err(out, ref)


def test_enhancer_takes_the_jax_constructor_parameters(noisy, jparams, net):
    """``hop``, ``sample_rate`` and ``batch_chunks`` away from their
    defaults (``n_fft`` is GTCRN's 512): 10 s read as 8 kHz audio, 2 s
    chunks at a 1.5 s stride, thirteen chunks in forwards of two rows at a
    hop of 128."""
    kw = dict(n_fft=512, hop=128, chunk_s=2.0, overlap_s=0.5, sample_rate=8000,
              batch_chunks=2)
    ref = JEnhancer(jparams, **kw)(noisy)
    enh = GtcrnEnhancer(net, **kw)
    assert (enh.n_fft, enh.hop, enh.sample_rate, enh.batch_chunks) == (512, 128, 8000, 2)
    out = enh(torch.from_numpy(noisy)).numpy()
    assert out.shape == ref.shape == (10 * SR,)
    assert _rel_err(out, ref) <= BAR, _rel_err(out, ref)


def test_enhancer_batch_chunks_changes_no_result(noisy, net):
    """Seven 2 s chunks in forwards of one row, or of four and three (the
    default): the rows are independent, within 1e-6 of the peak."""
    y = torch.from_numpy(noisy)
    one = GtcrnEnhancer(net, chunk_s=2.0, overlap_s=0.5, batch_chunks=1)(y)
    four = GtcrnEnhancer(net, chunk_s=2.0, overlap_s=0.5)(y)
    assert (one - four).abs().max() <= 1e-6 * four.abs().max()


@pytest.mark.parametrize("chunk_s,overlap_s", [(4.0, 1.0), (2.0, 0.5)])
def test_enhancer_chunked_ola_matches(noisy, jparams, net, chunk_s, overlap_s):
    """Chunks over 10 s merged by the Hann overlap-add: three 4 s chunks at
    a 3 s stride (one forward; the JAX side pads it to four rows), and
    seven 2 s chunks at 1.5 s (two forwards of four and three rows)."""
    ref = JEnhancer(jparams, chunk_s=chunk_s, overlap_s=overlap_s)(noisy)
    out = GtcrnEnhancer(net, chunk_s=chunk_s, overlap_s=overlap_s)(
        torch.from_numpy(noisy)).numpy()
    assert out.shape == ref.shape == (10 * SR,)
    assert _rel_err(out, ref) <= BAR, _rel_err(out, ref)


def test_zero_padding_rows_can_be_left_out(noisy, net):
    """The rows of a batch are independent in eval mode: three real chunks
    alone give what they give beside a zero row."""
    rows = torch.from_numpy(noisy[:3 * 2 * SR].reshape(3, 2 * SR))
    enh = GtcrnEnhancer(net)
    with torch.inference_mode():
        alone = enh.forward(rows)
        padded = enh.forward(torch.cat([rows, torch.zeros(1, 2 * SR)]))[:3]
    assert (alone - padded).abs().max() <= 1e-6 * alone.abs().max()


@pytest.mark.parametrize("backend", ["gtcrn", "zipenhancer", "demix-dialog",
                                     "zipenhancer-ref"])
def test_default_weights_path_matches(backend):
    a, b = default_weights_path(backend), jdefault_weights_path(backend)
    assert (a is None) == (b is None)
    if a is not None:
        assert Path(a).name == Path(b).name


def test_make_enhance_fn_gtcrn_is_the_shipped_net(noisy, net):
    fn = make_enhance_fn("gtcrn", device="cpu")
    y = torch.from_numpy(noisy[:2 * SR])
    ref = GtcrnEnhancer(net)(y)
    assert torch.equal(fn(y), ref)


@pytest.mark.parametrize("backend", ["zipenhancer", "zipenhancer-ref",
                                     "demix-dialog"])
def test_unported_backends_raise(backend):
    """No backend is unported now: the shipped-weight ZipEnhancer and demix
    backends and the published ZipEnhancer graph (random weights, with a
    warning) build and keep a waveform's length (their parity with the JAX
    package: test_torch_zipenhancer.py, test_torch_demix.py,
    test_torch_zipenhancer_ref.py)."""
    y = torch.from_numpy(_wave(SR + 123, 6))
    out = make_enhance_fn(backend, device="cpu")(y)
    assert out.shape == y.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("backend", ["gtcrn", "zipenhancer", "demix-dialog"])
def test_make_enhance_fn_defaults_to_the_card(backend):
    """Without ``device`` the enhancer is built on the card; without CUDA
    that raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_enhance_fn(backend)


def test_unknown_backend_is_a_value_error():
    with pytest.raises(ValueError, match="unknown"):
        make_enhance_fn("wiener")


# ----------------------------------------------------------- layers ------
def _jgru(g: torch.nn.GRU, suffix: str = "") -> GRUParams:
    return GRUParams(*(jnp.asarray(getattr(g, f"{n}_l0{suffix}").detach().numpy())
                       for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))


@pytest.mark.parametrize("d_in,hidden,bidir", [(8, 16, False), (8, 4, True),
                                               (8, 8, False)])
def test_nn_gru_is_gru_sequence(d_in, hidden, bidir):
    """``nn.GRU`` has the gate order and math of ``gru_sequence``, forward
    and (bidirectional) reversed."""
    torch.manual_seed(hidden)
    g = torch.nn.GRU(d_in, hidden, batch_first=True, bidirectional=bidir)
    x = _wave((5, 250, d_in), hidden)
    with torch.inference_mode():
        out, _ = g(torch.from_numpy(x))
    ref, _ = gru_sequence(jnp.asarray(x), _jgru(g))
    if bidir:
        rb, _ = gru_sequence(jnp.asarray(x), _jgru(g, "_reverse"), reverse=True)
        ref = jnp.concatenate([ref, rb], axis=-1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_prelu_matches():
    x = _wave((2, 3, 4, 5), 1)
    a = np.array([0.25], np.float32)
    out = torch.nn.functional.prelu(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jprelu(jnp.asarray(x), jnp.asarray(a))),
                               atol=1e-7)


def test_layer_norm_over_bins_and_channels_matches():
    """LayerNorm over (33, 16) with eps 1e-8, as the DPGRNNs use it."""
    x = _wave((2, 7, 33, 16), 2)
    g, b = 1.0 + _wave((33, 16), 3), _wave((33, 16), 4)
    out = layer_norm_apply(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b))
    ref = jlayer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-6)
