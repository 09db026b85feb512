"""The port's published ZipEnhancer graph (``models/zipenhancer_ref.py``),
its ModelScope importer (``models/port_zipenhancer.py``), the
``zipenhancer-ref`` enhancer and the ``enhance --backend zipenhancer-ref``
subcommand against the JAX package, on the same numpy-seeded inputs.

Both sides load one numpy draw (``models.registry.seeded_state_dict`` of
the JAX manifest, seed 0) or the JAX ``init`` converted to numpy.

The first frame of a reflect-centred STFT is symmetric about its middle, so
its imaginary parts (and the DC and Nyquist bins') are zero in exact
arithmetic and rounding noise as computed; ``atan2`` turns the noise's sign
into an input phase of +pi or -pi wherever the real part is negative, and
the graph's output follows (ROADMAP F18).  The port sets those entries to
+0 (``exact_zero_imag``); a whole-graph comparison gives the JAX graph the
same spectrum (:func:`exact_spectrum`).  The STFT itself is held against
the JAX one separately.

Bars: primitives within 1e-6 absolute (SwooshL/R, BiasNorm, the bypass)
or 1e-5 (the relative position encoding, the relative position scores at
even and odd lengths, instance norm, PReLU, the sub-pixel upsample, the
dense block, the Zipformer2 encoder); the spectrum within 3e-6; the graph at
the JAX tests' tiny configuration and at the published width (0.25 s)
within 1e-5 of the output's peak; ``make_enhance_fn('zipenhancer-ref')``
(3 s, two windows) and the subcommand within 1e-4 of the peak.  Manifests
and parameter counts equal the JAX ones (3,495,276 at the published
defaults); the importer's strict refusals carry the JAX messages.
"""
from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.models.port_zipenhancer as jpz
import speech_diarization_tpu.models.zipenhancer_ref as jzr
import speech_diarization_tpu.pipelines.enhance as jenhance
import speech_diarization_tpu_torch.models.port_zipenhancer as tpz
import speech_diarization_tpu_torch.models.zipenhancer_ref as tzr
from speech_diarization_tpu.cli import main as jmain
from speech_diarization_tpu.dsp.stft import sqrt_hann_window as jsqrt_hann
from speech_diarization_tpu.dsp.stft import stft_ri as jstft_ri
from speech_diarization_tpu.models.layers import conv1d_torch as jconv1d
from speech_diarization_tpu_torch.cli import main
from speech_diarization_tpu_torch.dsp.stft import stft_ri
from speech_diarization_tpu_torch.io.audio import read_wav, write_wav
from speech_diarization_tpu_torch.models.registry import seeded_state_dict
from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn

torch.set_num_threads(2)
SR = 16000
TINY = dict(n_fft=400, hop=100, dense_channel=16, num_tsblocks=1, num_layers=1,
            heads=2, query_head_dim=8, pos_head_dim=4, value_head_dim=8,
            pos_dim=16, feedforward_dim=48, conv_kernel=7)
LAYER = dict(heads=2, query_head_dim=8, pos_head_dim=4, value_head_dim=8,
             conv_kernel=7)


def _wave(shape, seed=0, scale=0.1):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load(net: torch.nn.Module, params) -> torch.nn.Module:
    net.load_state_dict({k: _t(v) for k, v in params.items()}, strict=True)
    return net.eval()


def exact_spectrum(y, n_fft, hop, window=None):
    """The JAX STFT with the port's exact zeros (``exact_zero_imag``)."""
    spec = jstft_ri(y, n_fft, hop, window=window)
    keep = np.ones(spec.shape[-3:-1], bool)
    keep[0] = keep[-1] = False
    keep[:, 0] = False
    return spec.at[..., 1].set(jnp.where(jnp.asarray(keep), spec[..., 1], 0.0))


@pytest.fixture
def exact_jax(monkeypatch):
    monkeypatch.setattr(jzr, "stft_ri", exact_spectrum)


@pytest.fixture(scope="module")
def tiny():
    jm = jzr.ZipEnhancerRef(**TINY)
    sd = seeded_state_dict(jpz.zipenhancer_manifest(jm), 0)
    return jm, {k: jnp.asarray(v) for k, v in sd.items()}, _load(tzr.ZipEnhancerRef(**TINY), sd)


# ---------------------------------------------------------- primitives ---
def test_swoosh_matches():
    x = np.linspace(-30.0, 30.0, 2001, dtype=np.float32)
    for jf, tf in ((jzr.swoosh_l, tzr.swoosh_l), (jzr.swoosh_r, tzr.swoosh_r)):
        np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                                   atol=1e-6)


@pytest.mark.parametrize("seq_len,pos_dim", [(7, 16), (8, 16), (81, 48), (161, 48)])
def test_rel_pos_encoding_matches(seq_len, pos_dim):
    ref = np.asarray(jzr.compact_rel_pos_encoding(seq_len, pos_dim))
    # float32 arguments reach 36 rad: 1e-5 is a few of their rounding steps
    np.testing.assert_allclose(tzr.compact_rel_pos_encoding(seq_len, pos_dim).numpy(),
                               ref, atol=1e-5)


@pytest.mark.parametrize("s", [7, 8, 51, 81], ids=["odd", "even", "odd-freq", "odd-time"])
def test_rel_pos_scores_are_the_jax_rel_shift(s):
    """The gathered offset table gives ``rel_shift`` of the full score
    table, at even and odd lengths (81 = 161 frames downsampled by 2)."""
    rng = np.random.default_rng(s)
    pq = rng.standard_normal((3, s, 2, 4)).astype(np.float32)
    pp = rng.standard_normal((2 * s - 1, 2, 4)).astype(np.float32)
    ref = jzr.rel_shift(jnp.einsum("nshd,rhd->nhsr", pq, pp), s)
    np.testing.assert_allclose(tzr.rel_pos_scores(_t(pq), _t(pp)).numpy(),
                               np.asarray(ref), atol=1e-5)


def test_bias_norm_and_bypass_match():
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((2, 2, 5, 6)).astype(np.float32)
    p = {"n.bias": rng.standard_normal(6).astype(np.float32),
         "n.log_scale": np.float32(0.3),
         "b.bypass_scale": np.array([-0.5, 0.0, 0.3, 0.7, 1.0, 1.5], np.float32)}
    norm = tzr.BiasNorm(6)
    norm.bias.data, norm.log_scale.data = _t(p["n.bias"]), _t(p["n.log_scale"])
    byp = tzr.Bypass(6)
    byp.bypass_scale.data = _t(p["b.bypass_scale"])
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    np.testing.assert_allclose(norm(_t(x)).numpy(),
                               np.asarray(jzr.bias_norm(jp, "n", jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(
        byp(_t(x), _t(y)).numpy(),
        np.asarray(jzr.bypass(jp, "b", jnp.asarray(x), jnp.asarray(y))), atol=1e-6)


def test_front_end_pieces_match(tiny):
    """Instance norm, PReLU, the sub-pixel upsample and the dense block on
    the tiny draw."""
    jm, p, net = tiny
    x = _wave((2, 16, 9, 11), 2, 1.0)
    enc = net.dense_encoder
    with torch.inference_mode():
        pairs = [
            (enc.dense_conv_1[1](_t(x)), jzr.instance_norm2d(p, "dense_encoder.dense_conv_1.1", x)),
            (enc.dense_conv_1[2](_t(x)), jzr.prelu(p, "dense_encoder.dense_conv_1.2", x)),
            (enc.dense_block(_t(x)), jzr.dense_block(p, "dense_encoder.dense_block", x)),
            (net.mask_decoder.mask_conv[0](_t(x)),
             jzr.sp_conv_transpose2d(p, "mask_decoder.mask_conv.0", x)),
        ]
    for out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("s", [160, 161], ids=["even", "odd"])
def test_zipformer_encoder_matches(tiny, s):
    """One downsampled Zipformer2 encoder (the time path of block 0) on
    sequences whose downsampled length is even (80) and odd (81)."""
    jm, p, net = tiny
    x = _wave((3, s, 16), 3, 1.0)
    with torch.inference_mode():
        out = net.ts_blocks[0].time(_t(x)).numpy()
    ref = jzr.downsampled_zipformer2_encoder(
        p, "ts_blocks.0.time", jnp.asarray(x), num_layers=1, downsample=2,
        pos_dim=16, **LAYER)
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


def test_depthwise_conv_matches(tiny):
    jm, p, net = tiny
    cm = net.ts_blocks[0].freq.encoder.layers[0].conv_module1
    x = _wave((2, 16, 13), 4, 1.0)
    pre = "ts_blocks.0.freq.encoder.layers.0.conv_module1.depthwise_conv"
    ref = jconv1d(jnp.asarray(x), p[f"{pre}.weight"], p[f"{pre}.bias"], padding=3,
                  groups=16)
    with torch.inference_mode():
        np.testing.assert_allclose(cm.depthwise_conv(_t(x)).numpy(), np.asarray(ref),
                                   atol=1e-5)


def test_spectrum_and_exact_zeros():
    """The port's STFT equals the JAX one; ``exact_zero_imag`` writes +0 at
    the DC and Nyquist bins and on the first frame and nowhere else."""
    y = _wave((2, 4100), 5)
    spec = stft_ri(_t(y), 400, 100)
    ref = np.asarray(jstft_ri(jnp.asarray(y), 400, 100, window=jsqrt_hann(400)))
    np.testing.assert_allclose(spec.numpy(), ref, atol=3e-6)
    im = tzr.exact_zero_imag(spec[..., 1], 400)
    zero = np.zeros(im.shape[1:], bool)
    zero[0] = zero[-1] = True
    zero[:, 0] = True
    assert torch.all(im[:, torch.from_numpy(zero)] == 0)
    assert not torch.signbit(im[:, torch.from_numpy(zero)]).any()
    assert torch.equal(im[:, torch.from_numpy(~zero)], spec[..., 1][:, torch.from_numpy(~zero)])
    # what the exact zeros are for: the computed first frame's imaginary
    # parts are noise, and their signs differ between the two packages
    assert np.abs(ref[:, :, 0, 1]).max() < 1e-5 * np.abs(ref[:, :, 0, 0]).max()


# ------------------------------------------------------ graph and manifest ---
@pytest.mark.parametrize("cfg", [TINY, {}], ids=["tiny", "published"])
def test_manifest_is_the_jax_one(cfg):
    man = tzr.ZipEnhancerRef(**cfg).manifest()
    assert man == jpz.zipenhancer_manifest(jzr.ZipEnhancerRef(**cfg))
    assert tpz.zipenhancer_manifest(tzr.ZipEnhancerRef(**cfg)) == man
    if not cfg:
        assert sum(int(np.prod(s)) for s in man.values()) == 3_495_276


def test_tiny_graph_matches_on_jax_init(exact_jax):
    jm = jzr.ZipEnhancerRef(**TINY)
    p = jm.init(jax.random.PRNGKey(0))
    net = _load(tzr.ZipEnhancerRef(**TINY), p)
    y = _wave((2, 4100), 6)
    ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(y)))
    with torch.inference_mode():
        out = net(_t(y)).numpy()
    assert out.shape == (2, 4100)
    assert _rel(out, ref) <= 1e-5


def test_tiny_apply_spec_matches(tiny):
    """The spectral graph alone on the same compressed magnitude and phase:
    the mask is bounded by beta and the phase by pi in both."""
    jm, p, net = tiny
    rng = np.random.default_rng(7)
    mag = np.abs(rng.standard_normal((2, 9, 201))).astype(np.float32)
    pha = rng.uniform(-np.pi, np.pi, (2, 9, 201)).astype(np.float32)
    ref_m, ref_p = jm.apply_spec(p, jnp.asarray(mag), jnp.asarray(pha))
    with torch.inference_mode():
        out_m, out_p = net.apply_spec(_t(mag), _t(pha))
    assert _rel(out_m.numpy(), ref_m) <= 1e-5
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=1e-4)
    assert float((out_m / _t(mag)).max()) <= 2.0 + 1e-5


def test_published_width_matches(exact_jax):
    """The published configuration on 0.25 s (two items) on the seeded
    draw."""
    jm = jzr.ZipEnhancerRef()
    sd = seeded_state_dict(jpz.zipenhancer_manifest(jm), 0)
    net = _load(tzr.ZipEnhancerRef(), sd)
    y = _wave((2, 4000), 8)
    ref = np.asarray(jax.jit(jm.apply)({k: jnp.asarray(v) for k, v in sd.items()},
                                       jnp.asarray(y)))
    with torch.inference_mode():
        out = net(_t(y)).numpy()
    assert np.isfinite(out).all()
    assert _rel(out, ref) <= 1e-5


# ------------------------------------------------------------ importer ---
def _modelscope_state(sd) -> dict:
    """A ModelScope-style state_dict: ``generator.``-prefixed tensors, one
    balancer entry and one ``num_batches_tracked`` entry to drop."""
    out = {f"generator.{k}": _t(v) for k, v in sd.items()}
    out["generator.ts_blocks.0.time.encoder.layers.0.balancer1.prob"] = torch.zeros(1)
    out["generator.dense_encoder.dense_conv_1.1.num_batches_tracked"] = torch.zeros(
        (), dtype=torch.long)
    return out


@pytest.mark.parametrize("form", ["mapping", "file", "file-under-state_dict"])
def test_modelscope_import_round_trips(tiny, tmp_path, form):
    jm, p, net = tiny
    src = _modelscope_state(p)
    ref = jpz.load_zipenhancer_modelscope(src, jm)
    if form != "mapping":
        path = tmp_path / "pytorch_model.bin"
        torch.save(src if form == "file" else {"state_dict": src}, path)
        src = path
    loaded = tpz.load_zipenhancer_modelscope(src, tzr.ZipEnhancerRef(**TINY))
    assert not loaded.training
    state = loaded.state_dict()
    assert set(state) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_modelscope_strict_refusals_carry_the_jax_messages(tiny, fault):
    jm, p, _ = tiny
    sd = {k: np.asarray(v) for k, v in p.items()}
    if fault == "missing":
        sd.pop("mask_decoder.lsigmoid.slope")
    elif fault == "unexpected":
        sd["phase_decoder.extra.weight"] = np.zeros(3, np.float32)
    else:
        sd["dense_encoder.dense_conv_1.0.weight"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError) as jerr:
        jpz.load_zipenhancer_modelscope(sd, jm)
    with pytest.raises(ValueError) as err:
        tpz.load_zipenhancer_modelscope(sd, tzr.ZipEnhancerRef(**TINY))
    assert str(err.value) == str(jerr.value)


def test_strip_prefix_matches():
    sd = {"module.model.generator.dense_encoder.a": 1, "module.model.generator.ts_blocks.b": 2,
          "module.model.other.c": 3}
    assert tpz._strip_prefix(sd) == jpz._strip_prefix(sd) == {
        "dense_encoder.a": 1, "ts_blocks.b": 2}
    bare = {"dense_encoder.a": 1}
    assert tpz._strip_prefix(bare) == jpz._strip_prefix(bare) == bare


# ---------------------------------------------- enhancer and subcommand ---
@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The seeded published-width draw as an ``.npz`` and as a ModelScope
    ``pytorch_model.bin``."""
    base = tmp_path_factory.mktemp("zipref")
    sd = seeded_state_dict(jpz.zipenhancer_manifest(jzr.ZipEnhancerRef()), 0)
    np.savez(base / "zipref.npz", **sd)
    torch.save({"model": _modelscope_state(sd)}, base / "pytorch_model.bin")
    return sd, base


def test_make_enhance_fn_matches(published, exact_jax, monkeypatch):
    """``make_enhance_fn('zipenhancer-ref')`` of an ``.npz`` on 3 s (two
    2 s windows, batches of two on both sides)."""
    sd, base = published
    y = _wave(3 * SR, 9, 0.2)
    ref = np.asarray(jenhance.make_enhance_fn(
        "zipenhancer-ref", weights=str(base / "zipref.npz"), batch_size=2)(jnp.asarray(y)))
    out = make_enhance_fn("zipenhancer-ref", weights=str(base / "zipref.npz"),
                          device="cpu", batch_size=2)(_t(y))
    assert _rel(out.numpy(), ref) <= 1e-4


def test_random_weights_warn_and_follow_the_seed():
    seen: list[str] = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    log = logging.getLogger("sdtpu")      # its loggers do not propagate
    log.addHandler(handler)
    try:
        fn = make_enhance_fn("zipenhancer-ref", device="cpu", batch_size=1)
    finally:
        log.removeHandler(handler)
    assert any("RANDOM weights" in m for m in seen)
    y = _t(_wave(SR, 10))
    a = fn(y)
    b = make_enhance_fn("zipenhancer-ref", device="cpu", batch_size=1)(y)
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_enhance_subcommand_loads_a_modelscope_bundle(published, tmp_path, exact_jax,
                                                      monkeypatch):
    """``enhance --backend zipenhancer-ref --weights pytorch_model.bin`` in
    both CLIs on one 2.5 s WAV."""
    _, base = published
    monkeypatch.setattr(jenhance, "windowed_enhance",
                        partial(jenhance.windowed_enhance, batch_size=2))
    outs = {}
    for side, fn in (("jax", jmain), ("port", main)):
        root = tmp_path / side / "in"
        write_wav(root / "a.wav", _wave(int(2.5 * SR), 11, 0.2), SR)
        argv = ["enhance", str(root), "--backend", "zipenhancer-ref", "--weights",
                str(base / "pytorch_model.bin")]
        assert fn(argv + (["--cpu"] if side == "port" else [])) == 0
        outs[side] = read_wav(root.with_name("in-enhanced") / "a.wav")[0]
    assert _rel(outs["port"], outs["jax"]) <= 1e-4
