"""The PyTorch port's ECAPA grid and kernel K1's plain version against the
JAX package (the Pallas kernel in interpret mode, as
tests/test_asp_grid_pallas.py runs it).

Bars (stated per test): the decomposed grid head in float32 matches the JAX
decomposed head to rel < 1e-5; the K1 path (bf16 operands, as the Pallas
kernel) matches the Pallas kernel at min-cos > 0.9999 and rel < 5e-3 (the
bars of tests/test_asp_grid_pallas.py); the full-width shipped encoder's
grid matches per window at cos > 0.9999 in float32.
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from speech_diarization_tpu.models.ecapa import EcapaTdnn as JEcapaTdnn
from speech_diarization_tpu.models.layers import sliding_mean_time as jsliding
from speech_diarization_tpu.ops.pallas.asp_grid import asp_grid_stats as jasp_stats
from speech_diarization_tpu.train.recipes import _flatten
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu_torch.models.ecapa import (
    _asp_grid_stats_plain,
    _k1_features,
    _rows_from,
    asp_grid_stats,
)
from speech_diarization_tpu_torch.models.layers import sliding_mean_time
from speech_diarization_tpu_torch.models.port import (
    load_speaker_encoder,
    params_from_numpy,
)

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "ecapa_robust_stream.npz"
CASES = [(0, 4, 17, 10), (8, 4, 17, 16), (3, 6, 21, 5)]


def _tiny_net():
    """tests/test_asp_grid_pallas.py::_tiny_net, carried across."""
    cfg = dict(n_mels=8, channels=16, scale=4, se_channels=8, att_channels=8,
               emb_dim=12)
    net = JEcapaTdnn(**cfg, dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(0))
    a = net.att_channels
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    params["att_bn"] = {
        "gamma": 1.0 + 0.1 * jax.random.normal(k1, (a,)),
        "beta": 0.1 * jax.random.normal(k2, (a,)),
        "mean": 0.05 * jnp.arange(a, dtype=jnp.float32),
        "var": 1.0 + 0.02 * jnp.arange(a, dtype=jnp.float32),
    }
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    port = params_from_numpy(flat, {"net": {**cfg, "dilations": [2, 3, 4]}})
    return net, params, port.net


def _cos_rel(ref, out):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    cos = (ref * out).sum(1) / (np.linalg.norm(ref, axis=1)
                                * np.linalg.norm(out, axis=1) + 1e-30)
    return cos.min(), np.linalg.norm(ref - out) / np.linalg.norm(ref)


def _x(cc, first_f, hop_f, win_f, n_windows, seed=1):
    t_f = first_f + (n_windows - 1) * hop_f + win_f + 3
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (cc, t_f),
                                      jnp.float32))


@pytest.mark.parametrize("first_f,hop_f,win_f,n_windows", CASES)
def test_grid_head_matches_jax_decomposed(first_f, hop_f, win_f, n_windows):
    net, params, pnet = _tiny_net()
    x = _x(net.cat_channels, first_f, hop_f, win_f, n_windows)
    ref = np.asarray(net.asp_head_grid(params, jnp.asarray(x), first_f, hop_f,
                                       win_f, n_windows))
    out = pnet.asp_head_grid(torch.from_numpy(x), first_f, hop_f, win_f,
                             n_windows).numpy()
    assert out.shape == ref.shape == (n_windows, net.emb_dim)
    _, rel = _cos_rel(ref, out)
    assert rel < 1e-5, rel


@pytest.mark.parametrize("first_f,hop_f,win_f,n_windows", CASES)
def test_grid_head_train_mode_matches_jax(first_f, hop_f, win_f, n_windows):
    """``train=True``: both BatchNorms on the batch's statistics, per row of
    a batch as under the JAX ``vmap``."""
    net, params, pnet = _tiny_net()
    x = np.stack([_x(net.cat_channels, first_f, hop_f, win_f, n_windows, seed=s)
                  for s in (1, 2)])
    ref = np.asarray(jax.vmap(lambda xi: net.asp_head_grid(
        params, xi, first_f, hop_f, win_f, n_windows, train=True))(jnp.asarray(x)))
    out = pnet.asp_head_grid(torch.from_numpy(x), first_f, hop_f, win_f,
                             n_windows, train=True).numpy()
    one = pnet.asp_head_grid(torch.from_numpy(x[0]), first_f, hop_f, win_f,
                             n_windows, train=True).numpy()
    assert out.shape == ref.shape == (2, n_windows, net.emb_dim)
    for o, r in ((out[0], ref[0]), (out[1], ref[1]), (one, ref[0])):
        _, rel = _cos_rel(r, o)
        assert rel < 1e-5, rel


@pytest.mark.parametrize("first_f,hop_f,win_f,n_windows", CASES)
def test_kernel_path_matches_pallas_interpret(first_f, hop_f, win_f, n_windows):
    net, params, pnet = _tiny_net()
    x = _x(net.cat_channels, first_f, hop_f, win_f, n_windows)
    ref = np.asarray(net.asp_head_grid_pallas(params, jnp.asarray(x), first_f,
                                              hop_f, win_f, n_windows,
                                              interpret=True))
    out = pnet.asp_head_grid_kernel(torch.from_numpy(x), first_f, hop_f, win_f,
                                    n_windows).numpy()
    cmin, rel = _cos_rel(ref, out)
    assert cmin > 0.9999, cmin
    assert rel < 5e-3, rel
    # the float32 decomposed head agrees with the Pallas kernel at its bars
    dec = pnet.asp_head_grid(torch.from_numpy(x), first_f, hop_f, win_f,
                             n_windows).numpy()
    cmin, rel = _cos_rel(ref, dec)
    assert cmin > 0.9999 and rel < 5e-3, (cmin, rel)


def _stats_args(net, params, x, first_f, hop_f, win_f, n_w):
    """The inputs asp_head_grid_pallas hands the Pallas kernel, as numpy."""
    cc = net.cat_channels
    x32 = jnp.asarray(x)
    starts = first_f + hop_f * np.arange(n_w)
    cs1 = jnp.pad(jnp.cumsum(x32, axis=-1), ((0, 0), (1, 0)))
    cs2 = jnp.pad(jnp.cumsum(x32 * x32, axis=-1), ((0, 0), (1, 0)))
    mu_g = (cs1[:, starts + win_f] - cs1[:, starts]).T / win_f
    sd_g = jnp.sqrt(jnp.clip((cs2[:, starts + win_f] - cs2[:, starts]).T / win_f
                             - mu_g * mu_g, 1e-12))
    w1 = params["att_w1"][..., 0]
    bw = mu_g @ w1[:, cc:2 * cc].T + sd_g @ w1[:, 2 * cc:].T + params["att_b1"]
    ab = params["att_bn"]
    inv = jax.lax.rsqrt(ab["var"] + 1e-5)
    s_bn = ab["gamma"] * inv
    t_bn = ab["beta"] - ab["mean"] * s_bn
    return [np.array(a) for a in (x, bw, w1[:, :cc], s_bn, t_bn,
                                    params["att_w2"][..., 0], params["att_b2"])]


@pytest.mark.parametrize("first_f,hop_f,win_f,n_windows", CASES)
def test_plain_k1_stats_match_pallas_stats(first_f, hop_f, win_f, n_windows):
    """The plain version repeats the kernel's arithmetic (bf16 operands,
    float32 accumulation): the stats agree with the Pallas kernel's to
    rel 1e-3 (summation order and exp implementations differ)."""
    net, params, _ = _tiny_net()
    x = _x(net.cat_channels, first_f, hop_f, win_f, n_windows, seed=4)
    args = _stats_args(net, params, x, first_f, hop_f, win_f, n_windows)
    ref = np.asarray(jasp_stats(*map(jnp.asarray, args), first_f, hop_f,
                                win_f, n_windows, interpret=True))
    out = asp_grid_stats(*map(torch.from_numpy, args), first_f, hop_f, win_f,
                         n_windows).numpy()
    assert out.shape == ref.shape == (n_windows, 2 * net.cat_channels)
    assert np.abs(out - ref).max() <= 1e-3 * np.abs(ref).max()


def test_k1_masked_softmax_ignores_out_of_window():
    """Rows outside [start, start+win_f) must not leak into the stats: a
    spike planted just past the last window's end leaves its stats as
    they were (mirror of the Pallas test)."""
    net, params, _ = _tiny_net()
    first_f, hop_f, win_f, n_w = 0, 4, 9, 6
    x = _x(net.cat_channels, first_f, hop_f, win_f, n_w, seed=2)
    x = np.concatenate([x, np.asarray(jax.random.normal(
        jax.random.PRNGKey(9), (x.shape[0], 5)))], axis=1)

    def stats_of(xa):
        args = _stats_args(net, params, xa, first_f, hop_f, win_f, n_w)
        return _asp_grid_stats_plain(*map(torch.from_numpy, args), first_f,
                                     hop_f, win_f, n_w).numpy()

    base = stats_of(x)
    spiked = x.copy()
    spiked[:, first_f + (n_w - 1) * hop_f + win_f] = 50.0
    out = stats_of(spiked)
    np.testing.assert_allclose(out[-1], base[-1], rtol=1e-5, atol=1e-5)
    # a spike inside the last window does move its stats
    inside = x.copy()
    inside[:, first_f + (n_w - 1) * hop_f + win_f - 1] = 50.0
    assert not np.allclose(stats_of(inside)[-1], base[-1], atol=1e-3)


@pytest.mark.parametrize("t,win", [(300, 201), (100, 201), (700, 21), (1000, 200)])
def test_sliding_mean_matches_jax_banded(t, win):
    x = np.random.default_rng(t).standard_normal((2, 5, t)).astype(np.float32)
    ref = np.asarray(jsliding(jnp.asarray(x), win, backend="banded"))
    out = sliding_mean_time(torch.from_numpy(x), win).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-6)


def test_shipped_encoder_grid_full_width():
    """Full-width shipped encoder (C=256, CC=768, A=64) on a short chunk:
    per-window cos > 0.9999 in float32."""
    jm, jp = jload_enc(WEIGHTS)
    tm = load_speaker_encoder(WEIGHTS)
    w, _ = make_conversation(np.random.default_rng(5), 7.0, n_speakers=3, sr=SR)
    w = w.astype(np.float32)
    win, hop, margin = 2 * SR, SR // 10, SR
    n_w = (len(w) - 2 * margin - win) // hop + 1
    ref = np.asarray(jm.encode_grid_chunk(jp, jnp.asarray(w), n_w, margin, win,
                                          hop, backend="decomposed"))
    with torch.inference_mode():
        out = tm.encode_grid_chunk(torch.from_numpy(w), n_w, margin, win,
                                   hop).numpy()
    assert out.shape == ref.shape == (n_w, 128)
    cmin, _ = _cos_rel(ref, out)
    assert cmin > 0.9999, cmin


def test_k1_wrapper_cpu_is_plain_version():
    net, params, _ = _tiny_net()
    x = _x(net.cat_channels, 0, 4, 17, 10)
    args = [torch.from_numpy(a) for a in _stats_args(net, params, x, 0, 4, 17, 10)]
    torch.testing.assert_close(asp_grid_stats(*args, 0, 4, 17, 10),
                               _asp_grid_stats_plain(*args, 0, 4, 17, 10),
                               rtol=0, atol=0)


def test_shared_log_mel_serves_vad_and_encoder():
    """The port computes the chunk's log-mel once and hands it to both the
    VAD and the encoder; each consumer gets what the JAX package computes
    on its own from the waveform (VAD probs atol 1e-4, grid cos > 0.9999)."""
    from speech_diarization_tpu.train.recipes import load_vad as jload_vad
    from speech_diarization_tpu_torch.dsp.mel import fused_log_mel
    from speech_diarization_tpu_torch.models.port import load_vad

    vad_w = WEIGHTS.parent / "vad_conv_mc.npz"
    jv, jvp = jload_vad(vad_w)
    jm, jp = jload_enc(WEIGHTS)
    tv, tm = load_vad(vad_w), load_speaker_encoder(WEIGHTS)
    assert tv.net.n_mels == tm.net.n_mels == 40
    w, _ = make_conversation(np.random.default_rng(8), 6.0, n_speakers=2, sr=SR)
    w = w.astype(np.float32)
    win, hop, margin = 2 * SR, SR // 10, SR
    n_w = (len(w) - 2 * margin - win) // hop + 1
    with torch.inference_mode():
        feats = fused_log_mel(torch.from_numpy(w), n_mels=40)
        probs = tv.probs_from_feats(feats).numpy()
        grid = tm.encode_grid_feats(feats, n_w, margin, win, hop).numpy()
    np.testing.assert_allclose(probs, np.asarray(jv.probs(jvp, jnp.asarray(w))),
                               atol=1e-4)
    ref = np.asarray(jm.encode_grid_chunk(jp, jnp.asarray(w), n_w, margin, win,
                                          hop, backend="decomposed"))
    cmin, _ = _cos_rel(ref, grid)
    assert cmin > 0.9999, cmin


@pytest.mark.parametrize("t_f,first_f,n_rows,dtype", [
    (64, 3, 40, torch.bfloat16), (61, 0, 61, torch.float32),
    (50, 7, 55, torch.float32), (33, 30, 20, torch.bfloat16)])
def test_k1_features_are_channel_major_rows_with_zero_overrun(t_f, first_f,
                                                              n_rows, dtype):
    """The kernel's feature map holds the rows ``_rows_from`` hands the
    plain version, channel-major in bf16, zero where the grid overruns."""
    x = torch.from_numpy(np.random.default_rng(t_f).standard_normal(
        (16, t_f)).astype(np.float32)).to(dtype)
    xb = _k1_features(x, first_f, n_rows)
    assert xb.dtype == torch.bfloat16 and xb.is_contiguous()
    assert xb.shape == (16, max(t_f, first_f + n_rows))
    want = _rows_from(x, first_f, n_rows).to(torch.bfloat16)
    torch.testing.assert_close(xb[:, first_f:first_f + n_rows].t(), want,
                               rtol=0, atol=0)
    if dtype == torch.bfloat16 and first_f + n_rows <= t_f:
        assert xb.data_ptr() == x.data_ptr()       # no copy on the main path


def _asp_grid_stats_tiled(x, bw, w1x, s_bn, t_bn, w2, b2, first_f, hop_f,
                          win_f, n_windows, chunk=208):
    """K1's data flow (csrc/asp_grid.cu) in plain PyTorch: channel-major
    features from ``_k1_features``; a window walked in chunks of ``chunk``
    rows, the last padded to its full length with zero activations whose
    logits are masked to -inf; the logits transposed ([W, CC, rows]); no
    ``b2`` (constant over a channel's rows, so the softmax cancels it); one
    ``exp2`` per element with log2(e) folded in; unnormalised sums per
    chunk, merged into a running (max, sum p, sum p x, sum p x^2) and
    divided at the end."""
    del b2
    n_rows = (n_windows - 1) * hop_f + win_f
    bf = torch.bfloat16
    log2e = 1.4426950408889634
    xb = _k1_features(x, first_f, n_rows).float()                   # [CC, T_f]
    hx = w1x.to(bf).float() @ xb[:, first_f:first_f + n_rows]       # [A, R]
    hx = F.pad(hx, (0, chunk))
    xg = F.pad(xb[:, first_f:first_f + n_rows], (0, chunk))
    m = z = s1 = s2 = None
    for c0 in range(0, win_f, chunk):
        idx = (hop_f * torch.arange(n_windows)[:, None] + c0
               + torch.arange(chunk)[None, :])                      # [W, chunk]
        valid = c0 + torch.arange(chunk) < win_f
        h = hx[:, idx].permute(1, 2, 0) + bw.float()[:, None, :]    # [W, chunk, A]
        a = torch.tanh(F.relu(h) * s_bn.float() + t_bn.float())
        a = torch.where(valid[None, :, None], a, 0.0).to(bf).float()
        e = w2.to(bf).float() @ a.transpose(1, 2)                   # [W, CC, chunk]
        e = e.masked_fill(~valid, float("-inf"))
        mc = e.amax(-1)
        p = torch.exp2(e * log2e - mc[..., None] * log2e)
        xw = torch.where(valid, xg[:, idx].permute(1, 0, 2), 0.0)   # [W, CC, chunk]
        zc, s1c, s2c = p.sum(-1), (p * xw).sum(-1), (p * xw * xw).sum(-1)
        if m is None:
            m, z, s1, s2 = mc, zc, s1c, s2c
            continue
        mm = torch.maximum(m, mc)
        fs, fc = torch.exp2((m - mm) * log2e), torch.exp2((mc - mm) * log2e)
        m, z, s1, s2 = mm, z * fs + zc * fc, s1 * fs + s1c * fc, s2 * fs + s2c * fc
    mu = s1 / z
    sd = torch.sqrt(torch.clamp(s2 / z - mu * mu, min=1e-12))
    return torch.cat([mu, sd], dim=1)


@pytest.mark.parametrize("first_f,hop_f,win_f,n_windows,overrun,chunk", [
    (0, 4, 17, 10, 0, 208), (8, 4, 16, 5, 0, 208), (3, 10, 201, 3, 0, 208),
    (2, 3, 64, 7, 0, 208), (5, 3, 37, 7, 4, 208), (1, 10, 201, 2, 11, 208),
    (0, 1, 1, 4, 0, 208), (5, 3, 37, 7, 4, 16), (2, 7, 450, 2, 9, 208),
    (0, 10, 416, 2, 0, 208)])
def test_k1_tiled_flow_matches_plain(first_f, hop_f, win_f, n_windows, overrun,
                                     chunk):
    """Rows in padded chunks masked to -inf, transposed logits, no b2, exp2
    with the scale folded in, chunks merged through a running maximum: the
    kernel's data flow gives the plain version's stats (1e-5 of the largest;
    the card bar is 2e-3) and the Pallas kernel's (interpret mode, on the
    features with the overrun as zero rows) to the 1e-3 the plain version
    is held to."""
    net, params, _ = _tiny_net()
    x = _x(net.cat_channels, first_f, hop_f, win_f, n_windows, seed=6)
    args = _stats_args(net, params, x, first_f, hop_f, win_f, n_windows)
    t_cut = x.shape[1] - 3 - overrun
    x_zero = args[0].copy()
    x_zero[:, t_cut:] = 0.0
    args[0] = args[0][:, :t_cut]
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    ref = _asp_grid_stats_plain(*targs, first_f, hop_f, win_f, n_windows)
    out = _asp_grid_stats_tiled(*targs, first_f, hop_f, win_f, n_windows,
                                chunk=chunk)
    assert out.shape == ref.shape
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    jref = np.asarray(jasp_stats(jnp.asarray(x_zero), *map(jnp.asarray, args[1:]),
                                 first_f, hop_f, win_f, n_windows,
                                 interpret=True))
    assert np.abs(out.numpy() - jref).max() <= 1e-3 * np.abs(jref).max()
