"""``sliding_mean_time``'s two forms (banded and cumsum) in the port
against the JAX package's, and the trunk's sliding SE at a window past the
banded form's reach.

Bars.  At the reference's own cases (T up to 513) both forms match the
per-position loop at atol 1e-5, the bar of tests/test_layers.py.  Over
longer rows a float32 prefix sum loses digits with its magnitude: at T
6400 the two forms differ from a float64 reference by up to 9e-7 of the
mean's peak on log-mel-like rows, and the port's and the JAX package's
cumsum (each float32, summed in its own order) by up to 7e-7 of the
input's largest magnitude; the bar is 4e-6 of that magnitude (TOL_REL).
The trunk (small width, float32) with ``se_win=1201`` is held to the JAX
trunk at 1e-5 of its output's peak.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.models import layers as jlayers
from speech_diarization_tpu.models.ecapa import EcapaTdnn as JEcapaTdnn
from speech_diarization_tpu.train.recipes import _flatten
from speech_diarization_tpu_torch.models.layers import sliding_mean_time
from speech_diarization_tpu_torch.models.port import params_from_numpy

torch.set_num_threads(4)
TOL_REL = 4e-6


def _ref(x, win):
    """Per-position mean over the clamped window, float64."""
    h0, h1 = win // 2, win - 1 - win // 2
    t = x.shape[-1]
    cs = np.concatenate([np.zeros(x.shape[:-1] + (1,)),
                         np.cumsum(x.astype(np.float64), -1)], -1)
    pos = np.arange(t)
    hi, lo = np.clip(pos + h1 + 1, 0, t), np.clip(pos - h0, 0, t)
    return (cs[..., hi] - cs[..., lo]) / (hi - lo)


def _port(x, win, backend="auto"):
    return sliding_mean_time(torch.from_numpy(x), win, backend=backend).numpy()


def _jax(x, win, backend="auto"):
    return np.asarray(jlayers.sliding_mean_time(jnp.asarray(x), win,
                                                backend=backend))


@pytest.mark.parametrize("t,win", [(50, 7), (100, 201), (33, 33), (10, 4),
                                   (7, 20), (300, 257), (513, 128)])
@pytest.mark.parametrize("backend", ["banded", "cumsum"])
def test_reference_cases(t, win, backend):
    x = np.random.default_rng(3).standard_normal((2, 5, t)).astype(np.float32)
    got = _port(x, win, backend)
    np.testing.assert_allclose(got, _ref(x, win), atol=1e-5)
    np.testing.assert_allclose(got, _jax(x, win, backend), atol=1e-5)


@pytest.mark.parametrize("half,t", [(513, 1100), (600, 6400), (1500, 8000)])
def test_cumsum_past_the_banded_reach_matches_jax(half, t):
    """Half-widths over 512: ``auto`` takes the cumsum form in both
    packages, on log-mel-like rows (offset -8, spread 3)."""
    g = np.random.default_rng(half)
    x = (g.standard_normal((1, 6, t)) * 3.0 - 8.0).astype(np.float32)
    win = 2 * half + 1
    got = _port(x, win)
    bar = TOL_REL * np.abs(x).max()
    assert np.abs(got - _jax(x, win)).max() <= bar
    assert np.abs(got - _ref(x, win)).max() <= bar
    np.testing.assert_array_equal(got, _port(x, win, "cumsum"))


def test_forms_agree_where_both_apply():
    """At half-width 512 (``win`` 1025) the forms agree on a 6400-frame
    row within the bar."""
    x = (np.random.default_rng(1).standard_normal((1, 8, 6400)) * 3 - 8
         ).astype(np.float32)
    d = np.abs(_port(x, 1025, "banded") - _port(x, 1025, "cumsum")).max()
    assert d <= TOL_REL * np.abs(x).max()
    np.testing.assert_array_equal(_port(x, 1025), _port(x, 1025, "banded"))


def test_environment_override(monkeypatch):
    x = np.random.default_rng(2).standard_normal((3, 900)).astype(np.float32)
    monkeypatch.setenv("SDTPU_SLIDING_BACKEND", "cumsum")
    np.testing.assert_array_equal(_port(x, 101), _port(x, 101, "cumsum"))
    monkeypatch.setenv("SDTPU_SLIDING_BACKEND", "banded")
    np.testing.assert_array_equal(_port(x, 1201), _port(x, 1201, "banded"))
    with pytest.raises(ValueError, match="unknown backend"):
        _port(x, 11, "scan")


def test_trunk_with_a_long_sliding_se_matches_jax():
    """``se_win=1201`` (half-width 600: the cumsum form in both packages)
    through the trunk of a small ECAPA on 1400 frames."""
    cfg = dict(n_mels=8, channels=16, scale=4, se_channels=8, att_channels=8,
               emb_dim=12)
    net = JEcapaTdnn(**cfg, dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(0))
    port = params_from_numpy({k: np.asarray(v) for k, v in _flatten(params).items()},
                             {"net": {**cfg, "dilations": [2, 3, 4]}}).net.eval()
    feats = np.random.default_rng(4).standard_normal((1, 1400, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, f: net.trunk(p, f, se_win=1201))(
        params, jnp.asarray(feats)))
    with torch.no_grad():
        got = port.trunk(torch.from_numpy(feats), se_win=1201).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
