"""Kernel K3 (``csrc/resample_poly.cu``) on the CPU: its walk over the
outputs (``dsp/resample.py::_polyphase_walk``: the tile, the thread's
residue and period, the phase, the newest input sample, the taps that fall
on samples), summed in float64 and rounded once, equals scipy's
``resample_poly`` (``resample_host``) to the bit at 16 <-> 44.1 kHz, for
``[T]`` and ``[C, T]``, at lengths down to one sample; the phase bank holds
every tap of the filter once; and the wrapper's guards.  The kernel itself
runs only on the card (``chip_smoke.py``'s K3 phase)."""
from __future__ import annotations

import ast
import inspect

import numpy as np
import pytest
import torch

from speech_diarization_tpu_torch.dsp import resample
from speech_diarization_tpu_torch.dsp.resample import (
    _poly_bank,
    _poly_filter,
    _polyphase_walk,
    resample_host,
    resample_poly,
)
from speech_diarization_tpu_torch.ops import cost, kernels

LEGS = [(16000, 44100, 441, 160), (44100, 16000, 160, 441)]
# one and two samples, shorter than half the filter (4,410 taps either
# way), odd, and three seconds
LENGTHS = [1, 2, 1001, 4411, 12345, "3s"]


def _wave(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _length(n, orig):
    return 3 * orig if n == "3s" else n


@pytest.mark.parametrize("leg", LEGS, ids=["16k-44.1k", "44.1k-16k"])
@pytest.mark.parametrize("n", LENGTHS)
def test_walk_equals_scipy_to_the_bit(leg, n):
    orig, target, up, down = leg
    t = _length(n, orig)
    y = _wave((2, t), t)
    ref = resample_host(y, orig, target)
    out = _polyphase_walk(torch.from_numpy(y), up, down)
    assert out.dtype == torch.float64 and out.shape == ref.shape
    np.testing.assert_array_equal(out.to(torch.float32).numpy(), ref)
    # a [T] wave walks as a row of the batch
    one = _polyphase_walk(torch.from_numpy(y[1]), up, down)
    assert torch.equal(one, out[1])
    np.testing.assert_array_equal(one.to(torch.float32).numpy(),
                                  resample_host(y[1], orig, target))


@pytest.mark.parametrize("leg", LEGS, ids=["16k-44.1k", "44.1k-16k"])
def test_bank_holds_every_tap_once(leg):
    _, _, up, down = leg
    h = _poly_filter(up, down)
    bank = _poly_bank(up, down)
    n_taps = -(-h.size // up)
    assert bank.shape == (up, n_taps) and bank.dtype == np.float64
    assert bank.flags.c_contiguous
    r, i = np.meshgrid(np.arange(up), np.arange(n_taps), indexing="ij")
    tap = r + i * up
    on = tap < h.size
    # each tap of the filter sits at exactly one (phase, index), the rest pad
    np.testing.assert_array_equal(np.sort(tap[on]), np.arange(h.size))
    np.testing.assert_array_equal(bank[on], h[tap[on]])
    assert not bank[~on].any()
    assert on.sum(axis=1).min() == h.size // up
    assert sorted(set(on.sum(axis=1))) in ([n_taps - 1, n_taps], [n_taps])


@pytest.mark.parametrize("leg", LEGS, ids=["16k-44.1k", "44.1k-16k"])
def test_cpu_wrapper_is_the_host_resampling(leg):
    orig, target, _, _ = leg
    y = _wave((3, 4411), 7)
    kernels.reset_launches()
    out = resample_poly(torch.from_numpy(y), orig, target)
    one = resample_poly(torch.from_numpy(y[2]), orig, target)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), resample_host(y, orig, target))
    assert torch.equal(one, out[2])
    assert kernels.LAUNCHES["resample_poly"] == 0
    x = torch.from_numpy(y)
    assert resample_poly(x, orig, orig) is x


def test_wrapper_refuses_other_ranks():
    with pytest.raises(ValueError, match=r"\[T\] or \[C, T\]"):
        resample_poly(torch.zeros(2, 2, 8), 16000, 44100)


def test_a_cuda_tensor_never_takes_the_host_resampling():
    """Without a card a CUDA tensor cannot exist here; the wrapper's only
    route to scipy is the tensor's device being the CPU, and no ``try``
    falls back."""
    src = inspect.getsource(resample.resample_poly)
    assert src.count("resample_host(") == 1
    assert 'if y.device.type == "cpu":' in src
    assert "kernels.launch(" in src
    assert not any(isinstance(n, ast.Try) for n in ast.walk(ast.parse(src)))


def test_no_path_stuffs_zeros():
    """The zero-stuffed convolution is gone: nothing in the resampling
    module convolves."""
    src = inspect.getsource(resample)
    assert "conv1d" not in src and "new_zeros" not in src


@pytest.mark.parametrize("leg", LEGS, ids=["16k-44.1k", "44.1k-16k"])
def test_work_counts_the_taps_that_fall_on_samples(leg):
    orig, target, up, down = leg
    t = 3 * orig
    n_out = -(-t * up // down)
    w = cost.resample_poly_work(1, t, n_out, up, down)
    # away from the ends every output meets len(h) / up taps on average
    taps = _poly_filter(up, down).size
    assert w["ops"]["f64"] == w["flops"] == 2 * n_out * taps // up
    assert w["bytes"] == 4 * (t + n_out) + 8 * _poly_bank(up, down).size
    ms, kind = cost.bound(w["bytes"], w["ops"])
    assert ms > 0 and kind in ("bytes", "operations")
