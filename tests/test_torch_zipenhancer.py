"""The port's ZipEnhancer, its windowed enhancer and the ``enhance``
subcommand against the JAX package's ``models/zipenhancer.py``,
``pipelines/enhance.py`` and CLI, on the same numpy-seeded inputs.

Bars: the model at a small width (16 channels, 1 block, 2 heads) on
JAX-initialised weights within 1e-5 of the output's peak; on the shipped
``weights/zipenhancer_mc.npz`` at full width (64 channels, 4 blocks, 4
heads) on two 2 s windows within 1e-4 of it; ``windowed_enhance`` on 5 s
(three windows) within 1e-4 of the peak, whether the port's last batch is
short (the JAX package pads it with zero rows) or full.  Both branches of
the peak limit, and the window-sum normalization, with a gain as the model
(within 1e-6).  The subcommand writes the same files as the JAX CLI, with
samples within 1e-4.  The JAX model costs about 2.4 s a window on the CPU,
so each JAX result is computed once.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.pipelines.enhance as jenhance
from speech_diarization_tpu.cli import main as jmain
from speech_diarization_tpu.models.port import load_params_npz as jload_npz
from speech_diarization_tpu.models.zipenhancer import ZipEnhancerModel as JZip
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu_torch.cli import main
from speech_diarization_tpu_torch.io.audio import read_wav, write_wav
from speech_diarization_tpu_torch.models.port import load_zipenhancer
from speech_diarization_tpu_torch.models.zipenhancer import ZipEnhancerModel
from speech_diarization_tpu_torch.pipelines.enhance import (
    enhance_batch,
    make_enhance_fn,
    windowed_enhance,
)

torch.set_num_threads(2)
SR = 16000
NPZ = Path(__file__).resolve().parents[1] / "weights" / "zipenhancer_mc.npz"


def _noisy(seconds: float, seed: int = 5) -> np.ndarray:
    w, _ = make_conversation_heldout(np.random.default_rng(seed), seconds,
                                     n_speakers=2, sr=SR, snr_db=10.0,
                                     noise_kind="white")
    return w.astype(np.float32)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def net():
    return load_zipenhancer(NPZ)


@pytest.fixture(scope="module")
def jfwd():
    return jax.jit(partial(JZip().apply, jload_npz(NPZ)))


def test_state_dict_keys_are_the_npz_keys(net):
    with np.load(NPZ) as data:
        assert set(net.state_dict()) == set(data.files)
        assert len(data.files) == 110


def test_small_width_matches_on_jax_initialised_weights():
    jm = JZip(channels=16, blocks=1, heads=2)
    params = jm.init(jax.random.PRNGKey(0))
    net = ZipEnhancerModel(channels=16, blocks=1, heads=2)
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in params.items()}, strict=True)
    x = _noisy(4.0, seed=1).reshape(2, 2 * SR)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.inference_mode():
        out = net.eval()(torch.from_numpy(x)).numpy()
    assert _rel(out, ref) <= 1e-5


@pytest.fixture(scope="module")
def two_windows(jfwd):
    x = _noisy(4.0).reshape(2, 2 * SR)
    return x, np.asarray(jfwd(jnp.asarray(x)))


def test_shipped_net_matches_at_full_width(net, two_windows):
    x, ref = two_windows
    with torch.inference_mode():
        out = net(torch.from_numpy(x)).numpy()
    assert _rel(out, ref) <= 1e-4


def test_zero_rows_change_no_real_row(net, two_windows):
    """The rows of a batch are independent: the JAX package's zero padding
    rows, left out by the port, change no real row."""
    x = torch.from_numpy(two_windows[0])
    with torch.inference_mode():
        alone = net(x)
        padded = net(torch.cat([x, torch.zeros_like(x)]))[:2]
    assert float((alone - padded).abs().max() / alone.abs().max()) <= 1e-6


# ------------------------------------------------------ windowed_enhance --
@pytest.fixture(scope="module")
def five_s(jfwd):
    y = _noisy(5.0, seed=7)
    return y, np.asarray(jenhance.windowed_enhance(jfwd, y, batch_size=2))


@pytest.mark.parametrize("batch_size", [2, 3], ids=["short-last-batch", "full-batch"])
def test_windowed_enhance_matches(net, five_s, batch_size):
    y, ref = five_s
    seen = []

    def fn(b):
        seen.append(b.shape[0])
        return net(b)

    with torch.inference_mode():
        out = windowed_enhance(fn, torch.from_numpy(y), batch_size=batch_size)
    assert out.shape == (5 * SR,)
    assert sum(seen) == 3               # the three real windows only
    assert _rel(out.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("gain", [0.5, 8.0], ids=["under-the-limit", "limited"])
@pytest.mark.parametrize("seconds", [1.3, 5.0, 7.77])
def test_windowed_overlap_add_and_peak_limit_match(gain, seconds):
    """A gain as the model: the windowing, the normalized overlap-add and
    the peak limit alone, at lengths under one window, on the hop grid and
    off it."""
    y = _noisy(seconds, seed=3)
    ref = np.asarray(jenhance.windowed_enhance(lambda b: b * gain, y, batch_size=4))
    out = windowed_enhance(lambda b: b * gain, torch.from_numpy(y), batch_size=4)
    assert out.shape == y.shape
    peak = float(out.abs().max())
    assert (peak == pytest.approx(0.99, rel=1e-6)) == (gain > 1.0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6 * np.abs(ref).max())


def test_make_enhance_fn_is_the_shipped_net(net):
    y = torch.from_numpy(_noisy(2.5, seed=2))
    with torch.inference_mode():
        ref = windowed_enhance(net, y)
    out = make_enhance_fn("zipenhancer", device="cpu", batch_size=8)(y)
    assert torch.equal(out, ref)


# ------------------------------------------------------ the subcommand ----
@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """The same two short WAVs (one in a subdirectory) under two roots, one
    for each package's CLI (both write a sibling ``<root>-enhanced``)."""
    base = tmp_path_factory.mktemp("enh")
    roots = {}
    for side in ("jax", "port"):
        root = base / side / "in"
        write_wav(root / "a.wav", _noisy(3.0, seed=8), SR)
        write_wav(root / "sub" / "b.wav", _noisy(2.5, seed=9), SR)
        roots[side] = root
    return roots


def _tree(root: Path) -> dict[str, np.ndarray]:
    return {str(p.relative_to(root)): read_wav(p)[0]
            for p in sorted(root.rglob("*.wav"))}


@pytest.fixture(scope="module", params=["gtcrn", "zipenhancer"])
def cli_outputs(request, wav_dirs):
    backend = request.param
    mp = pytest.MonkeyPatch()
    # the JAX CLI pads each batch to 64 windows; the rows are independent,
    # so two a batch give the same output at a fraction of the CPU time
    mp.setattr(jenhance, "windowed_enhance",
               partial(jenhance.windowed_enhance, batch_size=2))
    try:
        assert jmain(["enhance", str(wav_dirs["jax"]), "--backend", backend]) == 0
    finally:
        mp.undo()
    assert main(["enhance", str(wav_dirs["port"]), "--backend", backend,
                 "--cpu"]) == 0
    out = {side: _tree(root.with_name("in-enhanced"))
           for side, root in wav_dirs.items()}
    rerun = enhance_batch(wav_dirs["port"], backend, device="cpu")
    for root in wav_dirs.values():
        for p in root.with_name("in-enhanced").rglob("*.wav"):
            p.unlink()
    return out, rerun


def test_enhance_subcommand_writes_what_the_jax_cli_writes(cli_outputs):
    out, rerun = cli_outputs
    assert sorted(out["port"]) == sorted(out["jax"]) == ["a.wav", "sub/b.wav"]
    for name, ref in out["jax"].items():
        assert out["port"][name].shape == ref.shape
        np.testing.assert_allclose(out["port"][name], ref, atol=1e-4)
    assert rerun == []                  # resume: every output exists


@pytest.mark.parametrize("argv", [["--weights", "pytorch_model.bin"],
                                  ["--weights", "model_trained_on_dns3.tar"]],
                         ids=["zipenhancer-ref", "tar-weights"])
def test_enhance_subcommand_refuses_the_published_graphs(tmp_path, argv):
    """A published graph's torch checkpoint (the ModelScope bundle, the
    GTCRN DNS3 tar) with the trainable ``--backend zipenhancer`` exits as
    the JAX CLI does, with its message (the graphs themselves run:
    ``tests/test_torch_zipenhancer_ref.py``, ``tests/test_torch_importers.py``)."""
    argv = ["enhance", str(tmp_path), "--backend", "zipenhancer", *argv]
    with pytest.raises(SystemExit) as err:
        main([*argv, "--cpu"])
    with pytest.raises(SystemExit) as jerr:
        jmain(argv)
    assert str(err.value) == str(jerr.value)
    assert "torch checkpoints are supported for --backend gtcrn" in str(err.value)
