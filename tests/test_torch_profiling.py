"""``utils/profiling.py`` against the JAX package's: ``Profiler``'s spans
and report (and its ``torch.profiler`` trace), ``count_params`` on the
shipped checkpoints, ``model_complexity`` against XLA's cost analysis, and
the kernels' analytic counts (``ops/cost.py``) against what the counter
reads on their plain versions.

Bars.  ``count_params`` equals the JAX count exactly.  ``model_complexity``
equals XLA's exactly on a GEMM (flops and bytes) and on an unpadded Conv1d
(flops; XLA's CPU bytes also count its layout copies).  On the ECAPA trunk
(small width, 300 frames) the port counts only products and XLA also the
elementwise work: the port's flops are 0.8935 of XLA's (held within
0.005), its bytes 1.44x (no fusion).  The analytic counts equal the
counter's on the dense plain versions exactly; the blocked one-waveform
log-mel pads its 400 taps to 3 blocks of 160 and reads 480/400 of the DFT
products.
"""
from __future__ import annotations

import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from speech_diarization_tpu.models.ecapa import EcapaTdnn as JEcapaTdnn
from speech_diarization_tpu.models.layers import conv1d_torch as jconv1d
from speech_diarization_tpu.models.port import load_params_npz as jload_npz
from speech_diarization_tpu.train import recipes as jrecipes
from speech_diarization_tpu.utils import profiling as jprof
from speech_diarization_tpu_torch.dsp import mel
from speech_diarization_tpu_torch.models import port
from speech_diarization_tpu_torch.models.ecapa import _asp_grid_stats_plain
from speech_diarization_tpu_torch.ops import cost, kernels
from speech_diarization_tpu_torch.train import recipes
from speech_diarization_tpu_torch.utils import Profiler, count_params, model_complexity

torch.set_num_threads(4)
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _flops(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def test_profiler_spans_and_report_match_jax():
    ours, theirs = Profiler(), jprof.Profiler()
    for p in (ours, theirs):
        for name in ("b", "a", "b"):
            with p.span(name):
                time.sleep(0.001)
        with pytest.raises(KeyError):
            with p.span("c"):
                raise KeyError("a span closes on an error")
    r, j = ours.report(), theirs.report()
    assert list(r) == list(j) == ["a", "b", "c"]
    for k in r:
        assert r[k].keys() == j[k].keys()
        assert r[k]["calls"] == j[k]["calls"]
        assert r[k]["mean_s"] == pytest.approx(r[k]["total_s"] / r[k]["calls"])
    assert r["b"]["total_s"] >= 0.002


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with Profiler().trace(tmp_path / "t") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


@pytest.mark.parametrize("name,jload,load,warm", [
    ("ecapa_robust_stream.npz", jload_npz, "load_speaker_encoder", None),
    ("vad_conv_mc.npz", jrecipes.load_vad_weights, "load_vad", "load_vad_weights"),
    ("segmentation_conv.npz", jrecipes.load_segmentation_weights,
     "load_segmentation", "load_segmentation_weights"),
    ("demix_synthetic.npz", jrecipes.load_demixer_weights, "load_demixer",
     "load_demixer_weights"),
])
def test_count_params_equals_jax(name, jload, load, warm):
    """The module (BatchNorm statistics are buffers in the port, leaves in
    the JAX tree), the warm-start state dict and the flat npz all count
    what the JAX package counts on its tree; float16 storage counts
    elements."""
    path = WEIGHTS / name
    ref = jprof.count_params(jload(path))
    built = getattr(port, load)(path)
    assert count_params(getattr(built, "net", built)) == ref
    assert count_params(port.load_params_npz(path)) == ref
    if warm is not None:
        assert count_params(getattr(recipes, warm)(path)) == ref


def test_model_complexity_exact_on_a_gemm_and_a_conv():
    g = np.random.default_rng(0)
    a = g.standard_normal((64, 128)).astype(np.float32)
    b = g.standard_normal((128, 32)).astype(np.float32)
    got = model_complexity(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got == jprof.model_complexity(lambda x, y: x @ y, a, b)
    x = g.standard_normal((2, 16, 100)).astype(np.float32)
    w = g.standard_normal((24, 16, 5)).astype(np.float32)
    got = model_complexity(torch.nn.functional.conv1d, torch.from_numpy(x),
                           torch.from_numpy(w))
    ref = jprof.model_complexity(lambda x, w: jconv1d(x, w), x, w)
    assert got["flops"] == ref["flops"] == 2 * 2 * 24 * 96 * 16 * 5
    assert got["bytes_accessed"] == 4 * (x.size + w.size + 2 * 24 * 96)


def test_model_complexity_on_the_ecapa_trunk():
    cfg = dict(n_mels=8, channels=16, scale=4, se_channels=8, att_channels=8,
               emb_dim=12)
    net = JEcapaTdnn(**cfg, dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(0))
    tnet = port.params_from_numpy(
        {k: np.asarray(v) for k, v in jrecipes._flatten(params).items()},
        {"net": {**cfg, "dilations": [2, 3, 4]}}).net.eval()
    f = np.random.default_rng(4).standard_normal((1, 300, 8)).astype(np.float32)
    ref = jprof.model_complexity(lambda f: net.trunk(params, f), jnp.asarray(f))
    with torch.no_grad():
        got = model_complexity(tnet.trunk, torch.from_numpy(f))
        with FlopCounterMode(display=False) as fc:
            tnet.trunk(torch.from_numpy(f))
    ops = {str(op) for counts in fc.get_flop_counts().values() for op in counts}
    assert ops <= {"aten.convolution", "aten.mm", "aten.bmm", "aten.addmm"}, ops
    assert abs(got["flops"] / ref["flops"] - 0.8935) < 0.005
    assert 1.3 < got["bytes_accessed"] / ref["bytes_accessed"] < 1.6


@pytest.mark.parametrize("shape,n_mels", [((3, 8000), 40), ((2, 4000), 80)])
def test_log_mel_counts(shape, n_mels):
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(shape)
                         .astype(np.float32))
    n_frames = shape[0] * (shape[1] // 160 + 1)
    work = cost.fused_log_mel_work(n_frames, n_mels, y.numel())
    assert _flops(mel._log_mel_batched, y, 16000, n_mels) == work["flops"]
    # the blocked form: 3 blocks of 160 taps stand for the 400 of a frame
    one = cost.fused_log_mel_work(n_frames // shape[0], n_mels, shape[1])
    dft = one["flops"] - 2 * 201 * n_mels * (n_frames // shape[0])
    assert _flops(mel._log_mel_1d, y[0], 16000, n_mels) == (
        one["flops"] - dft + dft * 480 // 400)
    # on the CPU the wrapper runs the plain version, which the counter sees
    assert model_complexity(mel.fused_log_mel, y, 16000, n_mels)["flops"] == work["flops"]
    b, kind = cost.bound(work["bytes"], work["ops"])
    assert b > 0 and kind in ("bytes", "operations")


def test_asp_grid_counts():
    g = np.random.default_rng(2)
    cc, a, hop_f, win_f, n_w = 48, 16, 5, 21, 7
    n_rows = (n_w - 1) * hop_f + win_f
    t = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))
    args = (t(cc, n_rows + 3), t(n_w, a), t(a, cc), t(a), t(a), t(cc, a), t(cc),
            0, hop_f, win_f, n_w)
    work = cost.asp_grid_work(cc, a, hop_f, win_f, n_w)
    assert _flops(_asp_grid_stats_plain, *args) == work["flops"]
    assert work["ops"]["bf16_tensor"] == work["flops"]


def test_model_complexity_adds_the_launches_it_cannot_see(monkeypatch):
    """A kernel launch (a stub library here) adds its analytic work; a
    launch outside the tally adds nothing to it."""
    from types import SimpleNamespace

    monkeypatch.setattr(kernels, "library",
                        lambda name: SimpleNamespace(sdt_fused_log_mel=lambda *a: 0))
    work = cost.fused_log_mel_work(101, 40, 16000)

    def fn():
        kernels.launch("fused_log_mel", work=lambda: work)
        return torch.ones(8, 8) @ torch.ones(8, 8)

    kernels.reset_launches()
    got = model_complexity(fn)
    assert got["flops"] == work["flops"] + 2 * 8 ** 3
    # two ones (written) and the product (two read, one written)
    assert got["bytes_accessed"] == work["bytes"] + 5 * 8 * 8 * 4
    fn()
    assert kernels.LAUNCHES["fused_log_mel"] == 2 and not kernels._TALLIES
    kernels.reset_launches()
