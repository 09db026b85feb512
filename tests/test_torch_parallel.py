"""The port's ``parallel/`` against the JAX package's on the CPU.

The JAX side runs on the eight virtual CPU devices of ``tests/conftest.py``;
the port's mesh names the CPU eight times (its virtual mesh).  Both load one
JAX ``init`` of the small ECAPA of ``tests/test_sharded_inference.py``.

* ``default_mesh_shape`` / ``make_mesh``: the same [dp, tp] for n 1-8 and
  tp 1-3; without a card the default mesh raises.
* ``param_partition_specs``: the same leaves split over 'tp'.
* The sharded encoder at dp 8 and dp 4 x tp 2: within atol / rtol 1e-4
  (the JAX bar) of the port's single-device encoder, on a short batch too,
  and of the JAX ``make_sharded_encode_fn``.
* ``make_sharded_framewise_fn`` with a divisible and an odd batch.
* The sharded pipeline and the corpus's sharded route on
  ``make_tone_conversation`` (AHC): segments equal to the single-device
  run's and to the JAX package's.
* K1's plain version on each dp replica against the JAX ``asp_head_grid``:
  min cosine above 0.999.
* A kernel launch runs with its tensors' device current (a stub library),
  and the counters count launches from many threads exactly.
"""
from __future__ import annotations

import ast
import contextlib
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.config as jc
import speech_diarization_tpu_torch.config as tc
from speech_diarization_tpu.models.ecapa import EcapaModel, EcapaTdnn
from speech_diarization_tpu.parallel import default_mesh_shape as jshape
from speech_diarization_tpu.parallel import make_mesh as jmesh
from speech_diarization_tpu.parallel import make_sharded_encode_fn as jsharded
from speech_diarization_tpu.parallel import param_partition_specs as jspecs
from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu.train.steps import ECAPA_TP_PATTERNS as J_TP
from speech_diarization_tpu.train.synthetic import make_tone_conversation
from speech_diarization_tpu_torch.models.port import params_from_numpy
from speech_diarization_tpu_torch.ops import kernels
from speech_diarization_tpu_torch.parallel import (
    batch_spec, default_mesh_shape, make_mesh, make_sharded_encode_fn,
    make_sharded_framewise_fn, param_partition_specs, replicate, shard_batch,
)
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.train.steps import ECAPA_TP_PATTERNS

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
NET = dict(n_mels=24, channels=64, emb_dim=32, scale=4, se_channels=16,
           att_channels=16)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def small():
    """(JAX model, JAX params, the flat dict, the port's model)."""
    model = EcapaModel(EcapaTdnn(**NET))
    params = jax.jit(model.init)(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in jrec._flatten(params).items()}
    port = params_from_numpy(flat, {"net": NET}, kind="ecapa").eval()
    return model, params, flat, port


def _cfg(pkg):
    return pkg.DiarizationConfig(
        audio=pkg.AudioConfig(target_lufs=None, preemphasis=None),
        cluster=pkg.ClusterConfig(method="ahc", max_speakers=6),
        embed=pkg.EmbedConfig(batch_size=64))


def _same(a, b) -> None:
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a.starts, b.starts, atol=1e-6)
    np.testing.assert_allclose(a.ends, b.ends, atol=1e-6)
    np.testing.assert_array_equal(a.spks, b.spks)


@pytest.mark.parametrize("tp", [1, 2, 3])
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n, tp):
    assert default_mesh_shape(n, tp) == jshape(n, tp)
    want = jmesh(n_devices=n, tp=tp)
    got = make_mesh(n_devices=n, tp=tp, devices=CPU8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_default_mesh_needs_a_card_and_enough_cards():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(n_devices=2)


def test_partition_specs_split_the_jax_leaves(small):
    model, params, flat, port = small
    params = dict(params, classifier=jnp.zeros((8, NET["emb_dim"])))
    flat = dict(flat, classifier=np.zeros((8, NET["emb_dim"]), np.float32))
    assert ECAPA_TP_PATTERNS == J_TP
    want_specs, _ = jax.tree_util.tree_flatten_with_path(
        jspecs(params, jmesh(8, tp=2), J_TP))
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, s in want_specs if len(s.spec) and s.spec[0] == "tp"}
    mesh = make_mesh(devices=CPU8, tp=2)
    got = {k for k, s in param_partition_specs(flat, mesh, ECAPA_TP_PATTERNS).items()
           if s.axis == "tp"}
    assert got == want and "classifier" in got and "mfa/w" in got
    # the same leaves named from the module (its checkpoint keys)
    from_module = {k for k, s in param_partition_specs(port, mesh, J_TP).items()
                   if s.axis == "tp"}
    assert from_module == want - {"classifier"}
    assert batch_spec(mesh).axis == "dp" and replicate(mesh).axis is None


def test_shard_batch_needs_a_multiple_of_dp():
    mesh = make_mesh(devices=CPU8, tp=2)
    x = torch.arange(24.0).reshape(8, 3)
    blocks = shard_batch(mesh, x)
    assert len(blocks) == 4 and all(b.shape == (2, 3) for b in blocks)
    assert blocks[1].data_ptr() == x[2:].data_ptr()     # views on the same device
    with pytest.raises(ValueError, match="multiple of dp"):
        shard_batch(mesh, x[:6])


@pytest.mark.parametrize("tp,patterns", [(1, ()), (2, ("mfa", "fc_w"))],
                         ids=["dp8", "dp4xtp2"])
def test_sharded_encoder_matches_single_device_and_jax(small, tp, patterns):
    model, params, flat, port = small
    wavs = np.random.default_rng(tp).standard_normal((16, 16000)).astype(np.float32)
    enc = make_sharded_encode_fn(port, flat, make_mesh(devices=CPU8, tp=tp), patterns)
    assert not enc.streaming_trained and not hasattr(enc, "encode_grid_chunk")
    if patterns:
        assert set(enc._split[0]) == {k for k, _ in port.named_parameters()
                                      if k.startswith(("net.mfa.", "net.fc_w"))}
        assert all(len(s.pieces) == 2 for s in enc._split[0].values())
    with torch.no_grad():
        got = enc(torch.from_numpy(wavs))
        ref = port.encode_batch(torch.from_numpy(wavs))
        short = enc.encode_batch(torch.from_numpy(wavs[:13]))  # 2 rows a block, 1 at the end
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(short.numpy(), ref[:13].numpy(), atol=1e-4, rtol=1e-4)
    want = np.asarray(jsharded(model, params, jmesh(8, tp=tp), patterns)(
        jnp.asarray(wavs)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rows", [8, 6])
def test_sharded_framewise_fn(rows):
    mesh = make_mesh(devices=CPU8, tp=2)
    seen = []

    def fn(x):
        seen.append(x.shape[0])
        return x.cumsum(-1)

    x = torch.randn(rows, 50)
    torch.testing.assert_close(make_sharded_framewise_fn(fn, mesh)(x), x.cumsum(-1))
    assert seen == ([2, 2, 2, 2] if rows == 8 else [6])


@pytest.fixture(scope="module")
def tone():
    return make_tone_conversation(0)[0]


def test_sharded_pipeline_matches_single_device_and_jax(small, tone):
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe

    model, params, flat, port = small
    single = DiarizationPipeline(_cfg(tc), encoder=port, device="cpu")
    sharded = DiarizationPipeline(
        _cfg(tc), encoder=make_sharded_encode_fn(port, None, make_mesh(devices=CPU8)),
        device="cpu")
    r1, r2 = single(tone), sharded(tone)
    assert r2.diagnostics["grid"] == "windowed"
    _same(r1.segments, r2.segments)
    jpipe = JPipe(_cfg(jc), encode_fn=jsharded(model, params, jmesh(8)))
    _same(r2.segments, jpipe((tone, 16000)).segments)


def test_corpus_sharded_route_matches_jax(small, tone):
    from speech_diarization_tpu.pipelines.corpus import corpus_diarize as jcorpus
    from speech_diarization_tpu_torch.pipelines.corpus import corpus_diarize

    model, params, flat, port = small
    report = corpus_diarize([(tone, 16000)], _cfg(tc), devices=CPU8,
                            encode_model=port, encode_params=flat,
                            keep_results=True)
    assert not report.errors and report.n_devices == 8
    assert report.files[0]["device"] == "sharded[8]"
    jrep = jcorpus([(tone, 16000)], _cfg(jc), encode_model=model,
                   encode_params=params, keep_results=True)
    assert jrep.files[0]["device"] == "sharded[8]"
    _same(report.files[0]["result"].segments, jrep.files[0]["result"].segments)
    assert report.files[0]["audio_s"] == jrep.files[0]["audio_s"]


def test_k1_plain_version_on_each_replica_matches_jax_grid_head(small):
    model, params, flat, port = small
    enc = make_sharded_encode_fn(port, None, make_mesh(devices=CPU8))
    net = model.net
    hop_f, win_f, n_win = 8, 21, 16
    t_f = (n_win - 1) * hop_f + win_f + 3
    cc = 3 * NET["channels"]
    x = np.random.default_rng(0).standard_normal((8, cc, t_f)).astype(np.float32)
    with torch.no_grad():    # tp 1: each replica holds all its leaves
        got = np.stack([enc.replicas[i].net.asp_head_grid_kernel(
            torch.from_numpy(x[i]), 0, hop_f, win_f, n_win).numpy()
            for i in range(8)])
    ref_fn = jax.jit(lambda xi: net.asp_head_grid(params, xi, 0, hop_f, win_f, n_win))
    want = np.stack([np.asarray(ref_fn(jnp.asarray(x[i]))) for i in range(8)])
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() > 0.999, cos.min()


def test_launch_runs_with_its_device_current(monkeypatch):
    """The C entry launches on the calling thread's current device: the
    wrapper's ``device=`` makes the tensors' device current around it."""
    from types import SimpleNamespace

    current = ["cuda:0"]
    seen = []

    @contextlib.contextmanager
    def cuda_device(dev):
        saved, current[0] = current[0], str(dev)
        try:
            yield
        finally:
            current[0] = saved

    fake = SimpleNamespace(sdt_fused_log_mel=lambda *a: seen.append(current[0]) or 0,
                           sdt_asp_grid_stats=lambda *a: seen.append(current[0]) or 0)
    monkeypatch.setattr(kernels, "library", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device", cuda_device)
    kernels.reset_launches()
    kernels.launch("fused_log_mel", device=torch.device("cuda", 1))
    kernels.launch("asp_grid_stats", device=torch.device("cuda", 3))
    kernels.launch("fused_log_mel")
    assert seen == ["cuda:1", "cuda:3", "cuda:0"] and current == ["cuda:0"]
    assert kernels.LAUNCHES == {"asp_grid_stats": 1, "fused_log_mel": 2,
                                "resample_poly": 0}
    kernels.reset_launches()


def test_every_kernel_launch_names_its_device():
    """Each wrapper's ``kernels.launch`` call passes ``device=``."""
    calls = []
    for path in (ROOT / "speech_diarization_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "launch"
                    and getattr(node.func.value, "id", None) == "kernels"):
                calls.append((path.name, {k.arg for k in node.keywords}))
    assert sorted(n for n, _ in calls) == ["ecapa.py", "mel.py", "resample.py"]
    assert all("device" in kw for _, kw in calls)


def test_launch_counters_count_under_threads(monkeypatch):
    from types import SimpleNamespace

    monkeypatch.setattr(kernels, "library",
                        lambda name: SimpleNamespace(sdt_fused_log_mel=lambda *a: 0))
    kernels.reset_launches()

    def many():
        for _ in range(500):
            kernels.launch("fused_log_mel", form="[B, T]", shape="s")

    threads = [threading.Thread(target=many) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert kernels.LAUNCHES["fused_log_mel"] == 4000
    assert kernels.LAUNCH_FORMS == {"fused_log_mel[B, T]": 4000}
    assert kernels.LAUNCH_SHAPES == {"fused_log_mel s": 4000}
    kernels.reset_launches()
