"""The other speaker encoders (ERes2NetV2, CAM++), the SpeechBrain ECAPA
importer, the ONNX initializer reader and the encoder registry of the
PyTorch port against the JAX package.

Both sides get the same weights: one numpy draw per net
(``models.registry.seeded_state_dict``, seed 0 unless a test says so),
loaded by each package's own loader.  Pieces and bars:

* ERes2NetV2 and CAM++ at the JAX parity tests' small configurations on
  their shapes ((2, 40 / 64, 32), (1, 99 / 317, 32): odd frame counts
  through the stride-2 stages, CAM++'s ragged 100-frame segment tail) and
  on inputs that pool a single frame: atol 2e-5, rtol 1e-4 (ten times
  tighter than ``tests/test_campp_parity.py``'s).  At the published widths,
  ``encode_batch`` (log-mel and net) on one 1 s window: max abs error under
  1e-4 of the embedding's peak and cos > 0.99999, the bar ``chip_smoke.py``
  holds the card to.  ``tests/test_campp_parity.py:250``'s element-wise
  atol 2e-4 / rtol 1e-3 does not hold for ERes2NetV2 here: its seeded
  embedding peaks near 40, and the log-mel's float32 differences (within
  ``tests/test_pallas_fbank.py``'s 2e-3) come out at 1.4e-5 of that peak,
  5.7e-4 absolute on an element of 0.2.
* The SpeechBrain ECAPA importer: a seeded ``embedding_model.ckpt`` written
  with ``torch.save`` (bare and under ``state_dict``), loaded by the port's
  registry and by the JAX ``load_ecapa_speechbrain`` onto ``EcapaModel``:
  embeddings rel < 1e-5 (the bar of the port's other ECAPA tests).
* ``io/onnx_lite``: the port's writer read by the JAX reader and the JAX
  writer read by the port's, bit for bit.
* Strict schemas: a missing key and a wrong shape raise the JAX loaders'
  ``ValueError`` messages.
* ``make_encoder_model`` for every backend and weight format (ECAPA
  ``.npz``, SpeechBrain ``.ckpt``, none; 3D-Speaker ``.onnx``, bare
  ``.pt``, ``.ckpt`` under ``state_dict``, none): the file's arrays are the
  module's, random weights warn and follow the seed.
* The pipeline (bench surface with the rescue and enhancement off, the
  energy VAD, ROADMAP F1) with each encoder at small width on a 12 s draw:
  final segments equal to the JAX pipeline's (edges within 1e-6 s, labels
  equal; the JAX side clusters on its numpy path, F2).  A forced
  ``grid_backend='streaming'`` with a trunk-less encoder warns and takes
  the windowed grid in both packages.
* The CLI: ``--bf16`` with a float32-only encoder is refused; a SpeechBrain
  checkpoint diarizes (it had failed in ``np.load``).
"""
from __future__ import annotations

import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu.config as jc
import speech_diarization_tpu_torch.config as tc
from speech_diarization_tpu.io.onnx_lite import read_initializers as jread_onnx
from speech_diarization_tpu.io.onnx_lite import write_initializers as jwrite_onnx
from speech_diarization_tpu.models.campp import CamPlusPlus as JCamPP
from speech_diarization_tpu.models.campp import CamPlusPlusModel as JCamPPModel
from speech_diarization_tpu.models.campp import load_campp as jload_campp
from speech_diarization_tpu.models.ecapa import EcapaModel as JEcapaModel
from speech_diarization_tpu.models.ecapa import EcapaTdnn as JEcapaTdnn
from speech_diarization_tpu.models.eres2netv2 import ERes2NetV2 as JERes
from speech_diarization_tpu.models.eres2netv2 import ERes2NetV2Model as JEResModel
from speech_diarization_tpu.models.eres2netv2 import load_eres2netv2 as jload_eres
from speech_diarization_tpu.models.port_ecapa import (
    ecapa_speechbrain_key_map as jkey_map,
)
from speech_diarization_tpu.models.port_ecapa import (
    ecapa_torch_manifest as jecapa_manifest,
)
from speech_diarization_tpu.models.port_ecapa import (
    load_ecapa_speechbrain as jload_sb,
)
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu_torch.io.audio import write_wav
from speech_diarization_tpu_torch.io.onnx_lite import read_initializers
from speech_diarization_tpu_torch.io.onnx_lite import write_initializers
from speech_diarization_tpu_torch.models.campp import (
    CamPlusPlus, CamPlusPlusModel, load_campp,
)
from speech_diarization_tpu_torch.models.ecapa import EcapaModel, EcapaTdnn
from speech_diarization_tpu_torch.models.eres2netv2 import (
    ERes2NetV2, ERes2NetV2Model, load_eres2netv2,
)
from speech_diarization_tpu_torch.models.port import load_params_npz
from speech_diarization_tpu_torch.models.port_ecapa import (
    ecapa_speechbrain_key_map, ecapa_torch_manifest, load_ecapa_speechbrain,
)
from speech_diarization_tpu_torch.models.registry import (
    BACKENDS, make_encoder, make_encoder_model, seeded_state_dict,
)
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"

# the JAX parity tests' small configurations, and ECAPA's of the port's
# windowed tests
SMALL = {
    "eres2netv2": dict(n_mels=32, m_channels=8, base_width=16, scale=2,
                       expansion=2, num_blocks=(1, 1, 2, 1), emb_dim=32),
    "campp": dict(n_mels=32, m_channels=8, init_channels=32, growth=8,
                  bn_channels=16, num_layers=(2, 3, 2), dilations=(1, 2, 2),
                  kernels=(3, 3, 3), emb_dim=24),
    "ecapa": dict(n_mels=24, channels=32, emb_dim=16, scale=4, se_channels=8,
                  att_channels=8),
}


def _rel(ref, out) -> float:
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(np.linalg.norm(ref - out) / np.linalg.norm(ref))


def _jax_side(backend: str, cfg: dict, sd: dict):
    """The JAX ``(model, params)`` of ``backend`` at ``cfg`` on ``sd``."""
    if backend == "eres2netv2":
        net = JERes(**cfg)
        return JEResModel(net), jload_eres(sd, net)
    if backend == "campp":
        net = JCamPP(**cfg)
        return JCamPPModel(net), jload_campp(sd, net)
    net = JEcapaTdnn(**cfg)
    return JEcapaModel(net), jload_sb(sd, net)


def _port_side(backend: str, cfg: dict, sd: dict):
    if backend == "eres2netv2":
        return ERes2NetV2Model(load_eres2netv2(sd, ERes2NetV2(**cfg)))
    if backend == "campp":
        return CamPlusPlusModel(load_campp(sd, CamPlusPlus(**cfg)))
    return EcapaModel(load_ecapa_speechbrain(sd, EcapaTdnn(**cfg)))


def _jax_manifest(backend: str, cfg: dict) -> dict:
    if backend == "eres2netv2":
        return JERes(**cfg).manifest()
    if backend == "campp":
        return JCamPP(**cfg).manifest()
    return jecapa_manifest(JEcapaTdnn(**cfg))


def _pair(backend: str, cfg: dict | None = None, seed: int = 0):
    cfg = SMALL[backend] if cfg is None else cfg
    sd = seeded_state_dict(_jax_manifest(backend, cfg), seed)
    return _jax_side(backend, cfg, sd), _port_side(backend, cfg, sd), sd


class _Warnings(logging.Handler):
    """Collects the messages of the ``sdtpu`` loggers (which do not
    propagate) at WARNING and above."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.seen: list[str] = []

    def emit(self, record):
        self.seen.append(record.getMessage())

    def __enter__(self):
        logging.getLogger("sdtpu").addHandler(self)
        return self.seen

    def __exit__(self, *exc):
        logging.getLogger("sdtpu").removeHandler(self)


@pytest.fixture(scope="module")
def speech():
    w, _ = make_conversation(np.random.default_rng(21), 12.0, n_speakers=3, sr=SR)
    return w.astype(np.float32)


# ------------------------------------------------------------ manifests --
@pytest.mark.parametrize("backend", ["eres2netv2", "campp", "ecapa"])
@pytest.mark.parametrize("width", ["small", "published"])
def test_state_dict_keys_equal_the_jax_manifest(backend, width):
    cfg = SMALL[backend] if width == "small" else {}
    port = {"eres2netv2": ERes2NetV2, "campp": CamPlusPlus}.get(backend)
    got = (port(**cfg).manifest() if port else
           ecapa_torch_manifest(EcapaTdnn(**cfg)))
    assert got == _jax_manifest(backend, cfg)
    if backend == "ecapa":
        # the JAX map's tree paths are the port's state_dict keys, and they
        # cover every parameter of the port's net
        def port_key(path):
            head = f"block.{path[0][5:]}" if path[0].startswith("block") else path[0]
            return ".".join([head, *map(str, path[1:])])

        m = ecapa_speechbrain_key_map(EcapaTdnn(**cfg))
        assert m == {k: port_key(p) for k, p in jkey_map(JEcapaTdnn(**cfg)).items()}
        assert set(m.values()) == set(EcapaTdnn(**cfg).state_dict())


def test_the_published_sizes():
    n = {b: sum(int(np.prod(s)) for s in _jax_manifest(b, {}).values())
         for b in ("eres2netv2", "campp")}
    assert n == {"eres2netv2": 15_402_320, "campp": 6_930_848}


def test_seeded_state_dict_is_fixed_and_order_free():
    man = JERes(**SMALL["eres2netv2"]).manifest()
    a = seeded_state_dict(man, 0)
    b = seeded_state_dict(dict(reversed(list(man.items()))), 0)
    c = seeded_state_dict(man, 1)
    assert list(a) == sorted(man) and all(
        np.array_equal(a[k], b[k]) and a[k].dtype == np.float32 for k in a)
    assert not np.array_equal(a["conv1.weight"], c["conv1.weight"])
    var = np.concatenate([v for k, v in a.items() if k.endswith("running_var")])
    gain = np.concatenate([a[k.replace("running_var", "weight")]
                           for k in a if k.endswith("running_var")])
    assert 0.5 <= var.min() and var.max() <= 1.5
    assert 0.8 <= gain.min() and gain.max() <= 1.2
    w = a["layer4.0.conv3.weight"]
    assert abs(w.std() * np.sqrt(np.prod(w.shape[1:])) - 1.0) < 0.1


# ----------------------------------------------------- small-width nets --
@pytest.mark.parametrize("backend,shape", [
    ("eres2netv2", (2, 40, 32)), ("eres2netv2", (1, 99, 32)),
    ("eres2netv2", (1, 8, 32)),       # 8 -> 4 -> 2 -> 1 frame at layer 4
    ("campp", (2, 64, 32)), ("campp", (1, 317, 32)),
    ("campp", (1, 2, 32)),            # one frame after the stride-2 tdnn
])
def test_net_matches_jax_small_width(backend, shape):
    (jm, jp), port, _ = _pair(backend)
    feats = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jm.net.apply(jp, jnp.asarray(feats)))
    with torch.inference_mode():
        out = port.net(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (shape[0], SMALL[backend]["emb_dim"])
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=1e-4)


def test_layer3_ds_lands_on_layer4s_grid_at_odd_lengths():
    net = ERes2NetV2(**SMALL["eres2netv2"])
    x = torch.randn(1, 8, 32, 201)
    with torch.inference_mode():
        out3 = net.layer3(net.layer2(net.layer1(x)))
        assert net.layer3_ds(out3).shape == net.layer4(out3).shape
        assert net.layer4(out3).shape[-1] == 26          # 201 -> 101, 51, 26


# ------------------------------------------------------- published widths --
@pytest.mark.parametrize("backend", ["eres2netv2", "campp"])
def test_encode_batch_matches_jax_at_the_published_widths(speech, backend):
    (jm, jp), port, _ = _pair(backend, {})
    wav = speech[3 * SR:4 * SR][None]                     # one 1 s window
    ref = np.asarray(jm.encode_batch(jp, jnp.asarray(wav)))
    with torch.inference_mode():
        out = port.encode_batch(torch.from_numpy(wav)).numpy()
    assert out.shape == ref.shape == (1, 192)
    peak = np.abs(ref).max()
    assert np.abs(out - ref).max() < 1e-4 * peak
    assert (out * ref).sum() / np.linalg.norm(out) / np.linalg.norm(ref) > 0.99999


# ------------------------------------------------- the SpeechBrain ECAPA --
@pytest.mark.parametrize("nested", [False, True], ids=["bare", "state_dict"])
def test_speechbrain_checkpoint_matches_jax(tmp_path, speech, nested):
    """The default ``EcapaTdnn`` (C 512), which the JAX registry loads a
    SpeechBrain checkpoint onto, from ``embedding_model.ckpt``."""
    sd = seeded_state_dict(jecapa_manifest(JEcapaTdnn()), 0)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    tensors["blocks.0.norm.norm.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "embedding_model.ckpt"
    torch.save({"state_dict": tensors} if nested else tensors, path)
    jm = JEcapaModel(sample_rate=SR)
    jp = jload_sb(str(path), jm.net)
    port = make_encoder_model("ecapa", path)
    assert type(port) is EcapaModel and not port.streaming_trained
    assert port.refine_sub_cos is None
    wb = np.stack([speech[i * SR:i * SR + SR] for i in range(2)])
    ref = np.asarray(jm.encode_batch(jp, jnp.asarray(wb)))
    with torch.inference_mode():
        out = port.encode_batch(torch.from_numpy(wb)).numpy()
    assert out.shape == ref.shape == (2, 192)
    assert _rel(ref, out) < 1e-5


# ---------------------------------------------------------------- ONNX --
def _tensors():
    g = np.random.default_rng(3)
    return {"conv1.weight": g.standard_normal((4, 1, 3, 3)).astype(np.float32),
            "bn.running_var": g.uniform(0.5, 1.5, 7).astype(np.float32),
            "half": g.standard_normal((2, 5)).astype(np.float16),
            "steps": np.array([3, -1, 2**40], np.int64),
            "scalar": np.array(2.5, np.float64)}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_onnx_lite_round_trips_against_the_jax_package(tmp_path, writer):
    t = _tensors()
    path = tmp_path / "m.onnx"
    (write_initializers if writer == "port" else jwrite_onnx)(path, t)
    got = (jread_onnx if writer == "port" else read_initializers)(path)
    assert list(got) == list(t)
    for k, v in t.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)
    if writer == "port":
        jwrite_onnx(tmp_path / "j.onnx", t)
        assert (tmp_path / "j.onnx").read_bytes() == path.read_bytes()


def test_onnx_lite_reads_packed_float_data(tmp_path):
    """``float_data`` (field 4, packed), the encoding other writers use."""
    from speech_diarization_tpu_torch.io import onnx_lite as ol

    vals = np.arange(6, dtype=np.float32) - 2.5
    tensor = (ol._field(1, 0) + ol._write_varint(2) + ol._field(1, 0)
              + ol._write_varint(3) + ol._field(2, 0) + ol._write_varint(1)
              + ol._len_delim(4, vals.tobytes()) + ol._len_delim(8, b"w"))
    path = tmp_path / "f.onnx"
    path.write_bytes(ol._len_delim(7, ol._len_delim(5, tensor)))
    got = read_initializers(path)["w"]
    np.testing.assert_array_equal(got, vals.reshape(2, 3))
    np.testing.assert_array_equal(got, jread_onnx(path)["w"])


# -------------------------------------------------------- strict schemas --
@pytest.mark.parametrize("backend", ["eres2netv2", "campp", "ecapa"])
@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_strict_schema_errors_are_the_jax_loaders(backend, fault):
    sd = dict(seeded_state_dict(_jax_manifest(backend, SMALL[backend]), 0))
    key = sorted(sd)[3]
    if fault == "missing":
        sd.pop(key)
    elif fault == "unexpected":
        sd["extra.weight"] = np.zeros(3, np.float32)
    else:
        sd[key] = np.zeros(sd[key].shape + (1,), np.float32)
    with pytest.raises(ValueError) as jerr:
        _jax_side(backend, SMALL[backend], sd)
    with pytest.raises(ValueError) as err:
        _port_side(backend, SMALL[backend], sd)
    assert str(err.value) == str(jerr.value)
    assert ("state_dict schema mismatch" in str(err.value)) == (fault != "shape")
    if fault == "shape":
        assert key in str(err.value)


# --------------------------------------------------------------- registry --
def _same_arrays(module: torch.nn.Module, sd: dict, key_map=None) -> None:
    state = module.state_dict()
    assert len(sd) == len(state)
    for k, v in sd.items():
        np.testing.assert_array_equal(state[key_map[k] if key_map else k].numpy(), v)


@pytest.mark.parametrize("backend,fmt", [
    ("eres2netv2", ".onnx"), ("eres2netv2", ".pt"), ("eres2netv2", ".ckpt"),
    ("campp", ".onnx"), ("campp", ".pt"), ("campp", ".ckpt"),
])
def test_make_encoder_model_reads_every_3dspeaker_format(tmp_path, backend, fmt):
    sd = seeded_state_dict(_jax_manifest(backend, {}), 0)
    path = tmp_path / f"model{fmt}"
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt == ".onnx":
        write_initializers(path, sd)
    elif fmt == ".pt":
        torch.save(tensors, path)
    else:
        torch.save({"epoch": 3, "state_dict": tensors}, path)
    model = make_encoder_model(backend, path, sample_rate=8000)
    assert type(model) is {"eres2netv2": ERes2NetV2Model,
                           "campp": CamPlusPlusModel}[backend]
    assert model.sample_rate == 8000 and not model.training
    _same_arrays(model.net, sd)
    # the JAX registry reads the same file into the same arrays
    from speech_diarization_tpu.models.registry import make_encoder_model as jmake

    _, jp = jmake(backend, str(path))
    assert set(jp) == set(sd)
    assert all(np.array_equal(np.asarray(jp[k]), v) for k, v in sd.items())


def test_make_encoder_model_reads_the_ecapa_formats(tmp_path):
    npz = make_encoder_model("ecapa", WEIGHTS / "ecapa_synthetic.npz")
    flat = load_params_npz(WEIGHTS / "ecapa_synthetic.npz")
    np.testing.assert_array_equal(npz.net.stem.w.numpy(), flat["stem/w"])
    assert type(npz) is EcapaModel and not npz.streaming_trained
    shipped = make_encoder_model("ecapa", None, dtype=torch.bfloat16)
    assert shipped.streaming_trained and shipped.net.dtype == torch.bfloat16
    assert shipped.refine_sub_cos == pytest.approx(0.7)
    sd = seeded_state_dict(jecapa_manifest(JEcapaTdnn(**SMALL["ecapa"])), 1)
    path = tmp_path / "embedding_model.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    with pytest.raises(ValueError, match="schema mismatch"):
        make_encoder_model("ecapa", path)        # onto the default net (F16)
    sb = load_ecapa_speechbrain(path, EcapaTdnn(**SMALL["ecapa"]))
    _same_arrays(sb, sd, ecapa_speechbrain_key_map(sb))


@pytest.mark.parametrize("backend", BACKENDS)
def test_random_weights_warn_and_follow_the_seed(backend, monkeypatch):
    import speech_diarization_tpu_torch.utils.weights as tweights

    monkeypatch.setattr(tweights, "ENCODER_PREFERENCE", ())
    with _Warnings() as seen:
        a = make_encoder_model(backend, seed=0)
        b = make_encoder_model(backend, seed=0)
        c = make_encoder_model(backend, seed=1)
    assert sum("RANDOM weights" in m for m in seen) == 3
    sa, sb, sc = (m.net.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = [k for k, v in sa.items() if v.ndim >= 2][0]
    assert not torch.equal(sa[w], sc[w])


def test_make_encoder_runs_on_the_asked_device(speech):
    fn, dim = make_encoder("campp", seed=0, device="cpu")
    out = fn(speech[None, :SR])
    assert dim == 192 and out.shape == (1, 192) and out.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown encoder backend"):
        make_encoder_model("xvector")
    with pytest.raises(ValueError, match="float32 only"):
        make_encoder_model("eres2netv2", dtype=torch.bfloat16)


# --------------------------------------------------------------- pipeline --
def _cfgs(**embed):
    def cfg(mod):
        return mod.DiarizationConfig(
            overlap=mod.OverlapConfig(enabled=False),
            enhance=mod.EnhanceConfig(enabled=False),
            embed=mod.EmbedConfig(batch_size=32, max_batch_size=32, **embed))
    return cfg(jc), cfg(tc)


def _jax_numpy_spectral(fn):
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        return fn()
    finally:
        jspectral._device_capable = saved


@pytest.mark.parametrize("backend", ["eres2netv2", "campp", "ecapa"])
@pytest.mark.parametrize("grid_backend", ["auto", "streaming"])
def test_pipeline_with_each_encoder_matches_jax(speech, backend, grid_backend):
    """The bench surface with the rescue and enhancement off and the energy
    VAD, each encoder at small width.  A forced ``grid_backend='streaming'``
    takes the streaming grid with the ECAPA (it has a trunk, streaming-trained
    or not); with a trunk-less encoder both packages warn and take the
    windowed grid."""
    (jm, jp), port, _ = _pair(backend)
    jcfg, tcfg = _cfgs(grid_backend=grid_backend)
    with _Warnings() as jseen:
        jres = _jax_numpy_spectral(lambda: JPipe(jcfg, encoder=(jm, jp))(
            (speech, SR), collect_diagnostics=True))
    pipe = DiarizationPipeline(tcfg, encoder=port, device="cpu")
    with _Warnings() as seen:
        tres = pipe(speech)
    d = tres.diagnostics
    forced = grid_backend == "streaming"
    assert d["route"] == "legacy"
    assert d["grid"] == ("streaming" if forced and backend == "ecapa" else "windowed")
    n_warn = int(forced and backend != "ecapa")
    assert sum("encode_grid_chunk" in m for m in seen) == n_warn
    assert sum("encode_grid_chunk" in m for m in jseen) == n_warn
    g_t, g_j = d["window_embeddings"], jres.diagnostics["window_embeddings"]
    assert g_t.shape == g_j.shape == (101, SMALL[backend]["emb_dim"])
    assert _rel(g_j, g_t) < 1e-5
    assert len(tres.segments) == len(jres.segments) > 0
    np.testing.assert_allclose(tres.segments.starts, jres.segments.starts, atol=1e-6)
    np.testing.assert_allclose(tres.segments.ends, jres.segments.ends, atol=1e-6)
    np.testing.assert_array_equal(tres.segments.spks, jres.segments.spks)


# -------------------------------------------------------------------- CLI --
@pytest.mark.parametrize("backend", ["eres2netv2", "campp"])
def test_cli_refuses_bf16_with_the_float32_encoders(backend):
    from speech_diarization_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="float32 only"):
        main(["diarize", "x.wav", "--cpu", "--bf16", "--encoder", backend])


def test_cli_diarizes_with_a_speechbrain_checkpoint(tmp_path, speech):
    """``--encoder-weights embedding_model.ckpt``: the JAX CLI's branch (a
    non-``.npz`` path with ``--encoder ecapa``), which the port had sent to
    ``np.load``."""
    from speech_diarization_tpu_torch.cli import main

    sd = seeded_state_dict(jecapa_manifest(JEcapaTdnn()), 0)
    ckpt = tmp_path / "embedding_model.ckpt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    wav = tmp_path / "conv.wav"
    write_wav(wav, speech[:4 * SR], SR)
    assert main(["diarize", str(wav), "--cpu", "--encoder-weights", str(ckpt),
                 "--enhance", "off", "--no-overlap", "--vad-backend", "energy",
                 "--out-dir", str(tmp_path / "out"), "--format", "rttm"]) == 0
    assert (tmp_path / "out" / "conv.rttm").read_text().startswith("SPEAKER conv")
