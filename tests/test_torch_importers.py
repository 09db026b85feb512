"""The port's torch checkpoint importers against the JAX package:
``models/port.py::load_gtcrn_checkpoint`` / ``port_torch_state_dict`` (the
GTCRN DNS3 ``.tar``), the ``enhance --backend gtcrn --weights *.tar``
subcommand, ``models/port_vad.py`` (the Silero TorchScript tools and the
VAD's distillation from such a teacher, against the JAX loop), and the
seeded draws the published graphs and the speaker encoders share
(``models/registry.seeded_state_dict``).

Bars: a DNS3-style tar written from the shipped ``gtcrn_mc.npz`` loads to
exactly the npz's arrays in both packages (``num_batches_tracked``
dropped), and the subcommand's output from the tar equals the output from
the npz sample for sample, and the JAX CLI's within one 16-bit step
(1e-4).  The Silero tools read a small TorchScript module with
``reset_states()`` written here and give exactly the JAX package's
arrays and probabilities.  The encoders' seed-0 draws are pinned by digest
(their DER bar, 59.215 %, was measured on them), and the new leaves of the
enhancer graphs start in their stated ranges.
"""
from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

import speech_diarization_tpu.models.port as jport
import speech_diarization_tpu.models.port_vad as jport_vad
import speech_diarization_tpu_torch.models.port_vad as port_vad
from speech_diarization_tpu.cli import main as jmain
from speech_diarization_tpu.models.demucs_ref import HTDemucsRef as JHTDemucs
from speech_diarization_tpu.models.port_zipenhancer import zipenhancer_manifest
from speech_diarization_tpu_torch.cli import main
from speech_diarization_tpu_torch.io.audio import read_wav, write_wav
from speech_diarization_tpu_torch.models import GTCRN, HTDemucsRef, ZipEnhancerRef
from speech_diarization_tpu_torch.models.campp import CamPlusPlus
from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn
from speech_diarization_tpu_torch.models.eres2netv2 import ERes2NetV2
from speech_diarization_tpu_torch.models.port import (
    load_gtcrn,
    load_gtcrn_checkpoint,
    load_params_npz,
    port_torch_state_dict,
)
from speech_diarization_tpu_torch.models.port_ecapa import ecapa_torch_manifest
from speech_diarization_tpu_torch.models.registry import seeded_state_dict

torch.set_num_threads(2)
SR = 16000
GTCRN_NPZ = Path(__file__).resolve().parents[1] / "weights" / "gtcrn_mc.npz"


def _dns3(sd: dict) -> dict:
    """A DNS3-style checkpoint: the state under ``model``, a BatchNorm
    counter, and a training entry beside it."""
    model = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    model["encoder.en_convs.0.bn.num_batches_tracked"] = torch.tensor(7)
    return {"model": model, "epoch": 120}


@pytest.fixture(scope="module")
def tar(tmp_path_factory):
    path = tmp_path_factory.mktemp("dns3") / "model_trained_on_dns3.tar"
    torch.save(_dns3(load_params_npz(GTCRN_NPZ)), path)
    return path


# ---------------------------------------------------------------- GTCRN ---
def test_gtcrn_tar_loads_the_npz_arrays(tar):
    net = load_gtcrn_checkpoint(tar)
    assert isinstance(net, GTCRN) and not net.training
    ref = load_gtcrn(GTCRN_NPZ).state_dict()
    jref = jport.load_gtcrn_checkpoint(tar)
    state = net.state_dict()
    assert set(state) == set(ref) == set(jref)
    for k, v in state.items():
        assert torch.equal(v, ref[k])
        np.testing.assert_array_equal(v.numpy(), np.asarray(jref[k]))


def test_a_bare_state_dict_tar_loads(tmp_path):
    path = tmp_path / "bare.tar"
    torch.save(_dns3(load_params_npz(GTCRN_NPZ))["model"], path)
    ref = load_gtcrn(GTCRN_NPZ).state_dict()
    assert all(torch.equal(v, ref[k])
               for k, v in load_gtcrn_checkpoint(path).state_dict().items())


def test_port_torch_state_dict_matches():
    sd = _dns3({"a.weight": np.ones((2, 3), np.float16), "b": np.arange(3)})["model"]
    out, ref = port_torch_state_dict(sd), jport.port_torch_state_dict(sd)
    assert set(out) == set(ref) == {"a.weight", "b"}
    for k, v in out.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, np.asarray(ref[k]))


def test_enhance_subcommand_reads_the_tar(tar, tmp_path):
    """``enhance --backend gtcrn --weights model.tar`` in both CLIs, and the
    port's CLI with the npz the tar was written from."""
    wav = (0.1 * np.random.default_rng(0).standard_normal(3 * SR)).astype(np.float32)
    outs = {}
    for tag, fn, weights in (("jax", jmain, tar), ("port", main, tar),
                             ("port-npz", main, GTCRN_NPZ)):
        root = tmp_path / tag / "in"
        write_wav(root / "a.wav", wav, SR)
        assert fn(["enhance", str(root), "--backend", "gtcrn", "--weights", str(weights)]
                  + ([] if tag == "jax" else ["--cpu"])) == 0
        outs[tag] = read_wav(root.with_name("in-enhanced") / "a.wav")[0]
    np.testing.assert_array_equal(outs["port"], outs["port-npz"])
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=1e-4)


# --------------------------------------------------------------- Silero ---
class _TinySilero(torch.nn.Module):
    """A stateful stand-in with Silero's streaming contract: ``forward(x,
    sr)`` -> speech probability of one chunk, ``reset_states()``."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.proj = torch.nn.Linear(4, 1)
        with torch.no_grad():
            self.proj.weight.copy_(torch.randn(1, 4, generator=g))
        self.register_buffer("state", torch.zeros(4))

    @torch.jit.export
    def reset_states(self):
        self.state.zero_()

    def forward(self, x: torch.Tensor, sr: int) -> torch.Tensor:
        feats = torch.stack([x.abs().mean(), x.std(), x.max(),
                             torch.tensor(sr / 16000.0)])
        self.state.mul_(0.5).add_(feats)
        return torch.sigmoid(self.proj(self.state))[0]


@pytest.fixture(scope="module")
def silero(tmp_path_factory):
    path = tmp_path_factory.mktemp("silero") / "silero_vad.jit"
    torch.jit.save(torch.jit.script(_TinySilero()), str(path))
    return path


def test_silero_state_dict_matches(silero):
    out, ref = port_vad.silero_state_dict(silero), jport_vad.silero_state_dict(silero)
    assert set(out) == set(ref) == {"proj.weight", "proj.bias", "state"}
    for k, v in out.items():
        np.testing.assert_array_equal(v, ref[k])


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_silero_probs_fn_matches(silero, sample_rate):
    y = (0.2 * np.random.default_rng(1).standard_normal(5000)).astype(np.float32)
    fn = port_vad.silero_probs_fn(silero, sample_rate)
    out = fn(y)
    ref = jport_vad.silero_probs_fn(silero, sample_rate)(y)
    assert out.dtype == np.float32 and out.shape == (5000 // (512 if sample_rate == 16000
                                                             else 256),)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(fn(y), out)        # the state is reset per call


def test_distillation_names_the_training_item(silero, monkeypatch, tmp_path):
    """``distill_vad_from_silero`` (a refusal until the training slice)
    runs the JAX distillation loop: the same TorchScript teacher, the same
    student weights (the JAX init, carried across), two steps on the same
    draws -> the logged loss within rtol 1e-4, the held-out agreement with
    the teacher equal, and an export the JAX ``load_vad`` reads."""
    import jax

    from speech_diarization_tpu.models.vad import VadModel as JVad
    from speech_diarization_tpu.train.recipes import _flatten, load_vad as jload

    params = JVad().init(jax.random.PRNGKey(0))
    monkeypatch.setattr(JVad, "init", lambda self, key: params)
    kw = dict(steps=2, batch=2, dur_s=1.0, seed=3)
    _, jm = jport_vad.distill_vad_from_silero(silero, **kw)
    model, m = port_vad.distill_vad_from_silero(
        silero, **kw, init_params=_flatten(params), device="cpu",
        out_path=tmp_path / "vad.npz")
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-4)
    assert m["teacher_agreement"] == jm["teacher_agreement"]
    jmodel, jparams = jload(tmp_path / "vad.npz")
    assert set(_flatten(jparams)) == set(_flatten(params))


# -------------------------------------------------------- seeded draws ---
def _digest(sd: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(np.ascontiguousarray(sd[k]).tobytes())
    return h.hexdigest()[:16]


@pytest.mark.parametrize("name,manifest,digest", [
    ("eres2netv2", lambda: ERes2NetV2().manifest(), "bf97d632c58cedcb"),
    ("campp", lambda: CamPlusPlus().manifest(), "7683beaf9b247709"),
    ("ecapa_speechbrain", lambda: ecapa_torch_manifest(EcapaTdnn()), "472583eac7f01fc9"),
])
def test_the_encoders_seed0_draws_are_unchanged(name, manifest, digest):
    """The draws the encoders' DER bar (59.215 %) was measured on: the enhancer
    graphs' rules match none of these manifests' leaves."""
    assert _digest(seeded_state_dict(manifest(), 0)) == digest


@pytest.mark.parametrize("graph", ["zipenhancer-ref", "htdemucs"])
def test_the_graphs_special_leaves_start_near_their_init(graph):
    man = (zipenhancer_manifest() if graph == "zipenhancer-ref" else JHTDemucs().manifest())
    net = ZipEnhancerRef() if graph == "zipenhancer-ref" else HTDemucsRef()
    assert net.manifest() == man
    sd = seeded_state_dict(man, 0)
    ranges = {"prelu": (0.2, 0.3), "norm": (0.8, 1.2), "bypass_scale": (0.4, 0.6),
              "scale": (5e-4, 1.5e-3), "slope": (0.8, 1.2)}
    seen = set()
    for k, v in sd.items():
        prefix, leaf = k.rsplit(".", 1)
        kind = leaf
        if leaf == "weight" and v.ndim == 1:
            kind = "norm" if f"{prefix}.bias" in sd else "prelu"
        if kind in ranges:
            lo, hi = ranges[kind]
            assert lo <= v.min() and v.max() <= hi, k
            seen.add(kind)
    if graph == "zipenhancer-ref":
        assert seen == {"prelu", "norm", "bypass_scale", "slope"}
        assert abs(float(sd["ts_blocks.0.time.encoder.layers.0.norm.log_scale"])) < 0.25
    else:
        assert seen == {"norm", "scale"}
        emb = sd["freq_emb.embedding.weight"]            # N(0, 1/48), as JAX init
        assert emb.shape == (512, 48) and abs(emb.std() * 48 ** 0.5 - 1.0) < 0.05
