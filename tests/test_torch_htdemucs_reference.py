"""The port's HTDemucs and its demix-dialog front-end against the plain
reference the benchmark checks them with (``perfbench/reference/models/
htdemucs.py``, ``perfbench/reference/pipelines/demix_dialog.py``), the
ensemble handed in as modules (``make_enhance_fn(nets=...)``), and the
benchmark's ``htdemucs_seeded`` kind.

Widths: channels 8, depth 2, nfft 512, a 32-wide bottleneck and two
transformer layers (one self-attention, one cross-attention), 2 s segments;
the front-end cuts 1 s chunks.  Both sides load one draw of
``perfbench/harness/weights.py``.

Bars: the graph within 1e-5 of the output's peak, the bar the port's graph
is held to against the JAX one (float32 on the CPU: the port's STFT is an
``rfft`` of unfolded frames and its attention SDPA, the reference's
``torch.stft`` and a written-out softmax; 4e-7 measured); the front-end's
dialog stem within 1e-5 of the reference's norm (``enh_gap``, as the
benchmark's check measures it; both resample with scipy in float64, so only
the device part differs); the nets handed in and the same nets read from
``.th`` packages equal to the bit (one code path after the load); the
operation count on the ``meta`` device equal to the count of a real
forward.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.harness import flops, systems  # noqa: E402
from perfbench.harness.weights import seeded_state_dict_on_device  # noqa: E402
from perfbench.reference.models.htdemucs import HTDemucs  # noqa: E402
from perfbench.reference.pipelines.demix_dialog import DemixDialog  # noqa: E402
from speech_diarization_tpu_torch.models.demucs_ref import HTDemucsRef  # noqa: E402
from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn  # noqa: E402

torch.set_num_threads(2)
SMALL = dict(channels=8, depth=2, nfft=512, bottom_channels=32, t_layers=2, t_heads=2,
             segment=2.0)


def _manifest(net: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def _pair(seed: int, cfg: dict = SMALL):
    """(port net, reference net) loaded with one draw."""
    port, ref = HTDemucsRef(**cfg).eval(), HTDemucs(**cfg).eval()
    state = seeded_state_dict_on_device(_manifest(ref), seed, "cpu")
    port.load_state_dict(state)
    ref.load_state_dict(state)
    return port, ref


def _wave(shape, seed: int, scale: float = 0.3) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _kind():
    from perfbench.harness.spec import load_kind

    return load_kind("htdemucs_seeded")


def test_state_dict_names_are_the_ports():
    """One draw loads into both, at the small and the published widths."""
    assert _manifest(HTDemucs(**SMALL)) == _manifest(HTDemucsRef(**SMALL))
    with torch.device("meta"):
        assert _manifest(HTDemucs()) == _manifest(HTDemucsRef())


@pytest.mark.parametrize("seed,batch,seconds", [(3, 1, 2.0), (4, 2, 0.7)],
                         ids=["segment", "ragged-batch-of-2"])
def test_graph_matches_the_reference(seed, batch, seconds):
    port, ref = _pair(seed)
    x = _wave((batch, 2, int(seconds * 44100)), seed)
    with torch.inference_mode():
        out, want = port(x), ref(x)
    assert out.shape == want.shape == (batch, 3, 2, x.shape[-1])
    assert float((out - want).abs().max() / want.abs().max()) <= 1e-5


def test_front_end_matches_the_reference():
    """A 2-net ensemble over two 1 s chunks of a 1.75 s wave: the dialog
    stem at 16 kHz, as the benchmark's ``enh_gap`` measures it."""
    pairs = [_pair(s) for s in (6, 7)]
    y = _wave(28000, 8, 0.2)
    fn = make_enhance_fn("demix-dialog", device="cpu", nets=[p for p, _ in pairs],
                         chunk_s=1.0)
    ref = DemixDialog([r for _, r in pairs], "cpu", chunk_s=1.0)
    out, want = fn(y), ref(y)
    assert out.shape == want.shape == y.shape
    assert float(torch.linalg.norm(out - want) / torch.linalg.norm(want)) <= 1e-5


def test_nets_equal_th_packages_to_the_bit(tmp_path, monkeypatch):
    """The same nets handed in, or read from ``.th`` packages through
    ``SDTPU_DEMUCS_CKPTS``: one output to the bit."""
    nets, paths = [], []
    for s in (9, 10):
        port, _ = _pair(s)
        nets.append(port)
        paths.append(tmp_path / f"net{s}.th")
        torch.save({"kwargs": dict(SMALL, sources=["music", "effect", "dialog"]),
                    "state": {k: v.clone() for k, v in port.state_dict().items()}},
                   paths[-1])
    monkeypatch.setenv("SDTPU_DEMUCS_CKPTS", ":".join(str(p) for p in paths))
    y = _wave(28000, 11, 0.2)
    from_disk = make_enhance_fn("demix-dialog", device="cpu", chunk_s=1.0)(y)
    handed = make_enhance_fn("demix-dialog", device="cpu", nets=nets, chunk_s=1.0)(y)
    assert torch.equal(handed, from_disk)


def test_weights_and_nets_together_are_refused():
    net = HTDemucsRef(**SMALL)
    with pytest.raises(ValueError, match="weights=.*nets="):
        make_enhance_fn("demix-dialog", weights="x.npz", nets=[net], device="cpu")
    with pytest.raises(ValueError, match="demix-dialog backend only"):
        make_enhance_fn("gtcrn", nets=[net], device="cpu")


def _side(program: bool, seed: int) -> systems.Side:
    system = SimpleNamespace(seed=seed, device="cpu", config={}, _seeded={})
    return systems.Side(system, program, program, "enhancer", None)


def test_kind_draws_are_equal_on_both_sides_and_distinct_across_nets():
    kind = _kind()
    block = {"backend": "demix-dialog", "kind": "htdemucs_seeded", "nets": 3, "net": SMALL}
    seed = 2 ** 31 + 517
    prog = kind.build(block, _side(True, seed))
    ref = kind.build(block, _side(False, seed))
    assert isinstance(ref, DemixDialog) and len(ref.nets) == 3
    # the program's nets sit in the enhancer's ensemble, in the closure
    dmx = next(c.cell_contents for c in prog.__closure__
               if type(c.cell_contents).__name__ == "EnsembleDemixer")
    assert [type(n) for n in dmx.nets] == [HTDemucsRef] * 3
    states = [n.state_dict() for n in dmx.nets]
    for p, r in zip(states, (n.state_dict() for n in ref.nets)):
        assert p.keys() == r.keys() and all(torch.equal(p[k], r[k]) for k in p)
    key = "crosstransformer.layers.0.self_attn.in_proj_weight"
    assert not torch.equal(states[0][key], states[1][key])
    assert not torch.equal(states[1][key], states[2][key])
    other = kind.draws(block, seed + 1, "cpu")
    assert not torch.equal(other[0][key], states[0][key])


def test_kind_counts_chunks_times_nets_times_a_chunk():
    """The count of one chunk on the ``meta`` device equals a real
    forward's, and a file's terms are its 44.1 kHz chunks at overlap 0.25
    times the nets times that count."""
    kind = _kind()
    block = {"nets": 3, "net": SMALL}
    probe = SimpleNamespace(count=flops.count)
    r = kind.rates(block, probe)
    net = HTDemucs(**SMALL).eval()
    real = flops.count(lambda: net(torch.zeros(1, 2, r["chunk"])), net)
    assert r["chunk"] == 88200 and r["nets"] == 3 and r["per_chunk"] == real > 0
    # 7 s at 16 kHz: 308,700 samples at 44.1 kHz, chunks every 66,150
    geo = SimpleNamespace(n_samples=7 * 16000)
    assert kind.terms(r, geo) == [5 * 3 * real]
    assert kind.terms(r, SimpleNamespace(n_samples=16000)) == [3 * real]


def test_reference_and_kind_import_neither_package():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import perfbench.reference.models.htdemucs\n"
            "import perfbench.reference.pipelines.demix_dialog\n"
            "from perfbench.harness.spec import load_kind\n"
            "load_kind('htdemucs_seeded')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'speech_diarization_tpu', "
            "'speech_diarization_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == "[]"
