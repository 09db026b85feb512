"""The check catches what it must: a whole run of the harness, on the CPU at
a small size and with the look for a card skipped, comes out correct as it
is, and not correct with the timed path broken underneath (an answer
altered where it is produced: the speech probabilities, the window
embeddings, the enhanced waveform, the final segments) or with the control
in the program's place.  The cells' committed limits judge every run.

The card-only case runs the control of each cell at the cell's own size; it
skips here, from inside its fixture.
"""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import runner  # noqa: E402
from perfbench.harness.spec import resolve  # noqa: E402

SEED = 2 ** 31 + 101


def _small(cell: str):
    """The cell with its pool cut to two short files and one checked: what
    a CPU test run can hold.  Everything else is the cell's."""
    c = resolve(cell)
    c.traffic = dict(c.traffic, pool=2, lengths_s={"fixed": [20.0, 26.0]}, check_files=1)
    if "files_per_call" in c.traffic:
        c.traffic["files_per_call"] = 2
    return c


def _run(cell: str, **kw) -> dict:
    return runner.run_cell(_small(cell), SEED, 3.0, device="cpu", pool_workers=1, **kw)


def _shift_probs(system):
    vad = system.program.vad
    orig = vad.probs_from_feats
    vad.probs_from_feats = lambda feats: orig(feats) + 0.02


def _scale_embeddings(system):
    enc = system.program.encoder
    orig = enc.encode_grid_feats
    enc.encode_grid_feats = lambda *a, **k: orig(*a, **k) * 1.5


def _scale_enhanced(system):
    pipe = system.program
    orig = pipe.enhance_fn
    pipe.enhance_fn = lambda y: orig(y) * 1.01


def _relabel(system):
    def alter(k, res):
        if len(res.segments):
            res.segments.spks[0] = res.segments.spks[0] + 1
        return res
    return alter


def _permute_grid(system):
    """The windowed grid's batches put together in another order: each
    batch the net encodes is right, the window order of the result wrong."""
    mod = importlib.import_module("speech_diarization_tpu_torch.pipelines.diarize")
    orig = mod.embed_windows

    def embed_windows(*a, **k):
        out = orig(*a, **k)
        return out.flip(0) if out.shape[0] > 1 else out
    mod.embed_windows = embed_windows


def test_sound_run_is_correct():
    out = _run("default.calls")
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["numbers"]["tail_mismatch"] == 0


@pytest.mark.parametrize("cell,fault,number", [
    ("default.calls", _shift_probs, "vad_gap"),
    ("default.calls", _scale_embeddings, "emb_gap"),
    ("default.calls", _relabel, "tail_mismatch"),
    ("default.noisy", _scale_enhanced, "enh_gap"),
])
def test_fault_is_caught(cell, fault, number):
    out = _run(cell, fault=fault)
    assert not out["correct"]
    lim = out["check"][number]["limit"]
    assert out["numbers"][number] > lim


def test_control_is_not_correct_cpu():
    """The default configuration's control (bfloat16 products, an fp8
    trunk) fails; TF32, the float32 configuration's control, exists only on
    the card."""
    out = _run("default.calls", control=True)
    assert not out["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 and the cells' own sizes")
    return "cuda"


@pytest.mark.parametrize("cell", ["default.calls", "eres2netv2.calls", "default.noisy"])
def test_control_is_not_correct_card(card, cell):
    out = runner.run_cell(resolve(cell), SEED, 30.0, control=True)
    assert not out["correct"], out["numbers"]


def test_stitch_fault_is_caught_card(card):
    """The windowed grid's window order broken at the cell's own size:
    ``stitch_mismatch`` (exact) fails, ``enc_step_gap`` does not see it."""
    mod = importlib.import_module("speech_diarization_tpu_torch.pipelines.diarize")
    orig = mod.embed_windows
    try:
        out = runner.run_cell(resolve("eres2netv2.calls"), SEED, 10.0, fault=_permute_grid)
    finally:
        mod.embed_windows = orig
    assert not out["correct"]
    assert out["numbers"]["stitch_mismatch"] > 0, out["numbers"]


def test_tail_check_is_exact_through_the_corpus():
    """The host tail of the reference on the program's outputs gives the
    program's segments to the bit (a sound run reads 0), with the files
    fed to ``corpus_diarize`` (the ``corpus`` entry a mix may name)."""
    c = _small("default.calls")
    c.traffic = dict(c.traffic, entry="corpus", files_per_call=2)
    out = runner.run_cell(c, SEED, 3.0, device="cpu", pool_workers=1)
    assert out["correct"], out["check"]
    assert out["numbers"]["tail_mismatch"] == 0 and np.isfinite(out["numbers"]["vad_gap"])


def _file_out(embs, outs):
    from perfbench.harness.check import FileOut

    return FileOut(None, None, None, embs, None, ("streamed", None), None,
                   enc_io=[(None, o) for o in outs])


def test_stitch_mismatch_counts_rows():
    """The net's outputs batch after batch against the window embeddings:
    0 when equal to the bit, the rows that differ otherwise."""
    from perfbench.harness.check import stitch_mismatch

    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    b = rng.standard_normal((2, 3)).astype(np.float32)
    embs = np.concatenate([a, b]).astype(np.float64)
    assert stitch_mismatch(_file_out(embs, [a, b])) == 0
    assert stitch_mismatch(_file_out(embs, [b, a])) > 0
    assert stitch_mismatch(_file_out(np.roll(embs, 1, axis=0), [a, b])) == 7
    assert stitch_mismatch(_file_out(embs[:6], [a, b])) == 7
    assert stitch_mismatch(_file_out(embs, [])) is None
