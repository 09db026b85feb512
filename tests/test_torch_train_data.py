"""The port's training data against the JAX package's: the multi-condition
generators (``train/multicond.py``) and the synthetic training examples
(``train/synthetic.py``, ``train/recipes.py::make_noisy_clean_batch``) give
byte-equal arrays for the same seed, and the proto recipe's pool and batch
draws (``train/proto.py``) follow the JAX recipe's draw order."""
from __future__ import annotations

import numpy as np
import pytest

from speech_diarization_tpu.train import multicond as jmc
from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu.train import synthetic as jsyn
from speech_diarization_tpu_torch.train import multicond as tmc
from speech_diarization_tpu_torch.train import recipes as trec
from speech_diarization_tpu_torch.train import synthetic as tsyn


def assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_same(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def both(fn_name, mod_j, mod_t, seed, *args, **kw):
    """The function of each package on a fresh generator of ``seed``; the
    generators must end in the same state too."""
    gj, gt = np.random.default_rng(seed), np.random.default_rng(seed)
    out_j = getattr(mod_j, fn_name)(gj, *args, **kw)
    out_t = getattr(mod_t, fn_name)(gt, *args, **kw)
    assert gj.bit_generator.state == gt.bit_generator.state
    return out_j, out_t


@pytest.mark.parametrize("seed", [0, 7])
def test_speaker_bank_and_render(seed):
    bj, bt = both("make_mc_speaker_bank", jmc, tmc, seed, 6)
    assert_same(bj, bt)
    for fam in ("lpc", "harm"):
        wj, wt = both("render_speaker", jmc, tmc, seed + 1, bj[2], 0.7,
                      family=fam)
        assert_same(wj, wt)


@pytest.mark.parametrize("seed", [0, 3])
def test_channel_bank(seed):
    cj = jmc.ChannelBank(np.random.default_rng(seed))
    ct = tmc.ChannelBank(np.random.default_rng(seed))
    wave = np.random.default_rng(seed + 9).standard_normal(8000).astype(np.float32)
    gj, gt = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    for kw in ({}, {"snr_db": (8.0, 30.0)}):
        assert_same(cj.apply(gj, wave, **kw), ct.apply(gt, wave, **kw))


@pytest.mark.parametrize("name,args", [
    ("make_vad_example_mc", (1.5,)),
    ("make_segmentation_example_mc", ()),
    ("make_segmentation_example_conv", ()),
])
def test_examples_mc(name, args):
    cj = jmc.ChannelBank(np.random.default_rng(1))
    ct = tmc.ChannelBank(np.random.default_rng(1))
    gj, gt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        assert_same(getattr(jmc, name)(gj, *args, channels=cj),
                    getattr(tmc, name)(gt, *args, channels=ct))


def test_noisy_clean_and_speaker_batches_mc():
    cj = jmc.ChannelBank(np.random.default_rng(2))
    ct = tmc.ChannelBank(np.random.default_rng(2))
    nj, nt = both("make_noisy_clean_batch_mc", jmc, tmc, 4, 3, 1.0)
    assert_same(nj, nt)
    nj, nt = both("make_noisy_clean_batch_mc", jmc, tmc, 4, 2, 1.0, channels=cj)
    nt2 = tmc.make_noisy_clean_batch_mc(np.random.default_rng(4), 2, 1.0,
                                        channels=ct)
    assert_same(nj, nt2)
    bank = jmc.make_mc_speaker_bank(np.random.default_rng(0), 4)
    sj, st = both("make_speaker_batch_mc", jmc, tmc, 8, bank, 3, dur_s=1.0)
    assert_same(sj, st)


@pytest.mark.parametrize("name,args,kw", [
    ("make_vad_example", (1.5,), {}),
    ("make_segmentation_example", (2.0,), {"max_speakers": 3}),
    ("make_demix_example", (0.5,), {}),
    ("make_speaker_batch", (jsyn.make_speaker_bank(np.random.default_rng(1), 3),
                            3), {"dur_s": 1.0}),
    ("synth_negative", (0.7,), {}),
])
def test_synthetic_examples(name, args, kw):
    for seed in range(3):
        assert_same(*both(name, jsyn, tsyn, seed, *args, **kw))


def test_noisy_clean_batch():
    assert_same(*both("make_noisy_clean_batch", jrec, trec, 3, 4, 1.0))
    est = np.random.default_rng(0).standard_normal((3, 800)).astype(np.float32)
    ref = np.random.default_rng(1).standard_normal((3, 800)).astype(np.float32)
    assert trec.si_snr_db(est, ref) == jrec.si_snr_db(est, ref)


def test_flatten_roundtrip():
    from speech_diarization_tpu.models.layers import GRUParams

    tree = {"a": np.ones(2), "blk": [{"w": np.zeros(3)}, {"w": np.ones(3)}],
            "gru": GRUParams(*(np.full(2, i, np.float32) for i in range(4)))}
    flat_j, flat_t = jrec._flatten(tree), trec._flatten(tree)
    assert list(flat_j) == list(flat_t)
    assert_same(list(flat_j.values()), list(flat_t.values()))
    back = trec.unflatten_params(flat_t)
    assert set(back) == {"a", "blk", "gru"}
    assert isinstance(back["blk"], list) and len(back["blk"]) == 2
    assert set(back["gru"]) == {"w_ih", "w_hh", "b_ih", "b_hh"}
