"""Entry points of the port for a quick check: a single-device forward and a
multi-device dry run (the JAX package's ``__graft_entry__.py``).

    python -m speech_diarization_tpu_torch.dryrun 4     # on the card

``dryrun_multichip`` runs on a virtual mesh: ``n_devices`` times one device
(the card unless ``device`` names another), as the JAX dry run runs on
``n_devices`` virtual CPU devices.  Torch has no platform to force before it
starts, so no subprocess is needed.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def entry(device=None):
    """A forward step of the flagship model: ECAPA-TDNN speaker embeddings
    of a batch of 1.5 s windows (the inner loop of the window-grid pass),
    at the default widths with seed-0 weights, on the card unless
    ``device`` is given.  Returns ``(fn, example_args)``; ``fn(*args)``
    -> [8, 192] float32."""
    from .models.ecapa import EcapaModel
    from .train.init import init_like_jax
    from .utils.device import resolve_device

    dev = resolve_device(device)
    model = EcapaModel()
    init_like_jax(model.net, 0)
    model = model.to(dev).eval()

    def fn(wavs):
        with torch.no_grad():
            return model.encode_batch(wavs)

    example = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 24000)).astype(np.float32)).to(dev)
    return fn, (example,)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Two phases on a virtual mesh of ``n_devices`` copies of ``device``:

    1. **Sharded inference**: a ``DiarizationPipeline`` whose window grid is
       sharded over dp (``make_sharded_encode_fn``) diarizes the seed-2
       60 s three-speaker conversation with the shipped
       ``ecapa_synthetic.npz`` and ``vad_conv_mc.npz`` in batches of
       ``8 * dp``; its segments must equal the single-device run's; DER
       against the generator truth is printed.
    2. **A dp x tp ECAPA training step** (tp 2 when ``n_devices`` is even
       and at least 4): the loss must be finite.

    Returns what it printed, as a dict."""
    from .config import ClusterConfig, DiarizationConfig, EmbedConfig
    from .metrics.der import diarization_error_rate
    from .models.ecapa import EcapaModel, EcapaTdnn
    from .models.port import load_speaker_encoder, load_vad
    from .parallel import make_mesh, make_sharded_encode_fn
    from .pipelines.diarize import DiarizationPipeline
    from .train.init import init_like_jax
    from .train.steps import make_ecapa_train_step
    from .train.synthetic import make_conversation
    from .types import SegmentArray
    from .utils.device import resolve_device

    dev = resolve_device(device)
    devices = [dev] * n_devices

    # ---- phase 1: sharded flagship inference ----------------------------
    enc_w = WEIGHTS / "ecapa_synthetic.npz"
    if enc_w.exists():
        model = load_speaker_encoder(enc_w)
    else:   # weights-free: the dry run stays self-contained
        model = EcapaModel(EcapaTdnn(n_mels=24, channels=64, emb_dim=32, scale=4,
                                     se_channels=16, att_channels=16))
        init_like_jax(model.net, 0)
    vad_w = next((WEIGHTS / n for n in ("vad_conv_mc.npz", "vad_conv_synthetic.npz",
                                         "vad_synthetic.npz")
                  if (WEIGHTS / n).exists()), None)
    vad = load_vad(vad_w) if vad_w is not None else None
    mesh = make_mesh(devices=devices)
    dp = mesh.shape["dp"]
    cfg = DiarizationConfig(
        cluster=ClusterConfig(method="spectral", max_speakers=8),
        embed=EmbedConfig(batch_size=8 * dp, max_batch_size=8 * dp))
    wave, truth = make_conversation(np.random.default_rng(2), 60.0, n_speakers=3,
                                    sr=16000)
    single = DiarizationPipeline(cfg, encoder=model, vad=vad, device=dev)
    sharded = DiarizationPipeline(cfg, encoder=make_sharded_encode_fn(model, None, mesh),
                                  vad=vad, device=dev)
    t0 = time.perf_counter()
    r_single = single(wave)
    t1 = time.perf_counter()
    r_sharded = sharded(wave)
    t2 = time.perf_counter()
    s1, s2 = r_single.segments, r_sharded.segments
    if len(s1) != len(s2):
        raise AssertionError(f"sharded/single segment count mismatch: "
                             f"{len(s1)} vs {len(s2)}")
    np.testing.assert_allclose(s1.starts, s2.starts, atol=1e-6)
    np.testing.assert_allclose(s1.ends, s2.ends, atol=1e-6)
    np.testing.assert_array_equal(s1.spks, s2.spks)
    der = 100.0 * diarization_error_rate(SegmentArray(*truth), s2).der
    print(f"dryrun sharded inference ok: dp={dp} on {dev}, {len(s2)} segments, "
          f"{r_sharded.num_speakers} speakers, DER {der:.2f}% (== single-device "
          f"output)", flush=True)

    # ---- phase 2: a dp x tp training step -------------------------------
    tp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh_t = make_mesh(devices=devices, tp=tp)
    dp_t = mesh_t.shape["dp"]
    net = EcapaTdnn(n_mels=20, channels=64, emb_dim=32, scale=4, se_channels=16,
                    att_channels=16)
    init_fn, step_fn, shard_state = make_ecapa_train_step(mesh_t, net, n_classes=16)
    state = shard_state(init_fn(0))
    g = np.random.default_rng(0)
    batch = 2 * dp_t
    wavs = g.standard_normal((batch, 4000)).astype(np.float32)
    labels = g.integers(0, 16, size=batch)
    state, loss = step_fn(state, wavs, labels)
    loss_val = float(loss)
    if not np.isfinite(loss_val):
        raise AssertionError(f"non-finite loss: {loss_val}")
    print(f"dryrun_multichip ok: inference dp{dp} DER {der:.2f}%; train "
          f"mesh=dp{dp_t}xtp{mesh_t.shape['tp']} loss={loss_val:.4f}", flush=True)
    return {"dp": dp, "segments": len(s2), "speakers": r_sharded.num_speakers,
            "der_pct": der, "wall_single_s": t1 - t0, "wall_sharded_s": t2 - t1,
            "train_mesh": (dp_t, mesh_t.shape["tp"]), "loss": loss_val}


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
