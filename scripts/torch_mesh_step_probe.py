"""Where a mesh training step's time goes on one card: the ECAPA step of
``chip_smoke.py`` phase 8d (``ecapa_robust_stream.npz``'s width, 16 x 2 s,
train-mode BN, 64 classes) on one device and on virtual meshes of the card
(dp 1 x tp 2: the split leaves alone; dp 2 x tp 1: the shard threads
alone; dp 2 x tp 2), each at the interpreter's default thread switch
interval and at 50 us (``sys.setswitchinterval``): the dp shards run on
long-lived threads that take turns and meet at every BatchNorm
statistic.

    python3 scripts/torch_mesh_step_probe.py [--steps 10] [--cards]

``--cards``: the meshes over the first cards of the machine (4 needed)
instead of the first card repeated.

Prints one line per configuration: the median of ``--steps`` steps on CUDA
events after a warm-up step, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cards", action="store_true",
                    help="meshes over real cards instead of the first repeated")
    args = ap.parse_args()

    import torch

    from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn
    from speech_diarization_tpu_torch.models.port import load_params_meta, load_params_npz
    from speech_diarization_tpu_torch.parallel import make_mesh
    from speech_diarization_tpu_torch.train.steps import apply_step, make_ecapa_train_step
    from speech_diarization_tpu_torch.train.synthetic import make_speaker_bank, make_speaker_batch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    w = ROOT / "weights" / "ecapa_robust_stream.npz"
    meta = load_params_meta(w)["net"]
    net_cfg = dict(meta, dilations=tuple(meta["dilations"]))
    cls = np.random.default_rng(0).standard_normal((64, net_cfg["emb_dim"])) \
        .astype(np.float32) * 0.05
    flat = {**load_params_npz(w), "classifier": cls}
    bank = make_speaker_bank(np.random.default_rng(8), 64)
    g = np.random.default_rng(9)
    batches = [tuple(torch.as_tensor(a).to(dev) for a in make_speaker_batch(
        g, bank, 16, dur_s=2.0)) for _ in range(4)]
    default = sys.getswitchinterval()

    def mesh(n, tp=1):
        return make_mesh(n_devices=n, tp=tp) if args.cards else make_mesh(
            devices=[dev] * n, tp=tp)

    for tag, where in (("one device", dev), ("dp1xtp2", mesh(2, 2)),
                       ("dp2xtp1", mesh(2)), ("dp2xtp2", mesh(4, 2))):
        init_fn, step_fn, shard = make_ecapa_train_step(where, EcapaTdnn(**net_cfg), 64)
        state = shard(init_fn(params=flat))

        def loss_fn(*b):
            return step_fn.loss_fn(state.params, *b)

        for interval in (default, 5e-5):
            sys.setswitchinterval(interval)
            try:
                apply_step(state, loss_fn, *batches[0])
                ev = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) for _ in range(args.steps)]
                for i, (a, b) in enumerate(ev):
                    a.record()
                    apply_step(state, loss_fn, *batches[1 + i % 3])
                    b.record()
                torch.cuda.synchronize()
            finally:
                sys.setswitchinterval(default)
            med = float(np.median([a.elapsed_time(b) for a, b in ev]))
            print(f"{tag}, switch interval {1e6 * interval:.0f} us: step median "
                  f"{med:.3f} ms; {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
