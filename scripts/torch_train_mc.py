#!/usr/bin/env python
"""Multi-condition training on the CUDA card (``--cpu``: on the CPU): the
port's counterpart of ``scripts/train_mc.py``, with its subcommands, flags
and outputs (``speech_diarization_tpu_torch/train/mc.py``).

    python scripts/torch_train_mc.py vad           [--steps 600] [--cpu]
    python scripts/torch_train_mc.py encoder-proto [--steps 2000] [--src x.npz]
    python scripts/torch_train_mc.py segmentation --powerset --seg-arch xf ...
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from speech_diarization_tpu_torch.train.mc import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main())
