"""Shipped-weights resolution: the first existing file of a preference list
under the repository's ``weights/`` directory (the same files the JAX package
ships and reads)."""
from __future__ import annotations

from pathlib import Path

WEIGHTS_ROOT = Path(__file__).resolve().parents[3] / "weights"

# Default speaker-encoder preference, most capable first.  Streaming-trained
# (*_stream) weights engage the trunk-shared grid under grid_backend='auto'.
ENCODER_PREFERENCE = (
    "ecapa_robust_stream.npz",
    "ecapa_synthetic_full_stream.npz",
    "ecapa_synthetic_full.npz",
    "ecapa_synthetic.npz",
)

# Neural VAD preference of the CLI's --vad-backend auto|neural: the
# multi-condition conv TCN, the in-domain conv net, then the GRU net.
VAD_PREFERENCE = ("vad_conv_mc.npz", "vad_conv_synthetic.npz",
                  "vad_synthetic.npz")

# The segmentation engine's own preference (``Diarizer(engine=
# 'segmentation')``): not the overlap detector's, which takes the xf net
# second.
ENGINE_SEGMENTATION_PREFERENCE = (
    "segmentation_conv.npz", "segmentation_ow3.npz",
    "segmentation_powerset.npz", "segmentation_mc.npz",
    "segmentation_synthetic.npz",
)

# Overlap-detector preference (segmentation checkpoints).
SEGMENTATION_PREFERENCE = (
    "segmentation_conv.npz", "segmentation_xf.npz", "segmentation_ow3.npz",
    "segmentation_powerset.npz", "segmentation_synthetic.npz",
)


def prefer_weights(names, root: Path | None = None) -> Path | None:
    """First existing checkpoint from ``names`` under ``root`` (repo
    ``weights/`` by default); None when nothing ships."""
    root = Path(root) if root is not None else WEIGHTS_ROOT
    return next((root / n for n in names if (root / n).exists()), None)
