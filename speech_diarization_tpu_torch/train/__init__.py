"""Training: the JAX package's ``train/`` on one device.

* ``synthetic.py``, ``heldout.py``, ``multicond.py``: the data generators
  (numpy; the same arrays as the JAX package's for the same seed);
* ``objectives.py``: AAM-softmax, SI-SNR, frame BCE (PIT losses beside the
  segmentation net, ``models/segmentation.py``; the angular prototypical
  loss in ``proto.py``);
* ``optim.py``: the optax optimizers of the recipes on ``torch.optim``;
* ``init.py``: seeded initial weights with the JAX inits' distributions;
* ``steps.py``: ``TrainState``, ``make_ecapa_train_step``,
  ``make_gtcrn_train_step``;
* ``checkpoint.py``: training-state checkpoints and npz exports;
* ``recipes.py``, ``proto.py``: the recipes behind the shipped weights;
* ``mc.py``: the multi-condition driver (``scripts/torch_train_mc.py``).

The objectives and the steps are exported here, as by the JAX package's
``train``; the other modules load on demand.
"""
from .objectives import aam_softmax_loss, bce_vad_loss, si_snr_loss
from .steps import TrainState, make_ecapa_train_step, make_gtcrn_train_step

__all__ = [
    "aam_softmax_loss",
    "si_snr_loss",
    "bce_vad_loss",
    "make_ecapa_train_step",
    "make_gtcrn_train_step",
    "TrainState",
]
