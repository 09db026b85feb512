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

Nothing is imported here: the modules load on demand.
"""
