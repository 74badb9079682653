"""Faults planted in the program underneath a run, for the tests and the
calibration of the limits: each is a context manager that patches the
program's timed path, after which `correct` has to come out false.

- `unchanged`: the optimizer's step leaves the parameters as they are;
- `half_batch`: the training loss is taken over the first half of the
  batch only (the 2D trainer gets the first half of each host batch); in
  3D inference the softmax is averaged over the first half of the mirror
  flips only, in 2D only the first half of each chunk is predicted;
- `altered`: every answer has a block of labels moved to the next class
  where the engine or the predictor produces it.
"""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def unchanged():
    import torch

    with mock.patch.object(torch.optim.SGD, "step", lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def half_batch():
    import numpy as np

    from deformablelka_tpu_torch.inference import predictor2d, sliding_window
    from deformablelka_tpu_torch.training import losses, train_step, trainer2d

    def half_loss(model, image, label):
        h = image.shape[0] // 2
        return losses.deep_supervision_loss(model(image[:h]), label[:h])

    combos = sliding_window.tta_combos

    def half_combos(axes, do_mirroring):
        out = combos(axes, do_mirroring)
        return out[:max(1, len(out) // 2)]

    to_device = trainer2d._to_device

    def half_to_device(array, device, dtype=None):
        half = array[:max(1, len(array) // 2)]
        return to_device(half, device) if dtype is None else to_device(half, device, dtype)

    labels = predictor2d.Predictor2D._labels

    def half_labels(self, chunk):
        h = len(chunk) // 2
        first = labels(self, chunk[:h])
        return np.concatenate([first, np.zeros((len(chunk) - h, *first.shape[1:]), first.dtype)])

    with mock.patch.object(train_step, "loss_of", half_loss), \
            mock.patch.object(sliding_window, "tta_combos", half_combos), \
            mock.patch.object(trainer2d, "_to_device", half_to_device), \
            mock.patch.object(predictor2d.Predictor2D, "_labels", half_labels):
        yield


@contextlib.contextmanager
def altered():
    from deformablelka_tpu_torch.inference import predictor2d, sliding_window

    def wrong(predict):
        def call(self, x):
            labels = predict(self, x).copy()
            block = tuple(slice(0, max(1, s // 8)) for s in labels.shape)
            labels[block] = (labels[block] + 1) % self.num_classes
            return labels
        return call

    engine, pred = sliding_window.SlidingWindowInference, predictor2d.Predictor2D
    with mock.patch.object(engine, "predict_segmentation", wrong(engine.predict_segmentation)), \
            mock.patch.object(pred, "predict_slices", wrong(pred.predict_slices)):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
