"""`train2d`'s closed loop of `Trainer2D` steps (`loops/train2d.py`: the
same set-up, checked steps, reference and comparison), reporting the
seconds a step as `train_step_s`, the end-to-end metric of the
benchmark's training cells."""

from __future__ import annotations

from portbench.loops import train2d


class Loop(train2d.Loop):
    @staticmethod
    def end_to_end(window_s: float, units: int) -> dict:
        return {"train_step_s": window_s / units}
