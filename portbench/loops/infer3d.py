"""A closed loop of 3D volumes through the program's
`inference/sliding_window.SlidingWindowInference.predict_segmentation`:
nnUNet's tile grid, Gaussian blending, the mirror flips of a tile in one
batch, the argmax on the card and a uint8 fetch.

Set-up builds the model (no deep supervision) and its engine, makes a
pool of `pool` distinct CT-like volumes on the card (handed to the
engine as host arrays, as a user's volumes come) and predicts
`warmup_units` of them. The window cycles through the pool.

What is compared, after the window: `label_gap`, the widest gap by which
the reference's probability of a voxel's label lies below the
reference's best, over every answer the window gave for `checked_volumes`
pool volumes drawn from the seed.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import data, harness
from portbench.reference import sliding_window


class Loop:
    unit = "volume"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = dict(ctx.cfg, do_ds=False)
        self.t = ctx.traffic
        self.calls = 0
        self.answers = {}

    def setup(self):
        from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference

        c, t, cfg = self.ctx, self.t, self.cfg
        with harness.stage(c.stages, "state", c.device):
            self.state = harness.make_state(c.reference.param_shapes(cfg), c.seed, c.device)
        with harness.stage(c.stages, "build", c.device):
            self.model = c.config.build(cfg, c.device)
        self.model.load_state_dict(self.state)
        self.engine = SlidingWindowInference(
            self.model, patch_size=tuple(cfg["img_size"]), num_classes=cfg["num_classes"],
            step_size=t["step_size"], do_mirroring=True, tta_batch=t["tta_batch"],
            device=c.device)
        images, _ = data.organs(t["pool"], tuple(t["volume"]), cfg["num_classes"],
                                c.seed + 1, c.device)
        self.volumes = data.zscore(images)
        self.host = [v[..., None].cpu().numpy() for v in self.volumes]
        for _ in range(t["warmup_units"]):
            self.run_unit()
        self.answers.clear()

    def run_unit(self):
        i = self.calls % self.t["pool"]
        self.calls += 1
        self.answers.setdefault(i, []).append(self.engine.predict_segmentation(self.host[i]))

    @staticmethod
    def end_to_end(window_s: float, units: int) -> dict:
        return {"volumes_per_s": units / window_s}

    def release(self):
        del self.model, self.engine

    def _checked(self) -> list:
        rng = np.random.default_rng(self.ctx.seed)
        done = sorted(self.answers)
        return sorted(rng.choice(done, min(self.t["checked_volumes"], len(done)),
                                 replace=False).tolist())

    def outputs(self) -> dict:
        return {i: self.answers[i] for i in self._checked()}

    def reference(self, tf32: bool = False) -> dict:
        R, cfg = self.ctx.reference, self.cfg
        with harness.tf32(tf32), torch.no_grad():
            return {i: sliding_window.probabilities(
                lambda x: R.forward(self.state, cfg, x), self.volumes[i],
                tuple(cfg["img_size"]), self.t["step_size"], cfg["num_classes"])
                for i in self._checked()}

    @staticmethod
    def as_answer(ref: dict) -> dict:
        return {i: [p.argmax(-1).to(torch.uint8).cpu().numpy()] for i, p in ref.items()}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        gap = 0.0
        for i, answers in got.items():
            p = ref[i]
            best = p.max(-1).values
            for labels in answers:
                lab = torch.from_numpy(np.asarray(labels, np.int64)).to(p.device)
                mine = p.gather(-1, lab[..., None])[..., 0]
                gap = max(gap, float((best - mine).max()))
        return {"label_gap": gap}

    def count(self) -> dict:
        from portbench import counts

        R, cfg = self.ctx.reference, self.cfg
        patch = tuple(cfg["img_size"])
        tiles = len(sliding_window.origins(patch, tuple(self.t["volume"]), self.t["step_size"]))
        p = {k: torch.empty(s, device="meta") for k, (s, _) in R.param_shapes(cfg).items()}
        x = torch.empty(len(sliding_window.FLIPS), 1, *patch, device="meta")
        return counts.count_unit(lambda: R.forward(p, cfg, x), times=tiles)
