"""A closed loop of 2D cases through the program's
`inference/predictor2d.Predictor2D.predict_slices`: a case's slices at
224², `slice_batch` slices a forward, the last chunk zero-padded, the
argmax on the card and a uint8 fetch per chunk.

Set-up builds the model and the predictor, loads the state made from the
seed, makes one CT-like case for each of the mix's slice counts on the
card (handed to the predictor as host arrays), orders the cases by the
seed (every seed runs the same sizes) and predicts `warmup_units` of them.
The window cycles through the cases.

What is compared, after the window: `logit_gap`, the widest gap by which
the reference's logit of a pixel's label lies below the reference's best,
over every answer the window gave for `checked_cases` cases: the longest
case and others drawn from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import data, harness


class Loop:
    unit = "case"

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.t = ctx.traffic
        self.calls = 0
        self.answers = {}
        self.ran = []

    def setup(self):
        from deformablelka_tpu_torch.inference.predictor2d import Predictor2D

        c, t, cfg = self.ctx, self.t, self.cfg
        S = cfg["img_size"]
        with harness.stage(c.stages, "state", c.device):
            self.state = harness.make_state(c.reference.param_shapes(cfg), c.seed, c.device)
        with harness.stage(c.stages, "build", c.device):
            self.model = c.config.build(cfg, c.device)
        self.model.load_state_dict(self.state)
        self.predictor = Predictor2D(self.model, (S, S), cfg["num_classes"], t["slice_batch"],
                                     device=c.device)
        sizes = t["slices"]
        images, _ = data.organs(sum(sizes), (S, S), cfg["num_classes"], c.seed + 1, c.device)
        images = ((images - 0.5) / 0.5)[..., None]
        self.cases = list(torch.split(images, sizes))
        self.host = [x.cpu().numpy() for x in self.cases]
        self.order = np.random.default_rng(c.seed).permutation(len(sizes)).tolist()
        for _ in range(t["warmup_units"]):
            self.run_unit()
        self.answers.clear()
        self.ran.clear()

    def run_unit(self):
        i = self.order[self.calls % len(self.order)]
        self.calls += 1
        self.ran.append(i)
        self.answers.setdefault(i, []).append(self.predictor.predict_slices(self.host[i]))

    def end_to_end(self, window_s: float, units: int) -> dict:
        return {"slices_per_s": sum(self.t["slices"][i] for i in self.ran) / window_s}

    def stretch_units(self, n: int) -> dict:
        """The last n cases' forwards (the per-layer unit) and real slices
        (the work)."""
        sizes = [self.t["slices"][i] for i in self.ran[-n:]]
        return {"layer": sum(math.ceil(s / self.t["slice_batch"]) for s in sizes),
                "work": sum(sizes)}

    def release(self):
        del self.model, self.predictor

    def _checked(self) -> list:
        done = sorted(self.answers)
        longest = max(done, key=lambda i: self.t["slices"][i])
        rest = [i for i in done if i != longest]
        rng = np.random.default_rng(self.ctx.seed)
        k = min(self.t["checked_cases"] - 1, len(rest))
        return sorted([longest] + rng.choice(rest, k, replace=False).tolist())

    def outputs(self) -> dict:
        return {i: self.answers[i] for i in self._checked()}

    def reference(self, tf32: bool = False) -> dict:
        R, cfg, B = self.ctx.reference, self.cfg, self.t["slice_batch"]
        with harness.tf32(tf32), torch.no_grad():
            return {i: torch.cat([R.forward_cl(self.state, cfg, self.cases[i][j:j + B])
                                  for j in range(0, len(self.cases[i]), B)])
                    for i in self._checked()}

    @staticmethod
    def as_answer(ref: dict) -> dict:
        return {i: [z.argmax(-1).to(torch.uint8).cpu().numpy()] for i, z in ref.items()}

    @staticmethod
    def compare(got: dict, ref: dict) -> dict:
        gap = 0.0
        for i, answers in got.items():
            z = ref[i]
            best = z.max(-1).values
            for labels in answers:
                lab = torch.from_numpy(np.asarray(labels, np.int64)).to(z.device)
                gap = max(gap, float((best - z.gather(-1, lab[..., None])[..., 0]).max()))
        return {"logit_gap": gap}

    def count(self) -> dict:
        """Per slice; the hand kernels per call of a full chunk."""
        from portbench import counts

        R, cfg, B = self.ctx.reference, self.cfg, self.t["slice_batch"]
        S = cfg["img_size"]
        p = {k: torch.empty(s, device="meta") for k, (s, _) in R.param_shapes(cfg).items()}
        x = torch.empty(B, S, S, 1, device="meta")
        c = counts.count_unit(lambda: R.forward_cl(p, cfg, x))
        c["flops"] /= B
        c["dense_flops"] /= B
        return c
