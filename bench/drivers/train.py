"""Training traffic: one job's steps back to back on a fixed global batch.

Traffic parameters: ``sequences`` and ``seq_len`` (the batch a step),
``microbatches`` (gradient accumulation), ``remat``, the ``optimizer``'s
settings, ``checked_steps`` (the steps the reference follows) and
``profiled_steps`` (the steps a traced run profiles after its window).
Step ``i`` trains on its own token ids, uniform over the published
vocabulary from ``(seed, i)``, the labels the ids themselves (next-token
loss); a vision configuration's rows also get their patch embeddings.

Set-up builds the port's model, optimizer state and step once, and drives
them through steps 1 to ``checked_steps`` through the step and feed the
window uses, keeping what the check compares: each step's loss and
gradient norm (the step's own metrics), each leaf's first gradient as the
optimizer got it (its first moment after one step over ``1 - beta1``) and
each leaf's change over those steps.  The window goes on from there with
the same objects, reading each step's loss on the host as a training loop
logs it.  After the window the reference makes the weights and batches
again from the seed and follows the same steps in float32.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict, List

import torch

from benchlib import program, weights

STREAM = 2  # the token stream of the training batches
MIN_LEAF_SHARE = 1e-3  # leaves whose reference gradient is below this share
# of the median leaf's move by round-off alone, and are left out of the change


class Driver:
    kind = "train"

    def __init__(self, ctx):
        self.ctx = ctx
        tr = ctx.traffic
        self.B, self.S, self.A = tr["sequences"], tr["seq_len"], tr["microbatches"]
        self.checked = tr["checked_steps"]
        self.vocab = ctx.conf["vocab_size"]

    # ---- the feed ---------------------------------------------------------- #

    def batch(self, i: int) -> Dict[str, torch.Tensor]:
        c = self.ctx
        P = c.conf.get("n_patches") or 0
        t = weights.tokens(c.conf, c.seed, STREAM, i, (self.B, self.S - P), c.device)
        b = {"tokens": t, "labels": t}
        if P:
            b["patches"] = weights.patches(c.conf, c.seed, STREAM, i, self.B, c.device)
        return b

    def _step(self, i: int) -> Dict[str, torch.Tensor]:
        self.model, self.opt, m = self.step(self.model, self.opt, self.batch(i))
        return m

    # ---- set-up ------------------------------------------------------------ #

    def setup(self) -> None:
        c = self.ctx
        tr = c.traffic
        t0 = time.perf_counter()
        self.arch = program.arch(c.conf, remat=tr["remat"], accum_steps=self.A)
        self.model = program.model(self.arch, weights.make(c.conf, c.seed, c.device))
        self.setup_times = {"weights_s": time.perf_counter() - t0, "steps_s": []}
        self.opt_cfg = program.adamw(tr["optimizer"])
        self.opt = program.adamw_init(self.model, self.opt_cfg)
        self.step = program.train_step(self.arch, self.opt_cfg)
        w0 = {k: program.published(k, p, self.vocab).detach().clone()
              for k, p in self.model.named_parameters()}
        losses, norms = [], []
        for i in range(1, self.checked + 1):
            t0 = time.perf_counter()
            m = self._step(i)
            losses.append(float(m["loss"]))
            self.setup_times["steps_s"].append(time.perf_counter() - t0)
            norms.append(float(m["grad_norm"]))
            if i == 1:
                b1 = tr["optimizer"]["beta1"]
                first = {k: float(program.published(k, v, self.vocab).float().norm())
                         / (1 - b1) for k, v in self.opt.m.items()}
        change = {k: float((program.published(k, p, self.vocab).detach().float()
                            - w0[k].float()).norm())
                  for k, p in self.model.named_parameters()}
        del w0
        self.readings = {"loss": losses, "grad_norm": norms, "first_grad": first,
                         "change": change}
        self.next = self.checked + 1

    # ---- the window -------------------------------------------------------- #

    def _steps(self, until) -> List[dict]:
        units = []
        while True:
            k5 = program.k5_launches()
            t0 = time.perf_counter()
            loss = float(self._step(self.next)["loss"])
            t1 = time.perf_counter()
            k5_after = program.k5_launches()
            units.append({"kind": "train", "batch": self.B, "seq": self.S,
                          "microbatches": self.A, "start": t0, "end": t1,
                          "ok": math.isfinite(loss),
                          "k5_launches": {k: k5_after[k] - k5[k] for k in k5}})
            self.next += 1
            if until(units):
                return units

    def window(self, seconds: float) -> List[dict]:
        t = time.perf_counter()
        return self._steps(lambda u: u[-1]["end"] - t >= seconds)

    def profile(self, n=None) -> List[dict]:
        """``n`` steps more (the traffic's ``profiled_steps`` by default)."""
        n = n or self.ctx.traffic["profiled_steps"]
        return self._steps(lambda u: len(u) >= n)

    def shape_check(self, units: List[dict]) -> str:
        """K5's launches a window step against the cell's shape: the
        forward once a layer and microbatch (twice with remat), the
        backward once."""
        L = self.ctx.conf["num_hidden_layers"]
        want = {"flash_attention": (2 if self.ctx.traffic["remat"] else 1) * L * self.A,
                "flash_attention_backward": L * self.A}
        seen = {k: sorted({u["k5_launches"][k] for u in units}) for k in want}
        return f"K5 launches a step {seen}, the shape's {want}"

    @staticmethod
    def end_to_end(units: List[dict]) -> Dict[str, float]:
        tokens = sum(u["batch"] * u["seq"] for u in units)
        return {"train_tokens_per_s": tokens / (units[-1]["end"] - units[0]["start"])}

    def free(self) -> None:
        del self.model, self.opt, self.step

    # ---- the check --------------------------------------------------------- #

    def reference_readings(self, precision: str = "float32") -> dict:
        """The reference's readings of the checked steps from the seed's
        weights and batches: ``precision`` "float32", or the control."""
        c = self.ctx
        ref, opt_ref = c.reference, c.optimizer
        made = weights.make(c.conf, c.seed, c.device)
        stored = {k: v.dtype for k, v in made.items()}
        W = {k: v.float().requires_grad_() for k, v in made.items()}
        del made
        w0 = {k: v.detach().clone() for k, v in W.items()}
        opt = opt_ref.AdamW(W, stored, c.traffic["optimizer"])
        losses, norms = [], []
        with ref.float32_exact():
            for i in range(1, self.checked + 1):
                loss, grads = ref.loss_and_grads(W, c.conf, self.batch(i), self.A, precision)
                out = opt.step(grads)
                del grads
                losses.append(loss)
                norms.append(out["grad_norm"])
                if i == 1:
                    first = out["leaf_norms"]
        change = {k: float((W[k].detach() - w0[k]).norm()) for k in W}
        return {"loss": losses, "grad_norm": norms, "first_grad": first,
                "change": change}

    @staticmethod
    def compare(got: dict, want: dict) -> Dict[str, float]:
        """The numbers the check holds to its limits, each a worst case:
        ``loss`` and ``grad_norm`` the largest gap over the checked steps
        as a share of the reference's; ``grad_leaf`` and ``change_leaf`` the
        largest gap between a leaf's norms (first gradient; change over the
        steps) as a share of the reference's norm of that leaf or of the
        median leaf, whichever is larger."""
        def steps(key):
            return max(abs(g - w) / abs(w) for g, w in zip(got[key], want[key]))

        def leaves(key, names):
            med = statistics.median(want[key][k] for k in names)
            return max(abs(got[key][k] - want[key][k]) / max(want[key][k], med)
                       for k in names)

        g_med = statistics.median(want["first_grad"].values())
        moved = [k for k, v in want["first_grad"].items() if v >= MIN_LEAF_SHARE * g_med]
        return {"loss": steps("loss"), "grad_norm": steps("grad_norm"),
                "grad_leaf": leaves("first_grad", list(want["first_grad"])),
                "change_leaf": leaves("change", moved)}

    def check(self) -> Dict[str, float]:
        return self.compare(self.readings, self.reference_readings())

    def control(self) -> Dict[str, float]:
        """The control's numbers: the reference in fp8 in the program's
        place."""
        return self.compare(self.reference_readings("fp8"), self.reference_readings())
