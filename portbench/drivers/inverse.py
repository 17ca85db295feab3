"""Inverse rendering: the inverse demo's gradient steps, one optimisation
(a closed loop: each step starts when the last was enqueued).

Set-up builds the training step as ``tpt_torch.inverse_demo.main`` wires
it (``tpt_torch.optim.make_renderer`` over the workload's views,
``make_inverse_step`` with clipped Adam and the demo's mask), from the
starting point drawn from the seed, and drives it through its first steps
with the window's own feed: each step's targets re-rendered under
``no_grad`` at that step's frame, ``float(loss)`` every ``loss_every``
steps.  The window goes on with the same object; it ends on a device
synchronise.

The check runs the plain reference through the same first steps from the
same starting point and compares each step's loss, the gradient the
optimizer took at the first step (from its first moment) and the change of
the parameters over the steps, leaf by leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import traffic
from ..harness import Check
from ..reference import paths
from ..tracing import span
from . import Base


def leaf_gaps(got, want):
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's.  Leaves
    whose reference norm is under a thousandth of the median leaf's (moved
    by round-off alone) are left out (None); a non-finite norm on either
    side makes every gap infinite."""
    g = [float(torch.linalg.vector_norm(x.double())) for x in got]
    w = [float(torch.linalg.vector_norm(x.double())) for x in want]
    if not all(np.isfinite(g + w)):
        return [float("inf")] * len(g)   # a non-finite norm on either side is a failure
    med = float(np.median(w))
    return [abs(a - b) / max(b, med) if b >= 1e-3 * med else None for a, b in zip(g, w)]


def worst_leaf_gap(got, want):
    """The worst of :func:`leaf_gaps`."""
    return max([x for x in leaf_gaps(got, want) if x is not None], default=0.0)


class Driver(Base):
    VARIANTS = (None, "control", "unchanged", "half_batch", "altered")

    def setup(self):
        from tpt_torch.config import CameraConfig
        from tpt_torch.env import constant_environment, pack_block_table
        from tpt_torch.optim import clipped_adam, make_inverse_step, make_renderer
        from tpt_torch.scene import Scene

        cfg, t = self.cell.config, self.cell.traffic
        dev = self.device
        self.width, self.height = t["width"], t["height"]
        self.view_names = list(t["views"])
        self.grad_frames, self.loss_every = int(t["grad_frames"]), int(t["loss_every"])
        self.n_checked = int(t["checked_steps"])
        r = cfg["render"]
        self.arrays = paths.scene_arrays(cfg["scene"])
        scene = Scene.from_numpy(self.arrays, dev)
        table = pack_block_table(constant_environment(tuple(cfg["environment"]["color"]),
                                                      device=dev), dtype=self.env_dtype())
        views = [CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfg["views"][name].items()})
                 for name in self.view_names]
        render = make_renderer(scene, views, width=self.width, height=self.height,
                               ray_depth=r["ray_depth"], spp=r["spp"], counts=tuple(r["counts"]),
                               env_table=table, jitter=r["jitter"],
                               russian_roulette=r["russian_roulette"])
        true_sm, true_cm = scene.sphere_material, scene.cuboid_material
        n_views = len(views)
        half = self.height // 2

        def target_frame(frame):
            with torch.no_grad():
                return torch.stack([render(true_sm, true_cm, frame, v) for v in range(n_views)])

        step_render = render
        if self.variant == "half_batch":   # the loss's mean over half the rows
            step_render = lambda *a: render(*a)[:half]   # noqa: E731
        (sm0, cm0), masks = traffic.perturbed_materials(self.arrays, cfg["perturbation"],
                                                        self.cell.seed)
        self.start, self.masks = (sm0, cm0), masks
        o = cfg["optimizer"]
        opt = clipped_adam(o["lr"], total_steps=o["total_steps"], clip_norm=o["clip_norm"])
        step = make_inverse_step(step_render, opt, n_views=n_views, grad_frames=self.grad_frames,
                                 param_mask=tuple(torch.tensor(m, device=dev) for m in masks))
        params = (torch.tensor(sm0, device=dev), torch.tensor(cm0, device=dev))
        state = {"params": params, "opt": opt.init(params)}
        variant = self.variant

        def one(i):
            """The window's call: step ``i``'s targets, then the step."""
            with span("portbench.targets"):
                tgt = torch.stack([target_frame(i * self.grad_frames + f)
                                   for f in range(self.grad_frames)])
            if variant == "half_batch":
                tgt = tgt[:, :, :half]
            with span("portbench.step"):
                p, s, loss = step(state["params"], state["opt"], i, tgt)
            if variant == "altered":   # one albedo moved where the step produced it
                p = (p[0].clone(), p[1])
                p[0][0, 0] += 0.1
            if variant != "unchanged":
                state["params"], state["opt"] = p, s
            if i % self.loss_every == 0:
                with span("portbench.read_loss"):
                    float(loss)
            return loss

        self.state, self.one = state, one
        # the first steps, through the window's own call: they warm every
        # shape, and the check follows them with the reference
        self.losses = []
        for i in range(self.n_checked):
            self.losses.append(float(one(i)))
            if i == 0:
                self.first_mu = tuple(m.clone() for m in state["opt"].mu)
        self.change = tuple(p - torch.tensor(a, device=dev)
                            for p, a in zip(state["params"], self.start))
        self.sync()

    def window(self, seconds: float) -> dict:
        i = self.n_checked
        t0 = time.perf_counter()
        while True:
            self.one(i)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        steps = i - self.n_checked
        renders = steps * self.grad_frames * len(self.view_names)
        pixels = self.width * self.height
        return {"end_to_end": {"step_ms": elapsed / steps * 1e3},
                "attempted": steps,
                "summary": {"steps": steps, "seconds": elapsed,
                            "step_ms": elapsed / steps * 1e3},
                "counts": {"steps": steps, "grad_renders": renders, "target_renders": renders,
                           "pixels": pixels, "spp": self.cell.config["render"]["spp"],
                           "counts": list(self.cell.config["render"]["counts"])}}

    def free(self):
        from ..reference.adam import B1

        self.first_grads = tuple(m / (1 - B1) for m in self.first_mu)
        del self.one, self.state, self.first_mu
        super().free()

    def check(self):
        """``loss_gap``: the largest relative gap of a checked step's loss;
        ``grad_gap``, ``change_gap``: :func:`worst_leaf_gap` of the first
        step's gradient and of the parameters' change over the checked
        steps."""
        cfg = self.cell.config
        views = [paths.camera_config(cfg["views"][n]) for n in self.view_names]
        ref = paths.inverse_steps(self.arrays, cfg, views, self.width, self.height, self.start,
                                  self.masks, self.n_checked, self.device, self.grad_frames)
        gaps = [abs(a - b) / abs(b) for a, b in zip(self.losses, ref["losses"])]
        loss_gap = max(gaps) if all(np.isfinite(gaps)) else float("inf")
        grad_gap = worst_leaf_gap(self.first_grads, ref["grads"])
        change_gap = worst_leaf_gap(self.change, ref["change"])
        checks = [Check("loss_gap", loss_gap, self.limit("loss_gap")),
                  Check("grad_gap", grad_gap, self.limit("grad_gap")),
                  Check("change_gap", change_gap, self.limit("change_gap"))]
        self.wrong = int(not all(c.ok for c in checks)) * self.n_checked
        self.ref_counts = {"segments_per_render": float(np.mean(ref["segments"]))}
        self.notes = {"losses": self.losses, "ref_losses": ref["losses"],
                      "grad_leaf_gaps": leaf_gaps(self.first_grads, ref["grads"]),
                      "change_leaf_gaps": leaf_gaps(self.change, ref["change"])}
        return checks
