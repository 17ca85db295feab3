"""The viewer while the camera moves: one user at the reference window's
size, every draw a camera tick and a fresh image (a closed loop).

The window drives ``tpt_torch.interactive.ViewerSession`` as its display
loop does: ``tick`` with the draw's keys and mouse delta at the workload's
``dt``, then ``render_one`` (the workload's frames per draw), which returns
the uint8 display image on the host.  The inputs are
:func:`portbench.traffic.input_stream`'s cycle, so the view changes every
draw and each draw restarts the accumulator.  A draw is timed on the host
clock from before ``tick`` to the image in hand.

The check replays the controller from the starting pose over the same
inputs, and renders the checked draws with the plain reference: the camera
state after the tick, the frame, the environment fetch, the mix into the
accumulator the program held before the draw, the display image.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import traffic
from ..harness import Check
from ..reference import controller as ref_controller
from ..reference import env as ref_env
from ..reference import paths
from ..tracing import span
from . import Base


class Driver(Base):
    VARIANTS = (None, "control", "unchanged", "altered")

    def setup(self):
        import tpt_torch.kernels.render as render_mod
        from tpt_torch.camera_controller import CameraState
        from tpt_torch.config import CameraConfig
        from tpt_torch.env import pack_block_table
        from tpt_torch.interactive import ViewerSession
        from tpt_torch.scene import Scene

        cfg, t = self.cell.config, self.cell.traffic
        self.size, self.per_draw, self.dt = t["size"], t["frames_per_draw"], float(t["dt"])
        atmo = t["atmosphere"]
        ses = ViewerSession(cfg.get("scene_name", "demo"), size=self.size,
                            env_name="atmosphere", atmosphere_size=atmo["size"],
                            device=self.device)
        self.arrays = paths.scene_arrays(cfg["scene"])
        ses.scene = Scene.from_numpy(self.arrays, self.device)
        ses.base_cam = CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                                       for k, v in cfg["camera"].items()})
        if self.variant == "control":
            ses._env_table = pack_block_table(ses.env_faces, dtype=torch.bfloat16)
            ses._env_table_src = ses.env_faces
        self.ses = ses
        self.start_cam = lambda: CameraState.from_config(ses.base_cam)
        self.stream = traffic.input_stream(self.cell.seed, t)
        self.checked = traffic.checked(self.cell.seed, t["checked"])
        # the segments each draw traced, read from the block function's
        # return value (ViewerSession keeps no count of its own)
        self.rays = []
        orig = render_mod.progressive_frames

        def counting(*args, **kwargs):
            acc, rays = orig(*args, **kwargs)
            self.rays.append(rays)
            return acc, rays

        render_mod.progressive_frames = counting
        self._restore = lambda: setattr(render_mod, "progressive_frames", orig)
        # warm-up: a few draws of the window's shape, then back to the start
        for i in range(4):
            self._draw(i)
        ses.acc.image.clone()
        self.sync()
        ses.cam = self.start_cam()
        ses.invalidate()
        self.rays.clear()

    def _draw(self, i):
        keys, mouse = self.stream[i % len(self.stream)]
        ses = self.ses
        with span("portbench.tick"):
            ses.tick(self.dt, keys, mouse)
        if self.variant == "unchanged" and i > 0:
            return self._last
        with span("portbench.render_one"):
            img = ses.render_one(self.per_draw)
        if self.variant == "altered":
            img[0, 0, 0] ^= 1
        self._last = img
        return img

    def window(self, seconds: float) -> dict:
        ses = self.ses
        snaps = {}
        times = []
        t0 = time.perf_counter()
        i = 0
        while True:
            keep = i in self.checked
            before = ses.acc.image.clone() if keep else None
            d0 = time.perf_counter()
            img = self._draw(i)
            d1 = time.perf_counter()
            times.append((d1 - d0) * 1e3)
            if keep:
                c = ses.cam
                snaps[i] = dict(before=before, image=img, position=np.array(c.position),
                                look=(c.look_x, c.look_y))
            i += 1
            if d1 - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        self._restore()
        segments = int(torch.stack(self.rays).sum()) if self.rays else 0
        self.snaps = snaps
        p95 = float(np.percentile(times, 95, method="linear"))
        pixels = self.size * self.size
        return {"end_to_end": {"draw_ms_p95": p95},
                "attempted": i,
                "summary": {"draws": i, "seconds": elapsed, "draw_ms_p50": float(np.median(times)),
                            "draw_ms_p95": p95, "draw_ms_max": max(times),
                            "segments": segments, "checked_draws": sorted(snaps)},
                "counts": {"segments": segments, "launches": len(self.rays), "draws": i,
                           "samples": len(self.rays) * self.per_draw * pixels,
                           "pixels": pixels, "slots": self.per_draw,
                           "counts": list(ses.scene.counts)}}

    def free(self):
        del self.ses
        super().free()

    def check(self):
        """``camera_off``: the largest gap between the program's camera state
        after a checked draw's tick and the replayed controller's;
        ``u8_off``: display values of the checked draws that differ from the
        reference's; ``draws_missing``: checked draws the window did not
        reach."""
        t = self.cell.traffic
        dev = self.device
        cfg = self.cell.config
        scene = paths.make_scene(self.arrays, dev)
        atmo = dict(t["atmosphere"], kind="atmosphere")
        table = ref_env.pack_block_table(paths.environment_faces(atmo, dev))
        base = paths.camera_config(cfg["camera"])
        state = ref_controller.CameraState.from_config(base)
        render = dict(cfg["render"])
        camera_off, u8_off, since_reset = 0.0, 0, 0
        last = max(self.snaps) if self.snaps else -1
        for i in range(last + 1):
            keys, mouse = self.stream[i % len(self.stream)]
            state, changed = ref_controller.process_inputs(state, self.dt, keys, mouse)
            since_reset = 0 if changed else since_reset
            if i in self.snaps:
                snap = self.snaps[i]
                camera_off = max(camera_off,
                                 float(np.abs(snap["position"] - state.position).max()),
                                 abs(snap["look"][0] - state.look_x),
                                 abs(snap["look"][1] - state.look_y))
                cam = state.to_config(base)
                if self.per_draw == 1:
                    mean, _ = paths.frame_mean(scene, table, cam, self.size, self.size,
                                               since_reset, render)
                    acc = paths.mix_frame(snap["before"], since_reset, mean)
                else:
                    rad, _, _ = paths.block(scene, table, cam, self.size, self.size,
                                            since_reset, self.per_draw, render)
                    acc = paths.fold_block(snap["before"], since_reset, rad, self.per_draw,
                                           render["spp"])
                off = int((paths.display_u8(acc) != snap["image"]).sum())
                u8_off += off
                self.wrong += int(off > 0)
            since_reset += self.per_draw
        missing = len([k for k in self.checked if k not in self.snaps])
        self.snaps = {}
        return [Check("camera_off", camera_off, self.limit("camera_off")),
                Check("u8_off", u8_off, self.limit("u8_off")),
                Check("draws_missing", missing, 0)]

