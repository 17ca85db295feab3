"""Offline render: ``cli render``'s kernel path, blocks of frames folded into
one accumulator, one user waiting for the image (a closed loop).

The window drives tpt_torch.kernels.render.progressive_frames as
``tpt_torch.cli._render_kernel`` wires it: the scene's counts from
``kernel_counts`` (so a CUDA launch takes the build for them), the packed
environment table, every block the same size, ``int(rays)`` read after
each.  The first frame index is an offset drawn from the seed.  The check
recomputes the checked blocks with the plain reference: the window's first
block from a fresh accumulator (the start, by itself) and a block drawn
from the seed, folded into the accumulator the program held before it.
"""

from __future__ import annotations

import time

import torch

from .. import traffic
from ..harness import Check
from ..reference import env as ref_env
from ..reference import paths
from ..tracing import span
from . import Base


class Driver(Base):
    VARIANTS = (None, "control", "unchanged", "half_batch", "altered")

    def setup(self):
        from tpt_torch.camera import camera_matrices
        from tpt_torch.config import AtmosphereConfig, CameraConfig
        from tpt_torch.env import pack_block_table
        from tpt_torch.kernels.render import kernel_counts
        from tpt_torch.progressive import init_accumulator
        from tpt_torch.scene import Scene
        from tpt_torch.sky import compute_atmosphere

        cfg, t = self.cell.config, self.cell.traffic
        self.width, self.height, self.frames = t["width"], t["height"], t["frames_per_block"]
        self.render = cfg["render"]
        self.arrays = paths.scene_arrays(cfg["scene"])
        self.scene = Scene.from_numpy(self.arrays, self.device)
        e = cfg["environment"]
        faces = compute_atmosphere(AtmosphereConfig(
            size=e["size"], i_steps=e["i_steps"], j_steps=e["j_steps"], time=e["time"],
            light_intensity=e["light_intensity"]), self.device)
        self.table = pack_block_table(faces, dtype=self.env_dtype())
        self.cam = CameraConfig(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg["camera"].items()})
        self.inv_p, self.inv_v, _ = camera_matrices(self.cam, self.width, self.height)
        self.counts = kernel_counts(self.scene, self.device)
        self.offset = traffic.frame_offset(self.cell.seed, t)
        self.checked = traffic.checked(self.cell.seed, t["checked"])
        self._init = lambda: init_accumulator(self.height, self.width, self.device)
        # warm-up: one block of the window's shape on a scratch accumulator
        acc = self._init()
        self._block(acc, self.offset)
        int(acc.image.clone().sum())
        self.sync()

    def _block(self, acc, frame0):
        from tpt_torch.kernels.render import progressive_frames

        n_valid = self.frames // 2 if self.variant == "half_batch" else self.frames
        if self.variant == "unchanged":
            scratch = self._init()
            scratch.frame = acc.frame
            _, rays = progressive_frames(
                scratch, self.scene, self.table, self.inv_p, self.inv_v, frame0,
                self.cam.focal_length, self.cam.aperture_diameter, width=self.width,
                height=self.height, ray_depth=self.render["ray_depth"], spp=self.render["spp"],
                counts=self.counts, n_frames=self.frames, jitter=self.render["jitter"])
            acc.frame += self.frames
            return acc, rays
        acc, rays = progressive_frames(
            acc, self.scene, self.table, self.inv_p, self.inv_v, frame0,
            self.cam.focal_length, self.cam.aperture_diameter, width=self.width,
            height=self.height, ray_depth=self.render["ray_depth"], spp=self.render["spp"],
            counts=self.counts, n_frames=self.frames, n_valid=n_valid,
            jitter=self.render["jitter"])
        if self.variant == "altered":
            acc.image[0, 0, 0] += 0.25
        return acc, rays

    def window(self, seconds: float) -> dict:
        acc = self._init()
        snaps = {}
        blocks = rays_total = 0
        t0 = time.perf_counter()
        while True:
            keep = blocks in self.checked
            if keep:
                snaps[blocks] = dict(before=acc.image.clone(), n0=acc.frame,
                                     frame0=self.offset + acc.frame)
            with span("portbench.block"):
                acc, rays = self._block(acc, self.offset + acc.frame)
            with span("portbench.read_rays"):
                r = int(rays)
            if keep:
                snaps[blocks].update(after=acc.image.clone(), rays=r)
            rays_total += r
            blocks += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        elapsed = time.perf_counter() - t0
        self.snaps = snaps
        pixels = self.width * self.height
        return {"end_to_end": {"mrays_per_s": rays_total / elapsed / 1e6},
                "attempted": blocks,
                "summary": {"blocks": blocks, "frames": blocks * self.frames,
                            "segments": rays_total, "seconds": elapsed,
                            "frame_offset": self.offset, "checked_blocks": sorted(snaps)},
                "counts": {"segments": rays_total, "launches": blocks,
                           "samples": blocks * self.frames * pixels * self.render["spp"],
                           "pixels": pixels, "frames": blocks * self.frames,
                           "env_bytes": self.table.numel() * self.table.element_size(),
                           "counts": list(self.counts or self.scene.counts)}}

    def free(self):
        del self.scene, self.table
        super().free()

    def check(self):
        """``values_off``: accumulator values of the checked blocks that differ
        from the reference's (a NaN matches a NaN: the reference's transport
        gives the same NaN pixels); ``rays_off``: the
        traced segments by which they differ; ``blocks_missing``: checked
        blocks the window did not reach."""
        dev = self.device
        scene = paths.make_scene(self.arrays, dev)
        table = ref_env.pack_block_table(paths.environment_faces(self.cell.config["environment"],
                                                                 dev))
        cam = paths.camera_config(self.cell.config["camera"])
        values_off = rays_off = escapes = frames = nan_values = 0
        for k, snap in sorted(self.snaps.items()):
            rad, rays, esc = paths.block(scene, table, cam, self.width, self.height,
                                         snap["frame0"], self.frames, self.render)
            before = torch.zeros_like(snap["before"]) if k == 0 else snap["before"]
            want = paths.fold_block(before, snap["n0"], rad, self.frames, self.render["spp"])
            got = snap["after"]
            same = (want == got) | (torch.isnan(want) & torch.isnan(got))
            off = int((~same).sum())
            nan_values += int(torch.isnan(got).sum())
            values_off += off
            rays_off += abs(rays - snap["rays"])
            self.wrong += int(off > 0 or rays != snap["rays"])
            escapes += esc
            frames += self.frames
        missing = len([k for k in self.checked if k not in self.snaps])
        self.ref_counts = {"escapes_per_frame": escapes / max(frames, 1)}
        self.notes = {"nan_values": nan_values, "escapes_per_frame": escapes / max(frames, 1)}
        self.snaps = {}
        return [Check("values_off", values_off, self.limit("values_off")),
                Check("rays_off", rays_off, self.limit("rays_off")),
                Check("blocks_missing", missing, 0)]
