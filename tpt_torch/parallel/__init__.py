"""Sharded rendering and training on ``torch.distributed`` (port of
tpt.parallel): the ('dp', 'sp') mesh, the sharded frame renderer, the
sharded progressive block, the sharded train step, and a launcher of local
ranks with :func:`dryrun`, the counterpart of ``dryrun_multichip``."""

from .dist import (Mesh, band_accumulator, gather_image, make_dist_progressive,
                   make_dist_renderer, make_mesh, make_train_step, trainable_filter_grads)
from .init import init_distributed, make_host_mesh
from .launch import launch

__all__ = ["Mesh", "make_mesh", "make_dist_renderer", "make_dist_progressive",
           "make_train_step", "trainable_filter_grads", "gather_image", "band_accumulator",
           "init_distributed", "make_host_mesh", "launch", "dryrun"]


def _dryrun_rank(n_ranks: int, device: str) -> str:
    """One rank of :func:`dryrun`: the sharded production paths on a small
    Cornell frame, then on the demo scene."""
    import math

    import torch

    from ..camera import camera_matrices
    from ..config import CameraConfig, RenderConfig
    from ..env import constant_environment
    from ..scene import cornell_scene, demo_scene

    device = torch.device(device)
    sp = 2 if n_ranks % 2 == 0 else 1
    dp = n_ranks // sp
    mesh = make_mesh(dp=dp, sp=sp)
    env = constant_environment((0.3, 0.45, 0.6), device=device)
    lines = []
    for name, cfg, cam, scene, step_kw in (
            ("cornell", RenderConfig(width=16, height=8, ray_depth=3, spp=1),
             CameraConfig(position=(0.0, 0.5, 2.0), look_x=-90.0, look_y=-5.0,
                          focal_length=8.0, aperture_diameter=0.1),
             cornell_scene().build(device), dict(counts=(4, 0))),
            # one 24-row band a rank, 128 columns: the shape of a 1080p band
            # (1080 = 45 x 24) at a narrow width
            ("demo", RenderConfig(width=128, height=dp * 24, ray_depth=3, spp=1),
             CameraConfig(), demo_scene().build(device),
             dict(counts=(48, 7), russian_roulette=False, psum_bands=2))):
        ip, iv, _ = camera_matrices(cam, cfg.width, cfg.height)
        args = (env, ip, iv, cam.focal_length, cam.aperture_diameter, 0)
        band, rays = make_dist_renderer(mesh, cfg)(scene, *args)
        target = gather_image(mesh, band, cfg.height)
        if int(rays) <= 0 or not bool(torch.isfinite(target).all()):
            raise AssertionError(f"dryrun {name}: rays {int(rays)}, finite image "
                                 f"{bool(torch.isfinite(target).all())}")
        _, loss = make_train_step(mesh, cfg, **step_kw)(scene, *args, target, 0.1)
        if not math.isfinite(float(loss)):
            raise AssertionError(f"dryrun {name}: non-finite loss {float(loss)}")
        lines.append(f"dryrun {name} ok: {cfg.width}x{cfg.height}, mesh dp={dp} sp={sp}, "
                     f"loss={float(loss):.6f}, rays={int(rays)}")
    return "\n".join(lines)


def dryrun(n_ranks: int, device="cuda", backend: str | None = None) -> None:
    """Start ``n_ranks`` local ranks on a (dp, sp) mesh (sp = 2 for an even
    count) and run the sharded production paths: the Cornell toy render and
    one SGD step at 16x8, then the demo scene at one 24-row band a rank
    (128 wide), its render and one step at counts (48, 7) with roulette off
    and two gradient bands.  Raises if a render traced no ray or an image or
    loss is not finite; prints the rank-0 summary."""
    print(launch(_dryrun_rank, n_ranks, n_ranks, str(device), backend=backend,
                 device=device)[0],
          flush=True)
