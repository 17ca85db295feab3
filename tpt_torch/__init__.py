"""tpt_torch — the PyTorch / CUDA port of tpt, the differentiable
progressive path tracer.

The JAX package ``tpt`` is the reference this package is held to; this one
imports ``torch`` and numpy and nothing of JAX.  On an NVIDIA Hopper card
the render path runs through a hand-written CUDA trace kernel
(``tpt_torch/csrc/trace.cu``) and the differentiable path (``trace_diff``,
``diff``, ``optim``, ``inverse_demo``) adds a hand-written backward kernel
(``tpt_torch/csrc/trace_grad.cu``); on the CPU the same functions run their
plain PyTorch versions.  ``tpt_torch.parallel`` shards the renderer, the
progressive block and the train step over ranks of ``torch.distributed``;
``tpt_torch.interactive`` is the viewer, ``tpt_torch.native_bridge`` the
C++ host helpers (std140 pack, PCG chain, PNG writer).
"""

from .config import (AtmosphereConfig, CameraConfig, DistConfig, RenderConfig,
                     MAX_SPHERES, MAX_CUBOIDS)
from .materials import Material
from .scene import Scene, SceneBuilder, demo_scene, cornell_scene
from .progressive import AccumulatorState, init_accumulator, accumulate, reset
from .kernels.trace_grad import trace_diff
from .diff import DiffInputs, render_diff, render_scene_diff
from .optim import (clipped_adam, default_schedule, make_inverse_step, make_renderer,
                    load_optim_checkpoint, save_optim_checkpoint)

__all__ = [
    "AtmosphereConfig", "CameraConfig", "DistConfig", "RenderConfig",
    "MAX_SPHERES", "MAX_CUBOIDS", "Material", "Scene", "SceneBuilder",
    "demo_scene", "cornell_scene", "AccumulatorState", "init_accumulator",
    "accumulate", "reset", "trace_diff", "DiffInputs", "render_diff",
    "render_scene_diff", "clipped_adam", "default_schedule", "make_inverse_step",
    "make_renderer", "load_optim_checkpoint", "save_optim_checkpoint",
]
