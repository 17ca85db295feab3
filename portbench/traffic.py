"""The one traffic generator: every input a run hands the program and the
reference, drawn from ``--seed`` and a workload file's ``traffic`` block.

A workload file holds only parameters (sizes, rates, strokes, how many
answers to check); this module turns them into draws, so a cell that a
later change adds is a data file.  Seeds are any whole number; numpy's
generator takes them whole.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent generator per use, so that adding a draw to one use
    changes no other."""
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), sum(map(ord, stream))])


def frame_offset(seed: int, traffic: dict) -> int:
    """The first frame index of the render, inside [0, frame_offset_max):
    each seed traces its own sample streams."""
    return int(rng(seed, "frame_offset").integers(0, int(traffic["frame_offset_max"])))


def checked(seed: int, spec: dict) -> List[int]:
    """The requests whose answers the check compares: ``first`` (the first
    request of the window) and ``sampled`` more drawn without replacement
    from [1, ``below``)."""
    out = [0] if spec.get("first", True) else []
    n = int(spec.get("sampled", 0))
    if n:
        draws = rng(seed, "checked").choice(np.arange(1, int(spec["below"])), n, replace=False)
        out += sorted(int(d) for d in draws)
    return out


def input_stream(seed: int, traffic: dict) -> List[Tuple[Tuple[str, ...], Tuple[float, float]]]:
    """One cycle of the viewer's inputs: (keys held, mouse delta) per draw.

    The cycle is the workload's ``strokes`` in an order drawn from the seed.
    A stroke holds its keys for ``press`` draws, releases them for
    ``coast`` draws (the velocity decays to rest), then holds the opposite
    keys as long and coasts again, so the camera comes back near where it
    started and every seed renders the same set of views in another order.
    The mouse moves on every draw by ``+-mouse`` pixels, the sign flipping
    each draw, so every draw changes the view and resets the accumulator."""
    opposite = {"w": "s", "s": "w", "a": "d", "d": "a"}
    press, coast = int(traffic["press"]), int(traffic["coast"])
    strokes = [tuple(s) for s in traffic["strokes"]]
    order = rng(seed, "strokes").permutation(len(strokes))
    keys: List[Tuple[str, ...]] = []
    for k in order:
        held = strokes[k]
        back = tuple(opposite.get(key, key) for key in held)
        keys += [held] * press + [()] * coast + [back] * press + [()] * coast
    mx, my = (float(v) for v in traffic["mouse"])
    return [(k, (mx if i % 2 == 0 else -mx, my if i % 2 == 0 else -my))
            for i, k in enumerate(keys)]


def perturbed_materials(arrays: Sequence, pert: dict, seed: int):
    """The inverse demo's starting point: the first ``n_obs`` sphere albedos
    drawn uniformly, the area light's emission jittered and floored, with
    the demo's draws from a generator seeded with ``seed``; and the masks of
    the recovered entries.  Returns ((sphere_material, cuboid_material),
    (mask_s, mask_c)) as f32 numpy arrays."""
    g = np.random.default_rng(int(seed) & (2 ** 63 - 1))
    sm0, cm0 = np.array(arrays[1], np.float32), np.array(arrays[4], np.float32)
    n, k = pert["n_obs"], pert["emission_cuboid"]
    sm0[:n, 0:3] = g.uniform(pert["albedo_low"], pert["albedo_high"], (n, 3))
    cm0[k, 4:7] = np.clip(cm0[k, 4:7] + g.uniform(-pert["emission_jitter"],
                                                  pert["emission_jitter"], 3),
                          pert["emission_floor"], None)
    mask_s, mask_c = np.zeros_like(sm0), np.zeros_like(cm0)
    mask_s[:n, 0:3] = 1.0
    mask_c[k, 4:7] = 1.0
    return (sm0, cm0), (mask_s, mask_c)

