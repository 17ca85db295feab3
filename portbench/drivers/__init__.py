"""One driver per kind of traffic.  A driver's ``Driver(cell, variant)``
has ``setup()`` (build, warm every shape of the cell, and whatever the
window starts from), ``window(seconds)`` (the measured loop, returning its
end-to-end values, its request count and the counts the readers take),
``free()`` (drop the program's state before the reference runs) and
``check()`` (the reference on the answers the window kept, as
:class:`portbench.harness.Check` values).

``variant`` is None in a benchmark run.  The output checks' own runs set it
to ``"control"`` (the program's opt-in bf16 environment table in place of
the f32 one, the lower precision the check has to catch) or to a planted
fault (``"unchanged"``, ``"half_batch"``, ``"altered"``) that a driver
supports; see each driver's ``VARIANTS``.
"""

from __future__ import annotations

from typing import Dict, Optional


class Base:
    VARIANTS = (None, "control")

    def __init__(self, cell, variant: Optional[str] = None):
        import torch

        if variant not in self.VARIANTS:
            raise ValueError(f"{type(self).__module__}: variant {variant!r} not in "
                             f"{self.VARIANTS}")
        self.cell, self.variant = cell, variant
        self.device = torch.device(cell.device)
        self.wrong = 0                 # checked answers found wrong
        self.ref_counts: Dict[str, float] = {}   # what the reference counted, for the readers
        self.notes: Dict[str, object] = {}   # what the check saw, printed beside the result

    def limit(self, name: str) -> float:
        return float(self.cell.workload["limits"][name])

    def sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def env_dtype(self):
        import torch

        return torch.bfloat16 if self.variant == "control" else torch.float32

    def free(self):
        """Drop the program's state (the driver keeps what check() reads)."""
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

