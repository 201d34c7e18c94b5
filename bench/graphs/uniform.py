"""``uniform``: a directed graph on ``n`` nodes in which each of the n²
entries (the diagonal too) is present with probability ``density``, as
``chip_smoke.py`` draws its graph (a), drawn on the device from the run's
generator, ``ROWS`` rows at a time."""
from __future__ import annotations

import torch

ROWS = 2048


def draw(params: dict, *, generator: torch.Generator,
         device: torch.device) -> torch.Tensor:
    """The raw 0/1 adjacency, a bool [n, n] tensor on ``device``."""
    n, density = int(params["n"]), float(params["density"])
    out = torch.empty((n, n), dtype=torch.bool, device=device)
    for r0 in range(0, n, ROWS):
        rows = min(ROWS, n - r0)
        out[r0:r0 + rows] = torch.rand((rows, n), generator=generator,
                                       device=device) < density
    return out
