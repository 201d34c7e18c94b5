"""The card, or (in the tests, which skip the look for a card) the CPU:
synchronisation, the memory peak and seeded generators."""
from __future__ import annotations

import numpy as np
import torch

# one independent generator per input, so that adding an input later
# leaves the others' values as they were
STREAMS = ("graph", "weights", "features", "labels", "sample")


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream``, from any whole number ``seed``."""
    state = np.random.SeedSequence(
        [seed % 2**64, STREAMS.index(stream)]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def generator(seed: int, stream: str, device: torch.device):
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


class Device:
    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda \
            else 0

    def free(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()
