"""Seeds: one ``--seed`` drives every draw of a run, through named streams."""
from __future__ import annotations

import hashlib

import torch


def stream_seed(seed: int, *names) -> int:
    """A 63-bit seed for the named stream of ``seed`` (any whole number,
    negative or above 2**63 included): the same names give the same seed,
    different names independent ones."""
    text = ":".join(str(x) for x in (int(seed), *names))
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def generator(device, seed: int, *names) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for the named stream."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, *names))
    return g
