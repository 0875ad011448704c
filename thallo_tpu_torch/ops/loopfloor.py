"""Launch-floor probe: ``o = x + 1`` over an [8, L] f32 array.

Replaces the Pallas kernel of ``scripts/tpu_loop_floor.py``
(``trivial_kernel``, launched on one [8, 1024] tile and as a 64-tile grid
over [8, 65536]).  It computes nothing of the solver: its time is the
floor under every small kernel launch of an LM step, which
``scripts/torch_loop_floor.py`` measures eagerly and inside a CUDA graph.
On the card (``csrc/loop_floor.cu``) one thread adds one to four
neighbouring values (a float4), whatever ``tiles`` is: ``tiles`` keeps
the TPU script's grid in the API and must divide L, but sets no block
count (the first body launched one block per tile, each walking its tile
in a loop: 2.5x ``torch.add``'s time on the H100).
"""
from __future__ import annotations

import torch

from . import _cuda

ROWS = 8


def add_one_reference(x):
    """Plain torch version."""
    return x + 1.0


def add_one(x, *, tiles=1):
    """x [8, L] f32 (contiguous, 16-byte aligned) -> x + 1; ``tiles`` (the
    TPU script's grid) must divide L.  CPU tensors take the plain version;
    CUDA tensors launch the float4 kernel."""
    if x.device.type == "cpu":
        return add_one_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one: unsupported device {x.device}")
    L = x.shape[-1]
    _cuda.require(x, "x", (ROWS, L), torch.float32, x.device)
    if tiles < 1 or L % tiles:
        raise ValueError(f"add_one: {tiles} tiles do not divide L={L}")
    if x.data_ptr() % 16:
        raise ValueError("add_one: x must be 16-byte aligned (the kernel reads float4)")
    o = torch.empty_like(x)
    code = _cuda.lib().thallo_loop_floor_add_one(x.data_ptr(), o.data_ptr(), L, _cuda.stream(x))
    _cuda.check(code, "add_one")
    add_one.launches += 1
    return o


add_one.launches = 0
