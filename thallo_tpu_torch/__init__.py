"""thallo_tpu_torch: the PyTorch/CUDA port of thallo_tpu.

The frontend (DSL, dims, expressions, inputs, spec) is a byte-identical
copy of the JAX package's jax-free modules, so both packages build the
same energy from the same text.  Planning lowers graph energies to
torch: channel-major residual evaluation, point Jacobians by
``torch.func.vjp``, a block-sparse materialized JᵀJ and an LM/GN solver
with block-Jacobi PCG.  Three hand-written CUDA kernels (``ops/``,
``csrc/``) carry the block-sparse setup and the per-iteration JᵀJ·p.

Plans take an explicit ``device`` ("cuda" by default); nothing here
falls back to the CPU when no GPU is present.
"""
from .dims import Dim, IndexDomain
from .expr import ExpVector
from .lib_env import load_energy, load_energy_file, make_env
from .plan import Plan, make_plan
from .spec import Energy, JTJpSchedule, NamedResidual, ProblemSpec
from .typesys import (  # noqa: F401
    VecType,
    float1,
    float2,
    float3,
    float4,
    float6,
    float9,
    mat3f,
)

__version__ = "0.1.0"

__all__ = [
    "Dim",
    "IndexDomain",
    "ExpVector",
    "ProblemSpec",
    "Energy",
    "NamedResidual",
    "JTJpSchedule",
    "Plan",
    "make_plan",
    "load_energy",
    "load_energy_file",
    "make_env",
]
