"""Channel-vector type system.

Mirrors the reference's `thallo_floatN` channel types
(API/src/thallo.t:759-832 ImageType terratype generation):
an image is an N-D array over its index space with a small per-point channel
vector. On TPU we store images as dense jnp arrays of shape
(*dims, channels), channels last so XLA lays out the vector dimension on
lanes.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VecType:
    """A per-point channel vector type (e.g. float2 = 2 channels)."""

    channels: int
    base: str = "float"  # "float" resolves to the problem precision

    def __repr__(self) -> str:
        return f"{self.base}{self.channels}"


# Named channel types, mirroring lib.t's thallo_float/float2/... names.
float1 = VecType(1)
float2 = VecType(2)
float3 = VecType(3)
float4 = VecType(4)
float5 = VecType(5)
float6 = VecType(6)
float7 = VecType(7)
float8 = VecType(8)
float9 = VecType(9)
float12 = VecType(12)
float16 = VecType(16)
mat3f = VecType(9)  # 3x3 matrix stored row-major as 9 channels
mat4f = VecType(16)

_BY_NAME = {
    "float": float1,
    "double": VecType(1, "double"),
    **{f"float{i}": VecType(i) for i in range(1, 17)},
    **{f"double{i}": VecType(i, "double") for i in range(1, 17)},
    **{f"thallo_float{i}": VecType(i) for i in range(1, 17)},
    "thallo_float": float1,
    "thallo_mat3f": mat3f,
    "thallo_mat4f": mat4f,
    "mat3f": mat3f,
    "mat4f": mat4f,
    # integer-typed arrays in the reference (e.g. uint8 edge masks,
    # shape_from_shading.t:19-20) are stored as float images on TPU
    "uint8": float1,
    "int32": float1,
    "uchar": float1,
}


def as_vectype(t) -> VecType:
    if isinstance(t, VecType):
        return t
    if isinstance(t, str) and t in _BY_NAME:
        return _BY_NAME[t]
    if isinstance(t, int):
        return VecType(t)
    if t is float:
        return float1
    raise TypeError(f"not a channel type: {t!r}")
