"""Store dtypes: normalized float32 rows -> the dtype the kernels score.

Counterpart of ``better_search_rag_rust_tpu/ops/quantize.py``. ``bfloat16``
and ``float32`` are a plain cast. ``int8`` is the symmetric lattice: rows
(and queries) are L2-normalized in f32, then mapped to ``round(x * 127)``
clipped to [-127, 127] (round half to even; -128 never occurs). A score is
the EXACT int32 dot of two lattice rows, value-converted to f32 and
multiplied once by :data:`INT8_INV_SCALE2`: the dot of two 768-d lattice
rows stays below 768 * 127^2 < 2^24, so the integer, its f32 image and the
one rounded multiply are the same bits in every kernel, plain version and
summation order (:func:`int8_sims_host` is the NumPy oracle).
"""

from __future__ import annotations

import numpy as np
import torch

#: Lattice scale: normalized coordinates in [-1, 1] map to [-127, 127].
INT8_SCALE = 127.0
#: f32(1 / 127^2): the one constant every int8 score is multiplied by —
#: bitwise the reference's (``0x38820610``; the CUDA source holds the same
#: bits).
INT8_INV_SCALE2 = float(np.float32(1.0) / np.float32(INT8_SCALE * INT8_SCALE))

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int8": torch.int8,
}


def store_dtype(name) -> torch.dtype:
    """The torch dtype of a store dtype name (``"bfloat16"``, ``"float32"``,
    ``"int8"``) or of a torch dtype already."""
    if isinstance(name, torch.dtype):
        if name in _DTYPES.values():
            return name
        raise ValueError(f"unsupported store dtype {name}")
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported store dtype {name!r}; expected one of "
            f"{sorted(_DTYPES)}"
        ) from None


def quantize_unit(x: torch.Tensor) -> torch.Tensor:
    """Unit-norm f32 rows -> the int8 lattice: ``clip(round(x * 127), -127,
    127)``; ``torch.round`` rounds half to even, like ``jnp.round``."""
    y = torch.round(x.to(torch.float32) * INT8_SCALE)
    return torch.clamp(y, -INT8_SCALE, INT8_SCALE).to(torch.int8)


def quantize_unit_host(x: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`quantize_unit` (``np.rint``: half to even)."""
    return np.clip(
        np.rint(np.asarray(x, dtype=np.float32) * np.float32(INT8_SCALE)),
        -INT8_SCALE, INT8_SCALE,
    ).astype(np.int8)


def cast_rows_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Normalized f32 rows -> store dtype: the lattice for int8, a round to
    nearest even otherwise."""
    dt = store_dtype(dtype)
    if dt == torch.int8:
        return quantize_unit(x)
    return x.to(dt)


def cast_rows_to_host(x: np.ndarray, dtype) -> torch.Tensor:
    """Host twin of :func:`cast_rows_to`: a CPU tensor in the store dtype
    (the int8 lattice through :func:`quantize_unit_host`)."""
    if store_dtype(dtype) == torch.int8:
        return torch.from_numpy(quantize_unit_host(x))
    return cast_rows_to(torch.from_numpy(np.asarray(x, dtype=np.float32)),
                        dtype)


def int8_sims_host(store_i8: np.ndarray, queries_i8: np.ndarray
                   ) -> np.ndarray:
    """``[Q, N]`` scaled scores of int8 operands in NumPy: exact int32 dot,
    f32 value-convert, one f32 multiply by :data:`INT8_INV_SCALE2`."""
    dots = queries_i8.astype(np.int32) @ store_i8.astype(np.int32).T
    return dots.astype(np.float32) * np.float32(INT8_INV_SCALE2)
