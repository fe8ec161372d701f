"""Store dtypes: normalized float32 rows -> the dtype the kernels score.

Counterpart of ``better_search_rag_rust_tpu/ops/quantize.py`` for the float
store dtypes. ``bfloat16`` and ``float32`` are a plain cast. The int8 lattice
store (``round(x * 127)`` and the exact int32 dot) needs the int8 bodies of
the scoring kernels, which ROADMAP.md Queue 2 item "int8 bodies of K1 and K2"
ports; until then it raises.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def _int8_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "int8 stores need the int8 bodies of the K1/K2 scoring kernels, "
        "which are not ported yet (ROADMAP.md, Queue 2: int8 bodies of K1 "
        "and K2)"
    )


def store_dtype(name) -> torch.dtype:
    """The torch dtype of a store dtype name (``"bfloat16"``, ``"float32"``)
    or of a torch dtype already."""
    if isinstance(name, torch.dtype):
        if name in _DTYPES.values():
            return name
        if name == torch.int8:
            raise _int8_not_ported()
        raise ValueError(f"unsupported store dtype {name}")
    if name == "int8":
        raise _int8_not_ported()
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(
            f"unsupported store dtype {name!r}; expected one of "
            f"{sorted(_DTYPES)}"
        ) from None


def cast_rows_to(x: torch.Tensor, dtype) -> torch.Tensor:
    """Normalized f32 rows -> store dtype (round to nearest even)."""
    return x.to(store_dtype(dtype))
