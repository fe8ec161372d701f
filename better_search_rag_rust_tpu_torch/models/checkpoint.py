"""Model parameter checkpoints: a directory holding one ``torch.save`` file.

Counterpart of ``better_search_rag_rust_tpu/models/checkpoint.py`` (Orbax):
:func:`save_params` writes a state dict to a directory, replacing what was
there; :func:`load_params` reads it back with ``weights_only=True`` (plain
tensors only, no pickled code), optionally onto the devices and dtypes of a
``like`` state dict. A restored checkpoint resumes training through
``ContrastiveTrainer(params=...)``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Optional

import torch

PARAMS_FILE = "params.pt"


def save_params(path: str | os.PathLike,
                params: Dict[str, torch.Tensor]) -> None:
    """Write ``params`` (tensors on any device) to the directory ``path``;
    the file is written whole, then moved into place."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    host = {k: v.detach().cpu().contiguous() for k, v in params.items()}
    tmp = path / f"{PARAMS_FILE}.{os.getpid()}.tmp"
    torch.save(host, tmp)
    os.replace(tmp, path / PARAMS_FILE)


def load_params(path: str | os.PathLike,
                like: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """Read a checkpoint directory. Without ``like`` the tensors arrive on
    the CPU; with it, each takes the device and dtype of the tensor of the
    same name, and the names and shapes must match."""
    params = torch.load(Path(path) / PARAMS_FILE, map_location="cpu",
                        weights_only=True)
    if like is None:
        return params
    if params.keys() != like.keys():
        missing = sorted(like.keys() - params.keys())
        extra = sorted(params.keys() - like.keys())
        raise KeyError(f"checkpoint names differ: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for name, ref in like.items():
        if params[name].shape != ref.shape:
            raise ValueError(f"{name}: checkpoint shape "
                             f"{tuple(params[name].shape)}, expected "
                             f"{tuple(ref.shape)}")
        out[name] = params[name].to(device=ref.device, dtype=ref.dtype)
    return out
