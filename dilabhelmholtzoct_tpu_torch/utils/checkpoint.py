"""Per-epoch checkpoints with retention, resume, and the reference's .pt.

Port of ``dilabhelmholtzoct_tpu/utils/checkpoint.py`` with ``torch.save`` in
place of Orbax: every epoch writes ``<dir>/step_N/state.pt`` holding the
trained entries of the state_dict (the decoder's, or every entry with
``trainable='all'``), the optimizer's state_dict and the epoch number; only
the newest ``keep`` step directories stay. Files are written to a temporary
name and renamed, so a crash never leaves a half-written checkpoint that
``latest_step`` would pick.
"""

from __future__ import annotations

import os
import shutil

import torch

STATE_FILE = "state.pt"


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(d.split("_", 1)[1]) for d in os.listdir(directory)
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
        and os.path.isfile(os.path.join(directory, d, STATE_FILE)))


def save_checkpoint(directory: str, step: int, state: dict, *,
                    keep: int | None = 3) -> str:
    """Save ``state`` (tensors moved to the host) under
    ``directory/step_N``; keep only the newest ``keep`` steps (None or 0
    keeps all)."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if keep:
        for old in _steps(directory)[:-keep]:
            shutil.rmtree(os.path.join(os.path.abspath(directory),
                                       f"step_{old}"), ignore_errors=True)
    return path


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int | None = None):
    """(state, step) of ``step`` (default: the latest), or (None, None)
    when the directory holds no checkpoint. Tensors load on the host."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    path = os.path.join(os.path.abspath(directory), f"step_{step}",
                        STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True), step


def export_reference_pt(sd: dict, path: str) -> str:
    """Write the merged HF-named state_dict as a torch ``.pt`` — the
    reference's checkpoint format, loadable by HF ``SamModel`` and by
    ``models/convert.py::load_state_dict``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().to("cpu", torch.float32).clone()
                for k, v in sd.items()}, path)
    return path
