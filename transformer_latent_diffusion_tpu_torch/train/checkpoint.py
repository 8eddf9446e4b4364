"""Train-state checkpoints on `torch.save` / `torch.load`.

The JAX package's `train/checkpoint.py::CheckpointManager` over orbax,
with the same layout and semantics: one directory per step under the run
directory (`<run_dir>/<step>/`), the newest three kept, `latest_step()`,
`restore()` of the newest by default, and `save` of an existing step
replacing it (the reference's save to a fixed filename). The state is a
dict of tensors, numbers and nested dicts / lists of them: here params,
ema_params (state_dicts), opt_state (the optimizer's and its learning-rate
schedule's state_dicts) and step. `average_checkpoints` is a later item.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

STATE_FILE = "state.pt"
MAX_TO_KEEP = 3


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Write `state` (tensors are copied to the CPU) as step `step`,
        replacing a checkpoint of the same step, then keep the newest
        MAX_TO_KEEP. The write goes to a temporary directory that is
        renamed into place, so a step directory is whole or absent."""
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".{step}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_to_cpu(state), os.path.join(tmp, STATE_FILE))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.all_steps()[:-MAX_TO_KEEP]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The state saved at `step` (default: the newest), tensors on the
        CPU; None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj
