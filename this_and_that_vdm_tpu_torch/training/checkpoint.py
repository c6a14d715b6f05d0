"""Checkpoint / resume with rotation (counterpart of ``training/checkpoint.py``).

A checkpoint is ``<output_dir>/checkpoint-<step>/state.pt``, one
``torch.save`` of the trainable parameters, the optimizer state and the
step (the reference's ``accelerator.save_state``); ``resume latest`` picks
the newest step and ``checkpoints_total_limit`` rotates old ones away.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import List, Optional, Tuple

import torch

_FILE = "state.pt"


def _ckpt_dirs(output_dir: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint-(\d+)", name)
        if m:
            out.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(out)


def save_checkpoint(output_dir: str, step: int, state, total_limit: Optional[int] = 15) -> str:
    """Write ``checkpoint-<step>`` for a ``trainer.TrainState``, then keep
    only the newest ``total_limit`` checkpoints."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(dict(step=state.step, params={k: p.detach() for k, p in state.params.items()},
                    opt_state=state.opt_state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    if total_limit:
        existing = _ckpt_dirs(output_dir)
        while len(existing) > total_limit:
            shutil.rmtree(existing.pop(0)[1], ignore_errors=True)
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    dirs = _ckpt_dirs(output_dir)
    return dirs[-1][1] if dirs else None


def restore_checkpoint(path: str, state):
    """Load a checkpoint into ``state``: its parameters are overwritten in
    place, the optimizer state lands on their device.  The file is one this
    package wrote (it holds the optimizer's named tuples, so it is read with
    ``weights_only=False``)."""
    params = state.params
    device = next(iter(params.values())).device if params else "cpu"
    saved = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=False)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved["params"][k])
    return type(state)(saved["step"], params, saved["opt_state"])


def checkpoint_step(path: str) -> int:
    m = re.search(r"checkpoint-(\d+)", path)
    return int(m.group(1)) if m else 0
