"""Checkpoint / resume with rotation (counterpart of ``training/checkpoint.py``).

A checkpoint is ``<output_dir>/checkpoint-<step>/state.pt``, one
``torch.save`` of the trainable parameters, the optimizer state and the
step (the reference's ``accelerator.save_state``); ``resume latest`` picks
the newest step and ``checkpoints_total_limit`` rotates old ones away.

On a mesh of ranks (a state with ``rows``) a save is collective: it
gathers the parameters and the optimizer state into their one-rank form,
rank 0 writes, and every rank waits for the file; a restore reads the file
on every rank and keeps the rank's rows of both.  The file is the one-rank
file, so a run saved at one world size resumes at any other.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .. import parallel

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
    only the newest ``total_limit`` checkpoints (collective on a mesh)."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    if state.rows is not None:
        params = state.rows.host_params()
    else:
        params = {k: p.detach() for k, p in state.params.items()}
    opt_state = parallel.host_replicated(state.opt_state, state.rows)
    if parallel.is_main_process():
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _FILE + ".tmp")
        torch.save(dict(step=state.step, params=params, opt_state=opt_state), tmp)
        os.replace(tmp, os.path.join(path, _FILE))
        if total_limit:
            existing = _ckpt_dirs(output_dir)
            while len(existing) > total_limit:
                shutil.rmtree(existing.pop(0)[1], ignore_errors=True)
    if state.rows is not None:
        dist.barrier()
    return path


def latest_checkpoint(output_dir: str) -> Optional[str]:
    dirs = _ckpt_dirs(output_dir)
    return dirs[-1][1] if dirs else None


def restore_checkpoint(path: str, state):
    """Load a checkpoint into ``state``: its parameters are overwritten in
    place (this rank's rows of them, on a mesh), the optimizer state lands
    on their device (this rank's rows of it, on a mesh).  The file is one
    this package wrote (it holds the optimizer's named tuples, so it is
    read with ``weights_only=False``)."""
    params = state.params
    device = next(iter(params.values())).device if params else "cpu"
    saved = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=False)
    opt_state = saved["opt_state"]
    if state.rows is not None:
        state.rows.load_(saved["params"])
        opt_state = parallel.shard_state(opt_state, state.rows)
    else:
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved["params"][k])
    return dataclasses.replace(state, step=saved["step"], opt_state=opt_state)


def checkpoint_step(path: str) -> int:
    m = re.search(r"checkpoint-(\d+)", path)
    return int(m.group(1)) if m else 0
