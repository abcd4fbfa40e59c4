"""Checkpoints of the train state (the port's counterpart of
`semantichuman_tpu/utils/checkpoint.py`, with `torch.save` in the place of
orbax).

A checkpoint is the directory <ckpt_dir>/<step> holding `state.pt`: a tree
of dicts and lists with tensor leaves and ints ({"params", "opt_state",
"epoch", "step"} for the trainer), loaded with `weights_only=True`.
"""

from __future__ import annotations

import os
import shutil

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, step: int, state: dict,
                    max_to_keep: int | None = None) -> str:
    """Save `state` under ckpt_dir/<step>; optionally prune all but the
    newest `max_to_keep` checkpoints."""
    base = os.path.abspath(ckpt_dir)
    path = os.path.join(base, str(step))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if max_to_keep is not None and max_to_keep > 0:
        # prune by save recency (mtime), not step number: a finetune resume
        # restarts epoch numbering, and pruning by step would delete the
        # checkpoint just written in favour of stale high-numbered ones
        entries = [(os.path.getmtime(os.path.join(base, d)), d)
                   for d in os.listdir(base) if d.isdigit()]
        for _, old in sorted(entries)[:-max_to_keep]:
            if old != str(step):
                shutil.rmtree(os.path.join(base, old), ignore_errors=True)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    base = os.path.abspath(ckpt_dir)
    if not os.path.isdir(base):
        return None
    steps = [int(d) for d in os.listdir(base) if d.isdigit()]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None,
                       device="cpu") -> tuple[dict, int]:
    """(state, step) with tensors on `device`; step=None restores the
    latest."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoints under {os.path.abspath(ckpt_dir)}")
    path = os.path.join(os.path.abspath(ckpt_dir), str(step), STATE_FILE)
    state = torch.load(path, map_location=device, weights_only=True)
    return state, step
