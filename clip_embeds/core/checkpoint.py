"""Checkpoint save/load with latest-election and atomic-write semantics.

Reference behaviours being reproduced (open_clip/src/open_clip_train/main.py):
per-epoch checkpoint files with embedded step/epoch metadata (:490-518),
``--resume latest`` scanning the checkpoint dir for the newest epoch
(:55-68, 131-163), and atomic replace for the most-recent pointer (:513-518).
Orbax handles the atomicity and async I/O.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np

try:
    import orbax.checkpoint as ocp

    _HAS_ORBAX = True
except Exception:  # pragma: no cover
    _HAS_ORBAX = False

CKPT_PREFIX = "epoch_"

# one long-lived async checkpointer: save() returns as soon as the host
# copy is snapshotted, the serialization overlaps the next epoch's compute
# (orbax commits atomically via the .orbax-checkpoint-tmp rename)
_ASYNC: Optional["ocp.AsyncCheckpointer"] = None


def _async_ckptr():
    global _ASYNC
    if _ASYNC is None:
        _ASYNC = ocp.AsyncCheckpointer(ocp.StandardCheckpointHandler())
    return _ASYNC


def save(
    directory: str,
    state: Any,
    step: int,
    keep: Optional[int] = None,
    blocking: bool = True,
) -> str:
    """Save a pytree under directory/epoch_<step>; returns the path.

    blocking=False starts an async write and returns immediately; call
    wait_for_saves() (or the next blocking save) before reading the path or
    exiting the process."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{CKPT_PREFIX}{step}")
    if _HAS_ORBAX:
        if blocking:
            # honor the documented contract: a blocking save also flushes
            # any earlier async saves before returning
            wait_for_saves()
            ckptr = ocp.StandardCheckpointer()
            ckptr.save(os.path.abspath(path), state, force=True)
            ckptr.wait_until_finished()
        else:
            _async_ckptr().save(
                os.path.abspath(path), args=ocp.args.StandardSave(state),
                force=True,
            )
    else:  # tiny fallback for environments without orbax
        from .factory import flatten_params

        np.savez(path + ".npz", **flatten_params(state))
    if keep:
        _prune(directory, keep)
    return path


def wait_for_saves() -> None:
    """Block until all async save() calls have committed."""
    if _ASYNC is not None:
        _ASYNC.wait_until_finished()


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest checkpoint path by epoch number (reference main.py:55-68)."""
    if not os.path.isdir(directory):
        return None
    best_step, best_path = -1, None
    for name in os.listdir(directory):
        m = re.match(rf"{CKPT_PREFIX}(\d+)(?:\.npz)?$", name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best_path = os.path.join(directory, name)
    return best_path


def load(path: str, target: Optional[Any] = None) -> Any:
    """Load a checkpoint saved by save(); target gives the pytree structure."""
    if path.endswith(".npz"):
        from .factory import unflatten_params

        return unflatten_params(dict(np.load(path)))
    assert _HAS_ORBAX, "orbax required for directory checkpoints"
    ckptr = ocp.StandardCheckpointer()
    if target is not None:
        return ckptr.restore(os.path.abspath(path), target=target)
    return ckptr.restore(os.path.abspath(path))


def resume(directory: str, target: Optional[Any] = None) -> Optional[Any]:
    """'latest' resume semantics: load the newest checkpoint if any."""
    path = latest_checkpoint(directory)
    if path is None:
        return None
    return load(path, target)


def step_of(path: str) -> int:
    m = re.search(rf"{CKPT_PREFIX}(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def _prune(directory: str, keep: int) -> None:
    entries = []
    for name in os.listdir(directory):
        m = re.match(rf"{CKPT_PREFIX}(\d+)(?:\.npz)?$", name)
        if m:
            entries.append((int(m.group(1)), name))
    entries.sort()
    for _, name in entries[:-keep]:
        full = os.path.join(directory, name)
        if os.path.isdir(full):
            import shutil

            shutil.rmtree(full)
        else:
            os.remove(full)
