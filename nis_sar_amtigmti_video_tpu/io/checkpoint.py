"""Orbax-backed checkpointing for large product stacks.

Complements the per-frame .npy spill (io/products.py): for long
multi-scenario campaigns a single versioned checkpoint tree (orbax) holds
SLC stacks, schedules and run metadata with atomic step directories.
Complex arrays are stored as stacked real/imag because some checkpoint
backends reject complex dtypes.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def _encode(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if k.endswith("__cplx"):
            # the packed-complex sentinel is reserved: a real array stored
            # under such a key would silently decode as a bogus complex array
            raise ValueError(
                f"checkpoint key {k!r} collides with the reserved "
                "'__cplx' suffix used to pack complex arrays")
        if isinstance(v, dict):
            out[k] = _encode(v)
        else:
            a = np.asarray(v)
            if np.iscomplexobj(a):
                out[k + "__cplx"] = np.stack([a.real, a.imag], axis=-1)
            else:
                out[k] = a
    return out


def _decode(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _decode(v)
        elif k.endswith("__cplx"):
            a = np.asarray(v)
            out[k[:-6]] = a[..., 0] + 1j * a[..., 1]
        else:
            out[k] = np.asarray(v)
    return out


class RunCheckpointer:
    """Versioned run state: save(step, tree) / latest() / restore(step)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        import orbax.checkpoint as ocp

        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._mgr = ocp.CheckpointManager(
            self._dir,
            options=ocp.CheckpointManagerOptions(max_to_keep=max_to_keep))

    def save(self, step: int, tree: Dict[str, Any]) -> None:
        import orbax.checkpoint as ocp

        self._mgr.save(step, args=ocp.args.StandardSave(_encode(tree)))
        self._mgr.wait_until_finished()

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        import orbax.checkpoint as ocp

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        return _decode(self._mgr.restore(step))

    def close(self):
        self._mgr.close()
