"""Process-global runtime: init/finalize and live-object registry.

Counterpart of ``hypredrive_tpu/core/runtime.py`` (ref:
src/internal/runtime.c:101 hypredrv_RuntimeInitialize, :232
DestroyAllLiveObjects): a once-only initialization plus a registry of
live driver handles, so that ``finalize`` can sweep leaked objects.

``initialize(distributed=True)`` calls
``torch.distributed.init_process_group`` (the multi-process analogue of
MPI_Init, as the JAX package calls ``jax.distributed.initialize``);
``finalize`` destroys the group.
"""

from __future__ import annotations

import atexit
import os
import weakref
from typing import Optional

_state = {
    "initialized": False,
    "distributed": False,
    "live": None,  # weak set of live driver objects
}


def is_initialized() -> bool:
    return _state["initialized"]


def initialize(distributed: Optional[bool] = None, **dist_kwargs) -> None:
    """Initialize the runtime (ref: HYPREDRV_Initialize,
    src/HYPREDRV.c:915).

    ``distributed=True`` calls ``torch.distributed.init_process_group(
    **dist_kwargs)``; the backend, address, world size and rank are the
    caller's.  By default it does so only when torchrun's ``MASTER_ADDR``
    and ``WORLD_SIZE`` are set (as the JAX package reads
    ``JAX_COORDINATOR_ADDRESS``).  A second call is a no-op."""
    if _state["initialized"]:
        return
    _state["live"] = weakref.WeakSet()
    if distributed is None:
        distributed = bool(os.environ.get("MASTER_ADDR")
                           and os.environ.get("WORLD_SIZE"))
    if distributed:
        import torch.distributed as dist

        dist.init_process_group(**dist_kwargs)
        _state["distributed"] = True
    _state["initialized"] = True


def register_live(obj) -> None:
    if _state["live"] is None:
        _state["live"] = weakref.WeakSet()
    _state["live"].add(obj)


def unregister_live(obj) -> None:
    live = _state["live"]
    if live is not None:
        live.discard(obj)


def finalize() -> None:
    """Destroy leaked live objects and shut down
    (ref: hypredrv_RuntimeDestroyAllLiveObjects,
    src/internal/runtime.c:232)."""
    live = _state["live"]
    if live is not None:
        for obj in list(live):
            try:
                obj.destroy()
            except Exception:  # one failed destroy must not stop the sweep
                pass
        live.clear()
    if _state["distributed"]:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        _state["distributed"] = False
    _state["initialized"] = False


atexit.register(finalize)
