"""Process-global runtime: init/finalize and live-object registry.

Counterpart of ``hypredrive_tpu/core/runtime.py`` (ref:
src/internal/runtime.c:101 hypredrv_RuntimeInitialize, :232
DestroyAllLiveObjects): a once-only initialization plus a registry of
live driver handles, so that ``finalize`` can sweep leaked objects.

``initialize(distributed=True)`` calls
``torch.distributed.init_process_group`` (the multi-process analogue of
MPI_Init, as the JAX package calls ``jax.distributed.initialize``): one
rank per card, NCCL with a card and gloo without one; the group is then
the default of ``parallel.make_mesh``.  ``finalize`` runs the hooks that
higher layers registered with :func:`at_finalize`, then destroys the
group.
"""

from __future__ import annotations

import atexit
import os
import weakref
from typing import Callable, Optional

_state = {
    "initialized": False,
    "distributed": False,
    "live": None,  # weak set of live driver objects
    "hooks": [],   # teardown callables run by finalize, in order
}


def is_initialized() -> bool:
    return _state["initialized"]


def initialize(distributed: Optional[bool] = None, **dist_kwargs) -> None:
    """Initialize the runtime (ref: HYPREDRV_Initialize,
    src/HYPREDRV.c:915).

    ``distributed=True`` makes ``cuda:LOCAL_RANK`` the current device
    (with a card) and calls ``torch.distributed.init_process_group(
    **dist_kwargs)``; the backend defaults to NCCL with a card and gloo
    without one, the address, world size and rank to torchrun's
    environment.  By default it does so only when torchrun's
    ``MASTER_ADDR`` and ``WORLD_SIZE`` are set (as the JAX package reads
    ``JAX_COORDINATOR_ADDRESS``).  A second call is a no-op."""
    if _state["initialized"]:
        return
    _state["live"] = weakref.WeakSet()
    if distributed is None:
        distributed = bool(os.environ.get("MASTER_ADDR")
                           and os.environ.get("WORLD_SIZE"))
    if distributed:
        import torch
        import torch.distributed as dist

        card = torch.cuda.is_available()
        if card:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist_kwargs.setdefault("backend", "nccl" if card else "gloo")
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


def at_finalize(fn: Callable[[], None]) -> None:
    """Have ``finalize`` call ``fn`` (once, however often it is
    registered) after the live-object sweep and before the process group
    is destroyed: what holds the group's resources lets go there."""
    if fn not in _state["hooks"]:
        _state["hooks"].append(fn)


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
    for fn in _state["hooks"]:
        fn()
    if _state["distributed"]:
        import gc

        import torch
        import torch.distributed as dist

        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if dist.is_initialized():
            dist.destroy_process_group()
        _state["distributed"] = False
    _state["initialized"] = False


atexit.register(finalize)
