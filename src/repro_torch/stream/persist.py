"""Durable stream-engine checkpoints over ``repro_torch.checkpoint``
(counterpart of ``repro.stream.persist``).

A serving node must survive restart without replaying its whole edge
stream. :meth:`~repro_torch.stream.engine.StreamEngine.state_dict` exposes
the engine's complete durable state as a flat fixed-shape numpy tree
(forest columns, replacement-edge reservoir, gid counter, canonical
labels, certification state); this module routes that tree through the
atomic checkpoint store (``step_<n>/`` + ``DONE`` marker, async writes,
crash-safe renames) keyed by the engine's snapshot **version** — so
``latest_step`` is also "the newest published state on disk", and a
restore resumes serving at exactly the version the saved node last
published (bit-identical forest weight, MSF gid set and labels). The
layout and the array names are the reference's, so a checkpoint written
by either package restores in the other.

    from repro_torch.stream import persist
    persist.save_stream(ckpt_dir, engine)            # writer side
    ...
    version = persist.restore_stream(ckpt_dir, eng2) # warm restart

The restored engine must be constructed with the same
``(n, batch_capacity, exact_deletes, reservoir_*)`` configuration — the
state tree carries a config fingerprint and ``restore_state`` rejects
mismatches loudly rather than resuming a corrupt forest.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_saves,
)


def save_stream(ckpt_dir: str, engine, *, async_save: bool = False) -> int:
    """Checkpoint ``engine`` under ``ckpt_dir`` at its current snapshot
    version; returns the step (= version) written.

    ``async_save=True`` serializes on a background thread (join via
    :func:`wait_for_saves`) — the engine state is copied synchronously
    first, so the writer may keep mutating immediately.
    """
    step = engine.version
    save_checkpoint(ckpt_dir, step, engine.state_dict(), async_save=async_save)
    return step


def latest_stream_step(ckpt_dir: str) -> Optional[int]:
    """Newest restorable checkpoint step (snapshot version), or None."""
    return latest_step(ckpt_dir)


def restore_stream(ckpt_dir: str, engine, step: Optional[int] = None) -> int:
    """Load the checkpoint at ``step`` (default: newest) into ``engine``.

    Returns the restored snapshot version. Raises ``FileNotFoundError``
    when the directory holds no completed checkpoint, and ``ValueError``
    when the stored config fingerprint does not match the engine.
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no completed stream checkpoint under {ckpt_dir!r}"
            )
    # The engine's own state tree is the restore template: same config ⇒
    # identical structure and shapes, so config mismatches surface in
    # restore_state.
    engine.restore_state(restore_checkpoint(ckpt_dir, step, engine.state_dict()))
    return engine.version


__all__ = [
    "latest_stream_step",
    "restore_stream",
    "save_stream",
    "wait_for_saves",
]
