"""CheckpointManager — crash-safe training checkpoint lifecycle
(counterpart of ``paddle_tpu/distributed/ckpt_manager.py``).

Owns the step-numbered checkpoint directory a training run writes into::

    <root>/step_00000100/     committed checkpoint (atomic, see
    <root>/step_00000200/     distributed/checkpoint.py)
    <root>/step_00000200.tmp-<nonce>/   crashed save — swept by gc_stale

and the policies around it:

- **Retention**: ``keep_last_n`` most recent checkpoints always survive;
  ``keep_every_k`` additionally pins every k-th step (long-horizon
  rollback points).  Pruning runs only after a save has committed.
- **Bounded async saves**: ``async_save=True`` keeps at most
  ``max_inflight`` background writers; the next ``save`` blocks on the
  oldest writer first.  A failed background save re-raises at the next
  ``save``/``wait`` — it must surface, not vanish.
- **auto_resume / restore**: picks the latest checkpoint that passes
  integrity validation, falling back past corrupt ones (counted in
  ``ckpt_corruption_total``) — a torn or bit-rotted latest checkpoint
  silently costs a few steps, never the run.
- **SIGTERM hook**: ``install_preemption_hook()`` flips ``preempted``
  when the scheduler sends SIGTERM; the training loop (hapi ``fit``)
  checks it between steps, saves, and stops cleanly.

The reference's code over the port's ``checkpoint`` module: ``save``
takes a ``CompiledTrainStep`` (its ``save_checkpoint``) or a raw tree.
"""
from __future__ import annotations

import os
import re
import shutil
import signal
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..common.errors import CorruptCheckpointError, enforce
from . import checkpoint as _ckpt

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"step_(\d+)$")


class CheckpointManager:
    def __init__(self, root: str, keep_last_n: int = 3,
                 keep_every_k: Optional[int] = None,
                 async_save: bool = False, max_inflight: int = 2):
        enforce(keep_last_n >= 1, "keep_last_n must be >= 1")
        enforce(max_inflight >= 1, "max_inflight must be >= 1")
        self.root = str(root)
        self.keep_last_n = keep_last_n
        self.keep_every_k = keep_every_k
        self.async_save = async_save
        self.max_inflight = max_inflight
        self.preempted = False
        self._prev_sigterm = None
        self._on_preempt = None
        # (step, handle) in submission order — bounded write-behind queue
        self._inflight: "deque[Tuple[int, _ckpt.AsyncSaveHandle]]" = deque()
        self._lock = threading.Lock()
        os.makedirs(self.root, exist_ok=True)
        from ..observability import get_registry
        reg = get_registry()
        self._depth = reg.gauge(
            "ckpt_async_queue_depth",
            "in-flight background checkpoint writers")
        self._corrupt = reg.counter(
            "ckpt_corruption_total",
            "checkpoints skipped by restore/auto_resume as corrupt")
        self.gc_stale()

    # -- paths ---------------------------------------------------------------
    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:08d}")

    def steps_on_disk(self) -> List[int]:
        """Committed (dir-exists) step numbers, ascending.  Staging dirs
        (``*.tmp-*``) are crashed saves, never listed."""
        out = []
        for entry in os.listdir(self.root):
            m = _STEP_RE.fullmatch(entry)
            if m and os.path.isdir(os.path.join(self.root, entry)):
                out.append(int(m.group(1)))
        return sorted(out)

    def gc_stale(self) -> List[str]:
        """Sweep staging dirs (``*.tmp-<nonce>``) left by killed saves.
        Safe at any time: a staging dir is by construction never a
        committed checkpoint.  Returns the swept paths."""
        swept = []
        for entry in os.listdir(self.root):
            full = os.path.join(self.root, entry)
            if ".tmp-" in entry and os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
                _ckpt._untrack_staging(full)
                swept.append(full)
        return swept

    # -- save ----------------------------------------------------------------
    def save(self, state, step: int, extra_state: Optional[Dict] = None):
        """Checkpoint ``state`` as ``<root>/step_<step>``.

        ``state`` is either a train step object exposing
        ``save_checkpoint(path, async_save=, extra_state=)``
        (CompiledTrainStep) or a raw tree for
        ``save_state_dict``.  Synchronous by default; with the manager's
        ``async_save=True`` the host snapshot is still taken before this
        returns (training may mutate/donate immediately) and disk writes
        happen on a bounded background queue.  Raises a previous
        background save's failure before starting a new one."""
        from ..observability import health as _health
        from ..observability import tracing as _tracing
        with self._lock, _health.goodput_region(
                "checkpoint_save"), _tracing.span(
                "train.checkpoint_save",
                attrs={"step": step,
                       "mode": "async" if self.async_save
                       else "sync"}):
            # bounded queue: block on the oldest writer for a free slot,
            # surfacing its failure here if it had one.  The span
            # covers the host-side snapshot (async mode) or the whole
            # committed write (sync) — what the training loop WAITS on
            self._drain_locked(want_free_slot=True)
            path = self.step_dir(step)
            if hasattr(state, "save_checkpoint"):
                handle = state.save_checkpoint(
                    path, async_save=self.async_save,
                    extra_state=extra_state)
            else:
                enforce(extra_state is None,
                        "extra_state needs a train-step saver "
                        "(save_checkpoint); raw pytrees don't carry it")
                handle = _ckpt.save_state_dict(
                    state, path, async_save=self.async_save)
            if handle is not None:
                self._inflight.append((step, handle))
            else:
                self._retain_locked()
            self._depth.set(len(self._inflight))
            return handle

    def _drain_locked(self, want_free_slot: bool = False):
        while self._inflight:
            _s, h = self._inflight[0]
            if not h.done() and not (
                    want_free_slot and
                    len(self._inflight) >= self.max_inflight):
                break
            self._inflight.popleft()
            self._depth.set(len(self._inflight))
            try:
                h.wait()          # re-raises the writer's failure — loud
            finally:
                self._depth.set(len(self._inflight))
            self._retain_locked()

    def wait(self):
        """Block until every queued background save has committed,
        re-raising the first failure.  Call before relying on the latest
        checkpoint (end of training, pre-preemption shutdown)."""
        with self._lock:
            while self._inflight:
                _s, h = self._inflight.popleft()
                self._depth.set(len(self._inflight))
                h.wait()
                self._retain_locked()

    def _retain_locked(self):
        """keep-last-N + keep-every-K pruning of committed checkpoints
        (runs only after a commit; in-flight steps are never pruned)."""
        steps = self.steps_on_disk()
        pending = {s for s, _h in self._inflight}
        keep = set(steps[-self.keep_last_n:])
        if self.keep_every_k:
            keep |= {s for s in steps if s % self.keep_every_k == 0}
        for s in steps:
            if s not in keep and s not in pending:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # -- resume --------------------------------------------------------------
    def auto_resume(self, deep: bool = True
                    ) -> Optional[Tuple[int, str]]:
        """(step, path) of the latest checkpoint that passes integrity
        validation, or None.  Corrupt candidates are counted and skipped
        — a torn latest checkpoint falls back to the previous one."""
        self.gc_stale()
        for s in reversed(self.steps_on_disk()):
            path = self.step_dir(s)
            try:
                _ckpt.validate_checkpoint(path, deep=deep)
                return s, path
            except CorruptCheckpointError:
                self._corrupt.inc()
        return None

    def restore(self, state) -> Optional[Tuple[int, Optional[Dict]]]:
        """Load the latest VALID checkpoint into ``state`` (a train step
        object with ``load_checkpoint`` or a template pytree).  Returns
        ``(step, extra_state)`` — extra_state is the trainer-loop dict
        saved alongside (epoch/loader position), None for raw trees or
        when nothing valid exists.  Corruption during the load itself
        (sha mismatch on read) also falls back to the previous
        checkpoint; the template is never left half-mutated."""
        self.gc_stale()
        for s in reversed(self.steps_on_disk()):
            path = self.step_dir(s)
            try:
                if hasattr(state, "load_checkpoint"):
                    extra = state.load_checkpoint(path)
                else:
                    _ckpt.load_state_dict(state, path)
                    extra = None
                return s, extra
            except CorruptCheckpointError:
                self._corrupt.inc()
        return None

    # -- preemption ----------------------------------------------------------
    def install_preemption_hook(self, on_preempt=None):
        """Arm SIGTERM → ``self.preempted = True`` (+ optional callback).
        The training loop checks the flag between steps, saves, and
        exits; the handler itself only flips the flag — no checkpoint
        IO happens in signal context.  Chains a previously-installed
        python handler.  Main-thread only (signal module contract)."""
        self._on_preempt = on_preempt
        prev = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            self.preempted = True
            # flight recorder (when one is enabled): the preemption
            # moment and what the process was doing land on disk even
            # if the post-save shutdown never completes.  Flag flip
            # stays first — a failing dump cannot lose the preemption.
            from ..observability import tracing as _tracing
            rec = _tracing.get_flight_recorder()
            if rec is not None:
                rec.record("preempted", signum=int(signum))
                try:
                    rec.dump(reason="preempted")
                except Exception:
                    pass
            if self._on_preempt is not None:
                self._on_preempt()
            if callable(prev) and prev not in (
                    signal.SIG_DFL, signal.SIG_IGN, signal.default_int_handler):
                prev(signum, frame)

        self._prev_sigterm = prev
        signal.signal(signal.SIGTERM, handler)

    def uninstall_preemption_hook(self):
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None
        self._on_preempt = None
