"""Checkpoint / resume with `torch.save`.

Port of `deformablelka_tpu/training/checkpoint.py` (Orbax there). Parity
target: upstream's network_trainer_synapse.py:283-348 — `model_best`,
`model_latest`, `model_final_checkpoint` with {epoch, state_dict,
optimizer, plot/best bookkeeping}; restore via `--continue_training`
(run_training.py:184-190). The scheduled-save policy mirrors
`maybe_save_checkpoint` (network_trainer_synapse.py:546-556): every
`save_every` epochs once past epoch 400, an additional immutable
`model_ep_%03d` checkpoint is written (unless `save_latest_only`), plus
`model_latest`.

Layout, as the JAX package's: checkpoint `<name>` is the directory
`<dir>/<name>/` (here holding one `state.pt`), its bookkeeping dict the
JSON file `<dir>/<name>.json`. A state is a dict of `state_dict()`s and
plain values (numbers, strings, lists, dicts); `load` reads it back with
`torch.load(weights_only=True)`, onto the CPU unless asked, so nothing
but tensors and plain containers is unpickled. By convention the model's
weights are under the key "model".

- **Async saves**: the copy to the host is synchronous (so training can
  change the state right after `save`), the write runs on a background
  thread. `wait_until_finished()` joins; `load`, `exists` and the next
  `save` join first, so readers always see complete checkpoints, and an
  exit handler joins the last one. A checkpoint is written to a
  temporary file and renamed into place.
- **GC keep-policy**: at most `max_scheduled_keep` `model_ep_*`
  checkpoints are kept (oldest deleted). Named role checkpoints
  (best/latest/final) are never deleted.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Optional

import torch

_EP_RE = re.compile(r"^model_ep_(\d+)$")
STATE_FILE = "state.pt"


def _to_host(state):
    """A copy of `state` with every tensor detached, cloned and on the CPU."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    return state


class CheckpointManager:
    def __init__(self, directory: str | Path, *, async_save: bool = True,
                 max_scheduled_keep: int = 5):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_save = async_save
        self.max_scheduled_keep = max_scheduled_keep
        self._pending: Optional[threading.Thread] = None
        self._pending_err: Optional[BaseException] = None
        # Join any in-flight save before the interpreter tears down its
        # threads: a daemon thread killed mid-write leaves no checkpoint.
        atexit.register(self._drain_at_exit)

    def _drain_at_exit(self):
        try:
            self.wait_until_finished()
        except Exception:
            pass  # exit path: nothing can handle it anymore

    def _path(self, name: str) -> Path:
        return self.dir / name

    # -- async plumbing --------------------------------------------------
    def wait_until_finished(self):
        """Join any in-flight async save; re-raise its error if it died."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join()
        err, self._pending_err = self._pending_err, None
        if err is not None:
            raise err

    def _write(self, name: str, state, bookkeeping: Optional[dict]):
        path = self._path(name)
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, path / STATE_FILE)
        if bookkeeping is not None:
            (self.dir / f"{name}.json").write_text(
                json.dumps(bookkeeping, default=float))

    def save(self, name: str, state, bookkeeping: Optional[dict] = None):
        # Copy to the host synchronously: the caller may update `state`
        # in place right after; the disk write is async.
        self.wait_until_finished()
        host_state = _to_host(state)
        if not self.async_save:
            self._write(name, host_state, bookkeeping)
            return

        def worker():
            try:
                self._write(name, host_state, bookkeeping)
            except Exception as e:  # surfaced at the next join
                self._pending_err = e

        t = threading.Thread(target=worker, daemon=True,
                             name=f"ckpt-save-{name}")
        t.start()
        self._pending = t

    def load(self, name: str, map_location="cpu"):
        """(state, bookkeeping dict or None) of checkpoint `name`."""
        self.wait_until_finished()
        state = torch.load(self._path(name) / STATE_FILE,
                           map_location=map_location, weights_only=True)
        meta = None
        metaf = self.dir / f"{name}.json"
        if metaf.exists():
            meta = json.loads(metaf.read_text())
        return state, meta

    def exists(self, name: str) -> bool:
        self.wait_until_finished()
        return self._path(name).exists()

    # -- scheduled checkpoints + GC ---------------------------------------
    def scheduled_epochs(self) -> list:
        """Epoch numbers of retained `model_ep_*` checkpoints (sorted)."""
        out = []
        for p in self.dir.iterdir():
            m = _EP_RE.match(p.name)
            if m and p.is_dir():
                out.append(int(m.group(1)))
        return sorted(out)

    def save_scheduled(self, epoch: int, state,
                       bookkeeping: Optional[dict] = None):
        """Save an immutable `model_ep_%03d` and GC beyond the keep cap."""
        self.save(f"model_ep_{epoch:03d}", state, bookkeeping)
        self.wait_until_finished()
        eps = self.scheduled_epochs()
        while self.max_scheduled_keep and len(eps) > self.max_scheduled_keep:
            old = eps.pop(0)
            name = f"model_ep_{old:03d}"
            shutil.rmtree(self._path(name), ignore_errors=True)
            metaf = self.dir / f"{name}.json"
            if metaf.exists():
                metaf.unlink()


def should_save_scheduled(epoch: int, save_every: int,
                          warmup_epochs: int = 400) -> bool:
    """Upstream's cadence (network_trainer_synapse.py:551): every
    `save_every` epochs once past `warmup_epochs`. `epoch` here is the
    post-increment epoch counter (upstream tests pre-increment
    `epoch % save_every == save_every - 1`, equivalent)."""
    return epoch > warmup_epochs + 1 and epoch % save_every == 0
