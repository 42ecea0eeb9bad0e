"""Training checkpoints in PyTorch's own format. Counterpart of
`TrainCheckpointManager` in `propainter_tpu/checkpoints.py` (the same
`save` / `restore` / `latest_step` interface; the JAX package's orbax
directories are not read). The files are the reference's
(core/trainer.py:274-319): `gen_%06d.pth` and `dis_%06d.pth` hold the
networks' state dicts (the discriminator's spectral-norm u and v among
them), `opt_%06d.pth` the optimizers and schedulers as optimG / optimD /
scheG / scheD with the iteration, and `latest.ckpt` the latest iteration.

Across ranks (`parallel.mesh`) rank 0 alone writes, as the JAX CLI saves
only from its main process, and a barrier follows each save, so no rank
reads a file still being written; every rank restores from the same
files.
"""

from __future__ import annotations

import os

import torch

from propainter_tpu_torch.parallel.mesh import barrier, is_main


class TrainCheckpointManager:
    """Iteration-stamped checkpoints of a train state (one with
    `checkpoint_items()`, `core/trainer.py`) with a latest pointer;
    max_to_keep: keep only the newest so many (None: all)."""

    def __init__(self, directory: str, max_to_keep: int | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if is_main():
            os.makedirs(self.directory, exist_ok=True)
        barrier()

    def _path(self, kind: str, step: int) -> str:
        return os.path.join(self.directory, f"{kind}_{step:06d}.pth")

    def steps(self) -> list[int]:
        return sorted(int(f[4:-4]) for f in os.listdir(self.directory)
                      if f.startswith("opt_") and f.endswith(".pth"))

    def save(self, step: int, state) -> None:
        """Rank 0 writes step `step` of `state`; every rank then waits
        for it."""
        if is_main():
            self._write(step, state)
        barrier()

    def _write(self, step: int, state) -> None:
        items = state.checkpoint_items()
        torch.save(items["gen"].state_dict(), self._path("gen", step))
        if items["dis"] is not None:
            torch.save(items["dis"].state_dict(), self._path("dis", step))
        opt = {k: items[k].state_dict() for k in ("optimG", "scheG",
                                                  "optimD", "scheD")
               if items[k] is not None}
        torch.save(dict(opt, iteration=step), self._path("opt", step))
        latest = os.path.join(self.directory, "latest.ckpt")
        with open(latest + ".tmp", "w") as f:
            f.write(f"{step}\n")
        os.replace(latest + ".tmp", latest)
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                for kind in ("gen", "dis", "opt"):
                    if os.path.exists(self._path(kind, old)):
                        os.remove(self._path(kind, old))

    def latest_step(self) -> int | None:
        latest = os.path.join(self.directory, "latest.ckpt")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            return int(f.read().strip())

    def restore(self, state, step: int | None = None):
        """Load checkpoint `step` (None: the latest) into `state` in place
        and return it; None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        items = state.checkpoint_items()
        device = next(items["gen"].parameters()).device
        items["gen"].load_state_dict(torch.load(
            self._path("gen", step), map_location=device))
        if items["dis"] is not None:
            items["dis"].load_state_dict(torch.load(
                self._path("dis", step), map_location=device))
        opt = torch.load(self._path("opt", step), map_location=device)
        for k in ("optimG", "scheG", "optimD", "scheD"):
            if items[k] is not None:
                items[k].load_state_dict(opt[k])
        state.step = int(opt["iteration"])
        return state
