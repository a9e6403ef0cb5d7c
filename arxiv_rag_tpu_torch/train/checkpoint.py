"""TrainState snapshots: resumable fine-tuning, the port of
``arxiv_rag_tpu/train/checkpoint.py``.

One ``step_%08d`` directory per snapshot, as the reference names them,
holding ``state.pt``: the fp32 parameters, both Adam moments, the Adam
count and the step, written with ``torch.save`` and read back with
``torch.load(weights_only=True)``. The reference's orbax format is not
ported. A snapshot is written under a temporary name and renamed into
place, so an interrupted save leaves the earlier snapshots as they were.
Resume is exact: the restored tensors are the saved bits.
"""

from __future__ import annotations

import copy
import shutil
from pathlib import Path

import torch

from arxiv_rag_tpu_torch.logging_utils import get_logger
from arxiv_rag_tpu_torch.train.contrastive import AdamWState, TrainState

log = get_logger("train.ckpt")

STATE_FILE = "state.pt"


def save_train_state(directory: str | Path, state: TrainState) -> Path:
    """Write a step-numbered snapshot; returns its path."""
    directory = Path(directory).resolve()
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{state.step:08d}"

    def host(tensors):
        return {k: v.detach().cpu() for k, v in tensors.items()}

    payload = {"params": host(state.params), "mu": host(state.opt_state.mu),
               "nu": host(state.opt_state.nu), "count": state.opt_state.count,
               "step": state.step}
    tmp = directory / f".tmp-{path.name}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(payload, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    tmp.rename(path)
    log.info("saved train state at step %d -> %s", state.step, path)
    return path


def latest_checkpoint(directory: str | Path) -> Path | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(directory.glob("step_*"))
    return steps[-1] if steps else None


def restore_train_state(directory_or_path: str | Path,
                        template: TrainState) -> TrainState | None:
    """Restore the latest snapshot (or the ``step_*`` directory given)
    into a new state shaped as ``template`` (from ``init_state`` of the
    same model and device); None if there is no snapshot."""
    path = Path(directory_or_path).resolve()
    if path.is_dir() and not path.name.startswith("step_"):
        latest = latest_checkpoint(path)
        if latest is None:
            return None
        path = latest.resolve()
    elif not path.exists():
        return None
    dev = next(iter(template.params.values())).device
    payload = torch.load(path / STATE_FILE, map_location=dev, weights_only=True)
    if payload["params"].keys() != template.params.keys():
        raise ValueError(f"{path}: the snapshot's parameters are not the template's")
    model = copy.deepcopy(template.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(payload["params"][name])
    names = list(template.params)  # the moments in the parameters' order
    moments = AdamWState({k: payload["mu"][k] for k in names},
                         {k: payload["nu"][k] for k in names}, int(payload["count"]))
    state = TrainState(model, moments, int(payload["step"]))
    log.info("restored train state from %s (step %d)", path, state.step)
    return state
