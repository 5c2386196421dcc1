"""Checkpoint / resume of the training state.

Counterpart of ``tch_geometric_tpu/utils/checkpoint.py`` with the same
``path/step_<n>`` directory layout; each checkpoint is one ``torch.save``
file, ``state.pt``.  The state (e.g. a ``TrainState`` and the root key) is
saved as plain containers of tensors and numbers, so it loads with
``weights_only=True``; orbax's format is not read.  Graph data is immutable
input and is not checkpointed.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"


def _target(path: str, step: Optional[int]) -> str:
    path = os.path.abspath(path)
    return os.path.join(path, f"step_{step}") if step is not None else path


def _plain(obj: Any) -> Any:
    """Named tuples -> dicts, tensors detached; the rest as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if isinstance(obj, tuple) and hasattr(obj, "_asdict"):
        return {k: _plain(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _fill(template: Any, saved: Any) -> Any:
    """``saved`` in the structure of ``template``.  A template tensor that
    requires grad (a parameter) takes the saved values in place, so a model
    that owns it sees them; other tensors are the saved ones on the
    template tensor's device, numbers the saved ones."""
    if isinstance(template, torch.Tensor):
        if template.requires_grad:
            with torch.no_grad():
                template.copy_(saved)
            return template
        return saved.to(template.device)
    if isinstance(template, tuple) and hasattr(template, "_asdict"):
        return type(template)(**{k: _fill(v, saved[k])
                                 for k, v in template._asdict().items()})
    if isinstance(template, dict):
        return {k: _fill(v, saved[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_fill(t, s) for t, s in zip(template, saved))
    return saved


def _device(obj: Any) -> torch.device:
    """The device of the first tensor in ``obj`` (the CPU if none)."""
    if isinstance(obj, torch.Tensor):
        return obj.device
    items = (obj.values() if isinstance(obj, dict)
             else obj if isinstance(obj, (list, tuple)) else ())
    for v in items:
        d = _device(v)
        if d.type != "cpu":
            return d
    return torch.device("cpu")


def save_checkpoint(path: str, state: Any, *,
                    step: Optional[int] = None) -> str:
    """Save ``state`` under ``path`` (``path/step_<step>`` when ``step`` is
    given); returns the directory written."""
    target = _target(path, step)
    os.makedirs(target, exist_ok=True)
    torch.save(_plain(state), os.path.join(target, STATE_FILE))
    return target


def restore_checkpoint(path: str, template: Any, *,
                       step: Optional[int] = None) -> Any:
    """Restore a state saved by :func:`save_checkpoint` onto the device of
    ``template``'s tensors, in ``template``'s structure (parameters of the
    template are written in place)."""
    saved = torch.load(os.path.join(_target(path, step), STATE_FILE),
                       map_location=_device(template), weights_only=True)
    return _fill(template, saved)


def latest_step(path: str) -> Optional[int]:
    """Largest ``step_*`` checkpoint under ``path`` (None if none)."""
    if not os.path.isdir(path):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(path)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None
