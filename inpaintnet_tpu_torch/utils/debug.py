"""Non-finite checks (``inpaintnet_tpu/utils/debug.py``).

The reference sweeps every weight for NaNs on every forward pass
(``encoder.py:111-116``, ``decoder.py:424-429``). The counterparts here:

- ``nan_check(params)``: a sweep of nested parameters that raises naming
  the first non-finite leaf's path; trainers run it once an epoch with
  ``debug=True``;
- ``assert_finite(tree, name)``: the same check for outputs;
- ``checkify_wrap(fn)``: the JAX package's ``checkify`` wrapper, as
  ``err, out = wrapped(*args)``: every PyTorch function ``fn`` calls is
  watched (a ``TorchFunctionMode``), and the first one that makes a
  non-finite value from finite inputs (a NaN, a division by zero), or an
  index outside its tensor, becomes ``err`` instead of an exception.
  ``err.get()`` is the message or None, ``err.throw()`` raises it. Each
  watched call reads its result back to the host: for debugging runs only.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.overrides import TorchFunctionMode

from inpaintnet_tpu_torch.models.base import iter_leaves


def _finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not x.is_floating_point() or bool(torch.isfinite(x.detach()).all())
    try:
        import numpy as np

        return bool(np.isfinite(np.asarray(x, dtype=np.float64)).all())
    except (TypeError, ValueError):
        return True


def nan_check(params: Any, what: str = "params") -> None:
    """Raise ValueError naming the first leaf of ``params`` (nested dicts and
    lists of tensors) that holds a NaN or an infinity."""
    for path, leaf in iter_leaves(params):
        if not _finite(leaf):
            raise ValueError(f"{what} has become non-finite at {path}")


def assert_finite(tree: Any, name: str = "output") -> None:
    for _, leaf in iter_leaves(tree):
        if not _finite(leaf):
            raise ValueError(f"{name} contains non-finite values")


class CheckError:
    """What ``checkify_wrap``'s function found: a message, or None."""

    def __init__(self, msg: Optional[str] = None):
        self.msg = msg

    def get(self) -> Optional[str]:
        return self.msg

    def throw(self) -> None:
        if self.msg is not None:
            raise ValueError(self.msg)


def _tensors(tree):
    return [leaf for _, leaf in iter_leaves(tree) if isinstance(leaf, torch.Tensor)]


class _FiniteWatch(TorchFunctionMode):
    """Records the first call whose floating outputs are not finite while
    its floating inputs are (a mode's handler runs with the mode off, so
    its own checks are not watched)."""

    def __init__(self):
        super().__init__()
        self.first: Optional[str] = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.first is None and not all(_finite(t) for t in _tensors(out)):
            if all(_finite(t) for t in _tensors((list(args), kwargs or {}))):
                self.first = f"non-finite value produced by {getattr(func, '__name__', func)}"
        return out


def checkify_wrap(fn):
    """``fn`` made to return ``(err, out)``: the first NaN, infinity or
    out-of-range index inside it is ``err`` (a :class:`CheckError`), and
    ``out`` is None where an index stopped it."""
    def wrapped(*args, **kwargs):
        watch = _FiniteWatch()
        try:
            with watch:
                out = fn(*args, **kwargs)
        except IndexError as e:
            return CheckError(f"index out of range: {e}"), None
        except RuntimeError as e:
            if "out of bounds" not in str(e) and "out of range" not in str(e):
                raise
            return CheckError(f"index out of range: {e}"), None
        return CheckError(watch.first), out
    return wrapped
