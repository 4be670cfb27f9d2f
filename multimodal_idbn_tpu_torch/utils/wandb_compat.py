"""Optional packages of the diagnostics: W&B, matplotlib and pandas.

Port of multimodal_idbn_tpu/utils/wandb_compat.py:1-60. The stub is the
same: ``Image``, ``Table``, ``plot.confusion_matrix``, ``init`` and
``log``, so any run object with a ``.log(dict)`` method (a W&B run, the
``RecorderRun`` below, a custom sink) receives the same keys and payload
structure whether or not the wandb package is installed. Unlike the JAX
module, nothing is imported when this module is: ``wandb`` resolves to the
wandb package at its first use where that is installed, else to the stub,
and ``init`` can be replaced on it (``wandb.init = ...``) to hand the entry
points a run object of one's own. matplotlib and pandas are imported only
by the code that draws a figure or builds a data frame (``pyplot``,
``has_pandas``); the numbers never need them.
"""

from __future__ import annotations

import importlib
import math

import numpy as np


class _Image:
    """Holds the image/figure payload in place of wandb.Image."""

    def __init__(self, obj, caption=None):
        self.obj = obj
        self.caption = caption

    def __repr__(self):
        return f"Image(caption={self.caption!r})"


class _Table:
    def __init__(self, columns=None, dataframe=None, data=None):
        self.columns = list(columns) if columns is not None else None
        self.dataframe = dataframe
        self.data = list(data) if data is not None else []

    def add_data(self, *row):
        self.data.append(list(row))


class _Plot:
    @staticmethod
    def confusion_matrix(y_true=None, preds=None, class_names=None, **kw):
        return {"y_true": list(y_true), "preds": list(preds),
                "class_names": list(class_names or [])}


class _WandbStub:
    Image = _Image
    Table = _Table
    plot = _Plot()
    run = None

    @staticmethod
    def log(*a, **kw):  # global wandb.log needs a real run; no-op
        pass

    @staticmethod
    def init(*a, **kw):
        return None


class _Wandb:
    """The wandb package where it is installed, else the stub, resolved at
    the first attribute read. Attributes set on it (``wandb.init = f``)
    take precedence."""

    _module = None

    def __getattr__(self, name):
        if _Wandb._module is None:
            try:
                _Wandb._module = importlib.import_module("wandb")
            except ImportError:
                _Wandb._module = _WandbStub()
        return getattr(_Wandb._module, name)


wandb = _Wandb()


def pyplot(run, diagnostic: str):
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib
    cannot be imported; then ``warn/{diagnostic}_figure_skipped``, naming
    the missing package, is logged to ``run``."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        if run is not None:
            run.log({f"warn/{diagnostic}_figure_skipped":
                     f"matplotlib is not installed ({e})"})
        return None
    return plt


def has_pandas() -> bool:
    try:
        import pandas  # noqa: F401
    except ImportError:
        return False
    return True


class _Config(dict):
    def update(self, d=(), allow_val_change=None, **kw):
        super().update(d, **kw)


class RecorderRun:
    """A run object that keeps every dict logged to it: what the
    diagnostics log without W&B. ``wandb.init = lambda **kw: RecorderRun()``
    hands one to the entry points; ``model.wandb_run = RecorderRun()`` to a
    model."""

    def __init__(self, **init_kw):
        self.init_kw = init_kw
        self.config = _Config()
        self.logged = []
        self.finished = False

    def log(self, d: dict) -> None:
        self.logged.append(dict(d))

    def finish(self) -> None:
        self.finished = True

    def keys(self) -> set:
        return {k for d in self.logged for k in d}

    def values(self, key: str) -> list:
        """Every value logged under ``key``, in order."""
        return [d[key] for d in self.logged if key in d]

    def epochs(self, key: str) -> list:
        """The ``epoch`` logged beside each value of ``key`` (None where
        none was)."""
        return [d.get("epoch") for d in self.logged if key in d]

    def numeric_keys(self) -> set:
        """Keys whose every value is numeric (``is_numeric``)."""
        out = {}
        for d in self.logged:
            for k, v in d.items():
                out[k] = out.get(k, True) and is_numeric(v)
        return {k for k, num in out.items() if num}


def is_numeric(v) -> bool:
    """A number, a numeric array, or a dict of numbers and None (the
    summaries)."""
    if isinstance(v, bool):
        return False
    if isinstance(v, (int, float, np.integer, np.floating)):
        return True
    if isinstance(v, np.ndarray):
        return v.dtype.kind in "iuf"
    if isinstance(v, dict) and v:
        return all(x is None or (is_numeric(x) and not isinstance(x, dict))
                   for x in v.values())
    return False


def numbers_of(v) -> list:
    """The numbers a numeric value holds, as floats."""
    if isinstance(v, dict):
        return [float(x) for x in v.values() if x is not None]
    if isinstance(v, np.ndarray):
        return [float(x) for x in v.reshape(-1)]
    return [float(v)]


def all_finite(v) -> bool:
    return all(math.isfinite(x) for x in numbers_of(v))
