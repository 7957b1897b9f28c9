"""Scalar metrics of a training run, and the alignment plots.

The port of the JAX package's ``utils/metrics.py``:

* ``MetricsLogger``: each ``log`` appends one JSON line (``step``, ``time``
  and the scalars, under an optional prefix such as ``eval/``) to
  ``metrics.jsonl`` and one scalar event to a TensorBoard event file
  (``utils/tb_events.py``) in the same directory;
* ``plot_alignment``, ``plot_predictions`` and ``plot_mgc_lf0``: alignment
  heatmaps and spectrogram panels as PNG (the reference's
  ``modules/metrics.py``);
* ``MetricsSaver``: the periodic writer of those plots (and optionally a
  prediction record) as ``{mode}_step{step:09d}_{key}.png``, keeping the
  newest ``keep_max`` PNGs.

matplotlib is optional: it is imported by the plotting functions, which
return False and write nothing where it is not installed (the machine with
the card has none); callers log that once and carry on.
"""

from __future__ import annotations

import importlib.util
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from .tb_events import EventWriter


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = EventWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        now = time.time()
        scalars = {prefix + k: float(v) for k, v in metrics.items()}
        self._f.write(json.dumps({"step": int(step), "time": now,
                                  **scalars}) + "\n")
        self._f.flush()
        self._tb.add_scalars(int(step), scalars, wall_time=now)

    def close(self):
        self._f.close()
        self._tb.close()


NO_PNG = "matplotlib is not installed: no PNG is written"


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_alignment(alignment: np.ndarray, path: str,
                   info: Optional[str] = None) -> bool:
    """One alignment heatmap as a PNG; False (nothing written) without
    matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(alignment, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep")
    ax.set_ylabel("Encoder timestep")
    if info:
        ax.set_title(info)
    fig.savefig(path, format="png")
    plt.close(fig)
    return True


def plot_predictions(alignments: Sequence[np.ndarray],
                     ground_truth: Optional[np.ndarray],
                     predicted: Optional[np.ndarray], text: str,
                     key: str, path: str,
                     predicted_postnet: Optional[np.ndarray] = None) -> bool:
    """Alignment heatmaps, then the ground-truth, predicted and postnet
    spectrogram panels that are given, as one PNG; False (nothing written)
    without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    specs = [(name, spec) for name, spec in (
        ("ground truth", ground_truth), ("predicted", predicted),
        ("predicted (postnet)", predicted_postnet)) if spec is not None]
    rows = len(alignments) + len(specs)
    fig = plt.figure(figsize=(12, 3 * rows))
    for i, align in enumerate(alignments):
        ax = fig.add_subplot(rows, 1, i + 1)
        im = ax.imshow(np.asarray(align), aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        ax.set_title(f"alignment {i + 1}")
    for i, (name, spec) in enumerate(specs):
        ax = fig.add_subplot(rows, 1, len(alignments) + i + 1)
        im = ax.imshow(np.asarray(spec).T, aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        ax.set_title(name)
    fig.suptitle(f"record: {key}\n{text}"[:400])
    fig.savefig(path, format="png")
    plt.close(fig)
    return True


def plot_mgc_lf0(mgc_gt: np.ndarray, mgc_pred: np.ndarray,
                 lf0_gt: np.ndarray, lf0_pred: np.ndarray, key: str,
                 path: str) -> bool:
    """Four panels: the mgc ground truth and prediction (magma, +-4) and the
    lf0 ones (binary in [0, 1]; a 1-D track as a line); False (nothing
    written) without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    fig = plt.figure(figsize=(12, 14))
    T = np.asarray(mgc_gt).shape[0]
    panels = [("mgc ground truth", mgc_gt, "magma", -4.0, 4.0),
              ("mgc predicted", np.asarray(mgc_pred)[:T], "magma", -4.0, 4.0),
              ("lf0 ground truth", lf0_gt, "binary", 0.0, 1.0),
              ("lf0 predicted", np.asarray(lf0_pred)[:T], "binary", 0.0, 1.0)]
    for i, (name, spec, cmap, vmin, vmax) in enumerate(panels):
        ax = fig.add_subplot(4, 1, i + 1)
        spec = np.asarray(spec)
        if spec.ndim == 1:
            ax.plot(spec)
        else:
            im = ax.imshow(spec.T, aspect="auto", origin="lower",
                           interpolation="none", cmap=cmap, vmin=vmin,
                           vmax=vmax)
            fig.colorbar(im, ax=ax)
        ax.set_title(name)
    fig.suptitle(f"record: {key}")
    fig.savefig(path, format="png")
    plt.close(fig)
    return True


class MetricsSaver:
    """Alignment plots (and prediction records) every ``save_steps`` steps
    as ``{mode}_step{step:09d}_{key}.png`` in ``out_dir``, the newest
    ``keep_max`` PNGs kept.  Without matplotlib no PNG is written; ``log``,
    if given, hears so once."""

    def __init__(self, out_dir: str, save_steps: int = 50, mode: str = "train",
                 keep_max: Optional[int] = None, log=None):
        self.out_dir = out_dir
        self.save_steps = max(save_steps, 1)
        self.mode = mode
        self.keep_max = keep_max
        self.log = log
        self._said_no_png = False
        os.makedirs(out_dir, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step % self.save_steps == 0

    def _drew(self, written: bool, png: str) -> Optional[str]:
        if written:
            return png
        if self.log is not None and not self._said_no_png:
            self.log.warning(NO_PNG)
        self._said_no_png = True
        return None

    def save(self, step: int, key: str, text: str,
             alignments: Sequence[np.ndarray],
             ground_truth: Optional[np.ndarray],
             predicted: Optional[np.ndarray],
             prediction_record_writer=None) -> Optional[str]:
        """The PNG's path, or None (not this step, or no matplotlib)."""
        if not self.should_save(step):
            return None
        name = f"{self.mode}_step{step:09d}_{key}"
        png = os.path.join(self.out_dir, name + ".png")
        written = plot_predictions(alignments, ground_truth, predicted, text,
                                   key, png)
        if prediction_record_writer is not None:
            prediction_record_writer(
                os.path.join(self.out_dir, name + ".tfrecord"))
        self._cleanup()
        return self._drew(written, png)

    def save_mgc_lf0(self, step: int, key: str, text: str,
                     alignments: Sequence[np.ndarray],
                     mgc_gt: np.ndarray, mgc_pred: np.ndarray,
                     lf0_gt: np.ndarray, lf0_pred: np.ndarray,
                     prediction_record_writer=None) -> Optional[str]:
        """The MGC/LF0 flavour: ``alignment_<name>.png``, the
        ``mgc_lf0_<name>.png`` panels and the record."""
        if not self.should_save(step):
            return None
        name = f"{self.mode}_step{step:09d}_{key}"
        align_png = os.path.join(self.out_dir, "alignment_" + name + ".png")
        plot_predictions(alignments, None, None, text, key, align_png)
        png = os.path.join(self.out_dir, "mgc_lf0_" + name + ".png")
        written = plot_mgc_lf0(mgc_gt, mgc_pred, lf0_gt, lf0_pred, key, png)
        if prediction_record_writer is not None:
            prediction_record_writer(
                os.path.join(self.out_dir, name + ".tfrecord"))
        self._cleanup()
        return self._drew(written, png)

    def _cleanup(self):
        if self.keep_max is None:
            return
        pngs = sorted(f for f in os.listdir(self.out_dir)
                      if f.endswith(".png"))
        for f in pngs[:-self.keep_max]:
            try:
                os.remove(os.path.join(self.out_dir, f))
            except OSError:
                pass
