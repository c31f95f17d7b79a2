"""Fit :class:`repro_torch.core.theory.CommModel` parameters from probe
samples (PyTorch port of ``repro/autotune/calibrate.py``; numpy and plain
Python, a copy that differs in import paths and docstrings).

The serial-schedule cost stack the probe measures is linear in four
non-negative parameters:

    t  =  [2 V (n-1) / n] * (1/fast_bw)        (ICI samples)
        + [2 V (n-1) / n] * (1/slow_bw)        (DCI samples)
        + [2 (n-1) m]     * latency            (per-message ring startups)
        + [D]             * (1/compress_bw)    (codec samples)

with V the wire payload, n the participants, m the dispatched messages,
D the dense (uncompressed) bytes — exactly
``CommModel.allreduce_time(V, n, bw) + (m-1)·2(n-1)·latency +
D/compress_bw``, the same bill ``theory.level_reduction_seconds`` puts
on a serial level.  :func:`fit_comm_model` solves the non-negative
least-squares problem exactly (best feasible column subset); parameters
whose feature column is all-zero (e.g. no DCI samples in a smoke grid)
or that the fit zeroes out keep the base model's value and are excluded
from ``Calibration.fitted``.

Per-codec compute: samples stamped with a non-empty ``codec`` label
(``Reducer.codec_name``, recorded by probe.py) move their dense-bytes
support out of the shared ``compress_bw`` column into one column per
codec family (top-k's select+scatter, qint8's pack, PowerSGD's
products+QR).  Fitted rates land in ``CommModel.codec_bw`` (reported as
``compress_bw[<codec>]`` in ``fitted``); ``CommModel.compress_bw_for``
falls back to the shared constant for any codec the fit didn't see.

The result serializes to the reference's JSON **calibration artifact**
(an artifact written by either package loads in the other), which
``launch/analytic.py`` loads instead of its built-in constants
(``resolve_calibration``, env var ``REPRO_CALIBRATION``), and which
``CostAwarePlan``, ``autotune/search.py`` and ``launch/train.py
--autotune`` turn into period and plan choices.

Tolerance note: ``CPU_MEDIAN_REL_ERR`` is the reference's documented
CPU tolerance (collective wall-clock on a few oversubscribed cores is
scheduler-bound, so the round trip asserts a median relative error
within 0.75, not hardware-grade accuracy).  On a card, what a fit can
identify and how close it comes is measured, not assumed (PERF.md).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.theory import CommModel

ENV_CALIBRATION = "REPRO_CALIBRATION"

# parameter order of the feature matrix; fitted values are the
# coefficients' reciprocals for the bandwidths, the coefficient itself
# for latency
PARAMS = ("fast_bw", "slow_bw", "latency", "compress_bw")

# documented CPU tolerance (see module docstring): median relative
# prediction error the calibration round-trip must stay within
CPU_MEDIAN_REL_ERR = 0.75


@dataclass(frozen=True)
class Calibration:
    """A fitted CommModel plus fit provenance/diagnostics."""

    model: CommModel
    fitted: Tuple[str, ...]          # params that came from the fit
    n_samples: int
    median_rel_err: float
    max_rel_err: float
    time_field: str = "min_us"
    source: str = ""

    def save(self, path: str) -> None:
        cm = dataclasses.asdict(self.model)
        if not cm.get("codec_bw"):
            # keep the artifact's documented key set stable when no
            # per-codec rate was fitted
            cm.pop("codec_bw", None)
        with open(path, "w") as f:
            json.dump({
                "comm_model": cm,
                "fitted": list(self.fitted),
                "diagnostics": {
                    "n_samples": self.n_samples,
                    "median_rel_err": round(self.median_rel_err, 4),
                    "max_rel_err": round(self.max_rel_err, 4),
                    "time_field": self.time_field,
                },
                "source": self.source,
            }, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "Calibration":
        with open(path) as f:
            d = json.load(f)
        if not isinstance(d, dict) or "comm_model" not in d:
            raise ValueError(
                f"{path} is not a calibration artifact (no 'comm_model' "
                f"key) — expected the JSON written by Calibration.save / "
                f"`python -m repro_torch.autotune.calibrate`, not e.g. "
                f"BENCH_autotune.json benchmark records")
        diag = d.get("diagnostics", {})
        return cls(model=CommModel(**d["comm_model"]),
                   fitted=tuple(d.get("fitted", ())),
                   n_samples=int(diag.get("n_samples", 0)),
                   median_rel_err=float(diag.get("median_rel_err",
                                                 float("nan"))),
                   max_rel_err=float(diag.get("max_rel_err", float("nan"))),
                   time_field=diag.get("time_field", "min_us"),
                   source=d.get("source", path))


def sample_features(s: Dict) -> np.ndarray:
    """Feature row of one probe sample, ordered like ``PARAMS``."""
    v, n, m = s["payload_bytes"], s["n"], s["messages"]
    ring = 2.0 * v * (n - 1) / n if n > 1 else 0.0
    return np.array([
        ring if s["tier"] == "ici" else 0.0,
        ring if s["tier"] == "dci" else 0.0,
        2.0 * (n - 1) * m,
        float(s["dense_bytes"]) if s.get("has_codec", True) else 0.0,
    ])


def _codec_label(s: Dict) -> str:
    """Codec family of a sample ("" when unlabeled or codec-free): the
    per-codec fit groups dense-bytes support by this label."""
    if not s.get("has_codec", True):
        return ""
    return str(s.get("codec") or "")


def predict_seconds(model: CommModel, s: Dict) -> float:
    """The model's prediction for one probe sample — shared by the fit
    diagnostics and the round-trip acceptance test, and identical in
    form to ``theory.level_reduction_seconds`` on the serial schedule
    (including its per-codec ``compress_bw_for`` pricing)."""
    theta = np.array([1.0 / model.fast_bw, 1.0 / model.slow_bw,
                      model.latency,
                      1.0 / model.compress_bw_for(_codec_label(s))])
    return float(sample_features(s) @ theta)


def _nnls(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact non-negative least squares for a skinny (<= 4-column) A:
    try every column subset, keep the best feasible solution."""
    k = A.shape[1]
    best, best_res = np.zeros(k), float(np.dot(b, b))
    for r in range(1, k + 1):
        for cols in itertools.combinations(range(k), r):
            sub = A[:, cols]
            theta, *_ = np.linalg.lstsq(sub, b, rcond=None)
            if np.any(theta < 0):
                continue
            res = float(np.sum((sub @ theta - b) ** 2))
            if res < best_res - 1e-30:
                best_res = res
                best = np.zeros(k)
                best[list(cols)] = theta
    return best


def fit_comm_model(samples: Sequence[Dict], *,
                   base: Optional[CommModel] = None,
                   time_field: str = "min_us",
                   source: str = "") -> Calibration:
    """Least-squares calibration of CommModel from probe samples.

    ``time_field`` picks the per-sample statistic (``min_us`` by
    default; see probe.py for why the floor, not the mean).  Parameters
    without support in the samples (all-zero feature column, or zeroed
    by the non-negativity constraint) keep ``base``'s value.
    """
    if not samples:
        raise ValueError("need at least one probe sample")
    base = base or CommModel()
    A = np.stack([sample_features(s) for s in samples])
    b = np.array([s[time_field] * 1e-6 for s in samples])
    # per-codec columns: codec-labeled samples carry their dense-bytes
    # support in a column of their own; the shared compress_bw column
    # keeps only the unlabeled codec samples
    labels = np.array([_codec_label(s) for s in samples])
    codecs = sorted({c for c in labels if c})
    dense = A[:, 3].copy()
    A[:, 3] = np.where(labels == "", dense, 0.0)
    if codecs:
        A = np.concatenate(
            [A] + [np.where(labels == c, dense, 0.0)[:, None]
                   for c in codecs], axis=1)
    names = list(PARAMS) + [f"compress_bw[{c}]" for c in codecs]
    identifiable = np.abs(A).sum(axis=0) > 0
    theta = np.zeros(A.shape[1])
    theta[identifiable] = _nnls(A[:, identifiable], b)

    vals = {}
    codec_bw = []
    fitted = []
    for i, name in enumerate(names):
        coef = theta[i]
        if not identifiable[i] or coef <= 0:
            if i < len(PARAMS):
                vals[name] = getattr(base, name)
            continue            # unfitted codec: compress_bw_for falls
            # back to the shared constant
        if i >= len(PARAMS):
            codec_bw.append((codecs[i - len(PARAMS)], 1.0 / coef))
        else:
            vals[name] = coef if name == "latency" else 1.0 / coef
        fitted.append(name)
    model = CommModel(**vals, codec_bw=tuple(codec_bw) or None)

    rel = []
    for s in samples:
        t = s[time_field] * 1e-6
        if t > 0:
            rel.append(abs(predict_seconds(model, s) - t) / t)
    rel = rel or [float("nan")]
    return Calibration(model=model, fitted=tuple(fitted),
                       n_samples=len(samples),
                       median_rel_err=float(np.median(rel)),
                       max_rel_err=float(np.max(rel)),
                       time_field=time_field, source=source)


def calibrate_file(probe_path: str, out_path: Optional[str] = None,
                   **kw) -> Calibration:
    """probe.json -> Calibration (optionally saved as the artifact)."""
    from repro_torch.autotune.probe import load_samples
    cal = fit_comm_model(load_samples(probe_path), source=probe_path, **kw)
    if out_path:
        cal.save(out_path)
    return cal


def resolve_calibration(path: Optional[str] = None
                        ) -> Optional[Calibration]:
    """The configured Calibration (explicit ``path``, else
    ``$REPRO_CALIBRATION``), or None.  Callers with their own built-in
    constants should consult ``.fitted`` — parameters NOT in it carry
    CommModel base defaults, not measurements, and must not displace a
    caller's different built-ins (launch/analytic.py's H100 link
    constants)."""
    source = "argument"
    if not path:
        path = os.environ.get(ENV_CALIBRATION)
        source = f"${ENV_CALIBRATION}"
    if not path:
        return None
    if not os.path.exists(path):
        # an explicitly configured artifact that is missing must not
        # silently degrade to built-in constants — the caller believes
        # they are costing with measured hardware
        raise FileNotFoundError(
            f"calibration artifact {path!r} (from {source}) does not "
            f"exist")
    return Calibration.load(path)


def resolve_comm_model(path: Optional[str] = None, *,
                       default: Optional[CommModel] = None
                       ) -> Optional[CommModel]:
    """The CommModel consumers should cost with: an explicit calibration
    artifact ``path``, else ``$REPRO_CALIBRATION``, else ``default``
    (``None`` default lets callers keep their own built-in constants
    when nothing is calibrated).  Unfitted parameters of the artifact
    equal the CommModel defaults — fine for consumers whose built-ins
    ARE those defaults (the controller, the search); consumers with
    other constants use :func:`resolve_calibration`."""
    cal = resolve_calibration(path)
    return cal.model if cal is not None else default


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("probe_json", help="probe artifact (autotune/probe.py)")
    ap.add_argument("--out", default="calibration.json")
    ap.add_argument("--time-field", default="min_us",
                    choices=("min_us", "warm_us"))
    args = ap.parse_args()
    cal = calibrate_file(args.probe_json, args.out,
                         time_field=args.time_field)
    m = cal.model
    print(f"fitted {cal.fitted} from {cal.n_samples} samples "
          f"(median_rel_err={cal.median_rel_err:.2f}, "
          f"max={cal.max_rel_err:.2f})")
    print(f"  fast_bw={m.fast_bw:.3e} B/s  slow_bw={m.slow_bw:.3e} B/s")
    print(f"  latency={m.latency:.3e} s    compress_bw={m.compress_bw:.3e}"
          f" B/s")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
