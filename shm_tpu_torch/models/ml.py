"""The classical baselines of the openLAB stage (counterpart of
``shm_tpu/models/ml.py``), and the export files the device path reads.

Five sklearn models attribute an anomalous window's 76 features to a
sensor or a structural fault: CART, a random forest of 400 trees, gradient
boosting and histogram gradient boosting behind a median imputer, and an
RBF SVM behind the imputer and a scaler. They train on the host
(:func:`build_ml_models`, sklearn imported inside); :func:`get_prob_st` is
sklearn's own ``predict_proba``.

On the device they are scored from an export file,
``<name>.export.npz`` beside ``<name>.joblib``: the preprocessing's
statistics, the model's arrays (``models/forest.py``, ``models/svm.py``) and
the sha256 of the joblib it came from. Writing one needs sklearn and joblib
(:func:`write_export`; the port's ``train-ml`` writes it with each joblib,
and ``python -m shm_tpu_torch.models.ml PATH...`` writes it for joblibs or
directories of them); reading one needs numpy and torch only
(:func:`load_export`). A missing export, or one made from other joblib
bytes, raises: nothing falls back to sklearn.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

EXPORT_FORMAT = "shm_tpu_torch.ml_export.v1"
EXPORT_COMMAND = "python -m shm_tpu_torch.models.ml"


def build_ml_models(seed: int = 42,
                    svm_probability: str = "calibrated") -> Dict[str, object]:
    """The five unfitted pipelines, by name. ``svm_probability``:
    ``"calibrated"`` (the default: ``CalibratedClassifierCV(SVC(),
    ensemble=False, method="sigmoid", cv=5)``, sklearn's replacement for
    the deprecated ``probability`` parameter) or ``"svc"`` (the reference's
    ``SVC(probability=True)``)."""
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.ensemble import (
        GradientBoostingClassifier,
        HistGradientBoostingClassifier,
        RandomForestClassifier,
    )
    from sklearn.impute import SimpleImputer
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC
    from sklearn.tree import DecisionTreeClassifier

    if svm_probability == "svc":
        svm_clf = SVC(kernel="rbf", probability=True, class_weight="balanced",
                      random_state=seed)
    elif svm_probability == "calibrated":
        svm_clf = CalibratedClassifierCV(
            SVC(kernel="rbf", class_weight="balanced", random_state=seed),
            ensemble=False, method="sigmoid", cv=5)
    else:
        raise ValueError(f"unknown svm_probability {svm_probability!r} "
                         "(expected 'svc' or 'calibrated')")

    imputer = lambda: SimpleImputer(strategy="median")
    return {
        "cart": Pipeline([
            ("imputer", imputer()),
            ("clf", DecisionTreeClassifier(random_state=seed,
                                           class_weight="balanced")),
        ]),
        "rf": Pipeline([
            ("imputer", imputer()),
            ("clf", RandomForestClassifier(random_state=seed, n_estimators=400,
                                           class_weight="balanced_subsample",
                                           n_jobs=-1)),
        ]),
        "svm_rbf": Pipeline([
            ("imputer", imputer()),
            ("scaler", StandardScaler(with_mean=True, with_std=True)),
            ("clf", svm_clf),
        ]),
        "gb": Pipeline([
            ("imputer", imputer()),
            ("clf", GradientBoostingClassifier(random_state=seed)),
        ]),
        "hgb": HistGradientBoostingClassifier(random_state=seed, max_depth=None,
                                              learning_rate=0.05, max_iter=400),
    }


def get_prob_st(model, X: np.ndarray) -> np.ndarray:
    """p(ST) for each row from sklearn itself; a model without
    ``predict_proba`` min-max scales its ``decision_function``."""
    if hasattr(model, "predict_proba"):
        return np.asarray(model.predict_proba(X))[:, 1].astype(np.float64)
    scores = np.asarray(model.decision_function(X), np.float64)
    lo, hi = scores.min(), scores.max()
    if hi - lo < 1e-12:
        return np.full_like(scores, 0.5)
    return (scores - lo) / (hi - lo)


# ---------------------------------------------------------------------------
# export files
# ---------------------------------------------------------------------------

def export_path(joblib_path: str | Path) -> Path:
    """``<dir>/<name>.export.npz`` beside ``<dir>/<name>.joblib``."""
    p = Path(joblib_path)
    return p.with_name(p.stem + ".export.npz")


def file_sha256(path: str | Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def export_model(model) -> Dict[str, np.ndarray]:
    """Everything the device path needs of a fitted baseline, as numpy: the
    preprocessing (``pre_steps`` and its statistics), ``model_kind``
    (``tree``, ``svm`` or ``calibrated_svm``) and the model's arrays.
    Needs sklearn."""
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.pipeline import Pipeline
    from sklearn.svm import SVC

    from shm_tpu_torch.models.forest import export_ensemble, export_preprocessing
    from shm_tpu_torch.models.svm import export_calibrated_svm, export_svm

    steps, out = export_preprocessing(model)
    est = model.steps[-1][1] if isinstance(model, Pipeline) else model
    if isinstance(est, CalibratedClassifierCV):
        kind, arrays = "calibrated_svm", export_calibrated_svm(model)
    elif isinstance(est, SVC):
        kind, arrays = "svm", export_svm(model)
    else:
        kind, arrays = "tree", export_ensemble(model)
    out.update(arrays)
    out.update(format=np.str_(EXPORT_FORMAT), model_kind=np.str_(kind),
               pre_steps=np.array(steps, dtype=np.str_))
    return out


def write_export(joblib_path: str | Path, model=None) -> Path:
    """Write ``<name>.export.npz`` beside ``joblib_path`` (``model``: the
    fitted model, else loaded from the file), with the joblib's sha256.
    Needs sklearn and joblib. Returns the written path."""
    joblib_path = Path(joblib_path)
    if model is None:
        import joblib

        model = joblib.load(joblib_path)
    out = export_model(model)
    out["joblib_sha256"] = np.str_(file_sha256(joblib_path))
    dest = export_path(joblib_path)
    np.savez_compressed(dest, **out)
    return dest


class MLModel(NamedTuple):
    """A baseline read from its export file, scored on ``device``."""

    name: str
    kind: str                     # "tree" | "svm" | "calibrated_svm"
    pre_steps: Tuple[str, ...]
    pre_arrays: Dict[str, np.ndarray]
    model: object                 # forest.TreeEnsemble or an svm tuple
    device: torch.device

    def transform(self, F: np.ndarray) -> np.ndarray:
        """The pipeline's preprocessing of (N, 76) features, as float32."""
        from shm_tpu_torch.models.forest import transform_features

        return transform_features(self.pre_steps, self.pre_arrays, F)

    def predict_proba(self, F: np.ndarray) -> np.ndarray:
        """p(ST) of each row, computed on the device in float32, returned
        as float64 on the host."""
        from shm_tpu_torch.models.forest import ensemble_predict_proba
        from shm_tpu_torch.models.svm import svm_predict_proba

        if len(F) == 0:
            return np.zeros((0,), np.float64)
        X = torch.from_numpy(self.transform(F)).to(self.device)
        p = (ensemble_predict_proba(self.model, X) if self.kind == "tree"
             else svm_predict_proba(self.model, X))
        return p.cpu().numpy().astype(np.float64)


def load_export(joblib_path: str | Path, device) -> MLModel:
    """The :class:`MLModel` of ``joblib_path``'s export file, on ``device``.
    The export must exist and carry the sha256 of the joblib's bytes;
    otherwise this raises, naming the command that writes it."""
    from shm_tpu_torch.models.forest import TREE_ARRAYS, ensemble_from_arrays
    from shm_tpu_torch.models.svm import svm_from_arrays

    joblib_path = Path(joblib_path)
    dest = export_path(joblib_path)
    how = f"write it with `{EXPORT_COMMAND} {joblib_path}` (needs sklearn)"
    if not dest.exists():
        raise FileNotFoundError(f"no export file {dest} of {joblib_path.name}: "
                                f"{how}")
    with np.load(dest, allow_pickle=False) as z:
        a = {k: z[k] for k in z.files}
    if str(a.get("format")) != EXPORT_FORMAT:
        raise ValueError(f"{dest}: not an export of format {EXPORT_FORMAT}; "
                         f"{how}")
    if not joblib_path.exists():
        raise FileNotFoundError(f"{joblib_path} is missing; {dest} names its "
                                "sha256, so the joblib must stay beside it")
    sha = file_sha256(joblib_path)
    if str(a["joblib_sha256"]) != sha:
        raise ValueError(f"{dest} was exported from other bytes than "
                         f"{joblib_path.name} (sha256 {a['joblib_sha256']}, "
                         f"the file's {sha}): {how}")
    device = torch.device(device)
    kind = str(a["model_kind"])
    steps = tuple(str(s) for s in a["pre_steps"])
    pre = {k: a[k] for k in ("impute_statistics", "scale_mean", "scale_scale")
           if k in a}
    if kind == "tree":
        model = ensemble_from_arrays(
            {k: a[k] for k in TREE_ARRAYS + ("depth", "kind", "base_score")},
            device)
    elif kind in ("svm", "calibrated_svm"):
        model = svm_from_arrays(a, device)
    else:
        raise ValueError(f"{dest}: unknown model_kind {kind!r}")
    return MLModel(joblib_path.stem, kind, steps, pre, model, device)


def ml_predictor(joblib_path: str | Path, host_ml: bool, device):
    """p(ST) of a feature matrix (n, 76) as float64: the model's export file
    on ``device`` (:func:`load_export`), or with ``host_ml`` sklearn's own
    ``predict_proba`` of the joblib (needs sklearn and joblib)."""
    if host_ml:
        import joblib

        mdl = joblib.load(joblib_path)
        return lambda F: get_prob_st(mdl, F)
    return load_export(joblib_path, device).predict_proba


def main(argv=None) -> int:
    """``python -m shm_tpu_torch.models.ml PATH...``: write the export file
    of every joblib named, or found in a directory named."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(f"usage: {EXPORT_COMMAND} JOBLIB_OR_DIR...", file=sys.stderr)
        return 2
    for arg in argv:
        p = Path(arg)
        for jp in (sorted(p.glob("*.joblib")) if p.is_dir() else [p]):
            print(f"[OK] {write_export(jp)}")
    return 0


__all__ = ["build_ml_models", "get_prob_st", "export_path", "file_sha256",
           "export_model", "write_export", "load_export", "MLModel",
           "ml_predictor",
           "EXPORT_FORMAT", "EXPORT_COMMAND", "main"]


if __name__ == "__main__":
    sys.exit(main())
