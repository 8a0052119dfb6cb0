"""A fitted sklearn RBF-kernel SVC scored on the device (counterpart of
``shm_tpu/models/svm_jax.py``).

A binary SVC is data: support vectors, dual coefficients, an intercept, the
kernel's gamma and, for ``probability=True``, libsvm's two Platt constants.
On the device:

- the kernel matrix ``K[i, j] = exp(-gamma * ||x_i - sv_j||^2)`` through
  ``||x||^2 + ||sv||^2 - 2 x @ sv.T`` (one matmul), then
  ``K @ dual_coef + intercept``, in float32 as in the JAX package;
- ``probability=True``: libsvm's binary probability, the Platt sigmoid
  ``1 / (1 + exp(A f + B))`` of the decision value oriented to libsvm's first
  internal label, clamped to [1e-7, 1 - 1e-7], then libsvm's
  ``multiclass_probability`` coupling for k=2, which stops at
  ``eps = 0.0025`` rather than at the fixed point (100 masked Gauss-Seidel
  sweeps, a sample frozen once it has converged);
- ``CalibratedClassifierCV(SVC(), ensemble=False)``: one calibrator of the
  decision value, a sigmoid ``expit(-(a f + b))`` or isotonic (linear
  interpolation over the fitted thresholds, clamped at the ends).

The exports (:func:`export_svm`, :func:`export_calibrated_svm`) need
sklearn; the support vectors live in the pipeline's transformed space, so
the features go through ``forest.transform_features`` first.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

_MIN_PROB = 1e-7           # libsvm svm_predict_probability: min_prob
_COUPLING_EPS = 0.005 / 2  # libsvm multiclass_probability: eps = 0.005 / k
_COUPLING_ITERS = 100      # libsvm: max_iter = max(100, k)


class RBFSVM(NamedTuple):
    sv: torch.Tensor         # (S, F) support vectors
    dual_coef: torch.Tensor  # (S,) y_i * alpha_i
    intercept: float
    gamma: float
    prob_a: float            # libsvm Platt slope (probA_)
    prob_b: float            # libsvm Platt offset (probB_)
    first_is_cls1: bool      # libsvm's first internal label is classes_[1]


class CalibratedRBFSVM(NamedTuple):
    sv: torch.Tensor
    dual_coef: torch.Tensor
    intercept: float
    gamma: float
    method: str              # "sigmoid" | "isotonic"
    a: float                 # sigmoid slope (0 for isotonic)
    b: float                 # sigmoid offset (0 for isotonic)
    iso_x: torch.Tensor      # isotonic X_thresholds_ (empty for sigmoid)
    iso_y: torch.Tensor      # isotonic y_thresholds_ (empty for sigmoid)


def _coupling_k2(r01: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """libsvm ``multiclass_probability`` for k=2 over a vector of samples:
    libsvm's update order (t=0, then t=1, each sweep), its stopping test
    ``max_t |(Qp)_t - p^T Q p| < eps`` before each sweep, and a converged
    sample frozen while the others go on."""
    r10 = 1.0 - r01
    q00, q01, q11 = r10 * r10, -r10 * r01, r01 * r01
    p0 = torch.full_like(r01, 0.5)
    p1 = torch.full_like(r01, 0.5)
    done = torch.zeros_like(r01, dtype=torch.bool)
    zero = torch.zeros_like(r01)
    for _ in range(_COUPLING_ITERS):
        qp0 = q00 * p0 + q01 * p1
        qp1 = q01 * p0 + q11 * p1
        pqp = p0 * qp0 + p1 * qp1
        err = torch.maximum(torch.abs(qp0 - pqp), torch.abs(qp1 - pqp))
        done = done | (err < _COUPLING_EPS)
        act = ~done
        # t = 0
        d = torch.where(act, (-qp0 + pqp) / q00, zero)
        p0n = p0 + d
        pqp = (pqp + d * (d * q00 + 2 * qp0)) / (1 + d) ** 2
        qp0 = (qp0 + d * q00) / (1 + d)
        qp1 = (qp1 + d * q01) / (1 + d)
        p0, p1 = p0n / (1 + d), p1 / (1 + d)
        # t = 1
        d = torch.where(act, (-qp1 + pqp) / q11, zero)
        p1n = p1 + d
        qp0 = (qp0 + d * q01) / (1 + d)
        p0, p1 = p0 / (1 + d), p1n / (1 + d)
    return p0, p1


def _proba_from_decision(f: torch.Tensor, a: float, b: float,
                         first_is_cls1: bool) -> torch.Tensor:
    f_int = f if first_is_cls1 else -f
    r01 = torch.clamp(torch.sigmoid(-(a * f_int + b)), _MIN_PROB, 1.0 - _MIN_PROB)
    p0, p1 = _coupling_k2(r01)
    return p0 if first_is_cls1 else p1


def _base_svc(svc) -> Dict[str, np.ndarray]:
    return {"sv": np.asarray(svc.support_vectors_, np.float32),
            "dual_coef": np.asarray(svc.dual_coef_, np.float32).ravel(),
            "intercept": np.float64(svc.intercept_[0]),
            "gamma": np.float64(svc._gamma)}


def export_svm(model) -> Dict[str, np.ndarray]:
    """The arrays and scalars of a fitted binary ``SVC(kernel="rbf",
    probability=True)``, or of a Pipeline ending in one (the JAX package's
    export, value for value). libsvm's internal label orientation is
    resolved once: both orientations' probabilities (float64, on the host)
    against sklearn's ``predict_proba`` on a few support vectors. Needs
    sklearn."""
    import warnings

    from sklearn.pipeline import Pipeline
    from sklearn.svm import SVC

    svc = model.steps[-1][1] if isinstance(model, Pipeline) else model
    if not isinstance(svc, SVC) or svc.kernel != "rbf":
        raise TypeError(f"expected a fitted rbf SVC, got {type(svc)}")
    if len(svc.classes_) != 2:
        raise NotImplementedError("binary SVC only")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)   # probA_ / probB_
        if not hasattr(svc, "probA_") or np.asarray(svc.probA_).size == 0:
            raise ValueError("SVC was not fitted with probability=True")
        prob_a = float(np.asarray(svc.probA_)[0])
        prob_b = float(np.asarray(svc.probB_)[0])
    out = _base_svc(svc)
    probe = out["sv"][: min(16, out["sv"].shape[0])].astype(np.float64)
    f = torch.as_tensor(np.asarray(svc.decision_function(probe), np.float64))
    ref = svc.predict_proba(probe)[:, 1]
    errs = [np.abs(_proba_from_decision(f, prob_a, prob_b, c).numpy() - ref).max()
            for c in (True, False)]
    out.update(prob_a=np.float64(prob_a), prob_b=np.float64(prob_b),
               first_is_cls1=np.bool_(errs[0] <= errs[1]))
    return out


def export_calibrated_svm(model) -> Dict[str, np.ndarray]:
    """The arrays and scalars of a fitted binary
    ``CalibratedClassifierCV(SVC(kernel="rbf"), ensemble=False)``, or of a
    Pipeline ending in one. Needs sklearn."""
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.pipeline import Pipeline
    from sklearn.svm import SVC

    cc = model.steps[-1][1] if isinstance(model, Pipeline) else model
    if not isinstance(cc, CalibratedClassifierCV):
        raise TypeError(f"expected a fitted CalibratedClassifierCV, got {type(cc)}")
    if len(cc.calibrated_classifiers_) != 1:
        raise NotImplementedError(
            "ensemble=False expected (one calibrated classifier, got "
            f"{len(cc.calibrated_classifiers_)})")
    c0 = cc.calibrated_classifiers_[0]
    svc = c0.estimator
    if not isinstance(svc, SVC) or svc.kernel != "rbf":
        raise TypeError(f"expected an rbf SVC base estimator, got {type(svc)}")
    if len(cc.classes_) != 2:
        raise NotImplementedError("binary only")
    cal = c0.calibrators[0]
    out = _base_svc(svc)
    if hasattr(cal, "a_"):                       # _SigmoidCalibration
        out.update(method=np.str_("sigmoid"), a=np.float64(cal.a_),
                   b=np.float64(cal.b_), iso_x=np.zeros(0, np.float32),
                   iso_y=np.zeros(0, np.float32))
    elif hasattr(cal, "X_thresholds_"):          # IsotonicRegression
        out.update(method=np.str_("isotonic"), a=np.float64(0.0),
                   b=np.float64(0.0),
                   iso_x=np.asarray(cal.X_thresholds_, np.float32),
                   iso_y=np.asarray(cal.y_thresholds_, np.float32))
    else:
        raise TypeError(f"unrecognized calibrator {type(cal)}")
    return out


def svm_from_arrays(arrays, device):
    """The :class:`RBFSVM` or :class:`CalibratedRBFSVM` of exported arrays,
    on ``device``."""
    t = lambda k: torch.as_tensor(np.asarray(arrays[k]), dtype=torch.float32,
                                  device=device)
    common = dict(sv=t("sv"), dual_coef=t("dual_coef"),
                  intercept=float(arrays["intercept"]),
                  gamma=float(arrays["gamma"]))
    if "method" in arrays:
        return CalibratedRBFSVM(**common, method=str(arrays["method"]),
                                a=float(arrays["a"]), b=float(arrays["b"]),
                                iso_x=t("iso_x"), iso_y=t("iso_y"))
    return RBFSVM(**common, prob_a=float(arrays["prob_a"]),
                  prob_b=float(arrays["prob_b"]),
                  first_is_cls1=bool(arrays["first_is_cls1"]))


def svm_decision_function(svm, X: torch.Tensor) -> torch.Tensor:
    """sklearn's ``decision_function`` for each row of ``X`` (N, F)."""
    X = X.to(torch.float32)
    x2 = (X ** 2).sum(dim=1, keepdim=True)                  # (N, 1)
    s2 = (svm.sv ** 2).sum(dim=1)[None, :]                  # (1, S)
    d2 = torch.clamp(x2 + s2 - 2.0 * X @ svm.sv.T, min=0.0)
    K = torch.exp(-svm.gamma * d2)                          # (N, S)
    return K @ svm.dual_coef + svm.intercept


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` (``xp`` increasing): ``fp[i-1] + (x -
    xp[i-1]) / dx * (fp[i] - fp[i-1])`` between the two points around each
    ``x``, ``fp[i-1]`` where they (nearly) coincide, ``fp[0]`` / ``fp[-1]``
    outside."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx))
                    * (fp[i] - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def svm_predict_proba(svm, X: torch.Tensor) -> torch.Tensor:
    """p(classes_[1]) for each row of ``X`` on its device: libsvm's
    probability for an :class:`RBFSVM`, the calibrator's for a
    :class:`CalibratedRBFSVM`."""
    f = svm_decision_function(svm, X)
    if isinstance(svm, RBFSVM):
        return _proba_from_decision(f, svm.prob_a, svm.prob_b, svm.first_is_cls1)
    if svm.method == "sigmoid":
        return torch.sigmoid(-(svm.a * f + svm.b))
    return _interp(f, svm.iso_x, svm.iso_y)


__all__ = ["RBFSVM", "CalibratedRBFSVM", "export_svm", "export_calibrated_svm",
           "svm_from_arrays", "svm_decision_function", "svm_predict_proba"]
