"""sklearn tree ensembles scored on the device (counterpart of
``shm_tpu/models/forest_jax.py``).

A fitted tree model is data: per tree, per node, the feature tested, the
threshold, the two children, the node's value and where a NaN goes. The
export (:func:`export_ensemble`, which needs sklearn) takes those arrays
out once, padded to the ensemble's largest tree; :func:`ensemble_predict_proba`
descends every tree for every row on the device in ``depth`` gather steps,
in float32 with float32 thresholds, as the JAX package does (a leaf's
feature is -1 and keeps its node). Covered: ``DecisionTreeClassifier``,
``RandomForestClassifier`` (the mean of the trees' class distributions),
``GradientBoostingClassifier`` and ``HistGradientBoostingClassifier``
(binary: the sigmoid of the summed leaf scores plus the baseline). HGB
keeps each node's NaN direction (``missing_go_to_left``); the other trees
never see a NaN (their pipelines impute).

The pipeline's preprocessing (a median imputer, a scaler) runs on the host
in :func:`transform_features`, from the exported statistics, as sklearn's
``transform`` computes it: see there.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class TreeEnsemble(NamedTuple):
    feature: torch.Tensor      # (n_trees, max_nodes) int64; -1 => leaf
    threshold: torch.Tensor    # (n_trees, max_nodes) float32
    left: torch.Tensor         # (n_trees, max_nodes) int64
    right: torch.Tensor        # (n_trees, max_nodes) int64
    value: torch.Tensor        # (n_trees, max_nodes, n_out) float32
    missing_left: torch.Tensor  # (n_trees, max_nodes) bool: a NaN goes left
    depth: int                 # the deepest tree's depth (the descent's steps)
    kind: str                  # "prob" (mean of distributions) | "raw" (sigmoid of sums)
    base_score: float          # the "raw" ensembles' additive offset


# the export's arrays, in the order of TreeEnsemble's first six fields
TREE_ARRAYS = ("feature", "threshold", "left", "right", "value", "missing_left")


def _export_sklearn_tree(tree, n_out: int, normalize: bool) -> tuple:
    t = tree.tree_
    n = t.node_count
    feat = np.where(t.feature < 0, -1, t.feature).astype(np.int32)
    thr = t.threshold.astype(np.float32)
    left = t.children_left.astype(np.int32)
    right = t.children_right.astype(np.int32)
    val = t.value.reshape(n, -1).astype(np.float64)
    if normalize:                   # classifier counts -> class probabilities
        s = val.sum(axis=1, keepdims=True)
        val = val / np.where(s > 0, s, 1.0)
    if val.shape[1] != n_out:
        raise ValueError(f"tree value width {val.shape[1]} != {n_out}")
    ml = getattr(t, "missing_go_to_left", None)
    ml = np.zeros(n, bool) if ml is None else np.asarray(ml, bool)[:n]
    return feat, thr, left, right, val.astype(np.float32), ml, int(t.max_depth)


def _pad_stack(arrs: Sequence[np.ndarray], fill) -> np.ndarray:
    m = max(a.shape[0] for a in arrs)
    out = np.full((len(arrs), m) + arrs[0].shape[1:], fill, arrs[0].dtype)
    for i, a in enumerate(arrs):
        out[i, : a.shape[0]] = a
    return out


def export_ensemble(model) -> Dict[str, np.ndarray]:
    """The arrays and scalars of a fitted sklearn tree model, or of a
    Pipeline ending in one, as numpy (``TREE_ARRAYS`` plus ``depth``,
    ``kind``, ``base_score``): the JAX package's export, value for value.
    Needs sklearn."""
    from sklearn.ensemble import (
        GradientBoostingClassifier,
        HistGradientBoostingClassifier,
        RandomForestClassifier,
    )
    from sklearn.pipeline import Pipeline
    from sklearn.tree import DecisionTreeClassifier

    if isinstance(model, Pipeline):
        model = model.steps[-1][1]
    if isinstance(model, DecisionTreeClassifier):
        trees = [_export_sklearn_tree(model, len(model.classes_), True)]
        kind, base = "prob", 0.0
    elif isinstance(model, RandomForestClassifier):
        trees = [_export_sklearn_tree(e, len(model.classes_), True)
                 for e in model.estimators_]
        kind, base = "prob", 0.0
    elif isinstance(model, GradientBoostingClassifier):
        if len(model.classes_) != 2:
            raise NotImplementedError("binary GB only")
        # binary GB: raw = init + lr * sum(tree outputs)
        base = float(np.ravel(model._raw_predict_init(
            np.zeros((1, model.n_features_in_))))[0])
        trees = [(f, t, l, r, v * model.learning_rate, m, d)
                 for (f, t, l, r, v, m, d) in
                 (_export_sklearn_tree(e, 1, False)
                  for e in model.estimators_[:, 0])]
        kind = "raw"
    elif isinstance(model, HistGradientBoostingClassifier):
        if len(model.classes_) != 2:
            raise NotImplementedError("binary HGB only")
        trees = []
        for preds in model._predictors:
            nodes = preds[0].nodes
            trees.append((
                np.where(nodes["is_leaf"], -1, nodes["feature_idx"]).astype(np.int32),
                nodes["num_threshold"].astype(np.float32),
                nodes["left"].astype(np.int32),
                nodes["right"].astype(np.int32),
                nodes["value"].astype(np.float32)[:, None],
                # HGB routes NaN natively, per node
                nodes["missing_go_to_left"].astype(bool),
                int(nodes["depth"].max()) + 1))
        kind = "raw"
        base = float(model._baseline_prediction.ravel()[0])
    else:
        raise TypeError(f"unsupported model type {type(model)}")

    fills = (-1, 0.0, 0, 0, 0.0, False)
    out = {name: _pad_stack([t[i] for t in trees], fill)
           for i, (name, fill) in enumerate(zip(TREE_ARRAYS, fills))}
    out.update(depth=np.int64(max(t[6] for t in trees)), kind=np.str_(kind),
               base_score=np.float64(base))
    return out


def ensemble_from_arrays(arrays, device) -> TreeEnsemble:
    """The :class:`TreeEnsemble` of exported arrays (``export_ensemble``'s,
    or an export file's), on ``device``."""
    dt = {"threshold": torch.float32, "value": torch.float32,
          "missing_left": torch.bool}
    t = {k: torch.as_tensor(np.asarray(arrays[k]), device=device).to(
             dt.get(k, torch.int64)) for k in TREE_ARRAYS}
    return TreeEnsemble(**t, depth=int(arrays["depth"]),
                        kind=str(arrays["kind"]),
                        base_score=float(arrays["base_score"]))


def ensemble_predict_proba(ens: TreeEnsemble, X: torch.Tensor) -> torch.Tensor:
    """p(class 1) for each row of ``X`` (N, F), on ``X``'s device (the
    ensemble's). Every tree descends for every row at once: ``depth``
    steps of gathers, a NaN feature taking the node's recorded direction."""
    X = X.to(torch.float32)
    n_trees = ens.feature.shape[0]
    Xt = X.T.contiguous()                                       # (F, N)
    node = torch.zeros(n_trees, X.shape[0], dtype=torch.int64, device=X.device)
    for _ in range(ens.depth):
        f = ens.feature.gather(1, node)                         # (T, N)
        fv = Xt.gather(0, f.clamp(min=0))
        go_left = torch.where(torch.isnan(fv), ens.missing_left.gather(1, node),
                              fv <= ens.threshold.gather(1, node))
        nxt = torch.where(go_left, ens.left.gather(1, node),
                          ens.right.gather(1, node))
        node = torch.where(f < 0, node, nxt)
    n_out = ens.value.shape[-1]
    per_tree = ens.value.gather(1, node[..., None].expand(-1, -1, n_out))
    if ens.kind == "prob":
        return per_tree.mean(dim=0)[:, 1]
    return torch.sigmoid(per_tree[:, :, 0].sum(dim=0) + ens.base_score)


# ---------------------------------------------------------------------------
# the pipeline's preprocessing, on the host
# ---------------------------------------------------------------------------

def export_preprocessing(model) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """The steps before a Pipeline's estimator, as (step names, arrays):
    ``"impute"`` (a ``SimpleImputer`` of NaN: ``impute_statistics``) and
    ``"scale"`` (a ``StandardScaler``: ``scale_mean``, ``scale_scale``, 0
    and 1 where it centers or scales nothing). A bare estimator has none.
    Any other step raises. Needs sklearn."""
    from sklearn.impute import SimpleImputer
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler

    if not isinstance(model, Pipeline):
        return [], {}
    steps, arrays = [], {}
    for name, step in model.steps[:-1]:
        if isinstance(step, SimpleImputer):
            stats = np.asarray(step.statistics_, np.float64)
            if not (isinstance(step.missing_values, float)
                    and np.isnan(step.missing_values)):
                raise NotImplementedError(
                    f"step {name!r}: only NaN is imputed on the device path")
            if np.isnan(stats).any() or step.add_indicator:
                raise NotImplementedError(
                    f"step {name!r}: empty features or a missing indicator")
            steps.append("impute")
            arrays["impute_statistics"] = stats
        elif isinstance(step, StandardScaler):
            n = step.n_features_in_
            mean = step.mean_ if step.with_mean else None
            scale = step.scale_ if step.with_std else None
            steps.append("scale")
            arrays["scale_mean"] = np.asarray(
                np.zeros(n) if mean is None else mean, np.float64)
            arrays["scale_scale"] = np.asarray(
                np.ones(n) if scale is None else scale, np.float64)
        else:
            raise NotImplementedError(
                f"step {name!r}: {type(step).__name__} has no export")
    return steps, arrays


def transform_features(steps: Sequence[str], arrays, X: np.ndarray) -> np.ndarray:
    """``X`` (N, F) through the exported steps, as float32: what sklearn's
    ``transform`` computes on a float32 ``X``. It keeps float32 and casts its
    statistics to float32 (``SimpleImputer`` fills each NaN with its
    column's statistic, ``StandardScaler`` subtracts, then divides, each in
    float32), so the result is its bits and no feature lands on the other
    side of a tree threshold."""
    out = np.array(X, np.float32, copy=True)
    for step in steps:
        if step == "impute":
            stats = np.asarray(arrays["impute_statistics"]).astype(np.float32)
            r, c = np.nonzero(np.isnan(out))
            out[r, c] = stats[c]
        elif step == "scale":
            out -= np.asarray(arrays["scale_mean"]).astype(np.float32)
            out /= np.asarray(arrays["scale_scale"]).astype(np.float32)
        else:
            raise ValueError(f"unknown preprocessing step {step!r}")
    return out


__all__ = ["TreeEnsemble", "TREE_ARRAYS", "export_ensemble",
           "ensemble_from_arrays", "ensemble_predict_proba",
           "export_preprocessing", "transform_features"]
