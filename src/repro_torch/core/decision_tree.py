"""Rule-based RAQO (paper §V): CART decision trees over the data-resource
space, plus the default Hive/Spark rules (Fig 10) as baselines (the port
of ``repro.core.decision_tree``).

numpy-only CART (gini impurity, axis-aligned splits), as the paper used
sklearn's classifier on switch-point data.  Host code with no device
work: the same ``(X, y)`` gives the reference's splits, thresholds and
predictions.  ``train_raqo_tree`` takes the port's ``HiveSimulator``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class _Node:
    feature: int = -1
    thresh: float = 0.0
    left: Optional["_Node"] = None
    right: Optional["_Node"] = None
    label: int = -1

    @property
    def is_leaf(self) -> bool:
        return self.label >= 0


def _gini(y: np.ndarray) -> float:
    if len(y) == 0:
        return 0.0
    _, counts = np.unique(y, return_counts=True)
    p = counts / len(y)
    return 1.0 - float(np.sum(p * p))


class DecisionTree:
    """CART classifier.  classes: 0 = SMJ, 1 = BHJ (by convention)."""

    def __init__(self, max_depth: int = 6, min_samples: int = 4):
        self.max_depth = max_depth
        self.min_samples = min_samples
        self.root: Optional[_Node] = None
        self.feature_names: Tuple[str, ...] = ()

    def fit(self, X: np.ndarray, y: np.ndarray,
            feature_names: Sequence[str] = ()) -> "DecisionTree":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.int64)
        self.feature_names = tuple(feature_names) or tuple(
            f"f{i}" for i in range(X.shape[1]))
        self.root = self._build(X, y, 0)
        return self

    def _build(self, X, y, depth) -> _Node:
        if depth >= self.max_depth or len(y) < self.min_samples or \
                _gini(y) == 0.0:
            return _Node(label=int(np.bincount(y).argmax()))
        best = None
        base = _gini(y)
        for f in range(X.shape[1]):
            vals = np.unique(X[:, f])
            if len(vals) < 2:
                continue
            threshs = (vals[:-1] + vals[1:]) / 2
            if len(threshs) > 32:     # subsample candidate thresholds
                threshs = threshs[:: max(1, len(threshs) // 32)]
            for t in threshs:
                m = X[:, f] <= t
                nl, nr = m.sum(), (~m).sum()
                if nl == 0 or nr == 0:
                    continue
                g = (nl * _gini(y[m]) + nr * _gini(y[~m])) / len(y)
                gain = base - g
                if best is None or gain > best[0]:
                    best = (gain, f, t, m)
        if best is None or best[0] <= 1e-12:
            return _Node(label=int(np.bincount(y).argmax()))
        _, f, t, m = best
        return _Node(feature=f, thresh=t,
                     left=self._build(X[m], y[m], depth + 1),
                     right=self._build(X[~m], y[~m], depth + 1))

    def predict_one(self, x: Sequence[float]) -> int:
        node = self.root
        while not node.is_leaf:
            node = node.left if x[node.feature] <= node.thresh else node.right
        return node.label

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.array([self.predict_one(row) for row in np.asarray(X)])

    def max_path_len(self) -> int:
        def depth(n: Optional[_Node]) -> int:
            if n is None or n.is_leaf:
                return 0
            return 1 + max(depth(n.left), depth(n.right))
        return depth(self.root)

    def n_nodes(self) -> int:
        def count(n):
            if n is None:
                return 0
            return 1 + count(n.left) + count(n.right)
        return count(self.root)

    def describe(self) -> str:
        lines: List[str] = []

        def walk(n: _Node, indent: int):
            pad = "  " * indent
            if n.is_leaf:
                lines.append(f"{pad}-> {'BHJ' if n.label else 'SMJ'}")
                return
            name = self.feature_names[n.feature]
            lines.append(f"{pad}{name} <= {n.thresh:.3g}?")
            walk(n.left, indent + 1)
            walk(n.right, indent + 1)
        walk(self.root, 0)
        return "\n".join(lines)


# ---------------------- default rules (paper Fig 10) ----------------------- #

def default_hive_rule(ss_gb: float, cs: float = 0, nc: float = 0) -> int:
    """Hive: BHJ iff small side < 10 MB (hive.auto.convert.join threshold)."""
    return 1 if ss_gb < 0.01 else 0


def default_spark_rule(ss_gb: float, cs: float = 0, nc: float = 0) -> int:
    """Spark: BHJ iff small side < 10 MB (autoBroadcastJoinThreshold)."""
    return 1 if ss_gb < 0.01 else 0


def train_raqo_tree(simulator, *, system: str = "hive",
                    max_depth: Optional[int] = None) -> Tuple[DecisionTree,
                                                              np.ndarray,
                                                              np.ndarray]:
    """Train the RAQO decision tree (Fig 11) on simulator switch-point data.
    Returns (tree, X, y).  Max path length targets: 6 (Hive), 7 (Spark)."""
    depth = max_depth or (6 if system == "hive" else 7)
    ss_grid = np.linspace(0.05, 8.0, 24)
    cs_grid = np.arange(1, 11)
    nc_grid = np.arange(5, 45, 5)
    X, y = [], []
    for ss in ss_grid:
        for cs in cs_grid:
            for nc in nc_grid:
                ts = simulator.smj(ss, 74.0, cs, nc)
                tb = simulator.bhj(ss, 74.0, cs, nc)
                X.append((ss, cs, nc))
                y.append(1 if tb < ts else 0)
    X = np.array(X)
    y = np.array(y)
    tree = DecisionTree(max_depth=depth).fit(
        X, y, feature_names=("small_gb", "container_gb", "num_containers"))
    return tree, X, y
