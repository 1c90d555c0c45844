"""Rule-based RAQO in the port (``repro_torch.core.decision_tree``): the
counterparts of ``tests/test_decision_tree.py``, and parity with the
reference's CART: the same (X, y) give the same tree (every split's
feature and threshold, every leaf's label) and the same predictions, on
``train_raqo_tree``'s switch-point data and on random separable data."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.cost_model import HiveSimulator as RHiveSimulator
from repro.core.decision_tree import DecisionTree as RDecisionTree
from repro.core.decision_tree import train_raqo_tree as rtrain_raqo_tree
from repro_torch.core import (DecisionTree, HiveSimulator, default_hive_rule,
                              default_spark_rule, train_raqo_tree)


def _nodes(tree):
    """Every node in preorder: (feature, threshold, label)."""
    out = []

    def walk(n):
        if n is None:
            return
        out.append((n.feature, n.thresh, n.label))
        walk(n.left)
        walk(n.right)
    walk(tree.root)
    return out


# ------------------------ counterparts of the reference ------------------- #

def test_raqo_tree_beats_default_rule():
    sim = HiveSimulator()
    tree, X, y = train_raqo_tree(sim, system="hive")
    acc = (tree.predict(X) == y).mean()
    base = np.array([default_hive_rule(*r) for r in X])
    base_acc = (base == y).mean()
    assert acc > 0.9
    assert acc > base_acc + 0.15          # Fig 10 vs 11


def test_tree_depth_matches_paper():
    """Paper: 'maximum path length in the RAQO decision trees is 6 for Hive
    and 7 for Spark'."""
    sim = HiveSimulator()
    t_hive, _, _ = train_raqo_tree(sim, system="hive")
    t_spark, _, _ = train_raqo_tree(sim, system="spark")
    assert t_hive.max_path_len() <= 6
    assert t_spark.max_path_len() <= 7


def test_tree_uses_resource_features():
    """RAQO trees must branch on resources, not only data size (Fig 11)."""
    tree, _, _ = train_raqo_tree(HiveSimulator(), system="hive")
    desc = tree.describe()
    assert "container_gb" in desc or "num_containers" in desc


def test_default_rules_threshold():
    assert default_hive_rule(0.005) == 1 and default_hive_rule(0.02) == 0
    assert default_spark_rule(0.005) == 1 and default_spark_rule(0.02) == 0


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 1000))
def test_hypothesis_cart_fits_separable(seed):
    """CART must (near-)perfectly fit an axis-separable labeling (candidate
    thresholds are subsampled, max 32 per feature)."""
    rng = np.random.default_rng(seed)
    X = rng.random((200, 3))
    y = ((X[:, 0] > 0.5) & (X[:, 2] > 0.3)).astype(int)
    tree = DecisionTree(max_depth=4).fit(X, y)
    assert (tree.predict(X) == y).mean() >= 0.97


def test_predict_shapes():
    X = np.array([[0.1, 1, 10], [5.0, 8, 40]])
    tree = DecisionTree(max_depth=2).fit(
        np.array([[0.0, 1, 1], [1.0, 1, 1], [2.0, 1, 1], [3.0, 1, 1]]),
        np.array([1, 1, 0, 0]))
    assert tree.predict(X).shape == (2,)


# ----------------------------- parity ------------------------------------- #

@pytest.mark.parametrize("system", ["hive", "spark"])
def test_raqo_tree_equals_reference(system):
    tree, X, y = train_raqo_tree(HiveSimulator(), system=system)
    rtree, rX, ry = rtrain_raqo_tree(RHiveSimulator(), system=system)
    assert np.array_equal(X, rX) and np.array_equal(y, ry)
    assert _nodes(tree) == _nodes(rtree)
    assert tree.describe() == rtree.describe()
    grid = np.random.default_rng(5).uniform([0, 0, 0], [9, 11, 45],
                                            (500, 3))
    for pts in (X, grid):
        assert np.array_equal(tree.predict(pts), rtree.predict(pts))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("max_depth,min_samples", [(4, 4), (6, 2), (2, 10)])
def test_cart_equals_reference_on_random_data(seed, max_depth, min_samples):
    rng = np.random.default_rng(seed)
    X = rng.random((300, 4))
    X[:, 3] = np.round(X[:, 3] * 5)          # a feature with few values
    y = ((X[:, 0] > 0.4) & (X[:, 2] < 0.7) | (X[:, 3] == 2)).astype(int)
    y[rng.random(300) < 0.05] ^= 1           # label noise
    tree = DecisionTree(max_depth, min_samples).fit(X, y)
    rtree = RDecisionTree(max_depth, min_samples).fit(X, y)
    assert _nodes(tree) == _nodes(rtree)
    assert tree.n_nodes() == rtree.n_nodes()
    assert tree.max_path_len() == rtree.max_path_len()
    Xt = rng.random((200, 4))
    assert np.array_equal(tree.predict(Xt), rtree.predict(Xt))
