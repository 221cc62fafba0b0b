"""Latent-Class Hough Forest: trees, splits, forest.

A numpy copy of the JAX package's ``lchf/forest.py`` (the same random
draws in the same order, so two forests trained on equal similarities are
equal node for node, and the same npz layout); a split computes its node's
covariance term once instead of once per candidate.  Reference: cxxLCHF/forest.h.
Faithful behavior:

- ``Tree.train`` (forest.h:212-301): breadth-first; a node becomes a leaf
  at depth ``max_depth`` (32) or with <= ``size_thresh`` (10) samples, or
  when no split attempt achieves positive gain.
- ``split`` (split_linemod, forest.h:303-416): up to ``split_attempts``
  (128) random pivot samples without replacement; similarities of the
  pivot against all node members; candidate thresholds drawn (without
  replacement) from the middle two quartiles of the similarity
  distribution; the best (pivot, threshold) by information gain wins.
  Members with sim <= thresh go left.  The pivot itself (sim = -1) is
  excluded from both children (reference drops it via sims[j] > 0).
- ``info_gain`` (forest.h:418-495, "infos" branch): reduction of
  log2(det(covariance of rpy labels)), with children weighted by size and
  - reproducing a reference quirk - divided by the TOTAL training-set
  size, not the node size.
- ``Forest`` (forest.h:179-210, 514-549): ``max_numtrees`` (5) trees, each
  trained on a random ``train_ratio`` (0.8) subset without replacement.
- ``predict`` (predict_linemod, forest.h:497-512): walk comparing
  similarity(pivot_feature, sample) <= node threshold.

The similarity oracle is injected as a callable so the same forest code
serves training patches (PatchSet similarity) and scene ROIs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Node:
    issplit: bool = False
    pnode: int = 0
    depth: int = 0
    cnodes: tuple = (0, 0)
    isleafnode: bool = True
    split_feat_idx: int = 0
    simi_thresh: float = 50.0
    ind_feats: Optional[np.ndarray] = None


def _rpy_logdet_var(rpy: np.ndarray) -> float:
    """log2 det of the covariance of (n, 3) rpy rows (forest.h:459-487)."""
    a = rpy - rpy.mean(0, keepdims=True)
    var = a.T @ a / max(len(rpy), 1)
    det = float(np.linalg.det(var))
    return float(np.log2(max(det, 1e-300)))


class Tree:
    def __init__(
        self,
        max_depth: int = 32,
        size_thresh: int = 10,
        split_attempts: int = 128,
        seed: int = 0,
        gain_norm: str = "node",
    ):
        """``gain_norm``: 'node' (standard — children weighted within the
        node) or 'reference' (reproduces forest.h:491-493, which divides
        the weighted child variance by the FULL training-set size; this
        makes deep splits nearly impossible once nodes are small, so trees
        stay shallow — kept for parity experiments)."""
        self.max_depth = max_depth
        self.size_thresh = size_thresh
        self.split_attempts = split_attempts
        self.gain_norm = gain_norm
        self.rng = np.random.default_rng(seed)
        self.nodes: List[Node] = []
        self.id_leafnodes: List[int] = []

    def train(
        self,
        similarity_rows: Callable[[int, np.ndarray], np.ndarray],
        rpy: np.ndarray,
        index: np.ndarray,
        total_count: int,
    ) -> None:
        """Args:
        similarity_rows: f(pivot_global_idx, member_global_idxs) -> sims.
        rpy: (N_total, 3) pose labels.
        index: global sample indices this tree trains on (bagged subset).
        total_count: N_total (for the reference's info-gain divisor).
        """
        root = Node(depth=1, ind_feats=np.asarray(index))
        self.nodes = [root]
        frontier = [0]
        while frontier:
            new_frontier = []
            for n in frontier:
                node = self.nodes[n]
                if node.depth == self.max_depth or len(node.ind_feats) <= self.size_thresh:
                    node.issplit = True
                    node.isleafnode = True
                    continue
                ok, f_idx, lc, rc, thresh = self._split(
                    similarity_rows, rpy, node.ind_feats, total_count
                )
                node.issplit = True
                if not ok:
                    node.isleafnode = True
                    continue
                node.isleafnode = False
                node.split_feat_idx = f_idx
                node.simi_thresh = thresh
                li = len(self.nodes)
                self.nodes.append(Node(pnode=n, depth=node.depth + 1, ind_feats=lc))
                self.nodes.append(Node(pnode=n, depth=node.depth + 1, ind_feats=rc))
                node.cnodes = (li, li + 1)
                new_frontier += [li, li + 1]
            frontier = new_frontier
        self.id_leafnodes = [i for i, nd in enumerate(self.nodes) if nd.isleafnode]

    def _split(self, similarity_rows, rpy, ind_feats, total_count):
        n = len(ind_feats)
        attempts = min(self.split_attempts, n)
        pivot_pool = np.ones(n, bool)
        best = (np.finfo(np.float32).eps, None)  # (gain, payload)
        # The node's own term of every gain, computed once (the JAX copy
        # recomputes it per candidate; the value is the same).
        tv = _rpy_logdet_var(rpy[ind_feats])
        for _ in range(attempts):
            avail = np.nonzero(pivot_pool)[0]
            if len(avail) == 0:
                break
            sel = int(self.rng.choice(avail))
            pivot_pool[sel] = False
            sims = similarity_rows(int(ind_feats[sel]), ind_feats)
            sims = np.asarray(sims, np.float32).copy()
            sims[sel] = -1.0

            order = np.argsort(sims, kind="stable")
            q = len(sims)
            cand_pos = order[q // 4 : q * 3 // 4]
            if len(cand_pos) == 0:
                continue
            attempts2 = min(attempts, len(cand_pos))
            cand_sel = self.rng.permutation(len(cand_pos))[:attempts2]
            for ci in cand_sel:
                thresh = sims[cand_pos[ci]]
                not_self = sims > 0
                left = np.nonzero(not_self & (sims <= thresh))[0]
                right = np.nonzero(not_self & (sims > thresh))[0]
                if len(left) == 0 or len(right) == 0:
                    continue
                gain = self._info_gain(rpy, ind_feats, left, right, total_count, tv)
                if gain > best[0]:
                    best = (gain, (sel, left, right, thresh))
        if best[1] is None or best[0] <= np.finfo(np.float32).eps * 10:
            return False, 0, None, None, 0.0
        sel, left, right, thresh = best[1]
        return (
            True,
            int(ind_feats[sel]),
            ind_feats[left],
            ind_feats[right],
            float(thresh),
        )

    def _info_gain(self, rpy, ind_feats, left, right, total_count, tv):
        lv = _rpy_logdet_var(rpy[ind_feats[left]])
        rv = _rpy_logdet_var(rpy[ind_feats[right]])
        denom = total_count if self.gain_norm == "reference" else (len(left) + len(right))
        return tv - (len(left) * lv + len(right) * rv) / max(denom, 1)

    def predict(self, similarity_to: Callable[[int], float]) -> int:
        """Leaf id for one sample; similarity_to(pivot_global_idx) -> sim."""
        cur = 0
        node = self.nodes[0]
        while not node.isleafnode:
            if similarity_to(node.split_feat_idx) <= node.simi_thresh:
                cur = node.cnodes[0]
            else:
                cur = node.cnodes[1]
            node = self.nodes[cur]
        return cur


class Forest:
    """Bagged forest (forest.h:179-210): 5 trees, 0.8 no-replacement."""

    def __init__(self, num_trees: int = 5, train_ratio: float = 0.8, seed: int = 0, **tree_kw):
        self.num_trees = num_trees
        self.train_ratio = train_ratio
        self.trees = [Tree(seed=seed + i, **tree_kw) for i in range(num_trees)]
        self.rng = np.random.default_rng(seed)

    def train(self, similarity_rows, rpy: np.ndarray) -> None:
        n = len(rpy)
        size = int(n * self.train_ratio)
        for tree in self.trees:
            idx = self.rng.permutation(n)[:size]
            tree.train(similarity_rows, rpy, np.sort(idx), n)

    def predict(self, similarity_to) -> List[int]:
        """One leaf id per tree (forest.h:543-549)."""
        return [t.predict(similarity_to) for t in self.trees]

    def leaf_feats_map(self) -> List[Dict[int, np.ndarray]]:
        """tree -> {leaf id: training sample indices}
        (lchf_model::getLeaf_feats_map, forest.cpp:240-252)."""
        return [
            {leaf: t.nodes[leaf].ind_feats for leaf in t.id_leafnodes}
            for t in self.trees
        ]

    # -- persistence (replaces the protobuf files, forest.cpp:30-129) -------

    def save(self, path: str) -> None:
        payload = {
            "meta": np.array(
                [self.num_trees, len(self.trees)], np.int64
            ),
            "train_ratio": np.array([self.train_ratio]),
        }
        for ti, t in enumerate(self.trees):
            rows = []
            for nd in t.nodes:
                rows.append(
                    [
                        int(nd.issplit),
                        nd.pnode,
                        nd.depth,
                        nd.cnodes[0],
                        nd.cnodes[1],
                        int(nd.isleafnode),
                        nd.split_feat_idx,
                    ]
                )
            payload[f"tree{ti}|nodes"] = np.array(rows, np.int64)
            payload[f"tree{ti}|thresh"] = np.array(
                [nd.simi_thresh for nd in t.nodes], np.float32
            )
            for ni, nd in enumerate(t.nodes):
                payload[f"tree{ti}|ind{ni}"] = (
                    nd.ind_feats if nd.ind_feats is not None else np.zeros(0, np.int64)
                )
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str) -> "Forest":
        with np.load(path, allow_pickle=False) as z:
            num_trees = int(z["meta"][1])
            forest = cls(num_trees=num_trees, train_ratio=float(z["train_ratio"][0]))
            for ti in range(num_trees):
                rows = z[f"tree{ti}|nodes"]
                thresh = z[f"tree{ti}|thresh"]
                t = forest.trees[ti]
                t.nodes = []
                for ni, r in enumerate(rows):
                    t.nodes.append(
                        Node(
                            issplit=bool(r[0]),
                            pnode=int(r[1]),
                            depth=int(r[2]),
                            cnodes=(int(r[3]), int(r[4])),
                            isleafnode=bool(r[5]),
                            split_feat_idx=int(r[6]),
                            simi_thresh=float(thresh[ni]),
                            ind_feats=z[f"tree{ti}|ind{ni}"],
                        )
                    )
                t.id_leafnodes = [
                    i for i, nd in enumerate(t.nodes) if nd.isleafnode
                ]
            return forest
