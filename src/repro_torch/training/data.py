"""Synthetic classification data: the paper-analog difficulty workload.

`DifficultyDataset` synthesizes the paper's premise that *required network
depth is data-dependent* with a **terminal-marked pointer-chase** task:
each sample is a sequence of (value, pointer, terminal-flag) cells; cell 0
starts a pointer path of per-sample length L ending at a terminal-flagged
cell, and the label is that terminal's value.  Decoy terminals off the path
force actual chain tracing.  A transformer resolves chains by pointer
*doubling* (reach 2^k after k layers), so L controls the depth needed per
sample.  Additive feature noise adds a second, orthogonal difficulty axis.

Pure numpy and deterministic given a seed: the same seeds give the same
arrays as ``repro.training.data.DifficultyDataset``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

FEATURE_DIM = 32  # input feature width of the "features" modality


@dataclasses.dataclass
class DifficultyDataset:
    """Terminal-marked pointer-chase classification with per-sample
    chain-length difficulty, sampled in three bands so each anytime stage
    unlocks a distinct slice of inputs (the paper's easy-sky /
    cluttered-image spectrum, made structural)."""
    num_classes: int = 10
    seq_len: int = 16
    feature_dim: int = FEATURE_DIM
    noise: float = 0.1
    band_probs: tuple = (0.4, 0.3, 0.3)
    bands: tuple = ((1, 2), (3, 5), (7, 11))   # chain-length per band
    # cap: seq_len-1-L must leave >=3 off-path cells for decoy terminals
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        sub = self.feature_dim // 4          # 4 sub-embeddings of this width
        self.pos_emb = rng.normal(size=(self.seq_len, sub)).astype(np.float32)
        self.val_emb = rng.normal(size=(self.num_classes, sub)).astype(np.float32)
        self.term_emb = rng.normal(size=(2, sub)).astype(np.float32)

    def sample(self, n: int, seed: int):
        """Terminal-marked chains: cell 0 starts a pointer path of per-sample
        length L ending at a terminal-flagged cell; label = terminal value.
        Returns dict(inputs={"features"}, labels, difficulty=L)."""
        rng = np.random.default_rng(seed)
        S, C = self.seq_len, self.num_classes
        vals = rng.integers(0, C, size=(n, S))
        band = rng.choice(len(self.bands), size=n, p=self.band_probs)
        lens = np.array([rng.integers(self.bands[b][0], self.bands[b][1] + 1)
                         for b in band])
        ptrs = rng.integers(0, S, size=(n, S))
        term = np.zeros((n, S), np.int64)
        labels = np.zeros(n, np.int64)
        for i in range(n):                    # build one path per sample
            L = int(lens[i])
            perm = 1 + rng.permutation(S - 1)
            path = np.concatenate([[0], perm[:L]])
            for a, b in zip(path[:-1], path[1:]):
                ptrs[i, a] = b
            end = path[-1]
            ptrs[i, end] = end
            term[i, end] = 1
            # decoy terminals off the path: flagged self-loops that are NOT
            # reachable from cell 0 — the network must trace the chain, not
            # just read "the flagged cell"
            decoys = perm[L:L + 3]
            for dcell in decoys:
                ptrs[i, dcell] = dcell
                term[i, dcell] = 1
            # remaining distractors must not self-loop (fake terminals)
            for j in range(S):
                if term[i, j] == 0 and ptrs[i, j] == j:
                    ptrs[i, j] = (j + 1) % S
            labels[i] = vals[i, end]
        sub = self.feature_dim // 4
        x = np.zeros((n, S, self.feature_dim), np.float32)
        x[:, :, :sub] = self.pos_emb[None]
        x[:, :, sub:2 * sub] = self.val_emb[vals]
        x[:, :, 2 * sub:3 * sub] = self.pos_emb[ptrs]
        x[:, :, 3 * sub:] = self.term_emb[term]
        x += self.noise * rng.normal(size=x.shape).astype(np.float32)
        return {
            "inputs": {"features": x},
            "labels": labels.astype(np.int32),
            "difficulty": lens.astype(np.float32),
        }

    def batches(self, n_total: int, batch_size: int, seed: int):
        data = self.sample(n_total, seed)
        for i in range(0, n_total - batch_size + 1, batch_size):
            sl = slice(i, i + batch_size)
            yield {"inputs": {"features": data["inputs"]["features"][sl]},
                   "labels": data["labels"][sl]}

