"""ISW / IRW covariance-mask state (network/cov_settings.py): a copy of
mrfp_tpu/nn/cov_settings.py, host numpy, kept in the port because the port
imports nothing of the JAX package.

Host-side bookkeeping that accumulates the variance-of-covariance over a
statistics pass and selects the "sensitive" off-diagonal entries:

- IRW: fixed mask = all off-diagonal (optionally relaxed by margin). It has
  no ``set_variance_of_covariance``, as in the JAX package, so a statistics
  pass cannot take it (ROADMAP C6; ``models/deepv3_zoo.py::covstat_update``
  says so).
- ISW: 1-D k-means over the flattened variance matrix; everything outside
  the lowest cluster is sensitive; a top-k by variance builds the mask
  (cov_settings.py:52-82).

kmeans1d (a pip dep of the reference, SDG.yml:214) is replaced by a
deterministic Lloyd iteration over sorted values with quantile init — only
the size of the lowest cluster is consumed downstream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mrfp_tpu_torch.utils.profiling import span


def kmeans_1d(values: np.ndarray, k: int, iters: int = 100) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster 1-D values into k clusters; returns (assignments, centroids)
    with clusters ordered by centroid value (kmeans1d convention). Each call
    is an ``isw.kmeans`` span that counts its ``values``."""
    v = np.asarray(values, np.float64).ravel()
    with span("isw.kmeans", values=v.size):
        k = min(k, len(np.unique(v)))
        # quantile init over sorted data
        centroids = np.quantile(v, np.linspace(0, 1, k))
        for _ in range(iters):
            d = np.abs(v[:, None] - centroids[None, :])
            assign = np.argmin(d, axis=1)
            new_c = np.array([v[assign == j].mean() if np.any(assign == j)
                              else centroids[j] for j in range(k)])
            if np.allclose(new_c, centroids):
                break
            centroids = new_c
        order = np.argsort(centroids)
        remap = np.empty_like(order)
        remap[order] = np.arange(k)
        return remap[assign], centroids[order]


class CovMatrixISW:
    """cov_settings.py:16-89."""

    def __init__(self, dim: int, relax_denom: float = 0, clusters: int = 50):
        self.dim = dim
        self.eye = np.eye(dim, dtype=np.float32)
        self.reversal_eye = np.triu(np.ones((dim, dim), np.float32), k=1)
        self.num_off_diagonal = float(self.reversal_eye.sum())
        self.clusters = clusters
        self.margin = 0 if relax_denom == 0 else self.num_off_diagonal // relax_denom
        self.num_sensitive = 0.0
        self.var_matrix: Optional[np.ndarray] = None
        self.count_var_cov = 0
        self.mask_matrix: Optional[np.ndarray] = None

    def get_eye_matrix(self):
        return self.eye, self.reversal_eye

    def set_variance_of_covariance(self, var_cov: np.ndarray):
        var_cov = np.asarray(var_cov, np.float32)
        self.var_matrix = var_cov if self.var_matrix is None \
            else self.var_matrix + var_cov
        self.count_var_cov += 1

    def reset_mask_matrix(self):
        self.mask_matrix = None

    def set_mask_matrix(self):
        assert self.var_matrix is not None, "run a covstat pass first"
        var = (self.var_matrix / self.count_var_cov).ravel()
        if self.margin == 0:
            assign, _c = kmeans_1d(var, self.clusters)
            num_sensitive = int((assign != 0).sum())
        else:
            num_sensitive = int(self.num_off_diagonal - self.margin)
        idx = np.argsort(var)[::-1][:num_sensitive]
        mask = np.zeros(self.dim * self.dim, np.float32)
        mask[idx] = 1
        mask = mask.reshape(self.dim, self.dim)
        if self.mask_matrix is not None:
            self.mask_matrix = (self.mask_matrix.astype(int) &
                                mask.astype(int)).astype(np.float32)
        else:
            self.mask_matrix = mask
        self.num_sensitive = float(self.mask_matrix.sum())
        self.var_matrix = None
        self.count_var_cov = 0

    def get_mask_matrix(self):
        if self.mask_matrix is None:
            self.set_mask_matrix()
        return self.eye, self.mask_matrix, 0, self.num_sensitive


class CovMatrixIRW:
    """cov_settings.py:91-107: fixed all-off-diagonal mask with margin."""

    def __init__(self, dim: int, relax_denom: float = 0):
        self.dim = dim
        self.eye = np.eye(dim, dtype=np.float32)
        self.reversal_eye = np.triu(np.ones((dim, dim), np.float32), k=1)
        self.num_off_diagonal = float(self.reversal_eye.sum())
        self.margin = 0 if relax_denom == 0 \
            else self.num_off_diagonal // relax_denom

    def get_mask_matrix(self):
        return self.eye, self.reversal_eye, self.margin, self.num_off_diagonal
