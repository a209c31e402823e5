"""The GMM max-mixture pose prior of SMPLify (counterpart of
``hig_tpu/smpl/prior.py``): per sample, the minimum over the mixture's
components of 0.5·(x − μ)ᵀ Σ⁻¹ (x − μ) − log(nll_weight). It loads
``gmm_08.pkl`` (the dict of means, covars and weights), or is synthetic
(:func:`synthetic_gmm_prior`, the JAX package's draws).
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

POSE_DIM = 69


@dataclasses.dataclass
class GMMPrior:
    """means (K, 69), precisions (K, 69, 69), nll_weights (K,), float32."""

    means: torch.Tensor
    precisions: torch.Tensor
    nll_weights: torch.Tensor

    def to(self, device) -> "GMMPrior":
        return GMMPrior(self.means.to(device), self.precisions.to(device),
                        self.nll_weights.to(device))

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """pose (..., 69) → the negative log-likelihood (...)."""
        diff = pose[..., None, :] - self.means  # (..., K, 69)
        quad = torch.einsum("...ki,kij,...kj->...k", diff, self.precisions, diff)
        return (0.5 * quad - torch.log(self.nll_weights)).min(dim=-1).values


def from_arrays(means: np.ndarray, covars: np.ndarray, weights: np.ndarray) -> GMMPrior:
    precisions = np.stack([np.linalg.inv(c) for c in covars])
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covars])
    const = (2 * np.pi) ** (POSE_DIM / 2.0)
    nll_weights = weights / (const * (sqrdets / sqrdets.min()))

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return GMMPrior(means=f32(means), precisions=f32(precisions), nll_weights=f32(nll_weights))


def load_gmm_prior(path: str) -> GMMPrior:
    """gmm_08.pkl: a dict of means, covars and weights."""
    with open(path, "rb") as f:
        try:
            gmm = pickle.load(f, encoding="latin1")
        except ModuleNotFoundError as e:
            raise ValueError(f"{path}: a pickled {e.name} object; this loader reads the dict "
                             f"layout (means, covars, weights), not a sklearn mixture") from e
    if not isinstance(gmm, dict):
        raise ValueError(f"{path}: a {type(gmm).__module__}.{type(gmm).__name__}; this loader "
                         f"reads the dict layout (means, covars, weights), not a sklearn "
                         f"mixture")
    return from_arrays(gmm["means"], gmm["covars"], gmm["weights"])


def synthetic_gmm_prior(num_gaussians: int = 8, seed: int = 0) -> GMMPrior:
    """A random prior for tests and asset-free runs (the JAX package's draws)."""
    rng = np.random.RandomState(seed)
    means = 0.1 * rng.randn(num_gaussians, POSE_DIM)
    covars = np.stack([np.eye(POSE_DIM) * (0.2 + 0.1 * rng.rand())
                       for _ in range(num_gaussians)])
    weights = rng.dirichlet(np.ones(num_gaussians))
    return from_arrays(means, covars, weights)
