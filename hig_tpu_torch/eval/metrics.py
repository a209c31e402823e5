"""Evaluation metric math (own copy of ``hig_tpu/eval/metrics.py``): NumPy
and SciPy on the host over pooled embeddings of at most 512 dimensions,
plus a FID of device tensors through ``torch.linalg.eigh``."""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    d1 = -2 * np.dot(matrix1, matrix2.T)
    d2 = np.sum(np.square(matrix1), axis=1, keepdims=True)
    d3 = np.sum(np.square(matrix2), axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(mat: np.ndarray, top_k: int) -> np.ndarray:
    size = mat.shape[0]
    gt = np.expand_dims(np.arange(size), 1).repeat(size, 1)
    bool_mat = mat == gt
    correct = np.zeros(size, dtype=bool)
    cols = []
    for i in range(top_k):
        correct = correct | bool_mat[:, i]
        cols.append(correct[:, None].copy())
    return np.concatenate(cols, axis=1)


def calculate_R_precision(embedding1: np.ndarray, embedding2: np.ndarray, top_k: int,
                          sum_all: bool = False):
    dist = euclidean_distance_matrix(embedding1, embedding2)
    top_k_mat = calculate_top_k(np.argsort(dist, axis=1), top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(embedding1, embedding2, sum_all: bool = False):
    dist = np.linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_activation_statistics(activations: np.ndarray):
    return np.mean(activations, axis=0), np.cov(activations, rowvar=False)


def calculate_diversity(activation: np.ndarray, diversity_times: int, rng=None) -> float:
    """Mean distance of ``diversity_times`` random pairs (two draws without
    replacement from ``rng``)."""
    if not (activation.ndim == 2 and activation.shape[0] > diversity_times):
        raise ValueError(f"need more than {diversity_times} rows, got {activation.shape}")
    rng = rng or np.random
    n = activation.shape[0]
    first = rng.choice(n, diversity_times, replace=False)
    second = rng.choice(n, diversity_times, replace=False)
    return float(np.linalg.norm(activation[first] - activation[second], axis=1).mean())


def calculate_multimodality(activation: np.ndarray, multimodality_times: int,
                            rng=None) -> float:
    """As :func:`calculate_diversity`, within each class of a (classes, n,
    D) stack."""
    if not (activation.ndim == 3 and activation.shape[1] > multimodality_times):
        raise ValueError(f"need more than {multimodality_times} per class, "
                         f"got {activation.shape}")
    rng = rng or np.random
    n = activation.shape[1]
    first = rng.choice(n, multimodality_times, replace=False)
    second = rng.choice(n, multimodality_times, replace=False)
    return float(np.linalg.norm(activation[:, first] - activation[:, second], axis=2).mean())


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Sutherland-stable FID."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_activations(gen: np.ndarray, gt: np.ndarray) -> float:
    mu1, cov1 = calculate_activation_statistics(gt)
    mu2, cov2 = calculate_activation_statistics(gen)
    return calculate_frechet_distance(mu1, cov1, mu2, cov2)


def frechet_distance_device(mu1: torch.Tensor, sigma1: torch.Tensor, mu2: torch.Tensor,
                            sigma2: torch.Tensor) -> torch.Tensor:
    """FID of tensors on any device without SciPy: tr √(Σ1 Σ2) is the sum of
    the square roots of the eigenvalues of the symmetric √Σ1 Σ2 √Σ1, which
    is similar to Σ1 Σ2."""
    diff = mu1 - mu2
    w1, v1 = torch.linalg.eigh(sigma1)
    sqrt1 = (v1 * torch.sqrt(w1.clamp(min=0.0))) @ v1.T
    w = torch.linalg.eigvalsh(sqrt1 @ sigma2 @ sqrt1)
    tr_covmean = torch.sqrt(w.clamp(min=0.0)).sum()
    return diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2 * tr_covmean


def get_metric_statistics(values: np.ndarray, replication_times: int):
    """mean ± 1.96·σ/√n over replications."""
    mean = np.mean(values, axis=0)
    conf = 1.96 * np.std(values, axis=0) / np.sqrt(replication_times)
    return mean, conf
