"""The assets and inputs of a fit of generated joints, shared by ``python
-m hig_tpu_torch.render_smpl`` and ``serve --fit_smpl``: the SMPL model
(``--smpl_model``, else the synthetic model), the pose prior (a
``gmm_08.pkl`` path, else the synthetic prior), and the joint confidences
of the reference's render path (feet and ankles 1.5)."""

from __future__ import annotations

import os

import numpy as np
import torch

from hig_tpu_torch.smpl.lbs import SMPLModel, load_smpl_model, synthetic_smpl_model
from hig_tpu_torch.smpl.prior import GMMPrior, load_gmm_prior, synthetic_gmm_prior

FEET_ANKLES = [7, 8, 10, 11]


def load_assets(smpl_model: str | None, gmm: str | None, device) -> tuple[SMPLModel, GMMPrior]:
    """(SMPL model, GMM prior) on ``device``; the synthetic ones where a
    path is not given or names no file, as the JAX tools fall back."""
    if smpl_model and os.path.exists(smpl_model):
        model = load_smpl_model(smpl_model)
    else:
        print("WARNING: no SMPL model asset: using a synthetic test model")
        model = synthetic_smpl_model()
    prior = load_gmm_prior(gmm) if gmm and os.path.exists(gmm) else synthetic_gmm_prior()
    return model.to(device), prior.to(device)


def joint_confidences(device) -> torch.Tensor:
    """(22,) ones, 1.5 on the feet and ankles."""
    conf = np.ones(22, np.float32)
    conf[FEET_ANKLES] = 1.5
    return torch.from_numpy(conf).to(device)
