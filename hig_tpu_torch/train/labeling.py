"""PIT role discovery and pseudo-labels, pipeline stage 1-2 (own copy of
``hig_tpu/train/labeling.py``).

1. Discovery: on the human-annotated clips (actor 1 oriented to the active
   role by ``test_active_anns.json``), the trained PIT model's losses under
   the two caption assignments at t ∈ {830, 860, 890, 920}, 5 noise draws
   each, vote per class which caption the model matches to the annotated
   active actor → pit_labels.json.
2. Labeling: on every training clip, the same comparison with 41 draws per
   t, oriented by the discovery, votes a 0/1 role label per clip →
   pseudo_labels.json (0: actor 1 is active).

Each vote is one denoiser forward over both assignments of the whole batch,
run in eval mode under ``no_grad``: a model with ``fused_blocks`` runs its
self-attention and interaction blocks through the fused-block kernel (B1),
else through B2, and the ``--no_eff`` model through B4. A bfloat16 model
scores on its float32 parameters, as JAX's scorer applies the raw tree:
B1-bf16 on the block weights cast per call, or B2 on bfloat16 activations
with the float32 weights (B2-bf16a); its bfloat16 prediction is held
against the float32 target in float32. The votes are counted on the host,
as in the reference.
"""

from __future__ import annotations

import collections
import json
import os
from typing import Callable

import torch

from hig_tpu_torch.data.dataset import PairDataset, epoch_batches
from hig_tpu_torch.data.vocab import CAP2KEY, CLASSID2CAPS, NUM_CLASSES
from hig_tpu_torch.diffusion import gaussian as g
from hig_tpu_torch.models.embeddings import length_mask
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.train.trainer import per_token_loss
from hig_tpu_torch.weights import reduce_bf16_in_float32

LABEL_T_VALUES = (830, 860, 890, 920)
DISCOVERY_REPEATS = 5
LABELING_REPEATS = 41

NoiseFn = Callable[[tuple], torch.Tensor]  # shape → one standard-normal draw


def make_assignment_scorer(model: InteractionModel, sched: g.DiffusionSchedule):
    """Puts ``model`` in eval mode and returns (encode, score):

      encode(cond_a, cond_b) → (xf_proj, xf_out) of the stacked [A; B]
        assignments, computed once per batch;
      score(motion, lengths, xf_proj, xf_out, t, noise=None, generator=None)
        → (B, 2) summed masked per-token losses of assignment A = (c1, c2)
        and B = (c2, c1) at timestep ``t``; ``noise`` (like motion) is drawn
        from ``generator`` unless given.
    """
    model.eval()
    if model.cfg.dtype != torch.float32:
        reduce_bf16_in_float32()

    @torch.no_grad()
    def encode(cond_a, cond_b):
        return model.encode_text(torch.cat([cond_a, cond_b]))

    @torch.no_grad()
    def score(motion, lengths, xf_proj, xf_out, t, noise=None, generator=None):
        B, _, T, _ = motion.shape
        lengths = lengths.clamp(max=T)
        tt = torch.full((B,), int(t), dtype=torch.int64, device=motion.device)
        if noise is None:
            noise = torch.randn(motion.shape, generator=generator, device=motion.device,
                                dtype=motion.dtype)
        x_t, target = g.training_targets(sched, motion, tt, noise)
        mask = length_mask(lengths, T, motion.dtype)
        # both assignments in one forward: the batch twice against [A; B]
        x2, t2, len2, target2, mask2 = (torch.cat([z, z])
                                        for z in (x_t, tt, lengths, target, mask))
        pred = model.denoise(x2, t2, len2, xf_proj, xf_out)
        sums = (per_token_loss(pred, target2) * mask2[:, None, :]).sum(dim=(1, 2))
        return torch.stack([sums[:B], sums[B:]], dim=1)

    return encode, score


def default_noise(seed: int, device) -> NoiseFn:
    """Draws from one generator seeded by ``seed``, on ``device``."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return lambda shape: torch.randn(shape, generator=generator, device=device)


def _iter_scored_batches(scorer, dataset: PairDataset, batch_size: int, repeats: int,
                         noise_fn: NoiseFn, cap_id: bool, device):
    """Yield (batch, votes): the dataset unshuffled, the last batch wrapped
    round, and per clip the argmin assignment of every (t, repeat)."""
    encode, score = scorer
    for batch in epoch_batches(dataset, batch_size, epoch=0, shuffle=False, drop_last=False):
        cond_a = torch.from_numpy(batch["cap_ids"] if cap_id else batch["tokens"]).long()
        cond_a = cond_a.to(device)
        motion = torch.from_numpy(batch["motion"]).to(device)
        lengths = torch.from_numpy(batch["lengths"]).long().to(device)
        xf_proj, xf_out = encode(cond_a, cond_a.flip(1))  # once per batch
        picks = [score(motion, lengths, xf_proj, xf_out, t, noise=noise_fn(motion.shape))
                 .argmin(dim=1)
                 for t in LABEL_T_VALUES for _ in range(repeats)]
        votes = torch.stack(picks, dim=1).tolist()  # one read-back per batch
        yield batch, votes


def discover_roles(scorer, annotated_dataset: PairDataset, batch_size: int, device,
                   cap_id: bool = False, noise_fn: NoiseFn | None = None,
                   rng_seed: int = 0) -> dict:
    """Stage 1-2a: each class's model-role orientation → the pit_labels
    dict. ``annotated_dataset`` carries the human annotations as its labels,
    so actor 1 is the active one. Noise from ``noise_fn``, else from a
    generator seeded by ``rng_seed``."""
    noise_fn = noise_fn or default_noise(rng_seed, device)
    tallies: dict[int, collections.Counter] = collections.defaultdict(collections.Counter)
    for batch, votes in _iter_scored_batches(scorer, annotated_dataset, batch_size,
                                             DISCOVERY_REPEATS, noise_fn, cap_id, device):
        for i, v in enumerate(votes):
            class_id = int(batch["class_id"][i])
            cap1, cap2 = int(batch["cap_ids"][i][0]), int(batch["cap_ids"][i][1])
            if cap1 == cap2:
                continue  # symmetric class: no role
            for r in v:
                # r == 0: the model matches caption 1 to the annotated active actor
                tallies[class_id][cap1 if r == 0 else cap2] += 1

    roles = {}
    for class_id in range(NUM_CLASSES):
        cap_active, cap_passive = CLASSID2CAPS[class_id]
        if cap_active == cap_passive:
            roles[class_id] = {"category": cap_active}
            continue
        k1, k2 = CAP2KEY[cap_active], CAP2KEY[cap_passive]
        counts = tallies.get(class_id)
        if counts and counts[k2] > counts[k1]:
            active, passive = k2, k1  # the model's convention is inverted
        else:
            active, passive = k1, k2
        roles[class_id] = {"category": cap_active, "active_index": active,
                           "passive_index": passive}
    return roles


def pseudo_label(scorer, dataset: PairDataset, batch_size: int, roles: dict, device,
                 repeats: int = LABELING_REPEATS, cap_id: bool = False,
                 noise_fn: NoiseFn | None = None, rng_seed: int = 1) -> dict:
    """Stage 1-2b: majority-vote 0/1 role labels → {clip name: 0|1}; 0 means
    actor 1 is active (the supervised stage swaps the actors of a 1)."""
    noise_fn = noise_fn or default_noise(rng_seed, device)
    labels: dict[str, int] = {}
    for batch, votes in _iter_scored_batches(scorer, dataset, batch_size, repeats, noise_fn,
                                             cap_id, device):
        for i, v in enumerate(votes):
            class_id = int(batch["class_id"][i])
            role = roles.get(class_id, roles.get(str(class_id), {}))
            if "active_index" not in role:
                labels[batch["names"][i]] = 0  # symmetric class
                continue
            cap1 = int(batch["cap_ids"][i][0])
            expected = 0 if cap1 == role["active_index"] else 1
            outs = [0 if r == expected else 1 for r in v]
            labels[batch["names"][i]] = int(collections.Counter(outs).most_common(1)[0][0])
    return labels


def save_json(obj: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)
