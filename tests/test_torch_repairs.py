"""Two faults of the PyTorch port, repaired, against hig_tpu on the CPU.

- Every parameter a freshly built port model holds is initialized, as
  JAX's initializers do (normal(1.0) for the positional tables, caption
  embeddings and the evaluator's class token, normal(0.02) and normal(0.01)
  for CLIP's token and positional embeddings): no NaN or Inf, whatever
  memory a build lands on, and each table's spread that of its JAX
  initializer.
- B3-bf16 past 320 rows: a bfloat16 ``--single_transformer`` PIT step over
  a merged timeline of 2 × 162 = 324 rows (a native window of 161), whose
  core is B3-bf16 (its streaming form on the card), against JAX's bfloat16
  einsum route, under ``tests/test_torch_bf16_train.py``'s gates: the loss
  within LOSS_RATIO of the bfloat16 effect, the core left unrounded above
  it (the control that must fail), every gradient within GRAD_RATIO.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.config import ExperimentConfig as JaxConfig
from hig_tpu.diffusion import gaussian as jg
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu.train import trainer as jt
from hig_tpu_torch.config import ExperimentConfig
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models import attention as tatt
from hig_tpu_torch.models.eval_models import (
    EvalModelConfig,
    MotionConsistencyEvalModel,
    MotionEncoder,
)
from hig_tpu_torch.models.interaction_model import (
    InteractionModel,
    ModelConfig,
    SingleModelConfig,
    SingleMotionModel,
)
from hig_tpu_torch.models.text_encoder import ClipTextConfig
from hig_tpu_torch.ops import pallas_attention as pa
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.weights import torch_state_from_flax
from tests.test_torch_bf16_train import (
    BF16,
    GRAD_RATIO,
    LOSS_RATIO,
    TINY2,
    f32,
    jax_exact,
    port_model_for,
    tree_ratio,
)
from tests.test_torch_pipeline import FEATS, JAX_CLIP, rand, t_

SMALL_CLIP = ClipTextConfig(width=64, heads=2, layers=1)
# parameter → the standard deviation of JAX's initializer
INIT_STD = {"sequence_embedding": 1.0, "cap_embedding": 1.0, "cls_input": 1.0,
            "token_embedding": 0.02, "positional_embedding": 0.01}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fresh_models():
    yield "interaction", InteractionModel(ModelConfig(num_layers=1, clip=SMALL_CLIP))
    yield "interaction_cap_id", InteractionModel(ModelConfig(num_layers=1, cap_id=True,
                                                             clip=SMALL_CLIP))
    yield "single_transformer", InteractionModel(
        ModelConfig(num_layers=1, single_transformer=True, clip=SMALL_CLIP))
    yield "single_person", SingleMotionModel(SingleModelConfig(num_layers=1, clip=SMALL_CLIP))
    yield "classifier", MotionEncoder(EvalModelConfig(num_layers=1))
    yield "consistency", MotionConsistencyEvalModel(EvalModelConfig(
        kind="consistency", class_num=2, num_layers=1))


def test_fresh_models_hold_initialized_parameters():
    """Every parameter of each kind of port model is finite after
    construction, twice over (fresh memory each time), and each table JAX
    draws from a normal initializer has its spread."""
    seen = set()
    for _ in range(2):
        for kind, model in _fresh_models():
            for name, p in model.state_dict().items():
                assert torch.isfinite(p).all(), f"{kind}: {name}"
                leaf = name.rsplit(".", 1)[-1]
                if leaf in INIT_STD and p.numel() >= 256:
                    seen.add(leaf)
                    std = float(p.float().std())
                    assert abs(std / INIT_STD[leaf] - 1) < 0.2, (kind, name, std)
    assert seen == set(INIT_STD)


# a native window of 161 frames: T = 162 rows an actor, 324 merged
LONG_T, LONG_B = 162, 2
LONG_LENGTHS = np.array([162, 120], np.int32)


def test_single_transformer_bf16_step_past_320_merged_rows():
    """One bfloat16 --single_transformer PIT step over 324 merged rows (its
    self-attention core B3-bf16) against JAX's einsum route (module doc)."""
    fields = dict(TINY2, num_layers=1, cap_id=True, single_transformer=True)
    jm = model_from_config(JaxConfig(**fields, compute_dtype="bfloat16", use_pallas=False),
                           clip_config=JAX_CLIP)
    _, tree = port_model_for(fields, "float32")
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    cap_ids = np.random.RandomState(0).randint(0, 43, (LONG_B, 2)).astype(np.int32)
    batch = {"motion": jnp.asarray(rand(LONG_B, 2, LONG_T, FEATS, seed=1)),
             "lengths": jnp.asarray(LONG_LENGTHS), "cap_ids": jnp.asarray(cap_ids)}
    rng = jax.random.key(7)
    fn = jax.value_and_grad(jt.make_loss_fn(jm, jg.make_schedule(jg.linear_betas(100)), True),
                            has_aux=True)
    (want_loss, _), g = jax_exact(fn, params, batch, rng)
    want = torch_state_from_flax(jax.tree_util.tree_map(np.asarray, g))
    t_rng, n_rng = jax.random.split(rng)
    t = t_(np.asarray(jax.random.randint(t_rng, (LONG_B,), 0, 100))).long()
    noise = t_(np.asarray(jax.random.normal(n_rng, (LONG_B, 2, LONG_T, FEATS), jnp.float32)))
    tbatch = {"motion": t_(f32(batch["motion"])), "lengths": t_(LONG_LENGTHS).long(),
              "cap_ids": t_(cap_ids).long()}
    seen = []

    def port_step(dtype, core=None):
        model, _ = port_model_for(fields, dtype)
        tt.make_optimizer(ExperimentConfig(**fields), model)
        loss_fn = tt.make_loss_fn(model, tg.make_schedule(tg.linear_betas(100)), True)
        saved = tatt.fused_efficient_attention

        def spy(q, k, v, heads, key_mask=None):
            seen.append(q.shape[-2])
            return (core or saved)(q, k, v, heads, key_mask)

        tatt.fused_efficient_attention = spy
        try:
            if core is not None:
                with torch.no_grad():
                    return float(loss_fn(tbatch, t=t, noise=noise)[0]), None
            loss, _ = tt.compute_grads(model, loss_fn, tbatch, t=t, noise=noise)
        finally:
            tatt.fused_efficient_attention = saved
        return float(loss), {n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None}

    loss32, grads32 = port_step("float32")
    seen.clear()
    loss, grads = port_step("bfloat16")
    assert seen and set(seen) == {2 * LONG_T} and 2 * LONG_T > pa.BF16_MAX_T
    assert pa.b3_bf16_form(2 * LONG_T, 2 * LONG_T) == "stream"
    effect = abs(float(want_loss) - loss32)
    assert effect > 0
    assert abs(loss - float(want_loss)) <= LOSS_RATIO * effect, (loss, float(want_loss), loss32)
    control_loss, _ = port_step("bfloat16", core=lambda q, k, v, heads, key_mask=None: (
        pa.efficient_attention(q.float(), k.float(), v.float(), heads, key_mask.float())
        .to(BF16)))
    assert abs(control_loss - float(want_loss)) > LOSS_RATIO * effect
    assert tree_ratio(grads, want, grads32) <= GRAD_RATIO
