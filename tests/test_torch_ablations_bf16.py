"""bfloat16 parity of the paper's ablation models in the port against
hig_tpu on the CPU, as ``tests/test_torch_bf16.py`` holds the pair model.

The whole denoiser cut to its first layer (the tiny widths' one layer: the
embeddings, every block and the heads) in bfloat16, from float32 x and
bfloat16 conditioning, against JAX's bfloat16 route with the matching
kernels in interpret mode: ``--no_cross_attn`` through B1-bf16 (JAX
``fused_blocks``) and through B2-bf16 (JAX ``use_pallas``), and
``--single_transformer`` over its merged timeline through B2-bf16 (its
layers never fuse) and, ``--no_eff``, through B4-bf16. Each is held to
``test_torch_bf16.py``'s gate: rms(port − JAX bf16) ≤ 0.5 · rms(JAX bf16 −
JAX float32) and a maximum error of 2 bfloat16 ulps of JAX's largest
magnitude, with the port's output bfloat16 and unlike its float32 one.
Beside each, a control route must fail the same rms gate: the route's
kernel replaced by a twin that rounds otherwise than the Pallas kernel —
B1-bf16's without its state's rounding, B2-bf16's with B1-bf16's core
roundings (B2's core is float32), B4-bf16's on float32 upcasts with the
output rounded once.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu import config as jcfg
from hig_tpu.models.interaction_model import InteractionModel as JaxModel
from hig_tpu.models.interaction_model import model_from_config
from hig_tpu_torch.config import ExperimentConfig, model_config
from hig_tpu_torch.models import attention
from hig_tpu_torch.models.interaction_model import InteractionModel, ModelConfig
from hig_tpu_torch.ops import flash_attention as fa
from hig_tpu_torch.ops import fused_block as fb
from hig_tpu_torch.ops import pallas_attention as pa
from hig_tpu_torch.weights import cast_floating, load_flax_tree, random_flax_tree
from tests.test_torch_bf16 import (
    LENGTHS,
    RMS_RATIO,
    assert_bf16_parity,
    denoiser_inputs,
    f32,
    jax_params,
    jax_run,
    jb,
    tb,
)
from tests.test_torch_pipeline import JAX_CLIP, PORT_CLIP, TINY, t_


def _b1_control(*args, **kw):
    return fb.fused_attention_block_plain(*args, **kw, unrounded=("att",))


def _b2_control(*args, **kw):
    return pa.fused_projected_attention_plain(*args, **kw, rounded=pa.CORE_ROUNDINGS)


def _b4_control(q, k, v, *args, **kw):
    return fa.flash_attention_plain(q.float(), k.float(), v.float(), *args, **kw).to(q.dtype)


# variant → (training options, port ModelConfig fields, JAX route fields,
# (the module attribute the route's kernel sits in, its control))
VARIANTS = {
    "no_cross_attn_fused": (dict(no_cross_attn=True), dict(fused_blocks=True),
                            dict(fused_blocks=True, use_pallas=True),
                            ("fused_attention_block", _b1_control)),
    "no_cross_attn_projected": (dict(no_cross_attn=True), dict(), dict(use_pallas=True),
                                ("fused_projected_attention", _b2_control)),
    "single_transformer": (dict(single_transformer=True), dict(fused_blocks=True),
                           dict(fused_blocks=True, use_pallas=True),
                           ("fused_projected_attention", _b2_control)),
    "single_transformer_no_eff": (dict(single_transformer=True, no_eff=True), dict(),
                                  dict(use_pallas=True),
                                  ("flash_attention", _b4_control)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def variant_models(variant: str):
    """(JAX bf16 model on the route's kernels, JAX f32 model, params, port
    bf16 model with its parameters cast, port f32 model) from one tree."""
    opts, port_kw, jax_kw, _ = VARIANTS[variant]
    mcfg = dataclasses.replace(model_config(ExperimentConfig(**TINY, **opts), PORT_CLIP),
                               **port_kw)
    tree = random_flax_tree(mcfg, seed=0)
    jkw = dict(TINY, **opts, **jax_kw)
    f32_kw = dict(jkw, use_pallas=False, fused_blocks=False)
    jmodels = [model_from_config(jcfg.ExperimentConfig(**kw, compute_dtype=dt),
                                 clip_config=JAX_CLIP)
               for kw, dt in ((jkw, "bfloat16"), (f32_kw, "float32"))]
    ports = []
    for dt in ("bfloat16", "float32"):
        model = load_flax_tree(InteractionModel(dataclasses.replace(mcfg, compute_dtype=dt)),
                               tree["params"]).eval()
        ports.append(cast_floating(model, ModelConfig(compute_dtype=dt).dtype))
    return (*jmodels, jax.tree_util.tree_map(jnp.asarray, tree), *ports)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_first_layer_matches_jax_beside_a_failing_control(variant, monkeypatch):
    jm16, jm32, params, port16, port32 = variant_models(variant)
    E, D = port16.cfg.time_embed_dim, port16.cfg.latent_dim
    assert port16.cfg.num_layers == 1
    x, t, xf_proj, xf_out, _, _, _ = denoiser_inputs(E, D)

    def jax_den(model, bf16):
        dt = jnp.bfloat16 if bf16 else jnp.float32
        return jax_run(lambda p, *a: model.apply(p, *a, method=JaxModel.denoise), bf16,
                       jax_params(params, bf16), jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(LENGTHS), jnp.asarray(jb(xf_proj), dt),
                       jnp.asarray(jb(xf_out), dt))

    def port_run(model, bf16):
        cast = tb if bf16 else (lambda a: tb(a).float())
        with torch.no_grad():
            return model.denoise(t_(x), t_(t), t_(LENGTHS), cast(xf_proj), cast(xf_out))

    want, want32 = jax_den(jm16, True), jax_den(jm32, False)
    assert_bf16_parity(port_run(port16, True), want, want32, port_run(port32, False), ulps=2.0)

    name, control = VARIANTS[variant][3]
    monkeypatch.setattr(attention, name, control)
    d, ref = f32(port_run(port16, True)) - f32(want), f32(want) - f32(want32)
    ratio = np.sqrt(np.mean(d ** 2)) / np.sqrt(np.mean(ref ** 2))
    assert ratio > RMS_RATIO, ratio
