"""bfloat16 parity of the port's samplers against hig_tpu on the CPU:
``make_sampler`` DDIM, DPM-Solver++(2M), DDPM and guided DDIM (w = 2.5) in
bfloat16, each on one kernel route (rms_norm projected, fused, no_eff,
fast_ln fused), against JAX's ``make_sampler`` (which casts the parameters
to bfloat16 once) from the same x_T and DDPM step noises. The models,
routes and the parity gate are ``test_torch_bf16.py``'s; this file holds
the samplers so that each file runs in under a minute in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hig_tpu.diffusion import gaussian as jg
from hig_tpu.train import trainer as jt
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.train import trainer as tt
from tests.test_torch_bf16 import (
    BF16,
    EXACT_BF16,
    FEATS,
    LENGTHS,
    T,
    assert_bf16_parity,
    cond_tokens,
    route_models,
    t_,
)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SAMPLERS = {  # case → (route, sampler, steps, guidance)
    "ddim_rms_norm": ("rms_norm", "ddim", 3, 1.0),
    "ddim_guided_fused": ("fused", "ddim", 3, 2.5),
    "dpm_no_eff": ("no_eff", "dpm", 3, 1.0),
    "ddpm_fast_ln": ("fast_ln", "ddpm", 50, 1.0),
}


def ddpm_draws(rng, shape, steps):
    """JAX p_sample_loop's draws: x_T from split(rng)[1], then per step
    (rng, noise_rng, pre_rng) = split(rng, 3) and z from noise_rng."""
    rng, init = jax.random.split(rng)
    x_t = np.asarray(jax.random.normal(init, shape, jnp.float32))
    zs = []
    for _ in range(steps):
        rng, noise_rng, _ = jax.random.split(rng, 3)
        zs.append(np.asarray(jax.random.normal(noise_rng, shape, jnp.float32)))
    return x_t, zs


@pytest.mark.parametrize("case", list(SAMPLERS))
def test_sampler_matches_jax(case):
    """``make_sampler`` in bfloat16 against JAX's from the same x_T (and
    DDPM step noises); the state is float32, ε bfloat16 upcast each step.
    DDPM over a 50-step schedule (linear betas up to 0.4)."""
    route, sampler, steps, w = SAMPLERS[case]
    jm16, jm32, params, port16, port32 = route_models(route)
    cond, Tg = cond_tokens(), T
    n_sched = steps if sampler == "ddpm" else 1000
    jsched = jg.make_schedule(jg.linear_betas(n_sched))
    tsched = tg.make_schedule(tg.linear_betas(n_sched))
    rng = jax.random.key(7)
    args = (params, jnp.asarray(cond), jnp.asarray(LENGTHS), rng)
    want = []
    for m, options in ((jm16, EXACT_BF16), (jm32, None)):
        jsample = jt.make_sampler(m, jsched, T=Tg, dim_pose=FEATS, sampler=sampler,
                                  ddim_steps=steps, guidance_scale=w)
        want.append(np.asarray(jsample.lower(*args).compile(compiler_options=options)(*args)))
    x_t, zs = ddpm_draws(rng, (2, 2, Tg, FEATS), steps)
    got = []
    for model in (port16, port32):
        sample = tt.make_sampler(model, tsched, T=Tg, dim_pose=FEATS, sampler=sampler,
                                 ddim_steps=steps, guidance_scale=w)
        got.append(sample(t_(cond).long(), t_(LENGTHS), noise=t_(x_t),
                          step_noise=lambda i: t_(zs[i])))
    assert all(p.dtype == BF16 for p in port16.parameters())
    assert got[0].dtype == torch.float32
    assert_bf16_parity(got[0], want[0], want[1], got[1], ulps=2.0, bf16_out=False)
