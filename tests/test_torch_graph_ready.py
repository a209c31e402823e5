"""The port's sampler is ready for CUDA-graph capture, checked on the CPU.

A capture refuses a copy from the host, so the sampling call must make
none once its inputs are on the device:

- the constants that bfloat16 modules round first (as JAX's weak type
  does) are made by a fill (``embeddings.constant``), which equals the
  ``torch.tensor`` it replaces bit for bit, in bfloat16 and float32, and
  each site's bfloat16 output equals the old expression's;
- with ``DiffusionSchedule.on``, ``torch.tensor`` and ``torch.as_tensor``
  counting their calls, DDIM-3, DPM-3 and DDPM-5 calls of ``make_sampler``'s
  sampler (float32 guided, bfloat16 ``fast_ln``, bfloat16 ``--no_eff``)
  make none: the sampler moved the schedule's tables and the grid's
  timesteps to the device when it was made;
- ``make_sampler(..., graph=True)`` on a CPU model runs the eager loop
  (no graph) and gives ``graph=False``'s output bit for bit;
- the launch counters' registry (``utils/graphs.py``) holds every
  wrapper's counters, and a replay's credit adds a capture's counts.

The parity of the samplers with ``hig_tpu`` stays with
``test_torch_samplers.py`` and ``test_torch_bf16_samplers.py``. Tiny
widths, ``torch.set_num_threads(1)``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from hig_tpu_torch.config import ExperimentConfig, model_config
from hig_tpu_torch.data.vocab import CAPS
from hig_tpu_torch.diffusion import gaussian as tg
from hig_tpu_torch.models import embeddings, text_encoder
from hig_tpu_torch.models.embeddings import LN_EPS, Norm, constant, dense, gelu
from hig_tpu_torch.models.interaction_model import InteractionModel
from hig_tpu_torch.models.text_encoder import ClipTextConfig, quick_gelu
from hig_tpu_torch.models.tokenizer import tokenize
from hig_tpu_torch.ops.flash_attention import quadratic_attention
from hig_tpu_torch.train import trainer as tt
from hig_tpu_torch.utils import graphs
from hig_tpu_torch.weights import load_flax_tree, random_flax_tree

TINY = dict(num_layers=1, latent_dim=32, ff_size=64, num_heads=4, num_text_layers=1,
            text_latent_dim=16, text_ff_size=32, text_num_heads=2, diffusion_steps=100)
CLIP = ClipTextConfig(width=32, heads=2, layers=1)
FEATS, T = 263, 8
BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(*shape, dtype=BF16, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32)


def _norm_eps_old(x):
    """``Norm``'s fast_ln forward as it was, eps from ``torch.tensor``."""
    norm = Norm(x.shape[-1], x.dtype, fast_ln=True)
    xs = x.to(norm.dtype)
    var = (xs * xs).float().mean(-1, keepdim=True).to(norm.dtype)
    mu = xs.float().mean(-1, keepdim=True).to(norm.dtype)
    var = torch.clamp(var - mu * mu, min=0.0)
    eps = torch.tensor(LN_EPS, dtype=norm.dtype, device=x.device)
    mul = torch.rsqrt((var + eps).float()).to(norm.dtype)
    return ((x - mu).float() * (mul.float() * norm.weight.float()) + norm.bias.float()).to(
        norm.dtype)


def _text_attention_old(x, in_proj, out_proj, heads):
    """The CLIP tower's bfloat16 attention as it was, the head-dim scale
    from ``torch.tensor``."""
    N, L, D = x.shape
    q, k, v = dense(in_proj, x, BF16).reshape(N, L, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    scale = 1.0 / torch.sqrt(torch.tensor(D // heads, dtype=BF16, device=x.device))
    logits = (q @ k.transpose(-1, -2)) * scale
    logits = logits.masked_fill(~torch.ones((L, L), dtype=torch.bool).tril(), float("-inf"))
    y = embeddings.softmax(logits, -1) @ v
    return dense(out_proj, y.transpose(1, 2).reshape(N, L, D), BF16)


def _quadratic_attention_old(q, k, v, heads):
    """``quadratic_attention`` in bfloat16 as it was."""
    D = q.shape[-1]
    qh, kh, vh = (t.reshape(*t.shape[:-1], heads, D // heads) for t in (q, k, v))
    scale = 1.0 / torch.sqrt(torch.tensor(D // heads, dtype=BF16))
    logits = torch.einsum("...nhd,...mhd->...nmh", qh, kh) * scale
    y = torch.einsum("...nmh,...mhd->...nhd", embeddings.softmax(logits, -2), vh)
    return y.reshape(*y.shape[:-2], D)


def _linears(seed):
    torch.manual_seed(seed)
    return torch.nn.Linear(32, 96), torch.nn.Linear(32, 32)


# site → (its constant, the site through the port, the old expression)
SITES = {
    "norm_eps": (LN_EPS,
                 lambda x: Norm(x.shape[-1], x.dtype, fast_ln=True)(x),
                 _norm_eps_old),
    "gelu_sqrt_half": (math.sqrt(0.5), gelu,
                       lambda x: (0.5 * x) * torch.special.erfc(
                           -x * torch.tensor(math.sqrt(0.5), dtype=x.dtype))),
    "quick_gelu": (1.702, quick_gelu,
                   lambda x: x * (1 / (1 + torch.exp(-(torch.tensor(1.702, dtype=x.dtype) * x))))),
    "text_attention_scale": (16,
                             lambda x: text_encoder._attention(x, *_linears(1), 2, True,
                                                               dtype=BF16),
                             lambda x: _text_attention_old(x, *_linears(1), 2)),
    "quadratic_attention_scale": (16,
                                  lambda x: quadratic_attention(x, x.flip(1), -x, 2),
                                  lambda x: _quadratic_attention_old(x, x.flip(1), -x, 2)),
}


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("site", list(SITES))
def test_capture_safe_constants_equal_the_host_copies(site, dtype):
    value, new, old = SITES[site]
    got, want = constant(value, dtype, "cpu"), torch.tensor(value, dtype=dtype)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape == ()
    assert torch.equal(_bits(got), _bits(want))
    if dtype != BF16:
        return  # the float32 modules take torch's own layers, without the constant
    x = _x(2, 5, 32)
    assert torch.equal(_bits(new(x)), _bits(old(x)))


def _model(variant: str) -> tuple[InteractionModel, float]:
    """A tiny seeded model of ``variant`` (efficient blocks fused) and its
    guidance weight."""
    fields = {"f32_guided": {},
              "bf16_fast_ln": {"compute_dtype": "bfloat16", "fast_ln": True},
              "bf16_no_eff": {"compute_dtype": "bfloat16", "no_eff": True}}[variant]
    guided = variant == "f32_guided"
    cfg = model_config(ExperimentConfig(**TINY, **fields), CLIP)
    cfg = dataclasses.replace(cfg, fused_blocks=cfg.efficient,
                              cond_drop_prob=0.1 if guided else 0.0)
    tree = random_flax_tree(cfg, seed=0)
    return load_flax_tree(InteractionModel(cfg), tree["params"]).eval(), 2.5 if guided else 1.0


def _inputs():
    tokens = torch.from_numpy(tokenize(CAPS).astype(np.int64)[[[3, 4], [10, 11]]])
    return tokens, torch.tensor([8, 5])


# sampler → (the schedule: beta schedule, steps; the ddim/dpm grid)
SAMPLERS = {"ddim": ("linear", 100, 3), "dpm": ("linear", 100, 3), "ddpm": ("cosine", 5, 5)}


@pytest.mark.parametrize("variant", ["f32_guided", "bf16_fast_ln", "bf16_no_eff"])
@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_sampling_copies_nothing_from_the_host(sampler, variant, monkeypatch):
    model, w = _model(variant)
    betas, steps, grid = SAMPLERS[sampler]
    sample = tt.make_sampler(model, tg.make_schedule(tg.named_betas(betas, steps)), T=T,
                             dim_pose=FEATS, sampler=sampler, ddim_steps=grid,
                             guidance_scale=w)
    cond, lengths = _inputs()
    calls = []

    def counting(name, real):
        def fn(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return fn

    monkeypatch.setattr(tg.DiffusionSchedule, "on",
                        counting("DiffusionSchedule.on", tg.DiffusionSchedule.on))
    monkeypatch.setattr(torch, "tensor", counting("torch.tensor", torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", counting("torch.as_tensor", torch.as_tensor))
    out = sample(cond, lengths, generator=torch.Generator().manual_seed(0))
    monkeypatch.undo()
    assert out.shape == (2, 2, T, FEATS) and torch.isfinite(out).all()
    assert calls == []


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_graph_keyword_runs_the_eager_loop_on_the_cpu(sampler):
    model, w = _model("f32_guided")
    betas, steps, grid = SAMPLERS[sampler]
    sched = tg.make_schedule(tg.named_betas(betas, steps))
    cond, lengths = _inputs()
    outs = []
    for graph in (True, False):
        sample = tt.make_sampler(model, sched, T=T, dim_pose=FEATS, sampler=sampler,
                                 ddim_steps=grid, guidance_scale=w, graph=graph)
        gen = torch.Generator().manual_seed(3)
        outs.append((sample(cond, lengths, generator=gen), gen.get_state()))
        assert sample.graphs == {}
    (got, got_state), (want, want_state) = outs
    assert torch.equal(got, want) and torch.equal(got_state, want_state)


def test_launch_counters_are_registered_and_credited(monkeypatch):
    counts = graphs.launch_counts()
    for name in ("fused_attention_block.launches", "fused_attention_block.launches_bf16",
                 "fused_projected_attention.launches", "fused_projected_attention.launches_bf16",
                 "fused_projected_attention.launches_mixed", "fused_efficient_attention.launches",
                 "fused_efficient_attention.launches_bf16", "flash_attention.launches",
                 "flash_attention.launches_bf16", "weight_pieces.launches", "bf16_sum.launches"):
        assert name in counts

    def wrapper():
        pass

    monkeypatch.setattr(graphs, "_COUNTERS", [])
    graphs.counted(wrapper, "launches", "launches_bf16")
    before = graphs.launch_counts()
    wrapper.launches += 16  # what a capture's wrappers count
    delta = graphs._count_delta(graphs.launch_counts(), before)
    assert delta == {"wrapper.launches": 16}
    graphs._set_counts(before)
    for _ in range(3):
        graphs._credit(delta)
    assert (wrapper.launches, wrapper.launches_bf16) == (48, 0)
