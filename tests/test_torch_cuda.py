"""CUDA kernels of the PyTorch port against their plain versions on the card.

Marked ``cuda``: each test skips without an NVIDIA GPU. The GPU machine has
no JAX, so run this file there without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are the serving path's: 8 caption pairs (N = 16 sequences), T = 91
(and 77 keys where Tq != Tk), D = 512, 8 heads of 64, float32, ragged
lengths; B1 and B4 also at T = 1, 17 and 196, the ragged edges of their
tiles, and B4 with more keys than its shared-memory tile holds.

Tolerances: 1e-4 absolute, since float32 sums run in another order than
cuBLAS's and the block's second LayerNorm rescales the attention output by
1/std; and REL_TOL of the largest magnitude of the plain output, which the
kernels' 3xTF32 products meet and plain TF32 products (the low parts
dropped) miss by more than an order of magnitude.
"""

import pytest
import torch

from hig_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
from hig_tpu_torch.ops.fused_block import (
    BlockWeights,
    fused_attention_block,
    fused_attention_block_plain,
)
from hig_tpu_torch.ops.pallas_attention import (
    efficient_attention,
    fused_efficient_attention,
    fused_projected_attention,
    fused_projected_attention_plain,
)

pytestmark = pytest.mark.cuda
N_PAIRS, T, D, H = 8, 91, 512, 8
TOL = 1e-4
REL_TOL = 3e-5
LENGTHS = (91, 80, 64, 91, 33, 70, 12, 50)  # at T = 91; scaled to other T


def assert_close(got, want):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= TOL, err
    assert err <= REL_TOL * scale, (err, scale)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, T=T):
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen)).to(device)

    w = BlockWeights(*(
        1 + randn(D, std=0.1) if name.endswith("_g") else
        randn(D, D, std=D ** -0.5) if name.startswith("w") else randn(D, std=0.1)
        for name in BlockWeights._fields
    ))
    lengths = torch.tensor([max(1, L * T // 91) for L in LENGTHS], device=device)
    mask = (torch.arange(T, device=device) < lengths[:, None]).float()
    mask = mask[:, None, :].expand(N_PAIRS, 2, T).contiguous()
    return (w, randn(N_PAIRS, 2, T, D), mask, randn(N_PAIRS, 2, 1, D, std=0.5),
            randn(N_PAIRS, 2, 1, D, std=0.5))


@pytest.mark.parametrize("t", [1, 17, T, 196])
@pytest.mark.parametrize("interaction", [False, True], ids=["self", "interaction"])
def test_fused_block_kernel(cuda, interaction, t):
    w, x, mask, scale, shift = _inputs(cuda, t)
    before = fused_attention_block.launches
    got = fused_attention_block(x, mask, scale, shift, w, H, interaction)
    torch.cuda.synchronize()
    assert fused_attention_block.launches == before + 1
    want = fused_attention_block_plain(x, mask, scale, shift, w, H, interaction)
    assert_close(got, want)


@pytest.mark.parametrize("same_source", [True, False], ids=["self", "partner"])
def test_projected_attention_kernel(cuda, same_source):
    w, x, mask, _, _ = _inputs(cuda)
    xn = torch.nn.functional.layer_norm(x, (D,), w.ln_g, w.ln_b, 1e-6)
    kv, kmask = (xn, mask) if same_source else (xn.flip(1).contiguous(),
                                               mask.flip(1).contiguous())
    args = (xn, kv, w.wq, w.bq, w.wk, w.bk, w.wv, w.bv, H, kmask)
    before = fused_projected_attention.launches
    got = fused_projected_attention(*args)
    torch.cuda.synchronize()
    assert fused_projected_attention.launches == before + 1
    assert_close(got, fused_projected_attention_plain(*args))


@pytest.mark.parametrize("t", [1, 17, T, 196])
@pytest.mark.parametrize("case", ["self", "partner", "causal", "tq_ne_tk"])
def test_flash_attention_kernel(cuda, case, t):
    """B4 as the quadratic blocks call it: self-attention reads q, k and v
    in place from one merged (..., T, 3D) product, the interaction block k
    and v from a (..., T, 2D) one with partner=True."""
    w, x, mask, _, _ = _inputs(cuda, t)
    Tk = max(1, t * 77 // 91) if case == "tq_ne_tk" else t
    if case == "partner":
        q = torch.nn.functional.linear(x, w.wq, w.bq)
        k, v = torch.nn.functional.linear(
            x, torch.cat([w.wk, w.wv]), torch.cat([w.bk, w.bv])).chunk(2, dim=-1)
    else:
        q, k, v = torch.nn.functional.linear(
            x, torch.cat([w.wq, w.wk, w.wv]), torch.cat([w.bq, w.bk, w.bv])).chunk(3, dim=-1)
    if case == "tq_ne_tk":
        k, v, mask = k[..., :Tk, :].contiguous(), v[..., :Tk, :].contiguous(), mask[..., :Tk]
    args = (q, k, v, H, mask, case == "causal", case == "partner")
    before = flash_attention.launches
    got = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert_close(got, flash_attention_plain(*args))


@pytest.mark.parametrize("tq,tk,causal,partner", [
    (91, 300, False, False), (91, 300, True, False), (300, 91, True, False),
    (17, 91, True, False), (196, 300, True, True), (300, 600, True, False),
], ids=["tk300", "tk300_causal", "tq300_causal", "tq17_causal", "tq196_tk300_partner",
        "tq300_tk600_causal"])
def test_flash_attention_kernel_key_ranges(cuda, tq, tk, causal, partner):
    """B4 with more keys than one shared-memory tile holds (chunked online
    softmax) and causal with Tq != Tk, with ragged key masks."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((N_PAIRS, 2, n, D), generator=gen).to(cuda) for n in (tq, tk, tk))
    lengths = torch.tensor([max(1, L * tk // 91) for L in LENGTHS], device=cuda)
    mask = (torch.arange(tk, device=cuda) < lengths[:, None]).float()
    mask = mask[:, None, :].expand(N_PAIRS, 2, tk).contiguous()
    args = (q, k, v, H, mask, causal, partner)
    before = flash_attention.launches
    got = flash_attention(*args)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert_close(got, flash_attention_plain(*args))


@pytest.mark.parametrize("Tk", [T, 77])
def test_efficient_attention_kernel(cuda, Tk):
    w, x, mask, _, _ = _inputs(cuda)
    gen = torch.Generator().manual_seed(1)
    k, v = (torch.randn((N_PAIRS, 2, Tk, D), generator=gen).to(cuda) for _ in range(2))
    args = (x, k, v, H, mask[..., :Tk])
    before = fused_efficient_attention.launches
    got = fused_efficient_attention(*args)
    torch.cuda.synchronize()
    assert fused_efficient_attention.launches == before + 1
    assert_close(got, efficient_attention(*args))


def test_kernels_refuse_unsupported_shapes(cuda):
    w, x, mask, scale, shift = _inputs(cuda)
    with pytest.raises(ValueError):  # head dim 32
        fused_attention_block(x, mask, scale, shift, w, 16)
    with pytest.raises(ValueError):  # not contiguous
        fused_attention_block(x.transpose(0, 1), mask, scale, shift, w, H)
    with pytest.raises(ValueError):  # float64
        fused_projected_attention(x.double(), x.double(), w.wq, w.bq, w.wk, w.bk,
                                  w.wv, w.bv, H)
    for kernel in (flash_attention, fused_efficient_attention):
        with pytest.raises(ValueError):  # head dim 32
            kernel(x, x, x, 16, mask)
        with pytest.raises(ValueError):  # float64
            kernel(x.double(), x.double(), x.double(), H, mask)
        with pytest.raises(ValueError):  # rows not evenly spaced
            kernel(x.transpose(0, 1), x.transpose(0, 1), x.transpose(0, 1), H)
    with pytest.raises(ValueError):  # partner without an actor axis of 2
        flash_attention(x[:, 0], x[:, 0], x[:, 0], H, partner=True)
