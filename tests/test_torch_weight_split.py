"""The weight split of B2-bf16a (``ops/pallas_attention.py``), plain version.

B2-bf16a takes bfloat16 activations and float32 weights, as a bfloat16
model's unfused blocks call it on float32 master weights, and computes
float32-accurate q, k, v on bfloat16 tensor cores by splitting each weight
into three bfloat16 pieces: hi = bf16(w), mid = bf16(w − hi), lo = bf16(w −
hi − mid). These tests hold the plain split (which the kernel is held to bit
for bit on the card, ``tests/test_torch_cuda.py``) to the two facts the
kernel rests on, exactly and in float64: the pieces sum back to w, for
seeded weights and for edge values (signed zeros, tiny and huge magnitudes,
negative values, bfloat16 rounding ties at each piece); and a bfloat16
activation times each piece is exact in float32, the three products summing
to the float64 product with w.
"""

import numpy as np
import pytest
import torch

from hig_tpu_torch.ops.pallas_attention import split_bf16_pieces, weight_pieces

BF16 = torch.bfloat16

# values at the edges of the split: signed zeros; the least normal float32;
# tiny values whose pieces reach bfloat16's subnormals; huge ones below
# bfloat16's overflow; ties of the rounding to bfloat16 at hi (1 + 2^-8,
# 1 + 3 2^-8) and at mid (1 + 2^-9 + 2^-17); negatives of each
EDGES = [0.0, -0.0, 2.0 ** -126, 2.0 ** -100 * (1 + 2.0 ** -23), 2.0 ** -110 * (1 + 2.0 ** -23),
         3e38, -3.38e38, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -9 + 2.0 ** -17,
         -(1.0 + 2.0 ** -8), -(1.0 + 3 * 2.0 ** -8), -(1.0 + 2.0 ** -9 + 2.0 ** -17),
         np.float32(np.pi), -np.float32(1 / 3), 65504.0 + 2.0 ** -7]

WEIGHTS = {
    "edges": lambda: torch.tensor(EDGES, dtype=torch.float32),
    "unit": lambda: torch.from_numpy(np.random.RandomState(0).randn(64, 48).astype(np.float32)),
    "block_init": lambda: torch.from_numpy(
        (np.random.RandomState(1).randn(128, 128) * 128 ** -0.5).astype(np.float32)),
    "wide_range": lambda: torch.from_numpy(
        (np.random.RandomState(2).randn(4096) * 10.0 ** np.random.RandomState(3).uniform(
            -30, 30, 4096)).astype(np.float32)),
}


@pytest.mark.parametrize("case", list(WEIGHTS))
def test_pieces_sum_back_to_the_weight(case):
    w = WEIGHTS[case]()
    hi, mid, lo = split_bf16_pieces(w)
    assert all(p.dtype == BF16 and p.shape == w.shape for p in (hi, mid, lo))
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, w.double()), (w[total != w.double()], total[total != w.double()])
    # each piece is the rounding of what the larger ones leave
    assert torch.equal(hi, w.to(BF16))
    assert torch.equal(mid, (w.double() - hi.double()).float().to(BF16))
    # signed zeros keep their sign in hi
    zeros = w == 0
    assert torch.equal(torch.signbit(hi[zeros]), torch.signbit(w[zeros]))


@pytest.mark.parametrize("case", list(WEIGHTS))
def test_bf16_activation_times_pieces_is_exact(case):
    w = WEIGHTS[case]()
    if case in ("edges", "wide_range"):  # keep the products inside float32's range
        w = w.clamp(-2.0 ** 60, 2.0 ** 60)
        w = torch.where(w.abs() < 2.0 ** -60, torch.zeros_like(w), w)
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(w.shape, generator=gen).to(BF16)
    pieces = split_bf16_pieces(w)
    for p in pieces:  # exact in float32: 8 significant bits times 8
        assert torch.equal((a.float() * p.float()).double(), a.double() * p.double())
    got = sum(a.double() * p.double() for p in pieces)
    assert torch.equal(got, a.double() * w.double())


def test_products_of_rows_match_the_float64_product():
    """A bfloat16 row times a float32 weight, summed over the three pieces'
    products in float64, is the float64 product of the row and the weight
    (each term exact, each sum within float64's 53 bits here)."""
    rs = np.random.RandomState(4)
    w = torch.from_numpy((rs.randn(32, 64) * 64 ** -0.5).astype(np.float32))
    x = torch.from_numpy(rs.randn(7, 64).astype(np.float32)).to(BF16)
    want = x.double() @ w.double().T
    got = sum(x.double() @ p.double().T for p in split_bf16_pieces(w))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-14, atol=0)


def test_weight_pieces_layout():
    """The kernel's layout, (3, 3D, D): piece p (hi, mid, lo) of the rows
    [wq; wk; wv]; on CPU tensors the plain split."""
    rs = np.random.RandomState(6)
    ws = [torch.from_numpy(rs.randn(16, 16).astype(np.float32)) for _ in range(3)]
    pieces = weight_pieces(*ws)
    assert pieces.shape == (3, 48, 16) and pieces.dtype == BF16
    for i, w in enumerate(ws):
        for p, want in enumerate(split_bf16_pieces(w)):
            assert torch.equal(pieces[p, 16 * i:16 * (i + 1)], want)
    assert torch.equal(pieces.double().sum(0), torch.cat(ws).double())
