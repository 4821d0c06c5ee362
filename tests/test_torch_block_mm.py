"""Kernel K3's wrapper on the CPU (`ops/block_mm_cuda.py`): the plain
versions against explicit einsums, the strides it hands the kernel, and
what it refuses. The kernel itself runs only on a card
(tests/test_torch_cuda.py)."""

import pytest
import torch

from dpgo_tpu_torch.manifold import (block_mm, block_mv, proj_tangent,
                                     sym_block_diag_product)
from dpgo_tpu_torch.ops import block_mm_cuda

FORMS = {  # (A transposed, B transposed) of each product form
    "nn": (False, False), "nt": (False, True),
    "tn": (True, False), "tt": (True, True)}
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
       torch.float64: dict(rtol=1e-13, atol=1e-13)}


def _blocks(n, d, dtype, seed, lead=(), tail=None):
    g = torch.Generator().manual_seed(seed)
    shape = tuple(lead) + (n,) + ((d, d) if tail is None else tail)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _t(x):
    return x.transpose(-1, -2)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 24848])
@pytest.mark.parametrize("form", sorted(FORMS) + ["mv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [2, 3])
def test_plain_version_equals_einsum(d, dtype, form, n):
    """block_mm / block_mv on CPU tensors (transposes as views) equal the
    einsum of the same blocks, at ragged batch lengths."""
    A = _blocks(n, d, dtype, 1)
    if form == "mv":
        v = _blocks(n, d, dtype, 2, tail=(d,))
        out = block_mm_cuda.block_mv(A, v)
        ref = torch.einsum("nij,nj->ni", A, v)
    else:
        ta, tb = FORMS[form]
        B = _blocks(n, d, dtype, 2)
        Av, Bv = (_t(A) if ta else A), (_t(B) if tb else B)
        out = block_mm_cuda.block_mm(Av, Bv)
        ref = torch.einsum("nik,nkj->nij", Av.contiguous(), Bv.contiguous())
    assert out.shape == ref.shape and out.dtype == dtype
    torch.testing.assert_close(out, ref, **TOL[dtype])


@pytest.mark.parametrize("form", ["mm", "mv"])
def test_plain_version_broadcasts_batch_shapes(form):
    """A [30, 67] stack against a [67] one (the polish's rigid levels):
    the batch shapes broadcast as the torch product's do."""
    A = _blocks(67, 3, torch.float64, 1, lead=(30,))
    if form == "mv":
        v = _blocks(67, 3, torch.float64, 2, tail=(3,))
        out, ref = (block_mm_cuda.block_mv(A, v),
                    torch.einsum("abij,bj->abi", A, v))
    else:
        B = _blocks(67, 3, torch.float64, 2)
        out, ref = (block_mm_cuda.block_mm(A, B),
                    torch.einsum("abik,bkj->abij", A, B))
    torch.testing.assert_close(out, ref, **TOL[torch.float64])


@pytest.mark.parametrize("kernel", [True, False])
def test_manifold_products_equal_einsum(kernel):
    """manifold.block_mm / block_mv / sym_block_diag_product / proj_tangent
    over a [N, m, 3, 3] stack, with the kernel route (the plain version on
    the CPU) and without it."""
    R, V, W = (_blocks(7, 3, torch.float64, s, lead=(2,)) for s in (3, 4, 5))
    v = _blocks(7, 3, torch.float64, 6, lead=(2,), tail=(3,))
    tol = TOL[torch.float64]
    torch.testing.assert_close(block_mm(R, _t(V), kernel),
                               torch.einsum("abik,abjk->abij", R, V), **tol)
    torch.testing.assert_close(block_mv(R, v, kernel),
                               torch.einsum("abij,abj->abi", R, v), **tol)
    S = torch.einsum("abki,abkj->abij", V, W)
    S = 0.5 * (S + _t(S))
    torch.testing.assert_close(sym_block_diag_product(R, V, W, kernel),
                               torch.einsum("abik,abkj->abij", R, S), **tol)
    S = torch.einsum("abki,abkj->abij", R, V)
    P = V - torch.einsum("abik,abkj->abij", R, 0.5 * (S + _t(S)))
    torch.testing.assert_close(proj_tangent(R, V, kernel), P, **tol)


@pytest.mark.parametrize("layout,want", [
    ("contiguous", (9, 3, 1)),
    ("transpose", (9, 1, 3)),
    ("broadcast", (0, 3, 1)),
    ("sliced", (9, 3, 1)),
    ("vector", (3, 1, 0)),
    ("column", (9, 3, 0)),
])
def test_strides_handed_to_the_kernel(layout, want):
    """The (batch, row, column) strides the kernel gets: its own for a
    stack whose batch dims collapse to one (transposes and broadcasts
    included), a contiguous copy's for one that does not."""
    A = _blocks(5, 3, torch.float32, 7, lead=(4,))
    x, tail = {
        "contiguous": (A, 2), "transpose": (_t(A), 2),
        "broadcast": (A[:1, :1].expand(4, 5, 3, 3), 2),
        "sliced": (A[:, 1:], 2), "vector": (A[..., 0, :].contiguous(), 1),
        "column": (A[..., :, 0], 1)}[layout]
    y, *strides = block_mm_cuda._strides(x, tail)
    assert tuple(strides) == want
    assert torch.equal(y, x)
    assert (y.data_ptr() == x.data_ptr()) == (layout != "sliced")


@pytest.mark.parametrize("case", [
    "not_square", "d4", "d1", "batch_mismatch", "vector_mismatch",
    "mixed_types", "integers", "no_batch"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    """Blocks that are not d x d, d outside {2, 3}, batch shapes that do
    not broadcast, mixed or non-float types, and a lone matrix raise on
    every device, before any product."""
    f32 = torch.float32
    A3, B3 = _blocks(4, 3, f32, 1), _blocks(4, 3, f32, 2)
    calls = {
        "not_square": lambda: block_mm_cuda.block_mm(
            _blocks(4, 3, f32, 1, tail=(3, 2)), B3),
        "d4": lambda: block_mm_cuda.block_mm(_blocks(4, 4, f32, 1),
                                             _blocks(4, 4, f32, 2)),
        "d1": lambda: block_mm_cuda.block_mv(_blocks(4, 1, f32, 1),
                                             _blocks(4, 1, f32, 2, tail=(1,))),
        "batch_mismatch": lambda: block_mm_cuda.block_mm(A3, B3[:3]),
        "vector_mismatch": lambda: block_mm_cuda.block_mv(
            A3, _blocks(4, 3, f32, 2, tail=(2,))),
        "mixed_types": lambda: block_mm_cuda.block_mm(A3, B3.double()),
        "integers": lambda: block_mm_cuda.block_mm(A3.int(), B3.int()),
        "no_batch": lambda: block_mm_cuda.block_mm(A3[0], B3[0]),
    }
    err = TypeError if case in ("mixed_types", "integers") else ValueError
    with pytest.raises(err):
        calls[case]()
