"""The rest of the ``la_op`` family: ``linalg_gemm``, ``potri``, ``trmm``,
``trsm``, ``sumlogdiag``, the diagonal and triangle pack/unpack ops,
``gelqf``, ``syevd``, ``inverse``, ``det``, ``slogdet``, and ``khatri_rao``
and ``moments``.

Counterpart of the JAX package's ``ops/linalg.py`` (``linalg_gemm2``,
``potrf`` and ``syrk`` are in ``ops/tensor.py``): every op works on the
last two axes and batches over the leading ones, ``lower`` selects the
triangle, gemm/trmm/trsm take ``alpha``.  ``torch.linalg`` does the
decompositions (cuSOLVER on the card); autograd differentiates them.
Conventions kept: ``gelqf`` returns (Q, L) with diag(L) ≥ 0, whatever
signs the QR gives; ``syevd`` returns (U, λ) with the eigenvectors in the
rows of U (A = Uᵀ diag(λ) U), not normalised in sign; ``moments`` is the
one-pass E[x²] − E[x]².
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _tri_mask(n, lower, dtype, device):
    r = torch.arange(n, device=device)
    m = r[:, None] >= r[None, :] if lower else r[:, None] <= r[None, :]
    return m.to(dtype)


@register("linalg_gemm")
def linalg_gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0, beta=1.0):
    """alpha · op(A) @ op(B) + beta · C."""
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return alpha * torch.matmul(a, b) + beta * c


@register("linalg_potri")
def linalg_potri(a, lower=True):
    """(L Lᵀ)⁻¹ from the Cholesky factor L (or Uᵀ U from U)."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    inv = torch.linalg.solve_triangular(a, eye, upper=not lower, left=True)
    if lower:
        return inv.transpose(-1, -2) @ inv
    return inv @ inv.transpose(-1, -2)


@register("linalg_trmm")
def linalg_trmm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    """alpha · op(A) @ B (B @ op(A) with ``rightside``), A's selected
    triangle only."""
    a = a * _tri_mask(a.shape[-1], lower, a.dtype, a.device)
    if transpose:
        a = a.transpose(-1, -2)
    return alpha * (b @ a if rightside else a @ b)


@register("linalg_trsm")
def linalg_trsm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    """Solve op(A) X = alpha·B (X op(A) = alpha·B with ``rightside``), A
    triangular."""
    upper = not lower
    if transpose:
        a, upper = a.transpose(-1, -2), lower
    return torch.linalg.solve_triangular(a, alpha * b, upper=upper, left=not rightside)


@register("linalg_sumlogdiag")
def linalg_sumlogdiag(a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


@register("linalg_extractdiag")
def linalg_extractdiag(a, offset=0):
    return torch.diagonal(a, offset=offset, dim1=-2, dim2=-1)


@register("linalg_makediag")
def linalg_makediag(v, offset=0):
    return torch.diag_embed(v, offset=offset, dim1=-2, dim2=-1)


def _trian_indices(n, offset, lower, device):
    if lower:
        return torch.tril_indices(n, n, offset, device=device)
    return torch.triu_indices(n, n, offset, device=device)


@register("linalg_extracttrian")
def linalg_extracttrian(a, offset=0, lower=True):
    """The selected triangle as a vector, row by row."""
    rows, cols = _trian_indices(a.shape[-1], offset, lower, a.device)
    return a[..., rows, cols]


@register("linalg_maketrian")
def linalg_maketrian(v, offset=0, lower=True):
    """The inverse of ``linalg_extracttrian``: a square matrix, zero outside
    the triangle."""
    m = int((-1 + (1 + 8 * v.shape[-1]) ** 0.5) // 2)
    n = m + abs(offset)
    rows, cols = _trian_indices(n, offset, lower, v.device)
    flat = v.new_zeros(v.shape[:-1] + (n * n,))
    idx = (rows * n + cols).expand(*v.shape[:-1], rows.shape[0])
    return flat.scatter(-1, idx, v).reshape(v.shape[:-1] + (n, n))


@register("linalg_gelqf")
def linalg_gelqf(a):
    """A = L Q with Q's rows orthonormal (m ≤ n); returns (Q, L), diag(L) ≥ 0."""
    q2, r2 = torch.linalg.qr(a.transpose(-1, -2))
    q, l = q2.transpose(-1, -2), r2.transpose(-1, -2)
    s = torch.sign(torch.diagonal(l, dim1=-2, dim2=-1))
    s = torch.where(s == 0, torch.ones_like(s), s).to(a.dtype)
    return q * s[..., :, None], l * s[..., None, :]


@register("linalg_syevd")
def linalg_syevd(a):
    """(U, λ) with A = Uᵀ diag(λ) U: eigenvectors in the rows, λ ascending."""
    w, v = torch.linalg.eigh(a)
    return v.transpose(-1, -2), w


@register("linalg_inverse")
def linalg_inverse(a):
    return torch.linalg.inv(a)


@register("linalg_det")
def linalg_det(a):
    return torch.linalg.det(a)


@register("linalg_slogdet")
def linalg_slogdet(a):
    sign, logabs = torch.linalg.slogdet(a)
    return sign, logabs


@register("khatri_rao")
def khatri_rao(*matrices):
    """The column-wise Kronecker product of matrices of one column count."""
    if not matrices:
        raise ValueError("khatri_rao needs at least one matrix")
    out = matrices[0]
    for m in matrices[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("moments")
def moments(data, axes=None, keepdims=False):
    """(mean, variance) over ``axes``, variance the one-pass E[x²] − E[x]²."""
    ax = tuple(axes) if axes is not None else tuple(range(data.ndim))
    mean = data.mean(ax, keepdim=True)
    var = (data * data).mean(ax, keepdim=True) - mean * mean
    if not keepdims:
        mean = mean.squeeze(ax) if ax else mean.reshape(())
        var = var.squeeze(ax) if ax else var.reshape(())
    return mean, var
