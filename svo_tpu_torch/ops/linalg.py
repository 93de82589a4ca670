"""Small-matrix linear algebra with fixed iteration counts.

Port of svo_tpu/ops/linalg.py. The port keeps the same closed-form and
fixed-count algorithms instead of torch.linalg, so that its results agree
with svo_tpu's: the 12x12 null vector of the PnP DLT comes from inverse
iteration, the SO(3) projection from a Newton polar iteration, the GN
solves from an unrolled Cholesky.
"""

from __future__ import annotations

import torch


def _entries(A: torch.Tensor):
    return [[A[..., r, c] for c in range(3)] for r in range(3)]


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched closed-form (adjugate) inverse of (...,3,3)."""
    (a, b, c), (d, e, f), (g, h, i) = _entries(A)
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], dim=-1),
            torch.stack([A21, A22, A23], dim=-1),
            torch.stack([A31, A32, A33], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def det3x3(A: torch.Tensor) -> torch.Tensor:
    (a, b, c), (d, e, f), (g, h, i) = _entries(A)
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def polar3x3(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Closest rotation to (...,3,3) M via scaled Newton polar iteration:
    X <- 0.5 (X s + X^-T / s), s = sqrt(|X^-1| / |X|) (Frobenius). det<0
    inputs are reflected to the det>0 branch."""
    sign = torch.where(det3x3(M) < 0, -1.0, 1.0)
    X = M * sign[..., None, None]
    for _ in range(iters):
        Xinv_T = inv3x3(X).transpose(-1, -2)
        nx = torch.sqrt(torch.sum(X * X, dim=(-1, -2)) + 1e-20)
        ni = torch.sqrt(torch.sum(Xinv_T * Xinv_T, dim=(-1, -2)) + 1e-20)
        s = torch.sqrt(ni / nx)[..., None, None]
        X = 0.5 * (X * s + Xinv_T / s)
    return X


def cholesky_unrolled(B: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of small PD (..., n, n) matrices, column by column,
    no pivoting (callers pass shifted PD matrices). Fills a fresh L in
    place."""
    n = B.shape[-1]
    L = torch.zeros_like(B)
    for j in range(n):
        s = B[..., j, j]
        if j:
            s = s - torch.sum(L[..., j, :j] * L[..., j, :j], dim=-1)
        djj = torch.sqrt(torch.clamp(s, min=1e-20))
        L[..., j, j] = djj
        if j + 1 < n:
            r = B[..., j + 1:, j]
            if j:
                r = r - torch.einsum("...ik,...k->...i", L[..., j + 1:, :j], L[..., j, :j])
            L[..., j + 1:, j] = r / djj[..., None]
    return L


def cho_solve_unrolled(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for small unrolled-Cholesky factors (..., n, n)."""
    n = L.shape[-1]
    y = torch.zeros_like(b)
    for i in range(n):  # forward: L y = b
        s = b[..., i]
        if i:
            s = s - torch.sum(L[..., i, :i] * y[..., :i], dim=-1)
        y[..., i] = s / L[..., i, i]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):  # backward: L^T x = y
        s = y[..., i]
        if i + 1 < n:
            s = s - torch.sum(L[..., i + 1:, i] * x[..., i + 1:], dim=-1)
        x[..., i] = s / L[..., i, i]
    return x


def smallest_eigvec_psd(
    A: torch.Tensor, shift: float = 1e-6, iters: int = 8
) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of a symmetric PSD (..., n, n)
    matrix via inverse iteration: x <- (A + shift*tr(A)/n*I)^-1 x,
    normalised. The shifted matrix is factored once."""
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    B = A + (shift * tr + 1e-12) * torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_unrolled(B)
    x = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    for _ in range(iters):
        y = cho_solve_unrolled(L, x)
        x = y / (torch.linalg.norm(y, dim=-1, keepdim=True) + 1e-20)
    return x


def solve_spd(A: torch.Tensor, b: torch.Tensor, damp: float = 0.0) -> torch.Tensor:
    """Solve small SPD systems (..., n, n) @ x = (..., n): closed form for
    n = 3, an LU solve otherwise. A singular system gives inf/NaN, as
    jnp.linalg.solve does, never an exception: solve_ex skips the check
    that torch.linalg.solve makes (a host sync on the card)."""
    n = A.shape[-1]
    if damp:
        A = A + damp * torch.eye(n, dtype=A.dtype, device=A.device)
    if n == 3:
        return (inv3x3(A) @ b[..., None])[..., 0]
    return torch.linalg.solve_ex(A, b[..., None], check_errors=False)[0][..., 0]
