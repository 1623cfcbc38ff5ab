"""Vector math core for the ray tracer.

Pure, jit/grad/vmap-safe JAX re-implementations of the reference's vector
kernels (reference: tinygfx/g3d/operations.py:4-162).  Unlike the reference
these functions never mutate their inputs, never emit NaNs from guarded
divisions/sqrts, and are smoothly differentiable away from the physical
branch points (TIR switch, tangential hits).

Conventions preserved from the reference (they are load-bearing for CSG):
  * quadratic solvers return BOTH roots, shape ``(2, n)``
  * a miss (negative discriminant) is encoded as ``+inf`` for both roots
  * the linear case (``a ~ 0``) duplicates the single root ``-c/b``
  * the constant case (``a ~ 0`` and ``b ~ 0``) returns ``(+inf, +inf)``,
    or ``(-inf, +inf)`` when ``c <= 0`` (ray fully inside the solid)
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = [
    "safe_sqrt",
    "safe_normalize",
    "affine_inverse",
    "transform_rays",
    "TRANSFORM_PRECISION",
    "smallest_positive_root",
    "binomial_root",
    "element_wise_dot",
    "reflect",
    "refract",
]

# 4x4 homogeneous transforms are applied at full input precision: on the GPU
# the default f32 matmul precision may run TF32, which keeps 10 mantissa
# bits and would quantize every ray origin/direction/normal to about three
# decimal digits.  The contractions are K=4 — far below tensor-core
# efficiency anyway — so full precision costs nothing measurable while
# keeping the f32 production path at f32 accuracy.
TRANSFORM_PRECISION = lax.Precision.HIGHEST


def transform_rays(tx, x):
    """``tx @ x`` for homogeneous transforms at TRANSFORM_PRECISION.

    ``tx``: (..., 4, 4); ``x``: (..., 4, n) points/vectors/normals.
    """
    return jnp.matmul(tx, x, precision=TRANSFORM_PRECISION)


def affine_inverse(matrices):
    """Closed-form inverse of affine 4x4 homogeneous transforms.

    ``matrices`` is ``(..., 4, 4)`` with last row ``(0, 0, 0, 1)`` (true for
    every transform the builders produce: rotations, translations, scales,
    shears).  The 3x3 block inverts by adjugate/determinant — no LU
    decomposition, so it stays elementwise work that fuses (XLA's generic
    ``linalg.inv`` lowers to an LU decomposition) and differentiates
    smoothly.
    """
    m = jnp.asarray(matrices)
    a = m[..., :3, :3]
    t = m[..., :3, 3]

    # adjugate of the 3x3 block
    def _cof(i0, i1, j0, j1):
        return a[..., i0, j0] * a[..., i1, j1] - a[..., i0, j1] * a[..., i1, j0]

    c00 = _cof(1, 2, 1, 2)
    c01 = -_cof(1, 2, 0, 2)
    c02 = _cof(1, 2, 0, 1)
    c10 = -_cof(0, 2, 1, 2)
    c11 = _cof(0, 2, 0, 2)
    c12 = -_cof(0, 2, 0, 1)
    c20 = _cof(0, 1, 1, 2)
    c21 = -_cof(0, 1, 0, 2)
    c22 = _cof(0, 1, 0, 1)
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02

    adj = jnp.stack(
        (
            jnp.stack((c00, c10, c20), axis=-1),
            jnp.stack((c01, c11, c21), axis=-1),
            jnp.stack((c02, c12, c22), axis=-1),
        ),
        axis=-2,
    )
    a_inv = adj / det[..., None, None]
    t_inv = -jnp.einsum("...ij,...j->...i", a_inv, t, precision=TRANSFORM_PRECISION)

    out = jnp.zeros_like(m)
    out = out.at[..., :3, :3].set(a_inv)
    out = out.at[..., :3, 3].set(t_inv)
    out = out.at[..., 3, 3].set(1.0)
    return out


def _sum_rows(x):
    """``jnp.sum(x, axis=0)`` unrolled over a small static leading axis.

    An explicit row sum is pure elementwise work that XLA fuses into its
    neighbours, with a fixed summation order on every backend.
    """
    total = x[0]
    for i in range(1, x.shape[0]):
        total = total + x[i]
    return total


def _norm_rows(x):
    """``jnp.linalg.norm(x, axis=0)`` via the unrolled row sum."""
    return jnp.sqrt(_sum_rows(x * x))


def safe_sqrt(x):
    """``sqrt(max(0, x))`` with a zero (not inf/NaN) gradient at ``x <= 0``.

    The double-``where`` guards the backward pass: ``grad(sqrt)`` at 0 is
    infinite, which would poison gradients at exactly-tangential hits and at
    the TIR boundary (reference quirk discussed in SURVEY.md section 3.4).
    """
    positive = x > 0
    return jnp.where(positive, jnp.sqrt(jnp.where(positive, x, 1.0)), 0.0)


def safe_normalize(vectors, axis=0, eps=0.0):
    """Normalize vectors along ``axis``; zero vectors stay zero (no NaN).

    The reference divides by the raw norm (tinygfx/g3d/operations.py:125),
    which NaNs on absorbed rays (zero direction).  Dead rays are first-class
    in the masked formulation, so the guard is required.

    The guard must sit on the *sqrt argument*, not only the division:
    ``d sqrt(s)/ds`` at ``s = 0`` is infinite, and ``0 cotangent * inf``
    makes NaN in reverse mode.  That NaN would leak through any broadcast
    scalar shared between dead and living rays (e.g. the refractive index
    n2 in refract), silently poisoning e.g. Sellmeier-coefficient grads.
    """
    vectors = jnp.asarray(vectors)
    if axis == 0 and vectors.ndim >= 1:
        sq = _sum_rows(vectors * vectors)[None]
    else:
        sq = jnp.sum(vectors * vectors, axis=axis, keepdims=True)
    zero = sq <= eps * eps if eps else sq == 0
    norm = jnp.sqrt(jnp.where(zero, 1.0, sq))
    return jnp.where(zero, vectors, vectors / norm)


def smallest_positive_root(a, b, c):
    """Smallest positive root of ``a x^2 + b x + c = 0``; ``+inf`` when none.

    Parity with tinygfx/g3d/operations.py:4-25 (legacy helper kept for its
    test surface).
    """
    a, b, c = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    disc = b**2 - 4 * a * c
    root = safe_sqrt(disc)
    denom = 2 * a + jnp.isclose(a, 0)
    polyroots = jnp.stack(((-b + root), (-b - root))) / denom
    nearest = jnp.where(polyroots[1] >= 0, jnp.min(polyroots, axis=0), polyroots[0])
    return jnp.where((disc >= 0) & (nearest >= 0), nearest, jnp.inf)


def binomial_root(a, b, c, disc=None):
    """Both roots of ``a x^2 + b x + c = 0`` with the CSG edge conventions.

    Parity with tinygfx/g3d/operations.py:28-63; see module docstring for
    the +/-inf encoding.  Returns shape ``(2,) + a.shape``.
    """
    a = jnp.asarray(a, dtype=jnp.result_type(float))
    b = jnp.asarray(b, dtype=a.dtype)
    c = jnp.asarray(c, dtype=a.dtype)
    disc = b**2 - 4 * a * c if disc is None else disc
    linear_cases = jnp.isclose(a, 0)
    root = safe_sqrt(disc)

    denom = 2 * a + linear_cases
    polyroots = jnp.stack(((-b + root), (-b - root))) / denom
    polyroots = jnp.where(disc >= 0, polyroots, jnp.inf)

    # single root for the linear case, duplicated so the hit count stays even.
    # The division is only *live* where (a ~ 0, b !~ 0); everywhere else the
    # denominator is forced to 1 — not just at b == 0 exactly, because a
    # tiny b (e.g. 1e-33 transform residue for on-axis rays) underflows b^2
    # in the backward pass (d/db = c/b^2 -> c/0 = inf), and inf times the
    # where's zero cotangent is NaN.  Values are unchanged: non-live lanes
    # are overridden by the linear/constant-case selects below.
    live_linear = linear_cases & ~jnp.isclose(b, 0)
    linear_root = -c / jnp.where(live_linear, b, 1.0)
    polyroots = jnp.where(linear_cases, linear_root[None], polyroots)

    # constant case: +/-inf encodes "always inside" (c <= 0) vs "never inside"
    # (row-stack rather than .at[].set: static row updates lower to a
    # scatter, which XLA fuses poorly)
    c_terms_only = linear_cases & jnp.isclose(b, 0)
    polyroots = jnp.where(c_terms_only, jnp.inf, polyroots)
    row0 = jnp.where(c_terms_only & (c <= 0), -jnp.inf, polyroots[0])
    return jnp.stack((row0, polyroots[1]))


def element_wise_dot(mat_1, mat_2, axis=0):
    """Column-wise (axis=0) or row-wise (axis=1) dot product of two matrices.

    Parity with tinygfx/g3d/operations.py:66-83.
    """
    mat_1 = jnp.asarray(mat_1)
    mat_2 = jnp.asarray(mat_2)
    if mat_1.ndim == 1:
        return jnp.dot(mat_1, mat_2)
    if axis == 0:
        return _sum_rows(mat_1 * mat_2)
    return jnp.sum(mat_1 * mat_2, axis=axis)


def reflect(vectors, normals):
    """Reflect ``vectors`` across unit ``normals``.

    Supports the same broadcast modes as the reference
    (tinygfx/g3d/operations.py:86-107): single/single, many/single and
    many/many (columns are vectors).
    """
    vectors = jnp.asarray(vectors)
    normals = jnp.asarray(normals)
    if vectors.ndim == 1 and normals.ndim == 1:
        return vectors - normals * 2 * jnp.dot(vectors, normals)
    if normals.ndim == 1:
        dots = jnp.einsum("ij,i->j", vectors, normals, precision=TRANSFORM_PRECISION)
        return vectors - 2 * normals[:, None] * dots
    dots = element_wise_dot(vectors, normals, axis=0)
    return vectors - 2 * normals * dots


def refract(vectors, normals, n1, n2, n_global=1.0):
    """Vector Snell refraction with automatic enter/exit and TIR handling.

    Functional port of tinygfx/g3d/operations.py:110-162:

    * ``v . n > 0`` means the ray is *exiting* the medium: the normal is
      flipped and the destination index becomes ``n_global``.
    * total internal reflection (radicand < 0) returns the reflected vector
      and keeps the incident index ``n1``.

    Returns ``(unit direction (4, n) or (3, n), new per-ray index)``.  Inputs
    are not mutated (reference normalizes the caller's array in place, quirk
    Q7 in SURVEY.md).
    """
    vectors = safe_normalize(jnp.asarray(vectors), axis=0)
    normals = jnp.asarray(normals)
    n1 = jnp.asarray(n1)
    n2 = jnp.asarray(n2)

    cos_theta1_p = element_wise_dot(vectors, normals, axis=0)
    cos_theta1_n = -cos_theta1_p
    exiting = cos_theta1_p > 0

    n2_local = jnp.where(exiting, n_global, n2)
    normals = jnp.where(exiting, -normals, normals)
    r = n1 / n2_local
    cos_theta1 = jnp.where(exiting, cos_theta1_p, cos_theta1_n)

    radicand = 1 - (r**2) * (1 - cos_theta1**2)
    cos_theta2 = safe_sqrt(radicand)

    refracted = jnp.where(
        radicand > 0,
        r * vectors + (r * cos_theta1 - cos_theta2) * normals,
        vectors + 2 * cos_theta1 * normals,
    )
    refracted = safe_normalize(refracted, axis=0)
    n_refracted = jnp.where(radicand > 0, n2_local, n1)
    return refracted, n_refracted
