"""Area-weighted reductions and robust statistics used by the physics.

The reference's global renormalizations and diagnostics are cos(lat)-weighted
means (e.g. /root/reference/pygcm/energy.py:518-526, physics.py:318-324,
ocean.py:369-377). Median-of-positives appears in the cloud/precip scaling
(physics.py:299-303, run_simulation.py:1867-1875) and must run on device to
keep the step sync-free.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def area_mean(x: jax.Array, w: jax.Array, mask: jax.Array | None = None) -> jax.Array:
    """Σ x·w / (Σ w + 1e-15); optional boolean mask folds into the weights."""
    if mask is not None:
        w = w * mask
    return jnp.sum(x * w) / (jnp.sum(w) + 1e-15)


# ---------------------------------------------------------------------------
# Compensated (float-float) summation — accumulation islands for the budget
# closure diagnostics. The reference accumulates its global closure sums in
# f64 NumPy (hydrology.py:270-340, energy.py:494-538, routing.py:320-331);
# the model runs f32, where a plain 65k-element tree sum carries ~1e-6
# relative error — the same order as the physical residuals being measured.
# A double-single pairwise reduction keeps ~48 bits through the sum, so the
# emitted f32 scalar is correct to its last ulp and the residual floor is
# set by the model, not the diagnostic.
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    """Knuth TwoSum: s = fl(a+b) and the exact roundoff e (a+b = s+e)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _ff_tree_axis0(hi: jax.Array, lo: jax.Array):
    """Halve-and-TwoSum float-float reduction along axis 0, vectorized over
    the trailing axes. Each level is elementwise over the trailing axes, so
    under SPMD a trailing-sharded operand reduces fully shard-locally."""
    n = hi.shape[0]
    p = 1 << max(0, int(n - 1).bit_length())
    if p != n:
        z = jnp.zeros((p - n,) + hi.shape[1:], hi.dtype)
        hi = jnp.concatenate([hi, z], axis=0)
        lo = jnp.concatenate([lo, z], axis=0)
    while hi.shape[0] > 1:
        h = hi.shape[0] // 2
        s, e = _two_sum(hi[:h], hi[h:])
        t = lo[:h] + lo[h:] + e
        # renormalize so |lo| stays ≤ ulp(hi)
        hi, e2 = _two_sum(s, t)
        lo = e2
    return hi[0], lo[0]


def _ff_tree_axis_last(hi: jax.Array, lo: jax.Array):
    """Halve-and-TwoSum float-float reduction along the LAST axis; every
    level is elementwise over the leading axes, so a leading-sharded operand
    reduces fully shard-locally."""
    n = hi.shape[-1]
    p = 1 << max(0, int(n - 1).bit_length())
    if p != n:
        z = jnp.zeros(hi.shape[:-1] + (p - n,), hi.dtype)
        hi = jnp.concatenate([hi, z], axis=-1)
        lo = jnp.concatenate([lo, z], axis=-1)
    while hi.shape[-1] > 1:
        h = hi.shape[-1] // 2
        s, e = _two_sum(hi[..., :h], hi[..., h:])
        t = lo[..., :h] + lo[..., h:] + e
        hi, e2 = _two_sum(s, t)
        lo = e2
    return hi[..., 0], lo[..., 0]


def sum_compensated(x: jax.Array) -> jax.Array:
    """Float-float pairwise sum of all elements; returns (hi, lo) pair.

    Halve-and-TwoSum tree: log2(n) unrolled levels of vector ops, each
    carrying an exact roundoff channel, renormalized per level. Relative
    error ~2⁻⁴⁸ for f32 input — effectively an f64 accumulator without
    enabling x64. Cost ≈ 2 plain sums (the shrinking levels total ~2n
    elementwise flops, fused by XLA).

    SPMD layout note: on a multi-device runtime a 2-D (lat, lon) field is
    reduced along the UNSHARDED latitude axis first — pure per-column vector
    ops, no cross-shard data motion — leaving one (lon,) row whose final
    tree is the only cross-shard stage (a ~1 KB collective instead of the
    full-field all-gather a raveled global tree would force). Single-device
    runtimes take the flat ravel tree, which XLA fuses tighter
    (tests/test_sharding_collectives.py runs on the 8-device mesh so the
    SPMD property stays locked)."""
    from .. import flags
    if not flags.enabled("QD_FF_SUMS"):
        # A/B bound on the float-float machinery's step cost (accuracy
        # drops to plain-tree ~1e-6 relative — perf experiments only)
        return jnp.sum(x), jnp.zeros((), x.dtype)
    if x.ndim == 0:
        return x, jnp.zeros_like(x)
    if x.size == 0:
        z = jnp.zeros((), x.dtype)
        return z, z
    if x.ndim >= 2 and jax.device_count() > 1:
        # collapse leading (unsharded) axes into axis 0, keep the trailing
        # (possibly sharded) axis intact
        x2 = x.reshape(-1, x.shape[-1])
        hi_row, lo_row = _ff_tree_axis0(x2, jnp.zeros_like(x2))
        # final (lon,) row: a straight halving tree cross-pairs shards at
        # every level (~28 tiny collective-permutes per sum — the dominant
        # permute source of the round-2 audit, ~560/step across ~20 sites).
        # Blocking the row as [n_shards, W/n] makes all but the last ~log(n)
        # levels shard-local: the axis-(-1) tree is elementwise over the
        # sharded axis, and only the final [n] vector ladders across shards.
        n = jax.device_count()
        W = hi_row.shape[0]
        if n > 1 and W % n == 0 and W // n > 1:
            hb = hi_row.reshape(n, W // n)
            lb = lo_row.reshape(n, W // n)
            hi_s, lo_s = _ff_tree_axis_last(hb, lb)
            return _ff_tree_axis0(hi_s, lo_s)
        return _ff_tree_axis0(hi_row, lo_row)
    flat = x.ravel()
    return _ff_tree_axis0(flat, jnp.zeros_like(flat))


def area_mean_compensated(x: jax.Array, w: jax.Array,
                          mask: jax.Array | None = None) -> jax.Array:
    """area_mean with float-float numerator/denominator accumulation.

    Per-element products still round once at working precision (bounded by
    one ulp each, uncorrelated); the summation itself adds nothing. Returns
    a working-precision scalar."""
    dtype = jnp.result_type(x, w)
    x = x.astype(dtype)
    w = w.astype(dtype)
    if mask is not None:
        w = w * mask
    nh, nl = sum_compensated(x * w)
    dh, dl = sum_compensated(w)
    return (nh + nl) / (dh + dl + 1e-15)


def _median_bisect_stats(x: jax.Array):
    """(n_positive, [k1-th, k2-th] order statistics of the positive entries),
    exact, by bisection over their bit patterns.

    Positive IEEE floats order like their bit patterns read as integers, so
    each order statistic is the smallest pattern b with count(x ≤ b) ≥ k+1.
    Each fixed-count pass is one fused compare+count over x; after one pass
    per bit the interval is a single pattern — the statistic itself, equal
    to the sort form's. The native shape is kept, so a lon-sharded field
    bisects with per-shard partial counts + scalar all-reduces."""
    itype = jnp.int64 if x.dtype == jnp.float64 else jnp.int32
    bits = jax.lax.bitcast_convert_type(x, itype)
    pos = x > 0.0
    n = jnp.sum(pos)
    # order statistics (0-indexed): numpy median averages k1=(n-1)//2, k2=n//2
    k = n.astype(jnp.int32)
    k12 = jnp.stack([jnp.maximum((k - 1) // 2, 0), jnp.maximum(k // 2, 0)])
    lo0 = jnp.zeros((2,), itype)
    hi0 = jnp.broadcast_to(jnp.max(jnp.where(pos, bits, 0)), (2,))
    axes = tuple(range(1, x.ndim + 1))

    def body(_, carry):
        lo, hi = carry
        mid = lo + (hi - lo) // 2
        mid_b = mid.reshape((2,) + (1,) * x.ndim)
        cnt = jnp.sum(pos[None] & (bits[None] <= mid_b), axis=axes)
        ge = cnt >= (k12 + 1)
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    iters = 8 * jnp.dtype(itype).itemsize
    lo, hi = jax.lax.fori_loop(0, iters, body, (lo0, hi0.astype(itype)))
    return n, jax.lax.bitcast_convert_type(hi, x.dtype)


@partial(jax.custom_jvp, nondiff_argnums=(1, 2))
def masked_median_of_positive(x: jax.Array, fallback: float = 1e-6,
                              sharded: bool = False) -> jax.Array:
    """Median over strictly positive entries of x; ``fallback`` if none.

    On-device re-expression of ``np.median(x[x > 0])`` (physics.py:299-303),
    exact in both forms. An unsharded field takes one sort
    (:func:`masked_median_of_positive_sort`): on the GPU that measured about
    twice as fast per coupled step as a 34-pass bisection, whose passes are
    each a small reduction kernel. A lon-sharded field (``sharded``: the
    caller's grid has a mesh attached) takes the bit-pattern bisection
    (``_median_bisect_stats``), which reduces shard-locally where a sort
    would all-gather the field; the two return the same value.

    Differentiation: a custom JVP supplies the exact generic-point
    derivative — the median tracks its defining order-statistic element(s),
    so d med = ½·(dx[i₁] + dx[i₂]) with i₁/i₂ the positive elements nearest
    the two middle order statistics (the same element twice for odd counts).
    Autodiff through a bisection loop instead attributes the derivative to
    the MAX element (its only data-dependent input) — wrong at every point —
    and its unrolled 34-select backward graph generated f32 NaNs; both were
    measured before this rule existed (docs/19). The argmin in the JVP
    ravels, so adjoint traces of a lon-sharded field will all-gather —
    adjoints currently run single-device; acceptable.
    """
    with jax.named_scope("precip_median"):
        if not sharded:
            return masked_median_of_positive_sort(x, fallback)
        n, hi = _median_bisect_stats(x)
        return jnp.where(n > 0, 0.5 * (hi[0] + hi[1]),
                         jnp.asarray(fallback, x.dtype))


@masked_median_of_positive.defjvp
def _masked_median_jvp(fallback, sharded, primals, tangents):
    (x,), (dx,) = primals, tangents
    n, hi = _median_bisect_stats(x)
    med = jnp.where(n > 0, 0.5 * (hi[0] + hi[1]),
                    jnp.asarray(fallback, x.dtype))
    posf = (x > 0.0).ravel()
    xf, df = x.ravel(), dx.ravel()
    inf = jnp.asarray(jnp.inf, x.dtype)
    # each order statistic is within ~1 ulp of a real element: nearest-
    # element lookup identifies it robustly (ties -> any is a subgradient)
    i1 = jnp.argmin(jnp.where(posf, jnp.abs(xf - hi[0]), inf))
    i2 = jnp.argmin(jnp.where(posf, jnp.abs(xf - hi[1]), inf))
    dmed = 0.5 * (df[i1] + df[i2])
    return med, jnp.where(n > 0, dmed, jnp.zeros_like(dmed))


def masked_median_of_positive_sort(x: jax.Array, fallback: float = 1e-6) -> jax.Array:
    """Exact median of the positive entries by one sort: numpy's mean of the
    two middle order statistics, rounded once."""
    flat = x.ravel()
    pos = flat > 0.0
    n = jnp.sum(pos)
    vals = jnp.where(pos, flat, jnp.inf)
    s = jnp.sort(vals)
    # numpy median of k elements: k odd -> s[(k-1)//2]; k even -> mean of the two middles
    k = n.astype(jnp.int32)
    lo_idx = jnp.maximum((k - 1) // 2, 0)
    hi_idx = jnp.maximum(k // 2, 0)
    lo = s[lo_idx]
    hi = s[hi_idx]
    med = 0.5 * (lo + hi)
    return jnp.where(n > 0, med, jnp.asarray(fallback, x.dtype))
