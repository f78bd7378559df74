"""Numerical failure detection — the aux-subsystem analog of the
reference's SAssert/Assert guards and its "invalid sample value" warnings
(librender integrator warnings, core/logger.h SLog machinery).

Re-design: host asserts can't live inside jit-compiled code, so
detection is two-layered:
  * `checked(fn)` wraps a jittable function with jax.experimental.checkify
    float checks — NaN/Inf creation inside the traced computation raises
    on the host with the failing primitive's location;
  * `assert_finite(tree)` / `find_nonfinite(tree)` validate materialized
    pytrees (film outputs, gradients) and report exactly which leaf and
    which indices went bad.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def checked(fn):
    """Wrap a jittable function so NaN/Inf produced anywhere inside it
    raises a host-side error with location info.

    NOTE: the wavefront renderer intentionally computes masked lanes and
    discards them with jnp.where (masked multi-eval), so full renders DO
    create transient NaNs that never reach the film — run `checked` on
    reduced repros of suspect kernels, and use `assert_finite` on
    materialized outputs for end-to-end validation.

    >>> err_fn = checked(render_fn); out = err_fn(*args)
    """
    from jax.experimental import checkify

    cfn = checkify.checkify(fn, errors=checkify.float_checks)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        err.throw()
        return out

    return wrapper


def find_nonfinite(tree, max_report: int = 5):
    """Scan a pytree for NaN/Inf; returns a list of (path, n_bad,
    first_indices) — empty when clean."""
    bad = []
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        mask = ~np.isfinite(arr)
        if mask.any():
            idx = np.argwhere(mask)[:max_report]
            bad.append((jax.tree_util.keystr(path), int(mask.sum()),
                        [tuple(i) for i in idx]))
    return bad


def assert_finite(tree, what: str = "output") -> None:
    """Raise with a precise report when the pytree contains NaN/Inf."""
    bad = find_nonfinite(tree)
    if bad:
        lines = [f"non-finite values in {what}:"]
        for path, count, idx in bad:
            lines.append(f"  {path}: {count} bad values, first at {idx}")
        raise FloatingPointError("\n".join(lines))
