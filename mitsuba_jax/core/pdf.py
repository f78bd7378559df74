"""Discrete 1-D distributions (CDF tables).

Vectorized counterpart of reference include/mitsuba/core/pdf.h
(`DiscretePDF::put/build/sample/sampleReuse`): build is a cumsum, sampling is
a vectorized `searchsorted` — O(log n) gathers instead of the reference's
per-call std::lower_bound.
"""
from __future__ import annotations

import jax.numpy as jnp

from mitsuba_jax.core.types import pytree_dataclass


@pytree_dataclass
class DiscretePDF:
    pmf: jnp.ndarray         # (n,) normalized probabilities
    cdf: jnp.ndarray         # (n,) inclusive cumulative sum, cdf[-1] == 1
    total: jnp.ndarray       # () original sum before normalization

    @staticmethod
    def build(weights):
        weights = jnp.asarray(weights, jnp.float32)
        total = jnp.sum(weights)
        safe_total = jnp.where(total > 0, total, 1.0)
        pmf = weights / safe_total
        cdf = jnp.cumsum(pmf)
        return DiscretePDF(pmf=pmf, cdf=cdf, total=total)

    def sample(self, u):
        """Sample index from uniform u in [0,1). Returns (index, pmf[index])."""
        idx = jnp.searchsorted(self.cdf, u, side="right")
        idx = jnp.clip(idx, 0, self.pmf.shape[0] - 1)
        return idx, self.pmf[idx]

    def sample_reuse(self, u):
        """Sample index and rescale u to [0,1) within the chosen bin.

        Mirrors reference pdf.h:128 `sampleReuse` — lets one random number
        drive both a discrete and a continuous decision.
        """
        idx, p = self.sample(u)
        lo = jnp.where(idx > 0, self.cdf[jnp.maximum(idx - 1, 0)], 0.0)
        u_rescaled = jnp.clip((u - lo) / jnp.maximum(p, 1e-20), 0.0, 1.0 - 1e-7)
        return idx, p, u_rescaled
