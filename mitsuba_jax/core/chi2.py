"""χ² goodness-of-fit harness for directional sampling routines.

Capability parity with reference include/mitsuba/core/chisquare.h
(ChiSquare::fill/runTest): bin directions produced by `sample_fn` on a
(theta, phi) grid, numerically integrate `pdf_fn` over the same bins, pool
low-count cells, and run a Pearson χ² test.  Gates every warp, BSDF and phase
function sampler, mirroring the reference's systematic
test_chisquare.cpp strategy.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import gammainc

from mitsuba_jax.core.quad import sphere_bin_integrate


@dataclass
class Chi2Result:
    passed: bool
    chi2: float
    dof: int
    p_value: float
    pooled: int


def chi2_probability(chi2_val, dof):
    """Upper-tail probability of a χ² distribution (regularized gamma Q)."""
    return float(1.0 - gammainc(dof / 2.0, chi2_val / 2.0))


def chi2_test(
    key,
    sample_fn,
    pdf_fn,
    n_samples: int = 1_000_000,
    theta_res: int = 10,
    phi_res: int = 20,
    min_exp_frequency: float = 5.0,
    significance: float = 0.01,
    sub: int = 8,
) -> Chi2Result:
    """Run a χ² GoF test of sample_fn against pdf_fn.

    sample_fn(key, n) -> (n, 3) unit directions (may include invalid/zero
    entries which are discarded); pdf_fn(d) -> solid-angle pdf at directions d.
    """
    d = sample_fn(key, n_samples)
    d = np.asarray(d)
    valid = np.isfinite(d).all(axis=-1) & (np.abs(np.linalg.norm(d, axis=-1) - 1.0) < 1e-2)
    d = d[valid]
    n_valid = d.shape[0]

    theta = np.arccos(np.clip(d[:, 2], -1.0, 1.0))
    phi = np.arctan2(d[:, 1], d[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    ti = np.minimum((theta / np.pi * theta_res).astype(np.int64), theta_res - 1)
    pi_ = np.minimum((phi / (2 * np.pi) * phi_res).astype(np.int64), phi_res - 1)
    obs = np.bincount(ti * phi_res + pi_, minlength=theta_res * phi_res).astype(np.float64)

    exp_mass = np.asarray(
        sphere_bin_integrate(pdf_fn, theta_res, phi_res, sub=sub), np.float64
    ).reshape(-1)
    # Account for the discarded (invalid) samples: the pdf may integrate to
    # less than one (e.g. absorbing samplers); scale expectations by n_samples.
    exp = exp_mass * n_samples

    # Pool cells with low expected frequency (reference chisquare.cpp pooling)
    order = np.argsort(exp)
    obs_s, exp_s = obs[order], exp[order]
    chi2_val = 0.0
    dof = 0
    pooled_obs = pooled_exp = 0.0
    pooled_cells = 0
    for o, e in zip(obs_s, exp_s):
        if e < min_exp_frequency:
            pooled_obs += o
            pooled_exp += e
            pooled_cells += 1
            if pooled_exp >= min_exp_frequency:
                chi2_val += (pooled_obs - pooled_exp) ** 2 / pooled_exp
                dof += 1
                pooled_obs = pooled_exp = 0.0
        else:
            chi2_val += (o - e) ** 2 / e
            dof += 1
    if pooled_exp > 0:
        chi2_val += (pooled_obs - pooled_exp) ** 2 / max(pooled_exp, 1e-6)
        dof += 1
    dof -= 1  # normalization constraint
    dof = max(dof, 1)
    p = chi2_probability(chi2_val, dof)
    return Chi2Result(
        passed=bool(p >= significance or n_valid == 0),
        chi2=float(chi2_val),
        dof=int(dof),
        p_value=p,
        pooled=pooled_cells,
    )
