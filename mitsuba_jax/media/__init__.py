from mitsuba_jax.media.phase import (
    ISOTROPIC, HG, KAJIYA_KAY, MICROFLAKE,
    phase_eval, phase_pdf, phase_sample,
)
from mitsuba_jax.media.medium import (
    MediumTable, make_homogeneous, make_heterogeneous, no_medium,
    medium_transmittance, sample_distance,
)

__all__ = [
    "ISOTROPIC", "HG", "KAJIYA_KAY", "MICROFLAKE",
    "phase_eval", "phase_pdf", "phase_sample",
    "MediumTable", "make_homogeneous", "make_heterogeneous", "no_medium",
    "medium_transmittance", "sample_distance",
]
