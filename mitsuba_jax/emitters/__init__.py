from mitsuba_jax.emitters.table import (
    EmitterTable,
    EmitterBuilder,
    sample_direct,
    pdf_direct_area,
    eval_emitter_hit,
    eval_and_pdf_environment,
    eval_environment,
    pdf_environment,
    AREA,
    POINT,
    SPOT,
    DIRECTIONAL,
    COLLIMATED,
    CONSTANT,
    ENVMAP,
    SKY,
)

__all__ = [
    "EmitterTable", "EmitterBuilder", "sample_direct", "pdf_direct_area",
    "eval_emitter_hit", "eval_environment", "pdf_environment",
    "eval_and_pdf_environment",
    "AREA", "POINT", "SPOT", "DIRECTIONAL", "COLLIMATED", "CONSTANT",
    "ENVMAP", "SKY",
]
