"""Roofline terms of a step on the card: the card's constants (``HW``), an
aten-op counter whose kernels declare their own cost and whose
collectives count their ring-model wire bytes (``op_cost``) and the
reference's ``RooflineTerms`` / ``model_flops``."""
from .analysis import (HW, Hardware, RooflineTerms,  # noqa: F401
                       analyze_sharded, analyze_step, model_flops)
