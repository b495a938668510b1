"""Roofline terms of a step on the card: the card's constants (``HW``), an
aten-op counter whose kernels declare their own cost (``op_cost``) and the
reference's ``RooflineTerms`` / ``model_flops``."""
from .analysis import (HW, Hardware, RooflineTerms,  # noqa: F401
                       analyze_step, model_flops)
