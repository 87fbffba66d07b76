"""The plain reference: each query's answer worked out again, in plain
PyTorch, from the generated columns and the frozen query spec.

It imports nothing of the program, takes none of its tables, plans or
weights, and reads the raw columns a generator makes from the run's seed.
``answer(..., precision="float64")`` is the reference; ``precision=
"bfloat16"`` is the control: every stored input (value and feature
columns, weights, thresholds) rounded to bfloat16 and the arithmetic in
float32, the step below the configuration's float32 that a later change
might be tempted to take.
"""
from .answers import Answer, answer  # noqa: F401
