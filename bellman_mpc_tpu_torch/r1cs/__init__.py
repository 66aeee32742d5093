from .core import (
    AUX,
    INPUT,
    ONE,
    AssignmentMissing,
    Circuit,
    ConstraintSystem,
    InvalidProof,
    InvalidVerifyingKey,
    LinearCombination,
    SynthesisError,
    UnconstrainedVariable,
    UnexpectedIdentity,
    Variable,
)

__all__ = [
    "AUX", "INPUT", "ONE", "AssignmentMissing", "Circuit", "ConstraintSystem",
    "InvalidProof", "InvalidVerifyingKey", "LinearCombination",
    "SynthesisError", "UnconstrainedVariable", "UnexpectedIdentity", "Variable",
]
