from .core import (
    AUX,
    INPUT,
    ONE,
    AssignmentMissing,
    Circuit,
    ConstraintSystem,
    DivisionByZero,
    InvalidProof,
    InvalidVerifyingKey,
    IoError,
    LinearCombination,
    Namespace,
    PolynomialDegreeTooLarge,
    SynthesisError,
    UnconstrainedVariable,
    UnexpectedIdentity,
    Unsatisfiable,
    Variable,
    VerificationError,
)
from .test_cs import TestConstraintSystem

__all__ = [
    "AUX", "INPUT", "ONE", "AssignmentMissing", "Circuit", "ConstraintSystem",
    "DivisionByZero", "InvalidProof", "InvalidVerifyingKey", "IoError",
    "LinearCombination", "Namespace", "PolynomialDegreeTooLarge",
    "SynthesisError", "UnconstrainedVariable", "UnexpectedIdentity",
    "Unsatisfiable", "Variable", "VerificationError", "TestConstraintSystem",
]
