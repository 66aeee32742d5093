from .assembly import DensityTracker, KeypairAssembly, ProvingAssignment
from .engine import Bls12Engine
from .generator import DETERMINISTIC_TRAPDOOR, generate_parameters, generate_random_parameters
from .prover import DETERMINISTIC_R, DETERMINISTIC_S
from .types import Parameters, PreparedVerifyingKey, Proof, VerifyingKey
from .verifier import prepare_verifying_key, verify_proof

__all__ = [
    "DensityTracker", "KeypairAssembly", "ProvingAssignment", "Bls12Engine",
    "DETERMINISTIC_TRAPDOOR", "generate_parameters", "generate_random_parameters",
    "DETERMINISTIC_R", "DETERMINISTIC_S",
    "Parameters", "PreparedVerifyingKey", "Proof", "VerifyingKey",
    "prepare_verifying_key", "verify_proof",
]
