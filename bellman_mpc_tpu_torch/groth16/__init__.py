from .assembly import DensityTracker, KeypairAssembly, ProvingAssignment
from .engine import DUMMY, Bls12Engine, DummyEngine, Engine, GroupAPI
from .generator import DETERMINISTIC_TRAPDOOR, generate_parameters, generate_random_parameters
from .prover import DETERMINISTIC_R, DETERMINISTIC_S, create_proof, create_random_proof
from .serialize import (
    params_from_bytes,
    params_to_bytes,
    proof_from_bytes,
    proof_to_bytes,
    vk_from_bytes,
    vk_to_bytes,
)
from .types import Parameters, PreparedVerifyingKey, Proof, VerifyingKey
from .verifier import prepare_verifying_key, verify_proof
from .verifier_batch import BatchVerifier, Item

__all__ = [
    "DensityTracker", "KeypairAssembly", "ProvingAssignment",
    "DUMMY", "Bls12Engine", "DummyEngine", "Engine", "GroupAPI",
    "DETERMINISTIC_TRAPDOOR", "generate_parameters", "generate_random_parameters",
    "DETERMINISTIC_R", "DETERMINISTIC_S", "create_proof", "create_random_proof",
    "params_from_bytes", "params_to_bytes", "proof_from_bytes", "proof_to_bytes",
    "vk_from_bytes", "vk_to_bytes",
    "Parameters", "PreparedVerifyingKey", "Proof", "VerifyingKey",
    "prepare_verifying_key", "verify_proof", "BatchVerifier", "Item",
]
