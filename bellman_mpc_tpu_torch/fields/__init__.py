from .host import PrimeField, batch_inv
from .limb import LIMB_BITS, LIMB_MASK, LimbField

__all__ = ["PrimeField", "batch_inv", "LimbField", "LIMB_BITS", "LIMB_MASK"]
