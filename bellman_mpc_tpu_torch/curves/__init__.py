from .host import FP2_OPS, FP_OPS, G1, G2, CurveGroup

__all__ = ["G1", "G2", "CurveGroup", "FP_OPS", "FP2_OPS"]
