"""Conversions between the JAX reference's objects and the port's.

Both packages keep host group elements as plain Python ints (G1: (x, y),
G2: ((x0, x1), (y0, y1)), identity None), so a CRS or a proof converts by
rebuilding its dataclasses.  Device arrays cross as numpy arrays: a JAX
array goes in through `tensor`, a tensor comes out through `.numpy()`; the
nested Fp2/Fp6/Fp12 tuples of the device tower cross through `tree_from`
and `tree_to`.
This module imports neither jax nor the reference package: it only reads
the attributes of the objects it is handed.
"""

from __future__ import annotations

import numpy as np
import torch

from .groth16.types import Parameters, Proof, VerifyingKey


def vk_from(vk) -> VerifyingKey:
    return VerifyingKey(
        alpha_g1=vk.alpha_g1, beta_g1=vk.beta_g1, beta_g2=vk.beta_g2,
        gamma_g2=vk.gamma_g2, delta_g1=vk.delta_g1, delta_g2=vk.delta_g2,
        ic=list(vk.ic),
    )


def params_from(params) -> Parameters:
    """A reference `Parameters` (or any object with its fields) -> the port's."""
    return Parameters(
        vk=vk_from(params.vk), h=list(params.h), l=list(params.l),
        a=list(params.a), b_g1=list(params.b_g1), b_g2=list(params.b_g2),
    )


def params_to(params: Parameters, cls_params, cls_vk):
    """The port's `Parameters` -> the reference's classes (passed in)."""
    vk = params.vk
    return cls_params(
        vk=cls_vk(alpha_g1=vk.alpha_g1, beta_g1=vk.beta_g1, beta_g2=vk.beta_g2,
                  gamma_g2=vk.gamma_g2, delta_g1=vk.delta_g1, delta_g2=vk.delta_g2,
                  ic=list(vk.ic)),
        h=list(params.h), l=list(params.l), a=list(params.a),
        b_g1=list(params.b_g1), b_g2=list(params.b_g2),
    )


def proof_from(proof) -> Proof:
    return Proof(a=proof.a, b=proof.b, c=proof.c)


def tensor(arr, device="cpu") -> torch.Tensor:
    """A numpy-convertible array (e.g. a JAX array) -> a tensor of its own."""
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tree_from(tree, device="cpu"):
    """Nested tuples (or lists) of numpy-convertible arrays, e.g. a
    reference Fp12 element, -> the same nesting of tensors."""
    if isinstance(tree, (tuple, list)):
        return tuple(tree_from(t, device) for t in tree)
    return tensor(tree, device)


def tree_to(tree):
    """Nested tuples of tensors -> the same nesting of numpy arrays."""
    if isinstance(tree, (tuple, list)):
        return tuple(tree_to(t) for t in tree)
    return tree.detach().cpu().numpy()
