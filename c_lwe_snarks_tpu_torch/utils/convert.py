"""State carried across packages: numpy arrays <-> the port's dataclasses.

The JAX package's objects enter as numpy arrays (``np.asarray`` of each
field), so this module needs no jax.  The SSP's coefficients and the
VRS's scalars become uint32 tensors (the JAX package's type), digit rows
uint8 tensors, on the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import snark as tsnark
from ..models import ssp as tssp
from ..ops import modp


def _digits(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.uint8)[..., :88], device=device)


def _reduced(x, device, what: str) -> torch.Tensor:
    """Words < p as a uint32 tensor; anything else raises."""
    x = np.asarray(x)
    if ((x < 0) | (x >= modp.P)).any():
        raise ValueError(f"{what} must be reduced mod p")
    return torch.tensor(x.astype(np.uint32), device=device)


def ssp_from_numpy(t, v, device="cuda") -> tssp.SSP:
    """t [d], v [m, d] coefficients < p (the JAX package's uint32 arrays as
    they are) -> SSP (uint32 tensors)."""
    return tssp.SSP(t=_reduced(t, device, "SSP coefficients"),
                    v=_reduced(v, device, "SSP coefficients"))


def crs_from_numpy(seed: bytes, b_s, b_as, b_t, b_v, device="cuda") -> tsnark.CRS:
    """Compressed b-rows ([..., 88] or [..., 92] bytes) -> CRS."""
    return tsnark.CRS(
        seed=bytes(seed), b_s=_digits(b_s, device), b_as=_digits(b_as, device),
        b_t=_digits(b_t, device), b_v=_digits(b_v, device))


def vrs_from_numpy(alpha, beta, s, sk, device="cuda") -> tsnark.VRS:
    """VRSDev's fields -> VRS (alpha, beta, s uint32 scalars < p, sk digit rows)."""
    alpha, beta, s = (_reduced(x, device, "VRS scalars") for x in (alpha, beta, s))
    return tsnark.VRS(alpha=alpha, beta=beta, s=s, sk=_digits(sk, device))


def proof_to_numpy(proof: tsnark.Proof) -> np.ndarray:
    """Proof -> uint8 [5, n+1, 88] in the order h, hat_h, hat_v, v_w, b_w."""
    return proof.stack().cpu().numpy().astype(np.uint8)
