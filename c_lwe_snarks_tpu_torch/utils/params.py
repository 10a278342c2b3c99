"""Security / size parameters of the lattice SNARK (GMNO18 over SSPs).

The port's own copy of ``c_lwe_snarks_tpu/utils/params.py`` (the two
packages share no module; ``tests/test_torch_params_aes_host.py`` holds
every property of the copy to the original).  The reference C code bakes
its ``GAMMA_*`` macros in at compile time (src/lwe.h:12-31) and toggles a
debug and a release profile via ``NDEBUG``; here they are a frozen
dataclass with the same two profiles (``toy`` == debug macros,
``release`` == NDEBUG macros) plus all derived constants (PRG stream
offsets, byte sizes) of src/snark.h:6-12 and src/lwe.h:29-31.

Exact-semantics notes carried into the dataclass:

* ``logq`` is the *nominal* modulus bit-width (736).  The reference's
  ``modq`` macro (src/lwe.h:107-118) effectively reduces mod ``2**704``
  (it truncates to ``logq//64`` 64-bit limbs); we expose that as
  ``q_eff_bits`` / ``q_eff_bytes`` and treat it as the real ciphertext
  modulus.  Fresh PRG samples (secret keys, a-vectors) are still full
  736-bit (src/lwe.c:33,90).
* One compressed ciphertext consumes exactly ``ct_bytes * n`` PRG bytes
  (``CTR_CT``, src/snark.h:8); section offsets ``ctr_s/ctr_as/ctr_bt/
  ctr_bv`` follow src/snark.h:9-12.
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class Params:
    """Parameter set mirroring the reference's GAMMA_* macros."""

    d: int  # SSP degree bound (GAMMA_D)
    m: int  # SSP width / number of v_i polynomials (GAMMA_M)
    n: int = 1470  # LWE dimension (GAMMA_N)
    logq: int = 736  # nominal log2(q) (GAMMA_LOGQ)
    p: int = 0xFFFFFFFB  # plaintext modulus 2^32 - 5 (GAMMA_P)
    log_smudging: int = 640  # smudging noise bits (GAMMA_LOG_SMUDGING)
    log_sigma: int = 556  # encryption noise sigma bits (GAMMA_LOG_SIGMA)

    # ---- derived sizes ----------------------------------------------------
    @property
    def logq_bytes(self) -> int:
        """LOGQ_BYTES (src/lwe.h:29): stored bytes of one mod-q scalar."""
        return self.logq // 8  # 92

    @property
    def ct_bytes(self) -> int:
        """CT_BYTES (src/lwe.h:31): compressed ciphertext size."""
        return self.logq_bytes

    @property
    def q_eff_bits(self) -> int:
        """Effective modulus bits: reference modq truncates to 64*(logq//64).

        For logq=736 this is 704 — see src/lwe.h:107-118 and SURVEY §2
        quirk 1: the masked top limb is excluded from the value.
        """
        return 64 * (self.logq // 64)

    @property
    def q_eff_bytes(self) -> int:
        return self.q_eff_bits // 8  # 88

    @property
    def q_eff(self) -> int:
        return 1 << self.q_eff_bits

    # ---- PRG stream layout (src/snark.h:8-12) -----------------------------
    @property
    def ctr_ct(self) -> int:
        """PRG bytes consumed by one ciphertext's a-vector expansion."""
        return self.ct_bytes * self.n  # 135,240 at n=1470

    @property
    def ctr_s(self) -> int:
        return 0

    @property
    def ctr_as(self) -> int:
        return self.ctr_ct * self.d

    @property
    def ctr_bt(self) -> int:
        return 2 * self.ctr_ct * self.d

    @property
    def ctr_bv(self) -> int:
        return 2 * self.ctr_ct * self.d + self.ctr_ct

    # ---- CRS / SSP buffer shapes (src/snark.h:6, src/ssp.h:6-9) ----------
    @property
    def crs_num_cts(self) -> int:
        """Number of compressed ciphertexts in the CRS: s, as, t, v[1..m-1].

        The reference allocates m slots for v but uses m-1
        (src/snark.c:45,103-110); we size exactly.
        """
        return 2 * self.d + 1 + (self.m - 1)

    @property
    def ssp_poly_coeffs(self) -> int:
        """Each SSP polynomial stores d coefficients (degree < d)."""
        return self.d

    # ---- validation -------------------------------------------------------
    def __post_init__(self):
        if self.logq != 736:
            # Mirror of the reference's "#error Not implemented" guard
            # (src/lwe.h:119-121): the modq fast path assumes logq == 736.
            raise NotImplementedError("modq fast path requires logq == 736")
        if self.p != (1 << 32) - 5:
            raise NotImplementedError("mod-p folds assume p == 2^32 - 5")
        if self.log_smudging % 8 != 0:
            raise ValueError("log_smudging must be byte aligned")


@functools.cache
def toy() -> Params:
    """Debug profile (reference --enable-debug macro set, src/lwe.h:18-21)."""
    return Params(d=1 << 8, m=1 << 6)


@functools.cache
def release() -> Params:
    """Release profile (reference NDEBUG macro set, src/lwe.h:14-17)."""
    return Params(d=1 << 15, m=21845)


def custom(d: int, m: int, n: int = 1470) -> Params:
    return Params(d=d, m=m, n=n)
