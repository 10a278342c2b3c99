"""Print the bitsliced S-box gate list of the PyTorch port as CUDA C++.

    python tools/gen_sbox_bp_cuh.py            # writes csrc/sbox_bp_gates.cuh
    python tools/gen_sbox_bp_cuh.py --check    # exit 1 if the file is stale

The gate list lives once, in ``c_lwe_snarks_tpu_torch/ops/sbox_bp.py``
(115 XOR/AND gates, S(x) ^ 0x63).  The bitsliced keystream kernel
(``csrc/keystream_bitsliced.cu``) includes the generated header, which is
committed so that the kernels build from the sources alone.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from c_lwe_snarks_tpu_torch.ops import sbox_bp  # noqa: E402

TARGET = ROOT / "c_lwe_snarks_tpu_torch" / "csrc" / "sbox_bp_gates.cuh"


def render() -> str:
    """The header's text: one ``const uint32_t`` per gate, in list order."""
    ops = {"xor": "^", "and": "&"}
    lines = [
        "// Bitsliced AES S-box, 115 XOR/AND gates, computing S(x) ^ 0x63 on eight",
        "// bit planes (x[k] = bit k of 32 bytes, LSB first), in place.",
        "//",
        "// GENERATED by tools/gen_sbox_bp_cuh.py from the gate list of",
        "// c_lwe_snarks_tpu_torch/ops/sbox_bp.py; do not edit by hand.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace cls {",
        "",
        f"constexpr int kSboxBpGates = {sbox_bp.GATE_COUNT};",
        "",
        "__device__ __forceinline__ void sbox_bp(uint32_t* __restrict__ x) {",
    ]
    lines += [f"  const uint32_t r{k} = x[{k}];" for k in range(8)]
    lines += [f"  const uint32_t r{dst} = r{a} {ops[op]} r{b};"
              for op, dst, a, b in sbox_bp.GATES]
    lines += [f"  x[{k}] = r{reg};" for k, reg in enumerate(sbox_bp.OUT_REGS)]
    lines += ["}", "", "}  // namespace cls", ""]
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true", help="compare, do not write")
    args = ap.parse_args()
    text = render()
    if args.check:
        same = TARGET.exists() and TARGET.read_text() == text
        print(f"{TARGET.relative_to(ROOT)}: {'up to date' if same else 'STALE'}")
        return 0 if same else 1
    TARGET.write_text(text)
    print(f"wrote {TARGET.relative_to(ROOT)} ({sbox_bp.GATE_COUNT} gates)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
