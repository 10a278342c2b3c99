"""Print the bitsliced S-box gate list of the PyTorch port as CUDA C++.

    python tools/gen_sbox_bp_cuh.py            # writes csrc/sbox_bp_gates.cuh
    python tools/gen_sbox_bp_cuh.py --check    # exit 1 if the file is stale

The gate list lives once, in ``c_lwe_snarks_tpu_torch/ops/sbox_bp.py``
(115 XOR/AND gates, S(x) ^ 0x63).  The bitsliced keystream kernel
(``csrc/keystream_bitsliced.cu``) includes the generated header, which is
committed so that the kernels build from the sources alone.

The header computes the same circuit as a cover of its gates by
three-input lookup tables, each one ``lop3.b32`` (Hopper's LOP3 takes any
function of three registers): ``lop3_cover`` picks, for every gate, the
cheapest set of at most three registers it can be computed from (cut
enumeration with area flow), and keeps the tables the outputs need.  The
instructions are written out because the compiler, given the gates, shares
subexpressions that the cover recomputes inside a table and so emits more
instructions.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from c_lwe_snarks_tpu_torch.ops import sbox_bp  # noqa: E402

TARGET = ROOT / "c_lwe_snarks_tpu_torch" / "csrc" / "sbox_bp_gates.cuh"
LUT_INPUTS = (0xF0, 0xCC, 0xAA)  # PTX lop3: the table is F(0xF0, 0xCC, 0xAA)


def lop3_cover(gates=sbox_bp.GATES, out_regs=sbox_bp.OUT_REGS) -> list[tuple[int, tuple, int]]:
    """[(register, leaves, table)] in gate order: each register computed by
    one three-input lookup table from at most three earlier registers
    (inputs 0..7 or other tables of the cover)."""
    kids = {dst: (op, a, b) for op, dst, a, b in gates}
    fanout = collections.Counter([r for _, _, a, b in gates for r in (a, b)] + list(out_regs))
    cuts = {r: [(r,)] for r in range(8)}
    flow = {r: 0.0 for r in range(8)}
    best = {}
    for _, dst, a, b in gates:
        options = sorted({tuple(sorted(set(ca) | set(cb))) for ca in cuts[a] for cb in cuts[b]
                          if len(set(ca) | set(cb)) <= 3})

        def cost(cut):
            return 1 + sum(flow[r] / fanout[r] for r in cut)

        best[dst] = min(options, key=lambda cut: (cost(cut), len(cut), cut))
        flow[dst] = cost(best[dst])
        cuts[dst] = [(dst,)] + options
    used, stack = set(), list(out_regs)
    while stack:
        r = stack.pop()
        if r >= 8 and r not in used:
            used.add(r)
            stack.extend(best[r])

    def table(dst, leaves):
        vals = dict(zip(leaves, LUT_INPUTS))

        def ev(r):
            if r not in vals:
                op, a, b = kids[r]
                vals[r] = ev(a) ^ ev(b) if op == "xor" else ev(a) & ev(b)
            return vals[r]

        return ev(dst)

    return [(dst, best[dst], table(dst, best[dst])) for _, dst, _, _ in gates if dst in used]


def run_cover(cover, planes, mask):
    """The cover on 8 planes (python ints or tensors; ``mask`` has every
    bit of a plane set): the 8 output planes."""
    regs = dict(enumerate(planes))
    for dst, leaves, lut in cover:
        a, b, c = (regs[r] for r in (leaves + (leaves[0],) * 3)[:3])
        out = 0
        for i in range(8):
            if lut >> i & 1:
                out = out | ((a if i & 4 else a ^ mask) & (b if i & 2 else b ^ mask)
                             & (c if i & 1 else c ^ mask))
        regs[dst] = out
    return [regs[r] for r in sbox_bp.OUT_REGS]


def render() -> str:
    """The header's text: one ``lop3`` a table of the cover, in gate order."""
    cover = lop3_cover()
    lines = [
        "// Bitsliced AES S-box computing S(x) ^ 0x63 on eight bit planes (x[k] =",
        f"// bit k of 32 bytes, LSB first), in place: the {sbox_bp.GATE_COUNT} XOR/AND gates as a",
        f"// cover of {len(cover)} three-input lookup tables, one lop3.b32 each.",
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
        f"constexpr int kSboxBpTables = {len(cover)};",
        "",
        "template <uint32_t kTable>",
        "__device__ __forceinline__ uint32_t lop3(uint32_t a, uint32_t b, uint32_t c) {",
        "  uint32_t d;",
        '  asm("lop3.b32 %0, %1, %2, %3, %4;" : "=r"(d) : "r"(a), "r"(b), "r"(c), "n"(kTable));',
        "  return d;",
        "}",
        "",
        "__device__ __forceinline__ void sbox_bp(uint32_t* __restrict__ x) {",
    ]
    lines += [f"  const uint32_t r{k} = x[{k}];" for k in range(8)]
    for dst, leaves, lut in cover:
        args = ", ".join(f"r{r}" for r in (leaves + (leaves[0],) * 3)[:3])
        lines.append(f"  const uint32_t r{dst} = lop3<0x{lut:02X}>({args});")
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
    print(f"wrote {TARGET.relative_to(ROOT)} ({sbox_bp.GATE_COUNT} gates, "
          f"{len(lop3_cover())} lookup tables)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
