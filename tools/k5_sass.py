"""Count the SASS instructions of kernel K5 (the bitsliced keystream,
``c_lwe_snarks_tpu_torch/csrc/keystream_bitsliced.cu``) per AES block.

    python tools/k5_sass.py

Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit; a machine with the card
has them).  It compiles the source to a cubin with the port's own flags
(``ops/_build.NVCC_FLAGS``), disassembles it, finds the kernel's two loops
(the rolled round loop inside the grid-stride loop over warp tiles) and
counts their instructions by opcode.  A warp tile is 256 blocks and 32
lanes, so one warp instruction of the tile's stream is 1/8 of a 32-bit
operation a block:

    per block = (13 * round loop + rest of the tile loop) / 8

(both sides of a divergent branch count, as the warp runs both).  The
cipher's logic operations (LOP3, LOP, SHF, PRMT) are what the compiled
kernel issues, to set beside the gate count its bound uses
(``chip_smoke.py:BITSLICED_OPS``); the other integer-pipe instructions
(address and loop arithmetic, counter adds, selects), the shuffles and the
shared-memory accesses are printed beside them.  The last line is one JSON
object.
"""

from __future__ import annotations

import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from c_lwe_snarks_tpu_torch.ops import _build  # noqa: E402

SOURCE = _build.CSRC / "keystream_bitsliced.cu"
KERNEL = "keystream_blocks_v1_kernel"
ROUNDS_IN_LOOP = 13
OPS_PER_WARP_INSTR = 32 / 256  # 32 lanes over a tile of 256 blocks
LOGIC = {"LOP3", "LOP", "SHF", "PRMT"}
ALU = LOGIC | {"IADD3", "ISETP", "SEL", "LEA", "MOV", "IABS", "IMNMX", "SGXT", "BMSK",
               "PLOP3", "P2R", "R2P", "FLO", "POPC", "BREV", "VIADD", "VIMNMX"}
FMA = {"IMAD", "IMUL", "FFMA", "FADD", "FMUL"}


def tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not pathlib.Path(found).exists():
        raise SystemExit(f"{name} not found: this tool needs the CUDA toolkit")
    return found


def disassemble() -> str:
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = pathlib.Path(tmp) / "k5.cubin"
        subprocess.run([tool("nvcc"), *flags, "-cubin", "-o", str(cubin), str(SOURCE)],
                       check=True, capture_output=True, text=True)
        return subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                              check=True, capture_output=True, text=True).stdout


def kernel_lines(sass: str) -> list[str]:
    """The lines of the kernel's function."""
    out, inside = [], False
    for line in sass.splitlines():
        if line.strip().startswith("Function :"):
            inside = KERNEL in line
            continue
        if inside:
            out.append(line)
    return out


INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def parse(lines: list[str]) -> tuple[list[tuple[str, str]], dict]:
    """[(opcode, operands)] in order, and {address: index}."""
    instrs, index = [], {}
    for line in lines:
        m = INSTR.search(line)
        if m:
            index[int(m.group(1), 16)] = len(instrs)
            instrs.append((m.group(3), m.group(4)))
    return instrs, index


def loops(instrs, index) -> list[tuple[int, int]]:
    """(first, last) instruction indices of each backward branch's body."""
    spans = []
    for i, (op, args) in enumerate(instrs):
        if op == "BRA":
            t = re.search(r"0x([0-9a-f]+)", args)
            if t and index.get(int(t.group(1), 16), i + 1) < i - 2:
                spans.append((index[int(t.group(1), 16)], i))
    return spans


def histogram(instrs, spans_in, spans_out=()) -> collections.Counter:
    inner = {i for a, b in spans_out for i in range(a, b + 1)}
    return collections.Counter(
        instrs[i][0].split(".")[0] for a, b in spans_in for i in range(a, b + 1) if i not in inner)


def summary(h: collections.Counter) -> dict:
    groups = {
        "logic": sum(n for op, n in h.items() if op in LOGIC),
        "alu_other": sum(n for op, n in h.items() if op in ALU - LOGIC),
        "fma_pipe": sum(n for op, n in h.items() if op in FMA),
        "shfl": h["SHFL"],
        "lds": h["LDS"],
        "sts": h["STS"],
        "stg": h["STG"],
    }
    groups["other"] = sum(h.values()) - sum(groups.values())
    return groups


def main() -> int:
    instrs, index = parse(kernel_lines(disassemble()))
    # the divergent slow paths of the shuffles (WARPSYNC) branch back too
    spans = sorted((s for s in loops(instrs, index)
                    if not any(instrs[i][0].startswith("WARPSYNC") for i in range(s[0], s[1] + 1))),
                   key=lambda s: s[1] - s[0])
    with_shfl = [s for s in spans if any(instrs[i][0] == "SHFL.IDX" for i in range(s[0], s[1] + 1))]
    if len(with_shfl) < 2:
        raise SystemExit(f"expected the round loop inside the tile loop, found loops {spans}")
    rounds = with_shfl[0]
    tile = next(s for s in with_shfl[1:] if s[0] <= rounds[0] and rounds[1] <= s[1])
    h_round = histogram(instrs, [rounds])
    h_rest = histogram(instrs, [tile], [rounds])
    r, t = summary(h_round), summary(h_rest)
    per_block = {k: (ROUNDS_IN_LOOP * r[k] + t[k]) * OPS_PER_WARP_INSTR for k in r}
    print(f"{KERNEL}: {len(instrs)} instructions; round loop {rounds[1] - rounds[0] + 1}, "
          f"tile loop outside it {sum(h_rest.values())}")
    print(f"round loop by opcode: {dict(h_round.most_common())}")
    print(f"tile loop outside the round loop by opcode: {dict(h_rest.most_common())}")
    for k in r:
        print(f"  {k:10s} round {r[k]:5d}  rest {t[k]:5d}  per block {per_block[k]:9.3f}")
    print(json.dumps({"kernel": KERNEL, "round_loop": r, "tile_rest": t, "per_block": per_block}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
