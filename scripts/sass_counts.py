"""Count the SASS instructions of the bucket-accumulation kernels (K1, K2,
K8-K10) and of single field products, by instruction class, on a machine
with the CUDA toolkit:

    python3 scripts/sass_counts.py [--root DIR] [--label NAME] [--out FILE]

--root is the directory holding `bulletproof_gadgets_tpu_torch` (default:
this checkout).  The script builds that checkout's kernel library
(`native.build()`), disassembles it with `cuobjdump -sass`, and for each
bucket-accumulation template counts the instructions of its round loop (the
longest backward branch) and of the whole kernel; it reads each kernel's
registers and local memory from `cuobjdump -res-usage` and works out the
resident 128-thread blocks per SM (65,536 registers, allocated per warp in
units of 256; at most 2,048 threads) and the waves of a 556-block launch
(the example statement's k=3 commitment MSM: P = 71,093 lanes).  It also
compiles scripts/sass_probe.cu (one field product, add, sub or mixed point
addition per kernel, for each field core the checkout has) and counts those
kernels, loads and stores apart.  Needs no GPU.  Prints one JSON object
(also written to --out) and writes the disassembly beside --out.
"""
import argparse
import collections
import json
import os
import re
import subprocess
import sys

SMS, REGS_PER_SM, MAX_THREADS, THREADS = 132, 65536, 2048, 128
LAUNCH_BLOCKS = -(-71093 // THREADS)
KERNELS = {   # label: substring of the mangled name
    "K1 bucket_accumulate_kernel<false>": "bucket_accumulate_kernelILb0E",
    "K2 bucket_accumulate_kernel<true>": "bucket_accumulate_kernelILb1E",
    "K8/K10 bucket_accumulate_limbs_kernel<false>":
        "bucket_accumulate_limbs_kernelILb0E",
    "K9 bucket_accumulate_limbs_kernel<true>":
        "bucket_accumulate_limbs_kernelILb1E",
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")


def opclass(op):
    """The class of one SASS opcode (with its modifiers)."""
    base = op.split(".")[0]
    if base == "IMAD":
        for kind in ("MOV", "SHL", "IADD"):
            if f".{kind}" in op:
                return f"IMAD.{kind} (no multiply)"
        if ".WIDE" in op:
            return "IMAD.WIDE"
        return "IMAD.HI" if ".HI" in op else "IMAD"
    if base in ("LDG", "LD", "LDS", "LDL", "LDC", "ULDC"):
        return "load"
    if base in ("STG", "ST", "STS", "STL"):
        return "store"
    if base in ("IADD3", "SHF", "LOP3", "LEA", "SEL", "ISETP", "MOV", "PRMT",
                "IABS", "BRA", "EXIT", "NOP"):
        return base
    return "other"


def functions(sass):
    """{mangled name: [(address, opcode, operands)]} of a cuobjdump -sass
    listing; a branch to a label (`(.L_x_3)) gets the label's address."""
    out, labels, cur, pending = {}, {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur, labels = out.setdefault(m.group(1), []), {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            cur.append([addr, m.group(3), m.group(4).strip(), labels])
    return {name: [(a, op, _resolve(rest, labs)) for a, op, rest, labs in ins]
            for name, ins in out.items()}


def _resolve(args, labels):
    m = re.match(r"`\((\.L_x_\d+)\)", args)
    return f"0x{labels[m.group(1)]:x}" if m and m.group(1) in labels else args


def counts(insns):
    by_class = collections.Counter(opclass(op) for _, op, _ in insns)
    by_class.pop("NOP", None)
    return dict(sorted(by_class.items())), sum(by_class.values())


def loop_body(insns):
    """The instructions of the longest loop: from a backward branch's target
    to the branch."""
    best = []
    for addr, op, args in insns:
        m = re.match(r"0x([0-9a-f]+)", args) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            body = [i for i in insns if int(m.group(1), 16) <= i[0] <= addr]
            if len(body) > len(best):
                best = body
    return best


def resources(lib, cuobjdump):
    """{mangled name: (registers, local bytes)} from cuobjdump -res-usage."""
    out, name = {}, None
    text = subprocess.run([cuobjdump, "-res-usage", lib], capture_output=True,
                          text=True, check=True).stdout
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"REG:(\d+).*LOCAL:(\d+)", line)
        if m and name:
            out[name] = (int(m.group(1)), int(m.group(2)))
    return out


def blocks_per_sm(regs):
    per_warp = -(-regs * 32 // 256) * 256
    warps = REGS_PER_SM // per_warp
    return min(warps // (THREADS // 32), MAX_THREADS // THREADS)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from bulletproof_gadgets_tpu_torch import native
    lib = native.build()
    bindir = os.path.dirname(native._nvcc())
    cuobjdump = os.path.join(bindir, "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, res = functions(sass), resources(lib, cuobjdump)
    report = {"label": args.label, "package": os.path.abspath(args.root),
              "kernels": {}, "probes": {}}
    dumps = []
    for label, key in KERNELS.items():
        name = next((f for f in funcs if key in f), None)
        if name is None:
            report["kernels"][label] = "not in the library"
            continue
        body = loop_body(funcs[name])
        regs, local = res.get(name, (None, None))
        blocks = blocks_per_sm(regs) if regs else None
        report["kernels"][label] = {
            "round_loop": dict(zip(("by_class", "total"), counts(body))),
            "kernel": dict(zip(("by_class", "total"), counts(funcs[name]))),
            "registers": regs, "local_bytes": local,
            "blocks_per_sm": blocks,
            "waves_of_556_blocks": (LAUNCH_BLOCKS / (SMS * blocks)
                                    if blocks else None)}
        dumps.append((label, funcs[name]))
    if native.BUILD_LOG:
        report["ptxas"] = [ln.strip() for ln in native.BUILD_LOG.splitlines()
                           if "bucket_accumulate" in ln or "spill" in ln
                           or "registers" in ln]
    probe = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "sass_probe.cu")
    cubin = os.path.join(native.BUILD_DIR, "sass_probe.cubin")
    subprocess.run([native._nvcc(), "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", native.CSRC, "-o", cubin, probe], check=True)
    psass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                           text=True, check=True).stdout
    pres = resources(cubin, cuobjdump)
    for name, insns in sorted(functions(psass).items()):
        by_class, total = counts(insns)
        memory = by_class.get("load", 0) + by_class.get("store", 0)
        report["probes"][name] = {"by_class": by_class, "total": total,
                                  "without_loads_stores": total - memory,
                                  "registers": pres.get(name, (None,))[0]}
        dumps.append((name, insns))
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
        with open(os.path.splitext(args.out)[0] + ".sass.txt", "w") as f:
            for label, insns in dumps:
                f.write(f"== {label}\n")
                f.writelines(f"/*{a:05x}*/ {op} {rest}\n"
                             for a, op, rest in insns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
