"""Whether the float32 instances of ``lstm_train.cu`` compile to the same
machine code as another version of the source (card machine only: needs
``nvcc`` and ``cuobjdump``).

    python tests/lstm_train_sass_diff.py OTHER.cu

Builds ``shm_tpu_torch/ops/csrc/lstm_train.cu`` and OTHER.cu with the
port's nvcc flags into a temporary directory, disassembles both
(``cuobjdump -sass``) and compares, kernel by kernel, the instruction
streams of every float32 kernel: the scans' ``<H, DEC>`` instances of OTHER
against the ``<H, DEC, false>`` instances here, the gradient pass's kernels
against their ``<false>`` instances (or their untemplated originals).
Instruction addresses and the kernels' own names are dropped before the
comparison. Prints one line a kernel and exits 1 if any differs.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from shm_tpu_torch.ops._build import NVCC_FLAGS, _nvcc  # noqa: E402

# the float32 kernels by a name independent of their template arguments
F32_KERNELS = {
    f"lstm2_{scan}_scan_kernel H={h} {'dec' if dec else 'enc'}":
        (rf"lstm2_{scan}_scan_kernelILi{h}ELb{int(dec)}E(Lb0E)?E",)
    for scan in ("fwd", "bwd") for h in (32, 64, 128) for dec in (0, 1)
}
F32_KERNELS.update({k: (rf"{k}(ILb0EEEv|E(?!v))",) for k in (
    "contract_partial_kernel", "wt_dg_kernel", "reduce_partial_kernel",
    "sum_t_rowsum_kernel")})


def sass(src: Path, out_dir: Path) -> dict:
    """{mangled kernel name: [instructions]} of ``src`` built as the port
    builds it."""
    lib = out_dir / (src.stem + f"-{abs(hash(str(src)))}.so")
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    tool = "cuobjdump"
    listing = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, check=True).stdout
    out, fn = {}, None
    for line in listing.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            out[fn] = []
        elif fn and "*/" in line and "/*" in line:
            ins = line.split("*/", 1)[1].split("/*")[0].strip()
            if ins:
                out[fn].append(re.sub(r"_ZN\w+", "SYM", ins))
    return out


def main(other: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        here = sass(ROOT / "shm_tpu_torch" / "ops" / "csrc" / "lstm_train.cu", Path(tmp))
        there = sass(Path(other).resolve(), Path(tmp))
    bad = 0
    for label, (pat,) in F32_KERNELS.items():
        find = lambda d: [v for k, v in d.items() if re.search(pat, k)]
        a, b = find(here), find(there)
        same = len(a) == len(b) == 1 and a[0] == b[0]
        print(f"[sass] {label}: {'same' if same else 'DIFFERENT'} "
              f"({len(a[0]) if a else 0} / {len(b[0]) if b else 0} instructions)")
        if not same and len(a) == len(b) == 1:
            diff = [(i, x, y) for i, (x, y) in enumerate(zip(a[0], b[0])) if x != y]
            print(f"[sass]   {len(diff)} instructions differ; the first: "
                  + "; ".join(f"#{i} {x!r} / {y!r}" for i, x, y in diff[:4]))
        bad += not same
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
