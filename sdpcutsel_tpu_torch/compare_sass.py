"""Compare the SASS of the kernels built from this checkout and another.

    python3 -m sdpcutsel_tpu_torch.compare_sass OTHER_DIR [SOURCE ...]

Compiles each source of sdpcutsel_tpu_torch/csrc (default: every .cu file
that both checkouts have) of this checkout and of OTHER_DIR (for example a
``git archive`` of the parent commit) to a cubin with the flags of
sdpcutsel_tpu_torch/_build.py, all at once, disassembles both with
``cuobjdump -sass`` and prints, for every kernel, whether its SASS is the
same in both.  Kernels that only one checkout has are listed apart.  Exits 1
if a kernel that both have differs.  Needs nvcc and cuobjdump; writes under
build/sass/.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys

from . import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cubins(root: str, names: list[str], out: str) -> list[subprocess.Popen]:
    os.makedirs(out, exist_ok=True)
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    return [subprocess.Popen([nvcc, *flags, "-cubin", "-o", os.path.join(out, f"{n}.cubin"),
                              os.path.join(root, "sdpcutsel_tpu_torch", "csrc", f"{n}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in names]


def kernels(cubin: str) -> dict[str, str]:
    """{kernel: its SASS} of a cubin, the anonymous namespace's hash (which
    differs with the source's path) taken out of the names."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        out[name.strip()] = body
    return out


def main(argv: list[str]) -> int:
    other = os.path.abspath(argv[0])
    here_csrc = os.path.join(REPO, "sdpcutsel_tpu_torch", "csrc")
    there_csrc = os.path.join(other, "sdpcutsel_tpu_torch", "csrc")
    names = argv[1:] or sorted(f[:-3] for f in os.listdir(here_csrc)
                               if f.endswith(".cu") and os.path.exists(os.path.join(there_csrc, f)))
    base = os.path.join(REPO, "build", "sass")
    procs = cubins(REPO, names, os.path.join(base, "this")) + cubins(
        other, names, os.path.join(base, "other"))
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            print(log)
            return 2
    differ = 0
    for n in names:
        a = kernels(os.path.join(base, "this", f"{n}.cubin"))
        b = kernels(os.path.join(base, "other", f"{n}.cubin"))
        same = [k for k in a if k in b and a[k] == b[k]]
        changed = [k for k in a if k in b and a[k] != b[k]]
        differ += len(changed)
        print(f"[sass] {n}.cu: {len(same)} kernels the same, {len(changed)} differ "
              f"{changed}; only here {sorted(set(a) - set(b))}; only there "
              f"{sorted(set(b) - set(a))}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
