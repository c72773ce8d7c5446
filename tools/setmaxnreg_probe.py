"""Register probe for kernel B2's dk/dv body on Hopper (sm_90a).

    python3 tools/setmaxnreg_probe.py

Compiles ``tools/setmaxnreg_probe.cu`` (the dk/dv step: dk and dv
[64 x 128] f32 a warpgroup beside S^T and dP^T) with nvcc in several
block layouts and prints one JSON line each: ptxas's registers, spill
bytes and warnings (C75xx: setmaxnreg ignored, wgmma serialised), and
the local-memory loads and stores (LDL/STL) in the SASS and
``cuobjdump -res-usage``'s line. ptxas -v prints the register count a
block is launched with (65536 / 384 threads rounded down: 168), not
what the consumers hold after ``setmaxnreg.inc``, so the SASS is the
judge: no LDL/STL and no C75xx warning means the body fits. One layout
adds a wait with a trapping timeout to the consumers' path, as kernel
B1's barrier waits have. Needs nvcc and cuobjdump (the CUDA toolkit),
no GPU. Cubins go to ``build/setmaxnreg_probe/`` (git-ignored).
"""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "tools" / "setmaxnreg_probe.cu"
OUT = ROOT / "build" / "setmaxnreg_probe"
# name: (threads, producer registers, consumer registers, q width, a
# trapping wait in the consumers' path)
CONFIGS = {
    "384_dec24_inc240_q64": (384, 24, 240, 64, 0),
    "384_dec40_inc232_q64": (384, 40, 232, 64, 0),
    "384_dec40_inc232_q64_trap": (384, 40, 232, 64, 1),
    "384_none_q64": (384, 0, 0, 64, 0),
    "288_none_q64": (288, 0, 0, 64, 0),
    "384_dec24_inc240_q32": (384, 24, 240, 32, 0),
    "384_none_q32": (384, 0, 0, 32, 0),
}


def _tool(name):
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / name
    return str(path) if path.exists() else shutil.which(name)


def probe(name, threads, prod, cons, qn, trap):
    OUT.mkdir(parents=True, exist_ok=True)
    cubin = OUT / f"{name}.cubin"
    build = subprocess.run(
        [_tool("nvcc"), "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-cubin", "-Xptxas", "-v", f"-DPROBE_THREADS={threads}",
         f"-DPROBE_PROD={prod}", f"-DPROBE_CONS={cons}", f"-DPROBE_QN={qn}",
         f"-DPROBE_TRAP={trap}", "-o", str(cubin), str(SOURCE)],
        capture_output=True, text=True)
    log = build.stdout + build.stderr
    row = {"config": name, "threads": threads, "setmaxnreg_dec": prod,
           "setmaxnreg_inc": cons, "q_width": qn, "trap": bool(trap),
           "rc": build.returncode}
    if build.returncode:
        row["log"] = log[-2000:]
        return row
    used = re.search(r"Used (\d+) registers", log)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      log)
    row["ptxas_registers"] = int(used.group(1)) if used else None
    row["spill_store_bytes"] = int(spill.group(1)) if spill else None
    row["spill_load_bytes"] = int(spill.group(2)) if spill else None
    row["warnings"] = [ln.strip() for ln in log.splitlines()
                       if re.search(r"C75\d\d|warning", ln)]
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True).stdout
    row["sass_STL"] = len(re.findall(r"\bSTL\b", sass))
    row["sass_LDL"] = len(re.findall(r"\bLDL\b", sass))
    row["sass_WGMMA"] = len(re.findall(r"\bHGMMA\b", sass))
    row["sass_setmaxnreg"] = len(re.findall(r"USETMAXREG", sass))
    res = subprocess.run([_tool("cuobjdump"), "-res-usage", str(cubin)],
                         capture_output=True, text=True).stdout
    row["res_usage"] = [ln.strip() for ln in res.splitlines()
                        if "REG" in ln]
    return row


def main():
    if _tool("nvcc") is None or _tool("cuobjdump") is None:
        print("setmaxnreg_probe: needs nvcc and cuobjdump", file=sys.stderr)
        return 1
    for name, cfg in CONFIGS.items():
        print(json.dumps(probe(name, *cfg)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
