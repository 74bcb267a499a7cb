#!/usr/bin/env python3
"""Where kernel K1 (``csrc/hrvo.cu``) spends its time, on one CUDA device.

Run from the repository root: ``python3 tools/profile_k1.py [--other PATH]``.
It builds variants of the kernel's source with the package's nvcc flags,
all at once:

- ``kept``: the kernel as it ships;
- ``flipped``: ``-DPF_HRVO_SKIP_EXACT=1 -DPF_HRVO_SKIP_FAN=0``, the other
  choice in both modes: exact mode branches past |w|, its sqrt and the
  inside test for a slot of 32 candidates where no pair passes the sign
  test, and fan mode computes every pair;
- ``persistent``: ``-DPF_HRVO_PERSISTENT=1``, one grid of persistent warps
  that stage the next entity's window into shared memory with cp.async
  while the current one is solved;
- ``no_cones``: the kernel with its cone loop removed, so every candidate is
  inside no cone. Its picks are wrong; it is timed only, to split the time
  into the cone loop and the rest (top-K, cones, candidates, pick);
- with ``--other PATH`` (repeatable): another ``hrvo.cu`` with the same C
  interface, for instance an earlier version of the kernel, named after
  its file.

Each runs on ``chip_smoke.py``'s real window (the battle scene 60 frames
into the march, N = 10,256, C2 = 144) and on its first 1,024 and 4,096
rows, exact and fan mode. A line gives the kernel's ms (CUDA events, mean
of 20 launches on inputs warm in L2, as the movement substep leaves them)
and whether every row equals the plain version (NaN equal to NaN). Then
each instance's registers, spills and shared memory (ptxas) and blocks per
SM (the CUDA occupancy query where the source exports
``pf_hrvo_blocks_per_sm``, else from ptxas's registers and shared memory).
The last line is one JSON object with every row.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "permafrost_engine_tpu_torch", "_build", "profile_k1")
LOOP = "for (uint32_t rest = vmask; rest != 0; rest &= rest - 1) {"
TIMED_ONLY = ("no_cones",)
ROWS = (1024, 4096, 10256)
# H100 SXM per SM: registers, shared memory a block's SM can give, threads
REGS_PER_SM, SMEM_PER_SM, THREADS_PER_SM, BLOCKS_PER_SM = 65536, 233472, 2048, 32
THREADS = 128                               # K1's block: 4 warps


def variants(src: str) -> dict:
    """name -> (source text, extra nvcc flags)."""
    if LOOP not in src:
        raise RuntimeError("hrvo.cu changed: update tools/profile_k1.py")
    return {
        "kept": (src, ()),
        "flipped": (src, ("-DPF_HRVO_SKIP_EXACT=1", "-DPF_HRVO_SKIP_FAN=0")),
        "persistent": (src, ("-DPF_HRVO_PERSISTENT=1",)),
        "no_cones": (src.replace(LOOP, LOOP.replace("= vmask", "= 0")), ()),
    }


def build(name: str, text: str, nvcc: str, flags) -> subprocess.Popen:
    src = os.path.join(BUILD, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    return subprocess.Popen(
        [nvcc, *flags, "-o", os.path.join(BUILD, f"lib{name}.so"), src],
        stderr=subprocess.PIPE, text=True)


def ptxas(report: str) -> dict:
    """kernel name -> registers, spill bytes, static shared memory."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = dict(registers=0, spill_stores=0, spill_loads=0, smem=0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(s.group(1)) if s else 0
    return out


def blocks_from_ptxas(regs: int, smem: int) -> int:
    """Blocks of 128 threads per SM: registers rounded to 8 a thread and
    warps allocated whole, shared memory with 1 KB reserved a block."""
    warps = REGS_PER_SM // (32 * ((regs + 7) // 8 * 8))
    by_regs = warps // (THREADS // 32)
    by_smem = SMEM_PER_SM // (smem + 1024)
    return min(by_regs, by_smem, THREADS_PER_SM // THREADS, BLOCKS_PER_SM)


def instance(kernel: str) -> str:
    """'exact/fan' plus the slot count of a mangled hrvo kernel name."""
    mode = "exact" if "ILb1E" in kernel else "fan"
    slots = re.search(r"ILb[01]ELi(\d+)E", kernel)
    kind = "persistent" if "persistent" in kernel else "kernel"
    return f"{kind} {mode}" + (f" slots={slots.group(1)}" if slots else "")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", default=[],
                    help="another hrvo.cu to time beside the variants, named "
                    "after its file (repeatable)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_k1: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from permafrost_engine_tpu_torch.ops import cuda_build
    from permafrost_engine_tpu_torch.ops.crowd_cuda import hrvo_select_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC, "hrvo.cu")) as f:
        todo = variants(f.read())
    for path in opts.other:
        with open(path) as f:
            todo[os.path.splitext(os.path.basename(path))[0]] = (f.read(), ())
    procs = {name: build(name, text, cuda_build.nvcc(),
                         (*cuda_build.NVCC_FLAGS, *defs))
             for name, (text, defs) in todo.items()}
    libs, regs = {}, {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        lib = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
        lib.pf_hrvo_select.restype = ctypes.c_int
        lib.pf_hrvo_select.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        libs[name] = lib
        regs[name] = ptxas(err)

    dev = torch.device("cuda", 0)
    args, _moving = chip_smoke.k1_live_window(dev)
    n_all, c2 = args[5].shape[0], args[5].shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for mode, exact in (("exact", True), ("fan", False)):
        want = hrvo_select_plain(*args, exact=exact)
        for n in ROWS:
            sub = [a[:n].contiguous() for a in args]
            out = torch.empty((n, 2), dtype=torch.float32, device=dev)
            for name, lib in libs.items():
                def run():
                    code = lib.pf_hrvo_select(*(t.data_ptr() for t in sub),
                                              out.data_ptr(), n, c2, int(exact),
                                              stream)
                    if code != 0:
                        raise RuntimeError(f"{name}: CUDA error {code}")
                run()
                torch.cuda.synchronize()
                equal = not bool(chip_smoke.rows_differ(out, want[:n]).any())
                ms = chip_smoke.cuda_ms(run, 20)
                rows.append(dict(variant=name, mode=mode, n=n, c2=c2, ms=ms,
                                 bit_equal=equal))
                print(f"{name} {mode} N={n} C2={c2} ms={ms:.4f} "
                      f"bit_equal={equal}"
                      + (" (timed only)" if name in TIMED_ONLY else ""),
                      flush=True)

    occupancy = []
    for name, kernels in regs.items():
        lib = libs[name]
        query = getattr(lib, "pf_hrvo_blocks_per_sm", None)
        for kernel, r in kernels.items():
            inst = instance(kernel)
            row = dict(variant=name, kernel=kernel, instance=inst, **r,
                       blocks_per_sm_ptxas=blocks_from_ptxas(r["registers"],
                                                             r["smem"]))
            if query is not None and "slots=16" not in inst:
                row["blocks_per_sm_query"] = query(int("exact" in inst), c2)
            occupancy.append(row)
            print(f"{name} {inst}: registers={r['registers']} "
                  f"spill_stores={r['spill_stores']} spill_loads={r['spill_loads']} "
                  f"smem={r['smem']} blocks_per_sm={row['blocks_per_sm_ptxas']}"
                  + (f" (query {row['blocks_per_sm_query']})"
                     if "blocks_per_sm_query" in row else ""), flush=True)
    print(json.dumps({"device": smi, "n_window": n_all, "rows": rows,
                      "ptxas": occupancy}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
