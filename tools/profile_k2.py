#!/usr/bin/env python3
"""Where a sweep of kernel K2 (``csrc/integrate.cu``) spends its time, on one
CUDA device.

Run from the repository root: ``python3 tools/profile_k2.py``. It builds two
variants of the kernel's source with the package's nvcc flags:

- ``cluster``: the kernel as it ships (one cluster barrier per sweep, the
  strip edges pushed to the neighbouring blocks through distributed shared
  memory);
- ``block_only``: the same sweeps with the cluster barrier replaced by a
  block barrier and no traffic between blocks, run to the sweep cap. Its
  fields are wrong (the strips never meet); it is timed only, to split a
  sweep into the block's own work and the cluster's exchange.

Both run at every cut (blocks per cluster P, rows per thread M) that fits
the shape, on ``chip_smoke.py``'s K2 batches: the 68-chunk portal-graph
batch, the 192-chunk goal batch, the 2-field 256x256 chase fields and the
256x256 serpentine (where the 1,024-sweep cap binds). Each line gives the
kernel's ms (CUDA events, mean of 20), the sweeps it ran and the us per
sweep, and whether the field is bit-equal to the plain version. The last
line is one JSON object with every row.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "permafrost_engine_tpu_torch", "_build", "profile_k2")
CUTS = {(64, 64): [(4, 4), (4, 8), (2, 4), (2, 8)],
        (256, 256): [(16, 8), (16, 4), (16, 16), (8, 8), (8, 16)]}
BATCHES = ("portal_spans", "goal_tiles", "map_layer0", "map_serpentine")


def variants(src: str) -> dict:
    barrier = "      cluster.sync();\n      src = dst;"
    if barrier not in src:
        raise RuntimeError("integrate.cu changed: update tools/profile_k2.py")
    local = (src.replace(barrier, "      __syncthreads();\n      src = dst;")
             .replace("if (top && up != nullptr)", "if (false)")
             .replace("if (bottom && down != nullptr)", "if (false)")
             .replace("*cluster.map_shared_rank(&bundle_changed[rank], t) = any;",
                      "bundle_changed[t] = any;")
             .replace("if (!any) break;", "(void)any;"))
    return {"cluster": src, "block_only": local}


def build(name: str, text: str, nvcc: str, flags) -> subprocess.Popen:
    src = os.path.join(BUILD, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    return subprocess.Popen([nvcc, *flags, "-o", os.path.join(BUILD, f"lib{name}.so"),
                             src], stderr=subprocess.PIPE, text=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_k2: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from permafrost_engine_tpu_torch import compile_nav_costs
    from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
    from permafrost_engine_tpu_torch.ops import cuda_build
    from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(cuda_build.CSRC, "integrate.cu")) as f:
        procs = {name: build(name, text, cuda_build.nvcc(), cuda_build.NVCC_FLAGS)
                 for name, text in variants(f.read()).items()}
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        lib = ctypes.CDLL(os.path.join(BUILD, f"lib{name}.so"))
        lib.pf_integrate.restype = ctypes.c_int
        lib.pf_integrate.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        libs[name] = lib

    dev = torch.device("cuda", 0)
    cost, _ = compile_nav_costs(make_battle_map())
    batches = chip_smoke.k2_batches(cost)
    rows = []
    for bname in BATCHES:
        c, s, _v = batches[bname]
        ct = torch.from_numpy(c).to(dev)
        st = torch.from_numpy(s).to(dev)
        k, h, w = c.shape
        cap = 4 * max(h, w)
        stats = {}
        want = integrate_plain(ct, st, max_iters=cap, stats=stats)
        out = torch.empty((k, h, w), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for vname, lib in libs.items():
            for p, m in CUTS[(h, w)]:
                def run():
                    code = lib.pf_integrate(ct.data_ptr(), st.data_ptr(), None,
                                            out.data_ptr(), k, h, w, p, m, cap,
                                            stream)
                    if code != 0:
                        raise RuntimeError(f"launch failed: CUDA error {code}")
                run()
                torch.cuda.synchronize()
                equal = bool(torch.equal(out, want))
                ms = chip_smoke.cuda_ms(run, 20)
                sweeps = cap if vname == "block_only" else stats["sweeps"]
                row = dict(batch=bname, variant=vname, k=k, h=h, w=w, p=p, m=m,
                           threads=(h // p // m) * w, ms=ms, sweeps=sweeps,
                           us_per_sweep=1e3 * ms / sweeps, bit_equal=equal)
                rows.append(row)
                print(f"{bname} {vname} K={k} {h}x{w} P={p} M={m} "
                      f"threads={row['threads']} ms={ms:.4f} sweeps={sweeps} "
                      f"us_per_sweep={row['us_per_sweep']:.3f} bit_equal={equal}",
                      flush=True)
    print(json.dumps({"device": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
