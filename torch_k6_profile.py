#!/usr/bin/env python3
"""Where K6 pass 1's warp route spends its time, on one CUDA card.

    python3 torch_k6_profile.py [--variants default,packat16] [--mib 64]

Writes ``build/k6_profile/k6_prof.cu``: a copy of
``regex_fpga_tpu_torch/csrc/dfa_block_fns.cu`` with clock64 counters around
the stages of the warp route (a block's walk up to the pack, building its
map, the packed walk of a team, the team's stores, and the whole walk of a
block that does not pack) and with its tuning constants open to ``-D``
(``V_FIRST_CHECK``, ``V_PACK_AT``, ``V_PACK_CHAINS``, ``V_MAX_WARPS``,
``V_PRING``, ``V_WRING``). Each variant is compiled by its own nvcc, all
at once, into a library of its own, and run on the 300-keyword Aho-Corasick
DFA (36, 836) over the class ids of ``--mib`` MiB of seeded random bytes in
blocks of 1,024. For each variant it prints the time (CUDA events, the mean
of 10 launches after one), whether the result equals the package's own
kernel bit for bit, how many blocks packed and with how many survivors,
and the cycles a warp spends in each stage (clock64 sums over all warps
divided by the blocks or teams they cover), with the card's name and power
limit. A card is needed; the package's own build is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "k6_profile")
VARIANTS = {  # name -> the -D flags of that variant
    "default": [],
    "packat16": ["-DV_PACK_AT=16"],
    "pack2": ["-DV_PACK_CHAINS=2"],
    "check4": ["-DV_FIRST_CHECK=4", "-DV_PACK_AT=4"],
}
WORDS = [w % i for i in range(300)
         for w in (b"error%04d", b"warning%03d", b"GET /path%d HTTP",
                   b"user-agent: bot%d", b"fail%dure")]


def instrumented_source() -> str:
    """dfa_block_fns.cu with the stage counters and the open constants."""
    src = open(os.path.join(ROOT, "regex_fpga_tpu_torch", "csrc",
                            "dfa_block_fns.cu")).read()

    def rep(old, new):
        nonlocal src
        if old not in src:
            raise RuntimeError(f"the kernel source changed: {old[:60]!r} not found")
        src = src.replace(old, new, 1)

    for name in ("FIRST_CHECK", "PACK_AT", "PACK_CHAINS", "MAX_WARPS", "PRING", "WRING"):
        m = re.search(r"constexpr int %s = (\d+);" % name, src)
        rep(m.group(0), f"#ifndef V_{name}\n#define V_{name} {m.group(1)}\n#endif\n"
                        f"constexpr int {name} = V_{name};")
    rep("namespace {\n", "namespace {\n__device__ unsigned long long prof[16];\n")
    rep("""    unsigned packed = 0;
    int kp = 0;
    for (int g = 0; g < team; ++g) {""", """    unsigned packed = 0;
    int kp = 0;
    long long t_a = clock64();
    for (int g = 0; g < team; ++g) {""")
    rep("""      const size_t out0 = (size_t)n * S;
      k.row = a.cls + (size_t)n * B;""", """      const size_t out0 = (size_t)n * S;
      t_a = clock64();
      k.row = a.cls + (size_t)n * B;""")
    rep("""        if (t < B) {  // packed: the rest of the block walks in the team's pack
          pack_block(k, g, live, np);""", """        long long t_p = clock64();
        if (k.lane == 0) {
          atomicAdd(&prof[t < B ? 0 : 1], (unsigned long long)(t_p - t_a));
          atomicAdd(&prof[t < B ? 6 : 7], 1ull);
        }
        if (t < B) {  // packed: the rest of the block walks in the team's pack
          pack_block(k, g, live, np);
          if (k.lane == 0) {
            atomicAdd(&prof[2], (unsigned long long)(clock64() - t_p));
            atomicAdd(&prof[9 + min(live, 4)], 1ull);
          }""")
    rep("""    if (!packed) continue;
    __syncwarp();""", """    if (!packed) continue;
    __syncwarp();
    long long t_w = clock64();""")
    rep("""    // every start state of a packed block takes its survivor's final state""",
        """    long long t_r = clock64();
    if (k.lane == 0) {
      atomicAdd(&prof[3], (unsigned long long)(t_r - t_w));
      atomicAdd(&prof[14], (unsigned long long)kp);
      atomicAdd(&prof[15], 1ull);
    }
    // every start state of a packed block takes its survivor's final state""")
    rep("""        a.out[out0 + s] = (int)k.pst[g * PACK_CHAINS + j];
      }
    }""", """        a.out[out0 + s] = (int)k.pst[g * PACK_CHAINS + j];
      }
    }
    if (k.lane == 0) atomicAdd(&prof[4], (unsigned long long)(clock64() - t_r));""")
    return src + """
extern "C" int k6_prof_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(prof, z, sizeof z);
}
extern "C" int k6_prof_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, prof, sizeof(unsigned long long) * 16);
}
"""


def event_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help=f"comma-separated, of {list(VARIANTS)}")
    parser.add_argument("--mib", type=int, default=64, help="MiB of random bytes")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_k6_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from regex_fpga_tpu_torch import _build
    from regex_fpga_tpu_torch.models import build_aho_corasick
    from regex_fpga_tpu_torch.ops import hopper_dfa as hd
    from regex_fpga_tpu_torch.ops.tables import build_dfa_tables

    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "k6_prof.cu")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    names = [v for v in args.variants.split(",") if v]
    builds = {}
    for name in names:  # one nvcc a variant, all at once
        lib = os.path.join(OUT, f"k6_{name}.so")
        cmd = [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC),
               *VARIANTS[name], "-o", lib, cu]
        builds[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)

    dev = torch.device("cuda")
    ac = build_aho_corasick(WORDS[:300]).dfa
    t = build_dfa_tables(ac.table, ac.accept, device=dev)
    rng = np.random.default_rng(1)
    noise = torch.as_tensor(rng.integers(0, 256, args.mib << 20, dtype=np.uint8), device=dev)
    cls = torch.take(t.class_of.to(torch.uint8), noise.long()).reshape(-1, 1024).contiguous()
    table = t.table.contiguous()
    want = hd.dfa_block_fns(table, cls)
    c_dim, s_dim = table.shape
    nb, b = cls.shape
    print(f"the package's kernel: {event_ms(lambda: hd.dfa_block_fns(table, cls)):.4f} ms, "
          f"route {hd.dfa_block_fns_route(c_dim, s_dim, nb, b)}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (path, proc) in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-3000:]}")
            return 1
        lib = ctypes.CDLL(path)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.dfa_block_fns.argtypes = [vp, vp, i, i, i, i, vp, vp]
        lib.k6_prof_read.argtypes = [vp]
        out = torch.empty_like(want)

        def call():
            _build.check(lib.dfa_block_fns(cls.data_ptr(), table.data_ptr(), c_dim, s_dim,
                                           nb, b, out.data_ptr(), stream), name)
        ms = event_ms(call)
        lib.k6_prof_reset()
        call()
        torch.cuda.synchronize()
        raw = (ctypes.c_ulonglong * 16)()
        lib.k6_prof_read(ctypes.addressof(raw))
        p = list(raw)
        packed, other, teams = max(p[6], 1), max(p[7], 1), max(p[15], 1)
        print(f"{name}: {ms:.4f} ms, equal to the package's kernel: {torch.equal(out, want)}; "
              f"blocks packed {p[6]}, walked alone {p[7]}; packed with 1-4 chains {p[10:14]}; "
              f"cycles a warp: a packed block's walk to the pack {p[0] / packed:.0f}, its map "
              f"{p[2] / packed:.0f}, a block walked alone {p[1] / other:.0f}, a team's packed "
              f"walk {p[3] / teams:.0f} (teams {p[15]}, mean chains a lane {p[14] / teams:.2f}) "
              f"and its stores {p[4] / teams:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
