"""Variants of K1's, K2's, K4's, K5's, K6's, K7's, K9's, K10's, K11's and
K13's sources timed side by side on one card.

    python sybil_tpu_torch/kernel_variants.py [NAME,NAME,...]

Each variant is a copy of `csrc/` under `archive_check/var/<name>/` with
text replacements in one source (and, where the wrapper must agree, module
constants of ops/scan.py set in the timing process), built by `nvcc` in
parallel, then timed in a fresh process each, in two rounds (the second
in reverse order) on the same card: K2 (dense_scan) at config 1's,
config 1's global form's, config 3's and config 2's shapes and config 4's
three windowed layouts; K1 (decode_bucket2) at k2_ab.py's K1 shapes;
K7 and sort_permute (sorted_front) at k2_ab.py's K7 and sort_permute
shapes; K10 (sorted_pack) at k2_ab.py's K10 shapes (pack_runs); K4
(dense_hist) and K13 (hll_registers) at k2_ab.py's K4 and K13 shapes
(hist_hll_runs); K6 (decode_value) at k2_ab.py's K6 runs (the id mode and
every width of the value mode) and K11 (enum_segments) at its config-5
runs; K9 (hist_pairs: both entries) and K5 (outlier_compact) at k2_ab.py's
path-1 runs (b5_runs).  A variant that drops work (the row pass, the adds)
gives wrong words: it only splits the time.  Prints each run's wall and
device ms (k2_ab._ms) and the ptxas spill lines of the variant's build.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "sybil_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "archive_check", "var")
K2S, K1S, K7S = "dense_scan", "decode_bucket2", "sorted_front"
K10S, K4S, K13S = "sorted_pack", "dense_hist", "hll_registers"
K6S, K11S = "decode_value", "enum_segments"
K9S, K5S = "hist_pairs", "outlier_compact"
# name -> (source, [(old, new)], {ops/scan.py constant: value})
VARIANTS = {
    "k2 as committed": (K2S, [], {}),
    "k2 2 rows a lane": (K2S, [("constexpr int TU = 4;",
                                "constexpr int TU = 2;")], {"_K2_ROWS": 2}),
    "k2 8 rows a lane": (K2S, [("constexpr int TU = 4;",
                                "constexpr int TU = 8;")], {"_K2_ROWS": 8}),
    "k2 4 rows a step": (K2S, [("constexpr int TH = 2;",
                                "constexpr int TH = 4;")], {}),
    "k2 a table a CTA": (K2S, [], {"_K2_WARP_TABLES": 0}),
    "k2 gids only": (K2S, [("      } else if (any) {",
                            "      } else if (false) {")], {}),
    "k7 as committed": (K7S, [], {}),
    "k7 2 rows a lane": (K7S, [("constexpr int TU = 4;",
                                "constexpr int TU = 2;")], {"_K7_ROWS": 2}),
    "k7 8 rows a lane": (K7S, [("constexpr int TU = 4;",
                                "constexpr int TU = 8;")], {"_K7_ROWS": 8}),
    "k7 512 threads 2 CTAs a SM": (K7S, [
        ("constexpr int TT = 1024;", "constexpr int TT = 512;"),
        ("__launch_bounds__(TT, 1) sorted_front_tiles",
         "__launch_bounds__(TT, 2) sorted_front_tiles")],
        {"_K7_THREADS": 512, "_K7_CTAS": 2}),
    "sp 4 rows a lane 8 CTAs a SM": (K7S, [("constexpr int PU = 2;",
                                            "constexpr int PU = 4;")],
                                     {"_PERMUTE_ROWS": 4,
                                      "_PERMUTE_CTAS": 8}),
    "sp 4 rows a lane": (K7S, [("constexpr int PU = 2;",
                                "constexpr int PU = 4;")],
                         {"_PERMUTE_ROWS": 4}),
    "sp 8 CTAs a SM": (K7S, [], {"_PERMUTE_CTAS": 8}),
    "sp 1 row a lane 8 CTAs a SM": (K7S, [("constexpr int PU = 2;",
                                           "constexpr int PU = 1;")],
                                    {"_PERMUTE_ROWS": 1,
                                     "_PERMUTE_CTAS": 8}),
    "sp no cache hints": (K7S, [("__ldcs(p + r + 32 * u)", "p[r + 32 * u]"),
                               ("__stcs(base_out + r + 32 * u, j[u])",
                                "base_out[r + 32 * u] = j[u]"),
                               ("__stcs(gathered + r + 32 * u, g[u])",
                                "gathered[r + 32 * u] = g[u]")], {}),
    "sp nxt kept in L2 (evict_last)": (K7S, [
        ("template <bool BASE, bool GATHER>\n__global__",
         "__device__ __forceinline__ long long ld_last(const long long* q) "
         "{\n  long long v;\n  asm volatile(\"{\\n\\t.reg .b64 pol;\\n\\t"
         "createpolicy.fractional.L2::evict_last.b64 pol, 1.0;\\n\\t"
         "ld.global.L2::cache_hint.b64 %0, [%1], pol;\\n}\" : \"=l\"(v) : "
         "\"l\"(q));\n  return v;\n}\n\n"
         "template <bool BASE, bool GATHER>\n__global__"),
        ("g[u] = r + 32 * u < r1 ? nxt[j[u]] : 0ll;",
         "g[u] = r + 32 * u < r1 ? ld_last(nxt + j[u]) : 0ll;")], {}),
    "sp chunks in row order": (K7S, [("if (lane < m) s_ord[rank] = lane;",
                                      "if (lane < m) s_ord[lane] = lane;")],
                               {}),
    "k10 as committed": (K10S, [], {}),
    "k10 look-back 32 tiles a window": (K10S, [
        ("constexpr int LB = 4;", "constexpr int LB = 1;")], {}),
    "k10 table CTAs first": (K10S, [
        ("  if ((int)blockIdx.x >= npc) {\n"
         "    table_part(a, (int)blockIdx.x - npc);",
         "  if ((int)blockIdx.x < a.tctas) {\n"
         "    table_part(a, (int)blockIdx.x);")], {}),
    "k10 pair CTAs alone (no table)": (K10S, [
        ("    table_part(a, (int)blockIdx.x - npc);\n", "")], {}),
    "k10 no pair rows written": (K10S, [
        ("    for (int i = threadIdx.x; i < n * a.W; i += THREADS) {",
         "    for (int i = threadIdx.x; i < 0 * n * a.W; i += THREADS) {")],
        {}),
    "k10 no padding rows written": (K10S, [
        ("  if (lo >= hi) return;", "  if (lo >= hi || hi > lo) return;")],
        {}),
    "k10 mask reads alone": (K10S, [
        ("  const int mine = __popcll(bits);\n",
         "  const int mine = __popcll(bits);\n"
         "  if (bits == 0x123456789abcdefull) a.main[0] = 0;\n  return;\n"),
        ("    pad_part(a, (t - ntile) / NHELP, (t - ntile) % NHELP);",
         "    return;"),
        ("    table_part(a, (int)blockIdx.x - npc);\n", "")], {}),
    "k10 mask reads and look-back alone": (K10S, [
        ("  const int count = s_count[0];\n",
         "  const int count = s_count[0];\n  if (count >= 0) return;\n"),
        ("    pad_part(a, (t - ntile) / NHELP, (t - ntile) % NHELP);",
         "    return;"),
        ("    table_part(a, (int)blockIdx.x - npc);\n", "")], {}),
    "k4 as committed": (K4S, [], {}),
    "k4 2 rows a lane": (K4S, [("constexpr int TU = 4;",
                                "constexpr int TU = 2;")], {}),
    "k4 8 rows a lane": (K4S, [("constexpr int TU = 4;",
                                "constexpr int TU = 8;")], {}),
    "k4 streaming outlier stores": (K4S, [
        ("          a.out_mask[ru] = o;\n"
         "          a.out_val[ru] = o ? cur.v[u] : 0ll;",
         "          __stcs(a.out_mask + ru, (unsigned char)o);\n"
         "          __stcs(a.out_val + ru, o ? cur.v[u] : 0ll);")], {}),
    "k4 no adds (loads and buckets alone)": (K4S, [
        ("      } else if (e >= 0) {", "      } else if (e == -7) {")], {}),
    "k13 as committed": (K13S, [], {}),
    "k13 8 rows a lane": (K13S, [("constexpr int TU = 4;",
                                  "constexpr int TU = 8;")], {}),
    "k13 no OR (register reads alone)": (K13S, [
        ("      if ((old[u] & th) != th) {", "      if ((old[u] & th) == 7u) {")],
        {}),
    "k13 global form: the word read first (no cache)": (K13S, [
        ("        old[u] = e.x == wi[u] ? e.y : 0u;",
         "        old[u] = __ldcg(planes + wi[u]);")], {}),
    "k13 global form: an OR a row (no cache)": (K13S, [
        ("        old[u] = e.x == wi[u] ? e.y : 0u;", "        old[u] = 0u;")],
        {}),
    "k13 no ranks past 8 sent": (K13S, [
        ("      if (rank[u] > TH_MAX) send_high(",
         "      if (rank[u] > 99) send_high(")], {}),
    "k13 one multiply for the int hash": (K13S, [
        ("      h = hash_int(cur.ok[u] ? cur.v[u] : -1ll);",
         "      h = (unsigned long long)(cur.ok[u] ? cur.v[u] : -1ll) * "
         "0x9E3779B97F4A7C15ull;")], {}),
    "k13 no phase 2": (K13S, [
        ("  for (int cb = c0; cb < c1; cb += TT) {",
         "  for (int cb = c0; cb < c1 && a.R < 0; cb += TT) {")], {}),
    "k13 no prefetch": (K13S, [
        ("    load_rows(a, r0 + step + lane, nxt);  // in flight while these "
         "hash\n", ""),
        ("    cur = nxt;\n", "    load_rows(a, r0 + step + lane, cur);\n")],
        {}),
    "k6 as committed": (K6S, [], {}),
    "k6 tiles of 8192 (512 threads)": (K6S, [
        ("constexpr int V_THREADS = 256;", "constexpr int V_THREADS = 512;")],
        {}),
    "k6 tiles of 8192 (8 quads a thread)": (K6S, [
        ("constexpr int V_QUADS = 4; ", "constexpr int V_QUADS = 8; ")], {}),
    "k6 no ticket (tiles by block index)": (K6S, [
        ("    s_tile = (int)atomicAdd(status, 1ull);  // the ticket: tiles in "
         "order\n  __syncthreads();", "    s_tile = 0;"),
        ("  const int tile = s_tile;", "  const int tile = blockIdx.x;")], {}),
    "k6 6 CTAs a SM": (K6S, [
        ("__global__ void __launch_bounds__(V_THREADS) decode_value_kernel(",
         "__global__ void __launch_bounds__(V_THREADS, 6) "
         "decode_value_kernel(")], {}),
    "k6 no look-back (no carry)": (K6S, [
        ("      for (int top = part - 1;; top -= 32) {",
         "      for (int top = part - 1; top < -1; top -= 32) {")], {}),
    "k11 as committed": (K11S, [], {}),
    "k11 1024 threads a SM": (K11S, [("constexpr int TT = 512; ",
                                      "constexpr int TT = 1024; ")],
                              {"_K11_WARPS": 32}),
    "k11 4 rows a lane": (K11S, [("constexpr int RL = 2; ",
                                  "constexpr int RL = 4; ")], {}),
    "k11 phase 1 alone": (K11S, [
        ("  grid.sync();\n\n  // ---- phase 2",
         "  grid.sync();\n  if (a.R > 0) return;\n\n  // ---- phase 2")], {}),
    "k11 phase clocks": (K11S, [
        ("#include <cstring>\n", "#include <cstring>\n#include <cstdio>\n"),
        ("  const int prev0 = lo > 0 && lo < hi ? skey[lo - 1] : 0;\n",
         "  const int prev0 = lo > 0 && lo < hi ? skey[lo - 1] : 0;\n"
         "  unsigned long long T0, T1, T2, T3;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(T0));\n"),
        ("  grid.sync();\n\n  // ---- phase 2",
         "  grid.sync();\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(T1));\n"
         "\n  // ---- phase 2"),
        ("  // the range's tail: its sums past its last start",
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(T2));\n"
         "  // the range's tail: its sums past its last start"),
        ("  grid.sync();\n\n  // ---- phase 3",
         "  grid.sync();\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(T3));\n"
         "  if ((blockIdx.x == 0 || blockIdx.x == gridDim.x - 1) && "
         "threadIdx.x == 0)\n"
         "    printf(\"k11 clocks: CTA %d: phase 1 %llu ns, phase 2 %llu ns, "
         "tails and barrier %llu ns\\n\", blockIdx.x, T1 - T0, T2 - T1, "
         "T3 - T2);\n\n  // ---- phase 3")], {}),
    "k11 no gathers": (K11S, [
        ("        v[j] = lv ? vals[r[j]] : 0ll;\n"
         "        if (lv && valid[r[j]]) ok |= 1u << j;",
         "        v[j] = lv ? r[j] : 0ll;\n        if (lv) ok |= 1u << j;")],
        {}),
    "k11 no scans": (K11S, [
        ("  unsigned long long c[4][RL], inc[4];",
         "  for (int n = 0; n < 4; ++n)\n"
         "    for (int j = 0; j < RL; ++j) seg[n][j] = x[n][j];\n"
         "  if (lane < 32) return;\n"
         "  unsigned long long c[4][RL], inc[4];")], {}),
    "k1 as committed": (K1S, [], {}),
    "k1 scan pass alone": (K1S, [
        ("  bucket_rows<<<dim3(a.nr, a.B), THREADS, shm, s>>>(a);\n", "")],
        {}),
    "k1 16 postings a thread": (K1S, [("constexpr int ITEMS = 8;",
                                       "constexpr int ITEMS = 16;")], {}),
    "k1 512 threads": (K1S, [("constexpr int THREADS = 256;",
                              "constexpr int THREADS = 512;")], {}),
    "k1 16 row ranges": (K1S, [("constexpr int NR = 32;",
                                "constexpr int NR = 16;")], {}),
    "k9 as committed": (K9S, [], {}),
    "k9 tiles of 16384 (four chunks)": (K9S, [
        ("constexpr int CHUNKS = 1;", "constexpr int CHUNKS = 4;")],
        {"_PAIRS_TILE": 16384}),
    "k9 tiles of 65536 (16 chunks)": (K9S, [
        ("constexpr int CHUNKS = 1;", "constexpr int CHUNKS = 16;")],
        {"_PAIRS_TILE": 65536}),
    "k9 rows alone (no carry or walk)": (K9S, [
        ("    Carry total;\n    const Carry in = combine(",
         "    if (lo >= 0) continue;\n    Carry total;\n"
         "    const Carry in = combine(")], {}),
    "k9 no walk": (K9S, [("  if (s_head_ends && warp == 0) {",
                          "  if (false && s_head_ends && warp == 0) {")], {}),
    "k9 prep 8 CTAs a SM": (K9S, [
        ("__global__ void __launch_bounds__(THREADS) prep_kernel",
         "__global__ void __launch_bounds__(THREADS, 8) prep_kernel")], {}),
    "k5 as committed": (K5S, [], {}),
    "k5 mask reads alone": (K5S, [
        ("  const int mine = __popcll(bits);\n",
         "  const int mine = __popcll(bits);\n"
         "  if (bits == 0x123456789abcdefull) a.out[0] = 0;\n  return;\n"),
        ("    pad_part(a, t - a.ntiles);", "    ;")], {}),
    "k5 mask reads and count sums alone": (K5S, [
        ("  const int count = s_count[0];\n",
         "  const int count = s_count[0];\n  if (count >= 0) return;\n"),
        ("    pad_part(a, t - a.ntiles);", "    ;")], {}),
    "k5 16 helpers": (K5S, [("constexpr int NHELP = 8;",
                             "constexpr int NHELP = 16;")],
                      {"_OUTLIER_HELPERS": 16}),
    "k5 4 helpers": (K5S, [("constexpr int NHELP = 8;",
                            "constexpr int NHELP = 4;")],
                     {"_OUTLIER_HELPERS": 4}),
    "k5 4 status words a lane a round": (K5S, [
        ("constexpr int LB = 16;", "constexpr int LB = 4;")], {}),
    "k9 tiles of 8192 (two chunks)": (K9S, [
        ("constexpr int CHUNKS = 1;", "constexpr int CHUNKS = 2;")],
        {"_PAIRS_TILE": 8192}),
}


def make(name: str) -> str:
    """The variant's copy of csrc/ -> its directory."""
    src, reps, consts = VARIANTS[name]
    d = os.path.join(OUT, name.replace(" ", "_"))
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(os.path.join(d, "build"))
    for f in os.listdir(CSRC):
        if f.endswith((".cu", ".cuh")):
            shutil.copy(os.path.join(CSRC, f), d)
    path = os.path.join(d, src + ".cu")
    with open(path) as f:
        text = f.read()
    for old, new in reps:
        if old not in text:
            raise SystemExit(f"variant {name!r}: {old!r} is not in {src}.cu")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    with open(os.path.join(d, "consts.json"), "w") as f:
        json.dump(consts, f)
    return d


def k2_shapes(scan, dev) -> list:
    """(label, iterations, call) of K2 at configs 1 (and its global form)
    and 3, as k2_ab.py builds them, config 2 and config 4's layouts."""
    import numpy as np
    import torch

    import k2_ab
    rng = np.random.default_rng(0)
    B, C = 128, 65536
    R = B * C

    def col(v, p):
        return (torch.from_numpy(np.asarray(v, np.int64).reshape(B, C))
                .to(dev),
                torch.from_numpy(rng.random(R) < p).reshape(B, C).to(dev))

    cols = {"host": col(rng.integers(0, 5, R), 0.93),
            "ping": col(np.abs(rng.normal(60, 20, R)).astype(np.int64), 0.89),
            "status": col(rng.integers(0, 5, R), 1.0)}
    nrec = torch.full((B,), C, dtype=torch.int32, device=dev)
    c1 = scan.ScanConfig(group_cols=("host",),
                         aggs=(scan.AggSpec("ping", 0, 0, 0, 0, 200),),
                         filters=(), key_bounds=((0, 5),))
    c3 = scan.ScanConfig(group_cols=("host",),
                         aggs=(scan.AggSpec("ping", 0, 1, 166, 0, 165),),
                         filters=(scan.FilterSpec("status", "eq", "str"),),
                         key_bounds=((0, 5),))
    fv = torch.tensor([0], dtype=torch.int64, device=dev)
    cols1 = {k: cols[k] for k in ("host", "ping")}
    return ([("K2 config-1 shape", 20,
              lambda: scan.dense_scan(c1, cols1, nrec)),
             ("K2 global form at config-1 shape", 20,
              lambda: scan.dense_scan(c1, cols1, nrec, form="global")),
             ("K2 config-3 shape", 20,
              lambda: scan.dense_scan(c3, cols, nrec, fv))]
            + list(k2_ab.c2_runs(scan, dev)) + list(k2_ab.c4_runs(scan, dev)))


def child(d: str, src: str) -> None:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "sybil_tpu_torch"))
    import torch

    import k2_ab
    from sybil_tpu_torch.ops import kernels, scan
    kernels.CSRC, kernels.BUILD_DIR = d, os.path.join(d, "build")
    with open(os.path.join(d, "consts.json")) as f:
        for k, v in json.load(f).items():
            setattr(scan, k, v)
    dev = torch.device("cuda")
    # a sort_permute variant ("sp ...") times sort_permute's runs alone
    runs = (k2_shapes(scan, dev) if src == K2S else
            [r for r in k2_ab.hist_hll_runs(scan, dev)
             if r[0].startswith("K4 " if src == K4S else "K13 ")]
            if src in (K4S, K13S) else
            list(k2_ab.k1_runs(dev)) if src == K1S else
            [r for r in k2_ab.k6_runs(dev) if "torch call" not in r[0]]
            if src == K6S else
            [r for r in k2_ab.k11_runs(scan, dev) if "torch call" not in r[0]]
            if src == K11S else
            [r for r in k2_ab.pack_runs(scan, dev) if r[0].startswith("K10")]
            if src == K10S else
            [r for r in k2_ab.b5_runs(scan, dev)
             if r[0].startswith(("B5 hist_prep", "B5 hist_pairs"))]
            if src == K9S else
            [r for r in k2_ab.b5_runs(scan, dev) if r[0].startswith("K5")]
            if src == K5S else
            list(k2_ab.permute_runs(scan, dev)) if
            os.path.basename(d).startswith("sp_") else
            list(k2_ab.k7_runs(scan, dev) + k2_ab.permute_runs(scan, dev)))
    name = os.path.basename(d)
    for what, n, fn in runs:
        print(f"{name}: {what}: {k2_ab._ms(fn, n):.4f} ms wall, "
              f"{k2_ab._ms(fn, n, queued=True):.4f} ms device", flush=True)
    with open(os.path.join(d, "build", src + ".log")) as f:
        spills = sorted({line.strip() for line in f if "spill stores" in line
                         and " 0 bytes spill stores" not in line})
    print(f"{name}: ptxas spill lines {spills}", flush=True)


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1], argv[2])
        return 0
    names = argv[0].split(",") if argv else list(VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dirs = [(make(n), VARIANTS[n][0]) for n in names]
    # the sources no variant edits, built once for every variant's runs
    shared = os.path.join(OUT, "shared_build")
    edited = sorted({src for _, src in dirs})
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from sybil_tpu_torch.ops import kernels; "
             "kernels.CSRC, kernels.BUILD_DIR = sys.argv[2], sys.argv[3]; "
             "kernels.build(tuple(sys.argv[4].split(',')))")
    builds = [subprocess.Popen([
        sys.executable, "-c", build, ROOT, d, os.path.join(d, "build"),
        src]) for d, src in dirs]
    sys.path.insert(0, ROOT)
    from sybil_tpu_torch.ops import kernels
    rest = subprocess.Popen([sys.executable, "-c", build, ROOT, CSRC, shared,
                             ",".join(n for n in kernels.SOURCES
                                      if n not in edited)])
    failed = {d for (d, _), p in zip(dirs, builds) if p.wait()}
    rest.wait()
    for d, _ in dirs:
        for f in os.listdir(shared):
            if f.endswith(".so"):
                shutil.copy(os.path.join(shared, f), os.path.join(d, "build"))
    for d in failed:
        print(f"{os.path.basename(d)}: the build failed", flush=True)
    dirs = [(d, src) for d, src in dirs if d not in failed]
    for order in (dirs, dirs[::-1]):
        for d, src in order:
            if subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", d, src]).returncode:
                print(f"{os.path.basename(d)}: the run failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
