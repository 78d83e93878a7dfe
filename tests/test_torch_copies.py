"""The port's copies of the reference's device-free modules stay copies.

sybil_tpu_torch keeps its own copy of every module of sybil_tpu that does
no device work (it may import nothing of sybil_tpu).  Each case compares
one pair with the import lines left out and allows only the departures
written out below, each as (the reference's text, the port's text); a
change to either side that these do not name fails.  The modules that do
device work, which the port rewrote, are listed apart with the reason."""

import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "sybil_tpu")
PORT = os.path.join(REPO, "sybil_tpu_torch")

# shared files the port rewrote: they run the scan on torch, or describe
# their own package
REWRITTEN = {
    "__init__.py": "the package's docstring",
    "__main__.py": "the reference sets JAX_PLATFORMS here",
    "cli.py": "-device, the torch process group",
    "ops/__init__.py": "the device kernels' package",
    "ops/decode.py": "K1 and K6",
    "ops/residency.py": "columns resident on a torch device",
    "ops/scan.py": "the scan's kernels",
    "parallel/__init__.py": "the package's docstring",
    "parallel/mesh.py": "the mesh scan on torch.distributed",
    "parallel/multihost.py": "the torch.distributed process group",
    "query/engine.py": "the engine's device dispatch",
}

NEW = ("recover.py", "trim.py", "inspect_cmd.py", "export.py",
       "query/stats.py", "api.py")

# module -> [(reference text, port text)], on the import-stripped texts
DEPARTURES = {
    "config.py": [
        ("    profile: bool = False            # jax.profiler trace "
         "capture\n",
         "    profile: bool = False            # torch.profiler trace "
         "capture\n"),
        ("    # multi-host runtime (parallel/multihost.py): join N processes "
         "into\n    # one mesh via jax.distributed; 0/-1/\"\" = single "
         "process\n",
         "    # multi-process runtime (parallel/multihost.py): join N "
         "processes\n    # into one mesh via torch.distributed; 0/-1/\"\" = "
         "single process\n"),
        ("    dist_num_processes: int = 0\n",
         "    dist_num_processes: int = 0\n"
         "    # torch device the scan runs on: \"cuda\" (the kernels) or "
         "\"cpu\" (their\n    # plain PyTorch versions); never chosen "
         "automatically\n    device: str = \"cuda\"\n"),
    ],
    "profiler.py": [
        ("(e.g. table_query.go:155-161,367-378).  The TPU-native "
         "equivalents:\n",
         "(e.g. table_query.go:155-161,367-378).  The equivalents here:\n"),
        ("- `-profile` captures a jax.profiler trace (XLA device timeline "
         "+ host\n  events) into `<profile-dir>/`, viewable with "
         "TensorBoard/Perfetto.\n",
         "- `-profile` captures a torch.profiler trace (CUDA kernel "
         "timeline +\n  host events) into `<profile-dir>/trace.json`, "
         "viewable with Perfetto\n  or chrome://tracing.\n"),
        ('    """jax.profiler trace capture around a block (the -profile '
         'flag)."""\n',
         '    """torch.profiler trace capture around a block (the -profile '
         'flag)."""\n'),
        ("    jax.profiler.start_trace(profile_dir)\n    try:\n        yield\n"
         "    finally:\n        jax.profiler.stop_trace()\n"
         "        print_(\"profile trace written to\", profile_dir)\n",
         "\n    acts = [ProfilerActivity.CPU]\n"
         "    if torch.cuda.is_available():\n"
         "        acts.append(ProfilerActivity.CUDA)\n"
         "    with profile(activities=acts) as prof:\n        yield\n"
         "    os.makedirs(profile_dir, exist_ok=True)\n"
         "    path = os.path.join(profile_dir, \"trace.json\")\n"
         "    prof.export_chrome_trace(path)\n"
         "    print_(\"profile trace written to\", path)\n"),
    ],
    "parallel/wire.py": [
        ('"""Node-protocol wire format.\n',
         '"""Node-protocol wire format (the port\'s own copy of '
         'sybil_tpu/parallel/\nwire.py: the two packages write and read the '
         'same results).\n'),
    ],
    "parallel/aggregator.py": [
        ('"""Multi-node result aggregation (the `aggregate` subcommand).\n',
         '"""Multi-node result aggregation (the `aggregate` subcommand; the '
         'port\'s\nown copy of sybil_tpu/parallel/aggregator.py, '
         'device-free).\n'),
    ],
    "api.py": [
        # 1. the subprocess mode spawns the port's CLI
        ("- subprocess: spawns `python -m sybil_tpu …` exactly like the Go "
         "client\n  spawns the sybil binary (process isolation; useful when "
         "embedding in a\n  long-lived server that must bound query "
         "memory).\n",
         "- subprocess: spawns `python -m sybil_tpu_torch …` exactly like "
         "the Go\n  client spawns the sybil binary (process isolation; "
         "useful when embedding\n  in a long-lived server that must bound "
         "query memory).\n"),
        ('        [sys.executable, "-m", "sybil_tpu", *argv],\n',
         '        [sys.executable, "-m", "sybil_tpu_torch", *argv],\n'),
        ('            f"sybil_tpu {argv[0]} failed: '
         '{proc.stderr.decode()[-2000:]}")\n',
         '            f"sybil_tpu_torch {argv[0]} failed: "\n'
         '            f"{proc.stderr.decode()[-2000:]}")\n'),
        # 2. SybilConfig.device, the CLI's -device
        ("set filters work here.\n",
         "set filters work here.\n\n`SybilConfig.device` is the CLI's "
         "`-device`: \"cuda\" (the default) runs the\nscan's kernels and "
         "fails without a card; \"cpu\" runs their plain PyTorch\n"
         "versions, and only when asked for.\n"),
        ('    table: str = ""\n',
         '    table: str = ""\n    device: str = "cuda"\n'),
        ("        return Flags(dir=self.config.dir, "
         "table=self.config.table)\n",
         "        return Flags(dir=self.config.dir, table=self.config.table,\n"
         "                     device=self.config.device)\n"),
        ('                "-json"]\n',
         '                "-json", "-device", self.config.device]\n'),
        # 3. what the in-process mode keeps: kernels and resident columns
        ("  process spawn, and the jit cache is shared across queries.\n",
         "  process spawn, and the kernels built and the columns resident "
         "on the\n  device stay across queries.\n"),
        ("def _run_inprocess(argv: list[str]) -> str:\n",
         "def _run_inprocess(argv: list[str]) -> str:\n"
         '    """The port\'s CLI in this process: the kernels it built and '
         "the\n    columns it keeps resident on the device serve the next "
         "query too.  A\n    non-zero exit (a missing card among them) "
         "raises; nothing falls back\n    to the CPU.\"\"\"\n"),
    ],
}

_IMPORT = re.compile(r"^\s*(import\s|from\s+\S+\s+import\s)")


def _strip_imports(text: str) -> str:
    """The text without its import statements (a parenthesised import's
    continuation lines included)."""
    out, in_paren = [], False
    for line in text.splitlines(keepends=True):
        if in_paren:
            in_paren = ")" not in line
            continue
        if _IMPORT.match(line):
            in_paren = line.rstrip().endswith("(")
            continue
        out.append(line)
    return "".join(out)


def _shared() -> list[str]:
    out = []
    for root, _, files in os.walk(PORT):
        if "build" in root.split(os.sep) or "__pycache__" in root:
            continue
        for f in files:
            if not f.endswith((".py", ".cpp")):
                continue
            rel = os.path.relpath(os.path.join(root, f), PORT)
            if os.path.exists(os.path.join(REF, rel)):
                out.append(rel.replace(os.sep, "/"))
    return sorted(out)


COPIES = [m for m in _shared() if m not in REWRITTEN]


def test_the_copies_cover_every_shared_device_free_module():
    shared = set(_shared())
    assert set(REWRITTEN) <= shared, set(REWRITTEN) - shared
    assert set(NEW) <= set(COPIES)
    assert set(DEPARTURES) <= set(COPIES)
    for mod in ("table.py", "blocks.py", "codec.py", "rowstore.py",
                "query/hist.py", "query/cache.py", "native/walcodec.cpp"):
        assert mod in COPIES


@pytest.mark.parametrize("mod", COPIES)
def test_port_module_is_a_copy_of_the_reference(mod):
    with open(os.path.join(REF, mod)) as f:
        want = _strip_imports(f.read())
    with open(os.path.join(PORT, mod)) as f:
        got = _strip_imports(f.read())
    for ref_text, port_text in DEPARTURES.get(mod, ()):
        assert want.count(ref_text) == 1, (mod, ref_text)
        want = want.replace(ref_text, port_text)
    if got != want:
        import difflib
        diff = "".join(difflib.unified_diff(
            want.splitlines(keepends=True), got.splitlines(keepends=True),
            f"sybil_tpu/{mod} (with the allowed departures)",
            f"sybil_tpu_torch/{mod}", n=1))
        pytest.fail(f"{mod} departs from the reference:\n{diff[:3000]}")
