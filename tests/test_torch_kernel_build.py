"""The sweep kernel's build (misti_tpu_torch/kernels/correction_fused.py
`compile_libs`) when several processes build the same libraries at once, as
the ranks of a sharded sweep do at their first launch: each process has nvcc
write a temporary file of its own and moves it into place, so no process can
load another's half-written library.

nvcc is a stub here (the CPU machine has none): a script that records its
``-o`` path, waits, and writes the file.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = """#!/bin/sh
while [ $# -gt 0 ]; do
    if [ "$1" = "-o" ]; then out="$2"; fi
    shift
done
echo "$out" >> "$NVCC_STUB_LOG"
sleep 0.5
echo "library $out" > "$out"
"""

CHILD = textwrap.dedent("""
    import sys
    from pathlib import Path
    from misti_tpu_torch.kernels import correction_fused as cf

    cf.BUILD_DIR = Path(sys.argv[1])
    report = cf.build(force=True)
    assert sorted(report) == sorted(cf._lib_path(c).name for c in (True, False)), report
    assert all(ok for _, _, ok in report.values()), report
""")


def test_concurrent_builds_write_temporary_files_of_their_own(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "nvcc").write_text(STUB)
    (bindir / "nvcc").chmod(0o755)
    build = tmp_path / "build"
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               NVCC_STUB_LOG=str(log), PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(build)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    pids = []
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        pids.append(p.pid)

    outs = log.read_text().split()
    assert len(outs) == 4 and len(set(outs)) == 4  # 2 libraries x 2 processes, no name shared
    for pid in pids:
        mine = [o for o in outs if o.endswith(f".{pid}.tmp")]
        assert len(mine) == 2, outs
    libs = sorted(f.name for f in build.iterdir())
    assert len(libs) == 2 and all(n.endswith(".so") for n in libs), libs  # no .tmp left
    for f in build.iterdir():
        assert f.read_text().startswith("library ")
