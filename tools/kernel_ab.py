#!/usr/bin/env python3
"""Run chip_smoke.py's kernel and frontier phases on the port of several
checkouts in turns, on one card.

    python3 tools/kernel_ab.py TREE [TREE ...] [--segments 64,128,256]

TREE is the root of a checkout (`.` for this one), for example the parent
commit unpacked with `git archive` into `build/parent`.  For each TREE in
the order given (parent, change, change, parent compares two versions), a
fresh process puts TREE/src first on the import path and runs this
checkout's `chip_smoke.py` on that tree's package, so every tree sees the
same inputs and the same timer:
  - `phase_kernels`: every kernel against its plain version, timed;
  - `main_path` twice; the second `frontier` line is the warm wall time;
  - `phase_profile`: one more `frontier` call under torch.profiler, with
    the device time of the KW queue's kernels.
With `--segments`, `phase_kernels` and `phase_profile` repeat for each
listed `SEGMENT_JOBS` of `kw_queue`.  chip_smoke's JSON lines pass through,
after the card's name and power limit and, for each run, a line naming its
tree and segment length.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_tree(tree: Path, segments: list[int]) -> None:
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import kw_queue as kw_module

    assert Path(kw_module.__file__).resolve().is_relative_to(tree.resolve()), kw_module.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def each_segment_length():
        for seg in segments or [None]:
            if seg is not None:
                kw_module.SEGMENT_JOBS = seg
            cs.emit("tree", tree=str(tree), segment_jobs=getattr(kw_module, "SEGMENT_JOBS", None))
            yield

    for _ in each_segment_length():
        cs.phase_kernels(torch, dev, cs.FULL)
    for _ in range(2):
        cs.main_path(torch, dev, cs.FULL)
    for _ in each_segment_length():  # warm, as `chip_smoke.py --profile` runs it
        cs.phase_profile(torch, dev, cs.FULL)


def main() -> int:
    args = sys.argv[1:]
    segments = []
    if "--segments" in args:
        i = args.index("--segments")
        segments = [int(v) for v in args[i + 1].split(",")]
        del args[i:i + 2]
    if args[:1] == ["--one"]:
        run_tree(Path(args[1]), segments)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(json.dumps({"nvidia_smi": cs.nvidia_smi()}), flush=True)
    failed = False
    for tree in args:
        cmd = [sys.executable, __file__, "--one", tree] + (["--segments", ",".join(map(str, segments))] if segments else [])
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=1800)
        print(res.stdout, end="", flush=True)
        if res.returncode != 0:
            print(json.dumps({"tree": tree, "rc": res.returncode, "stderr": res.stderr[-3000:]}), flush=True)
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
