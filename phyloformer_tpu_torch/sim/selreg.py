"""SelReg (selection-regime) simulation shim.

The reference drives the external OCaml ``pastek`` binary per tree
(the reference's `bin/simselreg.sh:36-45`: ``pastek multiselreg --nsites N
--seed=42 --selreg-weights=25,25,25,25 --Ne 0.5``); the binary is absent from
its snapshot.  This shim reproduces the wrapper loop when ``pastek`` is on
PATH and reports a clear error otherwise.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple


def simulate_selreg(
    tree_dir,
    out_dir,
    n_sites: int = 500,
    seed: int = 42,
    selreg_weights: str = "25,25,25,25",
    ne: float = 0.5,
    binary: str = "pastek",
) -> List[Tuple[str, str]]:
    """Run pastek multiselreg for every tree; returns (tree, error) failures."""
    if shutil.which(binary) is None:
        raise FileNotFoundError(
            f"{binary!r} not found on PATH. SelReg simulation requires the "
            "external pastek binary (OCaml; see github.com/pveber/pastek). "
            "All other data generators (LG+GC, indels, CherryML coevolution) "
            "are built in."
        )
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    failures = []
    for tree in sorted(Path(tree_dir).glob("*.nwk")):
        dest = out / (tree.stem + ".fa")
        cmd = [
            binary, "multiselreg",
            "--tree", str(tree),
            "--nsites", str(n_sites),
            f"--seed={seed}",
            f"--selreg-weights={selreg_weights}",
            "--Ne", str(ne),
            "--output", str(dest),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0 or not dest.exists():
            failures.append((str(tree), proc.stderr.strip()))
    return failures
