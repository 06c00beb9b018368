"""IQ-TREE2 AliSim passthrough (optional external engine).

Reproduces the reference wrapper's subprocess behavior
(the reference's `alisim.py:91-128`) for users who have ``iqtree2``: model
string assembly (+gamma with prior-sampled alpha), indel flags, duplicate
rejection loop, post-trim.  Gracefully reports absence of the binary.
"""

from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..data.fasta import read_fasta, write_fasta
from .priors import alpha_sampler


def alisim_passthrough(
    trees: List[Path],
    outdir: Path,
    binary: str = "iqtree2",
    length: int = 500,
    substitution: str = "LG",
    gamma: Optional[str] = None,
    indels: bool = False,
    max_attempts: int = 20,
    seed: Optional[int] = None,
    mdef: Optional[str] = None,
) -> List[Tuple[str, int]]:
    if shutil.which(binary) is None:
        raise FileNotFoundError(
            f"iqtree2 binary {binary!r} not found on PATH; use --engine native "
            "(the built-in simulator) instead"
        )
    custom_name = None
    if mdef is not None:
        # reference model-string assembly: +NAME from the mdef's first
        # "frequency" identifier (alisim.py:48-53,255-263)
        from .models import parse_custom_model_name

        custom_name = parse_custom_model_name(mdef)
        if custom_name is None:
            raise ValueError(f"{mdef} is not a valid IQTree model file")
    rng = np.random.default_rng(seed)
    prior = alpha_sampler() if gamma else None
    failures: List[Tuple[str, int]] = []
    for tree in trees:
        out = outdir / (tree.stem + ".fa")
        ok = False
        for attempt in range(1, max_attempts + 1):
            model = substitution
            if custom_name:
                model += f"+{custom_name}"
            if gamma:
                mean = float(prior.sample(rng))
                alpha = max(float(rng.normal(mean, mean / 10.0)), 0.05)
                model += f"+{gamma}{{{alpha}}}"
            cmd = [
                binary, "--alisim", str(outdir / tree.stem), "-t", str(tree),
                "-m", model, "-mwopt", "-af", "fasta", "--seqtype", "AA",
                "--length", str(length), "--threads", "1",
            ]
            if mdef is not None:
                cmd += ["-mdef", str(mdef)]
            if indels:
                cmd += ["--indel", "0.01,0.01", "--indel-size", "GEO{5},GEO{4}"]
            subprocess.run(cmd, capture_output=True, text=True)
            if not out.exists():
                continue
            if indels:  # trim keeping .untrimmed (alisim.py:38-45)
                aln = read_fasta(out, strict=False)
                write_fasta(str(out) + ".untrimmed", aln)
                from ..data.fasta import Alignment

                write_fasta(out, Alignment(codes=aln.codes[:, :length], ids=aln.ids))
            aln = read_fasta(out, strict=False)
            if len({r.tobytes() for r in aln.codes}) == aln.n_seqs:
                ok = True
                break
        if not ok:
            if out.exists():
                out.unlink()
            failures.append((str(tree), max_attempts))
    return failures
