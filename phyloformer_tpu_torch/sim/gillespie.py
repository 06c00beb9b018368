"""Gillespie CTMC sequence simulator over arbitrary state spaces — the
CherryML coevolution data generator.

Re-implements the reference's `bin/simulateWithCoevolution/src/simulateGillespie.py`
(400-state paired-amino-acid alphabet, exchangeabilities ∘ equilibrium
frequencies, unit expected rate, per-site exponential waiting times simulated
preorder from an equilibrium root — ``computeScale`` ``:21-25``, build+rescale
``:69-81``, ``simulateSiteAlongBranch`` ``:28-42``) plus the ``simcherry.sh``
pairing convention (each simulated site is an amino-acid *pair*, so
``seqlen = L/2`` yields length-L protein sequences, ``simcherry.sh:33-38``).

The reference's coevolution rate files are absent from its snapshot
(``.MISSING_LARGE_BLOBS``); we accept the same file format
(whitespace tables with state headers) and also provide an LG⊗LG product
model with an optional coevolution coupling for self-contained generation.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.fasta import Alignment
from ..data.newick import Node
from .models import get_model

AA20 = "ARNDCQEGHILKMFPSTWYV"


@dataclasses.dataclass
class CTMCModel:
    states: List[str]  # state labels, e.g. 400 amino-acid pairs "AR"
    rate_matrix: np.ndarray  # (S, S) generator, rows sum to 0, unit expected rate
    freqs: np.ndarray  # stationary distribution


def compute_scale(q: np.ndarray, freqs: np.ndarray) -> float:
    """Expected substitution rate (reference ``computeScale`` ``:21-25``)."""
    return float(-(freqs * np.diag(q)).sum())


def build_ctmc(
    exchangeabilities: np.ndarray, freqs: np.ndarray, states: Sequence[str]
) -> CTMCModel:
    """Rate matrix = exchangeabilities ∘ freqs, diagonal fixed, rescaled to
    unit expected rate (reference ``:69-81``)."""
    q = exchangeabilities * freqs[None, :]
    np.fill_diagonal(q, 0.0)
    q[np.diag_indices(len(freqs))] = -q.sum(axis=1)
    q = q / compute_scale(q, freqs)
    return CTMCModel(list(states), q, np.asarray(freqs, dtype=np.float64))


def load_rate_table(path) -> Tuple[np.ndarray, List[str]]:
    """Parse a whitespace table with a state-label header row (CherryML
    ``coevolution.txt`` style)."""
    lines = [ln for ln in Path(path).read_text().splitlines() if ln.strip()]
    header = lines[0].split()
    n = len(header)
    mat = np.zeros((n, n))
    for i, ln in enumerate(lines[1 : n + 1]):
        fields = ln.split()
        row = fields[1:] if len(fields) == n + 1 else fields
        mat[i] = [float(x) for x in row]
    return mat, header


def load_stationary(path) -> Tuple[np.ndarray, List[str]]:
    lines = [ln for ln in Path(path).read_text().splitlines() if ln.strip()]
    two_col = all(
        len(ln.split()) == 2 and _is_float(ln.split()[1]) for ln in lines
    )
    if two_col:  # "<state> <freq>" rows
        states = [ln.split()[0] for ln in lines]
        vals = np.asarray([float(ln.split()[1]) for ln in lines])
    elif len(lines) >= 2 and not _is_float(lines[0].split()[0]):
        # header row of states, then values
        states = lines[0].split()
        vals = np.array([float(x) for ln in lines[1:] for x in ln.split()])
    else:
        states = []
        vals = np.array([float(x) for ln in lines for x in ln.split()])
    vals = vals / vals.sum()
    return vals, list(states)


def _is_float(x: str) -> bool:
    try:
        float(x)
        return True
    except ValueError:
        return False


def coevolution_model_from_files(rates_path, stationary_path) -> CTMCModel:
    exch, states = load_rate_table(rates_path)
    freqs, st2 = load_stationary(stationary_path)
    if st2 and st2 != states:
        order = [st2.index(s) for s in states]
        freqs = freqs[order]
    return build_ctmc(exch, freqs, states)


def paired_lg_model(coupling: float = 0.0) -> CTMCModel:
    """400-state product model: two LG sites evolving jointly.

    ``coupling`` in [0, 1) boosts exchangeabilities between pair-states whose
    two substitutions are 'compensatory' (both positions change at once) —
    coupling 0 is two independent LG sites.
    """
    lg = get_model("LG")
    R1, pi1 = lg.exchangeabilities, lg.freqs
    states = [a + b for a in AA20 for b in AA20]
    n = 400
    R = np.zeros((n, n))
    eye = np.eye(20)
    # single-position changes: R[(a,b) -> (c,b)] = R1[a,c]; [(a,b)->(a,d)] = R1[b,d]
    R += np.kron(R1, eye)
    R += np.kron(eye, R1)
    if coupling > 0:
        R += coupling * np.kron(R1, R1)  # double substitutions
    freqs = np.kron(pi1, pi1)
    return build_ctmc(R, freqs, states)


def simulate_site_along_branch(
    rng: np.random.Generator, model: CTMCModel, state: int, t: float
) -> int:
    """Exponential waiting-time simulation of one site over one branch
    (reference ``simulateSiteAlongBranch`` ``:28-42``)."""
    q = model.rate_matrix
    elapsed = 0.0
    while True:
        rate = -q[state, state]
        if rate <= 0:
            return state
        elapsed += rng.exponential(1.0 / rate)
        if elapsed >= t:
            return state
        probs = q[state].copy()
        probs[state] = 0.0
        probs /= probs.sum()
        state = int(rng.choice(len(probs), p=probs))


def simulate_alignment_ctmc(
    tree: Node,
    model: CTMCModel,
    n_sites: int,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, List[int]]:
    """Preorder simulation; returns leaf-name -> list of state indices."""
    rng = rng if rng is not None else np.random.default_rng()
    root_states = rng.choice(len(model.freqs), size=n_sites, p=model.freqs)
    out: Dict[str, List[int]] = {}

    def down(node: Node, states: np.ndarray):
        if node.is_leaf:
            out[node.name] = [int(s) for s in states]
            return
        for child in node.children:
            t = child.length or 0.0
            child_states = np.array(
                [simulate_site_along_branch(rng, model, int(s), t) for s in states]
            )
            down(child, child_states)

    down(tree, root_states)
    return out


def states_to_alignment(
    leaf_states: Dict[str, List[int]], model: CTMCModel
) -> Alignment:
    """Concatenate state labels into protein sequences (pairs → 2 residues,
    ``simcherry.sh`` convention) and encode as an Alignment."""
    from ..data.alphabet import encode_bytes

    names = list(leaf_states)
    rows = []
    for name in names:
        seq = "".join(model.states[s] for s in leaf_states[name])
        rows.append(encode_bytes(seq.encode()))
    return Alignment(codes=np.stack(rows).astype(np.int8), ids=names)


def simulate_coevolution_msa(
    tree: Node,
    seq_len: int,
    model: Optional[CTMCModel] = None,
    rng: Optional[np.random.Generator] = None,
) -> Alignment:
    """CherryML-style MSA: ``seq_len`` residues = ``seq_len // 2`` pair sites."""
    model = model or paired_lg_model(coupling=0.5)
    leaf_states = simulate_alignment_ctmc(tree, model, seq_len // 2, rng)
    return states_to_alignment(leaf_states, model)
