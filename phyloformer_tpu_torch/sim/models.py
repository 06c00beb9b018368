"""Amino-acid substitution models (time-reversible GTR-class).

Replaces the reference's hard dependency on the external IQ-TREE2 binary for
model math (its `alisim.py:91-112` shells out for everything).
Ships LG, WAG, JTT (exchangeabilities + equilibrium frequencies recovered
from the vendored FastTree 2.1.11 binary's embedded tables and verified
against the published LG values to 6 decimals), a Poisson model, and a
PAML ``.dat`` loader for arbitrary models.

Rate matrix: ``Q_ij = R_ij * pi_j`` (i != j), rows sum to zero, scaled so the
expected substitution rate ``-sum_i pi_i Q_ii = 1``.  Reversibility gives the
symmetric eigenbasis used for fast ``expm``: with ``S = D Q D^-1``
(``D = diag(sqrt(pi))``) symmetric, ``P(t) = D^-1 U exp(L t) U^T D``.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..data.alphabet import ALPHABET

AA_ORDER = "ARNDCQEGHILKMFPSTWYV"  # PAML order == our alphabet's first 20

_DATA = pathlib.Path(__file__).parent / "data" / "aa_models.npz"


@dataclass
class SubstitutionModel:
    name: str
    exchangeabilities: np.ndarray  # (20, 20) symmetric, zero diagonal
    freqs: np.ndarray  # (20,) sums to 1

    def rate_matrix(self) -> np.ndarray:
        """Normalized generator Q (expected rate 1)."""
        R, pi = self.exchangeabilities, self.freqs
        q = R * pi[None, :]
        np.fill_diagonal(q, 0.0)
        q[np.diag_indices(20)] = -q.sum(axis=1)
        scale = -(pi * np.diag(q)).sum()
        return q / scale

    def eigensystem(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(eigenvalues, left, right) with P(t) = right @ diag(exp(l t)) @ left."""
        q = self.rate_matrix()
        sqrt_pi = np.sqrt(self.freqs)
        s = sqrt_pi[:, None] * q / sqrt_pi[None, :]
        lam, u = np.linalg.eigh((s + s.T) / 2)
        right = u / sqrt_pi[:, None]
        left = u.T * sqrt_pi[None, :]
        return lam, left, right

    def transition_matrix(self, t: float) -> np.ndarray:
        lam, left, right = self.eigensystem()
        p = (right * np.exp(lam * t)[None, :]) @ left
        return np.clip(p, 0.0, None)


def _load_builtin(name: str) -> SubstitutionModel:
    data = np.load(_DATA)
    freqs = np.ascontiguousarray(data[f"{name}_freqs"], dtype=np.float64)
    return SubstitutionModel(
        name=name,
        exchangeabilities=np.ascontiguousarray(data[f"{name}_exch"], dtype=np.float64),
        freqs=freqs / freqs.sum(),
    )


def poisson_model() -> SubstitutionModel:
    R = np.ones((20, 20)) - np.eye(20)
    return SubstitutionModel("Poisson", R, np.full(20, 0.05))


def load_paml_dat(path, name: Optional[str] = None) -> SubstitutionModel:
    """Parse a PAML-format .dat: 19 lower-triangle exchangeability rows then
    a frequency line (whitespace/newline tolerant)."""
    values = []
    for line in pathlib.Path(path).read_text().split("\n"):
        line = line.split("#")[0].strip()
        if line:
            values.extend(float(x) for x in line.split())
    if len(values) < 190 + 20:
        raise ValueError(f"{path}: expected >=210 numbers, got {len(values)}")
    R = np.zeros((20, 20))
    k = 0
    for i in range(1, 20):
        for j in range(i):
            R[i, j] = R[j, i] = values[k]
            k += 1
    freqs = np.asarray(values[k : k + 20])
    freqs = freqs / freqs.sum()
    return SubstitutionModel(name or pathlib.Path(path).stem, R, freqs)


_REGISTRY: Dict[str, object] = {}


def get_model(name: str) -> SubstitutionModel:
    """Look up a model by name ("LG", "WAG", "JTT", "Poisson") or PAML path."""
    key = name.upper()
    if key in _REGISTRY:
        return _REGISTRY[key]  # type: ignore[return-value]
    if key in ("LG", "WAG", "JTT"):
        model = _load_builtin(key)
    elif key in ("POISSON", "EQU"):
        model = poisson_model()
    elif pathlib.Path(name).exists():
        model = load_paml_dat(name)
    else:
        raise ValueError(
            f"unknown substitution model {name!r}; builtins: LG, WAG, JTT, Poisson, "
            "or a PAML .dat path"
        )
    _REGISTRY[key] = model
    return model


def discrete_gamma_rates(alpha: float, k: int) -> np.ndarray:
    """Mean rates of k equal-probability gamma categories (Yang 1994)."""
    from scipy.stats import gamma as gamma_dist

    if k <= 1:
        return np.ones(1)
    edges = gamma_dist.ppf(np.linspace(0, 1, k + 1), alpha, scale=1.0 / alpha)
    # category means via the incomplete-gamma identity
    cdf2 = gamma_dist.cdf(edges, alpha + 1, scale=1.0 / alpha)
    means = (cdf2[1:] - cdf2[:-1]) * k
    return means / means.mean()


@dataclass
class FrequencyMixture:
    """A named mixture of equilibrium-frequency classes (IQ-TREE ``-mdef``
    nexus custom models, consumed by the reference as ``+NAME``,
    ``alisim.py:48-53,79-82,255-263``).  Each alignment site
    belongs to one class; the base model's exchangeabilities are shared."""

    name: str
    classes: "list[np.ndarray]"  # each (20,), normalized
    weights: np.ndarray  # (k,), sums to 1
    rates: Optional[np.ndarray] = None  # (k,) per-class rate multipliers

    def class_rates(self) -> np.ndarray:
        return self.rates if self.rates is not None else np.ones(len(self.classes))

    def class_models(self, base: SubstitutionModel) -> "list[SubstitutionModel]":
        return [
            SubstitutionModel(f"{base.name}+{self.name}_F{i + 1}",
                              base.exchangeabilities, f)
            for i, f in enumerate(self.classes)
        ]


def parse_custom_model_name(path) -> Optional[str]:
    """The reference's model-name convention: the first ``frequency`` line's
    identifier up to the first underscore (`alisim.py:48-53`)."""
    for line in pathlib.Path(path).read_text().splitlines():
        if line.strip().startswith("frequency"):
            return line.split()[1].split("_")[0]
    return None


def load_mdef_nexus(path) -> FrequencyMixture:
    """Parse an IQ-TREE ``-mdef`` nexus model-definition file.

    Supports the subset the reference pipeline uses: ``frequency NAME = f1
    ... f20;`` class statements, plus an optional ``frequency MIXNAME =
    FMIX{C1[:w1],C2[:w2],...};`` statement selecting classes and weights
    (uniform when omitted).  Comments ``[...]`` and the ``begin models; /
    end;`` wrapper are tolerated."""
    import re

    text = pathlib.Path(path).read_text()
    text = re.sub(r"\[[^\]]*\]", " ", text)  # nexus comments
    classes: Dict[str, np.ndarray] = {}
    fmix: Optional[Tuple[str, list]] = None
    for stmt in text.split(";"):
        stmt = stmt.strip()
        if not stmt.lower().startswith("frequency"):
            continue
        m = re.match(r"frequency\s+(\S+)\s*=\s*(.*)", stmt, re.S | re.I)
        if not m:
            continue
        name, rhs = m.group(1), m.group(2).strip()
        if rhs.upper().startswith("FMIX"):
            inner = rhs[rhs.index("{") + 1 : rhs.rindex("}")]
            parts = [p.strip() for p in inner.split(",") if p.strip()]
            fmix = (name, parts)
            continue
        vals = np.array([float(x) for x in rhs.split()])
        if vals.size != 20:
            raise ValueError(
                f"{path}: frequency {name!r} has {vals.size} values, expected 20"
            )
        classes[name] = vals / vals.sum()
    if not classes:
        raise ValueError(f"{path} is not a valid IQTree model file")

    if fmix is not None:
        mix_name, parts = fmix
        sel, weights, rates = [], [], []
        for part in parts:
            # IQ-TREE component syntax: NAME[:rate[:weight]]
            fields = [f.strip() for f in part.split(":")]
            cname = fields[0]
            if cname not in classes:
                raise ValueError(f"{path}: FMIX references unknown class {cname!r}")
            sel.append(classes[cname])
            rates.append(float(fields[1]) if len(fields) > 1 and fields[1] else 1.0)
            weights.append(float(fields[2]) if len(fields) > 2 and fields[2] else 1.0)
        w = np.asarray(weights, dtype=np.float64)
        name = mix_name.split("_")[0]
        return FrequencyMixture(name, sel, w / w.sum(),
                                np.asarray(rates, dtype=np.float64))

    name = parse_custom_model_name(path) or "CUSTOM"
    sel = [classes[k] for k in classes]  # insertion order
    w = np.full(len(sel), 1.0 / len(sel))
    return FrequencyMixture(name, sel, w)
