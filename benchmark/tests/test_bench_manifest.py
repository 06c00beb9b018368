"""BENCHMARK.json against the contract's rules and the files it names: each
test runs its rule of ``benchmark/manifest.py`` on the repository."""

import json

import pytest

from benchmark import manifest
from conftest import REPO

MANIFEST = manifest.load(REPO)
METRICS = manifest.metrics(MANIFEST)
PHYLOFORMER = {"n_blocks": 6, "n_heads": 4, "embed_dim": 64, "ffn_dim": 256, "in_channels": 22,
               "dropout": 0.0}


def test_top_level_keys():
    assert manifest.top_level_keys(REPO) == []


@pytest.mark.parametrize("entry", METRICS + MANIFEST["workloads"] + MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert manifest.names_and_units(REPO, entry) == []


def test_unique_names():
    assert manifest.unique_names(REPO) == []


def test_end_to_end_rules():
    assert manifest.end_to_end_rules(REPO) == []


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    assert manifest.per_layer_cells(REPO, metric) == []


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cells_have_files(cell):
    assert manifest.cell_files(REPO, cell) == []


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configs_are_published_widths(config):
    assert manifest.published_widths(REPO, config) == []


def test_phyloformer_is_held_to_its_published_widths():
    """The published model fits one chip whole: no key may be cut, and both
    configurations are it, uncut."""
    arch = json.loads((REPO / "benchmark/architectures/phyloformer.json").read_text())
    assert arch["published"] == PHYLOFORMER and arch["may_cut"] == {}
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for name in ("phyloformer-fp32", "phyloformer-tf32"):
        sizes = json.loads((REPO / configs[name]["file"]).read_text())
        assert sizes["architecture"] == "phyloformer" and configs[name]["reduced"] == []
        assert {k: sizes[k] for k in PHYLOFORMER} == PHYLOFORMER
