"""Phyloformer in PyTorch and CUDA for NVIDIA Hopper.

The PyTorch port of :mod:`phyloformer_tpu`: the same inference path (FASTA →
codes → embedding → pair gather → axial blocks → softplus head → distances →
trees) and training, with the axial-block kernels, forward and backward,
written by hand in CUDA C++ for ``sm_90a``.  Module names follow the JAX package so each counterpart is easy to
find.  The package imports ``torch`` and numpy, never ``jax`` and nothing of
``phyloformer_tpu``.

Subpackages
-----------
- ``data``:    FASTA/PHYLIP codecs, pair indexing, newick trees and
               patristic distances; the MSA tools (``pf-msa-torch``).
- ``models``:  configuration, parameter trees, the eager fp32 model.
- ``io``:      reference ``.ckpt`` import, training checkpoints, ``.npz``
               parameter files.
- ``ops``:     scaled linear attention; ``ops.kernels`` holds the CUDA kernels
               and their plain PyTorch versions.
- ``infer``:   bucketed batched inference engine and the ``pf-infer`` CLI.
- ``train``:   losses, schedule, train/eval steps, data loading, the fit
               loop and the ``pf-train-torch`` CLI.
- ``trees``:   neighbour joining, the native BME/NNI/SPR builder and tree
               metrics, likelihoods, ML refinement, baselines, and
               ``pf-tree-torch`` (host code).
- ``bench``:   the accuracy grid, throughput, and the end-to-end pipeline
               harness, reports and figures (``pf-bench-torch``).
- ``sim``:     tree and alignment simulators (birth-death, LG+G, indels,
               Gillespie coevolution; the batched evolver on the card).
"""

from .version import __version__

__all__ = ["__version__"]
