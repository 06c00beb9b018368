"""The plain reference against the port's eager model on the CPU, and the
lower precision that the controls stand for coming out apart from it."""

import numpy as np
import pytest
import torch

from benchmark import compare, traffic
from benchmark.reference import phyloformer as reference
from conftest import REPO

SIZES = {"n_blocks": 6, "n_heads": 4, "embed_dim": 64, "ffn_dim": 256, "in_channels": 22}
CKPT = REPO / "artifacts" / "pf_mre_r5.ckpt"


@pytest.fixture(scope="module")
def case():
    codes, _ = traffic.evolve(traffic.rng_for(5, 0), 7, 40, 0.02, 0.001)
    net = reference.from_checkpoint(CKPT, SIZES, torch.device("cpu"))
    return codes, reference.predict(net, codes, torch.device("cpu")).numpy()


def test_reference_matches_the_ports_eager_model(case):
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
    from phyloformer_tpu_torch.models.phyloformer import forward

    codes, ref = case
    params, cfg, _ = load_pretrained(CKPT)
    with torch.no_grad():
        port = forward(params, torch.as_tensor(codes)[None].long(), cfg)[0].double().numpy()
    assert ref.shape == (21,)
    assert compare.dist_gap([(port, ref)]) < 1e-5


def test_bf16_reference_is_far_from_it(case):
    codes, ref = case
    net = reference.from_checkpoint(CKPT, SIZES, torch.device("cpu"), torch.bfloat16)
    low = reference.predict(net, codes, torch.device("cpu")).numpy()
    assert compare.dist_gap([(low, ref)]) > 1e-3


def test_lower_precision_paths_are_far_from_it(case):
    """The controls on the program's own paths: one TF32 pass (the fp32
    configuration's) and bf16 parameters (the tf32 configuration's
    serving), on the CPU the plain versions with rounded operands."""
    from phyloformer_tpu_torch.data.fasta import Alignment
    from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu_torch.io.ckpt_import import load_pretrained

    codes, ref = case
    params, cfg, _ = load_pretrained(CKPT)
    aln = [Alignment(codes=codes, ids=[f"s{i}" for i in range(7)])]
    gaps = {}
    for name, icfg in (("float32", {}), ("tensorfloat32", {"matmul_precision": "tensorfloat32"}),
                       ("bf16_params", {"matmul_precision": "tensorfloat32",
                                        "precision": "bfloat16"})):
        eng = InferenceEngine(params, cfg, InferenceConfig(**icfg), device="cpu")
        gaps[name] = compare.dist_gap(zip(eng.predict(aln), [ref]))
    assert gaps["float32"] < 1e-5 < 1e-4 < gaps["tensorfloat32"]
    # the tf32 configuration's serving control, the engine's bf16 parameters
    assert gaps["bf16_params"] > 3 * gaps["tensorfloat32"]


def test_gap_rules():
    ref = np.array([0.5, 2.0])
    assert compare.dist_gap([(ref + 1e-3, ref)]) == pytest.approx(5e-4)
    assert compare.dist_gap([(np.zeros(1), ref)]) == float("inf")
    assert compare.dist_gap([(ref * np.nan, ref)]) == float("inf")
    grads = {"a": 1.0, "b": 2.0, "c": 1e-9}
    ref_t = {"losses": [1.0, 1.0], "grad": grads, "change": {"a": 1.0, "b": 1.0, "c": 1.0}}
    prog = {"losses": [1.0, 1.01], "grad": grads, "change": {"a": 1.0, "b": 0.5, "c": 9.0}}
    g = compare.train_gaps(prog, ref_t)
    assert g["loss_gap"] == pytest.approx(0.01) and g["grad_gap"] == 0.0
    assert g["change_gap"] == pytest.approx(0.5)  # c's gradient is round-off: left out
