"""The fixed operation counts against ``torch.utils.flop_counter`` on the
code they count: the plain reference for the model, the port's plain
versions for kernels M and C."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import phyloformer as reference
from benchmark.rooflines import kernel_c, kernel_m, model

SIZES = {"n_blocks": 2, "n_heads": 4, "embed_dim": 64, "ffn_dim": 256, "in_channels": 22}


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_model_count_is_the_reference_forward():
    n, l = 5, 7
    net = reference.Phyloformer(SIZES["n_blocks"], SIZES["n_heads"], SIZES["embed_dim"],
                                SIZES["ffn_dim"], SIZES["in_channels"])
    x = reference.one_hot(torch.randint(0, 20, (n, l)))
    p, d = n * (n - 1) // 2, SIZES["embed_dim"]
    seq2pair = 2 * p * n * d * l  # a gather written as a product: not in the count
    # Q (K^T V) has no contraction (one query scalar a head): the counter
    # sees a broadcast multiply and counts nothing; the count takes 2 d a
    # position of each attention
    outer = SIZES["n_blocks"] * 2 * (2 * d * p * l)
    with torch.no_grad():
        assert counted(lambda: net(x)) - seq2pair + outer == model.forward_flop(n, l, SIZES)


def test_published_numbers():
    sizes = dict(SIZES, n_blocks=6)
    assert model.per_block_flop(sizes) == 100_864
    assert model.per_pair_site_flop(sizes) == 605_312
    assert model.train_flop(3, 4, sizes) == 3 * model.forward_flop(3, 4, sizes)


def _weights(seed=0):
    from phyloformer_tpu_torch.models.params import PhyloformerConfig, init_params
    from phyloformer_tpu_torch.ops.kernels.pipeline import PipelineWeights

    cfg = PhyloformerConfig(n_blocks=2)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    return params, PipelineWeights.from_params(params)


def test_kernel_m_count_is_its_plain_version():
    from phyloformer_tpu_torch.ops.kernels.pipeline import kernel_m_plain

    _, w = _weights()
    b, p, l, d = 1, 6, 8, 64
    x1 = torch.randn(b, p, l, d)
    stats = torch.rand(b, l, 3 * d) + 0.5
    smask, pmask = torch.ones(b, l), torch.ones(b, p)
    flop = counted(lambda: kernel_m_plain(x1, stats, smask, pmask, torch.full((b,), float(p)),
                                          w.b[0], w.row[1], w.col[1], 1e-5))
    # the plain version repeats each head's q and k over the head's lanes
    # (five d x d products); the count takes the model's d x H
    h = SIZES["n_heads"]
    repeated = 5 * 2 * d * (d - h)
    assert flop - b * p * l * repeated == b * p * l * kernel_m.flop_per_pair_site(SIZES)
    assert kernel_m.flop_per_pair_site(dict(SIZES, n_blocks=6)) == 100_864


def test_kernel_c_count_is_its_plain_version():
    from phyloformer_tpu_torch.ops.kernels.axial_block_bwd import c_group, kernel_c_plain

    params, _ = _weights()
    b, p, l, d = 1, 6, 8, 64
    x1, g3 = torch.randn(b, p, l, d), torch.randn(b, p, l, d)
    stats = torch.rand(b, l, 3 * d) + 0.5
    flop = counted(lambda: kernel_c_plain(x1, g3, stats, torch.ones(b, p),
                                          torch.full((b,), float(p)),
                                          c_group(params["layers"][0]), 1e-5))
    assert flop == b * p * l * kernel_c.flop_per_pair_site(SIZES)
