"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes and gaps, and the targets are the tree's distances."""

import numpy as np

from benchmark import traffic

MIX = {"tips": [4, 7], "sites": [10, 30], "reps": 2, "mean_branch": 0.02, "min_branch": 0.001}


def test_pool_is_deterministic_per_seed():
    a, b = traffic.pool(MIX, 2**40 + 3), traffic.pool(MIX, 2**40 + 3)
    assert [x["n"] for x in a] == [x["n"] for x in b]
    for x, y in zip(a, b):
        assert np.array_equal(x["codes"], y["codes"]) and np.array_equal(x["dists"], y["dists"])


def test_every_seed_has_the_same_sizes():
    a, b = traffic.pool(MIX, 1), traffic.pool(MIX, 2)
    assert sorted((x["n"], x["l"]) for x in a) == sorted((x["n"], x["l"]) for x in b)
    assert any(not np.array_equal(x["codes"], y["codes"]) for x, y in zip(a, b))


def test_tips_range_and_reps():
    assert traffic.sizes({"tips_range": [10, 12], "sites": [5], "reps": 2}) == [
        (10, 5), (11, 5), (12, 5)] * 2


def test_distances_are_a_tree_metric():
    rng = traffic.rng_for(7, 0)
    codes, d = traffic.evolve(rng, 6, 50, 0.05, 0.001)
    assert codes.shape == (6, 50) and codes.dtype == np.int8 and codes.max() < 20
    m = np.zeros((6, 6))
    m[np.triu_indices(6, 1)] = d
    m = m + m.T
    assert (d >= 2 * 0.001 - 1e-12).all()
    # the four-point condition of a tree metric
    for i, j, k, l in [(0, 1, 2, 3), (1, 2, 4, 5), (0, 3, 4, 5)]:
        s = sorted([m[i, j] + m[k, l], m[i, k] + m[j, l], m[i, l] + m[j, k]])
        assert abs(s[2] - s[1]) < 1e-9


def test_schedule_has_fixed_gaps_and_counts():
    d1, i1 = traffic.poisson_schedule(20.0, 30.0, 72, 11)
    d2, i2 = traffic.poisson_schedule(20.0, 30.0, 72, 12)
    assert len(d1) == len(d2) == 8 * 72  # 600 requests, rounded to whole rounds of the pool
    gaps1, gaps2 = np.diff(np.append(d1, 30.0)), np.diff(np.append(d2, 30.0))
    assert np.allclose(sorted(gaps1), sorted(gaps2)) and abs(gaps1.sum() - 30.0) < 1e-9
    for r in range(8):  # each round: every pool entry once, the same share of the gaps
        assert sorted(i1[72 * r:72 * (r + 1)].tolist()) == list(range(72))
        assert abs(gaps1[72 * r:72 * (r + 1)].sum() - 30.0 / 8) < 0.1 * 30.0 / 8
    assert not np.array_equal(i1, i2)
    d3, i3 = traffic.poisson_schedule(20.0, 30.0, 72, 11)
    assert np.array_equal(d1, d3) and np.array_equal(i1, i3)


def test_fasta_round_trips_through_the_port():
    from phyloformer_tpu_torch.data.fasta import read_fasta

    codes, _ = traffic.evolve(traffic.rng_for(3, 0), 5, 40, 0.02, 0.001)
    aln = read_fasta(traffic.fasta(codes))
    assert aln.ids == [f"s{i}" for i in range(5)] and np.array_equal(aln.codes, codes)
