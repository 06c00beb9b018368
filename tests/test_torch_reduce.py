"""The launch plan and the ordered twin of the slot reduction
``out[g, n] = Σ_s partial[g, s, n]`` (``phyloformer_tpu_torch.ops.kernels.reduce``),
on the CPU.

The kernel itself (``pf_reduce_slots`` in ``csrc/slot_reduce.cu``, behind
``pipeline.reduce_stats`` and ``axial_block_bwd.reduce_partials``) runs only
on the card, where ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold it
to the twin bit for bit.  Here, at every shape the paths give the two
reductions (with N cut by 16, so that the twin runs in a moment here) and at
the edges:

- the plan covers every (g, s, n) exactly once and is the same on every call;
- at the full shapes it gives at least two blocks per SM wherever the
  column tiles allow (all but D's and E's narrow weight-gradient partials,
  whose slots are not split over blocks);
- the twin adds in the kernel's order: it equals, bit for bit, a literal
  numpy float32 transcription of the kernel's loops, on data whose sum
  depends on the order;
- the twin is within 1e-6 x Σ_s |partial| (float64) of the float64 sum,
  column by column, and so are the wrappers' CPU paths (``partial.sum``).

No JAX function computes this sum on its own: the Pallas kernels accumulate
it over sequential grid steps.  The stats and gradients it feeds are held to
the JAX package in ``test_torch_kernels.py``, ``test_torch_fused.py`` and
``test_torch_train*.py``.
"""

import numpy as np
import pytest
import torch

from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
from phyloformer_tpu_torch.ops.kernels.reduce import (
    ACCS,
    MAX_WARPS,
    STREAM_BYTES,
    TILE_COLS,
    reduce_plan,
    reduce_slots_ordered,
)

SMS = 132  # the H100's SM count
# (G, S, N) of every slot reduction on the paths (PERF.md sections 4 and 6);
# the stats' N is L x 3d.
SHAPES = {
    "stats_headline": (9, 118, 49152),
    "stats_a_only": (1, 1056, 49152),
    "stats_long_inference": (1, 64, 294912),
    "stats_training": (4, 264, 49152),
    "stats_long_training": (2, 64, 294912),
    "c_a1_training": (4, 33, 16384),
    "c_a1_long_training": (2, 66, 98304),
    "c_grads": (1, 132, 37376),
    "d_grads": (1, 396, 4808),
    "e_grads": (1, 396, 8968),
}
EDGES = {
    "n4999": (1, 37, 4999),
    "many_slots_one_tile": (1, 300, 100),
    "s1": (2, 1, 49152),
    "g3": (3, 37, 5000),
    "one_column": (1, 5, 1),
    "fewer_slots_than_warps": (2, 3, 300),
}
SCALED = {name: (g, s, -(-n // 16)) for name, (g, s, n) in SHAPES.items()}
CASES = {**SCALED, **EDGES}


def _partial(shape, seed):
    """fp32 values over eight decades with random signs: their sum depends on
    the order in which it is taken."""
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-4, 4, shape)
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _kernel_order(partial, plan):
    """A literal transcription of ``reduce_tile``'s loops in
    ``csrc/slot_reduce.cu``, every column at once, in numpy float32."""
    G, S, N = partial.shape
    W = plan.warps
    warp_sums = []
    for w in range(W):
        r0, r1 = w * S // W, (w + 1) * S // W
        acc = [np.zeros((G, N), np.float32) for _ in range(ACCS)]
        s = r0
        while s + ACCS <= r1:
            x = [partial[:, s + j] for j in range(ACCS)]
            for j in range(ACCS):
                acc[j] = acc[j] + x[j]
            s += ACCS
        for j in range(ACCS):
            if s + j < r1:
                acc[j] = acc[j] + partial[:, s + j]
        warp_sums.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    t = warp_sums[0]
    for w in range(1, W):
        t = t + warp_sums[w]
    return t


@pytest.mark.parametrize("case", list(CASES))
def test_plan_covers_every_cell_once(case):
    """Column tiles x warp runs x G cover each (g, s, n) once."""
    G, S, N = CASES[case]
    plan = reduce_plan(G, S, N, SMS)
    assert (plan.tiles - 1) * TILE_COLS < N <= plan.tiles * TILE_COLS, plan
    assert 1 <= plan.warps <= MAX_WARPS, plan
    runs = plan.runs()
    assert len(runs) == plan.warps
    seen = np.zeros((S, N), np.int32)  # every g runs the same blocks (grid.y)
    for tile in range(plan.tiles):
        cols = slice(tile * TILE_COLS, min(N, (tile + 1) * TILE_COLS))
        for a, b in runs:
            seen[a:b, cols] += 1
    assert (seen == 1).all(), plan
    assert plan.blocks == G * plan.tiles


@pytest.mark.parametrize("case", list(SHAPES) + list(EDGES))
def test_plan_is_fixed_and_fills_the_card(case):
    """The plan depends on (G, S, N) and the SM count only, and at the
    paths' full shapes gives at least two blocks per SM wherever the column
    tiles allow it: everywhere but D's and E's weight-gradient partials (38
    and 71 tiles), where a slot split over blocks measured no faster on the
    H100 and every tile is one block."""
    G, S, N = {**SHAPES, **EDGES}[case]
    plans = [reduce_plan(G, S, N, SMS) for _ in range(3)]
    assert plans[0] == plans[1] == plans[2]
    assert plans[0].runs() == plans[2].runs()
    plan = plans[0]
    assert plan.blocks == G * -(-N // TILE_COLS), plan
    if case in SHAPES and case not in ("d_grads", "e_grads"):
        assert plan.blocks >= 2 * SMS, plan


def test_plan_warps_and_streaming_at_the_paths_shapes():
    """Two warps a block where the column tiles alone give at least
    WARPS_PER_SM / 2 blocks per SM (the headline and long stats), more where
    they give fewer, 8 at the narrow weight-gradient partials; one warp per
    2 ACCS slots at most (C's A1); streaming loads exactly for the partials
    above STREAM_BYTES (the stats and C's A1 at 1536 sites)."""
    plans = {name: reduce_plan(*shape, SMS) for name, shape in SHAPES.items()}
    assert {name: p.warps for name, p in plans.items()} == {
        "stats_headline": 2, "stats_a_only": 8, "stats_long_inference": 3, "stats_training": 4,
        "stats_long_training": 2, "c_a1_training": 5, "c_a1_long_training": 4, "c_grads": 8,
        "d_grads": 8, "e_grads": 8}
    assert reduce_plan(2, 1, 49152, SMS).warps == 1 and reduce_plan(2, 9, 300, SMS).warps == 2
    assert {name for name, p in plans.items() if p.streaming} == {
        name for name, (g, s, n) in SHAPES.items() if 4 * g * s * n > STREAM_BYTES}
    assert {name for name, p in plans.items() if p.streaming} == {
        name for name in SHAPES if name.startswith("stats")} | {"c_a1_long_training"}
    with pytest.raises(ValueError):
        reduce_plan(1, 0, 10, SMS)


@pytest.mark.parametrize("case", list(CASES))
def test_ordered_twin_adds_in_kernel_order(case):
    """reduce_slots_ordered equals the transcription of the kernel's loops
    bit for bit, on data whose sum depends on the order."""
    G, S, N = CASES[case]
    partial = _partial((G, S, N), 7)
    plan = reduce_plan(G, S, N, SMS)
    got = reduce_slots_ordered(torch.from_numpy(partial), plan).numpy()
    want = _kernel_order(partial, plan)
    assert got.shape == (G, N) and got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), plan


@pytest.mark.parametrize("case", list(CASES))
def test_ordered_twin_is_within_float64_bound(case):
    """|twin - Σ_s partial (float64)| <= 1e-6 x Σ_s |partial| per column,
    and the same for the CPU paths of reduce_stats / reduce_partials."""
    G, S, N = CASES[case]
    partial = np.random.default_rng(8).standard_normal((G, S, N)).astype(np.float32)
    ref = partial.astype(np.float64).sum(axis=1)
    tol = 1e-6 * np.abs(partial).astype(np.float64).sum(axis=1)
    twin = reduce_slots_ordered(torch.from_numpy(partial), reduce_plan(G, S, N, SMS))
    assert (np.abs(twin.numpy().astype(np.float64) - ref) <= tol).all()
    t = torch.from_numpy(partial)
    if N % 192 == 0:
        cpu = pipe.reduce_stats(t.view(G, S, N // 192, 192)).reshape(G, N)
    else:
        cpu = bw.reduce_partials(t)
    assert (np.abs(cpu.numpy().astype(np.float64) - ref) <= tol).all()
    assert pipe.LAUNCHES["reduce_stats"] == pipe.LAUNCHES["reduce_partials"] == 0


def test_ordered_twin_rejects_another_shape():
    plan = reduce_plan(2, 5, 300, SMS)
    with pytest.raises(ValueError):
        reduce_slots_ordered(torch.zeros(2, 6, 300), plan)
