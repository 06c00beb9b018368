"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA card these tests skip.  On a machine with
one (no JAX needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Shapes are small and chosen for the edges the main path's buckets rarely
reach: a site axis that ends in a partial tile, fewer pairs than blocks, a
batch element with every sequence but two masked, batch size one, a single
pair.  The fused kernels (A, B, A1, A2) are checked on site axes above 1024
(the L-tiled forward) and below it (the two-kernel forward), and so is the
backward (C, D and E below; C, D, E1 and E2 above).  The batched simulator
(``sim/device.py``, plain PyTorch, no kernel of its own) runs once at 8 x
20 tips x 300 sites.  The kernels sum in another order than the plain
versions (tiles, blocks, the one-pass ctx = Σk·v/Σk): tolerance 2e-5 relative to max(1, max|ref|) per kernel,
1e-4 on distances after six blocks against the eager model.  The two slot
reductions sum in the order of their launch plan, so they are held to their
ordered twin bit for bit.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from torch_rendezvous import Rendezvous

REPO = pathlib.Path(__file__).resolve().parent.parent

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    r = subprocess.run([sys.executable, "-c",
                        "import torch; print(torch.cuda.is_available())"],
                       capture_output=True, text=True, timeout=300)
    if r.stdout.strip() != "True":
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")


_CODE = """
import json
import numpy as np
import torch
from phyloformer_tpu_torch.data.pairs import pair_indices
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
from phyloformer_tpu_torch.models.phyloformer import forward
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
params, cfg, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
params = map_params(lambda t: t.to(dev), params)
w = pipe.PipelineWeights.from_params(params)
rng = np.random.default_rng(7)

def rel(got, want):
    want = want.double()
    return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())

errs = {}
for name, (dims, pad_n, pad_l) in {
        "partial_tile": ([(9, 45), (6, 30)], 9, 45),
        "two_seqs": ([(2, 70)], 2, 70),
        "masked_seqs": ([(12, 33), (2, 33)], 12, 40)}.items():
    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    smask = np.zeros((b, pad_l), bool)
    qmask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = rng.integers(0, 22, (n, l))
        smask[r, :l] = True
        qmask[r, :n] = True
    codes, smask, qmask = (torch.from_numpy(a).to(dev) for a in (codes, smask, qmask))
    i, j = (torch.as_tensor(a, device=dev) for a in pair_indices(pad_n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b).contiguous()
    sm = smask.float().contiguous()
    pm = (qmask[:, i.long()] & qmask[:, j.long()]).float().contiguous()
    pc = pm.sum(1)
    x0 = (emb[:, i.long()] + emb[:, j.long()]).contiguous()
    e = []
    got = pipe.kernel_p0(emb, i, j, sm, pm, w.row[0], w.col[0], 1e-5)
    want = pipe.kernel_p0_plain(emb, i, j, sm, pm, w.row[0], w.col[0], 1e-5)
    e += [rel(got[0], want[0]), rel(got[1], want[1])]
    got = pipe.kernel_a_only(x0.clone(), sm, pm, w.row[0], w.col[0], 1e-5)
    e += [rel(got[0], want[0]), rel(got[1], want[1])]
    x1, stats = want
    for gelu in ("exact", "tanh"):
        got = pipe.kernel_m(x1.clone(), stats, sm, pm, pc, w.b[0], w.row[1], w.col[1],
                            1e-5, gelu)
        ref = pipe.kernel_m_plain(x1, stats, sm, pm, pc, w.b[0], w.row[1], w.col[1], 1e-5,
                                  gelu)
        e += [rel(got[0], ref[0]), rel(got[1], ref[1])]
        e.append(rel(pipe.kernel_z(x1, stats, sm, pc, w.b[5], w.head, 1e-5, gelu),
                     pipe.kernel_z_plain(x1, stats, sm, pc, w.b[5], w.head, 1e-5, gelu)))
    pipe.reset_launch_counts()
    dist = pipe.forward_fused_pipeline(w, codes, smask, qmask)
    launches = dict(pipe.LAUNCHES)
    ref = forward(params, codes, cfg, site_mask=smask, seq_mask=qmask)
    real = pm.bool()
    errs[name] = {"kernels": max(e), "launches": launches,
                  "finite": bool(torch.isfinite(dist[real]).all()),
                  "dist": (dist[real].double() - ref[real].double()).abs().max().item()}

# the fused forward's kernels: A, B, A1, A2 against their plain versions,
# then forward_fused against the eager model with its launch counts
from phyloformer_tpu_torch.models.phyloformer import forward_fused
from phyloformer_tpu_torch.ops.kernels import fused
for name, (dims, pad_n, pad_l) in {
        "long_partial_tile": ([(9, 1100), (2, 1077)], 9, 1100),
        "long_one_pair": ([(2, 1050)], 2, 1050),
        "short_two_kernel": ([(7, 45), (2, 45)], 7, 45)}.items():
    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    smask = np.zeros((b, pad_l), bool)
    qmask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = rng.integers(0, 22, (n, l))
        smask[r, :l] = True
        qmask[r, :n] = True
    codes, smask, qmask = (torch.from_numpy(a).to(dev) for a in (codes, smask, qmask))
    i, j = (torch.as_tensor(a, device=dev) for a in pair_indices(pad_n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b).contiguous()
    sm = smask.float().contiguous()
    pm = (qmask[:, i.long()] & qmask[:, j.long()]).float().contiguous()
    pc = pm.sum(1)
    x0 = (emb[:, i.long()] + emb[:, j.long()]).contiguous()
    e = {}
    got = fused.kernel_a(x0, sm, pm, w.row[0], w.col[0], 1e-5)
    want = pipe.kernel_a_only_plain(x0, sm, pm, w.row[0], w.col[0], 1e-5)
    e["kernel_a"] = max(rel(got[0], want[0]), rel(got[1], want[1]))
    rs = fused.kernel_a1_plain(x0, sm, w.row[0], 1e-5)
    e["kernel_a1"] = rel(fused.kernel_a1(x0, sm, w.row[0], 1e-5), rs)
    got = fused.kernel_a2(x0, rs, sm, pm, w.row[0], w.col[0], 1e-5)
    want = fused.kernel_a2_plain(x0, rs, sm, pm, w.row[0], w.col[0], 1e-5)
    e["kernel_a2"] = max(rel(got[0], want[0]), rel(got[1], want[1]))
    x1, stats = want
    e["kernel_b"] = rel(fused.kernel_b(x1, stats, pc, w.b[0], 1e-5),
                        fused.kernel_b_plain(x1, stats, pc, w.b[0], 1e-5))
    e["x_untouched"] = bool(torch.equal(x0, (emb[:, i.long()] + emb[:, j.long()])))
    pipe.reset_launch_counts()
    dist = forward_fused(w, codes, cfg, smask, qmask)
    launches = dict(pipe.LAUNCHES)
    ref = forward(params, codes, cfg, site_mask=smask, seq_mask=qmask)
    real = pm.bool()
    errs[name] = {"kernels": e, "launches": launches,
                  "finite": bool(torch.isfinite(dist[real]).all()),
                  "dist": (dist[real].double() - ref[real].double()).abs().max().item()}
torch.cuda.synchronize()
print(json.dumps(errs))
"""


@pytest.fixture(scope="module")
def results(card):
    r = subprocess.run([sys.executable, "-c", _CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["partial_tile", "two_seqs", "masked_seqs"])
def test_kernels_match_plain_on_card(case, results):
    res = results[case]
    assert res["kernels"] <= 2e-5, res
    assert res["finite"] and res["dist"] <= 1e-4, res
    assert res["launches"]["kernel_p0"] == 1 and res["launches"]["kernel_m"] == 5, res
    assert res["launches"]["kernel_z"] == 1 and res["launches"]["reduce_stats"] == 6, res


@pytest.mark.parametrize("case", ["long_partial_tile", "long_one_pair", "short_two_kernel"])
def test_fused_kernels_match_plain_on_card(case, results):
    """Kernels A, B, A1 and A2, out of place, and forward_fused through
    them: A1/A2/B per block above 1024 sites, A/B below."""
    res = results[case]
    kernels = res["kernels"]
    assert kernels.pop("x_untouched"), res
    assert max(kernels.values()) <= 2e-5, res
    assert res["finite"] and res["dist"] <= 1e-4, res
    n = res["launches"]
    if case.startswith("long"):
        assert n["kernel_a1"] == n["kernel_a2"] == n["kernel_b"] == 6 and n["kernel_a"] == 0, n
    else:
        assert n["kernel_a"] == n["kernel_b"] == 6 and n["kernel_a1"] == 0, n
    assert n["reduce_stats"] == 6 and n["kernel_m"] == 0 and n["kernel_z"] == 0, n


_AB_CODE = """
import json
import numpy as np
import torch
from phyloformer_tpu_torch.data.pairs import pair_indices
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
from phyloformer_tpu_torch.ops.kernels import fused
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
params, cfg, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
w = pipe.PipelineWeights.from_params(map_params(lambda t: t.to(dev), params))
rng = np.random.default_rng(13)

def rel(got, want):
    want = want.double()
    return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())

res = {}
for name, (dims, pad_n, pad_l) in {
        "headline": ([(60, 250)] * 9, 60, 256),
        "ragged250": ([(60, 250), (41, 233)], 60, 250),
        "long": ([(60, 1500)], 60, 1536),
        "ragged1100": ([(40, 1100), (33, 1031)], 40, 1100)}.items():
    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    smask = np.zeros((b, pad_l), bool)
    qmask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = rng.integers(0, 20, (n, l))
        smask[r, :l] = True
        qmask[r, :n] = True
    codes, smask, qmask = (torch.from_numpy(a).to(dev) for a in (codes, smask, qmask))
    i, j = (torch.as_tensor(a, device=dev).long() for a in pair_indices(pad_n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b)
    x0 = (emb[:, i] + emb[:, j]).contiguous()
    sm = smask.float().contiguous()
    pm = (qmask[:, i] & qmask[:, j]).float().contiguous()
    pc = pm.sum(1)
    want = pipe.kernel_a_only_plain(x0, sm, pm, w.row[0], w.col[0], 1e-5)
    e = {}
    if name != "long":
        got = fused.kernel_a(x0, sm, pm, w.row[0], w.col[0], 1e-5)
        again = fused.kernel_a(x0, sm, pm, w.row[0], w.col[0], 1e-5)
        e["a"] = max(rel(got[0], want[0]), rel(got[1], want[1]))
        e["a_bits"] = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
        del got, again
    x1, stats = want
    got = fused.kernel_b(x1, stats, pc, w.b[0], 1e-5)
    e["b"] = rel(got, fused.kernel_b_plain(x1, stats, pc, w.b[0], 1e-5))
    e["b_bits"] = bool(torch.equal(got, fused.kernel_b(x1, stats, pc, w.b[0], 1e-5)))
    torch.cuda.synchronize()
    res[name] = e
    del x0, x1, stats, want, got, emb
    torch.cuda.empty_cache()
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def ab_results(card):
    r = subprocess.run([sys.executable, "-c", _AB_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["headline", "ragged250", "long", "ragged1100"])
def test_kernels_a_b_tensor_cores_on_card(case, ab_results):
    """Kernels A and B (split-TF32 products on the tensor cores) against
    their fp32 plain versions at the main path's shapes (9 x 1770 x 256;
    B alone at 1 x 1770 x 1536) and on partial 64-site tiles (250 and 1100
    sites): within 2e-5 of max(1, max|ref|), and the same bits twice."""
    res = ab_results[case]
    assert res["b"] <= 2e-5 and res["b_bits"], res
    if case == "long":
        assert "a" not in res, res
    else:
        assert res["a"] <= 2e-5 and res["a_bits"], res


_BWD_CODE = """
import json
import numpy as np
import torch
from phyloformer_tpu_torch.data.pairs import pair_indices
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
from phyloformer_tpu_torch.models.phyloformer import axial_block
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
from phyloformer_tpu_torch.ops.kernels import fused
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
from phyloformer_tpu_torch.ops.kernels.autodiff import LAYER_LEAVES, layer_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
params, cfg, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
params = map_params(lambda t: t.to(dev), params)
layer = params["layers"][3]
w = bw.BwdWeights.of(layer)
rng = np.random.default_rng(11)

def rel(got, want):
    want = want.double()
    return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())

res = {}
for name, (dims, pad_n, pad_l) in {
        "partial_tile": ([(9, 45), (6, 30)], 9, 45),
        "l1024": ([(5, 1024)], 5, 1024),
        "few_pairs": ([(3, 70)], 3, 70),
        "two_seqs": ([(12, 33), (2, 33)], 12, 40),
        "masked_row": ([(8, 50), (0, 0)], 8, 50),
        # 100 sites: a last tile that is a partial 64-site tile (and 32-site)
        "partial_64": ([(7, 100), (5, 90)], 7, 100),
        # above 1024 sites: the L-tiled row backward, E1 then E2
        "long_partial_tile": ([(9, 1100), (6, 1077)], 9, 1100),
        "l1025": ([(5, 1025)], 5, 1025),
        "long_three_pairs": ([(3, 1200)], 3, 1200),
        "long_masked_row": ([(8, 1050), (0, 0)], 8, 1050)}.items():
    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    smask = np.zeros((b, pad_l), bool)
    qmask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = rng.integers(0, 22, (n, l))
        smask[r, :l] = True
        qmask[r, :n] = True
    i, j = (torch.as_tensor(a, device=dev).long() for a in pair_indices(pad_n))
    codes, smask, qmask = (torch.from_numpy(a).to(dev) for a in (codes, smask, qmask))
    emb = torch.relu(params["embed"]["w"][codes.long()] + params["embed"]["b"])
    x = (emb[:, i] + emb[:, j]).contiguous()
    sm = smask.float().contiguous()
    pm = (qmask[:, i] & qmask[:, j]).float().contiguous()
    pc = pm.sum(1)
    g3 = (torch.randn(x.shape, device=dev, generator=torch.Generator(dev).manual_seed(3))
          * sm[:, None, :, None] * pm[:, :, None, None]).contiguous()
    _, x1, stats = fused.fused_axial_block_res(x, layer, sm, pm)
    e = {"act": 0.0, "grad": 0.0}
    got = bw.kernel_c(x1, g3, stats, pm, pc, w.c, 1e-5)
    want = bw.kernel_c_plain(x1, g3, stats, pm, pc, w.c, 1e-5)
    e["act"] = max(e["act"], rel(got[0], want[0]), rel(got[1], want[1]))
    e["grad"] = max(e["grad"], rel(got[2], want[2]))
    g2, a1 = want[0], want[1]
    got = bw.kernel_d(x1, g2, stats, a1, pm, pc, w.d, 1e-5)
    want = bw.kernel_d_plain(x1, g2, stats, a1, pm, pc, w.d, 1e-5)
    again = bw.kernel_d(x1, g2, stats, a1, pm, pc, w.d, 1e-5)
    e["d"], e["d_grad"] = rel(got[0], want[0]), rel(got[1], want[1])
    e["d_bits"] = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
    e["act"] = max(e["act"], e["d"])
    e["grad"] = max(e["grad"], e["d_grad"])
    e["padded_pairs"] = int((pm == 0).sum())
    e["ragged"] = pad_l % bw.TC_TILE_SITES != 0
    g1 = want[0]
    if pad_l > 1024:
        rs = bw.kernel_e1_plain(x, g1, sm, w.e, 1e-5)
        got = bw.kernel_e2(x, g1, rs, sm, w.e, 1e-5)
        want = bw.kernel_e2_plain(x, g1, rs, sm, w.e, 1e-5)
        again = bw.kernel_e2(x, g1, rs, sm, w.e, 1e-5)
        e["e2"] = rel(got[0], want[0])
        e["e2_bits"] = bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
        e["e2_grid"] = list(bw.e2_grid(b, x.shape[1], pad_l, dev))
        e["e12"] = max(rel(bw.kernel_e1(x, g1, sm, w.e, 1e-5), rs), e["e2"])
    else:
        got = bw.kernel_e(x, g1, sm, w.e, 1e-5)
        want = bw.kernel_e_plain(x, g1, sm, w.e, 1e-5)
        if pad_l == 1024:  # the L-tiled form of the same function against kernel E
            g12 = bw.kernel_e2(x, g1, bw.kernel_e1(x, g1, sm, w.e, 1e-5), sm, w.e, 1e-5)
            e["e12_vs_e"] = rel(g12[0], got[0])
            e["e12_vs_e_grads"] = rel(g12[1], got[1])
    e["act"] = max(e["act"], rel(got[0], want[0]))
    e["grad"] = max(e["grad"], rel(got[1], want[1]))
    # the whole block backward: launch counts, same bits twice, and the
    # gradients against autograd of the eager block
    pipe.reset_launch_counts()
    gx, dl = bw.fused_axial_block_bwd(x, x1, stats, g3, layer, sm, pm, 4)
    launches = dict(pipe.LAUNCHES)
    gx2, dl2 = bw.fused_axial_block_bwd(x, x1, stats, g3, layer, sm, pm, 4)
    same = torch.equal(gx, gx2) and all(torch.equal(a, b) for a, b in
                                        zip(layer_leaves(dl), layer_leaves(dl2)))
    leaves = [t.detach().requires_grad_(True) for t in layer_leaves(layer)]
    lay = {}
    for (a, k), t in zip(LAYER_LEAVES, leaves):
        lay.setdefault(a, {})[k] = t
    xr = x.detach().requires_grad_(True)
    ref = torch.autograd.grad(axial_block(xr, lay, cfg, smask, pm.bool()), [xr] + leaves, g3)
    e["autograd"] = max([rel(gx, ref[0])] + [rel(g, r) for g, r in zip(layer_leaves(dl), ref[1:])])
    torch.cuda.synchronize()
    res[name] = {"errs": e, "launches": launches, "same_bits": same,
                 "finite": bool(torch.isfinite(gx).all())
                 and all(bool(torch.isfinite(t).all()) for t in layer_leaves(dl))}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def bwd_results(card):
    r = subprocess.run([sys.executable, "-c", _BWD_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["partial_tile", "l1024", "few_pairs", "two_seqs",
                                  "masked_row", "partial_64"])
def test_backward_kernels_match_plain_on_card(case, bwd_results):
    """Kernels C, D and E against their plain versions (2e-5 on g2, A1, g1
    and gx; 1e-4 on the weight gradients, sums over every pair-site taken in
    another order), the block backward against autograd of the eager block
    (1e-4), its launches, and the same bits from two runs.  C, D and E run
    split TF32 on the tensor cores; at 1024 sites E1 + E2 (E1 the streaming
    pass of the factored sums, E2 E's pass 2) match E within 1e-5 on gx and
    1e-4 on the weight gradients."""
    res = bwd_results[case]
    if case == "l1024":
        assert res["errs"]["e12_vs_e"] <= 1e-5, res
        assert res["errs"]["e12_vs_e_grads"] <= 1e-4, res
    assert res["errs"]["act"] <= 2e-5, res
    assert res["errs"]["grad"] <= 1e-4, res
    assert res["errs"]["autograd"] <= 1e-4, res
    assert res["finite"] and res["same_bits"], res
    n = res["launches"]
    assert n["kernel_c"] == n["kernel_d"] == n["kernel_e"] == 1, n
    assert n["reduce_partials"] == 4, n


@pytest.mark.parametrize("case", ["partial_tile", "two_seqs", "masked_row"])
def test_backward_kernel_d_padded_pairs_ragged_tile_on_card(case, bwd_results):
    """Kernel D (split TF32 on the tensor cores) on batches with padded
    pairs (pair mask 0) and a ragged last 32-site tile: g1 within 2e-5 and
    its weight gradients within 1e-4 of the plain version, and the same bits
    from two runs."""
    e = bwd_results[case]["errs"]
    assert e["padded_pairs"] > 0 and e["ragged"], e
    assert e["d"] <= 2e-5 and e["d_grad"] <= 1e-4 and e["d_bits"], e


@pytest.mark.parametrize("case", ["long_partial_tile", "l1025", "long_three_pairs",
                                  "long_masked_row"])
def test_backward_kernel_e2_site_chunks_on_card(case, bwd_results):
    """Kernel E2 (split TF32 on the tensor cores) on a grid of more than one
    site chunk a pair slot, the last chunk ending in a ragged 32-site tile:
    gx within 1e-5 of the plain version, and the same bits from two runs."""
    e = bwd_results[case]["errs"]
    slots, chunks = e["e2_grid"]
    assert chunks > 1 and e["ragged"], e
    assert e["e2"] <= 1e-5 and e["e2_bits"], e


@pytest.mark.parametrize("case", ["long_partial_tile", "l1025", "long_three_pairs",
                                  "long_masked_row"])
def test_ltiled_backward_kernels_match_plain_on_card(case, bwd_results):
    """Above 1024 sites: C, D, E1 (row sums) and E2 against their plain
    versions (1e-5 on the row sums and gx, 2e-5 on g2, A1 and g1, 1e-4 on the
    weight gradients), the block backward through E1 and E2 (no E) against
    autograd of the eager block (1e-4), and the same bits from two runs.  C,
    D and E2 run split TF32 on the tensor cores, E1 exact fp32 FFMA."""
    res = bwd_results[case]
    assert res["errs"]["e12"] <= 1e-5, res
    assert res["errs"]["act"] <= 2e-5, res
    assert res["errs"]["grad"] <= 1e-4, res
    assert res["errs"]["autograd"] <= 1e-4, res
    assert res["finite"] and res["same_bits"], res
    n = res["launches"]
    assert n["kernel_c"] == n["kernel_d"] == n["kernel_e1"] == n["kernel_e2"] == 1, n
    assert n["kernel_e"] == 0 and n["reduce_partials"] == 4, n


_E1_CODE = """
import json
import numpy as np
import torch
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
sms = torch.cuda.get_device_properties(dev).multi_processor_count
params, _, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
params = map_params(lambda t: t.to(dev), params)
w = bw.BwdWeights.of(params["layers"][2])
w64 = bw.att_group(*({k: v.double() for k, v in params["layers"][2][n].items()}
                     for n in ("row_norm", "row_attn")))
gen = torch.Generator(dev).manual_seed(5)

def rel(got, want):
    want = want.double()
    return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())

res = {}
for name, (b, p, l, real) in {
        "one_pair": (1, 1, 1100, (1100,)),
        "ragged": (2, 3, 1077, (1077, 1030)),
        "masked_row": (2, 6, 1050, (1050, 0)),
        "headline": (2, 1225, 1536, (1536, 1536))}.items():
    sm = (torch.arange(l, device=dev)[None] < torch.tensor(real, device=dev)[:, None]).float()
    x = torch.randn((b, p, l, 64), device=dev, generator=gen)
    g1 = torch.randn((b, p, l, 64), device=dev, generator=gen) * sm[:, None, :, None]
    pipe.reset_launch_counts()
    got = bw.kernel_e1(x, g1, sm, w.e, 1e-5)
    launches = pipe.LAUNCHES["kernel_e1"]
    again = bw.kernel_e1(x, g1, sm, w.e, 1e-5)
    torch.cuda.synchronize()
    tpw, warps, segs, _ = bw.e1_plan(b, p, l, sms)
    res[name] = {"plain": rel(got, bw.kernel_e1_plain(x, g1, sm, w.e, 1e-5)),
                 "factored": rel(got, bw.kernel_e1_factored(x.double(), g1.double(),
                                                            sm.double(), w64, 1e-5)),
                 "same_bits": bool(torch.equal(got, again)), "launches": launches,
                 "finite": bool(torch.isfinite(got).all()),
                 "masked_zero": bool((got[1] == 0).all()) if real[-1] == 0 else None,
                 "ragged": l % bw.TILE_SITES != 0, "tiles_a_row": -(-l // bw.TILE_SITES),
                 "tiles_a_warp": tpw, "partials_a_row": segs}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def e1_results(card):
    r = subprocess.run([sys.executable, "-c", _E1_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["one_pair", "ragged", "masked_row", "headline"])
def test_kernel_e1_matches_plain_and_factored_on_card(case, e1_results):
    """Kernel E1 (streamed per warp, M and N summed over the sites, then
    contracted once a pair) against kernel_e1_plain (the TPU kernel's
    association) and kernel_e1_factored in float64 (the exact value of its
    own) within 1e-5 relative to
    max(1, max|ref|), one launch a call and the same bits twice: one pair
    (B = 1, P = 1, a row over dozens of warps), a ragged last tile and last
    row segment, a fully masked batch element (all sums 0) and the long
    training bucket 2 x 1225 x 1536 (rows over two warps)."""
    res = e1_results[case]
    assert res["plain"] <= 1e-5 and res["factored"] <= 1e-5, res
    assert res["same_bits"] and res["finite"] and res["launches"] == 1, res
    if case == "one_pair":
        assert res["tiles_a_warp"] == 1 and res["partials_a_row"] == res["tiles_a_row"], res
    if case == "ragged":
        assert res["ragged"] and res["partials_a_row"] > 1, res
    if case == "masked_row":
        assert res["masked_zero"], res


_RED_CODE = """
import json
import torch
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
from phyloformer_tpu_torch.ops.kernels import reduce as red

dev = torch.device("cuda")
sms = torch.cuda.get_device_properties(dev).multi_processor_count
gen = torch.Generator(dev).manual_seed(5)
res = {}
for name, (wrap, shape, off) in {
        "d_grads": (bw.reduce_partials, (1, 264, 4808), 0),
        "e_grads": (bw.reduce_partials, (1, 264, 8968), 0),
        "c_grads": (bw.reduce_partials, (1, 132, 37376), 0),
        "stats_a_only": (pipe.reduce_stats, (1, 1056, 256, 192), 0),
        "stats_headline": (pipe.reduce_stats, (9, 118, 256, 192), 0),
        "n4999": (bw.reduce_partials, (1, 37, 4999), 0),
        "s1": (pipe.reduce_stats, (2, 1, 256, 192), 0),
        "offset4": (bw.reduce_partials, (1, 132, 37376), 1),
        "g3": (bw.reduce_partials, (3, 37, 5000), 0),
        "one_tile": (bw.reduce_partials, (1, 300, 100), 0)}.items():
    numel = 1
    for n in shape:
        numel *= n
    partial = torch.randn(numel + off, device=dev, generator=gen)[off:].view(shape)
    G, S = shape[0], shape[1]
    N = numel // (G * S)
    pipe.reset_launch_counts()
    got = wrap(partial)
    launches = sum(pipe.LAUNCHES.values())
    again = wrap(partial)
    twin = red.reduce_slots_ordered(partial.view(G, S, N), red.reduce_plan(G, S, N, sms))
    want = partial.double().sum(dim=1)
    torch.cuda.synchronize()
    res[name] = {"twin_bits": torch.equal(got.view(G, N), twin),
                 "same_bits": torch.equal(got, again), "launches": launches,
                 "shape": list(got.shape),
                 "err": ((got.double() - want).abs().max() / want.abs().max().clamp_min(1)).item()}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def red_results(card):
    r = subprocess.run([sys.executable, "-c", _RED_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["d_grads", "e_grads", "c_grads", "stats_a_only",
                                  "stats_headline", "n4999", "s1", "offset4", "g3",
                                  "one_tile"])
def test_slot_reductions_match_ordered_twin_on_card(case, red_results):
    """reduce_partials and reduce_stats (both pf_reduce_slots) at the
    weight-gradient and stats shapes of the paths and at the edges (N = 4999,
    S = 1, a start 4 bytes into a buffer, G = 3, one column tile of 300
    slots): equal to the ordered twin on the same plan bit for bit, the same
    bits from two runs, within 2e-5 of the float64 sum, one launch per
    call."""
    res = red_results[case]
    assert res["twin_bits"] and res["same_bits"], res
    assert res["err"] <= 2e-5, res
    assert res["launches"] == 1, res


@pytest.fixture(scope="module")
def sass(card):
    """HMMA and FFMA counts of each kernel of the built library
    (``chip_smoke.sass_counts``, from ``cuobjdump -sass``)."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import sass_counts
    from phyloformer_tpu_torch.ops.kernels import _build

    counts = sass_counts(_build.build())
    if counts is None:
        pytest.skip("no cuobjdump in this CUDA toolkit")
    return counts


@pytest.mark.parametrize("kernel", ["kernel_c", "kernel_d", "kernel_e", "kernel_e2"])
def test_backward_kernels_run_on_tensor_cores(kernel, sass):
    """C, D, E and E2 hold tensor-core mma (HMMA) instructions, built for
    three TF32 passes and for one (``kernel_c<Li3E>``: the mangled template
    argument)."""
    for passes in (3, 1):
        assert sass[f"{kernel}<Li{passes}E>"]["HMMA"] > 0, sass


@pytest.mark.parametrize("gelu", range(4))
@pytest.mark.parametrize("passes", [3, 1])
def test_kernel_m_runs_on_warpgroup_mma(passes, gelu, sass):
    """Kernel M at fp32 storage (``pf::wg::kernel_m``, every activation at
    both pass counts) holds warpgroup MMA (HGMMA) instructions and no
    mma.sync (HMMA)."""
    n = sass[f"wg::kernel_m<Li{gelu}ELi{passes}E>"]
    assert n["HGMMA"] > 0 and n["HMMA"] == 0, n


# ---- kernel M on warpgroup MMA at the shapes where its split of the work can
# fail: fewer pairs than SMs (one pair a block: one consumer's tiles only),
# an odd tile count, ragged last tiles, three batch elements with padded
# pairs, one pass above 1024 sites, rows of one tile with two and three
# pairs a block (each consumer's row sums of the other's rows are zeros);
# against kernel_m_plain, twice for the same bits, and the bf16 route on its
# own launch count ---------------------------------------------------------------

_M_WG_CODE = """
import json
import numpy as np
import torch
from phyloformer_tpu_torch.data.pairs import pair_indices
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
params, _, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
w = pipe.PipelineWeights.from_params(map_params(lambda t: t.to(dev), params))
rng = np.random.default_rng(24)

def rel(got, want):
    want = want.double()
    d = (got.double() - want).abs().flatten()
    scale = max(1.0, want.abs().max().item())
    return d.max().item() / scale, torch.quantile(d[:1 << 24], 0.999).item() / scale

out = {}
for name, (dims, pad_n, pad_l, passes) in {
        "p45": ([(10, 250)], 10, 256, (3, 1)),
        "odd_tiles": ([(20, 320)], 20, 320, (3, 1)),
        "ragged_1000": ([(12, 1000)], 12, 1000, (3, 1)),
        "ragged_1100_one_pass": ([(10, 1100)], 10, 1100, (1,)),
        "b3_padded_pairs": ([(9, 130), (6, 100), (2, 77)], 9, 130, (3, 1)),
        "one_tile_rows": ([(24, 40)], 24, 40, (3, 1))}.items():
    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    smask = np.zeros((b, pad_l), bool)
    qmask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = rng.integers(0, 22, (n, l))
        smask[r, :l] = True
        qmask[r, :n] = True
    codes, smask, qmask = (torch.from_numpy(a).to(dev) for a in (codes, smask, qmask))
    i, j = (torch.as_tensor(a, device=dev).long() for a in pair_indices(pad_n))
    emb = torch.relu(w.embed_w[codes.long()] + w.embed_b)
    x0 = (emb[:, i] + emb[:, j]).contiguous()
    sm = smask.float().contiguous()
    pm = (qmask[:, i] & qmask[:, j]).float().contiguous()
    pc = pm.sum(1)
    for np_ in passes:
        x1, stats = pipe.kernel_a_only_plain(x0, sm, pm, w.row[0], w.col[0], 1e-5, np_)
        want = pipe.kernel_m_plain(x1, stats, sm, pm, pc, w.b[0], w.row[1], w.col[1], 1e-5,
                                   "exact", np_)
        pipe.reset_launch_counts()
        run = lambda: pipe.kernel_m(x1.clone(), stats, sm, pm, pc, w.b[0], w.row[1], w.col[1],
                                    1e-5, "exact", np_)
        got, again = run(), run()
        n_wg = pipe.LAUNCHES["kernel_m"]
        real = pm.bool()
        e_x1 = rel(got[0][real], want[0][real])
        e_st = rel(got[1], want[1])
        r = {"x1": e_x1, "stats": e_st, "launches": n_wg,
             "same_bits": bool(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))}
        if np_ == 3:
            x1b = x1.to(torch.bfloat16)
            pipe.reset_launch_counts()
            gb = pipe.kernel_m(x1b.clone(), stats, sm, pm, pc, w.b[0], w.row[1], w.col[1], 1e-5)
            r["bf16_launches"] = (pipe.LAUNCHES["kernel_m"], pipe.LAUNCHES["kernel_m_bf16"])
            r["bf16_finite"] = bool(torch.isfinite(gb[0].float()).all()
                                    and torch.isfinite(gb[1]).all())
        out[f"{name}/{np_}"] = r
torch.cuda.synchronize()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def m_wg_results(card):
    r = subprocess.run([sys.executable, "-c", _M_WG_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["p45/3", "p45/1", "odd_tiles/3", "odd_tiles/1",
                                  "ragged_1000/3", "ragged_1000/1", "ragged_1100_one_pass/1",
                                  "b3_padded_pairs/3", "b3_padded_pairs/1",
                                  "one_tile_rows/3", "one_tile_rows/1"])
def test_kernel_m_warpgroup_mma_matches_plain_on_card(case, m_wg_results):
    """x1 on the real pairs and the stats against kernel_m_plain: within
    2e-5 of max(1, max|ref|) at three passes, ONE_PASS_TOL (largest) and
    ONE_PASS_P999 (99.9th percentile) at one; the same bits from two runs;
    one launch counted as kernel_m; at bf16 storage the mma.sync kernel,
    counted as kernel_m_bf16."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import ONE_PASS_P999, ONE_PASS_TOL

    res = m_wg_results[case]
    three = case.endswith("/3")
    for key in ("x1", "stats"):
        worst, p999 = res[key]
        if three:
            assert worst <= 2e-5, res
        else:
            assert worst <= ONE_PASS_TOL and p999 <= ONE_PASS_P999, res
    assert res["same_bits"] and res["launches"] == 2, res
    if three:
        assert res["bf16_launches"] == [0, 1] and res["bf16_finite"], res


# ---- the backward at one TF32 pass -------------------------------------------

_BWD1_CODE = """
import json
import numpy as np
import torch
from phyloformer_tpu_torch.data.pairs import pair_indices
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
from phyloformer_tpu_torch.models.phyloformer import axial_block
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
from phyloformer_tpu_torch.ops.kernels import fused
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
from phyloformer_tpu_torch.ops.kernels.autodiff import LAYER_LEAVES, layer_leaves

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
params, cfg, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
params = map_params(lambda t: t.to(dev), params)
layer = params["layers"][3]
w = bw.BwdWeights.of(layer)
rng = np.random.default_rng(13)

def rel(got, want):
    want = want.double()
    return (got.double() - want).abs().max().item() / max(1.0, want.abs().max().item())

def hold(e, name, run, plain):
    got, again, want = run(), run(), plain()
    e[name] = max(rel(a, b) for a, b in zip(got, want))
    e[name + "_bits"] = all(torch.equal(a, b) for a, b in zip(got, again))
    return want

res = {}
for name, (dims, pad_n, pad_l) in {
        "partial_tile": ([(9, 45), (6, 30)], 9, 45),
        "few_pairs": ([(3, 70)], 3, 70),
        "two_seqs": ([(12, 33), (2, 33)], 12, 40),
        "long_partial_tile": ([(9, 1100), (6, 1077)], 9, 1100),
        "long_masked_row": ([(8, 1050), (0, 0)], 8, 1050)}.items():
    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    smask = np.zeros((b, pad_l), bool)
    qmask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        codes[r, :n, :l] = rng.integers(0, 22, (n, l))
        smask[r, :l] = True
        qmask[r, :n] = True
    i, j = (torch.as_tensor(a, device=dev).long() for a in pair_indices(pad_n))
    codes, smask, qmask = (torch.from_numpy(a).to(dev) for a in (codes, smask, qmask))
    emb = torch.relu(params["embed"]["w"][codes.long()] + params["embed"]["b"])
    x = (emb[:, i] + emb[:, j]).contiguous()
    sm = smask.float().contiguous()
    pm = (qmask[:, i] & qmask[:, j]).float().contiguous()
    pc = pm.sum(1)
    g3 = (torch.randn(x.shape, device=dev, generator=torch.Generator(dev).manual_seed(5))
          * sm[:, None, :, None] * pm[:, :, None, None]).contiguous()
    _, x1, stats = fused.fused_axial_block_res(x, layer, sm, pm, 1e-5, "default")
    e = {}
    run = lambda f: f(x1, g3, stats, pm, pc, w.c, 1e-5, 1)
    g2, a1, _ = hold(e, "c", lambda: run(bw.kernel_c), lambda: run(bw.kernel_c_plain))
    run = lambda f: f(x1, g2, stats, a1, pm, pc, w.d, 1e-5, 1)
    g1, _ = hold(e, "d", lambda: run(bw.kernel_d), lambda: run(bw.kernel_d_plain))
    if pad_l > 1024:
        rs = bw.kernel_e1_plain(x, g1, sm, w.e, 1e-5, 1)
        e["e1_bits"] = bool(torch.equal(bw.kernel_e1(x, g1, sm, w.e, 1e-5, 1),
                                        bw.kernel_e1(x, g1, sm, w.e, 1e-5, 3)))
        run = lambda f: f(x, g1, rs, sm, w.e, 1e-5, 1)
        hold(e, "e", lambda: run(bw.kernel_e2), lambda: run(bw.kernel_e2_plain))
    else:
        run = lambda f: f(x, g1, sm, w.e, 1e-5, 1)
        hold(e, "e", lambda: run(bw.kernel_e), lambda: run(bw.kernel_e_plain))
    # the block backward at "default" against autograd of the eager block in fp32
    pipe.reset_launch_counts()
    gx, dl = bw.fused_axial_block_bwd(x, x1, stats, g3, layer, sm, pm, 4,
                                      mxu_precision="default")
    launches = dict(pipe.LAUNCHES)
    leaves = [t.detach().requires_grad_(True) for t in layer_leaves(layer)]
    lay = {}
    for (a, k), t in zip(LAYER_LEAVES, leaves):
        lay.setdefault(a, {})[k] = t
    xr = x.detach().requires_grad_(True)
    ref = torch.autograd.grad(axial_block(xr, lay, cfg, smask, pm.bool()), [xr] + leaves, g3)
    e["autograd"] = max([rel(gx, ref[0])] + [rel(g, r) for g, r in zip(layer_leaves(dl), ref[1:])])
    torch.cuda.synchronize()
    res[name] = {"errs": e, "launches": launches,
                 "finite": bool(torch.isfinite(gx).all())
                 and all(bool(torch.isfinite(t).all()) for t in layer_leaves(dl))}
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def bwd1_results(card):
    r = subprocess.run([sys.executable, "-c", _BWD1_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["partial_tile", "few_pairs", "two_seqs", "long_partial_tile",
                                  "long_masked_row"])
def test_one_pass_backward_kernels_match_plain_on_card(case, bwd1_results):
    """C, D and E (E1 and E2 above 1024 sites) at one TF32 pass, on the
    one-pass forward's residuals: every output and weight gradient within
    chip_smoke's ONE_PASS_TOL (2e-3 of max(1, max|ref|): an operand computed
    in another fp32 order can round to the neighbouring TF32 value) of the
    one-pass plain version, the same bits twice; E1 gives its three-pass
    bits (exact fp32 at both); the block backward at "default" runs C, D and
    E, or C, D, E1 and E2, and lies within the 6e-3 gate of autograd of the
    eager block in fp32."""
    res = bwd1_results[case]
    e = res["errs"]
    for k in ("c", "d", "e"):
        assert e[k] <= 2e-3 and e[k + "_bits"], (k, e)
    assert e["autograd"] <= 6e-3, e
    assert res["finite"], res
    n = res["launches"]
    long = case.startswith("long")
    assert n["kernel_c"] == n["kernel_d"] == 1 and n["reduce_partials"] == 4, n
    assert (n["kernel_e1"], n["kernel_e2"], n["kernel_e"]) == ((1, 1, 0) if long else (0, 0, 1))
    if long:
        assert e["e1_bits"], e


# ---- the reduced-precision and activation variants ---------------------------
# chip_smoke.py's variant phase (every entry of its VARIANTS against the plain
# twin, twice for the same bits) on small edge shapes: a partial tile, two
# sequences, masked sequences, and 1100 sites (the pipeline serves it at one
# pass).  Its bars: KERNEL_TOL at three passes, ONE_PASS_TOL and ONE_PASS_P999
# at one (TF32 rounding flips), one bf16 ulp plus the variant's fp32 bar for
# x1 stored as bf16.

_VARIANT_CODE = """
import json
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import map_params
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
params = map_params(lambda t: t.to(dev), load_pretrained(cs.CKPT)[0])
cs.VARIANT_CASES = {"headline": ([(20, 100), (17, 75)], 20, 100),
                    "ragged": ([(2, 70)], 2, 70),
                    "wide": ([(9, 64), (2, 64)], 12, 64),
                    "long": ([(6, 1100)], 6, 1100)}
var = cs.variant_checks(pipe.PipelineWeights.from_params(params), dev)
print(json.dumps({v: {"fails": cs.variant_failures(v, r), "launched": r["ms"] > 0}
                  for v, r in var.items()}))
"""


@pytest.fixture(scope="module")
def variant_results(card):
    r = subprocess.run([sys.executable, "-c", _VARIANT_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kernel", ["kernel_p0", "kernel_a_only", "kernel_m", "kernel_z",
                                    "kernel_a", "kernel_b", "kernel_a1", "kernel_a2"])
def test_reduced_precision_variants_match_plain_on_card(kernel, variant_results):
    mine = {v: r for v, r in variant_results.items() if v.startswith(kernel + "/")}
    assert mine, variant_results
    for v, r in mine.items():
        assert not r["fails"] and r["launched"], (v, r)


_SHARDED_CODE = """
import json, os, sys
import numpy as np
import torch
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.phyloformer import forward_fused
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
from phyloformer_tpu_torch.ops.kernels.sharded import forward_fused_sharded
from phyloformer_tpu_torch.parallel.mesh import init_distributed, make_mesh

torch.backends.cuda.matmul.allow_tf32 = False
dev = init_distributed("gloo", "cuda")
params, cfg, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
rng = np.random.default_rng(11)
codes = torch.as_tensor(rng.integers(0, 20, (2, 19, 70)), dtype=torch.int32, device=dev)
smask = torch.as_tensor(np.arange(70)[None].repeat(2, 0) < [[70], [61]], device=dev)
qmask = torch.as_tensor(np.arange(19)[None].repeat(2, 0) < [[19], [14]], device=dev)
from phyloformer_tpu_torch.models.params import map_params
params = map_params(lambda t: t.to(dev), params)
pipe.reset_launch_counts()
got = forward_fused_sharded(params, codes, cfg, make_mesh(1, 2), smask, qmask)[:, :171]
launched = pipe.LAUNCHES["kernel_a"] + pipe.LAUNCHES["kernel_b"]
want = forward_fused(params, codes, cfg, smask, qmask)
i, j = np.triu_indices(19, 1)
pm = torch.as_tensor(qmask.cpu().numpy()[:, i] & qmask.cpu().numpy()[:, j], device=dev)
err = ((got - want)[pm].abs().max() / want[pm].abs().max().clamp_min(1.0)).item()
np.save(sys.argv[1] + f"/rank{torch.distributed.get_rank()}.npy", got.cpu().numpy())
print(json.dumps({"err": err, "launched": launched}))
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def sharded_results(card, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_card")
    with Rendezvous() as rdv:
        procs = [rdv.popen([sys.executable, "-c", _SHARDED_CODE, str(tmp)], r, 2,
                           env={**os.environ, "LOCAL_RANK": "0"}, cwd=str(REPO),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    import numpy as np

    return ([json.loads(out.strip().splitlines()[-1]) for out, _ in outs],
            [np.load(tmp / f"rank{r}.npy") for r in range(2)])


def test_two_gloo_ranks_on_card_match_single_process(sharded_results):
    """forward_fused_sharded on two gloo ranks on the one card (data 1 x
    pair 2, 171 pairs: the second shard holds a padding pair) against the
    single-process forward_fused, within the kernels' bar; both ranks give
    the same bits and launch kernels A and B."""
    import numpy as np

    res, outs = sharded_results
    np.testing.assert_array_equal(outs[0], outs[1])
    for r in res:
        assert r["err"] <= 2e-5 and r["launched"] == 12, r


_SIM_CODE = """
import json
import numpy as np
from phyloformer_tpu_torch.sim.device import simulate_msas_device
from phyloformer_tpu_torch.sim.msa import MsaSimConfig
from phyloformer_tpu_torch.sim.trees import TreeSimConfig, simulate_tree

tree_rng = np.random.default_rng(3)
trees = [simulate_tree(tree_rng, TreeSimConfig(ntips=20)) for _ in range(8)]
cfg = MsaSimConfig(length=300, gamma="GC")
runs = [simulate_msas_device(trees, cfg, np.random.default_rng(11), batch_size=8)
        for _ in range(2)]
(alns, attempts), (again, _) = runs
print(json.dumps({
    "shapes": [list(a.codes.shape) if a is not None else None for a in alns],
    "distinct_rows": [len({r.tobytes() for r in a.codes}) if a is not None else 0
                      for a in alns],
    "attempts": attempts,
    "same_bytes": all(a is not None and b is not None and a.codes.tobytes() == b.codes.tobytes()
                      and a.ids == b.ids
                      for a, b in zip(alns, again))}))
"""


def test_device_simulator_on_card(card):
    """simulate_msas_device on the card at 8 x 20 tips x 300 sites (GC):
    every alignment 20 x 300 with distinct rows, and the same bytes from a
    second run at the same seed."""
    r = subprocess.run([sys.executable, "-c", _SIM_CODE], capture_output=True, text=True,
                       cwd=str(REPO), timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["shapes"] == [[20, 300]] * 8
    assert res["distinct_rows"] == [20] * 8
    assert all(1 <= a <= 20 for a in res["attempts"])
    assert res["same_bytes"]
