"""The port's simulators (``phyloformer_tpu_torch.sim``) against the JAX
package's, on the CPU.

The JAX package's simulators are host numpy (its device engine aside) and
run here in the test process; the port runs in fresh interpreters
(:func:`test_torch_model.run_port`: torch and JAX are never imported into one
process), and the two exchange files and ``.npz`` arrays.  Bars:

- the substitution models, the shipped data tables, the CLIs' files at one
  ``--seed`` and the device engine's host side (draws, packed trees, the
  drawn device seed, the numpy generator's state after a run): bit for bit;
- one step's transition weights against JAX's expression
  (``device.py:146-151``, jitted on the CPU): 1e-5 of each row's maximum
  (fp32 exp and a 20-term sum taken in another order);
- the device engine's distributions (its substitution draws come from a
  ``torch.Generator``, so they are held in distribution, not in bits):
  JAX's own bars, 0.02 on the mean p-distance, 0.03 on a mixture's
  composition; the sampler within 5 standard errors a state.
"""

import hashlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from phyloformer_tpu.data import parse_newick
from phyloformer_tpu.sim import MsaSimConfig, TreeSimConfig, get_model, simulate_tree
from test_torch_model import PORT_THREAD_ENV, REPO, run_port

MODELS = ["LG", "WAG", "JTT", "Poisson", "paml"]
TIMES = (0.01, 0.5, 3.0)
GAMMAS = [(0.3, 4), (1.7, 8), (0.05, 2)]
F1 = np.full(20, 0.01)
F1[0] = F1[1] = 0.41
F2 = np.full(20, 0.01)
F2[18] = F2[19] = 0.41


def _shared(*funcs, **consts):
    """Source text of this module's helpers and constants for the port's
    interpreter, which cannot import this module (it imports JAX)."""
    return "".join([f"{k} = {v!r}\n" for k, v in consts.items()]
                   + [inspect.getsource(f) + "\n" for f in funcs])


def _nexus_mix():
    """The two-class nexus of ``test_simulators.py`` (weights 0.5, 0.5)."""
    return ("#nexus\nbegin models;\n"
            "  [ test mixture ]\n"
            f"  frequency TST_F1 = {' '.join(f'{x:.4f}' for x in F1)};\n"
            f"  frequency TST_F2 = {' '.join(f'{x:.4f}' for x in F2)};\n"
            "  frequency TST_MIX = FMIX{TST_F1:1.0:0.5,TST_F2:1.0:0.5};\n"
            "end;\n")


def _nexus_rates():
    """IQ-TREE's ``NAME:rate`` shorthand: uniform weights, class rates."""
    return ("begin models;\n"
            f"  frequency TSR_F1 = {' '.join(f'{x:.4f}' for x in F1)};\n"
            f"  frequency TSR_F2 = {' '.join(f'{x:.4f}' for x in F2)};\n"
            "  frequency TSR_MIX = FMIX{TSR_F1:0.5,TSR_F2:2.0};\n"
            "end;\n")


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim_models")
    lg = get_model("LG")
    lines = [" ".join(f"{lg.exchangeabilities[i, j]:.6f}" for j in range(i))
             for i in range(1, 20)]
    lines.append(" ".join(f"{f:.6f}" for f in lg.freqs))
    (d / "lg.dat").write_text("\n".join(lines) + "\n")
    (d / "mix.nex").write_text(_nexus_mix())
    (d / "rates.nex").write_text(_nexus_rates())
    return d


def _model_arrays(sim_models, name, path):
    m = sim_models.get_model(str(path / "lg.dat") if name == "paml" else name)
    lam, left, right = m.eigensystem()
    out = {"exch": m.exchangeabilities, "freqs": m.freqs, "q": m.rate_matrix(),
           "lam": lam, "left": left, "right": right}
    out.update({f"p{t}": m.transition_matrix(t) for t in TIMES})
    return out


@pytest.fixture(scope="module")
def models_case(model_files):
    from phyloformer_tpu.sim import models as jm

    want = {}
    for name in MODELS:
        for k, v in _model_arrays(jm, name, model_files).items():
            want[f"{name}.{k}"] = v
    for alpha, k in GAMMAS:
        want[f"gamma.{alpha}.{k}"] = jm.discrete_gamma_rates(alpha, k)
    for nex in ("mix", "rates"):
        mix = jm.load_mdef_nexus(model_files / f"{nex}.nex")
        want[f"{nex}.classes"] = np.stack(mix.classes)
        want[f"{nex}.weights"] = mix.weights
        want[f"{nex}.rates"] = mix.class_rates()
        want[f"{nex}.name"] = np.asarray(mix.name)
    got = run_port(_shared(_model_arrays, TIMES=TIMES) + f"""
import pathlib
from phyloformer_tpu_torch.sim import models as pm
path = pathlib.Path({str(model_files)!r})
for name in {MODELS!r}:
    for k, v in _model_arrays(pm, name, path).items():
        OUT[f"{{name}}.{{k}}"] = v
for alpha, k in {GAMMAS!r}:
    OUT[f"gamma.{{alpha}}.{{k}}"] = pm.discrete_gamma_rates(alpha, k)
for nex in ("mix", "rates"):
    mix = pm.load_mdef_nexus(path / f"{{nex}}.nex")
    OUT[f"{{nex}}.classes"] = np.stack(mix.classes)
    OUT[f"{{nex}}.weights"] = mix.weights
    OUT[f"{{nex}}.rates"] = mix.class_rates()
    OUT[f"{{nex}}.name"] = np.asarray(mix.name)
""", {}, model_files / "port")
    return got, want


def _bit_equal(got, want, prefix):
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got if k.startswith(prefix))
    for k in keys:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_substitution_model_bit_equal(name, models_case):
    """Exchangeabilities, frequencies, generator, eigensystem and P(t)."""
    _bit_equal(*models_case, name + ".")


@pytest.mark.parametrize("case", ["gamma.", "mix.", "rates."])
def test_gamma_rates_and_mdef_bit_equal(case, models_case):
    _bit_equal(*models_case, case)


@pytest.mark.parametrize("name", ["aa_models.npz", "priors.npz"])
def test_data_tables_identical(name):
    digest = [hashlib.sha256((REPO / pkg / "sim" / "data" / name).read_bytes()).hexdigest()
              for pkg in ("phyloformer_tpu", "phyloformer_tpu_torch")]
    assert digest[0] == digest[1]


# -- the CLIs: the same files at one --seed -----------------------------------

TREE_CASES = {
    "birth_death": ["-n", "4", "-t", "9", "--seed", "11"],
    "birth_death_no_het": ["-n", "4", "-t", "9", "--seed", "12", "--no-heterogeneity"],
    "uniform": ["-n", "3", "-t", "7", "--type", "uniform", "--seed", "13"],
    "uniform_no_het": ["-n", "3", "-t", "7", "--type", "uniform", "--seed", "14",
                       "--no-heterogeneity"],
}
MSA_CASES = {
    "no_gamma": ["-l", "60", "--seed", "21"],
    "gc": ["-l", "60", "-g", "GC", "--seed", "22"],
    "g4": ["-l", "60", "-g", "G4", "--seed", "23"],
    "fixed_alpha": ["-l", "60", "-g", "GC", "--alpha", "0.4", "--seed", "24"],
    "mdef": ["-l", "60", "--mdef", "{mix}", "--seed", "25"],
    "indels": ["-l", "60", "--indels", "--seed", "26"],
    "device_indels": ["-l", "50", "--indels", "--engine", "device", "--seed", "27"],
}
COEV_ARGS = ["--seqlen", "40", "--seed", "31"]


def _cli_runs(root, mix):
    """(module, argv) of every case, writing under ``root``; the alignment
    cases read the trees of the first tree case."""
    trees = str(root / "trees" / "birth_death")
    runs = {f"trees/{c}": ("cli_trees", a + ["-o", str(root / "trees" / c)])
            for c, a in TREE_CASES.items()}
    runs.update({f"msa/{c}": ("cli_msa", [trees, str(root / "msa" / c)]
                              + [x.format(mix=mix) for x in a])
                 for c, a in MSA_CASES.items()})
    runs["coevolution"] = ("cli_coevolution",
                           [trees, str(root / "coevolution")] + COEV_ARGS)
    return runs


@pytest.fixture(scope="module")
def cli_case(tmp_path_factory, model_files):
    import importlib

    jax_root, port_root = (tmp_path_factory.mktemp(n) for n in ("jax_cli", "port_cli"))
    mix = str(model_files / "mix.nex")
    rcs = {}
    for case, (mod, argv) in _cli_runs(jax_root, mix).items():
        rcs[case] = importlib.import_module(f"phyloformer_tpu.sim.{mod}").main(argv)
    got = run_port(_shared(_cli_runs, TREE_CASES=TREE_CASES, MSA_CASES=MSA_CASES,
                           COEV_ARGS=COEV_ARGS) + f"""
import importlib, pathlib
for case, (mod, argv) in _cli_runs(pathlib.Path({str(port_root)!r}), {mix!r}).items():
    OUT["rc/" + case] = importlib.import_module("phyloformer_tpu_torch.sim." + mod).main(argv)
""", {}, port_root / "io")
    return jax_root, port_root, rcs, got


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("case", [f"trees/{c}" for c in TREE_CASES]
                         + [f"msa/{c}" for c in MSA_CASES] + ["coevolution"])
def test_cli_files_byte_equal(case, cli_case):
    """pf-simulate-{trees,alignments,coevolution}-torch write the JAX CLIs'
    bytes (the indel cases with their ``.untrimmed`` files; ``--engine
    device --indels`` runs the native engine, as JAX's CLI does)."""
    jax_root, port_root, rcs, got = cli_case
    assert rcs[case] == 0 and int(got["rc/" + case]) == 0
    want, have = _files(jax_root / case), _files(port_root / case)
    assert want and sorted(have) == sorted(want)
    if case.endswith("indels"):
        assert any(k.endswith(".untrimmed") for k in want)
    for name in want:
        assert have[name] == want[name], name


# -- the device engine: host side bit for bit, one step, distributions ---------

def _trees():
    """Newick strings of three simulated trees of 9, 5 and 3 tips."""
    rng = np.random.default_rng(41)
    out = [simulate_tree(rng, TreeSimConfig(ntips=n)).to_newick() for n in (9, 5)]
    return out + ["((A:0.1,B:0.2):0.05,C:0.3);"]


HOST_CASES = {"lg_gc": dict(length=30, gamma="GC"),
              "mix_g4": dict(length=30, gamma="G4", mdef="{mix}"),
              "wag_alpha": dict(substitution="WAG", length=30, gamma="GC", alpha=0.6)}


def _host_side(dev, priors, trees, cfg, seed_log, **device):
    """Host draws, packing, drawn seeds and the generator's state after a
    run of ``simulate_msas_device`` with ``allow_duplicates=True``."""
    from dataclasses import replace

    prior = priors.alpha_sampler() if cfg.gamma else None
    sim = dev.DeviceSimulator(cfg, **device)
    rates, cls, roots = sim._host_draws(len(trees), np.random.default_rng(5), prior)
    packed = dev._pack_trees(trees, pad_nodes=20)
    rng = np.random.default_rng(6)
    alns, attempts = dev.simulate_msas_device(trees, replace(cfg, allow_duplicates=True),
                                              rng, prior, batch_size=2, **device)
    state = rng.bit_generator.state["state"]
    return {"rates": rates, "cls": cls, "roots": roots, "parent": packed.parent,
            "blen": packed.blen, "leaf_node": packed.leaf_node,
            "n_leaves": np.asarray(packed.n_leaves), "names": np.asarray(sum(packed.names, [])),
            "seeds": np.asarray(seed_log, dtype=np.uint64),
            "attempts": np.asarray(attempts),
            "shapes": np.asarray([a.codes.shape for a in alns]),
            "state": np.asarray([str(state["state"]), str(state["inc"])])}


@pytest.fixture(scope="module")
def host_case(tmp_path_factory, model_files):
    from phyloformer_tpu.sim import device as jdev
    from phyloformer_tpu.sim import priors as jpriors

    trees = _trees()
    mix = str(model_files / "mix.nex")
    want = {}
    real_key = jax.random.PRNGKey
    for case, kw in HOST_CASES.items():
        cfg = MsaSimConfig(**{k: v.format(mix=mix) if isinstance(v, str) else v
                              for k, v in kw.items()})
        seeds = []
        jax.random.PRNGKey = lambda s: (seeds.append(s), real_key(s))[1]
        try:
            res = _host_side(jdev, jpriors, [parse_newick(t) for t in trees], cfg, seeds)
        finally:
            jax.random.PRNGKey = real_key
        want.update({f"{case}.{k}": v for k, v in res.items()})
    got = run_port(_shared(_host_side) + f"""
from phyloformer_tpu_torch.data.newick import parse_newick
from phyloformer_tpu_torch.sim import device as pdev
from phyloformer_tpu_torch.sim import priors as ppriors
from phyloformer_tpu_torch.sim.msa import MsaSimConfig
seeds = []
evolve = pdev.DeviceSimulator._evolve
def logged(self, packed, rates, cls, roots, seed):
    seeds.append(seed)
    return evolve(self, packed, rates, cls, roots, seed)
pdev.DeviceSimulator._evolve = logged
for case, kw in {HOST_CASES!r}.items():
    seeds.clear()
    cfg = MsaSimConfig(**{{k: v.format(mix={mix!r}) if isinstance(v, str) else v
                          for k, v in kw.items()}})
    res = _host_side(pdev, ppriors, [parse_newick(t) for t in {trees!r}], cfg, seeds,
                     device="cpu")
    OUT.update({{f"{{case}}.{{k}}": v for k, v in res.items()}})
""", {}, tmp_path_factory.mktemp("port_host"))
    return got, want


@pytest.mark.parametrize("case", list(HOST_CASES))
@pytest.mark.parametrize("what", ["draws", "packing", "seed_and_state"])
def test_device_engine_host_side_bit_equal(case, what, host_case):
    got, want = host_case
    keys = {"draws": ["rates", "cls", "roots"],
            "packing": ["parent", "blen", "leaf_node", "n_leaves", "names"],
            "seed_and_state": ["seeds", "state", "attempts", "shapes"]}[what]
    for k in keys:
        name = f"{case}.{k}"
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if what == "seed_and_state":
        assert len(want[f"{case}.seeds"]) == 2  # two batches of two trees


STEP_CASES = {"lg": None, "mixture": "{mix}"}


@pytest.fixture(scope="module")
def step_case(tmp_path_factory, model_files):
    """JAX's expression of one step (``device.py:146-151``) on the JAX
    engine's float32 stacks, jitted on the CPU, beside the port's
    ``step_weights`` on its own stacks."""
    from phyloformer_tpu.sim.device import DeviceSimulator

    K, L = 3, 200
    rng = np.random.default_rng(51)
    inputs, want = {}, {}
    for case, mdef in STEP_CASES.items():
        sim = DeviceSimulator(MsaSimConfig(mdef=mdef and mdef.format(
            mix=str(model_files / "mix.nex"))))
        lam, left, right = (np.asarray(a) for a in (sim.lam, sim.left, sim.right))
        cls = rng.integers(0, lam.shape[0], (K, L)).astype(np.int32)
        p_state = rng.integers(0, 20, (K, L)).astype(np.int32)
        blen = rng.uniform(0.0, 2.0, K).astype(np.float32)
        blen[0] = 0.0
        rates = rng.gamma(0.5, 2.0, (K, L)).astype(np.float32)

        def one(lamc, leftc, rightc, p_state, blen_i, rates):
            sites = jnp.arange(L)
            e = jnp.exp(lamc * (blen_i * rates)[:, None])
            a = rightc[sites, p_state, :] * e
            return jnp.einsum("lk,lkj->lj", a, leftc)

        want[case] = np.asarray(jax.jit(jax.vmap(one))(
            lam[cls], left[cls], right[cls], p_state, blen, rates))
        want[case + ".stacks"] = (lam, left, right)
        inputs.update({f"{case}.cls": cls, f"{case}.p_state": p_state,
                       f"{case}.blen": blen, f"{case}.rates": rates})
    got = run_port(f"""
from phyloformer_tpu_torch.sim.device import DeviceSimulator, step_weights
from phyloformer_tpu_torch.sim.msa import MsaSimConfig
for case, mdef in {STEP_CASES!r}.items():
    sim = DeviceSimulator(MsaSimConfig(mdef=mdef and mdef.format(
        mix={str(model_files / "mix.nex")!r})), device="cpu")
    cls = t(case + ".cls", torch.int64)
    OUT[case] = step_weights(sim.lam[cls], sim.left[cls], sim.right, cls,
                             t(case + ".p_state", torch.int64),
                             t(case + ".blen")[:, None] * t(case + ".rates"))
    OUT[case + ".lam"], OUT[case + ".left"], OUT[case + ".right"] = sim.lam, sim.left, sim.right
""", inputs, tmp_path_factory.mktemp("port_step"))
    return got, want


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_weights_match_jax(case, step_case):
    got, want = step_case
    for name, stack in zip(("lam", "left", "right"), want[case + ".stacks"]):
        np.testing.assert_array_equal(got[f"{case}.{name}"], stack)  # the same fp32 stacks
    w, ref = got[case], want[case]
    assert w.shape == ref.shape and np.isfinite(w).all()
    err = np.abs(w - ref) / np.abs(ref).max(axis=-1, keepdims=True)
    assert err.max() <= 1e-5, err.max()


SKEWED = np.array([0.3, 0.2, 0.12, 0.1, 0.08, 0.06, 0.04, 0.03, 0.02, 0.015,
                   0.01, 0.005, 0.004, 0.003, 0.002, 0.0005, 0.0003, 0.0001,
                   0.0001, 0.0])
SKEWED[-1] = 1.0 - SKEWED[:-1].sum()

DISTRIBUTION_CODE = """
import pathlib
from phyloformer_tpu_torch.data.newick import parse_newick
from phyloformer_tpu_torch.sim.device import gumbel_argmax, simulate_msas_device
from phyloformer_tpu_torch.sim.models import get_model
from phyloformer_tpu_torch.sim.msa import MsaSimConfig

# the distance calibration and the topology signal (JAX's
# test_device_engine_distance_calibration)
t = 0.3
lg = get_model("LG")
OUT["expected_diff"] = 1.0 - (lg.freqs * np.diag(lg.transition_matrix(t))).sum()
trees = [parse_newick(f"(A:{t / 2},B:{t / 2});"),
         parse_newick("((A:0.05,B:0.05):0.3,(C:0.05,D:0.05):0.3);")]
alns, attempts = simulate_msas_device(trees, MsaSimConfig(substitution="LG", length=6000),
                                      np.random.default_rng(7), batch_size=2, device="cpu")
OUT["pair"], OUT["quartet"] = alns[0].codes, alns[1].codes
OUT["quartet_ids"] = np.asarray(alns[1].ids)

# the mixture's composition (JAX's test_mdef_frequency_mixture, on the device engine)
alns, _ = simulate_msas_device(
    [parse_newick("((A:0.05,B:0.05):0.05,(C:0.05,D:0.05):0.05);")],
    MsaSimConfig(length=2000, mdef=MIX), np.random.default_rng(0), device="cpu")
OUT["mixture"] = alns[0].codes

# the sampler: 10^6 draws from a skewed 20-state vector
gen = torch.Generator().manual_seed(3)
logits = torch.log(torch.as_tensor(IN["skewed"], dtype=torch.float32).clamp_min(1e-30))
OUT["draw_counts"] = sum(torch.bincount(gumbel_argmax(logits.expand(100_000, 20), gen),
                                        minlength=20) for _ in range(10))

# duplicate rejection: zero-length branches, every attempt fails
alns, attempts = simulate_msas_device([parse_newick("((A:0,B:0):0,C:0);")],
                                      MsaSimConfig(length=50, max_attempts=3),
                                      np.random.default_rng(6), device="cpu")
OUT["dup_none"], OUT["dup_attempts"] = np.asarray(alns[0] is None), np.asarray(attempts)

# no device named: the card, which raises without one
from phyloformer_tpu_torch.sim.device import DeviceSimulator
try:
    OUT["default_device"] = np.asarray(str(DeviceSimulator(MsaSimConfig()).device))
except RuntimeError as e:
    OUT["default_device"] = np.asarray(str(e))
OUT["cuda"] = np.asarray(torch.cuda.is_available())
"""


@pytest.fixture(scope="module")
def distributions(tmp_path_factory, model_files):
    return run_port(f"MIX = {str(model_files / 'mix.nex')!r}\n" + DISTRIBUTION_CODE,
                    {"skewed": SKEWED}, tmp_path_factory.mktemp("port_dist"))


def test_device_engine_distance_calibration(distributions):
    d = distributions
    assert d["pair"].shape == (2, 6000) and d["quartet"].shape == (4, 6000)
    observed = (d["pair"][0] != d["pair"][1]).mean()
    assert observed == pytest.approx(float(d["expected_diff"]), abs=0.02)


def test_device_engine_topology_signal(distributions):
    c, ids = distributions["quartet"], list(distributions["quartet_ids"])
    i = {name: k for k, name in enumerate(ids)}
    assert (c[i["A"]] != c[i["B"]]).mean() < (c[i["A"]] != c[i["C"]]).mean()


def test_device_engine_mixture_composition(distributions):
    codes = distributions["mixture"]
    assert codes.shape == (4, 2000)
    obs = np.bincount(codes.ravel(), minlength=22)[:20] / codes.size
    expect = 0.5 * F1 / F1.sum() + 0.5 * F2 / F2.sum()
    assert np.abs(obs - expect).max() < 0.03


def test_gumbel_argmax_sampler(distributions):
    counts = distributions["draw_counts"]
    n = counts.sum()
    assert n == 10**6
    se = np.sqrt(SKEWED * (1 - SKEWED) / n)
    z = np.abs(counts / n - SKEWED) / np.maximum(se, 1e-12)
    assert (z < 5).all(), z


def test_device_engine_duplicate_rejection(distributions):
    assert bool(distributions["dup_none"])
    assert distributions["dup_attempts"].tolist() == [3]


@pytest.fixture(scope="module")
def duplicate_witness(tmp_path_factory):
    """Surplus rows (rows less distinct rows) of JAX's engine and the port's
    on ``chip_smoke.py``'s witness: the first 128 of its birth-death trees of
    50 tips, 500 sites at GC, 8 attempts each with duplicates allowed, one
    numpy seed, so both draw the same rates and roots and differ only in
    their substitution draws.  The port runs beside JAX, in its own
    interpreter, through ``chip_smoke.duplicate_surplus`` as on the card."""
    from concurrent.futures import ThreadPoolExecutor

    from phyloformer_tpu.data import read_newick
    from phyloformer_tpu.sim.device import DeviceSimulator
    from phyloformer_tpu.sim.priors import alpha_sampler
    from phyloformer_tpu.sim.trees import simulate_trees

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    tmp = tmp_path_factory.mktemp("witness")
    paths = simulate_trees(tmp / "trees", cs.WITNESS_TREES, TreeSimConfig(ntips=cs.SIM_TIPS),
                           seed=cs.SEED)
    port_code = f"""
sys.path.insert(0, ".")
import chip_smoke as cs
from phyloformer_tpu_torch.data.newick import read_newick
from phyloformer_tpu_torch.sim.device import DeviceSimulator
from phyloformer_tpu_torch.sim.msa import MsaSimConfig
from phyloformer_tpu_torch.sim.priors import alpha_sampler
trees = [read_newick(p) for p in {[str(p) for p in paths]!r}]
sim = DeviceSimulator(MsaSimConfig(length=cs.SIM_SITES, gamma="GC"), "cpu")
OUT["surplus"] = cs.duplicate_surplus(sim, trees, alpha_sampler())
"""
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(run_port, port_code, {}, tmp / "port")
        sim = DeviceSimulator(MsaSimConfig(length=cs.SIM_SITES, gamma="GC"))
        want = cs.duplicate_surplus(sim, [read_newick(p) for p in paths], alpha_sampler())
        got = port.result()["surplus"]
    return cs, got, want


def test_duplicate_witness_is_jax(duplicate_witness):
    """``chip_smoke.WITNESS_JAX``, the card's bar, is what JAX's engine gives
    (to 1% of the attempts and one tree: another build of XLA may round a
    transition weight otherwise)."""
    cs, _, want = duplicate_witness
    assert want.shape == (cs.WITNESS_ROUNDS, cs.WITNESS_TREES)
    dups, always = int((want > 0).sum()), int((want > 0).all(0).sum())
    rec = cs.WITNESS_JAX
    assert abs(dups - rec["dup_attempts"]) <= want.size // 100, (dups, always)
    assert abs(always - rec["always_dup_trees"]) <= 1, (dups, always)


@pytest.mark.parametrize("what", ["duplicate_attempts", "surplus_rows", "always_duplicate"])
def test_device_engine_duplicate_rate_matches_jax(what, duplicate_witness):
    """The port's engine draws duplicate rows as often as JAX's (its fp32
    substitution draws on short branches included): the share of attempts
    with duplicates within ``chip_smoke.dup_share_bar`` (4 standard errors),
    the mean surplus rows an attempt within 4 standard errors of their
    difference, and the trees with duplicates in every attempt within 4
    Poisson standard errors."""
    cs, got, want = duplicate_witness
    assert got.shape == want.shape
    n = want.size
    if what == "duplicate_attempts":
        p, q = (got > 0).mean(), (want > 0).mean()
        assert abs(p - q) <= cs.dup_share_bar((p + q) / 2, n), (p, q)
    elif what == "surplus_rows":
        se = np.sqrt((got.var() + want.var()) / n)
        assert abs(got.mean() - want.mean()) <= 4 * se, (got.mean(), want.mean(), se)
    else:
        a, b = int((got > 0).all(0).sum()), int((want > 0).all(0).sum())
        assert abs(a - b) <= 4 * np.sqrt(max(a + b, 1)), (a, b)


def test_device_simulator_defaults_to_the_card(distributions):
    got = str(distributions["default_device"])
    if bool(distributions["cuda"]):
        assert got.startswith("cuda")
    else:
        assert "no CUDA device available" in got, got


# -- pf-simulate-alignments-torch --engine device ------------------------------

def _device_cli(tmp_path, extra):
    treedir = tmp_path / "trees"
    treedir.mkdir(exist_ok=True)
    for k in range(3):
        (treedir / f"{k}_4_tips.nwk").write_text("((A:0.1,B:0.1):0.2,(C:0.1,D:0.1):0.2);\n")
    out = tmp_path / ("msas" + "_".join(extra))
    r = subprocess.run([sys.executable, "-m", "phyloformer_tpu_torch.sim.cli_msa",
                        str(treedir), str(out), "-l", "40", "--engine", "device", "--seed", "5",
                        "--batch-size", "2", *extra],
                       capture_output=True, text=True, timeout=300, cwd=str(REPO),
                       env={**os.environ, **PORT_THREAD_ENV})
    return r, out


def test_device_cli_on_cpu_writes_paired_files(tmp_path):
    from phyloformer_tpu.data import read_fasta

    r, out = _device_cli(tmp_path, ["--device", "cpu"])
    assert r.returncode == 0, r.stderr
    msas = sorted(out.glob("*.fa"))
    assert [m.stem for m in msas] == [f"{k}_4_tips" for k in range(3)]
    for m in msas:
        aln = read_fasta(m)
        assert aln.codes.shape == (4, 40) and sorted(aln.ids) == ["A", "B", "C", "D"]


def test_device_cli_defaults_to_the_card(tmp_path):
    """Without ``--device`` the engine asks for the card: here, with none,
    the CLI fails with ``resolve_device``'s message and writes nothing."""
    cuda = subprocess.run([sys.executable, "-c", "import torch; print(torch.cuda.is_available())"],
                          capture_output=True, text=True, timeout=300).stdout.strip() == "True"
    r, out = _device_cli(tmp_path, [])
    if cuda:
        assert r.returncode == 0, r.stderr
    else:
        assert r.returncode != 0
        assert "no CUDA device available" in r.stderr, r.stderr[-2000:]
        assert not list(out.glob("*.fa"))
