"""The port's eager model against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
and their counterparts in ``phyloformer_tpu_torch`` (run in a fresh
interpreter: torch and JAX are never imported into one process here).
Tolerance: 5e-5 max-abs on real pairs for whole forwards (fp32 sums taken in
another order by two frameworks), 1e-5 relative to the reference's magnitude
for single operators.

:func:`run_port` is the exchange the other ``test_torch_*`` files use too.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from phyloformer_tpu.models.params import PhyloformerConfig, init_params

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPT = REPO / "artifacts" / "pf_mre_r5.ckpt"

_PRELUDE = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
# The port's CPU entry points warm torch's vector math in resolve_device; code
# here may call the plain versions without one, so it warms it first too.
from phyloformer_tpu_torch.device import warm_cpu_math
warm_cpu_math()
IN = dict(np.load(sys.argv[1]))
OUT = {}

def tree(prefix):
    '''The nested dict/list of fp32 tensors stored under "prefix/..." in IN.'''
    from phyloformer_tpu_torch.models.params import params_from_numpy
    root = {}
    for key, val in IN.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}

    return params_from_numpy(lists(root), "cpu")

def t(name, dtype=None):
    x = torch.from_numpy(IN[name])
    return x if dtype is None else x.to(dtype)
"""

_EPILOGUE = """
np.savez(sys.argv[2], **{k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                             else np.asarray(v)) for k, v in OUT.items()})
"""


def flatten(tree, prefix):
    """Nested dict/list of arrays → {"prefix/a/0/b": np.ndarray}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}"))
    return out


# CPU thread counts of the subprocesses, fixed so that the order of every
# parallel sum does not depend on the load of the machine (the test workers
# run side by side): the port's OpenMP / MKL pools at the prelude's two
# threads, with dynamic adjustment off; XLA's CPU backend on one thread.
PORT_THREAD_ENV = {"OMP_NUM_THREADS": "2", "MKL_NUM_THREADS": "2", "OMP_DYNAMIC": "FALSE",
                   "MKL_DYNAMIC": "FALSE"}
JAX_THREAD_FLAGS = "--xla_cpu_multi_thread_eigen=false"

_JAX_PRELUDE = """
import sys
import numpy as np
import jax
IN = dict(np.load(sys.argv[1]))
OUT = {}
"""

_JAX_EPILOGUE = """
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in OUT.items()})
"""


def _run(prelude, code, epilogue, inputs, tmp_path, name, env):
    tmp_path.mkdir(parents=True, exist_ok=True)
    src, dst = tmp_path / f"{name}_in.npz", tmp_path / f"{name}_out.npz"
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", prelude + code + epilogue, str(src), str(dst)],
                       capture_output=True, text=True, cwd=str(REPO), timeout=300,
                       env={**os.environ, **env})
    assert r.returncode == 0, r.stderr[-4000:]
    return dict(np.load(dst))


def run_port(code, inputs, tmp_path):
    """Run ``code`` in a fresh interpreter with the port importable.

    ``inputs`` (name → array) arrive as ``IN``; ``tree(prefix)`` rebuilds a
    parameter tree flattened with :func:`flatten`; the code fills ``OUT``
    (name → tensor or array), which comes back as numpy arrays."""
    return _run(_PRELUDE, code, _EPILOGUE, inputs, tmp_path, "port", PORT_THREAD_ENV)


def run_jax(code, inputs, tmp_path):
    """Like :func:`run_port`, for JAX package code on the CPU with XLA on
    one thread: ``IN`` and ``OUT`` as there (no ``tree``)."""
    flags = (os.environ.get("XLA_FLAGS", "") + " " + JAX_THREAD_FLAGS).strip()
    return _run(_JAX_PRELUDE, code, _JAX_EPILOGUE, inputs, tmp_path, "jax",
                {"JAX_PLATFORMS": "cpu", "XLA_FLAGS": flags})


def random_params(seed, n_blocks):
    """JAX-initialised parameters with every leaf perturbed by numpy noise, so
    LayerNorm scales and biases are not the identity; as numpy arrays."""
    cfg = PhyloformerConfig(n_blocks=n_blocks, matmul_precision="float32")
    params = init_params(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32), params)
    return params, cfg


def random_batch(seed, dims, pad_n, pad_l, gap_frac=0.0):
    """Codes and masks of a padded batch of random alignments of real shapes
    ``dims`` = [(n, l), ...]; padding holds code 0, as the engine pads."""
    rng = np.random.default_rng(seed)
    b = len(dims)
    codes = np.zeros((b, pad_n, pad_l), np.int32)
    site_mask = np.zeros((b, pad_l), bool)
    seq_mask = np.zeros((b, pad_n), bool)
    for r, (n, l) in enumerate(dims):
        c = rng.integers(0, 20, (n, l))
        c[rng.random((n, l)) < gap_frac] = 21  # '-'
        codes[r, :n, :l] = c
        site_mask[r, :l] = True
        seq_mask[r, :n] = True
    return codes, site_mask, seq_mask


def real_pair_mask(seq_mask):
    i, j = np.triu_indices(seq_mask.shape[1], 1)
    return seq_mask[:, i] & seq_mask[:, j]


# name: (seed, n_blocks, real dims, pad_n, pad_l, gap fraction, masked)
FORWARD_CASES = {
    "one_block_unmasked": (11, 1, [(6, 10)] * 2, 6, 10, 0.0, False),
    "three_blocks_ragged": (12, 3, [(9, 16), (5, 11), (7, 13)], 9, 16, 0.0, True),
    "two_blocks_gapped": (13, 2, [(8, 14), (6, 9)], 8, 16, 0.4, True),
}


def _jax_forward(params, cfg, codes, site_mask, seq_mask, masked):
    from phyloformer_tpu.models.phyloformer import forward

    kw = dict(site_mask=jnp.asarray(site_mask), seq_mask=jnp.asarray(seq_mask)) if masked else {}
    return np.asarray(forward(params, jnp.asarray(codes), cfg, **kw))


@pytest.fixture(scope="module")
def model_case(tmp_path_factory):
    """Every case's inputs and JAX result, and the port's results from one
    subprocess."""
    inputs, want = {}, {}
    for name, (seed, nb, dims, pad_n, pad_l, gap, masked) in FORWARD_CASES.items():
        params, cfg = random_params(seed, nb)
        codes, site_mask, seq_mask = random_batch(seed, dims, pad_n, pad_l, gap)
        inputs.update(flatten(params, f"{name}/params"))
        inputs.update({f"{name}.codes": codes, f"{name}.site_mask": site_mask,
                       f"{name}.seq_mask": seq_mask})
        want[name] = (_jax_forward(params, cfg, codes, site_mask, seq_mask, masked),
                      real_pair_mask(seq_mask))

    # the real checkpoint at full width: n=8, L=24, unpadded
    from phyloformer_tpu.io.ckpt_import import load_pretrained

    params, cfg, _ = load_pretrained(CKPT)
    codes, site_mask, seq_mask = random_batch(21, [(8, 24)], 8, 24, 0.1)
    want["checkpoint"] = (_jax_forward(params, cfg, codes, site_mask, seq_mask, False),
                          real_pair_mask(seq_mask))
    inputs["checkpoint.codes"] = codes

    # operators: LayerNorm and masked / unmasked scaled linear attention
    rng = np.random.default_rng(31)
    x = rng.normal(size=(2, 5, 7, 16)).astype(np.float32)
    mask = np.ones((2, 1, 7), bool)
    mask[0, :, 5:] = False
    mask[1, :, :] = False  # a fully masked row: the zero-sum guards
    attn = {"wq": rng.normal(size=(16, 4)), "bq": rng.normal(size=4),
            "wk": rng.normal(size=(16, 4)), "bk": rng.normal(size=4),
            "wv": rng.normal(size=(16, 16)), "bv": rng.normal(size=16),
            "wo": rng.normal(size=(16, 16)), "bo": rng.normal(size=16)}
    attn = {k: (0.3 * v).astype(np.float32) for k, v in attn.items()}
    ln_s, ln_b = (1 + 0.1 * rng.normal(size=(2, 16))).astype(np.float32)
    inputs.update(flatten(attn, "attn"))
    inputs.update({"x": x, "mask": mask, "ln_s": ln_s, "ln_b": ln_b})

    from phyloformer_tpu.ops.attention import layer_norm, scaled_linear_attention

    with jax.default_matmul_precision("float32"):
        want["layer_norm"] = np.asarray(layer_norm(x, ln_s, ln_b, 1e-5))
        want["attn_masked"] = np.asarray(scaled_linear_attention(x, attn, 4, mask=mask))
        want["attn_unmasked"] = np.asarray(scaled_linear_attention(x, attn, 4))

    got = run_port(f"""
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.models.phyloformer import forward
from phyloformer_tpu_torch.ops.attention import layer_norm, scaled_linear_attention
for name, (nb, masked) in {
    {k: (v[1], v[6]) for k, v in FORWARD_CASES.items()}!r}.items():
    kw = dict(site_mask=t(name + ".site_mask"), seq_mask=t(name + ".seq_mask")) if masked else {{}}
    OUT[name] = forward(tree(name + "/params"), t(name + ".codes"),
                        PhyloformerConfig(n_blocks=nb), **kw)
params, cfg, _ = load_pretrained({str(CKPT)!r})
OUT["checkpoint"] = forward(params, t("checkpoint.codes"), cfg)
x, attn = t("x"), tree("attn")
OUT["layer_norm"] = layer_norm(x, t("ln_s"), t("ln_b"), 1e-5)
OUT["attn_masked"] = scaled_linear_attention(x, attn, 4, mask=t("mask"))
OUT["attn_unmasked"] = scaled_linear_attention(x, attn, 4)
""", inputs, tmp_path_factory.mktemp("port_model"))
    return got, want


@pytest.mark.parametrize("case", list(FORWARD_CASES) + ["checkpoint"])
def test_forward_matches_jax(case, model_case):
    got, want = model_case
    ref, pm = want[case]
    assert got[case].shape == ref.shape
    assert np.isfinite(got[case][pm]).all()
    err = np.abs(got[case] - ref)[pm].max()
    assert err <= 5e-5, err


@pytest.mark.parametrize("op", ["layer_norm", "attn_masked", "attn_unmasked"])
def test_operator_matches_jax(op, model_case):
    got, want = model_case
    assert got[op].shape == want[op].shape
    assert np.isfinite(got[op]).all()
    err = np.abs(got[op] - want[op]).max() / max(1.0, np.abs(want[op]).max())
    assert err <= 1e-5, err
