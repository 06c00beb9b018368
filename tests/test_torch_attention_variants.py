"""The ablation attention ops of the port (``multi_head_attention``,
``linear_kernel_attention``) against the JAX package's, on the CPU.

The cases of ``tests/test_ops_variants.py`` at its tolerances: softmax
attention of constant inputs is the same at every position (1e-5), padding
masked out of the linear-kernel attention changes nothing (2e-5), and the
three operators differ.  Besides, each op, with and without a mask, gives
JAX's output on the same inputs (1e-5 of max(1, max|ref|) for the softmax,
2e-5 for the linear kernel).
"""

import numpy as np
import pytest

from test_torch_model import run_jax, run_port

D, H = 16, 4
TOL = {"multi_head_attention": 1e-5, "linear_kernel_attention": 2e-5}


def _params(qk, rng, prefix):
    shapes = {"wq": (D, qk), "bq": (qk,), "wk": (D, qk), "bk": (qk,), "wv": (D, D), "bv": (D,),
              "wo": (D, D), "bo": (D,)}
    return {f"{prefix}/{k}": (rng.normal(size=s, scale=0.2) if k[0] == "w"
                              else rng.normal(size=s, scale=0.05)).astype(np.float32)
            for k, s in shapes.items()}


def _inputs():
    rng = np.random.default_rng(0)
    inputs = {**_params(D, rng, "full"), **_params(H, rng, "small")}
    inputs["x"] = rng.normal(size=(2, 3, 10, D)).astype(np.float32)
    inputs["x_pad"] = np.concatenate([inputs["x"], np.ones((2, 3, 3, D), np.float32)], axis=-2)
    inputs["mask"] = np.broadcast_to(np.arange(13) < 10, (2, 3, 13)).copy()
    return inputs


_CASES = """
p_full = {k: T(IN["full/" + k]) for k in KEYS}
p_small = {k: T(IN["small/" + k]) for k in KEYS}
x, x_pad, mask = T(IN["x"]), T(IN["x_pad"]), T(IN["mask"])
for name, op in (("multi_head_attention", multi_head_attention),
                 ("linear_kernel_attention", linear_kernel_attention)):
    OUT[name] = op(x, p_full, 4)
    OUT[name + ".masked"] = op(x_pad, p_full, 4, mask=mask)
    OUT[name + ".const"] = op(x * 0 + 1, p_full, 4)
OUT["scaled"] = scaled_linear_attention(x, p_small, 4)
"""
_KEYS = "KEYS = ('wq', 'bq', 'wk', 'bk', 'wv', 'bv', 'wo', 'bo')\n"


@pytest.fixture(scope="module")
def variants_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("attention_variants")
    want = run_jax(_KEYS + """
import jax.numpy as jnp
from phyloformer_tpu.ops.attention import (linear_kernel_attention, multi_head_attention,
                                           scaled_linear_attention)
T = jnp.asarray
""" + _CASES, _inputs(), root / "jax")
    got = run_port(_KEYS + """
from phyloformer_tpu_torch.ops.attention import (linear_kernel_attention, multi_head_attention,
                                                 scaled_linear_attention)
T = torch.from_numpy
""" + _CASES, _inputs(), root / "port")
    return want, got


@pytest.mark.parametrize("op", list(TOL))
@pytest.mark.parametrize("form", ["", ".masked"])
def test_variant_matches_jax(op, form, variants_case):
    want, got = variants_case
    g, r = got[op + form], want[op + form]
    assert g.shape == r.shape
    assert np.abs(g - r).max() <= TOL[op] * max(1.0, np.abs(r).max()), np.abs(g - r).max()


def test_mha_of_constant_input_is_the_same_everywhere(variants_case):
    _, got = variants_case
    out = got["multi_head_attention.const"]
    assert out.shape == (2, 3, 10, D)
    np.testing.assert_allclose(out, np.broadcast_to(out[..., :1, :], out.shape), atol=1e-5)


def test_linear_kernel_attention_mask_is_a_noop(variants_case):
    _, got = variants_case
    np.testing.assert_allclose(got["linear_kernel_attention.masked"][..., :10, :],
                               got["linear_kernel_attention"], atol=2e-5)


def test_the_three_operators_differ(variants_case):
    _, got = variants_case
    assert not np.allclose(got["scaled"], got["linear_kernel_attention"])
    assert not np.allclose(got["linear_kernel_attention"], got["multi_head_attention"])
