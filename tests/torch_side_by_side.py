"""Run the same code, or the same CLI command lines, under the JAX package
and under the port, each in a fresh interpreter, the two side by side.

``$PKG`` in the code or in a module name stands for the package
(``phyloformer_tpu`` or ``phyloformer_tpu_torch``) and ``$OUT`` in an
argument for the side's own output directory, so that one text drives both
sides.  Both interpreters get the same thread settings
(:data:`test_torch_model.PORT_THREAD_ENV`), so that numpy's sums run in one
order on both.  The port's interpreter must end with nothing of JAX or of
the JAX package loaded.
"""

import json
import os
import subprocess
import sys

import numpy as np

from test_torch_model import PORT_THREAD_ENV, REPO

SIDES = {"jax": "phyloformer_tpu", "port": "phyloformer_tpu_torch"}
ENV = {**os.environ, **PORT_THREAD_ENV, "JAX_PLATFORMS": "cpu"}

_PRELUDE = """
import sys
import numpy as np
IN = dict(np.load(sys.argv[1]))
OUT = {}
"""

_EPILOGUE = """
if "$PKG" == "phyloformer_tpu_torch":
    _bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "phyloformer_tpu")]
    assert not _bad, _bad
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in OUT.items()})
"""

_CLI_RUNNER = """
import contextlib, importlib, io, json, sys
res = []
for module, argv in json.loads(sys.argv[1]):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = importlib.import_module(module).main(argv)
    res.append({"rc": rc, "out": out.getvalue(), "err": err.getvalue()})
if "$PKG" == "phyloformer_tpu_torch":
    _bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "phyloformer_tpu")]
    assert not _bad, _bad
print(json.dumps({"res": res, "torch": "torch" in sys.modules}))
"""


def _wait(procs, timeout):
    """Wait for both sides (killing both if one overruns); fails unless both
    exited 0.  Returns their standard outputs."""
    outs, errs = {}, {}
    try:
        for side, p in procs.items():
            outs[side], errs[side] = p.communicate(timeout=timeout)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for side, p in procs.items():
        assert p.returncode == 0, f"{side}: {errs.get(side, '')[-4000:]}"
    return outs


def run_both(code, inputs, tmp_path, timeout=600):
    """``code`` (with ``IN``, filling ``OUT``) on both sides; returns
    ``{"jax": OUT, "port": OUT}`` as numpy arrays."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    src = tmp_path / "side_in.npz"
    np.savez(src, **inputs)
    procs = {}
    for side, pkg in SIDES.items():
        prog = (_PRELUDE + code + _EPILOGUE).replace("$PKG", pkg)
        procs[side] = subprocess.Popen(
            [sys.executable, "-c", prog, str(src), str(tmp_path / f"{side}_out.npz")],
            cwd=str(REPO), env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _wait(procs, timeout)
    return {side: dict(np.load(tmp_path / f"{side}_out.npz")) for side in SIDES}


def run_clis_both(jobs, root, timeout=600, port_args=()):
    """The command lines ``jobs`` = [(module, argv), ...] through each
    CLI's ``main(argv)``, in order, in one interpreter a side; ``$OUT`` in
    an argument is ``root/<side>`` (and ``root/<side>`` in what a command
    prints is ``$OUT`` again).  Returns ``{side: {"res": [{"rc", "out",
    "err"}, ...], "torch": bool}}``."""
    procs = {}
    for side, pkg in SIDES.items():
        (root / side).mkdir(parents=True, exist_ok=True)
        extra = list(port_args) if side == "port" else []
        mine = [(m.replace("$PKG", pkg),
                 [a.replace("$OUT", str(root / side)) for a in argv] + extra)
                for m, argv in jobs]
        procs[side] = subprocess.Popen(
            [sys.executable, "-c", _CLI_RUNNER.replace("$PKG", pkg), json.dumps(mine)],
            cwd=str(REPO), env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = _wait(procs, timeout)
    res = {side: json.loads(out.strip().splitlines()[-1]) for side, out in outs.items()}
    for side, r in res.items():  # each side's output directory printed back as $OUT
        for job in r["res"]:
            for k in ("out", "err"):
                job[k] = job[k].replace(str(root / side), "$OUT")
    return res


def files_of(directory):
    """Every file under ``directory``: relative path -> bytes."""
    directory = str(directory)
    out = {}
    for base, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, directory)] = fh.read()
    return out
